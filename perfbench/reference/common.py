"""Plain PyTorch reference of a decoder-only transformer, in float32 with
TF32 off, computed layer by layer over a few served requests.

It imports nothing of the program.  It reads the benchmark's own weights
(:mod:`perfbench.weights`, drawn from the run's seed) in the program's
served type and upcasts one layer at a time, so it fits on the card beside
nothing else once the program's state is freed.

Each request is one row: the prompt left-padded with token 0 to the cell's
``prompt_len`` (the program's batcher attends to that padding at positions
0 .. prompt_len - 1), then every served token but the last.  The logits at
position ``prompt_len - 1 + j`` judge the j-th served token.

``lin`` is the matrix product every projection goes through: float32, or a
lower precision for the control (:func:`fp8_lin`), which rounds both
operands to float8 e4m3 with a scale per row of the activations and per
output column of the weight and accumulates in float32.
"""

from __future__ import annotations

import math
from typing import Callable, Dict, List, Sequence

import numpy as np
import torch
import torch.nn.functional as F

QUERY_BLOCK = 512
FP8_MAX = 448.0


def f32_lin(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    return x @ w.float()


def _fp8_round(t: torch.Tensor, dim: int) -> torch.Tensor:
    scale = t.abs().amax(dim=dim, keepdim=True).clamp(min=1e-30) / FP8_MAX
    return (t / scale).to(torch.float8_e4m3fn).float() * scale


def fp8_lin(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """x (.., K) @ w (K, N) with both operands rounded to float8 e4m3."""
    return _fp8_round(x.float(), -1) @ _fp8_round(w.float(), 0)


LINS: Dict[str, Callable] = {"f32": f32_lin, "fp8": fp8_lin}


def rmsnorm(x: torch.Tensor, scale: torch.Tensor, eps: float) -> torch.Tensor:
    return x * torch.rsqrt((x * x).mean(-1, keepdim=True) + eps) * scale.float()


def rope(x: torch.Tensor, theta: float) -> torch.Tensor:
    """Rotary embedding of x (N, heads, dh) at positions 0 .. N - 1, the
    first half of each head rotated against the second; angles in float64."""
    n, _, dh = x.shape
    half = dh // 2
    inv = 1.0 / (theta ** (np.arange(half, dtype=np.float64) / half))
    ang = np.arange(n, dtype=np.float64)[:, None] * inv[None, :]
    cos = torch.from_numpy(np.cos(ang)).float().to(x.device)[:, None, :]
    sin = torch.from_numpy(np.sin(ang)).float().to(x.device)[:, None, :]
    x1, x2 = x[..., :half], x[..., half:]
    return torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)


def attention(x: torch.Tensor, lw: Dict, conf: Dict, lin) -> torch.Tensor:
    """Causal grouped-query self-attention of one row x (N, d)."""
    n = x.shape[0]
    h = conf["num_attention_heads"]
    hkv = conf.get("num_key_value_heads", h)
    dh = conf.get("head_dim") or conf["hidden_size"] // h
    eps = conf["rms_norm_eps"]
    q = lin(x, lw["wq"]).view(n, h, dh)
    k = lin(x, lw["wk"]).view(n, hkv, dh)
    v = lin(x, lw["wv"]).view(n, hkv, dh)
    if "q_norm" in lw:                       # Qwen3: RMSNorm per head
        q = rmsnorm(q, lw["q_norm"]["scale"], eps)
        k = rmsnorm(k, lw["k_norm"]["scale"], eps)
    q = rope(q, float(conf["rope_theta"]))
    k = rope(k, float(conf["rope_theta"]))
    k = k.repeat_interleave(h // hkv, dim=1)
    v = v.repeat_interleave(h // hkv, dim=1)
    out = torch.empty((n, h, dh), dtype=torch.float32, device=x.device)
    keys = torch.arange(n, device=x.device)
    for q0 in range(0, n, QUERY_BLOCK):
        q1 = min(n, q0 + QUERY_BLOCK)
        s = torch.einsum("qhd,khd->hqk", q[q0:q1], k[:q1]) / math.sqrt(dh)
        causal = keys[None, :q1] <= keys[q0:q1, None]
        s = s.masked_fill(~causal[None], float("-inf"))
        out[q0:q1] = torch.einsum("hqk,khd->qhd", torch.softmax(s, -1),
                                  v[:q1])
    return lin(out.view(n, h * dh), lw["wo"])


def layer_weights(blocks: List[Dict], i: int) -> Dict:
    """Layer ``i`` of the benchmark's stacked weight tree (views)."""
    def take(t):
        if isinstance(t, dict):
            return {k: take(v) for k, v in t.items()}
        return t[i]
    return take(blocks[0])


def forward(weights: Dict, conf: Dict, rows: Sequence[Dict], ffn,
            precision: str = "f32") -> List[torch.Tensor]:
    """Logits (n_served, vocab) in float32 at each row's judged positions.

    ``rows``: dicts with ``tokens`` (N,) int64 on the card (the padded
    prompt and all served tokens but the last) and ``prompt_len``.
    ``ffn(lw, h, rows, conf, lin)`` is the family's second half of a layer
    over the rows' tokens concatenated."""
    lin = LINS[precision]
    eps = conf["rms_norm_eps"]
    emb = weights["embed"]["w"]
    xs = [emb[r["tokens"]].float() for r in rows]
    for i in range(conf["num_hidden_layers"]):
        lw = layer_weights(weights["blocks"], i)
        xs = [x + attention(rmsnorm(x, lw["ln1"]["scale"], eps), lw["attn"],
                            conf, lin) for x in xs]
        h = torch.cat([rmsnorm(x, lw["ln2"]["scale"], eps) for x in xs])
        y = ffn(lw, h, rows, conf, lin)
        xs = list(torch.split(torch.cat(xs) + y, [x.shape[0] for x in xs]))
    head = weights["lm_head"]["w"] if "lm_head" in weights else emb
    head = head[:conf["vocab_size"]]
    out = []
    for x, r in zip(xs, rows):
        hid = rmsnorm(x[r["prompt_len"] - 1:], weights["final_norm"]["scale"],
                      eps)
        out.append(lin(hid, head.T))
    return out


def swiglu(h: torch.Tensor, wi: torch.Tensor, wo: torch.Tensor,
           lin) -> torch.Tensor:
    g = lin(h, wi)
    gate, up = g.chunk(2, dim=-1)
    return lin(F.silu(gate) * up, wo)
