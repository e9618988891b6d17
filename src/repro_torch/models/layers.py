"""Primitive layers: nested-dict params, functional apply on tensors.

Counterpart of ``repro.models.layers``.  All linear layers are bias-free.
Two places where PyTorch's defaults differ from JAX's are pinned here:

* GELU: ``jax.nn.gelu`` defaults to the tanh approximation, so
  :func:`mlp` uses ``F.gelu(..., approximate="tanh")``.
* RoPE: the inverse frequencies are computed in float64 numpy and then cast
  to float32, exactly as the reference does; a ``torch.pow`` in float32
  gives other bits.  They are cached per device so a decode step never
  copies them from the host.
"""

from __future__ import annotations

import functools

import numpy as np
import torch
import torch.nn.functional as F

from ..device import torch_dtype


# ---------------------------------------------------------------------------
# Linear / embedding / norms
# ---------------------------------------------------------------------------


def init_dense(gen: torch.Generator, d_in: int, d_out: int, dtype="bfloat16",
               scale: float | None = None, *, device=None):
    scale = (1.0 / np.sqrt(d_in)) if scale is None else scale
    w = torch.randn((d_in, d_out), generator=gen, dtype=torch.float32,
                    device=device or gen.device) * scale
    return {"w": w.to(torch_dtype(dtype))}


def init_embedding(gen: torch.Generator, vocab: int, d_model: int,
                   dtype="bfloat16", *, device=None):
    w = torch.randn((vocab, d_model), generator=gen, dtype=torch.float32,
                    device=device or gen.device) * 0.02
    return {"w": w.to(torch_dtype(dtype))}


def embed(params, tokens):
    return params["w"][tokens.long()]


def init_rmsnorm(d: int, dtype="bfloat16", *, device="cpu"):
    return {"scale": torch.ones((d,), dtype=torch_dtype(dtype), device=device)}


def rmsnorm(params, x, *, eps: float = 1e-6):
    """RMSNorm in f32 accumulation, cast back to input dtype."""
    xf = x.float()
    var = torch.mean(xf * xf, dim=-1, keepdim=True)
    y = xf * torch.rsqrt(var + eps)
    return (y * params["scale"].float()).to(x.dtype)


# ---------------------------------------------------------------------------
# MLP: SwiGLU (fused gate+up) or plain 2-matrix GELU
# ---------------------------------------------------------------------------


def init_mlp(gen: torch.Generator, d_model: int, d_ff: int, dtype="bfloat16",
             *, kind: str = "swiglu", device=None):
    wi_out = 2 * d_ff if kind == "swiglu" else d_ff   # swiglu: [gate | up]
    return {
        "wi": init_dense(gen, d_model, wi_out, dtype, device=device)["w"],
        "wo": init_dense(gen, d_ff, d_model, dtype, device=device)["w"],
    }


def mlp(params, x, *, kind: str = "swiglu"):
    h = x @ params["wi"]
    if kind == "swiglu":
        gate, up = torch.chunk(h, 2, dim=-1)
        h = F.silu(gate) * up
    else:
        h = F.gelu(h, approximate="tanh")
    return h @ params["wo"]


# ---------------------------------------------------------------------------
# Rotary position embeddings
# ---------------------------------------------------------------------------


def rope_freqs(d_head: int, theta: float) -> np.ndarray:
    """Inverse frequencies for half the head dim (host constant, float64)."""
    half = d_head // 2
    return 1.0 / (theta ** (np.arange(half, dtype=np.float64) / half))


@functools.lru_cache(maxsize=64)
def _inv_freq(d_head: int, theta: float, device: torch.device) -> torch.Tensor:
    return torch.tensor(rope_freqs(d_head, theta).astype(np.float32),
                        device=device)


def apply_rope(x, positions, theta: float):
    """x: (..., S, H, Dh); positions: broadcastable to (..., S) int32."""
    inv = _inv_freq(x.shape[-1], float(theta), x.device)
    ang = positions[..., None].float() * inv                     # (..., S, half)
    cos = torch.cos(ang)[..., None, :]                           # (..., S, 1, half)
    sin = torch.sin(ang)[..., None, :]
    x1, x2 = torch.chunk(x.float(), 2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
    return out.to(x.dtype)
