"""Attention: GQA + qk_norm + RoPE + sliding window + dense KV-cache decode.

Counterpart of the dense parts of ``repro.models.attention``.  Three compute
paths, selected by ``impl``:

* ``"cuda"``  — the hand-written kernels: prefill through
  ``repro_torch.kernels.flash_attention``, decode through
  ``repro_torch.kernels.decode_attention``.  A CPU tensor takes each
  kernel's plain version; a CUDA tensor launches the kernel.
* ``"torch"`` — chunked online-softmax attention in plain PyTorch (a loop
  over KV blocks), the counterpart of the reference's ``"xla"`` oracle.
* ``"naive"`` — materialised-scores einsum.

Decode keeps a **ring-buffer** cache of ``min(max_len, window)`` slots for
sliding-window archs.  The JAX functions are pure and return an updated
cache; :func:`decode_attention` here writes the new token's K/V **in place**
into the cache views it is given (views of the stacked cache, so the write
lands in the caller's tensors) and returns the same views.
"""

from __future__ import annotations

import math
from typing import NamedTuple, Optional

import torch

from ..kernels.common import NEG_INF
from .layers import apply_rope, init_dense, init_rmsnorm, rmsnorm


# ---------------------------------------------------------------------------
# Capability table: which attn impl is legal for which execution mode
# ---------------------------------------------------------------------------
#
# Only the modes the port runs so far are listed; the others (train, paged,
# prefix, verify) arrive with the ROADMAP items that port them, and asking
# for one raises as an unknown mode.

ATTN_CAPABILITIES = {
    "dense": ("cuda", "torch", "naive"),
    "sliding_window": ("cuda", "torch", "naive"),
}


def check_attn_impl(impl: str, mode: str) -> str:
    """Validate ``impl`` against :data:`ATTN_CAPABILITIES` for ``mode``.

    Returns ``impl`` unchanged on success; raises ``ValueError`` naming the
    mode and the supported impls otherwise.
    """
    try:
        supported = ATTN_CAPABILITIES[mode]
    except KeyError:
        raise ValueError(
            f"unknown attention mode {mode!r}; "
            f"expected one of {sorted(ATTN_CAPABILITIES)}") from None
    if impl not in supported:
        raise ValueError(
            f"attn_impl={impl!r} is not supported for mode {mode!r}; "
            f"supported: {supported}")
    return impl


# ---------------------------------------------------------------------------
# Params
# ---------------------------------------------------------------------------


def init_attention(gen: torch.Generator, cfg, *, device=None):
    device = device or gen.device
    p = {
        "wq": init_dense(gen, cfg.d_model, cfg.q_dim, cfg.dtype, device=device)["w"],
        "wk": init_dense(gen, cfg.d_model, cfg.kv_dim, cfg.dtype, device=device)["w"],
        "wv": init_dense(gen, cfg.d_model, cfg.kv_dim, cfg.dtype, device=device)["w"],
        "wo": init_dense(gen, cfg.q_dim, cfg.d_model, cfg.dtype, device=device)["w"],
    }
    if cfg.qk_norm:
        p["q_norm"] = init_rmsnorm(cfg.d_head, cfg.dtype, device=device)
        p["k_norm"] = init_rmsnorm(cfg.d_head, cfg.dtype, device=device)
    return p


# ---------------------------------------------------------------------------
# Core attention math
# ---------------------------------------------------------------------------


def _project_qkv(params, x, cfg, *, positions=None, rope: bool = True):
    """x: (B, S, D) -> q (B,S,H,dh), k/v (B,S,Hkv,dh), rope applied."""
    B, S, _ = x.shape
    q = (x @ params["wq"]).reshape(B, S, cfg.n_heads, cfg.d_head)
    k = (x @ params["wk"]).reshape(B, S, cfg.n_kv_heads, cfg.d_head)
    v = (x @ params["wv"]).reshape(B, S, cfg.n_kv_heads, cfg.d_head)
    if cfg.qk_norm and "q_norm" in params:
        q = rmsnorm(params["q_norm"], q, eps=cfg.norm_eps)
        k = rmsnorm(params["k_norm"], k, eps=cfg.norm_eps)
    if rope and cfg.rope_theta > 0:
        if cfg.m_rope:
            raise NotImplementedError(
                "M-RoPE (qwen2-vl) is not ported yet: ROADMAP.md Queue 1, "
                "other model families")
        if positions is None:
            positions = torch.arange(S, dtype=torch.int32, device=x.device)[None, :]
        q = apply_rope(q, positions, cfg.rope_theta)
        k = apply_rope(k, positions, cfg.rope_theta)
    return q, k, v


def _expand_kv(k, n_heads: int):
    """(B,S,Hkv,dh) -> (B,S,H,dh) by repeating each kv head (GQA)."""
    return torch.repeat_interleave(k, n_heads // k.shape[2], dim=2)


def _mask(Sq: int, Sk: int, *, causal: bool, window: Optional[int],
          q_offset: int, device) -> torch.Tensor:
    qi = torch.arange(Sq, device=device)[:, None] + q_offset
    ki = torch.arange(Sk, device=device)[None, :]
    mask = torch.ones((Sq, Sk), dtype=torch.bool, device=device)
    if causal:
        mask &= ki <= qi
    if window is not None:
        mask &= ki > qi - window
    return mask


def naive_attention(q, k, v, *, causal: bool, window: Optional[int] = None,
                    q_offset: int = 0):
    """Materialized-scores reference.  q: (B,Sq,H,dh); k,v: (B,Sk,Hkv,dh)."""
    B, Sq, H, dh = q.shape
    Sk = k.shape[1]
    k = _expand_kv(k, H)
    v = _expand_kv(v, H)
    scores = torch.einsum("bqhd,bkhd->bhqk", q, k).float() / math.sqrt(dh)
    mask = _mask(Sq, Sk, causal=causal, window=window, q_offset=q_offset,
                 device=q.device)
    scores = torch.where(mask[None, None], scores, NEG_INF)
    w = torch.softmax(scores, dim=-1)
    return torch.einsum("bhqk,bkhd->bqhd", w.to(v.dtype), v)


def chunked_flash_attention(
    q, k, v, *, causal: bool, window: Optional[int] = None,
    q_offset: int = 0, block_k: int = 512,
):
    """Online-softmax attention, a loop over KV blocks (plain-PyTorch
    "flash"): peak memory O(B·H·Sq·block_k).  The oracle of the prefill
    kernel, the counterpart of the reference's ``lax.scan`` version."""
    B, Sq, H, dh = q.shape
    Sk, Hkv = k.shape[1], k.shape[2]
    group = H // Hkv
    block_k = min(block_k, Sk)
    n_blocks = (Sk + block_k - 1) // block_k
    qg = (q.float() / math.sqrt(dh)).reshape(B, Sq, Hkv, group, dh)
    qi = torch.arange(Sq, dtype=torch.int32, device=q.device) + q_offset

    m = torch.full((B, Sq, Hkv, group), NEG_INF, dtype=torch.float32,
                   device=q.device)
    l = torch.zeros((B, Sq, Hkv, group), dtype=torch.float32, device=q.device)
    acc = torch.zeros((B, Sq, Hkv, group, dh), dtype=torch.float32,
                      device=q.device)
    for blk in range(n_blocks):
        lo = blk * block_k
        kc = k[:, lo:lo + block_k].float()
        vc = v[:, lo:lo + block_k].float()
        ki = lo + torch.arange(kc.shape[1], dtype=torch.int32, device=q.device)
        s = torch.einsum("bqgid,bkgd->bqgik", qg, kc)
        mask = torch.ones((Sq, kc.shape[1]), dtype=torch.bool, device=q.device)
        if causal:
            mask &= ki[None, :] <= qi[:, None]
        if window is not None:
            mask &= ki[None, :] > qi[:, None] - window
        s = torch.where(mask[None, :, None, None, :], s, NEG_INF)
        m_new = torch.maximum(m, s.amax(dim=-1))
        p = torch.exp(s - m_new[..., None])
        scale = torch.exp(m - m_new)
        l = l * scale + p.sum(dim=-1)
        acc = acc * scale[..., None] + torch.einsum("bqgik,bkgd->bqgid", p, vc)
        m = m_new
    out = acc / torch.clamp(l, min=1e-30)[..., None]
    return out.reshape(B, Sq, H, dh).to(q.dtype)


# ---------------------------------------------------------------------------
# Full layers
# ---------------------------------------------------------------------------


def self_attention(
    params, x, cfg, *, positions=None, causal: bool = True,
    impl: str = "cuda", q_offset: int = 0, block_k: int = 512,
):
    """Prefill self-attention.  Returns (out, (k, v)) so prefill can seed the
    KV cache.  (The reference's ``prefix_kv`` argument arrives with the
    prefix-sharing slice.)"""
    q, k, v = _project_qkv(params, x, cfg, positions=positions)
    if impl == "cuda":
        from ..kernels.flash_attention import ops as fa_ops

        out = fa_ops.flash_attention(
            q, k, v, causal=causal, window=cfg.sliding_window, q_offset=q_offset)
    elif impl == "naive":
        out = naive_attention(q, k, v, causal=causal, window=cfg.sliding_window,
                              q_offset=q_offset)
    elif impl == "torch":
        out = chunked_flash_attention(
            q, k, v, causal=causal, window=cfg.sliding_window,
            q_offset=q_offset, block_k=block_k)
    else:
        raise ValueError(f"unknown attn impl {impl!r}")
    B, S, _, _ = q.shape
    y = out.reshape(B, S, cfg.q_dim) @ params["wo"]
    return y, (k, v)


# ---------------------------------------------------------------------------
# Decode path (one new token vs. KV cache)
# ---------------------------------------------------------------------------


class KVCacheView(NamedTuple):
    """One layer's cache: ring buffer when the arch has a sliding window.

    k, v:  (B, C, Hkv, dh) with C = min(max_len, window or max_len)
    pos:   (B, C) int32 — absolute position stored in each slot (-1 = empty)
    """

    k: torch.Tensor
    v: torch.Tensor
    pos: torch.Tensor


def decode_attention(params, x, cache: KVCacheView, cur_pos, cfg, *,
                     impl: str = "cuda"):
    """x: (B, 1, D); cur_pos: (B,) int32 absolute position of the new token.

    Writes the new token's K/V at slot ``cur_pos % C`` **in place** (ring
    buffer ≡ plain buffer when C == max_len) and returns (out (B,1,D), the
    same cache views).
    """
    B = x.shape[0]
    q, k_new, v_new = _project_qkv(params, x, cfg, positions=cur_pos[:, None])
    C = cache.k.shape[1]
    # RoPE computes in f32: cast to the cache dtype BEFORE the slot write
    k_new = k_new.to(cache.k.dtype)
    v_new = v_new.to(cache.v.dtype)
    slot = (cur_pos % C).long()                                # (B,)
    bidx = torch.arange(B, device=x.device)
    cache.k.index_put_((bidx, slot), k_new[:, 0])
    cache.v.index_put_((bidx, slot), v_new[:, 0])
    cache.pos.index_put_((bidx, slot), cur_pos.to(torch.int32))

    if impl == "cuda":
        from ..kernels.decode_attention import ops as da_ops

        out = da_ops.decode_attention(
            q[:, 0], cache.k, cache.v, cache.pos, cur_pos,
            window=cfg.sliding_window)[:, None]
    elif impl in ("torch", "naive"):
        out = _decode_attn_torch(q, cache.k, cache.v, cache.pos, cur_pos, cfg)
    else:
        raise ValueError(f"unknown attn impl {impl!r}")
    y = out.reshape(B, 1, cfg.q_dim) @ params["wo"]
    return y, cache


def _decode_attn_torch(q, k, v, pos, cur_pos, cfg):
    """Counterpart of the reference's ``_decode_attn_xla``.
    q: (B,1,H,dh); k/v: (B,C,Hkv,dh); pos: (B,C); cur_pos: (B,).

    As in the reference, q is scaled by 1/sqrt(dh) in q's dtype *before*
    the dot product (the kernel and ``ref.py`` scale the f32 scores
    instead), and the products accumulate in f32."""
    B, _, H, dh = q.shape
    Hkv = k.shape[2]
    group = H // Hkv
    qg = (q.reshape(B, Hkv, group, dh).float() / math.sqrt(dh)).to(q.dtype)
    s = torch.einsum("bgid,bkgd->bgik", qg.float(), k.float())   # (B,Hkv,g,C)
    valid = (pos >= 0) & (pos <= cur_pos[:, None])
    if cfg.sliding_window is not None:
        valid &= pos > (cur_pos[:, None] - cfg.sliding_window)
    s = torch.where(valid[:, None, None, :], s, NEG_INF)
    w = torch.softmax(s, dim=-1)
    out = torch.einsum("bgik,bkgd->bgid", w.to(v.dtype).float(), v.float())
    return out.reshape(B, 1, H, dh).to(q.dtype)


def init_kv_cache(cfg, batch: int, max_len: int, *, dtype=None,
                  device="cpu") -> KVCacheView:
    """Cache for ONE attention layer.  Ring-buffer length = min(max_len,
    window) for sliding-window archs — the O(window) decode-memory property."""
    from ..device import torch_dtype

    C = min(max_len, cfg.sliding_window) if cfg.sliding_window else max_len
    dt = torch_dtype(dtype or cfg.dtype)
    return KVCacheView(
        k=torch.zeros((batch, C, cfg.n_kv_heads, cfg.d_head), dtype=dt, device=device),
        v=torch.zeros((batch, C, cfg.n_kv_heads, cfg.d_head), dtype=dt, device=device),
        pos=torch.full((batch, C), -1, dtype=torch.int32, device=device),
    )
