"""Attention: GQA + qk_norm + RoPE/M-RoPE + sliding window + dense and
paged KV-cache decode + prefix-context prefill + encoder-decoder
cross-attention.

Counterpart of ``repro.models.attention`` for the serving and training modes
the port runs.  Four compute paths, selected by ``impl``:

* ``"cuda"``  — the hand-written kernels: prefill through
  ``repro_torch.kernels.flash_attention``, dense decode through
  ``repro_torch.kernels.decode_attention``, paged decode through
  ``repro_torch.kernels.paged_attention`` (the page table is walked in the
  kernel) and suffix prefill against a cached prefix through
  ``repro_torch.kernels.prefix_attention``.  A CPU tensor takes each
  kernel's plain version; a CUDA tensor launches the kernel.
* ``"torch"`` — chunked online-softmax attention in plain PyTorch (a loop
  over KV blocks), the counterpart of the reference's ``"xla"`` oracle.
* ``"naive"`` — materialised-scores einsum.
* ``"flash"`` — the training path's differentiable prefill:
  :class:`FlashAttentionFn`, whose forward is the prefill kernel writing
  each row's log-sum-exp beside the output (a CPU tensor takes
  :func:`_flash_fwd_lse`, the reference's blockwise forward) and whose
  backward (:func:`_flash_bwd`) is the reference's ``_fa_vjp_bwd`` in
  torch: a blockwise recompute of the probabilities from the saved LSE.
  The reference's backward is pure JAX, so this is its port, not a
  stand-in for a kernel.  The reference cannot differentiate through its
  Pallas kernels (``jax.grad`` of a ``pallas_call`` fails in its JVP
  rule), so training refuses ``"cuda"`` and runs ``"flash"``.

Cross-attention (:func:`cross_attention`, the audio family's decoder over
the encoder's K/V) is the same non-causal attention: ``"cuda"`` sends it
through the prefill kernel with ``causal=False``, where the reference runs
its plain ``chunked_flash_attention`` on every route.

Draft verification (speculative decode) scores a window of W tokens in one
pass: :func:`verify_decode_attention` on dense rings and
:func:`paged_verify_attention` on the page pool.  Only the paged pool has a
multi-query kernel, in the reference as here; on dense rings ``"cuda"``
runs the plain multi-query path on the card, the reference's own route.

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
import torch.nn.functional as F

from ..device import resolve_device, torch_dtype
from ..kernels.common import NEG_INF
from ..obs import profiled
from .layers import apply_mrope, apply_rope, init_dense, init_rmsnorm, rmsnorm


# ---------------------------------------------------------------------------
# Capability table: which attn impl is legal for which execution mode
# ---------------------------------------------------------------------------
#
# The rows mirror the reference's (``"torch"`` stands for its ``"xla"``,
# ``"cuda"`` for its ``"pallas"``).  train: differentiable prefill (the
# training step); ``"cuda"`` is left out, as the reference's ``"pallas"``
# cannot be differentiated (see the module docstring), and ``"flash"``
# carries the kernel there.  verify: multi-query draft verification
# (speculative decode); ``"cuda"`` launches the paged multi-query kernel on
# the page pool and runs the plain multi-query path on dense rings, where
# the reference has no kernel either.

ATTN_CAPABILITIES = {
    "train": ("flash", "torch", "naive"),
    "dense": ("cuda", "torch", "naive"),
    "paged": ("cuda", "torch"),
    "prefix": ("cuda", "torch", "naive"),
    "sliding_window": ("cuda", "torch", "naive", "flash"),
    "verify": ("cuda", "torch"),
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


def init_attention(gen: torch.Generator, cfg, *, cross: bool = False,
                   device=None):
    """``cross=True`` builds encoder-decoder cross-attention (no qk_norm,
    K/V over the encoder's states)."""
    device = device or gen.device
    p = {
        "wq": init_dense(gen, cfg.d_model, cfg.q_dim, cfg.dtype, device=device)["w"],
        "wk": init_dense(gen, cfg.d_model, cfg.kv_dim, cfg.dtype, device=device)["w"],
        "wv": init_dense(gen, cfg.d_model, cfg.kv_dim, cfg.dtype, device=device)["w"],
        "wo": init_dense(gen, cfg.q_dim, cfg.d_model, cfg.dtype, device=device)["w"],
    }
    if cfg.qk_norm and not cross:
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
        if positions is None:
            positions = torch.arange(S, dtype=torch.int32, device=x.device)[None, :]
        if cfg.m_rope:
            if positions.dim() == 2:   # plain (B,S) ids (e.g. text-only decode)
                positions = positions[None].expand((3,) + positions.shape)
            q = apply_mrope(q, positions, cfg.rope_theta)
            k = apply_mrope(k, positions, cfg.rope_theta)
        else:
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
# Flash attention for training: a torch.autograd.Function
# ---------------------------------------------------------------------------
#
# The counterpart of the reference's ``flash_attention_vjp`` (a
# ``jax.custom_vjp``): the forward saves only (q, k, v, out, LSE) and the
# backward recomputes each key block's probabilities from the LSE, so
# attention memory through the backward is O(S·block), not O(S²).


def _flash_fwd_lse(q, k, v, *, causal: bool, window: Optional[int],
                   q_offset: int, block_k: int):
    """The reference's ``_flash_fwd_lse`` in torch: an online softmax over
    key blocks of ``block_k`` (k and v padded with zeros to a whole block),
    f32 throughout.  q: (B,Sq,H,dh); k, v: (B,Sk,Hkv,dh).  Returns (out
    (B,Sq,H,dh) in q's dtype, lse (B,Sq,H) f32: m + log(l) of the scores
    scaled by 1/sqrt(dh))."""
    B, Sq, H, dh = q.shape
    Sk, Hkv = k.shape[1], k.shape[2]
    group = H // Hkv
    block_k = min(block_k, Sk)
    n_blocks = (Sk + block_k - 1) // block_k
    pad = n_blocks * block_k - Sk
    if pad:
        k = F.pad(k, (0, 0, 0, 0, 0, pad))
        v = F.pad(v, (0, 0, 0, 0, 0, pad))
    dev = q.device
    qg = (q.float() / math.sqrt(dh)).reshape(B, Sq, Hkv, group, dh)
    qi = torch.arange(Sq, dtype=torch.int32, device=dev) + q_offset
    m = torch.full((B, Sq, Hkv, group), NEG_INF, dtype=torch.float32,
                   device=dev)
    l = torch.zeros((B, Sq, Hkv, group), dtype=torch.float32, device=dev)
    acc = torch.zeros((B, Sq, Hkv, group, dh), dtype=torch.float32,
                      device=dev)
    for blk in range(n_blocks):
        lo = blk * block_k
        kc = k[:, lo:lo + block_k].float()
        vc = v[:, lo:lo + block_k].float()
        s = torch.einsum("bqgid,bkgd->bqgik", qg, kc)
        mask = _block_mask(qi, lo, block_k, Sk, causal, window)
        s = torch.where(mask[None, :, None, None, :], s, NEG_INF)
        m_new = torch.maximum(m, s.amax(dim=-1))
        p = torch.exp(s - m_new[..., None])
        scale = torch.exp(m - m_new)
        l = l * scale + p.sum(dim=-1)
        acc = acc * scale[..., None] + torch.einsum("bqgik,bkgd->bqgid", p, vc)
        m = m_new
    l_safe = torch.clamp(l, min=1e-30)
    out = (acc / l_safe[..., None]).reshape(B, Sq, H, dh).to(q.dtype)
    return out, (m + torch.log(l_safe)).reshape(B, Sq, H)


def _block_mask(qi, lo: int, bk: int, Sk: int, causal: bool,
                window: Optional[int]):
    """(Sq, bk) validity of keys [lo, lo + bk) for query positions ``qi``:
    inside Sk, causal, inside the window."""
    ki = lo + torch.arange(bk, dtype=torch.int32, device=qi.device)
    mask = (ki[None, :] < Sk).expand(qi.shape[0], bk)
    if causal:
        mask = mask & (ki[None, :] <= qi[:, None])
    if window is not None:
        mask = mask & (ki[None, :] > qi[:, None] - window)
    return mask


def _flash_bwd(q, k, v, out, lse, do, *, causal: bool,
               window: Optional[int], q_offset: int, block_k: int):
    """The reference's ``_fa_vjp_bwd`` in torch: for each key block the
    probabilities are recomputed from ``lse`` (B,Sq,H), f32 throughout,
    with D = rowsum(dO·O).  Returns (dq, dk, dv) in the dtypes of q, k, v.

    The query heads of a kv head are laid out as the rows of one matrix,
    (B, Hkv, group·Sq, dh) with row i·Sq + q for head i of the group, so
    each of the five products is one batched matmul over (B, Hkv) and dk,
    dv sum over the group as they contract over the rows.  The last key
    block is cut at Sk where the reference pads it with zero keys and cuts
    their rows off dk and dv: a zero key adds nothing to dq, so the sums
    are the same."""
    B, Sq, H, dh = q.shape
    Sk, Hkv = k.shape[1], k.shape[2]
    group = H // Hkv
    bk = min(block_k, Sk)
    sm = 1.0 / math.sqrt(dh)

    def rows(t, width):
        return (t.float().reshape(B, Sq, Hkv, group, width)
                .permute(0, 2, 3, 1, 4).reshape(B, Hkv, group * Sq, width))

    qr, dor = rows(q, dh), rows(do, dh)
    lse_r = rows(lse[..., None], 1)
    D = torch.sum(dor * rows(out, dh), dim=-1, keepdim=True)   # (B,Hkv,gSq,1)
    qs = qr * sm
    kt = k.float().transpose(1, 2)                       # (B,Hkv,Sk,dh)
    vt = v.float().transpose(1, 2)
    qi = torch.arange(Sq, dtype=torch.int32, device=q.device) + q_offset
    dq = torch.zeros_like(qr)
    dk = torch.empty_like(kt)
    dv = torch.empty_like(vt)
    for lo in range(0, Sk, bk):
        hi = min(lo + bk, Sk)
        kc, vc = kt[:, :, lo:hi], vt[:, :, lo:hi]
        keep = _block_mask(qi, lo, hi - lo, Sk, causal, window).repeat(group, 1)
        s = torch.matmul(qs, kc.transpose(-1, -2))       # (B,Hkv,gSq,n)
        p = s.masked_fill_(~keep, NEG_INF).sub_(lse_r).exp_()   # recomputed probs
        dv[:, :, lo:hi] = torch.matmul(p.transpose(-1, -2), dor)
        dp = torch.matmul(dor, vc.transpose(-1, -2))
        ds = dp.sub_(D).mul_(p).mul_(sm)
        dq += torch.matmul(ds, kc)
        dk[:, :, lo:hi] = torch.matmul(ds.transpose(-1, -2), qr)
    dq = (dq.reshape(B, Hkv, group, Sq, dh).permute(0, 3, 1, 2, 4)
          .reshape(B, Sq, H, dh))
    return (dq.to(q.dtype), dk.transpose(1, 2).to(k.dtype),
            dv.transpose(1, 2).to(v.dtype))


class FlashAttentionFn(torch.autograd.Function):
    """Differentiable flash attention.  Forward: the prefill kernel with its
    log-sum-exp on a CUDA tensor (``kernels.flash_attention.ops``, which
    counts the launch and raises on what the kernel does not take), the
    plain :func:`_flash_fwd_lse` on a CPU tensor; backward:
    :func:`_flash_bwd` from the saved (q, k, v, out, lse)."""

    @staticmethod
    def forward(ctx, q, k, v, causal, window, q_offset, block_k):
        if q.device.type == "cpu":
            out, lse = _flash_fwd_lse(q, k, v, causal=causal, window=window,
                                      q_offset=q_offset, block_k=block_k)
        else:
            from ..kernels.flash_attention import ops as fa_ops

            out, lse = fa_ops.flash_attention(
                q, k, v, causal=causal, window=window, q_offset=q_offset,
                return_lse=True)
        ctx.save_for_backward(q, k, v, out, lse)
        ctx.args = (causal, window, q_offset, block_k)
        return out

    @staticmethod
    @torch.autograd.function.once_differentiable
    def backward(ctx, do):
        q, k, v, out, lse = ctx.saved_tensors
        causal, window, q_offset, block_k = ctx.args
        # a profiler range while a profiler records (chip_smoke.py phase 6
        # splits the training window's device time by it)
        with profiled("flash.backward"):
            dq, dk, dv = _flash_bwd(q, k, v, out, lse, do, causal=causal,
                                    window=window, q_offset=q_offset,
                                    block_k=block_k)
        return dq, dk, dv, None, None, None, None


def flash_attention_train(q, k, v, *, causal: bool = True,
                          window: Optional[int] = None, q_offset: int = 0,
                          block_k: int = 512):
    """Differentiable flash attention (blockwise-recompute backward).
    q: (B,Sq,H,dh); k, v: (B,Sk,Hkv,dh) -> (B,Sq,H,dh)."""
    return FlashAttentionFn.apply(q, k, v, causal, window, q_offset,
                                  min(block_k, k.shape[1]))


# ---------------------------------------------------------------------------
# Full layers
# ---------------------------------------------------------------------------


def self_attention(
    params, x, cfg, *, positions=None, causal: bool = True,
    impl: str = "cuda", q_offset: int = 0, block_k: int = 512,
    prefix_kv=None,
):
    """Prefill self-attention.  Returns (out, (k, v)) so prefill can seed the
    KV cache.

    ``prefix_kv=(pk, pv)`` prepends an already-computed K/V context of
    length ``Lp`` (shared-prefix admission: the cached prompt pages): the
    queries attend to ``[prefix; self]`` with the causal mask offset by
    ``Lp``, which is exactly rows ``[Lp:]`` of the full-sequence causal
    attention.  Callers pass ``positions`` already offset by ``Lp``; the
    returned (k, v) cover only the fresh suffix.  ``impl="cuda"`` keeps the
    two as separate operands of the prefix kernel; ``"torch"`` and
    ``"naive"`` concatenate.  Requires a non-windowed arch."""
    q, k, v = _project_qkv(params, x, cfg, positions=positions)
    if prefix_kv is not None:
        if cfg.sliding_window:
            raise ValueError("prefix_kv requires a non-sliding-window arch")
        pk, pv = prefix_kv
        Lp = pk.shape[1]
        if impl == "cuda":
            from ..kernels.prefix_attention import ops as pfx_ops

            out = pfx_ops.prefix_flash_attention(
                q, pk.to(k.dtype), pv.to(v.dtype), k, v, q_offset=q_offset)
        elif impl in ("torch", "naive", "flash"):
            k_att = torch.cat([pk.to(k.dtype), k], dim=1)
            v_att = torch.cat([pv.to(v.dtype), v], dim=1)
            if impl == "naive":
                out = naive_attention(q, k_att, v_att, causal=causal,
                                      q_offset=q_offset + Lp)
            else:
                out = chunked_flash_attention(q, k_att, v_att, causal=causal,
                                              q_offset=q_offset + Lp,
                                              block_k=block_k)
        else:
            raise ValueError(f"unknown attn impl {impl!r}")
    elif impl == "cuda":
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
    elif impl == "flash":
        # the autograd.Function: O(S·block) memory through the backward
        out = flash_attention_train(
            q, k, v, causal=causal, window=cfg.sliding_window,
            q_offset=q_offset, block_k=block_k)
    else:
        raise ValueError(f"unknown attn impl {impl!r}")
    B, S, _, _ = q.shape
    y = out.reshape(B, S, cfg.q_dim) @ params["wo"]
    return y, (k, v)


def cross_attention(params, x, enc_kv, cfg, *, impl: str = "cuda"):
    """Decoder cross-attention of x (B, S, D) over precomputed encoder
    (k, v), each (B, S_enc, Hkv, dh): non-causal, no RoPE."""
    B, S, _ = x.shape
    q = (x @ params["wq"]).reshape(B, S, cfg.n_heads, cfg.d_head)
    k, v = enc_kv
    if impl == "cuda":
        from ..kernels.flash_attention import ops as fa_ops

        out = fa_ops.flash_attention(q, k, v, causal=False)
    elif impl == "naive":
        out = naive_attention(q, k, v, causal=False)
    elif impl in ("torch", "flash"):
        # "flash" too, as the reference sends every route but "naive" here
        out = chunked_flash_attention(q, k, v, causal=False)
    else:
        raise ValueError(f"unknown attn impl {impl!r}")
    return out.reshape(B, S, cfg.q_dim) @ params["wo"]


def encode_cross_kv(params, enc_out, cfg):
    """Cross-attention K/V from the encoder output (once per request)."""
    B, S, _ = enc_out.shape
    k = (enc_out @ params["wk"]).reshape(B, S, cfg.n_kv_heads, cfg.d_head)
    v = (enc_out @ params["wv"]).reshape(B, S, cfg.n_kv_heads, cfg.d_head)
    return k, v


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
                     impl: str = "cuda", policy=None):
    """x: (B, 1, D); cur_pos: (B,) int32 absolute position of the new token.

    Writes the new token's K/V at slot ``cur_pos % C`` **in place** (ring
    buffer ≡ plain buffer when C == max_len) and returns (out (B,1,D), the
    same cache views).

    Under a policy whose cache length is sharded over "model"
    (``distributed.spmd.ActivationPolicy`` with ``kv_len_sharded``) the
    cache holds this rank's block of slots: the write goes through
    ``policy.kv_slot_update`` (only the rank that owns the slot writes it),
    attention over the rank's slots returns its ``(m, l)`` beside its
    output, and ``policy.merge_attention`` merges the ranks' outputs.
    """
    B = x.shape[0]
    q, k_new, v_new = _project_qkv(params, x, cfg, positions=cur_pos[:, None])
    C = cache.k.shape[1]
    # RoPE computes in f32: cast to the cache dtype BEFORE the slot write
    k_new = k_new.to(cache.k.dtype)
    v_new = v_new.to(cache.v.dtype)
    len_sharded = getattr(policy, "kv_len_sharded", False)
    if len_sharded:
        policy.kv_slot_update(cache, k_new[:, 0], v_new[:, 0], cur_pos)
    else:
        slot = (cur_pos % C).long()                            # (B,)
        bidx = torch.arange(B, device=x.device)
        cache.k.index_put_((bidx, slot), k_new[:, 0])
        cache.v.index_put_((bidx, slot), v_new[:, 0])
        cache.pos.index_put_((bidx, slot), cur_pos.to(torch.int32))
    # a mesh description's cache is the whole ring: nothing to merge
    stats = len_sharded and policy.merges_length_shards

    if impl == "cuda":
        from ..kernels.decode_attention import ops as da_ops

        out = da_ops.decode_attention(
            q[:, 0], cache.k, cache.v, cache.pos, cur_pos,
            window=cfg.sliding_window, return_stats=stats)
    elif impl in ("torch", "naive"):
        out = _decode_attn_torch(q, cache.k, cache.v, cache.pos, cur_pos,
                                 cfg, return_stats=stats)
        out = (out[0][:, 0],) + out[1:] if stats else out[:, 0]
    else:
        raise ValueError(f"unknown attn impl {impl!r}")
    if len_sharded:
        out = (policy.merge_attention(*out) if stats
               else policy.merge_attention(out))
    y = out.reshape(B, 1, cfg.q_dim) @ params["wo"]
    return y, cache


def _refuse_len_sharded(policy, what: str) -> None:
    """The reference's refusal: the length-sharded slot write
    (``kv_slot_update``) serves dense decode rings only."""
    if getattr(policy, "kv_len_sharded", False):
        raise NotImplementedError(
            f"{what} does not support a length-sharded KV cache")


def _decode_attn_torch(q, k, v, pos, cur_pos, cfg, *,
                       return_stats: bool = False):
    """Counterpart of the reference's ``_decode_attn_xla``.
    q: (B,1,H,dh); k/v: (B,C,Hkv,dh); pos: (B,C); cur_pos: (B,).  Returns
    (B,1,H,dh); with ``return_stats``, (out, m, l): each row's max score
    ``m`` (NEG_INF where no slot is valid) and ``l = sum exp(s - m)``, f32
    (B, H), the decode kernel's statistics.

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
    if return_stats:
        m = s.amax(dim=-1, keepdim=True)
        p = torch.exp(s - m)
        l = p.sum(dim=-1, keepdim=True)
        w = p / l
    else:
        w = torch.softmax(s, dim=-1)
    out = torch.einsum("bgik,bkgd->bgid", w.to(v.dtype).float(), v.float())
    out = out.reshape(B, 1, H, dh).to(q.dtype)
    if not return_stats:
        return out
    return out, m.reshape(B, H), l.reshape(B, H)


def init_kv_cache(cfg, batch: int, max_len: int, *, dtype=None,
                  device="cuda") -> KVCacheView:
    """Cache for ONE attention layer.  Ring-buffer length = min(max_len,
    window) for sliding-window archs — the O(window) decode-memory property."""
    C = min(max_len, cfg.sliding_window) if cfg.sliding_window else max_len
    dt = torch_dtype(dtype or cfg.dtype)
    device = resolve_device(device)
    return KVCacheView(
        k=torch.zeros((batch, C, cfg.n_kv_heads, cfg.d_head), dtype=dt, device=device),
        v=torch.zeros((batch, C, cfg.n_kv_heads, cfg.d_head), dtype=dt, device=device),
        pos=torch.full((batch, C), -1, dtype=torch.int32, device=device),
    )


# ---------------------------------------------------------------------------
# Paged decode path (block-granular KV virtualization)
# ---------------------------------------------------------------------------


class PagedKVView(NamedTuple):
    """One layer's cache as a shared pool of fixed-size pages.

    k, v: (n_pages + 1, page_size, Hkv, dh) — one extra *trash* page at
    index ``n_pages`` that absorbs writes from slots with no mapping
    (inactive, page-fault denied).  Which pool page holds which slot's
    tokens lives outside the view, in the per-slot **page table**
    (B, max_pages) int32 where entry j maps the slot's logical page j
    (absolute positions [j*page_size, (j+1)*page_size)) to a physical page
    id, -1 = unmapped.

    Paged placement is position-indexed — logical page j, offset o *is*
    absolute position j*page_size + o — so a gathered key is valid iff its
    page is mapped and its position is <= cur_pos; no ``pos`` array exists.
    """

    k: torch.Tensor
    v: torch.Tensor

    @property
    def n_pages(self) -> int:
        return self.k.shape[-4] - 1

    @property
    def page_size(self) -> int:
        return self.k.shape[-3]


def init_paged_kv_cache(cfg, n_pages: int, page_size: int, *, dtype=None,
                        device="cuda") -> PagedKVView:
    """Page pool for ONE attention layer (+1 trash page).  Paging assumes a
    full-length cache, i.e. no sliding-window ring (the ring would recycle
    *within* a slot; pages recycle *across* slots)."""
    if cfg.sliding_window:
        raise ValueError("paged KV does not support sliding-window archs")
    dt = torch_dtype(dtype or cfg.dtype)
    device = resolve_device(device)
    shape = (n_pages + 1, page_size, cfg.n_kv_heads, cfg.d_head)
    return PagedKVView(k=torch.zeros(shape, dtype=dt, device=device),
                       v=torch.zeros(shape, dtype=dt, device=device))


def paged_write_target(page_table, cur_pos, page_size: int, n_pages: int):
    """(physical page, offset) that position ``cur_pos`` writes in each slot:
    ``page_table[b, cur_pos // page_size]``, or the trash page ``n_pages``
    when that entry is unmapped or lies past the table.  JAX's gather
    fills an out-of-range index (a slot stopped at ``cur_pos == max_len``
    with ``max_len % page_size == 0``) and the fill lands on the trash
    page; torch would raise, so the index is clamped and masked here.
    ``cur_pos`` is (B,) for decode or (B, W) for a verify window's
    positions; the result has its shape."""
    maxp = page_table.shape[1]
    pos = cur_pos[:, None] if cur_pos.dim() == 1 else cur_pos
    logical = (pos // page_size).long()
    inside = logical < maxp
    pid = torch.gather(page_table, 1, logical.clamp(max=maxp - 1))
    mapped = inside & (pid >= 0) & (pid < n_pages)
    dest = torch.where(mapped, pid, n_pages).long()
    off = (pos % page_size).long()
    if cur_pos.dim() == 1:
        return dest[:, 0], off[:, 0]
    return dest, off


def paged_decode_attention(params, x, cache: PagedKVView, cur_pos, page_table,
                           cfg, write_target, *, impl: str = "cuda",
                           policy=None):
    """Single-token decode against a paged pool.

    x: (B, 1, D); cur_pos: (B,) int32 absolute position of the new token;
    page_table: (B, max_pages) int32 physical page per logical page.

    The new token's K/V is written **in place** at (page_table[b, cur_pos //
    ps], cur_pos % ps) — the trash page when unmapped — before attention
    reads the pool, as in the reference.  ``write_target`` is that
    (page, offset) pair from :func:`paged_write_target`, computed once per
    step by the caller: it is the same for every layer.  ``impl="cuda"``
    walks the page table inside the kernel; ``"torch"`` gathers the slot's pages into a
    (B, max_pages*ps, Hkv, dh) view first (the reference's XLA oracle).
    Returns (out (B, 1, D), the same cache view).  Under an SPMD
    ``policy`` ``x`` holds the rank's rows and heads, and the pool write
    takes every data group's rows (:func:`_pool_write`).  A length-sharded
    ``policy`` is refused, as the reference refuses it: its slot write is
    for dense rings only.
    """
    _refuse_len_sharded(policy, "paged decode")
    B = x.shape[0]
    q, k_new, v_new = _project_qkv(params, x, cfg, positions=cur_pos[:, None])
    cur_pos = cur_pos.to(torch.int32)
    _pool_write(cache, k_new[:, 0], v_new[:, 0], write_target, policy)

    if impl == "cuda":
        from ..kernels.paged_attention import ops as pa_ops

        out = pa_ops.paged_decode_attention(
            q[:, 0], cache.k, cache.v, page_table, cur_pos)[:, None]
    elif impl == "torch":
        kg, vg, mapped, pos_l = _gather_pages(cache, page_table, cfg)
        valid = mapped & (pos_l[None, :] <= cur_pos[:, None])
        out = _verify_attn_torch(q, kg, vg, valid[:, None])  # a window of 1
    else:
        raise ValueError(f"unknown attn impl {impl!r} for paged decode")
    y = out.reshape(B, 1, cfg.q_dim) @ params["wo"]
    return y, cache


def _pool_write(cache: PagedKVView, k_new, v_new, write_target,
                policy=None) -> None:
    """Write the new K/V rows (B, ..., Hkv, dh) at their (page, offset)
    targets in place, cast to the pool's dtype.  Under an SPMD policy the
    rows and targets are first all-gathered over the data axes
    (``policy.pool_rows``): every data group's pool is the whole pool."""
    dest, off = write_target
    k_new, v_new = k_new.to(cache.k.dtype), v_new.to(cache.v.dtype)
    if hasattr(policy, "pool_rows"):
        k_new, v_new, dest, off = policy.pool_rows(k_new, v_new, dest, off)
    cache.k.index_put_((dest, off), k_new)
    cache.v.index_put_((dest, off), v_new)


def _gather_pages(cache: PagedKVView, page_table, cfg):
    """The reference's XLA oracle view of the pool: each slot's pages
    gathered into (B, maxp*ps, Hkv, dh), entries that are unmapped or
    outside [0, n_pages) reading the trash page.  Returns (k, v, mapped
    (B, L) per key row, absolute key positions (L,))."""
    P, ps = cache.n_pages, cache.page_size
    B, maxp = page_table.shape
    L = maxp * ps
    mapped = (page_table >= 0) & (page_table < P)
    gather = torch.where(mapped, page_table, P).long()             # (B, maxp)
    kg = cache.k[gather].reshape(B, L, cfg.n_kv_heads, cfg.d_head)
    vg = cache.v[gather].reshape(B, L, cfg.n_kv_heads, cfg.d_head)
    pos_l = torch.arange(L, device=page_table.device)              # flat == absolute
    return kg, vg, mapped[:, pos_l // ps], pos_l


# ---------------------------------------------------------------------------
# Multi-query verify (speculative decode)
# ---------------------------------------------------------------------------
#
# Draft-and-verify scores a whole window of W candidate tokens in one pass:
# the window's K/V is written into the cache FIRST (positions cur_pos +
# [0, W)), then every query attends with per-query validity ``key position
# <= query position``, which gives within-window causality for free.
# Rejected drafts are rolled back by overwrite-before-attend: the next
# window's write range covers every stale position, and the position mask
# keeps stale entries unattendable meanwhile.


def verify_decode_attention(params, x, cache: KVCacheView, cur_pos, cfg, *,
                            impl: str = "cuda", write_limit=None,
                            policy=None):
    """Multi-query decode attention for draft verification on dense rings.

    x: (B, W, D) hidden states of the W window tokens; cur_pos: (B,)
    absolute position of the window's first token.  Query ``j`` attends
    every cached position ``<= cur_pos + j``, the window's own writes at
    positions ``< j`` included.  The window's K/V is written **in place**
    at ring slots ``(cur_pos + j) % C``; returns (out (B, W, D), the same
    cache views).

    ``write_limit`` (B,) bounds how many of the window's writes stick:
    entries ``j >= write_limit[b]`` keep the old ring contents and the old
    ``pos``, so a window that overruns a slot's budget near ring capacity
    cannot wrap onto live context.  Those positions can never be
    committed, so their attention output is never observed.

    There is no dense multi-query kernel, in the reference as here: both
    ``"cuda"`` and ``"torch"`` run :func:`_verify_attn_torch` (on the card
    when the tensors are there), the reference's own route for
    ``"pallas"`` on dense caches.  A length-sharded ``policy`` is refused,
    as in the reference.
    """
    _refuse_len_sharded(policy, "verify decode")
    if cfg.sliding_window:
        raise ValueError("verify decode does not support sliding-window archs")
    if impl not in ("cuda", "torch"):
        raise ValueError(f"unknown attn impl {impl!r} for verify decode")
    B, W, _ = x.shape
    dev = x.device
    wi = torch.arange(W, dtype=torch.int32, device=dev)
    pos_w = cur_pos.to(torch.int32)[:, None] + wi[None, :]         # (B, W)
    q, k_new, v_new = _project_qkv(params, x, cfg, positions=pos_w)
    C = cache.k.shape[1]
    if W > C:
        raise ValueError(f"verify window {W} exceeds the ring of {C} slots")
    # RoPE computes in f32: cast to the cache dtype BEFORE the ring write
    k_new = k_new.to(cache.k.dtype)
    v_new = v_new.to(cache.v.dtype)

    slot = (pos_w % C).long()                                      # (B, W)
    bidx = torch.arange(B, device=dev)[:, None]
    if write_limit is not None:
        ok = wi[None, :] < write_limit[:, None]                    # (B, W)
        k_new = torch.where(ok[..., None, None], k_new, cache.k[bidx, slot])
        v_new = torch.where(ok[..., None, None], v_new, cache.v[bidx, slot])
        pos_vals = torch.where(ok, pos_w, cache.pos[bidx, slot])
    else:
        pos_vals = pos_w
    # W <= C: a slot's window positions hit distinct ring slots
    cache.k.index_put_((bidx, slot), k_new)
    cache.v.index_put_((bidx, slot), v_new)
    cache.pos.index_put_((bidx, slot), pos_vals)

    pos = cache.pos[:, None, :]
    valid = (pos >= 0) & (pos <= pos_w[:, :, None])                # (B, W, C)
    out = _verify_attn_torch(q, cache.k, cache.v, valid)
    y = out.reshape(B, W, cfg.q_dim) @ params["wo"]
    return y, cache


def _verify_attn_torch(q, k, v, valid):
    """Counterpart of the reference's ``_verify_attn_xla`` and
    ``_paged_verify_attn_xla``.  q: (B,W,H,dh); k/v: (B,L,Hkv,dh); valid:
    (B,W,L), per-query key validity (ring positions on dense caches, the
    gathered pages' mask on the pool).  :func:`_decode_attn_torch` with a
    query-window axis: q scaled in its dtype before the dot, f32
    accumulation."""
    B, W, H, dh = q.shape
    Hkv = k.shape[2]
    group = H // Hkv
    qg = (q.reshape(B, W, Hkv, group, dh).float() / math.sqrt(dh)).to(q.dtype)
    s = torch.einsum("bwgid,bkgd->bwgik", qg.float(), k.float())  # (B,W,Hkv,g,L)
    s = torch.where(valid[:, :, None, None, :], s, NEG_INF)
    w = torch.softmax(s, dim=-1)
    out = torch.einsum("bwgik,bkgd->bwgid", w.to(v.dtype).float(), v.float())
    return out.reshape(B, W, H, dh).to(q.dtype)


def paged_verify_attention(params, x, cache: PagedKVView, cur_pos, page_table,
                           cfg, write_target, *, impl: str = "cuda",
                           policy=None):
    """Multi-query decode attention for draft verification on the page pool.

    x: (B, W, D); cur_pos: (B,) first window position; page_table as in
    :func:`paged_decode_attention`.  The window's K/V is written **in
    place** at ``write_target``, the (B, W) (page, offset) pairs of
    :func:`paged_write_target` for the window's positions, computed once per
    step by the caller: positions whose logical page is unmapped or past
    the table land on the trash page (allocation is the caller's job: the
    spec chunk faults every committable page before the verify).  Trash
    entries are the only duplicate indices of the write, and nothing reads
    the trash page as valid.

    ``impl="cuda"`` walks the page table inside the multi-query kernel
    (:mod:`repro_torch.kernels.paged_attention`); ``"torch"`` is the gather
    oracle.  Returns (out (B, W, D), the same cache view).  An SPMD
    ``policy`` as in :func:`paged_decode_attention`.
    """
    _refuse_len_sharded(policy, "paged decode")
    B, W, _ = x.shape
    pos_w = cur_pos.to(torch.int32)[:, None] + torch.arange(
        W, dtype=torch.int32, device=x.device)[None, :]            # (B, W)
    q, k_new, v_new = _project_qkv(params, x, cfg, positions=pos_w)
    _pool_write(cache, k_new, v_new, write_target, policy)

    if impl == "cuda":
        from ..kernels.paged_attention import ops as pa_ops

        out = pa_ops.paged_verify_attention(q, cache.k, cache.v, page_table,
                                            cur_pos.to(torch.int32))
    elif impl == "torch":
        kg, vg, mapped, pos_l = _gather_pages(cache, page_table, cfg)
        valid = mapped[:, None, :] & (
            pos_l[None, None, :] <= pos_w[:, :, None])             # (B, W, L)
        out = _verify_attn_torch(q, kg, vg, valid)
    else:
        raise ValueError(f"unknown attn impl {impl!r} for paged verify")
    y = out.reshape(B, W, cfg.q_dim) @ params["wo"]
    return y, cache

