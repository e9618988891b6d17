"""Mamba-2 (SSD, state-space duality) blocks. [arXiv:2405.21060]

Counterpart of ``repro.models.ssm``.  Prefill runs the **chunked SSD
algorithm**: the sequence is cut into chunks of length L; within a chunk the
recurrence is a masked quadratic form, and the (hd, N) state per head is
carried from chunk to chunk.  ``impl="cuda"`` runs it through the
hand-written kernel (``repro_torch.kernels.ssd_scan``: a CPU tensor takes
the plain version, a CUDA tensor launches the kernel); ``"torch"``,
``"naive"`` and the training path's ``"flash"`` run :func:`ssd_chunked`,
the plain PyTorch oracle (differentiable by autograd), as the reference's
every other route runs its ``ssd_chunked``.

Decode is the O(1) recurrent update ``state = state·exp(dt·A) +
dt·x⊗B``, ``y = C·state + D·x``.  :func:`ssm_decode` writes the new state
**in place** into the :class:`SSMState` it is given (views of the stacked
decode caches), as ``attention.decode_attention`` writes its cache views.

Heads follow Mamba-2: ``d_inner = expand·d_model`` is split into ``nh =
d_inner / head_dim`` heads, and B and C are shared across ``nh / n_groups``
heads.  The block reads its widths from its params, so an SPMD rank
(``distributed.spmd``) runs it on its own heads: its ``xBC`` channels,
the groups its heads read (``policy.ssm_groups`` where B and C are whole),
and the gated norm's sum of squares summed over "model".  bf16 rounds where the reference rounds: after each shifted add of
the causal conv, the SiLU outputs, and the intra-chunk scores before their
product with x.
"""

from __future__ import annotations

import math
from typing import NamedTuple, Tuple

import torch
import torch.nn.functional as F

from ..device import resolve_device, torch_dtype
from .layers import gated_rmsnorm, init_dense, init_rmsnorm


# ---------------------------------------------------------------------------
# Params
# ---------------------------------------------------------------------------


def ssm_dims(cfg):
    s = cfg.ssm
    d_in = s.d_inner(cfg.d_model)
    nh = s.n_ssm_heads(cfg.d_model)
    d_bc = 2 * s.n_groups * s.d_state
    return d_in, nh, d_bc


def init_ssm(gen: torch.Generator, cfg, *, device=None):
    """Separate projection matrices (wz/wx/wb/wc/wdt), as the reference
    keeps them, so the weight bridge maps leaf for leaf.  ``A_log``, ``D``
    and ``dt_bias`` are f32."""
    s = cfg.ssm
    d_in, nh, d_bc = ssm_dims(cfg)
    gn = s.n_groups * s.d_state
    dev = device or gen.device
    dt = cfg.dtype
    conv_w = torch.randn((s.d_conv, d_in + d_bc), generator=gen,
                         dtype=torch.float32, device=dev) / math.sqrt(s.d_conv)
    return {
        "wz": init_dense(gen, cfg.d_model, d_in, dt, device=dev)["w"],
        "wx": init_dense(gen, cfg.d_model, d_in, dt, device=dev)["w"],
        "wb": init_dense(gen, cfg.d_model, gn, dt, device=dev)["w"],
        "wc": init_dense(gen, cfg.d_model, gn, dt, device=dev)["w"],
        "wdt": init_dense(gen, cfg.d_model, nh, dt, device=dev)["w"],
        "conv_w": conv_w.to(torch_dtype(dt)),
        "A_log": torch.zeros((nh,), dtype=torch.float32, device=dev),  # A = -1
        "D": torch.ones((nh,), dtype=torch.float32, device=dev),
        "dt_bias": torch.zeros((nh,), dtype=torch.float32, device=dev),
        "norm": init_rmsnorm(d_in, dt, device=dev),
        "out_proj": init_dense(gen, d_in, cfg.d_model, dt, device=dev)["w"],
    }


# ---------------------------------------------------------------------------
# Causal depthwise conv (d_conv is tiny: shifted adds)
# ---------------------------------------------------------------------------


def causal_conv(x, conv_w):
    """x: (B, S, C); conv_w: (K, C).  y[t] = sum_i w[i] * x[t - (K-1) + i],
    as K shifted adds in the reference's order (bf16 rounds after each add,
    which ``F.conv1d`` would not do)."""
    K = conv_w.shape[0]
    B, S, C = x.shape
    pad = torch.zeros((B, K - 1, C), dtype=x.dtype, device=x.device)
    xp = torch.cat([pad, x], dim=1)
    y = torch.zeros_like(x)
    for i in range(K):
        y = y + xp[:, i:i + S, :] * conv_w[i]
    return y


def causal_conv_step(x_t, conv_state, conv_w):
    """One decode step.  x_t: (B, C); conv_state: (B, K-1, C), oldest first.
    Returns (y_t, new_conv_state)."""
    K = conv_w.shape[0]
    window = torch.cat([conv_state, x_t[:, None, :]], dim=1)       # (B, K, C)
    y_t = torch.einsum("bkc,kc->bc", window, conv_w)
    return y_t, (window[:, 1:, :] if K > 1 else conv_state)


# ---------------------------------------------------------------------------
# SSD chunked scan (plain PyTorch; the oracle of kernels/ssd_scan)
# ---------------------------------------------------------------------------


def _segsum(dA):
    """dA: (..., L).  M[..., i, j] = sum_{j < t <= i} dA[t] for i >= j, -inf
    above the diagonal: the log of the causal decay matrix."""
    L = dA.shape[-1]
    cs = torch.cumsum(dA, dim=-1)
    M = cs[..., :, None] - cs[..., None, :]
    mask = torch.tril(torch.ones((L, L), dtype=torch.bool, device=dA.device))
    return torch.where(mask, M, -math.inf)


def pad_to_chunks(x, dt, Bm, Cm, chunk: int):
    """``L = min(chunk, S)`` and the inputs padded along S to a multiple of
    L with zeros.  ``dt = 0`` padding is exact: dA = 0 leaves the state
    untouched and the padded rows weigh 0 in every sum.  Returns
    (x, dt, Bm, Cm, L)."""
    S = x.shape[1]
    L = min(chunk, S)
    pad = (-S) % L
    if pad:
        x = F.pad(x, (0, 0, 0, 0, 0, pad))
        dt = F.pad(dt, (0, 0, 0, pad))
        Bm = F.pad(Bm, (0, 0, 0, 0, 0, pad))
        Cm = F.pad(Cm, (0, 0, 0, 0, 0, pad))
    return x, dt, Bm, Cm, L


def ssd_chunked(x, dt, A, Bm, Cm, *, chunk: int, return_state: bool = False):
    """Chunked SSD.

    x:  (B, S, nh, hd)   inputs per head
    dt: (B, S, nh)       discretisation steps (after softplus), f32
    A:  (nh,)            negative-real state decay, f32
    Bm: (B, S, G, N)     input projections (shared across nh/G heads)
    Cm: (B, S, G, N)     output projections
    Returns y (B, S, nh, hd) [, final state (B, nh, hd, N) f32].

    A ragged tail is padded with ``dt = 0`` (:func:`pad_to_chunks`) and cut
    off y.
    """
    Bsz, S_out, nh, hd = x.shape
    G, N = Bm.shape[2], Bm.shape[3]
    x, dt, Bm, Cm, L = pad_to_chunks(x, dt, Bm, Cm, chunk)
    S = x.shape[1]
    nc = S // L
    rep = nh // G

    xc = x.reshape(Bsz, nc, L, nh, hd)
    dtc = dt.reshape(Bsz, nc, L, nh)
    Bc = Bm.reshape(Bsz, nc, L, G, N)
    Cc = Cm.reshape(Bsz, nc, L, G, N)
    dA = dtc * A[None, None, None, :]                      # (B, nc, L, nh)
    cum = torch.cumsum(dA, dim=2)                          # within-chunk

    state = torch.zeros((Bsz, nh, hd, N), dtype=torch.float32, device=x.device)
    ys = []
    for c in range(nc):
        xk, dtk, Bk, Ck = xc[:, c], dtc[:, c], Bc[:, c], Cc[:, c]
        dAk, cumk = dA[:, c], cum[:, c]
        # intra-chunk (quadratic duality form), decay per head (B, nh, L, L)
        decay = torch.exp(_segsum(dAk.movedim(-1, 1)))
        CB = torch.einsum("blgn,bmgn->bglm", Ck, Bk)       # (B, G, L, L)
        CB = CB.repeat_interleave(rep, dim=1)              # (B, nh, L, L)
        scores = CB * decay * dtk.movedim(-1, 1)[:, :, None, :]
        y_intra = torch.einsum("bhlm,bmhp->blhp", scores.to(xk.dtype), xk)
        # inter-chunk: the carried state, read before this chunk's update
        Crep = Ck.repeat_interleave(rep, dim=2)            # (B, L, nh, N)
        # bf16 C against the f32 state promotes to f32, as in JAX
        y_inter = torch.einsum("blhn,bhpn->blhp", Crep.float(), state)
        y_inter = y_inter * torch.exp(cumk)[..., None]
        # state update
        total = cumk[:, -1, :]                             # (B, nh)
        w = torch.exp(total[:, None, :] - cumk) * dtk      # (B, L, nh)
        Brep = Bk.repeat_interleave(rep, dim=2)            # (B, L, nh, N)
        state = state * torch.exp(total)[:, :, None, None] + torch.einsum(
            "blhp,blhn,blh->bhpn", xk.float(), Brep.float(), w)
        ys.append(y_intra + y_inter.to(xk.dtype))
    y = torch.stack(ys, dim=1).reshape(Bsz, S, nh, hd)[:, :S_out]
    if return_state:
        return y, state
    return y


# ---------------------------------------------------------------------------
# Block forward (prefill) and decode step
# ---------------------------------------------------------------------------


class SSMState(NamedTuple):
    conv: torch.Tensor   # (B, K-1, d_in + d_bc) in the model dtype
    ssm: torch.Tensor    # (B, nh, hd, N) f32


def init_ssm_state(cfg, batch: int, *, device="cuda") -> SSMState:
    s = cfg.ssm
    d_in, nh, d_bc = ssm_dims(cfg)
    device = resolve_device(device)
    return SSMState(
        conv=torch.zeros((batch, s.d_conv - 1, d_in + d_bc),
                         dtype=torch_dtype(cfg.dtype), device=device),
        ssm=torch.zeros((batch, nh, s.head_dim, s.d_state),
                        dtype=torch.float32, device=device),
    )


def _split_proj(params, x):
    """Per-stream projections; xBC is the concat the causal conv runs over
    (depthwise, so conv(concat) == concat(per-segment conv))."""
    z = x @ params["wz"]
    xc = x @ params["wx"]
    bc = x @ params["wb"]
    cc = x @ params["wc"]
    dt = x @ params["wdt"]
    return z, torch.cat([xc, bc, cc], dim=-1), dt


def _local(params, cfg, policy):
    """This layer's dims from its blocks (an SPMD rank holds ``nh / model``
    heads, which a config derived from ``d_model`` cannot express): the
    x channels, heads and B (or C) channels its ``wx``, ``wdt`` and ``wb``
    hold, and the group selection of its heads where B and C are whole
    (``policy.ssm_groups``: a slice or per-head list of groups, or None)."""
    d_loc, nh = params["wx"].shape[-1], params["wdt"].shape[-1]
    return d_loc, nh, params["wb"].shape[-1], getattr(policy, "ssm_groups",
                                                      None)


def _norm(params, y, z, cfg, policy):
    """The gated norm over all of ``d_inner``: where the policy splits the
    heads over "model", this rank's sum of squares is all-reduced in f32
    (``policy.model_sum``) and divided by the whole ``d_inner``."""
    if not getattr(policy, "ssm_split", False):
        return gated_rmsnorm(params["norm"], y, z, eps=cfg.norm_eps)
    return gated_rmsnorm(params["norm"], y, z, eps=cfg.norm_eps,
                         width=ssm_dims(cfg)[0],
                         sum_fn=lambda ss: policy.model_sum(ss, "ssm-norm"))


def ssm_forward(params, x, cfg, *, impl: str = "cuda",
                return_state: bool = False, policy=None):
    """x: (B, S, d_model) -> (B, S, d_model); the prefill path.
    ``return_state=True`` also returns the :class:`SSMState` after the last
    token (what decode continues from).  Under an SPMD ``policy`` the
    params are the rank's heads (``distributed.spmd``): the output is this
    rank's partial sum, which the caller sums at ``"attn_out"``."""
    s = cfg.ssm
    N, hd = s.d_state, s.head_dim
    d_loc, nh, gn, groups = _local(params, cfg, policy)
    B, S, _ = x.shape

    z, xBC_raw, dt = _split_proj(params, x)
    xBC = causal_conv(xBC_raw, params["conv_w"])
    xBC = F.silu(xBC.float()).to(x.dtype)
    xs = xBC[..., :d_loc].reshape(B, S, nh, hd)
    Bm = xBC[..., d_loc:d_loc + gn].reshape(B, S, gn // N, N)
    Cm = xBC[..., d_loc + gn:].reshape(B, S, gn // N, N)
    if groups is not None:
        Bm, Cm = Bm[:, :, groups], Cm[:, :, groups]
    dt = F.softplus(dt.float() + params["dt_bias"])
    A = -torch.exp(params["A_log"])

    if impl == "cuda":
        from ..kernels.ssd_scan import ops as ssd_ops

        y, final_state = ssd_ops.ssd(xs, dt, A, Bm, Cm, chunk=s.chunk,
                                     return_state=True)
    elif impl in ("torch", "naive", "flash"):
        # every route but the kernel's, as in the reference (ssm.py:232);
        # "flash" is the training path's name, and the scan has no
        # backward kernel in either package
        y, final_state = ssd_chunked(xs, dt, A, Bm, Cm, chunk=s.chunk,
                                     return_state=True)
    else:
        raise ValueError(f"unknown ssm impl {impl!r}")
    y = y + params["D"][None, None, :, None].to(y.dtype) * xs
    y = _norm(params, y.reshape(B, S, d_loc), z, cfg, policy)
    out = y @ params["out_proj"]
    if not return_state:
        return out
    conv_state = xBC_raw[:, S - (s.d_conv - 1):, :]
    return out, SSMState(conv=conv_state, ssm=final_state)


def ssm_decode(params, x, state: SSMState, cfg, *,
               policy=None) -> Tuple[torch.Tensor, SSMState]:
    """One token.  x: (B, 1, d_model) -> (y (B, 1, d_model), state), with
    ``state``'s tensors updated in place to the state after the token.
    Under an SPMD ``policy`` the state is the rank's block, as in
    :func:`ssm_forward`."""
    s = cfg.ssm
    N, hd = s.d_state, s.head_dim
    d_loc, nh, gn, groups = _local(params, cfg, policy)
    B = x.shape[0]

    z, xBC, dt = _split_proj(params, x[:, 0, :])
    xBC, conv_new = causal_conv_step(xBC, state.conv, params["conv_w"])
    xBC = F.silu(xBC.float()).to(x.dtype)
    xt = xBC[..., :d_loc].reshape(B, nh, hd)
    Bt = xBC[..., d_loc:d_loc + gn].reshape(B, gn // N, N)
    Ct = xBC[..., d_loc + gn:].reshape(B, gn // N, N)
    if groups is not None:
        Bt, Ct = Bt[:, groups], Ct[:, groups]
    dt = F.softplus(dt.float() + params["dt_bias"])               # (B, nh)
    A = -torch.exp(params["A_log"])
    dA = torch.exp(dt * A)                                        # (B, nh)

    rep = nh // Bt.shape[1]
    Brep = Bt.repeat_interleave(rep, dim=1)                       # (B, nh, N)
    Crep = Ct.repeat_interleave(rep, dim=1)
    # state * dA + dt * x ⊗ B, rounded as the reference's expression is
    state.ssm.mul_(dA[..., None, None]).add_(
        dt[..., None, None] * xt.float()[..., :, None]
        * Brep.float()[..., None, :])
    state.conv.copy_(conv_new)
    y = torch.einsum("bhpn,bhn->bhp", state.ssm, Crep.float())
    y = y.to(x.dtype) + params["D"][None, :, None].to(x.dtype) * xt
    y = _norm(params, y.reshape(B, d_loc), z, cfg, policy)
    return (y @ params["out_proj"])[:, None, :], state


__all__ = [
    "SSMState", "causal_conv", "causal_conv_step", "init_ssm",
    "init_ssm_state", "ssd_chunked", "ssm_decode", "ssm_dims", "ssm_forward",
]
