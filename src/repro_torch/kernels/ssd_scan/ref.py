"""Plain PyTorch ground truth of the SSD (Mamba-2) scan, line for line after
``repro.kernels.ssd_scan.ref``.

:func:`ssd_naive` is the O(S²) "duality" form, one masked quadratic over
the whole sequence: the definition of the SSD operator.
:func:`ssd_passes_ref` is the decomposition the CUDA kernel's bf16 route
computes, pass by pass, with its rounding points optionally modelled.  The chunked plain
version the kernel is held against, and the CPU route of :mod:`.ops`, is
``repro_torch.models.ssm.ssd_chunked``.
"""

from __future__ import annotations

import math

import torch


def ssd_naive(x, dt, A, Bm, Cm):
    """x: (B, S, nh, hd); dt: (B, S, nh); A: (nh,); Bm, Cm: (B, S, G, N).
    Returns y (B, S, nh, hd) in f32:

        y_i = sum_{j<=i} exp(sum_{t in (j, i]} dt_t A) * dt_j * (C_i·B_j) * x_j
    """
    Bsz, S, nh, hd = x.shape
    G = Bm.shape[2]
    rep = nh // G
    dA = dt * A[None, None, :]                           # (B, S, nh)
    cum = torch.cumsum(dA, dim=1)
    M = cum[:, :, None, :] - cum[:, None, :, :]          # (B, i, j, nh)
    M = M.movedim(-1, 1)                                 # (B, nh, i, j)
    mask = torch.tril(torch.ones((S, S), dtype=torch.bool, device=x.device))
    decay = torch.where(mask[None, None], torch.exp(M), 0.0)
    CB = torch.einsum("bign,bjgn->bgij", Cm.float(), Bm.float())
    CB = CB.repeat_interleave(rep, dim=1)                # (B, nh, i, j)
    scores = CB * decay * dt.movedim(-1, 1)[:, :, None, :]
    return torch.einsum("bhij,bjhp->bihp", scores, x.float())


def ssd_passes_ref(x, dt, A, Bm, Cm, *, chunk: int, bf16_points: bool = False,
                   split_state: bool = True):
    """The CUDA kernel's bf16 route in plain PyTorch: Mamba-2's chunked
    decomposition of the SSD as the kernel's five passes compute it, in
    f32.  Model layout as :func:`ssd_naive`; a ragged tail is padded with
    ``dt = 0`` (``models.ssm.pad_to_chunks``).  Returns y (B, S, nh, hd) in
    x's dtype and the final state (B, nh, hd, N) f32.

    1. cum: the in-chunk prefix sum of dA = dt · A;
    2. C·Bᵀ once per (batch, chunk, group);
    3. each chunk's own state sum_j w_j x_jᵀ B_j, w_j = e^(cum_L − cum_j) dt_j;
    4. the states passed across chunks: the state entering each chunk and
       the final one;
    5. y = (C·Bᵀ · e^(cum_i − cum_j) dt_j, masked to j <= i) x
       + e^(cum_i) C_i · state_inᵀ.

    ``bf16_points`` rounds where the kernel rounds: C·Bᵀ, the scaled scores
    and the entering state to bf16, the weighted operand of step 3 to a
    bf16 hi + lo pair (``split_state``; a single bf16 rounding without it),
    and y to bf16 once."""
    from ...models.ssm import pad_to_chunks

    bf16, f32 = torch.bfloat16, torch.float32

    def rnd(t):
        return t.to(bf16).to(f32) if bf16_points else t

    Bsz, S_out, nh, hd = x.shape
    G, N = Bm.shape[2], Bm.shape[3]
    x, dt, Bm, Cm, L = pad_to_chunks(x, dt, Bm, Cm, chunk)
    S = x.shape[1]
    nc, rep = S // L, nh // G
    xc = x.float().reshape(Bsz, nc, L, nh, hd)
    dtc = dt.float().reshape(Bsz, nc, L, nh)
    Bc = Bm.float().reshape(Bsz, nc, L, G, N)
    Cc = Cm.float().reshape(Bsz, nc, L, G, N)
    # 1.
    cum = torch.cumsum(dtc * A.float(), dim=2)                 # (B, nc, L, nh)
    total = cum[:, :, -1]                                      # (B, nc, nh)
    # 2.
    CB = rnd(torch.einsum("bcign,bcjgn->bcgij", Cc, Bc))        # (B, nc, G, L, L)
    # 3.
    wx = xc * (torch.exp(total[:, :, None] - cum) * dtc)[..., None]
    Brep = Bc.repeat_interleave(rep, dim=3)                    # (B, nc, L, nh, N)
    if bf16_points and split_state:
        hi = wx.to(bf16).to(f32)
        parts = (hi, (wx - hi).to(bf16).to(f32))
    else:
        parts = (rnd(wx),)
    states = sum(torch.einsum("bcjhp,bcjhn->bchpn", part, Brep)
                 for part in parts)                            # (B, nc, nh, hd, N)
    # 4.
    state = torch.zeros((Bsz, nh, hd, N), dtype=f32, device=x.device)
    state_in = []
    for c in range(nc):
        state_in.append(state)
        state = state * torch.exp(total[:, c])[..., None, None] + states[:, c]
    state_in = rnd(torch.stack(state_in, dim=1))               # (B, nc, nh, hd, N)
    # 5.
    mask = torch.tril(torch.ones((L, L), dtype=torch.bool, device=x.device))
    seg = (cum[:, :, :, None, :] - cum[:, :, None, :, :]).movedim(-1, 2)
    decay = torch.exp(seg.masked_fill(~mask, -math.inf))       # (B, nc, nh, i, j)
    scale = decay * dtc.movedim(-1, 2)[:, :, :, None, :]
    scores = rnd(CB.repeat_interleave(rep, dim=2) * scale)
    y = torch.einsum("bchij,bcjhp->bcihp", scores, xc)
    Crep = Cc.repeat_interleave(rep, dim=3)                    # (B, nc, L, nh, N)
    y = y + torch.einsum("bcihn,bchpn->bcihp", Crep, state_in) \
        * torch.exp(cum)[..., None]
    y = y.reshape(Bsz, S, nh, hd)[:, :S_out]
    return y.to(bf16 if bf16_points else x.dtype), state
