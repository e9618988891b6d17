"""Plain PyTorch ground truth of the SSD (Mamba-2) scan, line for line after
``repro.kernels.ssd_scan.ref``.

:func:`ssd_naive` is the O(S²) "duality" form, one masked quadratic over
the whole sequence: the definition of the SSD operator.  The chunked plain
version the kernel is held against, and the CPU route of :mod:`.ops`, is
``repro_torch.models.ssm.ssd_chunked``.
"""

from __future__ import annotations

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
