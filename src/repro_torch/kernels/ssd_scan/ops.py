"""Public wrapper for the SSD scan in the model layout.

``ssd`` is what ``models.ssm.ssm_forward`` calls when ``impl == "cuda"``.
It takes ``L = min(chunk, S)`` and pads a ragged tail with ``dt = 0``
(``models.ssm.pad_to_chunks``), as ``ssd_chunked`` does, where the
reference's Pallas route asserts ``S % chunk == 0`` (ROADMAP.md Queue 3);
the padded rows are cut off y.  Otherwise the inputs reach the kernel as
the caller holds them: it reads the model layout through strides and forms
``dA = dt · A`` itself, where ``repro.kernels.ssd_scan.ops`` moves the
head axis ahead of the sequence.  The route follows the tensor's device: a
CPU tensor takes the plain version (``models.ssm.ssd_chunked`` on the
padded input), a CUDA tensor launches the kernel or raises.  There is no
fallback between the two, nor between the kernel's routes
(``kernel.ssd_route``).  ``ssd.launches`` counts calls that reached the
card (a bf16 call launches five kernels, an f32 call one), and
``ssd.route_calls`` counts them by route.  A ``meta`` tensor launches
nothing: the wrapper returns empty outputs and adds :func:`ssd_cost` to the
open cost sinks (``distributed.op_static``).
"""

from __future__ import annotations

import torch

from ..common import cdiv, count_launch, record_kernel
from ...models.ssm import pad_to_chunks, ssd_chunked
from .kernel import ROUTES, ssd_route, ssd_scan_kernel


def ssd(x, dt, A, Bm, Cm, *, chunk: int, return_state: bool = False):
    """Model layout: x (B, S, nh, hd); dt (B, S, nh); A (nh,); Bm/Cm
    (B, S, G, N).  Returns y (B, S, nh, hd) [, final state (B, nh, hd, N)
    f32]."""
    S = x.shape[1]
    if x.device.type == "meta":
        record_kernel(ssd, ssd_cost(x, dt, A, Bm, Cm, chunk=chunk))
        B, _, nh, hd = x.shape
        y = x.new_empty(x.shape)
        state = x.new_empty((B, nh, hd, Bm.shape[3]), dtype=torch.float32)
        return (y, state) if return_state else y
    x, dt, Bm, Cm, L = pad_to_chunks(x, dt, Bm, Cm, chunk)
    if x.device.type == "cpu":
        y, state = ssd_chunked(x, dt, A, Bm, Cm, chunk=L, return_state=True)
    else:
        y, state = ssd_scan_kernel(x, dt.float(), A.float(), Bm, Cm, chunk=L)
        count_launch(ssd, ssd_route(x.dtype), by="route_calls")
    y = y[:, :S]
    if return_state:
        return y, state
    return y


def ssd_cost(x, dt, A, Bm, Cm, *, chunk: int):
    """(flops, bytes) of one call: x, dt, A, B, C read once, y and the f32
    final state written once; the causal (row, col) pairs of each chunk
    (a ragged tail padded to a whole chunk, as the call does): C·Bᵀ once a
    group, its product with x a head, and the state's read and update a
    head."""
    B, S, nh, hd = x.shape
    G, N = Bm.shape[2], Bm.shape[3]
    L = min(chunk, S)
    nc, pairs = cdiv(S, L), L * (L + 1) // 2
    n_bytes = (2 * B * S * nh * hd * x.element_size()
               + B * S * nh * dt.element_size() + nh * A.element_size()
               + B * S * G * N * (Bm.element_size() + Cm.element_size())
               + B * nh * hd * N * 4)
    flops = 2.0 * B * nc * (G * pairs * N + nh * (pairs * hd + 2 * L * N * hd))
    return flops, n_bytes


ssd.launches = 0
ssd.cost = ssd_cost
ssd.route_calls = dict.fromkeys(ROUTES, 0)
