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
``ssd.route_calls`` counts them by route.
"""

from __future__ import annotations

from ..common import count_launch
from ...models.ssm import pad_to_chunks, ssd_chunked
from .kernel import ROUTES, ssd_route, ssd_scan_kernel


def ssd(x, dt, A, Bm, Cm, *, chunk: int, return_state: bool = False):
    """Model layout: x (B, S, nh, hd); dt (B, S, nh); A (nh,); Bm/Cm
    (B, S, G, N).  Returns y (B, S, nh, hd) [, final state (B, nh, hd, N)
    f32]."""
    S = x.shape[1]
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


ssd.launches = 0
ssd.route_calls = dict.fromkeys(ROUTES, 0)
