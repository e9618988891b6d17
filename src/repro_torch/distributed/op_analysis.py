"""Roofline terms of a traced program on the H100, and collective totals.

Counterpart of ``repro.distributed.hlo_analysis``.  The reference reads
FLOPs, bytes and collective bytes out of a compiled XLA module; the port
counts them over the aten ops a program dispatches
(:mod:`.op_static`), and this module turns those counts into the three
roofline terms on NVIDIA H100 SXM peaks:

    compute    = flops             / (chips · 989e12 FLOP/s, dense bf16)
    memory     = bytes             / (chips · 3.35e12 B/s, HBM3)
    collective = collective bytes  / (chips · 450e9 B/s, NVLink 4)

The peaks are NVIDIA's H100 SXM5 data sheet's, held once in
``core/hwmodel.py`` (``H100_PEAK_FLOPS``, ``H100_HBM_BW``,
``H100_NVLINK_BW``).  The field names are the reference's (``hlo_flops``,
``hlo_bytes``) so a record reads the same in both packages; here they
hold the op counter's totals.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Optional

import torch

from ..core.hwmodel import H100_HBM_BW, H100_NVLINK_BW, H100_PEAK_FLOPS

#: bytes of one element of each dtype a program may carry (the dtypes this
#: torch build has)
DTYPE_BYTES = {
    getattr(torch, name): nb for name, nb in (
        ("bool", 1), ("uint8", 1), ("int8", 1), ("float8_e4m3fn", 1),
        ("float8_e5m2", 1), ("int16", 2), ("float16", 2), ("bfloat16", 2),
        ("int32", 4), ("uint32", 4), ("float32", 4), ("int64", 8),
        ("uint64", 8), ("float64", 8), ("complex64", 8), ("complex128", 16))
    if hasattr(torch, name)
}

#: one H100 SXM5 (NVIDIA data sheet), from ``core.hwmodel``
H100_SXM = {
    "peak_flops": H100_PEAK_FLOPS,   # dense bf16 tensor-core FLOP/s
    "hbm_bw": H100_HBM_BW,           # HBM3 bytes/s
    "nvlink_bw": H100_NVLINK_BW,     # NVLink 4 bytes/s a direction
}


def tensor_bytes(t: torch.Tensor) -> int:
    """Bytes of ``t``'s elements (its view, not its storage)."""
    return t.numel() * DTYPE_BYTES.get(t.dtype, t.element_size())


@dataclasses.dataclass
class CollectiveStats:
    bytes_by_op: Dict[str, float]
    count_by_op: Dict[str, int]

    @property
    def total_bytes(self) -> float:
        return sum(self.bytes_by_op.values())

    @property
    def total_count(self) -> int:
        return sum(self.count_by_op.values())

    def summary(self) -> str:
        parts = [
            f"{op}: {cnt}x {self.bytes_by_op[op] / 1e9:.3f} GB"
            for op, cnt in sorted(self.count_by_op.items())
        ]
        return "; ".join(parts) if parts else "none"


@dataclasses.dataclass
class Roofline:
    """The three roofline terms of a program over ``chips`` H100s.
    ``collective_bytes`` is None where no collective was counted (a program
    traced for one card, laid out over a mesh it never ran on): then
    ``t_collective`` is None and ``bound`` picks between compute and
    memory."""

    chips: int
    hlo_flops: float
    hlo_bytes: float
    collective_bytes: Optional[float]
    model_flops: float = 0.0

    @property
    def t_compute(self) -> float:
        return self.hlo_flops / (self.chips * H100_SXM["peak_flops"])

    @property
    def t_memory(self) -> float:
        return self.hlo_bytes / (self.chips * H100_SXM["hbm_bw"])

    @property
    def t_collective(self) -> Optional[float]:
        if self.collective_bytes is None:
            return None
        return self.collective_bytes / (self.chips * H100_SXM["nvlink_bw"])

    def _terms(self) -> Dict[str, float]:
        terms = {"compute": self.t_compute, "memory": self.t_memory}
        if self.t_collective is not None:
            terms["collective"] = self.t_collective
        return terms

    @property
    def bound(self) -> str:
        terms = self._terms()
        return max(terms, key=terms.get)

    @property
    def t_bound(self) -> float:
        return max(self._terms().values())

    @property
    def useful_flops_ratio(self) -> float:
        """model FLOPs / counted FLOPs: remat and redundancy show below 1."""
        return self.model_flops / self.hlo_flops if self.hlo_flops else 0.0

    @property
    def roofline_fraction(self) -> float:
        """compute term / dominant term: 1.0 is compute-bound."""
        return self.t_compute / self.t_bound if self.t_bound else 0.0

    def as_dict(self) -> dict:
        return {
            "chips": self.chips,
            "hlo_flops": self.hlo_flops,
            "hlo_bytes": self.hlo_bytes,
            "collective_bytes": self.collective_bytes,
            "model_flops": self.model_flops,
            "t_compute": self.t_compute,
            "t_memory": self.t_memory,
            "t_collective": self.t_collective,
            "bound": self.bound,
            "useful_flops_ratio": self.useful_flops_ratio,
            "roofline_fraction": self.roofline_fraction,
        }


__all__ = ["CollectiveStats", "DTYPE_BYTES", "H100_SXM", "Roofline",
           "tensor_bytes"]
