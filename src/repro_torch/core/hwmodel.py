"""Hardware models for the latency simulator and the roofline machinery.

Copy of ``repro.core.hwmodel`` for the port, which imports nothing of
``repro``; it is pure Python and must keep the reference's behaviour
(``tests/test_torch_vengine.py`` holds the two against each other).

The paper's latency simulator (Eqs. 2-3) is parameterized by the accelerator's
compute parallelism and off-chip bandwidth.  We keep that structure but make it
generic over a :class:`HardwareModel`, with two concrete instantiations:

* :func:`fpga_core` — the paper's Angel-Eye-style ISA accelerator core on a
  Xilinx U200/VU9P: ``Parallelism = 2 * PP * ICP * OCP`` OPs/cycle @ 300 MHz,
  128-bit DDR port per small core (4 small cores share one 512-bit DDR bank).
  Used by the *faithful reproduction* benchmarks (Tables 2-3, Figs. 5-7).

* :func:`h100_chip` — one NVIDIA H100 SXM5 80GB, the card the port runs
  on: 989 TFLOP/s dense bf16, 3.35 TB/s HBM3, 450 GB/s NVLink 4 per
  direction (NVIDIA H100 data sheet).  It prices leases of the port's card
  for the latency simulator and the dynamic compiler.

A "core" is the basic shareable unit of the hardware resource pool (HRP): a
small FPGA core in the paper, one card in the port.

The FPGA model and its constants are the paper's, copied verbatim.  Every
value of :func:`h100_chip` names its source; none is a measurement of the
simulator's output.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Tuple

# ---------------------------------------------------------------------------
# Generic hardware model
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class HardwareModel:
    """Per-core performance model of the basic shareable unit.

    Attributes
    ----------
    name:            human-readable identifier.
    flops_per_sec:   peak OPs/s of one core (MACs count as 2 OPs).
    mem_bw:          off-chip bandwidth of one core, bytes/s.
    bw_eff:          achievable fraction of ``mem_bw`` (paper Eq. 3 ``eff``).
    link_bw:         inter-core interconnect bandwidth, bytes/s (NVLink on a GPU;
                     on the FPGA the cores only synchronize, so this only
                     prices the sync signal and is effectively irrelevant).
    sync_latency:    fixed cost of a layer-wise multi-core barrier, seconds.
    instr_overhead:  fixed issue cost per instruction, seconds.
    compute_tile:    (PP, ICP, OCP)-like quantization of the compute unit.
                     Work is rounded up to multiples of each tile dim, which
                     models the utilization cliff of wide cores on narrow
                     layers (the reason the paper's 16x512 multi-core beats
                     the 1x8192 single core on ResNet50).
    vmem_bytes:      on-chip memory (BRAM/URAM pool, or shared memory on a GPU).
    """

    name: str
    flops_per_sec: float
    mem_bw: float
    bw_eff: float = 0.85
    link_bw: float = 0.0
    sync_latency: float = 1e-6
    instr_overhead: float = 0.0
    compute_tile: Tuple[int, int, int] = (1, 1, 1)
    vmem_bytes: int = 0

    # -- Eq. 2 (generalized): compute time with tile quantization ----------
    def compute_time(self, flops: float, shape: Tuple[int, int, int] | None = None) -> float:
        """Time to execute ``flops`` OPs on one core.

        ``shape`` is the (pixels, in_channels, out_channels) extent of the
        work; when given, each dim is rounded up to the matching compute-tile
        multiple before the peak-rate division, reproducing Eq. 2's
        ``ceil(C_in/ICP) * ceil(C_out/OCP) * ...`` quantization.
        """
        if shape is not None:
            util = 1.0
            for extent, tile in zip(shape, self.compute_tile):
                if extent:   # 0 ⇒ dim not quantized (e.g. depthwise has no
                    util *= extent / (math.ceil(extent / tile) * tile)  # ICP)
            eff_flops = self.flops_per_sec * max(util, 1e-9)
        else:
            eff_flops = self.flops_per_sec
        return flops / eff_flops + self.instr_overhead

    # -- Eq. 3: data-movement time ------------------------------------------
    def memory_time(self, nbytes: float) -> float:
        return nbytes / (self.mem_bw * self.bw_eff) + self.instr_overhead

    def link_time(self, nbytes: float) -> float:
        if self.link_bw <= 0:
            return self.sync_latency
        return nbytes / self.link_bw + self.sync_latency

    def scaled(self, factor: float, name: str | None = None) -> "HardwareModel":
        """A core with ``factor``x compute and bandwidth (for ablations such
        as the paper's MobileNet 2x-bandwidth experiment)."""
        return dataclasses.replace(
            self,
            name=name or f"{self.name}-x{factor:g}",
            flops_per_sec=self.flops_per_sec * factor,
            mem_bw=self.mem_bw * factor,
        )

    def with_bandwidth(self, factor: float) -> "HardwareModel":
        return dataclasses.replace(
            self, name=f"{self.name}-bw{factor:g}x", mem_bw=self.mem_bw * factor
        )


# ---------------------------------------------------------------------------
# Paper constants — Angel-Eye-style FPGA core
# ---------------------------------------------------------------------------

FPGA_FREQ_HZ = 300e6  # all accelerators run at 300 MHz (paper §6.1)


def _split_parallelism(parallelism: int) -> Tuple[int, int, int]:
    """Pick (PP, ICP, OCP) with 2*PP*ICP*OCP == parallelism.

    Follows Angel-Eye practice: grow OCP first, then ICP, then PP, keeping
    OCP >= ICP >= PP.  parallelism must be a power of two >= 16.
    """
    assert parallelism >= 16 and (parallelism & (parallelism - 1)) == 0, parallelism
    budget = parallelism // 2  # PP*ICP*OCP
    pp, icp, ocp = 1, 1, 1
    # round-robin growth OCP -> ICP -> PP yields OCP >= ICP >= PP
    dims = ["ocp", "icp", "pp"]
    i = 0
    while pp * icp * ocp < budget:
        d = dims[i % 3]
        if d == "ocp":
            ocp *= 2
        elif d == "icp":
            icp *= 2
        else:
            pp *= 2
        i += 1
    return pp, icp, ocp


# Calibrated against the paper's measured ResNet50 row (Table 3) — see
# the reference's benchmarks/bench_calibration.py for the fit.  Real conv dataflows reach
# well under peak (im2col padding, pixel-edge stalls, DDR latency), which is
# exactly why the paper's 16x512 pool beats the 1x8192 core.
FPGA_COMPUTE_EFF = 0.48   # achieved fraction of 2*PP*ICP*OCP peak
FPGA_BW_EFF = 0.32        # achieved fraction of DDR port bandwidth


def fpga_core(
    parallelism: int = 512,
    ddr_port_bits: int = 128,
    *,
    compute_eff: float = FPGA_COMPUTE_EFF,
    bw_eff: float = FPGA_BW_EFF,
) -> HardwareModel:
    """One core of the paper's ISA-based CNN accelerator.

    parallelism:   OPs/cycle (= 2*PP*ICP*OCP, Eq. 1).  512 for a small core,
                   8192 for the static single large core.
    ddr_port_bits: DDR data-port width available to this core.  128 bits for a
                   small core; the single large core gets four 512-bit banks.
    """
    pp, icp, ocp = _split_parallelism(parallelism)
    return HardwareModel(
        name=f"fpga-{parallelism}",
        flops_per_sec=parallelism * FPGA_FREQ_HZ * compute_eff,
        mem_bw=ddr_port_bits / 8 * FPGA_FREQ_HZ,
        bw_eff=bw_eff,
        link_bw=0.0,
        sync_latency=2e-6,      # sync_local/sync_global handshake
        instr_overhead=40e-9,   # ~12 cycles instruction issue
        compute_tile=(pp, icp, ocp),
        vmem_bytes=4 << 20,     # BRAM+URAM pool of one small core, ~4 MiB
    )


def fpga_small_core() -> HardwareModel:
    """Basic shareable unit used in the paper's virtualized design (16x512)."""
    return fpga_core(parallelism=512, ddr_port_bits=128)


def fpga_large_core() -> HardwareModel:
    """Static single-core baseline (8192 parallelism, 4 DDR banks)."""
    return fpga_core(parallelism=8192, ddr_port_bits=4 * 512)


# ---------------------------------------------------------------------------
# NVIDIA H100 SXM5 80GB — the port's card
# ---------------------------------------------------------------------------

H100_PEAK_FLOPS = 989e12     # dense bf16 tensor-core OPs/s (NVIDIA H100 data
                             # sheet, SXM5; chip_smoke.py's BF16_FLOPS_PER_S)
H100_HBM_BW = 3.35e12        # HBM3 bytes/s (same data sheet; chip_smoke.py's
                             # HBM_BYTES_PER_S)
H100_NVLINK_BW = 450e9       # NVLink 4 bytes/s per direction (same data sheet)
H100_SMEM = 132 * 228 * 1024  # shared memory: 132 SMs x 228 KiB
H100_LAUNCH_FLOOR = 2.1e-6   # seconds: the least device time of one launch, a
                             # one-element fill timed by chip_smoke.py
                             # --kernel-times on NVIDIA H100 80GB HBM3, 700 W
H100_CTA_TILE = (128, 64, 128)  # the wgmma matmul's CTA tile (TC_BM, TC_BK,
                                # TC_BN in csrc/matmul.cu)


def h100_chip() -> HardwareModel:
    """One NVIDIA H100 SXM5 80GB as one core of the pool.  ``bw_eff`` is the
    dataclass default: the achievable share of HBM bandwidth is not
    measured for this model."""
    return HardwareModel(
        name="h100-sxm5",
        flops_per_sec=H100_PEAK_FLOPS,
        mem_bw=H100_HBM_BW,
        link_bw=H100_NVLINK_BW,
        sync_latency=H100_LAUNCH_FLOOR,
        instr_overhead=H100_LAUNCH_FLOOR,
        compute_tile=H100_CTA_TILE,
        vmem_bytes=H100_SMEM,
    )
