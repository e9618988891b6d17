"""Tiling-based Instruction Frame Packages (IFPs) — paper §5.2.1.

Copy of ``repro.core.ifp`` for the port, which imports nothing of
``repro``; it is pure Python and must keep the reference's behaviour
(``tests/test_torch_vengine.py`` holds the two against each other).

The static compiler tiles every layer's *output* along one of two dimensions:

* ``Strategy.WIDTH``  — same weights, different output columns (pixels for
  CNNs, tokens for LMs).  Multi-core sharing of a width-tiled layer is the
  data-parallel pattern: weights replicated, activations split (+halo).
* ``Strategy.OC``     — same input pixels, different output channels.  This is
  weight parallelism (tensor-parallel pattern): weights split, input
  replicated.  For depthwise layers OC tiling also splits input channels, so
  nothing is replicated.

Each tile becomes one IFP: an independent instruction sequence
(LOAD weights -> {LOAD input chunk -> CONV -> SAVE} x groups) whose latency on
the basic shareable unit is priced by the latency simulator into a LUT.

Weight/input LOADs carry reuse keys: when the dynamic compiler concatenates
several IFPs of the same layer on one core, a LOAD whose key matches the
previous IFP's resident tensor and whose size fits on-chip memory is dropped
(the on-chip weight buffer of Angel-Eye-class designs).  Without this reuse,
width tiling at few cores would be bandwidth-absurd — with it, the paper's
Table 3 behaviour (width wins at few cores, OC at many) emerges naturally.
"""

from __future__ import annotations

import dataclasses
import enum
from typing import List, Optional, Tuple

from .isa import Op, Program
from .workloads import Layer


class Strategy(enum.Enum):
    WIDTH = "W"   # width-only tiling (data-parallel analogue)
    OC = "OC"     # output-channel-only tiling (tensor-parallel analogue)


@dataclasses.dataclass
class IFP:
    """One tiling-based instruction frame package."""

    layer_idx: int
    strategy: Strategy
    tile_idx: int
    n_tiles: int
    program: Program
    # latency on the basic shareable unit, filled by the static compiler:
    latency: float = 0.0            # cold: all loads paid
    latency_cached: float = 0.0     # reusable loads dropped (same-layer chain)
    flops: float = 0.0
    # the program as it runs when the *shared* tensor of its (layer,
    # strategy) is already on-chip (weights for WIDTH, input map for OC);
    # filled by the static compiler so the dynamic compiler concatenates
    # cached artifacts instead of rewriting instructions (~ms path).
    program_cached: Optional[Program] = None

    @property
    def key(self) -> Tuple[int, str, int]:
        return (self.layer_idx, self.strategy.value, self.tile_idx)


def _split(total: int, parts: int) -> List[int]:
    """Split ``total`` into at most ``parts`` near-equal positive chunks."""
    parts = max(1, min(parts, total))
    base, rem = divmod(total, parts)
    return [base + (1 if i < rem else 0) for i in range(parts)]


def make_layer_ifps(
    layer: Layer,
    layer_idx: int,
    strategy: Strategy,
    n_tiles: int,
    *,
    load_groups: int = 4,
) -> List[IFP]:
    """Tile one layer into IFPs under the given strategy.

    Returns fewer than ``n_tiles`` IFPs when the tiling dimension is too
    narrow (e.g. a 7-wide feature map cannot be split 16 ways) — the workload
    imbalance this causes at high core counts is part of what the paper's
    optimized per-layer strategy choice avoids.
    """
    ifps: List[IFP] = []
    if strategy is Strategy.WIDTH:
        chunks = _split(layer.w, n_tiles)
        for t, w_cols in enumerate(chunks):
            prog = _tile_program(
                layer, layer_idx, t,
                w_cols=w_cols, c_out=layer.c_out, c_in=layer.c_in,
                weight_frac=1.0, replicate_input=False,
                # weights are identical across WIDTH tiles -> shared/reusable
                weight_key=(layer_idx, "W", "shared"), weight_shared=True,
                input_key=None,  # disjoint input slices (halo aside): no reuse
                load_groups=load_groups,
            )
            ifps.append(IFP(layer_idx, strategy, t, len(chunks), prog))
    else:  # OC
        chunks = _split(layer.c_out, n_tiles)
        depthwise = layer.is_depthwise
        for t, co in enumerate(chunks):
            frac = co / layer.c_out
            c_in_eff = max(1, round(layer.c_in * frac)) if depthwise else layer.c_in
            prog = _tile_program(
                layer, layer_idx, t,
                w_cols=layer.w, c_out=co, c_in=c_in_eff,
                weight_frac=frac, replicate_input=not depthwise,
                # each OC tile owns its own weight slice -> NOT reusable
                weight_key=(layer_idx, "OC", t), weight_shared=False,
                # feature maps STREAM through line buffers (Angel-Eye-class
                # designs hold weights in a dedicated buffer but not whole
                # input maps): consecutive OC tiles re-stream the input.
                # This is why the paper's OC tiling collapses at few cores
                # (Table 3: 4.2 vs 6.8 fps at k=1) — the re-streams serialize.
                input_key=(layer_idx, "OC", "full_in") if not depthwise else None,
                input_shared=False,
                load_groups=load_groups,
            )
            ifps.append(IFP(layer_idx, strategy, t, len(chunks), prog))
    return ifps


def _tile_program(
    layer: Layer,
    layer_idx: int,
    tile_idx: int,
    *,
    w_cols: int,
    c_out: int,
    c_in: int,
    weight_frac: float,
    replicate_input: bool,
    weight_key,
    input_key,
    load_groups: int,
    weight_shared: bool = False,
    input_shared: bool = False,
) -> Program:
    """Emit the instruction sequence of one tile.

    Input loads are split into ``load_groups`` row-chunks so the per-core
    scheduler (second-level IDM) can overlap LOAD of chunk g+1 with CONV of
    chunk g — the reason the ISA carries dependency fields at all.
    """
    prog = Program()
    w_bytes = layer.weight_nbytes * weight_frac
    in_bytes = layer.input_nbytes(w_cols=w_cols, c_in=c_in)
    out_bytes = float(layer.h * w_cols * c_out * layer.abytes)
    flops = 2.0 * layer.h * w_cols * c_out * (c_in if layer.is_depthwise else layer.c_in // layer.groups) \
        * layer.kh * layer.kw / (layer.groups if layer.is_depthwise else 1)
    if layer.is_depthwise:
        # depthwise: each output channel sees 1 input channel
        flops = 2.0 * layer.h * w_cols * c_out * layer.kh * layer.kw

    prog.emit(Op.CONVINIT, layer=layer_idx, tile=tile_idx)
    wload = prog.load(w_bytes, kind="w", key=weight_key, shared=weight_shared,
                      layer=layer_idx, tile=tile_idx)

    groups = max(1, min(load_groups, layer.h))
    pix_rows = _split(layer.h, groups)
    done_rows = 0
    for g, rows in enumerate(pix_rows):
        frac_g = rows / layer.h
        iload = prog.load(
            in_bytes * frac_g,
            kind="in",
            key=input_key,                      # tensor-level identity
            shared=input_shared and input_key is not None,
            layer=layer_idx, tile=tile_idx, group=g,
        )
        # depthwise convs stream one channel per lane: the ICP quantization
        # of the dense PE array doesn't apply (extent 0 = skip that dim)
        q_ci = 0 if layer.is_depthwise else c_in
        conv = prog.emit(
            Op.CONV,
            flops=flops * frac_g,
            shape=(rows * w_cols, q_ci, c_out),
            deps=[wload, iload],
            layer=layer_idx, tile=tile_idx, group=g,
        )
        prog.save(out_bytes * frac_g, deps=[conv], layer=layer_idx, tile=tile_idx, group=g)
        done_rows += rows
    return prog


def dedupe_onchip(
    programs: List[Program],
    vmem_bytes: int,
) -> Program:
    """Concatenate the IFP programs assigned to one core, dropping *shared*
    LOADs whose tensor is already resident from the previous package and fits
    on-chip memory.  This models the on-chip weight/feature buffer:
    consecutive WIDTH tiles of a layer share weights; consecutive OC tiles
    share the (replicated) input feature map.

    Residency is program-granular: after each package, the on-chip buffer
    holds exactly the keyed tensors that package loaded (grouped chunk loads
    of one tensor count toward one residency entry).  This is the reference
    semantics the dynamic compiler's chain construction
    (``[cold, cached, cached, ...]``) must match — asserted in tests.
    """
    out = Program()
    resident: dict = {}   # kind -> set of resident tensor keys
    for p in programs:
        # total bytes per (kind, key) tensor in this package (grouped loads)
        totals: dict = {}
        for ins in p.instrs:
            if ins.op is Op.LOAD and ins.tag.get("key") is not None:
                kk = (ins.tag.get("kind"), ins.tag["key"])
                totals[kk] = totals.get(kk, 0.0) + ins.nbytes
        mapping: dict = {}    # old iid -> new iid | None if dropped
        touched: dict = {}    # kind -> set of keys this package keeps on-chip
        for ins in p.instrs:
            if ins.op is Op.LOAD:
                kind = ins.tag.get("kind")
                key = ins.tag.get("key")
                fits = (
                    key is not None
                    and totals.get((kind, key), float("inf")) <= vmem_bytes
                )
                if fits:
                    touched.setdefault(kind, set()).add(key)
                    if ins.tag.get("shared") and key in resident.get(kind, ()):
                        # hit: tensor resident from the previous package
                        mapping[ins.iid] = None
                        continue
            new_deps = [mapping[d] for d in ins.deps if mapping.get(d) is not None]
            new_iid = len(out.instrs)
            mapping[ins.iid] = new_iid
            out.instrs.append(
                dataclasses.replace(ins, iid=new_iid, deps=new_deps, tag=dict(ins.tag))
            )
        resident = {k: set(v) for k, v in touched.items()}
    return out
