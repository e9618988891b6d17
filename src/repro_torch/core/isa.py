"""Instruction IR for the virtualized ISA-based accelerator.

Copy of ``repro.core.isa`` for the port, which imports nothing of
``repro``; it is pure Python and must keep the reference's behaviour
(``tests/test_torch_vengine.py`` holds the two against each other).

The paper's core ISA is {System, Load, Save, Convinit, Conv, Poolinit, Pool}
mapping onto four functional units (LOAD, SAVE, CONV, MISC), with dependency
fields on every instruction so the per-core scheduler (the second-level IDM)
can overlap data movement with compute.

We keep exactly that structure, generalized so the same IR also describes
transformer layers on the accelerator adaptation:

* opcodes COMPUTE-class: CONV, POOL, MATMUL, ATTN, SSM, MISC      (unit CONV/MISC)
* opcodes MOVE-class:    LOAD, SAVE                               (unit LOAD/SAVE)
* opcodes CTRL-class:    CONVINIT, SYSTEM (sync/end)              (unit CTRL)

Every instruction carries:
  * ``deps``  — instruction ids it must wait for (data/hardware deps),
  * ``flops`` / ``nbytes`` — cost terms consumed by the latency simulator,
  * ``shape`` — (pixels, c_in, c_out) extent for the Eq.-2 quantization,
  * ``core``  — core index assigned by the dynamic compiler (-1 = unassigned),
  * ``tag``   — free-form metadata (layer index, tile index, tenant, ...).

The IR is deliberately plain Python (no array library) — the dynamic compiler must
re-allocate instruction packages in ~1 ms, so everything on that path is
lists/ints.
"""

from __future__ import annotations

import dataclasses
import enum
from typing import Dict, List, Optional, Tuple


class Op(enum.Enum):
    LOAD = "load"
    SAVE = "save"
    CONV = "conv"
    POOL = "pool"
    MATMUL = "matmul"
    ATTN = "attn"
    SSM = "ssm"
    MISC = "misc"
    CONVINIT = "convinit"
    SYSTEM = "system"   # sync / end-of-task


class Unit(enum.Enum):
    LOAD = "LOAD"
    SAVE = "SAVE"
    CONV = "CONV"    # the main compute array (PE array / MXU)
    MISC = "MISC"    # pooling / elementwise / softmax-ish
    CTRL = "CTRL"


OP_UNIT: Dict[Op, Unit] = {
    Op.LOAD: Unit.LOAD,
    Op.SAVE: Unit.SAVE,
    Op.CONV: Unit.CONV,
    Op.MATMUL: Unit.CONV,
    Op.ATTN: Unit.CONV,
    Op.SSM: Unit.CONV,
    Op.POOL: Unit.MISC,
    Op.MISC: Unit.MISC,
    Op.CONVINIT: Unit.CTRL,
    Op.SYSTEM: Unit.CTRL,
}


@dataclasses.dataclass
class Instr:
    """One instruction. ``flops`` for COMPUTE-class, ``nbytes`` for MOVE-class."""

    iid: int
    op: Op
    flops: float = 0.0
    nbytes: float = 0.0
    shape: Optional[Tuple[int, int, int]] = None   # (pixels, c_in, c_out)
    deps: List[int] = dataclasses.field(default_factory=list)
    core: int = -1
    tag: dict = dataclasses.field(default_factory=dict)

    @property
    def unit(self) -> Unit:
        return OP_UNIT[self.op]

    @property
    def is_sync(self) -> bool:
        return self.op is Op.SYSTEM and self.tag.get("sync", False)


class Program:
    """An append-only instruction container with dependency bookkeeping.

    Used both for whole-layer programs and for instruction frame packages
    (IFPs).  Instruction ids are indices into ``instrs``.
    """

    def __init__(self) -> None:
        self.instrs: List[Instr] = []

    # -- builders -----------------------------------------------------------
    def emit(
        self,
        op: Op,
        *,
        flops: float = 0.0,
        nbytes: float = 0.0,
        shape: Optional[Tuple[int, int, int]] = None,
        deps: Optional[List[int]] = None,
        **tag,
    ) -> int:
        iid = len(self.instrs)
        self.instrs.append(
            Instr(iid=iid, op=op, flops=flops, nbytes=nbytes, shape=shape,
                  deps=list(deps or []), tag=tag)
        )
        return iid

    def load(self, nbytes: float, deps=None, **tag) -> int:
        return self.emit(Op.LOAD, nbytes=nbytes, deps=deps, **tag)

    def save(self, nbytes: float, deps=None, **tag) -> int:
        return self.emit(Op.SAVE, nbytes=nbytes, deps=deps, **tag)

    def sync(self, deps=None, **tag) -> int:
        return self.emit(Op.SYSTEM, deps=deps, sync=True, **tag)

    # -- utilities ----------------------------------------------------------
    def __len__(self) -> int:
        return len(self.instrs)

    def __iter__(self):
        return iter(self.instrs)

    @property
    def total_flops(self) -> float:
        return sum(i.flops for i in self.instrs)

    @property
    def total_bytes(self) -> float:
        return sum(i.nbytes for i in self.instrs)

    def validate(self) -> None:
        """Deps must point backwards (the IR is in issue order per unit)."""
        for ins in self.instrs:
            for d in ins.deps:
                if not (0 <= d < ins.iid):
                    raise ValueError(
                        f"instr {ins.iid} ({ins.op}) has invalid dep {d}"
                    )

    def relabel(self, offset: int) -> "Program":
        """Copy with all ids/deps shifted by ``offset`` (for concatenation)."""
        out = Program()
        for ins in self.instrs:
            out.instrs.append(
                Instr(
                    iid=ins.iid + offset,
                    op=ins.op,
                    flops=ins.flops,
                    nbytes=ins.nbytes,
                    shape=ins.shape,
                    deps=[d + offset for d in ins.deps],
                    core=ins.core,
                    tag=dict(ins.tag),
                )
            )
        return out


class Chain:
    """Zero-copy sequence of Programs run back-to-back on one core.

    The dynamic compiler concatenates cached IFP artifacts by *reference*
    (the ~1 ms online path — paper Table 2); dependency ids stay local to
    each program, and the per-unit in-order issue provides the
    serialization across programs, exactly like appended instruction files.
    """

    __slots__ = ("programs",)

    def __init__(self, programs=None) -> None:
        self.programs: List[Program] = list(programs or [])

    def append(self, prog: Program) -> None:
        self.programs.append(prog)

    def __len__(self) -> int:
        return sum(len(p) for p in self.programs)

    def __iter__(self):
        for p in self.programs:
            yield from p

    @property
    def total_flops(self) -> float:
        return sum(p.total_flops for p in self.programs)

    @property
    def total_bytes(self) -> float:
        return sum(p.total_bytes for p in self.programs)

    def materialize(self) -> Program:
        """Flatten to a single Program (tests / debugging only)."""
        return concat(self.programs)


def _sync_prog() -> Program:
    p = Program()
    p.sync()
    return p


#: shared per-layer synchronization `System` instruction (paper §5.2.2)
SYNC_PROGRAM = _sync_prog()


def concat(programs: List[Program]) -> Program:
    """Concatenate programs, rewriting instruction ids; later programs get an
    implicit dependency on nothing (the per-unit in-order issue provides the
    serialization, exactly like appending instruction files)."""
    out = Program()
    off = 0
    for p in programs:
        shifted = p.relabel(off)
        out.instrs.extend(shifted.instrs)
        off += len(p)
    return out
