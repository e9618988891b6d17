"""Meshes: axis names and sizes, and, inside a ``torch.distributed``
process group, the ranks that run one SPMD program over them.

Counterpart of ``repro.launch.mesh``.  The reference builds a GSPMD mesh of
256 (or 512) devices and compiles one SPMD program over it.  The port has
two kinds of mesh, both a :class:`MeshSpec`:

* a **description**: the names and sizes of the axes, which the spec
  functions (``distributed.sharding.param_specs`` and its kin,
  ``optim.opt_state_specs``) read to lay a program's arguments out per
  device, and under which ``distributed.spmd.ActivationPolicy`` records
  each collective's bytes a device instead of issuing it (the dry-run's
  production meshes, which hold no devices; a host mesh of one device);
* a **process mesh**: one rank of a process group whose world size is the
  mesh's size.  It holds this rank's coordinate on each axis, one
  sub-group of the ranks along each axis and the rank's device, and the
  policy issues its collectives over those sub-groups.

The process group is the gloo backend's: CPU ranks, or several ranks
sharing one card (NCCL refuses two ranks on one card, and gloo copies a
CUDA tensor through host memory).  Ranks on distinct cards would need
NCCL and are refused: that is ROADMAP.md Queue 1 item 18 part b.  The
spec functions read only ``.shape`` (axis name -> size) and
``.axis_names``.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Any, Dict, Optional, Tuple

import numpy as np
import torch


@dataclasses.dataclass(frozen=True)
class MeshSpec:
    """A mesh by its axes: ``axis_names`` and the size of each.  ``device``
    is the device this process runs on (a host or process mesh), or None
    for a production mesh, which holds no devices.  A process mesh also
    has ``coords`` (this rank's coordinate on each axis) and ``groups``
    (one process sub-group per axis: the ranks that differ from this one
    on that axis only)."""

    axis_names: Tuple[str, ...]
    sizes: Tuple[int, ...]
    device: Optional[torch.device] = None
    coords: Optional[Tuple[int, ...]] = None
    groups: Optional[Tuple[Any, ...]] = dataclasses.field(
        default=None, compare=False, repr=False)

    def __post_init__(self):
        if len(self.axis_names) != len(self.sizes):
            raise ValueError(f"{len(self.axis_names)} axis names for "
                             f"{len(self.sizes)} sizes")

    @property
    def shape(self) -> Dict[str, int]:
        return dict(zip(self.axis_names, self.sizes))

    @property
    def size(self) -> int:
        """Devices the mesh spans (the reference's ``mesh.devices.size``)."""
        return math.prod(self.sizes)

    @property
    def is_process_mesh(self) -> bool:
        return self.groups is not None

    def coord(self, name: str) -> int:
        """This rank's index along axis ``name`` (0 off the mesh's axes)."""
        if name not in self.axis_names:
            return 0
        if self.coords is None:
            raise ValueError("a mesh description has no rank coordinates")
        return self.coords[self.axis_names.index(name)]

    def group(self, name: str):
        """The process sub-group of the ranks along axis ``name``."""
        if self.groups is None:
            raise ValueError("a mesh description has no process groups")
        return self.groups[self.axis_names.index(name)]


def make_production_mesh(*, multi_pod: bool = False, dp_tp=None) -> MeshSpec:
    """16 x 16 = 256 chips a pod; two pods = 512 with a leading "pod" axis.
    ``dp_tp=(dp, tp)`` overrides the per-pod (data, model) split, keeping
    256 chips a pod, as the reference's does.  A description only: it holds
    no devices (see the module docstring)."""
    dp, tp = dp_tp if dp_tp is not None else (16, 16)
    if dp * tp != 256:
        raise ValueError(f"dp x tp must be 256 chips a pod, got {dp} x {tp}")
    if multi_pod:
        return MeshSpec(("pod", "data", "model"), (2, dp, tp))
    return MeshSpec(("data", "model"), (dp, tp))


def make_host_mesh(shape=None, axes=("data", "model"),
                   device="cuda") -> MeshSpec:
    """A mesh of ``shape`` over ``axes`` on ``device``.  Of one device, the
    mesh on which a cell's program runs as it is (the tests' CPU, or the
    card).  Of several, a process mesh: this process must be one rank of
    an initialised ``torch.distributed`` group of the gloo backend whose
    world size is the mesh's size (``launch.spmd.run_ranks`` starts such a
    group); ranks are laid out row-major over ``shape``."""
    from ..device import resolve_device

    shape = tuple(shape) if shape is not None else (1,) * len(axes)
    dev = resolve_device(device)
    if math.prod(shape) == 1:
        return MeshSpec(tuple(axes), shape, dev)
    import torch.distributed as dist

    if not (dist.is_available() and dist.is_initialized()):
        raise ValueError(
            f"a mesh of {shape} spans {math.prod(shape)} devices: run it in "
            f"a torch.distributed process group of that size "
            f"(launch.spmd.run_ranks); meshes over several cards are "
            f"ROADMAP.md Queue 1 item 18 part b")
    return _process_mesh(shape, tuple(axes), dev)


def _process_mesh(shape, axes, dev: torch.device) -> MeshSpec:
    import torch.distributed as dist

    world, rank = dist.get_world_size(), dist.get_rank()
    if world != math.prod(shape):
        raise ValueError(f"a mesh of {shape} needs a process group of "
                         f"{math.prod(shape)} ranks, not {world}")
    backend = dist.get_backend()
    if backend != "gloo":
        raise ValueError(
            f"the process mesh runs over the gloo backend, not {backend!r}: "
            f"NCCL across cards is ROADMAP.md Queue 1 item 18 part b")
    if dev.type == "cuda" and dev.index is None:
        dev = torch.device("cuda", torch.cuda.current_device())
    # every rank's device, so that ranks on distinct cards are refused on
    # every rank alike
    mine = torch.tensor([dev.type == "cuda", dev.index or 0],
                        dtype=torch.int64)
    every = [torch.empty_like(mine) for _ in range(world)]
    dist.all_gather(every, mine)
    kinds = {tuple(int(v) for v in t) for t in every}
    if len(kinds) > 1:
        raise ValueError(
            f"the ranks sit on distinct devices "
            f"({sorted(kinds)} as (is_cuda, index)): ranks on several cards "
            f"need NCCL, ROADMAP.md Queue 1 item 18 part b; gloo ranks share "
            f"one card or the CPU")
    ranks = np.arange(world).reshape(shape)
    coords = tuple(int(c) for c in np.unravel_index(rank, shape))
    groups = []
    for ax in range(len(shape)):
        mine_group = None
        # every rank makes every group, in the same order (dist.new_group
        # is collective over the world)
        for row in np.moveaxis(ranks, ax, -1).reshape(-1, shape[ax]):
            g = dist.new_group(ranks=[int(r) for r in row])
            if rank in row:
                mine_group = g
        groups.append(mine_group)
    return MeshSpec(axes, shape, dev, coords=coords, groups=tuple(groups))


__all__ = ["MeshSpec", "make_host_mesh", "make_production_mesh"]
