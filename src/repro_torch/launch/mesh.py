"""Mesh descriptions for the dry-run: axis names and sizes.

Counterpart of ``repro.launch.mesh``.  The reference builds a GSPMD mesh of
256 (or 512) devices and compiles one SPMD program over it.  One card
cannot hold 256 devices, and the port runs no SPMD program (running over
several cards is ROADMAP.md Queue 1 item 18), so a production mesh here is
a *description*: the names and sizes of its axes, which the spec functions
(``distributed.sharding.param_specs`` and its kin,
``optim.opt_state_specs``) read to lay a traced program's arguments out
per device.  Those functions read only ``.shape`` (axis name -> size) and
``.axis_names``.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Dict, Optional, Tuple

import torch


@dataclasses.dataclass(frozen=True)
class MeshSpec:
    """A mesh by its axes: ``axis_names`` and the size of each.  ``device``
    is the card the axes lie over (a host mesh), or None for a production
    mesh, which holds no devices."""

    axis_names: Tuple[str, ...]
    sizes: Tuple[int, ...]
    device: Optional[torch.device] = None

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
    """The (1, 1) mesh over one device, on which a cell's program runs as
    it is: the tests' CPU, or the card.  Only a shape of one device is
    taken."""
    from ..device import resolve_device

    shape = tuple(shape) if shape is not None else (1,) * len(axes)
    if math.prod(shape) != 1:
        raise ValueError(f"a host mesh spans one device, not {shape}: "
                         f"meshes over several cards are ROADMAP.md item 18")
    return MeshSpec(tuple(axes), shape, resolve_device(device))
