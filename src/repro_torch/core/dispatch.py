"""Two-level Instruction Dispatch Module (IDM) — paper §4.2.1.

Copy of ``repro.core.dispatch`` for the port, which imports nothing of
``repro``; it is pure Python and must keep the reference's behaviour
(``tests/test_torch_tenancy.py`` holds the two against each other).

Level 1 (task-level scheduler, one per accelerator):
  * routes instruction streams to cores by core index,
  * the **context-switch controller** records per-tenant context on a
    reconfiguration signal from the hypervisor — either *task-level* (wait for
    the running inference to finish) or *layer-level* (record the layer index;
    activations already live off-chip because execution is layer-by-layer, so
    the layer index is the entire context),
  * the **multi-core sync controller** aggregates ``sync_local`` from all
    cores of a tenant into one ``sync_global`` per layer.

Level 2 (module-level scheduler, one per core) is the in-order-per-unit
dependency scoreboard — implemented by the latency simulator's list scheduler
(the port's own :func:`repro_torch.core.latency_sim.simulate`), which this
module drives.

These classes are behavioural models (discrete-event), exercised by the
virtualized engine (:class:`repro_torch.core.vengine.VirtualEngine`) and
unit-tested directly; the serving port uses ``SwitchMode``, the mode of the
hypervisor's resize decisions.
"""

from __future__ import annotations

import dataclasses
import enum
from typing import Dict, List, Optional, Set


class SwitchMode(enum.Enum):
    TASK_LEVEL = "task"    # wait for current inference to finish
    LAYER_LEVEL = "layer"  # preempt at the next layer boundary


@dataclasses.dataclass
class Context:
    """What the context-switch controller records.  Layer-by-layer execution
    writes activations back to DDR/HBM, so this is the *whole* context."""

    tenant: str
    layer_idx: int          # next layer to execute
    inference_id: int       # running inference number (for accounting)


class MultiCoreSyncController:
    """Aggregates sync_local -> sync_global per tenant (hypervisor-configured
    core membership).  Pure state machine; raises on foreign cores."""

    def __init__(self) -> None:
        self._members: Dict[str, Set[int]] = {}
        self._arrived: Dict[str, Set[int]] = {}

    def configure(self, tenant: str, cores: Set[int]) -> None:
        self._members[tenant] = set(cores)
        self._arrived[tenant] = set()

    def deconfigure(self, tenant: str) -> None:
        self._members.pop(tenant, None)
        self._arrived.pop(tenant, None)

    def sync_local(self, tenant: str, core: int) -> bool:
        """Core ``core`` raised sync_local.  Returns True when sync_global
        fires (all member cores arrived), resetting the barrier."""
        if core not in self._members.get(tenant, set()):
            raise KeyError(f"core {core} is not a member of tenant {tenant}")
        arrived = self._arrived[tenant]
        arrived.add(core)
        if arrived == self._members[tenant]:
            arrived.clear()
            return True
        return False


class ContextSwitchController:
    """Records/loads per-tenant context around reconfigurations."""

    def __init__(self) -> None:
        self._saved: Dict[str, Context] = {}
        self._pending: Dict[str, SwitchMode] = {}

    def request_switch(self, tenant: str, mode: SwitchMode) -> None:
        self._pending[tenant] = mode

    def pending_mode(self, tenant: str) -> Optional[SwitchMode]:
        return self._pending.get(tenant)

    def boundary(self, tenant: str, layer_idx: int, n_layers: int, inference_id: int) -> Optional[Context]:
        """Called by the engine at every layer boundary.  If a switch is
        pending and the boundary type matches the mode, capture the context
        and clear the request; otherwise return None."""
        mode = self._pending.get(tenant)
        if mode is None:
            return None
        at_task_end = layer_idx >= n_layers
        if mode is SwitchMode.TASK_LEVEL and not at_task_end:
            return None
        ctx = Context(tenant=tenant, layer_idx=0 if at_task_end else layer_idx,
                      inference_id=inference_id)
        self._saved[tenant] = ctx
        del self._pending[tenant]
        return ctx

    def load(self, tenant: str) -> Optional[Context]:
        return self._saved.pop(tenant, None)


class InstructionRouter:
    """First-level IDM instruction decoder: streams indexed by core id.

    On real hardware this fetches from DDR into the on-chip instruction
    memory and forwards by the core-index field; here it validates that a
    schedule only ever references cores inside the tenant's lease."""

    @staticmethod
    def route(schedule_cores: List[int], lease_cores: Set[int]) -> Dict[int, int]:
        mapping: Dict[int, int] = {}
        for local, phys in enumerate(schedule_cores):
            if phys not in lease_cores:
                raise PermissionError(
                    f"schedule targets core {phys} outside lease {sorted(lease_cores)}"
                )
            mapping[local] = phys
        return mapping
