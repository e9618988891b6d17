"""Optimizer and LR schedules of the training path: counterpart of
``repro.optim``, with the ZeRO state specs as a layout over a mesh
description."""

from .adamw import (
    QBLOCK,
    AdamWState,
    QTensor,
    adamw_init,
    adamw_update,
    clip_by_global_norm,
    global_norm,
    opt_state_specs,
)
from .schedules import SCHEDULES, constant, warmup_cosine, warmup_linear

__all__ = [
    "AdamWState", "QBLOCK", "QTensor", "adamw_init", "adamw_update",
    "clip_by_global_norm", "global_norm", "opt_state_specs",
    "SCHEDULES", "constant", "warmup_cosine", "warmup_linear",
]
