"""Optimizer and LR schedules of the training path: counterpart of
``repro.optim`` (the ZeRO state specs wait for ROADMAP.md item 18)."""

from .adamw import (
    QBLOCK,
    AdamWState,
    QTensor,
    adamw_init,
    adamw_update,
    clip_by_global_norm,
    global_norm,
)
from .schedules import SCHEDULES, constant, warmup_cosine, warmup_linear

__all__ = [
    "AdamWState", "QBLOCK", "QTensor", "adamw_init", "adamw_update",
    "clip_by_global_norm", "global_norm",
    "SCHEDULES", "constant", "warmup_cosine", "warmup_linear",
]
