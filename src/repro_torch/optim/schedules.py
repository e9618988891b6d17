"""LR schedules as functions of the step (an int or a 0-d tensor), each
returning a 0-d f32 tensor.  Counterpart of ``repro.optim.schedules``: the
same f32 arithmetic in the same order."""

from __future__ import annotations

import math

import torch


def _step_f32(step) -> torch.Tensor:
    if isinstance(step, torch.Tensor):
        return step.float()
    return torch.tensor(float(step), dtype=torch.float32)


def constant(lr: float):
    def f(step):
        dev = step.device if isinstance(step, torch.Tensor) else None
        return torch.tensor(lr, dtype=torch.float32, device=dev)
    return f


def warmup_linear(lr: float, warmup: int, total: int):
    def f(step):
        s = _step_f32(step)
        w = torch.clamp(s / max(warmup, 1), max=1.0)
        decay = torch.clamp(
            1.0 - torch.clamp(s - warmup, min=0.0) / max(total - warmup, 1),
            min=0.0)
        return torch.tensor(lr, dtype=torch.float32, device=s.device) * w * decay
    return f


def warmup_cosine(lr: float, warmup: int, total: int, *,
                  final_frac: float = 0.1):
    def f(step):
        s = _step_f32(step)
        w = torch.clamp(s / max(warmup, 1), max=1.0)
        t = torch.clamp((s - warmup) / max(total - warmup, 1), 0.0, 1.0)
        cos = final_frac + (1 - final_frac) * 0.5 * (1 + torch.cos(math.pi * t))
        return torch.tensor(lr, dtype=torch.float32, device=s.device) * w * cos
    return f


SCHEDULES = {
    "constant": constant,
    "warmup_linear": warmup_linear,
    "warmup_cosine": warmup_cosine,
}
