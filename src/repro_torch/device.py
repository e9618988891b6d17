"""Device and dtype resolution shared by every entry point of the port.

The port runs on the card unless the caller asks for the CPU: an entry point
called with the default ``device="cuda"`` on a machine without a GPU raises
instead of carrying on quietly on the CPU.
"""

from __future__ import annotations

import torch

# the config files name dtypes as strings (``ModelConfig.dtype``)
DTYPES = {
    "float32": torch.float32,
    "bfloat16": torch.bfloat16,
    "float16": torch.float16,
    "int32": torch.int32,
}


def torch_dtype(name) -> torch.dtype:
    """Map a config dtype string (or a torch dtype) to a torch dtype."""
    if isinstance(name, torch.dtype):
        return name
    try:
        return DTYPES[name]
    except KeyError:
        raise ValueError(
            f"unknown dtype {name!r}; expected one of {sorted(DTYPES)}") from None


def resolve_device(device="cuda") -> torch.device:
    """``torch.device`` for ``device``; raises ``RuntimeError`` when a CUDA
    device is asked for and none is present."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device is available; pass device='cpu' to run the "
            "port on the CPU")
    return dev
