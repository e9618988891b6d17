"""repro_torch — the PyTorch/CUDA port of ``repro`` for one NVIDIA H100.

Same structure and names as the JAX package, in PyTorch's idiom: plain
functions on tensors over nested-dict parameter trees, explicit ``device``
arguments and ``torch.Generator``s.  Prefill and decode attention run as
hand-written CUDA kernels for ``sm_90a`` (``repro_torch.kernels``); a CPU
tensor takes each kernel's plain PyTorch version instead.

The port imports nothing of ``jax`` and nothing of ``repro``: it keeps its
own copies of the configs and the telemetry plane.
"""

from .configs import ARCHS, ModelConfig, get_config, get_reduced
from .device import DTYPES, resolve_device, torch_dtype

__all__ = [
    "ARCHS", "DTYPES", "ModelConfig", "get_config", "get_reduced",
    "resolve_device", "torch_dtype",
]
