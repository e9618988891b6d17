"""Hand-written CUDA kernels for Hopper (``sm_90a``) with their plain PyTorch
versions.

Each kernel package mirrors ``repro.kernels.<name>``: ``ref.py`` is the
plain version, ``kernel.py`` launches the CUDA source in ``repro_torch/csrc``
through the ctypes library that :mod:`._build` compiles at first use, and
``ops.py`` is the model-layout wrapper that picks the route by the tensor's
device and counts launches.

Ported so far: ``flash_attention`` (prefill) and ``decode_attention``
(dense ring-buffer decode).
"""
