"""Hand-written CUDA kernels for Hopper (``sm_90a``) with their plain PyTorch
versions.

Each kernel package mirrors ``repro.kernels.<name>``: ``ref.py`` is the
plain version, ``kernel.py`` launches the CUDA source in ``repro_torch/csrc``
through the ctypes library that :mod:`._build` compiles at first use, and
``ops.py`` is the model-layout wrapper that picks the route by the tensor's
device and counts launches.

Every TPU kernel of the reference has its counterpart: ``flash_attention``
(prefill), ``decode_attention`` (dense ring-buffer decode),
``paged_attention`` (decode and the multi-query draft verify over the paged
pool, walking the page table in the kernel), ``prefix_attention`` (suffix
prefill against a cached prefix), ``ssd_scan`` (the Mamba-2 SSD chunked
scan of every SSM prefill), and the standalone ``rmsnorm`` and ``matmul``
(reached through their own entry points, as in the reference, and by the
tenant program of ``chip_smoke.py``'s tenancy phase).
"""
