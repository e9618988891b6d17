"""Weight bridge between the JAX package's parameter trees and the port's.

Both packages use the same nested layout (dicts, the per-period ``blocks``
list, blocks stacked on axis 0), so the bridge maps leaf for leaf.  It takes
the tree of numpy arrays that ``jax.device_get(params)`` returns; the port
never imports ``jax`` itself.

bf16 needs care: JAX's bfloat16 arrays come back as ``ml_dtypes.bfloat16``,
which ``torch.from_numpy`` refuses.  They are reinterpreted bit for bit:
viewed as ``int16`` in numpy, handed to torch as ``torch.int16`` and viewed
as ``torch.bfloat16``.
"""

from __future__ import annotations

from typing import Any

import numpy as np
import torch

from .device import resolve_device


def _leaf_to_torch(a, device) -> torch.Tensor:
    a = np.array(a, copy=True, order="C")    # writable, owned by the tensor
    if a.dtype.name == "bfloat16":
        return torch.from_numpy(a.view(np.int16)).view(torch.bfloat16).to(device)
    return torch.from_numpy(a).to(device)


def _leaf_to_numpy(t: torch.Tensor) -> np.ndarray:
    t = t.detach().cpu().contiguous()
    if t.dtype == torch.bfloat16:
        import ml_dtypes

        return t.view(torch.int16).numpy().view(ml_dtypes.bfloat16)
    return t.numpy()


def _map(tree, fn):
    if isinstance(tree, dict):
        return {k: _map(v, fn) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_map(v, fn) for v in tree)
    return fn(tree)


def params_from_jax(tree_of_numpy: Any, *, device="cuda") -> Any:
    """Map a JAX parameter tree (leaves are numpy arrays, e.g. from
    ``jax.device_get``) to the port's tree of tensors on ``device``."""
    dev = resolve_device(device)
    return _map(tree_of_numpy, lambda a: _leaf_to_torch(a, dev))


def params_to_jax(params: Any) -> Any:
    """Inverse of :func:`params_from_jax`: the port's tree as numpy arrays
    (bf16 leaves as ``ml_dtypes.bfloat16``), ready for ``jnp.asarray``."""
    return _map(params, _leaf_to_numpy)
