"""Weight bridge between the JAX package's parameter trees and the port's.

Both packages use the same nested layout (dicts, the per-period ``blocks``
list, blocks stacked on axis 0), so the bridge maps leaf for leaf.  It takes
the tree of numpy arrays that ``jax.device_get(params)`` returns; the port
never imports ``jax`` itself.

The optimizer state crosses too (:func:`opt_state_from_jax`,
:func:`opt_state_to_jax`): its NamedTuples are rebuilt field by field.

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


def _map(tree, fn, classes=None):
    """``fn`` over the leaves of nested dicts, lists, tuples and
    NamedTuples.  A NamedTuple is rebuilt field by field, as the class in
    ``classes`` (a map from its field names) when given, else as its own
    class."""
    if isinstance(tree, dict):
        return {k: _map(v, fn, classes) for k, v in tree.items()}
    if isinstance(tree, tuple) and hasattr(tree, "_fields"):
        cls = (classes or {}).get(tuple(tree._fields), type(tree))
        return cls(*(_map(v, fn, classes) for v in tree))
    if isinstance(tree, (list, tuple)):
        return type(tree)(_map(v, fn, classes) for v in tree)
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


def _opt_classes():
    from .optim import AdamWState, QTensor

    return {tuple(AdamWState._fields): AdamWState,
            tuple(QTensor._fields): QTensor}


def opt_state_from_jax(state: Any, *, device="cuda") -> Any:
    """The reference's AdamW state (its ``AdamWState`` of f32 moments or
    ``QTensor``s, leaves as numpy arrays, e.g. from ``jax.device_get``) as
    the port's :class:`~repro_torch.optim.AdamWState` and
    :class:`~repro_torch.optim.QTensor` of tensors on ``device``, so both
    packages start a step from the same state."""
    dev = resolve_device(device)
    return _map(state, lambda a: _leaf_to_torch(a, dev), _opt_classes())


def opt_state_to_jax(state: Any) -> Any:
    """Inverse of :func:`opt_state_from_jax`: the port's state as numpy
    leaves in the port's NamedTuples, which the reference's ``adamw_update``
    reads by field name (``.step``, ``.m``, ``.q``)."""
    return _map(state, _leaf_to_numpy)
