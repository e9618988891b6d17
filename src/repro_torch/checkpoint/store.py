"""Checkpointing: atomic, async, restore into any tree of the same keys.

Counterpart of ``repro.checkpoint.store``, on the same disk format, so a
checkpoint written by either package restores in the other bit for bit:

* ``<dir>/tmp.<step>`` is written (``arrays.npz`` + ``manifest.json``) and
  renamed to ``<dir>/step_<step:08d>``; a crash mid-write never corrupts
  the latest checkpoint.  ``keep`` of the newest are kept.
* Each leaf is stored under its path string, the reference's
  ``jax.tree_util.keystr``: ``['params']['blocks'][0]['attn']['wq']`` for
  dicts and lists, ``['opt'].m`` for a NamedTuple field
  (:mod:`repro_torch.tree`).
* npz cannot hold bf16: a bf16 leaf is stored as its raw ``uint16`` bits
  with its logical dtype name in the manifest (``logical_dtypes``), as the
  reference stores its ``ml_dtypes`` arrays.  The port decodes the bits
  with a torch view, so no ``ml_dtypes`` is needed.
* ``AsyncCheckpointer.save_async`` copies every leaf to host memory on the
  caller's thread (snapshot semantics: later in-place updates do not reach
  the checkpoint) and writes on a background thread; ``wait()`` joins.
"""

from __future__ import annotations

import json
import os
import shutil
import threading
from typing import Any, Dict, Optional, Tuple

import numpy as np
import torch

from ..tree import flatten_with_path, tree_map

_SEP = "|"


def _encode(t: torch.Tensor) -> Tuple[np.ndarray, Optional[str]]:
    """A host copy of ``t`` as a storable array and its logical dtype name
    (None when numpy holds the dtype itself; ``"bfloat16"`` for bf16,
    stored as its raw ``uint16`` bits)."""
    host = t.detach().to("cpu", copy=True).contiguous()
    if host.dtype == torch.bfloat16:
        return host.view(torch.int16).numpy().view(np.uint16), "bfloat16"
    return host.numpy(), None


def _decode(arr: np.ndarray, logical: Optional[str]) -> torch.Tensor:
    """A tensor sharing ``arr``'s memory (an array ``np.load`` read, which
    nothing else holds)."""
    if not logical:
        return torch.from_numpy(arr)
    if logical != "bfloat16":
        raise ValueError(f"checkpoint leaf of logical dtype {logical!r}; "
                         f"the port reads bfloat16 only")
    return torch.from_numpy(arr.view(np.int16)).view(torch.bfloat16)


def _flatten_named(tree) -> Dict[str, Tuple[np.ndarray, Optional[str]]]:
    return {key: _encode(leaf) for key, leaf in flatten_with_path(tree)}


def _write(path: str, step: int, named, metadata, keep: int, *,
           full_manifest: bool, fsync: bool) -> str:
    os.makedirs(path, exist_ok=True)
    tmp = os.path.join(path, f"tmp.{step}")
    final = os.path.join(path, f"step_{step:08d}")
    if os.path.exists(tmp):
        shutil.rmtree(tmp)
    os.makedirs(tmp)
    np.savez(os.path.join(tmp, "arrays.npz"),
             **{k.replace("/", _SEP): arr for k, (arr, _) in named.items()})
    manifest = {"step": step, "keys": list(named.keys())}
    if full_manifest:
        manifest["shapes"] = {k: list(arr.shape) for k, (arr, _) in named.items()}
        manifest["dtypes"] = {k: logi or str(arr.dtype)
                              for k, (arr, logi) in named.items()}
    manifest["logical_dtypes"] = {k: logi for k, (_, logi) in named.items()
                                  if logi}
    manifest["metadata"] = metadata or {}
    with open(os.path.join(tmp, "manifest.json"), "w") as f:
        json.dump(manifest, f)
        if fsync:
            f.flush()
            os.fsync(f.fileno())
    if os.path.exists(final):
        shutil.rmtree(final)
    os.rename(tmp, final)
    _gc(path, keep)
    return final


def save(path: str, step: int, tree: Any, *, metadata: Optional[dict] = None,
         keep: int = 3) -> str:
    """Synchronous atomic save.  Returns the final checkpoint directory."""
    return _write(path, step, _flatten_named(tree), metadata, keep,
                  full_manifest=True, fsync=True)


def _gc(path: str, keep: int) -> None:
    steps = sorted(d for d in os.listdir(path) if d.startswith("step_"))
    for d in steps[:-keep] if keep > 0 else []:
        shutil.rmtree(os.path.join(path, d), ignore_errors=True)


def latest_step(path: str) -> Optional[int]:
    if not os.path.isdir(path):
        return None
    steps = sorted(int(d.split("_")[1]) for d in os.listdir(path)
                   if d.startswith("step_"))
    return steps[-1] if steps else None


def restore(path: str, like: Any, *, step: Optional[int] = None) -> Any:
    """Restore into the structure of ``like`` (a tree of tensors): each leaf
    takes the dtype and the device of ``like``'s, and the tree's classes
    (``AdamWState``, ``QTensor``) are ``like``'s own."""
    step = latest_step(path) if step is None else step
    if step is None:
        raise FileNotFoundError(f"no checkpoint under {path}")
    final = os.path.join(path, f"step_{step:08d}")
    with open(os.path.join(final, "manifest.json")) as f:
        logical = json.load(f).get("logical_dtypes", {})
    with np.load(os.path.join(final, "arrays.npz")) as data:
        arrays = {k.replace(_SEP, "/"): data[k] for k in data.files}
    keys = iter([key for key, _ in flatten_with_path(like)])

    def one(leaf):
        key = next(keys)
        if key not in arrays:
            raise KeyError(f"checkpoint missing leaf {key}")
        return _decode(arrays[key], logical.get(key)).to(
            device=leaf.device, dtype=leaf.dtype)

    return tree_map(one, like)


def read_metadata(path: str, *, step: Optional[int] = None) -> dict:
    step = latest_step(path) if step is None else step
    with open(os.path.join(path, f"step_{step:08d}", "manifest.json")) as f:
        return json.load(f)


class AsyncCheckpointer:
    """Background-thread writer with snapshot-on-call semantics."""

    def __init__(self, path: str, *, keep: int = 3):
        self.path = path
        self.keep = keep
        self._thread: Optional[threading.Thread] = None
        self.last_saved: Optional[int] = None

    def save_async(self, step: int, tree: Any, *,
                   metadata: Optional[dict] = None):
        self.wait()
        named = _flatten_named(tree)   # snapshot now (device -> host)

        def _run():
            _write(self.path, step, named, metadata, self.keep,
                   full_manifest=False, fsync=False)
            self.last_saved = step

        self._thread = threading.Thread(target=_run, daemon=True)
        self._thread.start()

    def wait(self):
        if self._thread is not None:
            self._thread.join()
            self._thread = None
