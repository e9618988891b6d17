"""Deterministic synthetic data pipeline (host-sharded).

The port's own copy of ``repro.data.synthetic`` (numpy only, so the port
imports nothing of the JAX package): the same Philox streams and the same
arithmetic, so both packages make byte-identical batches.

Production shape without external storage: every batch is a pure function of
(seed, step, host) via counter-based Philox streams, so

* restarts are bit-exact (fault-tolerance tests replay the same stream),
* hosts generate disjoint shards with no coordination (``host_batch``),
* the "dataset" scales to any step count with zero I/O.

Token streams are Zipf-ish (realistic softmax pressure) and labels are the
next-token shift with the final position masked (-1).  Modality stubs: the
VLM cell gets patch embeddings + 3D M-RoPE positions; the audio cell gets
encoder frame embeddings (the conv frontend is a stub).
"""

from __future__ import annotations

import dataclasses
from typing import Dict

import numpy as np

VLM_PATCHES = 256     # patch positions prepended for the vlm family
VLM_PATCHES_REDUCED = 8


def _rng(seed: int, step: int, host: int = 0) -> np.random.Generator:
    # counter-based stream: (seed, step, host) -> disjoint, replayable
    counter = [step, host, 0x5EED, 0]
    return np.random.Generator(np.random.Philox(key=seed, counter=counter))


def _zipf_tokens(rng: np.random.Generator, shape, vocab: int) -> np.ndarray:
    """Zipf(1.1)-distributed token ids clipped to the vocab."""
    z = rng.zipf(1.1, size=shape)
    return ((z - 1) % vocab).astype(np.int32)


@dataclasses.dataclass(frozen=True)
class PipelineSpec:
    seed: int = 0
    n_hosts: int = 1


def make_batch(
    cfg, *, seq_len: int, batch: int, step: int, seed: int = 0,
    host: int = 0, n_hosts: int = 1, reduced: bool = False,
) -> Dict[str, np.ndarray]:
    """One host's shard of the global batch for ``step``.

    Keys always include tokens/labels; family extras:
      vlm   → extra_embeds (B, P, d) f32, positions (3, B, P+S)
      audio → frames (B, enc_seq, d) f32
    VLM tokens cover seq_len - P positions so the total sequence length
    (patches + text) equals the cell's seq_len.
    """
    assert batch % n_hosts == 0, (batch, n_hosts)
    b_local = batch // n_hosts
    rng = _rng(seed, step, host)
    n_patch = 0
    if cfg.family == "vlm":
        n_patch = VLM_PATCHES_REDUCED if reduced else VLM_PATCHES
    s_text = seq_len - n_patch
    tokens = _zipf_tokens(rng, (b_local, s_text), cfg.vocab)
    labels = np.full((b_local, seq_len), -1, dtype=np.int32)
    # next-token prediction on the text region (patch positions stay masked)
    labels[:, n_patch : seq_len - 1] = tokens[:, 1:]
    out: Dict[str, np.ndarray] = {"tokens": tokens, "labels": labels}
    if cfg.family == "vlm":
        out["extra_embeds"] = rng.standard_normal(
            (b_local, n_patch, cfg.d_model), dtype=np.float32
        ) * 0.02
        # M-RoPE 3D ids: patches get (t=0, h, w) grid ids; text continues 1D
        side_h = int(np.sqrt(n_patch))
        while n_patch % side_h:
            side_h -= 1
        side_w = n_patch // side_h
        hh, ww = np.meshgrid(np.arange(side_h), np.arange(side_w), indexing="ij")
        pos = np.zeros((3, b_local, seq_len), dtype=np.int32)
        pos[0, :, :n_patch] = 0
        pos[1, :, :n_patch] = hh.reshape(-1)[None, :]
        pos[2, :, :n_patch] = ww.reshape(-1)[None, :]
        text_pos = max(side_h, side_w) + np.arange(s_text, dtype=np.int32)
        pos[:, :, n_patch:] = text_pos[None, None, :]
        out["positions"] = pos
    if cfg.family == "audio":
        out["frames"] = rng.standard_normal(
            (b_local, cfg.enc_seq, cfg.d_model), dtype=np.float32
        ) * 0.02
    return out


def global_batch(cfg, *, seq_len: int, batch: int, step: int, seed: int = 0,
                 n_hosts: int = 1, reduced: bool = False) -> Dict[str, np.ndarray]:
    """Assemble the full global batch (concatenating host shards) — used by
    single-host tests/examples and to verify host-shard disjointness."""
    shards = [
        make_batch(cfg, seq_len=seq_len, batch=batch, step=step, seed=seed,
                   host=h, n_hosts=n_hosts, reduced=reduced)
        for h in range(n_hosts)
    ]
    return {
        k: np.concatenate([s[k] for s in shards], axis=1 if k == "positions" else 0)
        for k in shards[0]
    }
