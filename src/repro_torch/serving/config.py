"""Unified serving configuration: one validated dataclass for the batcher.

Counterpart of ``repro.serving.config``: the same fields, defaults and
cross-field rules, checked at construction against the port's
:data:`~repro_torch.models.attention.ATTN_CAPABILITIES`.  The port's
attention impls are ``"cuda"`` (the kernels, the default), ``"torch"`` (the
counterpart of ``"xla"``) and ``"naive"``.

``tp`` is the tensor-parallel width: the number of logical cores of the
batcher's device its decode is sharded over (``distributed.sharding``).
It runs with every impl, the kernels included: the reference refuses
``tp > 1`` unless ``attn_impl="xla"``, because its Pallas kernels were
single-device under ``shard_map``, while each of the port's kernels
computes the same function on a shard's head counts (the group ratio is
kept), so ``"cuda"`` runs them per shard (ROADMAP.md Queue 3).  The paged
pool, the prefix cache, speculative decode, overlap and the fault guards
(watchdog, page-table audit) run at every width.

The legacy kwargs constructor is kept as a thin deprecation shim::

    ContinuousBatcher(params, cfg, ServingConfig(slots=4, ...))   # new
    ContinuousBatcher(params, cfg, slots=4, ...)                  # shim,
                                                  # DeprecationWarning
"""

from __future__ import annotations

import dataclasses
from typing import Any, Optional

from ..models.attention import check_attn_impl


@dataclasses.dataclass(frozen=True)
class ServingConfig:
    """Everything a :class:`~repro_torch.serving.batcher.ContinuousBatcher`
    needs beyond (params, model cfg, device, clock).

    Core shape:
      slots        — fixed decode batch
      prompt_len   — prompt bucket: prompts are left-padded to this length
      max_len      — per-slot cache capacity (prompt + decode budget)
      attn_impl    — "cuda" | "torch" | "naive" (capability-checked per mode)
      chunk        — max decode steps fused per dispatch

    Paged pool (``paged``, ``page_size``, ``n_pages``, ``page_quota``,
    ``reserve_pages``), shared-prefix cache (``prefix_cache``), speculative
    decode (``speculative``, ``draft_window``, ``draft_ngram``,
    ``draft_hist``) and admission/decode overlap (``overlap``) as in
    ``repro.serving.config``, and so are the fault guards (``watchdog_s``,
    ``audit``) and the tensor-parallel width ``tp``.
    """

    slots: int
    prompt_len: int
    max_len: int
    attn_impl: str = "cuda"
    chunk: int = 8
    # paged KV pool
    paged: bool = False
    page_size: int = 16
    n_pages: Optional[int] = None
    page_quota: Optional[int] = None
    reserve_pages: bool = True
    prefix_cache: Any = None          # bool | None
    # fault guards
    watchdog_s: Optional[float] = None
    audit: bool = False
    # speculative decode + admission/decode overlap
    speculative: bool = False
    draft_window: int = 4
    draft_ngram: int = 2
    draft_hist: int = 64
    overlap: bool = False
    # tensor-parallel width: logical cores of the batcher's device
    tp: int = 1

    def __post_init__(self):
        if self.slots < 1:
            raise ValueError(f"slots must be >= 1, got {self.slots}")
        if self.prompt_len < 1:
            raise ValueError(
                f"prompt_len must be >= 1, got {self.prompt_len}")
        if self.max_len <= self.prompt_len:
            raise ValueError(
                f"max_len ({self.max_len}) must exceed prompt_len "
                f"({self.prompt_len}) — there is no room to decode")
        if self.chunk < 1:
            raise ValueError(f"chunk must be >= 1, got {self.chunk}")
        if self.tp < 1:
            raise ValueError(f"tp must be >= 1, got {self.tp}")
        check_attn_impl(self.attn_impl, "dense")
        if self.paged:
            check_attn_impl(self.attn_impl, "paged")
            if self.page_size < 1:
                raise ValueError(
                    f"page_size must be >= 1, got {self.page_size}")
            if self.n_pages is not None and self.n_pages < 1:
                raise ValueError(
                    f"n_pages must be >= 1, got {self.n_pages}")
        if self.prefix_cache:
            if not self.paged:
                raise ValueError("the prefix cache rides on the paged pool; "
                                 "pass paged=True")
            check_attn_impl(self.attn_impl, "prefix")
        if self.speculative:
            check_attn_impl(self.attn_impl, "verify")
            if self.draft_window < 2:
                raise ValueError(
                    f"draft_window must be >= 2 (one committed token plus "
                    f"at least one draft), got {self.draft_window}")
            if self.draft_ngram < 1:
                raise ValueError(
                    f"draft_ngram must be >= 1, got {self.draft_ngram}")
            if self.draft_hist < self.draft_ngram + self.draft_window:
                raise ValueError(
                    f"draft_hist ({self.draft_hist}) must hold at least "
                    f"draft_ngram + draft_window "
                    f"({self.draft_ngram + self.draft_window}) tokens")


def config_from_legacy_kwargs(**kwargs) -> ServingConfig:
    """Map the pre-:class:`ServingConfig` ``ContinuousBatcher`` kwargs onto
    a config.  Raises ``TypeError`` on unknown names."""
    fields = {f.name for f in dataclasses.fields(ServingConfig)}
    unknown = sorted(set(kwargs) - fields)
    if unknown:
        import difflib

        hints = []
        for name in unknown:
            close = difflib.get_close_matches(name, fields, n=1)
            if close:
                hints.append(f"{name!r} (did you mean {close[0]!r}?)")
            else:
                hints.append(repr(name))
        raise TypeError(
            f"unknown ContinuousBatcher argument(s): {', '.join(hints)}; "
            f"valid ServingConfig fields: {sorted(fields)}")
    return ServingConfig(**kwargs)
