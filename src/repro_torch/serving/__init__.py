"""Serving on dense KV caches and on the paged pool with shared-prefix
admission, with optional speculative decode and admission/decode overlap:
engine steps, continuous batcher, config, page ledger and prefix cache;
and tenancy, the hypervisor's serving adapter (leased logical cores, the
two-stage compiler, live-state migration between chunks, tensor-parallel
re-meshing of a live batcher)."""

from .batcher import BatcherStats, ContinuousBatcher, Request
from .config import ServingConfig, config_from_legacy_kwargs
from .engine import (
    DraftState,
    PageState,
    ServeConfig,
    SlotState,
    chunk_bucket,
    generate,
    init_draft_state,
    init_page_state,
    init_slot_state,
    make_admit_step,
    make_cached_admit_step,
    make_decode_chunk,
    make_page_push,
    make_paged_admit_step,
    make_paged_decode_chunk,
    make_paged_spec_decode_chunk,
    make_prefill_step,
    make_serve_step,
    make_spec_decode_chunk,
    select_token,
    tp_program,
)
from .kv_cache import (
    PagedKVPool,
    PageQuotaError,
    cache_len,
    kv_cache_bytes,
    page_bytes,
    paged_kv_cache_bytes,
    pages_for,
    seed_kv_cache,
    seed_ssm_state,
    tree_bytes,
)
from .prefix_cache import PrefixCache, PrefixNode
from .tenancy import (
    TensorSpec,
    TwoStageCompiler,
    ServingExecutor,
    VirtualAcceleratorPool,
    make_serving_hypervisor,
)

__all__ = [
    "BatcherStats", "ContinuousBatcher", "Request",
    "ServingConfig", "config_from_legacy_kwargs",
    "DraftState", "PageState", "ServeConfig", "SlotState", "chunk_bucket",
    "generate", "init_draft_state", "init_page_state", "init_slot_state",
    "make_admit_step", "make_cached_admit_step", "make_decode_chunk",
    "make_page_push", "make_paged_admit_step", "make_paged_decode_chunk",
    "make_paged_spec_decode_chunk", "make_prefill_step",
    "make_serve_step", "make_spec_decode_chunk", "select_token", "tp_program",
    "PagedKVPool", "PageQuotaError", "cache_len", "kv_cache_bytes",
    "page_bytes", "paged_kv_cache_bytes", "pages_for", "seed_kv_cache",
    "seed_ssm_state", "tree_bytes",
    "PrefixCache", "PrefixNode",
    "TensorSpec", "TwoStageCompiler", "ServingExecutor",
    "VirtualAcceleratorPool", "make_serving_hypervisor",
]
