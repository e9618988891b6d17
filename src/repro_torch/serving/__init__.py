"""Serving on dense KV caches: engine steps, continuous batcher, config."""

from .batcher import BatcherStats, ContinuousBatcher, Request
from .config import ServingConfig, config_from_legacy_kwargs
from .engine import (
    ServeConfig,
    SlotState,
    chunk_bucket,
    generate,
    init_slot_state,
    make_admit_step,
    make_decode_chunk,
    make_prefill_step,
    select_token,
)
from .kv_cache import cache_len, kv_cache_bytes, seed_kv_cache, tree_bytes

__all__ = [
    "BatcherStats", "ContinuousBatcher", "Request",
    "ServingConfig", "config_from_legacy_kwargs",
    "ServeConfig", "SlotState", "chunk_bucket", "generate",
    "init_slot_state", "make_admit_step", "make_decode_chunk",
    "make_prefill_step", "select_token",
    "cache_len", "kv_cache_bytes", "seed_kv_cache", "tree_bytes",
]
