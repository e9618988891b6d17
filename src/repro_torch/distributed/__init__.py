"""Distribution layer: the tensor-parallel serving layout and its runtime,
and int8 gradient compression.

Counterpart of the serving half of ``repro.distributed`` (its
``sharding`` module's ``TPShardPolicy`` through ``tp_put_replicated``) and
of ``compression`` up to its cross-pod all-reduce.  The train-side half of
``sharding`` (``param_specs``, ``ActivationPolicy``, ``make_policy``,
``cache_specs``, ``train_batch_specs``, ``batch_shard``) and
``compression.pod_psum_compressed`` shard over a mesh of several cards and
wait for ROADMAP.md Queue 1 item 18.
"""

from .compression import (
    compress_with_feedback,
    dequantize_int8,
    init_error_feedback,
    quantization_error,
    quantize_int8,
)
from .sharding import (
    P,
    PerShard,
    ShardGroup,
    TP_POLICY,
    TPShardPolicy,
    check_tp,
    make_tp_mesh,
    mesh_device,
    permute_params_for_tp,
    tp_cache_specs,
    tp_gather,
    tp_local_cfg,
    tp_param_specs,
    tp_replicas,
    tp_shards,
    tp_supported,
    tp_tree_bytes,
)

__all__ = [
    "compress_with_feedback", "dequantize_int8", "init_error_feedback",
    "quantization_error", "quantize_int8",
    "P", "PerShard", "ShardGroup", "TP_POLICY", "TPShardPolicy", "check_tp",
    "make_tp_mesh", "mesh_device", "permute_params_for_tp", "tp_cache_specs",
    "tp_gather", "tp_local_cfg", "tp_param_specs", "tp_replicas", "tp_shards",
    "tp_supported", "tp_tree_bytes",
]
