"""Distribution layer: the tensor-parallel serving layout and its runtime,
and int8 gradient compression.

Counterpart of the serving half of ``repro.distributed`` (its
``sharding`` module's ``TPShardPolicy`` through ``tp_put_replicated``) and
of ``compression`` up to its cross-pod all-reduce; the train-side specs of
``sharding`` (``param_specs``, ``cache_specs``, ``train_batch_specs``,
``batch_shard``) as a layout over a mesh description; and the dry-run's
instruments, ``op_analysis`` (roofline terms) and ``op_static`` (a cost
counter over the aten ops a program dispatches), the twins of
``hlo_analysis`` and ``hlo_static``.  The runtime half of the training
layout (``ActivationPolicy``, ``make_policy``, ``param_shardings``) and
``compression.pod_psum_compressed`` shard over several cards and wait for
ROADMAP.md Queue 1 item 18.
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
    batch_shard,
    cache_specs,
    data_axes,
    mesh_axis_size,
    param_specs,
    train_batch_specs,
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
    "P", "PerShard", "batch_shard", "cache_specs", "data_axes",
    "mesh_axis_size", "param_specs", "train_batch_specs", "ShardGroup",
    "TP_POLICY", "TPShardPolicy", "check_tp",
    "make_tp_mesh", "mesh_device", "permute_params_for_tp", "tp_cache_specs",
    "tp_gather", "tp_local_cfg", "tp_param_specs", "tp_replicas", "tp_shards",
    "tp_supported", "tp_tree_bytes",
]
