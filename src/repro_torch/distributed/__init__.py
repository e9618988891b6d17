"""Distribution layer: the tensor-parallel serving layout and its runtime,
the SPMD runtime over a process group, and int8 gradient compression.

Counterpart of ``repro.distributed``: ``sharding`` holds the serving half
of the reference's ``sharding`` (``TPShardPolicy`` through
``tp_put_replicated``) and its specs (``param_specs``, ``cache_specs``,
``train_batch_specs``, ``batch_shard``); ``spmd`` its runtime half
(``param_shardings``, ``ActivationPolicy``, ``make_policy``) over a
``torch.distributed`` process group; ``compression`` the int8 quantizer
and ``pod_psum_compressed``; and the dry-run's instruments,
``op_analysis`` (roofline terms) and ``op_static`` (a cost counter over
the aten ops a program dispatches), the twins of ``hlo_analysis`` and
``hlo_static``.  Running over several cards (NCCL) is ROADMAP.md Queue 1
item 18 part b.
"""

from .compression import (
    compress_with_feedback,
    dequantize_int8,
    init_error_feedback,
    pod_psum_compressed,
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

from .spmd import (
    ActivationPolicy,
    CollectiveLog,
    gather_param_shards,
    make_policy,
    param_shardings,
    policy_supported,
)

__all__ = [
    "ActivationPolicy", "CollectiveLog", "gather_param_shards",
    "make_policy", "param_shardings", "policy_supported",
    "compress_with_feedback", "dequantize_int8", "init_error_feedback",
    "pod_psum_compressed", "quantization_error", "quantize_int8",
    "P", "PerShard", "batch_shard", "cache_specs", "data_axes",
    "mesh_axis_size", "param_specs", "train_batch_specs", "ShardGroup",
    "TP_POLICY", "TPShardPolicy", "check_tp",
    "make_tp_mesh", "mesh_device", "permute_params_for_tp", "tp_cache_specs",
    "tp_gather", "tp_local_cfg", "tp_param_specs", "tp_replicas", "tp_shards",
    "tp_supported", "tp_tree_bytes",
]
