"""Distribution layer: the tensor-parallel serving layout and its runtime.

Counterpart of the serving half of ``repro.distributed`` (its
``sharding`` module's ``TPShardPolicy`` through ``tp_put_replicated``).
The train-side half (``param_specs``, ``ActivationPolicy``,
``make_policy``, ``cache_specs``, ``train_batch_specs``, ``batch_shard``)
and ``compression`` wait for training (ROADMAP.md Queue 1 item 14).
"""

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
    "P", "PerShard", "ShardGroup", "TP_POLICY", "TPShardPolicy", "check_tp",
    "make_tp_mesh", "mesh_device", "permute_params_for_tp", "tp_cache_specs",
    "tp_gather", "tp_local_cfg", "tp_param_specs", "tp_replicas", "tp_shards",
    "tp_supported", "tp_tree_bytes",
]
