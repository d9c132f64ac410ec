"""repro_torch.distributed — logical-axis sharding rules and the
feature-sharded estimator over ``torch.distributed`` (port of
``repro.distributed``). The reference's ``shard_map`` wrapper has no
counterpart: each rank of a ``DeviceMesh`` runs the per-shard code itself
(``distributed.estimator``). ``distributed.tensor_parallel`` gives a
rank its local view of a mesh with a ``"model"`` axis: its shards of the
params, its local config and the collectives of Megatron-style tensor
parallelism."""
from repro_torch.distributed.estimator import (
    FEATURE_AXIS,
    ShardedFeatureMap,
    make_sharded_feature_map,
    shard_init_params,
    sharded_apply,
    sharded_estimate_gram,
)
from repro_torch.distributed.sharding import (
    DEFAULT_RULES,
    batch_partition_specs,
    constrain,
    estimator_param_specs,
    logical_rules_context,
    params_partition_specs,
    set_default_rules,
)

__all__ = [
    "constrain",
    "logical_rules_context",
    "set_default_rules",
    "params_partition_specs",
    "batch_partition_specs",
    "estimator_param_specs",
    "DEFAULT_RULES",
    "FEATURE_AXIS",
    "ShardedFeatureMap",
    "make_sharded_feature_map",
    "shard_init_params",
    "sharded_apply",
    "sharded_estimate_gram",
]
