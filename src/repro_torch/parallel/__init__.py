"""Sharding rules and tensor-parallel shards (``repro.parallel.sharding``)."""
from repro_torch.parallel.sharding import (
    P, ShardingRules, current_rules, param_shardings, regather_layer_params, shard, slice_decode_params, spec,
    spec_for_param_path, stack_decode_shards, unstack_decode_shards, use_rules,
)

__all__ = ["P", "ShardingRules", "current_rules", "param_shardings", "regather_layer_params", "shard",
           "slice_decode_params", "spec", "spec_for_param_path", "stack_decode_shards", "unstack_decode_shards",
           "use_rules"]
