"""Tensor-parallel decode shards (``repro.parallel.sharding``'s serving half)."""
from repro_torch.parallel.sharding import slice_decode_params, stack_decode_shards, unstack_decode_shards

__all__ = ["slice_decode_params", "stack_decode_shards", "unstack_decode_shards"]
