"""Serving over a (stream, freq) mesh of devices from one controller."""

from folve_tpu_torch.parallel.serving import (
    ServingMesh,
    ShardedArray,
    check_freq_shardable,
    make_serving_mesh,
    make_sharded_serving_step,
    shard_states_and_bank,
)

__all__ = [
    "ServingMesh",
    "ShardedArray",
    "check_freq_shardable",
    "make_serving_mesh",
    "make_sharded_serving_step",
    "shard_states_and_bank",
]
