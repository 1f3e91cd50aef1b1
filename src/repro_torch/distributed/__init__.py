"""Mesh, sharding rules and tensor parallelism (counterpart of ``repro.distributed``)."""

from .sharding import (Mesh, ParallelismRules, activation_sharding, batch_pspec, cache_pspec,
                       copy_to_tp, explain, leaf_pspec, param_pspecs, reduce_from_tp, shard_params)

__all__ = ["Mesh", "ParallelismRules", "activation_sharding", "batch_pspec", "cache_pspec",
           "copy_to_tp", "explain", "leaf_pspec", "param_pspecs", "reduce_from_tp",
           "shard_params"]
