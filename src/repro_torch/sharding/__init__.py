"""Tensor parallelism of the port: the logical-axis rules
(:mod:`.specs`, the port's copy of ``repro.sharding.specs``) and the one
module that calls collectives (:mod:`.comm`)."""
from .specs import (
    ShardingRules,
    activation_rules,
    batch_axes,
    default_rules,
    heads_shard_axis,
    leaf_split,
    leaf_splits,
    local_shape,
    logical_pspec,
    mesh_shape,
    opt_enabled,
    param_pspecs,
    serve_rules,
    set_activation_rules,
    shard_params,
    tp_degree,
)

__all__ = [
    "ShardingRules", "activation_rules", "batch_axes", "default_rules", "heads_shard_axis", "leaf_split",
    "leaf_splits", "local_shape", "logical_pspec", "mesh_shape", "opt_enabled", "param_pspecs", "serve_rules",
    "set_activation_rules", "shard_params", "tp_degree",
]
