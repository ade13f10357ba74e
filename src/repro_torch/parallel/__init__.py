"""Parallel layouts of the port (counterpart of `repro.parallel`): the
serving `Mesh` of device slots, the training `ProcessMesh` of ranks, the
logical-axis rules, the sharding trees, the collectives and the GPipe
pipeline."""
from repro_torch.parallel.api import (
    DEFAULT_RULES,
    Mesh,
    ProcessMesh,
    axes_leaves,
    axis_rules,
    current_mesh,
    data_mesh,
    is_axes_leaf,
    local_devices,
    logical_spec,
    shard,
    sharding_for,
)
from repro_torch.parallel.collectives import (
    all_gather,
    all_reduce,
    bucketed_psum,
    compressed_psum,
    reduce_scatter,
)
from repro_torch.parallel.pipeline import pipeline_apply, split_stages
from repro_torch.parallel.sharding import (
    batch_sharding,
    cache_sharding,
    gather_tree,
    opt_sharding,
    params_sharding,
    shard_tree,
)

__all__ = ["DEFAULT_RULES", "Mesh", "ProcessMesh", "all_gather", "all_reduce", "axes_leaves",
           "axis_rules", "batch_sharding", "bucketed_psum", "cache_sharding",
           "compressed_psum", "current_mesh", "data_mesh", "gather_tree", "is_axes_leaf",
           "local_devices", "logical_spec", "opt_sharding", "params_sharding",
           "pipeline_apply", "reduce_scatter", "shard", "shard_tree", "sharding_for",
           "split_stages"]
