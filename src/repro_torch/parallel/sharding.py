"""Sharding trees for params / optimizer state / caches / batches
(counterpart of `repro.parallel.sharding`), and the port's placement of a
tree under them.

The reference returns `NamedSharding` trees; here each leaf is the spec
tuple `logical_spec` resolves (one entry per dim: a mesh axis, a tuple of
axes, or None), in the value tree's structure. `shard_tree` and
`gather_tree` are the port's counterpart of `device_put` under those
shardings: a dim split over several axes (("pod", "data")) splits over
their product, pod-major, as the reference's does.
"""
from __future__ import annotations

import torch

from repro_torch.configs.base import ModelConfig, RunConfig
from repro_torch.launch.steps import DTYPES
from repro_torch.models import model as M
from repro_torch.optim.adamw import OptState
from repro_torch.parallel.api import axes_leaves, logical_spec
from repro_torch.parallel.collectives import all_gather
from repro_torch.tree import state_leaves, state_unflatten, tree_map

def _zip_spec(shapes_tree, axes_tree, mesh):
    """Map (shape leaf, logical axes) pairs to a tree of specs."""
    flat_s = state_leaves(shapes_tree)
    flat_a = axes_leaves(axes_tree)
    if len(flat_s) != len(flat_a):
        raise ValueError(f"{len(flat_s)} leaves but {len(flat_a)} axes annotations")
    return state_unflatten(shapes_tree, [logical_spec(tuple(s.shape), a, mesh)
                                         for s, a in zip(flat_s, flat_a)])


def params_sharding(cfg: ModelConfig, mesh, dtype=torch.bfloat16):
    """(spec tree, meta-tensor shapes tree) of the parameters."""
    shapes, axes = M.abstract_params(cfg, dtype)
    return _zip_spec(shapes, axes, mesh), shapes


def opt_sharding(cfg: ModelConfig, mesh, run: RunConfig, param_shapes):
    """Moments shard exactly like the params (FSDP / ZeRO: the state lives
    with its shard); the step count is replicated."""
    axes = M.param_axes(cfg)
    mdt = DTYPES[run.moment_dtype]
    mom_shapes = tree_map(lambda s: torch.empty(s.shape, dtype=mdt, device="meta"),
                          param_shapes)
    mom_spec = _zip_spec(mom_shapes, axes, mesh)
    state_shapes = OptState(step=torch.empty((), dtype=torch.int32, device="meta"),
                            m=mom_shapes, v=mom_shapes)
    return OptState(step=(), m=mom_spec, v=mom_spec), state_shapes


def cache_sharding(cfg: ModelConfig, mesh, batch: int, max_len: int, dtype=torch.bfloat16):
    shapes, axes = M.abstract_cache(cfg, batch, max_len, dtype)
    return _zip_spec(shapes, axes, mesh), shapes


_BATCH_AXES = {
    "tokens": ("batch", None),
    "labels": ("batch", None),
    "img_embeds": ("batch", None, None),
    "frames": ("batch", None, None),
    "enc_out": ("batch", None, None),
}


def batch_sharding(specs: dict, mesh) -> dict:
    return {k: logical_spec(tuple(v.shape), _BATCH_AXES[k], mesh) for k, v in specs.items()}


def spec_axes(entry) -> tuple:
    """One spec entry as a tuple of mesh axes (() for a replicated dim)."""
    if entry is None:
        return ()
    return (entry,) if isinstance(entry, str) else tuple(entry)


def shard_leaf(x: torch.Tensor, spec: tuple, mesh) -> torch.Tensor:
    """This rank's block of the whole tensor `x` under `spec`: each split
    dim narrowed to the block `mesh.index` names; `x` itself when nothing
    is split."""
    for dim, entry in enumerate(spec):
        axes = spec_axes(entry)
        if axes:
            k = mesh.count(axes)
            size = x.shape[dim] // k
            x = x.narrow(dim, mesh.index(axes) * size, size)
    return x


def gather_leaf(x: torch.Tensor, spec: tuple, mesh) -> torch.Tensor:
    """The whole tensor from this rank's block under `spec` (a collective
    over every rank of the mesh's groups along the split axes)."""
    for dim, entry in enumerate(spec):
        axes = spec_axes(entry)
        if axes:
            x = all_gather(x, mesh, axes, dim=dim)
    return x


def leaves_with_specs(tree, specs):
    """[(leaf, spec)] of a value tree and its spec tree (walked by the value
    tree's structure, so a spec tuple is never taken for a container)."""
    if tree is None:
        return []
    if isinstance(tree, dict):
        return [p for k in sorted(tree) for p in leaves_with_specs(tree[k], specs[k])]
    if isinstance(tree, (tuple, list)):
        return [p for t, s in zip(tree, specs) for p in leaves_with_specs(t, s)]
    return [(tree, specs)]


def shard_tree(whole_tree, specs, mesh):
    """This rank's shards (contiguous copies) of a tree of whole logical
    arrays."""
    return state_unflatten(whole_tree, [shard_leaf(x, s, mesh).contiguous().clone()
                                        if any(spec_axes(e) for e in s) else x
                                        for x, s in leaves_with_specs(whole_tree, specs)])


def gather_tree(local_tree, specs, mesh):
    """The whole logical arrays of a tree of this rank's shards (collective:
    every rank of the mesh calls it)."""
    return state_unflatten(local_tree, [gather_leaf(x, s, mesh)
                                        for x, s in leaves_with_specs(local_tree, specs)])
