"""Elastic re-meshing: rebuild a smaller mesh after a node loss and reshard
(counterpart of `repro.runtime.elastic`).

The flow: the survivors rebuild the mesh with a shrunken data axis
(`shrink_mesh`; every rank of the default group takes part in making the
new groups, and a dropped rank, off the new grid, leaves), restore the
latest whole-array checkpoint or gather the state, keep their shards
under the new mesh (`reshard_state`), and replay the data pipeline from
the step counter. The global batch stays fixed, so each data rank's share
grows and `grad_accum` absorbs it (`rebalance_grad_accum`).
"""
from __future__ import annotations

import math

import numpy as np

from repro_torch.parallel.api import ProcessMesh, axes_leaves, logical_spec
from repro_torch.parallel.sharding import shard_leaf
from repro_torch.tree import state_leaves, state_unflatten


def shrink_mesh(mesh: ProcessMesh, lost_data_slices: int = 1) -> ProcessMesh:
    """Drop the last `lost_data_slices` rows of the data axis (the failed
    hosts). Collective: every rank of the default group calls it; on a
    dropped rank the new mesh's `member` is False."""
    di = mesh.axis_names.index("data")
    keep = mesh.ranks.shape[di] - lost_data_slices
    if keep < 1:
        raise ValueError("cannot shrink data axis below 1")
    ranks = np.take(mesh.ranks, np.arange(keep), axis=di)
    return ProcessMesh(ranks.shape, mesh.axis_names, ranks=ranks, device=mesh.device)


def reshard_state(state, axes_tree, new_mesh: ProcessMesh):
    """This rank's shards, under the new mesh's resolved specs, of a state
    tree of whole logical arrays (from a gather or a checkpoint)."""
    flat_s = state_leaves(state)
    flat_a = axes_leaves(axes_tree)
    if len(flat_s) != len(flat_a):
        raise ValueError(f"{len(flat_s)} leaves but {len(flat_a)} axes annotations")
    out = []
    for leaf, ax in zip(flat_s, flat_a):
        spec = logical_spec(tuple(np.shape(leaf)), ax, new_mesh)
        shard = shard_leaf(leaf, spec, new_mesh)
        out.append(shard.contiguous().clone() if shard is not leaf else leaf)
    return state_unflatten(state, out)


def rebalance_grad_accum(run, old_mesh, new_mesh):
    """Keep the global batch fixed: scale grad_accum by the dp shrink factor."""
    old_dp = math.prod(old_mesh.shape[a] for a in old_mesh.axis_names if a != "model")
    new_dp = math.prod(new_mesh.shape[a] for a in new_mesh.axis_names if a != "model")
    if old_dp == new_dp:
        return run
    scale = max(1, round(old_dp / new_dp))
    return run.replace(grad_accum=run.grad_accum * scale)
