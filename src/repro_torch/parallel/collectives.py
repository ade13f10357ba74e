"""Collectives over a `ProcessMesh`'s axes (counterpart of
`repro.parallel.collectives`, whose helpers run inside `shard_map`).

The primitives (`all_reduce`, `all_gather`, `reduce_scatter`) reduce,
gather or reduce and split over the ranks that differ from this one only
along the named axes, which are named in mesh order. Which
`torch.distributed` call they make is decided by the backend and the
tensor's device, in code: NCCL, and gloo on CPU tensors, gather with
`all_gather_into_tensor` and reduce-scatter with `reduce_scatter_tensor`;
gloo on CUDA tensors (ranks sharing a card) offers `all_reduce` and neither
of those, so there a gather is an `all_reduce` of a zero buffer holding
this rank's shard in its slot (exact: every element is one value plus
zeros) and a reduce-scatter is an `all_reduce` and a slice. The
point-to-point hop of `parallel.pipeline` stages gloo's CUDA tensors
through the host, where gloo's send / recv run.

`compressed_psum` is the int8 all-reduce with a per-shard scale exchange;
`bucketed_psum` reduces a tree as one flat fp32 buffer (the reference
ignores `bucket_bytes`, and so does this port).
"""
from __future__ import annotations

import torch
import torch.distributed as dist

from repro_torch.tree import tree_leaves, tree_unflatten


def _group_of(mesh_or_group, axes):
    """(group, global ranks in row-major order over `axes`, this rank's
    index among them) or None when one rank is along `axes`. A raw process
    group stands for its own ranks, in group-rank order."""
    if isinstance(mesh_or_group, dist.ProcessGroup):
        ranks = dist.get_process_group_ranks(mesh_or_group)
        if len(ranks) == 1:
            return None
        return mesh_or_group, ranks, ranks.index(dist.get_rank())
    got = mesh_or_group.group(axes)
    if got is None:
        return None
    group, ranks = got
    return group, ranks, ranks.index(mesh_or_group.rank)


def _native(group, x: torch.Tensor) -> bool:
    """Whether the backend gathers and reduce-scatters `x` itself (NCCL;
    gloo on CPU tensors only)."""
    return dist.get_backend(group) == "nccl" or x.device.type == "cpu"


def all_reduce(x: torch.Tensor, mesh_or_group, axes=None) -> torch.Tensor:
    """Sum of `x` over the ranks along `axes`, in place; `x` itself when
    one rank is along them."""
    g = _group_of(mesh_or_group, axes)
    if g is not None:
        dist.all_reduce(x, group=g[0])
    return x


def _all_gather_by_all_reduce(x: torch.Tensor, group, n: int, idx: int) -> torch.Tensor:
    """The n shards of the group stacked (n, *x.shape): an all_reduce of a
    zero buffer with this rank's shard in slot `idx`."""
    buf = torch.zeros((n,) + tuple(x.shape), dtype=x.dtype, device=x.device)
    buf[idx] = x
    dist.all_reduce(buf, group=group)
    return buf


def all_gather(x: torch.Tensor, mesh_or_group, axes=None, dim: int = 0) -> torch.Tensor:
    """The ranks' `x` along `axes` concatenated along `dim`, in row-major
    order over `axes` (the shard order `ProcessMesh.index` gives); `x`
    itself when one rank is along them."""
    g = _group_of(mesh_or_group, axes)
    if g is None:
        return x
    group, ranks, idx = g
    n = len(ranks)
    x = x.contiguous()
    if _native(group, x):
        out = torch.empty(n * x.numel(), dtype=x.dtype, device=x.device)
        dist.all_gather_into_tensor(out, x.reshape(-1), group=group)
        out = out.view((n,) + tuple(x.shape))
    else:
        out = _all_gather_by_all_reduce(x, group, n, idx)
    return torch.cat(out.unbind(0), dim=dim) if dim else out.reshape((-1,) + tuple(x.shape[1:]))


def _reduce_scatter_by_all_reduce(x: torch.Tensor, group, n: int, idx: int,
                                  dim: int) -> torch.Tensor:
    """Block `idx` of n along `dim` of the group's sum: an all_reduce of `x`
    in place and a slice (a view of `x`)."""
    dist.all_reduce(x, group=group)
    return x.narrow(dim, idx * (x.shape[dim] // n), x.shape[dim] // n)


def reduce_scatter(x: torch.Tensor, mesh_or_group, axes=None, dim: int = 0) -> torch.Tensor:
    """This rank's block along `dim` (its `ProcessMesh.index` over `axes`)
    of the sum of `x` over the ranks along `axes`; `x` itself when one
    rank is along them. Each rank sends and receives (n - 1) / n of `x`
    where the backend reduce-scatters; on gloo's CUDA tensors it is an
    `all_reduce` of `x` in place and a slice."""
    g = _group_of(mesh_or_group, axes)
    if g is None:
        return x
    group, ranks, idx = g
    n = len(ranks)
    if x.shape[dim] % n:
        raise ValueError(f"dim {dim} of {tuple(x.shape)} does not split over {n} ranks")
    if not _native(group, x):
        return _reduce_scatter_by_all_reduce(x, group, n, idx, dim)
    src = x.movedim(dim, 0).contiguous()
    out = torch.empty((src.shape[0] // n,) + tuple(src.shape[1:]), dtype=x.dtype,
                      device=x.device)
    dist.reduce_scatter_tensor(out, src, group=group)
    return out.movedim(0, dim)


def compressed_psum(x: torch.Tensor, mesh_or_group, axis=None,
                    generator: torch.Generator | None = None) -> torch.Tensor:
    """int8-quantized sum of `x` over the ranks along `axis`: each rank's
    scale is max(max|x|, 1e-12) / 127 and its payload round(x / scale)
    clipped to +-127, rounded stochastically (uniform noise in [-0.5, 0.5)
    from `generator`) when one is given. Over at most 8 ranks the result is
    the exact sum of each rank's dequantized payload; over more, the int32
    sum of the payloads times the ranks' mean scale (the reference's two
    paths)."""
    x32 = x.float()
    scale = torch.clamp_min(x32.abs().max(), 1e-12) / 127.0
    scaled = x32 / scale
    if generator is not None:
        noise = torch.rand(x.shape, generator=generator, dtype=torch.float32,
                           device=generator.device).to(x.device) - 0.5
        scaled = scaled + noise
    q = torch.clamp(torch.round(scaled), -127, 127)
    g = _group_of(mesh_or_group, axis)
    n = 1 if g is None else len(g[1])
    if n <= 8:
        return all_reduce(q * scale, mesh_or_group, axis)
    qsum = all_reduce(q.to(torch.int32), mesh_or_group, axis)
    scales = all_gather(scale.reshape(1), mesh_or_group, axis)
    return qsum.float() * scales.mean()


def bucketed_psum(tree, mesh_or_group, axis=None, bucket_bytes: int = 4 << 20):
    """The sum of a tree of tensors over the ranks along `axis`, reduced as
    one flat fp32 buffer; each leaf comes back in its own dtype.
    `bucket_bytes` is accepted and unused, as in the reference."""
    del bucket_bytes
    leaves = tree_leaves(tree)
    flat = torch.cat([leaf.reshape(-1).float() for leaf in leaves])
    red = all_reduce(flat, mesh_or_group, axis)
    out, off = [], 0
    for leaf in leaves:
        n = leaf.numel()
        out.append(red[off:off + n].reshape(leaf.shape).to(leaf.dtype))
        off += n
    return tree_unflatten(tree, out)
