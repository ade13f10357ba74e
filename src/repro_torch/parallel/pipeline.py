"""GPipe-style pipeline parallelism over a mesh axis (counterpart of
`repro.parallel.pipeline`).

`pipeline_apply` runs S stages on the S ranks along `axis` with M
microbatches on the (M + S - 1)-tick schedule: at tick t, stage s runs
microbatch t - s and hands its activation to stage s + 1 by a
point-to-point send. The hop is a `torch.autograd.Function` whose backward
is the reverse hop, so autograd gives the GPipe backward wave, and the
gradient of stage s's parameters lands on its own rank. The output is
summed over the stage axis, so every rank holds it (the reference's
`psum`); its backward hands each rank's gradient to its own stages, so
every rank computes the same loss from the output, as under SPMD.

Messages carry the microbatch as their tag, and every rank runs its
backward in the reverse order of its forward, so the sends and receives
pair up. gloo sends host tensors only: on gloo a CUDA activation goes
through the host; NCCL sends it from the card.
"""
from __future__ import annotations

import torch
import torch.distributed as dist

from repro_torch.parallel.collectives import all_reduce
from repro_torch.tree import tree_map


def _send(x: torch.Tensor, dst: int, tag: int) -> None:
    if dist.get_backend() == "gloo" and x.device.type != "cpu":
        x = x.cpu()
    dist.send(x.contiguous(), dst, tag=tag)


def _recv(like_shape, dtype, device, src: int, tag: int) -> torch.Tensor:
    staged = dist.get_backend() == "gloo" and device.type != "cpu"
    buf = torch.empty(like_shape, dtype=dtype, device="cpu" if staged else device)
    dist.recv(buf, src, tag=tag)
    return buf.to(device) if staged else buf


class _HopSend(torch.autograd.Function):
    """Forward: send y to the next stage, return a zero scalar that joins
    the output. Backward: receive dL/dy from the next stage."""

    @staticmethod
    def forward(ctx, y, dst: int, tag: int):
        ctx.meta = (tuple(y.shape), y.dtype, y.device, dst, tag)
        _send(y.detach(), dst, tag)
        return torch.zeros((), dtype=y.dtype, device=y.device)

    @staticmethod
    def backward(ctx, _):
        shape, dtype, device, dst, tag = ctx.meta
        return _recv(shape, dtype, device, dst, tag), None, None


class _HopRecv(torch.autograd.Function):
    """Forward: receive x from the previous stage (`anchor` only ties the
    node into the graph). Backward: send dL/dx back to it."""

    @staticmethod
    def forward(ctx, anchor, shape, dtype, src: int, tag: int):
        ctx.meta = (src, tag)
        return _recv(shape, dtype, anchor.device, src, tag)

    @staticmethod
    def backward(ctx, grad):
        src, tag = ctx.meta
        _send(grad, src, tag)
        return None, None, None, None, None


class _SumOverStages(torch.autograd.Function):
    """Forward: the sum over the stage axis. Backward: each rank's gradient
    to its own contribution."""

    @staticmethod
    def forward(ctx, x, mesh, axis):
        return all_reduce(x.clone(), mesh, axis)

    @staticmethod
    def backward(ctx, grad):
        return grad, None, None


def pipeline_apply(stage_fn, stage_params, x_micro: torch.Tensor, *, mesh, axis: str = "pod"):
    """stage_params: tree with leaves stacked (S, ...), of which this rank
    uses row s (its index along `axis`); x_micro: (M, mb, ...), the same on
    every rank (only stage 0 reads it). stage_fn(params_of_one_stage, x) ->
    y with y.shape == x.shape. Returns the (M, mb, ...) outputs of the
    whole S-stage pipeline on every rank."""
    s_count, m_count = mesh.shape[axis], x_micro.shape[0]
    sid = mesh.coords[axis]
    params_me = tree_map(lambda p: p[sid], stage_params)

    def neighbour(step: int) -> int:
        coords = dict(mesh.coords, **{axis: sid + step})
        return int(mesh.ranks[tuple(coords[a] for a in mesh.axis_names)])

    anchor = torch.zeros((), device=x_micro.device, requires_grad=True)
    mb_shape = tuple(x_micro.shape[1:])
    outputs, hops = [], torch.zeros((), dtype=x_micro.dtype, device=x_micro.device)
    for t in range(m_count + s_count - 1):
        j = t - sid
        if not 0 <= j < m_count:
            continue
        x_in = (x_micro[j] if sid == 0 else
                _HopRecv.apply(anchor, mb_shape, x_micro.dtype, neighbour(-1), j))
        y = stage_fn(params_me, x_in)
        if sid == s_count - 1:
            outputs.append(y)
        else:
            hops = hops + _HopSend.apply(y, neighbour(1), j)
    if sid == s_count - 1:
        out = torch.stack(outputs)
    else:
        out = torch.zeros((m_count,) + mb_shape, dtype=x_micro.dtype, device=x_micro.device)
    return _SumOverStages.apply(out + hops, mesh, axis)


def split_stages(stacked_params, n_stages: int):
    """Reshape (L, ...) stacked layer params into (S, L/S, ...) stage stacks."""
    def r(x):
        n_layers = x.shape[0]
        if n_layers % n_stages:
            raise ValueError(f"{n_layers} layers do not split into {n_stages} stages")
        return x.reshape(n_stages, n_layers // n_stages, *x.shape[1:])

    return tree_map(r, stacked_params)
