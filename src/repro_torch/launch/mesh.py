"""Training meshes over `torch.distributed` ranks (counterpart of
`repro.launch.mesh`), and the process group they stand on.

The backend is chosen by rule, never by trying one and falling back:
gloo on the host; gloo for ranks that share a card (NCCL refuses two ranks
on one device); NCCL for one card per rank. The rule counts the ranks on
this host (LOCAL_WORLD_SIZE), not the world: 2 hosts of 8 ranks over 8
cards each take NCCL. `init_distributed` starts the default group from
`torchrun`'s environment (RANK, WORLD_SIZE, LOCAL_WORLD_SIZE, LOCAL_RANK,
MASTER_ADDR, MASTER_PORT).
"""
from __future__ import annotations

import math
import os

import torch
import torch.distributed as dist

from repro_torch.device import resolve_device
from repro_torch.parallel.api import ProcessMesh


def world_size() -> int:
    """The default group's size, or 1 without one (the counterpart of
    `jax.device_count()` on one device)."""
    return dist.get_world_size() if dist.is_available() and dist.is_initialized() else 1


def local_world_size() -> int:
    """The ranks on this host: torchrun's LOCAL_WORLD_SIZE, else the world
    size (one host)."""
    return int(os.environ.get("LOCAL_WORLD_SIZE", os.environ.get("WORLD_SIZE", 1)))


def backend_for(device, local_world: int) -> str:
    """NCCL when the ranks' tensors live on cards and this host has a card
    for each of its `local_world` ranks; gloo for CPU tensors or for ranks
    that share a card."""
    cuda = torch.device(device).type == "cuda"
    return "nccl" if cuda and local_world <= torch.cuda.device_count() else "gloo"


def rank_device(device, backend: str) -> torch.device:
    """This rank's device: with NCCL the card of its local rank
    (LOCAL_RANK, else the global rank modulo the cards), otherwise `device`
    as given (the host, or the one card the ranks share)."""
    dev = resolve_device(device)
    if backend == "nccl":
        local = int(os.environ.get("LOCAL_RANK", dist.get_rank() % torch.cuda.device_count()))
        dev = torch.device("cuda", local)
        torch.cuda.set_device(dev)
    return dev


def init_distributed(device=None) -> torch.device:
    """Start the default process group from `torchrun`'s environment when
    it names more than one rank, with `backend_for(device,
    local_world_size())`; a group already started is kept. Returns this
    rank's device. With one rank it starts nothing."""
    dev = resolve_device(device)
    world = int(os.environ.get("WORLD_SIZE", 1))
    if not dist.is_initialized():
        if world == 1:
            return dev
        dist.init_process_group(backend_for(dev, local_world_size()))
    return rank_device(dev, dist.get_backend())


def make_production_mesh(*, multi_pod: bool = False, device=None) -> ProcessMesh:
    """16x16 ("data", "model") over 256 ranks, or 2x16x16 ("pod", "data",
    "model") over 512; raises unless the world has exactly that many."""
    shape = (2, 16, 16) if multi_pod else (16, 16)
    axes = ("pod", "data", "model") if multi_pod else ("data", "model")
    n = world_size()
    if n != math.prod(shape):
        raise ValueError(f"the production mesh {shape} needs {math.prod(shape)} ranks; "
                         f"the world has {n}")
    return ProcessMesh(shape, axes, device=device)


def make_host_mesh(model_axis: int = 1, device=None) -> ProcessMesh:
    """(world // model_axis, model_axis) over ("data", "model"): every rank
    of the default group, or the one process without a group."""
    n = world_size()
    if model_axis < 1 or n % model_axis:
        raise ValueError(f"model axis {model_axis} does not divide the {n} ranks")
    return ProcessMesh((n // model_axis, model_axis), ("data", "model"), device=device)
