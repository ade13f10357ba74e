"""Logical-axis sharding rules and the 1-D data mesh (counterpart of
`repro.parallel.api`).

Model code names tensor dimensions ("batch", "heads", "experts", ...). A
rules table maps each name to an ordered list of candidate mesh-axis
tuples. Resolution per tensor:

  for each dim (left to right), take the first candidate whose axes are all
  (a) present in the mesh, (b) not already used by an earlier dim of this
  tensor, and (c) divide the dim size evenly. Otherwise the dim is replicated.

On a 1-D "data" mesh, "batch" resolves to ("data",): the serving engine's
data-parallel layout (`pipeline.run_plan_sharded`,
`serving.graph_runner.ShardedRunner`). Outside an `axis_rules` context and
without a mesh argument, `logical_spec` resolves nothing.

The reference's mesh is a grid of JAX devices. The port has two forms:

- `Mesh`, a grid of `torch.device` slots in one process, where one device
  may fill several slots (two shards on one card, or the host's CPU
  standing for N devices, as the reference's virtual CPU devices do).
  `data_mesh(n, devices=...)` builds such a mesh for serving.
- `ProcessMesh`, a grid of `torch.distributed` ranks, one process each,
  for training: this rank's coordinates, its device, and a process group
  for every set of axes (`launch.mesh.make_host_mesh` builds one over the
  default process group).

`sharding_for` resolves a tensor's spec on the mesh in context, and
`shard` checks a tensor's names against it. GSPMD's constraints change no
value; the port computes the reference's function with the model axis as
a storage split (`launch.train.build_trainer`), so `shard` returns its
input.
"""
from __future__ import annotations

import itertools
import math
from contextlib import contextmanager
from typing import Optional, Sequence

import numpy as np
import torch
import torch.distributed as dist
from torch.utils.weak import WeakIdKeyDictionary

from repro_torch.device import resolve_device

# fsdp: parameter dims that shard over the data axes (ZeRO-3); the "pod" axis
# joins both the batch and the fsdp shardings on the multi-pod mesh.
DEFAULT_RULES: dict[str, list[tuple[str, ...]]] = {
    # activations
    "batch": [("pod", "data"), ("data",)],
    "seq_sp": [("model",)],  # Megatron-SP activation sequence sharding
    "act_embed": [],
    # caches / recurrent state
    "cache_seq": [("pod", "data"), ("data",)],
    "cache_kv": [("model",)],
    "cache_hd": [("model",)],
    # params
    "vocab": [("model",)],
    "embed": [("pod", "data"), ("data",)],  # FSDP dim
    "heads": [("model",)],
    "kv_heads": [("model",)],
    "head_dim": [],
    "mlp": [("model",)],
    "experts": [("model",)],  # EP
    "expert_cap": [("pod", "data"), ("data",)],
    "kv_lora": [],
    "q_lora": [],
    "layers": [],
    "none": [],
}


class Mesh:
    """A named grid of device slots (the counterpart of
    `jax.sharding.Mesh`): `devices`, an object array of `torch.device`s
    with one dim per name in `axis_names`; `shape`, {axis: size} in axis
    order; `size`, the number of slots; `slots`, the devices in slot order.

    `place(tensor, device)` is `tensor` on `device`: the tensor itself when
    it lives there, otherwise a copy the mesh makes once and hands out
    again while the tensor lives and is unchanged (its version counter)."""

    def __init__(self, devices, axis_names: Sequence[str]):
        arr = np.array(devices, dtype=object)
        for idx in np.ndindex(arr.shape):
            d = torch.device(arr[idx])
            if d.type == "cuda" and d.index is None:
                d = torch.device("cuda", torch.cuda.current_device())
            arr[idx] = d
        self.axis_names = tuple(str(a) for a in axis_names)
        if arr.ndim != len(self.axis_names) or arr.size == 0:
            raise ValueError(f"a mesh of device shape {arr.shape} cannot take the "
                             f"axes {self.axis_names}")
        self.devices = arr
        self.shape = dict(zip(self.axis_names, (int(s) for s in arr.shape)))
        self._copies = WeakIdKeyDictionary()  # tensor -> (version, {device: copy})

    @property
    def size(self) -> int:
        return int(self.devices.size)

    @property
    def slots(self) -> list:
        return list(self.devices.flat)

    def place(self, tensor: torch.Tensor, device: torch.device) -> torch.Tensor:
        if tensor.device == device:
            return tensor
        entry = self._copies.get(tensor)
        if entry is None or entry[0] != tensor._version:
            entry = (tensor._version, {})
            self._copies[tensor] = entry
        if device not in entry[1]:
            with torch.no_grad():
                entry[1][device] = tensor.detach().to(device)
        return entry[1][device]

    def __repr__(self) -> str:
        return f"Mesh({self.shape}, slots={[str(d) for d in self.slots]})"


class ProcessMesh:
    """A named grid of `torch.distributed` ranks (the training counterpart
    of `jax.sharding.Mesh`): `ranks`, an int array of global ranks with one
    dim per name in `axis_names`; `shape`, {axis: size} in axis order;
    `size`; `rank`, this process's global rank, and `coords`, its
    {axis: index} on the grid (None when this rank is not on it, as a
    rank dropped by `runtime.elastic.shrink_mesh`); `device`, where this
    rank's tensors live; `backend`, the default group's backend (None
    without a process group, where the mesh must hold one rank).

    For every set of axes with more than one rank it makes the process
    groups of the ranks that differ only along those axes ("the ranks that
    differ only along data" is what a reduction over data uses). New
    groups are collective over the default group, so every rank, on the
    grid or not, builds every mesh in the same order."""

    def __init__(self, shape: Sequence[int], axis_names: Sequence[str], *, ranks=None,
                 device=None):
        self.axis_names = tuple(str(a) for a in axis_names)
        shape = tuple(int(s) for s in shape)
        if len(shape) != len(self.axis_names) or not shape or min(shape) < 1:
            raise ValueError(f"a mesh of shape {shape} cannot take the axes {self.axis_names}")
        on = dist.is_available() and dist.is_initialized()
        world = dist.get_world_size() if on else 1
        self.rank = dist.get_rank() if on else 0
        self.backend = dist.get_backend() if on else None
        grid = np.arange(math.prod(shape)) if ranks is None else np.asarray(ranks, dtype=int)
        grid = grid.reshape(shape)
        if len(set(grid.flat)) != grid.size or grid.min() < 0 or grid.max() >= world:
            raise ValueError(f"mesh ranks {grid.tolist()} are not distinct ranks of a "
                             f"world of {world}")
        self.ranks = grid
        self.shape = dict(zip(self.axis_names, shape))
        self.size = int(grid.size)
        where = np.argwhere(grid == self.rank)
        self.coords = (dict(zip(self.axis_names, (int(i) for i in where[0])))
                       if len(where) else None)
        self.device = resolve_device(device)
        if self.device.type == "cuda" and self.device.index is None:
            self.device = torch.device("cuda", torch.cuda.current_device())
        self._groups = {}  # axes (mesh order) -> this rank's (group, ranks in row-major order)
        for k in range(1, len(shape) + 1):
            for axes in itertools.combinations(self.axis_names, k):
                if math.prod(self.shape[a] for a in axes) == 1:
                    continue
                order = [self.axis_names.index(a) for a in axes]
                rest = [i for i in range(len(shape)) if i not in order]
                lines = np.transpose(grid, rest + order).reshape(
                    -1, math.prod(self.shape[a] for a in axes))
                for line in lines:
                    members = [int(r) for r in line]
                    group = dist.new_group(members) if on else None
                    if self.rank in members:
                        self._groups[axes] = (group, members)

    @property
    def member(self) -> bool:
        """Whether this rank is on the grid."""
        return self.coords is not None

    def _mesh_order(self, axes) -> tuple:
        """`axes` as a tuple; raises unless they are axes of the mesh named
        in its order (the order every spec and rule names them in)."""
        axes = (axes,) if isinstance(axes, str) else tuple(axes)
        missing = [a for a in axes if a not in self.shape]
        if missing:
            raise ValueError(f"axes {missing} are not on the mesh {self.axis_names}")
        if axes != tuple(a for a in self.axis_names if a in axes):
            raise ValueError(f"axes {axes} are not in the mesh's order {self.axis_names}")
        return axes

    def count(self, axes) -> int:
        """The number of ranks along `axes` (a name or a tuple of names)."""
        return math.prod(self.shape[a] for a in self._mesh_order(axes))

    def index(self, axes) -> int:
        """This rank's position along `axes`, row-major in mesh order: the
        shard it holds of a dim split over them (a dim split over ("pod",
        "data") takes pod-major order, as the reference's does)."""
        if self.coords is None:
            raise ValueError(f"rank {self.rank} is not on the mesh")
        idx = 0
        for a in self._mesh_order(axes):
            idx = idx * self.shape[a] + self.coords[a]
        return idx

    def group(self, axes):
        """(process group, its global ranks in row-major order over `axes`,
        which is shard order) of the ranks that differ from this one only
        along `axes`; None when those axes hold one rank."""
        if self.coords is None:
            raise ValueError(f"rank {self.rank} is not on the mesh")
        axes = self._mesh_order(axes)
        return self._groups.get(axes) if self.count(axes) > 1 else None

    def __repr__(self) -> str:
        return (f"ProcessMesh({self.shape}, rank={self.rank}, coords={self.coords}, "
                f"device={self.device}, backend={self.backend})")


def local_devices(device_type: str | None = None) -> list:
    """The devices this process can place work on: `cuda:0 ..` on a
    machine with cards, the CPU otherwise (`device_type` picks one kind)."""
    kind = device_type or ("cuda" if torch.cuda.is_available() else "cpu")
    if kind == "cuda":
        return [torch.device("cuda", i) for i in range(torch.cuda.device_count())]
    return [torch.device(kind)]


def data_mesh(n_devices: Optional[int] = None, *, devices=None) -> Mesh:
    """1-D mesh over the first `n_devices` of `devices` on the "data" axis
    (None = all of them) — the serving engine's data-parallel layout.
    `devices` defaults to `local_devices()`; a list that names one device
    several times gives that device several slots. A 1-slot mesh is valid
    and degenerates to replication everywhere."""
    devs = local_devices() if devices is None else list(devices)
    n = len(devs) if n_devices is None else int(n_devices)
    if not 1 <= n <= len(devs):
        raise ValueError(
            f"data_mesh({n_devices}): this host exposes {len(devs)} device(s)")
    return Mesh(devs[:n], ("data",))


def is_axes_leaf(x) -> bool:
    """A logical-axes annotation: tuple of axis names / None (incl. empty)."""
    return isinstance(x, tuple) and all(isinstance(e, (str, type(None))) for e in x) and (
        not hasattr(x, "_fields") or len(x) == 0)


def axes_leaves(tree) -> list:
    """The annotations of a tree of dicts (sorted keys), lists and tuples,
    in the order `jax.tree_util.tree_leaves(tree, is_leaf=is_axes_leaf)`
    gives them; None holds no leaf."""
    if is_axes_leaf(tree):
        return [tree]
    if tree is None:
        return []
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in axes_leaves(tree[k])]
    if isinstance(tree, (list, tuple)):
        return [x for t in tree for x in axes_leaves(t)]
    return [tree]


class _Ctx:
    mesh: Optional[Mesh] = None
    rules: dict = DEFAULT_RULES


_CTX = _Ctx()


@contextmanager
def axis_rules(mesh: Mesh, rules: dict | None = None, fsdp: bool = True):
    prev = (_CTX.mesh, _CTX.rules)
    r = dict(rules or DEFAULT_RULES)
    if not fsdp:
        r["embed"] = []
    _CTX.mesh, _CTX.rules = mesh, r
    try:
        yield
    finally:
        _CTX.mesh, _CTX.rules = prev


def current_mesh() -> Optional[Mesh]:
    return _CTX.mesh


def logical_spec(shape: Sequence[int], names: Sequence[Optional[str]],
                 mesh=None, rules: dict | None = None) -> tuple:
    """Resolve logical names to a partition spec with conflict and
    divisibility pruning: a tuple with, per dim, a mesh axis name, a tuple
    of several, or None (replicated) — what JAX's `PartitionSpec` holds.
    `mesh` needs only `axis_names` and `shape`."""
    mesh = mesh or _CTX.mesh
    rules = rules or _CTX.rules
    if mesh is None:
        return ()
    if len(shape) != len(names):
        raise ValueError(f"{len(shape)} dims {tuple(shape)} but {len(names)} names "
                         f"{tuple(names)}")
    mesh_axes = set(mesh.axis_names)
    used: set[str] = set()
    out = []
    for size, name in zip(shape, names):
        assigned: tuple[str, ...] | None = None
        for cand in rules.get(name or "none", []):
            axes = tuple(a for a in cand if a in mesh_axes)
            if not axes or any(a in used for a in axes):
                continue
            k = math.prod(mesh.shape[a] for a in axes)
            if k > 1 and size % k == 0:
                assigned = axes
                used.update(axes)
                break
        out.append(assigned if assigned is None or len(assigned) > 1 else assigned[0])
    return tuple(out)


def sharding_for(shape, names, mesh=None) -> Optional[tuple]:
    """The spec `logical_spec` resolves for (shape, names) on `mesh` (the
    mesh in context by default); None outside a mesh."""
    mesh = mesh or _CTX.mesh
    if mesh is None:
        return None
    return logical_spec(shape, names, mesh)


def shard(x: torch.Tensor, *names: Optional[str]) -> torch.Tensor:
    """The reference's sharding constraint by logical names: `x` itself (a
    constraint changes no value). Under a mesh the names must cover every
    dim, as `logical_spec` demands."""
    if _CTX.mesh is not None and len(names) != x.ndim:
        raise ValueError(f"{x.ndim} dims {tuple(x.shape)} but {len(names)} names {names}")
    return x
