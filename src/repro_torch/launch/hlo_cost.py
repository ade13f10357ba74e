"""The cost of one rank's program, counted from the ops it dispatches
(counterpart of `repro.launch.hlo_cost`).

The reference re-derives FLOPs, HBM bytes and collective bytes from the
optimized HLO text of a compiled program. The port has no HLO: it runs
eagerly, so its program is the stream of ATen and c10d ops one rank
dispatches. `analyze(fn, *args)` runs `fn` once under a counting
`TorchDispatchMode` and sums:

- FLOPs: `torch.utils.flop_counter`'s formulas for the matmuls and
  convolutions (mm, addmm, bmm, baddbmm, convolution and their backward
  ops); one per output element for every other op that is not a view,
  metadata or allocation op (the reference's "elementwise-ish" rule);
- HBM bytes, by the reference's three rules. Eager mode fuses nothing, so
  every op materializes its result. Operands + result for most ops
  (`_OPERANDS_PLUS_RESULT`); the result twice for copies and conversions
  (`clone`, `_to_copy`, `copy_`, pad, flip: `_RESULT_X2`), and for gathers
  (`index`, `gather`, `index_select`, `embedding`) the result twice plus the
  indices, as the reference charges a fused gather's table at the gathered
  size; the result only for fills, constants, ranges and random draws
  (`_RESULT_ONLY`);
- collectives: each c10d op's result bytes under the reference's kind names
  (all-reduce, all-gather, reduce-scatter, all-to-all; a send is one
  collective-permute, counted once per pair as the reference counts at
  `-start`), their counts, and their bytes by the link their group crosses
  (`obs.constants.link_of`, which the dry run's collective term reads);
- `tagged_bytes`: the bytes dispatched while an `obs.scopes.scope` whose
  name contains one of `tags` is open (the counterpart of the reference's
  `jax.named_scope` metadata);
- `peak_live_bytes`: the most bytes held at once by the storages that ops
  inside `fn` allocated, each released when its storage dies (the dry
  run's `temp_size_in_bytes`).

Run on fake tensors (`torch._subclasses.FakeTensorMode`) it counts a
program too large for the host, and under a fake process group a rank of a
large world (`launch.dryrun`); on real tensors it counts what runs.

Kept different on purpose:
- loops: eager mode unrolls every Python loop, so each iteration is counted
  as it runs. The reference's trip-count logic (`while`, `conditional`)
  has no counterpart;
- native = raw collective bytes: the port moves bf16 as bf16, with none of
  the CPU backend's f32 promotion the reference corrects for;
- convolutions: FLOPs from the convolution's own shapes, as XLA's
  `cost_analysis` counts them. The reference divides the kernel's elements
  by its dim 0, which XLA's CPU layout makes a spatial dim (ROADMAP,
  properties of the reference).

`analyze` raises when a hand-written kernel launches inside it: a `ctypes`
launch dispatches no op, so its cost would be silently missing.
"""
from __future__ import annotations

import weakref

import torch
import torch.distributed as dist
import torch.utils._pytree as pytree
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils.flop_counter import flop_registry

from repro_torch.obs.constants import link_of
from repro_torch.obs.scopes import counting, open_scopes

# ops that move no bytes and do no arithmetic: allocation, metadata, and
# reshapes that alias their input
_FREE = {
    "aten::empty", "aten::empty_like", "aten::empty_strided", "aten::new_empty",
    "aten::new_empty_strided", "aten::_unsafe_view", "aten::detach", "aten::alias",
    "aten::lift_fresh", "aten::_local_scalar_dense", "aten::sym_size", "aten::sym_stride",
    "aten::sym_numel", "aten::sym_storage_offset", "aten::is_same_size", "aten::resize_",
    "aten::set_",
}
# the reference's `_RESULT_X2` (copy, convert, pad, reverse) and, with the
# indices added, its fused gather
_COPIES = {"aten::clone", "aten::_to_copy", "aten::copy_", "aten::copy",
           "aten::constant_pad_nd", "aten::flip"}
_GATHERS = {"aten::index", "aten::gather", "aten::index_select", "aten::embedding"}
# the reference's `_RESULT_ONLY` (broadcast, iota, rng-bit-generator)
_RESULT_ONLY = {
    "aten::fill_", "aten::zero_", "aten::full", "aten::full_like", "aten::zeros",
    "aten::zeros_like", "aten::ones", "aten::ones_like", "aten::new_zeros", "aten::new_ones",
    "aten::new_full", "aten::scalar_tensor", "aten::arange", "aten::linspace", "aten::rand",
    "aten::randn", "aten::randint", "aten::normal_", "aten::uniform_", "aten::random_",
}
# c10d op name (leading and trailing "_" stripped) -> the reference's kind
_KINDS = (("allreduce", "all-reduce"), ("allgather", "all-gather"),
          ("reduce_scatter", "reduce-scatter"), ("alltoall", "all-to-all"),
          ("send", "collective-permute"))


def _tensors(tree) -> list:
    return [t for t in pytree.tree_leaves(tree) if isinstance(t, torch.Tensor)]


def _nbytes(t: torch.Tensor) -> int:
    return t.numel() * t.element_size()


def _storage_key(t: torch.Tensor):
    try:
        return t.untyped_storage()._cdata
    except (RuntimeError, NotImplementedError):  # a tensor with no storage
        return None


def _kind(func) -> str | None:
    name = func._schema.name.split("::", 1)[1].strip("_")
    for stem, kind in _KINDS:
        if name.startswith(stem):
            return kind
    return None


def _group_ranks(args) -> list:
    """The global ranks of the process group a c10d op runs on (the default
    group's when it names none)."""
    pg_cls = torch._C._distributed_c10d.ProcessGroup
    for a in args:
        if isinstance(a, torch.ScriptObject) and "ProcessGroup" in str(a._type()):
            return dist.get_process_group_ranks(pg_cls.unbox(a))
    return list(range(dist.get_world_size()))


def _launch_counts() -> dict:
    """Every launch counter of the port's hand-written kernels: each
    wrapper's `.launches` and the per-entry-point counts."""
    from repro_torch.kernels import cuda as kcuda
    from repro_torch.kernels.bsr_matmul.kernel import bsr_matmul
    from repro_torch.kernels.conv_pool.kernel import conv_pool_batch
    from repro_torch.kernels.ecr_conv.kernel import ecr_conv_batch
    from repro_torch.kernels.flash_attention import kernel as fa
    from repro_torch.kernels.selective_scan import kernel as ss
    from repro_torch.quant.kernels import bsr_matmul_int8, ecr_conv_int8_batch

    wrappers = (ecr_conv_batch, conv_pool_batch, bsr_matmul, ecr_conv_int8_batch,
                bsr_matmul_int8, fa.flash_fwd, fa.flash_fwd_q8, fa.flash_fwd_mla,
                fa.flash_bwd_mla, fa.flash_bwd_dq, fa.flash_bwd_dkv, fa.flash_bwd,
                ss.selective_scan, ss.selective_scan_bwd)
    counts = {w.__name__: w.launches for w in wrappers}
    for table in (kcuda.FLASH_ENTRY_LAUNCHES, kcuda.MLA_ENTRY_LAUNCHES,
                  kcuda.SCAN_ENTRY_LAUNCHES):
        counts.update(table)
    return counts


class _Counter(TorchDispatchMode):
    """The counting mode: see the module docstring for what it sums."""

    def __init__(self, tags, external):
        super().__init__()
        self.tags = tuple(tags)
        self.external = external  # storages of fn's arguments: never allocated here
        self.flops = 0
        self.bytes = 0
        self.n_ops = 0
        self.coll, self.coll_counts, self.by_link, self.tagged = {}, {}, {}, {}
        self.live = self.peak = 0
        self.held = set()

    def _free(self, key, n):
        self.held.discard(key)
        self.live -= n

    def _track(self, outs):
        for t in outs:
            key = _storage_key(t)
            if key is None or key in self.held or key in self.external:
                continue
            st = t.untyped_storage()
            n = st.nbytes()
            self.held.add(key)
            self.live += n
            self.peak = max(self.peak, self.live)
            weakref.finalize(st, self._free, key, n)

    def _add(self, table, key, n):
        table[key] = table.get(key, 0) + n

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        out = func(*args, **kwargs)
        name = func._schema.name
        if func.is_view or name in _FREE or func.namespace == "prim":
            if not func.is_view:
                self._track(_tensors(out))
            return out
        ins = _tensors((args, kwargs))
        outs = _tensors(out)
        kind = _kind(func) if func.namespace == "c10d" else None
        if func.namespace == "c10d":
            if kind is None:  # recv (counted at its send), barrier, ...
                return out
            # in-place collectives return their buffers; a send or an
            # all-to-all returns only its work handle
            outs = outs or _tensors(args[0])
            nb = sum(_nbytes(t) for t in outs)
            ranks = _group_ranks(args)
            if kind == "collective-permute":
                ranks = [dist.get_rank(), ranks[args[2]]]
            self._add(self.coll, kind, nb)
            self._add(self.coll_counts, kind, 1)
            self._add(self.by_link, link_of(ranks), nb)
        else:
            self._track(outs)
        self.n_ops += 1
        packet = func._overloadpacket
        if packet in flop_registry:
            self.flops += int(flop_registry[packet](*args, **kwargs, out_val=out))
        else:
            self.flops += sum(t.numel() for t in outs)
        out_nb = sum(_nbytes(t) for t in outs)
        if name in _COPIES:
            nb = 2 * out_nb
        elif name in _GATHERS:  # the table at the gathered rows, and the indices
            nb = 2 * out_nb + sum(_nbytes(t) for t in ins[1:])
        elif name in _RESULT_ONLY:
            nb = out_nb
        else:
            nb = sum(_nbytes(t) for t in ins) + out_nb
        self.bytes += nb
        if self.tags:
            open_ = open_scopes()
            for tag in self.tags:
                if any(tag in s for s in open_):
                    self._add(self.tagged, tag, nb)
        return out

    def result(self) -> dict:
        total = sum(self.coll.values())
        return {
            "flops": self.flops,
            "bytes": self.bytes,
            "collective_bytes_by_kind": dict(self.coll),
            "collective_counts": dict(self.coll_counts),
            "collective_bytes": total,
            "collective_bytes_native": total,
            "collective_native_by_kind": dict(self.coll),
            "collective_bytes_by_link": dict(self.by_link),
            "tagged_bytes": dict(self.tagged),
            "peak_live_bytes": self.peak,
            "n_ops": self.n_ops,
        }


def run_counted(fn, *args, tags: tuple = (), **kwargs):
    """(fn(*args, **kwargs), its counts): `analyze`'s dict for the one call
    that produced the result."""
    external = {_storage_key(t) for t in _tensors((args, kwargs))}
    before = _launch_counts()
    counter = _Counter(tags, external)
    with counting(), counter:
        out = fn(*args, **kwargs)
    moved = {k: v - before[k] for k, v in _launch_counts().items() if v != before[k]}
    if moved:
        raise RuntimeError(f"hand-written kernels launched inside analyze: {moved}; a "
                           "ctypes launch dispatches no op, so the count would miss its cost "
                           "(run the function on CPU or fake tensors)")
    return out, counter.result()


def analyze(fn, *args, tags: tuple = (), **kwargs) -> dict:
    """The counts of one call `fn(*args, **kwargs)` (module docstring):
    `flops`, `bytes`, `collective_bytes_by_kind`, `collective_counts`,
    `collective_bytes`, `collective_bytes_native`,
    `collective_native_by_kind`, `tagged_bytes` (the reference's keys),
    `collective_bytes_by_link`, `peak_live_bytes` and `n_ops`. `tags`:
    substrings of `obs.scopes.scope` names whose bytes are reported apart."""
    return run_counted(fn, *args, tags=tags, **kwargs)[1]
