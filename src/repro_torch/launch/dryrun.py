"""The dry run: one rank's counted program per (arch, shape, mesh) cell on a
fake world of the production size (counterpart of `repro.launch.dryrun`).

The reference lowers and compiles one device's program per cell on 512 fake
host devices and reads FLOPs, bytes, collectives and memory off the
compiled HLO. The port has no HLO. Its program is the stream of ops one
rank dispatches, so a cell here:

1. starts a fake default process group of 256 ranks (16x16, ("data",
   "model")) or 512 (2x16x16, ("pod", "data", "model")) in this one process
   (`fake_world`: `torch.distributed`'s "fake" backend, whose collectives
   return at once and move nothing), and builds the production mesh over it
   (`launch.mesh.make_production_mesh`);
2. builds the cell's step and this rank's arguments as fake tensors
   (`FakeTensorMode`, on the CPU, so every kernel wrapper takes its plain
   PyTorch version and no memory or random number is drawn): the state's or
   the caches' shard shapes from the port's spec trees
   (`parallel.sharding.params_sharding` / `opt_sharding` /
   `cache_sharding`), never whole parameters;
3. runs the step once under `launch.hlo_cost`'s counter and writes the
   record to `experiments/dryrun_torch/{arch}__{shape}__{mesh}.json`.

The steps:
- train: the port's `ShardedTrainStep` (params gathered whole, this rank's
  rows of each microbatch, gradients reduce-scattered onto the shards,
  AdamW on the shards);
- prefill / decode: `ShardedServeStep`, the counterpart of what GSPMD
  builds for the reference: each parameter gathered over its spec's axes,
  each cache leaf gathered over every split dim but its batch dim, this
  rank's rows of the batch and of the caches through `make_prefill_step` /
  `make_serve_step`, the new cache rows written back into this rank's
  shards. A decode step writes at position seq_len - 1 and attends over the
  whole cache.
Ranks along "model" compute the same rows with gathered weights (ROADMAP
queue 1 [28]); the counts show it (`useful_flop_ratio`). Archs with routed
experts are skipped on a mesh whose data axes hold more than one rank, for
every shape: the capacity and the aux loss are statistics of the whole
batch ([29]).

Collectives: the fake group takes the path NCCL would (`parallel.
collectives._native` is true for CPU tensors): gathers as
`all_gather_into_tensor`, gradient sums as `reduce_scatter_tensor`.

The record keeps the reference's field names where they mean the same:
`status`, `reason`, `n_chips`, `grad_accum`, `moment_dtype`,
`hlo_flops_per_device`, `hlo_bytes_per_device`, `collectives`,
`memory_analysis` (`argument_size_in_bytes`: this rank's arguments;
`output_size_in_bytes`: its results, in-place results included;
`temp_size_in_bytes`: the most bytes the step's own allocations held at
once), `model_flops_global`, the roofline terms, `dominant_term`,
`useful_flop_ratio` and `pallas_flash` (`attention_bytes_jnp`: the bytes
counted inside `scope("flash_attention")`, the plain attention;
`attention_bytes_kernel`: `analytic_flash_bytes` over the ranks that
compute distinct rows, where the reference divides by every chip because
GSPMD splits the heads too). `trace_s` replaces `lower_s` / `compile_s`;
`argument_bytes` splits the arguments by name. `xla_cost_analysis_raw` and
`generated_code_size_in_bytes` have no counterpart.

Terms (H100 SXM datasheet, `obs.constants`): compute = FLOPs / 989 TFLOP/s
(bf16 dense), memory = bytes / 3.35 TB/s, collective = the sum over link
classes of bytes / that link's rate (NVLink 450 GB/s within an 8-rank node,
50 GB/s between nodes); `collective_term_raw_s` equals it, since native =
raw here.

    PYTHONPATH=src python -m repro_torch.launch.dryrun --arch qwen3-0.6b --shape decode_32k --mesh single
"""
from __future__ import annotations

import argparse
import contextlib
import json
import math
import pathlib
import time
import traceback

import torch
import torch.distributed as dist

from repro_torch.configs.base import SHAPES, RunConfig, get_config, list_archs, shape_applicable
from repro_torch.launch import hlo_cost
from repro_torch.launch.mesh import make_production_mesh
from repro_torch.launch.steps import DTYPES, TrainState, make_prefill_step, make_serve_step
from repro_torch.launch.train import ShardedTrainStep, data_axes, has_routed_experts
from repro_torch.models import model as M
from repro_torch.obs import constants as C
from repro_torch.parallel import sharding as S
from repro_torch.parallel.api import axes_leaves, axis_rules
from repro_torch.tree import state_leaves, state_unflatten

OUT_DIR = pathlib.Path(__file__).resolve().parents[3] / "experiments" / "dryrun_torch"
TOTAL_STEPS = 10_000  # the learning-rate schedule's horizon in a train cell


def run_overrides(cfg, shape) -> RunConfig:
    big = M.count_params_analytic(cfg) > 5e10
    return RunConfig(
        moment_dtype="bfloat16" if big else "float32",
        grad_accum=8 if shape.kind == "train" else 1,
        remat="full" if shape.kind == "train" else "none",
        kv_cache_dtype="int8" if shape.kind == "decode" else "bfloat16",
    )


def analytic_flash_bytes(cfg, shape, run, qc: int = 256, kc: int = 512) -> float:
    """Global HBM bytes of all attention, if computed by the flash kernel
    streaming as the reference's Pallas kernel does: per call, Q and O
    stream once, K/V re-stream once per q-block; backward re-streams per its
    two passes; remat='full' runs forward twice (the reference's function,
    copied)."""
    from repro_torch.models.model import AUDIO_DEC_LAYOUT, AUDIO_ENC_LAYOUT
    from repro_torch.models.transformer import group_layout, n_groups

    b = shape.global_batch
    s = shape.seq_len
    kind = shape.kind
    dt = 2  # bf16
    h = cfg.n_heads

    # int8 KV cache: K/V stream at 1 byte (+ scales) in the decode kernel
    kv_dt = 1 if (kind == "decode" and run.kv_cache_dtype == "int8") else dt

    def call_bytes(sq, sk, kv, g, dk, dv, train, kv_bytes=dt):
        nq = max(1, math.ceil(sq / qc))
        nk = max(1, math.ceil(sk / kc))
        qb = b * sq * kv * g * dk * dt
        ob = b * sq * kv * g * dv * dt
        kb = b * sk * kv * dk * kv_bytes + (b * sk * kv * 4 if kv_bytes == 1 else 0)
        vb = b * sk * kv * dv * kv_bytes + (b * sk * kv * 4 if kv_bytes == 1 else 0)
        fwd = qb + ob + nq * (kb + vb)
        if not train:
            return fwd
        bwd = (nq * (kb + vb) + 2 * qb + ob  # dq pass
               + nk * (qb + ob) + kb + vb)  # dk/dv pass
        n_fwd = 2 if run.remat == "full" else 1
        return n_fwd * fwd + bwd

    def sub_dims(sub):
        if sub.kind == "mla":
            return (1, h, cfg.kv_lora_rank + cfg.rope_head_dim, cfg.kv_lora_rank)
        kv = cfg.n_kv_heads
        return (kv, h // kv, cfg.resolved_head_dim, cfg.resolved_head_dim)

    train = kind == "train"
    sq = 1 if kind == "decode" else s
    total = 0.0
    layouts = []
    if cfg.is_encoder_decoder:
        if kind != "decode":
            layouts.append((AUDIO_ENC_LAYOUT, cfg.n_encoder_layers, s))
        layouts.append((AUDIO_DEC_LAYOUT, cfg.n_layers, s))
    else:
        layouts.append((group_layout(cfg), n_groups(cfg), s))
    for lay, groups, sk_default in layouts:
        for sub in lay:
            if sub.kind not in ("attn", "cross", "mla"):
                continue
            sk = sk_default
            if sub.kind == "cross" and cfg.family == "vlm":
                sk = cfg.n_image_tokens
            kv, g, dk, dv = sub_dims(sub)
            kvb = kv_dt if sub.kind == "attn" else dt  # only GQA caches quantize
            total += groups * call_bytes(sq, sk, kv, g, dk, dv, train, kv_bytes=kvb)
    return total


def model_flops(cfg, shape) -> float:
    na = M.count_params_analytic(cfg, active_only=True)
    tokens = shape.global_batch * (shape.seq_len if shape.kind != "decode" else 1)
    if shape.kind == "train":
        return 6.0 * na * tokens
    return 2.0 * na * tokens


@contextlib.contextmanager
def fake_world(n: int):
    """The default process group as `n` fake ranks, this process being rank
    0, for the block; destroyed on exit. Refuses when a group is already
    up."""
    if dist.is_initialized():
        raise RuntimeError(f"a process group ({dist.get_backend()}, {dist.get_world_size()} "
                           "ranks) is already up; the dry run starts its own fake world")
    # registers the "fake" backend and its store (torch's own test module)
    from torch.testing._internal.distributed.fake_pg import FakeStore

    dist.init_process_group("fake", store=FakeStore(), rank=0, world_size=n)
    try:
        yield
    finally:
        dist.destroy_process_group()


def _shards(shapes, specs, mesh):
    """Fake tensors of this rank's shards: each leaf of `shapes` (meta
    tensors) split as its spec says."""
    out = []
    for meta, spec in S.leaves_with_specs(shapes, specs):
        shp = list(meta.shape)
        for d, entry in enumerate(spec):
            axes = S.spec_axes(entry)
            if axes:
                shp[d] //= mesh.count(axes)
        out.append(torch.zeros(shp, dtype=meta.dtype))
    return state_unflatten(shapes, out)


def _global_batch(specs: dict) -> dict:
    return {k: torch.zeros(tuple(v.shape), dtype=v.dtype) for k, v in specs.items()}


class ShardedServeStep:
    """A prefill or decode step over a `ProcessMesh` (module docstring):
    (params shards, cache shards, the global batch[, pos]) -> (logits or
    next tokens of this rank's rows, the cache shards, updated in place).
    Parameters in bf16; the cache in `run.kv_cache_dtype`."""

    def __init__(self, cfg, run, shape, mesh):
        self.cfg, self.mesh, self.kind = cfg, mesh, shape.kind
        dt = torch.bfloat16
        cache_dt = torch.int8 if run.kv_cache_dtype == "int8" else dt
        b, s = shape.global_batch, shape.seq_len
        with axis_rules(mesh, fsdp=run.fsdp):
            self.pspec, self.pshapes = S.params_sharding(cfg, mesh, dt)
            self.cspec, self.cshapes = S.cache_sharding(cfg, mesh, b, s, cache_dt)
            self.inputs = M.input_specs(cfg, shape, dt)
            self.bspec = S.batch_sharding(self.inputs, mesh)
        names = axes_leaves(M.abstract_cache(cfg, b, s, cache_dt)[1])
        # per cache leaf, its spec with the batch dim left whole: the split
        # this rank gathers before the step and takes its block of after
        self.row_specs = [tuple(None if n == "batch" else e for e, n in zip(spec, nm))
                          for (_, spec), nm in zip(S.leaves_with_specs(self.cshapes,
                                                                       self.cspec), names)]
        self.step = (make_prefill_step(cfg, run) if shape.kind == "prefill"
                     else make_serve_step(cfg, run))
        self.batch_axes = S.spec_axes(self.bspec["tokens"][0])
        self.pos = s - 1

    @torch.no_grad()
    def __call__(self, params, caches, batch):
        mesh = self.mesh
        whole = S.gather_tree(params, self.pspec, mesh)
        local = {k: S.shard_leaf(v, self.bspec[k], mesh) for k, v in batch.items()}
        shards = state_leaves(caches)
        rows = [S.gather_leaf(x, spec, mesh) for x, spec in zip(shards, self.row_specs)]
        rows_tree = state_unflatten(caches, rows)
        if self.kind == "prefill":
            out, _ = self.step(whole, rows_tree, local)
        else:
            out, _ = self.step(whole, rows_tree, local, self.pos)
        for shard, row, spec in zip(shards, rows, self.row_specs):
            if row is not shard:  # the caches are written in place: copy this rank's block back
                shard.copy_(S.shard_leaf(row, spec, mesh))
        return out, caches


def build_cell(cfg, shape, run, mesh):
    """(fn, {name: argument}) of one cell; call it under a FakeTensorMode,
    which makes every argument a fake CPU tensor of this rank's shard."""
    dt = torch.bfloat16
    if shape.kind == "train":
        step = ShardedTrainStep(cfg, run, shape, mesh, TOTAL_STEPS, torch.device("cpu"))
        pshapes = M.abstract_params(cfg, DTYPES[run.param_dtype])[0]
        _, oshapes = S.opt_sharding(cfg, mesh, run, pshapes)
        shapes = TrainState(params=pshapes, opt=oshapes)
        state = _shards(shapes, step.specs, mesh)
        return step, {"state": state, "batch": _global_batch(M.input_specs(cfg, shape, dt))}
    step = ShardedServeStep(cfg, run, shape, mesh)
    return step, {"params": _shards(step.pshapes, step.pspec, mesh),
                  "caches": _shards(step.cshapes, step.cspec, mesh),
                  "batch": _global_batch(step.inputs)}


def _bytes(tree) -> int:
    """The bytes of the distinct storages of a tree's tensors."""
    seen, n = set(), 0
    for t in state_leaves(tree):
        if isinstance(t, torch.Tensor):
            st = t.untyped_storage()
            if st._cdata not in seen:
                seen.add(st._cdata)
                n += st.nbytes()
    return n


def skip_reason(cfg, mesh) -> str | None:
    """Why a cell does not run on `mesh`, or None."""
    dp = mesh.count(data_axes(mesh)) if data_axes(mesh) else 1
    if dp > 1 and has_routed_experts(cfg):
        return (f"{cfg.name} routes tokens to experts over the whole batch; the sharded "
                f"steps run it only on meshes with one data rank, not {mesh.shape} "
                f"(ROADMAP queue 1 [29])")
    return None


def dry_run_cell(cfg, shape, run, mesh) -> dict:
    """The record of one cell (module docstring) on `mesh`, a `ProcessMesh`
    on the CPU over a `fake_world` the caller holds open. Raises on a
    failure."""
    from torch._subclasses.fake_tensor import FakeTensorMode

    reason = skip_reason(cfg, mesh)
    if reason:
        return {"status": "skipped", "reason": reason}
    n = math.prod(mesh.shape.values())
    t0 = time.perf_counter()
    with FakeTensorMode():
        fn, args = build_cell(cfg, shape, run, mesh)
        t1 = time.perf_counter()
        out, la = hlo_cost.run_counted(fn, *args.values(), tags=("flash_attention",))
        t2 = time.perf_counter()
        arg_bytes = {k: _bytes(v) for k, v in args.items()}
        out_bytes = _bytes(out)
    # the ranks that compute distinct rows: those along the batch's axes
    row_groups = mesh.count(fn.batch_axes) if fn.batch_axes else 1
    coll = {
        "bytes_by_kind": la["collective_bytes_by_kind"],
        "counts": la["collective_counts"],
        "total_bytes": la["collective_bytes"],
        "total_bytes_native": la["collective_bytes_native"],
        "native_by_kind": la["collective_native_by_kind"],
    }
    flops, nbytes = float(la["flops"]), float(la["bytes"])
    mf = model_flops(cfg, shape)
    coll_s = sum(b / C.LINK_BW[link] for link, b in la["collective_bytes_by_link"].items())
    rec = dict(
        status="ok",
        build_s=t1 - t0,
        trace_s=t2 - t1,
        n_chips=n,
        grad_accum=run.grad_accum,
        moment_dtype=run.moment_dtype,
        remat=run.remat,
        kv_cache_dtype=run.kv_cache_dtype,
        hlo_flops_per_device=flops,
        hlo_bytes_per_device=nbytes,
        n_ops=la["n_ops"],
        collectives=coll,
        collective_bytes_by_link=la["collective_bytes_by_link"],
        memory_analysis={"argument_size_in_bytes": sum(arg_bytes.values()),
                         "output_size_in_bytes": out_bytes,
                         "temp_size_in_bytes": la["peak_live_bytes"]},
        argument_bytes=arg_bytes,
        model_flops_global=mf,
        compute_term_s=flops / C.BF16_PEAK_FLOPS,
        memory_term_s=nbytes / C.DEFAULT_HBM_BW,
        collective_term_s=coll_s,
        collective_term_raw_s=coll_s,
        row_groups=row_groups,
    )
    terms = {"compute": rec["compute_term_s"], "memory": rec["memory_term_s"],
             "collective": rec["collective_term_s"]}
    rec["dominant_term"] = max(terms, key=terms.get)
    rec["useful_flop_ratio"] = (mf / n) / flops if flops else 0.0
    tagged = float(la["tagged_bytes"].get("flash_attention", 0.0))
    if tagged > 0:
        kern = analytic_flash_bytes(cfg, shape, run) / row_groups
        rec["pallas_flash"] = {
            "attention_bytes_jnp": tagged,
            "attention_bytes_kernel": kern,
            "memory_term_pallas_s": max(nbytes - tagged + kern, 0.0) / C.DEFAULT_HBM_BW,
        }
    return rec


def _mesh_name(multi_pod: bool) -> str:
    return "2x16x16" if multi_pod else "16x16"


def run_cell(arch: str, shape_name: str, multi_pod: bool, force: bool = False,
             out_dir=None) -> dict:
    """The record of (arch, shape, production mesh), from
    `{out_dir}/{arch}__{shape}__{mesh}.json` when it exists and not
    `force`; otherwise run (`dry_run_cell`) and written there. A cell that
    raises records status "error" with its traceback."""
    cfg = get_config(arch)
    shape = SHAPES[shape_name]
    mesh_name = _mesh_name(multi_pod)
    out_dir = pathlib.Path(out_dir or OUT_DIR)
    out_dir.mkdir(parents=True, exist_ok=True)
    out_path = out_dir / f"{arch}__{shape_name}__{mesh_name}.json"
    if out_path.exists() and not force:
        return json.loads(out_path.read_text())
    rec = {"arch": arch, "shape": shape_name, "mesh": mesh_name}
    ok, reason = shape_applicable(cfg, shape)
    if not ok:
        rec.update(status="skipped", reason=reason)
        out_path.write_text(json.dumps(rec, indent=2))
        return rec
    run = run_overrides(cfg, shape)
    try:
        with fake_world(512 if multi_pod else 256):
            mesh = make_production_mesh(multi_pod=multi_pod, device="cpu")
            rec.update(dry_run_cell(cfg, shape, run, mesh))
        if rec["status"] == "ok":
            print(f"[dryrun] {arch} {shape_name} {mesh_name}: trace {rec['trace_s']:.2f}s "
                  f"dominant={rec['dominant_term']} useful_flop_ratio="
                  f"{rec['useful_flop_ratio']:.4f}")
            print(f"  memory_analysis: {rec['memory_analysis']}")
            print(f"  cost: flops={rec['hlo_flops_per_device']:.3e} "
                  f"bytes={rec['hlo_bytes_per_device']:.3e} collective_bytes="
                  f"{rec['collectives']['total_bytes']:.3e}")
        else:
            print(f"[dryrun] {arch} {shape_name} {mesh_name}: skipped ({rec['reason']})")
    except Exception as e:  # a failing cell is a fault: recorded, and main exits nonzero
        rec.update(status="error", error=f"{type(e).__name__}: {e}",
                   traceback=traceback.format_exc()[-4000:])
        print(f"[dryrun] {arch} {shape_name} {mesh_name}: FAILED {type(e).__name__}: {e}")
    out_path.write_text(json.dumps(rec, indent=2))
    return rec


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__,
                                 formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--arch", default="all")
    ap.add_argument("--shape", default="all")
    ap.add_argument("--mesh", default="both", choices=["single", "multi", "both"])
    ap.add_argument("--force", action="store_true")
    ap.add_argument("--out-dir", default=None,
                    help=f"where the records go (default {OUT_DIR})")
    args = ap.parse_args(argv)
    archs = ([a for a in list_archs() if a != "vgg19-sparse"] if args.arch == "all"
             else [args.arch])
    shapes = list(SHAPES) if args.shape == "all" else [args.shape]
    meshes = {"single": [False], "multi": [True], "both": [False, True]}[args.mesh]
    n_bad = 0
    for arch in archs:
        for shape in shapes:
            for mp in meshes:
                rec = run_cell(arch, shape, mp, force=args.force, out_dir=args.out_dir)
                n_bad += rec.get("status") == "error"
    if n_bad:
        raise SystemExit(f"{n_bad} cells failed")


if __name__ == "__main__":
    main()
