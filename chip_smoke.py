#!/usr/bin/env python3
"""Run the PyTorch/CUDA port (src/repro_torch) end to end on one NVIDIA GPU.

    python3 chip_smoke.py [--layers-out PATH]

1. Refuses at once without CUDA, or when it does not sit in a checkout of the
   repository (it needs src/repro_torch). Prints the card's name and power
   limit as nvidia-smi reports them.
2. Builds the CUDA kernels from the checkout's sources with nvcc and times
   the build.
3. Serves the published VGG-19 (3x224x224, 1000 classes, random weights from
   a fixed generator seed with the dead-filter shift) through the port's
   Engine (block_c=8, occ_threshold=0.75, max_batch=8, SimClock): 16 requests
   through replay_stream. The kernels' launch counters are set to 0 just
   before and read just after; the plan must hold ECR and PECR layers and
   both counters must have grown. Engine logits are held against the dense
   path on cuDNN (TF32 off) at rtol=1e-3 plus atol=1e-3*max|dense| — sixteen
   fp32 conv layers summed in another order. Then LeNet-5 and AlexNet serve
   8 requests each with the same check.
4. Holds each kernel against its plain PyTorch version on the same packed
   operands, at the real input of every sparse layer of the served VGG-19
   plan (batch 8, and the single-image branch at N=1), and at edge cases
   (a cnt=0 sample, stride 4 with k 11, k 5 with pad 0, odd spatial sizes,
   C % block_c != 0): max|kernel - plain| <= 1e-4*max|plain| + 1e-5. The
   ops are also held against cuDNN. Times kernel, plain version and the
   library call (F.conv2d, + relu + max_pool2d for PECR) with CUDA events
   after warm-up, in turns, and computes each call's bound from its data.
5. Prints the kernel table as one JSON line, the card line, and last
   {"ok": true, "device": {...}}. Any failure exits non-zero without it.
   In the table, ms / plain_ms / library_ms / bound_ms are sums over the
   served plan's layers that run the kernel (one batch-8 VGG-19 forward);
   launches count the serving run only. `--layers-out PATH` also writes the
   per-layer numbers there as JSON.
"""
from __future__ import annotations

import argparse
import json
import subprocess
import sys
import time
import traceback
from pathlib import Path

ROOT = Path(__file__).resolve().parent
PEAK_FP32_FLOPS = 67e12  # H100 SXM, fp32 outside the tensor cores
PEAK_HBM_BYTES = 3.35e12  # H100 SXM HBM3
KERNEL_TOL = "max|kernel - plain| <= 1e-4*max|plain| + 1e-5"


def fail(msg: str) -> int:
    print(f"chip_smoke: {msg}", file=sys.stderr)
    return 1


def card_line() -> str:
    r = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                        "--format=csv,noheader"], capture_output=True, text=True,
                       timeout=60)
    if r.returncode != 0:
        raise RuntimeError(f"nvidia-smi failed: {r.stderr.strip()}")
    return r.stdout.strip().splitlines()[0]


def time_turns(fns: dict, rounds: int = 5, iters: int = 10) -> dict:
    """Median ms per call of each function, timed with CUDA events after a
    warm-up, the functions taking turns round by round."""
    import torch

    for fn in fns.values():
        fn()
    torch.cuda.synchronize()
    samples = {k: [] for k in fns}
    for _ in range(rounds):
        for k, fn in fns.items():
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            for _ in range(iters):
                fn()
            end.record()
            torch.cuda.synchronize()
            samples[k].append(start.elapsed_time(end) / iters)
    return {k: sorted(v)[len(v) // 2] for k, v in samples.items()}


def work_bound(x, w, ids, cnt, *, stride, block_c, out_elems):
    """(flop time, byte time) in ms for what these inputs need: the live
    blocks' multiply-adds, each scheduled input block read once, the weights
    of the union of scheduled blocks read once, the schedules, the output
    written once."""
    n, h, wd, c = x.shape
    kh, kw, _, o = w.shape
    oh, ow = (h - kh) // stride + 1, (wd - kw) // stride + 1
    counts = cnt.clamp(0, c // block_c).tolist()
    ids_h = ids.tolist()
    live = sum(counts)
    union = {j for b in range(n) for j in ids_h[b][:counts[b]]}
    flops = 2.0 * oh * ow * o * kh * kw * block_c * live
    nbytes = 4.0 * (live * block_c * h * wd + len(union) * block_c * kh * kw * o
                    + ids.numel() + cnt.numel() + out_elems)
    return flops / PEAK_FP32_FLOPS * 1e3, nbytes / PEAK_HBM_BYTES * 1e3


class KernelBook:
    """Accumulates each kernel's comparisons and timings for the JSON line."""

    def __init__(self):
        self.rows = []
        self.max_err = {"ecr_conv": 0.0, "conv_pool": 0.0}

    def check(self, kernel, label, got, want):
        err = float((got - want).abs().max())
        lim = 1e-4 * float(want.abs().max()) + 1e-5
        self.max_err[kernel] = max(self.max_err[kernel], err)
        print(f"  {kernel:9s} {label:44s} max_abs_err={err:.3e} (limit {lim:.3e})")
        if not err <= lim:
            raise AssertionError(f"{kernel} {label}: {err} > {lim} ({KERNEL_TOL})")


def check_layer_kernels(book, unit, kind, xp, w, pool, timed: bool):
    """Kernel vs plain (batched and N=1) on one sparse layer's real input,
    the op vs cuDNN, and, when `timed`, kernel/plain/library timings."""
    import torch
    import torch.nn.functional as F

    from repro_torch.graph.registry import unit_launch
    from repro_torch.kernels.conv_pool.kernel import conv_pool_batch, conv_pool_plain
    from repro_torch.kernels.conv_pool.ops import fused_conv_pool
    from repro_torch.kernels.ecr_conv.kernel import ecr_conv_batch, ecr_conv_plain
    from repro_torch.kernels.ecr_conv.ops import ecr_conv, pack_operands, pack_operands_single

    impl = "pecr_pallas" if pool else "ecr_pallas"
    name = "conv_pool" if pool else "ecr_conv"
    stride = unit.conv.stride
    launch = unit_launch(kind, impl, unit, block_c=8, batch=xp.shape[0])
    bc = launch.block_c

    def kernel(args):
        if pool:
            return conv_pool_batch(*args, stride=stride, pool=pool, block_c=bc)
        return ecr_conv_batch(*args, stride=stride, block_c=bc)

    def plain(args):
        if pool:
            return conv_pool_plain(*args, stride=stride, pool=pool, block_c=bc)
        return ecr_conv_plain(*args, stride=stride, block_c=bc)

    def library():
        y = F.conv2d(xp, w, stride=stride)
        return F.max_pool2d(torch.relu(y), pool, pool) if pool else y

    label = f"conv{unit.index + 1} x{tuple(xp.shape)} w{tuple(w.shape)}"
    packed = pack_operands(xp, w, launch)
    got = kernel(packed)
    torch.cuda.synchronize()
    book.check(name, label + f" N={xp.shape[0]}", got, plain(packed))
    single = pack_operands_single(xp[0], w, launch)
    book.check(name, label + " N=1", kernel(single), plain(single))
    op = fused_conv_pool(xp, w, stride, pool, block_c=8) if pool else \
        ecr_conv(xp, w, stride, block_c=8)
    book.check(name, label + " op vs cuDNN", op, library())
    if not timed:
        return
    x1 = xp[:1]

    def library_n1():
        y = F.conv2d(x1, w, stride=stride)
        return F.max_pool2d(torch.relu(y), pool, pool) if pool else y

    t = time_turns({"kernel": lambda: kernel(packed), "plain": lambda: plain(packed),
                    "library": library, "kernel_n1": lambda: kernel(single),
                    "plain_n1": lambda: plain(single), "library_n1": library_n1})
    ft, bt = work_bound(*packed, stride=stride, block_c=bc, out_elems=got.numel())
    ft1, bt1 = work_bound(*single, stride=stride, block_c=bc,
                          out_elems=got.numel() // got.shape[0])
    row = {"kernel": name, "layer": f"conv{unit.index + 1}",
           "x_nchw": list(xp.shape), "w_oihw": list(w.shape), "block_c": bc,
           "cnt": packed[3].tolist(), "n_cb": launch.n_cb,
           "ms": t["kernel"], "plain_ms": t["plain"], "library_ms": t["library"],
           "flop_ms": ft, "byte_ms": bt, "bound_ms": max(ft, bt),
           "bound_by": "operations" if ft >= bt else "bytes",
           "n1_cnt": int(single[3][0]), "ms_n1": t["kernel_n1"],
           "plain_ms_n1": t["plain_n1"], "library_ms_n1": t["library_n1"],
           "flop_ms_n1": ft1, "byte_ms_n1": bt1, "bound_ms_n1": max(ft1, bt1),
           "bound_by_n1": "operations" if ft1 >= bt1 else "bytes"}
    book.rows.append(row)
    print(f"    N={xp.shape[0]}: ms={t['kernel']:.4f} plain_ms={t['plain']:.4f} "
          f"library_ms={t['library']:.4f} bound_ms={max(ft, bt):.4f} "
          f"({row['bound_by']}); N=1: ms={t['kernel_n1']:.4f} "
          f"plain_ms={t['plain_n1']:.4f} library_ms={t['library_n1']:.4f} "
          f"bound_ms={max(ft1, bt1):.4f} ({row['bound_by_n1']})")


def edge_cases(book, dev):
    """Synthetic shapes the served VGG-19 does not reach."""
    import numpy as np
    import torch

    from repro_torch.graph.ir import ConvSpec, ConvUnit, PoolSpec

    cases = [  # (c, h, o, k, stride, pad, pool)
        (3, 224, 64, 11, 4, 2, 0),   # AlexNet conv1: stride 4, k 11, C % 8 != 0
        (64, 27, 192, 5, 1, 2, 0),   # AlexNet conv2: k 5
        (6, 14, 16, 5, 1, 0, 2),     # LeNet conv2: k 5, pad 0, fused pool
        (20, 27, 70, 3, 1, 1, 2),    # odd map, O % 64 != 0, C % 8 != 0, floor pool
        (20, 15, 70, 3, 2, 1, 0),    # odd map at stride 2
    ]
    rng = np.random.default_rng(7)
    for i, (c, h, o, k, s, pad, pool) in enumerate(cases):
        x = rng.random((3, c, h, h), dtype=np.float32)
        x *= rng.random((3, c, 1, 1)) > 0.4
        x[-1] = 0.0  # the batcher's all-zero pad sample: cnt = 0
        w = rng.standard_normal((o, c, k, k)).astype(np.float32) / (c * k * k) ** 0.5
        spec = ConvSpec(o, k=k, stride=s, pad=pad)
        oh = (h + 2 * pad - k) // s + 1
        unit = ConvUnit(index=100 + i, stage=0, slot=0, conv=spec, relu=True,
                        pool=PoolSpec(pool) if pool else None, in_shape=(c, h, h),
                        out_shape=(o, oh // max(pool, 1), oh // max(pool, 1)))
        xp = torch.nn.functional.pad(torch.from_numpy(x).to(dev), (pad,) * 4)
        check_layer_kernels(book, unit, "conv_pool" if pool else "conv", xp,
                            torch.from_numpy(w).to(dev), pool, timed=False)


def kernel_category(name: str) -> str:
    """Coarse class of a CUDA kernel by its symbol name."""
    if "ecr_conv_kernel" in name:
        return "pecr kernel" if "ILb1E" in name or "<true>" in name else "ecr kernel"
    low = name.lower()
    if any(t in low for t in ("cudnn", "xmma", "conv", "gemm", "cutlass")):
        return "cuDNN/cuBLAS (dense convs, head)"
    if "sort" in low or "radix" in low:
        return "argsort (compaction)"
    return "other (pad/permute/gather/relu/pool/occupancy)"


def service_breakdown(plan, params, imgs) -> dict:
    """One warm batch through the engine's runner: host wall time (median of
    5, synchronised) and a torch.profiler trace of one more run, summed by
    kernel class. The device idle share is 1 - device time / wall time."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.pipeline import run_plan

    n = imgs.shape[0]

    def service():
        return run_plan(plan, params, imgs, collect_occupancy=True, n_valid=n)

    for _ in range(2):
        service()
    torch.cuda.synchronize()
    walls = []
    for _ in range(5):
        t0 = time.perf_counter()
        service()
        torch.cuda.synchronize()
        walls.append((time.perf_counter() - t0) * 1e3)
    wall_ms = sorted(walls)[2]
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        service()
        torch.cuda.synchronize()
    kernels = {}
    for e in prof.key_averages():
        if e.device_type != torch.autograd.DeviceType.CUDA:
            continue
        us = getattr(e, "self_device_time_total", 0.0)
        kernels[e.key] = (kernels.get(e.key, (0.0, 0))[0] + us, e.count)
    cats = {}
    for name, (us, _) in kernels.items():
        cats[kernel_category(name)] = cats.get(kernel_category(name), 0.0) + us / 1e3
    device_ms = sum(cats.values())
    top = sorted(kernels.items(), key=lambda kv: -kv[1][0])[:10]
    return {"batch": n, "wall_ms": wall_ms, "walls_ms": walls,
            "device_ms": device_ms,
            "idle_share": max(0.0, 1.0 - device_ms / wall_ms) if device_ms else None,
            "by_class_ms": cats,
            "top_kernels": [{"name": k[:120], "ms": v[0] / 1e3, "count": v[1]}
                            for k, v in top]}


def serve(graph, n_requests, *, seed, dev):
    """An Engine over `graph` (random weights from generator `seed`, dead
    filters shifted, planned on 2 calibration images) and its request
    images. Returns (engine, params, imgs, planning seconds, clock)."""
    import torch

    from repro_torch.graph import init_graph
    from repro_torch.launch.serve_cnn import synth_requests
    from repro_torch.models.cnn import shift_dead_channels
    from repro_torch.serving import Engine, SimClock

    params = shift_dead_channels(init_graph(torch.Generator().manual_seed(seed),
                                            graph, device=dev))
    calib = torch.stack(synth_requests(graph, 2, seed=seed + 1, device=dev))
    clock = SimClock()
    t0 = time.perf_counter()
    eng = Engine(params, graph=graph, calib=calib, occ_threshold=0.75,
                 block_c=8, max_batch=8, clock=clock, device=dev)
    plan_s = time.perf_counter() - t0
    eng.warmup()
    imgs = synth_requests(graph, n_requests, seed=seed + 2, device=dev)
    return eng, params, imgs, plan_s, clock


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__,
                                 formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--layers-out", type=Path, default=None, metavar="PATH",
                    help="write the per-layer kernel numbers to PATH as JSON")
    args = ap.parse_args()
    import torch

    if not torch.cuda.is_available():
        return fail("CUDA is not available; this script runs the port on an NVIDIA GPU")
    if not (ROOT / "src" / "repro_torch" / "kernels" / "csrc").is_dir():
        return fail(f"{ROOT} is not a checkout of the repository (no src/repro_torch)")
    sys.path.insert(0, str(ROOT / "src"))
    import numpy as np

    from repro_torch.configs.alexnet import ALEXNET
    from repro_torch.configs.lenet import LENET
    from repro_torch.configs.vgg19_sparse import CNNConfig, vgg19_graph
    from repro_torch.device import resolve_device
    from repro_torch.graph import pad2d, run_graph, run_unit
    from repro_torch.kernels import cuda as kcuda
    from repro_torch.kernels.conv_pool.kernel import conv_pool_batch
    from repro_torch.kernels.ecr_conv.kernel import ecr_conv_batch
    from repro_torch.pipeline import run_plan
    from repro_torch.serving import replay_stream

    dev = resolve_device("cuda")  # also turns TF32 off for cuDNN and cuBLAS
    card = card_line()
    kind = torch.cuda.get_device_name(0)
    print(f"card: {card}; torch {torch.__version__} cuda {torch.version.cuda}")

    t0 = time.perf_counter()
    lib_path = kcuda.build(verbose=True)
    kcuda.library()
    print(f"build: {lib_path.name} in {time.perf_counter() - t0:.2f} s")

    book = KernelBook()
    failures = []

    # ---- the main path: published VGG-19 through the Engine ----------------
    graph = vgg19_graph(CNNConfig())
    eng, params, imgs, plan_s, clock = serve(graph, 16, seed=0, dev=dev)
    plan = eng.plan
    print(f"vgg19 plan ({plan_s:.2f} s): " + " ".join(
        f"conv{lp.index + 1}={lp.impl}@{lp.occupancy:.2f}" for lp in plan.layers))
    impls = [lp.impl for lp in plan.layers]
    ecr_conv_batch.launches = 0
    conv_pool_batch.launches = 0
    t_start = clock()
    wall0 = time.perf_counter()
    results = replay_stream(eng, imgs, rate_rps=1000.0)
    wall = time.perf_counter() - wall0
    launches = {"ecr_conv": ecr_conv_batch.launches,
                "conv_pool": conv_pool_batch.launches}
    makespan = clock() - t_start
    stats = eng.stats()
    print(f"vgg19 served {len(results)} requests: launches {launches}, "
          f"{stats['batches']} batches, compiles={stats['compiles']} "
          f"hits={stats['hits']}, throughput {len(results) / makespan:.1f} req/s "
          f"(SimClock, measured service), p50={stats['p50_ms']:.2f} ms "
          f"p95={stats['p95_ms']:.2f} ms, host wall {wall:.2f} s")
    if "ecr_pallas" not in impls or "pecr_pallas" not in impls:
        failures.append(f"vgg19 plan lacks an ECR or PECR layer: {impls}")
    if launches["ecr_conv"] < 1 or launches["conv_pool"] < 1:
        failures.append(f"a kernel of the main path never launched: {launches}")
    order = sorted(results, key=lambda r: r.id)
    served = np.stack([r.logits for r in order])
    batch = torch.stack(imgs)
    dense = run_graph(graph, params, batch, "dense").cpu().numpy()
    scale = float(np.abs(dense).max())
    err = float(np.abs(served - dense).max())
    ok = np.allclose(served, dense, rtol=1e-3, atol=1e-3 * scale)
    print(f"vgg19 engine vs dense cuDNN: max_abs_err={err:.3e} (max|dense|="
          f"{scale:.3e}, rtol=1e-3, atol=1e-3*max|dense|): {'ok' if ok else 'FAIL'}")
    if not ok or not np.all(np.isfinite(served)) or served.shape != (16, 1000):
        failures.append("vgg19 engine logits disagree with the dense path")
    ref8 = run_plan(plan, params, batch[:8]).cpu().numpy()
    print(f"vgg19 engine logits bitwise equal to run_plan on the same 8-bucket: "
          f"{bool(np.array_equal(served[:8], ref8))} "
          f"(max diff {float(np.abs(served[:8] - ref8).max()):.3e})")
    for m in (1, 2):  # the min_bucket question: is a sample's row batch-invariant?
        refm = run_plan(plan, params, batch[:m]).cpu().numpy()
        print(f"vgg19 run_plan at N={m} bitwise equal to its rows at N=8: "
              f"{bool(np.array_equal(refm, ref8[:m]))} "
              f"(max diff {float(np.abs(refm - ref8[:m]).max()):.3e})")

    # ---- LeNet-5 and AlexNet through the same spine ------------------------
    for name, g in (("lenet5", LENET), ("alexnet", ALEXNET)):
        e2, p2, im2, _, _ = serve(g, 8, seed=0, dev=dev)
        res2 = sorted(replay_stream(e2, im2, rate_rps=1000.0), key=lambda r: r.id)
        got2 = np.stack([r.logits for r in res2])
        ref2 = run_graph(g, p2, torch.stack(im2), "dense").cpu().numpy()
        sc2 = float(np.abs(ref2).max())
        ok2 = np.allclose(got2, ref2, rtol=1e-3, atol=1e-3 * sc2) and np.all(np.isfinite(got2))
        print(f"{name} plan: {[lp.impl for lp in e2.plan.layers]}; served "
              f"{len(res2)}: max_abs_err={float(np.abs(got2 - ref2).max()):.3e} "
              f"vs dense: {'ok' if ok2 else 'FAIL'}")
        if not ok2:
            failures.append(f"{name} engine logits disagree with the dense path")

    # ---- where the time goes in one warm batch-8 service -------------------
    svc = service_breakdown(plan, params, batch[:8])
    print(f"vgg19 warm batch-8 service: wall {svc['wall_ms']:.2f} ms (median of 5), "
          f"device {svc['device_ms']:.2f} ms, idle share {svc['idle_share']}")
    for cat, ms in sorted(svc["by_class_ms"].items(), key=lambda kv: -kv[1]):
        print(f"  {ms:8.3f} ms  {cat}")

    # ---- kernels vs plain versions at the served VGG-19 layer shapes -------
    print(f"kernel checks ({KERNEL_TOL}):")
    conv_ws = params["conv"]
    x = batch[:8]
    for lp, w in zip(plan.layers, conv_ws):
        unit = lp.to_unit()
        if lp.impl in ("ecr_pallas", "pecr_pallas"):
            pool = unit.pool.p if lp.kind == "conv_pool" else 0
            try:
                check_layer_kernels(book, unit, lp.kind, pad2d(x, unit.conv.pad), w,
                                    pool, timed=True)
            except Exception:
                traceback.print_exc()
                failures.append(f"kernel check failed at conv{unit.index + 1}")
        x = run_unit(x, w, unit, "conv", "dense")
    try:
        edge_cases(book, dev)
    except Exception:
        traceback.print_exc()
        failures.append("edge-case kernel check failed")

    kernels = []
    src = {"ecr_conv": ("ecr_conv_batch", "src/repro/kernels/ecr_conv/kernel.py:166"),
           "conv_pool": ("conv_pool_batch", "src/repro/kernels/conv_pool/kernel.py:181")}
    for key, (wrapper, replaces) in src.items():
        rows = [r for r in book.rows if r["kernel"] == key]
        flop_ms = sum(r["flop_ms"] for r in rows)
        byte_ms = sum(r["byte_ms"] for r in rows)
        kernels.append({
            "name": wrapper, "route": "cuda",
            "source": "src/repro_torch/kernels/csrc/ecr_conv.cu",
            "replaces": replaces, "launches": launches[key],
            "max_abs_err": book.max_err[key],
            "ms": sum(r["ms"] for r in rows),
            "plain_ms": sum(r["plain_ms"] for r in rows),
            "bound_ms": sum(r["bound_ms"] for r in rows),
            "bound_by": "operations" if flop_ms >= byte_ms else "bytes",
            "library_ms": sum(r["library_ms"] for r in rows),
            "layers": [r["layer"] for r in rows]})
    if args.layers_out is not None:
        args.layers_out.parent.mkdir(parents=True, exist_ok=True)
        args.layers_out.write_text(json.dumps(
            {"card": card, "rows": book.rows, "kernels": kernels, "service": svc},
            indent=1))
    if failures:
        for f in failures:
            print(f"FAILED: {f}", file=sys.stderr)
        return 1
    print(json.dumps({"kernels": kernels}))
    print(card)
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": kind,
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    try:
        sys.exit(main())
    except Exception:
        traceback.print_exc()
        sys.exit(1)
