#!/usr/bin/env python3
"""Run the PyTorch/CUDA port (src/repro_torch) end to end on one NVIDIA GPU.

    python3 chip_smoke.py [--layers-out PATH]

1. Refuses at once without CUDA, or when it does not sit in a checkout of the
   repository (it needs src/repro_torch). Prints the card's name and power
   limit as nvidia-smi reports them.
2. Builds the CUDA kernels from the checkout's sources with nvcc (one nvcc
   per source, in parallel) and times the build; counts HMMA, LDGSTS, LDS
   and FFMA in the SASS (cuobjdump) of each instantiation of the split-TF32
   kernels (the fp32 ECR / PECR kernel, the fp32 BSR kernel, the fp32
   flash forward and both flash backward passes) and fails unless every
   one has HMMA and LDGSTS and the expected number of instantiations
   exists; prints each one's registers, stack frame and spill bytes
   (nvcc -Xptxas -v, from the build's output).
3. Serves the published VGG-19 (3x224x224, 1000 classes, random weights from
   a fixed generator seed with the dead-filter shift) through the port's
   Engine (block_c=8, occ_threshold=0.75, max_batch=8, SimClock): 16 requests
   through replay_stream. The kernels' launch counters are set to 0 just
   before and read just after; the plan must hold ECR and PECR layers and
   both counters must have grown. Engine logits are held against the dense
   path on cuDNN (TF32 off) at rtol=1e-3 plus atol=1e-3*max|dense| — sixteen
   fp32 conv layers summed in another order. Then LeNet-5 and AlexNet serve
   8 requests each with the same check.
4. Three more VGG-19 phases, 16 requests each, counters set to 0 just before
   each and read just after:
   - pruned to block density 0.3 (prune_graph_params, probed on the
     calibration batch), fp32: bsr_matmul must launch; logits within the
     same tolerance of the dense cuDNN path on the pruned weights;
   - unpruned, int8=True: ecr_conv_int8 must launch; engine logits bitwise
     equal to run_plan on the same 8-bucket; top-1 agreement and max drift
     against the fp32 dense path are printed;
   - pruned to 0.3 and int8=True: bsr_matmul_int8 must launch; the same
     checks. The int8 phases are planned once at the default int8_budget
     0.98 (its Int8Report is printed) and served at int8_budget=0.0: random
     weights give near-tied logits, so the probe is no accuracy claim here.
5. Holds each kernel against its plain PyTorch version on the same packed
   operands, at the real input of every layer of each served plan that runs
   it (batch 8, and the single-image branch at N=1 for the conv kernels),
   and at edge cases (a cnt=0 sample or row-block, stride 4 with k 11, k 5
   with pad 0, K=27 and other ragged K/O/P, C % block_c != 0, int8 values at
   +-127 over VGG-19's longest reduction). The int8 tensor-core kernels
   also meet the paths they add: ECR schedules whose live blocks leave 1, 2
   or 3 blocks of a 32-channel step (cnt % 4 at block_c 8), cnt = n_cb,
   ids out of order, block_c 4 and 16, and N=1 at conv13's shape (a grid
   of 8 blocks); BSR at every block width 8-128 with F = 25 and 27, T not
   a multiple of 8, ragged P, and density 0.3 with schedules that differ
   per row-block. The split-TF32 BSR kernel meets its own paths
   (`edge_cases_bsr_tf32`): every block width 8-128 at density 0.3 with
   schedules that differ per row-block and a cnt = 0 row-block, F = 25 and
   27 with T = 70 and ragged P, the conv probe lowered as BSR at K = 4608
   (uniform, and x and w spread over 2^+-12), operands off 16-byte
   alignment. The split-TF32 ECR / PECR kernel meets its own paths
   (`edge_cases_tf32`): schedules that leave half an 8-channel k-step
   (block_c 4) or take two per block (block_c 16), cnt = n_cb, cnt = 0, ids
   out of order, ragged O, with and without the pool; N=1 at conv13's shape;
   the served conv10 and conv12 shapes at batch 8; x and w spread over
   2^+-12 at K = 4608, where one TF32 product per multiply-add fails the
   limit; operands off 16-byte alignment. fp32 kernels:
   max|kernel - plain| <= 1e-4*max|plain| + 1e-5*min(1, max|plain|): the
   absolute floor shrinks with the data, since pruning leaves the deep
   layers' outputs far below 1e-5; int8 kernels: bitwise equal. The ops
   are also held against cuDNN (fp32) or their int8 oracle.
   Times kernel, plain version and the library call with CUDA events after
   warm-up, in turns (eager calls; kernel and library call also as
   CUDA-graph replays, which leave out the host's per-call overhead), and
   computes each call's bound from its data. The
   library call is F.conv2d (+ relu + max_pool2d for PECR) for the fp32 conv
   kernels, F.conv2d on the dequantized operands for the int8 conv,
   torch.matmul on the padded dense operands for BSR, and torch._int_mm plus
   the rescale for int8 BSR; none of these is on the port's path.
6. The obs phase: measure -> calibrate -> search -> plan on the published
   VGG-19 and on it pruned to 0.3, at batch 8 (eight calibration images):
   - profile_plan times every layer under dense (cuDNN), ECR, PECR (on the
     fusable layers), BSR, int8 ECR and int8 BSR (host wall around each
     layer call and a synchronize, median of 3) and prints one line per
     layer: occupancy, weight density, ms per impl;
   - CalibrationDB.from_report fits one scale per (kind, impl), printed
     with the plan at the datasheet constants beside the calibrated one;
   - tile_search searches the occupancy-rule plan's kernel layers on the
     card's grid (fp32 ECR / PECR block_c x block_o, BSR bf) and prints
     each layer's default and winner with their times and whether the
     floor holds (it must); every timed geometry's kernel is held against
     its plain version (fp32 limit; int8 bitwise);
   - an Engine planned with the DB's constants and tile winners, traced,
     serves 16 requests: its logits within the tolerance of the dense path
     on cuDNN, every kernel of its plan launched, and the plan must reach
     at least one kernel. Every kernel must also have launched in the
     profile and the search. With --layers-out, the trace and the DB are
     written beside that file (obs_trace_*.json, obs_calibration_*.json).
7. The paper's methods as plain oracles, and the static verifier:
   - full-width VGG-19 (3x224x224, 1000 classes; init_cnn at generator
     seed 0 plus shift_dead_channels) through cnn_forward at batch 1 (one
     image) and 2 under dense, im2col, ecr, pecr (the oracles) and
     ecr_pallas, pecr_pallas (the kernels): each impl's logits within
     1e-4*max|dense|, printed with the forward's wall, its peak
     torch.cuda.max_memory_allocated and its kernel launches; the window
     statistics (sparsity, theta, mul and add reduction; paper Fig. 2 /
     Fig. 6) of the 16 conv inputs; each conv layer timed at batch 1 by
     CUDA events under conv2d dense / im2col / ecr / ecr_pallas and each
     stage-final layer under conv_pool unfused / pecr / pecr_pallas, with
     fused_traffic_bytes beside it; the oracle plan
     (plan_network(use_pallas=False)) verified and run against dense;
   - verify_plan on every plan the script builds (the served VGG-19,
     LeNet-5 and AlexNet plans, the pruned / int8 / pruned+int8 plans and
     their probes, the obs phase's base, calibrated and tile-stamped
     plans, the oracle plan): none may have an error;
   - a copy of the served VGG-19 plan with an ECR layer claimed as BSR at
     density 0.3 on unpruned params must give RPA205 and be refused by
     run_plan; one with a tile the kernels cannot honour gives the RPA204
     warn (the kernel falls back, logits bitwise unchanged); a launch
     record one spatial tile short gives RPA101; verify_plan's host wall
     per run_plan call is printed beside the batch-8 wall, for the served
     VGG-19 plan and for each pruned / int8 variant's;
   - the Python mirror of the conv kernels' tile choice
     (kernels/tiles.py) against the kernels' own host code on every
     full-width VGG-19 / LeNet-5 / AlexNet conv geometry at batch 1, 2
     and 8 (each output tile, with and without the pool, fp32 and int8),
     each accepted geometry launched once at batch 2, and kMaxSmem against
     the device's opt-in shared memory per block where torch exposes it;
   - python -m repro_torch.analysis.cli --json over the reduced zoo must
     exit 0 with no error.
8. Serves full-width qwen3-0.6b (28 layers, d_model 1024, 16 query / 8 KV
   heads, head_dim 128, vocab 151,936; random weights from generator seed
   0) through `repro_torch.launch.serve.serve` at batch 4, prompt 32, 32
   generated tokens, once with the fp32 KV cache and once with the int8
   cache, after a 2-token warm-up of each. The flash counters are set to 0
   just before each run and read just after: flash_fwd must launch 28 * 32 =
   896 times in the fp32 run and flash_fwd_q8 896 times in the int8 run (one
   launch per layer at prefill and at each of the 31 decode steps). The
   card's weights are carried to the host and the port's plain path runs
   teacher-forced on the served tokens (prefill plus 4 decode steps, fp32
   and int8 cache): card logits within rtol 1e-3 + 1e-3*max|host| of the
   host's, and the served tokens equal to the card's argmax. For the int8
   cache the host first quantizes its own K/V and must land within one step
   of the card's values (scales within 1e-5 relative), then attends over
   the card's values: a value on a rounding boundary may round either way
   after fp32 noise, and one step apart moves the logits by more than the
   limit. int8-cache top-1 agreement and drift against the fp32 cache are
   printed. Then both
   flash kernels are held against their plain versions (out, m and l for
   fp32; same tolerance as the fp32 conv kernels) at the real q, k, v of
   layers 0 and 27 at prefill and at the first decode step (captured from
   the teacher-forced card run), at a long prefill (Sq = Sk = 2048, causal)
   and a long decode (kv_len 4096 in a 4160-slot cache) at batch 4, and at
   edge shapes (ragged Sq/Sk, kv_len < Sk, q_offset > 0, Sq = 1, a fully
   masked block, G = 3; decode at G = 1, 2, 4, 8 with kv_len 1, 63 and 65,
   the fp32 kernel's tile edges; q and k spread over 2^+-3 at D = 128).
   The training phase adds the trained forward shape (layer 0 of a batch-8
   step: out, m and l, timed). Kernel, plain version and the library call
   (F.scaled_dot_product_attention in fp32 with K/V expanded to the query
   heads and the same boolean mask; dequantize + SDPA for the int8 kernel)
   are timed in turns at layer 0 of the served shapes and at the long ones,
   as CUDA-graph replays (device time: the eager call's host overhead
   exceeds the kernel at the served shapes) and as eager calls.
   A torch.profiler trace of one warm prefill and one warm decode step per
   cache type gives wall, device time and idle share.
9. Trains full-width qwen3-0.6b (the same config, fp32 weights from
   generator seed 0) through `repro_torch.launch.train.train` at the
   reference launcher's defaults: global batch 8, sequence 128, remat
   "full", 6 steps, checkpoints into a temporary directory the phase
   removes. Prints each step's loss, grad norm, synchronised step time and
   tok/s. The flash counters are set to 0 just before and read just after:
   per step flash_fwd must launch 56 times (28 layers, and again under
   remat), flash_bwd_dq and flash_bwd_dkv 28 times each. Then: the save time
   of a checkpoint of the trained params and both moments; a torch.profiler
   trace of one warm step; one step's loss and gradients on the card against
   the host's plain path at batch 2 (loss within 1e-4 relative, grad norm
   1e-3 relative, every leaf within 1e-3*max|host leaf|, and every layer of
   every leaf with a nonzero gradient on the card); both backward kernels
   against their plain versions (dq; dk and dv; the fp32 limit above) at
   the real operands of layers 0 and 27 of a batch-8 step, at a long causal
   shape (batch 4, Sq = Sk = 2048) and at edge shapes (every head dim,
   ragged Sq/Sk, G = 1, 2, 8, q_offset/kv_len, non-causal, rows that see
   no key; q and k over 2^+-3 at Sk = 512); kernel, plain version and the
   library call (the backward of fp32 F.scaled_dot_product_attention with
   K/V expanded and the same mask, all three gradients in one call: the
   memory-efficient attention backward op, SDPA's fused backend for fp32
   inputs with a mask) timed in turns at layer 0 and at the long shape as CUDA-graph
   replays (device time), the eager calls beside them (the library's eager
   time is the autograd SDPA backward, as earlier runs timed it); the bound
   per pass is max(6 (dq) or 8 (dk/dv) * B*H*pairs*D / 165 TFLOP/s
   (split-TF32), bytes / 3.35 TB/s), with the same operations at the CUDA
   cores' 67 TFLOP/s beside it. Last, at the reduced
   config, a 10-step run against one with a failure at step 7 (checkpoints
   every 3): losses within 1e-6.
10. The scenario phase, on the published VGG-19 (weights and calibration
   images as in step 3; Engines at block_c=8, occ_threshold=0.75,
   max_batch=8, on a SimClock charged with the measured service time):
   - hotswap: 24 requests at 200 req/s; at the midpoint `hot_swap` to
     prune_graph_params(params, 0.3) with a plan built on the card. The
     launch counters are read at the swap: bsr_matmul must be 0 there and
     grow after it, ecr_conv and conv_pool must have grown before it. Each
     result is held against run_plan of the model that served it (rtol
     1e-3 + 1e-3*max|logits|; bitwise only at the same bucket), and the two
     models' logits must differ by more than 10x that tolerance; both
     margins are printed. Then the swap back to the dense-weight model
     (no runner built), a candidate with one BSR layer's density claimed
     0.5 on the 0.3 params (`hot_swap` returns False, verify_rejects 1,
     RPA205), and 8 more requests served by the dense-weight model. Then
     the weight signature: the 0.3 variant and the first of 0.5, 0.4, 0.35,
     0.25 with the same (kind, impl) decisions and other rounded BSR
     densities must get two runners on one engine, each serving its own
     model, or the script prints that no such pair exists;
   - diurnal: 32 requests planned at dead_frac 0.5, replan_band 0.15, no
     cooldown, stepping at the midpoint to 0.0 (VGG-19's 3 input channels
     fill one 8-channel block either way, so no occupancy moves; the
     largest EMA drift and the re-plans are printed) and to 1.0 (blank
     frames), where at least one re-plan must land: the batches formed
     before the step, the batch it landed after, the plan before and
     after, and whether the new plan equals plan_network on the drifted
     images (it must);
   - burst: 32 Poisson requests at 50 req/s with 16x bursts: every id
     served once, each formed within the deadline plus the service of the
     batches that ran between its arrival and its formation; p50 / p95;
   - multitenant: VGG-19 and LeNet-5 (published) on one PlanCache and
     clock, 8 requests each: no build after warmup, each tenant within the
     tolerance of its own model's run_plan;
   - history: serve_cnn(full=True, history=...) steady and then
     --scenario hotswap into a temporary BenchDB; every record stamped with
     the card's name, the trend table, and `python -m
     repro_torch.obs.history.cli check --json` must exit 0 or 1 with JSON
     (1 is a regression verdict, printed, not a failure).
   The phase's seconds are printed, per part and in all.
11. Prints the kernel table as one JSON line (the twelve TPU kernel sites of
   the repo; the single-image rows are the batched kernels at N=1), the card
   line, and last {"ok": true, "device": {...}}. Any failure exits non-zero
   without it. In the CNN rows, ms / plain_ms / library_ms /
   bound_ms are sums over the served plan's layers that run the kernel (one
   batch-8 VGG-19 forward, or N=1 for the single-image rows); launches count
   the serving run of the phase that runs the kernel, and are 0 for the
   single-image rows, which the engine (buckets of 2 or more) never runs. In
   the flash rows they are sums of one prefill launch and one decode launch
   at the served shapes (layer 0), with every timed shape listed under
   "shapes", and launches count the served qwen3-0.6b run. The flash bound is
   max(4*B*H*(visible q.k pairs)*D / 165 TFLOP/s (split-TF32), bytes /
   3.35 TB/s), the
   bytes being the K/V of the keys read (4 bytes, or 1 byte plus the fp32
   scales), Q, O, and m, l for fp32, once. The backward rows time one
   launch of each pass at layer 0 of the trained batch-8 step by graph
   replay, with every timed shape under "shapes", and launches count the
   6-step training run; they carry "redesigned_in": 18 (split-TF32),
   eager_ms, eager_library_ms, achieved_tflops, bound_share and
   fp32_core_bound_ms.
   The rows whose kernels were redesigned for the tensor cores, the fp32
   ECR / PECR rows (ecr_conv_batch, conv_pool_batch and both at N=1;
   split-TF32, "redesigned_in": 16), bsr_matmul (split-TF32, 17) and the
   int8 rows (ecr_conv_int8_batch, at N=1, bsr_matmul_int8; 15), time
   kernel and library as device time
   (CUDA-graph replay, as the flash rows do; the eager times ride along as
   eager_ms and eager_library_ms, the plain version is timed eager) and
   carry the achieved GB/s on the bytes of the bound and "bound_share" =
   bound_ms / ms, all from the device time, with the achieved TFLOP/s (fp32
   rows) or TOPS (int8 rows) on the live multiply-adds. The fp32 rows' bound
   is at 495 / 3 = 165 TFLOP/s, the rate of three TF32 products per
   multiply-add, and "fp32_core_bound_ms" beside it at the CUDA cores' 67
   TFLOP/s; the N=1 rows say "split_reduction": false (the kernel does not
   split its reduction across blocks). flash_fwd carries "redesigned_in":
   17 (its rows were always timed by graph replay; flash_fwd_q8 runs on
   its body).
   `--layers-out PATH` also writes the per-layer numbers there as JSON.
"""
from __future__ import annotations

import argparse
import contextlib
import io
import json
import subprocess
import sys
import time
import traceback
from pathlib import Path

ROOT = Path(__file__).resolve().parent
PEAK_FP32_FLOPS = 67e12  # H100 SXM, fp32 outside the tensor cores
# H100 SXM, TF32 tensor cores (495 TFLOP/s dense) at three products per
# fp32-accurate multiply-add (split-TF32): the fp32 ECR / PECR kernels' rate
PEAK_TF32_SPLIT_FLOPS = 495e12 / 3
PEAK_INT8_OPS = 1979e12  # H100 SXM, int8 tensor cores, dense
PEAK_HBM_BYTES = 3.35e12  # H100 SXM HBM3
KERNEL_TOL = ("fp32: max|kernel - plain| <= 1e-4*max|plain| + 1e-5*min(1, max|plain|); "
              "int8: bitwise")
PRUNE_DENSITY = 0.3
# the split-TF32 kernels and their instantiations: ECR / PECR (4 tiles x
# pool), BSR (16- or 4-byte copies x 8, 4 or 2 row-blocks per block), the
# fp32 flash forward and both backward passes (6 head dims each)
SPLIT_TF32_KERNELS = {"ecr_conv_kernel": 8, "bsr_matmul_kernel": 6, "flash_fwd_kernel": 6,
                      "flash_bwd_dq_kernel": 6, "flash_bwd_dkv_kernel": 6}


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


def time_graph_turns(fns: dict, rounds: int = 5, iters: int = 10) -> dict:
    """Median device ms per call of each function: `iters` calls captured in
    one CUDA graph per function and replayed, timed with CUDA events, the
    functions taking turns round by round. Graph replay leaves the host's
    per-call overhead out, which at the served LM shapes exceeds the
    kernels' own time."""
    import torch

    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        for fn in fns.values():
            for _ in range(2):
                fn()
    torch.cuda.current_stream().wait_stream(side)
    torch.cuda.synchronize()
    graphs = {}
    for k, fn in fns.items():
        g = torch.cuda.CUDAGraph()
        with torch.cuda.graph(g):
            for _ in range(iters):
                fn()
        graphs[k] = g
    for g in graphs.values():
        g.replay()
    torch.cuda.synchronize()
    samples = {k: [] for k in fns}
    for _ in range(rounds):
        for k, g in graphs.items():
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            g.replay()
            end.record()
            torch.cuda.synchronize()
            samples[k].append(start.elapsed_time(end) / iters)
    del graphs
    return {k: sorted(v)[len(v) // 2] for k, v in samples.items()}


def device_times(fns: dict) -> dict:
    """Kernel and library ms per call as device time (CUDA-graph replay,
    `time_graph_turns`), the plain version's eager (its schedule loop reads
    the counts on the host, so it cannot be captured); the eager times of
    kernel and library ride along under "eager" as eager_ms and
    eager_library_ms."""
    te = time_turns(fns)
    tg = time_graph_turns({k: fns[k] for k in ("kernel", "library")})
    return {"kernel": tg["kernel"], "plain": te["plain"], "library": tg["library"],
            "eager": {"eager_ms": te["kernel"], "eager_library_ms": te["library"]}}


def work_bound(x, w, ids, cnt, *, stride, block_c, out_elems, peak, elem_bytes=4):
    """(op time, byte time) in ms of a conv kernel for what these inputs
    need: the live blocks' multiply-adds, each scheduled input block read
    once, the weights of the union of scheduled blocks read once (operands
    at `elem_bytes`), the schedules and the fp32 output written once."""
    n, h, wd, c = x.shape
    kh, kw, _, o = w.shape
    oh, ow = (h - kh) // stride + 1, (wd - kw) // stride + 1
    counts = cnt.clamp(0, c // block_c).tolist()
    ids_h = ids.tolist()
    live = sum(counts)
    union = {j for b in range(n) for j in ids_h[b][:counts[b]]}
    ops = 2.0 * oh * ow * o * kh * kw * block_c * live
    nbytes = (elem_bytes * (live * block_c * h * wd + len(union) * block_c * kh * kw * o)
              + 4.0 * (ids.numel() + cnt.numel() + out_elems))
    return ops / peak * 1e3, nbytes / PEAK_HBM_BYTES * 1e3


def bsr_bound(h, d, ids, cnt, block, *, elem_bytes, peak):
    """(op time, byte time) in ms of a BSR matmul h (T,F) @ w (F,d) for what
    this schedule needs: 2*d multiply-adds per live element of h (blocks
    clipped to T and F), each live block of h read once, the rows of w under
    the union of live reduction blocks read once, the fp32 output written
    once, and the schedules."""
    t, f = h.shape
    bt, bf = block[0], block[1]
    counts = cnt.clamp(0, ids.shape[1]).tolist()
    ids_h = ids.tolist()
    area, union = 0, set()
    for i, c in enumerate(counts):
        rows = min(bt, t - i * bt)
        for j in ids_h[i][:c]:
            area += rows * max(0, min(bf, f - j * bf))
            union.add(j)
    w_rows = sum(max(0, min(bf, f - j * bf)) for j in union)
    ops = 2.0 * area * d
    nbytes = elem_bytes * (area + w_rows * d) + 4.0 * (t * d + ids.numel() + cnt.numel())
    return ops / peak * 1e3, nbytes / PEAK_HBM_BYTES * 1e3


class KernelBook:
    """Accumulates each kernel's comparisons and timings for the JSON line."""

    def __init__(self):
        self.rows = []
        self.max_err = {}

    def check(self, kernel, label, got, want):
        err = float((got - want).abs().max())
        scale = float(want.abs().max())
        lim = 1e-4 * scale + 1e-5 * min(1.0, scale)
        self.max_err[kernel] = max(self.max_err.get(kernel, 0.0), err)
        print(f"  {kernel:15s} {label:46s} max_abs_err={err:.3e} (limit {lim:.3e}, "
              f"max|plain|={scale:.3e})")
        if not err <= lim:
            raise AssertionError(f"{kernel} {label}: {err} > {lim} ({KERNEL_TOL})")

    def exact(self, kernel, label, got, want):
        """int8 kernels: bitwise equal to the plain version."""
        import torch

        err = float((got - want).abs().max())
        same = got.shape == want.shape and bool(torch.equal(got, want))
        self.max_err[kernel] = max(self.max_err.get(kernel, 0.0), err)
        print(f"  {kernel:15s} {label:46s} bitwise={same} max_abs_err={err:.3e}")
        if not same:
            raise AssertionError(f"{kernel} {label}: not bitwise equal ({KERNEL_TOL})")



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

    row = {"kernel": name, "layer": f"conv{unit.index + 1}",
           "x_nchw": list(xp.shape), "w_oihw": list(w.shape), "block_c": bc,
           "cnt": packed[3].tolist(), "n_cb": launch.n_cb, "n1_cnt": int(single[3][0])}
    for sfx, args, lib_fn, n_out in (("", packed, library, got.numel()),
                                     ("_n1", single, library_n1, got.numel() // got.shape[0])):
        t = device_times({"kernel": lambda a=args: kernel(a),
                          "plain": lambda a=args: plain(a), "library": lib_fn})
        # the bound at the rate of the kernel's arithmetic (split-TF32), and
        # at the CUDA cores' fp32 rate beside it
        ft, bt = work_bound(*args, stride=stride, block_c=bc, out_elems=n_out,
                            peak=PEAK_TF32_SPLIT_FLOPS)
        fc = ft * PEAK_TF32_SPLIT_FLOPS / PEAK_FP32_FLOPS
        row.update({"ms" + sfx: t["kernel"], "plain_ms" + sfx: t["plain"],
                    "library_ms" + sfx: t["library"],
                    "eager_ms" + sfx: t["eager"]["eager_ms"],
                    "eager_library_ms" + sfx: t["eager"]["eager_library_ms"],
                    "flop_ms" + sfx: ft, "byte_ms" + sfx: bt, "bound_ms" + sfx: max(ft, bt),
                    "fp32_core_bound_ms" + sfx: max(fc, bt),
                    "bound_by" + sfx: "operations" if ft >= bt else "bytes"})
        _print_times(f"N={args[0].shape[0]}", t, ft, bt)
    book.rows.append(row)


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


def _row(name, unit, xp, w, t, ft, bt, extra=None):
    row = {"kernel": name, "layer": f"conv{unit.index + 1}",
           "x_nchw": list(xp.shape), "w_oihw": list(w.shape),
           "ms": t["kernel"], "plain_ms": t["plain"], "library_ms": t["library"],
           "flop_ms": ft, "byte_ms": bt, "bound_ms": max(ft, bt),
           "bound_by": "operations" if ft >= bt else "bytes"}
    row.update(extra or {})
    return row


def _print_times(label, t, ft, bt):
    eager = t.get("eager")
    note = (f" [kernel and library: CUDA-graph replay; eager calls: "
            f"{eager['eager_ms']:.4f} / {eager['eager_library_ms']:.4f} ms]" if eager else "")
    print(f"    {label}: ms={t['kernel']:.4f} plain_ms={t['plain']:.4f} "
          f"library_ms={t['library']:.4f} bound_ms={max(ft, bt):.4f} "
          f"({'operations' if ft >= bt else 'bytes'}){note}")


def check_ecr_int8_layer(book, unit, xp, w, timed: bool):
    """int8 ECR kernel vs its plain version (bitwise) on one layer's real
    input, batched and at N=1 (the single-image kernel); the op vs its int8
    oracle; when `timed`, kernel/plain/library times, where the library call
    is F.conv2d on the dequantized operands."""
    import torch
    import torch.nn.functional as F

    from repro_torch.graph.registry import unit_launch
    from repro_torch.quant.kernels import ecr_conv_int8_batch, ecr_conv_int8_plain
    from repro_torch.quant.ops import (
        ecr_conv_int8,
        ecr_conv_int8_ref,
        pack_int8_operands,
        pack_int8_operands_single,
    )

    stride = unit.conv.stride
    launch = unit_launch("conv", "ecr_int8", unit, block_c=8, batch=xp.shape[0])
    bc = launch.block_c
    label = f"conv{unit.index + 1} x{tuple(xp.shape)} w{tuple(w.shape)}"
    packed = pack_int8_operands(xp, w, launch)
    single = pack_int8_operands_single(xp[0], w, launch)

    def kernel(args):
        return ecr_conv_int8_batch(*args, stride=stride, block_c=bc)

    def plain(args):
        return ecr_conv_int8_plain(*args, stride=stride, block_c=bc)

    got = kernel(packed)
    torch.cuda.synchronize()
    book.exact("ecr_conv_int8", label + f" N={xp.shape[0]}", got, plain(packed))
    got1 = kernel(single)
    book.exact("ecr_conv_int8_n1", label + " N=1", got1, plain(single))
    book.check("ecr_conv_int8 op", label + " vs int8 oracle",
               ecr_conv_int8(xp, w, stride, block_c=8), ecr_conv_int8_ref(xp, w, stride))
    if not timed:
        return

    def dequantized(args):
        x, wk, sx, sw = args[:4]
        xd = (x.float() * sx.reshape(-1, 1, 1, 1)).permute(0, 3, 1, 2).contiguous()
        wd = (wk.float() * sw.reshape(1, 1, 1, -1)).permute(3, 2, 0, 1).contiguous()
        return xd, wd

    xd, wd = dequantized(packed)
    xd1, wd1 = dequantized(single)
    t = device_times({"kernel": lambda: kernel(packed), "plain": lambda: plain(packed),
                      "library": lambda: F.conv2d(xd, wd, stride=stride)})
    t1 = device_times({"kernel": lambda: kernel(single), "plain": lambda: plain(single),
                       "library": lambda: F.conv2d(xd1, wd1, stride=stride)})
    x, wk, _, _, ids, cnt = packed
    ft, bt = work_bound(x, wk, ids, cnt, stride=stride, block_c=bc,
                        out_elems=got.numel(), elem_bytes=1, peak=PEAK_INT8_OPS)
    x1, wk1, _, _, ids1, cnt1 = single
    ft1, bt1 = work_bound(x1, wk1, ids1, cnt1, stride=stride, block_c=bc,
                          out_elems=got1.numel(), elem_bytes=1, peak=PEAK_INT8_OPS)
    meta = {"block_c": bc, "cnt": cnt.tolist(), "n_cb": launch.n_cb, **t["eager"]}
    book.rows.append(_row("ecr_conv_int8", unit, xp, w, t, ft, bt, meta))
    book.rows.append(_row("ecr_conv_int8_n1", unit, xp[:1], w, t1, ft1, bt1,
                          {"block_c": bc, "cnt": cnt1.tolist(), "n_cb": launch.n_cb,
                           **t1["eager"]}))
    _print_times(f"N={xp.shape[0]}", t, ft, bt)
    _print_times("N=1", t1, ft1, bt1)


def check_bsr_layer(book, unit, xp, w, *, int8: bool, timed: bool):
    """BSR kernel (fp32 or int8) vs its plain version on one layer's real
    input (fp32 within tolerance, int8 bitwise), the op vs cuDNN (fp32) or
    its int8 oracle, and, when `timed`, kernel/plain/library times: the
    library call is torch.matmul on the padded dense operands (fp32) or
    torch._int_mm plus the rescale (int8)."""
    import torch
    import torch.nn.functional as F

    from repro_torch.kernels.bsr_matmul.kernel import bsr_matmul, bsr_matmul_plain
    from repro_torch.quant.kernels import bsr_matmul_int8, bsr_matmul_int8_plain
    from repro_torch.quant.ops import conv2d_bsr_int8, conv2d_bsr_int8_ref, pack_bsr_int8_operands
    from repro_torch.sparse_weights.conv import conv2d_bsr, pack_bsr_operands

    stride = unit.conv.stride
    label = f"conv{unit.index + 1} x{tuple(xp.shape)} w{tuple(w.shape)}"
    if int8:
        h, at, sh, sa, ids, cnt, launch, _, _ = pack_bsr_int8_operands(xp, w, stride)
        name = "bsr_matmul_int8"
    else:
        h, at, ids, cnt, launch, _, _ = pack_bsr_operands(xp, w, stride)
        name = "bsr_matmul"
    blk = (launch.bt, launch.bf)

    def kernel():
        if int8:
            return bsr_matmul_int8(h, at, sh, sa, ids, cnt, block=blk)
        return bsr_matmul(h, at, ids, cnt, block=blk)

    def plain():
        if int8:
            return bsr_matmul_int8_plain(h, at, sh, sa, ids, cnt, block=blk)
        return bsr_matmul_plain(h, at, ids, cnt, block=blk)

    got = kernel()
    torch.cuda.synchronize()
    if int8:
        book.exact(name, label, got, plain())
        book.check(name + " op", label + " vs int8 oracle",
                   conv2d_bsr_int8(xp, w, stride), conv2d_bsr_int8_ref(xp, w, stride))
    else:
        book.check(name, label, got, plain())
        book.check(name + " op", label + " vs cuDNN", conv2d_bsr(xp, w, stride),
                   F.conv2d(xp, w, stride=stride))
    if not timed:
        return
    # the dense operands padded as the reference pads them: rows and taps to
    # block multiples, patches to a multiple of 128
    t_pad, f_pad, d_pad = (-launch.t) % launch.bt, (-launch.f) % launch.bf, (-launch.d) % 128
    hp = F.pad(h, (0, f_pad, 0, t_pad))
    atp = F.pad(at, (0, d_pad, 0, f_pad))
    if int8:
        shp = F.pad(sh, (0, 0, 0, t_pad), value=1.0)

        def library():
            return (torch._int_mm(hp, atp).float() * shp) * sa
    else:
        def library():
            return torch.matmul(hp, atp)

    t = device_times({"kernel": kernel, "plain": plain, "library": library})
    # the fp32 bound at the rate of the kernel's arithmetic (split-TF32), and
    # at the CUDA cores' fp32 rate beside it
    ft, bt = bsr_bound(h, at.shape[1], ids, cnt, blk, elem_bytes=1 if int8 else 4,
                       peak=PEAK_INT8_OPS if int8 else PEAK_TF32_SPLIT_FLOPS)
    meta = {"block": list(blk), "live_blocks": int(cnt.clamp(min=0).sum()),
            "blocks": launch.nt * launch.nf, "t_f_d": [launch.t, launch.f, launch.d],
            "cnt": cnt.tolist(), **t["eager"]}
    if not int8:
        meta["fp32_core_bound_ms"] = max(ft * PEAK_TF32_SPLIT_FLOPS / PEAK_FP32_FLOPS, bt)
    book.rows.append(_row(name, unit, xp, w, t, ft, bt, meta))
    _print_times(f"live {meta['live_blocks']}/{meta['blocks']} blocks", t, ft, bt)


def edge_cases_bsr_tf32(book, dev):
    """The split-TF32 BSR kernel's own paths against the plain version (fp32
    limit), each launch counted and every cnt = 0 row-block all zeros: every
    block width 8-128 at density 0.3 with schedules that differ per
    row-block (row-block 0 fully pruned), in grids of 8 and 2 row-blocks per
    block; F = 25 and 27 with T = 70 and ragged P; the conv probe lowered as
    BSR (K = 4608, every block scheduled), uniform and with x and w spread
    over 2^+-12, where one TF32 product per multiply-add fails the limit;
    operands off 16-byte alignment (4-byte copies); 525 row-blocks (a large
    T: the most counts any launch here ranks)."""
    import numpy as np
    import torch

    from repro_torch.core.sparsity import patches_t
    from repro_torch.kernels.bsr_matmul.kernel import bsr_matmul, bsr_matmul_plain
    from repro_torch.kernels.bsr_matmul.ops import block_schedule

    rng = np.random.default_rng(17)

    def run(label, h, w, ids, cnt, bf):
        before = bsr_matmul.launches
        got = bsr_matmul(h, w, ids, cnt, block=(8, bf))
        torch.cuda.synchronize()
        if bsr_matmul.launches != before + 1:
            raise AssertionError(f"{label}: the launch was not counted once")
        book.check("bsr_matmul", label, got, bsr_matmul_plain(h, w, ids, cnt, block=(8, bf)))
        for i in (cnt == 0).nonzero().flatten().tolist():
            if bool(torch.any(got[8 * i:8 * i + 8] != 0)):
                raise AssertionError(f"{label}: the cnt = 0 row-block {i} is not all zeros")

    def pruned(t, f, d, bf, density):
        nt, nf = -(-t // 8), -(-f // bf)
        keep = rng.random((nt, nf)) < density
        keep[0] = False
        mask = np.repeat(np.repeat(keep, 8, 0), bf, 1)[:t, :f]
        h = torch.from_numpy((rng.standard_normal((t, f)) * mask).astype(np.float32)).to(dev)
        w = torch.from_numpy(rng.random((f, d), dtype=np.float32)).to(dev)
        ids, cnt = block_schedule(h, 8, bf)
        return h, w, ids.contiguous(), cnt.contiguous()

    for bf in (8, 16, 32, 64, 128):
        for t, f, d in ((70, 25, 1001), (70, 27, 1002), (256, 1152, 2048),
                        (256, 1152, 34816)):
            run(f"T={t} F={f} P={d} bf={bf} density 0.3", *pruned(t, f, d, bf, 0.3), bf)
    for kind in ("uniform", "wide"):
        x, w = tf32_probe_operands(kind)
        at, _, _ = patches_t(x.permute(0, 3, 1, 2), 3, 3)
        h = w.permute(3, 2, 0, 1).reshape(64, -1).contiguous()
        ids, cnt = block_schedule(h, 8, 128)
        label = ("x and w over 2^+-12, K=4608" if kind == "wide"
                 else "conv probe, K=4608")
        run(label, h.to(dev), at.contiguous().to(dev), ids.to(dev), cnt.to(dev), 128)

    def misaligned(t):  # the same values, 4 bytes past a 16-byte boundary
        buf = torch.empty(t.numel() + 4, device=dev)
        v = buf[1:1 + t.numel()].view(t.shape)
        v.copy_(t)
        return v

    h, w, ids, cnt = pruned(40, 512, 1000, 128, 0.5)
    run("h and w off 16-byte alignment", misaligned(h), misaligned(w), ids, cnt, 128)
    run("T=4200 (525 row-blocks) F=128 P=300 bf=16", *pruned(4200, 128, 300, 16, 0.3), 16)


def edge_cases_new(book, dev):
    """The BSR and int8 kernels at shapes and values the served VGG-19 does
    not reach: ragged K/O/P, an all-pruned row-block (cnt = 0), stride 4
    with k 11, k 5 with pad 0, an int8 cnt = 0 pad sample, and int8 values
    at +-127 over VGG-19's longest reduction (512 * 3 * 3 = 4608 taps)."""
    import numpy as np
    import torch
    import torch.nn.functional as F

    from repro_torch.graph.ir import ConvSpec, ConvUnit
    from repro_torch.kernels.bsr_matmul.ops import block_schedule
    from repro_torch.quant.kernels import (
        bsr_matmul_int8,
        bsr_matmul_int8_plain,
        ecr_conv_int8_batch,
        ecr_conv_int8_plain,
    )
    from repro_torch.sparse_weights.format import conv_weight_matrix, weight_block
    from repro_torch.sparse_weights.prune import prune_matrix

    cases = [  # (c, h, o, k, stride, pad)
        (3, 30, 64, 3, 1, 1),       # K = 27 (VGG-19 conv1_1), ragged P
        (1, 32, 6, 5, 1, 0),        # LeNet-5 conv1: O = 6, K = 25, k 5 pad 0
        (3, 224, 64, 11, 4, 2),     # AlexNet conv1: stride 4, k 11, K = 363
        (64, 27, 192, 5, 1, 2),     # AlexNet conv2: k 5
        (20, 15, 70, 3, 2, 1),      # ragged O and C at stride 2
    ]
    rng = np.random.default_rng(11)
    for i, (c, h, o, k, s, pad) in enumerate(cases):
        x = rng.random((3, c, h, h), dtype=np.float32)
        x *= rng.random((3, c, 1, 1)) > 0.4
        x[-1] = 0.0  # the batcher's all-zero pad sample
        w = rng.standard_normal((o, c, k, k)).astype(np.float32) / (c * k * k) ** 0.5
        wt = torch.from_numpy(w).to(dev)
        m = conv_weight_matrix(wt)
        m = prune_matrix(m, PRUNE_DENSITY, weight_block(*m.shape))[0]
        m[:8] = 0.0  # an all-pruned row-block: cnt = 0
        wt = m.reshape(wt.shape).contiguous()
        spec = ConvSpec(o, k=k, stride=s, pad=pad)
        oh = (h + 2 * pad - k) // s + 1
        unit = ConvUnit(index=200 + i, stage=0, slot=0, conv=spec, relu=True,
                        pool=None, in_shape=(c, h, h), out_shape=(o, oh, oh))
        xp = F.pad(torch.from_numpy(x).to(dev), (pad,) * 4)
        check_bsr_layer(book, unit, xp, wt, int8=False, timed=False)
        check_bsr_layer(book, unit, xp, wt, int8=True, timed=False)
        check_ecr_int8_layer(book, unit, xp, wt, timed=False)

    # int8 extremes: every product is 127 * 127, summed over 4608 taps
    taps = 512 * 9
    h8 = torch.full((16, taps), 127, dtype=torch.int8, device=dev)
    h8[8:] = -127
    w8 = torch.full((taps, 300), 127, dtype=torch.int8, device=dev)
    ids, cnt = block_schedule(h8, 8, 128)
    one16, one = torch.ones(16, device=dev), torch.ones(1, device=dev)
    got = bsr_matmul_int8(h8, w8, one16, one, ids, cnt, block=(8, 128))
    book.exact("bsr_matmul_int8", "+-127 over K=4608", got,
               bsr_matmul_int8_plain(h8, w8, one16, one, ids, cnt, block=(8, 128)))
    if not (torch.all(got[:8] == 127 * 127 * taps) and torch.all(got[8:] == -127 * 127 * taps)):
        raise AssertionError("bsr_matmul_int8 extremes are not exact")
    x8 = torch.full((2, 16, 16, 512), 127, dtype=torch.int8, device=dev)
    x8[1] = 0  # a cnt = 0 pad sample
    w8 = torch.full((3, 3, 512, 64), -127, dtype=torch.int8, device=dev)
    ids = torch.arange(64, dtype=torch.int32, device=dev).repeat(2, 1).contiguous()
    cnt = torch.tensor([64, 0], dtype=torch.int32, device=dev)
    ones2, ones64 = torch.ones(2, device=dev), torch.ones(64, device=dev)
    got = ecr_conv_int8_batch(x8, w8, ones2, ones64, ids, cnt, stride=1, block_c=8)
    book.exact("ecr_conv_int8", "+-127 over C*kh*kw=4608, a cnt=0 sample", got,
               ecr_conv_int8_plain(x8, w8, ones2, ones64, ids, cnt, stride=1, block_c=8))
    if not (torch.all(got[0] == -127 * 127 * taps) and torch.all(got[1] == 0)):
        raise AssertionError("ecr_conv_int8 extremes are not exact")


def edge_cases_int8_tc(book, dev):
    """The int8 tensor-core kernels' own paths, bitwise against the plain
    versions: ECR schedules that leave 1, 2 or 3 blocks of a 32-channel
    step, cnt = n_cb, cnt = 0 and ids out of order at block_c 4, 8 and 16
    and O not a multiple of 128; N=1 at VGG-19 conv13's shape (a grid of 8
    blocks); BSR at block widths 8-128 with F = 25 and 27, T = 70, ragged P
    and density 0.3 (schedules differ per row-block, row-block 0 fully
    pruned), in grids that take 2 and 8 row-blocks per block."""
    import numpy as np
    import torch

    from repro_torch.kernels.bsr_matmul.ops import block_schedule
    from repro_torch.quant.kernels import (
        bsr_matmul_int8,
        bsr_matmul_int8_plain,
        ecr_conv_int8_batch,
        ecr_conv_int8_plain,
    )

    rng = np.random.default_rng(15)

    def i8(shape):
        return torch.from_numpy(rng.integers(-127, 128, shape).astype(np.int8)).to(dev)

    def scales(n):
        return torch.from_numpy(rng.random(n).astype(np.float32) * 1e-2 + 1e-4).to(dev)

    cnts = [1, 2, 3, 8, 0, 5]
    for bc, o in ((8, 96), (8, 70), (16, 128), (4, 64)):
        x, w = i8((len(cnts), 13, 19, 8 * bc)), i8((3, 3, 8 * bc, o))
        ids = torch.from_numpy(np.stack([rng.permutation(8) for _ in cnts])
                               .astype(np.int32)).to(dev)
        cnt = torch.tensor(cnts, dtype=torch.int32, device=dev)
        args = (x, w, scales(len(cnts)), scales(o), ids, cnt)
        book.exact("ecr_conv_int8", f"cnt {cnts}, ids permuted, block_c {bc}, O={o}",
                   ecr_conv_int8_batch(*args, stride=1, block_c=bc),
                   ecr_conv_int8_plain(*args, stride=1, block_c=bc))
    x, w = i8((1, 16, 16, 512)), i8((3, 3, 512, 512))
    x[..., 36 * 8:] = 0
    ids = torch.arange(64, dtype=torch.int32, device=dev)[None].contiguous()
    args = (x, w, scales(1), scales(512), ids, torch.tensor([36], dtype=torch.int32,
                                                            device=dev))
    book.exact("ecr_conv_int8_n1", "N=1 conv13 shape, 36/64 blocks",
               ecr_conv_int8_batch(*args, stride=1, block_c=8),
               ecr_conv_int8_plain(*args, stride=1, block_c=8))

    for bf in (8, 16, 32, 64, 128):
        for t, f, d in ((70, 25, 1001), (70, 27, 1002), (256, 1152, 2048),
                        (256, 1152, 34816)):
            nt, nf = -(-t // 8), -(-f // bf)
            keep = rng.random((nt, nf)) < 0.3
            keep[0] = False
            mask = np.repeat(np.repeat(keep, 8, 0), bf, 1)[:t, :f]
            h = i8((t, f)) * torch.from_numpy(mask.astype(np.int8)).to(dev)
            ids, cnt = block_schedule(h, 8, bf)
            args = (h, i8((f, d)), scales(t), scales(1), ids.contiguous(), cnt.contiguous())
            book.exact("bsr_matmul_int8", f"T={t} F={f} P={d} bf={bf} density 0.3",
                       bsr_matmul_int8(*args, block=(8, bf)),
                       bsr_matmul_int8_plain(*args, block=(8, bf)))


def tf32_probe_operands(kind: str, seed: int = 0):
    """A conv with VGG-19 conv10's reduction (3x3x512 = 4,608 terms) over
    16x16 positions and 64 output channels: x uniform on [0, 1) and w normal
    over sqrt(K) ("uniform"), or both scaled elementwise by 2^e, e uniform
    over -12..12 ("wide"). The same operands as the host's
    tests/test_torch_kernels.py, which shows that one TF32 product per
    multiply-add fails the fp32 limit on them and split-TF32 holds it."""
    import numpy as np
    import torch

    rng = np.random.default_rng(seed)
    x = rng.random((1, 18, 18, 512), dtype=np.float32)
    w = (rng.standard_normal((3, 3, 512, 64)) / np.sqrt(4608)).astype(np.float32)
    if kind == "wide":
        x = (x * np.exp2(rng.integers(-12, 13, x.shape))).astype(np.float32)
        w = (w * np.exp2(rng.integers(-12, 13, w.shape))).astype(np.float32)
    return torch.from_numpy(x), torch.from_numpy(w)


def edge_cases_tf32(book, dev):
    """The split-TF32 ECR / PECR kernel's own paths against the plain
    versions (fp32 limit), each launch counted and every cnt = 0 sample all
    zeros: schedules that leave half an 8-channel k-step (block_c 4), two
    k-steps per block (block_c 16), cnt = n_cb, cnt = 0 and ids out of order,
    O not a multiple of the tile; N=1 at VGG-19 conv13's shape (36 of 64
    blocks, the kernel's smallest served grid); the served conv10 and conv12
    shapes at batch 8; an input spread over 2^+-12 at K = 4608, where one
    TF32 product per multiply-add fails the limit; operands off 16-byte
    alignment (plain loads instead of cp.async)."""
    import numpy as np
    import torch

    from repro_torch.kernels.conv_pool.kernel import conv_pool_batch, conv_pool_plain
    from repro_torch.kernels.ecr_conv.kernel import ecr_conv_batch, ecr_conv_plain

    rng = np.random.default_rng(16)

    def operands(n, h, w_, c, o):
        x = torch.from_numpy(rng.random((n, h, w_, c), dtype=np.float32)).to(dev)
        w = rng.standard_normal((3, 3, c, o)) / np.sqrt(9 * c)
        return x, torch.from_numpy(w.astype(np.float32)).to(dev)

    def schedule(cnts, n_cb, permuted=True):
        order = [rng.permutation(n_cb) if permuted else np.arange(n_cb) for _ in cnts]
        return (torch.from_numpy(np.stack(order).astype(np.int32)).to(dev),
                torch.tensor(cnts, dtype=torch.int32, device=dev))

    def run(label, x, w, ids, cnt, *, bc, pool=0):
        wrapper = conv_pool_batch if pool else ecr_conv_batch
        before = wrapper.launches
        if pool:
            got = conv_pool_batch(x, w, ids, cnt, stride=1, pool=pool, block_c=bc)
            want = conv_pool_plain(x, w, ids, cnt, stride=1, pool=pool, block_c=bc)
        else:
            got = ecr_conv_batch(x, w, ids, cnt, stride=1, block_c=bc)
            want = ecr_conv_plain(x, w, ids, cnt, stride=1, block_c=bc)
        torch.cuda.synchronize()
        if wrapper.launches != before + 1:
            raise AssertionError(f"{label}: the launch was not counted once")
        book.check("conv_pool" if pool else "ecr_conv", label, got, want)
        for b in (cnt == 0).nonzero().flatten().tolist():
            if bool(torch.any(got[b] != 0)):
                raise AssertionError(f"{label}: the cnt = 0 sample {b} is not all zeros")

    cnts = [1, 2, 3, 8, 0, 5]
    for bc, o, pool in ((8, 96, 0), (8, 70, 2), (16, 128, 0), (4, 64, 2), (4, 70, 0),
                        (16, 64, 2)):
        x, w = operands(len(cnts), 13, 19, 8 * bc, o)
        ids, cnt = schedule(cnts, 8)
        run(f"cnt {cnts}, ids permuted, block_c {bc}, O={o}, pool {pool}", x, w, ids, cnt,
            bc=bc, pool=pool)
    x, w = operands(1, 16, 16, 512, 512)
    x[..., 36 * 8:] = 0.0
    ids, cnt = schedule([36], 64, permuted=False)
    run("N=1 conv13 shape, 36/64 blocks", x, w, ids, cnt, bc=8)
    x, w = operands(8, 30, 30, 512, 512)
    x[-1] = 0.0
    ids, cnt = schedule([42] * 7 + [0], 64)
    run("conv10 shape, batch 8, 42/64 blocks", x, w, ids, cnt, bc=8)
    run("conv12 shape, batch 8, 42/64 blocks, pool 2", x, w, ids, cnt, bc=8, pool=2)
    x, w = (t.to(dev) for t in tf32_probe_operands("wide"))
    ids, cnt = schedule([64], 64, permuted=False)
    run("x and w over 2^+-12, K=4608", x, w, ids, cnt, bc=8)
    x, w = operands(3, 12, 12, 32, 64)

    def misaligned(t):  # the same values, 4 bytes past a 16-byte boundary
        buf = torch.empty(t.numel() + 4, device=dev)
        v = buf[1:1 + t.numel()].view(t.shape)
        v.copy_(t)
        return v

    ids, cnt = schedule([4, 0, 2], 4)
    run("x and w off 16-byte alignment", misaligned(x), misaligned(w), ids, cnt, bc=8)
    run("x and w off 16-byte alignment, pool 2", misaligned(x), misaligned(w), ids, cnt,
        bc=8, pool=2)


def sass_counts(lib_path) -> dict:
    """{kernel symbol: {opcode: count}} of the built library's SASS
    (cuobjdump -sass from the toolkit that built it)."""
    import re

    from repro_torch.kernels.cuda import nvcc_path

    cuobjdump = Path(nvcc_path()).with_name("cuobjdump")
    r = subprocess.run([str(cuobjdump), "-sass", str(lib_path)], capture_output=True,
                       text=True, timeout=300)
    if r.returncode != 0:
        raise RuntimeError(f"cuobjdump failed: {r.stderr.strip()}")
    counts, fn = {}, None
    for line in r.stdout.splitlines():
        m = re.search(r"Function : (\S+)", line)
        if m:
            fn = m.group(1)
            counts[fn] = {}
            continue
        m = re.search(r"/\*[0-9a-f]{4,}\*/\s+(?:@!?U?P\w+\s+)?([A-Z][A-Z0-9]*)", line)
        if m and fn:
            counts[fn][m.group(1)] = counts[fn].get(m.group(1), 0) + 1
    return counts


def ptxas_usage(text: str) -> dict:
    """{kernel symbol: {"registers", "stack", "spill_stores", "spill_loads"}}
    from nvcc's `-Xptxas -v` report in the build's output: registers per
    thread, stack frame bytes, and the bytes of registers spilled to it."""
    import re

    usage, fn = {}, None
    for line in text.splitlines():
        m = re.search(r"Function properties for (\S+)", line)
        if m:
            fn = m.group(1)
            usage[fn] = {}
            continue
        m = re.search(r"(\d+) bytes stack frame, (\d+) bytes spill stores, (\d+) bytes "
                      r"spill loads", line)
        if m and fn:
            usage[fn].update(stack=int(m.group(1)), spill_stores=int(m.group(2)),
                             spill_loads=int(m.group(3)))
            continue
        m = re.search(r"Used (\d+) registers", line)
        if m and fn:
            usage[fn]["registers"] = int(m.group(1))
            fn = None
    return usage


def kernel_category(name: str) -> str:
    """Coarse class of a CUDA kernel by its symbol name."""
    if "flash_bwd_dq_kernel" in name:
        return "flash bwd dq kernel"
    if "flash_bwd_dkv_kernel" in name:
        return "flash bwd dk/dv kernel"
    if "flash_fwd_q8_kernel" in name:
        return "flash q8 kernel"
    if "flash_fwd_kernel" in name:
        return "flash kernel"
    if "bsr_matmul_i8_kernel" in name:
        return "bsr int8 kernel"
    if "ecr_conv_i8_kernel" in name:
        return "ecr int8 kernel"
    if "bsr_matmul_kernel" in name:
        return "bsr kernel"
    if "ecr_conv_kernel" in name:
        return "pecr kernel" if "Lb1E" in name or "true>" in name else "ecr kernel"
    low = name.lower()
    if any(t in low for t in ("cudnn", "xmma", "conv", "gemm", "cutlass")):
        return "cuDNN/cuBLAS (dense convs, head, LM matmuls)"
    if "sort" in low or "radix" in low:
        return "argsort (compaction)"
    if "im2col" in low:
        return "im2col (BSR patches)"
    return "other (pad/permute/gather/relu/pool/occupancy/quantize)"


def trace_breakdown(fn, extra=None) -> dict:
    """Host wall time of `fn` (median of 5, synchronised, after 2 warm-up
    runs) and a torch.profiler trace of one more run, summed by kernel class.
    The device idle share is 1 - device time / wall time."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    for _ in range(2):
        fn()
    torch.cuda.synchronize()
    walls = []
    for _ in range(5):
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        walls.append((time.perf_counter() - t0) * 1e3)
    wall_ms = sorted(walls)[2]
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        fn()
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
    out = {"wall_ms": wall_ms, "walls_ms": walls, "device_ms": device_ms,
           "device_ops": sum(n for _, n in kernels.values()),
           "idle_share": max(0.0, 1.0 - device_ms / wall_ms) if device_ms else None,
           "by_class_ms": cats,
           "top_kernels": [{"name": k[:120], "ms": v[0] / 1e3, "count": v[1]}
                           for k, v in top]}
    out.update(extra or {})
    return out


def service_breakdown(plan, params, imgs) -> dict:
    """One warm batch through the engine's runner (`trace_breakdown`)."""
    from repro_torch.pipeline import run_plan

    n = imgs.shape[0]
    return trace_breakdown(
        lambda: run_plan(plan, params, imgs, collect_occupancy=True, n_valid=n),
        {"batch": n})


def make_params(graph, *, seed, dev, prune_density=1.0):
    """Random weights from generator `seed` with the dead filters shifted,
    optionally block-pruned (the calibration batch as probe), and the 2
    calibration images. Returns (params, calib, prune report or None)."""
    import torch

    from repro_torch.graph import init_graph
    from repro_torch.launch.serve_cnn import synth_requests
    from repro_torch.models.cnn import shift_dead_channels
    from repro_torch.sparse_weights.prune import prune_graph_params

    params = shift_dead_channels(init_graph(torch.Generator().manual_seed(seed),
                                            graph, device=dev))
    calib = torch.stack(synth_requests(graph, 2, seed=seed + 1, device=dev))
    report = None
    if prune_density < 1.0:
        params, report = prune_graph_params(params, prune_density, graph, probe=calib)
    return params, calib, report


def serve(graph, n_requests, *, seed, dev, prune_density=1.0, int8=False,
          int8_budget=0.98):
    """An Engine over `make_params`' weights, planned on its 2 calibration
    images, and its request images. Returns (engine, params, imgs, planning
    seconds, clock, prune report)."""
    from repro_torch.launch.serve_cnn import synth_requests
    from repro_torch.serving import Engine, SimClock

    params, calib, report = make_params(graph, seed=seed, dev=dev,
                                        prune_density=prune_density)
    clock = SimClock()
    t0 = time.perf_counter()
    eng = Engine(params, graph=graph, calib=calib, occ_threshold=0.75,
                 block_c=8, max_batch=8, clock=clock, int8=int8,
                 int8_budget=int8_budget, device=dev)
    plan_s = time.perf_counter() - t0
    eng.warmup()
    imgs = synth_requests(graph, n_requests, seed=seed + 2, device=dev)
    return eng, params, imgs, plan_s, clock, report


def plan_line(plan) -> str:
    return " ".join(f"conv{lp.index + 1}={lp.impl}@{lp.occupancy:.2f}"
                    for lp in plan.layers)


def reset_counts(wrappers) -> None:
    for fn in wrappers.values():
        fn.launches = 0


def read_counts(wrappers) -> dict:
    return {k: fn.launches for k, fn in wrappers.items()}


def variant_phase(name, graph, dev, wrappers, failures, *, prune_density,
                  int8, want):
    """One served VGG-19 variant (pruned and/or int8): plan, counters to 0,
    16 requests, counters read; `want` is the wrapper that must have
    launched. Returns (engine plan, params, request batch, launches,
    summary) for the kernel checks."""
    import numpy as np
    import torch

    from repro_torch.graph import run_graph
    from repro_torch.pipeline import plan_network, run_plan
    from repro_torch.serving import replay_stream

    budget = 0.98
    if int8:
        # plan once at the default budget, to show what the probe does
        p0, calib0, _ = make_params(graph, seed=0, dev=dev, prune_density=prune_density)
        t0 = time.perf_counter()
        probed = plan_network(p0, calib0, graph, occ_threshold=0.75, block_c=8,
                              int8=True, int8_budget=0.98)
        rep = probed.int8_report
        print(f"{name} int8 probe at int8_budget=0.98 ({time.perf_counter() - t0:.2f} s): "
              f"{len(rep.layers)} layers kept {list(rep.layers)}, {len(rep.demoted)} "
              f"demoted {list(rep.demoted)}, top-1 agreement {rep.top1_agreement:.3f}, "
              f"max logit drift {rep.max_logit_drift:.3e}; plan {plan_line(probed)}")
        verify_built(f"{name} probed at int8_budget=0.98", probed, p0, 2, failures)
        del p0, calib0, probed
        budget = 0.0
    eng, params, imgs, plan_s, clock, prep = serve(
        graph, 16, seed=0, dev=dev, prune_density=prune_density, int8=int8,
        int8_budget=budget)
    plan = eng.plan
    if prep is not None:
        print(f"{name} pruned to {prep.density:.4f} achieved block density (target "
              f"{prune_density}): probe max logit drift {prep.max_logit_drift:.3e}, "
              f"top-1 agreement {prep.top1_agreement:.2f}")
    served_at = f" (served at int8_budget={budget})" if int8 else ""
    print(f"{name} plan ({plan_s:.2f} s){served_at}: {plan_line(plan)}")
    print(f"{name} plan counts: {plan.counts()}")
    verify_built(name, plan, params, 8, failures)
    reset_counts(wrappers)
    t_start = clock()
    wall0 = time.perf_counter()
    results = replay_stream(eng, imgs, rate_rps=1000.0)
    wall = time.perf_counter() - wall0
    launches = read_counts(wrappers)
    makespan = clock() - t_start
    stats = eng.stats()
    print(f"{name} served {len(results)} requests: launches {launches}, "
          f"{stats['batches']} batches, throughput {len(results) / makespan:.1f} req/s "
          f"(SimClock, measured service), p50={stats['p50_ms']:.2f} ms "
          f"p95={stats['p95_ms']:.2f} ms, host wall {wall:.2f} s")
    if launches[want] < 1:
        failures.append(f"{name}: {want} never launched on the served path: {launches}")
    served = np.stack([r.logits for r in sorted(results, key=lambda r: r.id)])
    batch = torch.stack(imgs)
    dense = run_graph(graph, params, batch, "dense").cpu().numpy()
    scale = float(np.abs(dense).max())
    err = float(np.abs(served - dense).max())
    if not np.all(np.isfinite(served)) or served.shape != (16, 1000):
        failures.append(f"{name}: served logits not finite or of the wrong shape")
    if int8:
        agree = float((served.argmax(-1) == dense.argmax(-1)).mean())
        print(f"{name} served logits vs the fp32 dense path: top-1 agreement "
              f"{agree:.3f}, max drift {err:.3e} (max|dense|={scale:.3e})")
        ref8 = run_plan(plan, params, batch[:8]).cpu().numpy()
        same = bool(np.array_equal(served[:8], ref8))
        print(f"{name} engine logits bitwise equal to run_plan on the same 8-bucket: "
              f"{same} (max diff {float(np.abs(served[:8] - ref8).max()):.3e})")
        if not same:
            failures.append(f"{name}: engine logits differ from run_plan on its bucket")
    else:
        ok = np.allclose(served, dense, rtol=1e-3, atol=1e-3 * scale)
        print(f"{name} engine vs dense cuDNN on the pruned weights: max_abs_err={err:.3e} "
              f"(max|dense|={scale:.3e}, rtol=1e-3, atol=1e-3*max|dense|): "
              f"{'ok' if ok else 'FAIL'}")
        if not ok:
            failures.append(f"{name}: engine logits disagree with the dense path")
    cost = verify_cost(name, plan, params, batch[:8])
    summary = {"plan": plan_line(plan), "counts": plan.counts(), "launches": launches,
               "verify": cost,
               "p50_ms": stats["p50_ms"], "p95_ms": stats["p95_ms"],
               "throughput_rps": len(results) / makespan, "max_abs_vs_dense": err,
               "max_abs_dense": scale,
               "prune_density": None if prep is None else prep.density}
    return plan, params, batch, launches, summary


def variant_kernel_checks(book, plan, params, batch, failures, name):
    """Every layer of a variant plan at its real input (batch 8): the new
    kernels checked and timed, the ECR / PECR layers checked. Rows are
    tagged with the phase."""
    from repro_torch.graph import pad2d, run_unit

    x = batch[:8]
    first = len(book.rows)
    for lp, w in zip(plan.layers, params["conv"]):
        unit = lp.to_unit()
        xp = pad2d(x, unit.conv.pad)
        try:
            if lp.impl in ("bsr", "bsr_int8"):
                check_bsr_layer(book, unit, xp, w, int8=lp.impl == "bsr_int8",
                                timed=True)
            elif lp.impl == "ecr_int8":
                check_ecr_int8_layer(book, unit, xp, w, timed=True)
            elif lp.impl in ("ecr_pallas", "pecr_pallas"):
                pool = unit.pool.p if lp.kind == "conv_pool" else 0
                check_layer_kernels(book, unit, lp.kind, xp, w, pool, timed=False)
        except Exception:
            traceback.print_exc()
            failures.append(f"{name}: kernel check failed at conv{unit.index + 1}")
        x = run_unit(x, w, unit, "conv", "dense")
    for row in book.rows[first:]:
        row["phase"] = name


OBS_BATCH = 8  # the obs phase profiles, searches and plans on 8 images


def check_geometry(book, unit, kind, impl, xp, w, tile):
    """The kernel of (kind, impl) at one searched geometry `tile` against
    its plain version on the layer's real input: fp32 within the limit,
    int8 bitwise."""
    import torch

    from repro_torch.graph.registry import unit_launch
    from repro_torch.kernels.bsr_matmul.kernel import bsr_matmul, bsr_matmul_plain
    from repro_torch.kernels.conv_pool.kernel import conv_pool_batch, conv_pool_plain
    from repro_torch.kernels.ecr_conv.kernel import ecr_conv_batch, ecr_conv_plain
    from repro_torch.kernels.ecr_conv.ops import pack_operands
    from repro_torch.kernels.tiles import resolve_block_o
    from repro_torch.quant.kernels import (
        bsr_matmul_int8,
        bsr_matmul_int8_plain,
        ecr_conv_int8_batch,
        ecr_conv_int8_plain,
    )
    from repro_torch.quant.ops import pack_bsr_int8_operands, pack_int8_operands
    from repro_torch.sparse_weights.conv import pack_bsr_operands

    stride = unit.conv.stride
    label = f"conv{unit.index + 1} tile {tuple(tile.key()) if tile else 'default'}"
    if impl in ("bsr", "bsr_int8"):
        if impl == "bsr_int8":
            h, at, sh, sa, ids, cnt, launch, _, _ = pack_bsr_int8_operands(xp, w, stride, tile)
            blk = (launch.bt, launch.bf)
            got = bsr_matmul_int8(h, at, sh, sa, ids, cnt, block=blk)
            torch.cuda.synchronize()
            book.exact("bsr_matmul_int8", label + f" bf={blk[1]}", got,
                       bsr_matmul_int8_plain(h, at, sh, sa, ids, cnt, block=blk))
        else:
            h, at, ids, cnt, launch, _, _ = pack_bsr_operands(xp, w, stride, tile)
            blk = (launch.bt, launch.bf)
            got = bsr_matmul(h, at, ids, cnt, block=blk)
            torch.cuda.synchronize()
            book.check("bsr_matmul", label + f" bf={blk[1]}", got,
                       bsr_matmul_plain(h, at, ids, cnt, block=blk))
        return
    # block_c 0 as the search runs it: the default geometry is the auto block
    launch = unit_launch(kind, impl, unit, tile=tile, block_c=0, batch=xp.shape[0])
    bc, bo = launch.block_c, resolve_block_o(unit.conv.c_out, tile.block_o)
    if impl == "ecr_int8":
        packed = pack_int8_operands(xp, w, launch)
        got = ecr_conv_int8_batch(*packed, stride=stride, block_c=bc)
        torch.cuda.synchronize()
        book.exact("ecr_conv_int8", label + f" bc={bc}", got,
                   ecr_conv_int8_plain(*packed, stride=stride, block_c=bc))
        return
    packed = pack_operands(xp, w, launch)
    if kind == "conv_pool":
        pool = unit.pool.p
        got = conv_pool_batch(*packed, stride=stride, pool=pool, block_c=bc, block_o=bo)
        torch.cuda.synchronize()
        book.check("conv_pool", label + f" bc={bc} bo={bo}", got,
                   conv_pool_plain(*packed, stride=stride, pool=pool, block_c=bc))
    else:
        got = ecr_conv_batch(*packed, stride=stride, block_c=bc, block_o=bo)
        torch.cuda.synchronize()
        book.check("ecr_conv", label + f" bc={bc} bo={bo}", got,
                   ecr_conv_plain(*packed, stride=stride, block_c=bc))


def obs_variant(name, graph, dev, wrappers, book, failures, outdir, *, prune_density):
    """The measure -> calibrate -> search -> plan loop on one VGG-19 variant
    at batch 8: profile every layer per impl, fit a CalibrationDB, search
    the tile geometry of the occupancy-rule plan's kernel layers (every
    timed geometry's kernel held against its plain version), and serve 16
    requests through an Engine planned with the DB's constants and tiles,
    traced. The counters are set to 0 before the profile and read after the
    search (every kernel must have run there), then set to 0 again just
    before serving and read just after (every kernel of the served plan
    must have run, and the plan must hold one)."""
    import numpy as np
    import torch

    from repro_torch.graph import pad2d, run_graph, run_unit
    from repro_torch.graph.registry import get_op
    from repro_torch.launch.serve_cnn import synth_requests
    from repro_torch.obs import PROFILE_IMPLS, CalibrationDB, Tracer, profile_plan, tile_search
    from repro_torch.pipeline import plan_network
    from repro_torch.serving import Engine, SimClock, replay_stream

    t_phase = time.perf_counter()
    params, _, _ = make_params(graph, seed=0, dev=dev, prune_density=prune_density)
    calib = torch.stack(synth_requests(graph, OBS_BATCH, seed=1, device=dev))
    tracer = Tracer()
    base = plan_network(params, calib, graph, occ_threshold=0.75, block_c=8)
    impls = PROFILE_IMPLS + ("ecr_int8", "bsr_int8")
    reset_counts(wrappers)
    report = profile_plan(base, params, calib, impls=impls, iters=3, warmup=1,
                          tracer=tracer)
    cols = (("dense", "dense"), ("ECR", "ecr_pallas"), ("PECR", "pecr_pallas"),
            ("BSR", "bsr"), ("ECR int8", "ecr_int8"), ("BSR int8", "bsr_int8"))
    print(f"{name} obs profile (batch {report.batch}, block_c 8, {report.device_kind}; "
          f"host wall per layer call with a synchronize, median of 3, ms):")
    layers = {}
    for idx, rows in sorted(report.layers().items()):
        by = {t.impl: t for t in rows}
        t0 = rows[0]
        cells = " ".join(f"{lab} {by[impl].measured_us / 1e3:8.3f}" if impl in by
                         else f"{lab} {'-':>8s}" for lab, impl in cols)
        print(f"  conv{idx + 1:<2d} occ {t0.occupancy:.2f} wd {t0.weight_density:.2f}: {cells}")
        layers[f"conv{idx + 1}"] = {
            "occupancy": t0.occupancy, "weight_density": t0.weight_density,
            **{impl: {"ms": t.measured_us / 1e3, "predicted_ms": t.predicted_us / 1e3,
                      "spread": t.spread} for impl, t in by.items()}}
    db = CalibrationDB.from_report(report)
    scales = {f"{k}/{i}": e.scale for (_, k, i, _), e in sorted(db.entries.items())}
    print(f"{name} calibration (scale = median predicted/measured per (kind, impl); "
          f"agreement {report.agreement()} -> {report.recalibrated(db).agreement()}):")
    for key, sc in scales.items():
        e = next(e for (_, k, i, _), e in db.entries.items() if f"{k}/{i}" == key)
        print(f"  {key:24s} scale {sc:.4e} ({e.n_samples} layers, residual spread "
              f"{e.resid_spread:.3f})")
    calibrated = plan_network(params, calib, graph, occ_threshold=0.75, block_c=8,
                              calibration=db)
    print(f"{name} plan, datasheet constants: {plan_line(base)}")
    print(f"{name} plan, calibrated:          {plan_line(calibrated)}")
    verify_built(f"{name} obs plan", base, params, OBS_BATCH, failures)
    verify_built(f"{name} obs plan, calibrated", calibrated, params, OBS_BATCH, failures)
    ts, db = tile_search(base, params, calib, db=db, calibration=db, tracer=tracer)
    measured = read_counts(wrappers)
    print(f"{name} launches in the profile and the tile search: {measured}")
    for k, n in measured.items():
        if n < 1:
            failures.append(f"{name}: {k} never launched in the profile or the tile search")
    print(f"{name} tile search: {len(ts.improved_layers())}/{len(ts.layers)} layers "
          f"improved, floor holds: {ts.floor_holds()}")
    if not ts.floor_holds():
        failures.append(f"{name}: the tile search's floor does not hold")
    x = calib
    searched = []
    for lp, unit, w in zip(base.layers, graph.units(), params["conv"]):
        r = ts.layers[unit.index]
        if get_op(lp.kind, lp.impl).pallas:
            print(f"  conv{unit.index + 1:<2d} {lp.impl:12s} default {r.default.key} "
                  f"{r.default.measured_us / 1e3:.3f} ms -> winner {r.best.key} "
                  f"{r.best.measured_us / 1e3:.3f} ms ({sum(c.timed for c in r.candidates)} "
                  f"of {len(r.candidates)} timed)")
            searched.append(r.row())
            from repro_torch.kernels.tiles import TileConfig

            xp = pad2d(x, unit.conv.pad)
            for cd in r.candidates:
                if cd.timed:
                    check_geometry(book, unit, lp.kind, lp.impl, xp, w,
                                   TileConfig.from_key(cd.key))
        x = run_unit(x, w, unit, "conv", "dense")
    imgs = synth_requests(graph, 16, seed=2, device=dev)
    clock = SimClock()
    eng = Engine(params, graph=graph, calib=calib, occ_threshold=0.75, block_c=8,
                 max_batch=8, clock=clock, tracer=tracer, calibration=db, tiles=db,
                 device=dev)
    plan = eng.plan
    print(f"{name} served plan (calibration + tiles): {plan_line(plan)}")
    verify_built(f"{name} obs plan, calibrated and tile-stamped", plan, params, 8, failures)
    moved = [f"conv{a.index + 1}: {a.impl} -> {b.impl}"
             + (f" tile {b.tile.key()}" if b.tile else "")
             for a, b in zip(base.layers, plan.layers)
             if (a.kind, a.impl) != (b.kind, b.impl) or b.tile]
    print(f"{name} moved by calibration or tile search: {moved or 'none'}")
    eng.warmup()
    reset_counts(wrappers)
    results = replay_stream(eng, imgs, rate_rps=1000.0)
    launches = read_counts(wrappers)
    print(f"{name} served {len(results)} requests through the searched plan: "
          f"launches {launches}")
    kernel_impls = {lp.impl for lp in plan.layers if get_op(lp.kind, lp.impl).pallas}
    want = {"ecr_pallas": "ecr_conv", "pecr_pallas": "conv_pool", "bsr": "bsr_matmul",
            "ecr_int8": "ecr_conv_int8", "bsr_int8": "bsr_matmul_int8"}
    if not kernel_impls:
        failures.append(f"{name}: the searched plan never reaches a CUDA kernel")
    for impl in kernel_impls:
        if launches[want[impl]] < 1:
            failures.append(f"{name}: {want[impl]} never launched on the searched plan")
    served = np.stack([r.logits for r in sorted(results, key=lambda r: r.id)])
    dense = run_graph(graph, params, torch.stack(imgs), "dense").cpu().numpy()
    scale = float(np.abs(dense).max())
    err = float(np.abs(served - dense).max())
    ok = bool(np.allclose(served, dense, rtol=1e-3, atol=1e-3 * scale)
              and np.all(np.isfinite(served)) and served.shape == (16, graph.n_classes()))
    print(f"{name} searched-plan engine vs dense cuDNN: max_abs_err={err:.3e} "
          f"(max|dense|={scale:.3e}, rtol=1e-3, atol=1e-3*max|dense|): "
          f"{'ok' if ok else 'FAIL'}")
    if not ok:
        failures.append(f"{name}: searched-plan engine logits disagree with the dense path")
    spans = sorted({e["name"] for e in tracer.events})
    if outdir is not None:
        db.save(str(outdir / f"obs_calibration_{name}.json"))
        tracer.save(str(outdir / f"obs_trace_{name}.json"))
    secs = time.perf_counter() - t_phase
    print(f"{name} obs phase: {len(tracer.events)} trace events ({', '.join(spans)}), "
          f"{secs:.1f} s")
    return {"layers": layers, "scales": scales, "agreement": report.agreement(),
            "agreement_calibrated": report.recalibrated(db).agreement(),
            "plan": plan_line(base), "plan_calibrated": plan_line(calibrated),
            "plan_served": plan_line(plan), "moved": moved, "tile_search": searched,
            "floor_holds": ts.floor_holds(), "launches_measured": measured,
            "launches": launches,
            "max_abs_vs_dense": err, "max_abs_dense": scale, "seconds": secs}


LM_ARCH = "qwen3-0.6b"
LM_SERVE = dict(batch=4, prompt_len=32, gen_len=32, seed=0)
LM_TF_STEPS = 4  # teacher-forced decode steps held against the CPU
LM_LONG = dict(b=4, sq=2048, dec_kv_len=4096, dec_s_max=4160)


def tree_to(tree, device):
    if isinstance(tree, dict):
        return {k: tree_to(v, device) for k, v in tree.items()}
    return tree.to(device)


class capture_attention:
    """Within the block, record the (q, k, v[, scales], kwargs) of the
    model's flash calls whose running index is in `keep` (cloned: the cache
    is written in place), then run the call as usual."""

    def __init__(self, keep):
        self.keep, self.calls, self.n = set(keep), {}, 0

    def __enter__(self):
        import repro_torch.models.attention as A

        self.A, self.orig = A, (A.flash_fwd, A.flash_fwd_q8)

        def wrap(fn):
            def rec(*args, **kw):
                if self.n in self.keep:
                    self.calls[self.n] = (tuple(a.clone() for a in args), dict(kw))
                self.n += 1
                return fn(*args, **kw)
            return rec

        A.flash_fwd, A.flash_fwd_q8 = wrap(self.orig[0]), wrap(self.orig[1])
        return self

    def __exit__(self, *exc):
        self.A.flash_fwd, self.A.flash_fwd_q8 = self.orig


class pin_quantization:
    """The int8 cache's rounding, pinned. Mode "record" (the card's run) keeps
    each `_quantize_kv` result in call order; mode "replay" (the host's run)
    quantizes its own K/V, holds the result to the card's (values within one
    step, scales within 1e-5 relative: an fp32 difference of 1e-7 moves a
    value sitting on a rounding boundary by one step) and hands on the
    card's values, so the host attends over the cache the card attended
    over."""

    def __init__(self, mode, recorded=None):
        self.mode, self.recorded = mode, recorded if recorded is not None else []
        self.i, self.moved, self.total, self.worst_step, self.worst_scale = 0, 0, 0, 0, 0.0

    def __enter__(self):
        import repro_torch.models.attention as A

        self.A, self.orig = A, A._quantize_kv

        def quantize(x):
            q, sc = self.orig(x)
            if self.mode == "record":
                self.recorded.append((q.cpu(), sc.cpu()))
                return q, sc
            qc, scc = self.recorded[self.i]
            self.i += 1
            step = (q.int() - qc.int()).abs()
            self.moved += int((step > 0).sum())
            self.total += q.numel()
            self.worst_step = max(self.worst_step, int(step.max()))
            self.worst_scale = max(self.worst_scale,
                                   float(((sc - scc).abs() / scc.abs()).max()))
            return qc.to(q.device), scc.to(sc.device)

        A._quantize_kv = quantize
        return self

    def __exit__(self, *exc):
        self.A._quantize_kv = self.orig


def teacher_forced(cfg, params, prompt, follow, kv_dtype, dev, max_len):
    """Prefill the prompt, then decode the `follow` tokens one by one:
    [prefill logits (B,S,V)] + one (B,1,V) per step, on the host."""
    import torch

    from repro_torch.models import model as M

    dt = torch.int8 if kv_dtype == "int8" else torch.float32
    cache = M.init_cache(cfg, prompt.shape[0], max_len, dt, device=dev)
    out = []
    with torch.no_grad():
        lg, cache = M.prefill(cfg, params, cache, {"tokens": prompt.to(dev)})
        out.append(lg.cpu())
        for t in range(follow.shape[1]):
            lg, cache = M.decode_step(cfg, params, cache,
                                      {"tokens": follow[:, t:t + 1].to(dev)},
                                      prompt.shape[1] + t)
            out.append(lg.cpu())
    return out


def visible_pairs(sq, sk, causal, q_offset, kv_len):
    """(visible q.k pairs per head, keys any row reads) under the masks."""
    lim = sk if kv_len is None else max(0, min(sk, kv_len))
    per_row = [lim if not causal else max(0, min(lim, q_offset + s + 1))
               for s in range(sq)]
    return sum(per_row), max(per_row)


def flash_bound(q, k, kw, *, q8):
    """(op time, byte time) in ms: 4 * B * H * pairs * D fp32 operations
    (q.k and p.v) at the rate of the kernels' arithmetic (split-TF32, 165
    TFLOP/s); K/V of the keys read (4 bytes, or 1 byte plus the fp32
    scales), Q and O once, and m and l (fp32 kernel) over 3.35 TB/s."""
    b, sq, kvh, g, d = q.shape
    sk = k.shape[1]
    pairs, keys = visible_pairs(sq, sk, kw["causal"], kw["q_offset"], kw["kv_len"])
    ops = 4.0 * b * kvh * g * pairs * d
    kv_bytes = 2.0 * b * kvh * keys * (d * 1 + 4 if q8 else d * 4)
    nbytes = kv_bytes + 8.0 * b * kvh * g * sq * d + (0 if q8 else 8.0 * b * kvh * g * sq)
    return ops / PEAK_TF32_SPLIT_FLOPS * 1e3, nbytes / PEAK_HBM_BYTES * 1e3


def attention_mask(sq, sk, kw, device):
    """The kernels' causal / q_offset / kv_len mask as a boolean (Sq, Sk)."""
    import torch

    qpos = kw["q_offset"] + torch.arange(sq, device=device)
    kpos = torch.arange(sk, device=device)
    mask = torch.ones((sq, sk), dtype=torch.bool, device=device)
    if kw["causal"]:
        mask &= qpos[:, None] >= kpos[None, :]
    if kw["kv_len"] is not None:
        mask &= (kpos < kw["kv_len"])[None, :]
    return mask


def flash_library(q, k, v, kw, ks=None, vs=None):
    """F.scaled_dot_product_attention on the same inputs: q to (B,H,Sq,D),
    K/V expanded to the H query heads (outside the call for fp32; for int8
    the dequantize and the expansion are inside it), the same boolean mask."""
    import torch.nn.functional as F

    b, sq, kvh, g, d = q.shape
    qh = q.reshape(b, sq, kvh * g, d).transpose(1, 2)
    mask = attention_mask(sq, k.shape[1], kw, q.device)

    def heads(x):
        return x.repeat_interleave(g, dim=2).transpose(1, 2)

    if ks is None:
        kh, vh = heads(k), heads(v)
        return lambda: F.scaled_dot_product_attention(qh, kh, vh, attn_mask=mask,
                                                      scale=kw["scale"])
    return lambda: F.scaled_dot_product_attention(
        qh, heads(k.float() * ks[..., None]), heads(v.float() * vs[..., None]),
        attn_mask=mask, scale=kw["scale"])


def check_flash(book, label, args, kw, *, timed):
    """A flash kernel against its plain version (out, and m, l for fp32) on
    model-layout operands; when `timed`, kernel / plain / library times and
    the bound. Returns the timing row or None."""
    import torch

    from repro_torch.kernels.flash_attention.kernel import (
        flash_fwd,
        flash_fwd_plain,
        flash_fwd_q8,
        flash_fwd_q8_plain,
    )

    q8 = len(args) == 5
    name = "flash_fwd_q8" if q8 else "flash_fwd"
    kernel = (lambda: flash_fwd_q8(*args, **kw)) if q8 else (lambda: flash_fwd(*args, **kw))
    plain = (lambda: flash_fwd_q8_plain(*args, **kw)) if q8 else \
        (lambda: flash_fwd_plain(*args, **kw))
    got = kernel()
    torch.cuda.synchronize()
    want = plain()
    tag = (f"{label} q{tuple(args[0].shape)} k{tuple(args[1].shape)} "
           f"q_offset={kw['q_offset']} kv_len={kw['kv_len']}")
    if q8:
        book.check(name, tag, got, want)
    else:
        for part, g_, w_ in zip(("out", "m", "l"), got, want):
            book.check(name, f"{tag} {part}", g_, w_)
    if not timed:
        return None
    lib = flash_library(*args[:3], kw, *(args[3:] if q8 else ()))
    lib_out = lib()
    got_out = got if q8 else got[0]
    b, sq, kvh, g, d = args[0].shape
    lib_err = float((lib_out.transpose(1, 2).reshape(got_out.shape) - got_out).abs().max())
    fns = {"kernel": kernel, "plain": plain, "library": lib}
    t = time_graph_turns(fns)
    te = time_turns(fns)
    ft, bt = flash_bound(args[0], args[1], kw, q8=q8)
    row = {"kernel": name, "shape": label, "q": list(args[0].shape),
           "k": list(args[1].shape), "q_offset": kw["q_offset"], "kv_len": kw["kv_len"],
           "ms": t["kernel"], "plain_ms": t["plain"], "library_ms": t["library"],
           "eager_ms": te["kernel"], "eager_plain_ms": te["plain"],
           "eager_library_ms": te["library"],
           "flop_ms": ft, "byte_ms": bt, "bound_ms": max(ft, bt),
           "bound_by": "operations" if ft >= bt else "bytes",
           "library_max_abs_diff": lib_err, "phase": LM_ARCH}
    book.rows.append(row)
    print(f"    {name} {label}: ms={t['kernel']:.4f} plain_ms={t['plain']:.4f} "
          f"library_ms={t['library']:.4f} bound_ms={max(ft, bt):.4f} "
          f"({row['bound_by']}) [CUDA-graph replay]; eager calls: "
          f"{te['kernel']:.4f} / {te['plain']:.4f} / {te['library']:.4f} ms; "
          f"|kernel - SDPA| {lib_err:.2e}")
    return row


def lm_phase(book, dev, failures) -> dict:
    """Full-width qwen3-0.6b served through the port (fp32 and int8 cache):
    counters, teacher-forced logits against the CPU, the flash kernels at the
    served, long and edge shapes, and a trace of prefill and decode."""
    import numpy as np
    import torch

    from repro_torch.configs.base import get_config
    from repro_torch.kernels.flash_attention.kernel import flash_fwd, flash_fwd_q8
    from repro_torch.launch.serve import serve
    from repro_torch.models import model as M
    from repro_torch.models.attention import _quantize_kv

    cfg = get_config(LM_ARCH)
    wrappers = {"flash_fwd": flash_fwd, "flash_fwd_q8": flash_fwd_q8}
    max_len = LM_SERVE["prompt_len"] + LM_SERVE["gen_len"]
    expect = cfg.n_layers * LM_SERVE["gen_len"]  # prefill + gen_len - 1 steps
    summary = {"runs": {}}
    served = {}
    for kvd, want in (("float32", "flash_fwd"), ("int8", "flash_fwd_q8")):
        # warm-up: cuBLAS handles and first launches stay out of the timed run
        serve(LM_ARCH, reduced=False, device=dev, kv_cache_dtype=kvd,
              **dict(LM_SERVE, gen_len=2))
        reset_counts(wrappers)
        res = serve(LM_ARCH, reduced=False, device=dev, kv_cache_dtype=kvd, **LM_SERVE)
        launches = read_counts(wrappers)
        served[kvd] = res
        print(f"{LM_ARCH} served ({kvd} KV cache): batch {LM_SERVE['batch']}, prompt "
              f"{LM_SERVE['prompt_len']}, {LM_SERVE['gen_len']} tokens: prefill "
              f"{res.prefill_ms:.2f} ms, decode {res.decode_ms:.3f} ms/step, "
              f"{res.tok_s:.1f} tok/s; launches {launches} (expected {expect} of {want})")
        other = "flash_fwd_q8" if want == "flash_fwd" else "flash_fwd"
        if launches[want] != expect or launches[other] != 0:
            failures.append(f"{LM_ARCH} {kvd}: launches {launches}, expected {expect} "
                            f"of {want} and none of {other}")
        toks = res.tokens.cpu()
        if toks.shape != (LM_SERVE["batch"], LM_SERVE["gen_len"]) or not bool(
                ((toks >= 0) & (toks < cfg.vocab_size)).all()):
            failures.append(f"{LM_ARCH} {kvd}: served tokens malformed")
        summary["runs"][kvd] = {"prefill_ms": res.prefill_ms, "decode_ms": res.decode_ms,
                                "tok_s": res.tok_s, "launches": launches}

    # the weights serve drew (host generator, seed 0), on the card and the host
    params = M.init_params(cfg, torch.Generator().manual_seed(LM_SERVE["seed"]), device=dev)
    params_cpu = tree_to(params, "cpu")
    n_layers = cfg.n_layers
    keep = (0, n_layers - 1, n_layers, 2 * n_layers - 1)  # prefill / first decode step
    card_logits, captured = {}, {}
    for kvd, res in served.items():
        prompt, follow = res.prompt.cpu(), res.tokens.cpu()[:, :LM_TF_STEPS]
        with capture_attention(keep) as cap, pin_quantization("record") as rec:
            card = teacher_forced(cfg, params, prompt, follow, kvd, dev, max_len)
        captured[kvd] = cap.calls
        card_logits[kvd] = card
        host = teacher_forced(cfg, params_cpu, prompt, follow, kvd, "cpu", max_len)
        pinned = None
        if kvd == "int8":
            # each side's own rounding (reported), then the host on the card's values
            raw = max(float((c - h).abs().max()) for c, h in zip(card, host))
            with pin_quantization("replay", rec.recorded) as pinned:
                host = teacher_forced(cfg, params_cpu, prompt, follow, kvd, "cpu", max_len)
            q_ok = pinned.worst_step <= 1 and pinned.worst_scale <= 1e-5
            print(f"{LM_ARCH} int8 host vs card quantization of the cache: "
                  f"{pinned.moved} of {pinned.total} values one step apart "
                  f"(max step {pinned.worst_step}, limit 1), scales within "
                  f"{pinned.worst_scale:.2e} relative (limit 1e-5): "
                  f"{'ok' if q_ok else 'FAIL'}; logits on each side's own "
                  f"rounding differ by up to {raw:.3e}")
            if not q_ok:
                failures.append(f"{LM_ARCH} int8: host and card quantize the cache apart")
            summary["runs"][kvd].update(
                quant_values_moved=pinned.moved, quant_values=pinned.total,
                quant_worst_step=pinned.worst_step, quant_worst_scale=pinned.worst_scale,
                max_abs_unpinned=raw)
        worst, ok = 0.0, True
        for c, h in zip(card, host):
            c, h = c.numpy(), h.numpy()
            scale = float(np.abs(h).max())
            worst = max(worst, float(np.abs(c - h).max()))
            ok &= bool(np.all(np.isfinite(c))) and np.allclose(c, h, rtol=1e-3,
                                                               atol=1e-3 * scale)
        greedy = torch.stack([card[0][:, -1].argmax(-1)] + [
            lg[:, 0].argmax(-1) for lg in card[1:LM_TF_STEPS]], 1).to(torch.int32)
        same = bool(torch.equal(greedy, follow))
        on = " (host on the card's int8 cache values)" if pinned is not None else ""
        print(f"{LM_ARCH} {kvd} card vs host plain path{on}, teacher-forced prefill + "
              f"{LM_TF_STEPS} decode steps: max_abs_err={worst:.3e} (max|host|="
              f"{max(float(h.abs().max()) for h in host):.3e}, rtol=1e-3, "
              f"atol=1e-3*max|host|): {'ok' if ok else 'FAIL'}; served tokens are "
              f"the card's argmax: {same}")
        if not ok:
            failures.append(f"{LM_ARCH} {kvd}: card logits disagree with the host")
        if not same:
            failures.append(f"{LM_ARCH} {kvd}: served tokens are not the greedy argmax")
        summary["runs"][kvd]["max_abs_vs_host"] = worst
    agree = [float((a.argmax(-1) == b.argmax(-1)).float().mean())
             for a, b in zip(card_logits["int8"], card_logits["float32"])]
    drift = max(float((a - b).abs().max())
                for a, b in zip(card_logits["int8"], card_logits["float32"]))
    print(f"{LM_ARCH} int8 cache vs fp32 cache logits (card, teacher-forced): top-1 "
          f"agreement {np.mean(agree):.3f} (per step {['%.3f' % a for a in agree]}), "
          f"max drift {drift:.3e}")
    summary["int8_vs_fp32"] = {"top1_agreement": float(np.mean(agree)), "max_drift": drift}

    # ---- the flash kernels at the served, long and edge shapes -------------
    print(f"{LM_ARCH} flash kernel checks (both kernels at the fp32 limit, "
          f"{KERNEL_TOL.split(';')[0]}):")
    for kvd, calls in captured.items():
        for idx in keep:
            if idx not in calls:
                failures.append(f"{LM_ARCH} {kvd}: attention call {idx} not captured")
                continue
            args, kw = calls[idx]
            layer = idx % n_layers
            label = f"{'prefill' if idx < n_layers else 'decode'} layer {layer}"
            check_flash(book, label, args, kw, timed=(layer == 0))
    gen = torch.Generator(device=dev).manual_seed(5)
    kvh, g, d = cfg.n_kv_heads, cfg.n_heads // cfg.n_kv_heads, cfg.resolved_head_dim
    b, sq = LM_LONG["b"], LM_LONG["sq"]
    q = torch.randn((b, sq, kvh, g, d), generator=gen, device=dev)
    k = torch.randn((b, sq, kvh, d), generator=gen, device=dev)
    v = torch.randn((b, sq, kvh, d), generator=gen, device=dev)
    sc = d ** -0.5
    longs = [("long prefill", (q, k, v), dict(scale=sc, causal=True, q_offset=0, kv_len=None))]
    kl, smax = LM_LONG["dec_kv_len"], LM_LONG["dec_s_max"]
    qd = torch.randn((b, 1, kvh, g, d), generator=gen, device=dev)
    kd = torch.randn((b, smax, kvh, d), generator=gen, device=dev)
    vd = torch.randn((b, smax, kvh, d), generator=gen, device=dev)
    longs.append(("long decode", (qd, kd, vd),
                  dict(scale=sc, causal=True, q_offset=kl - 1, kv_len=kl)))
    for label, (qq, kk, vv), kw in longs:
        check_flash(book, label, (qq, kk, vv), kw, timed=True)
        kq, ks = _quantize_kv(kk)
        vq, vs = _quantize_kv(vv)
        check_flash(book, label, (qq, kq, vq, ks, vs), kw, timed=True)
    del q, k, v, kd, vd
    # edge shapes: ragged Sq/Sk, kv_len < Sk, q_offset > 0, Sq = 1, a fully
    # masked block, G = 3; decode at the fp32 kernel's tile edges (G of a
    # 16-row tile live, kv_len at one key, one short of and one past a
    # 64-key cache read at Sk = 80)
    edges = [  # (b, sq, kvh, g, sk, d, causal, q_offset, kv_len)
        (3, 37, 2, 2, 53, 128, False, 0, None),
        (3, 37, 2, 2, 53, 128, True, 16, None),
        (2, 100, 1, 3, 300, 64, True, 200, 290),
        (2, 1, 8, 2, 130, 128, True, 99, 100),
        (2, 8, 2, 2, 32, 128, False, 0, 0),
    ]
    edges += [(4, 1, 8, eg, 80, 128, True, kvl - 1, kvl)
              for eg in (1, 2, 4, 8) for kvl in (1, 63, 65)]
    for eb, esq, ekv, eg, esk, ed, causal, qo, kvl in edges:
        qq = torch.randn((eb, esq, ekv, eg, ed), generator=gen, device=dev)
        kk = torch.randn((eb, esk, ekv, ed), generator=gen, device=dev)
        vv = torch.randn((eb, esk, ekv, ed), generator=gen, device=dev)
        kw = dict(scale=ed ** -0.5, causal=causal, q_offset=qo, kv_len=kvl)
        check_flash(book, "edge", (qq, kk, vv), kw, timed=False)
        kq, ks = _quantize_kv(kk)
        vq, vs = _quantize_kv(vv)
        check_flash(book, "edge", (qq, kq, vq, ks, vs), kw, timed=False)
    # q and k spread over 2^+-3 at D = 128 (scores up to about 70), where one
    # TF32 product per multiply-add misses the fp32 limit
    qq = torch.randn((4, 32, kvh, g, d), generator=gen, device=dev)
    kk = torch.randn((4, 64, kvh, d), generator=gen, device=dev)
    vv = torch.randn((4, 64, kvh, d), generator=gen, device=dev)
    qq = qq * torch.exp2(torch.randint(-3, 4, qq.shape, generator=gen, device=dev).float())
    kk = kk * torch.exp2(torch.randint(-3, 4, kk.shape, generator=gen, device=dev).float())
    check_flash(book, "q and k over 2^+-3", (qq, kk, vv),
                dict(scale=d ** -0.5, causal=True, q_offset=0, kv_len=32), timed=False)

    # ---- where the time goes: one prefill and one decode step, warm --------
    summary["service"] = {}
    for kvd in ("float32", "int8"):
        dt = torch.int8 if kvd == "int8" else torch.float32
        cache = M.init_cache(cfg, LM_SERVE["batch"], max_len, dt, device=dev)
        prompt = served[kvd].prompt
        nxt = served[kvd].tokens[:, :1]

        def prefill():
            with torch.no_grad():
                return M.prefill(cfg, params, cache, {"tokens": prompt})

        def decode():
            with torch.no_grad():
                return M.decode_step(cfg, params, cache, {"tokens": nxt},
                                     LM_SERVE["prompt_len"])

        for step, fn in (("prefill", prefill), ("decode", decode)):
            br = trace_breakdown(fn)
            summary["service"][f"{kvd} {step}"] = br
            print(f"{LM_ARCH} {kvd} warm {step}: wall {br['wall_ms']:.3f} ms (median of 5), "
                  f"device {br['device_ms']:.3f} ms in {br['device_ops']} device ops, "
                  f"idle share {br['idle_share']}")
            for cat, ms in sorted(br["by_class_ms"].items(), key=lambda kv: -kv[1]):
                print(f"  {ms:8.3f} ms  {cat}")
    del params, params_cpu
    torch.cuda.empty_cache()
    return summary


LM_TRAIN = dict(steps=6, global_batch=8, seq_len=128, seed=0)
LM_TRAIN_HOST_BATCH = 2  # the host's gradient check, batch cut for its sake
LM_RESTART = dict(steps=10, global_batch=2, seq_len=32, checkpoint_every=3, fail_at=(7,))


class capture_backward:
    """Within the block, record (q, k, v, out, m, l, do, kwargs) of the
    attention backward calls (`FlashAttentionFn.backward`'s `flash_bwd`)
    whose running index is in `keep`, cloned, then run the call as usual.
    The backward visits the layers last to first: index 0 is the last
    layer."""

    def __init__(self, keep):
        self.keep, self.calls, self.n = set(keep), {}, 0

    def __enter__(self):
        import repro_torch.kernels.flash_attention.ops as O

        self.O, self.orig = O, O.flash_bwd

        def rec(*args, **kw):
            if self.n in self.keep:
                self.calls[self.n] = (tuple(a.detach().clone() for a in args), dict(kw))
            self.n += 1
            return self.orig(*args, **kw)

        O.flash_bwd = rec
        return self

    def __exit__(self, *exc):
        self.O.flash_bwd = self.orig


def flash_bwd_bound(q, k, kw, *, part, peak=PEAK_TF32_SPLIT_FLOPS):
    """(op time, byte time) in ms of one backward pass for these inputs:
    per visible (q, k) pair and head-dim element 6 fp32 operations for dq
    (scores, dp, ds.k) and 8 for dk/dv (scores, dp, p^T.do, ds^T.q), at
    `peak` (the kernels' split-TF32 rate, 165 TFLOP/s; 67 for the CUDA
    cores); q, do, k, v of the keys read, m, l, delta read, and dq, or dk
    and dv, written once, over 3.35 TB/s."""
    b, sq, kvh, g, d = q.shape
    sk = k.shape[1]
    pairs, keys = visible_pairs(sq, sk, kw["causal"], kw["q_offset"], kw["kv_len"])
    per = 6.0 if part == "dq" else 8.0
    ops = per * b * kvh * g * pairs * d
    rows = b * kvh * g * sq
    qbytes = 4.0 * rows * d
    kbytes = 4.0 * b * kvh * keys * d
    nbytes = 2 * qbytes + 2 * kbytes + 12.0 * rows + (qbytes if part == "dq" else 2 * kbytes)
    return ops / peak * 1e3, nbytes / PEAK_HBM_BYTES * 1e3


def sdpa_backward(q, k, v, do, kw):
    """The backward of fp32 F.scaled_dot_product_attention on the same
    inputs (K/V expanded to the query heads, the same mask): two closures
    that compute its three gradients, the autograd backward of the SDPA call
    (eager only: it runs on the forward's stream) and the memory-efficient
    attention backward op, SDPA's fused backend for fp32 inputs with a mask,
    fed by that op's own forward (capturable in a CUDA graph; the caller
    prints how far its dq lies from the autograd call's)."""
    import torch
    import torch.nn.functional as F

    b, sq, kvh, g, d = q.shape
    sk = k.shape[1]
    qh = q.reshape(b, sq, kvh * g, d).transpose(1, 2).detach().requires_grad_(True)
    kh = k.repeat_interleave(g, dim=2).transpose(1, 2).detach().requires_grad_(True)
    vh = v.repeat_interleave(g, dim=2).transpose(1, 2).detach().requires_grad_(True)
    mask = attention_mask(sq, sk, kw, q.device)
    out = F.scaled_dot_product_attention(qh, kh, vh, attn_mask=mask, scale=kw["scale"])
    doh = do.reshape(b, sq, kvh * g, d).transpose(1, 2)
    bias = torch.zeros((sq, sk), device=q.device).masked_fill(~mask, float("-inf"))
    bias = bias.expand(b, kvh * g, sq, sk)
    aten = torch.ops.aten
    o, lse, seed, offset = aten._scaled_dot_product_efficient_attention(
        qh.detach(), kh.detach(), vh.detach(), bias, True, 0.0, False, scale=kw["scale"])
    return (lambda: torch.autograd.grad(out, (qh, kh, vh), doh, retain_graph=True),
            lambda: aten._scaled_dot_product_efficient_attention_backward(
                doh, qh.detach(), kh.detach(), vh.detach(), bias, o, lse, seed, offset, 0.0,
                [True, True, True, False], False, scale=kw["scale"])[:3])


def check_flash_bwd(book, label, args, kw, *, timed):
    """Both backward kernels against their plain versions (dq; dk and dv) on
    model-layout operands (q, k, v, out, m, l, do); when `timed`, kernel /
    plain / library times and the bound of each pass. Returns the rows."""
    import torch

    from repro_torch.kernels.flash_attention.kernel import (
        flash_bwd_dkv,
        flash_bwd_dkv_plain,
        flash_bwd_dq,
        flash_bwd_dq_plain,
        flash_delta,
    )

    q, k, v, out, m, l, do = args
    delta = flash_delta(do, out)
    ops = (q, k, v, do, m, l, delta)
    dq = flash_bwd_dq(*ops, **kw)
    dk, dv = flash_bwd_dkv(*ops, **kw)
    torch.cuda.synchronize()
    pdq = flash_bwd_dq_plain(*ops, **kw)
    pdk, pdv = flash_bwd_dkv_plain(*ops, **kw)
    tag = (f"{label} q{tuple(q.shape)} k{tuple(k.shape)} q_offset={kw['q_offset']} "
           f"kv_len={kw['kv_len']} causal={kw['causal']}")
    book.check("flash_bwd_dq", f"{tag} dq", dq, pdq)
    book.check("flash_bwd_dkv", f"{tag} dk", dk, pdk)
    book.check("flash_bwd_dkv", f"{tag} dv", dv, pdv)
    if not timed:
        return []
    lib_autograd, lib = sdpa_backward(q, k, v, do, kw)
    gq = lib()[0]
    lib_err = float((gq.transpose(1, 2).reshape(q.shape) - dq).abs().max())
    lib_gap = float((lib_autograd()[0] - gq).abs().max())
    del gq
    fns = {"dq": lambda: flash_bwd_dq(*ops, **kw), "dkv": lambda: flash_bwd_dkv(*ops, **kw),
           "dq_plain": lambda: flash_bwd_dq_plain(*ops, **kw),
           "dkv_plain": lambda: flash_bwd_dkv_plain(*ops, **kw), "library": lib}
    t = time_graph_turns(fns)
    te = time_turns({**fns, "library": lib_autograd})
    rows = []
    for part, name in (("dq", "flash_bwd_dq"), ("dkv", "flash_bwd_dkv")):
        ft, bt = flash_bwd_bound(q, k, kw, part=part)
        fc, _ = flash_bwd_bound(q, k, kw, part=part, peak=PEAK_FP32_FLOPS)
        row = {"kernel": name, "shape": label, "q": list(q.shape), "k": list(k.shape),
               "q_offset": kw["q_offset"], "kv_len": kw["kv_len"], "ms": t[part],
               "plain_ms": t[part + "_plain"], "library_ms": t["library"],
               "eager_ms": te[part], "eager_plain_ms": te[part + "_plain"],
               "eager_library_ms": te["library"],
               "flop_ms": ft, "byte_ms": bt, "bound_ms": max(ft, bt),
               "bound_by": "operations" if ft >= bt else "bytes",
               "fp32_core_bound_ms": max(fc, bt),
               "library_max_abs_diff_dq": lib_err, "phase": LM_ARCH + "-train"}
        book.rows.append(row)
        rows.append(row)
        print(f"    {name} {label}: ms={t[part]:.4f} plain_ms={t[part + '_plain']:.4f} "
              f"library_ms={t['library']:.4f} (SDPA backward, all three gradients) "
              f"bound_ms={max(ft, bt):.4f} ({row['bound_by']}; CUDA cores "
              f"{max(fc, bt):.4f}) [CUDA-graph replay]; eager calls: {te[part]:.4f} / "
              f"{te[part + '_plain']:.4f} / {te['library']:.4f} ms (library: autograd SDPA)")
    print(f"    dq + dk/dv {t['dq'] + t['dkv']:.4f} ms against SDPA's backward "
          f"{t['library']:.4f} ms [CUDA-graph replay]; |dq - SDPA dq| {lib_err:.2e}; "
          f"efficient-attention op vs autograd SDPA dq {lib_gap:.2e}")
    return rows


def train_phase(book, dev, failures) -> dict:
    """Full-width qwen3-0.6b trained through `repro_torch.launch.train.train`:
    launch counters per step, one step's gradients against the host's plain
    path, the backward kernels at the trained, long and edge shapes, a trace
    of one warm step, the final checkpoint's save time, and restart equality
    at the reduced config."""
    import shutil
    import tempfile

    import numpy as np
    import torch

    from repro_torch.checkpoint import CheckpointManager
    from repro_torch.configs.base import DEFAULT_RUN, get_config
    from repro_torch.data import make_pipeline
    from repro_torch.kernels.cuda import FLASH_HEAD_DIMS
    from repro_torch.kernels.flash_attention.kernel import (
        flash_bwd,
        flash_bwd_dkv,
        flash_bwd_dq,
        flash_fwd,
    )
    from repro_torch.launch.steps import loss_and_grads, make_train_step, to_device
    from repro_torch.launch.train import train
    from repro_torch.models import model as M
    from repro_torch.optim import global_norm
    from repro_torch.tree import tree_leaves, tree_paths

    cfg = get_config(LM_ARCH)
    n_layers, steps = cfg.n_layers, LM_TRAIN["steps"]
    gb, sl = LM_TRAIN["global_batch"], LM_TRAIN["seq_len"]
    wrappers = {"flash_fwd": flash_fwd, "flash_bwd": flash_bwd,
                "flash_bwd_dq": flash_bwd_dq, "flash_bwd_dkv": flash_bwd_dkv}
    expect = {"flash_fwd": 2 * n_layers * steps, "flash_bwd": n_layers * steps,
              "flash_bwd_dq": n_layers * steps, "flash_bwd_dkv": n_layers * steps}
    summary = {}
    tmp = Path(tempfile.mkdtemp(prefix="repro_torch_train_"))
    try:
        # ---- the main run: train() at the reference launcher's defaults ----
        reset_counts(wrappers)
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        state, hist = train(LM_ARCH, reduced=False, steps=steps, global_batch=gb,
                            seq_len=sl, ckpt_dir=str(tmp / "main"),
                            checkpoint_every=10 * steps, resume=False,
                            seed=LM_TRAIN["seed"], device=dev)
        wall = time.perf_counter() - t0
        launches = read_counts(wrappers)
        peak_gb = torch.cuda.max_memory_allocated() / 1e9
        for h in hist:
            print(f"{LM_ARCH} train step {h['step']}: loss {h['loss']:.5f} grad_norm "
                  f"{h['grad_norm']:.5f} lr {h['lr']:.3e} step {h['step_ms']:.1f} ms "
                  f"(synchronised) {gb * sl / h['step_ms'] * 1e3:.0f} tok/s")
        per_step = {k: v / max(len(hist), 1) for k, v in launches.items()}
        print(f"{LM_ARCH} trained {len(hist)} steps (batch {gb} x {sl}, remat full, "
              f"fp32) in {wall:.2f} s with set-up and the final checkpoint; launches "
              f"{launches} = {per_step} per step (expected {expect}); peak device "
              f"memory {peak_gb:.2f} GB")
        if launches != expect:
            failures.append(f"{LM_ARCH} train: launches {launches}, expected {expect}")
        if len(hist) != steps or not all(np.isfinite(h["loss"]) and np.isfinite(
                h["grad_norm"]) for h in hist):
            failures.append(f"{LM_ARCH} train: history malformed or not finite")
        warm = hist[1:]
        summary["main"] = {
            "history": hist, "launches": launches, "wall_s": wall, "peak_gb": peak_gb,
            "step_ms_warm_median": sorted(h["step_ms"] for h in warm)[len(warm) // 2],
            "tok_s_warm": gb * sl * len(warm) / sum(h["step_ms"] for h in warm) * 1e3}

        # ---- the final checkpoint's size and save time ----------------------
        ck = CheckpointManager(tmp / "save", keep=1)
        nbytes = sum(t.numel() * t.element_size() for t in
                     tree_leaves(state.params) + tree_leaves(state.opt.m)
                     + tree_leaves(state.opt.v))
        t0 = time.perf_counter()
        ck.save(steps, state, extra={"step": steps}, block=True)
        save_s = time.perf_counter() - t0
        ck.close()
        print(f"{LM_ARCH} checkpoint of params + m + v ({nbytes / 1e9:.2f} GB): "
              f"save {save_s:.2f} s (host copy + npz write + atomic commit)")
        summary["save"] = {"bytes": nbytes, "save_s": save_s}
        shutil.rmtree(tmp / "save", ignore_errors=True)

        # ---- where the time goes: one warm train step ----------------------
        run = DEFAULT_RUN.replace(remat="full", param_dtype="float32")
        step_fn = make_train_step(cfg, run, steps, device=dev)
        batch0 = make_pipeline(cfg, sl, gb, seed=LM_TRAIN["seed"]).batch_at(0)
        br = trace_breakdown(lambda: step_fn(state, batch0), {"batch": gb, "seq": sl})
        summary["service"] = br
        print(f"{LM_ARCH} warm train step: wall {br['wall_ms']:.3f} ms (median of 5), "
              f"device {br['device_ms']:.3f} ms in {br['device_ops']} device ops, "
              f"idle share {br['idle_share']}")
        for cat, ms in sorted(br["by_class_ms"].items(), key=lambda kv: -kv[1]):
            print(f"  {ms:8.3f} ms  {cat}")
        del state, step_fn
        torch.cuda.empty_cache()

        # ---- one step's gradients, card against the host's plain path ------
        params = M.init_params(cfg, torch.Generator().manual_seed(LM_TRAIN["seed"]),
                               device=dev)
        keep = (0, n_layers - 1)  # backward order: layer 27, then layer 0
        with capture_backward(keep) as cap:
            loss_and_grads(cfg, run, params, to_device(batch0, dev))
        hb = {k: v[:LM_TRAIN_HOST_BATCH] for k, v in batch0.items()}
        loss_c, grads_c = loss_and_grads(cfg, run, params, to_device(hb, dev))
        params_cpu = tree_to(params, "cpu")
        del params
        grads_c = tree_to(grads_c, "cpu")
        t0 = time.perf_counter()
        loss_h, grads_h = loss_and_grads(cfg, run.replace(remat="none"), params_cpu,
                                         to_device(hb, "cpu"))
        host_s = time.perf_counter() - t0
        lc, lh = float(loss_c), float(loss_h)
        nc, nh = float(global_norm(grads_c)), float(global_norm(grads_h))
        worst, zero_layers, ok_leaves = 0.0, [], True
        for (path_c, gc), gh in zip(tree_paths(grads_c), tree_leaves(grads_h)):
            scale = float(gh.abs().max())
            err = float((gc - gh).abs().max())
            worst = max(worst, err / scale if scale else err)
            ok_leaves &= err <= 1e-3 * scale
            per_layer = gc.reshape(gc.shape[0], -1) if path_c.startswith("groups") else \
                gc.reshape(1, -1)
            zero_layers += [f"{path_c}[{i}]" for i in range(per_layer.shape[0])
                            if not bool(per_layer[i].abs().max() > 0)]
        ok_loss = abs(lc - lh) <= 1e-4 * abs(lh)
        ok_norm = abs(nc - nh) <= 1e-3 * nh
        print(f"{LM_ARCH} one step's gradients, card vs host plain path (batch "
              f"{LM_TRAIN_HOST_BATCH} x {sl}; host {host_s:.1f} s): loss {lc:.6f} vs "
              f"{lh:.6f} ({'ok' if ok_loss else 'FAIL'}, 1e-4 rel), grad norm {nc:.6f} "
              f"vs {nh:.6f} ({'ok' if ok_norm else 'FAIL'}, 1e-3 rel), worst leaf "
              f"max|card - host| / max|host| = {worst:.2e} ({'ok' if ok_leaves else 'FAIL'},"
              f" 1e-3); leaves (per layer) with a zero gradient on the card: "
              f"{zero_layers or 'none'}")
        if not (ok_loss and ok_norm and ok_leaves):
            failures.append(f"{LM_ARCH} train: card gradients disagree with the host")
        if zero_layers:
            failures.append(f"{LM_ARCH} train: zero gradients on the card: {zero_layers}")
        summary["grads_vs_host"] = {"loss": [lc, lh], "grad_norm": [nc, nh],
                                    "worst_leaf_rel": worst, "zero": zero_layers,
                                    "host_s": host_s}
        del params_cpu, grads_c, grads_h
        torch.cuda.empty_cache()

        # ---- the backward kernels: trained, long and edge shapes -----------
        print(f"{LM_ARCH} flash backward kernel checks ({KERNEL_TOL.split(';')[0]}):")
        for idx in keep:
            if idx not in cap.calls:
                failures.append(f"{LM_ARCH} train: backward call {idx} not captured")
                continue
            args, kw = cap.calls[idx]
            layer = n_layers - 1 - idx
            check_flash_bwd(book, f"trained layer {layer}", args, kw, timed=(layer == 0))
            if layer == 0:  # the forward at the trained shape: out, m and l
                check_flash(book, "trained layer 0", args[:3], kw, timed=True)
        del cap
        gen = torch.Generator(device=dev).manual_seed(6)

        def operands(b, sq, kvh, g, sk, d, kw, wide=False):
            q = torch.randn((b, sq, kvh, g, d), generator=gen, device=dev)
            k = torch.randn((b, sk, kvh, d), generator=gen, device=dev)
            v = torch.randn((b, sk, kvh, d), generator=gen, device=dev)
            if wide:  # q and k elementwise times 2^e, e uniform over -3..3
                for t in (q, k):
                    t.mul_(torch.exp2(torch.randint(-3, 4, t.shape, generator=gen,
                                                    device=dev).float()))
            with torch.no_grad():
                out, m, l = flash_fwd(q, k, v, **kw)
            do = torch.randn(q.shape, generator=gen, device=dev)
            return q, k, v, out, m, l, do

        kvh, g, d = cfg.n_kv_heads, cfg.n_heads // cfg.n_kv_heads, cfg.resolved_head_dim
        lb, ls = LM_LONG["b"], LM_LONG["sq"]
        kw = dict(scale=d ** -0.5, causal=True, q_offset=0, kv_len=None)
        check_flash_bwd(book, "long 2048x2048 causal", operands(lb, ls, kvh, g, ls, d, kw),
                        kw, timed=True)
        torch.cuda.empty_cache()
        # every head dim; ragged Sq / Sk; G = 1, 2, 8; q_offset / kv_len; non-causal;
        # q and k over 2^+-3 at Sk = 512 (where one TF32 product would miss)
        edges = [(2, 37, 2, 2, 53, hd, hd % 16 == 0, 0, None) for hd in FLASH_HEAD_DIMS]
        edges += [(3, 37, 1, 1, 53, 128, True, 16, None),
                  (2, 70, 1, 8, 130, 64, True, 200, 250),
                  (2, 65, 2, 8, 97, 256, False, 0, 80),
                  (2, 1, 8, 2, 130, 128, True, 99, 100),
                  (2, 40, 2, 2, 40, 128, True, -8, None)]
        edges = [e + (False,) for e in edges] + [(2, 384, 4, 2, 512, 128, True, 128, None, True)]
        for eb, esq, ekv, eg, esk, ed, causal, qo, kvl, wide in edges:
            ekw = dict(scale=ed ** -0.5, causal=causal, q_offset=qo, kv_len=kvl)
            check_flash_bwd(book, "edge, q and k over 2^+-3" if wide else "edge",
                            operands(eb, esq, ekv, eg, esk, ed, ekw, wide), ekw, timed=False)

        # ---- restart on the card at the reduced config ---------------------
        losses = {}
        for tag, fail_at in (("uninterrupted", ()), ("failed", LM_RESTART["fail_at"])):
            _, h = train(LM_ARCH, reduced=True, steps=LM_RESTART["steps"],
                         global_batch=LM_RESTART["global_batch"],
                         seq_len=LM_RESTART["seq_len"], ckpt_dir=str(tmp / tag),
                         checkpoint_every=LM_RESTART["checkpoint_every"],
                         fail_at=fail_at, resume=False, seed=7, device=dev)
            losses[tag] = {x["step"]: x["loss"] for x in h}
        a, b = losses["uninterrupted"], losses["failed"]
        diff = max(abs(a[s_] - b[s_]) for s_ in a) if sorted(a) == sorted(b) else float("inf")
        ok = diff < 1e-6
        print(f"{LM_ARCH} reduced restart on the card ({LM_RESTART['steps']} steps, "
              f"failure at {LM_RESTART['fail_at']}, checkpoints every "
              f"{LM_RESTART['checkpoint_every']}): max |loss difference| {diff:.3e} "
              f"(limit 1e-6): {'ok' if ok else 'FAIL'}")
        if not ok:
            failures.append(f"{LM_ARCH} train: restart changed the losses by {diff}")
        summary["restart_max_loss_diff"] = diff
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    torch.cuda.empty_cache()
    return summary


# ---- the paper's methods as plain oracles, and the static verifier --------

PAPER_IMPLS = ("dense", "im2col", "ecr", "pecr", "ecr_pallas", "pecr_pallas")
VERIFIED = []  # one entry per plan this script builds


def verify_built(name, plan, params, batch, failures) -> None:
    """verify_plan on a plan this script built: it must show no error."""
    from repro_torch.analysis import errors, verify_plan

    diags = verify_plan(plan, params, batch=batch)
    errs = sorted({d.code for d in errors(diags)})
    VERIFIED.append({"plan": name, "layers": len(plan.layers), "batch": batch,
                     "errors": errs, "notes": sorted({d.code for d in diags} - set(errs))})
    if errs:
        failures.append(f"{name}: verify_plan finds errors {errs}")


def verifier_checks(plan, params, imgs, failures) -> dict:
    """The verifier on the card: a copy of the served VGG-19 plan corrupted
    two ways (a BSR layer at a weight density its params do not have, and a
    searched tile the kernels cannot honour), the launch record of a served
    layer corrupted, and the host wall of verify_plan per run_plan call
    beside the batch's wall."""
    import torch

    from dataclasses import replace

    from repro_torch.analysis import PlanVerificationError, check_launch_descriptor, verify_plan
    from repro_torch.graph.registry import unit_launch
    from repro_torch.kernels.tiles import TileConfig
    from repro_torch.pipeline import run_plan

    batch = int(imgs.shape[0])
    i = next(i for i, lp in enumerate(plan.layers) if lp.impl == "ecr_pallas")
    layers = list(plan.layers)
    layers[i] = replace(layers[i], kind="conv", impl="bsr", weight_density=0.3)
    dense_copy = replace(plan, layers=tuple(layers))
    codes = sorted({d.code for d in verify_plan(dense_copy, params, batch=batch)})
    try:
        run_plan(dense_copy, params, imgs)
        refused = False
    except PlanVerificationError as e:
        refused = "RPA205" in str(e)
    print(f"verifier: conv{i + 1} claimed as BSR at density 0.3 on unpruned params: "
          f"codes {codes}, run_plan refused: {refused}")
    if "RPA205" not in codes or not refused:
        failures.append("verifier: a BSR plan on params of another density was not refused")
    layers = list(plan.layers)
    layers[i] = replace(layers[i], tile=TileConfig(block_c=1000, block_o=32))
    tiled = replace(plan, layers=tuple(layers))
    diags = verify_plan(tiled, params, batch=batch)
    warned = sorted({d.code for d in diags})
    same = bool(torch.equal(run_plan(tiled, params, imgs), run_plan(plan, params, imgs)))
    L = unit_launch(plan.layers[i].kind, plan.layers[i].impl, plan.layers[i].to_unit(),
                    block_c=plan.block_c, batch=batch)
    bad = replace(L, tiles=L.tiles - 1)
    bad_codes = sorted({d.code for d in check_launch_descriptor(bad)})
    print(f"verifier: conv{i + 1} with tile block_c=1000 block_o=32: codes {warned} "
          f"(warn: the kernel falls back, logits bitwise unchanged: {same}); its launch "
          f"record one spatial tile short ({bad.tiles} of {L.tiles}): codes {bad_codes}")
    if warned != ["RPA204"] or not same or "RPA101" not in bad_codes:
        failures.append("verifier: a bad tile was not reported as the reference reports it")
    cost = verify_cost("vgg19", plan, params, imgs)
    return {"rpa205_codes": codes, "tile_codes": warned, "launch_codes": bad_codes,
            **cost}


def verify_cost(name, plan, params, imgs) -> dict:
    """verify_plan runs on every run_plan: its host wall (median of 5)
    against the wall of the whole run_plan call, verification included."""
    import torch

    from repro_torch.analysis import verify_plan
    from repro_torch.pipeline import run_plan

    batch = int(imgs.shape[0])
    verify_ms, run_ms = [], []
    for _ in range(5):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        verify_plan(plan, params, batch=batch)
        verify_ms.append((time.perf_counter() - t0) * 1e3)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        run_plan(plan, params, imgs)
        torch.cuda.synchronize()
        run_ms.append((time.perf_counter() - t0) * 1e3)
    v, r = sorted(verify_ms)[2], sorted(run_ms)[2]
    print(f"{name} verify_plan host wall {v:.3f} ms per run_plan call (median of 5) "
          f"beside the batch-{batch} run_plan wall {r:.3f} ms (verify included): "
          f"{100 * v / r:.1f}%")
    return {"verify_ms": v, "run_plan_ms": r, "verify_share": v / r}


def geometry_checks(dev, failures) -> dict:
    """Every full-width VGG-19 / LeNet-5 / AlexNet conv geometry: the Python
    mirror of the conv kernels' tile choice (`kernels.tiles`) against the
    kernels' own host code (`kernels.cuda.conv_tile`) at batch 1, 2 and 8,
    every output tile (0, 64, 128), with and without the pool, fp32 and
    int8; then each geometry the mirror accepts launched once at batch 2
    (fp32 conv, fused pool where the unit fuses, int8)."""
    import torch

    from repro_torch.configs.alexnet import ALEXNET
    from repro_torch.configs.lenet import LENET
    from repro_torch.configs.vgg19_sparse import CNNConfig, vgg19_graph
    from repro_torch.graph.registry import fusion_eligible
    from repro_torch.kernels import cuda as kcuda
    from repro_torch.kernels.conv_pool.kernel import conv_pool_batch
    from repro_torch.kernels.ecr_conv.kernel import ecr_conv_batch
    from repro_torch.kernels.tiles import CUDA_MAX_SMEM, f32_conv_tile, i8_conv_tile
    from repro_torch.quant.kernels import ecr_conv_int8_batch

    props = torch.cuda.get_device_properties(0)
    sms = props.multi_processor_count
    optin = getattr(props, "shared_memory_per_block_optin", None)
    print(f"geometry: {sms} SMs; kMaxSmem {CUDA_MAX_SMEM} B against the device's opt-in "
          f"shared memory per block {optin if optin is not None else 'not exposed by torch'}")
    if optin is not None and CUDA_MAX_SMEM > optin:
        failures.append(f"kMaxSmem {CUDA_MAX_SMEM} exceeds the device's opt-in {optin}")
    gen = torch.Generator(device=dev).manual_seed(0)
    compared = differ = launched = 0
    for gname, g in (("vgg19", vgg19_graph(CNNConfig())), ("lenet5", LENET),
                     ("alexnet", ALEXNET)):
        for unit in g.units():
            c, h, w = unit.in_shape
            conv, o = unit.conv, unit.conv.c_out
            hp, wp, k, st = h + 2 * conv.pad, w + 2 * conv.pad, conv.k, conv.stride
            oh, ow = (hp - k) // st + 1, (wp - k) // st + 1
            cp = c + (-c) % 8
            pools = (0, unit.pool.p) if fusion_eligible(unit) else (0,)
            for batch in (1, 2, 8):
                cases = [(pool, tn, False) for pool in pools for tn in (0, 64, 128)]
                for pool, tn, int8 in cases + [(0, 0, True)]:
                    mirror = (i8_conv_tile(oh, ow, o, k, k, st) if int8 else
                              f32_conv_tile(batch, oh, ow, o, k, k, st, pool, tn, sms))
                    try:
                        card = kcuda.conv_tile(batch, hp, wp, cp, o, k, k, stride=st,
                                               block_c=8, pool=pool, block_o=tn, int8=int8)
                    except RuntimeError:
                        card = (0,) * 7
                    compared += 1
                    if tuple(mirror) != tuple(card):
                        differ += 1
                        failures.append(f"{gname} conv{unit.index + 1} batch {batch} pool "
                                        f"{pool} tn {tn} int8 {int8}: mirror {mirror} != "
                                        f"kernel {card}")
            # one launch of each accepted geometry at batch 2
            n_cb = cp // 8
            x = torch.rand((2, hp, wp, cp), generator=gen, device=dev)
            wt = torch.randn((k, k, cp, o), generator=gen, device=dev)
            ids = torch.arange(n_cb, dtype=torch.int32, device=dev).repeat(2, 1).contiguous()
            cnt = torch.full((2,), n_cb, dtype=torch.int32, device=dev)
            outs = []
            if f32_conv_tile(2, oh, ow, o, k, k, st, 0, 0, sms)[0]:
                outs.append(ecr_conv_batch(x, wt, ids, cnt, stride=st, block_c=8))
            if len(pools) > 1 and f32_conv_tile(2, oh, ow, o, k, k, st, pools[1], 0, sms)[0]:
                outs.append(conv_pool_batch(x, wt, ids, cnt, stride=st, pool=pools[1],
                                            block_c=8))
            if i8_conv_tile(oh, ow, o, k, k, st)[0]:
                xq = torch.randint(-127, 128, x.shape, generator=gen, device=dev,
                                   dtype=torch.int8)
                wq = torch.randint(-127, 128, wt.shape, generator=gen, device=dev,
                                   dtype=torch.int8)
                sx = torch.full((2, 1), 1e-3, device=dev)
                sw = torch.full((1, o), 1e-3, device=dev)
                outs.append(ecr_conv_int8_batch(xq, wq, sx, sw, ids, cnt, stride=st,
                                                block_c=8))
            torch.cuda.synchronize()
            for y in outs:
                launched += 1
                if not bool(torch.isfinite(y).all()):
                    failures.append(f"{gname} conv{unit.index + 1}: a launch gave non-finite "
                                    f"values")
            del x, wt, outs
    print(f"geometry: the Python tile mirror against the kernels' host code on "
          f"{compared} (geometry, batch, pool, tn, dtype) cases: {compared - differ} equal, "
          f"{differ} differ; {launched} launches of the accepted geometries at batch 2, "
          f"all finite")
    return {"compared": compared, "differ": differ, "launched": launched, "sms": sms,
            "smem_optin": optin}


def paper_phase(dev, wrappers, failures) -> dict:
    """The paper's methods on full-width VGG-19 (3x224x224, 1000 classes;
    weights from init_cnn at generator seed 0 plus shift_dead_channels):
    cnn_forward at batch 1 (one image) and 2 under every impl against the
    dense path, Fig. 2 / Fig. 6's window statistics of the 16 conv inputs,
    each conv layer timed by CUDA events under every conv impl and, on the
    stage-final layers, every conv+pool impl (batch 1), and the oracle plan
    (use_pallas=False) planned, verified and run."""
    import torch

    from repro_torch.configs.vgg19_sparse import CNNConfig, vgg19_graph
    from repro_torch.core import conv2d, conv_pool, window_stats
    from repro_torch.core.pecr import fused_traffic_bytes
    from repro_torch.graph import pad2d
    from repro_torch.graph.ir import graph_weights
    from repro_torch.graph.registry import fusion_eligible
    from repro_torch.launch.serve_cnn import synth_requests
    from repro_torch.models.cnn import (
        cnn_feature_maps,
        cnn_forward,
        init_cnn,
        shift_dead_channels,
    )
    from repro_torch.pipeline import plan_network, run_plan

    t_phase = time.perf_counter()
    ccfg = CNNConfig()
    graph = vgg19_graph(ccfg)
    params = shift_dead_channels(init_cnn(torch.Generator().manual_seed(0), ccfg,
                                          device=dev))
    imgs = torch.stack(synth_requests(graph, 2, seed=2, device=dev))
    res = {"forward": [], "window_stats": [], "layers": []}
    for batch, x in ((1, imgs[0]), (2, imgs)):
        dense = cnn_forward(params, x, "dense", ccfg)
        scale = float(dense.abs().max())
        for impl in PAPER_IMPLS:
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            reset_counts(wrappers)
            t0 = time.perf_counter()
            got = cnn_forward(params, x, impl, ccfg)
            torch.cuda.synchronize()
            wall = (time.perf_counter() - t0) * 1e3
            peak = torch.cuda.max_memory_allocated() / 2 ** 20
            launches = {k: v for k, v in read_counts(wrappers).items() if v}
            err = float((got - dense).abs().max())
            ok = (bool(torch.isfinite(got).all()) and got.shape == dense.shape
                  and err <= 1e-4 * scale)
            print(f"paper batch {batch} cnn_forward {impl:12s}: max_abs_err vs dense "
                  f"{err:.3e} (limit 1e-4*max|dense| = {1e-4 * scale:.3e}): "
                  f"{'ok' if ok else 'FAIL'}; wall {wall:.1f} ms, peak allocated "
                  f"{peak:.0f} MiB, kernel launches {launches}")
            if not ok:
                failures.append(f"paper: cnn_forward {impl} at batch {batch} disagrees "
                                f"with dense")
            if impl.endswith("_pallas") and not launches:
                failures.append(f"paper: cnn_forward {impl} launched no kernel")
            res["forward"].append({"batch": batch, "impl": impl, "max_abs_err": err,
                                   "max_abs_dense": scale, "wall_ms": wall,
                                   "peak_mib": peak, "launches": launches})
    maps = cnn_feature_maps(params, imgs[0], ccfg)
    print("paper window statistics of the 16 conv inputs (image 0; paper Fig. 2 / "
          "Fig. 6, 3x3 windows, stride 1, before padding):")
    for unit, m in zip(graph.units(), maps):
        ws = window_stats(m, 3, 3, 1)
        print(f"  conv{unit.index + 1:<2d} {tuple(m.shape)}: sparsity {ws.sparsity:.4f}, "
              f"theta {ws.theta:.4f}, mul reduction {ws.mul_reduction:.4f}, add "
              f"reduction {ws.add_reduction:.4f}")
        res["window_stats"].append({"layer": unit.index + 1, "shape": tuple(m.shape),
                                    **vars(ws), "mul_reduction": ws.mul_reduction,
                                    "add_reduction": ws.add_reduction})
    conv_ws, _ = graph_weights(params)
    print("paper per-layer ms (batch 1, CUDA events, median of 3; conv: dense / im2col "
          "/ ecr / ecr_pallas; stage-final conv+pool: unfused / pecr / pecr_pallas):")
    for unit, m, w in zip(graph.units(), maps, conv_ws):
        xp = pad2d(m, unit.conv.pad)
        t = time_turns({impl: (lambda impl=impl: conv2d(xp, w, 1, impl))
                        for impl in ("dense", "im2col", "ecr", "ecr_pallas")},
                       rounds=3, iters=1)
        row = {"layer": unit.index + 1, "in": tuple(xp.shape), **t}
        line = " ".join(f"{k} {v:8.3f}" for k, v in t.items())
        if fusion_eligible(unit):
            tp = time_turns({impl: (lambda impl=impl: conv_pool(xp, w, 1, 2, None, impl))
                             for impl in ("unfused", "pecr", "pecr_pallas")},
                            rounds=3, iters=1)
            tb = fused_traffic_bytes(tuple(xp.shape), w.shape[0], 3, 3, 1, 2)
            row.update({f"pool_{k}": v for k, v in tp.items()}, traffic=tb)
            line += (" | " + " ".join(f"{k} {v:8.3f}" for k, v in tp.items())
                     + f" | fused {tb['fused_bytes']} B, unfused {tb['unfused_bytes']} B,"
                       f" saved {tb['saved_frac']:.3f}")
        print(f"  conv{unit.index + 1:<2d} {tuple(xp.shape)}: {line}")
        res["layers"].append(row)
    oplan = plan_network(params, imgs, graph, occ_threshold=0.75, block_c=8,
                         use_pallas=False)
    verify_built("vgg19 oracle plan (use_pallas=False)", oplan, params, 2, failures)
    got = run_plan(oplan, params, imgs)
    dense = cnn_forward(params, imgs, "dense", ccfg)
    err = float((got - dense).abs().max())
    ok = bool(torch.isfinite(got).all()) and err <= 1e-4 * float(dense.abs().max())
    print(f"paper oracle plan: {plan_line(oplan)}; run_plan vs dense max_abs_err "
          f"{err:.3e}: {'ok' if ok else 'FAIL'}")
    if not ok:
        failures.append("paper: the oracle plan disagrees with dense")
    res["oracle_plan"] = plan_line(oplan)
    res["seconds"] = time.perf_counter() - t_phase
    print(f"paper phase: {res['seconds']:.1f} s")
    return res


SCN_RATE = 200.0  # req/s offered in the hot-swap and diurnal streams


def scn_engine(graph, params, calib, dev, **kw):
    """An Engine as the served phases build them (block_c=8,
    occ_threshold=0.75, max_batch=8), on a SimClock charged with the
    measured service time."""
    from repro_torch.serving import Engine, SimClock

    kw.setdefault("clock", SimClock())
    return Engine(params, graph=graph, calib=calib, occ_threshold=0.75, block_c=8,
                  max_batch=8, device=dev, **kw)


def plan_logits(plan, params, imgs):
    """run_plan over `imgs` in buckets of 8 (the engine's largest), numpy."""
    import numpy as np

    from repro_torch.pipeline import run_plan

    return np.concatenate([run_plan(plan, params, imgs[i:i + 8]).cpu().numpy()
                           for i in range(0, imgs.shape[0], 8)])


def close(got, ref) -> tuple:
    """rtol 1e-3 + 1e-3*max|ref|: on the card run_plan equals the engine
    bitwise only at the same bucket. Returns (ok, max_abs_err)."""
    import numpy as np

    atol = 1e-3 * float(np.abs(ref).max())
    ok = bool(np.all(np.isfinite(got)) and np.allclose(got, ref, rtol=1e-3, atol=atol))
    return ok, float(np.abs(got - ref).max())


def decisions(plan) -> list:
    return [(lp.kind, lp.impl) for lp in plan.layers]


def scenario_hotswap(graph, params, calib, dev, wrappers, failures) -> dict:
    """24 requests with a hot swap to the 0.3-pruned variant (planned on the
    card) at the midpoint, the swap back, a refused corrupt swap, and the
    weight signature on two pruned variants."""
    from dataclasses import replace

    import numpy as np
    import torch

    from repro_torch.pipeline import plan_network
    from repro_torch.serving import HotSwapScenario, plan_key, replay_scenario, replay_stream
    from repro_torch.serving.scenarios import synth_image
    from repro_torch.sparse_weights.prune import prune_graph_params

    pruned, rep = prune_graph_params(params, 0.3, graph)
    pplan = plan_network(pruned, calib, graph, occ_threshold=0.75, block_c=8)
    verify_built("scenario hot-swap variant (pruned 0.3)", pplan, pruned, 8, failures)
    eng = scn_engine(graph, params, calib, dev)
    dplan = eng.plan
    eng.warmup()
    n = 24
    at_swap = {}

    def swap(engines):
        at_swap.update(read_counts(wrappers))
        at_swap["swapped"] = engines[""].hot_swap(pruned, plan=pplan)

    scn = HotSwapScenario(in_shape=graph.in_shape, n_requests=n, rate_rps=SCN_RATE,
                          t_swap=n / (2 * SCN_RATE), swap_fn=swap, seed=0)
    reset_counts(wrappers)
    results = replay_scenario(eng, scn)[""]
    launches = read_counts(wrappers)
    st = eng.stats()
    print(f"scenario hotswap: pruned to {rep.density:.4f}; plan after the swap "
          f"{plan_line(pplan)}; launches at the swap {dict((k, at_swap.get(k)) for k in wrappers)},"
          f" after the stream {launches}; {st['batches']} batches, hot_swaps "
          f"{st['hot_swaps']}, compiles {st['compiles']}")
    if not at_swap.get("swapped") or sorted(r.id for r in results) != list(range(n)):
        failures.append("scenario hotswap: the swap did not land or a request was lost")
    if at_swap.get("bsr_matmul", 1) != 0 or launches["bsr_matmul"] < 1:
        failures.append("scenario hotswap: bsr_matmul did not grow only after the swap")
    if at_swap.get("ecr_conv", 0) < 1 or at_swap.get("conv_pool", 0) < 1:
        failures.append("scenario hotswap: ECR / PECR did not launch before the swap")
    swap_t = [e["t"] for e in st["telemetry"]["replan_events"] if e["kind"] == "hot_swap"][0]
    imgs = torch.stack([r.img for r in scn.requests()]).to(dev)
    ref_old, ref_new = plan_logits(dplan, params, imgs), plan_logits(pplan, pruned, imgs)
    # the largest per-logit tolerance either check allows: rtol 1e-3 plus
    # atol 1e-3*max|ref|, both at most 1e-3*max|logits|
    tol = 2e-3 * max(float(np.abs(ref_old).max()), float(np.abs(ref_new).max()))
    pre = [r for r in results if r.t_done <= swap_t]
    post = [r for r in results if r.t_done > swap_t]
    worst = 0.0
    for part, ref in ((pre, ref_old), (post, ref_new)):
        if part:
            ok, err = close(np.stack([r.logits for r in part]),
                               ref[[r.id for r in part]])
            worst = max(worst, err)
            if not ok:
                failures.append("scenario hotswap: a request disagrees with the model "
                                "that served it")
    apart = float(min(np.abs(ref_old[i] - ref_new[i]).max() for i in range(n)))
    print(f"scenario hotswap: {len(pre)} requests served before the swap, {len(post)} "
          f"after; each against run_plan of its model: max err {worst:.3e} = "
          f"{worst / tol:.4f} x the tolerance {tol:.3e} (2e-3*max|logits|); the two "
          f"models' logits differ by at least {apart:.3e} = {apart / tol:.1f} x the "
          f"tolerance per request")
    if not pre or not post or apart <= 10 * tol:
        failures.append("scenario hotswap: the swap did not land mid-stream, or the two "
                        "models cannot be told apart")
    # the swap back builds nothing; a corrupt candidate is refused
    builds = eng.cache.compiles
    back = eng.hot_swap(params, plan=dplan)
    k = next(i for i, lp in enumerate(pplan.layers) if lp.impl == "bsr")
    bad = replace(pplan, layers=tuple(replace(lp, weight_density=0.5) if i == k else lp
                                      for i, lp in enumerate(pplan.layers)))
    refused = eng.hot_swap(pruned, plan=bad)
    codes = [e["codes"] for e in eng.stats()["telemetry"]["replan_events"]
             if e["kind"] == "verify_reject"]
    reset_counts(wrappers)
    more = [synth_image(graph.in_shape, 1, i) for i in range(8)]
    after = sorted(replay_stream(eng, more, rate_rps=1000.0), key=lambda r: r.id)
    after_launches = read_counts(wrappers)
    ok_after, err_after = close(np.stack([r.logits for r in after]),
                                   plan_logits(dplan, params, torch.stack(more).to(dev)))
    print(f"scenario hotswap: swap back {back}, compiles {builds} -> "
          f"{eng.cache.compiles} after 8 more requests; conv{k + 1} density claimed 0.5 "
          f"on the 0.3 params: hot_swap returned {refused}, verify_rejects "
          f"{eng.verify_rejects}, codes {codes}; the next batches vs the dense-weight "
          f"model's run_plan: max err {err_after:.3e} {'ok' if ok_after else 'FAIL'}, "
          f"launches {after_launches}")
    if not back or eng.cache.compiles != builds:
        failures.append("scenario hotswap: the swap back built a runner")
    if refused or eng.verify_rejects != 1 or not codes or "RPA205" not in codes[0]:
        failures.append("scenario hotswap: the corrupt swap was not refused with RPA205")
    if not ok_after or after_launches["bsr_matmul"] != 0:
        failures.append("scenario hotswap: after the refused swap the engine did not "
                        "serve the current model")
    out = {"pruned_density": rep.density, "plan_after_swap": plan_line(pplan),
           "launches_at_swap": {k: at_swap.get(k) for k in wrappers},
           "launches": launches, "served_before_swap": len(pre), "max_err": worst,
           "tolerance": tol, "models_apart": apart, "compiles": builds,
           "compiles_after_swap_back": eng.cache.compiles, "refused_codes": codes}
    del eng
    # the weight signature at full width: two pruned variants with the same
    # (kind, impl) decisions but other rounded BSR densities, on one engine;
    # 0.5 first, then densities nearer 0.3 (at 224 px the 0.5 and 0.4
    # variants move layers off BSR)
    for d in (0.5, 0.4, 0.35, 0.25):
        p5, rep5 = prune_graph_params(params, d, graph)
        plan5 = plan_network(p5, calib, graph, occ_threshold=0.75, block_c=8)
        verify_built(f"scenario weight_sig variant (pruned {d})", plan5, p5, 8, failures)
        same = decisions(plan5) == decisions(pplan)
        sigs_differ = plan_key(8, plan5).weight_sig != plan_key(8, pplan).weight_sig
        print(f"scenario weight_sig: the {d} variant plans {plan_line(plan5)}: same "
              f"(kind, impl) decisions as the 0.3 variant: {same}; rounded BSR "
              f"densities differ: {sigs_differ}")
        if same and sigs_differ:
            break
    else:
        print("scenario weight_sig: no pair with equal decisions and other BSR "
              "densities at full width; "
              "tests/test_torch_engine_replan.py::"
              "test_hot_swap_between_pruned_variants_builds_separate_runners is the "
              "evidence")
        out["weight_sig"] = "no pair with equal decisions"
        return out
    eng = scn_engine(graph, pruned, calib, dev, plan=pplan)
    batch = torch.stack(more).to(dev)
    got3 = eng.serve(list(batch))
    b3 = eng.cache.compiles
    eng.hot_swap(p5, plan=plan5)
    got5 = eng.serve(list(batch))
    keys_differ = plan_key(8, pplan) != plan_key(8, plan5)
    ok3 = close(got3, plan_logits(pplan, pruned, batch))[0]
    ok5 = close(got5, plan_logits(plan5, p5, batch))[0]
    print(f"scenario weight_sig: 0.3 and {d} variants (density {rep5.density:.4f}) "
          f"plan the same decisions; weight_sig {plan_key(8, pplan).weight_sig[:3]}... vs "
          f"{plan_key(8, plan5).weight_sig[:3]}...: keys differ {keys_differ}; builds "
          f"{b3} then {eng.cache.compiles}; each variant vs its own run_plan: {ok3} {ok5}")
    if not keys_differ or b3 != 1 or eng.cache.compiles != 2 or not (ok3 and ok5):
        failures.append("scenario weight_sig: the pruned variants shared a runner")
    out["weight_sig"] = {"pair": [0.3, d], "keys_differ": keys_differ,
                         "builds": eng.cache.compiles}
    return out


def scenario_diurnal(graph, params, calib, dev, failures) -> dict:
    """32 requests planned at dead_frac 0.5, stepping at the midpoint, with
    replan_band 0.15 and no cooldown: to 0.0 (a re-plan needs the occupancy
    to move, and VGG-19's 3 input channels fill one 8-channel block either
    way), then to 1.0 (blank frames: every layer's occupancy drops)."""
    import numpy as np
    import torch

    from repro_torch.pipeline import plan_network
    from repro_torch.serving import DiurnalDriftScenario, replay_scenario

    n = 32
    out = {}
    for dead_hi in (0.0, 1.0):
        eng = scn_engine(graph, params, calib, dev, replan_band=0.15, replan_cooldown=0)
        before = eng.plan
        planned = np.array([lp.occupancy for lp in before.layers])
        eng.warmup()
        scn = DiurnalDriftScenario(in_shape=graph.in_shape, n_requests=n, rate_rps=SCN_RATE,
                                   dead_lo=0.5, dead_hi=dead_hi, drift="step",
                                   t_drift=n / (2 * SCN_RATE), seed=0)
        results = replay_scenario(eng, scn)[""]
        st = eng.stats()
        tel = st["telemetry"]
        drift = max(float(np.abs(np.array(v) - planned).max()) for _, v in tel["occ_timeline"])
        swaps = [e for e in tel["replan_events"] if e["kind"] == "swap" and e["changed"]]
        landed = [sum(1 for t, _ in tel["occ_timeline"] if t <= e["t"]) for e in swaps]
        onset = len({r.t_formed for r in results if r.t_formed < scn.t_drift})
        label = f"scenario diurnal 0.5 -> {dead_hi}"
        print(f"{label}: {len(results)} served in {st['batches']} batches, "
              f"{onset} formed before the step; replans {st['replans']}, largest "
              f"|occupancy EMA - planned| {drift:.4f} (band 0.15)")
        entry = {"replans": st["replans"], "max_drift": drift, "landed_at_batch": landed,
                 "batches_before_step": onset}
        if swaps:
            drifted = torch.stack([r.img for r in scn.requests()[-8:]]).to(dev)
            ref = plan_network(params, drifted, graph, occ_threshold=0.75, block_c=8)
            same = decisions(ref) == decisions(eng.plan)
            print(f"{label}: the re-plan landed after batch {landed[0]}; plan before "
                  f"{plan_line(before)}; after {plan_line(eng.plan)}; equals plan_network "
                  f"on the last 8 (drifted) images: {same}")
            entry.update(plan_before=plan_line(before), plan_after=plan_line(eng.plan),
                         equals_plan_network=same)
            if not same:
                failures.append(f"{label}: the re-plan is not plan_network's plan")
        if not all(np.all(np.isfinite(r.logits)) for r in results) or len(results) != n:
            failures.append(f"{label}: lost requests or non-finite logits")
        out[str(dead_hi)] = entry
        del eng
    if out["1.0"]["replans"] < 1:
        failures.append("scenario diurnal: no re-plan landed on the blank-frame step")
    return out


def scenario_burst(graph, params, calib, dev, failures) -> dict:
    """32 Poisson requests at 50 req/s with 16x bursts: every id served once,
    each formed within its deadline plus the service of the buckets that
    ran between its arrival and its formation (the one executing when it
    arrived included: the measured service exceeds the 10 ms deadline)."""
    from repro_torch.serving import PoissonBurstScenario, replay_scenario

    n, rate = 32, 50.0
    t_mid = n / (2 * rate)
    eng = scn_engine(graph, params, calib, dev)
    eng.warmup()
    scn = PoissonBurstScenario(in_shape=graph.in_shape, n_requests=n, base_rps=rate,
                               burst_rps=16 * rate, burst_every_s=t_mid,
                               burst_len_s=t_mid / 4, seed=0)
    results = replay_scenario(eng, scn)[""]
    batches = {r.t_formed: r.t_done for r in results}  # t_formed -> t_done
    late = []
    for r in results:
        busy = sum(d - f for f, d in batches.items() if f < r.t_formed and d > r.t_arrival)
        if r.t_formed - r.t_arrival > eng.batcher.deadline_s + busy + 1e-9:
            late.append(r.id)
    if late:
        failures.append(f"scenario burst: requests {late} waited past their bound")
    st = eng.stats()
    print(f"scenario burst: {len(results)} served once each: "
          f"{sorted(r.id for r in results) == list(range(n))}; {st['batches']} batches, "
          f"buckets {st['telemetry']['bucket_counts']}; p50={st['p50_ms']:.2f} ms "
          f"p95={st['p95_ms']:.2f} ms (SimClock, measured service); every request "
          f"formed within its bound: {not late}")
    if sorted(r.id for r in results) != list(range(n)):
        failures.append("scenario burst: a request was lost or served twice")
    return {"p50_ms": st["p50_ms"], "p95_ms": st["p95_ms"], "batches": st["batches"],
            "bucket_counts": st["telemetry"]["bucket_counts"]}


def scenario_multitenant(graph, params, calib, dev, failures) -> dict:
    """VGG-19 and LeNet-5 (published sizes) on one PlanCache and clock, 8
    requests each: no build after warmup, each tenant against its model."""
    import numpy as np
    import torch

    from repro_torch.configs.lenet import LENET
    from repro_torch.serving import (
        MultiTenantScenario,
        PlanCache,
        SimClock,
        TenantSpec,
        replay_scenario,
    )

    lparams, lcalib, _ = make_params(LENET, seed=1, dev=dev)
    clock, cache = SimClock(), PlanCache()
    engines = {"vgg19": scn_engine(graph, params, calib, dev, clock=clock, cache=cache),
               "lenet5": scn_engine(LENET, lparams, lcalib, dev, clock=clock, cache=cache)}
    warm = sum(e.warmup() for e in engines.values())
    scn = MultiTenantScenario(tenants=(
        ("vgg19", TenantSpec(in_shape=graph.in_shape, n_requests=8, rate_rps=100.0)),
        ("lenet5", TenantSpec(in_shape=LENET.in_shape, n_requests=8, rate_rps=100.0))),
        seed=0)
    results = replay_scenario(engines, scn)
    line = []
    for stream, eng in engines.items():
        imgs = torch.stack([r.img for r in scn.requests() if r.stream == stream]).to(dev)
        got = sorted(results[stream], key=lambda r: r.id)
        ok, err = close(np.stack([r.logits for r in got]),
                           plan_logits(eng.plan, eng.params, imgs))
        line.append(f"{stream} {len(got)} served, vs its run_plan max err {err:.3e} "
                    f"{'ok' if ok else 'FAIL'}")
        if not ok or len(got) != 8:
            failures.append(f"scenario multitenant: {stream} disagrees with its model")
    print(f"scenario multitenant: warmup built {warm} runners ({len(cache._entries)} keys), "
          f"after the stream {cache.compiles}; " + "; ".join(line))
    if cache.compiles != warm:
        failures.append("scenario multitenant: the stream built a runner")
    return {"warm_builds": warm, "builds_after": cache.compiles}


def scenario_history(kind, failures, full=True, device=None) -> dict:
    """serve_cnn(history=...) twice (steady at 96 px, then hotswap): every
    record stamped with the card's name, the trend table, and the history
    CLI's check."""
    import os
    import tempfile

    from repro_torch.launch.serve_cnn import serve_cnn
    from repro_torch.obs.history import BenchDB, trend_table

    with tempfile.TemporaryDirectory() as tmp:
        db_path = os.path.join(tmp, "benchdb.jsonl")
        for scenario in ("steady", "hotswap"):
            s = serve_cnn(model="vgg19", full=full, n_requests=16, scenario=scenario,
                          history=db_path, device=device)
            print(f"scenario history: serve_cnn --full --scenario {scenario}: "
                  f"{s['requests']} served, p50={s['p50_ms']:.2f} ms "
                  f"p95={s['p95_ms']:.2f} ms, hot_swaps {s['hot_swaps']}")
        db = BenchDB(db_path)
        kinds = sorted({r.device_kind for r in db.records})
        print(f"scenario history: {len(db)} points, {len(db.series())} series, device "
              f"kinds {kinds}")
        print(trend_table(db))
        env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
        r = subprocess.run([sys.executable, "-m", "repro_torch.obs.history.cli", "check",
                            "--db", db_path, "--json"], capture_output=True, text=True,
                           env=env, cwd=ROOT, timeout=300)
        report = json.loads(r.stdout) if r.returncode in (0, 1) else {}
    print(f"scenario history: check --json exit {r.returncode}, counts "
          f"{report.get('counts')}, regressed {report.get('regressed')}")
    if not len(db) or kinds != [kind]:
        failures.append(f"scenario history: empty DB or records not stamped {kind!r}")
    if r.returncode not in (0, 1) or "counts" not in report:
        print(r.stderr[-2000:], file=sys.stderr)
        failures.append("scenario history: the history CLI check failed")
    return {"points": len(db), "series": len(db.series()), "device_kinds": kinds,
            "check_rc": r.returncode, "check_counts": report.get("counts")}


def scenario_phase(dev, wrappers, failures) -> dict:
    """The scenario library on the published VGG-19 (3x224x224, 1000 classes,
    make_params' weights and calibration images)."""
    import torch

    from repro_torch.configs.vgg19_sparse import CNNConfig, vgg19_graph

    graph = vgg19_graph(CNNConfig())
    params, calib, _ = make_params(graph, seed=0, dev=dev)
    t_phase = time.perf_counter()
    out = {}
    for name, fn, args in (
            ("hotswap", scenario_hotswap, (graph, params, calib, dev, wrappers, failures)),
            ("diurnal", scenario_diurnal, (graph, params, calib, dev, failures)),
            ("burst", scenario_burst, (graph, params, calib, dev, failures)),
            ("multitenant", scenario_multitenant, (graph, params, calib, dev, failures)),
            ("history", scenario_history, (torch.cuda.get_device_name(0), failures))):
        t0 = time.perf_counter()
        try:
            out[name] = fn(*args)
        except Exception:
            traceback.print_exc()
            failures.append(f"scenario {name} failed")
        out.setdefault(name, {})
        out[name]["seconds"] = time.perf_counter() - t0
        print(f"scenario {name}: {out[name]['seconds']:.2f} s")
        torch.cuda.empty_cache()
    out["seconds"] = time.perf_counter() - t_phase
    print(f"scenario phase: {out['seconds']:.2f} s")
    return out


def lint_cli(failures) -> dict:
    """python -m repro_torch.analysis.cli --json over the zoo, on the card."""
    import os

    t0 = time.perf_counter()
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    r = subprocess.run([sys.executable, "-m", "repro_torch.analysis.cli", "--json"],
                       capture_output=True, text=True, env=env, cwd=ROOT, timeout=600)
    doc = json.loads(r.stdout) if r.returncode == 0 else {}
    models = [(rep["model"], " ".join(rep["plan"]["layers"])) for rep in doc.get("reports", [])]
    print(f"analysis cli --json: exit {r.returncode}, n_errors {doc.get('n_errors')}, "
          f"{models}, {time.perf_counter() - t0:.1f} s")
    if r.returncode != 0 or doc.get("n_errors") != 0:
        print(r.stderr[-2000:], file=sys.stderr)
        failures.append("python -m repro_torch.analysis.cli --json did not exit clean")
    return {"rc": r.returncode, "n_errors": doc.get("n_errors"), "models": models}


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
    from repro_torch.kernels.bsr_matmul.kernel import bsr_matmul
    from repro_torch.kernels.conv_pool.kernel import conv_pool_batch
    from repro_torch.kernels.ecr_conv.kernel import ecr_conv_batch
    from repro_torch.pipeline import run_plan
    from repro_torch.quant.kernels import bsr_matmul_int8, ecr_conv_int8_batch
    from repro_torch.serving import replay_stream

    dev = resolve_device("cuda")  # also turns TF32 off for cuDNN and cuBLAS
    card = card_line()
    kind = torch.cuda.get_device_name(0)
    print(f"card: {card}; torch {torch.__version__} cuda {torch.version.cuda}")

    t0 = time.perf_counter()
    build_out = io.StringIO()
    with contextlib.redirect_stdout(build_out):
        lib_path = kcuda.build(verbose=True)
    print(build_out.getvalue(), end="")
    kcuda.library()
    print(f"build: {lib_path.name} in {time.perf_counter() - t0:.2f} s")

    book = KernelBook()
    failures = []
    # the fp32 tensor-core bodies (ECR / PECR, BSR, the fp32 flash forward)
    # run on the TF32 tensor cores (HMMA), staged by cp.async (LDGSTS); the
    # conv body has no CUDA-core fp32 multiply-add (FFMA) left
    all_sass = sass_counts(lib_path)
    usage = ptxas_usage(build_out.getvalue())  # empty if the library was built before
    for stem, want in SPLIT_TF32_KERNELS.items():
        sass = {k: v for k, v in all_sass.items() if stem in k}
        for fn, ops in sorted(sass.items()):
            res = usage.get(fn)
            regs = (f"registers {res.get('registers')}, stack frame {res.get('stack')} B, "
                    f"spill stores {res.get('spill_stores')} B, spill loads "
                    f"{res.get('spill_loads')} B" if res else
                    "registers and spills not reported (library built before this run)")
            print(f"sass {fn[:100]}: " + ", ".join(f"{op} {ops.get(op, 0)}" for op in
                                                  ("HMMA", "LDGSTS", "LDS", "FFMA"))
                  + f"; {regs}")
            if not ops.get("HMMA") or not ops.get("LDGSTS"):
                failures.append(f"{fn}: no HMMA or no LDGSTS in its SASS")
        if len(sass) != want:
            failures.append(f"expected {want} {stem} instantiations, found {len(sass)}")
    wrappers = {"ecr_conv": ecr_conv_batch, "conv_pool": conv_pool_batch,
                "bsr_matmul": bsr_matmul, "ecr_conv_int8": ecr_conv_int8_batch,
                "bsr_matmul_int8": bsr_matmul_int8}

    # ---- the main path: published VGG-19 through the Engine ----------------
    graph = vgg19_graph(CNNConfig())
    eng, params, imgs, plan_s, clock, _ = serve(graph, 16, seed=0, dev=dev)
    plan = eng.plan
    print(f"vgg19 plan ({plan_s:.2f} s): {plan_line(plan)}")
    verify_built("vgg19", plan, params, 8, failures)
    impls = [lp.impl for lp in plan.layers]
    reset_counts(wrappers)
    t_start = clock()
    wall0 = time.perf_counter()
    results = replay_stream(eng, imgs, rate_rps=1000.0)
    wall = time.perf_counter() - wall0
    launches = read_counts(wrappers)
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
        e2, p2, im2, _, _, _ = serve(g, 8, seed=0, dev=dev)
        verify_built(name, e2.plan, p2, 8, failures)
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
    verifier = {}
    try:
        verifier = verifier_checks(plan, params, batch[:8], failures)
    except Exception:
        traceback.print_exc()
        failures.append("verifier checks failed")

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
    for row in book.rows:
        row["phase"] = "vgg19"
    try:
        edge_cases(book, dev)
    except Exception:
        traceback.print_exc()
        failures.append("edge-case kernel check failed")
    try:
        edge_cases_tf32(book, dev)
    except Exception:
        traceback.print_exc()
        failures.append("edge-case check of the split-TF32 ECR / PECR kernel failed")

    del eng
    torch.cuda.empty_cache()

    # ---- pruned, int8 and pruned+int8 VGG-19 through the Engine -------------
    variants = {}
    services = {"vgg19": svc}
    phase_launches = {"vgg19": launches}
    for name, prune, int8, want in (
            ("vgg19-pruned", PRUNE_DENSITY, False, "bsr_matmul"),
            ("vgg19-int8", 1.0, True, "ecr_conv_int8"),
            ("vgg19-pruned-int8", PRUNE_DENSITY, True, "bsr_matmul_int8")):
        try:
            vplan, vparams, vbatch, vl, summary = variant_phase(
                name, graph, dev, wrappers, failures, prune_density=prune,
                int8=int8, want=want)
        except Exception:
            traceback.print_exc()
            failures.append(f"{name} phase failed")
            continue
        phase_launches[name] = vl
        variants[name] = summary
        vs = service_breakdown(vplan, vparams, vbatch[:8])
        services[name] = vs
        print(f"{name} warm batch-8 service: wall {vs['wall_ms']:.2f} ms (median of 5), "
              f"device {vs['device_ms']:.2f} ms, idle share {vs['idle_share']}")
        for cat, ms in sorted(vs["by_class_ms"].items(), key=lambda kv: -kv[1]):
            print(f"  {ms:8.3f} ms  {cat}")
        print(f"{name} kernel checks ({KERNEL_TOL}):")
        variant_kernel_checks(book, vplan, vparams, vbatch, failures, name)
        del vplan, vparams, vbatch
        torch.cuda.empty_cache()
    try:
        edge_cases_new(book, dev)
    except Exception:
        traceback.print_exc()
        failures.append("edge-case check of the BSR / int8 kernels failed")
    try:
        edge_cases_int8_tc(book, dev)
    except Exception:
        traceback.print_exc()
        failures.append("edge-case check of the int8 tensor-core kernels failed")
    try:
        edge_cases_bsr_tf32(book, dev)
    except Exception:
        traceback.print_exc()
        failures.append("edge-case check of the split-TF32 BSR kernel failed")

    # ---- obs: measure -> calibrate -> search -> plan on VGG-19 --------------
    obs = {}
    outdir = args.layers_out.parent if args.layers_out is not None else None
    if outdir is not None:
        outdir.mkdir(parents=True, exist_ok=True)
    for name, prune in (("vgg19", 1.0), ("vgg19-pruned", PRUNE_DENSITY)):
        try:
            obs[name] = obs_variant(name, graph, dev, wrappers, book, failures, outdir,
                                    prune_density=prune)
        except Exception:
            traceback.print_exc()
            failures.append(f"{name} obs phase failed")
        torch.cuda.empty_cache()

    # ---- the paper's methods as oracles; the verifier's geometry and CLI ---
    paper, geometry, lint = {}, {}, {}
    try:
        paper = paper_phase(dev, wrappers, failures)
    except Exception:
        traceback.print_exc()
        failures.append("paper phase failed")
    torch.cuda.empty_cache()
    try:
        geometry = geometry_checks(dev, failures)
    except Exception:
        traceback.print_exc()
        failures.append("geometry checks failed")
    torch.cuda.empty_cache()
    try:
        lint = lint_cli(failures)
    except Exception:
        traceback.print_exc()
        failures.append("analysis cli check failed")
    scenario = {}
    try:
        scenario = scenario_phase(dev, wrappers, failures)
    except Exception:
        traceback.print_exc()
        failures.append("scenario phase failed")
    torch.cuda.empty_cache()
    print(f"verify_plan on the {len(VERIFIED)} plans this run built:")
    for v in VERIFIED:
        print(f"  {v['plan']}: {v['layers']} layers at batch {v['batch']}, errors "
              f"{v['errors'] or 'none'}, notes {v['notes'] or 'none'}")
    if len(VERIFIED) < 12:
        failures.append(f"only {len(VERIFIED)} plans were verified")

    # ---- full-width qwen3-0.6b served through the flash kernels ------------
    lm = {}
    try:
        lm = lm_phase(book, dev, failures)
    except Exception:
        traceback.print_exc()
        failures.append(f"{LM_ARCH} phase failed")

    # ---- full-width qwen3-0.6b trained through the flash backward kernels --
    train_summary = {}
    try:
        train_summary = train_phase(book, dev, failures)
    except Exception:
        traceback.print_exc()
        failures.append(f"{LM_ARCH}-train phase failed")

    csrc = "src/repro_torch/kernels/csrc/"
    # (name, book key, row suffix, source, replaces, the phase that serves it)
    table = (
        ("ecr_conv_batch", "ecr_conv", "", "ecr_conv.cu",
         "src/repro/kernels/ecr_conv/kernel.py:166", "vgg19"),
        ("conv_pool_batch", "conv_pool", "", "ecr_conv.cu",
         "src/repro/kernels/conv_pool/kernel.py:181", "vgg19"),
        ("ecr_conv_batch at N=1", "ecr_conv", "_n1", "ecr_conv.cu",
         "src/repro/kernels/ecr_conv/kernel.py:94", "vgg19"),
        ("conv_pool_batch at N=1", "conv_pool", "_n1", "ecr_conv.cu",
         "src/repro/kernels/conv_pool/kernel.py:98", "vgg19"),
        ("bsr_matmul", "bsr_matmul", "", "bsr_matmul.cu",
         "src/repro/kernels/bsr_matmul/kernel.py:75", "vgg19-pruned"),
        ("ecr_conv_int8_batch", "ecr_conv_int8", "", "ecr_conv_int8.cu",
         "src/repro/quant/kernels.py:183", "vgg19-int8"),
        ("ecr_conv_int8_batch at N=1", "ecr_conv_int8_n1", "", "ecr_conv_int8.cu",
         "src/repro/quant/kernels.py:104", "vgg19-int8"),
        ("bsr_matmul_int8", "bsr_matmul_int8", "", "bsr_matmul_int8.cu",
         "src/repro/quant/kernels.py:252", "vgg19-pruned-int8"),
    )
    # rows whose kernels were redesigned for the tensor cores, and in which PR
    # (16 and 17: fp32 on split-TF32; 15: int8)
    redesigned = {"ecr_conv_batch": 16, "conv_pool_batch": 16, "ecr_conv_batch at N=1": 16,
                  "conv_pool_batch at N=1": 16, "bsr_matmul": 17, "ecr_conv_int8_batch": 15,
                  "ecr_conv_int8_batch at N=1": 15, "bsr_matmul_int8": 15}
    int8_rows = ("ecr_conv_int8_batch", "ecr_conv_int8_batch at N=1", "bsr_matmul_int8")
    kernels = []
    for name, key, sfx, source, replaces, phase in table:
        rows = [r for r in book.rows if r["kernel"] == key and r["phase"] == phase]
        flop_ms = sum(r["flop_ms" + sfx] for r in rows)
        byte_ms = sum(r["byte_ms" + sfx] for r in rows)
        # the engine's buckets hold at least 2 requests: the single-image rows
        # are never launched on the served path
        single = "N=1" in name
        ms = sum(r["ms" + sfx] for r in rows)
        bound = sum(r["bound_ms" + sfx] for r in rows)
        kernels.append({
            "name": name, "route": "cuda", "source": csrc + source,
            "replaces": replaces,
            "launches": 0 if single else phase_launches.get(phase, {}).get(key, 0),
            "max_abs_err": book.max_err.get(key, 0.0),
            "ms": ms,
            "plain_ms": sum(r["plain_ms" + sfx] for r in rows),
            "bound_ms": bound,
            "bound_by": "operations" if flop_ms >= byte_ms else "bytes",
            "library_ms": sum(r["library_ms" + sfx] for r in rows),
            "phase": phase, "layers": [r["layer"] for r in rows]})
        if name in redesigned and ms > 0:
            kernels[-1].update({
                "redesigned_in": redesigned[name],
                "timing": "CUDA-graph replay (plain_ms eager)",
                "eager_ms": sum(r["eager_ms" + sfx] for r in rows),
                "eager_library_ms": sum(r["eager_library_ms" + sfx] for r in rows),
                "achieved_gbs": byte_ms / ms * PEAK_HBM_BYTES / 1e9,
                "bound_share": bound / ms})
            if name not in int8_rows:
                kernels[-1].update({
                    "achieved_tflops": flop_ms / ms * PEAK_TF32_SPLIT_FLOPS / 1e12,
                    "fp32_core_bound_ms": sum(r["fp32_core_bound_ms" + sfx] for r in rows)})
                if single:
                    kernels[-1]["split_reduction"] = False  # not implemented
            else:
                kernels[-1]["achieved_tops"] = flop_ms / ms * PEAK_INT8_OPS / 1e12
        if not rows:
            failures.append(f"no timed layer ran {name}")
    # the flash rows: one prefill plus one decode launch at the served shapes
    # (layer 0), with every timed shape listed under "shapes"
    flash_src = "src/repro/kernels/flash_attention/kernel.py"
    for name, kvd, replaces in (("flash_fwd", "float32", flash_src + ":94"),
                                ("flash_fwd_q8", "int8", flash_src + ":165")):
        rows = [r for r in book.rows if r["kernel"] == name and r["phase"] == LM_ARCH]
        main_rows = [r for r in rows if r["shape"] in ("prefill layer 0", "decode layer 0")]
        flop_ms = sum(r["flop_ms"] for r in main_rows)
        byte_ms = sum(r["byte_ms"] for r in main_rows)
        kernels.append({
            "name": name, "route": "cuda", "source": csrc + "flash_attention.cu",
            "replaces": replaces,
            **({"redesigned_in": 17, "timing": "CUDA-graph replay (plain_ms too)"}
               if name == "flash_fwd" else {}),
            "launches": lm.get("runs", {}).get(kvd, {}).get("launches", {}).get(name, 0),
            "max_abs_err": book.max_err.get(name, 0.0),
            "ms": sum(r["ms"] for r in main_rows),
            "plain_ms": sum(r["plain_ms"] for r in main_rows),
            "bound_ms": sum(r["bound_ms"] for r in main_rows),
            "bound_by": "operations" if flop_ms >= byte_ms else "bytes",
            "library_ms": sum(r["library_ms"] for r in main_rows),
            "phase": LM_ARCH,
            "train_launches": train_summary.get("main", {}).get("launches", {}).get(name, 0),
            "shapes": [{k: r[k] for k in ("shape", "q", "k", "ms", "plain_ms",
                                          "library_ms", "bound_ms", "bound_by")}
                       for r in rows]})
        if len(main_rows) != 2:
            failures.append(f"{name}: the served shapes were not timed")
    # the backward rows: one launch of each pass at the trained shape (layer
    # 0 of a batch-8 step), with every timed shape listed under "shapes"
    for name, site in (("flash_bwd_dq", ":265"), ("flash_bwd_dkv", ":284")):
        rows = [r for r in book.rows if r["kernel"] == name]
        main_rows = [r for r in rows if r["shape"] == "trained layer 0"]
        ms = sum(r["ms"] for r in main_rows)
        bound = sum(r["bound_ms"] for r in main_rows)
        flop_ms = sum(r["flop_ms"] for r in main_rows)
        kernels.append({
            "name": name, "route": "cuda", "source": csrc + "flash_attention_bwd.cu",
            "replaces": flash_src + site,
            "redesigned_in": 18, "timing": "CUDA-graph replay (plain_ms too)",
            "launches": train_summary.get("main", {}).get("launches", {}).get(name, 0),
            "max_abs_err": book.max_err.get(name, 0.0),
            "ms": ms,
            "plain_ms": sum(r["plain_ms"] for r in main_rows),
            "bound_ms": bound,
            "bound_by": main_rows[0]["bound_by"] if main_rows else "operations",
            "library_ms": sum(r["library_ms"] for r in main_rows),
            "eager_ms": sum(r["eager_ms"] for r in main_rows),
            "eager_library_ms": sum(r["eager_library_ms"] for r in main_rows),
            "achieved_tflops": flop_ms / ms * PEAK_TF32_SPLIT_FLOPS / 1e12 if ms else 0.0,
            "bound_share": bound / ms if ms else 0.0,
            "fp32_core_bound_ms": sum(r["fp32_core_bound_ms"] for r in main_rows),
            "phase": LM_ARCH + "-train",
            "shapes": [{k: r[k] for k in ("shape", "q", "k", "ms", "plain_ms",
                                          "library_ms", "eager_ms", "eager_library_ms",
                                          "bound_ms", "bound_by", "fp32_core_bound_ms")}
                       for r in rows]})
        if len(main_rows) != 1:
            failures.append(f"{name}: the trained shape was not timed")
    if args.layers_out is not None:
        args.layers_out.parent.mkdir(parents=True, exist_ok=True)
        args.layers_out.write_text(json.dumps(
            {"card": card, "rows": book.rows, "kernels": kernels,
             "service": services, "variants": variants, "obs": obs, "lm": lm,
             "train": train_summary, "paper": paper, "verifier": verifier,
             "geometry": geometry, "lint": lint, "scenario": scenario,
             "verified": VERIFIED},
            indent=1, default=str))
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
