"""The selective scan (`csrc/selective_scan.cu`) on the card, alone.

Prints the card and its clock, the registers, stack and spills of the
forward's, the backward's and the reduce kernel's instantiations (nvcc's
`-Xptxas -v`) and their SASS counts (FFMA, FMUL, FADD, MUFU, SHFL, LDS, STS,
LDG, STG, LDGSTS, LDL, STL), and the instructions each walk issues a state
and step: a copy of the source with a NANOSLEEP marker around each walk's
body, the SASS between two markers over the steps and states it covers
(walk 1 and the forward: a body unrolled 4 steps; walk 2 and the reverse
walk: a whole chunk each), and the issue-rate floor that count implies
at full-width training (132 SMs x 4 warp instructions a clock). Then, at
the four timed shapes of full-width jamba (di 8192, N 16), operands drawn on
the card (`tests/test_torch_ssm_cuda.py`'s draw):

    prefill      forward fp32, B 4 x S 32, zero state, the model's views
    decode       forward fp32, B 4 x S 1, carried state, views
    train bf16   forward bf16, B 4 x S 128, views
    bwd fp32 / bwd bf16   backward, B 4 x S 128, contiguous

the kernel against the plain version at its limit (fp32 1e-4 * max +
1e-5 * min(1, max), bf16 2^-7 * max), the backward repeated bitwise, and
kernel, plain version and bound (`chip_smoke.scan_bound`, `scan_bwd_bound`)
by CUDA-graph replay in turns; beside them copies of the source with parts
taken out (text patches, each checked to apply; one nvcc per copy, all
started together), their entry points called directly with the wrapper's
arguments:

    full        the kernels as they are
    empty       both kernels return at once (launch and grid alone)
    no-loads    the staging's global loads left out (x, dt, z, dout, B, C
                read as zeros)
    no-exp      the state decays' exp replaced by 1 + x
    no-shfl     the dB / dC butterfly's shuffles left out (each lane adds its own)
    no-bc       the dB / dC butterfly, its warp sums and the partials left out
    no-reduce   the backward's reduce kernel not launched
    skeleton    no-loads, no-exp, no-shfl and no-bc

(the ablated copies' outputs are wrong by design; `full` is held to the
plain version), and, with `--parent FILE`, a selective_scan.cu of an earlier
tree built the same way and held to the plain version too (it takes the
scratch of the kernel that ran one channel a thread: ck (B, ceil(S / 32), N,
di), per-warp partials (4 ceil(di / 128), B, S, 2N), pa (B, N, di), pd (B,
di)). Imports no JAX. Run from the root of a
checkout on a machine with the card:

    python3 scripts/scan_study.py [--parent build/parent_selective_scan.cu]

Exits 1 if a check fails, a repeat differs, or a backward instantiation
uses local memory.
"""
from __future__ import annotations

import argparse
import ctypes
import gc
import re
import subprocess
import sys
import traceback
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
DI, N = 8192, 16
# (label, batch, S, activations, h0 carried, views, backward)
SHAPES = (("prefill", 4, 32, "float32", False, True, False),
          ("decode", 4, 1, "float32", True, True, False),
          ("train bf16", 4, 128, "bfloat16", False, True, False),
          ("bwd fp32", 4, 128, "float32", False, False, True),
          ("bwd bf16", 4, 128, "bfloat16", False, False, True))

VARIANTS = {  # name -> the ablation flags set
    "full": (), "empty": ("EMPTY",), "no-loads": ("NO_LOADS",), "no-exp": ("NO_EXP",),
    "no-shfl": ("NO_SHFL",), "no-bc": ("NO_BC",), "no-reduce": ("NO_REDUCE",),
    "skeleton": ("NO_LOADS", "NO_EXP", "NO_SHFL", "NO_BC"),
}
FLAGS = ("EMPTY", "NO_LOADS", "NO_EXP", "NO_SHFL", "NO_BC", "NO_REDUCE", "MARK")
MARK = "  if (ABL_MARK) __nanosleep(1);\n"
PATCHES = (  # (text, replacement, occurrences)
    ("  constexpr int L = N / kStates, CPB = kFwdThreads / L;\n",
     "  constexpr int L = N / kStates, CPB = kFwdThreads / L;\n"
     "  if (ABL_EMPTY && p.s != -7) return;\n", 1),
    ("  constexpr int L = N / kStates, CPB = kBwdChannels, T = BwdBlock<N>::kThreads;\n",
     "  constexpr int L = N / kStates, CPB = kBwdChannels, T = BwdBlock<N>::kThreads;\n"
     "  if (ABL_EMPTY && p.s != -7) return;\n", 1),
    ("      const bool ok = slive && t < tn;", "      const bool ok = !ABL_NO_LOADS && slive && t < tn;",
     2),
    ("      const bool ok = e < BCN && t < tn;",
     "      const bool ok = !ABL_NO_LOADS && e < BCN && t < tn;", 2),
    ("float decay(float x) { return __expf(x); }",
     "float decay(float x) { return ABL_NO_EXP ? 1.f + x : __expf(x); }", 1),
    ("#include <type_traits>\n", "#include <type_traits>\n#define ABL_SHFL(v, m) "
     "(ABL_NO_SHFL ? (v) : __shfl_xor_sync(~0u, v, m))\n", 1),
    ("__shfl_xor_sync(0xffffffffu, ", "ABL_SHFL(", 4),
    ("        const float r = channel_sum<L>(v, lane);\n        if (stores) s_bc[w][t][slot] = r;",
     "        if (!ABL_NO_BC) {\n          const float r = channel_sum<L>(v, lane);\n"
     "          if (stores) s_bc[w][t][slot] = r;\n        }", 1),
    ("    for (int i = 0; i < kChunk * SLOTS / T; ++i) {",
     "    for (int i = 0; i < (ABL_NO_BC ? 0 : kChunk * SLOTS / T); ++i) {", 1),
    ("  const long long blocks = ((long long)p.nb * p.s * 2 * N + 31) / 32 +",
     "  if (ABL_NO_REDUCE) return 0;\n  const long long blocks = ((long long)p.nb * p.s * 2 * N + 31) / 32 +",
     1),
    # the markers: around the forward's walk, walk 1's body, walk 2, the reverse walk
    ("#pragma unroll 4\n    for (int t = 0; t < kFwdChunk; ++t) {",
     MARK + "#pragma unroll 4\n    for (int t = 0; t < kFwdChunk; ++t) {", 1),
    ("        s_y[t][tid] = y;\n      }\n    }\n", "        s_y[t][tid] = y;\n      }\n    }\n" + MARK,
     2),
    ("#pragma unroll 4\n    for (int t = 0; t < kChunk; ++t) {",
     MARK + "#pragma unroll 4\n    for (int t = 0; t < kChunk; ++t) {", 1),
    ("      for (int j = 0; j < kStates; ++j) h[j] = decay(dtv * av[j]) * h[j] + u * bb[j];\n"
     "    }\n",
     "      for (int j = 0; j < kStates; ++j) h[j] = decay(dtv * av[j]) * h[j] + u * bb[j];\n"
     "    }\n" + MARK, 1),
    ("    // walk 2: the chunk's states, kept, and each lane's part of y\n",
     MARK + "    // walk 2: the chunk's states, kept, and each lane's part of y\n", 1),
    ("#pragma unroll\n    for (int j = 0; j < kStates; ++j) hs[j] = rck[j];\n",
     MARK + "#pragma unroll\n    for (int j = 0; j < kStates; ++j) hs[j] = rck[j];\n", 1),
)
ENTRIES = ("repro_selective_scan_f32", "repro_selective_scan_bf16",
           "repro_selective_scan_bwd_f32", "repro_selective_scan_bwd_bf16")
OPS = ("FFMA", "FMUL", "FADD", "MUFU", "SHFL", "LDS", "STS", "LDG", "STG", "LDGSTS", "LDL",
       "STL")


def _nvcc(kcuda, src: Path, out: Path, defs=()) -> subprocess.Popen:
    return subprocess.Popen([kcuda.nvcc_path(), *kcuda.NVCC_FLAGS, *defs, f"-I{kcuda.CSRC}",
                             "-shared", "-o", str(out), str(src)],
                            stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)


def _unprefixed(symbol: str) -> str:
    """A kernel symbol without its anonymous namespace's file tag."""
    return re.sub(r"^.*?_cu_[0-9a-f]+", "", symbol)


def _load(path: Path) -> ctypes.CDLL:
    lib = ctypes.CDLL(str(path))
    for entry in ENTRIES:
        fn = getattr(lib, entry)
        fn.argtypes = ([ctypes.c_void_p] * 22 + [ctypes.POINTER(ctypes.c_int), ctypes.c_void_p]
                       if "_bwd_" in entry else
                       [ctypes.c_void_p] * 10 + [ctypes.POINTER(ctypes.c_int),
                                                 ctypes.POINTER(ctypes.c_longlong),
                                                 ctypes.c_void_p])
        fn.restype = ctypes.c_int
    return lib


def build(kcuda, parent) -> tuple:
    """({variant: loaded library} of the patched copies, the parent's library
    or None, nvcc's -Xptxas -v report of the `full` copy, the marked copy's
    path)."""
    src = (kcuda.CSRC / "selective_scan.cu").read_text()
    for old, new, count in PATCHES:
        if src.count(old) != count:
            raise RuntimeError(f"patch does not apply ({src.count(old)} x): {old!r}")
        src = src.replace(old, new)
    out = kcuda.build_dir() / "scan_ablation"
    out.mkdir(parents=True, exist_ok=True)
    (out / "ablation.cu").write_text(src)
    runs = dict(VARIANTS, marked=("MARK",))
    procs = {name: _nvcc(kcuda, out / "ablation.cu", out / f"{name}.so",
                         [f"-DABL_{f}={int(f in on)}" for f in FLAGS]
                         + (["-Xptxas", "-v"] if name == "full" else []))
             for name, on in runs.items()}
    if parent:
        procs["parent"] = _nvcc(kcuda, Path(parent).resolve(), out / "parent.so")
    libs, report = {}, ""
    for name, proc in procs.items():
        sout, err = proc.communicate()
        if proc.returncode:
            raise RuntimeError(f"nvcc failed for {name}:\n{err[-4000:]}")
        if name == "full":
            report = sout + err
        if name != "marked":
            libs[name] = _load(out / f"{name}.so")
    return libs, libs.pop("parent", None), report, out / "marked.so"


def marked_counts(kcuda, path: Path) -> dict:
    """{kernel symbol: [instructions between consecutive NANOSLEEP markers]}
    of the marked copy's SASS."""
    cuobjdump = Path(kcuda.nvcc_path()).with_name("cuobjdump")
    r = subprocess.run([str(cuobjdump), "-sass", str(path)], capture_output=True, text=True,
                       timeout=300)
    if r.returncode != 0:
        raise RuntimeError(f"cuobjdump failed: {r.stderr.strip()}")
    spans, fn, count = {}, None, None
    for line in r.stdout.splitlines():
        m = re.search(r"Function : (\S+)", line)
        if m:
            fn, count = m.group(1), None
            spans[fn] = []
            continue
        m = re.search(r"/\*[0-9a-f]{4,}\*/\s+(?:@!?U?P\w+\s+)?([A-Z][A-Z0-9]*)", line)
        if not (m and fn):
            continue
        if m.group(1) == "NANOSLEEP":
            if count is not None:
                spans[fn].append(count)
            count = 0
        elif count is not None:
            count += 1
    return spans


def clock_mhz() -> float:
    r = subprocess.run(["nvidia-smi", "--query-gpu=clocks.max.sm", "--format=csv,noheader,nounits"],
                       capture_output=True, text=True, timeout=60)
    return float(r.stdout.strip().splitlines()[0])


def operands(dev, b, s, dtype, h0, views, seed):
    """The scan's operands at full width (`tests/test_torch_ssm_cuda.py`'s
    draw): dt a softplus, A = -exp(log(1..N) + noise), B, C, x, z standard
    normal; `views`: x, z the halves of one (B, S, 2 di) tensor and B, C
    slices of one (B, S, 8 + 2N) projection."""
    import numpy as np
    import torch

    rng = np.random.default_rng(seed)

    def t(*shape, scale=1.0):
        return torch.from_numpy((scale * rng.standard_normal(shape)).astype(np.float32)).to(dev)

    if views:
        xz = t(b, s, 2 * DI)
        x, z = xz[..., :DI], xz[..., DI:]
        proj = t(b, s, 8 + 2 * N)
        bm, cm = proj[..., 8:8 + N], proj[..., 8 + N:]
    else:
        x, z, bm, cm = t(b, s, DI), t(b, s, DI), t(b, s, N), t(b, s, N)
    dt = torch.nn.functional.softplus(t(b, s, DI))
    a_log = torch.log(torch.arange(1, N + 1, dtype=torch.float32, device=dev)).repeat(DI, 1)
    a = -torch.exp(a_log + t(DI, N, scale=0.1))
    d = 1 + t(DI, scale=0.2)
    h = t(b, DI, N) if h0 else torch.zeros((b, DI, N), device=dev)
    act = getattr(torch, dtype)
    return [v.to(act) if i in (0, 1, 5, 6) else v for i, v in enumerate((x, dt, a, bm, cm, d, z, h))]


def fwd_calls(libs, args) -> tuple:
    """({name: call} of each library's forward entry on the wrapper's
    arguments, (out, h_last))."""
    import torch

    x, dt, a, bm, cm, d, z, h0 = args
    b, s, di = x.shape
    n = a.shape[1]
    out = torch.empty((b, s, di), device=x.device, dtype=x.dtype)
    h_last = torch.empty((b, di, n), device=x.device)
    entry = ENTRIES[x.dtype == torch.bfloat16]
    dims = (ctypes.c_int * 4)(b, s, di, n)
    strides = (ctypes.c_longlong * 10)(*(st for t in (x, dt, z, bm, cm)
                                         for st in (t.stride(0), t.stride(1))))
    ptrs = [t.data_ptr() for t in (x, dt, z, bm, cm, a, d, h0, out, h_last)]

    def call(lib):
        fn = getattr(lib, entry)
        return lambda: fn(*ptrs, dims, strides, torch.cuda.current_stream().cuda_stream)

    return {name: call(lib) for name, lib in libs.items()}, (out, h_last)


def bwd_calls(kcuda, libs, parent, args, dout, dh_last) -> tuple:
    """({name: call} of each library's backward entry, with its own
    scratch, the eight gradients' buffers)."""
    import torch

    x, dt, a, bm, cm, d, z, h0 = args
    b, s, di = x.shape
    n = a.shape[1]
    dev = x.device

    def empty(shape, dtype=torch.float32):
        return torch.empty(shape, device=dev, dtype=dtype)

    dx, ddt, dz = (empty((b, s, di), x.dtype) for _ in range(3))
    dh0, db, dc, da, dd = (empty(h0.shape), empty(bm.shape), empty(cm.shape), empty(a.shape),
                           empty(d.shape, d.dtype))
    new = tuple(map(empty, kcuda.scan_bwd_scratch(b, s, di, n).values()))
    old = (empty((b, -(-s // 32), n, di)), empty((4 * -(-di // 128), b, s, 2 * n)),
           empty((b, n, di)), empty((b, di)))
    entry = ENTRIES[2 + (x.dtype == torch.bfloat16)]
    dims = (ctypes.c_int * 4)(b, s, di, n)

    def call(lib, scratch):
        fn = getattr(lib, entry)
        ptrs = [t.data_ptr() for t in (x, dt, z, bm, cm, a, d, h0, dout, dh_last, dx, ddt, dz,
                                       dh0) + scratch + (db, dc, da, dd)]

        def run():
            return fn(*ptrs, dims, torch.cuda.current_stream().cuda_stream)

        run.scratch = scratch  # alive as long as the call is
        return run

    fns = {name: call(lib, new) for name, lib in libs.items()}
    if parent is not None:
        fns["parent"] = call(parent, old)
    return fns, (dx, ddt, da, db, dc, dd, dz, dh0)


def held(got, want) -> float:
    """max|got - want| over the limit, worst part (<= 1 holds)."""
    import torch

    worst = 0.0
    for g, w in zip(got, want):
        scale = float(w.float().abs().max())
        err = float((g.float() - w.float()).abs().max())
        lim = (2.0 ** -7 * scale if w.dtype == torch.bfloat16
               else 1e-4 * scale + 1e-5 * min(1.0, scale))
        worst = max(worst, err / lim if lim else float(err > 0))
    return worst


def study_shape(cs, kcuda, K, libs, parent, dev, shape, failures) -> None:
    import torch

    label, b, s, dtype, h0, views, bwd = shape
    args = operands(dev, b, s, dtype, h0, views, seed=s + b)
    if bwd:
        args = [t.contiguous() for t in args]
        gen = torch.Generator(device=dev).manual_seed(s)
        dout = torch.randn((b, s, DI), device=dev, generator=gen).to(args[0].dtype)
        dh_last = torch.zeros((b, DI, N), device=dev)
        fns, bufs = bwd_calls(kcuda, libs, parent, args, dout, dh_last)
        plain = lambda: K.selective_scan_bwd_plain(*args, dout, dh_last)  # noqa: E731
        ft, bt = cs.scan_bwd_bound(args)
    else:
        all_libs = dict(libs, **({"parent": parent} if parent is not None else {}))
        fns, bufs = fwd_calls(all_libs, args)
        plain = lambda: K.selective_scan_plain(*args)  # noqa: E731
        ft, bt = cs.scan_bound(args)
    with torch.no_grad():
        want = plain()
        for key in ("full", "parent"):
            if key not in fns:
                continue
            if fns[key]() != 0:
                raise RuntimeError(f"{key}: launch failed")
            torch.cuda.synchronize()
            worst = held(bufs, want)
            first = [t.clone() for t in bufs]
            fns[key]()
            torch.cuda.synchronize()
            same = all(torch.equal(x, y) for x, y in zip(first, bufs))
            print(f"{label} {key}: max|kernel - plain| / limit {worst:.3f}; a repeat "
                  f"bitwise the same: {same}")
            if worst > 1.0 or not same:
                failures.append(f"{label} {key}")
        for key, fn in fns.items():
            if fn() != 0:
                raise RuntimeError(f"{key}: launch failed")
        fns["plain"] = plain
        t = cs.time_graph_turns(fns)
    bound = max(ft, bt)
    print(f"{label}: B {b} x S {s}, di {DI}, N {N}, {dtype}, ms by CUDA-graph replay; bound "
          f"{bound:.4f} ms ({'operations' if ft >= bt else 'bytes'}; operations {ft:.4f}, "
          f"bytes {bt:.4f}):")
    for key, v in t.items():
        share = f", {100 * bound / v:.1f}% of the bound" if key in ("full", "parent") else ""
        print(f"  {key:10s} {v:.4f}{share}")
    del args, want, fns, bufs
    gc.collect()
    torch.cuda.empty_cache()


def main() -> int:
    import torch

    ap = argparse.ArgumentParser()
    ap.add_argument("--parent", help="a selective_scan.cu of an earlier tree, timed beside")
    opts = ap.parse_args()
    if not torch.cuda.is_available():
        print("scan_study: no CUDA device", file=sys.stderr)
        return 1
    sys.path[:0] = [str(ROOT), str(ROOT / "src")]
    import chip_smoke as cs
    from repro_torch.device import resolve_device, strict_fp32
    from repro_torch.kernels import cuda as kcuda
    from repro_torch.kernels.selective_scan import kernel as K

    dev = resolve_device("cuda")
    strict_fp32()
    mhz = clock_mhz()
    print(f"card: {cs.card_line()}; max SM clock {mhz:.0f} MHz; torch {torch.__version__} "
          f"cuda {torch.version.cuda}")
    failures = []
    libs, parent, report, marked = build(kcuda, opts.parent)
    usage = {_unprefixed(k): v for k, v in cs.ptxas_usage(report).items()}
    full = kcuda.build_dir() / "scan_ablation" / "full.so"
    for fn, ops in sorted(cs.sass_counts(full).items()):
        res = usage.get(_unprefixed(fn), {})
        print(f"sass {_unprefixed(fn)[:90]}: " + ", ".join(f"{op} {ops.get(op, 0)}" for op in OPS)
              + f", all {sum(ops.values())}; registers {res.get('registers')}, stack "
                f"{res.get('stack')} B, spill stores {res.get('spill_stores')} B, loads "
                f"{res.get('spill_loads')} B")
        if "bwd_kernel" in fn and (ops.get("LDL") or ops.get("STL") or res.get("stack")):
            failures.append(f"{fn}: local memory in the backward")
    # instructions a state and step, and the floor they set at full-width
    # training (B 4, S 128, di 8192, N 16; 8 chunks: walk 1 covers 7)
    steps = 4 * 128 * DI * N
    rate = 132 * 4 * mhz * 1e6  # warp instructions a second
    for fn, spans in sorted(marked_counts(kcuda, marked).items()):
        name = _unprefixed(fn)
        if "Li16E" not in name or "reduce" in name:
            continue
        if "selective_scan_kernel" in name and len(spans) >= 1:
            per = spans[0] / (4 * 4)
            print(f"{name[:60]}: forward walk {spans[0]} instructions over 4 steps x 4 states: "
                  f"{per:.1f} a state and step")
        elif "selective_scan_bwd_kernel" in name and len(spans) >= 4:
            kc = kcuda.SCAN_CHUNK
            w1, w2, rev = spans[0] / (4 * 4), spans[2] / (kc * 4), spans[3] / (kc * 4)
            per = w1 * (1 - kc / 128) + w2 + rev  # walk 1 stops a chunk short of S 128
            print(f"{name[:60]}: walk 1 {spans[0]} instructions over 4 steps x 4 states "
                  f"({w1:.1f} a state and step); walk 2 {spans[2]} over {kc} x 4 ({w2:.1f}); "
                  f"reverse {spans[3]} over {kc} x 4 ({rev:.1f}); at S 128 {per:.1f} a state "
                  f"and step: floor {per * steps / 32 / rate * 1e3:.4f} ms at {mhz:.0f} MHz")
        else:
            print(f"{name[:60]}: marker spans {spans}")
    for shape in SHAPES:
        try:
            study_shape(cs, kcuda, K, libs, parent, dev, shape, failures)
        except Exception:
            traceback.print_exc()
            failures.append(shape[0])
    for f in failures:
        print(f"FAILED: {f}", file=sys.stderr)
    return 1 if failures else 0


if __name__ == "__main__":
    sys.exit(main())
