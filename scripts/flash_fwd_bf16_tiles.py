#!/usr/bin/env python3
"""Compare block geometries of the bf16 flash forward on the card: build
`flash_attention.cu` once per geometry (the rows a block owns, BM; the keys
per ring tile, KN; the blocks per SM it is built for), check each
build against the plain version, and time them in turns beside SDPA and the
committed kernel by CUDA-graph replay.

    python3 scripts/flash_fwd_bf16_tiles.py [--build NAME=DIR ...]

A dev study, not part of the library: the committed kernel has one geometry
per head dim (`Bf16Fwd<D>` in csrc/flash_attention.cu), and this script
rewrites its `static constexpr` lines in a copy of the sources under
build/fwd_tiles/ to make the others. `--build NAME=DIR` also builds
DIR/flash_attention.cu as it is, e.g. the csrc/ of the parent commit's
checkout (a before / after in one run). Shapes: the trained forward (qwen3-0.6b layer 0, B8,
S128, KV 8, G 2, D 128, causal) and B4, Sq = Sk = 2048 causal at every
head dim. Prints the card's name and power limit, each build's
registers and spill per head dim (ptxas -v), and per shape one line per
geometry: ms, against SDPA's and the committed kernel's ms of the same
turns, the bound and the bound share. Exits 1 if a build fails its check
(out within 2^-7 max|plain|, m and l within 1e-5 max|plain|).
"""
from __future__ import annotations

import argparse
import ctypes
import re
import shutil
import subprocess
import sys
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / "src"))
sys.path.insert(0, str(ROOT))
import chip_smoke as cs  # noqa: E402
from repro_torch.kernels import cuda as kcuda  # noqa: E402
from repro_torch.kernels.flash_attention.kernel import flash_fwd, flash_fwd_plain  # noqa: E402

# name -> replacements of Bf16Fwd<D>'s constants (C++ expressions in D); the
# committed geometry is timed beside them as "committed"
GEOMETRIES = {
    "bm128": {"BM": "128", "kMinBlocks": "1"},
    "kn32": {"KN": "32"},
    "min2": {"kMinBlocks": "2"},
    "su2": {"SU": "D == 256 ? 2 : KS"},
}
# (label, b, sq, kv heads, g, sk, d): the trained forward, then B4, 2048^2
# causal at every head dim
SHAPES = [("trained", 8, 128, 8, 2, 128, 128)] + [
    (f"long d{d}", 4, 2048, 8, 2, 2048, d) for d in (8, 16, 32, 64, 128, 256)]


def variant_source(csrc: Path, consts: dict) -> str:
    src = (csrc / "flash_attention.cu").read_text()
    start = src.index("struct Bf16Fwd {")
    end = src.index("};", start)
    body = src[start:end]
    for name, expr in consts.items():
        body, n = re.subn(rf"(static constexpr (?:int|bool) {name} = )[^;]*;",
                          rf"\g<1>{expr};", body)
        if n != 1:
            raise RuntimeError(f"Bf16Fwd has no single constant {name}")
    return src[:start] + body + src[end:]


def build_all(out: Path, extra: dict) -> dict:
    """{name: (library path, ptxas text)}, every build compiled in parallel:
    the geometries, and the csrc/ directories `extra` names as they are."""
    nvcc = kcuda.nvcc_path()
    jobs = {}
    for name, consts in GEOMETRIES.items():
        d = out / name
        shutil.copytree(kcuda.CSRC, d)
        (d / "flash_attention.cu").write_text(variant_source(kcuda.CSRC, consts))
        jobs[name] = d
    for name, src in extra.items():
        shutil.copytree(src, out / name)
        jobs[name] = out / name
    procs = {name: subprocess.Popen(
        [nvcc, *kcuda.NVCC_FLAGS, "-Xptxas", "-v", "-shared", "-o", str(d / "lib.so"),
         str(d / "flash_attention.cu")], stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
        text=True) for name, d in jobs.items()}
    built = {}
    for name, p in procs.items():
        text, _ = p.communicate()
        if p.returncode != 0:
            raise RuntimeError(f"nvcc failed for {name}:\n{text}")
        built[name] = (jobs[name] / "lib.so", text)
    return built


def entry(lib_path: Path):
    lib = ctypes.CDLL(str(lib_path))
    fn = lib.repro_flash_fwd_bf16
    fn.argtypes = [ctypes.c_void_p] * 6 + [ctypes.POINTER(ctypes.c_int),
                                           ctypes.POINTER(ctypes.c_longlong),
                                           ctypes.c_float, ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


def caller(fn, q, k, v, kw):
    """A closure launching `fn` (a build's repro_flash_fwd_bf16) as
    kernels.cuda.launch_flash does, into preallocated out, m and l."""
    nbkv, nh, g, sq, sk, d = kcuda.check_flash_operands(q, k, v)
    out = torch.empty_like(q)
    m = torch.empty((nbkv, g, sq), device=q.device)
    l = torch.empty((nbkv, g, sq), device=q.device)
    dims = kcuda._flash_dims(nbkv, nh, g, sq, sk, d, kw["causal"], kw["q_offset"],
                             kw["kv_len"])
    strides = (ctypes.c_longlong * 17)(*kcuda.flash_strides(q, k, v, out))

    def run():
        err = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), m.data_ptr(),
                 l.data_ptr(), dims, strides, float(kw["scale"]),
                 torch.cuda.current_stream().cuda_stream)
        if err:
            raise RuntimeError(f"launch failed: cudaError {err}")
        return out, m, l
    return run


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--build", action="append", default=[], metavar="NAME=DIR",
                    help="also build DIR/flash_attention.cu as it is, as NAME")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("flash_fwd_bf16_tiles: needs a CUDA device", file=sys.stderr)
        return 1
    print(cs.card_line())
    out = kcuda.build_dir().parent / "fwd_tiles"
    shutil.rmtree(out, ignore_errors=True)
    built = build_all(out, dict(b.split("=", 1) for b in args.build))
    for name, (_, text) in built.items():
        regs = {}
        for fn, u in cs.ptxas_usage(text).items():
            m = re.search(r"flash_fwd_bf16_kernelILi(\d+)E", fn)
            if m:
                regs[int(m.group(1))] = (u.get("registers"), u.get("spill_stores"))
        print(f"{name}: registers, spill stores by head dim {dict(sorted(regs.items()))}")
    fns = {name: entry(path) for name, (path, _) in built.items()}
    gen = torch.Generator(device="cuda").manual_seed(0)
    failed = []
    for label, b, sq, kvh, g, sk, d in SHAPES:
        q = torch.randn((b, sq, kvh, g, d), generator=gen, device="cuda").bfloat16()
        k = torch.randn((b, sk, kvh, d), generator=gen, device="cuda").bfloat16()
        v = torch.randn((b, sk, kvh, d), generator=gen, device="cuda").bfloat16()
        kw = dict(scale=d ** -0.5, causal=True, q_offset=0, kv_len=None)
        po, pm, pl = flash_fwd_plain(q, k, v, **kw)
        runs = {name: caller(fn, q, k, v, kw) for name, fn in fns.items()}
        for name, run in runs.items():
            o, m, l = run()
            torch.cuda.synchronize()
            errs = (float((o.float() - po.float()).abs().max()) / float(po.float().abs().max()),
                    float((m - pm).abs().max()) / float(pm.abs().max()),
                    float((l - pl).abs().max()) / float(pl.abs().max()))
            if not (errs[0] <= 2.0 ** -7 and errs[1] <= 1e-5 and errs[2] <= 1e-5):
                failed.append((label, name, errs))
        timed = dict(runs)
        timed["committed"] = lambda: flash_fwd(q, k, v, **kw)
        timed["sdpa"] = cs.flash_library(q, k, v, kw)
        t = cs.time_graph_turns(timed)
        ft, bt = cs.flash_bound(q, k, kw, q8=False)
        bound = max(ft, bt)
        print(f"{label} q{tuple(q.shape)}: SDPA {t['sdpa']:.4f} ms, committed "
              f"{t['committed']:.4f} ms, bound {bound:.4f} ms "
              f"({'operations' if ft >= bt else 'bytes'}) [CUDA-graph replay]")
        for name in runs:
            print(f"  {name:16s} {t[name]:.4f} ms  {t[name] / t['sdpa']:.2f}x SDPA  "
                  f"bound share {bound / t[name]:.1%}")
        del q, k, v, po, pm, pl, runs, timed
        torch.cuda.empty_cache()
    print("failed checks:", failed or "none")
    return 1 if failed else 0


if __name__ == "__main__":
    sys.exit(main())
