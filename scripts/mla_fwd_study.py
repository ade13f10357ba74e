"""The MLA forward (`csrc/flash_mla.cu`) on the card, alone.

Prints the card, the registers, stack and spills of the kernel's and the
combine's instantiations (nvcc's `-Xptxas -v`) and their SASS counts
(HMMA, LDGSTS, LDSM, LDS, FFMA); then, at full width with 128 heads on
operands drawn on the card at deepseek-v2-236b's served shapes (B 4: the
prefill, Sq 32 over a 64-slot stacked cache at kv_len 32; a decode step,
Sq 1 at kv_len 33; and a decode over 4,096 keys) and at its full-width
sublayer's training shape (B 2, causal S 128: rows past the key ring),
fp32 and bf16 latent:
the kernel against the plain version at its limits, and kernel, plain,
SDPA and the bound by CUDA-graph replay in turns (`chip_smoke.check_mla`),
with the split `mla_fwd_split` chose.

Last, where the time goes at each of those shapes: copies of the source
with parts taken out (text patches, each checked to apply; one nvcc per
copy, all started together, into the build directory), their entry points
called directly with the wrapper's arguments and timed in turns:

    full        the kernel as it is
    empty       the kernel returns at once (launch and grid alone)
    no-q        Q's copies left out (the q tiles as found)
    no-stage    the key tiles never staged (the ring's contents as found)
    no-s        S's MMAs and their key fragment loads left out
    no-pv       P.V's MMAs and their value fragment loads left out
    no-mma      both
    no-exchange warp 0's part of S taken for S (no sum over the warps' parts)
    no-write    out, m and l not written (decided at run time, so nothing
                upstream is dropped)
    no-combine  the key-split combine kernel not launched
    skeleton    no-q, no-stage and no-mma (barriers, softmax, writes left)

(the ablated copies' outputs are wrong by design; `full` is held to the
plain version), beside the wrapper (`flash_fwd_mla`) and, with `--parent
FILE`, a flash_mla.cu of an earlier tree built the same way (its entry
points taking a workspace and a split, as these do), held to the plain
version too.
Imports no JAX. Run from the root of a checkout on a machine with the
card:

    python3 scripts/mla_fwd_study.py [--parent build/parent_flash_mla.cu]

Exits 1 if a check fails or an MLA instantiation lacks HMMA or LDGSTS (or,
over a bf16 latent, LDSM).
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
# (label, B, Sq, Sk, q_offset, kv_len, stacked): deepseek-v2's served
# prefill and first decode step (a 64-slot cache of 2 layers, read in
# place), a decode over 4,096 keys, and the full-width sublayer's training
# forward (`chip_smoke.MLA_TRAIN`); 128 heads throughout
SHAPES = (("prefill", 4, 32, 64, 0, 32, True), ("decode", 4, 1, 64, 32, 33, True),
          ("decode 4096", 4, 1, 4096, 4095, 4096, False),
          ("train", 2, 128, 128, 0, None, False))

VARIANTS = {  # name -> the ablation flags set
    "full": (), "empty": ("EMPTY",), "no-q": ("NO_Q",), "no-stage": ("NO_STAGE",),
    "no-s": ("NO_S",), "no-pv": ("NO_PV",), "no-mma": ("NO_S", "NO_PV"),
    "no-exchange": ("NO_EXCHANGE",), "no-write": ("NO_WRITE",), "no-combine": ("NO_COMBINE",),
    "skeleton": ("NO_Q", "NO_STAGE", "NO_S", "NO_PV"),
}
FLAGS = ("EMPTY", "NO_Q", "NO_STAGE", "NO_S", "NO_PV", "NO_EXCHANGE", "NO_WRITE", "NO_COMBINE")
PATCHES = (  # (text, replacement, occurrences)
    ("  constexpr int PP = G::PP;\n",
     "  constexpr int PP = G::PP;\n  if (ABL_EMPTY && p.kv_len != -7) return;\n", 1),
    ("      cp_async16(smem_addr(dst + r * G::QP + 4 * c)",
     "      if (!ABL_NO_Q) cp_async16(smem_addr(dst + r * G::QP + 4 * c)", 1),
    ("        stage_keys<KT, R, DR, NCS>(ring + s * kKeys * KP",
     "        if (!ABL_NO_STAGE) stage_keys<KT, R, DR, NCS>(ring + s * kKeys * KP", 1),
    ("for (int i0 = 0; i0 < QS; i0 += G::SU) {",
     "for (int i0 = 0; i0 < (ABL_NO_S ? 0 : QS); i0 += G::SU) {", 1),
    ("for (int w = 1; w < kWarps; ++w) x += part",
     "for (int w = 1; w < (ABL_NO_EXCHANGE ? 1 : kWarps); ++w) x += part", 1),
    ("            if (j >= nj) break;", "            if (j >= nj || ABL_NO_PV) break;", 1),
    ("for (int n = 0; n < NW; n += 2) {", "for (int n = 0; n < (ABL_NO_PV ? 0 : NW); n += 2) {", 1),
    ("        if (row >= p.rows) continue;",
     "        if (row >= p.rows || (ABL_NO_WRITE && p.kv_len != -7)) continue;", 1),
    ("  if (p.nks > 1) {\n    const long long threads",
     "  if (p.nks > 1 && !ABL_NO_COMBINE) {\n    const long long threads", 1),
)
ENTRIES = ("repro_flash_fwd_mla_f32", "repro_flash_fwd_mla_bf16kv")


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
        fn.argtypes = [ctypes.c_void_p] * 7 + [ctypes.POINTER(ctypes.c_int),
                                                    ctypes.POINTER(ctypes.c_longlong),
                                                    ctypes.c_float, ctypes.c_void_p]
        fn.restype = ctypes.c_int
    return lib


def build(kcuda, parent) -> tuple:
    """({variant: loaded library} of the patched copies, the parent's library
    or None, nvcc's -Xptxas -v report of the `full` copy)."""
    src = (kcuda.CSRC / "flash_mla.cu").read_text()
    for old, new, count in PATCHES:
        if src.count(old) != count:
            raise RuntimeError(f"patch does not apply ({src.count(old)} x): {old!r}")
        src = src.replace(old, new)
    out = kcuda.build_dir() / "mla_fwd_ablation"
    out.mkdir(parents=True, exist_ok=True)
    (out / "ablation.cu").write_text(src)
    procs = {name: _nvcc(kcuda, out / "ablation.cu", out / f"{name}.so",
                         [f"-DABL_{f}={int(f in on)}" for f in FLAGS]
                         + (["-Xptxas", "-v"] if name == "full" else []))
             for name, on in VARIANTS.items()}
    if parent:
        procs["parent"] = _nvcc(kcuda, Path(parent).resolve(), out / "parent.so")
    libs, report = {}, ""
    for name, proc in procs.items():
        sout, err = proc.communicate()
        if proc.returncode:
            raise RuntimeError(f"nvcc failed for {name}:\n{err[-4000:]}")
        libs[name] = _load(out / f"{name}.so")
        if name == "full":
            report = sout + err
    return libs, libs.pop("parent", None), report


def operands(dev, dtype, batch, sq, sk, q_offset, kv_len, stacked, seed):
    """(args, kw) at full width, 128 heads: q fp32, the latents in `dtype`
    (layer 0 of a 2-layer stacked cache when `stacked`)."""
    import torch

    gen = torch.Generator(device=dev).manual_seed(seed)
    lead = (2,) if stacked else ()
    q = torch.randn((batch, sq, 128, 576), generator=gen, device=dev)
    c = torch.randn(lead + (batch, sk, 512), generator=gen, device=dev).to(dtype)
    k = torch.randn(lead + (batch, sk, 64), generator=gen, device=dev).to(dtype)
    if stacked:
        c, k = c[0], k[0]
    return (q, c, k), dict(scale=192 ** -0.5, causal=True, q_offset=q_offset, kv_len=kv_len)


def direct_calls(kcuda, libs, parent, args, kw) -> dict:
    """{name: call} of each library's entry point on the wrapper's
    arguments (outputs allocated once)."""
    import torch

    q, c, k = args
    b, sq, h, _ = q.shape
    sk, r, dr = c.shape[1], c.shape[2], k.shape[2]
    entry = ENTRIES[c.dtype == torch.bfloat16]
    out = torch.empty((b, sq, h, r), device=q.device, dtype=c.dtype)
    m = torch.empty((b, sq * h), device=q.device)
    l = torch.empty((b, sq * h), device=q.device)
    kvl = -1 if kw["kv_len"] is None else kw["kv_len"]
    split = kcuda.mla_fwd_split(b, sq * h, kcuda.mla_visit_end(
        sq, sk, kw["causal"], kw["q_offset"], kw["kv_len"]), r)
    ws = torch.empty(split[2] * b * sq * h * (r + 2), device=q.device)
    head = (b, h, sq, sk, r, dr, 1, kw["q_offset"], kvl)
    dims = (ctypes.c_int * 12)(*head, *split)
    strides = (ctypes.c_longlong * 10)(q.stride(0), q.stride(1), q.stride(2), c.stride(0),
                                       c.stride(1), k.stride(0), k.stride(1), out.stride(0),
                                       out.stride(1), out.stride(2))
    ptrs = [t.data_ptr() for t in (q, c, k, out, m, l)]

    def call(lib):
        fn = getattr(lib, entry)

        def run():
            stream = torch.cuda.current_stream().cuda_stream
            return fn(*ptrs, ws.data_ptr(), dims, strides, kw["scale"], stream)
        return run

    fns = {name: call(lib) for name, lib in libs.items()}
    if parent is not None:
        fns["parent"] = call(parent)
    return fns, (out, m, l), split


def ablation(cs, kcuda, K, libs, parent, dev, failures) -> None:
    """The ablation table at each shape, fp32 and bf16 latent."""
    import torch

    for label, batch, sq, sk, q_offset, kv_len, stacked in SHAPES:
        for dtype, sfx in ((torch.float32, "f32"), (torch.bfloat16, "bf16")):
            args, kw = operands(dev, dtype, batch, sq, sk, q_offset, kv_len, stacked,
                                seed=sk + sq)
            fns, (out, m, l), split = direct_calls(kcuda, libs, parent, args, kw)
            want = K.flash_fwd_mla_plain(*args, **kw)
            for key in ("full", "parent"):
                if key not in fns:
                    continue
                if fns[key]() != 0:
                    raise RuntimeError(f"{key}: launch failed")
                torch.cuda.synchronize()
                errs = [float((g.float() - w.float()).abs().max() / w.float().abs().max())
                        for g, w in zip((out, m, l), want)]
                lim = 2.0 ** -7 if dtype == torch.bfloat16 else 1e-4
                ok = errs[0] <= lim * 1.5 and max(errs[1:]) <= 2e-5
                print(f"{label} {sfx} {key}: max|kernel - plain| / max|plain| (out, m, l) "
                      + ", ".join(f"{e:.2e}" for e in errs) + ("" if ok else "  FAILED"))
                if not ok:
                    failures.append(f"{label} {sfx} {key}")
            for key, fn in fns.items():
                if fn() != 0:
                    raise RuntimeError(f"{key}: launch failed")
            fns["wrapper"] = lambda: K.flash_fwd_mla(*args, **kw)
            t = cs.time_graph_turns(fns)
            print(f"{label}, {sfx}, split (row tiles a block, column slices, key chunks) "
                  f"{split}, ms by CUDA-graph replay:")
            for key, v in t.items():
                print(f"  {key:12s} {v:.4f}")
            del args, want, fns
            gc.collect()
            torch.cuda.empty_cache()


def main() -> int:
    import torch

    ap = argparse.ArgumentParser()
    ap.add_argument("--parent", help="a flash_mla.cu of an earlier tree, timed beside")
    opts = ap.parse_args()
    if not torch.cuda.is_available():
        print("mla_fwd_study: no CUDA device", file=sys.stderr)
        return 1
    sys.path[:0] = [str(ROOT), str(ROOT / "src")]
    import chip_smoke as cs
    from repro_torch.device import resolve_device, strict_fp32
    from repro_torch.kernels import cuda as kcuda
    from repro_torch.kernels.flash_attention import kernel as K

    dev = resolve_device("cuda")
    strict_fp32()
    print(f"card: {cs.card_line()}; torch {torch.__version__} cuda {torch.version.cuda}")
    lib = kcuda.build()
    failures = []
    try:
        libs, parent, report = build(kcuda, opts.parent)
    except Exception:
        traceback.print_exc()
        libs, parent, report = None, None, ""
        failures.append("the ablation build")
    # the ablation copy's symbols carry its file name: key both by the rest
    usage = {_unprefixed(k): v for k, v in cs.ptxas_usage(report).items()}
    sass = {k: v for k, v in cs.sass_counts(lib).items()
            if "flash_mla_kernel" in k or "flash_mla_combine_kernel" in k}
    for fn, ops in sorted(sass.items()):
        res = usage.get(_unprefixed(fn), {})
        print(f"sass {fn[:96]}: " + ", ".join(f"{op} {ops.get(op, 0)}" for op in
                                             ("HMMA", "LDGSTS", "LDSM", "LDS", "FFMA"))
              + f"; registers {res.get('registers')}, stack {res.get('stack')} B, spill "
                f"stores {res.get('spill_stores')} B, loads {res.get('spill_loads')} B")
        if "combine" in fn:
            continue
        if not (ops.get("HMMA") and ops.get("LDGSTS")):
            failures.append(f"{fn}: no HMMA or no LDGSTS")
        if "kernelIt" in fn and not ops.get("LDSM"):
            failures.append(f"{fn}: no LDSM over the bf16 latent")
    book = cs.KernelBook()
    for label, batch, sq, sk, q_offset, kv_len, stacked in SHAPES:
        for dtype in (torch.float32, torch.bfloat16):
            try:
                args, kw = operands(dev, dtype, batch, sq, sk, q_offset, kv_len, stacked,
                                    seed=sk + sq)
                print(f"{label}: B {batch}, Sq {sq}, Sk {sk}, 128 heads, causal, q_offset "
                      f"{q_offset}, kv_len {kv_len}, {dtype}:")
                cs.check_mla(book, label, args, kw, timed=True)
                del args
            except Exception:
                traceback.print_exc()
                failures.append(f"{label} {dtype}")
            gc.collect()
            torch.cuda.empty_cache()
    try:
        if libs:
            ablation(cs, kcuda, K, libs, parent, dev, failures)
    except Exception:
        traceback.print_exc()
        failures.append("the ablation")
    for f in failures:
        print(f"FAILED: {f}", file=sys.stderr)
    return 1 if failures else 0


if __name__ == "__main__":
    sys.exit(main())
