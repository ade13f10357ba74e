"""The MLA backward passes (`csrc/flash_mla_bwd.cu`) on the card, alone.

Prints the card, the registers, stack and spills of the passes' eight
instantiations (nvcc's `-Xptxas -v`) and their SASS counts (HMMA, LDGSTS,
LDSM, LDS, FFMA); then, at full width with 128 heads, causal, on operands
drawn on the card (`chip_smoke.mla_drawn_operands`: m and l from the kernel
forward), fp32 and bf16, at B 2 x S 128 (deepseek-v2's training sublayer)
and B 1 x S 1024: both passes against the plain version at its limits, and
kernel, plain, SDPA's memory-efficient backward and the bound by CUDA-graph
replay in turns (`chip_smoke.check_mla_bwd`); at B 2 x S 128 also the dkv
pass over several targets of its block count (`MLA_BWD_BLOCKS`, which sets
its row chunks), in turns.

Last, where the time goes at B 2 x S 128: copies of the source with parts
taken out (text patches, each checked to apply; one nvcc per copy, all
started together, into the build directory), their entry points called
directly with the wrapper's arguments and timed in turns:

    full        the kernel as it is
    no-s-dp     phase one's MMAs left out (S and dP zero)
    no-grads    the dq / dc_kv | dk_rope MMAs left out
    no-mma      both (staging, the pair tiles, syncs and writes left)
    no-refill   the ring tiles after the first not staged again
    skeleton    no-mma and no-refill
    no-reduce   the dkv pass without its reduce kernel

(the ablated copies' outputs are wrong by design; `full` is held to the
plain version), beside the wrapper (`flash_bwd_mla`: each pass, and both in
one call), the bf16 q prescale as `_mla_prescaled` forms it and as four
separate elementwise ops (widen, scale, round, widen), and the
`.contiguous()` copy of a `do` laid out as the sublayer's autograd hands it
in ((B, H, S, r) memory). Imports no JAX. Run from the root of a checkout
on a machine with the card:

    python3 scripts/mla_bwd_study.py

Exits 1 if a check fails or an instantiation lacks HMMA or LDGSTS.
"""
from __future__ import annotations

import contextlib
import ctypes
import gc
import io
import subprocess
import sys
import traceback
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
SHAPES = ((2, 128), (1, 1024))  # (batch, seq_len)
BLOCK_TARGETS = (264, 528, 1056, 2112)

# name -> (no phase-one MMAs, no gradient MMAs, no ring refills, no reduce)
VARIANTS = {
    "full": (0, 0, 0, 0), "no-s-dp": (1, 0, 0, 0), "no-grads": (0, 1, 0, 0),
    "no-mma": (1, 1, 0, 0), "no-refill": (0, 0, 1, 0), "skeleton": (1, 1, 1, 0),
    "no-reduce": (0, 0, 0, 1),
}
PATCHES = (  # (text, replacement, occurrences)
    ("  if (role == 1)\n    block_products",
     "  if (ABL_NO_S_DP) {\n    for (int n = 0; n < 2; ++n)\n      for (int e = 0; e < 4; ++e)"
     " c[n][e] = 0.f;\n  } else if (role == 1)\n    block_products", 1),
    ("for (int j0 = 0; j0 < G::NJ; j0 += JU) {",
     "for (int j0 = 0; j0 < (ABL_NO_GRADS ? 0 : G::NJ); j0 += JU) {", 2),
    ("if (it + 1 < n_tiles)\n      stage_keys",
     "if (it + 1 < n_tiles && !ABL_NO_REFILL)\n      stage_keys", 1),
    ("if (nxt < t_end) stage(slot ^ 1, nxt);",
     "if (nxt < t_end && !ABL_NO_REFILL) stage(slot ^ 1, nxt);", 1),
    ("  mla_bwd_dkv_reduce<KT, R, DR><<<",
     "  if (!ABL_NO_REDUCE) mla_bwd_dkv_reduce<KT, R, DR><<<", 1),
)


def build(kcuda) -> dict:
    """{variant: loaded library} of the patched copies."""
    src = (kcuda.CSRC / "flash_mla_bwd.cu").read_text()
    for old, new, count in PATCHES:
        if src.count(old) != count:
            raise RuntimeError(f"patch does not apply ({src.count(old)} x): {old!r}")
        src = src.replace(old, new)
    out = kcuda.build_dir() / "mla_bwd_ablation"
    out.mkdir(parents=True, exist_ok=True)
    (out / "ablation.cu").write_text(src)
    nvcc = kcuda.nvcc_path()
    procs = {}
    for name, flags in VARIANTS.items():
        defs = [f"-DABL_{k}={v}" for k, v in zip(("NO_S_DP", "NO_GRADS", "NO_REFILL",
                                                   "NO_REDUCE"), flags)]
        procs[name] = subprocess.Popen(
            [nvcc, *kcuda.NVCC_FLAGS, *defs, f"-I{kcuda.CSRC}", "-shared", "-o",
             str(out / f"{name}.so"), str(out / "ablation.cu")],
            stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
    libs = {}
    for name, proc in procs.items():
        _, err = proc.communicate()
        if proc.returncode:
            raise RuntimeError(f"nvcc failed for {name}:\n{err[-4000:]}")
        lib = ctypes.CDLL(str(out / f"{name}.so"))
        for entry in kcuda.MLA_BWD_ENTRIES:
            dq = "_dq_" in entry
            fn = getattr(lib, entry)
            fn.argtypes = ([ctypes.c_void_p] * (9 if dq else 11)
                           + [ctypes.c_float] * (2 if dq else 1) + [ctypes.c_void_p])
            fn.restype = ctypes.c_int
        libs[name] = lib
    return libs


def ablation(cs, kcuda, K, dev) -> None:
    """The ablation table at B 2 x S 128, fp32 and bf16 (see the docstring)."""
    import torch

    libs = build(kcuda)
    b, s = 2, 128
    for dtype, sfx in ((torch.float32, "f32"), (torch.bfloat16, "bf16")):
        args, kw = cs.mla_drawn_operands(dev, dtype, b, s, seed=s)
        q, c, k, do = args[:4]
        scale = kw["scale"]
        qk, sc, dsc = q, scale, scale
        if dtype == torch.bfloat16:
            qk, sc, dsc = K._mla_prescaled(q, scale), 1.0, K._mla_dscale(q, scale)
        h, dk = q.shape[2], q.shape[3]
        nc = kcuda.mla_dkv_chunks(b, s * h, s)
        dims = (ctypes.c_int * 10)(b, h, s, s, c.shape[2], k.shape[2], 1, 0, -1, nc)
        ptrs = [t.data_ptr() for t in (qk, *args[1:])]
        dq = torch.empty(q.shape, device=dev, dtype=c.dtype)
        part = torch.empty((nc, b, s, dk), device=dev, dtype=torch.float32)
        dc, dkr = torch.empty_like(c), torch.empty_like(k)

        def entry(lib, which):
            fn = getattr(lib, f"repro_flash_bwd_mla_{which}_{sfx}")
            if which == "dq":
                return lambda: fn(*ptrs, dq.data_ptr(), dims, sc, dsc,
                                  torch.cuda.current_stream().cuda_stream)
            return lambda: fn(*ptrs, part.data_ptr(), dc.data_ptr(), dkr.data_ptr(), dims, sc,
                              torch.cuda.current_stream().cuda_stream)

        fns = {f"{name} {which}": entry(lib, which) for name, lib in libs.items()
               for which in ("dq", "dkv")}
        fns = {key: fn for key, fn in fns.items() if not (key.startswith("no-reduce")
                                                          and key.endswith("dq"))}
        for key, fn in fns.items():
            if fn() != 0:
                raise RuntimeError(f"{key}: launch failed")
        fns["full dq"]()
        fns["full dkv"]()
        torch.cuda.synchronize()
        want = K.flash_bwd_mla_plain(*args, **kw)
        errs = [float((g.float() - w.float()).abs().max() / w.float().abs().max())
                for g, w in zip((dq, dc, dkr), want)]
        print(f"{sfx} full, max|kernel - plain| / max|plain| (dq, dc_kv, dk_rope): "
              + ", ".join(f"{e:.2e}" for e in errs))
        fns.update({f"wrapper {p or 'dq + dkv'}":
                    (lambda p=p: K.flash_bwd_mla(*args, part=p, **kw))
                    for p in ("dq", "dkv", None)})
        if dtype == torch.bfloat16:
            fns["prescale"] = lambda: K._mla_prescaled(q, scale)
            bs = K._bf16_scale(scale)
            fns["prescale as 4 ops"] = lambda: (q.float() * bs).to(torch.bfloat16).float()
        do_t = do.permute(0, 2, 1, 3).contiguous().permute(0, 2, 1, 3)
        fns["do.contiguous() of the permuted do"] = lambda: do_t.contiguous()
        t = cs.time_graph_turns(fns)
        print(f"B {b} x S {s}, {sfx}, ms by CUDA-graph replay:")
        for key, v in t.items():
            print(f"  {key:40s} {v:.4f}")
        del args, want


def block_sweep(cs, kcuda, K, args, kw) -> str:
    """The dkv pass timed in turns with each of BLOCK_TARGETS as
    MLA_BWD_BLOCKS (which sets its row chunks)."""
    b, s, h = args[0].shape[:3]
    default, ncs = kcuda.MLA_BWD_BLOCKS, {}

    def at(n):
        kcuda.MLA_BWD_BLOCKS = n
        ncs[n] = kcuda.mla_dkv_chunks(b, s * h, s)
        return K.flash_bwd_mla(*args, part="dkv", **kw)

    try:
        t = cs.time_graph_turns({n: (lambda n=n: at(n)) for n in BLOCK_TARGETS})
    finally:
        kcuda.MLA_BWD_BLOCKS = default
    return ", ".join(f"{n} (nc {ncs[n]}): {t[n]:.4f} ms" for n in BLOCK_TARGETS)


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("mla_bwd_study: no CUDA device", file=sys.stderr)
        return 1
    sys.path[:0] = [str(ROOT), str(ROOT / "src")]
    import chip_smoke as cs
    from repro_torch.device import resolve_device
    from repro_torch.kernels import cuda as kcuda
    from repro_torch.kernels.flash_attention import kernel as K

    dev = resolve_device("cuda")
    print(f"card: {cs.card_line()}; torch {torch.__version__} cuda {torch.version.cuda}")
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        lib = kcuda.build(verbose=True)
    usage = cs.ptxas_usage(out.getvalue())
    failures = []
    sass = {k: v for k, v in cs.sass_counts(lib).items() if "mla_bwd" in k}
    for fn, ops in sorted(sass.items()):
        res = usage.get(fn, {})
        print(f"sass {fn[:90]}: " + ", ".join(f"{op} {ops.get(op, 0)}" for op in
                                             ("HMMA", "LDGSTS", "LDSM", "LDS", "FFMA"))
              + f"; registers {res.get('registers')}, stack {res.get('stack')} B, spill "
                f"stores {res.get('spill_stores')} B, loads {res.get('spill_loads')} B")
        if "reduce" not in fn and not (ops.get("HMMA") and ops.get("LDGSTS")):
            failures.append(f"{fn}: no HMMA or no LDGSTS")
    book = cs.KernelBook()
    for b, s in SHAPES:
        for dtype in (torch.float32, torch.bfloat16):
            try:
                args, kw = cs.mla_drawn_operands(dev, dtype, b, s, seed=s)
                print(f"B {b} x S {s}, {dtype}:")
                cs.check_mla_bwd(book, f"B {b} x S {s}", args, kw, timed=True)
                if s == 128:
                    print("    dkv by block target: " + block_sweep(cs, kcuda, K, args, kw))
                del args
            except Exception:
                traceback.print_exc()
                failures.append(f"B {b} x S {s} {dtype}")
            gc.collect()
            torch.cuda.empty_cache()
    try:
        ablation(cs, kcuda, K, dev)
    except Exception:
        traceback.print_exc()
        failures.append("the ablation")
    for f in failures:
        print(f"FAILED: {f}", file=sys.stderr)
    return 1 if failures else 0


if __name__ == "__main__":
    sys.exit(main())
