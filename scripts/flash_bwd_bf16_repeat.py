#!/usr/bin/env python3
"""Launch the bf16 flash backward passes many times on edge shapes and check
that every launch repeats the first bitwise, and that the first is within
the bf16 limit (2^-7 max|plain|) of the plain version.

    python3 scripts/flash_bwd_bf16_repeat.py [--reps 40] [--device cuda]

Covers all six head dims, each at four shapes ragged against the passes'
block and ring tiles (causal, non-causal with kv_len, q_offset > 0, G = 8),
and the trained shape (qwen3-0.6b layer 0). Both passes own each output
row, key and column with one warp and keep a fixed order of steps (no
atomics), so a launch that differs from the first is a race. Prints the
card's name and power limit, one line per shape, and exits 1 on any
failure. `--device cpu` runs the wrappers' plain versions (once).
"""
from __future__ import annotations

import argparse
import subprocess
import sys
from pathlib import Path

import numpy as np
import torch

sys.path.insert(0, str(Path(__file__).resolve().parents[1] / "src"))
from repro_torch.kernels.flash_attention.kernel import (  # noqa: E402
    flash_bwd_dkv,
    flash_bwd_dkv_plain,
    flash_bwd_dq,
    flash_bwd_dq_plain,
    flash_delta,
    flash_fwd,
)

# (b, sq, kv heads, g, sk, d, causal, q_offset, kv_len)
SHAPES = [s for d in (8, 16, 32, 64, 128, 256) for s in (
    (2, 70, 2, 3, 150, d, True, 0, None), (1, 33, 3, 1, 97, d, False, 0, 60),
    (2, 45, 2, 2, 70, d, True, 16, None), (1, 130, 1, 8, 129, d, True, 0, None))]
SHAPES.append((8, 128, 8, 2, 128, 128, True, 0, None))


def operands(dev, b, sq, kv, g, sk, d, causal, q_offset, kv_len, seed):
    rng = np.random.default_rng(seed)

    def make(*dims):
        x = rng.standard_normal(dims).astype(np.float32)
        return torch.from_numpy(x).to(dev, torch.bfloat16)

    q, k, v, do = make(b, sq, kv, g, d), make(b, sk, kv, d), make(b, sk, kv, d), \
        make(b, sq, kv, g, d)
    kw = dict(scale=d ** -0.5, causal=causal, q_offset=q_offset, kv_len=kv_len)
    out, m, l = flash_fwd(q, k, v, **kw)
    return (q, k, v, do, m, l, flash_delta(do, out)), kw


def rel_err(got, want):
    scale = max(float(want.float().abs().max()), 1e-30)
    return float((got.float() - want.float()).abs().max()) / scale


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--reps", type=int, default=40)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args()
    dev = args.device
    reps = args.reps if dev == "cuda" else 1
    if dev == "cuda":
        print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                              "--format=csv,noheader"], capture_output=True,
                             text=True).stdout.strip())
    fails = []
    for i, shape in enumerate(SHAPES):
        ops, kw = operands(dev, *shape, seed=100 + i)
        dq = flash_bwd_dq(*ops, **kw)
        dk, dv = flash_bwd_dkv(*ops, **kw)
        errs = [rel_err(dq, flash_bwd_dq_plain(*ops, **kw))]
        errs += [rel_err(a, b) for a, b in zip((dk, dv), flash_bwd_dkv_plain(*ops, **kw))]
        differ = 0
        for _ in range(reps):
            dk2, dv2 = flash_bwd_dkv(*ops, **kw)
            dq2 = flash_bwd_dq(*ops, **kw)
            differ += not (torch.equal(dq2, dq) and torch.equal(dk2, dk)
                           and torch.equal(dv2, dv))
        ok = max(errs) <= 2.0 ** -7 and differ == 0
        print(f"{shape}: rel err dq {errs[0]:.2e} dk {errs[1]:.2e} dv {errs[2]:.2e}; "
              f"{differ} of {reps} repeats differ {'ok' if ok else 'FAIL'}", flush=True)
        if not ok:
            fails.append(shape)
    print("failures:", fails or "none")
    return 1 if fails else 0


if __name__ == "__main__":
    sys.exit(main())
