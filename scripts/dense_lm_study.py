#!/usr/bin/env python3
"""How the dense LM family's full-width weights are drawn, and how far the
fp32 and int8 flash kernels and their plain versions sit from an fp64
reference at those models' attention scores. Runs on one NVIDIA GPU:

    python3 scripts/dense_lm_study.py

1. minitron-8b's weights drawn by `init_params` from a host generator (each
   leaf moved to the card as it is drawn: the serve launcher's default) and
   from a generator on the card: seconds of each, and the bytes on the card.
2. For minitron-8b and stablelm-12b at full width (weights from a card
   generator, seed 0), the attention calls of layers 0, 1 and n - 1 of a
   batch-4, 32-token prefill and of the first decode step are captured; for
   each, out, m and l of the fp32 kernel and of its plain version against
   the same function in fp64, and out of the int8 kernel and its plain
   version against fp64 on the dequantized cache, each beside the port's
   fp32 limit (1e-4 * max + 1e-5 * min(1, max)).
3. The same on random q, k, v at the served shape (B 4, Sq 32, Sk 64, KV 8,
   G 4, kv_len 32, causal) at head dims 128 and 160, with the scores' std
   swept from 1 to 128.
Prints the card's name and power limit first.
"""
from __future__ import annotations

import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("dense_lm_study: needs a CUDA device", file=sys.stderr)
        return 1
    sys.path.insert(0, str(ROOT / "src"))
    sys.path.insert(0, str(ROOT))
    import chip_smoke as C
    from repro_torch.configs.base import get_config
    from repro_torch.device import resolve_device
    from repro_torch.kernels import cuda as kcuda
    from repro_torch.kernels.flash_attention.kernel import (
        dequantize,
        flash_fwd,
        flash_fwd_plain,
        flash_fwd_q8,
        flash_fwd_q8_plain,
    )
    from repro_torch.models import model as M
    from repro_torch.models.attention import _quantize_kv

    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip())
    dev = resolve_device("cuda")
    kcuda.build()
    kcuda.library()

    cfg = get_config("minitron-8b")
    for where in ("host", "card"):
        gen = (torch.Generator() if where == "host"
               else torch.Generator(device=dev)).manual_seed(0)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        params = M.init_params(cfg, gen, device=dev)
        torch.cuda.synchronize()
        print(f"minitron-8b weights drawn on the {where}: {time.perf_counter() - t0:.2f} s, "
              f"{torch.cuda.memory_allocated() / 1e9:.2f} GB on the card")
        del params
        torch.cuda.empty_cache()

    def err(a, b):
        return float((a.double() - b.double()).abs().max())

    def limit(w):
        s = float(w.abs().max())
        return 1e-4 * s + 1e-5 * min(1.0, s)

    def study(label, q, k, v, kw):
        po, pm, pl = flash_fwd_plain(q, k, v, **kw)
        ko, km, kl = flash_fwd(q, k, v, **kw)
        to, tm, tl = flash_fwd_plain(q.double(), k.double(), v.double(), **kw)
        line = [f"{label}: max|m| {float(tm.abs().max()):.1f}"]
        for part, g, p, t in (("out", ko, po, to), ("m", km, pm, tm), ("l", kl, pl, tl)):
            line.append(f"{part}: kernel-fp64 {err(g, t):.3e}, plain-fp64 {err(p, t):.3e}, "
                        f"kernel-plain {err(g, p):.3e}, limit {limit(p):.3e}")
        kq, ks = _quantize_kv(k)
        vq, vs = _quantize_kv(v)
        tq = flash_fwd_plain(q.double(), dequantize(kq, ks).double(),
                             dequantize(vq, vs).double(), **kw)[0]
        go = flash_fwd_q8(q, kq, vq, ks, vs, **kw)
        wo = flash_fwd_q8_plain(q, kq, vq, ks, vs, **kw)
        line.append(f"q8 out: kernel-fp64 {err(go, tq):.3e}, plain-fp64 {err(wo, tq):.3e}, "
                    f"kernel-plain {err(go, wo):.3e}, limit {limit(wo):.3e}")
        print("; ".join(line), flush=True)

    for arch in ("minitron-8b", "stablelm-12b"):
        cfg = get_config(arch)
        params = M.init_params(cfg, torch.Generator(device=dev).manual_seed(0), device=dev)
        prompt = torch.randint(0, cfg.vocab_size, (4, 32), dtype=torch.int32,
                               generator=torch.Generator().manual_seed(1))
        follow = torch.randint(0, cfg.vocab_size, (4, 1), dtype=torch.int32,
                               generator=torch.Generator().manual_seed(2))
        n = cfg.n_layers
        with C.capture_attention((0, 1, n - 1, n)) as cap:
            C.teacher_forced(cfg, params, prompt, follow, "float32", dev, 64)
        for idx, (args, kw) in sorted(cap.calls.items()):
            step = "prefill" if idx < n else "decode"
            study(f"{arch} {step} layer {idx % n} q{tuple(args[0].shape)}", *args[:3], kw)
        del params, cap
        torch.cuda.empty_cache()

    gen = torch.Generator(device=dev).manual_seed(3)
    for d in (128, 160):
        for std in (1, 4, 16, 32, 64, 128):
            a = std ** 0.5  # q.k / sqrt(d) has std `std` when q and k entries have std sqrt(std)
            q = torch.randn((4, 32, 8, 4, d), generator=gen, device=dev) * a
            k = torch.randn((4, 64, 8, d), generator=gen, device=dev) * a
            v = torch.randn((4, 64, 8, d), generator=gen, device=dev) * 20
            study(f"random D {d}, score std {std}", q, k, v,
                  dict(scale=d ** -0.5, causal=True, q_offset=0, kv_len=32))
    return 0


if __name__ == "__main__":
    sys.exit(main())
