"""Reduced deepseek-v2's bf16 gradients on the card against the host's, at
sequence lengths whose causal rows see more keys than the MLA forward's key
ring holds over a bf16 latent (64 keys): which part of the card's path
moves the worst gradient leaf.

For each S (96 and 128, past the ring), from the same weights
(`init_train_state`, seed 0) and the first batch of the token pipeline (B
4, `DEFAULT_RUN`, bf16), step 0's loss-and-gradients pass on the card with
remat "full" beside the host's plain path (remat "none"), four ways:

    kernels     the card as it runs (the MLA forward and backward kernels)
    plain fwd   the card with the MLA forward's plain version in its place
    plain both  the card with the forward's and both backward passes' plain
                versions (cuBLAS and the other kernels as they run)
    host fp32   the host's fp32 pass on the same weights, against the
                host's bf16 one: how far bf16 rounding alone moves a leaf

each as the worst leaf's max|card - host| / max|host| (the bf16 train-step
limit is 5e-2) and that leaf's name; then 3 train steps (`make_train_step`,
warm-up 2) on the card with the kernels and with the plain versions, each
beside the host's: every step's loss and gradients' global norm (limits
1e-2 and 3e-2 relative).

Then the card test's check (`tests/test_torch_mla_cuda.py::
bf16_vs_host` and `ring_misses`): 3 card steps with the kernels, and
before each, on the card's weights of that step, the card's loss and
gradients against the host's with the card's top-2 routing taken from the
host's, with the kernels and with the plain versions: loss, global norm,
the worst leaf and the worst leaf outside the router and the routed
experts, the worst routed leaf of the kernels against the plain versions,
and whether the test's limits (`RING_LIMITS`) held. Last, chip_smoke's
bf16 check of the full-width MLA sublayer's gradients against the host's
(B 2 x S 128, `chip_smoke.MLA_TRAIN`).

Imports no JAX. Run from the root of a checkout on a machine with the
card (the script reports; it exits 1 only without a card):

    python3 scripts/mla_bf16_ring_check.py
"""
from __future__ import annotations

import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
SEQS = (96, 128)


def worst_leaf(names, got, want) -> tuple:
    worst, where = 0.0, None
    for name, g, w in zip(names, got, want):
        g, w = g.float().cpu(), w.float().cpu()
        r = float((g - w).abs().max()) / max(float(w.abs().max()), 1e-30)
        if r > worst:
            worst, where = r, name
    return worst, where


def fixed_routing(cfg, run, seqs) -> bool:
    """The card test's check at each S (`bf16_vs_host`, `ring_misses`):
    3 card steps with the kernels, and before each, on its weights, the
    kernels' and the plain versions' passes against the host's (routing
    taken from the host's). Returns whether every step held."""
    import torch
    from test_torch_mla_cuda import ROUTED, bf16_vs_host, ring_misses

    from repro_torch.data import make_pipeline
    from repro_torch.launch.steps import init_train_state, make_train_step, to_device

    srun = run.replace(warmup_steps=2)
    held = True
    for s in seqs:
        state = init_train_state(cfg, srun, torch.Generator().manual_seed(0), device="cuda")
        pipe = make_pipeline(cfg, s, 4, seed=0)
        step = make_train_step(cfg, srun, 10, device="cuda")
        for i in range(3):
            batch = to_device(pipe.batch_at(i), "cpu")
            res = bf16_vs_host(cfg, srun, state.params, batch, "cuda")
            for label in ("kernels", "plain"):
                r = res[label]
                lv = r["leaves"]
                worst = max(lv, key=lv.get)
                kept = {k: v for k, v in lv.items() if not k.endswith(ROUTED)}
                wk = max(kept, key=kept.get)
                print(f"S {s} step {i}, routing from the host, {label} / host: loss "
                      f"{r['loss']:.3e}, grad norm {r['grad_norm']:.3e}, worst leaf "
                      f"{lv[worst]:.3e} ({worst}), worst non-routed leaf {kept[wk]:.3e} ({wk})")
            kp = {k: v for k, v in res["kernels_vs_plain"].items() if k.endswith(ROUTED)}
            wr = max(kp, key=kp.get)
            miss = ring_misses(res)
            held = held and not miss
            print(f"S {s} step {i}: worst routed leaf, kernels / plain {kp[wr]:.3e} ({wr}); "
                  f"the card test's limits: {'held' if not miss else f'FAILS {miss}'}")
            state, _ = step(state, batch)
    return held


def sublayer(cs, dev) -> None:
    """chip_smoke's bf16 check of the full-width MLA sublayer's gradients
    against the host's, on `mla_sublayer`'s draws."""
    import torch

    from repro_torch.configs.base import get_config
    from repro_torch.models import attention as A

    cfg = get_config(cs.MLA_ARCH)
    b, s = cs.MLA_TRAIN["batch"], cs.MLA_TRAIN["seq_len"]
    gen = torch.Generator(device=dev).manual_seed(cs.MLA_TRAIN["seed"])
    p32 = A.init_mla(gen, cfg, place=lambda t, axes: t.to(dev))
    x32 = torch.randn((b, s, cfg.d_model), device=dev, generator=gen)
    g32 = torch.randn((b, s, cfg.d_model), device=dev, generator=gen)
    pos = torch.arange(s, device=dev)[None].expand(b, s)

    def fwd(p, x):
        return A.mla_attention(p, x, cfg=cfg, positions=pos.to(x.device))[0]

    failures = []
    cs.sublayer_vs_host(cs.MLA_ARCH + " MLA", fwd, p32, [x32], g32, dev, failures,
                        dtype=torch.bfloat16)
    print(f"sublayer bf16 check: {'FAILS' if failures else 'held'}")


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("mla_bf16_ring_check: no CUDA device", file=sys.stderr)
        return 1
    sys.path[:0] = [str(ROOT), str(ROOT / "src"), str(ROOT / "tests")]
    import chip_smoke as cs
    from test_torch_mla_cuda import plain_mla

    from repro_torch.configs.base import DEFAULT_RUN, get_config
    from repro_torch.data import make_pipeline
    from repro_torch.device import strict_fp32
    from repro_torch.launch.steps import (
        init_train_state,
        loss_and_grads,
        make_train_step,
        to_device,
    )
    from repro_torch.tree import tree_leaves, tree_map, tree_paths

    strict_fp32()
    print(f"card: {cs.card_line()}; torch {torch.__version__}")
    cfg = get_config("deepseek-v2-236b", reduced=True)
    run = DEFAULT_RUN
    hrun = run.replace(remat="none")
    for s in SEQS:
        state_c = init_train_state(cfg, run, torch.Generator().manual_seed(0), device="cuda")
        state_h = init_train_state(cfg, hrun, torch.Generator().manual_seed(0), device="cpu")
        names = [p for p, _ in tree_paths(state_h.params)]
        batch = to_device(make_pipeline(cfg, s, 4, seed=0).batch_at(0), "cpu")
        _, g_h = loss_and_grads(cfg, hrun, state_h.params, batch)
        g_h = tree_leaves(g_h)
        line = []
        for label, fwd, bwd in (("kernels", False, False), ("plain fwd", True, False),
                                ("plain both", True, True)):
            with plain_mla(fwd, bwd):
                _, g_c = loss_and_grads(cfg, run, state_c.params, to_device(batch, "cuda"))
            w, where = worst_leaf(names, tree_leaves(g_c), g_h)
            line.append(f"{label} {w:.3e} ({where})")
        _, g_f = loss_and_grads(cfg, hrun.replace(param_dtype="float32"),
                                tree_map(lambda t: t.float(), state_h.params), batch)
        w, where = worst_leaf(names, g_h, tree_leaves(g_f))
        line.append(f"host bf16 vs host fp32 {w:.3e} ({where})")
        print(f"S {s}: worst leaf max|card - host| / max|host|: " + "; ".join(line))
        pipe = make_pipeline(cfg, s, 4, seed=0)
        batches = [to_device(pipe.batch_at(i), "cpu") for i in range(3)]
        srun = run.replace(warmup_steps=2)
        runs = {}
        for label, plain, device, r in (("host", False, "cpu", srun.replace(remat="none")),
                                        ("kernels", False, "cuda", srun),
                                        ("plain both", True, "cuda", srun)):
            st = init_train_state(cfg, r, torch.Generator().manual_seed(0), device=device)
            step = make_train_step(cfg, r, 10, device=device)
            runs[label] = []
            for b in batches:
                with plain_mla(plain, plain):
                    st, met = step(st, b)
                runs[label].append((float(met["loss"]), float(met["grad_norm"])))
        for label in ("kernels", "plain both"):
            print(f"S {s} steps, {label} / host: loss " + ", ".join(
                f"{c[0]:.5f}/{h[0]:.5f}" for c, h in zip(runs[label], runs["host"]))
                + "; grad norm " + ", ".join(
                    f"{c[1]:.4f}/{h[1]:.4f} ({abs(c[1] - h[1]) / h[1]:.3f})"
                    for c, h in zip(runs[label], runs["host"])))
        print(f"S {s} steps, kernels / plain both: grad norm " + ", ".join(
            f"{c[1]:.4f}/{q[1]:.4f} ({abs(c[1] - q[1]) / q[1]:.3f})"
            for c, q in zip(runs["kernels"], runs["plain both"])))
    held = fixed_routing(cfg, run, SEQS)
    print(f"the card test's check at S {SEQS}: {'held' if held else 'FAILS'}")
    sublayer(cs, torch.device("cuda"))
    return 0


if __name__ == "__main__":
    sys.exit(main())
