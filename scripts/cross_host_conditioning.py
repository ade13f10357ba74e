#!/usr/bin/env python3
"""How far the reduced cross-attention archs amplify fp32 rounding, on the
host (CPU; imports the JAX package, like the parity tests):

    PYTHONPATH=src JAX_PLATFORMS=cpu python3 scripts/cross_host_conditioning.py

For llama-3.2-vision-90b (reduced, at 5 and 10 layers, without and with
qk_norm) and whisper-tiny (reduced), with every cross-attention gate at 0.7
and unit-normal image embeddings or frames, as `tests/test_torch_cross.py`
runs them: the JAX package's own logits, and its fp32 loss gradients, under
a relative nudge of 1e-7 (normal noise, three seeds for the logits, two for
the gradients) to the embedding table and to the image embeddings or
frames. Printed: the largest change of the logits as a fraction of
max|logits| (against the parity tests' limit of 1e-4), and the largest
change of a gradient leaf as a fraction of that leaf's max, with the leaf.
A fraction near or past 1e-4 means no fp32 implementation can be held to
the reference at that limit on these weights.

Then full-size whisper-tiny on the port alone, as `chip_smoke.py`'s cross
phase feeds it (weights from `torch.Generator(0)`, gates 0.7, unit-normal
frames from `torch.Generator(2)`, batch 4, prompt 32): the fp32 forward's
logits against the same forward in float64 (the norms still compute in
fp32), and the fp32-against-float64 gap after each sublayer, encoder then
decoder, as a fraction of that sublayer's output max; for the registered
config and for it with qk_norm on.
"""
from __future__ import annotations

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np

from repro.configs import get_config as j_get_config
from repro.models import model as JM

KEY = jax.random.PRNGKey(0)
CASES = (("llama-3.2-vision-90b", 5, False), ("llama-3.2-vision-90b", 5, True),
         ("llama-3.2-vision-90b", 10, False), ("llama-3.2-vision-90b", 10, True),
         ("whisper-tiny", 2, False), ("whisper-tiny", 2, True))


def with_gate(tree, value=0.7):
    if isinstance(tree, dict):
        return {k: (np.full_like(v, value) if k == "gate" else with_gate(v, value))
                for k, v in tree.items()}
    return tree


def nudge(params, side, seed):
    rng = np.random.default_rng(10 + seed)
    p = dict(params)
    p["embed"] = (params["embed"] * (1 + 1e-7 * rng.standard_normal(params["embed"].shape))
                  ).astype(np.float32)
    return p, (side * (1 + 1e-7 * rng.standard_normal(side.shape))).astype(np.float32)


def main() -> None:
    for arch, layers, qk_norm in CASES:
        cfg = dataclasses.replace(j_get_config(arch, reduced=True), n_layers=layers,
                                  qk_norm=qk_norm)
        params = with_gate(jax.tree_util.tree_map(np.asarray, JM.init_params(cfg, KEY)[0]))
        rng = np.random.default_rng(0)
        key = "img_embeds" if cfg.family == "vlm" else "frames"
        toks = rng.integers(0, cfg.vocab_size, (2, 16)).astype(np.int32)
        labels = rng.integers(0, cfg.vocab_size, (2, 16)).astype(np.int32)
        n_side = cfg.n_image_tokens if cfg.family == "vlm" else 16
        side = rng.standard_normal((2, n_side, cfg.d_model)).astype(np.float32)

        def logits(p, sd):
            return np.asarray(JM.forward(cfg, jax.tree_util.tree_map(jnp.asarray, p),
                                         {"tokens": jnp.asarray(toks), key: jnp.asarray(sd)})[0])

        def grads(p, sd):
            batch = {"tokens": jnp.asarray(toks), "labels": jnp.asarray(labels),
                     key: jnp.asarray(sd)}
            g = jax.grad(lambda q: JM.lm_loss(cfg, q, batch))(
                jax.tree_util.tree_map(jnp.asarray, p))
            return {"/".join(str(k.key) for k in path): np.asarray(a)
                    for path, a in jax.tree_util.tree_flatten_with_path(g)[0]}

        base = logits(params, side)
        moved = max(float(np.abs(logits(*nudge(params, side, s)) - base).max())
                    for s in range(3)) / float(np.abs(base).max())
        gbase = grads(params, side)
        worst, leaf = 0.0, ""
        for s in range(2):
            g = grads(*nudge(params, side, s))
            for k, a in gbase.items():
                frac = float(np.abs(g[k] - a).max()) / max(float(np.abs(a).max()), 1e-30)
                if frac > worst:
                    worst, leaf = frac, k
        print(f"{arch} reduced, {layers} layers, qk_norm {qk_norm}: a 1e-7 nudge moves the "
              f"logits by {moved:.3e} of max|logits| (limit 1e-4), a gradient leaf by "
              f"{worst:.3e} of its max ({leaf})")


def whisper_full() -> None:
    import torch

    from repro_torch.configs.base import get_config
    from repro_torch.models import model as M
    from repro_torch.models import transformer as T

    def to(tree, dtype):
        if isinstance(tree, dict):
            return {k: to(v, dtype) for k, v in tree.items()}
        return tree.to(dtype)

    for qk_norm in (False, True):
        cfg = dataclasses.replace(get_config("whisper-tiny"), qk_norm=qk_norm)
        params = M.init_params(cfg, torch.Generator().manual_seed(0), device="cpu")
        for sub in params["groups"].values():
            if "gate" in sub["mix"]:
                sub["mix"]["gate"].fill_(0.7)
        frames = torch.randn((4, 32, cfg.d_model), generator=torch.Generator().manual_seed(2))
        toks = torch.randint(0, cfg.vocab_size, (4, 32),
                             generator=torch.Generator().manual_seed(1))
        outs, orig = {}, T.apply_sublayer
        for dtype in (torch.float32, torch.float64):
            rec = []

            def record(sub, p, x, **kw):
                out = orig(sub, p, x, **kw)
                rec.append((sub.kind, out[0].double()))
                return out

            T.apply_sublayer = record
            try:
                with torch.no_grad():
                    lg = M.forward(cfg, to(params, dtype),
                                   {"tokens": toks, "frames": frames.to(dtype)})[0]
            finally:
                T.apply_sublayer = orig
            outs[dtype] = (lg.double(), rec)
        (l32, r32), (l64, r64) = outs[torch.float32], outs[torch.float64]
        gaps = [f"{k} {float((a - b).abs().max() / b.abs().max()):.1e}"
                for (k, a), (_, b) in zip(r32, r64)]
        print(f"whisper-tiny full size, qk_norm {qk_norm}, gates 0.7, unit-normal frames: "
              f"fp32 logits against float64 {float((l32 - l64).abs().max()):.3e} at "
              f"max|logits| {float(l64.abs().max()):.3e}; per sublayer "
              f"(encoder, then decoder): {', '.join(gaps)}")


if __name__ == "__main__":
    main()
    whisper_full()
