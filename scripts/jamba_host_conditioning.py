#!/usr/bin/env python3
"""How far the reduced jamba-v0.1-52b amplifies fp32 rounding, on the host
(CPU; imports the JAX package and the port, like the parity tests):

    PYTHONPATH=src JAX_PLATFORMS=cpu python3 scripts/jamba_host_conditioning.py

1. The port's logits under a relative nudge of 1e-7 (normal noise) to the
   embedding table, three seeds: the largest change as a fraction of
   max|logits|, for the registered reduced config and for it with qk_norm
   on (the same code with a well-conditioned attention).
2. The port against the JAX package on the same weights (the JAX side's,
   carried over): the largest logit error as a fraction of the parity
   tests' limit, 1e-4 * max|ref| + 1e-6, for `forward` and for prefill (5
   tokens) plus 7 teacher-forced decode steps over the fp32 and the int8
   request's caches, for both configs (`tests/test_torch_ssm.py` runs the
   same comparisons).
"""
from __future__ import annotations

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import torch

from repro.configs import get_config as j_get_config
from repro.models import model as JM
from repro_torch.configs.base import get_config
from repro_torch.convert import lm_params_from_jax
from repro_torch.models import model as M

ARCH = "jamba-v0.1-52b"


def nudged(cfg, params, toks) -> list:
    with torch.no_grad():
        base = M.forward(cfg, params, {"tokens": toks})[0]
        out = []
        for seed in range(3):
            g = torch.Generator().manual_seed(seed)
            p = dict(params, embed=params["embed"] * (
                1 + 1e-7 * torch.randn(params["embed"].shape, generator=g)))
            lg = M.forward(cfg, p, {"tokens": toks})[0]
            out.append(float((lg - base).abs().max() / base.abs().max()))
    return out


def of_limit(got, want) -> float:
    want = np.asarray(want, np.float32)
    return float(np.abs(got.numpy() - want).max() / (1e-4 * np.abs(want).max() + 1e-6))


def against_jax(cfg, jcfg) -> dict:
    jparams, _ = JM.init_params(jcfg, jax.random.PRNGKey(0))
    params = lm_params_from_jax(jax.tree_util.tree_map(np.asarray, jparams), cfg, device="cpu")
    rng = np.random.default_rng(0)
    toks0 = rng.integers(0, cfg.vocab_size, (2, 12)).astype(np.int32)
    toks = np.random.default_rng(1).integers(0, cfg.vocab_size, (2, 12)).astype(np.int32)
    with torch.no_grad():
        got = M.forward(cfg, params, {"tokens": torch.from_numpy(toks0)})[0]
    out = {"forward": of_limit(got, JM.forward(jcfg, jparams, {"tokens": jnp.asarray(toks0)})[0])}
    for name, jdt, tdt in (("float32", jnp.float32, torch.float32),
                           ("int8", jnp.int8, torch.int8)):
        jc, _ = JM.init_cache(jcfg, 2, 16, jdt)
        c = M.init_cache(cfg, 2, 16, tdt, device="cpu")
        jl, jc = JM.prefill(jcfg, jparams, jc, {"tokens": jnp.asarray(toks[:, :5])})
        with torch.no_grad():
            lg, c = M.prefill(cfg, params, c, {"tokens": torch.from_numpy(toks[:, :5])})
            worst = of_limit(lg, jl)
            for t in range(5, 12):
                jl, jc = JM.decode_step(jcfg, jparams, jc,
                                        {"tokens": jnp.asarray(toks[:, t:t + 1])}, t)
                lg, c = M.decode_step(cfg, params, c,
                                      {"tokens": torch.from_numpy(toks[:, t:t + 1])}, t)
                worst = max(worst, of_limit(lg, jl))
        out[name] = worst
    params_t = M.init_params(cfg, torch.Generator().manual_seed(0), device="cpu")
    out["nudge"] = nudged(cfg, params_t, torch.from_numpy(toks))
    return out


def main() -> None:
    for qk_norm in (False, True):
        cfg = dataclasses.replace(get_config(ARCH, reduced=True), qk_norm=qk_norm)
        jcfg = dataclasses.replace(j_get_config(ARCH, reduced=True), qk_norm=qk_norm)
        r = against_jax(cfg, jcfg)
        print(f"{ARCH} reduced, qk_norm={qk_norm}: logits moved by "
              + ", ".join(f"{x:.2e}" for x in r["nudge"])
              + " of max|logits| under a 1e-7 relative nudge of the embeddings (3 seeds); "
              f"port vs JAX package, as a fraction of 1e-4*max|ref| + 1e-6: forward "
              f"{r['forward']:.2f}, fp32 request {r['float32']:.2f}, int8 request "
              f"{r['int8']:.2f}")


if __name__ == "__main__":
    main()
