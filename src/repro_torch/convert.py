"""Carry weights (and a training state) made by the JAX package into the
port.

`torch.Generator` cannot reproduce `jax.random` bits, so a comparison of the
two packages makes its weights once (on the JAX side, as numpy arrays) and
hands the same values to both. numpy has no bfloat16: a bf16 leaf crosses
widened to float32 (exact) and the LM converters narrow it back with
`dtype=torch.bfloat16` (exact again).
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.device import resolve_device


def params_from_jax(np_params: dict, device=None) -> dict:
    """{"conv": [(O,C,kh,kw)...], "dense": [(d_in,d_out)...]} of array-likes
    (numpy arrays, or anything `np.asarray` takes) -> the same layout of
    float32 tensors on `device` (None = the card). The legacy VGG layout
    {"stages": [[w, ...], ...], "fc1", "fc2"} (`repro.models.cnn.init_cnn`)
    stays legacy. Conv weights stay OIHW, dense weights (d_in, d_out)."""
    dev = resolve_device(device)

    def t(a):
        return torch.from_numpy(np.array(a, dtype=np.float32)).to(dev)

    if "stages" in np_params:
        return {"stages": [[t(w) for w in convs] for convs in np_params["stages"]],
                "fc1": t(np_params["fc1"]), "fc2": t(np_params["fc2"])}
    return {"conv": [t(w) for w in np_params["conv"]],
            "dense": [t(w) for w in np_params["dense"]]}


def lm_params_from_jax(np_params: dict, cfg, device=None, dtype=torch.float32) -> dict:
    """The JAX LM's parameter values tree (`repro.models.model.init_params`'s
    first result, leaves as array-likes) -> the port's tree on `device`
    (None = the card): `embed`, `final_norm`, [`unembed`] and
    `groups.sub0.{ln1, mix.{wq, wk, wv, wo[, q_norm, k_norm]}, ln2,
    ffn.{w1[, w3], w2}}`, each group leaf with its leading layer axis. The two
    trees have the same keys and layouts; a missing or misshapen leaf raises.
    Leaves in `dtype` (float32, or bfloat16 for the reference's default
    training type). Dense LMs only (the families the port serves)."""
    from repro_torch.models.transformer import group_layout, n_groups

    dev = resolve_device(device)
    group_layout(cfg)  # raises for a family the port does not serve
    n = n_groups(cfg)

    def t(a, where):
        x = np.array(a, dtype=np.float32)
        if where.startswith("groups") and (x.ndim == 0 or x.shape[0] != n):
            raise ValueError(f"{where}: leading axis {x.shape[:1]} is not the "
                             f"{n} layers of {cfg.name}")
        return torch.from_numpy(x).to(dev, dtype)

    sub = np_params["groups"]["sub0"]
    mix = ("wq", "wk", "wv", "wo") + (("q_norm", "k_norm") if cfg.qk_norm else ())
    ffn = ("w1", "w2") if cfg.mlp_activation in ("relu", "relu2") else ("w1", "w3", "w2")
    out = {
        "embed": t(np_params["embed"], "embed"),
        "final_norm": t(np_params["final_norm"], "final_norm"),
        "groups": {"sub0": {
            "ln1": t(sub["ln1"], "groups.sub0.ln1"),
            "mix": {k: t(sub["mix"][k], f"groups.sub0.mix.{k}") for k in mix},
            "ln2": t(sub["ln2"], "groups.sub0.ln2"),
            "ffn": {k: t(sub["ffn"][k], f"groups.sub0.ffn.{k}") for k in ffn},
        }},
    }
    if not cfg.tie_embeddings:
        out["unembed"] = t(np_params["unembed"], "unembed")
    d, v = cfg.d_model, cfg.vocab_size
    if tuple(out["embed"].shape) != (v, d):
        raise ValueError(f"embed {tuple(out['embed'].shape)} is not ({v}, {d})")
    return out


def train_state_from_jax(np_state, cfg, device=None, dtype=torch.float32):
    """The JAX package's `TrainState` (`repro.launch.steps`), leaves as
    array-likes -> the port's `TrainState` on `device` (None = the card):
    params in `dtype` and the AdamW moments m and v in float32 (the
    reference's `moment_dtype`), through `lm_params_from_jax`, and the step
    count as an int32 scalar."""
    from repro_torch.launch.steps import TrainState
    from repro_torch.optim.adamw import OptState

    dev = resolve_device(device)
    opt = np_state.opt
    step = torch.tensor(int(np.asarray(opt.step)), dtype=torch.int32, device=dev)
    return TrainState(
        params=lm_params_from_jax(np_state.params, cfg, device=dev, dtype=dtype),
        opt=OptState(step=step, m=lm_params_from_jax(opt.m, cfg, device=dev),
                     v=lm_params_from_jax(opt.v, cfg, device=dev)))
