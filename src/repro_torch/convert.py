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
    `groups.sub0.{ln1, mix.{wq, wk, wv, wo[, q_norm, k_norm]}, ln2}` (MLA:
    `mix.{w_dq, w_uq, w_dkv, w_uk, w_uv, w_kr, w_o, q_norm, kv_norm}`) with
    the FFN the group layout gives: `ffn.{w1[, w3], w2}` (dense), and for
    the MoE family `moe.{router, w1, w3, w2[, shared.{w1, w3, w2}]}` (beside
    `ffn` for arctic's dense residual), each group leaf with its leading
    layer axis. A hybrid (jamba) has `groups.sub0` ... `sub7`, its Mamba
    sublayers' `mix.{in_proj, conv_w, x_proj, dt_proj, a_log, d_skip,
    out_proj}`; an xLSTM has `groups.sub0.mix.{up, wq, wk, wv, wi, wf,
    down}` (mLSTM) and `groups.sub1.mix.{wz, wi, wf, wo, r, ffn_up,
    ffn_down, norm}` (sLSTM), with no `ln2` or FFN; a VLM's cross sublayer
    adds `mix.gate`, and an encoder-decoder (whisper) has `enc_groups` and
    `enc_norm` beside its decoder's `groups`. The two trees have the
    same keys and layouts: the port's tree (made on the meta device) names
    the leaves to carry, so a family's leaves carry with no code of their
    own (the MLA and recurrent leaves too), and a missing leaf or one of
    another shape raises; so does a stacked leaf whose leading axis is not
    its own stack's group count (`models.model.group_stacks`: the layout's
    groups for `groups`, `n_encoder_layers` for `enc_groups`). Leaves in
    `dtype` (float32, or bfloat16 for the reference's default training
    type)."""
    from repro_torch.models import model as M

    dev = resolve_device(device)
    with torch.device("meta"):
        like = M.init_params(cfg, None, device="meta")
    counts = {name: n for name, (_, n) in M.group_stacks(cfg).items()}

    def carry(want, src, where):
        if isinstance(want, dict):
            return {k: carry(want[k], src[k], f"{where}.{k}" if where else k) for k in want}
        x = np.array(src, dtype=np.float32)
        n = counts.get(where.split(".")[0])
        if n is not None and (x.ndim == 0 or x.shape[0] != n):
            raise ValueError(f"{where}: leading axis {x.shape[:1]} is not the {n} "
                             f"stacked layers of {cfg.name}'s {where.split('.')[0]}")
        if x.shape != tuple(want.shape):
            raise ValueError(f"{where}: shape {x.shape} is not {tuple(want.shape)}")
        return torch.from_numpy(x).to(dev, dtype)

    return carry(like, np_params, "")


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
