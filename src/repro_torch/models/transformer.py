"""Decoder stack as a loop over repeating layer groups (counterpart of
`repro.models.transformer`).

A *group* is the smallest repeating pattern of sublayers:
  dense / MoE LM (GQA) -> [attn]                      x n_layers groups
  MoE LM with MLA      -> [mla]                       x n_layers groups
  jamba hybrid         -> [mamba x4, attn, mamba x3]  x n_layers / 8 groups
                          (attention at index attn_every // 2; a routed FFN
                          on the odd indices, dense on the even)
  xlstm                -> [mlstm, slstm]              x n_layers / 2 groups
  llama-vision         -> [attn x4, cross]            x n_layers / 5 groups
  whisper (audio)      -> decoder [attn (no FFN), cross], encoder [attn]
                          (`models.model`'s layouts, passed as `layout=`)
An [attn] sublayer's FFN is dense, routed (`models.moe`) or both side by
side (arctic's dense residual); an [mla] sublayer's (deepseek-v2) is routed,
and its cache the latent `MLACache`. The recurrent sublayers (`models.ssm`,
`models.xlstm`) carry a state in place of a KV cache, replaced at every
call. A [cross] sublayer attends over `kv_src` (image embeddings or the
encoder's output), non-causal and gated, and keeps no cache: its slot in
the cache tuple is None.

Group parameters keep the reference's stacked leaves: every leaf of
`groups["sub<i>"]` carries a leading (n_groups,) axis, so weights carry over
from the JAX tree as they are. The reference's `lax.scan` over groups is a
Python loop over that axis here, and a layer's cache is a view into the
stacked (n_groups, ...) cache, written in place: attention writes its
KV / latent cache at write_pos itself; a recurrent sublayer returns its new
state and `apply_sublayer` copies it into the stacked slot.
"""
from __future__ import annotations

import functools
import itertools
from typing import NamedTuple

import torch
import torch.utils.checkpoint
from torch.utils.checkpoint import CheckpointPolicy, create_selective_checkpoint_contexts

from repro_torch.configs.base import ModelConfig
from repro_torch.core.sparse_ffn import activation_fn
from repro_torch.models import attention as attn_mod
from repro_torch.models import ssm as ssm_mod
from repro_torch.models import xlstm as xlstm_mod
from repro_torch.models.layers import as_drawn, dense_init, ones_init, rms_norm
from repro_torch.models.moe import init_moe, moe_ffn
from repro_torch.tree import tree_map

class Sub(NamedTuple):
    kind: str  # attn | mla | cross | mamba | mlstm | slstm
    ffn: str  # dense | moe | moe+dense | none


def group_layout(cfg: ModelConfig) -> list:
    """The reference's rule: a dense LM, a VLM, the audio family (for
    `n_groups` and the parameter count; its stacks have layouts of their
    own, `models.model.AUDIO_*_LAYOUT`) or a MoE LM with GQA attention is
    one [attn] sublayer whose FFN is routed ("moe"), routed beside a dense
    residual FFN ("moe+dense") or dense, and a VLM with `cross_attn_every`
    n is n - 1 of them and a [cross] with the same FFN; a MoE LM with MLA
    attention is one [mla] sublayer with a routed FFN; a hybrid is
    `attn_every` sublayers, mamba but for attention at index attn_every //
    2, with a routed FFN where the index is 1 modulo `moe_every` and a
    dense one elsewhere; an SSM LM (xLSTM) is [mlstm, slstm] with no FFN of
    their own. Another family raises ValueError."""
    fam = cfg.family
    if fam in ("dense", "vlm", "audio") or (fam == "moe" and cfg.attn_type == "gqa"):
        base_ffn = "moe+dense" if (cfg.n_experts and cfg.dense_residual_ff) else (
            "moe" if cfg.n_experts else "dense")
        if fam == "vlm" and cfg.cross_attn_every:
            n = cfg.cross_attn_every
            return [Sub("attn", base_ffn)] * (n - 1) + [Sub("cross", base_ffn)]
        return [Sub("attn", base_ffn)]
    if fam == "moe":  # mla
        return [Sub("mla", "moe")]
    if fam == "hybrid":
        attn_pos = cfg.attn_every // 2
        return [Sub("attn" if i == attn_pos else "mamba",
                    "moe" if (cfg.moe_every and i % cfg.moe_every == 1) else "dense")
                for i in range(cfg.attn_every)]
    if fam == "ssm":
        return [Sub("mlstm", "none"), Sub("slstm", "none")]
    raise ValueError(f"{cfg.name}: family {fam!r} has no group layout")


def n_groups(cfg: ModelConfig) -> int:
    lay = group_layout(cfg)
    if cfg.n_layers % len(lay):
        raise ValueError(f"{cfg.name}: {cfg.n_layers} layers do not tile a group of {len(lay)}")
    return cfg.n_layers // len(lay)


# ---------------------------------------------------------------------------
# init
# ---------------------------------------------------------------------------


def init_ffn(generator: torch.Generator, cfg: ModelConfig, d_ff: int,
             place=as_drawn) -> dict:
    d = cfg.d_model
    p = {"w1": place(dense_init(generator, (d, d_ff)), ("embed", "mlp"))}
    if cfg.mlp_activation not in ("relu", "relu2"):  # gated; non-gated is the ECR-sparse form
        p["w3"] = place(dense_init(generator, (d, d_ff)), ("embed", "mlp"))
    p["w2"] = place(dense_init(generator, (d_ff, d), fan_in=d_ff), ("mlp", "embed"))
    return p


def ffn_apply(p, x, cfg: ModelConfig):
    act = activation_fn(cfg.mlp_activation)
    if "w3" in p:
        h = act(x @ p["w1"].to(x.dtype)) * (x @ p["w3"].to(x.dtype))
    else:
        # ffn_sparsity="block_ecr" (minitron) stays this dense product: the
        # reference's branch only re-shards h and masks nothing, and the
        # block-masked form is `core.sparse_ffn.sparse_ffn_apply`
        h = act(x @ p["w1"].to(x.dtype))
    return h @ p["w2"].to(x.dtype)


def init_sublayer(generator: torch.Generator, sub: Sub, cfg: ModelConfig,
                  place=as_drawn) -> dict:
    init_mix = {"attn": attn_mod.init_gqa, "mla": attn_mod.init_mla,
                "cross": functools.partial(attn_mod.init_gqa, cross=True),
                "mamba": ssm_mod.init_mamba, "mlstm": xlstm_mod.init_mlstm,
                "slstm": xlstm_mod.init_slstm}.get(sub.kind)
    if init_mix is None:
        raise ValueError(f"sublayer kind {sub.kind!r}")
    p = {"ln1": place(ones_init((cfg.d_model,)), (None,)),
         "mix": init_mix(generator, cfg, place)}
    if sub.ffn != "none":
        p["ln2"] = place(ones_init((cfg.d_model,)), (None,))
        if "moe" in sub.ffn:
            p["moe"] = init_moe(generator, cfg, place)
        if sub.ffn in ("dense", "moe+dense"):
            p["ffn"] = init_ffn(generator, cfg, cfg.d_ff, place)
    return p


def init_groups(generator: torch.Generator, cfg: ModelConfig, place=as_drawn,
                layout=None, groups=None, with_axes: bool = False):
    """{"sub0": {...}} with every leaf stacked (n_groups, ...): `layout`
    (default `group_layout(cfg)`) repeated `groups` times (default
    `n_groups(cfg)`; whisper's encoder and decoder stacks pass theirs). Layer by
    layer, each leaf goes to `place(leaf)` as soon as it is drawn, then into
    its slot of the stacked leaf (made at layer 0 where `place` put the leaf),
    and is freed before the next leaf is drawn: the peak is the stacked tree
    plus one leaf (one full-width arctic-480b layer: 56 GB plus a 17.85 GB
    expert leaf), and with `place` moving leaves to the card the host holds
    one leaf at a time. `with_axes` also returns the logical-axes tree, each
    leaf's axes as drawn behind "layers" (the reference's `_stack_px`)."""
    lay = layout or group_layout(cfg)
    n = groups or n_groups(cfg)
    stacked, stacked_axes = [], []  # in draw order

    def into_slot(i):
        drawn = itertools.count()

        def put(t, axes):
            t, j = place(t), next(drawn)
            if i == 0:
                stacked.append(t.new_empty((n,) + tuple(t.shape)))
                stacked_axes.append(("layers",) + tuple(axes))
            stacked[j][i].copy_(t)
            return j  # the layer's tree holds each leaf's index in draw order
        return put

    for i in range(n):
        put = into_slot(i)  # one draw order over the whole group
        layer = {f"sub{j}": init_sublayer(generator, s, cfg, put) for j, s in enumerate(lay)}
    tree = tree_map(lambda j: stacked[j], layer)
    return (tree, tree_map(lambda j: stacked_axes[j], layer)) if with_axes else tree


def stacked_groups(tree) -> int:
    """The number of groups a stacked parameter tree holds: its first
    leaf's leading axis (`unstack_groups` holds every leaf to it)."""
    while isinstance(tree, dict):
        tree = next(iter(tree.values()))
    return tree.shape[0]


def unstack_groups(tree, n: int) -> list:
    """The n groups' parameter trees: every stacked leaf unbound along its
    layers axis (views). Under autograd one unbind per leaf gathers the n
    layer gradients with one stack; indexing each layer instead would add a
    full-size zero-filled gradient per layer and leaf."""
    if isinstance(tree, dict):
        parts = {k: unstack_groups(v, n) for k, v in tree.items()}
        return [{k: parts[k][i] for k in tree} for i in range(n)]
    if tree.shape[0] != n:
        raise ValueError(f"stacked leaf {tuple(tree.shape)} does not hold {n} groups")
    return tree.unbind(0)


# ---------------------------------------------------------------------------
# caches (decode / prefill state), aligned with the group layout
# ---------------------------------------------------------------------------


def init_group_caches(cfg: ModelConfig, batch: int, max_len: int, dtype,
                      device=None, layout=None, groups=None) -> tuple:
    """Per sublayer position of `layout` (default `group_layout(cfg)`), its
    cache stacked over the `groups` (default `n_groups(cfg)`): an [attn]
    sublayer's KVCache (n_groups, B, S_max, KV, hd), where dtype torch.int8
    gives the quantized cache with its scales; an [mla] sublayer's MLACache
    (n_groups, B, S_max, r) and (n_groups, B, S_max, dr), bfloat16 for an
    int8 request (the reference quantizes no latent state); a recurrent
    sublayer's state, (n_groups, ...) of `MambaState` (see
    `init_mamba_state`), `MLSTMState` or `SLSTMState`, fp32 for every
    request and whatever `max_len`; a [cross] sublayer's None (its K / V are
    recomputed from `kv_src` at every call)."""
    lay = layout or group_layout(cfg)
    g = groups or n_groups(cfg)
    caches = []
    for sub in lay:
        if sub.kind == "cross":
            caches.append(None)
            continue
        if sub.kind == "mla":
            c = attn_mod.init_mla_cache(cfg, batch, max_len,
                                        torch.bfloat16 if dtype == torch.int8 else dtype,
                                        device=device)
        elif sub.kind == "mamba":
            c = ssm_mod.init_mamba_state(cfg, batch, device=device)
        elif sub.kind == "mlstm":
            c = xlstm_mod.init_mlstm_state(cfg, batch, device=device)
        elif sub.kind == "slstm":
            c = xlstm_mod.init_slstm_state(cfg, batch, device=device)
        else:
            c = attn_mod.init_gqa_cache(cfg, batch, max_len, dtype, device=device)
        caches.append(type(c)(*(None if x is None else x.expand((g,) + x.shape).contiguous()
                                for x in c)))
    return tuple(caches)


def group_cache_axes(cfg: ModelConfig, quantized: bool, layout=None) -> tuple:
    """The logical axes of `init_group_caches`' tree: per sublayer position,
    its cache's axes behind "layers" (None for a [cross] slot), as the
    reference's `init_group_caches` returns them."""
    per_kind = {"attn": attn_mod.cache_axes(quantized), "mla": attn_mod.MLA_CACHE_AXES,
                "mamba": ssm_mod.MAMBA_STATE_AXES, "mlstm": xlstm_mod.MLSTM_STATE_AXES,
                "slstm": xlstm_mod.SLSTM_STATE_AXES}
    out = []
    for sub in layout or group_layout(cfg):
        a = per_kind.get(sub.kind)
        out.append(None if a is None else
                   type(a)(*(None if x is None else ("layers",) + x for x in a)))
    return tuple(out)


def _layer_cache(cache, i: int):
    """Group i's view of a stacked cache (KVCache, MLACache or a recurrent
    state; None for a [cross] slot)."""
    if cache is None:
        return None
    return type(cache)(*(None if x is None else x[i] for x in cache))


# ---------------------------------------------------------------------------
# forward
# ---------------------------------------------------------------------------


def apply_sublayer(sub: Sub, p, x, *, cfg, positions, cache, write_pos, causal,
                   kv_src=None):
    """-> (x, cache, aux): the routed FFN's output plus the dense FFN's,
    both from the same normed input, added to the residual; aux is the
    routed FFN's load-balancing loss (None without one). A recurrent
    sublayer's new state is copied into `cache` (a view of the stacked
    state), which is returned. `kv_src` reaches only a [cross] sublayer,
    which runs non-causal."""
    h = rms_norm(x, p["ln1"], cfg.norm_eps)
    if sub.kind in ("attn", "cross"):
        out, new_cache = attn_mod.gqa_attention(
            p["mix"], h, cfg=cfg, positions=positions,
            causal=causal and sub.kind == "attn", cache=cache, write_pos=write_pos,
            kv_src=kv_src if sub.kind == "cross" else None)
    elif sub.kind == "mla":
        out, new_cache = attn_mod.mla_attention(p["mix"], h, cfg=cfg, positions=positions,
                                                causal=causal, cache=cache,
                                                write_pos=write_pos)
    else:
        block = {"mamba": ssm_mod.mamba_block, "mlstm": xlstm_mod.mlstm_block,
                 "slstm": xlstm_mod.slstm_block}[sub.kind]
        out, state = block(p["mix"], h, cfg, state=cache)
        if cache is not None:
            for slot, new in zip(cache, state):
                slot.copy_(new)
        new_cache = cache
    x = x + out
    aux = None
    if sub.ffn != "none":
        h2 = rms_norm(x, p["ln2"], cfg.norm_eps)
        if "moe" in p:
            delta, aux = moe_ffn(p["moe"], h2, cfg)
            if "ffn" in p:
                delta = delta + ffn_apply(p["ffn"], h2, cfg)
        else:
            delta = ffn_apply(p["ffn"], h2, cfg)
        x = x + delta
    return x, new_cache, aux


def dots_policy(ctx, op, *args, **kwargs):
    """remat "dots" (the reference's `dots_with_no_batch_dims_saveable`):
    save the outputs of the matmuls that contract with no batch dimension,
    the q/k/v/o projections, the FFN's three, the router and the shared
    experts, and recompute everything else, the attention region included.
    `torch.einsum` lowers a batch-free contraction such as "bsd,dhk->bshk"
    to `aten.bmm` over a batch of one, `x @ w` to `aten.mm`: the policy keys
    on the batch the op contracts over, not on its name alone. The routed
    experts' products are `bmm`s over E > 1 experts, a batch dimension, so
    they are recomputed, as the reference's "ecd,edf->ecf" einsums are."""
    aten = torch.ops.aten
    if op is aten.mm.default or (op is aten.bmm.default and args[0].shape[0] == 1):
        return CheckpointPolicy.MUST_SAVE
    return CheckpointPolicy.PREFER_RECOMPUTE


def stack_apply(groups_params, x, *, cfg: ModelConfig, positions, caches=None,
                write_pos=None, causal=True, kv_src=None, remat: str = "none",
                layout=None):
    """Run the full group stack: `group_layout(cfg)` over `n_groups(cfg)`
    groups, or a `layout` given over as many groups as the stacked
    parameters hold (whisper's encoder and decoder). Returns (x, caches,
    aux_loss); the caches are the ones given, updated in place (None
    without caches); aux_loss sums the routed FFNs' losses over groups and
    sublayers (fp32). `kv_src` goes to the [cross] sublayers; `causal` to
    the [attn] ones.

    remat "full" recomputes each group's activations in the backward pass
    (`torch.utils.checkpoint`, non-reentrant: the reference's
    `jax.checkpoint` around its scan body); "dots" recomputes them too but
    keeps the batch-free matmul outputs (`dots_policy`); "none" keeps
    everything. The flash kernels are launches, not aten ops, so under
    "full" and "dots" alike each group's attention forward runs twice."""
    if remat not in ("none", "full", "dots"):
        raise ValueError(f"remat {remat!r}: choose from 'none', 'full', 'dots'")
    lay = layout or group_layout(cfg)
    n = n_groups(cfg) if layout is None else stacked_groups(groups_params)
    groups = unstack_groups(groups_params, n)

    def group(gi, x, aux):
        gp = groups[gi]
        for i, sub in enumerate(lay):
            cache = None if caches is None else _layer_cache(caches[i], gi)
            x, _, a = apply_sublayer(sub, gp[f"sub{i}"], x, cfg=cfg, positions=positions,
                                     cache=cache, write_pos=write_pos, causal=causal,
                                     kv_src=kv_src)
            if a is not None:
                aux = aux + a
        return x, aux

    aux = torch.zeros((), dtype=torch.float32, device=x.device)
    for gi in range(n):
        if remat == "full":
            x, aux = torch.utils.checkpoint.checkpoint(group, gi, x, aux, use_reentrant=False)
        elif remat == "dots":
            x, aux = torch.utils.checkpoint.checkpoint(
                group, gi, x, aux, use_reentrant=False,
                context_fn=functools.partial(create_selective_checkpoint_contexts,
                                             dots_policy))
        else:
            x, aux = group(gi, x, aux)
    return x, caches, aux
