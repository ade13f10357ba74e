"""Decoder stack as a loop over repeating layer groups (counterpart of
`repro.models.transformer`).

A *group* is the smallest repeating pattern of sublayers. The port covers
the dense LM, whose group is one [attn] sublayer with a dense FFN; the other
families (MoE, MLA, hybrid, SSM, VLM, audio) raise NotImplementedError until
ROADMAP queue 1 item 16 ports them.

Group parameters keep the reference's stacked leaves: every leaf of
`groups["sub0"]` carries a leading (n_layers,) axis, so weights carry over
from the JAX tree as they are. The reference's `lax.scan` over groups is a
Python loop over that axis here, and a layer's cache is a view into the
stacked (n_layers, ...) cache, written in place.
"""
from __future__ import annotations

import functools
from typing import NamedTuple

import torch
import torch.utils.checkpoint
from torch.utils.checkpoint import CheckpointPolicy, create_selective_checkpoint_contexts

from repro_torch.configs.base import ModelConfig
from repro_torch.core.sparse_ffn import activation_fn
from repro_torch.models import attention as attn_mod
from repro_torch.models.layers import as_drawn, dense_init, ones_init, rms_norm
from repro_torch.tree import tree_leaves, tree_map

FAMILIES_TODO = "ROADMAP queue 1 item 16 (the other LM families)"


class Sub(NamedTuple):
    kind: str  # attn (mla | cross | mamba | mlstm | slstm: not ported)
    ffn: str  # dense | none (moe | moe+dense: not ported)


def group_layout(cfg: ModelConfig) -> list:
    if cfg.family == "dense" and not cfg.n_experts and cfg.attn_type == "gqa":
        return [Sub("attn", "dense")]
    raise NotImplementedError(f"{cfg.name}: family {cfg.family!r} is not ported "
                              f"yet; see {FAMILIES_TODO}")


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
    p = {"w1": place(dense_init(generator, (d, d_ff)))}
    if cfg.mlp_activation not in ("relu", "relu2"):  # gated; non-gated is the ECR-sparse form
        p["w3"] = place(dense_init(generator, (d, d_ff)))
    p["w2"] = place(dense_init(generator, (d_ff, d), fan_in=d_ff))
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
    if sub.kind != "attn":
        raise NotImplementedError(f"sublayer {sub.kind!r}: see {FAMILIES_TODO}")
    p = {"ln1": place(ones_init((cfg.d_model,))),
         "mix": attn_mod.init_gqa(generator, cfg, place)}
    if sub.ffn != "none":
        p["ln2"] = place(ones_init((cfg.d_model,)))
        p["ffn"] = init_ffn(generator, cfg, cfg.d_ff, place)
    return p


def init_groups(generator: torch.Generator, cfg: ModelConfig, place=as_drawn) -> dict:
    """{"sub0": {...}} with every leaf stacked (n_groups, ...). Layer by
    layer, each leaf goes to `place` as soon as it is drawn and is then
    copied into its slot of the stacked leaf, made where `place` put layer
    0's: with `place` moving leaves to the card, the host holds one leaf at a
    time."""
    lay = group_layout(cfg)
    n = n_groups(cfg)
    stacked = None
    for i in range(n):
        layer = {f"sub{j}": init_sublayer(generator, s, cfg, place)
                 for j, s in enumerate(lay)}
        if stacked is None:
            stacked = tree_map(lambda t: t.new_empty((n,) + tuple(t.shape)), layer)
        for dst, src in zip(tree_leaves(stacked), tree_leaves(layer)):
            dst[i].copy_(src)
    return stacked


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
                      device=None) -> tuple:
    """Per sublayer position, a KVCache stacked (n_groups, B, S_max, KV, hd);
    dtype torch.int8 gives the quantized cache with its scales."""
    g = n_groups(cfg)
    caches = []
    for _ in group_layout(cfg):
        c = attn_mod.init_gqa_cache(cfg, batch, max_len, dtype, device=device)
        caches.append(attn_mod.KVCache(*(None if x is None else
                                         x.expand((g,) + x.shape).contiguous()
                                         for x in c)))
    return tuple(caches)


def _layer_cache(cache, i: int):
    return attn_mod.KVCache(*(None if x is None else x[i] for x in cache))


# ---------------------------------------------------------------------------
# forward
# ---------------------------------------------------------------------------


def apply_sublayer(sub: Sub, p, x, *, cfg, positions, cache, write_pos, causal):
    h = rms_norm(x, p["ln1"], cfg.norm_eps)
    out, new_cache = attn_mod.gqa_attention(
        p["mix"], h, cfg=cfg, positions=positions, causal=causal, cache=cache,
        write_pos=write_pos)
    x = x + out
    if sub.ffn != "none":
        x = x + ffn_apply(p["ffn"], rms_norm(x, p["ln2"], cfg.norm_eps), cfg)
    return x, new_cache


def dots_policy(ctx, op, *args, **kwargs):
    """remat "dots" (the reference's `dots_with_no_batch_dims_saveable`):
    save the outputs of the matmuls that contract with no batch dimension,
    the q/k/v/o projections and the FFN's three, and recompute everything
    else, the attention region included. `torch.einsum` lowers a batch-free
    contraction such as "bsd,dhk->bshk" to `aten.bmm` over a batch of one,
    `x @ w` to `aten.mm`: the policy keys on the batch the op contracts
    over, not on its name alone."""
    aten = torch.ops.aten
    if op is aten.mm.default or (op is aten.bmm.default and args[0].shape[0] == 1):
        return CheckpointPolicy.MUST_SAVE
    return CheckpointPolicy.PREFER_RECOMPUTE


def stack_apply(groups_params, x, *, cfg: ModelConfig, positions, caches=None,
                write_pos=None, causal=True, remat: str = "none"):
    """Run the full group stack. Returns (x, caches, aux_loss); the caches are
    the ones given, updated in place (None without caches).

    remat "full" recomputes each group's activations in the backward pass
    (`torch.utils.checkpoint`, non-reentrant: the reference's
    `jax.checkpoint` around its scan body); "dots" recomputes them too but
    keeps the batch-free matmul outputs (`dots_policy`); "none" keeps
    everything. The flash kernels are launches, not aten ops, so under
    "full" and "dots" alike each group's attention forward runs twice."""
    if remat not in ("none", "full", "dots"):
        raise ValueError(f"remat {remat!r}: choose from 'none', 'full', 'dots'")
    lay = group_layout(cfg)
    groups = unstack_groups(groups_params, n_groups(cfg))

    def group(gi, x):
        gp = groups[gi]
        for i, sub in enumerate(lay):
            cache = None if caches is None else _layer_cache(caches[i], gi)
            x, _ = apply_sublayer(sub, gp[f"sub{i}"], x, cfg=cfg, positions=positions,
                                  cache=cache, write_pos=write_pos, causal=causal)
        return x

    for gi in range(n_groups(cfg)):
        if remat == "full":
            x = torch.utils.checkpoint.checkpoint(group, gi, x, use_reentrant=False)
        elif remat == "dots":
            x = torch.utils.checkpoint.checkpoint(
                group, gi, x, use_reentrant=False,
                context_fn=functools.partial(create_selective_checkpoint_contexts,
                                             dots_policy))
        else:
            x = group(gi, x)
    return x, caches, torch.zeros((), dtype=torch.float32, device=x.device)
