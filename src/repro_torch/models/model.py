"""Public LM API: init / cache / forward / loss / prefill / decode
(counterpart of `repro.models.model`).

All families go through one `forward`:
  - LM (dense / moe / ssm / hybrid / vlm): token embed -> group stack ->
    logits; a VLM batch carries `img_embeds` (B, n_image_tokens, D), the
    cross sublayers' `kv_src`;
  - audio (whisper): a batch with `frames` (B, T, D) runs them plus
    sinusoidal positions through the non-causal encoder stack (`enc_groups`,
    then `enc_norm`), one without reads the encoder output `enc_out`; the
    decoder stack (self-attention with a cache, then cross-attention over
    the encoder output) runs over the tokens plus absolute sinusoidal
    positions.

Step semantics:
  train:   lm_loss(batch with tokens, labels) -> scalar next-token loss
  prefill: forward(tokens, caches, write_pos=0) -> logits + filled caches
  decode:  forward(one token, caches, write_pos=pos) -> next-token logits

Parameters are a plain dict with the reference's tree and layouts
({"embed", "final_norm", "groups", ["unembed"]}, and for an
encoder-decoder "enc_groups" and "enc_norm"), each leaf with the
reference's logical axes (`param_axes`, `abstract_params`; the caches'
`abstract_cache`, the steps' `input_specs`), drawn from a
`torch.Generator` on its own device and moved to `device` (None = the card)
leaf by leaf. Without caches
`forward` and `lm_loss` are differentiable (the attention backward is the
flash backward kernels); the cache paths are for serving and run under
`torch.no_grad()`, as `launch/serve.py` does.
"""
from __future__ import annotations

import math

import torch
import torch.utils.checkpoint

from repro_torch.configs.base import ModelConfig, ShapeConfig
from repro_torch.device import resolve_device
from repro_torch.models.layers import embed_init, ones_init, rms_norm, sinusoid_positions
from repro_torch.models.transformer import (
    Sub,
    group_layout,
    group_cache_axes,
    init_group_caches,
    init_groups,
    n_groups,
    stack_apply,
)
from repro_torch.tree import tree_leaves

AUDIO_DEC_LAYOUT = [Sub("attn", "none"), Sub("cross", "dense")]
AUDIO_ENC_LAYOUT = [Sub("attn", "dense")]


def group_stacks(cfg: ModelConfig) -> dict:
    """Each stacked-group subtree of the parameters -> (its layout, its
    number of groups): "groups" for every arch (an encoder-decoder's
    decoder: AUDIO_DEC_LAYOUT x n_layers), and "enc_groups" (AUDIO_ENC_LAYOUT
    x n_encoder_layers) for an encoder-decoder."""
    if cfg.is_encoder_decoder:
        return {"enc_groups": (AUDIO_ENC_LAYOUT, cfg.n_encoder_layers),
                "groups": (AUDIO_DEC_LAYOUT, cfg.n_layers)}
    return {"groups": (group_layout(cfg), n_groups(cfg))}


def init_params(cfg: ModelConfig, generator: torch.Generator, *, device=None,
                dtype=torch.float32, with_axes: bool = False):
    """Random parameters in the reference's tree, drawn leaf by leaf in a
    fixed order on the generator's device, each cast to `dtype` and moved to
    `device` as soon as it is drawn: a host generator holds one leaf at a
    time on the host and gives the same tree on every device. `with_axes`
    returns (params, logical-axes tree), as the reference's `init_params`
    does; each leaf's axes are named where it is drawn."""
    dev = resolve_device(device)

    def place(t):
        return t.to(device=dev, dtype=dtype)

    p, axes = {}, {}

    def leaf(name, t, ax):
        p[name], axes[name] = place(t), ax

    d, v = cfg.d_model, cfg.vocab_size
    leaf("embed", embed_init(generator, (v, d)), ("vocab", "embed"))
    leaf("final_norm", ones_init((d,)), (None,))
    for name, (layout, groups) in group_stacks(cfg).items():
        p[name], axes[name] = init_groups(generator, cfg, place, layout=layout,
                                          groups=groups, with_axes=True)
        if name == "enc_groups":
            leaf("enc_norm", ones_init((d,)), (None,))
    if not cfg.tie_embeddings:
        leaf("unembed", embed_init(generator, (d, v)), ("embed", "vocab"))
    return (p, axes) if with_axes else p


def abstract_params(cfg: ModelConfig, dtype=torch.float32) -> tuple:
    """(tree of meta tensors in `dtype`, logical-axes tree): the parameters'
    shapes with no memory and no random numbers (the reference's
    ShapeDtypeStruct tree)."""
    with torch.device("meta"):
        return init_params(cfg, None, device="meta", dtype=dtype, with_axes=True)


def param_axes(cfg: ModelConfig) -> dict:
    """The logical-axes tree matching `init_params`' tree."""
    return abstract_params(cfg)[1]


def count_params_analytic(cfg: ModelConfig, active_only: bool = False) -> int:
    """The number of parameters `init_params` makes for `cfg`, counted from
    `abstract_params`. `active_only` counts what one token uses: each leaf
    whose axes name "experts" (the routed experts) scaled by
    top_k / n_experts, rounded down leaf by leaf, as the reference does."""
    from repro_torch.parallel.api import axes_leaves  # parallel imports this module

    shapes, axes = abstract_params(cfg)
    total = 0
    for s, a in zip(tree_leaves(shapes), axes_leaves(axes)):
        n = s.numel()
        if active_only and "experts" in a:
            n = int(n * cfg.top_k / max(cfg.n_experts, 1))
        total += n
    return total


def init_cache(cfg: ModelConfig, batch: int, max_len: int, dtype=torch.float32,
               device=None) -> tuple:
    """The decode/prefill cache tree: one cache per sublayer position,
    stacked over groups: a KVCache, where dtype torch.int8 quantizes K/V
    (fp32 scales), for MLA an MLACache of the latent and the rotary key,
    bfloat16 for an int8 request, for a recurrent sublayer its state, and
    None for a cross-attention sublayer (`models.transformer.
    init_group_caches`); an encoder-decoder's over its decoder stack."""
    layout, groups = group_stacks(cfg)["groups"]
    return init_group_caches(cfg, batch, max_len, dtype, device=resolve_device(device),
                             layout=layout, groups=groups)


def abstract_cache(cfg: ModelConfig, batch: int, max_len: int, dtype=torch.float32) -> tuple:
    """(cache tree of meta tensors, logical-axes tree) without allocating:
    `init_cache`'s tree on the meta device, and per sublayer position its
    cache's axes behind "layers" (the reference's `abstract_cache`)."""
    with torch.device("meta"):
        caches = init_cache(cfg, batch, max_len, dtype, device="meta")
    layout, _ = group_stacks(cfg)["groups"]
    return caches, group_cache_axes(cfg, dtype == torch.int8, layout)


def input_specs(cfg: ModelConfig, shape: ShapeConfig, dtype=torch.bfloat16) -> dict:
    """The step's inputs as meta tensors (the reference's ShapeDtypeStruct
    stand-ins): tokens / labels (B, S) int32 for a train shape, tokens for
    prefill, one token (B, 1) for decode; img_embeds for a VLM; frames
    (B, S, D) for an encoder-decoder, or enc_out at decode."""
    b, s = shape.global_batch, shape.seq_len

    def meta(shp, dt=dtype):
        return torch.empty(shp, dtype=dt, device="meta")

    spec = {"tokens": meta((b, 1 if shape.kind == "decode" else s), torch.int32)}
    if shape.kind == "train":
        spec["labels"] = meta((b, s), torch.int32)
    if cfg.family == "vlm":
        spec["img_embeds"] = meta((b, cfg.n_image_tokens, cfg.d_model))
    if cfg.is_encoder_decoder:
        spec["enc_out" if shape.kind == "decode" else "frames"] = meta((b, s, cfg.d_model))
    return spec


def _logits(cfg, params, x):
    x = rms_norm(x, params["final_norm"], cfg.norm_eps)
    w = params["embed"].T if cfg.tie_embeddings else params["unembed"]
    logits = torch.matmul(x, w.to(x.dtype))
    if cfg.logit_softcap:
        logits = torch.tanh(logits / cfg.logit_softcap) * cfg.logit_softcap
    return logits


def forward(cfg: ModelConfig, params, batch: dict, *, caches=None, write_pos=None,
            remat: str = "none", return_hidden: bool = False):
    """Returns (logits, caches, aux_loss), or (final-normed hidden states,
    caches, aux_loss) with `return_hidden`; the caches, if given, are
    updated in place and returned."""
    wp = 0 if write_pos is None else int(write_pos)
    if cfg.is_encoder_decoder:
        return _forward_encdec(cfg, params, batch, caches=caches, write_pos=wp,
                               remat=remat, return_hidden=return_hidden)
    tokens = batch["tokens"]
    b, s = tokens.shape
    x = params["embed"][tokens]
    positions = (wp + torch.arange(s, device=tokens.device))[None, :].expand(b, s)
    kv_src = batch.get("img_embeds") if cfg.family == "vlm" else None
    x, new_caches, aux = stack_apply(params["groups"], x, cfg=cfg, positions=positions,
                                     caches=caches, write_pos=write_pos, causal=True,
                                     kv_src=kv_src, remat=remat)
    if return_hidden:
        return rms_norm(x, params["final_norm"], cfg.norm_eps), new_caches, aux
    return _logits(cfg, params, x), new_caches, aux


def encode(cfg: ModelConfig, params, frames, *, remat: str = "none"):
    """The encoder of an encoder-decoder: frames (B, T, D) plus sinusoidal
    positions through the non-causal `enc_groups` stack, then `enc_norm`
    -> the decoder's `kv_src` (B, T, D)."""
    t = frames.shape[1]
    pe = sinusoid_positions(t, cfg.d_model, frames.dtype, device=frames.device)
    pos = torch.arange(t, device=frames.device)[None].expand(frames.shape[0], t)
    enc_out, _, _ = stack_apply(params["enc_groups"], frames + pe[None], cfg=cfg,
                                positions=pos, causal=False, remat=remat,
                                layout=AUDIO_ENC_LAYOUT)
    return rms_norm(enc_out, params["enc_norm"], cfg.norm_eps)


def _forward_encdec(cfg, params, batch, *, caches, write_pos, remat,
                    return_hidden: bool = False):
    """The reference's `_forward_encdec`: the encoder over `frames` if the
    batch has them, else its `enc_out`; then the decoder stack over the
    tokens at absolute positions write_pos .., cross-attending to it."""
    enc_out = (encode(cfg, params, batch["frames"], remat=remat) if "frames" in batch
               else batch["enc_out"])
    tokens = batch["tokens"]
    b, s = tokens.shape
    x = params["embed"][tokens]
    pos = (write_pos + torch.arange(s, device=tokens.device))[None, :]
    x = x + _abs_pos(pos, cfg.d_model, x.dtype)
    x, new_caches, aux = stack_apply(
        params["groups"], x, cfg=cfg, positions=pos.expand(b, s), caches=caches,
        write_pos=write_pos, causal=True, kv_src=enc_out, remat=remat,
        layout=AUDIO_DEC_LAYOUT)
    if return_hidden:
        return rms_norm(x, params["final_norm"], cfg.norm_eps), new_caches, aux
    return _logits(cfg, params, x), new_caches, aux


def _abs_pos(pos, d: int, dtype):
    """Sinusoidal absolute positions of `pos` (any shape), [sin ; cos] over
    the last axis (not the interleaved layout of `sinusoid_positions`)."""
    div = torch.exp(-torch.arange(0, d, 2, dtype=torch.float32, device=pos.device) / d
                    * math.log(10_000.0))
    ang = pos.float()[..., None] * div
    return torch.cat([torch.sin(ang), torch.cos(ang)], dim=-1).to(dtype)


def _chunked_xent(x, w_t, labels, vocab_chunk: int = 16384):
    """Cross-entropy without materializing the (B,S,V) logits: a loop over
    vocab chunks with running (max, sumexp, gold), each chunk checkpointed so
    the backward recomputes its logits (the reference's scan of
    `jax.checkpoint`ed bodies). Mean over labels >= 0."""
    b, s, _ = x.shape
    v = w_t.shape[1]
    cs = min(vocab_chunk, v)
    lab = labels.long()

    def chunk(m, acc, gold, c0):
        lg = (x @ w_t[:, c0:c0 + cs]).float()  # the last chunk may be short
        m_new = torch.maximum(m, lg.amax(-1))
        acc = acc * torch.exp(m - m_new) + torch.exp(lg - m_new[..., None]).sum(-1)
        idx = lab - c0
        in_range = (idx >= 0) & (idx < lg.shape[-1])
        g = torch.gather(lg, -1, idx.clamp(0, lg.shape[-1] - 1)[..., None])[..., 0]
        return m_new, acc, gold + torch.where(in_range, g, torch.zeros_like(g))

    m = torch.full((b, s), -1e30, dtype=torch.float32, device=x.device)
    acc = torch.zeros((b, s), dtype=torch.float32, device=x.device)
    gold = torch.zeros((b, s), dtype=torch.float32, device=x.device)
    for c0 in range(0, v, cs):
        m, acc, gold = torch.utils.checkpoint.checkpoint(chunk, m, acc, gold, c0,
                                                         use_reentrant=False)
    lse = torch.log(torch.clamp_min(acc, 1e-30)) + m
    mask = (labels >= 0).float()
    return ((lse - gold) * mask).sum() / torch.clamp_min(mask.sum(), 1.0)


# The reference's threshold (`repro.models.model.LOSS_VOCAB_CHUNK_MIN`): the
# chunked loss cuts peak logits memory but not traffic, so it is off for
# every vocab the configs have.
LOSS_VOCAB_CHUNK_MIN = 1 << 30


def lm_loss(cfg: ModelConfig, params, batch, *, remat: str = "none"):
    """Mean next-token cross-entropy over labels >= 0, plus the aux loss."""
    labels = batch["labels"]
    if cfg.vocab_size >= LOSS_VOCAB_CHUNK_MIN and not cfg.logit_softcap:
        x, _, aux = forward(cfg, params, batch, remat=remat, return_hidden=True)
        w = params["embed"].T if cfg.tie_embeddings else params["unembed"]
        return _chunked_xent(x, w.to(x.dtype), labels) + aux
    logits, _, aux = forward(cfg, params, batch, remat=remat)
    lg = logits.float()
    lse = torch.logsumexp(lg, dim=-1)
    gold = torch.gather(lg, -1, labels.long().clamp_min(0)[..., None])[..., 0]
    mask = (labels >= 0).float()
    nll = ((lse - gold) * mask).sum() / torch.clamp_min(mask.sum(), 1.0)
    return nll + aux


def prefill(cfg, params, caches, batch):
    logits, new_caches, _ = forward(cfg, params, batch, caches=caches, write_pos=0)
    return logits, new_caches


def decode_step(cfg, params, caches, batch, pos):
    """batch["tokens"]: (B,1); pos: the write position -> (logits, caches)."""
    logits, new_caches, _ = forward(cfg, params, batch, caches=caches, write_pos=pos)
    return logits, new_caches
