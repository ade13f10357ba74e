"""Public LM API: init / cache / forward / prefill / decode (counterpart of
`repro.models.model`, the decoder-only LM branch).

Step semantics:
  prefill: forward(tokens, caches, write_pos=0) -> logits + filled caches
  decode:  forward(one token, caches, write_pos=pos) -> next-token logits

Parameters are a plain dict with the reference's tree and layouts
({"embed", "final_norm", "groups", ["unembed"]}), drawn on the host from a
`torch.Generator` and moved to `device` (None = the card). The LM has no
backward yet (the flash backward kernel comes with the training slice): run
it under `torch.no_grad()`, as `launch/serve.py` does.
"""
from __future__ import annotations

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.device import resolve_device
from repro_torch.models.layers import embed_init, ones_init, rms_norm
from repro_torch.models.transformer import (
    FAMILIES_TODO,
    init_group_caches,
    init_groups,
    stack_apply,
)


def _check_family(cfg: ModelConfig) -> None:
    if cfg.is_encoder_decoder or cfg.family != "dense":
        raise NotImplementedError(f"{cfg.name}: family {cfg.family!r} is not "
                                  f"ported yet; see {FAMILIES_TODO}")


def _to(tree, device, dtype):
    if isinstance(tree, dict):
        return {k: _to(v, device, dtype) for k, v in tree.items()}
    return tree.to(device=device, dtype=dtype)


def init_params(cfg: ModelConfig, generator: torch.Generator, *, device=None,
                dtype=torch.float32) -> dict:
    """Random parameters in the reference's tree (no logical-axes tree: the
    port has no mesh)."""
    _check_family(cfg)
    dev = resolve_device(device)
    d, v = cfg.d_model, cfg.vocab_size
    p = {"embed": embed_init(generator, (v, d)), "final_norm": ones_init((d,)),
         "groups": init_groups(generator, cfg)}
    if not cfg.tie_embeddings:
        p["unembed"] = embed_init(generator, (d, v))
    return _to(p, dev, dtype)


def init_cache(cfg: ModelConfig, batch: int, max_len: int, dtype=torch.float32,
               device=None) -> tuple:
    """The decode/prefill cache tree: one KVCache per sublayer position,
    stacked over layers; dtype torch.int8 quantizes K/V (fp32 scales)."""
    _check_family(cfg)
    return init_group_caches(cfg, batch, max_len, dtype, device=resolve_device(device))


def _logits(cfg, params, x):
    x = rms_norm(x, params["final_norm"], cfg.norm_eps)
    w = params["embed"].T if cfg.tie_embeddings else params["unembed"]
    logits = torch.matmul(x, w.to(x.dtype))
    if cfg.logit_softcap:
        logits = torch.tanh(logits / cfg.logit_softcap) * cfg.logit_softcap
    return logits


def forward(cfg: ModelConfig, params, batch: dict, *, caches=None, write_pos=None):
    """Returns (logits, caches, aux_loss); the caches, if given, are updated
    in place and returned."""
    _check_family(cfg)
    wp = 0 if write_pos is None else int(write_pos)
    tokens = batch["tokens"]
    b, s = tokens.shape
    x = params["embed"][tokens]
    positions = (wp + torch.arange(s, device=tokens.device))[None, :].expand(b, s)
    x, new_caches, aux = stack_apply(params["groups"], x, cfg=cfg, positions=positions,
                                     caches=caches, write_pos=write_pos, causal=True)
    return _logits(cfg, params, x), new_caches, aux


def prefill(cfg, params, caches, batch):
    logits, new_caches, _ = forward(cfg, params, batch, caches=caches, write_pos=0)
    return logits, new_caches


def decode_step(cfg, params, caches, batch, pos):
    """batch["tokens"]: (B,1); pos: the write position -> (logits, caches)."""
    logits, new_caches, _ = forward(cfg, params, batch, caches=caches, write_pos=pos)
    return logits, new_caches
