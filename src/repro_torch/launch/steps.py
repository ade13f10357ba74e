"""Serve step functions (counterpart of `repro.launch.steps`; the train step
comes with the training slice). No `jit`: PyTorch runs eagerly, and the
steps run under `torch.no_grad()`."""
from __future__ import annotations

import torch

from repro_torch.configs.base import ModelConfig, RunConfig
from repro_torch.models import model as M


def make_prefill_step(cfg: ModelConfig, run: RunConfig):
    @torch.no_grad()
    def prefill_step(params, caches, batch):
        return M.prefill(cfg, params, caches, batch)

    return prefill_step


def make_serve_step(cfg: ModelConfig, run: RunConfig):
    """One decode step: greedy next token against the cache."""

    @torch.no_grad()
    def serve_step(params, caches, batch, pos):
        logits, new_caches = M.decode_step(cfg, params, caches, batch, pos)
        return torch.argmax(logits[:, -1, :], dim=-1).to(torch.int32), new_caches

    return serve_step
