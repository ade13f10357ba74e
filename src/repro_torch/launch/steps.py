"""Step functions: the train step (gradient accumulation, remat, AdamW) and
the serve steps (counterpart of `repro.launch.steps`). No `jit`: PyTorch runs
eagerly. The serve steps run under `torch.no_grad()`; the train step takes
its gradients with `torch.autograd.grad`, through the flash backward kernels
on the card. Parameters (and so activations and gradients) are in
`run.param_dtype`, bfloat16 by default as in the reference; the moments in
`run.moment_dtype`; AdamW and the gradient-accumulation sums work in
float32. Like the reference's, the train step does not read
`run.grad_compression`: `optim.compression` is a library.
"""
from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from repro_torch.configs.base import ModelConfig, RunConfig
from repro_torch.device import resolve_device
from repro_torch.models import model as M
from repro_torch.optim.adamw import OptState, adamw_update, init_opt_state
from repro_torch.optim.schedules import warmup_cosine
from repro_torch.tree import tree_leaves, tree_map, tree_unflatten

DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}


class TrainState(NamedTuple):
    params: dict
    opt: OptState


def init_train_state(cfg: ModelConfig, run: RunConfig, generator: torch.Generator,
                     device=None, dtype=None) -> TrainState:
    """Random parameters from `generator` (in `run.param_dtype` unless
    `dtype` is given) and zero moments (`run.moment_dtype`) on `device`
    (None = the card)."""
    dtype = dtype or DTYPES[run.param_dtype]
    params = M.init_params(cfg, generator, device=resolve_device(device), dtype=dtype)
    return TrainState(params=params, opt=init_opt_state(params, DTYPES[run.moment_dtype]))


def to_device(batch: dict, device) -> dict:
    """A batch of numpy arrays or tensors -> tensors on `device`."""
    return {k: (torch.from_numpy(np.asarray(v)) if not isinstance(v, torch.Tensor) else v)
            .to(device) for k, v in batch.items()}


def loss_and_grads(cfg: ModelConfig, run: RunConfig, params: dict, batch: dict):
    """(loss, grads) of `M.lm_loss` at `params` on one (micro)batch of
    tensors: the gradients of detached copies of the leaves, so the state's
    tensors carry no autograd history."""
    leaves = [p.detach().requires_grad_(True) for p in tree_leaves(params)]
    loss = M.lm_loss(cfg, tree_unflatten(params, leaves), batch, remat=run.remat)
    grads = torch.autograd.grad(loss, leaves)
    return loss.detach(), tree_unflatten(params, list(grads))


def make_train_step(cfg: ModelConfig, run: RunConfig, total_steps: int = 10_000,
                    device=None):
    """(state, batch) -> (state, {"loss", "grad_norm", "lr"}) on `device`
    (None = the card); the batch may be numpy arrays or tensors. With
    `run.grad_accum` > 1 the batch splits into that many microbatches whose
    gradients sum in float32 and are averaged, as is the loss. The learning
    rate comes from the step count before the update, as the reference's
    does. The state is updated in place and returned."""
    dev = resolve_device(device)
    ga = run.grad_accum

    def train_step(state: TrainState, batch: dict):
        batch = to_device(batch, dev)
        params = state.params
        if ga > 1:
            mbs = [{k: v.reshape(ga, v.shape[0] // ga, *v.shape[1:])[i]
                    for k, v in batch.items()} for i in range(ga)]
            gsum = tree_map(lambda p: torch.zeros(p.shape, dtype=torch.float32,
                                                  device=p.device), params)
            lsum = torch.zeros((), dtype=torch.float32, device=dev)
            for mb in mbs:
                loss, grads = loss_and_grads(cfg, run, params, mb)
                tree_map(lambda a, g: a.add_(g.float()), gsum, grads)
                lsum = lsum + loss
            grads = tree_map(lambda g: g / ga, gsum)
            loss = lsum / ga
        else:
            loss, grads = loss_and_grads(cfg, run, params, batch)
        lr = warmup_cosine(state.opt.step, peak_lr=run.learning_rate,
                           warmup_steps=run.warmup_steps, total_steps=total_steps)
        new_params, new_opt, gnorm = adamw_update(
            grads, state.opt, params, lr=lr, beta1=run.beta1, beta2=run.beta2,
            weight_decay=run.weight_decay, grad_clip=run.grad_clip)
        metrics = {"loss": loss, "grad_norm": gnorm, "lr": lr}
        return TrainState(params=new_params, opt=new_opt), metrics

    return train_step


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
