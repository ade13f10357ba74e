"""AdamW with gradient clipping by global norm (counterpart of
`repro.optim.adamw`).

The reference's rule: clip scale min(1, clip / (norm + 1e-9)), bias-corrected
moments, decoupled weight decay, all in float32. The JAX update is pure and
returns new trees; this one updates the parameters and moments in place under
`torch.no_grad()` (the trees are returned as well) so that a step holds no
second copy of either.
"""
from __future__ import annotations

from typing import NamedTuple

import torch

from repro_torch.tree import tree_leaves, tree_map


class OptState(NamedTuple):
    step: torch.Tensor  # () int32
    m: dict
    v: dict


def init_opt_state(params, moment_dtype=torch.float32) -> OptState:
    def zeros(p):
        return torch.zeros(p.shape, dtype=moment_dtype, device=p.device)

    step = torch.zeros((), dtype=torch.int32, device=tree_leaves(params)[0].device)
    return OptState(step=step, m=tree_map(zeros, params), v=tree_map(zeros, params))


def global_norm(tree) -> torch.Tensor:
    return torch.sqrt(sum(torch.sum(torch.square(x.float())) for x in tree_leaves(tree)))


@torch.no_grad()
def adamw_update(grads, state: OptState, params, *, lr, beta1=0.9, beta2=0.95,
                 eps=1e-8, weight_decay=0.1, grad_clip=1.0, grad_norm=None):
    """Returns (params, new_state, grad_norm); `params` and the moments are
    updated in place. `grad_norm` is the global norm to clip by when the
    trees hold shards of the model (the sharded trainer's, counted over
    the unique shards); by default the norm of `grads`."""
    step = state.step + 1
    gnorm = global_norm(grads) if grad_norm is None else grad_norm
    if grad_clip > 0:
        scale = torch.clamp(grad_clip / (gnorm + 1e-9), max=1.0)
    else:
        scale = torch.ones((), dtype=torch.float32, device=gnorm.device)
    sf = step.to(torch.float32)
    bc1 = 1.0 - torch.pow(torch.tensor(beta1, dtype=torch.float32, device=sf.device), sf)
    bc2 = 1.0 - torch.pow(torch.tensor(beta2, dtype=torch.float32, device=sf.device), sf)
    lr = torch.as_tensor(lr, dtype=torch.float32, device=sf.device)

    def upd(g, m, v, p):
        g = g.float() * scale
        m32 = beta1 * m.float() + (1 - beta1) * g
        v32 = beta2 * v.float() + (1 - beta2) * torch.square(g)
        update = (m32 / bc1) / (torch.sqrt(v32 / bc2) + eps)
        p32 = p.float()
        p.copy_(p32 - lr * (update + weight_decay * p32))
        m.copy_(m32)
        v.copy_(v32)

    tree_map(upd, grads, state.m, state.v, params)
    return params, OptState(step=step, m=state.m, v=state.v), gnorm
