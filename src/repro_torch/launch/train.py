"""Training launcher on the port: supervised loop over the train step with
async checkpoints and restart (counterpart of `repro.launch.train`), in
one process or over a ("data", "model") mesh of `torch.distributed` ranks
(`build_trainer`, `--model-axis`).

It trains as the reference's launcher does, at `DEFAULT_RUN`'s types:
bfloat16 parameters and activations (the flash kernels' bf16 entry points
on the card), float32 AdamW moments and gradient sums, and activations
recomputed per layer in the backward pass (remat "full"). The batch shape is
a `ShapeConfig("custom_train", seq_len, global_batch, "train")`. For the
float32 trainer, build the state with `init_train_state` and the step with
`make_train_step` at `DEFAULT_RUN.replace(param_dtype="float32")`.

Run on the card (default device "cuda"); qwen3-0.6b trains at full width,
the larger archs (minitron-8b, stablelm-12b, mistral-large-123b, the MoE
arctic-480b, whose router aux loss joins the loss, the MLA deepseek-v2-236b
and the hybrid jamba-v0.1-52b) at their reduced configs, since bf16 weights
with fp32 moments take 12 bytes a parameter, past one card at 8 B
parameters (arctic-480b has ~477 B). MLA trains through `MLAAttentionFn`
(the MLA kernel and its two backward kernels), Mamba through
`SelectiveScanFn` (the scan and its backward kernel):
    PYTHONPATH=src python -m repro_torch.launch.train --arch qwen3-0.6b --full --steps 6
    PYTHONPATH=src python -m repro_torch.launch.train --arch minitron-8b --steps 3 --no-resume
    PYTHONPATH=src python -m repro_torch.launch.train --arch deepseek-v2-236b --steps 3 --no-resume
    PYTHONPATH=src python -m repro_torch.launch.train --arch jamba-v0.1-52b --steps 3 --no-resume
On the host, through the kernels' plain PyTorch versions (reduced config):
    PYTHONPATH=src python -m repro_torch.launch.train --arch qwen3-0.6b --device cpu --steps 4
    PYTHONPATH=src python -m repro_torch.launch.train --arch arctic-480b --device cpu --steps 2 --no-resume
    PYTHONPATH=src python -m repro_torch.launch.train --arch deepseek-v2-236b --device cpu --steps 2 --no-resume
    PYTHONPATH=src python -m repro_torch.launch.train --arch jamba-v0.1-52b --device cpu --steps 2 --no-resume
Over ranks, under torchrun: params and moments stored sharded by the
logical-axis rules (ZeRO-3 storage over the data axis; a step gathers the
whole model, ROADMAP queue 1 [30]), the global batch split over the data
axis, gradients reduce-scattered onto the shards; gloo on the host, NCCL
where a host has a card for each of its ranks:
    PYTHONPATH=src torchrun --nproc-per-node 4 -m repro_torch.launch.train --arch qwen3-0.6b --device cpu --model-axis 2 --steps 4 --no-resume
    PYTHONPATH=src torchrun --nproc-per-node 8 -m repro_torch.launch.train --arch qwen3-0.6b --full --model-axis 2 --steps 6 --no-resume
"""
from __future__ import annotations

import argparse
import logging
import os
import tempfile
import time

import torch
import torch.distributed as dist

from repro_torch.checkpoint import CheckpointManager
from repro_torch.configs.base import DEFAULT_RUN, ModelConfig, RunConfig, ShapeConfig, get_config
from repro_torch.data import make_pipeline
from repro_torch.device import resolve_device
from repro_torch.launch.mesh import init_distributed, make_host_mesh
from repro_torch.launch.steps import (
    DTYPES,
    TrainState,
    init_train_state,
    loss_and_grads,
    make_train_step,
    to_device,
)
from repro_torch.models import model as M
from repro_torch.optim.adamw import adamw_update, init_opt_state
from repro_torch.optim.schedules import warmup_cosine
from repro_torch.parallel import sharding as S
from repro_torch.parallel.api import axis_rules
from repro_torch.parallel.collectives import all_reduce, reduce_scatter
from repro_torch.runtime import FailureInjector, Supervisor
from repro_torch.tree import state_unflatten, tree_map

log = logging.getLogger("repro_torch.train")


def data_axes(mesh) -> tuple:
    """The mesh axes the batch and the FSDP split run over: all but
    "model"."""
    return tuple(a for a in mesh.axis_names if a != "model")


def has_routed_experts(cfg: ModelConfig) -> bool:
    return any("moe" in sub.ffn for lay, _ in M.group_stacks(cfg).values() for sub in lay)


class ShardedTrainStep:
    """One step of the sharded trainer, (state of this rank's shards, the
    global batch) -> (state, {"loss", "grad_norm", "lr"}):

    1. every parameter leaf gathered whole over the axes its spec names, in
       `run.param_dtype`;
    2. `steps.loss_and_grads` on this rank's rows of each microbatch of the
       global batch (the rows `batch_sharding` gives it; ranks along
       "model" take the same rows), `run.grad_accum` microbatches as the
       unsharded step cuts them;
    3. each rank's loss and gradients weighted by its share of the
       microbatch's labels, summed in fp32 over the batch's axes and
       averaged over the microbatches: the gradient of the global mean;
    4. this rank's shard of each gradient, the sum of step 3 reduce-
       scattered onto the shards where a dim splits over the batch's axes
       (`_reduce_to_shard`; all-reduced and sliced on gloo's CUDA tensors);
    5. the global norm over the unique shards: a shard replicated over an
       axis is counted on the rank at index 0 of that axis only;
    6. `adamw_update` on the shards, clipped by that norm, at the learning
       rate of the step count before the update.

    `mesh`, `specs` (a TrainState of spec tuples) and `batch_specs` say
    how the state and a microbatch are laid out."""

    def __init__(self, cfg: ModelConfig, run: RunConfig, shape: ShapeConfig, mesh,
                 total_steps: int, device):
        self.cfg, self.run, self.mesh, self.device = cfg, run, mesh, device
        self.total_steps = total_steps
        ga = run.grad_accum
        if shape.global_batch % ga:
            raise ValueError(f"global batch {shape.global_batch} does not split into "
                             f"{ga} microbatches")
        with axis_rules(mesh, fsdp=run.fsdp):
            pspec, pshapes = S.params_sharding(cfg, mesh, DTYPES[run.param_dtype])
            ospec, _ = S.opt_sharding(cfg, mesh, run, pshapes)
            micro = ShapeConfig(shape.name, shape.seq_len, shape.global_batch // ga, "train")
            self.batch_specs = S.batch_sharding(M.input_specs(cfg, micro), mesh)
        self.specs = TrainState(params=pspec, opt=ospec)
        self.batch_axes = S.spec_axes(self.batch_specs["tokens"][0])

    def _counted_here(self, spec) -> bool:
        """Whether this rank counts its shard of a leaf in the global norm:
        it sits at index 0 of every axis the leaf is replicated over."""
        split = {a for e in spec for a in S.spec_axes(e)}
        return all(self.mesh.coords[a] == 0 for a in self.mesh.axis_names if a not in split)

    def _reduce_to_shard(self, g: torch.Tensor, spec: tuple) -> torch.Tensor:
        """This rank's shard under `spec` of the sum of the whole gradient
        `g` over the batch's axes: a reduce-scatter over the axes of the
        first dim split over batch axes alone, an all-reduce over the rest
        of those axes (or over all of them when no dim is split so), then
        this rank's block of the other split dims."""
        mesh, axes, whole = self.mesh, self.batch_axes, g
        dim = next((d for d, e in enumerate(spec)
                    if S.spec_axes(e) and set(S.spec_axes(e)) <= set(axes)), None)
        if dim is None:
            out = S.shard_leaf(all_reduce(g, mesh, axes), spec, mesh)
        else:
            split = S.spec_axes(spec[dim])
            g = reduce_scatter(g, mesh, split, dim=dim)
            rest = tuple(a for a in axes if a not in split)
            if rest:
                g = all_reduce(g.contiguous(), mesh, rest)
            out = S.shard_leaf(g, spec[:dim] + (None,) + spec[dim + 1:], mesh)
        # a view would keep the whole sum alive
        return out if out is whole else out.clone(memory_format=torch.contiguous_format)

    def __call__(self, state: TrainState, batch: dict):
        mesh, run, ga = self.mesh, self.run, self.run.grad_accum
        batch = to_device(batch, self.device)
        params = S.gather_tree(state.params, self.specs.params, mesh)
        gsum = tree_map(lambda p: torch.zeros(p.shape, dtype=torch.float32,
                                              device=p.device), params)
        lsum = torch.zeros((), dtype=torch.float32, device=self.device)
        for i in range(ga):
            mb = {k: v.reshape(ga, v.shape[0] // ga, *v.shape[1:])[i] for k, v in batch.items()}
            local = {k: S.shard_leaf(v, self.batch_specs[k], mesh) for k, v in mb.items()}
            count = (local["labels"] >= 0).sum().float()
            total = all_reduce(count.clone(), mesh, self.batch_axes)
            weight = count / torch.clamp_min(total, 1.0)
            loss, grads = loss_and_grads(self.cfg, run, params, local)
            tree_map(lambda a, g: a.add_(g.float() * weight), gsum, grads)
            lsum = lsum + loss.float() * weight
        del params
        pairs = S.leaves_with_specs(gsum, self.specs.params)
        del gsum
        shards = []
        for i in range(len(pairs)):  # leaf by leaf, each whole sum freed once reduced
            g, spec = pairs[i]
            pairs[i] = None
            shards.append(self._reduce_to_shard(g, spec).div_(ga))
            del g
        grads = state_unflatten(state.params, shards)
        loss = all_reduce(lsum, mesh, self.batch_axes) / ga
        sq = torch.zeros((), dtype=torch.float32, device=self.device)
        for g, spec in S.leaves_with_specs(grads, self.specs.params):
            if self._counted_here(spec):
                sq = sq + torch.sum(torch.square(g))
        gnorm = torch.sqrt(all_reduce(sq, mesh, mesh.axis_names))
        lr = warmup_cosine(state.opt.step, peak_lr=run.learning_rate,
                           warmup_steps=run.warmup_steps, total_steps=self.total_steps)
        new_params, new_opt, gnorm = adamw_update(
            grads, state.opt, state.params, lr=lr, beta1=run.beta1, beta2=run.beta2,
            weight_decay=run.weight_decay, grad_clip=run.grad_clip, grad_norm=gnorm)
        return TrainState(params=new_params, opt=new_opt), {"loss": loss, "grad_norm": gnorm,
                                                            "lr": lr}


def build_trainer(cfg: ModelConfig, run: RunConfig, shape: ShapeConfig, mesh,
                  total_steps: int, seed: int = 0, device=None):
    """Returns (step_fn, state) for `mesh` (a `ProcessMesh`): the state
    holds this rank's shards of the parameters (`run.param_dtype`, drawn
    whole from `torch.Generator(seed)` as the unsharded trainer draws
    them) and of the AdamW moments, laid out by `opt_sharding` under the
    rules of `axis_rules(mesh, fsdp=run.fsdp)`; `step_fn` is a
    `ShardedTrainStep` taking the global batch. `device` defaults to the
    mesh's. The "model" axis splits storage only: its ranks compute the
    same rows with gathered weights (the reference's function, not its
    tensor-parallel compute split; ROADMAP queue 1 [28]). Raises for an
    arch with routed experts on a mesh whose data axes hold more than one
    rank: the capacity and the router's aux loss are statistics of the
    whole batch (ROADMAP queue 1 [29])."""
    if not mesh.member:
        raise ValueError(f"rank {mesh.rank} is not on the mesh {mesh.shape}")
    dev = mesh.device if device is None else resolve_device(device)
    dp = mesh.count(data_axes(mesh)) if data_axes(mesh) else 1
    if dp > 1 and has_routed_experts(cfg):
        raise ValueError(f"{cfg.name} routes tokens to experts over the whole batch; the "
                         f"sharded trainer runs it only on meshes with one data rank, not "
                         f"{mesh.shape} (ROADMAP queue 1 [29])")
    step_fn = ShardedTrainStep(cfg, run, shape, mesh, total_steps, dev)
    whole = M.init_params(cfg, torch.Generator().manual_seed(seed), device=dev,
                          dtype=DTYPES[run.param_dtype])
    params = S.shard_tree(whole, step_fn.specs.params, mesh)
    del whole
    return step_fn, TrainState(params=params,
                               opt=init_opt_state(params, DTYPES[run.moment_dtype]))


class GatheredCheckpoint:
    """A `CheckpointManager` for the sharded trainer: a save gathers the
    whole logical arrays (collective) and rank 0 writes them under the
    reference's npz key paths; a restore reads the whole arrays on every
    rank and keeps its shards, so a checkpoint restores under any mesh."""

    def __init__(self, manager: CheckpointManager, specs, mesh):
        self.manager, self.specs, self.mesh = manager, specs, mesh
        self.lead = mesh.rank == int(mesh.ranks.flat[0])

    def save(self, step: int, state, extra=None, block: bool = False):
        whole = S.gather_tree(state, self.specs, self.mesh)
        if self.lead:
            self.manager.save(step, whole, extra=extra, block=block)
        if block:
            self._barrier()

    def _barrier(self):
        all_reduce(torch.zeros((), device=self.mesh.device), self.mesh, self.mesh.axis_names)

    def wait(self):
        if self.lead:
            self.manager.wait()
        self._barrier()

    def latest_step(self):
        return self.manager.latest_step()

    def restore(self, like_state, step=None):
        like = S.gather_tree(like_state, self.specs, self.mesh)
        whole, meta = self.manager.restore(like, step)
        if whole is None:
            return None, None
        return S.shard_tree(whole, self.specs, self.mesh), meta

    def close(self):
        self.wait()
        self.manager.close()


def train(arch: str, *, steps: int = 100, reduced: bool = True, global_batch: int = 8,
          seq_len: int = 128, grad_accum: int = 1, ckpt_dir: str | None = None,
          checkpoint_every: int = 50, fail_at: tuple = (), resume: bool = True,
          seed: int = 0, model_axis: int = 1, device=None):
    """Train `arch` for `steps` steps on `device` (None = the card; raises
    without one). Weights from `torch.Generator(seed)`, batches from the
    seeded token pipeline, checkpoints every `checkpoint_every` steps and at
    the end into `ckpt_dir` (default: repro_torch_ckpt in the temporary
    directory), resumed from there unless `resume` is False. Returns
    (state, history).

    Under `torchrun` (WORLD_SIZE > 1) it trains over `make_host_mesh(
    model_axis)` with `build_trainer` (the default group's backend from
    `launch.mesh.backend_for`), each rank holding its shards, and
    checkpoints whole arrays from the mesh's first rank; the state returned
    is this rank's shards. In one process with model_axis 1 it runs the
    unsharded trainer."""
    cfg = get_config(arch, reduced=reduced)
    run = DEFAULT_RUN.replace(grad_accum=grad_accum, checkpoint_every=checkpoint_every,
                              remat="full")
    shape = ShapeConfig("custom_train", seq_len, global_batch, "train")
    dev = init_distributed(device)
    manager = CheckpointManager(
        ckpt_dir or os.path.join(tempfile.gettempdir(), "repro_torch_ckpt"), keep=3)
    pipeline = make_pipeline(cfg, shape.seq_len, shape.global_batch, seed=seed)
    if dist.is_initialized() or model_axis > 1:
        mesh = make_host_mesh(model_axis, device=dev)
        step_fn, state = build_trainer(cfg, run, shape, mesh, steps, seed, device=dev)
        ckpt = GatheredCheckpoint(manager, step_fn.specs, mesh)
        log.info("mesh %s on %s (%s)", mesh.shape, dev, mesh.backend or "one process")
    else:
        step_fn = make_train_step(cfg, run, steps, device=dev)
        state = init_train_state(cfg, run, torch.Generator().manual_seed(seed), device=dev)
        ckpt = manager

    start = 0
    if resume and ckpt.latest_step() is not None:
        restored, meta = ckpt.restore(state)
        if restored is not None:
            state, start = restored, int(meta["step"])
            log.info("resumed from step %d", start)

    sup = Supervisor(
        train_step=step_fn, pipeline=pipeline, ckpt=ckpt,
        checkpoint_every=checkpoint_every,
        injector=FailureInjector(fail_at=tuple(fail_at)) if fail_at else None,
    )
    t0 = time.perf_counter()
    try:
        state, history = sup.run(state, steps, start_step=start)
    finally:
        ckpt.close()
    dt = time.perf_counter() - t0
    if history:
        for h in history[:: max(1, len(history) // 10)]:
            log.info("step %4d loss %.4f grad_norm %.4f %.1f ms", h["step"], h["loss"],
                     h["grad_norm"], h["step_ms"])
        tok_s = shape.global_batch * shape.seq_len * len(history) / max(dt, 1e-9)
        log.info("done: %d steps in %.1fs (%.0f tok/s, checkpoints included), final "
                 "loss %.4f, %s", len(history), dt, tok_s, history[-1]["loss"], dev)
    return state, history


def main():
    logging.basicConfig(level=logging.INFO, format="%(message)s")
    ap = argparse.ArgumentParser(description=__doc__,
                                 formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--arch", required=True)
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--full", action="store_true", help="full (non-reduced) config")
    ap.add_argument("--global-batch", type=int, default=8)
    ap.add_argument("--seq-len", type=int, default=128)
    ap.add_argument("--grad-accum", type=int, default=1)
    ap.add_argument("--model-axis", type=int, default=1,
                    help="ranks along the mesh's model axis (the rest form the data axis)")
    ap.add_argument("--ckpt-dir", default=None,
                    help="checkpoint directory (default: repro_torch_ckpt in the "
                         "temporary directory)")
    ap.add_argument("--no-resume", action="store_true")
    ap.add_argument("--device", default=None,
                    help="torch device (default cuda; 'cpu' runs the kernels' "
                         "plain PyTorch versions)")
    args = ap.parse_args()
    train(args.arch, steps=args.steps, reduced=not args.full,
          global_batch=args.global_batch, seq_len=args.seq_len,
          grad_accum=args.grad_accum, ckpt_dir=args.ckpt_dir,
          resume=not args.no_resume, model_axis=args.model_axis, device=args.device)
    if dist.is_initialized():
        dist.destroy_process_group()


if __name__ == "__main__":
    main()
