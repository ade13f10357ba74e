"""Training launcher on the port: supervised loop over the train step with
async checkpoints and restart (counterpart of `repro.launch.train`, the
dense and MoE LMs; no mesh, so no `--model-axis`).

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
"""
from __future__ import annotations

import argparse
import logging
import os
import tempfile
import time

import torch

from repro_torch.checkpoint import CheckpointManager
from repro_torch.configs.base import DEFAULT_RUN, ShapeConfig, get_config
from repro_torch.data import make_pipeline
from repro_torch.device import resolve_device
from repro_torch.launch.steps import init_train_state, make_train_step
from repro_torch.runtime import FailureInjector, Supervisor

log = logging.getLogger("repro_torch.train")


def train(arch: str, *, steps: int = 100, reduced: bool = True, global_batch: int = 8,
          seq_len: int = 128, grad_accum: int = 1, ckpt_dir: str | None = None,
          checkpoint_every: int = 50, fail_at: tuple = (), resume: bool = True,
          seed: int = 0, device=None):
    """Train `arch` for `steps` steps on `device` (None = the card; raises
    without one). Weights from `torch.Generator(seed)`, batches from the
    seeded token pipeline, checkpoints every `checkpoint_every` steps and at
    the end into `ckpt_dir` (default: repro_torch_ckpt in the temporary
    directory), resumed from there unless `resume` is False. Returns
    (state, history)."""
    dev = resolve_device(device)
    cfg = get_config(arch, reduced=reduced)
    run = DEFAULT_RUN.replace(grad_accum=grad_accum, checkpoint_every=checkpoint_every,
                              remat="full")
    shape = ShapeConfig("custom_train", seq_len, global_batch, "train")
    step_fn = make_train_step(cfg, run, steps, device=dev)
    state = init_train_state(cfg, run, torch.Generator().manual_seed(seed), device=dev)
    pipeline = make_pipeline(cfg, shape.seq_len, shape.global_batch, seed=seed)
    ckpt = CheckpointManager(
        ckpt_dir or os.path.join(tempfile.gettempdir(), "repro_torch_ckpt"), keep=3)

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
          resume=not args.no_resume, device=args.device)


if __name__ == "__main__":
    main()
