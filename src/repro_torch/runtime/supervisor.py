"""Training supervisor: checkpoint/restart fault tolerance + straggler watch
(counterpart of `repro.runtime.supervisor`).

The supervisor owns the outer loop:

  while steps remain:
      batch  = pipeline.batch_at(step)          # stateless -> replay-exact
      state  = train_step(state, batch)         # may raise (node failure)
      monitor.observe(step_time)                # straggler detection
      every N steps: ckpt.save(step, state)     # async + atomic

On an injected `SimulatedFailure` it restores the latest complete checkpoint
and continues from the restored step. The step time is the host wall from
the batch's hand-off to the loss on the host, which waits for the device.
"""
from __future__ import annotations

import logging
import time
from dataclasses import dataclass, field
from typing import Callable, Optional

from repro_torch.checkpoint import CheckpointManager
from repro_torch.runtime.straggler import StragglerMonitor

log = logging.getLogger("repro_torch.supervisor")


class SimulatedFailure(RuntimeError):
    pass


@dataclass
class FailureInjector:
    """Deterministic failure schedule: raise at the given global steps."""

    fail_at: tuple = ()
    _fired: set = field(default_factory=set)

    def maybe_fail(self, step: int):
        if step in self.fail_at and step not in self._fired:
            self._fired.add(step)
            raise SimulatedFailure(f"injected node failure at step {step}")


@dataclass
class Supervisor:
    train_step: Callable  # (state, batch of numpy arrays) -> (state, metrics)
    pipeline: object  # batch_at(step) -> dict
    ckpt: CheckpointManager
    checkpoint_every: int = 50
    max_restarts: int = 10
    injector: Optional[FailureInjector] = None
    monitor: StragglerMonitor = field(default_factory=StragglerMonitor)
    on_restart: Optional[Callable[[int], None]] = None

    def run(self, state, total_steps: int, start_step: int = 0):
        """Returns (final_state, history): one {"step", "step_ms", and each
        metric as a float} per step run. Restarts transparently on failure."""
        step = start_step
        restarts = 0
        history = []
        while step < total_steps:
            try:
                batch = self.pipeline.batch_at(step)
                if self.injector:
                    self.injector.maybe_fail(step)
                t0 = time.perf_counter()
                state, metrics = self.train_step(state, batch)
                metrics = {k: float(v) for k, v in metrics.items()}  # waits for the device
                dt = time.perf_counter() - t0
                self.monitor.observe(step, dt)
                history.append({"step": step, "step_ms": dt * 1e3, **metrics})
                step += 1
                if step % self.checkpoint_every == 0:
                    self.ckpt.save(step, state, extra={"step": step})
            except SimulatedFailure as e:
                restarts += 1
                if restarts > self.max_restarts:
                    raise
                log.warning("failure: %s — restoring latest checkpoint", e)
                self.ckpt.wait()
                restored, meta = self.ckpt.restore(state)
                if restored is None:  # no checkpoint yet: restart from scratch
                    step = start_step
                else:
                    state = restored
                    step = int(meta["step"])
                if self.on_restart:
                    self.on_restart(step)
        self.ckpt.save(total_steps, state, extra={"step": total_steps}, block=True)
        return state, history
