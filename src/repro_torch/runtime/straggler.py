"""Straggler detection: per-step wall-time EMA + z-score outlier flagging
(a copy of `repro.runtime.straggler`, which imports no JAX).

At pod scale the common failure shape is not a crash but a slow chip/host
(thermal throttle, flaky ICI link, noisy neighbor on the host NIC). The
monitor keeps an EMA/EMVar of step time; a step slower than
`mean + z_thresh * std` is flagged, and `on_straggler` fires with the stats so
the launcher can mark the slot for replacement (here: logged + counted).
"""
from __future__ import annotations

import time
from dataclasses import dataclass, field
from typing import Callable, Optional


@dataclass
class StragglerMonitor:
    z_thresh: float = 3.0
    min_rel: float = 0.25  # never flag steps < (1+min_rel) x mean (var floor)
    decay: float = 0.95
    warmup_steps: int = 5
    on_straggler: Optional[Callable[[int, float, float], None]] = None

    _mean: float = 0.0
    _var: float = 0.0
    _n: int = 0
    flagged: list = field(default_factory=list)

    def observe(self, step: int, dt: float) -> bool:
        """Returns True if `dt` is a straggler step."""
        self._n += 1
        if self._n <= self.warmup_steps:
            # seed statistics
            d = dt - self._mean
            self._mean += d / self._n
            self._var += d * (dt - self._mean)
            return False
        std = max((self._var / max(self._n - 1, 1)) ** 0.5, 1e-9)
        is_slow = dt > max(self._mean + self.z_thresh * std,
                           self._mean * (1 + self.min_rel))
        if is_slow:
            self.flagged.append((step, dt, self._mean))
            if self.on_straggler:
                self.on_straggler(step, dt, self._mean)
        else:
            # only fold non-outliers into the EMA (outliers would mask repeats)
            self._mean = self.decay * self._mean + (1 - self.decay) * dt
            self._var = self.decay * self._var + (1 - self.decay) * (dt - self._mean) ** 2
        return is_slow

    def timed(self, step: int):
        return _StepTimer(self, step)


class _StepTimer:
    def __init__(self, mon: StragglerMonitor, step: int):
        self.mon, self.step = mon, step

    def __enter__(self):
        self.t0 = time.perf_counter()
        return self

    def __exit__(self, *exc):
        self.mon.observe(self.step, time.perf_counter() - self.t0)
        return False
