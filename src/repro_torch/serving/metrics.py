"""Serving telemetry: the `MetricsTracker` the `Engine` feeds per event
(a copy of `repro.serving.metrics`; stdlib only).

The re-planner and the plan cache exist for *shifting* traffic (the paper's
Fig. 3 diurnal-sparsity story), but counters alone cannot show whether a
re-plan fired at the right time or a cache key churned — that takes time
series. The tracker turns the engine's event stream into a deterministic,
JSON-serializable `snapshot()`:

- request/batch counters and per-bucket execute counts (which bucket shapes
  the traffic actually exercised — the fill story behind `mean_fill`);
- a bounded latency reservoir (Vitter's algorithm R on a seeded PRNG, so two
  identical replays sample identically) reporting p50/p95/p99/mean/max —
  fed per COMPLETED request, whether it completed through `poll()` or the
  `drain()`/flush tail, so `Engine.stats()` percentiles cover every request;
- the per-layer occupancy-EMA timeline (one row per executed batch) — the
  drift signal the re-planner consumes, recorded so a run's telemetry can
  show occupancy moving and the re-plan answering;
- re-plan events (trigger with its out-of-band delta, swap with whether the
  schedule actually changed, error, hot-swap), timestamped on the engine's
  clock.

Determinism contract: on a `SimClock` with a fixed service-time model
(`Engine(sim_service_s=...)`), two identical replays produce bit-identical
snapshots, which is what makes two runs' telemetry comparable.

All timestamps are whatever the engine's clock reads (simulated seconds for
SimClock replays, `time.monotonic` live). Timelines and event logs are
bounded deques: a long-lived engine keeps the most recent `timeline_max`
entries instead of growing without bound.
"""
from __future__ import annotations

import random
from collections import deque


def _percentile(sorted_vals, q: float) -> float:
    """Linear-interpolated percentile of an ascending list (numpy's default
    method, without materializing an array per snapshot). q in [0, 100]."""
    n = len(sorted_vals)
    if n == 0:
        return 0.0
    if n == 1:
        return float(sorted_vals[0])
    pos = (q / 100.0) * (n - 1)
    lo = int(pos)
    hi = min(lo + 1, n - 1)
    frac = pos - lo
    return float(sorted_vals[lo] * (1.0 - frac) + sorted_vals[hi] * frac)


class LatencyReservoir:
    """Bounded uniform sample of request latencies (algorithm R).

    Exact while `count <= size` (every latency is in the sample — the test
    and CI-benchmark regime), an unbiased uniform subsample beyond. The PRNG
    is seeded so identical event streams produce identical reservoirs —
    the determinism contract of `MetricsTracker.snapshot()`.
    """

    def __init__(self, size: int = 4096, seed: int = 0):
        if size < 1:
            raise ValueError(f"reservoir size must be >= 1, got {size}")
        self.size = size
        self._rng = random.Random(seed)
        self.values: list = []
        self.count = 0
        self.total = 0.0
        self.max = 0.0

    def add(self, v: float) -> None:
        v = float(v)
        self.count += 1
        self.total += v
        if v > self.max:
            self.max = v
        if len(self.values) < self.size:
            self.values.append(v)
        else:
            j = self._rng.randrange(self.count)
            if j < self.size:
                self.values[j] = v

    def percentiles_ms(self) -> dict:
        """{"count", "mean_ms", "max_ms", "p50_ms", "p95_ms", "p99_ms"} over
        the reservoir (values stored in seconds, reported in ms)."""
        s = sorted(self.values)
        return {
            "count": self.count,
            "mean_ms": (self.total / self.count * 1e3) if self.count else 0.0,
            "max_ms": self.max * 1e3,
            "p50_ms": _percentile(s, 50) * 1e3,
            "p95_ms": _percentile(s, 95) * 1e3,
            "p99_ms": _percentile(s, 99) * 1e3,
        }


class MetricsTracker:
    """Event sink for one serving engine (or one shared stream of engines).

    The engine calls the `on_*` hooks; `snapshot()` renders the current state
    as a plain dict of JSON-serializable values (no numpy scalars, no
    tuples-vs-lists ambiguity) that `Engine.stats()` absorbs under
    ``"telemetry"``.
    """

    def __init__(self, reservoir_size: int = 4096, timeline_max: int = 4096,
                 seed: int = 0):
        self.latency = LatencyReservoir(reservoir_size, seed=seed)
        self.submitted = 0
        self.completed = 0
        self.batches = 0
        self.pad_samples = 0
        self._fill_sum = 0.0
        self.service_s_total = 0.0
        self.bucket_counts: dict = {}
        self.occ_timeline: deque = deque(maxlen=timeline_max)
        self.replan_events: deque = deque(maxlen=timeline_max)
        self.replan_triggers = 0
        self.replan_swaps = 0
        self.replan_errors = 0
        self.hot_swaps = 0
        self.verify_rejects = 0

    # -- engine hooks ------------------------------------------------------

    def on_submit(self, t: float) -> None:
        self.submitted += 1

    def on_batch(self, t: float, bucket: int, n_real: int,
                 service_s: float) -> None:
        """One executed bucket: `service_s` is the time CHARGED to the
        timeline (measured wall, or the engine's fixed `sim_service_s`
        model — the deterministic replays record the model, never the
        noisy wall)."""
        self.batches += 1
        self.pad_samples += bucket - n_real
        self._fill_sum += n_real / bucket
        self.service_s_total += float(service_s)
        self.bucket_counts[bucket] = self.bucket_counts.get(bucket, 0) + 1

    def on_result(self, latency_s: float) -> None:
        """One COMPLETED request — poll()-completed and drain()/flush-tail
        alike, so the percentiles never silently exclude the stragglers the
        deadline machinery exists to bound."""
        self.completed += 1
        self.latency.add(latency_s)

    def on_occupancy(self, t: float, ema) -> None:
        self.occ_timeline.append((float(t), [float(v) for v in ema]))

    def on_replan_trigger(self, t: float, delta: float) -> None:
        self.replan_triggers += 1
        self.replan_events.append(
            {"t": float(t), "kind": "trigger", "delta": float(delta)})

    def on_replan_swap(self, t: float, changed: bool) -> None:
        self.replan_swaps += 1
        self.replan_events.append(
            {"t": float(t), "kind": "swap", "changed": bool(changed)})

    def on_replan_error(self, t: float) -> None:
        self.replan_errors += 1
        self.replan_events.append({"t": float(t), "kind": "error"})

    def on_hot_swap(self, t: float) -> None:
        self.hot_swaps += 1
        self.replan_events.append({"t": float(t), "kind": "hot_swap"})

    def on_verify_reject(self, t: float, codes=()) -> None:
        """A candidate plan the static verifier refused (hot swap or re-plan
        adoption): `codes` are the error diagnostic codes that fired."""
        self.verify_rejects += 1
        self.replan_events.append({"t": float(t), "kind": "verify_reject",
                                   "codes": [str(c) for c in codes]})

    # -- rendering ---------------------------------------------------------

    def mean_fill(self) -> float:
        return self._fill_sum / self.batches if self.batches else 0.0

    def snapshot(self) -> dict:
        """The current telemetry as a deterministic, JSON-ready dict."""
        return {
            "submitted": self.submitted,
            "completed": self.completed,
            "batches": self.batches,
            "pad_samples": self.pad_samples,
            "mean_fill": self.mean_fill(),
            "service_s_total": self.service_s_total,
            "bucket_counts": {str(b): self.bucket_counts[b]
                              for b in sorted(self.bucket_counts)},
            "latency": self.latency.percentiles_ms(),
            "occ_timeline": [[t, list(e)] for t, e in self.occ_timeline],
            "replan_events": list(self.replan_events),
            "replans": {"triggers": self.replan_triggers,
                        "swaps": self.replan_swaps,
                        "errors": self.replan_errors,
                        "hot_swaps": self.hot_swaps,
                        "verify_rejects": self.verify_rejects},
        }
