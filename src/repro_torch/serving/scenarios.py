"""Scenario library and replay driver: seeded traffic regimes for the
engine on a `SimClock` (counterpart of `repro.serving.scenarios`).

A scenario is a deterministic list of (arrival time, image) requests plus
timed events. The regimes:

- `PoissonBurstScenario` — Poisson arrivals whose rate switches between a
  base and a burst level on a fixed cycle (several full buckets queue at
  once);
- `DiurnalDriftScenario` — steady arrivals whose dead-channel band moves
  over simulated time (a step or a sine), which must push the occupancy EMA
  out of the hysteresis band and re-plan;
- `MultiTenantScenario` — interleaved streams for several models sharing
  one `PlanCache`;
- `HotSwapScenario` — a steady stream with a timed event that swaps the
  engine to another model (`Engine.hot_swap`) under load;
- `ListScenario` — explicit (arrival, image) lists, the steady stream
  `replay_stream` wraps.

Arrival times come from `random.Random(seed)` and plain arithmetic, so they
equal the reference's exactly. The images come from `synth_image`, a
`torch.Generator` per request: the same function of its arguments as the
reference's, but not the same bits (`jax.random` is not reproduced).

`replay_scenario` merges arrivals, events and every engine's batcher
deadline into one event loop on a shared `SimClock`.
"""
from __future__ import annotations

import math
import random
from dataclasses import dataclass, field

import torch

from repro_torch.core.sparsity import dead_channel_band
from repro_torch.serving.batcher import SimClock


def synth_image(in_shape, seed: int, i: int, dead_frac: float = 0.5) -> torch.Tensor:
    """The i-th request image of a seeded stream: uniform [0, 1) (C,H,W) on
    the host from `torch.Generator().manual_seed(seed * 1000003 + i)`, with
    the trailing `dead_frac` channel band zeroed. A pure function of its
    arguments; the engine moves it to its device on submit."""
    gen = torch.Generator().manual_seed(seed * 1000003 + i)
    return dead_channel_band(torch.rand(tuple(in_shape), generator=gen), dead_frac)


@dataclass(frozen=True)
class ScenarioRequest:
    """One scheduled request: arrival time, image, and the stream it targets
    ("" = the scenario's only stream)."""

    t: float
    img: object
    stream: str = ""


class Scenario:
    """Protocol every scenario implements: ``name``, ``requests()`` (ordered
    by arrival, a pure function of the constructor arguments) and ``events``
    (((t, fn), ...) run once between batches when the clock reaches t)."""

    name: str = "scenario"
    events: tuple = ()

    def requests(self) -> list:
        raise NotImplementedError

    def streams(self) -> tuple:
        """The distinct stream keys, in first-appearance order."""
        seen: dict = {}
        for r in self.requests():
            seen.setdefault(r.stream, None)
        return tuple(seen)


@dataclass(frozen=True)
class ListScenario(Scenario):
    """Explicit (arrival, image) lists — the steady stream `replay_stream`
    wraps."""

    imgs: tuple = ()
    arrivals: tuple = ()
    name: str = "list"
    stream: str = ""

    def __post_init__(self):
        if len(self.imgs) != len(self.arrivals):
            raise ValueError(
                f"ListScenario needs one arrival per image, got "
                f"{len(self.imgs)} images / {len(self.arrivals)} arrivals")

    def requests(self) -> list:
        return [ScenarioRequest(t=float(t), img=img, stream=self.stream)
                for t, img in sorted(zip(self.arrivals, self.imgs),
                                     key=lambda p: p[0])]


@dataclass(frozen=True)
class PoissonBurstScenario(Scenario):
    """Markov-modulated Poisson arrivals: exponential interarrivals at
    `base_rps`, switching to `burst_rps` for the first `burst_len_s` of every
    `burst_every_s` cycle. A burst queues several full max_batch buckets at
    once, so it pins the no-stranding property: every request is formed
    within its deadline plus the backlog of earlier due buckets."""

    in_shape: tuple = (16, 12, 12)
    n_requests: int = 32
    base_rps: float = 50.0
    burst_rps: float = 800.0
    burst_every_s: float = 0.25
    burst_len_s: float = 0.05
    dead_frac: float = 0.5
    seed: int = 0
    name: str = "burst"

    def rate_at(self, t: float) -> float:
        return self.burst_rps if (t % self.burst_every_s) < self.burst_len_s \
            else self.base_rps

    def requests(self) -> list:
        rng = random.Random(self.seed)
        t, out = 0.0, []
        for i in range(self.n_requests):
            t += rng.expovariate(self.rate_at(t))
            out.append(ScenarioRequest(
                t=t, img=synth_image(self.in_shape, self.seed, i, self.dead_frac)))
        return out


@dataclass(frozen=True)
class DiurnalDriftScenario(Scenario):
    """Steady arrivals whose occupancy drifts: the dead-channel band moves
    from `dead_lo` to `dead_hi` over simulated time. ``drift="step"`` flips
    at `t_drift`; ``drift="sine"`` widens and narrows the band smoothly over
    `period_s`. An engine planned at the `dead_lo` regime must re-plan to
    the schedule `plan_network` picks at the drifted occupancy."""

    in_shape: tuple = (16, 12, 12)
    n_requests: int = 32
    rate_rps: float = 200.0
    dead_lo: float = 0.0
    dead_hi: float = 0.5
    drift: str = "step"  # "step" | "sine"
    t_drift: float = 0.05  # step: time of the flip
    period_s: float = 0.2  # sine: one widen+narrow cycle
    seed: int = 0
    name: str = "diurnal"

    def dead_frac_at(self, t: float) -> float:
        if self.drift == "step":
            return self.dead_hi if t >= self.t_drift else self.dead_lo
        if self.drift == "sine":
            phase = 0.5 - 0.5 * math.cos(2.0 * math.pi * t / self.period_s)
            return self.dead_lo + (self.dead_hi - self.dead_lo) * phase
        raise ValueError(f"unknown drift mode {self.drift!r} "
                         "(choose 'step' or 'sine')")

    def requests(self) -> list:
        out = []
        for i in range(self.n_requests):
            t = i / self.rate_rps
            out.append(ScenarioRequest(
                t=t, img=synth_image(self.in_shape, self.seed, i,
                                     self.dead_frac_at(t))))
        return out


@dataclass(frozen=True)
class TenantSpec:
    """One tenant stream of a multi-tenant scenario."""

    in_shape: tuple
    n_requests: int = 16
    rate_rps: float = 100.0
    dead_frac: float = 0.5


@dataclass(frozen=True)
class MultiTenantScenario(Scenario):
    """Interleaved per-tenant steady streams merged by arrival time. The
    tenants' engines share one `PlanCache` (`Engine(cache=...)`): the graph
    signature in `PlanKey` bounds the builds by the distinct keys, and no
    tenant ever runs another tenant's runner."""

    tenants: tuple = ()  # ((name, TenantSpec), ...)
    seed: int = 0
    name: str = "multi_tenant"

    def requests(self) -> list:
        out = []
        for k, (stream, spec) in enumerate(self.tenants):
            for i in range(spec.n_requests):
                out.append(ScenarioRequest(
                    t=i / spec.rate_rps,
                    img=synth_image(spec.in_shape, self.seed + 7919 * (k + 1),
                                    i, spec.dead_frac),
                    stream=stream))
        # stable sort: simultaneous arrivals keep tenant declaration order
        return sorted(out, key=lambda r: r.t)

    def streams(self) -> tuple:
        return tuple(stream for stream, _ in self.tenants)


@dataclass(frozen=True)
class HotSwapScenario(Scenario):
    """A steady stream that swaps the served model mid-flight: at `t_swap`
    the driver calls `swap_fn(engines)`, canonically
    ``engines[""].hot_swap(pruned_params)``. The swap is atomic between
    batches: requests completed before it carry the old model's logits,
    requests after it the new model's, and no bucket mixes the two."""

    in_shape: tuple = (16, 12, 12)
    n_requests: int = 32
    rate_rps: float = 200.0
    t_swap: float = 0.05
    swap_fn: object = None  # callable(engines: dict) -> None
    dead_frac: float = 0.5
    seed: int = 0
    name: str = "hot_swap"
    events: tuple = field(init=False, default=())

    def __post_init__(self):
        if self.swap_fn is None:
            raise ValueError("HotSwapScenario needs swap_fn= (the timed "
                             "model-swap action, e.g. a hot_swap closure)")
        object.__setattr__(self, "events", ((float(self.t_swap), self.swap_fn),))

    def requests(self) -> list:
        return [ScenarioRequest(
            t=i / self.rate_rps,
            img=synth_image(self.in_shape, self.seed, i, self.dead_frac))
            for i in range(self.n_requests)]


def replay_scenario(engines, scenario) -> dict:
    """Drive one scenario's event loop to completion on a shared `SimClock`.

    `engines` is one `Engine` or a ``{stream: Engine}`` mapping; all engines
    share ONE SimClock. Each turn enqueues every arrival at or before the
    current time, fires due events, polls every engine until nothing is due
    (an executed batch may move the clock past further deadlines), then
    jumps the clock to the earliest next arrival, event or batcher deadline.
    Returns ``{stream: [ServedResult, ...]}`` in completion order."""
    from repro_torch.serving.engine import Engine

    if isinstance(engines, Engine):
        engines = {"": engines}
    clocks = {id(e.clock): e.clock for e in engines.values()}
    if len(clocks) != 1 or not isinstance(next(iter(clocks.values())), SimClock):
        raise ValueError("replay_scenario needs every engine on ONE shared "
                         "SimClock")
    clock = next(iter(clocks.values()))
    reqs = sorted(scenario.requests(), key=lambda r: r.t)
    missing = {r.stream for r in reqs} - set(engines)
    if missing:
        raise ValueError(f"scenario emits streams {sorted(missing)} with no "
                         f"engine (have {sorted(engines)})")
    events = sorted(((float(t), fn) for t, fn in scenario.events),
                    key=lambda e: e[0])
    results: dict = {k: [] for k in engines}
    served = 0
    i = 0

    def submit_due():
        nonlocal i
        while i < len(reqs) and reqs[i].t <= clock():
            engines[reqs[i].stream].submit(reqs[i].img, now=reqs[i].t)
            i += 1

    def fire_due_events():
        while events and events[0][0] <= clock():
            _, fn = events.pop(0)
            fn(engines)

    while served < len(reqs):
        submit_due()
        fire_due_events()
        progressed = True
        while progressed:
            progressed = False
            for stream, eng in engines.items():
                out = eng.poll()
                if out:
                    results[stream].extend(out)
                    served += len(out)
                    progressed = True
                    submit_due()
                    fire_due_events()
        if served >= len(reqs):
            break
        cands = [eng.next_deadline() for eng in engines.values()]
        if i < len(reqs):
            cands.append(reqs[i].t)
        if events:
            cands.append(events[0][0])
        cands = [c for c in cands if c is not None]
        if not cands:  # nothing queued, nothing scheduled: requests were lost
            break
        clock.set(min(cands))
    fire_due_events()
    return results
