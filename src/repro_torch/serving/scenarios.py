"""Replay driver for request streams on a `SimClock` (counterpart of the
`ListScenario` / `replay_scenario` part of `repro.serving.scenarios`).

A scenario is a deterministic list of (arrival time, image) requests plus
timed events; `replay_scenario` merges arrivals, events and every engine's
batcher deadline into one event loop on a shared `SimClock`. The seeded
traffic regimes of the reference (burst, diurnal drift, multi-tenant, hot
swap) are a later slice.
"""
from __future__ import annotations

from dataclasses import dataclass

from repro_torch.serving.batcher import SimClock


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
