"""Span tracer: nested spans -> Chrome trace_event JSON, loadable in
Perfetto (counterpart of `repro.obs.trace`).

The serving stack is a pipeline of phases (plan, compile, per-batch
execute, per-layer kernel in the profiling and tile-search harnesses), and
"where did the time go" needs those phases as nested intervals on a
timeline. A `Tracer` records complete-duration spans (`ph: "X"`), instants
(`"i"`) and counters (`"C"`) against an injectable clock and renders them in
the Chrome trace_event format.

Determinism: the clock is any zero-arg callable returning seconds
(`time.perf_counter` live, a `serving.batcher.SimClock` in replays). Thread
ids are logical (0 for the first thread to open a span, 1 for the next, ...)
and events are appended in span-exit order, so two identical SimClock
replays give the same `chrome_trace()` payload. The event schema is the
reference's, key for key, so the same call sequence on the same clock gives
the same JSON from either package.

Disabled tracing costs nothing on the serving path: `NULL_TRACER` (the
engine's default) hands back one shared no-op context manager and records
nothing.
"""
from __future__ import annotations

import json
import threading
import time


class _NullSpan:
    """The shared no-op context manager `NullTracer.span` returns."""

    __slots__ = ()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False


_NULL_SPAN = _NullSpan()


class NullTracer:
    """Stand-in when tracing is disabled: every `span()` call returns the
    same no-op object and no event is recorded."""

    __slots__ = ()
    enabled = False
    events: tuple = ()

    def span(self, name, cat="repro", **args):
        return _NULL_SPAN

    def instant(self, name, cat="repro", **args):
        return None

    def chrome_trace(self) -> dict:
        return {"traceEvents": [], "displayTimeUnit": "ms"}

    def save(self, path: str) -> str:
        raise ValueError("NullTracer records nothing: construct a Tracer to export a trace")


NULL_TRACER = NullTracer()


class _SpanCtx:
    """One open span: records start on __enter__, emits the complete event
    (ph "X") on __exit__. Exceptions propagate; the event still closes, with
    an "error" arg naming the exception type (a crashed batch must stay
    visible on the timeline)."""

    __slots__ = ("tracer", "name", "cat", "args", "t0", "depth")

    def __init__(self, tracer, name, cat, args):
        self.tracer = tracer
        self.name = name
        self.cat = cat
        self.args = args

    def __enter__(self):
        self.t0, self.depth = self.tracer._push()
        return self

    def annotate(self, **kw) -> None:
        """Attach args discovered mid-span (e.g. the measured batch fill)."""
        self.args.update(kw)

    def __exit__(self, exc_type, exc, tb):
        if exc_type is not None:
            self.args["error"] = exc_type.__name__
        self.tracer._pop(self)
        return False


class Tracer:
    """Span recorder over an injectable clock (see module docstring).

    `span(name, **args)` is a context manager; spans nest per thread (the
    depth rides into the event args so nesting survives flat JSON). `instant`
    marks point events (re-plan triggers, hot swaps). `chrome_trace()` /
    `save(path)` render the Chrome trace_event JSON.
    """

    def __init__(self, clock=time.perf_counter, pid: int = 0):
        self.clock = clock
        self.pid = pid
        self.enabled = True
        self.events: list = []  # chrome trace_event dicts, span-exit order
        self._lock = threading.Lock()
        self._tids: dict = {}  # OS ident -> logical tid (first-span order)
        self._stacks: dict = {}  # logical tid -> open-span depth counter
        self._t0 = float(clock())  # trace epoch: ts are relative (us)

    # -- span plumbing ------------------------------------------------------

    def _tid(self) -> int:
        ident = threading.get_ident()
        with self._lock:
            if ident not in self._tids:
                self._tids[ident] = len(self._tids)
            return self._tids[ident]

    def _us(self, t: float) -> float:
        return (t - self._t0) * 1e6

    def _push(self):
        tid = self._tid()
        with self._lock:
            depth = self._stacks.get(tid, 0)
            self._stacks[tid] = depth + 1
        return float(self.clock()), depth

    def _pop(self, ctx: _SpanCtx) -> None:
        t1 = float(self.clock())
        tid = self._tid()
        args = {"depth": ctx.depth, **ctx.args}
        with self._lock:
            self._stacks[tid] = max(self._stacks.get(tid, 1) - 1, 0)
            self.events.append({
                "name": ctx.name, "cat": ctx.cat, "ph": "X",
                "ts": self._us(ctx.t0), "dur": self._us(t1) - self._us(ctx.t0),
                "pid": self.pid, "tid": tid, "args": args,
            })

    # -- public API ---------------------------------------------------------

    def span(self, name: str, cat: str = "repro", **args) -> _SpanCtx:
        return _SpanCtx(self, name, cat, dict(args))

    def instant(self, name: str, cat: str = "repro", **args) -> None:
        tid = self._tid()  # before the lock: _tid takes it too (non-reentrant)
        with self._lock:
            self.events.append({
                "name": name, "cat": cat, "ph": "i", "s": "t",
                "ts": self._us(float(self.clock())),
                "pid": self.pid, "tid": tid, "args": dict(args),
            })

    def counter(self, name: str, value: float, cat: str = "repro") -> None:
        """A `ph: "C"` counter sample (Perfetto renders it as a track)."""
        tid = self._tid()
        with self._lock:
            self.events.append({
                "name": name, "cat": cat, "ph": "C",
                "ts": self._us(float(self.clock())),
                "pid": self.pid, "tid": tid,
                "args": {name: float(value)},
            })

    def chrome_trace(self) -> dict:
        """The Chrome trace_event payload (JSON Object Format)."""
        with self._lock:
            return {"traceEvents": [dict(e) for e in self.events],
                    "displayTimeUnit": "ms"}

    def save(self, path: str) -> str:
        """Write the trace JSON (loadable in Perfetto); returns the path."""
        with open(path, "w") as f:
            json.dump(self.chrome_trace(), f, indent=1, sort_keys=True)
            f.write("\n")
        return path
