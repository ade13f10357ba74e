"""Dynamic micro-batcher: single-image requests -> bucketed padded batches
(a copy of `repro.serving.batcher`; stdlib only).

Serving traffic arrives one image at a time; the batched kernels only pay
off when a whole batch flows through each layer as one op (the weight tile
is reused across the batch). The batcher bridges the two: requests
queue until either a full bucket of `max_batch` is waiting or the OLDEST
request has been queued for `deadline_s` — then a batch is formed at the
smallest executable bucket that fits (powers of two plus the `max_batch` cap
itself, filtered by the device-alignment rule below), and the engine pads the ragged tail
with all-zero images (which the per-sample (ids, cnt) schedules skip entirely:
a pad sample costs 0 MACs in the sparse layers).

The deadline is a hard formation budget: provided the driver polls `ready()`
no later than `next_deadline()`, no request ever waits in the queue longer
than `deadline_s` (asserted by the simulated-clock tests). The clock is injectable — `SimClock` gives serving
tests and the queueing benchmark a deterministic timeline.
"""
from __future__ import annotations

import time
from collections import deque
from dataclasses import dataclass, field


class SimClock:
    """Deterministic, manually-advanced clock (seconds). Duck-typed against
    `time.monotonic`: calling it reads the time; `advance`/`set` move it.
    The engine charges measured execution wall time into a SimClock so the
    simulated timeline carries real service times (see Engine._run_batch)."""

    def __init__(self, t0: float = 0.0):
        self.t = float(t0)

    def __call__(self) -> float:
        return self.t

    def advance(self, dt: float) -> float:
        self.t += float(dt)
        return self.t

    def set(self, t: float) -> float:
        self.t = max(self.t, float(t))  # monotonic: never move backwards
        return self.t


def bucket_sizes(max_batch: int) -> tuple:
    """Powers of two up to max_batch, plus max_batch itself when it is not a
    power of two (the requested cap is HONORED, never silently clamped —
    bucket_sizes(6) == (1, 2, 4, 6)): the bucket set every batch pads into.
    One built runner per bucket keeps the compile count logarithmic in
    max_batch instead of linear in observed batch sizes; a non-power-of-two
    cap costs exactly one extra program."""
    if max_batch < 1:
        raise ValueError(f"max_batch must be >= 1, got {max_batch}")
    sizes = [1]
    while sizes[-1] * 2 <= max_batch:
        sizes.append(sizes[-1] * 2)
    if sizes[-1] != max_batch:
        sizes.append(max_batch)
    return tuple(sizes)


@dataclass(frozen=True)
class Request:
    """One queued single-image inference request."""

    id: int
    img: object  # (C,H,W) array
    t_arrival: float


@dataclass(frozen=True)
class MicroBatch:
    """A formed batch: `requests` are the real samples; `bucket` is the padded
    batch size the engine executes at (bucket - len(requests) pad samples)."""

    requests: tuple
    bucket: int
    t_formed: float

    @property
    def n_real(self) -> int:
        return len(self.requests)

    @property
    def fill(self) -> float:
        return len(self.requests) / self.bucket


@dataclass
class MicroBatcher:
    """`min_bucket` floors the PER-DEVICE executed batch size (default 2),
    as in the reference, where an M=1 GEMV sums the classifier reduction in
    another order than the M>=2 GEMM: padding lone requests up to a 2-bucket
    keeps every request's logits bit-identical to the whole-batch `run_plan`
    regardless of how the stream was chopped into batches, and the pad
    sample is skipped by the sparse layers' per-sample schedules.

    `align` is the sharded-serving knob of the reference: with a data-parallel
    mesh of N devices the engine sets align=N, and every EXECUTED bucket is a
    multiple of align whose per-device slice is >= min_bucket — each shard
    gets an equal, >=2-sample slice (the bit-exactness floor applies on every
    device), and the extra pad samples stay free under the per-sample
    schedules. align=1 (the default) is exactly the unsharded behavior."""

    max_batch: int = 8
    deadline_s: float = 0.010
    clock: object = time.monotonic
    min_bucket: int = 2
    align: int = 1
    _q: deque = field(default_factory=deque, init=False, repr=False)
    _next_id: int = field(default=0, init=False, repr=False)

    def __post_init__(self):
        if self.align < 1:
            raise ValueError(f"align must be >= 1, got {self.align}")
        if self.max_batch % self.align:
            raise ValueError(
                f"max_batch={self.max_batch} must be a multiple of "
                f"align={self.align} (one equal slice per device)")
        self.buckets = bucket_sizes(self.max_batch)
        if self.align > 1 and self.max_batch // self.align < self.min_bucket:
            # silently clamping here would hand every shard an M=1 slice —
            # exactly the GEMV reduction-order case min_bucket exists to
            # prevent — and quietly void the bit-exactness contract
            raise ValueError(
                f"max_batch={self.max_batch} over align={self.align} devices "
                f"gives each shard {self.max_batch // self.align} sample(s), "
                f"below the min_bucket={self.min_bucket} bit-exactness floor; "
                "pass min_bucket=1 to accept M=1 shards or use fewer devices")
        # unsharded legacy clamp: max_batch=1 callers explicitly want singletons
        self.min_bucket = min(self.min_bucket, max(1, self.max_batch // self.align))

    def submit(self, img, now: float | None = None) -> int:
        """Queue one image; returns its request id (submission order)."""
        rid = self._next_id
        self._next_id += 1
        self._q.append(Request(id=rid, img=img, t_arrival=self.clock() if now is None else now))
        return rid

    def pending(self) -> int:
        return len(self._q)

    def next_deadline(self) -> float | None:
        """Absolute time by which `ready()` must next be polled (oldest
        arrival + deadline), or None when the queue is empty."""
        if not self._q:
            return None
        return self._q[0].t_arrival + self.deadline_s

    def exec_buckets(self) -> tuple:
        """The bucket sizes batches actually execute at — multiples of
        `align` whose per-device slice is >= min_bucket — the set the engine
        pre-compiles on warmup. Non-empty by construction (max_batch always
        qualifies)."""
        return tuple(b for b in self.buckets
                     if b % self.align == 0 and b // self.align >= self.min_bucket)

    def bucket_for(self, n: int) -> int:
        """Smallest executable bucket >= n (n is capped at max_batch by the
        callers)."""
        for b in self.exec_buckets():
            if b >= n:
                return b
        return self.max_batch

    def ready(self, now: float | None = None) -> MicroBatch | None:
        """Form a batch if one is due: a full max_batch bucket dispatches
        immediately; otherwise the oldest request's deadline forces a ragged
        flush. Returns None when nothing is due yet."""
        if not self._q:
            return None
        now = self.clock() if now is None else now
        if len(self._q) >= self.max_batch:
            return self._form(self.max_batch, now)
        if now >= self._q[0].t_arrival + self.deadline_s:
            return self._form(len(self._q), now)
        return None

    def flush(self, now: float | None = None) -> MicroBatch | None:
        """Unconditionally form a batch from up to max_batch queued requests
        (drain path: end of stream, shutdown)."""
        if not self._q:
            return None
        now = self.clock() if now is None else now
        return self._form(min(len(self._q), self.max_batch), now)

    def _form(self, n: int, now: float) -> MicroBatch:
        reqs = tuple(self._q.popleft() for _ in range(n))
        return MicroBatch(requests=reqs, bucket=self.bucket_for(n), t_formed=now)
