"""Property-based MicroBatcher invariants of the port, held against the JAX
package's batcher, mirroring tests/test_batcher_props.py (through
tests/_hypothesis_compat.py: real hypothesis when installed, the seeded
stand-in otherwise).

Each property draws a seed and derives a batcher config plus an arbitrary
interleaving of submit / clock-advance / ready / flush operations from one
`random.Random(seed)`. The same interleaving drives the port's batcher and
the reference's side by side: every formed batch must be the reference's
(ids, bucket, t_formed, arrivals: exact, the batcher is plain arithmetic),
and the invariants must hold on every interleaving:

- conservation: no request is ever lost or duplicated;
- every formed batch respects the bucket discipline (n_real <= bucket <=
  max_batch, bucket in exec_buckets(), align-multiple, per-device slice >=
  the post-clamp min_bucket floor);
- ready() fires exactly when due (full bucket or oldest past deadline);
- a driver that polls by next_deadline() never lets a request wait longer
  than deadline_s.
"""
import random

import pytest

pytest.importorskip("torch")

from _hypothesis_compat import given, settings, st  # noqa: E402

import repro.serving as J  # noqa: E402
from repro_torch.serving import MicroBatcher, SimClock  # noqa: E402


def _config(rng):
    """A random valid batcher config (the floor kept satisfiable)."""
    align = rng.choice([1, 2, 4])
    max_batch = align * rng.randint(1, 8)
    min_bucket = rng.randint(1, 3)
    if align > 1 and max_batch // align < min_bucket:
        min_bucket = max_batch // align
    return dict(max_batch=max_batch, align=align, min_bucket=min_bucket,
                deadline_s=rng.choice([0.001, 0.005, 0.02]))


def _pair(cfg):
    """(port batcher, its clock, reference batcher, its clock)."""
    clock, jclock = SimClock(), J.SimClock()
    return MicroBatcher(clock=clock, **cfg), clock, J.MicroBatcher(clock=jclock, **cfg), jclock


def _check_bucket(b, batch):
    assert 1 <= batch.n_real <= batch.bucket <= b.max_batch
    assert batch.bucket in b.exec_buckets()
    assert batch.bucket % b.align == 0
    assert batch.bucket // b.align >= b.min_bucket


def _same(batch, jbatch):
    """The port's formed batch is the reference's, field for field."""
    if batch is None or jbatch is None:
        assert batch is jbatch is None
        return
    assert (batch.bucket, batch.t_formed, batch.n_real) == \
        (jbatch.bucket, jbatch.t_formed, jbatch.n_real)
    assert [(r.id, r.t_arrival) for r in batch.requests] == \
        [(r.id, r.t_arrival) for r in jbatch.requests]


@settings(max_examples=30, deadline=None)
@given(seed=st.integers(min_value=0, max_value=2**31 - 1))
def test_no_request_lost_or_duplicated(seed):
    rng = random.Random(seed)
    cfg = _config(rng)
    b, clock, jb, jclock = _pair(cfg)
    assert b.exec_buckets() == jb.exec_buckets() and b.min_bucket == jb.min_bucket
    submitted, formed = [], []

    def step(batch, jbatch):
        _same(batch, jbatch)
        if batch is not None:
            _check_bucket(b, batch)
            formed.append(batch)

    for _ in range(rng.randint(1, 80)):
        op = rng.random()
        if op < 0.55:
            rid = b.submit(object())
            assert rid == jb.submit(object())
            submitted.append(rid)
        elif op < 0.75:
            dt = rng.uniform(0.0, 0.01)
            clock.advance(dt)
            jclock.advance(dt)
            step(b.ready(), jb.ready())
        elif op < 0.9:
            step(b.flush(), jb.flush())
        else:
            dt = rng.uniform(0.0, 0.03)
            clock.advance(dt)
            jclock.advance(dt)
    while b.pending():
        step(b.flush(), jb.flush())
    assert jb.pending() == 0
    served = [r.id for batch in formed for r in batch.requests]
    assert sorted(served) == submitted and len(served) == len(set(served))


@settings(max_examples=30, deadline=None)
@given(seed=st.integers(min_value=0, max_value=2**31 - 1))
def test_ready_fires_exactly_when_due(seed):
    rng = random.Random(seed)
    cfg = _config(rng)
    b, clock, jb, jclock = _pair(cfg)
    oldest = []  # shadow arrival queue, in order
    for _ in range(rng.randint(1, 80)):
        if rng.random() < 0.5:
            b.submit(object())
            jb.submit(object())
            oldest.append(clock())
        else:
            dt = rng.uniform(0.0, 0.012)
            clock.advance(dt)
            jclock.advance(dt)
        assert b.next_deadline() == jb.next_deadline()
        queued = len(oldest)
        due = queued >= cfg["max_batch"] or (
            queued > 0 and clock() >= oldest[0] + cfg["deadline_s"])
        batch = b.ready()
        _same(batch, jb.ready())
        if due:
            assert batch is not None
            _check_bucket(b, batch)
            del oldest[:batch.n_real]
        else:
            assert batch is None
    assert b.pending() == jb.pending() == len(oldest)


@settings(max_examples=30, deadline=None)
@given(seed=st.integers(min_value=0, max_value=2**31 - 1))
def test_deadline_contract_under_driver_polling(seed):
    rng = random.Random(seed)
    cfg = _config(rng)
    b, clock, jb, jclock = _pair(cfg)
    arrivals = []
    t = 0.0
    for _ in range(rng.randint(1, 60)):
        t += rng.uniform(0.0, cfg["deadline_s"] * 2)
        arrivals.append(t)
    formed = []
    i = 0
    while i < len(arrivals) or b.pending():
        cands = [c for c in (b.next_deadline(),
                             arrivals[i] if i < len(arrivals) else None)
                 if c is not None]
        clock.set(min(cands))
        jclock.set(min(cands))
        while i < len(arrivals) and arrivals[i] <= clock():
            b.submit(object(), now=arrivals[i])
            jb.submit(object(), now=arrivals[i])
            i += 1
        batch = b.ready()
        _same(batch, jb.ready())
        while batch is not None:  # a burst can leave several due buckets
            formed.append(batch)
            batch = b.ready()
            _same(batch, jb.ready())
    served = 0
    for batch in formed:
        _check_bucket(b, batch)
        for r in batch.requests:
            served += 1
            assert batch.t_formed - r.t_arrival <= cfg["deadline_s"] + 1e-9, (
                f"request waited {batch.t_formed - r.t_arrival:.5f}s with "
                f"deadline {cfg['deadline_s']}s (seed {seed})")
    assert served == len(arrivals)


@settings(max_examples=30, deadline=None)
@given(seed=st.integers(min_value=0, max_value=2**31 - 1))
def test_flush_drains_everything_in_bounded_batches(seed):
    rng = random.Random(seed)
    cfg = _config(rng)
    b, _, jb, _ = _pair(cfg)
    n = rng.randint(0, 40)
    ids = [b.submit(object()) for _ in range(n)]
    assert [jb.submit(object()) for _ in range(n)] == ids
    out = []
    while b.pending():
        batch = b.flush()
        _same(batch, jb.flush())
        _check_bucket(b, batch)
        out.extend(r.id for r in batch.requests)
    assert out == ids  # FIFO order survives arbitrary batch boundaries
    assert b.flush() is None and jb.flush() is None
