"""Noise-aware regression verdicts over BenchDB series (counterpart of
`repro.obs.history.baseline`: the same pure functions, so both packages
give the same verdicts on the same DB).

The gate has to hold two properties at once: a bit-identical rerun must
come out all-flat (exit 0), and a real perf cliff must trip it — on wall
times measured on shared CI runners whose absolute numbers wander by tens
of percent between runs. The classification therefore never compares two
raw points; it compares the fresh point against a ROLLING BASELINE:

- baseline = median of the last `window` prior points of the series
  (median, not mean: one GC-paused outlier run must not move the bar);
- noise    = MAD of the same window, scaled by 1.4826 (the normal-
  consistency constant, so `mad_k` reads in sigmas);
- tol      = max(rel_tol * |baseline|, mad_k * 1.4826 * MAD, abs_floor) —
  the relative term carries a young series (MAD of one point is 0), the
  MAD term widens the band automatically on metrics that history shows to
  be noisy on this runner, but only once the series has
  `mad_min_samples` prior points (the MAD of two points is just half
  their gap — one noisy early pair must not swallow a real cliff);
- verdict  = regressed / improved when the point leaves the band in the
  metric's bad / good direction, flat inside it.

`min_samples` guards the cold start: a series with fewer prior points than
that reports "no-baseline" and never gates — the default of 1 makes the
second-ever run comparable (two ingested runs, identical ⇒ exit 0,
perturbed ⇒ nonzero).

Metric direction and noise class are inferred from the metric NAME
(`*_us`/`*_ms`/latency ⇒ lower-better noisy; throughput/speedup/agreement
⇒ higher-better; agreement/counters ⇒ exact-class tight tolerance);
metrics with no inferable direction are tracked but never gate — a changed
`batches` count is trajectory information, not by itself a regression.
"""
from __future__ import annotations

from dataclasses import dataclass, replace

# -- metric policy ---------------------------------------------------------

_LOWER_SUFFIXES = ("_us", "_ms", "_s", "_sec")
_LOWER_TOKENS = ("us_per_call", "latency", "wall", "spread", "resid",
                 "drift", "pad_samples", "stream_compiles", "errors",
                 "rejects", "miss", "service_s")
_HIGHER_TOKENS = ("throughput", "speedup", "agreement", "top1", "pairwise",
                  "accuracy", "mean_fill", "hits")
# deterministic-by-construction metrics: same code + same seed must
# reproduce them exactly, so the tolerance band is tight
_EXACT_TOKENS = ("agreement", "top1", "pairwise", "compiles", "errors",
                 "rejects", "hits", "mean_fill", "accuracy")


def metric_direction(metric: str) -> int:
    """-1 lower-is-better, +1 higher-is-better, 0 ungated (tracked only)."""
    m = metric.lower()
    if any(t in m for t in _HIGHER_TOKENS):
        return 1
    if m.endswith(_LOWER_SUFFIXES) or any(t in m for t in _LOWER_TOKENS):
        return -1
    return 0


def metric_noise_class(metric: str) -> str:
    """"exact" (deterministic counters/scores) or "noisy" (wall clock)."""
    m = metric.lower()
    return "exact" if any(t in m for t in _EXACT_TOKENS) else "noisy"


@dataclass(frozen=True)
class Thresholds:
    """The configurable gate geometry (CLI flags map 1:1).

    `rel_noisy` defaults wide (50%) because CI wall clocks on shared
    runners genuinely move that much run-to-run; the MAD term tightens the
    effective band once a series has history. `rel_exact` is tight — a
    deterministic agreement score or compile count that moves 2% moved
    because the code changed."""

    rel_noisy: float = 0.5
    rel_exact: float = 0.02
    mad_k: float = 4.0
    min_samples: int = 1
    # the MAD term needs this many prior points before it can widen the
    # band: the MAD of two points is just half their gap, so one noisy
    # pair of early runs would otherwise swallow a real 3x cliff forever
    mad_min_samples: int = 3
    window: int = 8
    abs_floor: float = 1e-9

    def rel_for(self, metric: str) -> float:
        return self.rel_exact if metric_noise_class(metric) == "exact" \
            else self.rel_noisy


@dataclass(frozen=True)
class Verdict:
    """One gated point: the fresh value vs its rolling baseline."""

    bench: str
    row: str
    metric: str
    device_kind: str
    value: float
    git_sha: str
    status: str  # regressed | improved | flat | no-baseline | ungated
    direction: int
    baseline: float = 0.0
    baseline_n: int = 0
    mad: float = 0.0
    tol: float = 0.0
    delta: float = 0.0  # value - baseline
    rel_delta: float = 0.0

    def to_json(self) -> dict:
        return {"bench": self.bench, "row": self.row, "metric": self.metric,
                "device_kind": self.device_kind, "git_sha": self.git_sha,
                "value": self.value, "status": self.status,
                "direction": self.direction,
                "baseline": self.baseline, "baseline_n": self.baseline_n,
                "mad": round(self.mad, 9), "tol": round(self.tol, 9),
                "delta": self.delta, "rel_delta": round(self.rel_delta, 6)}


def _median(vals) -> float:
    s = sorted(vals)
    n = len(s)
    return float(s[n // 2]) if n % 2 else float((s[n // 2 - 1] + s[n // 2]) / 2)


def classify(prior_values, value: float, metric: str,
             thresholds: Thresholds | None = None) -> Verdict:
    """Classify one fresh `value` against the series' `prior_values`
    (oldest→newest; only the last `window` are consulted). Series identity
    fields of the returned Verdict are left blank — `check_db` fills them."""
    th = thresholds or Thresholds()
    direction = metric_direction(metric)
    base = Verdict(bench="", row="", metric=metric, device_kind="",
                   value=float(value), git_sha="", status="flat",
                   direction=direction)
    if direction == 0:
        return replace(base, status="ungated")
    recent = list(prior_values)[-th.window:]
    if len(recent) < max(th.min_samples, 1):
        return replace(base, status="no-baseline", baseline_n=len(recent))
    med = _median(recent)
    mad = _median([abs(v - med) for v in recent])
    tol = max(th.rel_for(metric) * abs(med), th.abs_floor)
    if len(recent) >= th.mad_min_samples:
        tol = max(tol, th.mad_k * 1.4826 * mad)
    delta = float(value) - med
    worse = delta if direction < 0 else -delta
    status = "regressed" if worse > tol else \
        "improved" if worse < -tol else "flat"
    return replace(base, status=status, baseline=med, baseline_n=len(recent),
                   mad=mad, tol=tol, delta=delta,
                   rel_delta=delta / abs(med) if med else 0.0)


def check_db(db, sha: str | None = None,
             thresholds: Thresholds | None = None) -> list:
    """Gate the candidate run against the trajectory.

    Candidate = the last point of each series, but only where that point
    belongs to `sha` (default: the SHA of the most recently appended record
    — "the run that just landed"). Series whose freshest point is from an
    older run are NOT judged: a bench that didn't re-run this time has no
    fresh evidence either way. Baseline = the points before the candidate
    in append order. Returns one Verdict per gated series, regressions
    first, then by (bench, row, metric)."""
    sha = sha or db.latest_sha()
    out = []
    for key, recs in sorted(db.series().items()):
        cand = recs[-1]
        if sha is not None and cand.git_sha != sha:
            continue
        v = classify([r.value for r in recs[:-1]], cand.value, cand.metric,
                     thresholds)
        out.append(replace(v, bench=cand.bench, row=cand.row,
                           device_kind=cand.device_kind,
                           git_sha=cand.git_sha))
    rank = {"regressed": 0, "improved": 1, "flat": 2, "no-baseline": 3,
            "ungated": 4}
    out.sort(key=lambda v: (rank.get(v.status, 9), v.bench, v.row, v.metric))
    return out


def diff_db(db, sha_a: str, sha_b: str) -> list:
    """Per-series comparison of two commits: the LATEST point of each
    series at each SHA (a commit benchmarked twice counts its freshest
    measurement). Only series present at both SHAs appear. Each entry is a
    JSON-ready dict with the delta signed in raw units and the classified
    direction, so a `diff` can be read without knowing the metric zoo."""
    out = []
    for key, recs in sorted(db.series().items()):
        at_a = [r for r in recs if r.git_sha == sha_a]
        at_b = [r for r in recs if r.git_sha == sha_b]
        if not at_a or not at_b:
            continue
        a, b = at_a[-1].value, at_b[-1].value
        bench, row, metric, dev = key
        d = metric_direction(metric)
        better = None
        if d != 0 and a != b:
            better = ((b < a) if d < 0 else (b > a))
        out.append({"bench": bench, "row": row, "metric": metric,
                    "device_kind": dev, "a": a, "b": b, "delta": b - a,
                    "rel_delta": (b - a) / abs(a) if a else 0.0,
                    "direction": d,
                    "better": better})
    return out
