"""BenchDB: the append-only JSONL store of cross-run benchmark points
(counterpart of `repro.obs.history.db`, same `benchdb-v1` schema).

One line per record, one record per (bench, row, metric) value of one run.
JSONL because the write path must be append-only: a job restores the DB,
appends its points and keeps it; a format that rewrote the whole file on
ingest would turn every crash into data loss. Plain JSON values.

The series key is (bench, row, metric, device_kind): `device_kind` is part
of the key, not metadata, so points measured on an H100, on a TPU or on the
host form disjoint series, and no baseline can absolve (or accuse) another
device's point. Within a series, points are ordered by append position
(`seq`): second-granularity timestamps collide, so ordering never depends
on them.

The file is shared with the JAX package: a DB written by either package
loads in the other. Each record carries the reference's version slots
(`jax`, `jaxlib`) and the port's (`torch`, `cuda`); the slots of the other
package read "unknown" (a loader ignores keys it does not know). A record
whose full payload (series key + run stamp + value) is already present is
skipped on ingest, so re-ingesting a file is a no-op in either package.
"""
from __future__ import annotations

import glob
import json
import os
import subprocess
import time
from dataclasses import dataclass, field
from pathlib import Path

SCHEMA = "benchdb-v1"

# row keys that are labels or configuration echoes, not measurements
_SKIP_KEYS = frozenset({"name", "derived", "layer", "index", "seed"})
_CHECKOUT = Path(__file__).resolve().parents[4]


def _git_sha() -> str:
    """The short SHA of the checkout this package runs from ("unknown" when
    it is not a git checkout)."""
    try:
        out = subprocess.run(["git", "rev-parse", "--short", "HEAD"],
                             capture_output=True, text=True, timeout=5,
                             cwd=_CHECKOUT)
    except (OSError, subprocess.SubprocessError):
        return "unknown"
    return out.stdout.strip() if out.returncode == 0 and out.stdout.strip() \
        else "unknown"


def run_context(device=None) -> dict:
    """The stamp of the producing run: git SHA, UTC timestamp, the torch and
    CUDA versions, and the device (`obs.calibrate.device_kind`: the card's
    name, or "cpu"; `device` None means the card when one is present)."""
    import torch

    from repro_torch.obs.calibrate import device_kind

    kind = device_kind(device)
    return {"git_sha": _git_sha(),
            "timestamp": time.strftime("%Y-%m-%dT%H:%M:%SZ", time.gmtime()),
            "versions": {"torch": torch.__version__,
                         "cuda": torch.version.cuda or "none"},
            "device_kind": kind,
            "platform": "cpu" if kind == "cpu" else "gpu"}


@dataclass(frozen=True)
class BenchRecord:
    """One perf point: a (bench, row, metric) value stamped with the run
    that produced it. `seq` is the append position in the DB (assigned on
    load or ingest, not serialized): the series order."""

    bench: str
    row: str
    metric: str
    value: float
    git_sha: str
    timestamp: str
    jax: str
    jaxlib: str
    device_kind: str
    platform: str
    torch: str = "unknown"
    cuda: str = "unknown"
    source: str = field(default="", compare=False)
    seq: int = field(default=-1, compare=False)

    @property
    def series_key(self) -> tuple:
        return (self.bench, self.row, self.metric, self.device_kind)

    def identity(self) -> tuple:
        """The dedup key: everything that makes this point THIS point,
        `value` included (a bit-identical rerun of one commit in the same
        second is the same point; a changed measurement is a new one). The
        reference's ten fields, then the port's two version slots."""
        return (self.bench, self.row, self.metric, self.value, self.git_sha,
                self.timestamp, self.jax, self.jaxlib, self.device_kind,
                self.platform, self.torch, self.cuda)

    def to_json(self) -> dict:
        return {"bench": self.bench, "row": self.row, "metric": self.metric,
                "value": self.value, "git_sha": self.git_sha,
                "timestamp": self.timestamp, "jax": self.jax,
                "jaxlib": self.jaxlib, "torch": self.torch, "cuda": self.cuda,
                "device_kind": self.device_kind, "platform": self.platform,
                "source": self.source}

    @classmethod
    def from_json(cls, d: dict, seq: int = -1) -> "BenchRecord":
        return cls(bench=str(d["bench"]), row=str(d["row"]),
                   metric=str(d["metric"]), value=float(d["value"]),
                   git_sha=str(d.get("git_sha", "unknown")),
                   timestamp=str(d.get("timestamp", "")),
                   jax=str(d.get("jax", "unknown")),
                   jaxlib=str(d.get("jaxlib", "unknown")),
                   device_kind=str(d.get("device_kind", "unknown")),
                   platform=str(d.get("platform", "unknown")),
                   torch=str(d.get("torch", "unknown")),
                   cuda=str(d.get("cuda", "unknown")),
                   source=str(d.get("source", "")), seq=seq)


def payload_records(payload: dict, source: str = "") -> list:
    """Flatten one BENCH payload (`write_bench_json`'s shape, or
    `records.make_payload`'s) into records: every numeric field of every row
    becomes one (bench, row, metric) point stamped with the payload's run
    context. Bools, strings, nested structures and label keys are skipped."""
    bench = str(payload.get("name", "unknown"))
    versions = payload.get("versions", {}) or {}
    ctx = {
        "git_sha": str(payload.get("git_sha", "unknown")),
        "timestamp": str(payload.get("timestamp", "")),
        **{k: str(versions.get(k, "unknown"))
           for k in ("jax", "jaxlib", "torch", "cuda")},
        # a payload without the device stamp lands in an explicit "unknown"
        # series rather than polluting a device baseline
        "device_kind": str(payload.get("device_kind", "unknown")),
        "platform": str(payload.get("platform", "unknown")),
    }
    out = []
    for row in payload.get("rows", []):
        if not isinstance(row, dict):
            continue
        rname = str(row.get("name", "?"))
        for k, v in row.items():
            if k in _SKIP_KEYS or isinstance(v, bool):
                continue
            if not isinstance(v, (int, float)):
                continue
            out.append(BenchRecord(bench=bench, row=rname, metric=str(k),
                                   value=float(v), source=source, **ctx))
    return out


class BenchDB:
    """The trajectory store: load on open, append on ingest, dedup always.

    `path=None` gives an in-memory DB; with a path the file is created
    lazily with a one-line schema header and every accepted record is
    appended at once, so two processes alternating ingests never clobber
    each other's points."""

    def __init__(self, path: str | None = None):
        self.path = path
        self.records: list = []
        self._ids: set = set()
        if path and os.path.exists(path):
            with open(path) as f:
                for line in f:
                    line = line.strip()
                    if not line:
                        continue
                    d = json.loads(line)
                    if "bench" not in d:  # schema header / metadata
                        continue
                    self._absorb(BenchRecord.from_json(d))

    def __len__(self) -> int:
        return len(self.records)

    def _absorb(self, rec: BenchRecord) -> bool:
        ident = rec.identity()
        if ident in self._ids:
            return False
        self._ids.add(ident)
        object.__setattr__(rec, "seq", len(self.records))
        self.records.append(rec)
        return True

    def append(self, records) -> int:
        """Dedup + append; accepted records are written through to the JSONL
        file (when file-backed). Returns how many were new."""
        fresh = [r for r in records if self._absorb(r)]
        if fresh and self.path:
            new_file = not os.path.exists(self.path) or \
                os.path.getsize(self.path) == 0
            os.makedirs(os.path.dirname(os.path.abspath(self.path)),
                        exist_ok=True)
            with open(self.path, "a") as f:
                if new_file:
                    f.write(json.dumps({"schema": SCHEMA}) + "\n")
                for r in fresh:
                    f.write(json.dumps(r.to_json(), sort_keys=True) + "\n")
        return len(fresh)

    # -- ingest ------------------------------------------------------------

    def ingest_payload(self, payload: dict, source: str = "") -> int:
        return self.append(payload_records(payload, source=source))

    def ingest_file(self, path: str) -> int:
        with open(path) as f:
            payload = json.load(f)
        if not isinstance(payload, dict) or "rows" not in payload:
            raise ValueError(f"{path}: not a BENCH payload (no 'rows')")
        return self.ingest_payload(payload, source=os.path.basename(path))

    def ingest_dir(self, dirpath: str) -> dict:
        """Ingest every BENCH_*.json under `dirpath`; {filename: n_new}.
        Dedup makes repeated calls over one directory safe."""
        out = {}
        for p in sorted(glob.glob(os.path.join(dirpath, "BENCH_*.json"))):
            out[os.path.basename(p)] = self.ingest_file(p)
        return out

    # -- views -------------------------------------------------------------

    def series(self) -> dict:
        """{(bench, row, metric, device_kind): [BenchRecord, ...]} in append
        order: the trajectory, one list per typed series."""
        out: dict = {}
        for r in self.records:
            out.setdefault(r.series_key, []).append(r)
        return out

    def shas(self) -> list:
        """Distinct git SHAs in first-appearance order."""
        seen: dict = {}
        for r in self.records:
            seen.setdefault(r.git_sha, None)
        return list(seen)

    def latest_sha(self) -> str | None:
        """The SHA of the most recently appended record: `check`'s default
        candidate run."""
        return self.records[-1].git_sha if self.records else None
