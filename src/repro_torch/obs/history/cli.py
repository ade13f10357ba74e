"""The perf-history CLI on the port (counterpart of `repro-bench`,
`repro.obs.history.cli`; the same commands, flags and exit codes).

    PYTHONPATH=src python -m repro_torch.obs.history.cli <cmd> --db DB ...

Commands:
- `ingest DB-relative BENCH files / directories` — append (dedup'd) points;
- `diff <shaA> <shaB>` — per-series values of two commits side by side;
- `check [files...]`   — gate the latest run (optionally ingesting the
  given BENCH files first) against each series' rolling baseline; exits
  nonzero iff any gated metric regressed — the regression gate;
- `report`             — trend tables (terminal or --markdown) and/or the
  self-contained HTML dashboard (--html PATH).

Exit codes: 0 ok, 1 regression detected (check), 2 usage/data errors.
"""
from __future__ import annotations

import argparse
import json
import os
import sys

from repro_torch.obs.history.baseline import Thresholds, check_db, diff_db
from repro_torch.obs.history.db import BenchDB
from repro_torch.obs.history.report import html_report, trend_table


def _ingest_paths(db: BenchDB, paths) -> dict:
    """Files and/or directories; directories expand to their BENCH_*.json."""
    out = {}
    for p in paths:
        if os.path.isdir(p):
            out.update(db.ingest_dir(p))
        else:
            out[os.path.basename(p)] = db.ingest_file(p)
    return out


def _thresholds(args) -> Thresholds:
    return Thresholds(rel_noisy=args.rel_noisy, rel_exact=args.rel_exact,
                      mad_k=args.mad_k, min_samples=args.min_samples,
                      mad_min_samples=args.mad_min_samples,
                      window=args.window)


def cmd_ingest(args) -> int:
    db = BenchDB(args.db)
    counts = _ingest_paths(db, args.paths)
    for name, n in sorted(counts.items()):
        print(f"{name}: {n} new point(s)")
    print(f"{args.db}: {len(db)} total points, "
          f"{len(db.series())} series, {len(db.shas())} commits")
    return 0


def cmd_diff(args) -> int:
    db = BenchDB(args.db)
    rows = diff_db(db, args.sha_a, args.sha_b)
    if args.json:
        json.dump({"a": args.sha_a, "b": args.sha_b, "series": rows},
                  sys.stdout, indent=2)
        print()
        return 0
    if not rows:
        print(f"no series present at both {args.sha_a} and {args.sha_b}")
        return 2
    print(f"{'series':<58} {args.sha_a:>12} {args.sha_b:>12} {'delta':>9}")
    for r in rows:
        name = f"{r['bench']}/{r['row']}/{r['metric']}"
        mark = "" if r["better"] is None else \
            (" (better)" if r["better"] else " (worse)")
        print(f"{name:<58} {r['a']:>12.4g} {r['b']:>12.4g} "
              f"{r['rel_delta']:>+8.1%}{mark}")
    return 0


def cmd_check(args) -> int:
    db = BenchDB(args.db)
    if args.paths:
        _ingest_paths(db, args.paths)
    if not len(db):
        print("empty DB: nothing to check", file=sys.stderr)
        return 2
    verdicts = check_db(db, sha=args.sha, thresholds=_thresholds(args))
    regressed = [v for v in verdicts if v.status == "regressed"]
    counts: dict = {}
    for v in verdicts:
        counts[v.status] = counts.get(v.status, 0) + 1
    if args.json:
        json.dump({"sha": args.sha or db.latest_sha(), "counts": counts,
                   "regressed": len(regressed),
                   "verdicts": [v.to_json() for v in verdicts]},
                  sys.stdout, indent=2)
        print()
    else:
        for v in verdicts:
            if v.status in ("regressed", "improved"):
                print(f"{v.status.upper():>10}  {v.bench}/{v.row}/{v.metric}"
                      f"  {v.baseline:.4g} -> {v.value:.4g}"
                      f" ({v.rel_delta:+.1%}, tol {v.tol:.4g})")
        print(f"checked {len(verdicts)} series at "
              f"{args.sha or db.latest_sha()}: " +
              ", ".join(f"{counts.get(s, 0)} {s}" for s in
                        ("regressed", "improved", "flat", "no-baseline",
                         "ungated")))
    return 1 if regressed else 0


def cmd_report(args) -> int:
    db = BenchDB(args.db)
    if not len(db):
        print("empty DB: nothing to report", file=sys.stderr)
        return 2
    if args.html:
        with open(args.html, "w") as f:
            f.write(html_report(db, last=args.last))
        print(f"wrote {args.html}")
    if args.html is None or args.tables:
        print(trend_table(db, last=args.last, markdown=args.markdown))
    return 0


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(prog="python -m repro_torch.obs.history.cli",
                                 description=__doc__,
                                 formatter_class=argparse.RawDescriptionHelpFormatter)
    sub = ap.add_subparsers(dest="cmd", required=True)

    p = sub.add_parser("ingest", help="append BENCH payloads to the DB")
    p.add_argument("--db", required=True, help="BenchDB JSONL path")
    p.add_argument("paths", nargs="+",
                   help="BENCH_*.json files and/or directories of them")
    p.set_defaults(fn=cmd_ingest)

    p = sub.add_parser("diff", help="compare two commits series by series")
    p.add_argument("--db", required=True)
    p.add_argument("sha_a")
    p.add_argument("sha_b")
    p.add_argument("--json", action="store_true")
    p.set_defaults(fn=cmd_diff)

    p = sub.add_parser(
        "check", help="gate the latest run vs rolling baselines")
    p.add_argument("--db", required=True)
    p.add_argument("paths", nargs="*",
                   help="BENCH files/dirs to ingest before checking")
    p.add_argument("--sha", default=None,
                   help="candidate SHA (default: the most recently "
                        "appended record's)")
    p.add_argument("--rel-noisy", type=float, default=Thresholds.rel_noisy,
                   help="relative tolerance for wall-clock metrics")
    p.add_argument("--rel-exact", type=float, default=Thresholds.rel_exact,
                   help="relative tolerance for deterministic metrics")
    p.add_argument("--mad-k", type=float, default=Thresholds.mad_k,
                   help="MAD multiplier (sigmas) for the noise band")
    p.add_argument("--min-samples", type=int, default=Thresholds.min_samples,
                   help="baseline points required before a series gates")
    p.add_argument("--mad-min-samples", type=int,
                   default=Thresholds.mad_min_samples,
                   help="baseline points required before the MAD term can "
                        "widen the band")
    p.add_argument("--window", type=int, default=Thresholds.window,
                   help="rolling-baseline window (points)")
    p.add_argument("--json", action="store_true")
    p.set_defaults(fn=cmd_check)

    p = sub.add_parser("report", help="trend tables / HTML dashboard")
    p.add_argument("--db", required=True)
    p.add_argument("--markdown", action="store_true",
                   help="markdown table instead of aligned text")
    p.add_argument("--html", default=None, metavar="PATH",
                   help="write the self-contained HTML dashboard here")
    p.add_argument("--tables", action="store_true",
                   help="with --html: also print the terminal table")
    p.add_argument("--last", type=int, default=10,
                   help="trend window (points per series)")
    p.set_defaults(fn=cmd_report)
    return ap


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)
    try:
        return args.fn(args)
    except (OSError, ValueError) as e:
        print(f"history cli: {e}", file=sys.stderr)
        return 2


if __name__ == "__main__":
    raise SystemExit(main())
