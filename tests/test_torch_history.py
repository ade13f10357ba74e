"""The port's perf-history store (`repro_torch.obs.history`) against the JAX
package's, mirroring tests/test_history.py.

The store, the verdicts and the rendering are plain host code, so on the
same DB the port must give the reference's records (series keys, values,
dedup), verdicts (`classify`, `check_db`), `diff_db` rows, `trend_table`
text and CLI exit codes exactly; there is no tolerance. A DB written by
either package loads in the other, with the same dedup. The port's own run
stamp carries torch / CUDA versions and never a jax key.
"""
import json
import os
import subprocess
import sys
from pathlib import Path

import pytest

pytest.importorskip("torch")

import repro.obs.history as J  # noqa: E402
from benchmarks._util import parse_csv_rows, write_bench_json  # noqa: E402
from repro.obs.history.cli import main as j_cli_main  # noqa: E402
from repro_torch.obs.history import (  # noqa: E402
    BenchDB,
    Thresholds,
    calibration_rows,
    check_db,
    classify,
    diff_db,
    html_report,
    make_payload,
    metric_direction,
    metric_noise_class,
    payload_records,
    run_context,
    telemetry_rows,
    trend_table,
)
from repro_torch.obs.history.cli import main as cli_main  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]


def bench_payload(sha="aaa1111", ts="2026-01-01T00:00:00Z", us=1000.0,
                  p50=2.0, name="model_zoo", device="cpu"):
    """A payload in the `write_bench_json` shape."""
    return {"name": name, "schema": "name,us_per_call,derived",
            "git_sha": sha, "timestamp": ts,
            "versions": {"jax": "0.9", "jaxlib": "0.9"},
            "device_kind": device, "platform": device,
            "rows": [
                {"name": "zoo/lenet/sparse", "us_per_call": us,
                 "p50_ms": p50, "throughput_rps": 100.0,
                 "derived": "batch=2"},
                {"name": "zoo/lenet/dense", "us_per_call": us * 2,
                 "derived": "batch=2"},
            ]}


def _series(db) -> dict:
    """{series key: [value, ...]}: the trajectory as plain data."""
    return {k: [r.value for r in recs] for k, recs in db.series().items()}


def _verdicts(verdicts) -> list:
    return [v.to_json() for v in verdicts]


def _both(tmp_path, *payloads):
    """(port DB, reference DB), each file-backed, with `payloads` ingested."""
    db, jdb = BenchDB(str(tmp_path / "db.jsonl")), J.BenchDB(str(tmp_path / "jdb.jsonl"))
    for p in payloads:
        assert db.ingest_payload(p) == jdb.ingest_payload(p)
    return db, jdb


# -- store -------------------------------------------------------------------


def test_ingest_and_series_typing(tmp_path):
    db, jdb = _both(tmp_path)
    assert db.ingest_payload(bench_payload()) == 4
    jdb.ingest_payload(bench_payload())
    keys = set(db.series())
    assert ("model_zoo", "zoo/lenet/sparse", "p50_ms", "cpu") in keys
    assert all(k[3] == "cpu" for k in keys)
    assert _series(db) == _series(jdb)


def test_device_kind_separates_baselines(tmp_path):
    """Host, TPU and H100 points form disjoint series: a fresh card point
    has no host baseline, so it is no-baseline, not regressed."""
    db, jdb = _both(tmp_path, bench_payload(device="cpu"),
                    bench_payload(sha="bbb2222", ts="2026-01-02T00:00:00Z",
                                  us=99999.0, device="NVIDIA H100 80GB HBM3"))
    series = db.series()
    for dev in ("cpu", "NVIDIA H100 80GB HBM3"):
        assert len(series[("model_zoo", "zoo/lenet/sparse", "us_per_call", dev)]) == 1
    verdicts = {v.metric: v for v in check_db(db)}
    assert verdicts["us_per_call"].status == "no-baseline"
    assert _verdicts(check_db(db)) == _verdicts(J.check_db(jdb))


def test_dedupe_and_reload(tmp_path):
    path = str(tmp_path / "db.jsonl")
    db = BenchDB(path)
    assert db.ingest_payload(bench_payload()) == 4
    assert db.ingest_payload(bench_payload()) == 0  # identical: all dups
    db2 = BenchDB(path)  # JSONL round trip preserves everything
    assert len(db2) == 4
    assert db2.ingest_payload(bench_payload()) == 0
    assert db2.records[0].identity() == db.records[0].identity()
    assert json.loads(open(path).readline())["schema"] == "benchdb-v1" == J.db.SCHEMA


def test_db_written_by_either_package_loads_in_the_other(tmp_path):
    """The reference's DB file loads in the port and the port's in the
    reference: the same series and values, and re-ingesting the payloads
    that wrote it adds nothing in either package."""
    jpath, path = str(tmp_path / "jdb.jsonl"), str(tmp_path / "db.jsonl")
    ref_payloads = [bench_payload(), bench_payload(sha="bbb2222",
                                                   ts="2026-01-02T00:00:00Z", us=1500.0)]
    port_payload = make_payload("serve_cnn", [{"name": "serve/lenet/steady",
                                               "p50_ms": 1.5, "requests": 8}],
                                device="cpu")
    jdb = J.BenchDB(jpath)
    for p in ref_payloads:
        jdb.ingest_payload(p)
    db = BenchDB(path)
    db.ingest_payload(port_payload)
    loaded, jloaded = BenchDB(jpath), J.BenchDB(path)
    assert _series(loaded) == _series(jdb) and _series(jloaded) == _series(db)
    assert all(loaded.ingest_payload(p) == 0 for p in ref_payloads)
    assert jloaded.ingest_payload(port_payload) == 0
    assert [r.torch for r in loaded.records] == ["unknown"] * len(loaded)
    rec = db.records[0]
    assert (rec.jax, rec.jaxlib, rec.device_kind, rec.platform) == \
        ("unknown", "unknown", "cpu", "cpu")
    assert jloaded.records[0].jax == "unknown"


def test_payload_records_skips_labels_and_nonscalars():
    payload = bench_payload()
    payload["rows"][0].update({"layer": 3, "seed": 0, "flag": True,
                               "nested": {"a": 1}, "note": "text"})
    recs = payload_records(payload)
    metrics = {r.metric for r in recs}
    assert not metrics & {"layer", "seed", "flag", "nested", "note"}
    assert "us_per_call" in metrics
    assert [r.identity()[:10] for r in recs] == \
        [r.identity() for r in J.payload_records(payload)]


# -- classification ----------------------------------------------------------


def test_metric_direction_and_noise_class():
    names = ("us_per_call", "p99_ms", "service_s_total", "throughput_rps",
             "speedup", "top1_agreement", "batches", "p50_ms", "stream_compiles",
             "mean_fill", "verify_rejects", "hits", "resid_spread", "scale")
    for m in names:
        assert metric_direction(m) == J.metric_direction(m), m
        assert metric_noise_class(m) == J.metric_noise_class(m), m
    assert metric_direction("us_per_call") == -1
    assert metric_direction("throughput_rps") == 1
    assert metric_direction("batches") == 0  # tracked, never gated
    assert metric_noise_class("top1_agreement") == "exact"


def test_classify_flat_on_identical_and_min_samples_guard():
    cases = [([100.0], 100.0, "us_per_call", Thresholds()),
             ([100.0, 100.0], 100.0, "us_per_call", Thresholds(min_samples=3))]
    got = [classify(*c) for c in cases]
    assert [v.status for v in got] == ["flat", "no-baseline"]
    jcases = [([100.0], 100.0, "us_per_call", J.Thresholds()),
              ([100.0, 100.0], 100.0, "us_per_call", J.Thresholds(min_samples=3))]
    assert _verdicts(got) == _verdicts([J.classify(*c) for c in jcases])


def _same_classify(prior, value, metric, **th):
    v = classify(prior, value, metric, Thresholds(**th))
    assert v.to_json() == J.classify(prior, value, metric, J.Thresholds(**th)).to_json()
    return v.status


def test_classify_regressed_improved_directions():
    assert _same_classify([100.0], 200.0, "us_per_call", rel_noisy=0.5) == "regressed"
    assert _same_classify([100.0], 40.0, "us_per_call", rel_noisy=0.5) == "improved"
    assert _same_classify([100.0], 40.0, "throughput_rps", rel_noisy=0.5) == "regressed"
    assert _same_classify([100.0], 200.0, "throughput_rps", rel_noisy=0.5) == "improved"


def test_mad_widens_band_on_noisy_history():
    quiet = [100.0, 101.0, 99.0, 100.0]
    noisy = [100.0, 140.0, 80.0, 120.0]
    assert _same_classify(quiet, 136.0, "us_per_call", rel_noisy=0.10, mad_k=4.0) \
        == "regressed"
    assert _same_classify(noisy, 136.0, "us_per_call", rel_noisy=0.10, mad_k=4.0) \
        == "flat"


def test_mad_needs_minimum_samples():
    assert _same_classify([509.9, 299.0], 897.0, "us_per_call") == "regressed"
    assert _same_classify([509.9, 299.0, 510.0, 300.0], 897.0, "us_per_call") == "flat"
    assert _same_classify([509.9, 299.0, 510.0, 300.0], 897.0, "us_per_call",
                          mad_min_samples=5) == "regressed"


def test_exact_metrics_gate_tight():
    assert _same_classify([1.0, 1.0, 1.0], 0.9, "top1_agreement") == "regressed"


# -- the gate: two runs, flat vs seeded regression ---------------------------


def _files(tmp_path, base, new):
    f1, f2 = tmp_path / "BENCH_a.json", tmp_path / "BENCH_b.json"
    f1.write_text(json.dumps(base))
    f2.write_text(json.dumps(new))
    return str(f1), str(f2)


def test_identical_rerun_is_flat_exit0(tmp_path):
    f1, f2 = _files(tmp_path, bench_payload(), bench_payload(ts="2026-01-02T00:00:00Z"))
    db_path, jdb_path = str(tmp_path / "db.jsonl"), str(tmp_path / "jdb.jsonl")
    for main, path in ((cli_main, db_path), (j_cli_main, jdb_path)):
        assert main(["ingest", "--db", path, f1]) == 0
        assert main(["check", "--db", path, f2]) == 0
    verdicts = check_db(BenchDB(db_path))
    gated = [v for v in verdicts if v.status != "ungated"]
    assert gated and all(v.status == "flat" for v in gated)
    assert _verdicts(verdicts) == _verdicts(J.check_db(J.BenchDB(jdb_path)))


def test_seeded_regression_exits_nonzero(tmp_path):
    bad = bench_payload(ts="2026-01-02T00:00:00Z")
    bad["rows"][0]["p50_ms"] *= 3.0  # >> rel_noisy=0.5
    f1, f2 = _files(tmp_path, bench_payload(), bad)
    db_path, jdb_path = str(tmp_path / "db.jsonl"), str(tmp_path / "jdb.jsonl")
    for main, path in ((cli_main, db_path), (j_cli_main, jdb_path)):
        assert main(["ingest", "--db", path, f1]) == 0
        assert main(["check", "--db", path, f2]) == 1
    verdicts = check_db(BenchDB(db_path))
    assert [(v.row, v.metric) for v in verdicts if v.status == "regressed"] == \
        [("zoo/lenet/sparse", "p50_ms")]
    assert _verdicts(verdicts) == _verdicts(J.check_db(J.BenchDB(jdb_path)))


def test_check_cli_process_level(tmp_path):
    """`python -m repro_torch.obs.history.cli check` at the process
    boundary: exit 0 with no baseline, exit 1 and the reference's JSON
    report on a regression, exit 2 on an empty DB."""
    bad = bench_payload(ts="2026-01-02T00:00:00Z")
    bad["rows"][1]["us_per_call"] *= 10.0
    f1, f2 = _files(tmp_path, bench_payload(), bad)
    env = dict(os.environ, PYTHONPATH=os.pathsep.join([str(ROOT / "src"), str(ROOT)]))

    def run(module, *args):
        return subprocess.run([sys.executable, "-m", module, *args],
                              capture_output=True, text=True, env=env, timeout=120)

    reports = []
    for module, db_path in (("repro_torch.obs.history.cli", tmp_path / "db.jsonl"),
                            ("repro.obs.history.cli", tmp_path / "jdb.jsonl")):
        r = run(module, "check", "--db", str(db_path), f1)
        assert r.returncode == 0, r.stderr  # first run: no baseline yet
        r = run(module, "check", "--db", str(db_path), f2, "--json")
        assert r.returncode == 1, r.stderr
        reports.append(json.loads(r.stdout))
    assert reports[0] == reports[1] and reports[0]["regressed"] == 1
    assert any(v["status"] == "regressed" and v["metric"] == "us_per_call"
               for v in reports[0]["verdicts"])
    r = run("repro_torch.obs.history.cli", "check", "--db", str(tmp_path / "empty.jsonl"))
    assert r.returncode == 2 and "empty DB" in r.stderr


def test_check_threshold_flags(tmp_path):
    bad = bench_payload(ts="2026-01-02T00:00:00Z")
    bad["rows"][0]["us_per_call"] *= 1.3
    f1, f2 = _files(tmp_path, bench_payload(), bad)
    db_path = str(tmp_path / "db.jsonl")
    assert cli_main(["ingest", "--db", db_path, f1, f2]) == 0
    assert cli_main(["check", "--db", db_path, "--rel-noisy", "0.5"]) == 0
    assert cli_main(["check", "--db", db_path, "--rel-noisy", "0.1"]) == 1
    assert j_cli_main(["check", "--db", db_path, "--rel-noisy", "0.1"]) == 1


def test_check_skips_stale_series(tmp_path):
    db, jdb = _both(tmp_path, bench_payload(name="old_bench"),
                    bench_payload(sha="bbb2222", ts="2026-01-02T00:00:00Z",
                                  name="fresh_bench", us=5000.0))
    verdicts = check_db(db, sha="bbb2222")
    assert verdicts and all(v.bench == "fresh_bench" for v in verdicts)
    assert _verdicts(verdicts) == _verdicts(J.check_db(jdb, sha="bbb2222"))


# -- diff --------------------------------------------------------------------


def test_diff_between_shas(tmp_path):
    db, jdb = _both(tmp_path, bench_payload(sha="aaa1111"),
                    bench_payload(sha="bbb2222", ts="2026-01-02T00:00:00Z", us=2000.0))
    rows = diff_db(db, "aaa1111", "bbb2222")
    assert rows == J.diff_db(jdb, "aaa1111", "bbb2222")
    by = {(r["row"], r["metric"]): r for r in rows}
    r = by[("zoo/lenet/sparse", "us_per_call")]
    assert (r["a"], r["b"], r["better"]) == (1000.0, 2000.0, False)
    assert r["rel_delta"] == pytest.approx(1.0)
    assert by[("zoo/lenet/sparse", "throughput_rps")]["better"] is None


# -- payload files and the device stamp --------------------------------------


def test_write_bench_json_roundtrip_and_device_stamp(tmp_path):
    """A file the benchmark harness writes ingests in both packages to the
    same records; the port's own payload carries the device stamp and the
    torch / CUDA versions."""
    csv = ("name,us_per_call,derived\n"
           "fig9/conv_1,123.4,speedup=2.0\n"
           "_meta/fig9_wall_s,1.5,module wall time (seconds)\n"
           "bogus-line\n")
    rows = parse_csv_rows(csv)
    path = write_bench_json("roundtrip", rows, str(tmp_path))
    payload = json.load(open(path))
    db, jdb = BenchDB(str(tmp_path / "db.jsonl")), J.BenchDB(str(tmp_path / "jdb.jsonl"))
    assert db.ingest_file(path) == jdb.ingest_file(path) == 1
    ((key, recs),) = db.series().items()
    assert key[:3] == ("roundtrip", "fig9/conv_1", "us_per_call")
    assert recs[0].value == 123.4 and recs[0].device_kind == payload["device_kind"]
    assert recs[0].identity()[:10] == jdb.records[0].identity()
    ours = make_payload("roundtrip", rows, device="cpu")
    for k in ("git_sha", "timestamp", "versions", "device_kind", "platform"):
        assert k in ours, k
    assert (ours["device_kind"], ours["platform"]) == ("cpu", "cpu")
    assert set(ours["versions"]) == {"torch", "cuda"}
    (rec,) = payload_records(ours)
    assert rec.torch == ours["versions"]["torch"] and rec.jax == "unknown"


def test_ingest_rejects_non_bench_json(tmp_path):
    p = tmp_path / "BENCH_bad.json"
    p.write_text(json.dumps({"not": "a payload"}))
    with pytest.raises(ValueError):
        BenchDB(str(tmp_path / "db.jsonl")).ingest_file(str(p))
    assert cli_main(["ingest", "--db", str(tmp_path / "db.jsonl"), str(p)]) == 2


# -- exporters: telemetry / profile / calibration ----------------------------


def test_telemetry_rows_schema():
    snapshot = {"submitted": 10, "completed": 10, "batches": 4,
                "pad_samples": 2, "mean_fill": 0.75, "service_s_total": 0.1,
                "latency": {"count": 10, "mean_ms": 2.0, "max_ms": 5.0,
                            "p50_ms": 1.5, "p95_ms": 4.0, "p99_ms": 5.0},
                "replans": {"triggers": 1, "swaps": 1, "errors": 0,
                            "hot_swaps": 1, "verify_rejects": 1},
                "occ_timeline": [[0.0, [0.5]]], "replan_events": []}
    rows = telemetry_rows(snapshot, prefix="telemetry/vgg/steady")
    assert rows == J.telemetry_rows(snapshot, prefix="telemetry/vgg/steady")
    (row,) = rows
    assert row["p95_ms"] == 4.0 and row["replan_swaps"] == 1 and row["hot_swaps"] == 1
    assert all(not isinstance(v, (list, dict)) for v in row.values())
    recs = payload_records(make_payload("serving", rows, device="cpu"))
    assert {r.metric for r in recs} >= {"p50_ms", "p99_ms", "mean_fill",
                                        "replan_triggers", "verify_rejects"}


def test_profile_and_calibration_rows():
    """`ProfileReport.history_rows` and `CalibrationDB.history_rows` give
    the reference's rows on the same timings and fits."""
    from repro.obs.calibrate import CalibEntry as JCalibEntry
    from repro.obs.calibrate import CalibrationDB as JCalibrationDB
    from repro.obs.profile import LayerTiming as JLayerTiming
    from repro.obs.profile import ProfileReport as JProfileReport
    from repro_torch.obs.calibrate import CalibEntry, CalibrationDB
    from repro_torch.obs.profile import LayerTiming, ProfileReport

    fields = [dict(index=i, kind="conv", impl=impl, occupancy=0.5,
                   weight_density=1.0, batch=2, block_c=8,
                   measured_us=100.0 * (i + 1), spread=0.1,
                   predicted_us=50.0 * (i + 1), flops=1e6, bytes=1e4)
              for i, impl in ((0, "dense"), (0, "ecr_pallas"), (1, "dense"))]
    report = ProfileReport(graph_name="lenet", device_kind="cpu", batch=2, block_c=8,
                           timings=tuple(LayerTiming(**f) for f in fields))
    jreport = JProfileReport(graph_name="lenet", device_kind="cpu", batch=2,
                             block_c=8, timings=tuple(JLayerTiming(**f) for f in fields))
    rows = report.history_rows()
    assert rows == jreport.history_rows()
    assert "profile/lenet/conv/dense" in [r["name"] for r in rows]
    assert 0.0 <= rows[-1]["top1_agreement"] <= 1.0
    entry = dict(peak_flops=1e12, hbm_bw=1e11, scale=0.5, n_samples=3, resid_spread=0.2)
    db, jdb = CalibrationDB(device="cpu"), JCalibrationDB(device="cpu")
    db.put("conv", "dense", 8, CalibEntry(**entry))
    jdb.put("conv", "dense", 8, JCalibEntry(**entry))
    assert db.history_rows() == calibration_rows(db) == jdb.history_rows()
    (crow,) = db.history_rows()
    assert crow["name"] == "calib/cpu/conv/dense/bc8" and crow["scale"] == 0.5
    recs = payload_records(make_payload("obs", rows + [crow], device="cpu"))
    assert {r.metric for r in recs} >= {"ratio_median", "top1_agreement",
                                        "scale", "resid_spread"}


# -- rendering ---------------------------------------------------------------


def test_trend_table_and_html_report(tmp_path):
    db, jdb = _both(tmp_path, bench_payload(),
                    bench_payload(sha="bbb2222", ts="2026-01-02T00:00:00Z", us=3000.0))
    table = trend_table(db)
    assert table == J.trend_table(jdb)
    assert "zoo/lenet/sparse/us_per_call" in table and "regressed" in table
    md = trend_table(db, markdown=True)
    assert md == J.trend_table(jdb, markdown=True) and md.startswith("| series |")
    html = html_report(db)
    assert html == J.html_report(jdb)
    assert html.startswith("<!doctype html>") and "<svg" in html
    assert "src=" not in html  # self-contained: no external assets
    out = tmp_path / "report.html"
    assert cli_main(["report", "--db", str(db.path), "--html", str(out)]) == 0
    assert out.read_text().startswith("<!doctype html>")


def test_benchdb_gitignored():
    """The DB is a run artifact, not a tracked file."""
    gitignore = (ROOT / ".gitignore").read_text()
    assert "benchdb" in gitignore or "*.jsonl" in gitignore


def test_run_context_stamps_torch_and_the_device():
    ctx = run_context("cpu")
    assert set(ctx["versions"]) == {"torch", "cuda"} and "jax" not in ctx["versions"]
    assert (ctx["device_kind"], ctx["platform"]) == ("cpu", "cpu")
    assert ctx["git_sha"]
