"""The port's serving spine on the host: engine logits bit-identical to the
port's own run_plan for co-batched shared-union requests, one runner build
per distinct key, the batcher's deadline on a SimClock, and the launcher
end to end on VGG-tiny."""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.graph import init_graph  # noqa: E402
from repro_torch.launch.serve_cnn import serve_cnn, serving_graph, synth_requests  # noqa: E402
from repro_torch.models.cnn import shift_dead_channels  # noqa: E402
from repro_torch.pipeline import run_plan  # noqa: E402
from repro_torch.serving import (  # noqa: E402
    Engine,
    MicroBatcher,
    PlanCache,
    SimClock,
    bucket_sizes,
    plan_key,
    replay_stream,
)

GRAPH = serving_graph("vgg19")  # VGG-tiny: 16x16x16, convs 16/16/32


@pytest.fixture(scope="module")
def params():
    return shift_dead_channels(init_graph(torch.Generator().manual_seed(0), GRAPH,
                                          device="cpu"))


def _engine(params, **kw):
    kw.setdefault("calib", torch.stack(synth_requests(GRAPH, 2, seed=1, device="cpu")))
    kw.setdefault("occ_threshold", 1.0)  # every layer sparse: ECR + PECR
    kw.setdefault("block_c", 8)
    kw.setdefault("max_batch", 4)
    kw.setdefault("deadline_s", 0.005)
    kw.setdefault("clock", SimClock())
    return Engine(params, graph=GRAPH, device="cpu", **kw)


def test_engine_plan_runs_both_kernels(params):
    eng = _engine(params)
    assert [lp.impl for lp in eng.plan.layers] == ["ecr_pallas", "pecr_pallas", "pecr_pallas"]


def test_engine_matches_run_plan_bitwise(params):
    """N single-image requests through the engine == run_plan on the same
    images, bit for bit, across ragged buckets (5 -> [4, 2-padded])."""
    eng = _engine(params)
    imgs = synth_requests(GRAPH, 5, seed=7, device="cpu")
    served = eng.serve(imgs)
    ref = run_plan(eng.plan, params, torch.stack(imgs)).numpy()
    assert served.dtype == np.float32
    assert np.array_equal(served, ref)
    assert eng.stats()["pad_samples"] > 0  # the ragged tail really was padded


def test_each_bucket_builds_its_runner_once(params):
    eng = _engine(params)
    assert eng.warmup() == len(eng.batcher.exec_buckets())
    builds = eng.cache.stats()["compiles"]
    for wave in range(2):
        for n in (1, 2, 3, 4, 7):
            eng.serve(synth_requests(GRAPH, n, seed=100 + 10 * wave + n, device="cpu"))
    stats = eng.stats()
    assert stats["compiles"] == builds == len({plan_key(b, eng.plan)
                                               for b in eng.batcher.exec_buckets()})
    assert stats["hits"] > 0 and stats["replans"] == 0


def test_plan_cache_lru_counters():
    cache = PlanCache(max_entries=2)
    made = []
    for key in ("a", "b", "a", "c", "b"):
        cache.get_or_compile(key, None, lambda k=key: made.append(k) or k)
    assert made == ["a", "b", "c", "b"]
    assert cache.stats() == {"entries": 2, "compiles": 4, "hits": 1, "misses": 4,
                             "evictions": 2}


def test_batcher_buckets_and_min_bucket():
    assert bucket_sizes(8) == (1, 2, 4, 8)
    assert bucket_sizes(6) == (1, 2, 4, 6)
    clock = SimClock()
    b = MicroBatcher(max_batch=8, deadline_s=0.01, clock=clock)
    b.submit(1)
    clock.advance(0.02)
    assert b.ready().bucket == 2  # min_bucket=2: a lone request pads to 2


def test_batcher_never_exceeds_deadline_simulated_clock():
    clock = SimClock()
    deadline = 0.010
    b = MicroBatcher(max_batch=4, deadline_s=deadline, clock=clock)
    arrivals = [0.0, 0.001, 0.002, 0.015, 0.0151, 0.04, 0.08, 0.0805, 0.081,
                0.0815, 0.0816, 0.3]
    formed, i = {}, 0
    while len(formed) < len(arrivals):
        t_arr = arrivals[i] if i < len(arrivals) else None
        t_dl = b.next_deadline()
        if t_arr is not None and (t_dl is None or t_arr <= t_dl):
            clock.set(t_arr)
            b.submit(i, now=t_arr)
            i += 1
        else:
            clock.set(t_dl)
        while (batch := b.ready()) is not None:
            for r in batch.requests:
                formed[r.id] = (r.t_arrival, batch.t_formed)
    assert max(tf - ta for ta, tf in formed.values()) <= deadline + 1e-12


def test_replay_stream_is_deterministic_with_a_service_model(params):
    """Two identical SimClock replays with a fixed service-time model give
    identical logits and latencies, and every request meets its deadline."""
    runs = []
    for _ in range(2):
        eng = _engine(params, sim_service_s=0.002)
        res = replay_stream(eng, synth_requests(GRAPH, 6, seed=3, device="cpu"),
                            rate_rps=400.0)
        runs.append(sorted((r.id, r.latency_s, r.logits.tobytes()) for r in res))
        assert all(r.t_formed - r.t_arrival <= 0.005 + 1e-12 for r in res)
    assert runs[0] == runs[1]


def test_engine_replans_on_occupancy_drift(params):
    """Planned on half-dead requests, served fully-live ones: the EMA leaves
    the band and the engine re-plans the first layer to dense."""
    eng = _engine(params, occ_threshold=0.75)
    assert eng.plan.layers[0].impl == "ecr_pallas"
    live = synth_requests(GRAPH, 12, seed=9, dead_frac=0.0, device="cpu")
    for k in range(0, 12, 4):
        eng.serve(live[k:k + 4])
    assert eng.stats()["replans"] >= 1
    assert eng.plan.layers[0].impl == "dense"


def test_serve_cnn_end_to_end_on_cpu():
    summary = serve_cnn(model="vgg19", n_requests=6, rate=200.0, device="cpu")
    assert summary["requests"] == 6 and summary["model"] == "vgg-tiny"
    assert summary["plan"][0].startswith("ecr_pallas")
    assert summary["compiles"] == 3 and summary["throughput_rps"] > 0


def test_engine_int8_on_pruned_params_matches_run_plan(params):
    """Pruned to 0.3 and served at int8=True: the plan holds a bsr_int8
    layer, the engine's logits equal run_plan's on the same bucket bit for
    bit, and stats() reports the BSR and int8 placements. (bsr_int8 takes
    one patch scale over the whole batch, as in the reference, so a
    request's logits depend on the requests it is batched with: the check
    is per bucket.)"""
    from repro_torch.sparse_weights.prune import prune_graph_params

    pruned, rep = prune_graph_params(params, 0.3, GRAPH)
    assert rep.density <= 0.55
    eng = _engine(pruned, occ_threshold=0.75, int8=True)
    assert "bsr_int8" in [lp.impl for lp in eng.plan.layers]
    assert eng.plan.int8_report is not None
    imgs = synth_requests(GRAPH, 4, seed=11, device="cpu")  # one full bucket
    served = eng.serve(imgs)
    ref = run_plan(eng.plan, pruned, torch.stack(imgs)).numpy()
    assert np.array_equal(served, ref)
    stats = eng.stats()
    assert stats["plan_bsr"] >= 1 and stats["plan_int8"] >= 1


def test_serve_cnn_pruned_int8_end_to_end_on_cpu():
    summary = serve_cnn(model="vgg19", n_requests=8, rate=200.0,
                        prune_density=0.3, int8=True, device="cpu")
    assert summary["requests"] == 8
    assert 0.0 < summary["prune_density"] <= 0.55
    assert summary["plan_bsr"] >= 1 and summary["plan_int8"] >= 1
    assert summary["plan"][0].startswith("bsr_int8")


def test_serve_cnn_cli_pruned_int8_on_cpu(monkeypatch, caplog):
    """`python -m repro_torch.launch.serve_cnn --device cpu --prune-density
    0.3 --int8` logs the prune report, the int8 probe and a bsr_int8 plan."""
    import logging
    import sys

    from repro_torch.launch import serve_cnn as launcher

    monkeypatch.setattr(sys, "argv", ["serve_cnn", "--device", "cpu", "--prune-density",
                                      "0.3", "--int8", "--n-requests", "4"])
    with caplog.at_level(logging.INFO, logger="repro_torch.serve_cnn"):
        launcher.main()
    assert "pruned to 0.30 achieved block density" in caplog.text
    assert "int8 probe:" in caplog.text
    assert "vgg-tiny plan: conv1=bsr_int8@" in caplog.text
    assert "served 4 requests" in caplog.text
