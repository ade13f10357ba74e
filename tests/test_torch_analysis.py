"""The port's static verifier (`repro_torch.analysis`) against the JAX
package's, mirroring tests/test_analysis.py (its Engine.hot_swap test waits
for the port's hot swap).

Plan-level checks (RPA2xx, RPA301): the same corruption of the same plan
(the JAX package's weights and calibration images carried across, each
package planning them) gives the same code set in both packages. Launch
checks (RPA1xx) are the card's, so they are tested on the port's own
geometry: the CUDA grid, the kernels' tile choice mirrored in Python
(`kernels.tiles.f32_conv_tile` / `i8_conv_tile`) and the 227 KB of shared
memory a block may ask for. Clean plans across the zoo verify clean, and
the planner, `validate_plan` / `run_plan` and the plan cache refuse an
erroring plan."""
import json
from dataclasses import replace

import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.analysis import CODES as J_CODES  # noqa: E402
from repro.analysis import schedule_ok as j_schedule_ok  # noqa: E402
from repro.analysis import verify_plan as j_verify_plan  # noqa: E402
from repro.graph import init_graph as j_init_graph  # noqa: E402
from repro.graph.ir import ConvSpec as JConvSpec  # noqa: E402
from repro.launch.serve_cnn import serving_graph as j_serving_graph  # noqa: E402
from repro.launch.serve_cnn import synth_requests as j_synth  # noqa: E402
from repro.models.cnn import shift_dead_channels as j_shift  # noqa: E402
from repro.pipeline.planner import plan_network as j_plan_network  # noqa: E402
from repro.sparse_weights import prune_graph_params as j_prune  # noqa: E402
from repro_torch.analysis import (  # noqa: E402
    CODES,
    PlanVerificationError,
    check_launch_descriptor,
    check_schedule,
    schedule_ok,
    verify_plan,
)
from repro_torch.analysis.diagnostics import DiagnosticSink, errors  # noqa: E402
from repro_torch.configs.alexnet import ALEXNET  # noqa: E402
from repro_torch.configs.lenet import LENET  # noqa: E402
from repro_torch.configs.vgg19_sparse import CNNConfig, vgg19_graph  # noqa: E402
from repro_torch.convert import params_from_jax  # noqa: E402
from repro_torch.graph.ir import ConvSpec  # noqa: E402
from repro_torch.graph.registry import fusion_eligible, unit_launch  # noqa: E402
from repro_torch.kernels.conv_pool.ops import conv_pool_launch  # noqa: E402
from repro_torch.kernels.ecr_conv.ops import ecr_conv_launch  # noqa: E402
from repro_torch.kernels.tiles import CUDA_MAX_SMEM, TileConfig  # noqa: E402
from repro_torch.launch.serve_cnn import serving_graph  # noqa: E402
from repro_torch.pipeline.planner import plan_network, run_plan  # noqa: E402
from repro_torch.quant.ops import ecr_conv_int8_launch  # noqa: E402
from repro_torch.sparse_weights.conv import bsr_conv_launch  # noqa: E402

_SETUPS: dict = {}


def _setup(model, prune=None, int8=False, seed=0):
    """Both packages' plans of one zoo model on the JAX package's weights and
    calibration images: ((j_plan, j_params), (plan, params, calib))."""
    key = (model, prune, int8)
    if key not in _SETUPS:
        jg = j_serving_graph(model)
        jp = j_shift(j_init_graph(jax.random.PRNGKey(seed), jg))
        calib = jnp.stack(j_synth(jg, 2, seed=seed + 1))
        if prune is not None:
            jp, _ = j_prune(jp, prune, jg, probe=calib)
        jplan = j_plan_network(jp, calib, jg, int8=int8)
        tp = params_from_jax(jax.tree_util.tree_map(np.asarray, jp), device="cpu")
        tcalib = torch.from_numpy(np.array(calib))
        plan = plan_network(tp, tcalib, serving_graph(model), int8=int8)
        assert [(lp.kind, lp.impl) for lp in plan.layers] == \
            [(lp.kind, lp.impl) for lp in jplan.layers]
        _SETUPS[key] = ((jplan, jp), (plan, tp, tcalib))
    return _SETUPS[key]


@pytest.fixture(scope="module")
def lenet():
    return _setup("lenet")


def _codes(diags):
    return {d.code for d in diags}


def _first(plan, **changes):
    return replace(plan, layers=(replace(plan.layers[0], **changes),) + plan.layers[1:])


# ---------------------------------------------------------------------------
# clean plans verify clean (zoo sweep, dense and pruned + int8)
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("model", ["lenet", "alexnet", "vgg19"])
def test_clean_plan_verifies_clean(model):
    (jplan, jp), (plan, tp, calib) = _setup(model)
    assert verify_plan(plan, tp, batch=int(calib.shape[0])) == []
    assert j_verify_plan(jplan, jp, batch=2) == []


def test_clean_pruned_int8_plan_verifies_clean():
    (jplan, jp), (plan, tp, calib) = _setup("lenet", prune=0.3, int8=True)
    assert {lp.impl for lp in plan.layers} & {"bsr", "bsr_int8", "ecr_int8"}
    assert verify_plan(plan, tp, batch=int(calib.shape[0])) == []


def test_every_code_documented_and_tested():
    assert set(CODES) == set(J_CODES) == {
        "RPA101", "RPA102", "RPA103", "RPA104", "RPA105",
        "RPA201", "RPA202", "RPA203", "RPA204", "RPA205", "RPA206",
        "RPA207", "RPA208", "RPA209", "RPA301", "RPA901",
    }
    assert {c: sev for c, (sev, _) in CODES.items()} == \
        {c: sev for c, (sev, _) in J_CODES.items()}
    assert "shared-memory" in CODES["RPA103"][1]


# ---------------------------------------------------------------------------
# launch geometry on the card (RPA101-RPA105): corrupt a field, re-check
# ---------------------------------------------------------------------------


def _conv_launch(**kw):
    return ecr_conv_launch(16, 12, 12, 32, 3, 3, **kw)


def test_clean_launches_check_clean():
    assert check_launch_descriptor(_conv_launch(batch=4)) == []
    assert check_launch_descriptor(_conv_launch(batch=4, block_o=64)) == []
    assert check_launch_descriptor(conv_pool_launch(16, 12, 12, 32, pool=2)) == []
    assert check_launch_descriptor(bsr_conv_launch(32, 144, 100)) == []
    assert check_launch_descriptor(ecr_conv_int8_launch(16, 12, 12, 32)) == []


@pytest.mark.parametrize("graph", [vgg19_graph(CNNConfig()), LENET, ALEXNET],
                         ids=["vgg19", "lenet5", "alexnet"])
@pytest.mark.parametrize("batch", [1, 2, 8])
def test_every_zoo_geometry_has_a_tile_that_fits(graph, batch):
    """The mirrored tile choice finds a spatial tile for every full-width
    layer at every kernel impl, its grid covers the output once, and its
    shared memory fits the card."""
    for unit in graph.units():
        for kind, impl in (("conv", "ecr_pallas"), ("conv_pool", "pecr_pallas"),
                           ("conv", "ecr_int8"), ("conv", "bsr"), ("conv", "bsr_int8")):
            if kind == "conv_pool" and not fusion_eligible(unit):
                continue
            L = unit_launch(kind, impl, unit, batch=batch)
            assert check_launch_descriptor(L) == [], (unit.index, impl)
            if impl not in ("bsr", "bsr_int8"):
                assert 0 < L.smem_bytes <= CUDA_MAX_SMEM
                assert L.grid[2] == batch and L.grid[0] * L.grid[1] > 0


def test_rpa101_grid_mismatch_conv():
    good = _conv_launch()
    for bad in (replace(good, n_cb=3),  # 16 channels / block 8 needs 2
                replace(good, c_pad=5),  # pad no longer minimal
                replace(good, tiles=good.tiles + 1),  # spatial tiles overlap
                replace(good, th=good.tm),  # th x tw no longer fits TM positions
                replace(good, o_tiles=good.o_tiles + 1),
                replace(good, tn=96),  # no such output tile
                replace(ecr_conv_launch(16, 12, 12, 64, block_o=64), tn=128)):  # not honoured
        assert "RPA101" in _codes(check_launch_descriptor(bad)), bad


def test_rpa101_grid_mismatch_bsr():
    good = bsr_conv_launch(32, 144, 100)
    for bad in (replace(good, nt=good.nt + 1),
                replace(good, bf=good.bf * 2),  # schedule at one block, kernel at another
                replace(good, bt=16)):  # the kernels' row block is 8
        assert "RPA101" in _codes(check_launch_descriptor(bad)), bad


def test_rpa102_out_of_bounds_gather():
    assert "RPA102" in _codes(check_launch_descriptor(replace(_conv_launch(), stride=0)))
    # kernel taller than the input
    assert "RPA102" in _codes(check_launch_descriptor(replace(_conv_launch(), kh=13)))
    assert "RPA102" in _codes(check_launch_descriptor(
        replace(bsr_conv_launch(32, 144, 100), bf=0)))


def test_rpa103_shared_memory_budget():
    # a 64 x 64 kernel: even one output position's split halo is 512 KB,
    # so the kernel's own choice finds no tile; that is a WARN
    big = ecr_conv_launch(8, 80, 80, 64, 64, 64)
    assert big.tn == 0 and big.smem_bytes == 0
    diags = check_launch_descriptor(big)
    assert [d.code for d in diags] == ["RPA103"] and diags[0].severity == "warn"
    big8 = ecr_conv_int8_launch(8, 100, 100, 64, 80, 80)
    diags = check_launch_descriptor(big8)
    assert [d.code for d in diags] == ["RPA103"] and diags[0].severity == "warn"
    # a requested output tile that cannot fit is an ERROR
    asked = ecr_conv_launch(8, 80, 80, 64, 64, 64, block_o=64)
    assert asked.tn_req == 64
    diags = check_launch_descriptor(asked)
    assert [d.code for d in diags] == ["RPA103"] and diags[0].severity == "error"
    # a record whose shared memory disagrees with its tile, and a BSR
    # schedule whose union outgrows the block's shared memory
    assert "RPA103" in _codes(check_launch_descriptor(
        replace(_conv_launch(), smem_bytes=CUDA_MAX_SMEM + 1)))
    wide = bsr_conv_launch(32, 8 * 40_000, 10, tile=TileConfig(bf=8))
    assert wide.smem_bytes > CUDA_MAX_SMEM
    assert [d.code for d in check_launch_descriptor(wide)] == ["RPA103"]


def test_rpa104_int8_contract():
    good = ecr_conv_int8_launch(16, 12, 12, 32)
    assert (good.acc_dtype, good.weight_scales) == ("int32", "per_output_channel")
    assert "RPA104" in _codes(check_launch_descriptor(replace(good, acc_dtype="float32")))
    assert "RPA104" in _codes(check_launch_descriptor(replace(good, weight_scales="none")))
    bsr8 = bsr_conv_launch(32, 144, 100, dtype_bytes=1)
    assert check_launch_descriptor(bsr8) == []
    assert "RPA104" in _codes(check_launch_descriptor(replace(bsr8, acc_dtype="float32")))


def test_rpa105_fused_pool_inexact():
    good = conv_pool_launch(16, 12, 12, 32, pool=2)  # oh=ow=10, 2 divides
    assert check_launch_descriptor(good) == []
    bad = replace(good, pool=3)  # 10 % 3 != 0: the kernel would floor
    assert "RPA105" in _codes(check_launch_descriptor(bad))


# ---------------------------------------------------------------------------
# plan invariants (RPA201-RPA209, RPA301): the reference's code set
# ---------------------------------------------------------------------------


def _same_codes(port_diags, ref_diags):
    assert _codes(port_diags) == _codes(ref_diags)
    return port_diags


def test_rpa201_empty_plan(lenet):
    (jplan, _), (plan, _, _) = lenet
    diags = _same_codes(verify_plan(replace(plan, layers=())),
                        j_verify_plan(replace(jplan, layers=())))
    assert _codes(diags) == {"RPA201"} and "empty PipelinePlan" in diags[0].message


def test_rpa201_pre_ir_layer(lenet):
    (jplan, _), (plan, _, _) = lenet
    diags = _same_codes(verify_plan(_first(plan, conv=ConvSpec(0))),
                        j_verify_plan(_first(jplan, conv=JConvSpec(0))))
    assert "RPA201" in _codes(diags)
    assert any("predates the LayerGraph IR" in d.message for d in diags)


def test_rpa201_plan_graph_mismatch(lenet):
    (jplan, _), (plan, _, _) = lenet
    diags = _same_codes(verify_plan(replace(plan, graph=serving_graph("alexnet"))),
                        j_verify_plan(replace(jplan, graph=j_serving_graph("alexnet"))))
    assert "RPA201" in _codes(diags)
    assert any("plan/graph mismatch" in d.message for d in diags)


def test_rpa202_graph_fails_shape_inference(lenet):
    (jplan, _), (plan, _, _) = lenet
    # conv + ReLU only: no Flatten + dense head, so shape inference refuses
    diags = _same_codes(
        verify_plan(replace(plan, graph=replace(plan.graph, nodes=plan.graph.nodes[:2]))),
        j_verify_plan(replace(jplan, graph=replace(jplan.graph, nodes=jplan.graph.nodes[:2]))))
    assert "RPA202" in _codes(diags)


def test_rpa203_illegal_fusion(lenet):
    (jplan, _), (plan, _, _) = lenet
    # claim fusion on a unit with no pool; graph=None isolates the fusion check
    bad = replace(_first(plan, kind="conv_pool", impl="pecr_pallas", pool=None), graph=None)
    jbad = replace(_first(jplan, kind="conv_pool", impl="pecr_pallas", pool=None), graph=None)
    assert "RPA203" in _codes(_same_codes(verify_plan(bad), j_verify_plan(jbad)))


def test_rpa204_nonconforming_tile_is_warn(lenet):
    (jplan, jp), (plan, tp, _) = lenet
    tile = TileConfig(block_c=1000)
    diags = verify_plan(_first(plan, impl="ecr_pallas", tile=tile), tp, batch=2)
    from repro.kernels.tiles import TileConfig as JTileConfig

    _same_codes(diags, j_verify_plan(
        _first(jplan, impl="ecr_pallas", tile=JTileConfig(block_c=1000)), jp, batch=2))
    assert "RPA204" in _codes(diags) and errors(diags) == []
    # the card's own rules: an output tile the fp32 kernel does not take,
    # any output tile on the int8 kernel, a BSR row block other than 8, a bd
    for impl, t in (("ecr_pallas", TileConfig(block_o=32)),
                    ("ecr_int8", TileConfig(block_o=64)),
                    ("bsr", TileConfig(bt=16)), ("bsr", TileConfig(bd=64))):
        bad = _first(plan, impl=impl, tile=t, weight_density=1.0)
        if impl == "ecr_int8":
            bad = replace(bad, int8_report=type("R", (), {"layers": (0,)})())
        diags = verify_plan(bad, tp, batch=2)
        assert _codes(diags) == {"RPA204"} and errors(diags) == [], (impl, t)


def test_rpa205_density_mismatch(lenet):
    (jplan, jp), (plan, tp, _) = lenet
    diags = _same_codes(  # params are unpruned
        verify_plan(_first(plan, kind="conv", impl="bsr", weight_density=0.3), tp, batch=2),
        j_verify_plan(_first(jplan, kind="conv", impl="bsr", weight_density=0.3), jp, batch=2))
    assert "RPA205" in _codes(diags)
    assert any("weight block density" in d.message for d in diags)


def test_rpa206_int8_without_report(lenet):
    (jplan, _), (plan, _, _) = lenet
    diags = _same_codes(verify_plan(replace(_first(plan, impl="ecr_int8"), int8_report=None)),
                        j_verify_plan(replace(_first(jplan, impl="ecr_int8"), int8_report=None)))
    rpa206 = [d for d in diags if d.code == "RPA206"]
    assert rpa206 and rpa206[0].severity == "warn"


def test_rpa208_unknown_impl(lenet):
    (jplan, _), (plan, _, _) = lenet
    diags = _same_codes(verify_plan(_first(plan, impl="nope")),
                        j_verify_plan(_first(jplan, impl="nope")))
    assert "RPA208" in _codes(diags)


def test_rpa209_field_sanity(lenet):
    (jplan, _), (plan, _, _) = lenet
    for changes in ({"occupancy": 1.5}, {"weight_density": -0.1}):
        assert "RPA209" in _codes(_same_codes(verify_plan(_first(plan, **changes)),
                                              j_verify_plan(_first(jplan, **changes))))
    assert "RPA209" in _codes(_same_codes(verify_plan(replace(plan, block_c=-1)),
                                          j_verify_plan(replace(jplan, block_c=-1))))


def test_rpa301_params_mismatch(lenet):
    (jplan, jp), (plan, tp, _) = lenet
    dropped = {"conv": tp["conv"][:-1], "dense": tp["dense"]}
    diags = _same_codes(verify_plan(plan, dropped),
                        j_verify_plan(jplan, {"conv": jp["conv"][:-1], "dense": jp["dense"]}))
    assert "RPA301" in _codes(diags)
    assert any("silently truncate" in d.message for d in diags)
    w0, jw0 = tp["conv"][0], jp["conv"][0]  # wrong C_in on one weight
    widened = {"conv": [torch.cat([w0, w0], dim=1)] + list(tp["conv"][1:]),
               "dense": tp["dense"]}
    jwidened = {"conv": [jnp.concatenate([jw0, jw0], axis=1)] + list(jp["conv"][1:]),
                "dense": jp["dense"]}
    assert "RPA301" in _codes(_same_codes(verify_plan(plan, widened),
                                          j_verify_plan(jplan, jwidened)))


# ---------------------------------------------------------------------------
# schedules (RPA207) + the run-time guard
# ---------------------------------------------------------------------------


def test_rpa207_schedule_invariants():
    ids = np.array([0, 1, 2, 0], np.int32)
    cases = [(ids, 3, 4, True), (ids[:3], 3, 3, True), (ids, 5, 4, False),
             (np.array([0, 9, 2, 0]), 3, 4, False),  # id out of range
             (np.array([0, 0, 2, 0]), 3, 4, False),  # repeated id
             (np.array([2, 0, 1, 0]), 3, 4, False),  # unsorted
             (np.array([1, 3, 1, 1]), 2, 4, True),  # padding is unconstrained
             (np.array([[0, 1, 0], [1, 2, 1]], np.int32), np.array([2, 2]), 3, True)]
    for i, c, n, ok in cases:
        assert schedule_ok(i, c, n) == ok == j_schedule_ok(i, c, n)
        assert schedule_ok(torch.from_numpy(np.array(i)), torch.as_tensor(np.array(c)), n) == ok
    sink = DiagnosticSink()
    check_schedule(np.array([[0, 1, 0], [1, 2, 1]], np.int32), np.array([2, 4]), 3, sink,
                   layer=1)
    assert [d.code for d in sink.items] == ["RPA207"] and sink.items[0].layer == 1


def test_guard_schedule_off_by_default():
    from repro_torch.kernels.schedule_guard import guard_schedule, schedules_checked

    assert not schedules_checked()
    ids = torch.tensor([7, 0, 0], dtype=torch.int32)
    out_ids, _ = guard_schedule(ids, torch.tensor(9, dtype=torch.int32), 3)
    assert out_ids is ids  # identity: the hot path is untouched


def test_guard_schedule_clamps_when_enabled(monkeypatch):
    monkeypatch.setenv("REPRO_CHECK_SCHEDULES", "1")
    from repro_torch.kernels.schedule_guard import guard_schedule, schedules_checked

    assert schedules_checked()
    ids, cnt = guard_schedule(torch.tensor([-1, 7, 2], dtype=torch.int32),
                              torch.tensor(9, dtype=torch.int32), 3)
    assert ids.tolist() == [0, 2, 2] and int(cnt) == 3
    ids, cnt = guard_schedule(torch.tensor([0, 2, 1], dtype=torch.int32),
                              torch.tensor(2, dtype=torch.int32), 3)
    assert ids.tolist() == [0, 2, 1] and int(cnt) == 2


def test_guarded_ops_stay_exact(monkeypatch):
    monkeypatch.setenv("REPRO_CHECK_SCHEDULES", "1")
    from repro_torch.core.ecr import conv2d_dense
    from repro_torch.kernels.ecr_conv.ops import ecr_conv

    g = torch.Generator().manual_seed(0)
    x = torch.rand((8, 10, 10), generator=g)
    x[4:] = 0.0
    w = torch.randn((8, 8, 3, 3), generator=g)
    torch.testing.assert_close(ecr_conv(x, w), conv2d_dense(x, w, 1), rtol=0, atol=1e-5)


# ---------------------------------------------------------------------------
# dead imports (RPA901)
# ---------------------------------------------------------------------------


def test_rpa901_dead_imports(tmp_path):
    from pathlib import Path

    from repro_torch.analysis.deadcode import check_dead_imports, dead_modules

    src = Path(__file__).resolve().parents[1] / "src"
    dead, _ = dead_modules(src)
    assert "repro_torch.launch.train" in dead  # the LM trainer is not on the CNN spine
    assert not any(m.split(".")[0] == "repro" for m in dead)  # only the port is walked
    for mod in ("repro_torch.pipeline.planner", "repro_torch.serving.engine",
                "repro_torch.kernels.ecr_conv.ops", "repro_torch.analysis.plan",
                "repro_torch.core.pecr"):
        assert mod not in dead
    # a planted module nothing imports trips RPA901; one imported lazily does not
    pkg = tmp_path / "repro_torch"
    (pkg / "launch").mkdir(parents=True)
    (pkg / "analysis").mkdir()
    for init in (pkg, pkg / "launch", pkg / "analysis"):
        (init / "__init__.py").write_text("")
    (pkg / "launch" / "serve_cnn.py").write_text(
        "def main():\n    from repro_torch import used\n")
    (pkg / "analysis" / "cli.py").write_text("import json\n")
    (pkg / "used.py").write_text("")
    (pkg / "planted.py").write_text("import os\n")
    sink = DiagnosticSink()
    check_dead_imports(tmp_path, sink)
    assert [d.message.split()[0] for d in sink.items] == ["repro_torch.planted"]
    assert all(d.code == "RPA901" and d.severity == "info" for d in sink.items)


# ---------------------------------------------------------------------------
# hook points: plan_network, validate_plan / run_plan, PlanCache
# ---------------------------------------------------------------------------


def test_validate_plan_raises_value_error(lenet):
    _, (plan, tp, calib) = lenet
    with pytest.raises(ValueError, match="RPA208"):
        run_plan(_first(plan, impl="nope"), tp, calib)
    # a BSR plan run on params of another density is refused (RPA205)
    with pytest.raises(PlanVerificationError, match="RPA205"):
        run_plan(_first(plan, kind="conv", impl="bsr", weight_density=0.3), tp, calib)


def test_plan_network_verifies_before_returning(lenet):
    # planning against params missing a conv layer must raise, not emit a
    # broken plan (the zip inside planning would silently truncate)
    _, (plan, tp, calib) = lenet
    dropped = {"conv": tp["conv"][:-1], "dense": tp["dense"]}
    with pytest.raises(PlanVerificationError):
        plan_network(dropped, calib, plan.graph)


def test_plan_cache_refuses_erroring_plan(lenet):
    from repro_torch.serving import PlanCache, plan_key

    _, (plan, _, _) = lenet
    cache = PlanCache()
    built = []
    with pytest.raises(PlanVerificationError):
        cache.get_or_compile(plan_key(2, plan), _first(plan, impl="nope"),
                             lambda: built.append(1) or "exe")
    assert built == []  # the runner was never built
    assert cache.get_or_compile(plan_key(2, plan), plan, lambda: "exe") == "exe"
    assert cache.get_or_compile(plan_key(4, plan), None, lambda: "exe2") == "exe2"


# ---------------------------------------------------------------------------
# the CLI
# ---------------------------------------------------------------------------


def test_cli_clean_zoo_json(capsys):
    from repro_torch.analysis.cli import main

    rc = main(["--device", "cpu", "--json"])
    doc = json.loads(capsys.readouterr().out)
    assert rc == 0 and doc["n_errors"] == 0
    assert [r["model"] for r in doc["reports"]] == ["vgg-tiny", "lenet-tiny", "alexnet-tiny"]
    assert all(r["plan"]["layers"] for r in doc["reports"])


def test_cli_dead_imports(capsys):
    from repro_torch.analysis.cli import main

    rc = main(["--device", "cpu", "--model", "lenet", "--dead-imports", "--json"])
    doc = json.loads(capsys.readouterr().out)
    assert rc == 0  # infos never fail the lint
    repo = [r for r in doc["reports"] if r["model"] == "<repo>"][0]
    assert any(d["code"] == "RPA901" and "repro_torch.launch.train" in d["message"]
               for d in repo["diagnostics"])


def test_cli_pruned_int8(capsys):
    from repro_torch.analysis.cli import main

    rc = main(["--device", "cpu", "--model", "lenet", "--prune-density", "0.3", "--int8",
               "--json"])
    doc = json.loads(capsys.readouterr().out)
    assert rc == 0 and doc["n_errors"] == 0
