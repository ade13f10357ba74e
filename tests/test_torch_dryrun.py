"""The port's dry run (`repro_torch.launch.dryrun`) against the JAX
package's (`repro.launch.dryrun`).

The reference's sharded dry run does not run on the host's JAX (its
`run_cell` records "The spec of NamedSharding passed to
with_sharding_constraint can only refer to Auto axes of the mesh", the
failure behind `test_distributed.py`), so its records cannot be held
against the port's. What is held:

- `run_overrides`, `model_flops` and `analytic_flash_bytes` equal the
  reference's (rel 1e-12) for every arch but vgg19-sparse and every shape
  in `SHAPES` (each package's own parameter count, the reference's taken
  once per arch and kept);
- the reference's mini dry run (`test_distributed.py::
  test_mini_dryrun_train_step_shards`), re-targeted: reduced qwen3-0.6b,
  `ShapeConfig("t", 64, 8, "train")`, grad_accum 2, remat full, on a fake
  (4, 2) world in a subprocess. Status ok; all-gathers and reduce-scatters
  counted; the state's argument bytes equal the summed shard bytes of the
  port's spec trees; the rank's FLOPs lie between 6 N T and
  1.1 (8 N T + A), with T the tokens of this rank's rows (8 x 64 / 4 data
  ranks), N the parameters and A = 16 B S^2 H hd L the plain attention's
  full S x S scores and P.V of B = 2 rows over L layers, run twice forward
  (remat full) and once backward (twice the forward's);
- one full-width cell in a subprocess: qwen3-0.6b decode_32k on the 16x16
  fake world gives status ok and every field; arctic-480b train_4k is
  skipped with ROADMAP [29]'s reason.

Cost on one worker: ~45 s (the reference's parameter counts ~20 s, the two
subprocesses ~20 s).
"""
import json
import math
import os
import subprocess
import sys
import textwrap
from pathlib import Path

import pytest

torch = pytest.importorskip("torch")

# the reference's dryrun forces 512 host devices at import; the flag is read
# when JAX first starts a backend, so it is put back before that can happen
_SAVED_FLAGS = os.environ.get("XLA_FLAGS")
import repro.launch.dryrun as J  # noqa: E402

if _SAVED_FLAGS is None:
    os.environ.pop("XLA_FLAGS", None)
else:
    os.environ["XLA_FLAGS"] = _SAVED_FLAGS

from repro.configs import SHAPES as J_SHAPES  # noqa: E402
from repro.configs import get_config as j_get_config  # noqa: E402
from repro_torch.configs.base import DEFAULT_RUN, SHAPES, ShapeConfig, get_config, list_archs  # noqa: E402
from repro_torch.launch import dryrun as D  # noqa: E402
from repro_torch.launch.steps import DTYPES  # noqa: E402
from repro_torch.models import model as M  # noqa: E402
from repro_torch.parallel import sharding as S  # noqa: E402
from repro_torch.parallel.api import axis_rules  # noqa: E402
from repro_torch.tree import state_leaves  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
ARCHS = [a for a in list_archs() if a != "vgg19-sparse"]


@pytest.fixture(scope="module")
def cached_reference_counts():
    """The reference's `count_params_analytic` (a jax.eval_shape of the
    whole model, ~1 s an arch) taken once per (arch, active_only)."""
    real = J.M.count_params_analytic
    memo = {}

    def counted(cfg, active_only=False):
        key = (cfg.name, active_only)
        if key not in memo:
            memo[key] = real(cfg, active_only=active_only)
        return memo[key]

    J.M.count_params_analytic = counted
    yield
    J.M.count_params_analytic = real


@pytest.mark.parametrize("arch", ARCHS)
def test_run_overrides_model_flops_and_flash_bytes_equal_the_reference(
        arch, cached_reference_counts):
    cfg, jcfg = get_config(arch), j_get_config(arch)
    assert set(SHAPES) == set(J_SHAPES)
    for name in SHAPES:
        shape, jshape = SHAPES[name], J_SHAPES[name]
        run, jrun = D.run_overrides(cfg, shape), J.run_overrides(jcfg, jshape)
        for f in ("moment_dtype", "grad_accum", "remat", "kv_cache_dtype"):
            assert getattr(run, f) == getattr(jrun, f), (name, f)
        got, want = D.model_flops(cfg, shape), J.model_flops(jcfg, jshape)
        assert got == pytest.approx(want, rel=1e-12), name
        got = D.analytic_flash_bytes(cfg, shape, run)
        want = J.analytic_flash_bytes(jcfg, jshape, jrun)
        assert got == pytest.approx(want, rel=1e-12), name


def _run(code: str, timeout: int = 300) -> dict:
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    r = subprocess.run([sys.executable, "-c", textwrap.dedent(code)], capture_output=True,
                       text=True, env=env, timeout=timeout)
    assert r.returncode == 0, r.stderr[-4000:]
    return json.loads(r.stdout.strip().splitlines()[-1])


class _Grid:
    """A stand-in mesh for `logical_spec`: axis names and sizes only."""

    def __init__(self, shape, names):
        self.axis_names, self.shape = names, dict(zip(names, shape))

    def count(self, axes):
        return math.prod(self.shape[a] for a in axes)


def _shard_bytes(shapes, specs, grid) -> int:
    total = 0
    for meta, spec in S.leaves_with_specs(shapes, specs):
        n = meta.numel()
        for entry in spec:
            axes = S.spec_axes(entry)
            if axes:
                n //= grid.count(axes)
        total += n * meta.element_size()
    return total


def test_mini_dryrun_train_step_shards():
    rec = _run("""
        import json
        from repro_torch.configs.base import DEFAULT_RUN, ShapeConfig, get_config
        from repro_torch.launch.dryrun import dry_run_cell, fake_world
        from repro_torch.parallel.api import ProcessMesh
        with fake_world(8):
            mesh = ProcessMesh((4, 2), ("data", "model"), device="cpu")
            rec = dry_run_cell(get_config("qwen3-0.6b", reduced=True),
                               ShapeConfig("t", 64, 8, "train"),
                               DEFAULT_RUN.replace(grad_accum=2, remat="full"), mesh)
        print(json.dumps(rec))
    """)
    assert rec["status"] == "ok", rec
    kinds = rec["collectives"]["bytes_by_kind"]
    assert kinds.get("all-gather", 0) > 0
    assert kinds.get("reduce-scatter", 0) + kinds.get("all-reduce", 0) > 0
    assert rec["collectives"]["total_bytes_native"] == rec["collectives"]["total_bytes"]

    cfg = get_config("qwen3-0.6b", reduced=True)
    run = DEFAULT_RUN.replace(grad_accum=2, remat="full")
    grid = _Grid((4, 2), ("data", "model"))
    with axis_rules(grid, fsdp=run.fsdp):
        pspec, pshapes = S.params_sharding(cfg, grid, DTYPES[run.param_dtype])
        ospec, oshapes = S.opt_sharding(cfg, grid, run, pshapes)
    state = _shard_bytes(pshapes, pspec, grid) + _shard_bytes(oshapes, ospec, grid)
    assert rec["argument_bytes"]["state"] == state
    batch = sum(t.numel() * t.element_size() for t in state_leaves(
        M.input_specs(cfg, ShapeConfig("t", 64, 8, "train"))))
    assert rec["memory_analysis"]["argument_size_in_bytes"] == state + batch
    assert rec["memory_analysis"]["temp_size_in_bytes"] > 0
    assert rec["row_groups"] == 4 and rec["n_chips"] == 8

    n, t = M.count_params_analytic(cfg), 8 * 64 // 4
    b, s, h, hd, layers = 2, 64, cfg.n_heads, cfg.resolved_head_dim, cfg.n_layers
    attention = 16 * b * s * s * h * hd * layers
    flops = rec["hlo_flops_per_device"]
    assert 6 * n * t <= flops <= 1.1 * (8 * n * t + attention), (flops, n, t, attention)
    assert rec["pallas_flash"]["attention_bytes_jnp"] > rec["pallas_flash"][
        "attention_bytes_kernel"] > 0


@pytest.fixture(scope="module")
def production_cells(tmp_path_factory):
    out = tmp_path_factory.mktemp("dryrun")
    _run(f"""
        import json
        from repro_torch.launch.dryrun import main
        for arch, shape in (("qwen3-0.6b", "decode_32k"), ("arctic-480b", "train_4k")):
            main(["--arch", arch, "--shape", shape, "--mesh", "single", "--out-dir", {str(out)!r}])
        print(json.dumps({{}}))
    """, timeout=600)
    return {p.name: json.loads(p.read_text()) for p in out.glob("*.json")}


def test_full_width_decode_cell_on_the_16x16_fake_world(production_cells):
    rec = production_cells["qwen3-0.6b__decode_32k__16x16.json"]
    assert rec["status"] == "ok", rec
    for f in ("n_chips", "grad_accum", "moment_dtype", "hlo_flops_per_device",
              "hlo_bytes_per_device", "collectives", "memory_analysis", "model_flops_global",
              "compute_term_s", "memory_term_s", "collective_term_s", "collective_term_raw_s",
              "dominant_term", "useful_flop_ratio", "pallas_flash", "trace_s"):
        assert f in rec, f
    assert rec["n_chips"] == 256 and rec["kv_cache_dtype"] == "int8"
    assert rec["hlo_flops_per_device"] > 0 and rec["hlo_bytes_per_device"] > 0
    assert rec["collectives"]["total_bytes"] > 0
    assert set(rec["memory_analysis"]) == {"argument_size_in_bytes", "output_size_in_bytes",
                                           "temp_size_in_bytes"}
    assert rec["dominant_term"] in ("compute", "memory", "collective")
    # ranks along "model" compute the same rows (ROADMAP [28])
    assert 0 < rec["useful_flop_ratio"] < 1 / 16


def test_routed_experts_on_data_ranks_are_skipped(production_cells):
    rec = production_cells["arctic-480b__train_4k__16x16.json"]
    assert rec["status"] == "skipped"
    assert "routes tokens to experts over the whole batch" in rec["reason"]
    assert "[29]" in rec["reason"]


def test_fake_world_refuses_a_group_already_up():
    with D.fake_world(2):
        with pytest.raises(RuntimeError, match="already up"):
            with D.fake_world(2):
                pass
