"""Distributed training on the port, on the host, against the JAX package:
the abstract trees, the sharding trees, the collectives, the sharded
trainer, elastic re-meshing, GPipe, `sharding_for` / `shard` and the
meshes.

Rank processes are spawned over gloo on the CPU by
`tests/_torch_distributed_ranks.py`, once per group for the whole module:
4 ranks run the trainer, elastic, launcher and pipeline cases, 16 ranks the
collectives. The reference's sharded step and `pipeline_apply` do not run
on the host's JAX (its 4 failing `test_distributed.py` tests), so the port
is held to the reference's spec trees (its `logical_spec` composed over its
abstract trees, checked once against its own `params_sharding` /
`opt_sharding` in a subprocess with 16 forced host devices, where its
`compressed_psum` / `bucketed_psum` also run under `shard_map`), to its
single-device `make_train_step` (GSPMD preserves semantics), and to the
contracts its tests state.

Tolerances:
- trees, specs and shapes: equal;
- collectives against the reference: 1e-6 * max|ref| + 1e-6 (fp32 sums in
  another order); stochastic rounding: within 5% of the exact sum, the
  reference test's bound;
- sharded trainer against the port's unsharded one: fp32 loss, grad norm
  1e-5 relative and every gathered leaf 1e-5 * max|leaf| + 1e-6; bf16 the
  limits below; each leaf's change over the run (warmup 0: every step at
  the peak rate) in norm, fp32 1e-4 and bf16 0.2 of the unsharded change's
  (`_deltas_close`; bf16 rounds an update of 2 to 3 ulps, so single
  elements flip an ulp);
- against the reference's single-device step (PERF.md section 2): fp32 loss
  1e-4 and grad norm 1e-3 relative, leaves 1e-3 * max|leaf| + 1e-6; bf16
  1e-2 / 3e-2 / 5e-2; each leaf's change in norm, fp32 1e-3, bf16 0.2;
- GPipe: output within 2e-4 of the sequential product (the reference
  test's limit), stage gradients within 2e-4 of autograd's.

Cost on one worker: ~48 s alone, 84 s inside the whole suite at 6
workers (the two rank groups run while the reference's steps compile).
"""
import json
import os
import subprocess
import sys
import textwrap
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.configs import DEFAULT_RUN as J_DEFAULT_RUN  # noqa: E402
from repro.configs import ShapeConfig as JShapeConfig  # noqa: E402
from repro.configs import get_config as j_get_config  # noqa: E402
from repro.data import make_pipeline as j_make_pipeline  # noqa: E402
from repro.launch.steps import init_train_state as j_init_train_state  # noqa: E402
from repro.launch.steps import make_train_step as j_make_train_step  # noqa: E402
from repro.models import model as JM  # noqa: E402
from repro.parallel.api import axes_leaves as j_axes_leaves  # noqa: E402
from repro.parallel.api import axis_rules as j_axis_rules  # noqa: E402
from repro.parallel.api import logical_spec as j_logical_spec  # noqa: E402
from repro.parallel.pipeline import split_stages as j_split_stages  # noqa: E402
from repro.parallel.sharding import _BATCH_AXES as J_BATCH_AXES  # noqa: E402
from repro_torch.checkpoint import CheckpointManager  # noqa: E402
from repro_torch.configs.base import DEFAULT_RUN, ShapeConfig, get_config, list_archs  # noqa: E402
from repro_torch.convert import lm_params_from_jax  # noqa: E402
from repro_torch.launch.mesh import (  # noqa: E402
    backend_for,
    make_host_mesh,
    make_production_mesh,
)
from repro_torch.launch.train import train  # noqa: E402
from repro_torch.models import model as M  # noqa: E402
from repro_torch.parallel import (  # noqa: E402
    Mesh,
    ProcessMesh,
    axes_leaves,
    axis_rules,
    shard,
    sharding_for,
    split_stages,
)
from repro_torch.parallel import sharding as S  # noqa: E402
from repro_torch.runtime import rebalance_grad_accum, shrink_mesh  # noqa: E402
from repro_torch.tree import state_leaves, tree_leaves, tree_map  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
RANKS = ROOT / "tests" / "_torch_distributed_ranks.py"
CPU = torch.device("cpu")
ARCHS = [a for a in list_archs() if get_config(a).family != "cnn"]
TRAIN_ARCH = "qwen3-0.6b"
TRAIN_MESHES = ((4, 1), (2, 2), (1, 4))
STEPS, SEQ, BATCH = 3, 32, 8  # as the rank worker runs them
LIMITS = {"float32": (1e-4, 1e-3, 1e-3), "bfloat16": (1e-2, 3e-2, 5e-2)}
# each leaf's change over the run, in norm (`_deltas_close`): against the
# port's unsharded trainer, and against the reference's step
DELTA_LIMITS = {"float32": (1e-4, 1e-3), "bfloat16": (0.2, 0.2)}


def _env():
    return dict(os.environ, PYTHONPATH=os.pathsep.join([str(ROOT / "src"), str(ROOT)]))


def _spawn(kind: str, inp: Path, out: Path) -> subprocess.Popen:
    out.mkdir(parents=True, exist_ok=True)
    return subprocess.Popen([sys.executable, str(RANKS), kind, str(inp), str(out)],
                            env=_env(), stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                            text=True)


def _wait(proc: subprocess.Popen, timeout: int = 300) -> None:
    out, _ = proc.communicate(timeout=timeout)
    assert proc.returncode == 0, out[-4000:]


def _rel(got, want) -> float:
    return abs(got - want) / max(abs(want), 1e-12)


def _leaf_err(got, want) -> tuple:
    g = np.asarray(got.float() if isinstance(got, torch.Tensor) else got, np.float64)
    w = np.asarray(want.float() if isinstance(want, torch.Tensor) else want, np.float64)
    assert g.shape == w.shape
    return float(np.abs(g - w).max()), float(np.abs(w).max())


def _trees_close(got: dict, want: dict, rel: float, floor: float = 1e-6) -> None:
    """Two port trees, leaf by leaf: max|got - want| <= rel * max|want| + floor."""
    gl, wl = tree_leaves(got), tree_leaves(want)
    assert len(gl) == len(wl)
    for i, (g, w) in enumerate(zip(gl, wl)):
        err, scale = _leaf_err(g, w)
        assert err <= rel * scale + floor, (i, err, scale)


def _deltas_close(got: dict, want: dict, start: dict, rel: float) -> None:
    """The change each run made to each leaf from `start`, in norm:
    ||(got - start) - (want - start)|| <= rel * ||want - start||. A step
    that skips or misapplies a shard's update moves it by O(1); rounding
    flips single elements (an Adam step near a zero gradient), which a
    max-based bound on the change cannot absorb."""
    for i, (g, w, s) in enumerate(zip(tree_leaves(got), tree_leaves(want), tree_leaves(start))):
        s = s.double()
        dg, dw = g.double() - s, w.double() - s
        err, scale = float((dg - dw).norm()), float(dw.norm())
        assert err <= rel * scale, (i, err, scale)


def _stand_in(shape, axes) -> Mesh:
    """A mesh with the shape and names (all `logical_spec` reads), its
    slots on the host."""
    return Mesh(np.array([CPU] * int(np.prod(shape)), dtype=object).reshape(shape), axes)


# ---------------------------------------------------------------------------
# the module's rank groups and the reference's runs
# ---------------------------------------------------------------------------

REF16 = """
import json, sys
import jax, jax.numpy as jnp, numpy as np
from functools import partial
from jax.sharding import Mesh, PartitionSpec as P
from jax.experimental.shard_map import shard_map
from repro.configs import DEFAULT_RUN, get_config, list_archs
from repro.models import model as M
from repro.parallel import sharding as S
from repro.parallel.api import axes_leaves, axis_rules, logical_spec
from repro.parallel.collectives import bucketed_psum, compressed_psum
out = sys.argv[1]
devs = np.array(jax.devices())
bad = []
for arch in list_archs():
    cfg = get_config(arch, reduced=True)
    if cfg.family == "cnn":
        continue
    shapes, axes = M.abstract_params(cfg, jnp.bfloat16)
    for shp, names, fsdp in (((4, 2), ("data", "model"), True),
                             ((2, 2, 2), ("pod", "data", "model"), True),
                             ((4, 2), ("data", "model"), False)):
        mesh = Mesh(devs[:8].reshape(shp), names)
        with axis_rules(mesh, fsdp=fsdp):
            comp = [logical_spec(s.shape, a, mesh) for s, a in
                    zip(jax.tree_util.tree_leaves(shapes), axes_leaves(axes))]
            ps, pshapes = S.params_sharding(cfg, mesh, jnp.bfloat16)
            os_, _ = S.opt_sharding(cfg, mesh, DEFAULT_RUN, pshapes)
            own = [s.spec for s in jax.tree_util.tree_leaves(ps)]
            mom = [s.spec for s in jax.tree_util.tree_leaves(os_.m)]
            if own != comp or mom != comp or os_.step.spec != P():
                bad.append((arch, shp, fsdp))
x = np.random.default_rng(0).standard_normal((16, 64)).astype(np.float32)
mesh = Mesh(devs[:16].reshape(4, 4), ("pod", "data"))
spec = P(("pod", "data"), None)
res = {}
for name, ax in (("n4", "data"), ("n16", ("pod", "data"))):
    f = shard_map(partial(compressed_psum, axis_name=ax), mesh=mesh, in_specs=spec,
                  out_specs=spec, check_rep=False)
    res[name] = np.asarray(f(jnp.asarray(x)))
f = shard_map(lambda t: compressed_psum(t, "data", jax.random.fold_in(
    jax.random.PRNGKey(0), jax.lax.axis_index(("pod", "data")))), mesh=mesh,
    in_specs=spec, out_specs=spec, check_rep=False)
res["n4_sr"] = np.asarray(f(jnp.asarray(x)))
g = shard_map(lambda t: bucketed_psum(t, ("pod", "data")), mesh=mesh,
              in_specs=spec, out_specs=spec, check_rep=False)
tree = g({"a": jnp.asarray(x), "b": jnp.asarray(x[:, :16] * 2)})
res["bucket_a"], res["bucket_b"] = np.asarray(tree["a"]), np.asarray(tree["b"])
np.savez(out + "/ref16.npz", **res)
print(json.dumps({"spec_mismatches": [list(map(str, b)) for b in bad]}))
"""


@pytest.fixture(scope="module")
def groups(tmp_path_factory):
    """Starts the two rank groups and the reference's 16-device subprocess,
    runs the reference's single-device steps meanwhile, and returns
    (port results, reference results)."""
    tmp = tmp_path_factory.mktemp("dist")
    cfg, jcfg = get_config(TRAIN_ARCH, reduced=True), j_get_config(TRAIN_ARCH, reduced=True)
    key = jax.random.PRNGKey(0)
    j32 = j_init_train_state(jcfg, J_DEFAULT_RUN.replace(param_dtype="float32"), key)
    np_params = jax.tree_util.tree_map(np.asarray, j32.params)
    torch.save({"params": lm_params_from_jax(np_params, cfg, device="cpu")}, tmp / "in.pt")
    x16 = np.random.default_rng(0).standard_normal((16, 64)).astype(np.float32)
    torch.save({"x": torch.from_numpy(x16)}, tmp / "in16.pt")
    env = dict(_env(), XLA_FLAGS="--xla_force_host_platform_device_count=16")
    ref16 = subprocess.Popen([sys.executable, "-c", textwrap.dedent(REF16), str(tmp)],
                             env=env, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
    train_p = _spawn("train", tmp / "in.pt", tmp / "train")
    coll_p = _spawn("collectives", tmp / "in16.pt", tmp / "coll")

    # the reference's single-device step at each dtype and grad_accum
    ref = {}
    pipe = j_make_pipeline(jcfg, JShapeConfig("t", SEQ, BATCH, "train"), seed=0)
    jsteps = {}
    for dtype in LIMITS:
        for ga in (1, 2):
            run = J_DEFAULT_RUN.replace(param_dtype=dtype, remat="none", grad_accum=ga,
                                        warmup_steps=0)
            step = jsteps[(dtype, ga)] = jax.jit(j_make_train_step(jcfg, run, 10))
            state = j_init_train_state(jcfg, run, key)
            hist = []
            for s in range(STEPS):
                batch = {k: jnp.asarray(v) for k, v in pipe.batch_at(s).items()}
                state, m = step(state, batch)
                hist.append((float(m["loss"]), float(m["grad_norm"])))
            ref[(dtype, ga)] = {"hist": hist, "params": state.params}
    # elastic: a step at grad_accum 1, then one at 2 (the shrunken mesh's)
    state = j_init_train_state(jcfg, J_DEFAULT_RUN.replace(param_dtype="float32"), key)
    for s, ga in ((0, 1), (1, 2)):
        batch = {k: jnp.asarray(v) for k, v in pipe.batch_at(s).items()}
        state, m = jsteps[("float32", ga)](state, batch)
    ref["elastic"] = {"hist1": (float(m["loss"]), float(m["grad_norm"])),
                      "params": state.params}

    _wait(train_p)
    _wait(coll_p)
    out, err = ref16.communicate(timeout=300)
    assert ref16.returncode == 0, err[-4000:]
    ref["spec_mismatches"] = json.loads(out.strip().splitlines()[-1])["spec_mismatches"]
    ref["coll"] = dict(np.load(tmp / "ref16.npz"))
    port = torch.load(tmp / "train" / "train.pt", weights_only=False)
    port["init"] = torch.load(tmp / "in.pt", weights_only=False)["params"]
    port["elastic"] = [torch.load(tmp / "train" / f"elastic_{r}.pt", weights_only=False)
                       for r in range(4)]
    port["pipeline"] = [torch.load(tmp / "train" / f"pipeline_{r}.pt", weights_only=False)[16]
                        for r in range(4)]
    port["coll"] = [torch.load(tmp / "coll" / f"collectives_{r}.pt", weights_only=False)
                    for r in range(16)]
    return port, ref


# ---------------------------------------------------------------------------
# abstract trees
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("arch", ARCHS)
def test_abstract_params_and_axes_match_the_reference(arch):
    cfg, jcfg = get_config(arch, reduced=True), j_get_config(arch, reduced=True)
    assert axes_leaves(M.param_axes(cfg)) == j_axes_leaves(JM.param_axes(jcfg))
    for dt, jdt in ((torch.float32, jnp.float32), (torch.bfloat16, jnp.bfloat16)):
        shapes, axes = M.abstract_params(cfg, dt)
        jshapes, jaxes = JM.abstract_params(jcfg, jdt)
        got = [(tuple(t.shape), str(t.dtype).split(".")[-1], t.device.type)
               for t in tree_leaves(shapes)]
        want = [(tuple(s.shape), str(s.dtype), "meta")
                for s in jax.tree_util.tree_leaves(jshapes)]
        assert got == want
        assert axes_leaves(axes) == j_axes_leaves(jaxes)
    for active in (False, True):
        assert M.count_params_analytic(cfg, active) == JM.count_params_analytic(jcfg, active)


@pytest.mark.parametrize("kv", ["float32", "int8"])
@pytest.mark.parametrize("arch", ARCHS)
def test_abstract_cache_matches_the_reference(arch, kv):
    """Shapes and axes; dtypes for a float32 request (for int8 the port
    keeps fp32 recurrent state where the reference makes bf16, see
    `models.ssm.init_mamba_state`)."""
    cfg, jcfg = get_config(arch, reduced=True), j_get_config(arch, reduced=True)
    caches, axes = M.abstract_cache(cfg, 2, 16, getattr(torch, kv))
    jcaches, jaxes = JM.abstract_cache(jcfg, 2, 16, getattr(jnp, kv))
    got, want = state_leaves(caches), jax.tree_util.tree_leaves(jcaches)
    assert [tuple(t.shape) for t in got] == [tuple(s.shape) for s in want]
    assert all(t.device.type == "meta" for t in got)
    if kv == "float32":
        assert [str(t.dtype).split(".")[-1] for t in got] == [str(s.dtype) for s in want]
    assert axes_leaves(axes) == j_axes_leaves(jaxes)
    assert len(axes) == len(jaxes)
    assert [a is None for a in axes] == [a is None for a in jaxes]


@pytest.mark.parametrize("kind", ["train", "prefill", "decode"])
@pytest.mark.parametrize("arch", ARCHS)
def test_input_specs_match_the_reference(arch, kind):
    cfg, jcfg = get_config(arch, reduced=True), j_get_config(arch, reduced=True)
    got = M.input_specs(cfg, ShapeConfig("s", 64, 4, kind), torch.bfloat16)
    want = JM.input_specs(jcfg, JShapeConfig("s", 64, 4, kind), jnp.bfloat16)
    assert list(got) == list(want)
    for k in got:
        assert tuple(got[k].shape) == tuple(want[k].shape), k
        assert str(got[k].dtype).split(".")[-1] == str(want[k].dtype), k
        assert got[k].device.type == "meta"


# ---------------------------------------------------------------------------
# sharding trees
# ---------------------------------------------------------------------------

SPEC_MESHES = {"data4_model2": ((4, 2), ("data", "model"), True),
               "pod2_data2_model2": ((2, 2, 2), ("pod", "data", "model"), True),
               "data4_model2_no_fsdp": ((4, 2), ("data", "model"), False)}


def _compose(shapes, axes, mesh):
    return [tuple(j_logical_spec(s.shape, a, mesh))
            for s, a in zip(jax.tree_util.tree_leaves(shapes), j_axes_leaves(axes))]


def _specs(tree, specs):
    return [s for _, s in S.leaves_with_specs(tree, specs)]


@pytest.mark.parametrize("mesh_name", sorted(SPEC_MESHES))
@pytest.mark.parametrize("arch", ARCHS)
def test_spec_trees_match_the_reference(arch, mesh_name):
    """params / opt / cache / batch spec trees against the reference's
    `logical_spec` composed over its abstract trees, under its rules."""
    shape, names, fsdp = SPEC_MESHES[mesh_name]
    cfg, jcfg = get_config(arch, reduced=True), j_get_config(arch, reduced=True)
    mesh = _stand_in(shape, names)
    with axis_rules(mesh, fsdp=fsdp), j_axis_rules(mesh, fsdp=fsdp):
        pspec, pshapes = S.params_sharding(cfg, mesh, torch.bfloat16)
        want = _compose(*JM.abstract_params(jcfg, jnp.bfloat16), mesh)
        assert _specs(pshapes, pspec) == want
        ospec, oshapes = S.opt_sharding(cfg, mesh, DEFAULT_RUN, pshapes)
        assert ospec.step == () and tuple(oshapes.step.shape) == ()
        assert _specs(oshapes.m, ospec.m) == want == _specs(oshapes.v, ospec.v)
        assert all(t.dtype == torch.float32 for t in tree_leaves(oshapes.m))
        cspec, cshapes = S.cache_sharding(cfg, mesh, 8, 64, torch.bfloat16)
        assert _specs(cshapes, cspec) == _compose(*JM.abstract_cache(jcfg, 8, 64), mesh)
        for kind, b in (("train", 8), ("decode", 1)):
            got = S.batch_sharding(M.input_specs(cfg, ShapeConfig("s", 64, b, kind)), mesh)
            jspec = JM.input_specs(jcfg, JShapeConfig("s", 64, b, kind))
            assert got == {k: tuple(j_logical_spec(v.shape, J_BATCH_AXES[k], mesh))
                           for k, v in jspec.items()}


def test_reference_spec_trees_are_the_composition(groups):
    """In the 16-device subprocess: the reference's own `params_sharding` /
    `opt_sharding` equal its `logical_spec` composed over its abstract
    trees, for every arch on every mesh above (what the test above holds
    the port to)."""
    _, ref = groups
    assert ref["spec_mismatches"] == []


def test_sharding_for_and_shard():
    x = torch.ones(8, 6)
    assert sharding_for((8, 6), ("batch", "mlp")) is None
    assert shard(x, "batch") is x  # no mesh: no check
    mesh = _stand_in((4, 2), ("data", "model"))
    assert sharding_for((8, 6), ("batch", "mlp"), mesh) == ("data", "model")
    with axis_rules(mesh):
        assert sharding_for((8, 6), ("batch", "mlp")) == ("data", "model")
        assert sharding_for((8, 5), ("batch", "mlp")) == ("data", None)
        assert shard(x, "batch", "mlp") is x
        with pytest.raises(ValueError):
            shard(x, "batch")


# ---------------------------------------------------------------------------
# meshes
# ---------------------------------------------------------------------------


def test_meshes_without_a_process_group():
    """One process: the host mesh is (1, 1), every axis holds one rank (no
    group), the production meshes refuse the world, elastic refuses to drop
    the last data row; a mesh's default device is the card."""
    mesh = make_host_mesh(device="cpu")
    assert mesh.shape == {"data": 1, "model": 1} and mesh.coords == {"data": 0, "model": 0}
    assert mesh.member and mesh.backend is None and mesh.group("data") is None
    assert mesh.index(("data", "model")) == 0 and mesh.count("model") == 1
    for multi in (False, True):
        with pytest.raises(ValueError, match="ranks"):
            make_production_mesh(multi_pod=multi, device="cpu")
    with pytest.raises(ValueError):
        make_host_mesh(2, device="cpu")
    with pytest.raises(ValueError, match="below 1"):
        shrink_mesh(mesh)
    with pytest.raises(ValueError):
        ProcessMesh((2, 1), ("data", "model"), device="cpu")  # 2 ranks in a world of 1
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA"):
            make_host_mesh()
    assert backend_for("cpu", 4) == "gloo"
    cards = torch.cuda.device_count()
    assert backend_for("cuda", cards + 1) == "gloo"  # this host's ranks share a card
    if cards:
        assert backend_for("cuda", cards) == "nccl"
    with pytest.raises(ValueError, match="order"):
        mesh.count(("model", "data"))  # axes are named in the mesh's order


@pytest.mark.parametrize("env, cards, want", [
    ({"WORLD_SIZE": "16", "LOCAL_WORLD_SIZE": "8"}, 8, "nccl"),  # 2 hosts x 8 cards
    ({"WORLD_SIZE": "2", "LOCAL_WORLD_SIZE": "2"}, 1, "gloo"),  # 2 ranks on one card
    ({"WORLD_SIZE": "4"}, 4, "nccl"),  # one host, no LOCAL_WORLD_SIZE
    ({"WORLD_SIZE": "4"}, 2, "gloo"),
])
def test_init_distributed_counts_the_ranks_on_this_host(monkeypatch, env, cards, want):
    """The backend `init_distributed` starts is chosen from the ranks on
    this host (torchrun's LOCAL_WORLD_SIZE) against its cards, not from the
    world size."""
    import repro_torch.launch.mesh as mesh_mod

    for k in ("WORLD_SIZE", "LOCAL_WORLD_SIZE"):
        monkeypatch.delenv(k, raising=False)
    for k, v in env.items():
        monkeypatch.setenv(k, v)
    started = []
    monkeypatch.setattr(torch.cuda, "device_count", lambda: cards)
    monkeypatch.setattr(mesh_mod, "resolve_device", torch.device)
    monkeypatch.setattr(mesh_mod.dist, "is_initialized", lambda: bool(started))
    monkeypatch.setattr(mesh_mod.dist, "init_process_group", started.append)
    monkeypatch.setattr(mesh_mod.dist, "get_backend", lambda: started[0])
    monkeypatch.setattr(mesh_mod, "rank_device", lambda dev, backend: dev)
    assert mesh_mod.init_distributed("cuda") == torch.device("cuda")
    assert started == [want]


def test_rebalance_grad_accum_matches_the_reference():
    from repro.runtime.elastic import rebalance_grad_accum as j_rebalance

    for old, new in (((4, 2), (2, 2)), ((4, 2), (3, 2)), ((2, 2), (2, 2)), ((2, 2), (1, 2))):
        a, b = _stand_in(old, ("data", "model")), _stand_in(new, ("data", "model"))
        got = rebalance_grad_accum(DEFAULT_RUN.replace(grad_accum=2), a, b).grad_accum
        assert got == j_rebalance(J_DEFAULT_RUN.replace(grad_accum=2), a, b).grad_accum


# ---------------------------------------------------------------------------
# collectives
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("case", ["n4", "n16", "n16_group"])
def test_compressed_psum_matches_the_reference(groups, case):
    """n = 4: each rank's exact dequantized sum; n = 16: int32 payload sum
    times the mean scale (over the mesh's two axes, and over the world's
    process group given in place of a mesh); against the reference under
    `shard_map`."""
    port, ref = groups
    want = ref["coll"][case.replace("_group", "")]
    for r in range(16):
        got = port["coll"][r][case].numpy()
        err, scale = _leaf_err(got, want[r])
        assert err <= 1e-6 * scale + 1e-6, (r, err)


def test_compressed_psum_stochastic_rounding_bound(groups):
    """With a generator: within the reference test's 5% of the exact sum
    (the reference's own draw too), and not the deterministic rounding."""
    port, ref = groups
    x = np.random.default_rng(0).standard_normal((16, 64)).astype(np.float32)
    exact = x.reshape(4, 4, 64).sum(1)
    for r in range(16):
        want = exact[r // 4]
        got = port["coll"][r]["n4_sr"].numpy()
        assert np.abs(got - want).max() / np.abs(want).max() < 0.05
        assert np.abs(ref["coll"]["n4_sr"][r] - want).max() / np.abs(want).max() < 0.05
    assert any(not np.array_equal(port["coll"][r]["n4_sr"].numpy(), port["coll"][r]["n4"].numpy())
               for r in range(16))


def test_bucketed_psum_matches_the_reference(groups):
    port, ref = groups
    for r in range(16):
        for leaf in ("a", "b"):
            got = port["coll"][r]["bucket"][leaf].numpy()
            err, scale = _leaf_err(got, ref["coll"][f"bucket_{leaf}"][r])
            assert err <= 1e-6 * scale + 1e-6


def test_gloo_cuda_gather_path_on_host_tensors(groups):
    """The gather gloo's CUDA tensors take (an all_reduce of a zero buffer)
    gives the native gather's result bitwise."""
    port, _ = groups
    assert port["gather"] is True


def test_gloo_cuda_reduce_scatter_path_on_host_tensors(groups):
    """The reduce-scatter gloo's CUDA tensors take (an all_reduce and a
    slice) gives the native `reduce_scatter_tensor`'s block bitwise, along
    dims 0 and 1."""
    port, _ = groups
    assert port["reduce_scatter"] == [True, True]


# ---------------------------------------------------------------------------
# the sharded trainer
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("ga", [1, 2])
@pytest.mark.parametrize("dtype", sorted(LIMITS))
@pytest.mark.parametrize("mesh", TRAIN_MESHES, ids=lambda m: f"{m[0]}x{m[1]}")
def test_sharded_trainer_matches_unsharded_and_reference(groups, mesh, dtype, ga):
    """Reduced qwen3-0.6b, 3 steps of B 8 x S 32 from the reference's
    weights at the peak learning rate from step 1 (warmup 0, so every step
    moves the state): loss and grad norm per step, every gathered leaf
    after the last step and each leaf's change over the 3 steps, against
    the port's unsharded trainer and the reference's single-device
    `make_train_step`."""
    port, ref = groups
    got, base, want = port[(mesh, dtype, ga)], port[("unsharded", dtype, ga)], ref[(dtype, ga)]
    lim = LIMITS[dtype]
    own = (1e-5, 1e-5, 1e-5) if dtype == "float32" else lim
    for (gl, gn, _), (bl, bn, _), (wl, wn) in zip(got["hist"], base["hist"], want["hist"]):
        assert _rel(gl, bl) <= own[0] and _rel(gn, bn) <= own[1], (gl, bl, gn, bn)
        assert _rel(gl, wl) <= lim[0] and _rel(gn, wn) <= lim[1], (gl, wl, gn, wn)
    _trees_close(got["params"], base["params"], own[2])
    jref = lm_params_from_jax(jax.tree_util.tree_map(
        lambda a: np.asarray(a.astype(jnp.float32)), want["params"]),
        get_config(TRAIN_ARCH, reduced=True), device="cpu")
    _trees_close(got["params"], jref, lim[2])
    start = tree_map(lambda p: p.to(getattr(torch, dtype)), port["init"])
    _deltas_close(got["params"], base["params"], start, DELTA_LIMITS[dtype][0])
    _deltas_close(got["params"], jref, start, DELTA_LIMITS[dtype][1])


def test_sharded_trainer_layout(groups):
    """On (2, 2) the tied embedding (vocab, embed) splits vocab over
    "model" and embed over "data" (FSDP): this rank holds a quarter."""
    port, _ = groups
    res = port[((2, 2), "float32", 1)]
    assert res["specs"]["embed"] == ("model", "data")
    assert res["local"]["embed"] == (256, 64)
    assert res["specs"]["groups"]["sub0"]["mix"]["wq"] == (None, "data", "model", None)


def test_sharded_trainer_draws_the_unsharded_weights(groups):
    port, _ = groups
    _trees_close(port["draw"]["sharded"], port["draw"]["unsharded"], 0.0, 0.0)


def test_moe_raises_on_data_axes_and_matches_on_the_model_axis(groups):
    """Routing is a whole-batch statistic: an MoE arch on a mesh with two
    data ranks raises (naming its ROADMAP item); on (1, 4) two steps at the
    default warm-up equal the unsharded ones, and so does a step at the peak
    rate, with its change to each leaf."""
    port, _ = groups
    assert port["moe_error"] and "ROADMAP queue 1 [29]" in port["moe_error"]
    for tag in ("moe", "moe_peak"):
        moe = port[tag]
        for (gl, gn, _), (bl, bn, _) in zip(moe["hist"], moe["ref_hist"]):
            assert _rel(gl, bl) <= 1e-5 and _rel(gn, bn) <= 1e-5
        _trees_close(moe["params"], moe["ref_params"], 1e-5)
    moe = port["moe_peak"]
    _deltas_close(moe["params"], moe["ref_params"], moe["init"], DELTA_LIMITS["float32"][0])


def test_elastic_shrink_reshard_and_step(groups):
    """(2, 2) -> a step -> shrink_mesh drops data row 1 -> (1, 2) with
    grad_accum 2; the state resharded from the gathered arrays equals the
    one from the whole-array checkpoint, and its step (at the peak rate, on
    the resharded moments) matches the unsharded trainer's and the
    reference's at the fp32 limits, the change it makes to each leaf
    too."""
    port, ref = groups
    dropped = [e for e in port["elastic"] if not e["member"]]
    kept = [e for e in port["elastic"] if e["member"]]
    assert len(dropped) == 2 and len(kept) == 2
    for e in port["elastic"]:
        assert e["grad_accum"] == 2
    e0 = port["elastic"][0]
    assert e0["new_shape"] == {"data": 1, "model": 2}
    for e in kept:
        assert e["same"]
    (gl, gn, _), (bl, bn, _) = e0["hist1"][0], e0["ref"]["hist1"][0]
    assert _rel(gl, bl) <= 1e-5 and _rel(gn, bn) <= 1e-5
    wl, wn = ref["elastic"]["hist1"]
    assert _rel(gl, wl) <= 1e-4 and _rel(gn, wn) <= 1e-3
    _trees_close(e0["params"], e0["ref"]["params"], 1e-5)
    jref = lm_params_from_jax(jax.tree_util.tree_map(np.asarray, ref["elastic"]["params"]),
                              get_config(TRAIN_ARCH, reduced=True), device="cpu")
    _trees_close(e0["params"], jref, 1e-3)
    # step 2, the first on the resharded moments: its own change to each leaf
    for e in kept:
        step2 = tree_map(lambda a, b: a - b, e["params"], e["params1"])
        ref2 = tree_map(lambda a, b: a - b, e0["ref"]["params"], e0["ref"]["params1"])
        _deltas_close(step2, ref2, tree_map(torch.zeros_like, ref2), DELTA_LIMITS["float32"][0])


def test_train_launcher_over_ranks(groups, tmp_path):
    """`train(model_axis=2)` over the 4 ranks: its checkpoint holds whole
    arrays under the reference's key paths, restorable by the one-process
    trainer, and its losses are the one-process launcher's within the
    bf16 limits."""
    port, _ = groups
    cfg = get_config(TRAIN_ARCH, reduced=True)
    ckpt = CheckpointManager(port["train"]["ckpt"])
    assert ckpt.all_steps() == [1, 2]
    _, hist = train(TRAIN_ARCH, steps=2, global_batch=4, seq_len=16, device="cpu",
                    ckpt_dir=str(tmp_path), checkpoint_every=1, resume=False)
    for (gl, gn), h in zip(port["train"]["hist"], hist):
        assert _rel(gl, h["loss"]) <= 1e-2 and _rel(gn, h["grad_norm"]) <= 3e-2
    mine = CheckpointManager(tmp_path)
    with np.load(Path(port["train"]["ckpt"]) / "step_00000002" / "arrays.npz") as z, \
            np.load(tmp_path / "step_00000002" / "arrays.npz") as w:
        assert sorted(z.files) == sorted(w.files)
        assert all(z[k].shape == w[k].shape for k in z.files)
    from repro_torch.launch.steps import init_train_state

    like = init_train_state(cfg, DEFAULT_RUN, torch.Generator().manual_seed(0), device="cpu")
    restored, meta = ckpt.restore(like)
    assert meta["step"] == 2 and restored.opt.step.item() == 2
    mine_state, _ = mine.restore(like)
    _trees_close(restored.params, mine_state.params, 5e-2, 1e-6)
    ckpt.close()
    mine.close()


# ---------------------------------------------------------------------------
# GPipe
# ---------------------------------------------------------------------------


def test_pipeline_matches_sequential_and_autograd(groups):
    """The reference test's case (L 8, D 16, M 6, mb 4) over 4 stages: every
    rank holds the output of the sequential stack, and each stage's
    gradient of sum(y^2), on its own rank only, is autograd's."""
    port, _ = groups
    p0 = port["pipeline"][0]
    ws = p0["ws"].clone().requires_grad_(True)
    h = p0["x"]
    for i in range(ws.shape[0]):
        h = torch.tanh(h @ ws[i])
    (h ** 2).sum().backward()
    g_ref = split_stages(ws.grad, 4)
    for p in port["pipeline"]:
        np.testing.assert_allclose(p["y"].numpy(), h.detach().numpy(), rtol=2e-4, atol=2e-4)
        s = p["stage"]
        np.testing.assert_allclose(p["grad"][s].numpy(), g_ref[s].numpy(), rtol=2e-4, atol=2e-4)
        others = torch.cat([p["grad"][:s], p["grad"][s + 1:]])
        assert float(others.abs().sum()) == 0.0
    assert sorted(p["stage"] for p in port["pipeline"]) == [0, 1, 2, 3]


@pytest.mark.parametrize("n_stages", [1, 2, 4, 8])
def test_split_stages_matches_the_reference(n_stages):
    x = np.random.default_rng(1).standard_normal((8, 3, 5)).astype(np.float32)
    tree = {"w": torch.from_numpy(x), "b": {"c": torch.from_numpy(x[:, 0])}}
    got = split_stages(tree, n_stages)
    want = j_split_stages({"w": jnp.asarray(x), "b": {"c": jnp.asarray(x[:, 0])}}, n_stages)
    np.testing.assert_array_equal(got["w"].numpy(), np.asarray(want["w"]))
    np.testing.assert_array_equal(got["b"]["c"].numpy(), np.asarray(want["b"]["c"]))
    with pytest.raises(ValueError):
        split_stages(tree, 3)
