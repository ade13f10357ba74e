"""Distributed training on the card: the sharded trainer, elastic
re-meshing, GPipe and the launcher over 2 gloo ranks sharing cuda:0 (the
path the one-card machine runs), and over 2 NCCL ranks with a card each
where the machine has two. Rank processes come from
`tests/_torch_distributed_ranks.py` (kinds `train_cuda`, `train_nccl`),
once per group for the module. These tests need an NVIDIA GPU and nvcc;
without one they skip (the check runs inside the fixture, never at
import). This file imports no JAX: run it on the card with
`PYTHONPATH=src python -m pytest --noconftest -m cuda tests/test_torch_distributed_cuda.py`.
The host's tests, against the JAX package too, are
`tests/test_torch_distributed.py`.

Reduced qwen3-0.6b, B 8 x S 32, 3 steps at the peak learning rate from
step 1 (warmup 0, so every step moves the state), against the unsharded
trainer on the same card from the same weights: fp32 loss, grad norm 1e-5
relative and every gathered leaf 1e-5 * max|leaf| + 1e-6; bf16 1e-2 / 3e-2
/ 5e-2 (PERF.md section 2); each leaf's change over the run, in norm, fp32
1e-4 and bf16 0.2 of the unsharded change's. GPipe: the output within 2e-4
of the sequential product, stage gradients within 2e-4 of autograd's."""
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.configs.base import DEFAULT_RUN, get_config  # noqa: E402
from repro_torch.parallel import split_stages  # noqa: E402
from repro_torch.tree import tree_leaves, tree_map  # noqa: E402

pytestmark = pytest.mark.cuda

ROOT = Path(__file__).resolve().parents[1]
KINDS = {"gloo": ("train_cuda", 1), "nccl": ("train_nccl", 2)}  # kind, cards needed
MESHES = ((2, 1), (1, 2))
LIMITS = {"float32": (1e-5, 1e-5, 1e-5), "bfloat16": (1e-2, 3e-2, 5e-2)}
DELTA_LIMITS = {"float32": 1e-4, "bfloat16": 0.2}


@pytest.fixture(scope="module", params=sorted(KINDS))
def ranks(request, tmp_path_factory):
    backend = request.param
    kind, cards = KINDS[backend]
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    if torch.cuda.device_count() < cards:
        pytest.skip(f"{backend} needs {cards} cards, the machine has "
                    f"{torch.cuda.device_count()}")
    from repro_torch.kernels import cuda as kcuda
    from repro_torch.launch.steps import init_train_state

    kcuda.build()  # once, before any rank loads the library
    tmp = tmp_path_factory.mktemp(backend)
    cfg = get_config("qwen3-0.6b", reduced=True)
    state = init_train_state(cfg, DEFAULT_RUN.replace(param_dtype="float32"),
                             torch.Generator().manual_seed(3), device="cpu")
    torch.save({"params": state.params}, tmp / "in.pt")
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    r = subprocess.run([sys.executable, str(ROOT / "tests" / "_torch_distributed_ranks.py"),
                        kind, str(tmp / "in.pt"), str(tmp / "out")], env=env,
                       capture_output=True, text=True, timeout=600)
    assert r.returncode == 0, (r.stdout + r.stderr)[-4000:]
    out = tmp / "out"
    res = torch.load(out / "train.pt", weights_only=False)
    res["init"] = state.params
    res["elastic"] = [torch.load(out / f"elastic_{i}.pt", weights_only=False) for i in range(2)]
    res["pipeline"] = [torch.load(out / f"pipeline_{i}.pt", weights_only=False)
                       for i in range(2)]
    return res


def _rel(a, b):
    return abs(a - b) / max(abs(b), 1e-12)


def _trees_close(got, want, rel, floor=1e-6):
    for i, (g, w) in enumerate(zip(tree_leaves(got), tree_leaves(want))):
        err = float((g.double() - w.double()).abs().max())
        scale = float(w.double().abs().max())
        assert err <= rel * scale + floor, (i, err, scale)


def _deltas_close(got, want, start, rel):
    """||(got - start) - (want - start)|| <= rel * ||want - start||, leaf by
    leaf (as in tests/test_torch_distributed.py)."""
    for i, (g, w, s) in enumerate(zip(tree_leaves(got), tree_leaves(want), tree_leaves(start))):
        dg, dw = g.double() - s.double(), w.double() - s.double()
        err, scale = float((dg - dw).norm()), float(dw.norm())
        assert err <= rel * scale, (i, err, scale)


@pytest.mark.parametrize("ga", [1, 2])
@pytest.mark.parametrize("dtype", sorted(LIMITS))
@pytest.mark.parametrize("mesh", MESHES, ids=lambda m: f"{m[0]}x{m[1]}")
def test_sharded_trainer_on_the_card(ranks, mesh, dtype, ga):
    got, base = ranks[(mesh, dtype, ga)], ranks[("unsharded", dtype, ga)]
    lim = LIMITS[dtype]
    for (gl, gn, _), (bl, bn, _) in zip(got["hist"], base["hist"]):
        assert np.isfinite(gl) and np.isfinite(gn)
        assert _rel(gl, bl) <= lim[0] and _rel(gn, bn) <= lim[1], (gl, bl, gn, bn)
    _trees_close(got["params"], base["params"], lim[2])
    start = tree_map(lambda p: p.to(getattr(torch, dtype)), ranks["init"])
    _deltas_close(got["params"], base["params"], start, DELTA_LIMITS[dtype])


def test_draw_moe_and_gather_on_the_card(ranks):
    _trees_close(ranks["draw"]["sharded"], ranks["draw"]["unsharded"], 0.0, 0.0)
    assert "ROADMAP queue 1 [29]" in ranks["moe_error"]
    for tag in ("moe", "moe_peak"):
        moe = ranks[tag]
        for (gl, gn, _), (bl, bn, _) in zip(moe["hist"], moe["ref_hist"]):
            assert _rel(gl, bl) <= 1e-5 and _rel(gn, bn) <= 1e-5
        _trees_close(moe["params"], moe["ref_params"], 1e-5)
    moe = ranks["moe_peak"]
    _deltas_close(moe["params"], moe["ref_params"], moe["init"], DELTA_LIMITS["float32"])
    assert ranks["gather"] is True and ranks["reduce_scatter"] == [True, True]
    assert [len(h) for h in ranks["train"]["hist"]] == [2, 2]


def test_elastic_on_the_card(ranks):
    """(2, 1) -> a step -> shrink to (1, 1) with grad_accum 2 -> reshard
    (from the gathered arrays and from the checkpoint, equal) -> a step
    equal to the unsharded trainer's, its change to each leaf too."""
    e0, e1 = ranks["elastic"]
    assert e0["member"] and not e1["member"]
    assert e0["grad_accum"] == e1["grad_accum"] == 2 and e0["same"]
    (gl, gn, _), (bl, bn, _) = e0["hist1"][0], e0["ref"]["hist1"][0]
    assert _rel(gl, bl) <= 1e-5 and _rel(gn, bn) <= 1e-5
    _trees_close(e0["params"], e0["ref"]["params"], 1e-5)
    step2 = tree_map(lambda a, b: a - b, e0["params"], e0["params1"])
    ref2 = tree_map(lambda a, b: a - b, e0["ref"]["params"], e0["ref"]["params1"])
    _deltas_close(step2, ref2, tree_map(torch.zeros_like, ref2), DELTA_LIMITS["float32"])


@pytest.mark.parametrize("d", [16, 1024])
def test_pipeline_on_the_card(ranks, d):
    ws = ranks["pipeline"][0][d]["ws"].double().requires_grad_(True)
    h = ranks["pipeline"][0][d]["x"].double()
    for i in range(ws.shape[0]):
        h = torch.tanh(h @ ws[i])
    (h ** 2).sum().backward()
    g_ref = split_stages(ws.grad, 2)
    for p in (r[d] for r in ranks["pipeline"]):
        np.testing.assert_allclose(p["y"].double().numpy(), h.detach().numpy(),
                                   rtol=2e-4, atol=2e-4)
        s = p["stage"]
        np.testing.assert_allclose(p["grad"][s].double().numpy(), g_ref[s].numpy(),
                                   rtol=2e-4, atol=2e-4)
        assert float(p["grad"][1 - s].abs().sum()) == 0.0
