"""Data-parallel serving on the card: `Engine(mesh=)` over two slots of
cuda:0 (and over two cards where the machine has them) for the fp32, int8
and pruned + int8 variants of VGG-tiny, whose plans run the ECR / PECR,
int8 ECR and int8 BSR kernels. These tests need an NVIDIA GPU and nvcc;
without a card they skip (the check runs inside the fixture, never at
import). This file imports no JAX: run it on the card with
`PYTHONPATH=src python -m pytest --noconftest -m cuda tests/test_torch_serving_sharded_cuda.py`.
The host's tests, against the JAX package too, are
`tests/test_torch_serving_sharded.py`.

Limits: cuDNN picks its algorithm per batch size, so a shard's logits are
bitwise equal to `run_plan` on that shard's slice, not to the whole
bucket's rows; the fp32 variant's served logits are held against the
dense cuDNN path (TF32 off) at rtol 1e-3 + 1e-3 * max|dense|; the
aggregated occupancy of a bucket with an all-pad shard within 1e-6 of the
whole bucket's n_valid-masked statistic."""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.graph import init_graph, run_graph  # noqa: E402
from repro_torch.launch.serve_cnn import serving_graph, synth_requests  # noqa: E402
from repro_torch.models.cnn import shift_dead_channels  # noqa: E402
from repro_torch.parallel import data_mesh  # noqa: E402
from repro_torch.pipeline import plan_network, run_plan  # noqa: E402
from repro_torch.serving import Engine, SimClock  # noqa: E402
from repro_torch.sparse_weights.prune import prune_graph_params  # noqa: E402

pytestmark = pytest.mark.cuda

GRAPH = serving_graph("vgg19")  # VGG-tiny: 16x16x16, convs 16/16/32
VARIANTS = {"fp32": (1.0, False, {"ecr_pallas", "pecr_pallas"}),
            "int8": (1.0, True, {"ecr_int8"}),
            "pruned-int8": (0.3, True, {"bsr_int8"})}


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    from repro_torch.device import strict_fp32

    strict_fp32()
    return torch.device("cuda")


@pytest.mark.parametrize("variant", sorted(VARIANTS))
@pytest.mark.parametrize("cards", [1, 2])
def test_sharded_engine_on_the_card(dev, cards, variant):
    if torch.cuda.device_count() < cards:
        pytest.skip(f"needs {cards} cards, the machine has {torch.cuda.device_count()}")
    prune, int8, impls = VARIANTS[variant]
    slots = [torch.device("cuda", 0), torch.device("cuda", cards - 1)]
    params = shift_dead_channels(init_graph(torch.Generator().manual_seed(0), GRAPH,
                                            device=dev))
    calib = torch.stack(synth_requests(GRAPH, 2, seed=1, device=dev))
    if prune < 1.0:
        params, _ = prune_graph_params(params, prune, GRAPH, probe=calib)
    plan = plan_network(params, calib, GRAPH, occ_threshold=1.0, block_c=8, int8=int8,
                        int8_budget=0.0)
    assert impls <= {lp.impl for lp in plan.layers}
    eng = Engine(params, graph=GRAPH, plan=plan, max_batch=8, clock=SimClock(),
                 mesh=data_mesh(2, devices=slots), device=dev)
    assert eng.n_devices == 2 and eng.batcher.exec_buckets() == (4, 8)
    eng.warmup()
    assert eng.stats()["captures_per_slot"] == [2, 2]
    runner = eng._executable(8)
    imgs = torch.stack(synth_requests(GRAPH, 16, seed=7, device=dev))
    served = eng.serve(list(imgs))  # two full 8-buckets
    assert eng.batch_builds == 0
    replayed: dict = {}
    for pool in eng.cache.pools:
        for k, n in pool.replay_launches.items():
            replayed[k] = replayed.get(k, 0) + n
    want: dict = {}
    for r in runner.runners:
        for k, n in r.launches_per_replay.items():
            want[k] = want.get(k, 0) + 2 * n
    assert replayed == want and replayed
    for b in range(2):
        for i in range(2):
            rows = slice(8 * b + 4 * i, 8 * b + 4 * i + 4)
            ref = run_plan(plan, params, imgs[rows]).cpu().numpy()
            assert np.array_equal(served[rows], ref), (b, i)
    if not int8:
        dense = run_graph(GRAPH, params, imgs, "dense").cpu().numpy()
        scale = float(np.abs(dense).max())
        np.testing.assert_allclose(served, dense, rtol=1e-3, atol=1e-3 * scale)
    # a ragged bucket whose second shard is all padding
    ragged = torch.cat([imgs[:4], torch.zeros_like(imgs[:4])])
    _, occs = runner(params, ragged, 4)
    _, ref_occs = run_plan(plan, params, ragged, collect_occupancy=True, n_valid=4)
    np.testing.assert_allclose(occs.cpu().numpy(), ref_occs.cpu().numpy(), rtol=1e-6,
                               atol=1e-6)


def test_default_engine_on_one_card_is_unsharded(dev):
    if torch.cuda.device_count() != 1:
        pytest.skip("the default mesh spans every card that divides max_batch")
    from repro_torch.serving import plan_key

    params = shift_dead_channels(init_graph(torch.Generator().manual_seed(0), GRAPH,
                                            device=dev))
    calib = torch.stack(synth_requests(GRAPH, 2, seed=1, device=dev))
    eng = Engine(params, graph=GRAPH, calib=calib, max_batch=8, clock=SimClock(),
                 device=dev)
    assert eng.mesh is None and eng.n_devices == 1
    assert plan_key(8, eng.plan, eng.mesh).mesh_shape == ()
