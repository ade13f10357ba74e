"""The port's dispatch-level cost counter (`repro_torch.launch.hlo_cost`,
`hlo_analysis`) and the autotuner's model fallback against the JAX
package's HLO counter, on the reference's own programs
(`tests/test_hlo_cost.py`).

- The 10-step tanh chain and the dot: FLOPs and bytes equal to the
  reference's `analyze` of the compiled HLO (168,099,840 / 7,864,320 and
  307,200 / 38,144). A row gather from a (1000, 64) table: bytes equal to
  the reference's (4,128: the rows read and written and the indices, not
  the table), and a copy, a conversion and a fill by the reference's
  result-x2 and result-only rules. Eager mode unrolls loops, so a 10-iteration loop is
  exactly 10 steps and a nested 3 x 4 exactly 12 x 2*64^3.
- A convolution (x (8,64,32,32), w (128,64,3,3), VALID, + ReLU): FLOPs equal
  to XLA's own `cost_analysis()` (1,062,604,800). The reference's `analyze`
  says 45,303,365,632 there (42.7x): it divides the kernel's elements by
  its dim 0, which XLA's CPU layout makes a spatial dim (ROADMAP,
  properties of the reference); the port does not copy that formula.
- `collective_stats` of an all-gather of f32[16,16] and an all-reduce on a
  fake 2-rank world: the reference's dict on its test HLO.
- `scope` tags, `FlashAttentionFn`'s backward tagged; outside a count a
  scope is one shared no-op; a kernel launch inside
  `analyze` raises; `peak_live_bytes` on real and fake tensors.
- `_model_us` routes as the reference's: `hlo_model_us` for a plan with no
  kernel layer, `plan_model_us` with a calibration or a kernel layer; on the
  all-dense plan of the serving tests' tiny VGG the port's counted FLOPs lie
  within 2% of XLA's `cost_analysis` of the reference's runner.

Cost on one worker: ~10 s.
"""
import importlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")
import torch.nn.functional as F  # noqa: E402

from repro.launch.hlo_analysis import collective_stats as j_collective_stats  # noqa: E402
from repro.launch.hlo_cost import analyze as j_analyze  # noqa: E402
from repro_torch.kernels import cuda as kcuda  # noqa: E402
from repro_torch.kernels.flash_attention.kernel import flash_fwd  # noqa: E402
from repro_torch.kernels.flash_attention.ops import flash_mha  # noqa: E402
from repro_torch.launch.dryrun import fake_world  # noqa: E402
from repro_torch.launch.hlo_analysis import collective_stats  # noqa: E402
from repro_torch.launch.hlo_cost import analyze  # noqa: E402
from repro_torch.obs import scopes  # noqa: E402
from repro_torch.obs.scopes import scope  # noqa: E402


def _hlo(f, *shapes):
    return jax.jit(f).lower(*(jax.ShapeDtypeStruct(s, jnp.float32) for s in shapes)) \
        .compile()


def _tanh_chain(n):
    def f(x, w):
        for _ in range(n):
            x = jnp.tanh(x @ w)
        return x

    def g(x, w):
        for _ in range(n):
            x = torch.tanh(x @ w)
        return x

    return f, g


def _zeros(*shape):
    return torch.zeros(shape, dtype=torch.float32)


def test_tanh_chain_and_dot_equal_the_reference():
    f, g = _tanh_chain(10)
    want = j_analyze(_hlo(f, (128, 256), (256, 256)).as_text())
    got = analyze(g, _zeros(128, 256), _zeros(256, 256))
    assert (got["flops"], got["bytes"]) == (want["flops"], want["bytes"]) == \
        (168_099_840, 7_864_320)
    want = j_analyze(_hlo(lambda a, b: a @ b, (32, 100), (100, 48)).as_text())
    got = analyze(lambda a, b: a @ b, _zeros(32, 100), _zeros(100, 48))
    assert (got["flops"], got["bytes"]) == (want["flops"], want["bytes"]) == (307_200, 38_144)


def test_gather_copy_and_fill_bytes_follow_the_reference_rules():
    """A gather reads only the rows it takes: `params['embed'][tokens]` must
    not charge the whole table."""
    want = jax.jit(lambda t, i: t[i]).lower(
        jax.ShapeDtypeStruct((1000, 64), jnp.float32),
        jax.ShapeDtypeStruct((8,), jnp.int32)).compile()
    want = j_analyze(want.as_text())
    idx = torch.tensor([3, 999, 0, 5, 5, 17, 400, 2], dtype=torch.int32)
    for gather in (lambda t, i: t[i], lambda t, i: F.embedding(i, t),
                   lambda t, i: t.index_select(0, i)):
        got = analyze(gather, _zeros(1000, 64), idx)
        assert got["bytes"] == want["bytes"] == 2 * 8 * 64 * 4 + 8 * 4
    x = _zeros(32, 16)
    assert analyze(lambda a: a.clone(), x)["bytes"] == 2 * 2048  # the reference's copy
    assert analyze(lambda a: a.to(torch.bfloat16), x)["bytes"] == 2 * 1024  # convert
    assert analyze(lambda a: a.fill_(1.0), x)["bytes"] == 2048  # broadcast: result only
    assert analyze(lambda: torch.zeros(32, 16))["bytes"] == 2048


def test_loops_count_every_iteration():
    _, g10 = _tanh_chain(10)
    _, g1 = _tanh_chain(1)
    a, w = _zeros(128, 256), _zeros(256, 256)
    one = analyze(g1, a, w)
    ten = analyze(g10, a, w)
    assert (ten["flops"], ten["bytes"]) == (10 * one["flops"], 10 * one["bytes"])

    def nested(x, w):
        for _ in range(3):
            for _ in range(4):
                x = x @ w
        return x

    assert analyze(nested, _zeros(64, 64), _zeros(64, 64))["flops"] == 12 * 2 * 64 ** 3


def test_convolution_flops_equal_xla_cost_analysis():
    def jconv(x, w):
        y = jax.lax.conv_general_dilated(x, w, (1, 1), "VALID",
                                         dimension_numbers=("NCHW", "OIHW", "NCHW"))
        return jax.nn.relu(y)

    xla = _hlo(jconv, (8, 64, 32, 32), (128, 64, 3, 3)).cost_analysis()
    xla = xla[0] if isinstance(xla, (list, tuple)) else xla
    got = analyze(lambda x, w: torch.relu(F.conv2d(x, w)), _zeros(8, 64, 32, 32),
                  _zeros(128, 64, 3, 3))
    assert got["flops"] == xla["flops"] == 1_062_604_800


def test_collective_stats_equal_the_reference_on_a_fake_world():
    import torch.distributed as dist

    hlo = """
ENTRY %main (p: f32[16,16]) -> f32[16,16] {
  %p = f32[16,16]{1,0} parameter(0)
  %ag = f32[32,16]{1,0} all-gather(%p), dimensions={0}
  %ar = f32[16,16]{1,0} all-reduce(%p), to_apply=%sum
  ROOT %r = f32[16,16]{1,0} add(%ar, %ar)
}
"""

    def prog(p):
        out = torch.empty((32, 16))
        dist.all_gather_into_tensor(out, p)
        dist.all_reduce(p)
        return p + p

    with fake_world(2):
        got = collective_stats(prog, _zeros(16, 16))
        a = analyze(prog, _zeros(16, 16))
    assert got == j_collective_stats(hlo) == {
        "bytes_by_kind": {"all-gather": 2048, "all-reduce": 1024},
        "counts": {"all-gather": 1, "all-reduce": 1}, "total_bytes": 3072}
    assert a["collective_bytes_native"] == a["collective_bytes"] == 3072
    assert a["collective_bytes_by_link"] == {"nvlink": 3072}  # ranks 0 and 1: one node


def test_scope_tags_bytes_and_the_flash_backward():
    def prog(x):
        y = x * 2  # untagged: 800 bytes
        with scope("outer/flash_attention/inner"):
            z = y + 1  # tagged: 800 bytes
        return z

    assert scope("flash_attention") is scope("x")  # no count open: one shared no-op
    with scope("flash_attention"):
        assert scopes.open_scopes() == []
    a = analyze(prog, _zeros(100), tags=("flash_attention",))
    assert a["bytes"] == 1600 and a["tagged_bytes"] == {"flash_attention": 800}
    assert analyze(prog, _zeros(100))["tagged_bytes"] == {}

    g = torch.Generator().manual_seed(0)
    q = torch.randn((2, 16, 2, 2, 8), generator=g).requires_grad_(True)
    k = torch.randn((2, 16, 2, 8), generator=g).requires_grad_(True)
    v = torch.randn((2, 16, 2, 8), generator=g).requires_grad_(True)
    out = flash_mha(q, k, v)
    do = torch.ones_like(out)
    b = analyze(lambda: torch.autograd.grad(out, (q, k, v), do), tags=("flash_attention",))
    grads = sum(t.numel() * 4 for t in (q, k, v))
    # the Function's backward dispatches every op of the gradient pass
    assert b["tagged_bytes"]["flash_attention"] == b["bytes"] > grads
    f = analyze(flash_mha, q, k, v, tags=("flash_attention",))
    assert 0 < f["tagged_bytes"]["flash_attention"] == f["bytes"]


@pytest.mark.parametrize("counter", ["wrapper", "entry point"])
def test_analyze_refuses_a_kernel_launch_inside(counter):
    def launches(x):
        if counter == "wrapper":
            flash_fwd.launches += 1
        else:
            kcuda.FLASH_ENTRY_LAUNCHES["repro_flash_fwd_bf16"] += 1
        return x + 1

    before = (flash_fwd.launches, dict(kcuda.FLASH_ENTRY_LAUNCHES))
    try:
        with pytest.raises(RuntimeError, match="launched inside analyze"):
            analyze(launches, _zeros(4))
    finally:
        flash_fwd.launches = before[0]
        kcuda.FLASH_ENTRY_LAUNCHES.update(before[1])
    analyze(lambda x: x + 1, _zeros(4))  # no launch: no refusal


@pytest.mark.parametrize("fake", [False, True], ids=["real", "fake"])
def test_peak_live_bytes_of_a_known_chain(fake):
    """x (external, 4,096 B); a, b 4,096 B each; a freed; a scalar; a
    40,000-byte scratch freed; then b * b: the peak is b + the scalar + the
    scratch = 44,100 B, and a view or an in-place op allocates nothing."""
    from torch._subclasses.fake_tensor import FakeTensorMode

    def chain(x):
        a = x * 2
        b = a + 1
        del a
        c = b.sum()
        d = torch.empty(10_000)
        d.add_(1.0)
        del d
        e = (b * b).view(32, 32)
        e.mul_(c)
        return e

    if fake:
        with FakeTensorMode():
            a = analyze(chain, torch.empty(1024))
    else:
        a = analyze(chain, torch.zeros(1024))
    assert a["peak_live_bytes"] == 4096 + 4 + 40_000


def _tiny_plans():
    """(jax graph, torch graph, jax params, torch params, calib numpy) of the
    serving tests' tiny VGG, weights made once and handed to both."""
    from repro.configs.vgg19_sparse import CNNConfig as JCNNConfig
    from repro.configs.vgg19_sparse import vgg19_graph as j_vgg19_graph
    from repro_torch.configs.vgg19_sparse import CNNConfig, vgg19_graph
    from repro_torch.convert import params_from_jax
    from repro_torch.graph import init_graph
    from repro_torch.launch.serve_cnn import synth_requests
    from repro_torch.models.cnn import shift_dead_channels

    tiny = dict(name="vgg-serve-tiny", in_channels=16, img_size=12,
                plan=((8, 1), (16, 1)), n_classes=4)
    jg, tg = j_vgg19_graph(JCNNConfig(**tiny)), vgg19_graph(CNNConfig(**tiny))
    tp = shift_dead_channels(init_graph(torch.Generator().manual_seed(0), tg, device="cpu"))
    npp = {k: [w.numpy() for w in ws] for k, ws in tp.items()}
    calib = torch.stack(synth_requests(tg, 2, seed=1, device="cpu")).numpy()
    jp = {k: [jnp.asarray(w) for w in ws] for k, ws in npp.items()}
    return jg, tg, jp, params_from_jax(npp, device="cpu"), calib


def test_model_us_routes_as_the_reference_and_counts_the_dense_plan():
    from repro.pipeline import plan_network as j_plan_network
    from repro.pipeline import run_plan as j_run_plan
    from repro_torch.obs import calibrate
    from repro_torch.pipeline import plan_network

    A = importlib.import_module("repro_torch.serving.autotune")  # the package exports a function
    jg, tg, jp, tp, calib = _tiny_plans()
    x = torch.from_numpy(calib)
    dense = plan_network(tp, x, tg, occ_threshold=0.0, block_c=8, use_pallas=False)
    kernel = plan_network(tp, x, tg, occ_threshold=1.0, block_c=8)
    assert {lp.impl for lp in dense.layers} == {"dense"}
    assert any(A.get_op(lp.kind, lp.impl).pallas for lp in kernel.layers)

    calls = []
    real_hlo, real_plan = A.hlo_model_us, A.plan_model_us
    try:
        A.hlo_model_us = lambda fn, *a: calls.append("hlo") or real_hlo(fn, *a)
        A.plan_model_us = lambda *a, **k: calls.append("plan") or real_plan(*a, **k)
        us = A._model_us(dense, tp, x, A._runner_for(dense))
        assert calls == ["hlo"] and us > 0
        db = calibrate.CalibrationDB(device="cpu")
        A._model_us(dense, tp, x, A._runner_for(dense), db)
        A._model_us(kernel, tp, x, A._runner_for(kernel))
        assert calls == ["hlo", "plan", "plan"]
        # the autotuner's fallback takes the same route
        calls.clear()
        res = A.autotune(tp, x, tg, thresholds=(0.0,), block_cs=(8,), mode="model",
                         use_pallas=False)
        assert calls == ["hlo"] and res.used_model and res.best.model_us == us
    finally:
        A.hlo_model_us, A.plan_model_us = real_hlo, real_plan

    jplan = j_plan_network(jp, jnp.asarray(calib), jg, occ_threshold=0.0, block_c=8,
                           use_pallas=False)
    assert [lp.impl for lp in jplan.layers] == [lp.impl for lp in dense.layers]
    c = jax.jit(lambda p, im: j_run_plan(jplan, p, im)).lower(jp, jnp.asarray(calib)).compile()
    xla = c.cost_analysis()
    xla = xla[0] if isinstance(xla, (list, tuple)) else xla
    got = analyze(A._runner_for(dense), tp, x)["flops"]
    assert abs(got - xla["flops"]) <= 0.02 * xla["flops"]
    np.testing.assert_allclose(A._runner_for(dense)(tp, x)[0].numpy(),
                               np.asarray(j_run_plan(jplan, jp, jnp.asarray(calib))[0]),
                               rtol=1e-4, atol=1e-5)
