"""The port's training path (reduced qwen3-0.6b, fp32 on both sides) against
the JAX package: AdamW and the LR schedule, the token pipeline, `lm_loss`
and its gradients, the chunked loss, whole train steps with and without
gradient accumulation, remat, checkpoints (the port's own and the JAX
package's), restart after a failure, and the launcher. The JAX side runs on
the CPU without a mesh, at `DEFAULT_RUN.replace(param_dtype="float32",
remat="none")`; its weights are carried over as numpy.

Tolerances (fp32 sums in another order on the two sides):
- loss and every gradient leaf: max|port - jax| <= 1e-5 * max|jax| + 1e-6;
- AdamW: new params and moments at rtol = atol = 1e-6 (one elementwise
  pass each), grad norm at 1e-6 relative; LR schedule at 1e-7 relative;
- three train steps: loss and grad norm at 1e-5 relative, lr at 1e-7
  relative, final params at 1e-5 * max|jax| + 1e-6 per leaf (the AdamW
  update divides by sqrt(v), which amplifies gradient noise where the
  gradient is near 0);
- remat "full" and "dots" against "none" on the port: 1e-6 relative (the
  same ops, recomputed);
- restart: losses within 1e-6, as `tests/test_checkpoint_runtime.py`;
- bf16, the reference's default (`DEFAULT_RUN.replace(remat="none")` on
  both sides, bf16 weights carried over exactly): loss per step within 1e-2
  relative (observed 7.5e-5), grad norm within 3e-2 relative (observed
  3.9e-4), step-0 gradient leaves within 5e-2 * max|leaf| (observed 1.4e-2):
  the two sides round bf16 activations at the same points but sum their
  fp32 products in other orders, and a bf16 rounding that flips moves a
  value by 2^-8 of itself.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.checkpoint import CheckpointManager as JCheckpointManager  # noqa: E402
from repro.configs import DEFAULT_RUN as J_DEFAULT_RUN  # noqa: E402
from repro.configs import ShapeConfig, get_config as j_get_config  # noqa: E402
from repro.data import make_pipeline as j_make_pipeline  # noqa: E402
from repro.launch.steps import init_train_state as j_init_train_state  # noqa: E402
from repro.launch.steps import make_train_step as j_make_train_step  # noqa: E402
from repro.models import model as JM  # noqa: E402
from repro.optim.adamw import OptState as JOptState  # noqa: E402
from repro.optim.adamw import adamw_update as j_adamw_update  # noqa: E402
from repro.optim.schedules import warmup_cosine as j_warmup_cosine  # noqa: E402
from repro_torch.checkpoint import CheckpointManager, restore_tree, save_tree  # noqa: E402
from repro_torch.configs.base import DEFAULT_RUN, get_config  # noqa: E402
from repro_torch.convert import lm_params_from_jax, train_state_from_jax  # noqa: E402
from repro_torch.data import TokenPipeline, make_pipeline  # noqa: E402
from repro_torch.launch.steps import (  # noqa: E402
    init_train_state,
    loss_and_grads,
    make_train_step,
)
from repro_torch.launch.train import train  # noqa: E402
from repro_torch.models import model as M  # noqa: E402
from repro_torch.optim import OptState, adamw_update, global_norm, warmup_cosine  # noqa: E402
from repro_torch.runtime import (  # noqa: E402
    FailureInjector,
    SimulatedFailure,
    StragglerMonitor,
    Supervisor,
)
from repro_torch.tree import tree_leaves, tree_map, tree_unflatten  # noqa: E402

ARCH = "qwen3-0.6b"
KEY = jax.random.PRNGKey(0)
J_RUN = J_DEFAULT_RUN.replace(param_dtype="float32", remat="none")
RUN = DEFAULT_RUN.replace(param_dtype="float32", remat="none")


def _close(got, want, rel=1e-5, floor=1e-6):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    err = float(np.abs(got - want).max())
    scale = float(np.abs(want).max())
    assert err <= rel * scale + floor, (err, scale)


def _leaves(tree):
    """(path, numpy leaf) pairs of a port tree or a JAX tree, sorted paths."""
    if isinstance(tree, dict):
        return [(f"{k}/{p}".rstrip("/"), x) for k in sorted(tree) for p, x in _leaves(tree[k])]
    return [("", np.asarray(tree.detach() if isinstance(tree, torch.Tensor) else tree))]


def _assert_trees_close(port, ref, **kw):
    pl, rl = _leaves(port), _leaves(ref)
    assert [p for p, _ in pl] == [p for p, _ in rl]
    for (path, a), (_, b) in zip(pl, rl):
        assert a.shape == b.shape, path
        try:
            _close(a, b, **kw)
        except AssertionError as e:
            raise AssertionError(f"{path}: {e}") from None


@pytest.fixture(scope="module")
def setup():
    cfg, jcfg = get_config(ARCH, reduced=True), j_get_config(ARCH, reduced=True)
    jstate = j_init_train_state(jcfg, J_RUN, KEY)
    np_state = jax.tree_util.tree_map(np.asarray, jstate)
    return cfg, jcfg, jstate, np_state


def _batch(cfg, b=4, s=16, seed=0):
    return make_pipeline(cfg, s, b, seed=seed).batch_at(seed)


# ---------------------------------------------------------------------------
# optimizer and schedule
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("step", [0, 1, 50, 99, 100, 101, 500, 999, 1000, 2000])
def test_warmup_cosine_matches_jax(step):
    kw = dict(peak_lr=3e-4, warmup_steps=100, total_steps=1000)
    want = float(j_warmup_cosine(jnp.int32(step), **kw))
    got = warmup_cosine(torch.tensor(step, dtype=torch.int32), **kw)
    assert got.dtype == torch.float32
    assert abs(float(got) - want) <= 1e-7 * abs(want) + 1e-12


@pytest.mark.parametrize("grad_scale,clip", [(1e-2, 1.0), (10.0, 1.0), (10.0, 0.0)])
def test_adamw_update_matches_jax(grad_scale, clip):
    """One update from nonzero moments at step 3, clipping active or not."""
    rng = np.random.default_rng(4)
    shapes = {"a": (5, 3), "b": {"c": (7,), "d": (2, 2, 2)}}
    mk = lambda s, sc=1.0: tree_map(  # noqa: E731
        lambda sh: (rng.standard_normal(sh) * sc).astype(np.float32), s)
    p, g, m = mk(shapes), mk(shapes, grad_scale), mk(shapes, 0.1)
    v = tree_map(lambda x: np.abs(x) * 0.01, mk(shapes))
    kw = dict(lr=1e-2, beta1=0.9, beta2=0.95, weight_decay=0.1, grad_clip=clip)
    jp, jst, jn = j_adamw_update(
        jax.tree_util.tree_map(jnp.asarray, g),
        JOptState(step=jnp.int32(3), m=jax.tree_util.tree_map(jnp.asarray, m),
                  v=jax.tree_util.tree_map(jnp.asarray, v)),
        jax.tree_util.tree_map(jnp.asarray, p), **kw)
    tt = lambda t: tree_map(lambda x: torch.from_numpy(x.copy()), t)  # noqa: E731
    pp, st, n = adamw_update(tt(g), OptState(step=torch.tensor(3, dtype=torch.int32),
                                             m=tt(m), v=tt(v)), tt(p), **kw)
    assert int(st.step) == 4 and int(jst.step) == 4
    assert abs(float(n) - float(jn)) <= 1e-6 * float(jn)
    assert abs(float(global_norm(tt(g))) - float(jn)) <= 1e-6 * float(jn)
    for got, want in ((pp, jp), (st.m, jst.m), (st.v, jst.v)):
        for (path, a), (_, b) in zip(_leaves(got), _leaves(want)):
            np.testing.assert_allclose(a, b, rtol=1e-6, atol=1e-6, err_msg=path)


# ---------------------------------------------------------------------------
# data
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("step,n_hosts,host_id", [(0, 1, 0), (11, 1, 0), (3, 2, 1)])
def test_batch_at_is_the_reference_batch(setup, step, n_hosts, host_id):
    cfg, jcfg, _, _ = setup
    want = j_make_pipeline(jcfg, ShapeConfig("t", 16, 8, "train"), seed=3,
                           n_hosts=n_hosts, host_id=host_id).batch_at(step)
    got = make_pipeline(cfg, 16, 8, seed=3, n_hosts=n_hosts, host_id=host_id).batch_at(step)
    for k in ("tokens", "labels"):
        assert got[k].dtype == want[k].dtype and np.array_equal(got[k], want[k])


def test_prefetch_iterator_resumes(setup):
    p = TokenPipeline(vocab_size=512, seq_len=16, global_batch=4, seed=1)
    it = p.iterate(start_step=5)
    first, second = next(it), next(it)
    it.close()
    assert np.array_equal(first["tokens"], p.batch_at(5)["tokens"])
    assert np.array_equal(second["tokens"], p.batch_at(6)["tokens"])
    with pytest.raises(ValueError, match="split"):
        TokenPipeline(vocab_size=512, seq_len=4, global_batch=3, n_hosts=2).host_batch


# ---------------------------------------------------------------------------
# loss and gradients
# ---------------------------------------------------------------------------


def test_lm_loss_and_every_gradient_leaf_match_jax(setup):
    cfg, jcfg, jstate, np_state = setup
    batch = _batch(cfg, seed=2)
    jloss, jgrads = jax.value_and_grad(lambda p: JM.lm_loss(jcfg, p, {
        k: jnp.asarray(v) for k, v in batch.items()}))(jstate.params)
    params = lm_params_from_jax(np_state.params, cfg, device="cpu")
    loss, grads = loss_and_grads(cfg, RUN, params, {
        k: torch.from_numpy(v) for k, v in batch.items()})
    _close(float(loss), float(jloss))
    _assert_trees_close(grads, jgrads)
    assert all(float(g.abs().max()) > 0 for g in tree_leaves(grads))


def test_lm_loss_ignores_negative_labels(setup):
    cfg, jcfg, jstate, np_state = setup
    batch = _batch(cfg, seed=3)
    batch["labels"][:, ::3] = -1
    want = JM.lm_loss(jcfg, jstate.params, {k: jnp.asarray(v) for k, v in batch.items()})
    params = lm_params_from_jax(np_state.params, cfg, device="cpu")
    with torch.no_grad():
        got = M.lm_loss(cfg, params, {k: torch.from_numpy(v) for k, v in batch.items()})
    _close(float(got), float(want))


@pytest.mark.parametrize("chunk", [128, 200, 512, 1000])
def test_chunked_xent_matches_jax(chunk):
    """`_chunked_xent` against the reference's, value and gradients; chunk
    sizes that divide the vocab, leave a short last chunk, and exceed it."""
    rng = np.random.default_rng(chunk)
    x = rng.standard_normal((2, 6, 16)).astype(np.float32)
    w = (rng.standard_normal((16, 512)) * 0.3).astype(np.float32)
    labels = rng.integers(0, 512, (2, 6)).astype(np.int32)
    labels[0, 2] = -1

    def jf(x, w):
        return JM._chunked_xent(x, w, jnp.asarray(labels), vocab_chunk=chunk)

    want, (jgx, jgw) = jax.value_and_grad(jf, argnums=(0, 1))(jnp.asarray(x), jnp.asarray(w))
    tx, tw = (torch.from_numpy(a).requires_grad_(True) for a in (x, w))
    got = M._chunked_xent(tx, tw, torch.from_numpy(labels), vocab_chunk=chunk)
    got.backward()
    _close(float(got.detach()), float(want))
    _close(tx.grad.numpy(), jgx)
    _close(tw.grad.numpy(), jgw)


def test_lm_loss_takes_the_chunked_branch_above_the_threshold(setup, monkeypatch):
    """The reference's branch on LOSS_VOCAB_CHUNK_MIN: lowered below the
    vocab, lm_loss goes through `_chunked_xent` and gives the same loss."""
    cfg, _, _, np_state = setup
    params = lm_params_from_jax(np_state.params, cfg, device="cpu")
    batch = {k: torch.from_numpy(v) for k, v in _batch(cfg, seed=4).items()}
    with torch.no_grad():
        full = M.lm_loss(cfg, params, batch)
        calls = []
        orig = M._chunked_xent
        monkeypatch.setattr(M, "_chunked_xent", lambda *a, **k: calls.append(1) or orig(*a, **k))
        monkeypatch.setattr(M, "LOSS_VOCAB_CHUNK_MIN", cfg.vocab_size)
        chunked = M.lm_loss(cfg, params, batch)
    assert calls == [1]
    _close(float(chunked), float(full), rel=1e-6)


def test_remat_full_equals_none(setup):
    cfg, _, _, np_state = setup
    params = lm_params_from_jax(np_state.params, cfg, device="cpu")
    batch = {k: torch.from_numpy(v) for k, v in _batch(cfg, seed=5).items()}
    l0, g0 = loss_and_grads(cfg, RUN, params, batch)
    l1, g1 = loss_and_grads(cfg, RUN.replace(remat="full"), params, batch)
    _close(float(l1), float(l0), rel=1e-6, floor=0)
    _assert_trees_close(g1, g0, rel=1e-6, floor=1e-9)
    l2, g2 = loss_and_grads(cfg, RUN.replace(remat="dots"), params, batch)
    _close(float(l2), float(l0), rel=1e-6, floor=0)
    _assert_trees_close(g2, g0, rel=1e-6, floor=1e-9)
    with pytest.raises(ValueError, match="remat"):
        M.lm_loss(cfg, params, batch, remat="some")


def test_remat_dots_saves_the_batch_free_matmuls(setup, monkeypatch):
    """remat "dots" keeps exactly the outputs of the seven batch-free
    matmuls of each layer (q, k, v, o projections: einsums lowered to a
    batch-of-one bmm; the FFN's w1, w3, w2: mm) and recomputes the rest; the
    attention region's batched products are recomputed. Through
    `saved_tensors_hooks`: under "dots", as under "full", autograd saves
    nothing from inside the layers (FlashAttentionFn's q among them), which
    "none" does save."""
    import repro_torch.models.transformer as T
    from torch.utils.checkpoint import CheckpointPolicy

    cfg, _, _, np_state = setup
    params = lm_params_from_jax(np_state.params, cfg, device="cpu")
    b, s = 4, 16
    batch = {k: torch.from_numpy(v) for k, v in _batch(cfg, b=b, s=s, seed=5).items()}
    decisions = []
    orig = T.dots_policy

    aten = torch.ops.aten

    def spy(ctx, op, *args, **kw):
        out = orig(ctx, op, *args, **kw)
        if not ctx.is_recompute and op in (aten.mm.default, aten.bmm.default):
            decisions.append((op, tuple(args[0].shape), tuple(args[1].shape), out))
        elif not ctx.is_recompute:
            assert out == CheckpointPolicy.PREFER_RECOMPUTE, op
        return out

    monkeypatch.setattr(T, "dots_policy", spy)
    saved_shapes = {}
    for remat in ("none", "full", "dots"):
        shapes = []

        def pack(t):
            shapes.append(tuple(t.shape))
            return t

        leaves = [x.detach().requires_grad_(True) for x in tree_leaves(params)]
        with torch.autograd.graph.saved_tensors_hooks(pack, lambda t: t):
            loss = M.lm_loss(cfg, tree_unflatten(params, leaves), batch, remat=remat)
        torch.autograd.grad(loss, leaves)
        saved_shapes[remat] = shapes
    kept = [(op, a, w) for op, a, w, d in decisions if d == CheckpointPolicy.MUST_SAVE]
    hd, kv = cfg.resolved_head_dim, cfg.n_kv_heads
    per_layer = sorted([cfg.n_heads * hd, kv * hd, kv * hd, cfg.d_model, cfg.d_ff, cfg.d_ff,
                        cfg.d_model])
    assert sorted(w[-1] for _, _, w in kept) == sorted(per_layer * cfg.n_layers)
    assert all(a[-2] == b * s for _, a, _ in kept)  # rows: every token, no batch dim
    assert {op for op, _, _ in kept} == {aten.mm.default, aten.bmm.default}
    batched = [a for op, a, _, d in decisions if op is aten.bmm.default and a[0] > 1]
    assert batched and all(d == CheckpointPolicy.PREFER_RECOMPUTE for op, a, _, d in decisions
                           if op is aten.bmm.default and a[0] > 1)
    q_shape = (b, s, kv, cfg.n_heads // kv, hd)  # FlashAttentionFn's saved q
    assert q_shape in saved_shapes["none"]
    assert q_shape not in saved_shapes["dots"]
    assert sorted(saved_shapes["dots"]) == sorted(saved_shapes["full"])


def test_forward_return_hidden(setup):
    cfg, jcfg, jstate, np_state = setup
    toks = _batch(cfg, seed=6)["tokens"]
    want, _, _ = JM.forward(jcfg, jstate.params, {"tokens": jnp.asarray(toks)},
                            return_hidden=True)
    params = lm_params_from_jax(np_state.params, cfg, device="cpu")
    with torch.no_grad():
        got, _, _ = M.forward(cfg, params, {"tokens": torch.from_numpy(toks)},
                              return_hidden=True)
    assert got.shape == (4, 16, cfg.d_model)
    _close(got.numpy(), want, rel=1e-5)


# ---------------------------------------------------------------------------
# whole train steps
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def setup_bf16():
    """The reduced config at the reference's default run (bf16 params, fp32
    moments), remat "none"; the JAX state made once."""
    cfg, jcfg = get_config(ARCH, reduced=True), j_get_config(ARCH, reduced=True)
    jrun = J_DEFAULT_RUN.replace(remat="none", warmup_steps=2)
    jstate = j_init_train_state(jcfg, jrun, KEY)
    assert jax.tree_util.tree_leaves(jstate.params)[0].dtype == jnp.bfloat16
    np_state = jax.tree_util.tree_map(lambda x: np.asarray(x, np.float32), jstate)
    return cfg, jcfg, jrun, jstate, np_state


def test_bf16_step0_gradients_match_jax(setup_bf16):
    """One bf16 loss and every bf16 gradient leaf against `jax.grad` of the
    reference's `lm_loss` at bf16."""
    cfg, jcfg, _, jstate, np_state = setup_bf16
    batch = make_pipeline(cfg, 16, 4, seed=8).batch_at(0)
    jl, jg = jax.value_and_grad(lambda p: JM.lm_loss(
        jcfg, p, {k: jnp.asarray(v) for k, v in batch.items()}, remat="none"))(jstate.params)
    params = lm_params_from_jax(np_state.params, cfg, device="cpu", dtype=torch.bfloat16)
    loss, grads = loss_and_grads(cfg, DEFAULT_RUN.replace(remat="none"), params,
                                 {k: torch.from_numpy(v) for k, v in batch.items()})
    assert abs(float(loss) - float(jl)) <= 1e-2 * abs(float(jl))
    jleaves = dict(_leaves(jax.tree_util.tree_map(lambda x: np.asarray(x, np.float32), jg)))
    for path, g in _leaves(tree_map(lambda t: t.float(), grads)):
        assert grads is not None and g.shape == jleaves[path].shape, path
        want = jleaves[path]
        assert np.abs(g - want).max() <= 5e-2 * np.abs(want).max(), path
    assert all(t.dtype == torch.bfloat16 for t in tree_leaves(grads))


def test_three_bf16_train_steps_match_jax(setup_bf16):
    """Three steps at the reference's default types: the port's state built
    by `train_state_from_jax(dtype=torch.bfloat16)` (exact: the JAX bf16
    leaves cross widened), loss and grad norm per step against the JAX
    package's `make_train_step`."""
    cfg, jcfg, jrun, jstate, np_state = setup_bf16
    jstep = jax.jit(j_make_train_step(jcfg, jrun, 10))
    step = make_train_step(cfg, DEFAULT_RUN.replace(remat="none", warmup_steps=2), 10,
                           device="cpu")
    state = train_state_from_jax(np_state, cfg, device="cpu", dtype=torch.bfloat16)
    assert all(torch.equal(a.float(), torch.from_numpy(b)) for a, b in zip(
        tree_leaves(state.params), jax.tree_util.tree_leaves(np_state.params)))
    pipe = make_pipeline(cfg, 16, 4, seed=8)
    for s in range(3):
        batch = pipe.batch_at(s)
        jstate, jm = jstep(jstate, {k: jnp.asarray(v) for k, v in batch.items()})
        state, m = step(state, batch)
        assert abs(float(m["loss"]) - float(jm["loss"])) <= 1e-2 * float(jm["loss"])
        assert abs(float(m["grad_norm"]) - float(jm["grad_norm"])) <= \
            3e-2 * float(jm["grad_norm"])
    assert int(state.opt.step) == int(jstate.opt.step) == 3
    assert all(t.dtype == torch.bfloat16 for t in tree_leaves(state.params))
    assert all(t.dtype == torch.float32 for t in tree_leaves(state.opt.m))


@pytest.mark.parametrize("grad_accum", [1, 2])
def test_three_train_steps_match_jax(setup, grad_accum):
    """Loss, grad norm, lr and the final params after 3 steps; warm-up of 2
    steps so the updates are not vanishingly small."""
    cfg, jcfg, jstate, np_state = setup
    jrun = J_RUN.replace(grad_accum=grad_accum, warmup_steps=2)
    run = RUN.replace(grad_accum=grad_accum, warmup_steps=2)
    jstep = jax.jit(j_make_train_step(jcfg, jrun, 10))
    step = make_train_step(cfg, run, 10, device="cpu")
    state = train_state_from_jax(np_state, cfg, device="cpu")
    pipe = make_pipeline(cfg, 16, 4, seed=8)
    for s in range(3):
        batch = pipe.batch_at(s)
        jstate, jm = jstep(jstate, {k: jnp.asarray(v) for k, v in batch.items()})
        state, m = step(state, batch)
        for k in ("loss", "grad_norm"):
            _close(float(m[k]), float(jm[k]), rel=1e-5, floor=0)
        assert abs(float(m["lr"]) - float(jm["lr"])) <= 1e-7 * float(jm["lr"])
    assert int(state.opt.step) == int(jstate.opt.step) == 3
    _assert_trees_close(state.params, jstate.params)


def test_train_step_leaves_the_state_without_history(setup):
    """The step updates the state's tensors in place and leaves no autograd
    history on them."""
    cfg, _, _, np_state = setup
    state = train_state_from_jax(np_state, cfg, device="cpu")
    before = state.params["embed"].clone()
    state2, _ = make_train_step(cfg, RUN.replace(warmup_steps=0), 10,
                                device="cpu")(state, _batch(cfg))
    assert state2.params["embed"] is state.params["embed"]
    assert not torch.equal(before, state2.params["embed"])
    assert all(not t.requires_grad and t.grad_fn is None
               for t in tree_leaves(state2.params) + tree_leaves(state2.opt.m))


def test_copy_task_learns():
    """Mirrors tests/test_system.py::test_training_learns_copy_task."""
    cfg = get_config(ARCH, reduced=True)
    run = RUN.replace(learning_rate=3e-3, warmup_steps=5)
    step = make_train_step(cfg, run, 60, device="cpu")
    state = init_train_state(cfg, run, torch.Generator().manual_seed(0), device="cpu")
    toks = np.tile(np.array([5, 9, 2, 7], np.int32), (4, 16))[:, :33]
    batch = {"tokens": toks[:, :-1], "labels": toks[:, 1:]}
    first = None
    for _ in range(40):
        state, m = step(state, batch)
        first = float(m["loss"]) if first is None else first
    assert float(m["loss"]) < first * 0.5, (first, float(m["loss"]))


# ---------------------------------------------------------------------------
# checkpoints, restart, launcher
# ---------------------------------------------------------------------------


def test_checkpoint_roundtrip_keep_k_and_atomic_commit(tmp_path):
    ckpt = CheckpointManager(tmp_path, keep=2)
    tree = {"a": torch.arange(5, dtype=torch.float32), "n": {"b": torch.ones((2, 3))},
            "i": torch.tensor(7, dtype=torch.int32)}
    for s in (1, 2, 3, 4):
        tree["a"] += 1  # in place after the save: the snapshot must not move
        ckpt.save(s, tree, extra={"step": s})
    ckpt.wait()
    assert ckpt.all_steps() == [3, 4]
    assert (tmp_path / "latest").read_text() == "step_00000004"
    restored, meta = ckpt.restore(tree)
    assert torch.equal(restored["a"], torch.arange(5, dtype=torch.float32) + 4)
    assert restored["i"].dtype == torch.int32 and int(restored["i"]) == 7
    assert meta["step"] == 4
    (tmp_path / "tmp.9").mkdir()
    (tmp_path / "step_00000009").mkdir()  # no arrays.npz: incomplete
    assert ckpt.all_steps() == [3, 4]
    ckpt.close()


def test_checkpoint_keys_are_the_reference_paths(setup, tmp_path):
    """The port's and the JAX package's managers write the same npz keys for
    a TrainState, and a JAX checkpoint restores into the port's state."""
    cfg, jcfg, jstate, np_state = setup
    jck = JCheckpointManager(tmp_path / "jax", keep=1)
    jck.save(3, jstate, extra={"step": 3}, block=True)
    state = train_state_from_jax(np_state, cfg, device="cpu")
    save_tree(state, tmp_path / "port")
    with np.load(tmp_path / "jax" / "step_00000003" / "arrays.npz") as zj, \
            np.load(tmp_path / "port" / "arrays.npz") as zp:
        assert sorted(zj.files) == sorted(zp.files)
        assert "opt/step" in zp.files and "params/groups/sub0/mix/wq" in zp.files
    like = init_train_state(cfg, RUN, torch.Generator().manual_seed(1), device="cpu")
    ck = CheckpointManager(tmp_path / "jax", keep=1)
    restored, meta = ck.restore(like)
    assert meta["step"] == 3 and int(restored.opt.step) == 0
    _assert_trees_close(restored.params, jstate.params, rel=0, floor=0)
    _assert_trees_close(restored.opt.m, jstate.opt.m, rel=0, floor=0)
    back = restore_tree(like, tmp_path / "port")
    _assert_trees_close(back.params, jstate.params, rel=0, floor=0)
    ck.close()


def _supervised(tmp, steps=10, fail_at=()):
    cfg = get_config(ARCH, reduced=True)
    run = RUN.replace(warmup_steps=2)
    state = init_train_state(cfg, run, torch.Generator().manual_seed(0), device="cpu")
    ckpt = CheckpointManager(tmp, keep=2)
    sup = Supervisor(train_step=make_train_step(cfg, run, steps, device="cpu"),
                     pipeline=make_pipeline(cfg, 32, 2, seed=7), ckpt=ckpt,
                     checkpoint_every=3,
                     injector=FailureInjector(fail_at=fail_at) if fail_at else None)
    return sup, state, ckpt


def test_restart_is_exact(tmp_path):
    """Mirrors tests/test_checkpoint_runtime.py::test_restart_is_bit_exact:
    an uninterrupted run against one that fails at step 7, restores step 6
    and replays."""
    sup1, state1, ck1 = _supervised(tmp_path / "a")
    _, hist1 = sup1.run(state1, 10)
    restarts = []
    sup2, state2, ck2 = _supervised(tmp_path / "b", fail_at=(7,))
    sup2.on_restart = restarts.append
    _, hist2 = sup2.run(state2, 10)
    assert restarts == [6]
    l1 = {h["step"]: h["loss"] for h in hist1}
    l2 = {h["step"]: h["loss"] for h in hist2}
    assert sorted(l1) == sorted(l2) == list(range(10))
    for s in range(10):
        assert abs(l1[s] - l2[s]) < 1e-6, (s, l1[s], l2[s])
    assert ck1.all_steps() == [9, 10]
    ck1.close()
    ck2.close()


def test_failure_injector_and_straggler_monitor():
    inj = FailureInjector(fail_at=(2,))
    inj.maybe_fail(1)
    with pytest.raises(SimulatedFailure):
        inj.maybe_fail(2)
    inj.maybe_fail(2)  # fires once
    mon = StragglerMonitor(z_thresh=3.0, warmup_steps=3)
    for s in range(20):
        mon.observe(s, 0.10 + 0.001 * (s % 3))
    assert not mon.flagged
    mon.observe(20, 0.9)
    assert len(mon.flagged) == 1 and mon.flagged[0][0] == 20


def test_train_runs_on_the_host_and_resumes(tmp_path):
    state, hist = train(ARCH, steps=3, global_batch=2, seq_len=16, ckpt_dir=tmp_path,
                        checkpoint_every=2, device="cpu")
    assert [h["step"] for h in hist] == [0, 1, 2]
    assert all(np.isfinite(h["loss"]) and h["step_ms"] > 0 for h in hist)
    assert int(state.opt.step) == 3
    # the reference launcher's types: bf16 parameters, fp32 moments
    assert all(t.dtype == torch.bfloat16 for t in tree_leaves(state.params))
    assert all(t.dtype == torch.float32 for t in tree_leaves(state.opt.m)
               + tree_leaves(state.opt.v))
    assert CheckpointManager(tmp_path).all_steps() == [2, 3]
    state2, hist2 = train(ARCH, steps=4, global_batch=2, seq_len=16, ckpt_dir=tmp_path,
                          checkpoint_every=2, device="cpu")
    assert [h["step"] for h in hist2] == [3] and int(state2.opt.step) == 4


def test_configs_keep_the_reference_run_fields():
    import repro.configs.base as jbase

    assert dataclasses.asdict(DEFAULT_RUN) == dataclasses.asdict(jbase.RunConfig())


def test_shape_table_matches_the_reference():
    import repro.configs.base as jbase
    from repro_torch.configs import base as pbase

    assert {k: dataclasses.asdict(v) for k, v in pbase.SHAPES.items()} == \
        {k: dataclasses.asdict(v) for k, v in jbase.SHAPES.items()}
    assert dataclasses.asdict(pbase.ShapeConfig("custom_train", 128, 8, "train")) == \
        dataclasses.asdict(jbase.ShapeConfig("custom_train", 128, 8, "train"))
    for reduced in (False, True):
        cfg, jcfg = get_config(ARCH, reduced=reduced), j_get_config(ARCH, reduced=reduced)
        for name in jbase.SHAPES:
            assert pbase.shape_applicable(cfg, pbase.SHAPES[name]) == \
                jbase.shape_applicable(jcfg, jbase.SHAPES[name])
        long_ctx = dataclasses.replace(cfg, family="hybrid")
        assert pbase.shape_applicable(long_ctx, pbase.SHAPES["long_500k"]) == (True, "")


@pytest.mark.parametrize("reduced", [False, True])
def test_n_params_match_the_reference(reduced):
    """`n_params` / `n_active_params` from the shapes alone, equal to the
    reference's for qwen3-0.6b full and reduced; the full count well under a
    second, with nothing allocated."""
    import time

    cfg, jcfg = get_config(ARCH, reduced=reduced), j_get_config(ARCH, reduced=reduced)
    t0 = time.perf_counter()
    n = cfg.n_params()
    assert time.perf_counter() - t0 < 0.5
    assert n == jcfg.n_params() and cfg.n_active_params() == jcfg.n_active_params() == n
    if not reduced:
        assert n == 596_049_920
