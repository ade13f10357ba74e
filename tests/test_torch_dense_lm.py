"""The port's dense LM family beyond qwen3-0.6b (minitron-8b with its
non-gated squared-ReLU FFN and `ffn_sparsity="block_ecr"`, stablelm-12b,
mistral-large-123b) against the JAX package, at the REDUCED configs: configs,
the init tree, `forward`, prefill plus teacher-forced decode over fp32 and
int8 KV caches, `n_params`, three bf16 train steps; the block-masked FFN
(`sparse_ffn_apply`, `sparse_ffn_stats`); `init_params`' leaf-by-leaf move;
and the flash entry points' head dims (stablelm-12b's 160). JAX weights are
carried over as numpy with `lm_params_from_jax`; the JAX side runs without a
mesh.

Tolerances (those of `tests/test_torch_lm.py` and `tests/test_torch_train.py`):
- logits: max|port - jax| <= 1e-4 * max|jax| + 1e-6;
- fp32 cache contents: max|port - jax| <= 1e-5 * max|jax| + 1e-6 (qwen3's
  test holds each entry at rtol = atol = 1e-5, which its qk_norm allows by
  keeping K near 1; without it K reaches ~12 here, and an entry near 0
  carries the absolute fp32 noise of the large ones); int8 cache values
  within 1 step, scales at 1e-5 relative;
- bf16 train steps: loss within 1e-2 relative per step; with qk_norm on,
  grad norm within 3e-2 relative per step and step-0 gradient leaves within
  5e-2 * max|leaf| (the registered configs saturate their softmax, where
  bf16 rounding decides the gradients: see the test); fp32 steps: loss
  1e-4, grad norm 1e-3 relative per step;
- `sparse_ffn_apply`'s y: rtol = atol = 1e-5 (the reference test's); its
  occupancy and `sparse_ffn_stats` exactly equal where both sides compute
  the same h (inputs on a dyadic grid, so x @ w1 is exact in fp32). On
  normal inputs h may differ in sign where x @ w1 is within fp32 noise of 0:
  there the element sparsity may differ by the share of such entries (at
  most |x @ w1| <= 1e-5 * max), and the block statistics are held equal
  only when no block holds such an entry alone.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.configs import DEFAULT_RUN as J_DEFAULT_RUN  # noqa: E402
from repro.configs import get_config as j_get_config  # noqa: E402
from repro.core.sparse_ffn import sparse_ffn_apply as j_sparse_ffn_apply  # noqa: E402
from repro.core.sparse_ffn import sparse_ffn_stats as j_sparse_ffn_stats  # noqa: E402
from repro.launch.steps import init_train_state as j_init_train_state  # noqa: E402
from repro.launch.steps import make_train_step as j_make_train_step  # noqa: E402
from repro.models import model as JM  # noqa: E402
from repro_torch.configs.base import DEFAULT_RUN, get_config  # noqa: E402
from repro_torch.convert import lm_params_from_jax, train_state_from_jax  # noqa: E402
from repro_torch.core.sparse_ffn import sparse_ffn_apply, sparse_ffn_stats  # noqa: E402
from repro_torch.data import make_pipeline  # noqa: E402
from repro_torch.kernels import cuda as kcuda  # noqa: E402
from repro_torch.launch.serve import serve  # noqa: E402
from repro_torch.launch.steps import loss_and_grads, make_train_step  # noqa: E402
from repro_torch.models import model as M  # noqa: E402
from repro_torch.models.layers import embed_init, ones_init  # noqa: E402
from repro_torch.models.transformer import group_layout, init_sublayer  # noqa: E402
from repro_torch.tree import tree_leaves  # noqa: E402

ARCHS = ["minitron-8b", "stablelm-12b", "mistral-large-123b"]
KEY = jax.random.PRNGKey(0)
# the reference's advertised sizes (`tests/test_models.py::test_param_counts_match_spec`)
SPEC_SIZES = {"minitron-8b": 8e9, "stablelm-12b": 12e9, "mistral-large-123b": 123e9}


def _close_logits(got, want):
    got, want = np.asarray(got, np.float32), np.asarray(want, np.float32)
    err = float(np.abs(got - want).max())
    scale = float(np.abs(want).max())
    assert err <= 1e-4 * scale + 1e-6, (err, scale)


@pytest.fixture(scope="module", params=ARCHS)
def model(request):
    arch = request.param
    cfg = get_config(arch, reduced=True)
    jcfg = j_get_config(arch, reduced=True)
    jparams, _ = JM.init_params(jcfg, KEY)
    np_params = jax.tree_util.tree_map(np.asarray, jparams)
    return cfg, jcfg, jparams, lm_params_from_jax(np_params, cfg, device="cpu")


def _tokens(cfg, b, s, seed=0):
    return np.random.default_rng(seed).integers(0, cfg.vocab_size, (b, s)).astype(np.int32)


# ---------------------------------------------------------------------------
# configs, parameter counts
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("reduced", [True, False])
@pytest.mark.parametrize("arch", ARCHS)
def test_configs_match_the_reference(arch, reduced):
    port = dataclasses.asdict(get_config(arch, reduced=reduced))
    assert port == dataclasses.asdict(j_get_config(arch, reduced=reduced))
    assert port["family"] == "dense"


def test_minitron_is_the_block_ecr_relu2_config():
    cfg = get_config("minitron-8b")
    assert (cfg.mlp_activation, cfg.ffn_sparsity) == ("relu2", "block_ecr")
    assert get_config("stablelm-12b").resolved_head_dim == 160


@pytest.mark.parametrize("reduced", [False, True])
@pytest.mark.parametrize("arch", ARCHS)
def test_n_params_match_the_reference(arch, reduced):
    """`n_params` / `n_active_params` from the shapes alone equal the
    reference's `count_params_analytic`; the full configs land within
    0.55-1.45 of the advertised size, as the reference's own test holds."""
    cfg, jcfg = get_config(arch, reduced=reduced), j_get_config(arch, reduced=reduced)
    n = cfg.n_params()
    assert n == JM.count_params_analytic(jcfg) == cfg.n_active_params()
    if not reduced:
        assert 0.55 * SPEC_SIZES[arch] <= n <= 1.45 * SPEC_SIZES[arch], n


@pytest.mark.parametrize("arch", ARCHS)
def test_supports_long_context(arch):
    """The dense archs are full-attention (`tests/test_models.py::test_long_context_flags`)."""
    assert get_config(arch).supports_long_context is False
    assert get_config(arch).supports_long_context == j_get_config(arch).supports_long_context


# ---------------------------------------------------------------------------
# init, forward, prefill + decode
# ---------------------------------------------------------------------------


def test_init_params_has_the_reference_tree(model):
    cfg, _, jparams, _ = model
    port = M.init_params(cfg, torch.Generator().manual_seed(0), device="cpu")
    jshapes = jax.tree_util.tree_map(lambda a: tuple(a.shape), jparams)

    def shapes(t):
        return {k: shapes(v) for k, v in t.items()} if isinstance(t, dict) else tuple(t.shape)

    assert shapes(port) == jshapes
    ffn = port["groups"]["sub0"]["ffn"]
    assert ("w3" in ffn) == (cfg.mlp_activation not in ("relu", "relu2"))


def _host_only_draw(cfg, seed, dtype):
    """The whole tree drawn on the host in `init_params`' order, stacked, and
    only then cast: what `init_params` made before it moved leaf by leaf."""
    gen = torch.Generator().manual_seed(seed)
    d, v = cfg.d_model, cfg.vocab_size
    embed = embed_init(gen, (v, d))
    layers = [init_sublayer(gen, s, cfg) for _ in range(cfg.n_layers)
              for s in group_layout(cfg)]

    def stack(trees):
        if isinstance(trees[0], dict):
            return {k: stack([t[k] for t in trees]) for k in trees[0]}
        return torch.stack(trees)

    p = {"embed": embed, "final_norm": ones_init((d,)), "groups": {"sub0": stack(layers)}}
    if not cfg.tie_embeddings:
        p["unembed"] = embed_init(gen, (d, v))
    return _cast(p, dtype)


def _cast(tree, dtype):
    if isinstance(tree, dict):
        return {k: _cast(v, dtype) for k, v in tree.items()}
    return tree.to(dtype)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("arch", ARCHS + ["qwen3-0.6b"])
def test_init_params_moves_leaf_by_leaf_bitwise(arch, dtype):
    """Each leaf placed as it is drawn, then copied into its stacked slot:
    the tree is bitwise the host-only draw, leaf for leaf, in `dtype`."""
    cfg = get_config(arch, reduced=True)
    got = M.init_params(cfg, torch.Generator().manual_seed(3), device="cpu", dtype=dtype)
    want = _host_only_draw(cfg, 3, dtype)
    assert sorted(got) == sorted(want)
    for a, b in zip(tree_leaves(got), tree_leaves(want)):
        assert a.dtype == b.dtype == dtype and torch.equal(a, b)


def test_init_params_places_every_leaf_as_it_is_drawn(monkeypatch):
    """`init_params` hands each drawn leaf to its device move before the
    next one is drawn: the host never holds two undelivered draws."""
    import repro_torch.models.layers as L

    cfg = get_config("minitron-8b", reduced=True)
    pending = []
    peak = [0]
    orig = L.dense_init

    def dense_init(*a, **kw):
        t = orig(*a, **kw)
        pending.append(t)
        peak[0] = max(peak[0], len(pending))
        return t

    real_to = torch.Tensor.to

    def to(self, *a, **kw):
        if any(self is p for p in pending):
            pending[:] = [p for p in pending if p is not self]
        return real_to(self, *a, **kw)

    import repro_torch.models.attention as A
    import repro_torch.models.transformer as T

    monkeypatch.setattr(A, "dense_init", dense_init)
    monkeypatch.setattr(T, "dense_init", dense_init)
    monkeypatch.setattr(torch.Tensor, "to", to)
    M.init_params(cfg, torch.Generator().manual_seed(0), device="cpu", dtype=torch.bfloat16)
    assert peak[0] == 1 and not pending


def test_forward_matches_jax(model):
    cfg, jcfg, jparams, params = model
    toks = _tokens(cfg, 2, 12)
    want, _, _ = JM.forward(jcfg, jparams, {"tokens": jnp.asarray(toks)})
    with torch.no_grad():
        got, _, aux = M.forward(cfg, params, {"tokens": torch.from_numpy(toks)})
    assert got.shape == (2, 12, cfg.vocab_size) and float(aux) == 0.0
    _close_logits(got.numpy(), want)


@pytest.mark.parametrize("kv_dtype", ["float32", "int8"])
def test_prefill_and_decode_match_jax(model, kv_dtype):
    cfg, jcfg, jparams, params = model
    b, s, pre = 2, 12, 5
    toks = _tokens(cfg, b, s, seed=1)
    jdt, tdt = (jnp.int8, torch.int8) if kv_dtype == "int8" else (jnp.float32, torch.float32)
    jcache, _ = JM.init_cache(jcfg, b, s + 4, jdt)
    cache = M.init_cache(cfg, b, s + 4, tdt, device="cpu")
    jl, jcache = JM.prefill(jcfg, jparams, jcache, {"tokens": jnp.asarray(toks[:, :pre])})
    with torch.no_grad():
        lg, cache = M.prefill(cfg, params, cache, {"tokens": torch.from_numpy(toks[:, :pre])})
        _close_logits(lg.numpy(), jl)
        for t in range(pre, s):
            jl, jcache = JM.decode_step(jcfg, jparams, jcache,
                                        {"tokens": jnp.asarray(toks[:, t:t + 1])},
                                        jnp.int32(t))
            lg, cache = M.decode_step(cfg, params, cache,
                                      {"tokens": torch.from_numpy(toks[:, t:t + 1])}, t)
            _close_logits(lg.numpy(), jl)
    (jc,), (c,) = jcache, cache
    if kv_dtype == "int8":
        for a, ja in ((c.k, jc.k), (c.v, jc.v)):
            assert a.dtype == torch.int8
            assert int(np.abs(a.numpy().astype(np.int32) - np.asarray(ja, np.int32)).max()) <= 1
        for a, ja in ((c.k_scale, jc.k_scale), (c.v_scale, jc.v_scale)):
            np.testing.assert_allclose(a.numpy(), np.asarray(ja), rtol=1e-5, atol=0)
    else:
        for a, ja in ((c.k, jc.k), (c.v, jc.v)):
            ja = np.asarray(ja)
            assert np.abs(a.numpy() - ja).max() <= 1e-5 * np.abs(ja).max() + 1e-6


@pytest.mark.parametrize("arch", ARCHS)
def test_serve_is_greedy_on_the_host(arch):
    """The launcher serves each arch (reduced) and its tokens are the argmax
    of the model's own forward on the same weights; given `params`, it
    serves those and draws none."""
    res = serve(arch, reduced=True, batch=2, prompt_len=6, gen_len=3, device="cpu", seed=3)
    cfg = get_config(arch, reduced=True)
    params = M.init_params(cfg, torch.Generator().manual_seed(3), device="cpu")
    seq = torch.cat([res.prompt, res.tokens], 1)
    with torch.no_grad():
        full, _, _ = M.forward(cfg, params, {"tokens": seq})
    assert torch.equal(full[:, 5:8].argmax(-1).to(torch.int32), res.tokens)
    again = serve(arch, reduced=True, batch=2, prompt_len=6, gen_len=3, device="cpu",
                  seed=3, params=params, kv_cache_dtype="int8")
    assert tuple(again.tokens.shape) == (2, 3) and torch.equal(again.prompt, res.prompt)


# ---------------------------------------------------------------------------
# three bf16 train steps
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("qk_norm", [False, True], ids=["registered", "qk_norm"])
@pytest.mark.parametrize("arch", ARCHS)
def test_three_bf16_train_steps_match_jax(arch, qk_norm):
    """Three steps at the reference's default types (bf16 params, fp32
    moments), remat "none", from the same state as the JAX package's
    `make_train_step`: the loss per step within 1e-2 relative; with
    qk_norm on, the grad norm per step within 3e-2 relative and the step-0
    gradient leaves within 5e-2 * max|leaf| too. The registered configs hold
    the loss only: without qk_norm their scores have a std of ~32 (wq, wk
    drawn at fan-in n_heads), the softmax saturates, and bf16 rounding
    decides their gradients (the JAX package's own bf16 and fp32 grad norms
    on one set of weights differ ~3x; `test_fp32_train_steps_match_jax`
    holds those configs' gradients)."""
    cfg = dataclasses.replace(get_config(arch, reduced=True), qk_norm=qk_norm)
    jcfg = dataclasses.replace(j_get_config(arch, reduced=True), qk_norm=qk_norm)
    jrun = J_DEFAULT_RUN.replace(remat="none", warmup_steps=2)
    run = DEFAULT_RUN.replace(remat="none", warmup_steps=2)
    jstate = j_init_train_state(jcfg, jrun, KEY)
    np_state = jax.tree_util.tree_map(lambda x: np.asarray(x, np.float32), jstate)
    pipe = make_pipeline(cfg, 16, 4, seed=8)
    if qk_norm:
        batch = pipe.batch_at(0)
        jg = jax.grad(lambda p: JM.lm_loss(
            jcfg, p, {k: jnp.asarray(v) for k, v in batch.items()}, remat="none"))(jstate.params)
        params = lm_params_from_jax(np_state.params, cfg, device="cpu", dtype=torch.bfloat16)
        _, grads = loss_and_grads(cfg, run, params,
                                  {k: torch.from_numpy(v) for k, v in batch.items()})
        for g, want in zip(tree_leaves(grads), jax.tree_util.tree_leaves(jg)):
            want = np.asarray(want, np.float32)
            assert np.abs(g.float().numpy() - want).max() <= 5e-2 * np.abs(want).max()
    jstep = jax.jit(j_make_train_step(jcfg, jrun, 10))
    step = make_train_step(cfg, run, 10, device="cpu")
    state = train_state_from_jax(np_state, cfg, device="cpu", dtype=torch.bfloat16)
    for s in range(3):
        batch = pipe.batch_at(s)
        jstate, jm = jstep(jstate, {k: jnp.asarray(v) for k, v in batch.items()})
        state, m = step(state, batch)
        assert abs(float(m["loss"]) - float(jm["loss"])) <= 1e-2 * float(jm["loss"])
        assert np.isfinite(float(m["grad_norm"]))
        if qk_norm:
            assert abs(float(m["grad_norm"]) - float(jm["grad_norm"])) <= \
                3e-2 * float(jm["grad_norm"])
    assert int(state.opt.step) == int(jstate.opt.step) == 3
    assert all(t.dtype == torch.bfloat16 for t in tree_leaves(state.params))
    assert all(t.dtype == torch.float32 for t in tree_leaves(state.opt.m))


@pytest.mark.parametrize("arch", ARCHS)
def test_fp32_train_steps_match_jax(arch):
    """Three fp32 steps of the registered reduced configs against the JAX
    package's at `param_dtype="float32"`: loss within 1e-4 and grad norm
    within 1e-3 relative per step (the fp32 limits of the card's trainer
    check; the saturated softmax amplifies fp32 noise to ~2e-4 in the grad
    norm by step 3, and AdamW's division by sqrt(v) moves single entries by
    a whole update where a gradient sits near 0, so the params are not held
    leaf by leaf)."""
    cfg, jcfg = get_config(arch, reduced=True), j_get_config(arch, reduced=True)
    jrun = J_DEFAULT_RUN.replace(remat="none", warmup_steps=2, param_dtype="float32")
    jstate = j_init_train_state(jcfg, jrun, KEY)
    np_state = jax.tree_util.tree_map(np.asarray, jstate)
    jstep = jax.jit(j_make_train_step(jcfg, jrun, 10))
    step = make_train_step(cfg, DEFAULT_RUN.replace(remat="none", warmup_steps=2,
                                                    param_dtype="float32"), 10, device="cpu")
    state = train_state_from_jax(np_state, cfg, device="cpu")
    pipe = make_pipeline(cfg, 16, 4, seed=8)
    for s in range(3):
        batch = pipe.batch_at(s)
        jstate, jm = jstep(jstate, {k: jnp.asarray(v) for k, v in batch.items()})
        state, m = step(state, batch)
        assert abs(float(m["loss"]) - float(jm["loss"])) <= 1e-4 * float(jm["loss"])
        assert abs(float(m["grad_norm"]) - float(jm["grad_norm"])) <= \
            1e-3 * float(jm["grad_norm"])
    assert int(state.opt.step) == int(jstate.opt.step) == 3


# ---------------------------------------------------------------------------
# the block-masked FFN
# ---------------------------------------------------------------------------


def _dyadic(rng, shape, lo, hi, denom):
    """Values k / denom for integers k in [lo, hi]: sums of their products
    stay exact in fp32 at these sizes."""
    return (rng.integers(lo, hi + 1, shape) / denom).astype(np.float32)


def _ffn_inputs(t, d, f, seed, kind):
    rng = np.random.default_rng(seed)
    if kind == "normal":  # the reference test's inputs, from numpy
        return (rng.standard_normal((t, d)).astype(np.float32),
                (0.1 * rng.standard_normal((d, f))).astype(np.float32),
                (0.1 * rng.standard_normal((f, d))).astype(np.float32))
    x = _dyadic(rng, (t, d), -2, 2, 1)
    w1 = _dyadic(rng, (d, f), -3, 1, 8)  # mostly negative: many exact zeros after ReLU
    w1[:, : f // 3] = -np.abs(w1[:, : f // 3])  # whole dead column blocks ...
    x[: t // 2] = np.abs(x[: t // 2])          # ... over nonnegative rows
    w2 = (0.1 * rng.standard_normal((f, d))).astype(np.float32)
    return x, w1, w2


# (T, D, F, input kind): 8 | T and 128 | F; the fallbacks bt = 1 (8 does not
# divide T) and bf = F (128 does not divide F); the reference test's shape
FFN_CASES = [(32, 64, 384, "dyadic"), (30, 64, 384, "dyadic"), (32, 64, 200, "dyadic"),
             (30, 48, 200, "dyadic"), (32, 64, 256, "normal")]


@pytest.mark.parametrize("activation", ["relu2", "relu"])
@pytest.mark.parametrize("case", FFN_CASES, ids=lambda c: "-".join(map(str, c)))
def test_sparse_ffn_matches_jax(case, activation):
    t, d, f, kind = case
    x, w1, w2 = _ffn_inputs(t, d, f, seed=t + f, kind=kind)
    jy, jocc = j_sparse_ffn_apply(jnp.asarray(x), jnp.asarray(w1), jnp.asarray(w2),
                                  activation, block=(8, 128))
    y, occ = sparse_ffn_apply(torch.from_numpy(x), torch.from_numpy(w1),
                              torch.from_numpy(w2), activation, block=(8, 128))
    np.testing.assert_allclose(y.numpy(), np.asarray(jy), rtol=1e-5, atol=1e-5)
    jst = j_sparse_ffn_stats(jnp.asarray(x), jnp.asarray(w1), activation)
    st = sparse_ffn_stats(torch.from_numpy(x), torch.from_numpy(w1), activation)
    assert sorted(st) == sorted(jst)
    if kind == "dyadic":  # the same h on both sides: every statistic equal
        assert float(occ) == float(jocc)
        assert st == jst
        assert 0.0 < st["element_sparsity"] < 1.0
    else:
        pre = x @ w1
        ambiguous = float((np.abs(pre) <= 1e-5 * np.abs(pre).max()).mean())
        assert abs(st["element_sparsity"] - jst["element_sparsity"]) <= ambiguous
        assert abs(float(occ) - float(jocc)) <= 1e-7
        assert st["block_occupancy"] == pytest.approx(jst["block_occupancy"], abs=1e-7)
    assert st["skippable_flop_frac"] == pytest.approx(1.0 - st["block_occupancy"], abs=1e-7)


@pytest.mark.parametrize("activation", ["relu2", "relu"])
def test_sparse_ffn_apply_equals_the_dense_ffn_bitwise(activation):
    """The mask removes only all-zero blocks of h, so y is the dense FFN's
    product on the same h, bit for bit; the occupancy counts live blocks."""
    x, w1, w2 = (torch.from_numpy(a) for a in _ffn_inputs(32, 64, 384, 5, "dyadic"))
    y, occ = sparse_ffn_apply(x, w1, w2, activation)
    act = torch.relu(x @ w1)
    h = act * act if activation == "relu2" else act
    assert torch.equal(y, h @ w2)
    live = (h.reshape(4, 8, 3, 128) != 0).any(3).any(1).float().mean()
    assert float(occ) == float(live) and 0.0 < float(occ) < 1.0


# ---------------------------------------------------------------------------
# flash entry points and their head dims
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("entry", sorted(kcuda.FLASH_ENTRY_HEAD_DIMS))
def test_flash_entry_head_dims(entry):
    """stablelm-12b's head dim 160: the fp32 and int8 K/V forwards take it;
    the bf16 forward and the backward passes refuse it, naming the ROADMAP
    item that brings it; every entry takes 8 ... 256 and refuses 96."""
    q = torch.zeros((1, 1, 4, 160))
    takes = entry in ("repro_flash_fwd_f32", "repro_flash_fwd_q8")
    if takes:
        kcuda._check_flash_kernel(entry, 1, 1, 160, (q,))
    else:
        with pytest.raises(ValueError, match=r"ROADMAP queue 2 item \[10\]"):
            kcuda._check_flash_kernel(entry, 1, 1, 160, (q,))
    for d in (8, 16, 32, 64, 128, 256):
        kcuda._check_flash_kernel(entry, 1, 1, d, (torch.zeros((1, d)),))
    with pytest.raises(ValueError, match="head dims"):
        kcuda._check_flash_kernel(entry, 1, 1, 96, (torch.zeros((1, 96)),))
    assert set(kcuda.FLASH_ENTRY_HEAD_DIMS) == set(kcuda.FLASH_ENTRY_LAUNCHES)


@pytest.mark.parametrize("kv_dtype", ["float32", "int8"])
def test_stablelm_head_dim_160_forward_matches_jax(kv_dtype):
    """A 2-layer stablelm-12b slice at its real head dim 160 (d_model 640
    over 4 heads, reduced elsewhere) through prefill + decode, against the
    JAX package: the shapes row 9 and row 10 serve at on the card."""
    jcfg = dataclasses.replace(j_get_config("stablelm-12b", reduced=True), d_model=640)
    cfg = dataclasses.replace(get_config("stablelm-12b", reduced=True), d_model=640)
    assert cfg.resolved_head_dim == 160
    jparams, _ = JM.init_params(jcfg, KEY)
    params = lm_params_from_jax(jax.tree_util.tree_map(np.asarray, jparams), cfg, device="cpu")
    b, s, pre = 2, 9, 6
    toks = _tokens(cfg, b, s, seed=4)
    jdt, tdt = (jnp.int8, torch.int8) if kv_dtype == "int8" else (jnp.float32, torch.float32)
    jcache, _ = JM.init_cache(jcfg, b, s, jdt)
    cache = M.init_cache(cfg, b, s, tdt, device="cpu")
    jl, jcache = JM.prefill(jcfg, jparams, jcache, {"tokens": jnp.asarray(toks[:, :pre])})
    with torch.no_grad():
        lg, cache = M.prefill(cfg, params, cache, {"tokens": torch.from_numpy(toks[:, :pre])})
        _close_logits(lg.numpy(), jl)
        for t in range(pre, s):
            jl, jcache = JM.decode_step(jcfg, jparams, jcache,
                                        {"tokens": jnp.asarray(toks[:, t:t + 1])},
                                        jnp.int32(t))
            lg, cache = M.decode_step(cfg, params, cache,
                                      {"tokens": torch.from_numpy(toks[:, t:t + 1])}, t)
            _close_logits(lg.numpy(), jl)
