"""The port's MoE family against the JAX package: `models.moe` (capacity-
routed top-k experts, shared experts) and arctic-480b (routed experts beside
a dense residual FFN, GQA attention) at its REDUCED config: configs,
`n_params` / `n_active_params`, the init tree and its leaf-by-leaf stacking,
`forward`, prefill plus teacher-forced decode over fp32 and int8 KV caches,
bf16 and fp32 train steps under remat none / dots / full, and
`lm_params_from_jax` on the MoE tree. The module tests mirror
`tests/test_moe.py`; their inputs and weights come from a numpy seed, the
whole-model tests carry the JAX package's weights over as numpy. The JAX
side runs without a mesh.

Tolerances:
- `moe_ffn` (fp32): y at rtol = atol = 1e-5, the aux loss at 1e-6
  relative; the routing (expert ids, slots, kept pairs) identical, the
  smallest margin between the k-th and (k+1)-th router probability printed
  so that a near-tie flip reads as one;
- `moe_ffn` on bf16 inputs and weights: the routing identical (both sides
  route in fp32 from the same bf16 values); y within 2^-5 * max|y| (the
  two sides round the experts' hidden state, silu and gate product, to
  bf16 at different steps: 2^-6.8 * max|y| apart on this test's draw);
- the brute force (numpy, float64, over each token's top-k experts): y at
  rtol = atol = 1e-5;
- whole model: those of `tests/test_torch_dense_lm.py` (logits 1e-4 *
  max + 1e-6; fp32 cache 1e-5 * max + 1e-6; int8 cache values within one
  step, scales 1e-5 relative; bf16 steps: loss 1e-2 relative per step,
  and with qk_norm on the grad norm 3e-2 relative per step and the step-0
  gradient leaves 5e-2 * max|leaf|; fp32 steps: loss 1e-4 and grad norm 1e-3 relative per step); remat dots
  and full against none on the port: 1e-6 relative.
"""
import dataclasses
import weakref

import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.configs import DEFAULT_RUN as J_DEFAULT_RUN  # noqa: E402
from repro.configs import get_config as j_get_config  # noqa: E402
from repro.configs.base import list_archs as j_list_archs  # noqa: E402
from repro.launch.steps import init_train_state as j_init_train_state  # noqa: E402
from repro.launch.steps import make_train_step as j_make_train_step  # noqa: E402
from repro.models import model as JM  # noqa: E402
from repro.models import moe as JMOE  # noqa: E402
from repro.models import transformer as j_transformer  # noqa: E402
from repro_torch.configs.base import DEFAULT_RUN, ModelConfig, get_config, list_archs  # noqa: E402
from repro_torch.convert import lm_params_from_jax, train_state_from_jax  # noqa: E402
from repro_torch.data import make_pipeline  # noqa: E402
from repro_torch.launch.serve import serve  # noqa: E402
from repro_torch.launch.steps import loss_and_grads, make_train_step  # noqa: E402
from repro_torch.models import model as M  # noqa: E402
from repro_torch.models import moe as PMOE  # noqa: E402
from repro_torch.models import transformer as T  # noqa: E402
from repro_torch.models.layers import embed_init, ones_init  # noqa: E402
from repro_torch.tree import tree_leaves, tree_paths  # noqa: E402

ARCH = "arctic-480b"
KEY = jax.random.PRNGKey(0)


def _cfgs(**kw):
    """(port, JAX) reduced arctic configs with the module tests' defaults
    (`tests/test_moe.py::_cfg`: no dense residual, no shared experts)."""
    kw.setdefault("dense_residual_ff", False)
    kw.setdefault("n_shared_experts", 0)
    return (dataclasses.replace(get_config(ARCH, reduced=True), **kw),
            dataclasses.replace(j_get_config(ARCH, reduced=True), **kw))


def _np_moe(cfg, seed):
    """MoE weights from a numpy seed, at the reference's fan-ins."""
    rng = np.random.default_rng(seed)
    d, e, f = cfg.d_model, cfg.n_experts, cfg.moe_d_ff or cfg.d_ff

    def w(shape, fan_in):
        return (rng.standard_normal(shape) * fan_in ** -0.5).astype(np.float32)

    p = {"router": w((d, e), d), "w1": w((e, d, f), d), "w3": w((e, d, f), d),
         "w2": w((e, f, d), f)}
    if cfg.n_shared_experts:
        fs = f * cfg.n_shared_experts
        p["shared"] = {"w1": w((d, fs), d), "w3": w((d, fs), d), "w2": w((fs, d), fs)}
    return p


def _x(cfg, b, s, seed, scale=1.0):
    rng = np.random.default_rng(1000 + seed)
    return (rng.standard_normal((b, s, cfg.d_model)) * scale).astype(np.float32)


def _to_torch(tree, dtype=torch.float32):
    if isinstance(tree, dict):
        return {k: _to_torch(v, dtype) for k, v in tree.items()}
    return torch.from_numpy(np.asarray(tree, np.float32)).to(dtype)


def _to_jax(tree, dtype=jnp.float32):
    return jax.tree_util.tree_map(lambda a: jnp.asarray(a, dtype), tree)


def _j_routing(router, xt, cfg):
    """The reference's routing steps (`repro/models/moe.py:64-82`), which it
    computes inside `moe_ffn` and does not return: (probs, eidx, slots,
    keep) as numpy."""
    t, k = xt.shape[0], cfg.top_k
    probs = jax.nn.softmax(xt @ router.astype(jnp.float32), axis=-1)
    _, eidx = jax.lax.top_k(probs, k)
    fe = eidx.reshape(-1)
    order = jnp.argsort(fe, stable=True)
    se = fe[order]
    pos = jnp.arange(t * k, dtype=jnp.int32)
    seg_first = jnp.where(jnp.concatenate([jnp.array([True]), se[1:] != se[:-1]]), pos, 0)
    slots = jnp.zeros((t * k,), jnp.int32).at[order].set(pos - jax.lax.cummax(seg_first))
    keep = slots < JMOE._capacity(t, cfg)
    return tuple(np.asarray(a) for a in (probs, eidx, slots, keep))


def _margin(probs, k):
    """The smallest gap between the k-th and (k+1)-th probability of a token."""
    top = -np.sort(-np.asarray(probs, np.float64), axis=-1)
    return float((top[:, k - 1] - top[:, k]).min()) if top.shape[1] > k else float("inf")


def _assert_routing_identical(p, x, cfg, jcfg, torch_dtype=torch.float32,
                              jax_dtype=jnp.float32):
    xt = x.reshape(-1, cfg.d_model)
    r = PMOE.route(_to_torch(p["router"], torch_dtype), _to_torch(xt, torch_dtype), cfg)
    probs, eidx, slots, keep = _j_routing(_to_jax(p["router"], jax_dtype),
                                          _to_jax(xt, jax_dtype), jcfg)
    print(f"smallest top-{cfg.top_k} margin {_margin(probs, cfg.top_k):.3e}")
    assert r.cap == JMOE._capacity(xt.shape[0], jcfg)
    np.testing.assert_array_equal(r.eidx.numpy(), eidx)
    np.testing.assert_array_equal(r.slots.numpy(), slots)
    np.testing.assert_array_equal(r.keep.numpy(), keep)
    return r


def _close(got, want, rel, floor=0.0):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    err, scale = float(np.abs(got - want).max()), float(np.abs(want).max())
    assert err <= rel * scale + floor, (err, scale)


# ---------------------------------------------------------------------------
# moe_ffn against the reference's
# ---------------------------------------------------------------------------


# capacity factors: 8.0 drops nothing, 0.5 drops, 1.25 (the default) may
@pytest.mark.parametrize("shared", [0, 1], ids=["routed", "shared"])
@pytest.mark.parametrize("k", [1, 2, 6])
@pytest.mark.parametrize("cf", [8.0, 1.25, 0.5])
def test_moe_ffn_matches_jax(cf, k, shared):
    cfg, jcfg = _cfgs(capacity_factor=cf, top_k=k, n_shared_experts=shared)
    p = _np_moe(cfg, seed=k)
    x = _x(cfg, 2, 24, seed=k)
    r = _assert_routing_identical(p, x, cfg, jcfg)
    jy, jaux = JMOE.moe_ffn(_to_jax(p), jnp.asarray(x), jcfg)
    y, aux = PMOE.moe_ffn(_to_torch(p), torch.from_numpy(x), cfg)
    assert y.shape == x.shape and y.dtype == torch.float32
    np.testing.assert_allclose(y.numpy(), np.asarray(jy), rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(float(aux), float(jaux), rtol=1e-6)
    drops = int((~r.keep).sum())
    print(f"capacity {r.cap}, {drops} of {r.keep.numel()} pairs dropped")
    assert drops == 0 if cf == 8.0 else (cf == 1.25 or drops > 0)


def test_moe_ffn_bf16_routes_in_fp32():
    """bf16 tokens and weights: both sides route in fp32 from the same bf16
    values (the port casts both operands; the reference leans on bf16 @ f32
    promotion), so the routing is identical; y in bf16 within 2^-5 *
    max|y|."""
    cfg, jcfg = _cfgs(top_k=2)
    p = _np_moe(cfg, seed=11)
    x = _x(cfg, 2, 16, seed=11)
    _assert_routing_identical(p, x, cfg, jcfg, torch.bfloat16, jnp.bfloat16)
    jy, jaux = JMOE.moe_ffn(_to_jax(p, jnp.bfloat16), jnp.asarray(x, jnp.bfloat16), jcfg)
    y, aux = PMOE.moe_ffn(_to_torch(p, torch.bfloat16),
                          torch.from_numpy(x).to(torch.bfloat16), cfg)
    assert y.dtype == torch.bfloat16 and aux.dtype == torch.float32
    want = np.asarray(jy, np.float32)
    err = np.abs(y.float().numpy() - want).max() / np.abs(want).max()
    print(f"bf16 y: max|port - jax| / max|jax| = 2^{np.log2(err):.2f}")
    assert err <= 2 ** -5
    np.testing.assert_allclose(float(aux), float(jaux), rtol=1e-6)


@pytest.mark.parametrize("cf", [8.0, 0.5], ids=["no_drops", "drops"])
def test_moe_ffn_bf16_gradients_match_jax(cf):
    """Top-2 on bf16 tokens and weights, the routing identical: the
    gradients of sum(y * cotangent) + aux with respect to the tokens, the
    router and the three expert leaves within 5e-2 * max|leaf| of the
    reference's (the whole-model step-0 leaf limit of
    `tests/test_torch_dense_lm.py`), through the gates, the aux loss, the
    expert bmms and the dropped pairs."""
    cfg, jcfg = _cfgs(top_k=2, capacity_factor=cf)
    p = _np_moe(cfg, seed=13)
    x = _x(cfg, 2, 16, seed=13)
    cot = np.random.default_rng(14).standard_normal(x.shape).astype(np.float32)
    r = _assert_routing_identical(p, x, cfg, jcfg, torch.bfloat16, jnp.bfloat16)
    assert (int((~r.keep).sum()) == 0) == (cf == 8.0)

    def j_loss(jp, jx):
        y, aux = JMOE.moe_ffn(jp, jx, jcfg)
        return jnp.sum(y.astype(jnp.float32) * cot) + aux

    jgp, jgx = jax.grad(j_loss, argnums=(0, 1))(_to_jax(p, jnp.bfloat16),
                                                jnp.asarray(x, jnp.bfloat16))
    tp = {k: v.requires_grad_() for k, v in _to_torch(p, torch.bfloat16).items()}
    tx = torch.from_numpy(x).to(torch.bfloat16).requires_grad_()
    y, aux = PMOE.moe_ffn(tp, tx, cfg)
    (torch.sum(y.float() * torch.from_numpy(cot)) + aux).backward()
    pairs = [(k, tp[k].grad, jgp[k]) for k in ("router", "w1", "w3", "w2")]
    for name, got, want in pairs + [("x", tx.grad, jgx)]:
        assert got.dtype == torch.bfloat16, name
        want = np.asarray(want, np.float32)
        err = np.abs(got.float().numpy() - want).max() / np.abs(want).max()
        print(f"{name}: max|port - jax| / max|jax| = {err:.3e}")
        assert err <= 5e-2, name


def test_brute_force_equivalence_no_drops():
    """With a capacity that drops nothing, moe_ffn equals the per-token sum
    over its top-k experts, each weighted by its renormalised gate (float64
    numpy)."""
    cfg, _ = _cfgs(n_experts=4, top_k=2, capacity_factor=8.0)
    p = _np_moe(cfg, seed=2)
    x = _x(cfg, 2, 6, seed=2, scale=0.5)
    y, _ = PMOE.moe_ffn(_to_torch(p), torch.from_numpy(x), cfg)
    xt = x.reshape(-1, cfg.d_model).astype(np.float64)
    logits = xt @ p["router"].astype(np.float64)
    probs = np.exp(logits - logits.max(-1, keepdims=True))
    probs /= probs.sum(-1, keepdims=True)
    w1, w3, w2 = (p[k].astype(np.float64) for k in ("w1", "w3", "w2"))
    ref = np.zeros_like(xt)
    for t in range(xt.shape[0]):
        top = np.argsort(-probs[t])[: cfg.top_k]
        g = probs[t][top] / probs[t][top].sum()
        for gi, e in zip(g, top):
            h = xt[t] @ w1[e]
            h = h / (1 + np.exp(-h)) * (xt[t] @ w3[e])
            ref[t] += gi * (h @ w2[e])
    np.testing.assert_allclose(y.numpy().reshape(-1, cfg.d_model), ref, rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("seed,t", [(0, 2), (7, 5), (123, 9), (500, 16), (999, 13)])
def test_routing_invariants(seed, t):
    """`tests/test_moe.py::test_hypothesis_routing_invariants` at fixed
    draws, with the capacity checked on the port's own routing: y finite,
    0 <= aux <= coef * E, cap >= 8, each expert's kept slots exactly 0 ..
    min(count, cap) - 1, and the routing identical to the reference's."""
    cfg, jcfg = _cfgs(n_experts=8, top_k=2, capacity_factor=1.0)
    p = _np_moe(cfg, seed=seed)
    x = _x(cfg, 1, t, seed=seed)
    y, aux = PMOE.moe_ffn(_to_torch(p), torch.from_numpy(x), cfg)
    assert np.isfinite(y.numpy()).all()
    assert 0.0 <= float(aux) <= cfg.router_aux_loss * cfg.n_experts
    r = _assert_routing_identical(p, x, cfg, jcfg)
    assert r.cap >= 8
    fe, slots, keep = r.eidx.reshape(-1).numpy(), r.slots.numpy(), r.keep.numpy()
    for e in range(cfg.n_experts):
        mine = slots[fe == e]
        assert sorted(mine) == list(range(len(mine)))
        assert sorted(slots[(fe == e) & keep]) == list(range(min(len(mine), r.cap)))


def test_dropped_tokens_get_zero_routed_output():
    """A tiny capacity factor drops most pairs: at most E * cap rows of y
    are nonzero, and y matches the reference's."""
    cfg, jcfg = _cfgs(n_experts=8, top_k=1, capacity_factor=0.01)
    p = _np_moe(cfg, seed=3)
    x = _x(cfg, 1, 64, seed=3)
    y, _ = PMOE.moe_ffn(_to_torch(p), torch.from_numpy(x), cfg)
    nonzero_rows = int((y.reshape(64, -1).abs().amax(-1) > 1e-6).sum())
    assert nonzero_rows <= 8 * 8
    jy, _ = JMOE.moe_ffn(_to_jax(p), jnp.asarray(x), jcfg)
    np.testing.assert_allclose(y.numpy(), np.asarray(jy), rtol=1e-5, atol=1e-5)


def test_shared_expert_and_dense_residual():
    """Shared experts inside moe_ffn, and arctic's dense residual FFN beside
    it in the sublayer: the tree's keys and shapes, y against the
    reference's."""
    cfg, jcfg = _cfgs(n_experts=4, top_k=2, n_shared_experts=1)
    p = _np_moe(cfg, seed=4)
    x = _x(cfg, 2, 4, seed=4)
    y, _ = PMOE.moe_ffn(_to_torch(p), torch.from_numpy(x), cfg)
    jy, _ = JMOE.moe_ffn(_to_jax(p), jnp.asarray(x), jcfg)
    assert y.shape == x.shape and np.isfinite(y.numpy()).all()
    np.testing.assert_allclose(y.numpy(), np.asarray(jy), rtol=1e-5, atol=1e-5)
    drawn = PMOE.init_moe(torch.Generator().manual_seed(0), cfg)
    assert {k: tuple(v.shape) for k, v in drawn["shared"].items()} == \
        {k: v.shape for k, v in p["shared"].items()}
    arctic = get_config(ARCH, reduced=True)
    assert T.group_layout(arctic) == [T.Sub("attn", "moe+dense")]
    sub = T.init_sublayer(torch.Generator().manual_seed(0), T.group_layout(arctic)[0], arctic)
    assert sorted(sub) == ["ffn", "ln1", "ln2", "mix", "moe"]
    assert sorted(sub["moe"]) == ["router", "w1", "w2", "w3"]


def test_grad_flows_through_router():
    """Every gradient leaf of sum(y^2) + aux, the router's nonzero, against
    `jax.grad` of the reference's (rtol = atol = 1e-5 of each leaf's max)."""
    cfg, jcfg = _cfgs(n_experts=4, top_k=2)
    p = _np_moe(cfg, seed=5)
    x = _x(cfg, 1, 8, seed=5)

    def jloss(p):
        y, aux = JMOE.moe_ffn(p, jnp.asarray(x), jcfg)
        return jnp.sum(y ** 2) + aux

    jg = jax.grad(jloss)(_to_jax(p))
    tp = {k: v.requires_grad_(True) for k, v in _to_torch(p).items()}
    y, aux = PMOE.moe_ffn(tp, torch.from_numpy(x), cfg)
    (torch.sum(y ** 2) + aux).backward()
    assert float(tp["router"].grad.abs().sum()) > 0.0
    for k, v in tp.items():
        _close(v.grad.numpy(), jg[k], rel=1e-5, floor=1e-6)


def test_aux_gradient_reaches_the_router_alone():
    """The aux loss's gradient flows through the router probabilities only:
    the counts carry none, as the reference's scatter-add gives none."""
    cfg, jcfg = _cfgs(n_experts=8, top_k=2)
    p = _np_moe(cfg, seed=6)
    x = _x(cfg, 1, 12, seed=6)
    jg = jax.grad(lambda r: JMOE.moe_ffn(dict(_to_jax(p), router=r),
                                         jnp.asarray(x), jcfg)[1])(jnp.asarray(p["router"]))
    router = torch.from_numpy(p["router"]).requires_grad_(True)
    _, aux = PMOE.moe_ffn(dict(_to_torch(p), router=router), torch.from_numpy(x), cfg)
    aux.backward()
    _close(router.grad.numpy(), jg, rel=1e-5, floor=1e-9)


@pytest.mark.parametrize("t", [1, 4, 128, 1000])
def test_capacity_matches_the_reference(t):
    """ceil(T k cf / E) rounded up to 8, at least 8: arctic's 8 at both
    T = 128 (prefill, B 4 S 32) and T = 4 (decode)."""
    for arch_kw in ({}, {"capacity_factor": 2.0}, {"top_k": 6, "n_experts": 8}):
        cfg, jcfg = _cfgs(**arch_kw)
        assert PMOE._capacity(t, cfg) == JMOE._capacity(t, jcfg)
    full = get_config(ARCH)
    if t in (4, 128):
        assert PMOE._capacity(t, full) == 8


# ---------------------------------------------------------------------------
# configs, layouts, parameter counts
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("reduced", [True, False])
def test_configs_match_the_reference(reduced):
    port = dataclasses.asdict(get_config(ARCH, reduced=reduced))
    assert port == dataclasses.asdict(j_get_config(ARCH, reduced=reduced))
    assert (port["family"], port["attn_type"], port["dense_residual_ff"]) == ("moe", "gqa", True)
    assert ARCH in list_archs() and "deepseek-v2-236b" in j_list_archs()
    mla = get_config("deepseek-v2-236b", reduced=reduced)
    assert (mla.family, mla.attn_type) == ("moe", "mla")
    assert (mla.kv_lora_rank, mla.rope_head_dim) == ((32, 16) if reduced else (512, 64))


def _stand_in(jcfg) -> ModelConfig:
    """A port ModelConfig with every field of a reference config."""
    return ModelConfig(**dataclasses.asdict(jcfg))


@pytest.mark.parametrize("arch", ["llama-3.2-vision-90b", "whisper-tiny"])
@pytest.mark.parametrize("reduced", [True, False])
def test_unported_families_raise(arch, reduced):
    """No family is left unported: the VLM and audio fields give the
    reference's group layout and parameter count (the cross-attention
    families' own tests are `tests/test_torch_cross.py`); with a family
    the reference has no layout for, group_layout, init_params and
    init_cache raise ValueError."""
    jcfg = j_get_config(arch, reduced=reduced)
    cfg = _stand_in(jcfg)
    assert [tuple(s) for s in T.group_layout(cfg)] == [
        tuple(s) for s in j_transformer.group_layout(jcfg)]
    assert cfg.n_params() == JM.count_params_analytic(jcfg)
    # (an encoder-decoder's stacks have layouts of their own: a decoder-only
    # config with the unknown family)
    cfg = dataclasses.replace(cfg, family="cnn", is_encoder_decoder=False)
    with pytest.raises(ValueError, match="family 'cnn'"):
        T.group_layout(cfg)
    with pytest.raises(ValueError, match="family 'cnn'"):
        M.init_params(cfg, None, device="meta")
    with pytest.raises(ValueError, match="family 'cnn'"):
        M.init_cache(cfg, 1, 4, device="cpu")


@pytest.mark.parametrize("reduced", [False, True])
def test_n_params_and_n_active_params_match_the_reference(reduced):
    """From the shapes alone, equal to the reference's
    `count_params_analytic`, full and active; the full config within
    0.55-1.45 of its advertised 480 B (`tests/test_models.py`), the active
    count about 17 B."""
    cfg, jcfg = get_config(ARCH, reduced=reduced), j_get_config(ARCH, reduced=reduced)
    n, a = cfg.n_params(), cfg.n_active_params()
    assert n == JM.count_params_analytic(jcfg)
    assert a == JM.count_params_analytic(jcfg, active_only=True)
    assert a < n
    if not reduced:
        assert 0.55 * 480e9 <= n <= 1.45 * 480e9, n
        assert 15e9 <= a <= 20e9, a


@pytest.mark.parametrize("reduced", [False, True])
def test_n_active_params_of_deepseek_moe_fields(reduced):
    """deepseek-v2's MoE fields (160 or 8 routed experts, top-6 or top-2,
    shared experts, moe_d_ff) on a GQA stand-in (its MLA fields dropped):
    the router and the shared experts count whole, the routed experts by
    top_k / n_experts, as the reference counts them."""
    jcfg = dataclasses.replace(j_get_config("deepseek-v2-236b", reduced=reduced),
                               attn_type="gqa", n_layers=2)
    cfg = _stand_in(jcfg)
    assert T.group_layout(cfg) == [T.Sub("attn", "moe")]
    assert cfg.n_params() == JM.count_params_analytic(jcfg)
    assert cfg.n_active_params() == JM.count_params_analytic(jcfg, active_only=True)
    with torch.device("meta"):
        p = M.init_params(cfg, None, device="meta")
    assert sorted(p["groups"]["sub0"]["moe"]) == ["router", "shared", "w1", "w2", "w3"]
    assert "ffn" not in p["groups"]["sub0"]


def test_init_params_has_the_reference_tree():
    cfg, jcfg = get_config(ARCH, reduced=True), j_get_config(ARCH, reduced=True)
    jparams, _ = JM.init_params(jcfg, KEY)
    port = M.init_params(cfg, torch.Generator().manual_seed(0), device="cpu")
    want = {path.replace("/", "."): tuple(a.shape) for path, a in
            zip(*_jax_paths(jparams))}
    assert {p.replace("/", "."): tuple(t.shape) for p, t in tree_paths(port)} == want


def _jax_paths(tree):
    flat = jax.tree_util.tree_flatten_with_path(tree)[0]
    return ["/".join(str(k.key) for k in path) for path, _ in flat], [a for _, a in flat]


def _host_only_draw(cfg, seed):
    """The whole tree drawn on the host in `init_params`' order, then
    stacked: what `init_groups` gives without its slots."""
    gen = torch.Generator().manual_seed(seed)
    d, v = cfg.d_model, cfg.vocab_size
    embed = embed_init(gen, (v, d))
    layers = [T.init_sublayer(gen, s, cfg) for _ in range(cfg.n_layers)
              for s in T.group_layout(cfg)]

    def stack(trees):
        if isinstance(trees[0], dict):
            return {k: stack([t[k] for t in trees]) for k in trees[0]}
        return torch.stack(trees)

    p = {"embed": embed, "final_norm": ones_init((d,)), "groups": {"sub0": stack(layers)}}
    if not cfg.tie_embeddings:
        p["unembed"] = embed_init(gen, (d, v))
    return p


@pytest.mark.parametrize("n_layers", [1, 2, 3])
@pytest.mark.parametrize("arch", [ARCH, "qwen3-0.6b", "minitron-8b"])
def test_init_groups_is_the_host_only_draw_bitwise(arch, n_layers):
    """The slots change no bit of the tree, for the dense archs as for
    arctic, at one group and at several."""
    cfg = dataclasses.replace(get_config(arch, reduced=True), n_layers=n_layers)
    got = M.init_params(cfg, torch.Generator().manual_seed(5), device="cpu")
    want = _host_only_draw(cfg, 5)
    assert [p for p, _ in tree_paths(got)] == [p for p, _ in tree_paths(want)]
    for (path, a), (_, b) in zip(tree_paths(got), tree_paths(want)):
        assert a.shape == b.shape and torch.equal(a, b), path


@pytest.mark.parametrize("n_layers", [1, 3])
@pytest.mark.parametrize("device", ["cpu", "meta"])
def test_init_groups_peak_is_one_stacked_tree_plus_one_leaf(device, n_layers):
    """Each drawn leaf is copied into its stacked slot and freed before the
    next leaf is drawn (the peak: the stacked tree plus the leaf in hand),
    at one group as at several."""
    cfg = dataclasses.replace(get_config(ARCH, reduced=True), n_layers=n_layers)
    gen = None if device == "meta" else torch.Generator().manual_seed(0)
    drawn, alive_at_draw = [], []

    def place(t):
        alive_at_draw.append(sum(w() is not None for w in drawn))
        drawn.append(weakref.ref(t))
        return t

    with torch.device(device):
        groups = T.init_groups(gen, cfg, place)
    leaves = tree_leaves(groups)
    assert len(drawn) == len(leaves) * n_layers
    assert all(x.shape[0] == n_layers and x.device.type == device for x in leaves)
    assert alive_at_draw == [0] * len(drawn) and all(w() is None for w in drawn)


# ---------------------------------------------------------------------------
# the whole model against the JAX package
# ---------------------------------------------------------------------------


def _close_logits(got, want):
    got, want = np.asarray(got, np.float32), np.asarray(want, np.float32)
    err = float(np.abs(got - want).max())
    scale = float(np.abs(want).max())
    assert err <= 1e-4 * scale + 1e-6, (err, scale)


@pytest.fixture(scope="module")
def model():
    cfg, jcfg = get_config(ARCH, reduced=True), j_get_config(ARCH, reduced=True)
    jparams, _ = JM.init_params(jcfg, KEY)
    np_params = jax.tree_util.tree_map(np.asarray, jparams)
    return cfg, jcfg, jparams, np_params, lm_params_from_jax(np_params, cfg, device="cpu")


def _tokens(cfg, b, s, seed=0):
    return np.random.default_rng(seed).integers(0, cfg.vocab_size, (b, s)).astype(np.int32)


def test_lm_params_from_jax_carries_the_moe_tree(model):
    """Every leaf of the JAX tree lands at the same path with the same
    values; a missing leaf, a short layer axis or a misshapen expert leaf
    raises."""
    cfg, _, jparams, np_params, params = model
    paths, leaves = _jax_paths(jparams)
    got = dict(tree_paths(params))
    assert sorted(got) == sorted(paths)
    for path, a in zip(paths, leaves):
        assert torch.equal(got[path], torch.from_numpy(np.array(a))), path
    bad = jax.tree_util.tree_map(lambda a: a, np_params)
    del bad["groups"]["sub0"]["moe"]["w3"]
    with pytest.raises(KeyError):
        lm_params_from_jax(bad, cfg, device="cpu")
    bad = jax.tree_util.tree_map(lambda a: a, np_params)
    bad["groups"]["sub0"]["moe"]["router"] = bad["groups"]["sub0"]["moe"]["router"][:1]
    with pytest.raises(ValueError, match="layers"):
        lm_params_from_jax(bad, cfg, device="cpu")
    bad = jax.tree_util.tree_map(lambda a: a, np_params)
    bad["groups"]["sub0"]["moe"]["w2"] = bad["groups"]["sub0"]["moe"]["w2"][:, :, :-1]
    with pytest.raises(ValueError, match="shape"):
        lm_params_from_jax(bad, cfg, device="cpu")


def test_forward_matches_jax(model):
    cfg, jcfg, jparams, _, params = model
    toks = _tokens(cfg, 2, 12)
    want, _, jaux = JM.forward(jcfg, jparams, {"tokens": jnp.asarray(toks)})
    with torch.no_grad():
        got, _, aux = M.forward(cfg, params, {"tokens": torch.from_numpy(toks)})
    assert got.shape == (2, 12, cfg.vocab_size)
    _close_logits(got.numpy(), want)
    assert float(aux) > 0.0
    np.testing.assert_allclose(float(aux), float(jaux), rtol=1e-5)


@pytest.mark.parametrize("kv_dtype", ["float32", "int8"])
def test_prefill_and_decode_match_jax(model, kv_dtype):
    """Prefill (T = 10: capacity 8) then teacher-forced decode (T = 2:
    capacity 8), logits and the caches against the reference's."""
    cfg, jcfg, jparams, _, params = model
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


def test_serve_is_greedy_on_the_host():
    """The launcher serves reduced arctic; its tokens are the argmax of the
    model's own forward on the same weights (fp32 cache), and it serves an
    int8 cache too."""
    res = serve(ARCH, reduced=True, batch=2, prompt_len=6, gen_len=3, device="cpu", seed=3)
    cfg = get_config(ARCH, reduced=True)
    params = M.init_params(cfg, torch.Generator().manual_seed(3), device="cpu")
    # teacher-forced through the same calls (the capacity, and so the
    # drops, follow each call's token count: a full forward over the
    # sequence may route otherwise)
    cache = M.init_cache(cfg, 2, 9, torch.float32, device="cpu")
    with torch.no_grad():
        lg, cache = M.prefill(cfg, params, cache, {"tokens": res.prompt})
        greedy = [lg[:, -1].argmax(-1)]
        for i in range(2):
            lg, cache = M.decode_step(cfg, params, cache,
                                      {"tokens": res.tokens[:, i:i + 1]}, 6 + i)
            greedy.append(lg[:, -1].argmax(-1))
    assert torch.equal(torch.stack(greedy, 1).to(torch.int32), res.tokens)
    again = serve(ARCH, reduced=True, batch=2, prompt_len=6, gen_len=3, device="cpu",
                  seed=3, params=params, kv_cache_dtype="int8")
    assert tuple(again.tokens.shape) == (2, 3) and torch.equal(again.prompt, res.prompt)


@pytest.mark.parametrize("qk_norm", [False, True], ids=["registered", "qk_norm_every_expert"])
@pytest.mark.parametrize("remat", ["none", "dots", "full"])
def test_three_bf16_train_steps_match_jax(remat, qk_norm):
    """Three steps at the reference's default types (bf16 params, fp32
    moments) from the JAX package's state, the aux loss in the loss, at the
    same remat on both sides: the loss per step within 1e-2 relative; with
    qk_norm on, the grad norm per step within 3e-2 relative and the step-0
    gradient leaves (router and experts among them) within 5e-2 *
    max|leaf| too. The registered config holds the loss only: it has no
    qk_norm and saturates its softmax, where bf16 rounding decides the
    gradients (`tests/test_torch_dense_lm.py`). Top-2 routing is a second
    such edge: the two sides' bf16 activations differ by an ulp or two,
    which flips near-tied picks (3 of layer 0's 128 pairs on this draw,
    top-2 margin 9e-4) and moves the routed leaves' gradients by up to 29%.
    So the qk_norm case routes every token to every expert (top_k =
    n_experts, capacity 80 over 64 tokens: no pick to flip, no drop), where
    the gradients meet bf16's own spread; `test_moe_ffn_bf16_gradients_
    match_jax` holds the top-2 backward with drops, aux included, on one
    set of bf16 values."""
    cfg = get_config(ARCH, reduced=True)
    pin = {"qk_norm": True, "top_k": cfg.n_experts} if qk_norm else {}
    cfg = dataclasses.replace(cfg, **pin)
    jcfg = dataclasses.replace(j_get_config(ARCH, reduced=True), **pin)
    jrun = J_DEFAULT_RUN.replace(remat=remat, warmup_steps=2)
    run = DEFAULT_RUN.replace(remat=remat, warmup_steps=2)
    jstate = j_init_train_state(jcfg, jrun, KEY)
    np_state = jax.tree_util.tree_map(lambda x: np.asarray(x, np.float32), jstate)
    pipe = make_pipeline(cfg, 16, 4, seed=8)
    if qk_norm:
        batch = pipe.batch_at(0)
        jg = jax.grad(lambda p: JM.lm_loss(
            jcfg, p, {k: jnp.asarray(v) for k, v in batch.items()}, remat=remat))(jstate.params)
        params = lm_params_from_jax(np_state.params, cfg, device="cpu", dtype=torch.bfloat16)
        _, grads = loss_and_grads(cfg, run, params,
                                  {k: torch.from_numpy(v) for k, v in batch.items()})
        paths, want_leaves = _jax_paths(jg)
        got = dict(tree_paths(grads))
        assert sorted(got) == sorted(paths)
        for path, want in zip(paths, want_leaves):
            want = np.asarray(want, np.float32)
            err = np.abs(got[path].float().numpy() - want).max()
            assert err <= 5e-2 * np.abs(want).max(), path
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


@pytest.mark.parametrize("remat", ["none", "dots", "full"])
def test_fp32_train_steps_match_jax(remat):
    """Three fp32 steps against the JAX package's at `param_dtype="float32"`
    and the same remat: loss within 1e-4 and grad norm within 1e-3
    relative per step."""
    cfg, jcfg = get_config(ARCH, reduced=True), j_get_config(ARCH, reduced=True)
    jrun = J_DEFAULT_RUN.replace(remat=remat, warmup_steps=2, param_dtype="float32")
    jstate = j_init_train_state(jcfg, jrun, KEY)
    np_state = jax.tree_util.tree_map(np.asarray, jstate)
    jstep = jax.jit(j_make_train_step(jcfg, jrun, 10))
    step = make_train_step(cfg, DEFAULT_RUN.replace(remat=remat, warmup_steps=2,
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


def test_remat_keeps_the_aux_and_saves_the_batch_free_matmuls(model, monkeypatch):
    """The aux loss comes out of the checkpointed group: loss and every
    gradient leaf under "dots" and "full" within 1e-6 relative of "none".
    "dots" keeps the batch-free products (attention projections, router,
    dense residual FFN: aten.mm, or bmm over a batch of one) and recomputes
    the routed experts' bmm over E > 1."""
    from torch.utils.checkpoint import CheckpointPolicy

    cfg, _, _, _, params = model
    run = DEFAULT_RUN.replace(param_dtype="float32")
    batch = {k: torch.from_numpy(v) for k, v in
             make_pipeline(cfg, 16, 4, seed=5).batch_at(5).items()}
    decisions = []
    orig = T.dots_policy
    aten = torch.ops.aten

    def spy(ctx, op, *args, **kw):
        out = orig(ctx, op, *args, **kw)
        if not ctx.is_recompute and op in (aten.mm.default, aten.bmm.default):
            decisions.append((op, tuple(args[0].shape), tuple(args[1].shape), out))
        return out

    monkeypatch.setattr(T, "dots_policy", spy)
    l0, g0 = loss_and_grads(cfg, run.replace(remat="none"), params, batch)
    for remat in ("dots", "full"):
        lr, gr = loss_and_grads(cfg, run.replace(remat=remat), params, batch)
        assert abs(float(lr) - float(l0)) <= 1e-6 * abs(float(l0))
        for a, b in zip(tree_leaves(gr), tree_leaves(g0)):
            _close(a.numpy(), b.numpy(), rel=1e-6, floor=1e-9)
    d, e, f = cfg.d_model, cfg.n_experts, cfg.moe_d_ff
    experts = [dec for op, a, w, dec in decisions
               if op is aten.bmm.default and w in ((e, d, f), (e, f, d))]
    assert experts == [CheckpointPolicy.PREFER_RECOMPUTE] * 3 * cfg.n_layers
    router = [dec for op, a, w, dec in decisions if op is aten.mm.default and w == (d, e)]
    assert router == [CheckpointPolicy.MUST_SAVE] * cfg.n_layers
    mm = [dec for op, a, w, dec in decisions if op is aten.mm.default]
    assert len(mm) >= 4 * cfg.n_layers  # the router and the dense FFN's three
    assert all(dec == CheckpointPolicy.MUST_SAVE for dec in mm)
