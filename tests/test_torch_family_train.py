"""Training the MLA (deepseek-v2-236b) and hybrid (jamba-v0.1-52b) families
on the port, against the JAX package: the MLA backward's plain version
`flash_bwd_mla_plain` and `MLAAttentionFn` against `jax.vjp` of the
reference's `flash_attention` at the absorbed shape (keys [c_kv ; k_rope],
values c_kv, one kv head under H query heads); `SelectiveScanFn` (through
`mamba_block`) against `jax.vjp` of the reference's `mamba_block`, whose
`lax.scan` JAX differentiates; float64 gradient checks of both Functions;
and the reduced deepseek-v2 and jamba `loss_and_grads` against the JAX
package's `lm_loss` and `jax.value_and_grad`, at fp32 and at the
reference launcher's bf16 (`DEFAULT_RUN`). Inputs come from a numpy seed,
weights from the JAX package carried over with `lm_params_from_jax`. The
JAX side runs without a mesh. The card's counterparts are in
`tests/test_torch_mla_cuda.py` and `tests/test_torch_ssm_cuda.py`.

Tolerances:
- MLA gradients (dq, dc_kv, dk_rope): fp32 within 1e-4 * max|ref| + 1e-6
  (fp32 sums in another order; the reference's online softmax over several
  key chunks against one pass); bf16 within 2^-6 * max|ref|: both round q *
  scale, p and out to bf16 at the same points in the forward, but the
  reference's autodiff rounds its cotangents to bf16 op by op (dp, the
  cotangents of q * scale and of q, ...) where the port's backward sums in
  fp32 and rounds each gradient once; over these cases and three seeds the
  two lie up to 1.6 * 2^-7 * max apart on dq, 1.05 on dk_rope, 0.84 on dc_kv
  (rounding dp and dq's cotangent as the reference does moves no worst case
  under 2^-7);
- `mamba_block` gradients (every weight, x and the carried state): fp32
  within 1e-4 * max|ref| + 1e-6; bf16 within 2^-5 * max|ref|: every op of
  the block rounds to bf16 on both sides, the reference's cotangents op by
  op and the scan's backward once, and the errors compound through the
  convolution, the projections and the softplus (measured up to 0.7 of
  that limit);
- float64 `gradcheck` at its defaults;
- reduced models, fp32: the loss at 1e-5 relative; every gradient leaf
  within 1e-4 * max|ref| + 1e-6 for deepseek-v2 (qk_norm does not reach
  MLA, whose latents are normed always) and for jamba with qk_norm on; the
  registered jamba's attention draws wq and wk at fan-in n_heads without
  qk_norm and amplifies fp32 rounding (its worst leaf lies at 1.1e-4 of
  its max from the reference's; ROADMAP queue 3), so its leaves are held
  finite and reached, with the loss;
- reduced models, bf16 at `DEFAULT_RUN`: the loss at 1e-2 relative (both
  packages round every activation to bf16, in another order), every leaf
  finite and the Mamba and MLA leaves reached.
"""
import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.configs import get_config as j_get_config  # noqa: E402
from repro.models import attention as JA  # noqa: E402
from repro.models import model as JM  # noqa: E402
from repro.models import ssm as JS  # noqa: E402
from repro.models.layers import unzip_params  # noqa: E402
from repro_torch.configs.base import DEFAULT_RUN, get_config  # noqa: E402
from repro_torch.convert import lm_params_from_jax  # noqa: E402
from repro_torch.kernels import cuda as kcuda  # noqa: E402
from repro_torch.kernels.flash_attention.kernel import (  # noqa: E402
    flash_bwd_mla,
    flash_bwd_mla_plain,
    flash_fwd_mla_plain,
    mla_delta,
)
from repro_torch.kernels.flash_attention.ops import MLAAttentionFn  # noqa: E402
from repro_torch.kernels.selective_scan.kernel import (  # noqa: E402
    SelectiveScanFn,
    selective_scan_bwd,
    selective_scan_bwd_plain,
)
from repro_torch.launch.steps import loss_and_grads  # noqa: E402
from repro_torch.models import ssm as S  # noqa: E402
from repro_torch.tree import tree_paths  # noqa: E402

DEEPSEEK, JAMBA = "deepseek-v2-236b", "jamba-v0.1-52b"
DTYPES = {"float32": (torch.float32, jnp.float32), "bfloat16": (torch.bfloat16, jnp.bfloat16)}


def _max(x) -> float:
    return float(np.abs(np.asarray(x, np.float32)).max())


def _err(got, want) -> float:
    return float(np.abs(np.asarray(got, np.float32) - np.asarray(want, np.float32)).max())


def _f32(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        return x.detach().float().numpy()
    return np.asarray(jnp.asarray(x).astype(jnp.float32))


def _hold(got, want, dtype, what, bf16_rel=2.0 ** -7):
    limit = bf16_rel * _max(want) if dtype == "bfloat16" else 1e-4 * _max(want) + 1e-6
    assert _err(got, want) <= limit, (what, _err(got, want), limit)


# ---------------------------------------------------------------------------
# the MLA backward
# ---------------------------------------------------------------------------

# (name, B, Sq, Sk, causal, q_offset, kv_len): a causal prefill, a decode
# window at an offset over a written prefix, a non-causal kv_len mask, and
# rows at negative positions that see no key (their out is the mean of
# c_kv, and c_kv's gradient takes p do from them)
MLA_CASES = [
    ("prefill", 2, 8, 8, True, 0, None),
    ("offset", 2, 3, 12, True, 8, 11),
    ("kv_len", 1, 5, 10, False, 0, 7),
    ("masked_rows", 2, 6, 16, True, -3, None),
]
R, DR, H = 32, 16, 4  # reduced deepseek-v2's latent, rotary width and heads


def _mla_inputs(b, sq, sk, seed):
    rng = np.random.default_rng(seed)
    return [rng.standard_normal(shape).astype(np.float32)
            for shape in ((b, sq, H, R + DR), (b, sk, R), (b, sk, DR), (b, sq, H, R))]


@functools.lru_cache(maxsize=None)
def _jax_mla_grads(case, dtype):
    """jax.vjp of the reference's `flash_attention` as `mla_attention`
    calls it, in `dtype`, with respect to (q, c_kv, k_rope), on the case's
    inputs: fp32 over several key chunks, bf16 over one (the reduced
    config's attn_chunk 64 at these lengths)."""
    _, b, sq, sk, causal, q_offset, kv_len = case
    q, c_kv, k_rope, do = _mla_inputs(b, sq, sk, seed=sq + sk)
    jdt = DTYPES[dtype][1]
    k_chunk = sk if dtype == "bfloat16" or sk % 4 else 4
    scale = (R + DR) ** -0.5
    h, dk = H, R + DR

    def f(qq, ck, kr):
        k_eff = jnp.concatenate([ck, kr], axis=-1)[:, :, None]
        out = JA.flash_attention(qq.reshape(b, sq, 1, h, dk), k_eff, ck[:, :, None],
                                 causal=causal, scale=scale, q_offset=q_offset,
                                 k_chunk=k_chunk, kv_len=kv_len)
        return out.reshape(b, sq, h, -1)

    _, vjp = jax.vjp(f, *(jnp.asarray(t, jdt) for t in (q, c_kv, k_rope)))
    return tuple(_f32(g) for g in vjp(jnp.asarray(do, jdt)))


@pytest.mark.parametrize("entry", ["plain", "fn"])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("case", MLA_CASES, ids=lambda c: c[0])
def test_mla_backward_matches_jax_vjp(case, dtype, entry):
    """`flash_bwd_mla_plain` on the forward's m, l and delta, and the
    gradients autograd takes through `MLAAttentionFn`, against the
    reference's (`_jax_mla_grads`)."""
    _, b, sq, sk, causal, q_offset, kv_len = case
    q, c_kv, k_rope, do = _mla_inputs(b, sq, sk, seed=sq + sk)
    kw = dict(scale=(R + DR) ** -0.5, causal=causal, q_offset=q_offset, kv_len=kv_len)
    tdt = DTYPES[dtype][0]
    want = _jax_mla_grads(case, dtype)
    ops = [torch.from_numpy(t).to(tdt) for t in (q, c_kv, k_rope, do)]
    if entry == "plain":
        out, m, l = flash_fwd_mla_plain(*ops[:3], **kw)
        got = flash_bwd_mla_plain(*ops[:3], ops[3], m, l, mla_delta(ops[3], out), **kw)
    else:
        leaves = [t.clone().requires_grad_() for t in ops[:3]]
        out = MLAAttentionFn.apply(*leaves, kw["scale"], causal, q_offset, kv_len)
        got = torch.autograd.grad(out, leaves, ops[3])
    for name, g, w, t in zip(("dq", "dc_kv", "dk_rope"), got, want, ops):
        assert g.dtype == t.dtype and g.shape == t.shape, name
        _hold(_f32(g), w, dtype, name, bf16_rel=2.0 ** -6)


def test_mla_function_gradcheck():
    """MLAAttentionFn in float64 on the host, with a q_offset that leaves
    rows seeing no key and a kv_len mask, against finite differences."""
    rng = np.random.default_rng(0)
    q, c, k = (torch.from_numpy(rng.standard_normal(s)).requires_grad_()
               for s in ((2, 3, 2, R + DR), (2, 6, R), (2, 6, DR)))
    for causal, q_offset, kv_len in ((True, -1, None), (False, 0, 4)):
        assert torch.autograd.gradcheck(
            lambda a, b_, c_: MLAAttentionFn.apply(a, b_, c_, 0.3, causal, q_offset, kv_len),
            (q, c, k))


def test_flash_bwd_mla_runs_the_plain_version_on_the_host():
    q, c_kv, k_rope, do = (torch.from_numpy(t) for t in _mla_inputs(2, 3, 9, 1))
    kw = dict(scale=0.2, causal=True, q_offset=6, kv_len=9)
    out, m, l = flash_fwd_mla_plain(q, c_kv, k_rope, **kw)
    ops = (q, c_kv, k_rope, do, m, l, mla_delta(do, out))
    before = flash_bwd_mla.launches, dict(kcuda.MLA_ENTRY_LAUNCHES)
    got = flash_bwd_mla(*ops, **kw)
    assert all(torch.equal(g, w) for g, w in zip(got, flash_bwd_mla_plain(*ops, **kw)))
    assert torch.equal(flash_bwd_mla(*ops, part="dq", **kw), got[0])
    assert all(torch.equal(g, w) for g, w in zip(flash_bwd_mla(*ops, part="dkv", **kw), got[1:]))
    assert (flash_bwd_mla.launches, kcuda.MLA_ENTRY_LAUNCHES) == before  # launches nothing
    with pytest.raises(ValueError, match="cuda or cpu"):
        flash_bwd_mla(*(t.to("meta") for t in ops), **kw)


@pytest.mark.parametrize("what", ["q dtype", "do", "stats", "part", "contiguous", "device"])
def test_launch_flash_mla_bwd_refuses(what):
    """What the backward launch site refuses before it reaches a card."""
    b, sq, sk = 1, 2, 5
    ops = [torch.zeros((b, sq, H, R + DR)), torch.zeros((b, sk, R)), torch.zeros((b, sk, DR)),
           torch.zeros((b, sq, H, R))] + [torch.zeros((b, sq * H)) for _ in range(3)]
    kw = dict(part="dq", scale=0.1, causal=True)
    err, match = ValueError, None
    if what == "q dtype":
        ops[:4] = [t.to(torch.bfloat16) for t in ops[:4]]
        err, match = TypeError, "float32 q"
    elif what == "do":
        ops[3], err = ops[3].to(torch.bfloat16), TypeError
    elif what == "stats":
        ops[5], match = torch.zeros((b, sq)), "m, l and delta"
    elif what == "part":
        kw["part"], match = "dv", "part"
    elif what == "contiguous":
        ops[1], match = torch.zeros((b, R, sk)).transpose(1, 2), "contiguous"
    else:
        match = "CUDA device"
    with pytest.raises(err, match=match):
        kcuda.launch_flash_mla_bwd(*ops, **kw)


# ---------------------------------------------------------------------------
# the selective scan's backward
# ---------------------------------------------------------------------------


def _scan_args(b, s, di, n, seed, carried, dtype=torch.float64):
    rng = np.random.default_rng(seed)

    def t(*shape, scale=1.0):
        return torch.from_numpy(scale * rng.standard_normal(shape)).to(dtype)

    h0 = t(b, di, n) if carried else torch.zeros((b, di, n), dtype=dtype)
    return [t(b, s, di), torch.nn.functional.softplus(t(b, s, di)),
            -torch.exp(t(di, n, scale=0.3)), t(b, s, n), t(b, s, n), t(di), t(b, s, di), h0]


@pytest.mark.parametrize("carried", [False, True])
def test_selective_scan_function_gradcheck(carried):
    """SelectiveScanFn in float64 on the host (its backward the plain
    version), with a zero and a carried state, against finite differences,
    S past one chunk boundary of the card's checkpoints at a small chunk."""
    args = [a.requires_grad_() for a in _scan_args(2, 5, 3, 4, seed=1, carried=carried)]
    assert torch.autograd.gradcheck(lambda *a: SelectiveScanFn.apply(*a), args)


def test_selective_scan_bwd_runs_the_plain_version_on_the_host():
    args = _scan_args(2, 5, 16, 8, seed=2, carried=True, dtype=torch.float32)
    dout = torch.randn(2, 5, 16, generator=torch.Generator().manual_seed(3))
    before = selective_scan_bwd.launches, dict(kcuda.SCAN_ENTRY_LAUNCHES)
    dh_last = torch.zeros_like(args[7])
    got = selective_scan_bwd(*args, dout, dh_last)
    want = selective_scan_bwd_plain(*args, dout, dh_last)
    assert all(torch.equal(g, w) for g, w in zip(got, want))
    assert (selective_scan_bwd.launches, kcuda.SCAN_ENTRY_LAUNCHES) == before
    with pytest.raises(ValueError, match="cuda or cpu"):
        selective_scan_bwd(*(a.to("meta") for a in args + [dout, dh_last]))


@pytest.fixture(scope="module")
def mamba_case():
    cfg, jcfg = get_config(JAMBA, reduced=True), j_get_config(JAMBA, reduced=True)
    w, _ = unzip_params(JS.init_mamba(jax.random.PRNGKey(3), jcfg))
    w = {k: np.asarray(v) for k, v in w.items()}
    rng = np.random.default_rng(4)
    w["a_log"] = w["a_log"] + 0.1 * rng.standard_normal(w["a_log"].shape).astype(np.float32)
    w["d_skip"] = (1 + 0.2 * rng.standard_normal(w["d_skip"].shape)).astype(np.float32)
    return cfg, jcfg, w


@pytest.mark.parametrize("carried", [False, True])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_mamba_block_grads_match_jax(mamba_case, dtype, carried):
    """`mamba_block`'s gradients through SelectiveScanFn (weights, x, and the
    carried conv ring and SSM state) against `jax.vjp` of the reference's
    `mamba_block`, with cotangents on the output and on the new SSM state;
    the weights and x in `dtype`, the state fp32 (S 8: one reference scan
    step per position)."""
    cfg, jcfg, w = mamba_case
    tdt, jdt = DTYPES[dtype]
    rng = np.random.default_rng(5)
    b, s, di, n = 2, 8, S._d_inner(cfg), cfg.ssm_state_dim
    x = rng.standard_normal((b, s, cfg.d_model)).astype(np.float32)
    conv = rng.standard_normal((b, cfg.ssm_conv_width - 1, di)).astype(np.float32)
    ssm = rng.standard_normal((b, di, n)).astype(np.float32)
    g_out = rng.standard_normal((b, s, cfg.d_model)).astype(np.float32)
    g_ssm = rng.standard_normal((b, di, n)).astype(np.float32)

    def jf(p, xx, st):
        out, new = JS.mamba_block(p, xx, jcfg, state=JS.MambaState(*st) if carried else None)
        return out, new.ssm

    @jax.jit
    def jgrads(p, xx, st, cts):
        return jax.vjp(jf, p, xx, st)[1](cts)

    jw, jx, jstate = jgrads({k: jnp.asarray(v, jdt) for k, v in w.items()},
                            jnp.asarray(x, jdt), (jnp.asarray(conv), jnp.asarray(ssm)),
                            (jnp.asarray(g_out, jdt), jnp.asarray(g_ssm)))

    p = {k: torch.from_numpy(v).to(tdt).requires_grad_() for k, v in w.items()}
    xt = torch.from_numpy(x).to(tdt).requires_grad_()
    st = [torch.from_numpy(conv).requires_grad_(), torch.from_numpy(ssm).requires_grad_()]
    out, new = S.mamba_block(p, xt, cfg, state=S.MambaState(*st) if carried else None)
    leaves = list(p.values()) + [xt] + (st if carried else [])
    grads = torch.autograd.grad((out, new.ssm), leaves,
                                (torch.from_numpy(g_out).to(tdt), torch.from_numpy(g_ssm)))
    want = [jw[k] for k in p] + [jx] + (list(jstate) if carried else [])
    names = list(p) + ["x"] + (["conv", "ssm"] if carried else [])
    for name, g, wnt, leaf in zip(names, grads, want, leaves):
        assert g.dtype == leaf.dtype, name
        _hold(_f32(g), _f32(wnt), dtype, name, bf16_rel=2.0 ** -5)


# ---------------------------------------------------------------------------
# the reduced models' loss and gradients
# ---------------------------------------------------------------------------


def _reduced(arch, qk_norm=False):
    cfg, jcfg = get_config(arch, reduced=True), j_get_config(arch, reduced=True)
    if qk_norm:
        cfg, jcfg = (dataclasses.replace(c, qk_norm=True) for c in (cfg, jcfg))
    jparams, _ = JM.init_params(jcfg, jax.random.PRNGKey(0))
    return cfg, jcfg, jax.tree_util.tree_map(np.asarray, jparams)


def _batch(cfg):
    rng = np.random.default_rng(3)
    return {"tokens": rng.integers(0, cfg.vocab_size, (2, 8)).astype(np.int32),
            "labels": rng.integers(0, cfg.vocab_size, (2, 8)).astype(np.int32)}


def _reached(arch, grads):
    """Every gradient leaf finite, and the MLA or Mamba leaves nonzero."""
    mix = ("w_dkv", "w_uk", "w_kr", "w_uq") if arch == DEEPSEEK else (
        "in_proj", "conv_w", "x_proj", "dt_proj", "a_log", "d_skip")
    for path, g in tree_paths(grads):
        assert bool(torch.isfinite(g.float()).all()), path
        if path.split("/")[-1] in mix:
            assert float(g.float().abs().sum()) > 0, path


@pytest.mark.parametrize("arch,qk_norm", [(DEEPSEEK, False), (JAMBA, False), (JAMBA, True)],
                         ids=["deepseek", "jamba", "jamba-qk_norm"])
def test_reduced_loss_and_grads_match_jax_fp32(arch, qk_norm):
    """`loss_and_grads` at fp32 (remat "full", through MLAAttentionFn or
    SelectiveScanFn) against the reference's loss and `jax.grad`: the loss
    at 1e-5 relative; every leaf where the config is conditioned for it
    (not the registered jamba: the module docstring)."""
    cfg, jcfg, npp = _reduced(arch, qk_norm)
    batch = _batch(cfg)
    jb = {k: jnp.asarray(v) for k, v in batch.items()}
    hold = arch == DEEPSEEK or qk_norm
    loss_fn = functools.partial(JM.lm_loss, jcfg, batch=jb)
    if hold:
        jloss, jgrads = jax.jit(jax.value_and_grad(loss_fn))(npp)
    else:
        jloss = jax.jit(loss_fn)(npp)
    params = lm_params_from_jax(npp, cfg, device="cpu")
    loss, grads = loss_and_grads(cfg, DEFAULT_RUN.replace(param_dtype="float32"), params,
                                 {k: torch.from_numpy(v) for k, v in batch.items()})
    np.testing.assert_allclose(float(loss), float(jloss), rtol=1e-5)
    _reached(arch, grads)
    if hold:
        jflat = {"/".join(str(k.key) for k in p): np.asarray(g)
                 for p, g in jax.tree_util.tree_flatten_with_path(jgrads)[0]}
        got = dict(tree_paths(grads))
        assert sorted(got) == sorted(jflat)
        for path, g in got.items():
            _hold(g.numpy(), jflat[path], "float32", path)


@pytest.mark.parametrize("arch", [DEEPSEEK, JAMBA])
def test_reduced_loss_and_grads_at_bf16_default_run(arch):
    """The reference launcher's default, bf16 parameters and activations
    with remat "full": the loss against the reference's at bf16 within
    1e-2 relative, every gradient leaf in bf16, finite, and the MLA or
    Mamba leaves reached. (jamba's Mamba sublayers once handed the scan a
    bf16 A, which it refused.)"""
    cfg, jcfg, npp = _reduced(arch)
    batch = _batch(cfg)
    jp = jax.tree_util.tree_map(lambda a: jnp.asarray(a, jnp.bfloat16), npp)
    jloss = jax.jit(functools.partial(JM.lm_loss, jcfg))(
        jp, {k: jnp.asarray(v) for k, v in batch.items()})
    params = lm_params_from_jax(npp, cfg, device="cpu", dtype=torch.bfloat16)
    assert DEFAULT_RUN.param_dtype == "bfloat16" and DEFAULT_RUN.remat == "full"
    loss, grads = loss_and_grads(cfg, DEFAULT_RUN, params,
                                 {k: torch.from_numpy(v) for k, v in batch.items()})
    assert abs(float(loss) - float(jloss)) <= 1e-2 * abs(float(jloss)), (float(loss),
                                                                        float(jloss))
    assert all(g.dtype == torch.bfloat16 for _, g in tree_paths(grads))
    _reached(arch, grads)
