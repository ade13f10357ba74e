"""The flash-attention backward on the port against the JAX package:
`flash_bwd`'s plain version against `flash_bwd_pallas` (interpret mode),
gradients through `FlashAttentionFn` against `jax.grad` of the JAX
`flash_mha`, and `torch.autograd.gradcheck` of the Function in float64. The
same numpy inputs, made from a seed, go to both packages.

Tolerances:
- dq, dk, dv against `flash_bwd_pallas` on the same (q, k, v, out, m, l,
  do): rtol = atol = 1e-5 (fp32; the Pallas kernels sum tile by tile, the
  plain version in one pass);
- `flash_mha` gradients against `jax.grad`: rtol = atol = 1e-5 (both sides
  recompute p from their own forward's m and l, fp32);
- gradcheck: its float64 defaults (eps 1e-6, atol 1e-5, rtol 1e-3);
- bf16 q, k, v, do against `flash_bwd_pallas` at bf16 on the same bf16
  values and the Pallas forward's out, m and l: dq, dk and dv within
  2^-7 * max|Pallas| (one bf16 ulp at the largest value: both round ds to
  bf16 before ds.K and ds^T.q and round the outputs; observed up to 0.30 of
  the limit)."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.kernels.flash_attention.kernel import (  # noqa: E402
    flash_bwd_pallas,
    flash_fwd_pallas,
)
from repro.kernels.flash_attention.ops import flash_mha as j_flash_mha  # noqa: E402
from repro_torch.kernels.cuda import check_flash_operands, flash_bwd_strides  # noqa: E402
from repro_torch.kernels.flash_attention.kernel import (  # noqa: E402
    flash_bwd,
    flash_bwd_dkv,
    flash_bwd_dq,
    flash_bwd_plain,
    flash_delta,
    flash_fwd,
)
from repro_torch.kernels.flash_attention.ops import FlashAttentionFn, flash_mha  # noqa: E402

TOL = dict(rtol=1e-5, atol=1e-5)


def _arrays(seed, *shapes, scale=0.5):
    rng = np.random.default_rng(seed)
    return [(rng.standard_normal(s) * scale).astype(np.float32) for s in shapes]


def _t(*xs):
    return [torch.from_numpy(np.array(x)) for x in xs]


# (bkv, g, sq, sk, d, q_offset, kv_len, qc, kc): the reference's gradient
# test shape (tests/test_flash_attention.py:43-54) and GQA with G = 4 under
# q_offset / kv_len; then the CUDA kernels' edges (16-row tiles of the
# flattened (position, group) rows, 16-key chunks): Sq * G not a multiple of
# 16 with G = 3 and Sk ending mid-chunk, G = 8, and q_offset < 0 with kv_len.
BWD_CASES = [
    (2, 3, 64, 128, 32, 0, None, 32, 64),
    (2, 4, 32, 64, 16, 16, 40, 16, 32),
    (3, 4, 48, 48, 8, 0, None, 16, 16),
    (2, 3, 13, 40, 16, 0, None, 13, 8),
    (2, 8, 11, 57, 32, 5, None, 11, 19),
    (3, 2, 21, 30, 8, -4, 17, 7, 10),
]


@pytest.mark.parametrize("case", BWD_CASES, ids=lambda c: "-".join(map(str, c)))
@pytest.mark.parametrize("causal", [True, False])
def test_bwd_plain_matches_pallas(case, causal):
    bkv, g, sq, sk, d, q_offset, kv_len, qc, kc = case
    q, k, v, do = _arrays(sq + sk + d, (bkv, g, sq, d), (bkv, sk, d), (bkv, sk, d),
                          (bkv, g, sq, d))
    kw = dict(scale=d ** -0.5, causal=causal, q_offset=q_offset, kv_len=kv_len)
    jq, jk, jv, jdo = map(jnp.asarray, (q, k, v, do))
    out, m, l = flash_fwd_pallas(jq, jk, jv, qc=qc, kc=kc, **kw)
    want = flash_bwd_pallas(jq, jk, jv, out, m, l, jdo, qc=qc, kc=kc, **kw)
    got = flash_bwd_plain(*_t(q, k, v, np.asarray(out), np.asarray(m), np.asarray(l),
                              do), **kw)
    for gt, wt in zip(got, want):
        assert gt.dtype == torch.float32
        np.testing.assert_allclose(gt.numpy(), np.asarray(wt), **TOL)
    # the host wrapper is the plain version, and the passes split it
    tq, tk, tv, tout, tm, tl, tdo = _t(q, k, v, np.asarray(out), np.asarray(m),
                                       np.asarray(l), do)
    assert all(torch.equal(a, b) for a, b in zip(
        flash_bwd(tq, tk, tv, tout, tm, tl, tdo, **kw), got))
    delta = flash_delta(tdo, tout)
    assert torch.equal(flash_bwd_dq(tq, tk, tv, tdo, tm, tl, delta, **kw), got[0])
    dk, dv = flash_bwd_dkv(tq, tk, tv, tdo, tm, tl, delta, **kw)
    assert torch.equal(dk, got[1]) and torch.equal(dv, got[2])


@pytest.mark.parametrize("case", BWD_CASES[:4] + BWD_CASES[5:],
                         ids=lambda c: "-".join(map(str, c)))
@pytest.mark.parametrize("causal", [True, False])
def test_bwd_bf16_plain_matches_pallas(case, causal):
    """The bf16 backward: GQA, head dims 8 to 32, q_offset / kv_len (also
    q_offset < 0), ragged tiles."""
    bkv, g, sq, sk, d, q_offset, kv_len, qc, kc = case
    q, k, v, do = _arrays(sq + sk + d + 1, (bkv, g, sq, d), (bkv, sk, d), (bkv, sk, d),
                          (bkv, g, sq, d))
    kw = dict(scale=d ** -0.5, causal=causal, q_offset=q_offset, kv_len=kv_len)
    jq, jk, jv, jdo = (jnp.asarray(x, jnp.bfloat16) for x in (q, k, v, do))
    out, m, l = flash_fwd_pallas(jq, jk, jv, qc=qc, kc=kc, **kw)
    want = flash_bwd_pallas(jq, jk, jv, out, m, l, jdo, qc=qc, kc=kc, **kw)

    def bf(x):
        return torch.from_numpy(np.asarray(x, np.float32)).to(torch.bfloat16)

    got = flash_bwd(bf(jq), bf(jk), bf(jv), bf(out), *_t(np.asarray(m), np.asarray(l)),
                    bf(jdo), **kw)
    for gt, wt in zip(got, want):
        assert gt.dtype == torch.bfloat16
        wt = np.asarray(wt, np.float32)
        assert np.abs(gt.float().numpy() - wt).max() <= 2.0 ** -7 * np.abs(wt).max()


def test_delta_matches_the_reference_rowsum():
    do, out = _arrays(5, (2, 3, 7, 16), (2, 3, 7, 16))
    want = jnp.sum(jnp.asarray(do) * jnp.asarray(out), axis=-1)
    np.testing.assert_allclose(flash_delta(*_t(do, out)).numpy(), np.asarray(want),
                               rtol=1e-6, atol=1e-6)


def _model_layout(x, b, kvh):
    """(BKV, G, S, D) or (BKV, S, D) -> the model's (B, S, KV, G, D) /
    (B, S, KV, D), contiguous."""
    if x.ndim == 4:
        bkv, g, s, d = x.shape
        return x.reshape(b, kvh, g, s, d).transpose(0, 3, 1, 2, 4).copy()
    bkv, s, d = x.shape
    return x.reshape(b, kvh, s, d).transpose(0, 2, 1, 3).copy()


def test_bwd_model_layout_equals_kernel_layout():
    """The model layout's gradients are the kernel layout's, permuted."""
    b, kvh, g, sq, sk, d = 2, 3, 2, 9, 14, 16
    q, k, v, do = _arrays(6, (b * kvh, g, sq, d), (b * kvh, sk, d), (b * kvh, sk, d),
                          (b * kvh, g, sq, d))
    kw = dict(scale=0.3, causal=True, q_offset=5, kv_len=13)
    out, m, l = flash_fwd(*_t(q, k, v), **kw)
    dq, dk, dv = flash_bwd(*_t(q, k, v), out, m, l, *_t(do), **kw)
    qm, km, vm, dom = (_model_layout(x, b, kvh) for x in (q, k, v, do))
    om, mm, lm = flash_fwd(*_t(qm, km, vm), **kw)
    dqm, dkm, dvm = flash_bwd(*_t(qm, km, vm), om, mm, lm, *_t(dom), **kw)
    assert dqm.shape == qm.shape and dkm.shape == km.shape
    np.testing.assert_allclose(dqm.numpy(), _model_layout(dq.numpy(), b, kvh),
                               rtol=1e-6, atol=1e-6)
    np.testing.assert_allclose(dkm.numpy(), _model_layout(dk.numpy(), b, kvh),
                               rtol=1e-6, atol=1e-6)
    np.testing.assert_allclose(dvm.numpy(), _model_layout(dv.numpy(), b, kvh),
                               rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize("causal", [True, False])
def test_flash_mha_grads_match_jax(causal):
    """Gradients through `FlashAttentionFn` against `jax.grad` of the JAX
    `flash_mha` (its Pallas custom_vjp, interpret mode), loss sum(out * w)."""
    b, s, kvh, g, d = 2, 48, 2, 4, 16
    q, k, v, w = _arrays(21, (b, s, kvh, g, d), (b, s, kvh, d), (b, s, kvh, d),
                         (b, s, kvh, g, d))

    def j_loss(q, k, v):
        return jnp.sum(j_flash_mha(q, k, v, causal=causal, qc=16, kc=16) * w)

    want = jax.grad(j_loss, argnums=(0, 1, 2))(*map(jnp.asarray, (q, k, v)))
    ts = [t.requires_grad_(True) for t in _t(q, k, v)]
    (flash_mha(*ts, causal=causal) * torch.from_numpy(w)).sum().backward()
    for t, wt in zip(ts, want):
        np.testing.assert_allclose(t.grad.numpy(), np.asarray(wt), **TOL)


@pytest.mark.parametrize("layout,causal,q_offset,kv_len", [
    ("model", True, 0, None), ("model", True, 3, 6), ("model", False, 0, 5),
    ("kernel", True, 1, None), ("kernel", False, 0, None),
])
def test_function_gradcheck_float64(layout, causal, q_offset, kv_len):
    """Finite differences in float64 through the plain path, where every
    row sees at least one key (see the next test for rows that see none)."""
    g = torch.Generator().manual_seed(7)
    if layout == "model":
        shapes = ((2, 5, 2, 2, 4), (2, 7, 2, 4))
    else:
        shapes = ((3, 2, 5, 4), (3, 6, 4))
    q = torch.randn(shapes[0], generator=g, dtype=torch.float64, requires_grad=True)
    k = torch.randn(shapes[1], generator=g, dtype=torch.float64, requires_grad=True)
    v = torch.randn(shapes[1], generator=g, dtype=torch.float64, requires_grad=True)
    assert torch.autograd.gradcheck(
        lambda q, k, v: FlashAttentionFn.apply(q, k, v, 0.5, causal, q_offset, kv_len),
        (q, k, v))


def test_fully_masked_rows_keep_the_reference_gradient():
    """A row that sees no key (here q_offset < 0 under the causal mask) has
    m = -1e30 and p = 1/l over every key, so its out is the mean of v and
    does not depend on q or k. The reference's backward still forms
    ds = p * (dp - delta) there, which gives such rows a nonzero dq and
    feeds dk; the port keeps the reference's values (the training path never
    makes such rows: causal from q_offset 0)."""
    bkv, g, sq, sk, d = 2, 2, 16, 16, 8
    q, k, v, do = _arrays(9, (bkv, g, sq, d), (bkv, sk, d), (bkv, sk, d), (bkv, g, sq, d))
    kw = dict(scale=d ** -0.5, causal=True, q_offset=-4, kv_len=None)
    jq, jk, jv, jdo = map(jnp.asarray, (q, k, v, do))
    out, m, l = flash_fwd_pallas(jq, jk, jv, qc=8, kc=8, **kw)
    want = flash_bwd_pallas(jq, jk, jv, out, m, l, jdo, qc=8, kc=8, **kw)
    got = flash_bwd_plain(*_t(q, k, v, np.asarray(out), np.asarray(m), np.asarray(l),
                              do), **kw)
    for gt, wt in zip(got, want):
        np.testing.assert_allclose(gt.numpy(), np.asarray(wt), **TOL)
    masked = np.asarray(m)[:, :, :4]
    assert np.all(masked == -1e30)
    assert float(np.abs(np.asarray(want[0])[:, :, :4]).max()) > 1e-3


def _gather(t, nbkv, nh, g, s, d, strides):
    sb, sh, sg, ss = strides
    return torch.as_strided(t, (nbkv // nh, nh, g, s, d), (sb, sh, sg, ss, 1),
                            t.storage_offset()).reshape(nbkv, g, s, d)


@pytest.mark.parametrize("layout", ["kernel", "model"])
def test_bwd_kernel_strides_address_the_operands(layout):
    """The stride table `launch_flash_bwd` hands the CUDA kernels reads q, k,
    v, do and writes dq, dk, dv where the plain version's views put them."""
    b, kvh, g, sq, sk, d = 2, 3, 2, 4, 6, 8
    q, k, v, do = _arrays(8, (b * kvh, g, sq, d), (b * kvh, sk, d), (b * kvh, sk, d),
                          (b * kvh, g, sq, d))
    if layout == "model":
        qt, kt, vt, dot = _t(*(_model_layout(x, b, kvh) for x in (q, k, v, do)))
    else:
        qt, kt, vt, dot = _t(q, k, v, do)
    nbkv, nh, *_ = check_flash_operands(qt, kt, vt)
    dq, dk, dv = torch.empty(qt.shape), torch.empty(kt.shape), torch.empty(vt.shape)
    st = flash_bwd_strides(qt, kt, vt, dot, dq, dk, dv)
    assert len(st) == 24
    for t, want, part in ((qt, q, st[0:4]), (dot, do, st[10:14])):
        assert torch.equal(_gather(t, nbkv, nh, g, sq, d, part), torch.from_numpy(want))
    for t, want, part in ((kt, k, st[4:7]), (vt, v, st[7:10])):
        got = _gather(t, nbkv, nh, 1, sk, d, (part[0], part[1], 0, part[2]))[:, 0]
        assert torch.equal(got, torch.from_numpy(want))
    for t, part in ((dq, st[14:18]), (dk, st[18:21]), (dv, st[21:24])):
        t.copy_(torch.arange(t.numel(), dtype=torch.float32).reshape(t.shape))
        if t is dq:
            got = _gather(t, nbkv, nh, g, sq, d, part)
            want = t if layout == "kernel" else t.permute(0, 2, 3, 1, 4)
        else:
            got = _gather(t, nbkv, nh, 1, sk, d, (part[0], part[1], 0, part[2]))[:, 0]
            want = t if layout == "kernel" else t.permute(0, 2, 1, 3)
        assert torch.equal(got, want.reshape(got.shape))
