"""Flash attention on the port against the JAX package: `flash_fwd`'s and
`flash_fwd_q8`'s plain versions against `flash_fwd_pallas` and
`flash_fwd_q8_pallas` (interpret mode), `_quantize_kv`, and `flash_mha`.
The same numpy inputs, made from a seed, go to both packages.

Tolerances:
- out, m and l: rtol = atol = 1e-5 (fp32; the Pallas kernel sums its
  online softmax tile by tile, the plain version in one pass);
- quantized K/V: int8 values identical, scales at 1e-7 relative (one fp32
  max and one division on both sides);
- the model layout against the kernel layout on the port: identical (the
  same plain arithmetic on permuted views);
- bf16 q, k, v against `flash_fwd_pallas` at bf16: out within 2^-7 *
  max|Pallas| (one bf16 ulp at the largest value: both round p to bf16
  before P.V and round out, the Pallas kernel p against each tile's running
  max, the plain version against the row's max; observed up to 0.90 of the
  limit, at (2, 4, 64, 128, 32) non-causal), m and l within 1e-5 *
  max|Pallas| (fp32 sums of exact products; observed up to 4.6e-7 of
  max|m| and 3.1e-7 of max|l|). The Pallas kernel's q * scale is the exact
  product of q and bf16(scale), unrounded, and so is the plain version's:
  rounding it to bf16 would move m and l by about 1e-3 of their maxima."""
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.kernels.flash_attention.kernel import (  # noqa: E402
    flash_fwd_pallas,
    flash_fwd_q8_pallas,
)
from repro.kernels.flash_attention.ops import flash_mha as j_flash_mha  # noqa: E402
from repro.kernels.flash_attention.ref import attention_ref as j_attention_ref  # noqa: E402
from repro.models.attention import _quantize_kv as j_quantize_kv  # noqa: E402
from repro_torch.kernels.cuda import check_flash_operands, flash_strides  # noqa: E402
from repro_torch.kernels.flash_attention.kernel import (  # noqa: E402
    flash_fwd,
    flash_fwd_plain,
    flash_fwd_q8,
    flash_fwd_q8_plain,
)
from repro_torch.kernels.flash_attention.ops import flash_mha  # noqa: E402
from repro_torch.kernels.flash_attention.ref import attention_ref  # noqa: E402
from repro_torch.models.attention import _dequantize_kv, _quantize_kv  # noqa: E402

TOL = dict(rtol=1e-5, atol=1e-5)


def _inputs(bkv, g, sq, sk, d, seed=0, scale=0.5):
    rng = np.random.default_rng(seed)
    q = (rng.standard_normal((bkv, g, sq, d)) * scale).astype(np.float32)
    k = (rng.standard_normal((bkv, sk, d)) * scale).astype(np.float32)
    v = (rng.standard_normal((bkv, sk, d)) * scale).astype(np.float32)
    return q, k, v


def _t(*xs):
    return tuple(torch.from_numpy(np.array(x)) for x in xs)


def _check_fwd(q, k, v, *, causal, q_offset=0, kv_len=None, qc, kc):
    d = q.shape[-1]
    jo, jm, jl = flash_fwd_pallas(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                                  scale=d ** -0.5, causal=causal, q_offset=q_offset,
                                  kv_len=kv_len, qc=qc, kc=kc)
    out, m, l = flash_fwd(*_t(q, k, v), scale=d ** -0.5, causal=causal,
                          q_offset=q_offset, kv_len=kv_len)
    np.testing.assert_allclose(out.numpy(), np.asarray(jo), **TOL)
    np.testing.assert_allclose(m.numpy(), np.asarray(jm), **TOL)
    np.testing.assert_allclose(l.numpy(), np.asarray(jl), **TOL)
    return out


@pytest.mark.parametrize("bkv,g,sq,sk,d", [(1, 1, 32, 32, 16), (2, 4, 64, 128, 32),
                                           (3, 2, 48, 96, 64)])
@pytest.mark.parametrize("causal", [True, False])
def test_fwd_sweep_matches_pallas(bkv, g, sq, sk, d, causal):
    q, k, v = _inputs(bkv, g, sq, sk, d, seed=sq + sk)
    _check_fwd(q, k, v, causal=causal, qc=16, kc=32)


def _check_fwd_bf16(q, k, v, *, causal, q_offset=0, kv_len=None, qc, kc):
    """bf16 plain forward vs `flash_fwd_pallas` at bf16 (interpret mode) on
    the same bf16 values."""
    d = q.shape[-1]
    jq, jk, jv = (jnp.asarray(x, jnp.bfloat16) for x in (q, k, v))
    jo, jm, jl = flash_fwd_pallas(jq, jk, jv, scale=d ** -0.5, causal=causal,
                                  q_offset=q_offset, kv_len=kv_len, qc=qc, kc=kc)
    tq, tk, tv = (torch.from_numpy(np.asarray(x, np.float32)).to(torch.bfloat16)
                  for x in (jq, jk, jv))
    out, m, l = flash_fwd(tq, tk, tv, scale=d ** -0.5, causal=causal, q_offset=q_offset,
                          kv_len=kv_len)
    assert out.dtype == torch.bfloat16 and m.dtype == l.dtype == torch.float32
    jo = np.asarray(jo, np.float32)
    assert np.abs(out.float().numpy() - jo).max() <= 2.0 ** -7 * np.abs(jo).max()
    for got, want in ((m, jm), (l, jl)):
        want = np.asarray(want)
        assert np.abs(got.numpy() - want).max() <= 1e-5 * np.abs(want).max()


@pytest.mark.parametrize("bkv,g,sq,sk,d", [(1, 1, 32, 32, 16), (2, 4, 64, 128, 32),
                                           (3, 2, 48, 96, 64)])
@pytest.mark.parametrize("causal", [True, False])
def test_fwd_sweep_bf16_matches_pallas(bkv, g, sq, sk, d, causal):
    """The reference's bf16 cases of `test_fwd_sweep`."""
    q, k, v = _inputs(bkv, g, sq, sk, d, seed=sq + sk)
    _check_fwd_bf16(q, k, v, causal=causal, qc=16, kc=32)


@pytest.mark.parametrize("d,q_offset,kv_len", [(8, 0, None), (8, 5, 30), (128, 5, 30),
                                               (128, 99, 100)])
def test_fwd_bf16_head_dim_8_and_offsets_match_pallas(d, q_offset, kv_len):
    """Head dim 8 (the CUDA kernel pads it to the k16 of its MMA) and
    q_offset / kv_len, with a ragged Sq."""
    q, k, v = _inputs(2, 2, 24, 40, d, seed=d + q_offset)
    _check_fwd_bf16(q, k, v, causal=True, q_offset=q_offset, kv_len=kv_len, qc=24, kc=8)


def test_fwd_decode_mode_matches_pallas():
    """Sq=1 with q_offset/kv_len: the serve step's configuration."""
    q, k, v = _inputs(2, 4, 1, 128, 32, seed=1)
    _check_fwd(q, k, v, causal=True, q_offset=99, kv_len=100, qc=1, kc=32)


# Decode at the fp32 tensor-core kernel's tile edges: G = 1, 2, 4, 8 rows of
# a 16-row tile, kv_len at 1, inside, just short of and just past a 16-key
# chunk and the 64-key cache, q_offset > 0; (bkv, g, sk, kv_len).
DECODE_EDGES = [(4, 2, 64, 1), (4, 2, 64, 17), (4, 2, 64, 63), (2, 8, 80, 65),
                (3, 1, 64, 33), (2, 4, 80, 41)]


@pytest.mark.parametrize("bkv,g,sk,kv_len", DECODE_EDGES)
def test_fwd_decode_tile_edges_match_pallas(bkv, g, sk, kv_len):
    q, k, v = _inputs(bkv, g, 1, sk, 128, seed=kv_len + g)
    _check_fwd(q, k, v, causal=True, q_offset=kv_len - 1, kv_len=kv_len, qc=1, kc=16)


def test_fwd_matches_the_oracle_and_ref_matches_jax():
    q, k, v = _inputs(2, 3, 40, 72, 32, seed=2)
    kw = dict(scale=32 ** -0.5, causal=True, q_offset=5, kv_len=60)
    want = np.asarray(j_attention_ref(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), **kw))
    np.testing.assert_allclose(attention_ref(*_t(q, k, v), **kw).numpy(), want, **TOL)
    np.testing.assert_allclose(flash_fwd(*_t(q, k, v), **kw)[0].numpy(), want, **TOL)


def test_fully_masked_rows_average_v_as_pallas():
    """kv_len = 0 masks every key: the -1e30 mask gives the mean of v (m = -1e30,
    l = Sk), not NaN."""
    q, k, v = _inputs(2, 2, 8, 32, 16, seed=3)
    out = _check_fwd(q, k, v, causal=False, kv_len=0, qc=8, kc=32)
    np.testing.assert_allclose(out.numpy(), np.broadcast_to(
        v.mean(1)[:, None, None], out.shape), rtol=1e-5, atol=1e-6)


def test_gqa_groups_share_kv():
    """All groups of one kv head see the same k/v (GQA semantics)."""
    q, k, v = _inputs(1, 4, 16, 16, 8, seed=4)
    q_same = np.broadcast_to(q[:, :1], q.shape).copy()
    out = _check_fwd(q_same, k, v, causal=True, qc=8, kc=8)
    for g in range(1, 4):
        np.testing.assert_allclose(out[:, 0].numpy(), out[:, g].numpy(), rtol=1e-6,
                                   atol=1e-6)


def _q8_inputs(causal_seed):
    bkv, g, sq, sk, d = 2, 3, 16, 128, 32
    q, k, v = _inputs(bkv, g, sq, sk, d, seed=causal_seed)
    kq, ks = j_quantize_kv(jnp.asarray(k).reshape(bkv, sk, 1, d))
    vq, vs = j_quantize_kv(jnp.asarray(v).reshape(bkv, sk, 1, d))
    return (q, np.asarray(kq).reshape(bkv, sk, d), np.asarray(vq).reshape(bkv, sk, d),
            np.asarray(ks).reshape(bkv, sk), np.asarray(vs).reshape(bkv, sk))


@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("q_offset,kv_len", [(0, None), (100, 117)])
def test_q8_matches_pallas(causal, q_offset, kv_len):
    q, kq, vq, ks, vs = _q8_inputs(7 + int(causal))
    d = q.shape[-1]
    want = flash_fwd_q8_pallas(*(jnp.asarray(x) for x in (q, kq, vq, ks, vs)),
                               scale=d ** -0.5, causal=causal, q_offset=q_offset,
                               kv_len=kv_len, qc=8, kc=32)
    got = flash_fwd_q8(*_t(q, kq, vq, ks, vs), scale=d ** -0.5, causal=causal,
                       q_offset=q_offset, kv_len=kv_len)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


def test_q8_equals_the_fp32_kernel_on_the_dequantized_cache():
    q, kq, vq, ks, vs = _q8_inputs(9)
    kt, vt, kst, vst = _t(kq, vq, ks, vs)
    kw = dict(scale=32 ** -0.5, causal=True, q_offset=3, kv_len=90)
    got = flash_fwd_q8_plain(torch.from_numpy(q), kt, vt, kst, vst, **kw)
    want = flash_fwd_plain(torch.from_numpy(q), kt.float() * kst[..., None],
                           vt.float() * vst[..., None], **kw)[0]
    assert torch.equal(got, want)


@pytest.mark.parametrize("shape", [(2, 64, 4, 32), (2, 16, 3, 128), (1, 7, 8, 8)])
def test_quantize_kv_matches_jax(shape):
    rng = np.random.default_rng(sum(shape))
    x = (rng.standard_normal(shape) * 2.0).astype(np.float32)
    x[0, 0, 0] = 0.0  # an all-zero row: the 1e-8 floor
    jq, js = j_quantize_kv(jnp.asarray(x))
    q, s = _quantize_kv(torch.from_numpy(x))
    assert q.dtype == torch.int8
    np.testing.assert_array_equal(q.numpy(), np.asarray(jq))
    np.testing.assert_allclose(s.numpy(), np.asarray(js), rtol=1e-7, atol=0)
    back = _dequantize_kv(q, s, torch.float32)
    assert float((back - torch.from_numpy(x)).abs().max() / np.abs(x).max()) < 0.01


def test_flash_mha_matches_jax():
    rng = np.random.default_rng(11)
    b, s, kv, g, d = 2, 48, 2, 4, 16
    q = (rng.standard_normal((b, s, kv, g, d)) * 0.4).astype(np.float32)
    k = (rng.standard_normal((b, s, kv, d)) * 0.4).astype(np.float32)
    v = (rng.standard_normal((b, s, kv, d)) * 0.4).astype(np.float32)
    want = j_flash_mha(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), causal=True,
                       qc=16, kc=16)
    got = flash_mha(*_t(q, k, v), causal=True)
    assert got.shape == (b, s, kv, g, d)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


def _model_layout(q, k, v, b, kvh):
    """(BKV, ...) arrays -> the model's (B, Sq, KV, G, D) / (B, Sk, KV, D)."""
    bkv, g, sq, d = q.shape
    sk = k.shape[1]
    qm = torch.from_numpy(q).reshape(b, kvh, g, sq, d).permute(0, 3, 1, 2, 4).contiguous()
    km = torch.from_numpy(k).reshape(b, kvh, sk, d).permute(0, 2, 1, 3).contiguous()
    vm = torch.from_numpy(v).reshape(b, kvh, sk, d).permute(0, 2, 1, 3).contiguous()
    return qm, km, vm


def test_model_layout_equals_kernel_layout():
    b, kvh = 2, 3
    q, k, v = _inputs(b * kvh, 2, 5, 40, 16, seed=12)
    qm, km, vm = _model_layout(q, k, v, b, kvh)
    kw = dict(scale=0.25, causal=True, q_offset=35, kv_len=40)
    out, m, l = flash_fwd(*_t(q, k, v), **kw)
    om, mm, lm = flash_fwd(qm, km, vm, **kw)
    assert om.shape == qm.shape and mm.shape == m.shape
    assert torch.equal(om.permute(0, 2, 3, 1, 4).reshape(out.shape), out)
    assert torch.equal(mm, m) and torch.equal(lm, l)


def _gather(t, nbkv, nh, g, sq, d, strides):
    """What the kernel reads from `t` through (b, h, g, s) element strides."""
    sb, sh, sg, ss = strides
    return torch.as_strided(t, (nbkv // nh, nh, g, sq, d), (sb, sh, sg, ss, 1),
                            t.storage_offset()).reshape(nbkv, g, sq, d)


@pytest.mark.parametrize("layout", ["kernel", "model", "cache_view"])
def test_kernel_strides_address_the_operands(layout):
    """The stride table `launch_flash` hands the CUDA kernel reads the same
    elements as the plain version's permuted views, in each layout, and for a
    cache slice (a strided view) read in place."""
    b, kvh, g, sq, sk, d = 2, 4, 2, 3, 9, 8
    q, k, v = _inputs(b * kvh, g, sq, sk, d, seed=13)
    ks = np.random.default_rng(14).random((b * kvh, sk)).astype(np.float32)
    if layout == "kernel":
        qt, kt, vt, kst = _t(q, k, v, ks)
    else:
        qt, kt, vt = _model_layout(q, k, v, b, kvh)
        kst = torch.from_numpy(ks).reshape(b, kvh, sk).permute(0, 2, 1).contiguous()
        if layout == "cache_view":  # the layer slice of a stacked cache
            big = torch.zeros((3,) + tuple(kt.shape))
            big[1] = kt
            kt = big[1]
            bigs = torch.zeros((3,) + tuple(kst.shape))
            bigs[1] = kst
            kst = bigs[1]
    nbkv, nh, gg, sq_, sk_, d_ = check_flash_operands(qt, kt, vt, kst, kst)
    assert (nbkv, gg, sq_, sk_, d_) == (b * kvh, g, sq, sk, d)
    out = torch.empty(qt.shape)
    st = flash_strides(qt, kt, vt, out, kst)
    assert torch.equal(_gather(qt, nbkv, nh, g, sq, d, st[0:4]), torch.from_numpy(q))
    k_read = _gather(kt, nbkv, nh, 1, sk, d, (st[4], st[5], 0, st[6]))[:, 0]
    assert torch.equal(k_read, torch.from_numpy(k))
    v_read = _gather(vt, nbkv, nh, 1, sk, d, (st[7], st[8], 0, st[9]))[:, 0]
    assert torch.equal(v_read, torch.from_numpy(v))
    s_read = torch.as_strided(kst, (nbkv // nh, nh, sk), st[10:13], kst.storage_offset())
    assert torch.equal(s_read.reshape(nbkv, sk), torch.from_numpy(ks))
    marker = torch.arange(out.numel(), dtype=torch.float32).reshape(out.shape)
    out.copy_(marker)
    o_bkv = _gather(out, nbkv, nh, g, sq, d, st[13:17])
    if layout == "kernel":
        assert torch.equal(o_bkv, marker)
    else:
        assert torch.equal(o_bkv, marker.permute(0, 2, 3, 1, 4).reshape(nbkv, g, sq, d))


@pytest.mark.parametrize("bad", ["k_len", "heads", "scale_shape", "one_scale"])
def test_operand_checks_raise(bad):
    q = torch.zeros(2, 3, 4, 8)
    k = torch.zeros(2, 5, 8)
    ks = torch.zeros(2, 5)
    args = {"k_len": (q, k, torch.zeros(2, 6, 8)),
            "heads": (torch.zeros(1, 4, 2, 3, 8), torch.zeros(1, 4, 3, 8),
                      torch.zeros(1, 4, 3, 8)),
            "scale_shape": (q, k, k, ks, torch.zeros(2, 4)),
            "one_scale": (q, k, k, ks, None)}[bad]
    with pytest.raises(ValueError):
        check_flash_operands(*args)
