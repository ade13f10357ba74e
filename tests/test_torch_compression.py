"""Gradient compression on the port (`repro_torch.optim.compression`)
against the JAX package's (`repro.optim.compression`). The gradients come
from `jax.random` as numpy and go to both; the int8 scheme's rounding noise
comes from a `torch.Generator` on the port and a `jax.random` key in the
reference, so int8 is held to the reference's scale exactly and to q within
one step of round(g / scale), and both schemes to the error-feedback
identity.

Tolerances:
- the reference's two tests, mirrored (same strategies, hence the same seeds
  under `_hypothesis_compat`): sum of decompressed + final error within
  rtol = atol = 1e-4 of the true sum; the quadratic within 0.02 of c;
- topk kept values and errors: identical to the reference's (a threshold
  and a mask on the same float32 values);
- int8 scale: identical (one fp32 max and one division on both sides);
- g + err_old = decompressed + err_new: 1e-6 * max|g| (one fp32 product and
  subtraction per entry)."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
from _hypothesis_compat import given, settings, st

torch = pytest.importorskip("torch")

from repro.optim import compress_grads as j_compress_grads  # noqa: E402
from repro.optim import decompress_grads as j_decompress_grads  # noqa: E402
from repro.optim import init_error_feedback as j_init_error_feedback  # noqa: E402
from repro_torch.optim import (  # noqa: E402
    compress_grads,
    decompress_grads,
    init_error_feedback,
)


def _t(tree):
    return {k: torch.from_numpy(np.array(v, dtype=np.float32)) for k, v in tree.items()}


@settings(max_examples=10, deadline=None)
@given(seed=st.integers(0, 1000), scheme=st.sampled_from(["int8", "topk"]))
def test_compression_error_feedback_unbiased(seed, scheme):
    """The reference's test on the port: accumulated (decompressed + error)
    equals the true gradient sum."""
    g = _t({"w": jax.random.normal(jax.random.PRNGKey(seed), (64,))})
    err = init_error_feedback(g)
    total_sent = np.zeros(64)
    total_true = np.zeros(64)
    gen = torch.Generator().manual_seed(seed + 1)
    for i in range(5):
        gi = _t({"w": jax.random.normal(jax.random.PRNGKey(seed + 10 + i), (64,))})
        total_true += gi["w"].numpy()
        comp, err = compress_grads(gi, err, scheme=scheme, generator=gen, topk_frac=0.1)
        dec = decompress_grads(comp, scheme=scheme)
        total_sent += dec["w"].numpy()
    np.testing.assert_allclose(total_sent + err["w"].numpy(), total_true, rtol=1e-4, atol=1e-4)


def test_compressed_sgd_converges_on_quadratic():
    """min ||x - c||^2 with int8-compressed gradients and error feedback."""
    c = torch.linspace(-1, 1, 32)
    x = {"x": torch.zeros(32)}
    err = init_error_feedback(x)
    gen = torch.Generator().manual_seed(0)
    for _ in range(200):
        g = {"x": 2 * (x["x"] - c)}
        comp, err = compress_grads(g, err, scheme="int8", generator=gen)
        dec = decompress_grads(comp, scheme="int8")
        x = {"x": x["x"] - 0.05 * dec["x"]}
    assert float((x["x"] - c).abs().max()) < 0.02


def _grads(seed):
    """A two-leaf gradient tree with repeated magnitudes (ties at a topk
    threshold) and an error buffer, as numpy."""
    rng = np.random.default_rng(seed)
    a = rng.standard_normal((6, 40)).astype(np.float32)
    a[0, :8] = a[1, 0]  # ties
    a[2, :4] = -a[1, 0]
    b = rng.standard_normal((33,)).astype(np.float32) * 1e-3
    e = {"a": (rng.standard_normal((6, 40)) * 0.1).astype(np.float32),
         "b": (rng.standard_normal((33,)) * 1e-4).astype(np.float32)}
    return {"a": a, "b": b}, e


@pytest.mark.parametrize("frac", [0.01, 0.05, 0.1, 0.5, 1.0])
@pytest.mark.parametrize("seed", [0, 1])
def test_topk_is_the_references(frac, seed):
    g, e = _grads(seed)
    jc, je = j_compress_grads({k: jnp.asarray(v) for k, v in g.items()},
                              {k: jnp.asarray(v) for k, v in e.items()},
                              scheme="topk", topk_frac=frac)
    pc, pe = compress_grads(_t(g), _t(e), scheme="topk", topk_frac=frac)
    jd = j_decompress_grads(jc, scheme="topk")
    pd = decompress_grads(pc, scheme="topk")
    for k in g:
        np.testing.assert_array_equal(pd[k].numpy(), np.asarray(jd[k]))
        np.testing.assert_array_equal(pe[k].numpy(), np.asarray(je[k]))


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_int8_scale_is_the_references_and_q_within_one_step(seed):
    g, e = _grads(seed)
    jc, _ = j_compress_grads({k: jnp.asarray(v) for k, v in g.items()},
                             {k: jnp.asarray(v) for k, v in e.items()},
                             scheme="int8", key=jax.random.PRNGKey(seed))
    pc, pe = compress_grads(_t(g), _t(e), scheme="int8",
                            generator=torch.Generator().manual_seed(seed))
    for k in g:
        q, scale = pc[k]
        assert q.dtype == torch.int8 and scale.dtype == torch.float32
        assert float(scale) == float(np.asarray(jc[k][1]))
        total = _t(g)[k] + _t(e)[k]
        nearest = torch.round(total / scale)
        assert int((q.float() - nearest).abs().max()) <= 1
        assert int(q.abs().max()) <= 127
        assert float((total - q.float() * scale - pe[k]).abs().max()) == 0.0


@pytest.mark.parametrize("scheme", ["int8", "topk"])
def test_error_feedback_identity(scheme):
    """g + err_old = decompressed + err_new, leaf by leaf."""
    g, e = _grads(3)
    tg, te = _t(g), _t(e)
    comp, new_err = compress_grads(tg, te, scheme=scheme,
                                   generator=torch.Generator().manual_seed(4),
                                   topk_frac=0.05)
    dec = decompress_grads(comp, scheme=scheme)
    for k in g:
        lim = 1e-6 * float(tg[k].abs().max())
        assert float((tg[k] + te[k] - dec[k] - new_err[k]).abs().max()) <= lim


def test_init_error_feedback_and_bad_schemes():
    params = {"w": torch.ones((3, 2), dtype=torch.bfloat16), "n": {"b": torch.ones(4)}}
    err = init_error_feedback(params)
    jerr = j_init_error_feedback({"w": jnp.ones((3, 2), jnp.bfloat16),
                                  "n": {"b": jnp.ones(4)}})
    assert err["w"].dtype == torch.float32 and tuple(err["w"].shape) == jerr["w"].shape
    assert float(err["n"]["b"].abs().sum()) == 0.0
    with pytest.raises(ValueError):
        compress_grads(params, err, scheme="fp8")
    with pytest.raises(ValueError, match="generator"):
        compress_grads(params, err, scheme="int8")
    with pytest.raises(ValueError):
        decompress_grads(params, scheme="fp8")
