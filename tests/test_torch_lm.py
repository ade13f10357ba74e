"""The port's dense LM (reduced qwen3-0.6b) against the JAX package: configs,
layer primitives, `forward`, prefill plus teacher-forced decode over an fp32
and an int8 KV cache, and the serve launcher. The JAX weights (from
`jax.random`) are carried over as numpy with `lm_params_from_jax`; prompt
tokens come from a numpy seed. The JAX side runs without a mesh.

Tolerances:
- logits: max|port - jax| <= 1e-4 * max|jax| + 1e-6 (fp32 through 2 layers,
  matmuls and the attention softmax summed in another order);
- fp32 cache contents: rtol = atol = 1e-5;
- int8 cache: values within 1 (a value at a rounding boundary may round
  either way after fp32 noise upstream), scales at 1e-5 relative;
- rms_norm / rope / activations: rtol = atol = 1e-6;
- the port's decode against its own full forward: rtol = atol = 2e-3, as
  `tests/test_models.py::test_decode_matches_teacher_forcing`."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.configs import get_config as j_get_config  # noqa: E402
from repro.core.sparse_ffn import activation_fn as j_activation_fn  # noqa: E402
from repro.models import layers as j_layers  # noqa: E402
from repro.models import model as JM  # noqa: E402
from repro_torch.configs.base import ModelConfig, RunConfig, get_config, list_archs  # noqa: E402
from repro_torch.convert import lm_params_from_jax  # noqa: E402
from repro_torch.core.sparse_ffn import activation_fn  # noqa: E402
from repro_torch.launch.serve import serve  # noqa: E402
from repro_torch.models import layers  # noqa: E402
from repro_torch.models import model as M  # noqa: E402
from repro_torch.models.transformer import group_layout  # noqa: E402

ARCH = "qwen3-0.6b"
KEY = jax.random.PRNGKey(0)


def _close_logits(got, want):
    got, want = np.asarray(got, np.float32), np.asarray(want, np.float32)
    err = float(np.abs(got - want).max())
    scale = float(np.abs(want).max())
    assert err <= 1e-4 * scale + 1e-6, (err, scale)


@pytest.fixture(scope="module")
def model():
    cfg = get_config(ARCH, reduced=True)
    jcfg = j_get_config(ARCH, reduced=True)
    jparams, _ = JM.init_params(jcfg, KEY)
    np_params = jax.tree_util.tree_map(np.asarray, jparams)
    return cfg, jcfg, jparams, lm_params_from_jax(np_params, cfg, device="cpu")


def _tokens(cfg, b, s, seed=0):
    return np.random.default_rng(seed).integers(0, cfg.vocab_size, (b, s)).astype(np.int32)


@pytest.mark.parametrize("reduced", [True, False])
def test_configs_match_the_reference(reduced):
    import repro.configs.base as jbase

    port = dataclasses.asdict(get_config(ARCH, reduced=reduced))
    assert port == dataclasses.asdict(j_get_config(ARCH, reduced=reduced))
    assert [f.name for f in dataclasses.fields(ModelConfig)] == \
        [f.name for f in dataclasses.fields(jbase.ModelConfig)]
    assert dataclasses.asdict(RunConfig()) == dataclasses.asdict(jbase.RunConfig())
    # every LM arch of the reference; its "vgg19-sparse" entry is a CNN, which
    # the port keeps as a CNNConfig
    assert list_archs() == [a for a in jbase.list_archs() if a != "vgg19-sparse"]
    assert list_archs() == ["arctic-480b", "deepseek-v2-236b", "jamba-v0.1-52b",
                            "llama-3.2-vision-90b", "minitron-8b", "mistral-large-123b", ARCH,
                            "stablelm-12b", "whisper-tiny", "xlstm-125m"]
    assert get_config(ARCH).rope_theta == 10_000.0  # the repo's default, kept


@pytest.mark.parametrize("name", ["silu", "gelu", "relu", "relu2"])
def test_activation_fn_matches_jax(name):
    x = np.linspace(-4, 4, 101, dtype=np.float32)
    want = np.asarray(j_activation_fn(name)(jnp.asarray(x)))
    got = activation_fn(name)(torch.from_numpy(x)).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-6)


def test_rms_norm_and_rope_match_jax():
    rng = np.random.default_rng(3)
    x = rng.standard_normal((2, 5, 3, 16)).astype(np.float32)
    w = rng.standard_normal(16).astype(np.float32)
    pos = np.broadcast_to(7 + np.arange(5)[None], (2, 5)).astype(np.int32)
    np.testing.assert_allclose(
        layers.rms_norm(torch.from_numpy(x), torch.from_numpy(w), 1e-6).numpy(),
        np.asarray(j_layers.rms_norm(jnp.asarray(x), jnp.asarray(w), 1e-6)),
        rtol=1e-6, atol=1e-6)
    np.testing.assert_allclose(
        layers.rope(torch.from_numpy(x), torch.from_numpy(pos.copy()), 1e4).numpy(),
        np.asarray(j_layers.rope(jnp.asarray(x), jnp.asarray(pos), 1e4)),
        rtol=1e-6, atol=1e-5)


def test_init_params_has_the_reference_tree(model):
    cfg, jcfg, jparams, _ = model
    port = M.init_params(cfg, torch.Generator().manual_seed(0), device="cpu")
    jshapes = jax.tree_util.tree_map(lambda a: tuple(a.shape), jparams)

    def shapes(t):
        return {k: shapes(v) for k, v in t.items()} if isinstance(t, dict) else tuple(t.shape)

    assert shapes(port) == jshapes
    # the reference's fan-in rule: wq (d, h, hd) takes fan_in = h
    wq = port["groups"]["sub0"]["mix"]["wq"]
    assert abs(float(wq.std()) - cfg.n_heads ** -0.5) < 0.02


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
            np.testing.assert_allclose(a.numpy(), np.asarray(ja), rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("kv_dtype", [torch.float32, torch.int8])
def test_decode_matches_teacher_forcing(model, kv_dtype):
    """prefill + token-by-token decode reproduce the port's own full forward
    (fp32 cache at the reference test's 2e-3; the int8 cache within the
    quantization error of `tests/test_kv_quant.py`, 0.12)."""
    cfg, _, _, params = model
    b, s, pre = 2, 12, 5
    toks = torch.from_numpy(_tokens(cfg, b, s, seed=2))
    tol = 2e-3 if kv_dtype == torch.float32 else 0.12
    with torch.no_grad():
        full, _, _ = M.forward(cfg, params, {"tokens": toks})
        cache = M.init_cache(cfg, b, s + 4, kv_dtype, device="cpu")
        lg, cache = M.prefill(cfg, params, cache, {"tokens": toks[:, :pre]})
        np.testing.assert_allclose(lg.numpy(), full[:, :pre].numpy(), rtol=tol, atol=tol)
        for t in range(pre, s):
            lg, cache = M.decode_step(cfg, params, cache, {"tokens": toks[:, t:t + 1]}, t)
            np.testing.assert_allclose(lg[:, 0].numpy(), full[:, t].numpy(), rtol=tol,
                                       atol=tol)


@pytest.mark.parametrize("kv_dtype", ["float32", "int8"])
def test_serve_generates_tokens_on_the_host(kv_dtype):
    res = serve(ARCH, reduced=True, batch=2, prompt_len=8, gen_len=4, device="cpu",
                kv_cache_dtype=kv_dtype)
    assert tuple(res.tokens.shape) == (2, 4) and tuple(res.prompt.shape) == (2, 8)
    assert bool((res.tokens >= 0).all()) and bool((res.tokens < 512).all())
    assert res.prefill_ms > 0 and res.decode_ms > 0 and res.tok_s > 0


def test_serve_is_greedy_over_the_model():
    """The served tokens are the argmax of prefill + decode on the same
    weights (the launcher adds nothing to the model's path)."""
    res = serve(ARCH, reduced=True, batch=2, prompt_len=6, gen_len=3, device="cpu", seed=3)
    cfg = get_config(ARCH, reduced=True)
    params = M.init_params(cfg, torch.Generator().manual_seed(3), device="cpu")
    seq = torch.cat([res.prompt, res.tokens], 1)
    with torch.no_grad():
        full, _, _ = M.forward(cfg, params, {"tokens": seq})
    assert torch.equal(full[:, 5:8].argmax(-1).to(torch.int32), res.tokens)


def test_serve_rejects_an_unknown_cache_dtype():
    with pytest.raises(ValueError, match="kv_cache_dtype"):
        serve(ARCH, device="cpu", kv_cache_dtype="bfloat16")


def test_other_families_are_not_ported_yet(model):
    """Every family of the reference is ported: a VLM config without
    `cross_attn_every` is the reference's plain [attn] stack; a family with
    no group layout raises ValueError, as the reference's `group_layout`
    does."""
    cfg = dataclasses.replace(model[0], family="vlm")
    assert group_layout(cfg) == [("attn", "dense")]
    assert len(M.init_cache(cfg, 1, 4, device="cpu")) == 1
    cfg = dataclasses.replace(model[0], family="cnn")
    with pytest.raises(ValueError, match="family 'cnn'"):
        group_layout(cfg)
    with pytest.raises(ValueError, match="family 'cnn'"):
        M.init_cache(cfg, 1, 4, device="cpu")


def test_lm_params_from_jax_checks_the_layer_axis(model):
    cfg, _, jparams, _ = model
    np_params = jax.tree_util.tree_map(np.asarray, jparams)
    np_params["groups"]["sub0"]["ln1"] = np_params["groups"]["sub0"]["ln1"][:1]
    with pytest.raises(ValueError, match="layers"):
        lm_params_from_jax(np_params, cfg, device="cpu")
    np_params = jax.tree_util.tree_map(np.asarray, jparams)
    del np_params["groups"]["sub0"]["mix"]["q_norm"]
    with pytest.raises(KeyError):
        lm_params_from_jax(np_params, cfg, device="cpu")
