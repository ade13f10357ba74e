"""The port's cross-attention families against the JAX package:
llama-3.2-vision-90b (VLM: a gated cross-attention sublayer over image
embeddings after every four self-attention sublayers) and whisper-tiny
(audio: a non-causal encoder stack, and a decoder of self-attention plus
gated cross-attention over the encoder's output). Configs, group layouts,
parameter counts, the parameter and cache trees; `sinusoid_positions`,
`_abs_pos` and the whisper conv frontend; `gqa_attention` with and without
`kv_src`; the whole reduced models (`forward`, the cross path's effect on
the logits, prefill plus teacher-forced decode over the fp32 and the int8
cache, a two-group VLM); decode against teacher forcing; loss and
gradients; `serve` on the host and the kernel calls each request makes;
`lm_params_from_jax` on both trees. The card's tests are in
`tests/test_torch_cross_cuda.py`, which imports no JAX.

The gate of a cross sublayer is drawn as 0.0, so a fresh cross sublayer
adds exactly 0 and a wrong cross path could not show. Every comparison of
the cross path therefore sets the gate leaves to 0.7 in the numpy tree
before carrying it to both packages, and feeds unit-normal image
embeddings or frames (zero ones give K = V = 0); `test_the_cross_path_moves
_the_logits` holds that the path then moves the logits by more than 100
times the tolerance.

Tolerances: logits at 1e-4 * max|ref| + 1e-6 (PERF.md section 2); blocks
(`gqa_attention`, the encoder output, the frontend) at rtol 1e-5 with atol
1e-5 * max(1, max|ref|) (the same fp32 ops summed in another order); the
loss at 1e-5 relative and every gradient leaf at 1e-4 * max|ref| + 1e-6
(with qk_norm on: see `test_smoke_forward_and_train_step`); decode against
teacher forcing at the reference's own limits (`tests/test_models.py:42`:
prefill 2e-3, decode 3e-3). The registered reduced VLM at 10 layers, and
the gradients of both registered reduced archs, amplify fp32 rounding past
these limits in the reference itself (`scripts/cross_host_conditioning.py`);
those comparisons run with qk_norm on.
"""
import contextlib
import dataclasses
import logging

import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.configs import get_config as j_get_config  # noqa: E402
from repro.models import attention as JA  # noqa: E402
from repro.models import cnn as JC  # noqa: E402
from repro.models import model as JM  # noqa: E402
from repro.models import transformer as JT  # noqa: E402
from repro.models.layers import sinusoid_positions as j_sinusoid_positions  # noqa: E402
from repro.models.layers import unzip_params  # noqa: E402
from repro_torch.configs.base import DEFAULT_RUN, get_config  # noqa: E402
from repro_torch.convert import lm_params_from_jax  # noqa: E402
from repro_torch.kernels.flash_attention import kernel as FK  # noqa: E402
from repro_torch.launch.serve import cache_kind, request_inputs, serve  # noqa: E402
from repro_torch.launch.steps import loss_and_grads  # noqa: E402
from repro_torch.models import attention as A  # noqa: E402
from repro_torch.models import model as M  # noqa: E402
from repro_torch.models import transformer as T  # noqa: E402
from repro_torch.models.cnn import init_whisper_frontend, whisper_frontend  # noqa: E402
from repro_torch.models.layers import sinusoid_positions  # noqa: E402
from repro_torch.tree import tree_paths  # noqa: E402

VLM, WHISPER = "llama-3.2-vision-90b", "whisper-tiny"
ARCHS = [VLM, WHISPER]
KEY = jax.random.PRNGKey(0)
GATE = 0.7
FULL_PARAMS = {VLM: 87_666_794_516, WHISPER: 41_158_276}
VLM_DEPTH5_PARAMS = 6_379_626_497  # the one group chip_smoke serves at full width


def _max(x) -> float:
    return float(np.abs(np.asarray(x, np.float32)).max())


def _err(got, want) -> float:
    return float(np.abs(np.asarray(got, np.float32) - np.asarray(want, np.float32)).max())


def _tol(want) -> float:
    """The logits' limit: 1e-4 * max|ref| + 1e-6."""
    return 1e-4 * _max(want) + 1e-6


def _close_logits(got, want):
    assert _err(got, want) <= _tol(want), (_err(got, want), _tol(want))


def _close(got, want, rtol=1e-5):
    """The blocks' limit: rtol plus an atol of rtol * max(1, max|want|)."""
    want = np.asarray(want, np.float32)
    np.testing.assert_allclose(np.asarray(got, np.float32), want, rtol=rtol,
                               atol=rtol * max(1.0, _max(want)))


def _with_gate(tree, value=GATE):
    """The numpy parameter tree with every `gate` leaf set to `value`."""
    if isinstance(tree, dict):
        return {k: (np.full_like(v, value) if k == "gate" else _with_gate(v, value))
                for k, v in tree.items()}
    return tree


def _tokens(cfg, b, s, seed=0):
    return np.random.default_rng(seed).integers(0, cfg.vocab_size, (b, s)).astype(np.int32)


def _side_input(cfg, b, s, seed=0, key=None):
    """Unit-normal image embeddings (VLM) or frames / an encoder output
    (whisper) from a numpy seed: {key: (b, n, d_model)}."""
    rng = np.random.default_rng(100 + seed)
    if cfg.family == "vlm":
        return {"img_embeds": rng.standard_normal((b, cfg.n_image_tokens, cfg.d_model))
                .astype(np.float32)}
    return {key or "frames": rng.standard_normal((b, s, cfg.d_model)).astype(np.float32)}


def _j(batch):
    return {k: jnp.asarray(v) for k, v in batch.items()}


def _t(batch):
    return {k: torch.from_numpy(np.asarray(v)) for k, v in batch.items()}


# ---------------------------------------------------------------------------
# configs, layouts, parameter counts, trees
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("reduced", [True, False])
@pytest.mark.parametrize("arch", ARCHS)
def test_configs_and_group_layout_match_the_reference(arch, reduced):
    cfg, jcfg = get_config(arch, reduced=reduced), j_get_config(arch, reduced=reduced)
    assert dataclasses.asdict(cfg) == dataclasses.asdict(jcfg)
    lay = T.group_layout(cfg)
    assert [tuple(s) for s in lay] == [tuple(s) for s in JT.group_layout(jcfg)]
    assert T.n_groups(cfg) == JT.n_groups(jcfg)
    if arch == VLM:
        assert lay == [T.Sub("attn", "dense")] * 4 + [T.Sub("cross", "dense")]
    else:
        assert lay == [T.Sub("attn", "dense")]
        assert [tuple(s) for s in M.AUDIO_DEC_LAYOUT] == [tuple(s) for s in JM.AUDIO_DEC_LAYOUT]
        assert [tuple(s) for s in M.AUDIO_ENC_LAYOUT] == [tuple(s) for s in JM.AUDIO_ENC_LAYOUT]
        stacks = M.group_stacks(cfg)
        assert stacks["groups"] == (M.AUDIO_DEC_LAYOUT, cfg.n_layers)
        assert stacks["enc_groups"] == (M.AUDIO_ENC_LAYOUT, cfg.n_encoder_layers)


@pytest.mark.parametrize("reduced", [False, True])
@pytest.mark.parametrize("arch", ARCHS)
def test_n_params_and_n_active_params_match_the_reference(arch, reduced):
    cfg, jcfg = get_config(arch, reduced=reduced), j_get_config(arch, reduced=reduced)
    assert cfg.n_params() == JM.count_params_analytic(jcfg)
    assert cfg.n_active_params() == JM.count_params_analytic(jcfg, active_only=True)
    assert cfg.n_active_params() == cfg.n_params()  # no experts
    if not reduced:
        assert cfg.n_params() == FULL_PARAMS[arch]
    if not reduced and arch == VLM:
        cut = dataclasses.replace(cfg, n_layers=5)
        assert cut.n_params() == VLM_DEPTH5_PARAMS == JM.count_params_analytic(
            dataclasses.replace(jcfg, n_layers=5))


@pytest.mark.parametrize("qk_norm", [False, True])
def test_init_gqa_cross_has_the_reference_leaves_and_a_zero_gate(qk_norm):
    """Keys and shapes against the reference's `init_gqa(cross=True)`; the
    gate is an fp32 scalar 0.0 that takes no draw (the other leaves are
    drawn as for a self-attention sublayer)."""
    cfg, jcfg = (dataclasses.replace(c, qk_norm=qk_norm)
                 for c in (get_config(VLM, reduced=True), j_get_config(VLM, reduced=True)))
    port = A.init_gqa(torch.Generator().manual_seed(0), cfg, cross=True)
    ref, _ = unzip_params(JA.init_gqa(KEY, jcfg, cross=True))
    assert sorted(port) == sorted(ref)
    for k in port:
        assert tuple(port[k].shape) == tuple(ref[k].shape), k
    assert port["gate"].dtype == torch.float32 and float(port["gate"]) == 0.0
    plain = A.init_gqa(torch.Generator().manual_seed(0), cfg)
    assert "gate" not in plain
    for k in plain:
        assert torch.equal(plain[k], port[k]), k


@pytest.mark.parametrize("arch", ARCHS)
def test_init_params_and_caches_have_the_reference_tree(arch):
    """The parameter tree's paths and shapes (the cross sublayers' `gate`,
    whisper's `enc_groups` / `enc_norm`; full whisper ties its embeddings and
    has no `unembed`), and the caches: a KVCache per self-attention slot,
    of the request's type, and None for each cross slot."""
    for reduced in (True, False):
        cfg, jcfg = get_config(arch, reduced=reduced), j_get_config(arch, reduced=reduced)
        if not reduced and arch == VLM:
            cfg, jcfg = (dataclasses.replace(c, n_layers=5) for c in (cfg, jcfg))
        with torch.device("meta"):
            port = M.init_params(cfg, None, device="meta")
        jshapes = jax.eval_shape(lambda: JM.init_params(jcfg, KEY)[0])
        flat = jax.tree_util.tree_flatten_with_path(jshapes)[0]
        want = {"/".join(str(k.key) for k in p): tuple(a.shape) for p, a in flat}
        assert {p: tuple(t.shape) for p, t in tree_paths(port)} == want
        gates = [p for p in want if p.endswith("/gate")]
        assert gates and all(want[p] == (T.stacked_groups(port["groups"]),) for p in gates)
        if arch == WHISPER:
            assert {"enc_groups", "enc_norm"} <= set(port)
            assert ("unembed" in port) == (not cfg.tie_embeddings)
            if not reduced:
                assert "unembed" not in port
    cfg, jcfg = get_config(arch, reduced=True), j_get_config(arch, reduced=True)
    for tdt, jdt in ((torch.float32, jnp.float32), (torch.int8, jnp.int8)):
        caches = M.init_cache(cfg, 2, 9, tdt, device="cpu")
        jcaches, _ = JM.init_cache(jcfg, 2, 9, jdt)
        lay = M.group_stacks(cfg)["groups"][0]
        assert len(caches) == len(jcaches) == len(lay)
        for sub, c, jc in zip(lay, caches, jcaches):
            if sub.kind == "cross":
                assert c is None and jc is None
                continue
            assert c._fields == jc._fields
            for got, ref in zip(c, jc):
                assert (got is None) == (ref is None)
                if got is not None:
                    assert tuple(got.shape) == tuple(ref.shape)
                    assert str(got.dtype).split(".")[-1] == str(ref.dtype)


@pytest.mark.parametrize("kv_dtype", ["float32", "int8"])
def test_cache_kind_names_the_self_attention_cache(kv_dtype):
    assert cache_kind(get_config(VLM), kv_dtype) == f"{kv_dtype} KV (self-attention layers only)"
    assert cache_kind(get_config(WHISPER), kv_dtype) == \
        f"{kv_dtype} decoder KV (self-attention layers only)"


# ---------------------------------------------------------------------------
# positions and the whisper frontend
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("n,d", [(1, 8), (12, 128), (32, 384), (1500, 384)])
def test_sinusoid_positions_matches_jax(n, d):
    """The interleaved table against the reference's, and against fp64 sin
    and cos of the same fp32 angles. At 1,500 positions (whisper's encoder
    length) the angles reach 1,499 rad, where XLA's fp32 sin and cos differ
    from libm's correctly rounded ones by up to ~1e-4; the limit against
    the reference is 8 ulps of the largest angle, 8 * 2^-24 * n."""
    got = sinusoid_positions(n, d)
    assert got.shape == (n, d) and got.dtype == torch.float32
    want = np.asarray(j_sinusoid_positions(n, d))
    assert _err(got.numpy(), want) <= max(1e-5, 8 * 2.0 ** -24 * n)
    pos = torch.arange(n, dtype=torch.float32)[:, None]
    div = torch.exp(-torch.arange(0, d, 2, dtype=torch.float32) / d * np.log(10_000.0))
    ang = (pos * div).double()
    truth = torch.stack([torch.sin(ang), torch.cos(ang)], dim=-1).reshape(n, d)
    assert float((got.double() - truth).abs().max()) <= 1e-6
    assert torch.equal(got[:, 0], torch.sin(torch.arange(n, dtype=torch.float32)))


@pytest.mark.parametrize("offset,s", [(0, 12), (5, 1), (31, 1), (7, 9)])
def test_abs_pos_matches_jax(offset, s):
    """[sin ; cos] halves, at the absolute positions offset .. offset + s."""
    for d in (128, 384):
        pos = offset + np.arange(s)[None, :]
        got = M._abs_pos(torch.from_numpy(pos), d, torch.float32)
        _close(got.numpy(), JM._abs_pos(jnp.asarray(pos), d, jnp.float32))
        assert got.shape == (1, s, d)


@pytest.mark.parametrize("stride2", [True, False])
def test_whisper_frontend_matches_jax(stride2):
    """The two gelu (tanh) convolutions, the second with stride 2, on the
    reference's weights; the port's own draw has the reference's shapes and
    fan-in scale."""
    jp = JC.init_whisper_frontend(KEY, 16, 64)
    mel = np.random.default_rng(0).standard_normal((16, 40)).astype(np.float32)
    want = JC.whisper_frontend(jp, jnp.asarray(mel), stride2=stride2)
    params = {k: torch.from_numpy(np.asarray(v)) for k, v in jp.items()}
    got = whisper_frontend(params, torch.from_numpy(mel), stride2=stride2)
    assert got.shape == want.shape == ((20 if stride2 else 40), 64)
    _close(got.numpy(), want)
    drawn = init_whisper_frontend(torch.Generator().manual_seed(0), 16, 64, device="cpu")
    for k in drawn:
        assert drawn[k].shape == jp[k].shape
        got_std, want_std = float(drawn[k].std()), float(np.asarray(jp[k]).std())
        assert abs(got_std - want_std) <= 0.1 * want_std, (k, got_std, want_std)


# ---------------------------------------------------------------------------
# gqa_attention with and without kv_src
# ---------------------------------------------------------------------------


def _gqa_case(arch, qk_norm, seed=0):
    cfg, jcfg = (dataclasses.replace(c, qk_norm=qk_norm)
                 for c in (get_config(arch, reduced=True), j_get_config(arch, reduced=True)))
    jp, _ = unzip_params(JA.init_gqa(jax.random.PRNGKey(seed), jcfg, cross=True))
    npp = _with_gate({k: np.asarray(v) for k, v in jp.items()})
    return cfg, jcfg, npp


@pytest.mark.parametrize("s", [1, 12])
@pytest.mark.parametrize("qk_norm", [False, True])
@pytest.mark.parametrize("arch", ARCHS)
def test_gqa_attention_with_kv_src_matches_jax(arch, qk_norm, s):
    """Cross-attention: K and V from unit-normal `kv_src` (the VLM's 16
    image tokens, or 12 encoder frames), non-causal, no rope, no cache,
    scaled by tanh(0.7)."""
    cfg, jcfg, npp = _gqa_case(arch, qk_norm)
    rng = np.random.default_rng(1)
    b, sk = 2, (cfg.n_image_tokens if arch == VLM else 12)
    x = rng.standard_normal((b, s, cfg.d_model)).astype(np.float32)
    src = rng.standard_normal((b, sk, cfg.d_model)).astype(np.float32)
    pos = np.broadcast_to(np.arange(s)[None] + 3, (b, s))
    want, _ = JA.gqa_attention(_j(npp), jnp.asarray(x), cfg=jcfg, positions=jnp.asarray(pos),
                               causal=False, kv_src=jnp.asarray(src))
    with torch.no_grad():
        got, cache = A.gqa_attention(_t(npp), torch.from_numpy(x), cfg=cfg,
                                     positions=torch.from_numpy(pos.copy()), causal=False,
                                     kv_src=torch.from_numpy(src))
    assert cache is None and got.shape == (b, s, cfg.d_model)
    _close(got.numpy(), want)


@pytest.mark.parametrize("qk_norm", [False, True])
def test_cross_sublayer_without_kv_src_attends_over_x(qk_norm):
    """The reference's fallback for a cross sublayer given no image
    embeddings: non-causal self-attention over x, with rope, still gated."""
    cfg, jcfg, npp = _gqa_case(VLM, qk_norm, seed=1)
    rng = np.random.default_rng(2)
    x = rng.standard_normal((2, 9, cfg.d_model)).astype(np.float32)
    pos = np.broadcast_to(np.arange(9)[None], (2, 9))
    want, _ = JA.gqa_attention(_j(npp), jnp.asarray(x), cfg=jcfg, positions=jnp.asarray(pos),
                               causal=False)
    with torch.no_grad():
        got, _ = A.gqa_attention(_t(npp), torch.from_numpy(x), cfg=cfg,
                                 positions=torch.from_numpy(pos.copy()), causal=False)
    _close(got.numpy(), want)


def test_cross_call_reaches_the_flash_forward_without_a_cache(monkeypatch):
    """Under torch.no_grad() a cross call goes through `FlashAttentionFn`
    to `flash_fwd` (on the card `repro_flash_fwd_f32`): once, non-causal,
    q_offset 0, no kv_len, over the (B, Sk, KV, D) keys of `kv_src`."""
    cfg, _, npp = _gqa_case(VLM, False)
    calls = []
    real = FK.flash_fwd_plain

    def record(q, k, v, **kw):
        calls.append((tuple(q.shape), tuple(k.shape), dict(kw)))
        return real(q, k, v, **kw)

    monkeypatch.setattr(FK, "flash_fwd_plain", record)
    x = torch.randn(2, 3, cfg.d_model)
    src = torch.randn(2, cfg.n_image_tokens, cfg.d_model)
    with torch.no_grad():
        A.gqa_attention(_t(npp), x, cfg=cfg, positions=torch.zeros(2, 3), causal=False,
                        kv_src=src)
    kv, hd = cfg.n_kv_heads, cfg.resolved_head_dim
    assert calls == [((2, 3, kv, cfg.n_heads // kv, hd), (2, cfg.n_image_tokens, kv, hd),
                      dict(scale=hd ** -0.5, causal=False, q_offset=0, kv_len=None))]


# ---------------------------------------------------------------------------
# the reduced models against the reference
# ---------------------------------------------------------------------------


def _model(arch, n_layers=None, gate=GATE, qk_norm=False):
    cfg, jcfg = get_config(arch, reduced=True), j_get_config(arch, reduced=True)
    if n_layers:
        cfg, jcfg = (dataclasses.replace(c, n_layers=n_layers) for c in (cfg, jcfg))
    if qk_norm:
        cfg, jcfg = (dataclasses.replace(c, qk_norm=True) for c in (cfg, jcfg))
    jparams, _ = JM.init_params(jcfg, KEY)
    np_params = _with_gate(jax.tree_util.tree_map(np.asarray, jparams), gate)
    jparams = jax.tree_util.tree_map(jnp.asarray, np_params)
    return cfg, jcfg, jparams, np_params, lm_params_from_jax(np_params, cfg, device="cpu")


@pytest.fixture(scope="module", params=[VLM, WHISPER, VLM + "+qk_norm@10"])
def model(request):
    """The registered reduced archs, and a two-group VLM (10 layers, so the
    loop over stacked groups runs twice) with qk_norm on: the registered
    VLM draws wq and wk at fan-in n_heads and has no qk_norm, so its
    attention saturates, and at 10 layers a 1e-7 relative nudge of its
    embeddings and image embeddings moves the reference's own logits by
    2.3e-3 of their max, past any fp32 limit of 1e-4 (5.1e-7 with qk_norm
    on; `scripts/cross_host_conditioning.py`)."""
    name, _, depth = request.param.partition("@")
    arch, _, flag = name.partition("+")
    return _model(arch, int(depth) if depth else None, qk_norm=bool(flag))


def test_lm_params_from_jax_carries_the_cross_tree(model):
    """Every leaf of the JAX tree lands at the same path with the same
    values: the gates (at 0.7 here), whisper's encoder stack and norm."""
    cfg, _, jparams, _, params = model
    flat = jax.tree_util.tree_flatten_with_path(jparams)[0]
    got = dict(tree_paths(params))
    assert sorted(got) == sorted("/".join(str(k.key) for k in p) for p, _ in flat)
    for p, a in flat:
        assert torch.equal(got["/".join(str(k.key) for k in p)], torch.from_numpy(np.array(a)))
    gates = [t for p, t in got.items() if p.endswith("/gate")]
    assert gates and all(bool((t == GATE).all()) for t in gates)


@pytest.mark.parametrize("arch", ARCHS)
def test_lm_params_from_jax_refuses_a_stack_of_the_wrong_depth(arch):
    """Each stack's leading axis is held to its own group count:
    `n_encoder_layers` for whisper's `enc_groups`, the layout's groups for
    `groups`; the message names the stack."""
    cfg, _, _, np_params, _ = _model(arch)
    stacks = ["groups"] + (["enc_groups"] if cfg.is_encoder_decoder else [])
    for stack in stacks:
        bad = jax.tree_util.tree_map(lambda a: a, np_params)
        ln1 = bad[stack]["sub0"]["ln1"]
        bad[stack]["sub0"]["ln1"] = np.concatenate([ln1, ln1[:1]])  # one group too many
        with pytest.raises(ValueError, match=f"stacked layers of {cfg.name}'s {stack}"):
            lm_params_from_jax(bad, cfg, device="cpu")
    if cfg.is_encoder_decoder:  # a whole encoder stack one group short
        cut = dataclasses.replace(cfg, n_encoder_layers=cfg.n_encoder_layers + 1)
        with pytest.raises(ValueError, match="enc_groups"):
            lm_params_from_jax(np_params, cut, device="cpu")


def test_forward_matches_jax(model):
    cfg, jcfg, jparams, _, params = model
    batch = {"tokens": _tokens(cfg, 2, 12), **_side_input(cfg, 2, 12)}
    want, _, _ = JM.forward(jcfg, jparams, _j(batch))
    with torch.no_grad():
        got, _, aux = M.forward(cfg, params, _t(batch))
    assert got.shape == (2, 12, cfg.vocab_size) and float(aux) == 0.0
    _close_logits(got.numpy(), want)


def test_the_cross_path_moves_the_logits(model):
    """With the gate at 0.7 the cross path moves the logits by more than 100x
    the tolerance against the same weights with the gate at 0 (and so a
    broken cross path could not pass the parity tests); without
    `img_embeds` a VLM falls back to self-attention in its cross layers,
    which moves them too."""
    cfg, _, _, np_params, params = model
    batch = _t({"tokens": _tokens(cfg, 2, 12), **_side_input(cfg, 2, 12)})
    closed = lm_params_from_jax(_with_gate(np_params, 0.0), cfg, device="cpu")
    with torch.no_grad():
        open_, _, _ = M.forward(cfg, params, batch)
        shut, _, _ = M.forward(cfg, closed, batch)
        moved = _err(open_.numpy(), shut.numpy())
        assert moved > 100 * _tol(open_.numpy()), (moved, _tol(open_.numpy()))
        if cfg.family == "vlm":
            plain, _, _ = M.forward(cfg, params, {"tokens": batch["tokens"]})
            assert _err(plain.numpy(), open_.numpy()) > 100 * _tol(open_.numpy())


def test_whisper_encoder_matches_jax():
    """`M.encode` against the reference's encoder stack and norm."""
    cfg, jcfg, jparams, _, params = _model(WHISPER)
    fr = _side_input(cfg, 2, 12)["frames"]
    pe = j_sinusoid_positions(12, cfg.d_model)
    enc_pos = jnp.broadcast_to(jnp.arange(12)[None], (2, 12))
    want, _, _ = JT.stack_apply(jparams["enc_groups"], jnp.asarray(fr) + pe[None], cfg=jcfg,
                                positions=enc_pos, causal=False, layout=JM.AUDIO_ENC_LAYOUT)
    from repro.models.layers import rms_norm as j_rms_norm

    want = j_rms_norm(want, jparams["enc_norm"], jcfg.norm_eps)
    with torch.no_grad():
        got = M.encode(cfg, params, torch.from_numpy(fr))
    _close(got.numpy(), want)


class _PinnedInt8:
    """The int8 cache's rounding, pinned to the reference's: each of the JAX
    package's `_quantize_kv` results is queued (concrete under
    `jax.disable_jit()`), and the port's `_quantize_kv` quantizes its own
    K / V, is held within one step of the queued values and its scales
    within 1e-5 relative, then hands on the reference's values. An fp32
    difference of an ulp moves a value sitting on a rounding boundary by one
    step, and the attention downstream by more than the logits' limit."""

    def __init__(self, monkeypatch):
        self.queue, self.moved = [], 0
        j_orig, orig = JA._quantize_kv, A._quantize_kv

        def record(x):
            q, sc = j_orig(x)
            self.queue.append((np.asarray(q), np.asarray(sc)))
            return q, sc

        def replay(x):
            q, sc = orig(x)
            jq, jsc = self.queue.pop(0)
            step = (q.int() - torch.from_numpy(jq).int()).abs()
            assert int(step.max()) <= 1
            np.testing.assert_allclose(sc.numpy(), jsc, rtol=1e-5, atol=0)
            self.moved += int((step > 0).sum())
            return torch.from_numpy(jq.copy()), torch.from_numpy(jsc.copy())

        monkeypatch.setattr(JA, "_quantize_kv", record)
        monkeypatch.setattr(A, "_quantize_kv", replay)


@pytest.mark.parametrize("kv_dtype", ["float32", "int8"])
def test_prefill_and_decode_match_jax(model, kv_dtype, monkeypatch):
    """Prefill 5 tokens (with the image embeddings, or the frames through the
    encoder), then 7 teacher-forced decode steps (with the image embeddings,
    or a unit-normal encoder output): logits against the reference's over
    the request's cache, then the self-attention caches themselves. Over
    the int8 cache the port's rounding is pinned to the reference's
    (`_PinnedInt8`: the two-group VLM's prefill otherwise flips single
    values by one step, and its logits move by 4.3x the limit)."""
    cfg, jcfg, jparams, _, params = model
    pinned = _PinnedInt8(monkeypatch) if kv_dtype == "int8" else None
    def jax_mode():
        return jax.disable_jit() if pinned else contextlib.nullcontext()

    b, s, pre = 2, 12, 5
    toks = _tokens(cfg, b, s, seed=1)
    side = _side_input(cfg, b, s, seed=1)
    dec_side = side if cfg.family == "vlm" else _side_input(cfg, b, s, seed=2, key="enc_out")
    jdt, tdt = (jnp.int8, torch.int8) if kv_dtype == "int8" else (jnp.float32, torch.float32)
    jcache, _ = JM.init_cache(jcfg, b, s + 4, jdt)
    cache = M.init_cache(cfg, b, s + 4, tdt, device="cpu")
    with jax_mode():
        jl, jcache = JM.prefill(jcfg, jparams, jcache, _j({"tokens": toks[:, :pre], **side}))
    with torch.no_grad():
        lg, back = M.prefill(cfg, params, cache, _t({"tokens": toks[:, :pre], **side}))
        assert back is cache
        _close_logits(lg.numpy(), jl)
        for t in range(pre, s):
            step = {"tokens": toks[:, t:t + 1], **dec_side}
            with jax_mode():
                jl, jcache = JM.decode_step(jcfg, jparams, jcache, _j(step), t)
            lg, cache = M.decode_step(cfg, params, cache, _t(step), t)
            _close_logits(lg.numpy(), jl)
    if pinned:
        assert not pinned.queue
    for c, jc in zip(cache, jcache):
        assert (c is None) == (jc is None)
        if c is None:
            continue
        for got, ref in zip(c, jc):
            assert (got is None) == (ref is None)
            if got is None:  # an fp32 cache's scales
                continue
            if got.dtype == torch.int8:  # one rounding step apart
                assert int((got.int() - torch.from_numpy(np.asarray(ref)).int()).abs().max()) <= 1
            else:
                _close(got.float().numpy(), np.asarray(ref, np.float32), rtol=1e-4)


@pytest.mark.parametrize("arch", ARCHS)
def test_decode_matches_teacher_forcing(arch):
    """`tests/test_models.py:42` on the port, for both archs: prefill plus
    token-by-token decode reproduce the full forward's logits (the decode
    steps fed the same image embeddings, or the encoder's output over the
    frames), at the reference's limits; the gate at 0.7 and unit-normal
    inputs, so the cross path is in play."""
    cfg = get_config(arch, reduced=True)
    params = M.init_params(cfg, torch.Generator().manual_seed(0), device="cpu")
    for stack in params["groups"].values():
        if "gate" in stack["mix"]:
            stack["mix"]["gate"].fill_(GATE)
    b, s, pre = 2, 12, 5
    toks = torch.from_numpy(_tokens(cfg, b, s, seed=2))
    side = _t(_side_input(cfg, b, s, seed=3))
    with torch.no_grad():
        full, _, _ = M.forward(cfg, params, {"tokens": toks, **side})
        caches = M.init_cache(cfg, b, s + 4, device="cpu")
        lp, caches = M.prefill(cfg, params, caches, {"tokens": toks[:, :pre], **side})
        np.testing.assert_allclose(lp.numpy(), full[:, :pre].numpy(), rtol=2e-3, atol=2e-3)
        dec = side if arch == VLM else {"enc_out": M.encode(cfg, params, side["frames"])}
        for t in range(pre, s):
            lt, caches = M.decode_step(cfg, params, caches, {"tokens": toks[:, t:t + 1], **dec},
                                       t)
            np.testing.assert_allclose(lt[:, 0].numpy(), full[:, t].numpy(),
                                       rtol=3e-3, atol=3e-3)


def _loss_and_grads_against_jax(cfg, jcfg, jparams, params, batch, hold_grads=True):
    jloss, jgrads = jax.value_and_grad(lambda p: JM.lm_loss(jcfg, p, _j(batch)))(jparams)
    loss, grads = loss_and_grads(cfg, DEFAULT_RUN.replace(param_dtype="float32"), params,
                                 _t(batch))
    assert np.isfinite(float(loss))
    np.testing.assert_allclose(float(loss), float(jloss), rtol=1e-5)
    jflat = {"/".join(str(k.key) for k in p): np.asarray(g)
             for p, g in jax.tree_util.tree_flatten_with_path(jgrads)[0]}
    got = dict(tree_paths(grads))
    assert sorted(got) == sorted(jflat)
    for path, g in got.items():
        assert bool(torch.isfinite(g).all()), path
        if hold_grads:
            assert _err(g.numpy(), jflat[path]) <= _tol(jflat[path]), path
    for path, g in got.items():
        if path.endswith(("gate", "mix/wk", "mix/wv")):
            assert float(g.abs().sum()) > 0, path


@pytest.mark.parametrize("arch", ARCHS)
def test_smoke_forward_and_train_step(arch):
    """`tests/test_models.py:26` on the port, for both archs: one forward
    and one loss-and-gradients pass on the host at fp32, against the JAX
    package's `lm_loss` and `jax.grad` on the same weights (gate 0.7) and
    the same batch: the loss at 1e-5 relative, every gradient leaf finite,
    the cross sublayers' gates and K / V projections reached. Every
    gradient leaf is held at 1e-4 * max|ref| + 1e-6 with qk_norm on. The
    registered reduced archs draw wq and wk at fan-in n_heads without
    qk_norm, and over unit-normal inputs their attention saturates: a 1e-7
    relative nudge of the embeddings and the side inputs moves the
    reference's own gradients by up to 3.1e-4 (VLM) and 2.6e-4 (whisper)
    of a leaf's max, past the limit, against 5.0e-6 and less with qk_norm
    on (`scripts/cross_host_conditioning.py`); their gradients are held for
    finiteness and reach only."""
    rng = np.random.default_rng(3)
    for qk_norm in (False, True):
        cfg, jcfg, jparams, _, params = _model(arch, qk_norm=qk_norm)
        batch = {"tokens": _tokens(cfg, 2, 16, seed=3),
                 "labels": rng.integers(0, cfg.vocab_size, (2, 16)).astype(np.int32),
                 **_side_input(cfg, 2, 16, seed=4)}
        with torch.no_grad():
            logits, _, _ = M.forward(cfg, params, _t(batch))
        assert logits.shape == (2, 16, cfg.vocab_size) and bool(torch.isfinite(logits).all())
        _loss_and_grads_against_jax(cfg, jcfg, jparams, params, batch, hold_grads=qk_norm)


# ---------------------------------------------------------------------------
# serve on the host
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("arch", ARCHS)
def test_request_inputs_are_the_reference_zero_inputs(arch):
    """What `repro/launch/serve.py:36-52` adds to a request: zero image
    embeddings at prefill and every decode step (VLM); zero frames at
    prefill, then a zero encoder output of the same shape (whisper)."""
    cfg = get_config(arch, reduced=True)
    pre, dec = request_inputs(cfg, 3, 7, "cpu")
    if arch == VLM:
        assert list(pre) == list(dec) == ["img_embeds"]
        assert pre["img_embeds"].shape == (3, cfg.n_image_tokens, cfg.d_model)
    else:
        assert list(pre) == ["frames"] and list(dec) == ["enc_out"]
        assert pre["frames"].shape == dec["enc_out"].shape == (3, 7, cfg.d_model)
    assert all(not bool(t.any()) for t in (*pre.values(), *dec.values()))
    assert request_inputs(get_config("qwen3-0.6b", reduced=True), 3, 7, "cpu") == ({}, {})


@pytest.mark.parametrize("kv_dtype", ["float32", "int8"])
@pytest.mark.parametrize("arch", ARCHS)
def test_serve_is_greedy_on_the_host(arch, kv_dtype, caplog, monkeypatch):
    """`serve` on the reduced config: each greedy token is the argmax of the
    teacher-forced logits over the same caches and the same zero inputs,
    the summary names the cache it ran, and the flash calls per request are
    the ones the card counts as launches: every self-attention layer on the
    request's entry (fp32 or int8 K/V) at each step, every cross layer, and
    whisper's encoder at prefill, on the fp32 one."""
    calls = {"f32": 0, "q8": 0}
    real_f32, real_q8 = FK.flash_fwd_plain, FK.flash_fwd_q8_plain

    def f32(*a, **kw):
        calls["f32"] += 1
        return real_f32(*a, **kw)

    def q8(*a, **kw):
        calls["q8"] += 1
        return real_q8(*a, **kw)

    monkeypatch.setattr(FK, "flash_fwd_plain", f32)
    monkeypatch.setattr(FK, "flash_fwd_q8_plain", q8)
    gen = 3
    with caplog.at_level(logging.INFO, logger="repro_torch.serve"):
        res = serve(arch, device="cpu", batch=2, prompt_len=5, gen_len=gen, seed=0,
                    kv_cache_dtype=kv_dtype)
    cfg = get_config(arch, reduced=True)
    assert f"{cache_kind(cfg, kv_dtype)} cache" in caplog.text
    lay, groups = M.group_stacks(cfg)["groups"]
    n_self = groups * sum(s.kind == "attn" for s in lay)
    n_cross = groups * sum(s.kind == "cross" for s in lay)
    n_enc = cfg.n_encoder_layers if cfg.is_encoder_decoder else 0
    want = ({"f32": n_enc + n_cross * gen, "q8": n_self * gen} if kv_dtype == "int8"
            else {"f32": n_enc + (n_self + n_cross) * gen, "q8": 0})
    assert calls == want
    monkeypatch.setattr(FK, "flash_fwd_plain", real_f32)
    monkeypatch.setattr(FK, "flash_fwd_q8_plain", real_q8)
    params = M.init_params(cfg, torch.Generator().manual_seed(0), device="cpu")
    cache = M.init_cache(cfg, 2, 5 + gen, torch.int8 if kv_dtype == "int8" else torch.float32,
                         device="cpu")
    pre, dec = request_inputs(cfg, 2, 5, "cpu")
    with torch.no_grad():
        lg, cache = M.prefill(cfg, params, cache, {"tokens": res.prompt, **pre})
        greedy = [lg[:, -1].argmax(-1)]
        for i in range(gen - 1):
            lg, cache = M.decode_step(cfg, params, cache,
                                      {"tokens": res.tokens[:, i:i + 1], **dec}, 5 + i)
            greedy.append(lg[:, 0].argmax(-1))
    assert torch.equal(torch.stack(greedy, 1).to(torch.int32), res.tokens)
