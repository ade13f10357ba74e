"""The port's MLA family against the JAX package: deepseek-v2-236b's
configs and parameter counts, `init_mla` / `MLACache` / `mla_attention`,
the MLA kernel's plain version `flash_fwd_mla_plain` against the
reference's chunked `flash_attention` at MLA's shape (keys [c_kv ; k_rope],
values c_kv, one kv head under H query heads), the whole reduced
deepseek-v2 (`forward`, prefill plus teacher-forced decode over the fp32
latent cache and the int8 request's bf16 one), decode against teacher
forcing, `lm_params_from_jax` on the MLA tree, and the refusals of the
kernel's launch site. Training (the MLA backward, `MLAAttentionFn`) is
held in `tests/test_torch_family_train.py`. Inputs and
weights come from a numpy seed, or the JAX package's weights carried over
as numpy. The JAX side runs without a mesh. The card's tests are in
`tests/test_torch_mla_cuda.py`, which imports no JAX.

Tolerances:
- the plain version against the reference (out): fp32 at rtol = atol =
  1e-5; over a bf16 latent within 2^-8 * max|ref| (both round p and out to
  bf16 at the same points; fp32 sums in another order flip a rounding);
- `mla_attention`: without a cache outputs at rtol = atol = 1e-5; with the
  fp32 cache at rtol = 1e-5, atol = 1e-5 * max|ref| (the outputs reach ~9,
  and fp32 sums over terms of that size taken in another order leave
  1.4e-6 * max on an element of 0.08), the cache's c_kv / k_rope within
  1e-5 * max; bf16 latent cache outputs within 2^-7 * max|ref|, the cache's
  values within one bf16 ulp of the reference's;
- whole model: logits at 1e-4 * max + 1e-6 (forward, and prefill plus
  decode over the fp32 cache), 2^-7 * max over the bf16 latent cache;
- decode against teacher forcing: the reference's own limits
  (`tests/test_models.py:42`, rtol = atol = 2e-3), at capacity_factor =
  n_experts (capacity drops depend on the batch's composition).
"""
import dataclasses
import logging

import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.configs import get_config as j_get_config  # noqa: E402
from repro.models import attention as JA  # noqa: E402
from repro.models import model as JM  # noqa: E402
from repro_torch.configs.base import get_config  # noqa: E402
from repro_torch.convert import lm_params_from_jax  # noqa: E402
from repro_torch.kernels import cuda as kcuda  # noqa: E402
from repro_torch.kernels.flash_attention.kernel import (  # noqa: E402
    flash_fwd_mla,
    flash_fwd_mla_plain,
)
from repro_torch.launch.serve import cache_kind, serve  # noqa: E402
from repro_torch.models import attention as A  # noqa: E402
from repro_torch.models import model as M  # noqa: E402
from repro_torch.models import transformer as T  # noqa: E402
from repro_torch.tree import tree_paths  # noqa: E402

ARCH = "deepseek-v2-236b"
KEY = jax.random.PRNGKey(0)


def _max(x) -> float:
    return float(np.abs(np.asarray(x, np.float32)).max())


def _err(got, want) -> float:
    return float(np.abs(np.asarray(got, np.float32) - np.asarray(want, np.float32)).max())


def _bf16_ulp(x: np.ndarray) -> np.ndarray:
    """One bf16 ulp at each value of x (8 significant bits)."""
    _, e = np.frexp(np.abs(x).astype(np.float64))
    return np.ldexp(1.0, e - 8)


# ---------------------------------------------------------------------------
# configs, layouts, parameter counts, the parameter tree
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("reduced", [True, False])
def test_configs_match_the_reference(reduced):
    cfg = get_config(ARCH, reduced=reduced)
    assert dataclasses.asdict(cfg) == dataclasses.asdict(j_get_config(ARCH, reduced=reduced))
    assert T.group_layout(cfg) == [T.Sub("mla", "moe")] and T.n_groups(cfg) == cfg.n_layers


@pytest.mark.parametrize("reduced", [False, True])
def test_n_params_and_n_active_params_match_the_reference(reduced):
    cfg, jcfg = get_config(ARCH, reduced=reduced), j_get_config(ARCH, reduced=reduced)
    n, a = cfg.n_params(), cfg.n_active_params()
    assert n == JM.count_params_analytic(jcfg)
    assert a == JM.count_params_analytic(jcfg, active_only=True)
    if not reduced:
        assert (n, a) == (239_375_569_920, 21_376_619_520)


def test_init_mla_has_the_reference_leaves():
    """Keys, shapes and fan-ins (the std of each drawn leaf) of `init_mla`
    against the reference's."""
    cfg, jcfg = get_config(ARCH), j_get_config(ARCH)
    with torch.device("meta"):
        port = A.init_mla(None, cfg)
    ref = jax.eval_shape(lambda: JA.init_mla(KEY, jcfg))
    assert sorted(port) == sorted(ref)
    for k in port:
        assert tuple(port[k].shape) == tuple(ref[k].value.shape), k
    small = get_config(ARCH, reduced=True)
    drawn = A.init_mla(torch.Generator().manual_seed(0), small)
    jdrawn = JA.init_mla(KEY, j_get_config(ARCH, reduced=True))
    for k in drawn:
        want = float(np.asarray(jdrawn[k].value).std())
        got = float(drawn[k].std())
        assert abs(got - want) <= 0.1 * want + 1e-7, (k, got, want)


def test_init_params_and_caches_have_the_reference_tree():
    cfg, jcfg = get_config(ARCH, reduced=True), j_get_config(ARCH, reduced=True)
    jparams, _ = JM.init_params(jcfg, KEY)
    port = M.init_params(cfg, torch.Generator().manual_seed(0), device="cpu")
    flat = jax.tree_util.tree_flatten_with_path(jparams)[0]
    want = {"/".join(str(k.key) for k in p): tuple(a.shape) for p, a in flat}
    assert {p: tuple(t.shape) for p, t in tree_paths(port)} == want
    for tdt, jdt in ((torch.float32, jnp.float32), (torch.int8, jnp.int8)):
        caches = M.init_cache(cfg, 2, 9, tdt, device="cpu")
        jcaches, _ = JM.init_cache(jcfg, 2, 9, jdt)
        assert len(caches) == len(jcaches) == 1
        c, jc = caches[0], jcaches[0]
        assert isinstance(c, A.MLACache)
        for got, ref in zip(c, jc):
            assert tuple(got.shape) == tuple(ref.shape) == (cfg.n_layers, 2, 9, got.shape[-1])
            assert str(got.dtype).split(".")[-1] == str(ref.dtype)
        view = T._layer_cache(c, 1)
        assert isinstance(view, A.MLACache)
        assert view.c_kv.data_ptr() == c.c_kv[1].data_ptr()
    assert cache_kind(cfg, "int8") == "bfloat16 latent"
    assert cache_kind(get_config("qwen3-0.6b"), "int8") == "int8"


# ---------------------------------------------------------------------------
# the MLA kernel's plain version against the reference's flash_attention
# ---------------------------------------------------------------------------

# (r, dr, H): reduced deepseek-v2 and a wider case
MLA_SHAPES = [(32, 16, 4), (128, 64, 16)]
# (name, B, Sq, Sk, causal, q_offset, kv_len): causal prefill, decode over
# a cache tail, a ragged key count, rows that see no key (negative offset:
# the reference's mean of the values), an empty cache
MLA_CASES = [
    ("prefill", 2, 8, 8, True, 0, None),
    ("decode", 2, 1, 24, True, 13, 14),
    ("ragged", 1, 5, 45, False, 0, 40),
    ("masked_rows", 2, 6, 16, True, -3, None),
    ("kv_len_0", 1, 2, 8, True, 0, 0),
]


def _mla_operands(b, sq, sk, r, dr, h, seed):
    rng = np.random.default_rng(seed)
    q = rng.standard_normal((b, sq, h, r + dr)).astype(np.float32)
    c_kv = rng.standard_normal((b, sk, r)).astype(np.float32)
    k_rope = rng.standard_normal((b, sk, dr)).astype(np.float32)
    return q, c_kv, k_rope


def _ref_mla_flash(q, c_kv, k_rope, *, dtype, scale, causal, q_offset, kv_len, k_chunk):
    """The reference's `flash_attention` as `mla_attention` calls it."""
    b, sq, h, dk = q.shape
    ck = jnp.asarray(c_kv, dtype)
    k_eff = jnp.concatenate([ck, jnp.asarray(k_rope, dtype)], axis=-1)[:, :, None]
    out = JA.flash_attention(jnp.asarray(q).reshape(b, sq, 1, h, dk), k_eff, ck[:, :, None],
                             causal=causal, scale=scale, q_offset=q_offset,
                             k_chunk=k_chunk, kv_len=kv_len)
    return np.asarray(out.astype(jnp.float32)).reshape(b, sq, h, -1)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("shape", MLA_SHAPES, ids=lambda s: "r{}-dr{}-h{}".format(*s))
@pytest.mark.parametrize("case", MLA_CASES, ids=lambda c: c[0])
def test_flash_fwd_mla_plain_matches_reference(case, shape, dtype):
    """fp32: several key chunks in the reference (its online softmax)
    against the plain version's one pass; bf16 latents: one key chunk, as
    the reduced config's attn_chunk 64 gives at these lengths (p's bf16
    rounding is taken against the running max)."""
    _, b, sq, sk, causal, q_offset, kv_len = case
    r, dr, h = shape
    q, c_kv, k_rope = _mla_operands(b, sq, sk, r, dr, h, seed=sq + sk + r)
    kw = dict(scale=(r // 4 + dr) ** -0.5, causal=causal, q_offset=q_offset, kv_len=kv_len)
    bf16 = dtype == "bfloat16"
    want = _ref_mla_flash(q, c_kv, k_rope, dtype=jnp.bfloat16 if bf16 else jnp.float32,
                          k_chunk=sk if bf16 or sk % 8 else 8, **kw)
    tdt = torch.bfloat16 if bf16 else torch.float32
    out, m, l = flash_fwd_mla_plain(torch.from_numpy(q), torch.from_numpy(c_kv).to(tdt),
                                    torch.from_numpy(k_rope).to(tdt), **kw)
    assert out.dtype == tdt and tuple(out.shape) == (b, sq, h, r)
    assert m.shape == l.shape == (b, sq * h) and m.dtype == l.dtype == torch.float32
    got = out.float().numpy()
    if bf16:
        assert _err(got, want) <= 2.0 ** -8 * _max(want), (_err(got, want), _max(want))
    else:
        np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)
    # m and l: the row max of the masked scores and the sum of exp(s - m)
    keys = torch.cat([torch.from_numpy(c_kv), torch.from_numpy(k_rope)], -1).to(tdt).float()
    s = torch.einsum("bshd,bkd->bshk", torch.from_numpy(q) * kw["scale"], keys)
    qpos = q_offset + torch.arange(sq)[:, None]
    kpos = torch.arange(sk)[None, :]
    mask = (qpos >= kpos) if causal else torch.ones((sq, sk), dtype=torch.bool)
    if kv_len is not None:
        mask = mask & (kpos < kv_len)
    s = torch.where(mask[None, :, None, :], s, torch.tensor(-1e30))
    m_want = s.amax(-1)
    l_want = torch.exp(s - m_want[..., None]).sum(-1).clamp_min(1e-30)
    torch.testing.assert_close(m, m_want.reshape(b, sq * h), rtol=1e-5, atol=1e-5)
    torch.testing.assert_close(l, l_want.reshape(b, sq * h), rtol=1e-5, atol=1e-5)


def test_flash_fwd_mla_wrapper_runs_the_plain_version_on_the_host():
    q, c_kv, k_rope = (torch.from_numpy(a) for a in _mla_operands(2, 3, 9, 32, 16, 4, 1))
    kw = dict(scale=0.2, causal=True, q_offset=6, kv_len=9)
    before = flash_fwd_mla.launches
    got = flash_fwd_mla(q, c_kv, k_rope, **kw)
    want = flash_fwd_mla_plain(q, c_kv, k_rope, **kw)
    assert all(torch.equal(g, w) for g, w in zip(got, want))
    assert flash_fwd_mla.launches == before  # a host call launches nothing
    with pytest.raises(ValueError, match="cuda or cpu"):
        flash_fwd_mla(q.to("meta"), c_kv.to("meta"), k_rope.to("meta"), **kw)


# ---------------------------------------------------------------------------
# mla_attention against the reference's
# ---------------------------------------------------------------------------


def _np_mla(cfg, seed):
    """MLA weights from a numpy seed at the reference's fan-ins; the norm
    scales drawn near 1 so that they count."""
    rng = np.random.default_rng(seed)
    d, h = cfg.d_model, cfg.n_heads
    dn, dr, dv = cfg.nope_head_dim, cfg.rope_head_dim, cfg.v_head_dim
    r, qr = cfg.kv_lora_rank, cfg.q_lora_rank

    def w(shape, fan_in=None):
        fi = fan_in or shape[-2]
        return (rng.standard_normal(shape) * fi ** -0.5).astype(np.float32)

    return {"w_dq": w((d, qr)), "w_uq": w((qr, h, dn + dr)), "w_dkv": w((d, r)),
            "w_uk": w((r, h, dn)), "w_uv": w((r, h, dv)), "w_kr": w((d, dr)),
            "w_o": w((h, dv, d), h * dv),
            "q_norm": (1 + 0.1 * rng.standard_normal(qr)).astype(np.float32),
            "kv_norm": (1 + 0.1 * rng.standard_normal(r)).astype(np.float32)}


@pytest.fixture(scope="module")
def mla_case():
    cfg, jcfg = get_config(ARCH, reduced=True), j_get_config(ARCH, reduced=True)
    w = _np_mla(cfg, 3)
    x = np.random.default_rng(4).standard_normal((2, 12, cfg.d_model)).astype(np.float32)
    return cfg, jcfg, w, x


def _positions(b, s, start=0):
    return np.broadcast_to(np.arange(start, start + s, dtype=np.int32)[None], (b, s)).copy()


def test_mla_attention_without_a_cache_matches_jax(mla_case):
    cfg, jcfg, w, x = mla_case
    pos = _positions(*x.shape[:2])
    want, _ = JA.mla_attention({k: jnp.asarray(v) for k, v in w.items()}, jnp.asarray(x),
                               cfg=jcfg, positions=jnp.asarray(pos))
    p = {k: torch.from_numpy(v) for k, v in w.items()}
    with torch.no_grad():
        got, cache = A.mla_attention(p, torch.from_numpy(x), cfg=cfg,
                                     positions=torch.from_numpy(pos))
    assert cache is None
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("latent", ["float32", "bfloat16"])
def test_mla_attention_prefill_then_decode_matches_jax(mla_case, latent):
    """Prefill 7 positions into a 12-long cache, then decode 3 one at a
    time: outputs and the written cache against the reference's."""
    cfg, jcfg, w, x = mla_case
    b, pre = x.shape[0], 7
    jdt, tdt = (jnp.bfloat16, torch.bfloat16) if latent == "bfloat16" else (
        jnp.float32, torch.float32)
    jp = {k: jnp.asarray(v) for k, v in w.items()}
    p = {k: torch.from_numpy(v) for k, v in w.items()}
    jcache = JA.init_mla_cache(jcfg, b, 12, jdt)
    cache = A.init_mla_cache(cfg, b, 12, tdt, device="cpu")
    for start, stop in ((0, pre), (pre, pre + 1), (pre + 1, pre + 2), (pre + 2, pre + 3)):
        pos = _positions(b, stop - start, start)
        want, jcache = JA.mla_attention(jp, jnp.asarray(x[:, start:stop]), cfg=jcfg,
                                        positions=jnp.asarray(pos), cache=jcache,
                                        write_pos=start)
        with torch.no_grad():
            got, back = A.mla_attention(p, torch.from_numpy(x[:, start:stop]), cfg=cfg,
                                        positions=torch.from_numpy(pos), cache=cache,
                                        write_pos=start)
        assert back is cache  # written in place
        want = np.asarray(want)
        if latent == "float32":
            np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-5 * _max(want))
        else:
            assert _err(got, want) <= 2.0 ** -7 * _max(want), (start, _err(got, want))
    for got, ref in zip(cache, jcache):
        assert got.dtype == tdt
        g, r_ = got.float().numpy(), np.asarray(ref.astype(jnp.float32))
        if latent == "float32":
            assert _err(g, r_) <= 1e-5 * _max(r_)
        else:
            assert np.all(np.abs(g - r_) <= _bf16_ulp(r_)), float(np.abs(g - r_).max())


# ---------------------------------------------------------------------------
# the kernel's launch site: what it refuses before it reaches a card
# ---------------------------------------------------------------------------


def _launch_args(r=512, dr=64, h=128, dtype=torch.float32):
    q = torch.zeros((1, 2, h, r + dr))
    return q, torch.zeros((1, 5, r), dtype=dtype), torch.zeros((1, 5, dr), dtype=dtype)


@pytest.mark.parametrize("what", ["shape", "q dtype", "latent dtypes", "last dim",
                                  "dims", "heads", "grad", "device"])
def test_launch_flash_mla_refuses(what):
    q, c, k = _launch_args()
    kw = dict(scale=0.1, causal=True)
    err, match = ValueError, None
    if what == "shape":
        k, match = torch.zeros((1, 4, 64)), "do not match"
    elif what == "q dtype":
        q, err = q.to(torch.float16), TypeError
    elif what == "latent dtypes":
        c, err = c.to(torch.bfloat16), TypeError
    elif what == "last dim":
        c, match = torch.zeros((1, 512, 5)).transpose(1, 2), "contiguous"
    elif what == "dims":
        (q, c, k), match = _launch_args(r=128, dr=64), "kv_lora_rank"
    elif what == "heads":
        (q, c, k), match = _launch_args(h=129), "heads"
    elif what == "grad":
        c, err, match = c.requires_grad_(), RuntimeError, "MLAAttentionFn"
    else:
        match = "CUDA device"
    with pytest.raises(err, match=match):
        kcuda.launch_flash_mla(q, c, k, **kw)
    if what in ("shape", "q dtype", "latent dtypes"):  # the plain version refuses too
        with pytest.raises(err, match=match):
            flash_fwd_mla_plain(q, c, k, **kw)


def test_launch_flash_mla_takes_the_built_dims_and_a_bf16_latent():
    """Every (r, dr) pair the kernel is built at passes the checks, over an
    fp32 and a bf16 latent, up to 128 heads: only the device check is left."""
    assert kcuda.MLA_DIMS == ((32, 16), (512, 64))
    assert set(kcuda.MLA_ENTRY_LAUNCHES) == {
        "repro_flash_fwd_mla_f32", "repro_flash_fwd_mla_bf16kv",
        "repro_flash_bwd_mla_dq_f32", "repro_flash_bwd_mla_dq_bf16",
        "repro_flash_bwd_mla_dkv_f32", "repro_flash_bwd_mla_dkv_bf16"}
    assert "flash_mla_bwd.cu" in kcuda.SOURCES
    for r, dr in kcuda.MLA_DIMS:
        for dt in (torch.float32, torch.bfloat16):
            with pytest.raises(ValueError, match="CUDA device"):
                kcuda.launch_flash_mla(*_launch_args(r, dr, 128, dt), scale=0.1, causal=False)


# ---------------------------------------------------------------------------
# the whole reduced deepseek-v2 against the JAX package
# ---------------------------------------------------------------------------


def _close_logits(got, want, rel=1e-4, floor=1e-6):
    err, scale = _err(got, want), _max(want)
    assert err <= rel * scale + floor, (err, scale)


@pytest.fixture(scope="module")
def model():
    cfg, jcfg = get_config(ARCH, reduced=True), j_get_config(ARCH, reduced=True)
    jparams, _ = JM.init_params(jcfg, KEY)
    np_params = jax.tree_util.tree_map(np.asarray, jparams)
    return cfg, jcfg, jparams, np_params, lm_params_from_jax(np_params, cfg, device="cpu")


def _tokens(cfg, b, s, seed=0):
    return np.random.default_rng(seed).integers(0, cfg.vocab_size, (b, s)).astype(np.int32)


def test_lm_params_from_jax_carries_the_mla_tree(model):
    """Every leaf of the JAX tree, the MLA leaves among them, lands at the
    same path with the same values; a misshapen MLA leaf raises."""
    cfg, _, jparams, np_params, params = model
    flat = jax.tree_util.tree_flatten_with_path(jparams)[0]
    got = dict(tree_paths(params))
    assert sorted(got) == sorted("/".join(str(k.key) for k in p) for p, _ in flat)
    for p, a in flat:
        assert torch.equal(got["/".join(str(k.key) for k in p)], torch.from_numpy(np.array(a)))
    assert sorted(params["groups"]["sub0"]["mix"]) == sorted(
        ["w_dq", "w_uq", "w_dkv", "w_uk", "w_uv", "w_kr", "w_o", "q_norm", "kv_norm"])
    bad = jax.tree_util.tree_map(lambda a: a, np_params)
    bad["groups"]["sub0"]["mix"]["w_uk"] = bad["groups"]["sub0"]["mix"]["w_uk"][..., :-1]
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
    np.testing.assert_allclose(float(aux), float(jaux), rtol=1e-5)


@pytest.mark.parametrize("kv_dtype", ["float32", "int8"])
def test_prefill_and_decode_match_jax(model, kv_dtype):
    """Prefill 5 tokens, then 7 teacher-forced decode steps: logits and the
    latent caches against the reference's. The int8 request is a bf16
    latent cache in both packages."""
    cfg, jcfg, jparams, _, params = model
    b, s, pre = 2, 12, 5
    toks = _tokens(cfg, b, s, seed=1)
    jdt, tdt = (jnp.int8, torch.int8) if kv_dtype == "int8" else (jnp.float32, torch.float32)
    rel, floor = (2.0 ** -7, 0.0) if kv_dtype == "int8" else (1e-4, 1e-6)
    jcache, _ = JM.init_cache(jcfg, b, s + 4, jdt)
    cache = M.init_cache(cfg, b, s + 4, tdt, device="cpu")
    jl, jcache = JM.prefill(jcfg, jparams, jcache, {"tokens": jnp.asarray(toks[:, :pre])})
    with torch.no_grad():
        lg, cache = M.prefill(cfg, params, cache, {"tokens": torch.from_numpy(toks[:, :pre])})
        _close_logits(lg.numpy(), jl, rel, floor)
        for t in range(pre, s):
            jl, jcache = JM.decode_step(jcfg, jparams, jcache,
                                        {"tokens": jnp.asarray(toks[:, t:t + 1])}, t)
            lg, cache = M.decode_step(cfg, params, cache,
                                      {"tokens": torch.from_numpy(toks[:, t:t + 1])}, t)
            _close_logits(lg.numpy(), jl, rel, floor)
    for got, ref in zip(cache[0], jcache[0]):
        assert got.dtype == (torch.bfloat16 if kv_dtype == "int8" else torch.float32)
        g, r_ = got.float().numpy(), np.asarray(ref.astype(jnp.float32))
        if kv_dtype == "int8":
            assert np.all(np.abs(g - r_) <= _bf16_ulp(r_)), float(np.abs(g - r_).max())
        else:
            assert _err(g, r_) <= 1e-5 * _max(r_)


def test_decode_matches_teacher_forcing():
    """`tests/test_models.py:42` for deepseek-v2 on the port: prefill plus
    token-by-token decode reproduce the full forward's logits, at no-drop
    capacity."""
    cfg = get_config(ARCH, reduced=True)
    cfg = dataclasses.replace(cfg, capacity_factor=float(cfg.n_experts))
    params = M.init_params(cfg, torch.Generator().manual_seed(0), device="cpu")
    b, s, pre = 2, 12, 5
    toks = torch.from_numpy(_tokens(cfg, b, s, seed=2))
    with torch.no_grad():
        full, _, _ = M.forward(cfg, params, {"tokens": toks})
        caches = M.init_cache(cfg, b, s + 4, device="cpu")
        lp, caches = M.prefill(cfg, params, caches, {"tokens": toks[:, :pre]})
        np.testing.assert_allclose(lp.numpy(), full[:, :pre].numpy(), rtol=2e-3, atol=2e-3)
        for t in range(pre, s):
            lt, caches = M.decode_step(cfg, params, caches, {"tokens": toks[:, t:t + 1]}, t)
            np.testing.assert_allclose(lt[:, 0].numpy(), full[:, t].numpy(),
                                       rtol=2e-3, atol=2e-3)


@pytest.mark.parametrize("kv_dtype", ["float32", "int8"])
def test_serve_is_greedy_on_the_host(kv_dtype, caplog):
    """`serve` on the reduced config: each greedy token is the argmax of the
    teacher-forced logits over the same cache type, and the summary names
    the latent cache it ran (bf16 for an int8 request)."""
    with caplog.at_level(logging.INFO, logger="repro_torch.serve"):
        res = serve(ARCH, device="cpu", batch=2, prompt_len=5, gen_len=3, seed=0,
                    kv_cache_dtype=kv_dtype)
    want = "bfloat16 latent cache" if kv_dtype == "int8" else "float32 latent cache"
    assert want in caplog.text
    cfg = get_config(ARCH, reduced=True)
    params = M.init_params(cfg, torch.Generator().manual_seed(0), device="cpu")
    cache = M.init_cache(cfg, 2, 8, torch.int8 if kv_dtype == "int8" else torch.float32,
                         device="cpu")
    with torch.no_grad():
        lg, cache = M.prefill(cfg, params, cache, {"tokens": res.prompt})
        greedy = [lg[:, -1].argmax(-1)]
        for i in range(2):
            lg, cache = M.decode_step(cfg, params, cache, {"tokens": res.tokens[:, i:i + 1]},
                                      5 + i)
            greedy.append(lg[:, 0].argmax(-1))
    assert torch.equal(torch.stack(greedy, 1).to(torch.int32), res.tokens)
