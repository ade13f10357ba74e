"""The flash forwards (`csrc/flash_attention.cu`, `repro_flash_fwd_f32` and
`repro_flash_fwd_q8`) at the cross-attention families' shapes against their
plain PyTorch versions on the card, a cross call's route to the fp32 entry,
and the reduced llama-3.2-vision-90b and whisper-tiny on the card against
the host. These tests need an NVIDIA GPU and nvcc; without a card they skip
(the check runs inside the fixture, never at import). This file imports no
JAX (the card's machine need not have it): run it on the card with
`PYTHONPATH=src python -m pytest --noconftest -m cuda tests/test_torch_cross_cuda.py`.
The host's parity tests against the JAX package are `tests/test_torch_cross.py`.

Shapes: non-causal, no q_offset, no kv_len, Sq != Sk: the full-width VLM's
cross layer at prefill (Sq 32) and decode (Sq 1) over its 1,024 image
tokens (KV 8, G 8, D 128); whisper-tiny's (KV 6, G 1, D 64) cross layer
over 32 encoder frames and its encoder's self-attention (Sq = Sk, and at
whisper's 1,500 frames); a ragged Sq and Sk. Operands unit-normal, and
for the fp32 entry also scaled by 8 (scores of std 64 saturate the softmax,
as the random-weight models' do).

Limits: kernel against plain version, out, m and l within 1e-4 * max|plain|
+ 1e-5 * min(1, max|plain|) (the port's fp32 rule), out and l widened by
8 * 2^-24 * S * max|plain| at row maxes S (chip_smoke's `score_widening`:
an fp32 score carries a few ulps of |s| on either side); the int8 K/V
kernel's out likewise. Whole reduced models, card against host, logits
within 1e-4 * max|host| + 1e-6 for whisper and within the port's LM
card-vs-host limit, 1e-3 * max|host|, for the VLM, whose reduced config
amplifies fp32 rounding (a 1e-7 relative nudge of its inputs moves its
logits by 5.4e-5 of their max in the JAX package;
`scripts/cross_host_conditioning.py`)."""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.configs.base import get_config  # noqa: E402
from repro_torch.kernels.cuda import FLASH_ENTRY_LAUNCHES  # noqa: E402
from repro_torch.kernels.flash_attention.kernel import (  # noqa: E402
    flash_fwd,
    flash_fwd_plain,
    flash_fwd_q8,
    flash_fwd_q8_plain,
)
from repro_torch.models import attention as A  # noqa: E402
from repro_torch.models import model as M  # noqa: E402

pytestmark = pytest.mark.cuda


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    from repro_torch.device import strict_fp32

    strict_fp32()
    return torch.device("cuda")


# (b, kv, g, sq, sk, d)
CROSS_CASES = [
    (4, 8, 8, 32, 1024, 128),  # llama-3.2-vision-90b's cross layer, prefill
    (4, 8, 8, 1, 1024, 128),  # and a decode step
    (4, 6, 1, 32, 32, 64),  # whisper-tiny's cross layer and encoder, prompt 32
    (4, 6, 1, 1, 32, 64),  # its cross layer at a decode step
    (1, 6, 1, 1500, 1500, 64),  # its encoder over whisper's 1,500 frames
    (2, 2, 8, 37, 1000, 128),  # ragged Sq and Sk
    (3, 3, 2, 5, 77, 64),
]


def _operands(dev, b, kv, g, sq, sk, d, seed, scale=1.0):
    rng = np.random.default_rng(seed)

    def t(*shape):
        return torch.from_numpy((scale * rng.standard_normal(shape)).astype(np.float32)).to(dev)

    return t(b, sq, kv, g, d), t(b, sk, kv, d), t(b, sk, kv, d)


def _limit(want, m=None):
    """1e-4 * max|plain| + 1e-5 * min(1, max|plain|), widened by 8 ulps of
    the largest row max."""
    scale = float(want.abs().max())
    widen = 0.0 if m is None else 8 * 2.0 ** -24 * float(m[m > -1e29].abs().max())
    return (1e-4 + widen) * scale + 1e-5 * min(1.0, scale)


KW = dict(causal=False, q_offset=0, kv_len=None)


@pytest.mark.parametrize("scale", [1.0, 8.0])
@pytest.mark.parametrize("case", CROSS_CASES, ids=lambda c: "-".join(map(str, c)))
def test_flash_kernel_at_cross_shapes_matches_plain(dev, case, scale):
    b, kv, g, sq, sk, d = case
    q, k, v = _operands(dev, *case, seed=sq + sk + d, scale=scale)
    kw = dict(scale=d ** -0.5, **KW)
    before = flash_fwd.launches
    out, m, l = flash_fwd(q, k, v, **kw)
    torch.cuda.synchronize()
    assert flash_fwd.launches == before + 1
    po, pm, pl = flash_fwd_plain(q, k, v, **kw)
    assert out.shape == q.shape and m.shape == pm.shape == (b * kv, g, sq)
    for name, got, want in (("out", out, po), ("m", m, pm), ("l", l, pl)):
        err = float((got - want).abs().max())
        assert err <= _limit(want, None if name == "m" else pm), (name, err)


@pytest.mark.parametrize("case", CROSS_CASES, ids=lambda c: "-".join(map(str, c)))
def test_flash_q8_kernel_at_cross_shapes_matches_plain(dev, case):
    b, kv, g, sq, sk, d = case
    q, k, v = _operands(dev, *case, seed=sq + sk + d + 1)
    kq, ks = A._quantize_kv(k)
    vq, vs = A._quantize_kv(v)
    kw = dict(scale=d ** -0.5, **KW)
    before = flash_fwd_q8.launches
    out = flash_fwd_q8(q, kq, vq, ks, vs, **kw)
    torch.cuda.synchronize()
    assert flash_fwd_q8.launches == before + 1
    want = flash_fwd_q8_plain(q, kq, vq, ks, vs, **kw)
    pm = flash_fwd_plain(q, kq.float() * ks[..., None], vq.float() * vs[..., None], **kw)[1]
    assert float((out - want).abs().max()) <= _limit(want, pm)


@pytest.mark.parametrize("arch", ["llama-3.2-vision-90b", "whisper-tiny"])
def test_cross_call_launches_the_fp32_entry(dev, arch):
    """A cross sublayer's attention under torch.no_grad() (no cache) goes
    through FlashAttentionFn to `repro_flash_fwd_f32`: one launch, and the
    same output as on the host."""
    cfg = get_config(arch, reduced=True)
    p = A.init_gqa(torch.Generator().manual_seed(0), cfg, cross=True)
    p["gate"].fill_(0.7)
    gen = torch.Generator().manual_seed(1)
    x = torch.randn((2, 3, cfg.d_model), generator=gen)
    src = torch.randn((2, 16, cfg.d_model), generator=gen)
    pos = torch.zeros((2, 3))
    with torch.no_grad():
        want, _ = A.gqa_attention(p, x, cfg=cfg, positions=pos, causal=False, kv_src=src)
        before = dict(FLASH_ENTRY_LAUNCHES)
        got, _ = A.gqa_attention({k: t.to(dev) for k, t in p.items()}, x.to(dev), cfg=cfg,
                                 positions=pos.to(dev), causal=False, kv_src=src.to(dev))
        torch.cuda.synchronize()
    moved = {k: FLASH_ENTRY_LAUNCHES[k] - before[k] for k in before}
    assert moved == {k: int(k == "repro_flash_fwd_f32") for k in before}
    scale = float(want.abs().max())
    assert float((got.cpu() - want).abs().max()) <= 1e-4 * scale + 1e-6


def _to(tree, dev):
    if isinstance(tree, dict):
        return {k: _to(v, dev) for k, v in tree.items()}
    return tree.to(dev)


@pytest.mark.parametrize("arch", ["llama-3.2-vision-90b", "whisper-tiny"])
def test_reduced_on_the_card_matches_the_host(dev, arch):
    """Reduced VLM and whisper with the gates at 0.7, unit-normal image
    embeddings or frames and encoder output: prefill then 3 teacher-forced
    decode steps over the fp32 request's cache, the card's logits (the
    flash kernels, cuBLAS) against the host's (the plain versions). (The
    int8 request, whose K/V rounding may differ by a step between card and
    host, is held in `chip_smoke.py` with the rounding pinned.)"""
    cfg = get_config(arch, reduced=True)
    params_cpu = M.init_params(cfg, torch.Generator().manual_seed(0), device="cpu")
    for sub in params_cpu["groups"].values():
        if "gate" in sub["mix"]:
            sub["mix"]["gate"].fill_(0.7)
    params = _to(params_cpu, dev)
    gen = torch.Generator().manual_seed(1)
    toks = torch.randint(0, cfg.vocab_size, (2, 11), generator=gen, dtype=torch.int32)
    n_side = cfg.n_image_tokens if cfg.family == "vlm" else 8
    side = torch.randn((2, n_side, cfg.d_model), generator=gen)
    pre = {"img_embeds": side} if cfg.family == "vlm" else {"frames": side}
    dec = {"img_embeds": side} if cfg.family == "vlm" else {
        "enc_out": torch.randn((2, 8, cfg.d_model), generator=gen)}
    rel, floor = (1e-3, 0.0) if cfg.family == "vlm" else (1e-4, 1e-6)
    outs = {}
    for where, p in (("cpu", params_cpu), ("cuda", params)):
        cache = M.init_cache(cfg, 2, 12, device=where)
        with torch.no_grad():
            lg, cache = M.prefill(cfg, p, cache, {"tokens": toks[:, :8].to(where),
                                                  **_to(pre, where)})
            seq = [lg.cpu()]
            for t in range(8, 11):
                lg, cache = M.decode_step(cfg, p, cache, {"tokens": toks[:, t:t + 1].to(where),
                                                          **_to(dec, where)}, t)
                seq.append(lg.cpu())
        outs[where] = seq
    for c, h in zip(outs["cuda"], outs["cpu"]):
        err, scale = float((c - h).abs().max()), float(h.abs().max())
        assert bool(torch.isfinite(c).all()) and err <= rel * scale + floor, (err, scale)
