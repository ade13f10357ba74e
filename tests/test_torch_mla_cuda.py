"""The MLA kernel (`csrc/flash_mla.cu`) against its plain PyTorch version on
the card, and the reduced deepseek-v2 on the card against the host. These
tests need an NVIDIA GPU and nvcc; without a card they skip (the check runs
inside the fixture, never at import). This file imports no JAX (the card's
machine need not have it): run it on the card with
`PYTHONPATH=src python -m pytest --noconftest -m cuda tests/test_torch_mla_cuda.py`.
The host's parity tests against the JAX package are `tests/test_torch_mla.py`.

Limits against the plain version: fp32 latent (`repro_flash_fwd_mla_f32`,
split-TF32): out within 1e-4 * max|plain| + 1e-5 * min(1, max|plain|), m
and l within 1e-5 * max|plain|; bf16 latent (`repro_flash_fwd_mla_bf16kv`):
out (bf16) within 2^-7 * max|plain| (one bf16 ulp at the largest value:
both round p and out to bf16 at the same points of fp32 sums taken in
another order), m and l within 1e-5 * max|plain|. The backward kernels
(`csrc/flash_mla_bwd.cu`) against `flash_bwd_mla_plain`: fp32 within the
same fp32 rule plus 8 * 2^-24 * S * max|plain| at row maxes S, bf16 within
2^-7 * max|plain|; the MLA sublayer's gradients, card against host, within
1e-3 * max|host|."""
import contextlib

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.configs.base import get_config  # noqa: E402
from repro_torch.kernels.cuda import MLA_ENTRY_LAUNCHES  # noqa: E402
from repro_torch.kernels.flash_attention.kernel import (  # noqa: E402
    flash_bwd_mla,
    flash_bwd_mla_plain,
    flash_fwd_mla,
    flash_fwd_mla_plain,
    mla_delta,
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


def _operands(dev, b, sq, sk, r, dr, h, dtype, seed, stacked=False):
    """q (B, Sq, H, r + dr) fp32 over c_kv, k_rope in `dtype`; `stacked`:
    the latents are layer 1 of a (3, B, Sk, .) stacked cache, read in place."""
    rng = np.random.default_rng(seed)
    q = torch.from_numpy(rng.standard_normal((b, sq, h, r + dr)).astype(np.float32)).to(dev)
    lead = (3,) if stacked else ()
    c = torch.from_numpy(rng.standard_normal(lead + (b, sk, r)).astype(np.float32))
    k = torch.from_numpy(rng.standard_normal(lead + (b, sk, dr)).astype(np.float32))
    c, k = c.to(dev, dtype), k.to(dev, dtype)
    return (q, c[1], k[1]) if stacked else (q, c, k)


def _check(got, want, bf16):
    out, m, l = got
    w_out, w_m, w_l = want
    assert out.dtype == w_out.dtype and out.shape == w_out.shape
    scale = float(w_out.float().abs().max())
    err = float((out.float() - w_out.float()).abs().max())
    limit = 2.0 ** -7 * scale if bf16 else 1e-4 * scale + 1e-5 * min(1.0, scale)
    assert err <= limit, ("out", err, scale)
    for name, g, w in (("m", m, w_m), ("l", l, w_l)):
        assert g.dtype == torch.float32 and g.shape == w.shape
        e = float((g - w).abs().max())
        assert e <= 1e-5 * float(w.abs().max()), (name, e)


# (B, Sq, Sk, H, causal, q_offset, kv_len, stacked): the served prefill's
# shape cut (causal, 8 positions x 128 heads over a 16-key cache), decode
# over a cache tail at kv_len 1, 33 and 64 (one and two key tiles), a ragged
# key count past two tiles, rows that see no key (negative offset: the mean
# of the values), an empty cache, a head count whose rows do not fill a
# 16-row tile, and the latents read in place from a stacked cache; then the
# key splits (`mla_fwd_split`: few row tiles over many keys): a decode over
# 4,096 keys read in place from a stacked cache, a decode whose kv_len ends
# inside a key chunk (16 chunks of 3 key tiles, the last one empty), and
# rows that see no key under a split (the mean over all 600 keys); the
# served prefill's own shape (4 row tiles a block, keys staged once); and a
# causal prefill whose rows see up to 96 keys, past the key ring (48 keys at
# fp32, 64 over a bf16 latent: online softmax, after a first pass for the
# row's max over a bf16 latent)
MLA_CASES = [
    (2, 8, 16, 128, True, 0, 8, False),
    (3, 1, 64, 128, True, 0, 1, True),
    (3, 1, 64, 128, True, 32, 33, True),
    (2, 1, 64, 128, True, 63, 64, False),
    (1, 5, 70, 16, False, 0, 67, False),
    (2, 6, 16, 4, True, -3, None, False),
    (1, 2, 8, 128, True, 0, 0, False),
    (2, 7, 40, 3, True, 33, 40, True),
    (4, 1, 4096, 128, True, 4095, 4096, True),
    (2, 1, 1024, 128, True, 700, 701, False),
    (1, 2, 600, 64, True, -1, None, False),
    (4, 32, 64, 128, True, 0, 32, True),
    (2, 96, 96, 16, True, 0, None, False),
]


@pytest.mark.parametrize("dims", [(512, 64), (32, 16)], ids=["full", "reduced"])
@pytest.mark.parametrize("latent", ["float32", "bfloat16"])
@pytest.mark.parametrize("case", MLA_CASES, ids=lambda c: "-".join(map(str, c)))
def test_mla_kernel_matches_plain(dev, case, latent, dims):
    """Each entry point launches once (and no other) and holds its limits."""
    b, sq, sk, h, causal, q_offset, kv_len, stacked = case
    r, dr = dims
    bf16 = latent == "bfloat16"
    q, c, k = _operands(dev, b, sq, sk, r, dr, h, torch.bfloat16 if bf16 else torch.float32,
                        seed=sq + sk + h + r, stacked=stacked)
    kw = dict(scale=(128 + dr) ** -0.5, causal=causal, q_offset=q_offset, kv_len=kv_len)
    before = dict(MLA_ENTRY_LAUNCHES)
    got = flash_fwd_mla(q, c, k, **kw)
    torch.cuda.synchronize()
    entry = "repro_flash_fwd_mla_bf16kv" if bf16 else "repro_flash_fwd_mla_f32"
    assert {e: n - before[e] for e, n in MLA_ENTRY_LAUNCHES.items() if n != before[e]} == {
        entry: 1}
    _check(got, flash_fwd_mla_plain(q, c, k, **kw), bf16)


@pytest.mark.parametrize("dims", [(512, 64), (32, 16)], ids=["full", "reduced"])
@pytest.mark.parametrize("latent", ["float32", "bfloat16"])
def test_mla_kernel_off_alignment(dev, latent, dims):
    """q, c_kv and k_rope as views whose rows start one element past each
    other (row strides r + dr + 1, r + 1, dr + 1): the kernel stages them by
    plain loads and holds the same limits."""
    r, dr = dims
    dt = torch.bfloat16 if latent == "bfloat16" else torch.float32
    rng = np.random.default_rng(11)
    b, sq, sk, h = 2, 3, 40, 16

    def view(shape, dtype):
        x = torch.from_numpy(rng.standard_normal(shape[:-1] + (shape[-1] + 1,)).astype(
            np.float32)).to(dev, dtype)
        return x[..., 1:]

    q, c, k = view((b, sq, h, r + dr), torch.float32), view((b, sk, r), dt), view((b, sk, dr), dt)
    assert q.stride(-2) % 4 and c.stride(-2) % 4 and k.stride(-2) % 4
    kw = dict(scale=(128 + dr) ** -0.5, causal=True, q_offset=30, kv_len=33)
    _check(flash_fwd_mla(q, c, k, **kw), flash_fwd_mla_plain(q, c, k, **kw),
           latent == "bfloat16")


@pytest.mark.parametrize("latent", ["float32", "bfloat16"])
def test_mla_kernel_repeats_bitwise(dev, latent):
    """A second launch on the same inputs repeats the first bitwise, at the
    served decode shape (column slices), a causal prefill, and a decode over
    4,096 keys (key chunks and their combine), and a causal prefill past the
    key ring."""
    dt = torch.bfloat16 if latent == "bfloat16" else torch.float32
    for b, sq, sk, q_offset, kv_len in ((4, 1, 64, 40, 41), (2, 16, 32, 0, 16),
                                        (4, 1, 4096, 4095, 4096), (2, 96, 96, 0, 96)):
        q, c, k = _operands(dev, b, sq, sk, 512, 64, 128, dt, seed=7)
        kw = dict(scale=192 ** -0.5, causal=True, q_offset=q_offset, kv_len=kv_len)
        first = flash_fwd_mla(q, c, k, **kw)
        second = flash_fwd_mla(q, c, k, **kw)
        torch.cuda.synchronize()
        assert all(torch.equal(x, y) for x, y in zip(first, second))


# the MLA backward kernels' cases, (B, Sq, Sk, H, causal, q_offset, kv_len):
# full-width training's sublayer cut in rows (causal, 128 heads), a causal
# window at an offset past a tile edge with kv_len, rows that see no key, a
# non-causal kv_len mask at a ragged Sk, a head count whose rows do not fill
# a tile, and kv_len 0; then the tiles of the tensor-core passes (a dq block
# owns 32 rows and walks 16-key tiles, a dkv block owns 32 keys and walks
# 16-row tiles): 24 heads, whose rows fill neither, over Sk 33, one key past
# a dkv block; Sk 33 at a causal offset with kv_len, so that the last key
# takes a block of its own; and a long sum, 32,768 rows into key 0's dc_kv
MLA_BWD_CASES = [
    (2, 16, 16, 128, True, 0, None),
    (1, 5, 40, 128, True, 30, 35),
    (2, 6, 16, 4, True, -3, None),
    (1, 5, 70, 16, False, 0, 67),
    (2, 7, 40, 3, True, 33, 40),
    (1, 2, 8, 4, True, 0, 0),
    (2, 7, 33, 24, True, 0, None),
    (1, 6, 33, 128, True, 27, 33),
    (1, 256, 256, 128, True, 0, None),
]


def _bwd_operands(dev, b, sq, sk, r, dr, h, dtype, seed):
    """q, c_kv, k_rope and do in `dtype` (float32, or bfloat16 for all four:
    training at bf16)."""
    rng = np.random.default_rng(seed)
    return [torch.from_numpy(rng.standard_normal(shape).astype(np.float32)).to(dev, dtype)
            for shape in ((b, sq, h, r + dr), (b, sk, r), (b, sk, dr), (b, sq, h, r))]


def _check_grads(got, want, bf16, widen=0.0):
    for name, g, w in zip(("dq", "dc_kv", "dk_rope"), got, want):
        assert g.dtype == w.dtype and g.shape == w.shape, name
        scale = float(w.float().abs().max())
        err = float((g.float() - w.float()).abs().max())
        limit = (2.0 ** -7 * scale if bf16 else
                 1e-4 * scale + 1e-5 * min(1.0, scale) + widen * scale)
        assert err <= limit, (name, err, scale)


@pytest.mark.parametrize("dims", [(512, 64), (32, 16)], ids=["full", "reduced"])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("case", MLA_BWD_CASES, ids=lambda c: "-".join(map(str, c)))
def test_mla_backward_kernels_match_plain(dev, case, dtype, dims):
    """The dq and dkv passes (one launch of each entry point, no other)
    against `flash_bwd_mla_plain` on the kernel forward's m, l and delta:
    fp32 within the port's rule widened by 8 * 2^-24 * S at row maxes S
    (the scores are recomputed in another order than m took them), bf16
    within 2^-7 * max|plain|."""
    b, sq, sk, h, causal, q_offset, kv_len = case
    r, dr = dims
    bf16 = dtype == "bfloat16"
    q, c, k, do = _bwd_operands(dev, b, sq, sk, r, dr, h,
                                torch.bfloat16 if bf16 else torch.float32, seed=sq + sk + h)
    kw = dict(scale=(128 + dr) ** -0.5, causal=causal, q_offset=q_offset, kv_len=kv_len)
    with torch.no_grad():
        out, m, l = flash_fwd_mla(q, c, k, **kw)
        ops = (q, c, k, do, m, l, mla_delta(do, out))
        before = dict(MLA_ENTRY_LAUNCHES)
        got = flash_bwd_mla(*ops, **kw)
        torch.cuda.synchronize()
    sfx = "bf16" if bf16 else "f32"
    assert {e: n - before[e] for e, n in MLA_ENTRY_LAUNCHES.items() if n != before[e]} == {
        f"repro_flash_bwd_mla_dq_{sfx}": 1, f"repro_flash_bwd_mla_dkv_{sfx}": 1}
    seen = m[m > -1e29]
    widen = 8 * 2.0 ** -24 * (float(seen.abs().max()) if seen.numel() else 0.0)
    _check_grads(got, flash_bwd_mla_plain(*ops, **kw), bf16, widen)


@pytest.mark.parametrize("dims", [(512, 64), (32, 16)], ids=["full", "reduced"])
@pytest.mark.parametrize("case", MLA_BWD_CASES[:2] + MLA_BWD_CASES[6:8],
                         ids=lambda c: "-".join(map(str, c)))
def test_mla_backward_bf16_entries_take_an_fp32_q(dev, case, dims):
    """An fp32 q over a bf16 latent and do: the bf16 entry points with a q
    that is not exact in TF32 (so its lo part takes part in every product
    with q), against `flash_bwd_mla_plain` within 2^-7 * max|plain|; dq comes
    in the latent's type (`launch_flash_mla_bwd`), so the plain dq is
    rounded to bf16 before the comparison."""
    b, sq, sk, h, causal, q_offset, kv_len = case
    r, dr = dims
    _, c, k, do = _bwd_operands(dev, b, sq, sk, r, dr, h, torch.bfloat16, seed=sq + sk + h)
    rng = np.random.default_rng(sq + sk + h + 1)
    q = torch.from_numpy(rng.standard_normal((b, sq, h, r + dr)).astype(np.float32)).to(dev)
    assert bool(((q.view(torch.int32) & 0x1fff) != 0).any())
    kw = dict(scale=(128 + dr) ** -0.5, causal=causal, q_offset=q_offset, kv_len=kv_len)
    with torch.no_grad():
        out, m, l = flash_fwd_mla(q, c, k, **kw)
        ops = (q, c, k, do, m, l, mla_delta(do, out))
        before = dict(MLA_ENTRY_LAUNCHES)
        got = flash_bwd_mla(*ops, **kw)
        torch.cuda.synchronize()
    assert {e: n - before[e] for e, n in MLA_ENTRY_LAUNCHES.items() if n != before[e]} == {
        "repro_flash_bwd_mla_dq_bf16": 1, "repro_flash_bwd_mla_dkv_bf16": 1}
    dq, dc, dkr = flash_bwd_mla_plain(*ops, **kw)
    _check_grads(got, (dq.to(torch.bfloat16), dc, dkr), True)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_mla_backward_kernels_repeat_bitwise(dev, dtype):
    """A second launch of both passes on the same inputs repeats the first
    bitwise (the dkv pass sums its row chunks in a second kernel, in order)."""
    dt = torch.bfloat16 if dtype == "bfloat16" else torch.float32
    q, c, k, do = _bwd_operands(dev, 2, 32, 32, 512, 64, 128, dt, seed=5)
    kw = dict(scale=192 ** -0.5, causal=True, q_offset=0, kv_len=None)
    with torch.no_grad():
        out, m, l = flash_fwd_mla(q, c, k, **kw)
        ops = (q, c, k, do, m, l, mla_delta(do, out))
        first, second = flash_bwd_mla(*ops, **kw), flash_bwd_mla(*ops, **kw)
    torch.cuda.synchronize()
    assert all(torch.equal(x, y) for x, y in zip(first, second))


def test_mla_attention_grads_on_the_card_match_the_host(dev):
    """The reduced deepseek-v2's MLA sublayer under autograd: forward through
    MLAAttentionFn (the MLA kernel), backward through both backward kernels,
    each launched once; its gradients (every weight and x) against the
    host's plain path within the port's fp32 train leaf limit, 1e-3 *
    max|host| (cuBLAS against the host's BLAS around the kernels)."""
    cfg = get_config("deepseek-v2-236b", reduced=True)
    p_cpu = A.init_mla(torch.Generator().manual_seed(0), cfg)
    x_cpu = torch.randn((2, 12, cfg.d_model), generator=torch.Generator().manual_seed(1))
    g_cpu = torch.randn((2, 12, cfg.d_model), generator=torch.Generator().manual_seed(2))
    pos = torch.arange(12)[None].expand(2, 12)
    grads = {}
    for where in ("cpu", "cuda"):
        p = {k: v.to(where).requires_grad_() for k, v in p_cpu.items()}
        x = x_cpu.to(where).requires_grad_()
        before = dict(MLA_ENTRY_LAUNCHES)
        out, _ = A.mla_attention(p, x, cfg=cfg, positions=pos.to(where))
        gs = torch.autograd.grad(out, list(p.values()) + [x], g_cpu.to(where))
        grads[where] = [g.cpu() for g in gs]
        launched = {e: n - before[e] for e, n in MLA_ENTRY_LAUNCHES.items() if n != before[e]}
        assert launched == ({} if where == "cpu" else {
            "repro_flash_fwd_mla_f32": 1, "repro_flash_bwd_mla_dq_f32": 1,
            "repro_flash_bwd_mla_dkv_f32": 1})
    for name, c, h in zip(list(p_cpu) + ["x"], grads["cuda"], grads["cpu"]):
        err, scale = float((c - h).abs().max()), float(h.abs().max())
        assert err <= 1e-3 * scale, (name, err, scale)


@contextlib.contextmanager
def routing_from(picks: dict, record: bool):
    """Within the block, `moe.route` keeps each router's top-k experts in
    `picks`, keyed by the router's bytes: recording, it stores the experts
    it picks; else it takes them from `picks` in place of its own top-k
    (the gates are then the picked experts' probabilities, in the stored
    order). Under remat "full" a layer's route runs again in the backward
    and finds its own key. Yields `picks`."""
    from repro_torch.models import moe

    real = moe.route

    def route(router, xt, cfg):
        key = router.detach().float().cpu().numpy().tobytes()
        if record:
            r = real(router, xt, cfg)
            picks[key] = r.eidx.cpu()
            return r
        eidx = picks[key].to(xt.device)
        topk = torch.topk
        torch.topk = lambda probs, k, dim=-1: (probs.gather(-1, eidx), eidx)
        try:
            return real(router, xt, cfg)
        finally:
            torch.topk = topk

    moe.route = route
    try:
        yield picks
    finally:
        moe.route = real


@contextlib.contextmanager
def plain_mla(fwd: bool = True, bwd: bool = True):
    """Within the block, the MLA autograd function calls the forward's
    (`fwd`) and both backward passes' (`bwd`) plain versions in place of
    the kernels, on the card's tensors too."""
    from repro_torch.kernels.flash_attention import kernel as K
    from repro_torch.kernels.flash_attention import ops

    saved = ops.flash_fwd_mla, ops.flash_bwd_mla
    if fwd:
        ops.flash_fwd_mla = K.flash_fwd_mla_plain
    if bwd:
        ops.flash_bwd_mla = K.flash_bwd_mla_plain
    try:
        yield
    finally:
        ops.flash_fwd_mla, ops.flash_bwd_mla = saved


# the router's and the routed experts' leaves
ROUTED = ("moe/router", "moe/w1", "moe/w2", "moe/w3")
# card against host past the key ring, bf16: loss and global norm relative
# (the train-step limits), every leaf but the routed ones, and the routed
# ones (the train-step limit), each relative to max|host leaf|
RING_LIMITS = (1e-2, 3e-2, 3.5e-2, 5e-2)


def bf16_vs_host(cfg, run, params, batch, dev) -> dict:
    """One bf16 loss-and-gradients pass on the host's plain path (remat
    "none") and two on the card (`run`) on the same weights and batch, with
    the MLA kernels and with their plain versions, the card's top-k routing
    taken from the host's -> {"launched": MLA launches of the kernels' pass,
    "kernels" and "plain": {"loss": rel, "grad_norm": rel, "leaves": {name:
    max|card - host| / max|host|}}, "kernels_vs_plain": {name: max|kernels -
    plain| / max|plain|}}."""
    from repro_torch.launch.steps import loss_and_grads, to_device
    from repro_torch.optim import global_norm
    from repro_torch.tree import tree_map, tree_paths

    def rel(a, b):
        err = float((a.float().cpu() - b.float().cpu()).abs().max())
        return err / max(float(b.float().abs().max()), 1e-30)

    host = tree_map(lambda t: t.detach().cpu(), params)
    with routing_from({}, record=True) as picks:
        lh, g_h = loss_and_grads(cfg, run.replace(remat="none"), host, batch)
    nh = float(global_norm(g_h))
    out, grads = {}, {}
    for label in ("kernels", "plain"):
        before = dict(MLA_ENTRY_LAUNCHES)
        with routing_from(picks, record=False), (
                plain_mla() if label == "plain" else contextlib.nullcontext()):
            lc, g_c = loss_and_grads(cfg, run, params, to_device(batch, dev))
        if label == "kernels":
            out["launched"] = {e: n - before[e] for e, n in MLA_ENTRY_LAUNCHES.items()
                               if n != before[e]}
        grads[label] = tree_paths(g_c)
        out[label] = {"loss": abs(float(lc) - float(lh)) / abs(float(lh)),
                      "grad_norm": abs(float(global_norm(g_c)) - nh) / nh,
                      "leaves": {name: rel(c, h) for (name, c), (_, h)
                                 in zip(grads[label], tree_paths(g_h))}}
    out["kernels_vs_plain"] = {name: rel(k, pl) for (name, k), (_, pl)
                               in zip(grads["kernels"], grads["plain"])}
    return out


def ring_misses(res) -> dict:
    """{what: (value, limit)} of `bf16_vs_host`'s result past RING_LIMITS:
    the kernels' loss and global norm; every leaf but the routed ones
    against the host's; a routed leaf against the host's, or, where the
    plain versions' pass also misses the host's past the limit, against the
    plain versions'."""
    l_loss, l_norm, l_leaf, l_routed = RING_LIMITS
    k, pl = res["kernels"], res["plain"]
    miss = {}
    for what, v, lim in (("loss", k["loss"], l_loss), ("grad_norm", k["grad_norm"], l_norm)):
        if not v <= lim:
            miss[what] = (v, lim)
    for name, v in k["leaves"].items():
        if not name.endswith(ROUTED):
            if not v <= l_leaf:
                miss[name] = (v, l_leaf)
        elif pl["leaves"][name] <= l_routed:
            if not v <= l_routed:
                miss[name] = (v, l_routed)
        elif not res["kernels_vs_plain"][name] <= l_routed:
            miss[name + " (vs plain)"] = (res["kernels_vs_plain"][name], l_routed)
    return miss


@pytest.mark.parametrize("seq_len", [128, 96])
def test_reduced_deepseek_bf16_training_past_the_key_ring(dev, seq_len):
    """Reduced deepseek-v2 trained 3 bf16 steps at DEFAULT_RUN (remat
    "full") on the card, at sequences whose causal rows see more keys than
    the MLA forward's key ring holds over a bf16 latent (64 keys): S 128
    (two of the reference's 64-key `attn_chunk` chunks) and S 96 (one chunk,
    the whole row). Before every step, on the card's weights of that step
    and the same batch, the card's loss and gradients are held against the
    host's plain path (remat "none") with the card's top-2 routing taken
    from the host's (`routing_from`: where a token's two best experts
    nearly tie, any other rounding flips the pick and moves whole rows of
    the routed gradients), at `RING_LIMITS` (`ring_misses`): the loss
    within 1e-2 and the global norm within 3e-2 relative; every leaf but
    the router's and the routed experts' within 3.5e-2 * max|host leaf|,
    between the kernel that rounded p against a 16-key running max past the
    ring (3.9e-2 at S 96, 4.7e-2 at S 128) and the plain versions on the
    card (2.8e-2); the routed leaves within 5e-2, of the host's where the
    card's plain versions meet that, else of the plain versions' (at S 96,
    step 0, a routed expert's leaf lies 7.1e-2 from the host's with the
    plain versions too). `scripts/mla_bf16_ring_check.py` prints these
    readings."""
    from repro_torch.configs.base import DEFAULT_RUN
    from repro_torch.data import make_pipeline
    from repro_torch.launch.steps import init_train_state, make_train_step, to_device

    cfg = get_config("deepseek-v2-236b", reduced=True)
    run = DEFAULT_RUN.replace(warmup_steps=2)
    state = init_train_state(cfg, run, torch.Generator().manual_seed(0), device=dev)
    pipe = make_pipeline(cfg, seq_len, 4, seed=0)
    step = make_train_step(cfg, run, 10, device=dev)
    for s in range(3):
        batch = to_device(pipe.batch_at(s), "cpu")
        res = bf16_vs_host(cfg, run, state.params, batch, dev)
        assert res["launched"].get("repro_flash_fwd_mla_bf16kv", 0) > 0, res["launched"]
        assert "repro_flash_fwd_mla_f32" not in res["launched"]
        miss = ring_misses(res)
        assert not miss, (s, miss)
        state, _ = step(state, batch)


@pytest.mark.parametrize("kv_dtype", [torch.float32, torch.int8], ids=["fp32", "bf16_latent"])
def test_reduced_deepseek_on_the_card_matches_the_host(dev, kv_dtype):
    """Reduced deepseek-v2, prefill then 3 teacher-forced decode steps: the
    card's logits (the MLA kernel) against the host's (its plain version) at
    1e-4 * max|host| over the fp32 latent, 2^-7 * max over the bf16 one."""
    cfg = get_config("deepseek-v2-236b", reduced=True)
    params_cpu = M.init_params(cfg, torch.Generator().manual_seed(0), device="cpu")
    params = M.init_params(cfg, torch.Generator().manual_seed(0), device=dev)
    toks = torch.randint(0, cfg.vocab_size, (2, 12), generator=torch.Generator().manual_seed(1),
                         dtype=torch.int32)
    rel = 2.0 ** -7 if kv_dtype == torch.int8 else 1e-4
    outs = {}
    for where, p in (("cpu", params_cpu), ("cuda", params)):
        cache = M.init_cache(cfg, 2, 16, kv_dtype, device=where)
        with torch.no_grad():
            lg, cache = M.prefill(cfg, p, cache, {"tokens": toks[:, :8].to(where)})
            seq = [lg.cpu()]
            for t in range(8, 11):
                lg, cache = M.decode_step(cfg, p, cache, {"tokens": toks[:, t:t + 1].to(where)}, t)
                seq.append(lg.cpu())
        outs[where] = seq
    for c, h in zip(outs["cuda"], outs["cpu"]):
        err, scale = float((c - h).abs().max()), float(h.abs().max())
        assert err <= rel * scale, (err, scale)
