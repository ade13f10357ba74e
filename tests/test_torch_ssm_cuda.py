"""The selective scan (`csrc/selective_scan.cu`) against its plain PyTorch
version on the card, and the reduced jamba and xlstm on the card against the
host. These tests need an NVIDIA GPU and nvcc; without a card they skip (the
check runs inside the fixture, never at import). This file imports no JAX
(the card's machine need not have it): run it on the card with
`PYTHONPATH=src python -m pytest --noconftest -m cuda tests/test_torch_ssm_cuda.py`.
The host's parity tests against the JAX package are `tests/test_torch_ssm.py`.

Limits: the kernels against the plain versions (the forward's out and
h_last; the backward's eight gradients), within 1e-4 * max|plain| + 1e-5 *
min(1, max|plain|), the port's fp32 rule (the same fp32 arithmetic with the
sums over N and over channels in another order and products contracted
into FMAs), and within 2^-7 * max|plain| for bf16 activations (the same
rounding points; a sum's other order flips a rounding); whole reduced
models, card against host (fp32
cuBLAS against the host's BLAS and the kernels against their plain
versions), logits within 1e-4 * max|host| + 1e-6 for xlstm and within the
port's LM card-vs-host limit, 1e-3 * max|host|, for jamba: its reduced
config amplifies fp32 rounding (a relative perturbation of 1e-7 in the
embeddings moves its logits by up to 4.7e-5 of their max on the host, and
the JAX package's logits sit at up to 0.67 of 1e-4 * max from the port's
over the fp32 cache; `scripts/jamba_host_conditioning.py`)."""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.configs.base import DEFAULT_RUN, get_config  # noqa: E402
from repro_torch.kernels.cuda import SCAN_ENTRY_LAUNCHES, launch_selective_scan  # noqa: E402
from repro_torch.kernels.selective_scan.kernel import (  # noqa: E402
    selective_scan,
    selective_scan_bwd,
    selective_scan_bwd_plain,
    selective_scan_plain,
)
from repro_torch.launch.steps import loss_and_grads  # noqa: E402
from repro_torch.models import model as M  # noqa: E402

pytestmark = pytest.mark.cuda


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    from repro_torch.device import strict_fp32

    strict_fp32()
    return torch.device("cuda")


def _operands(dev, b, s, di, n, seed, h0=True, views=False):
    """The scan's operands at the model's scales: dt a softplus (positive,
    ~0.7), A = -exp(log(1..N) + noise), B, C, x, z standard normal. `views`:
    x, z as the halves of one (B, S, 2di) tensor and B, C as slices of one
    (B, S, 8 + 2N) projection, read in place; h0 zero or random."""
    rng = np.random.default_rng(seed)

    def t(*shape, scale=1.0):
        return torch.from_numpy((scale * rng.standard_normal(shape)).astype(np.float32)).to(dev)

    if views:
        xz = t(b, s, 2 * di)
        x, z = xz[..., :di], xz[..., di:]
        proj = t(b, s, 8 + 2 * n)
        bm, cm = proj[..., 8:8 + n], proj[..., 8 + n:]
    else:
        x, z, bm, cm = t(b, s, di), t(b, s, di), t(b, s, n), t(b, s, n)
    dt = torch.nn.functional.softplus(t(b, s, di))
    a_log = torch.log(torch.arange(1, n + 1, dtype=torch.float32, device=dev)).repeat(di, 1)
    a = -torch.exp(a_log + t(di, n, scale=0.1))
    d = 1 + t(di, scale=0.2)
    h = t(b, di, n) if h0 else torch.zeros((b, di, n), device=dev)
    return x, dt, a, bm, cm, d, z, h


def _check(got, want, names=("out", "h_last")):
    for name, g, w in zip(names, got, want):
        assert g.dtype == w.dtype and g.shape == w.shape, name
        scale = float(w.float().abs().max())
        err = float((g.float() - w.float()).abs().max())
        limit = (2.0 ** -7 * scale if w.dtype == torch.bfloat16
                 else 1e-4 * scale + 1e-5 * min(1.0, scale))
        assert err <= limit, (name, err, scale)


def _act(args, dtype):
    """The operands with x, dt, d and z in the activation type `dtype`."""
    return [t.to(dtype) if i in (0, 1, 5, 6) else t for i, t in enumerate(args)]


# (B, S, di, N, h0, views): full-width jamba's decode, prefill and training
# shapes (di 8192, N 16), the reduced (di 256, N 8), S within one chunk (16
# steps in the forward, 8 in the backward) and past it, di not a multiple
# of a block's channels (the forward's 32 at N 16 and 64 at N 8, the
# backward's 32), at N 8 and 16, zero and carried states, and the model's
# strided views
SCAN_CASES = [
    (4, 1, 8192, 16, True, True),
    (4, 32, 8192, 16, False, True),
    (4, 128, 8192, 16, False, True),
    (2, 40, 328, 8, True, False),
    (4, 48, 8200, 16, True, True),
    (2, 7, 256, 8, True, False),
    (2, 32, 256, 8, False, True),
    (1, 129, 200, 16, True, False),
    (3, 129, 200, 8, True, True),
    (2, 33, 1000, 16, False, False),
    (1, 1, 1, 8, True, False),
]


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("case", SCAN_CASES, ids=lambda c: "-".join(map(str, c)))
def test_scan_kernel_matches_plain(dev, case, dtype):
    """One launch of the activation type's entry point per call, within its
    limit."""
    b, s, di, n, h0, views = case
    args = _operands(dev, b, s, di, n, seed=s + di + n, h0=h0, views=views)
    if dtype == "bfloat16":
        args = _act(args, torch.bfloat16)
    entry = f"repro_selective_scan_{'bf16' if dtype == 'bfloat16' else 'f32'}"
    before = dict(SCAN_ENTRY_LAUNCHES), selective_scan.launches
    with torch.no_grad():
        got = selective_scan(*args)
    torch.cuda.synchronize()
    assert {e: k - before[0][e] for e, k in SCAN_ENTRY_LAUNCHES.items() if k != before[0][e]} \
        == {entry: 1} and selective_scan.launches == before[1] + 1
    _check(got, selective_scan_plain(*args))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("case", SCAN_CASES, ids=lambda c: "-".join(map(str, c)))
def test_scan_backward_kernel_matches_plain(dev, case, dtype):
    """The backward entry point, one launch per call, against
    `selective_scan_bwd_plain` with a cotangent on out and on h_last."""
    b, s, di, n, h0, views = case
    args = _operands(dev, b, s, di, n, seed=s + di + n + 1, h0=h0, views=views)
    tdt = torch.bfloat16 if dtype == "bfloat16" else torch.float32
    args = _act(args, tdt)
    gen = torch.Generator(device=dev).manual_seed(s)
    dout = torch.randn((b, s, di), device=dev, generator=gen).to(tdt)
    dh_last = torch.randn((b, di, n), device=dev, generator=gen)
    entry = f"repro_selective_scan_bwd_{'bf16' if dtype == 'bfloat16' else 'f32'}"
    before = dict(SCAN_ENTRY_LAUNCHES)
    got = selective_scan_bwd(*args, dout, dh_last)
    torch.cuda.synchronize()
    assert {e: k - before[e] for e, k in SCAN_ENTRY_LAUNCHES.items() if k != before[e]} == {
        entry: 1}
    _check(got, selective_scan_bwd_plain(*args, dout, dh_last),
           ("dx", "ddt", "da", "db", "dc", "dd", "dz", "dh0"))


def test_scan_kernel_repeats_bitwise(dev):
    args = _operands(dev, 4, 32, 8192, 16, seed=3, views=True)
    with torch.no_grad():
        first, second = selective_scan(*args), selective_scan(*args)
    torch.cuda.synchronize()
    assert all(torch.equal(x, y) for x, y in zip(first, second))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_scan_backward_kernel_repeats_bitwise(dev, dtype):
    """Full-width training's shape (B 4, S 128, di 8192): dB and dC sum
    over the channels and dA and dD over the batch in a fixed order."""
    tdt = torch.bfloat16 if dtype == "bfloat16" else torch.float32
    args = _act(_operands(dev, 4, 128, 8192, 16, seed=4), tdt)
    dout = torch.randn((4, 128, 8192), device=dev,
                       generator=torch.Generator(device=dev).manual_seed(0)).to(tdt)
    dh_last = torch.zeros_like(args[7])
    first, second = (selective_scan_bwd(*args, dout, dh_last),
                     selective_scan_bwd(*args, dout, dh_last))
    torch.cuda.synchronize()
    assert all(torch.equal(x, y) for x, y in zip(first, second))


def test_scan_backward_kernel_repeats_bitwise_at_full_width_over_launches(dev):
    """Eight launches of the bf16 backward at full width with a carried
    state, a cotangent on h_last and di 8200 (ragged past the blocks' 32 and
    64 channels): every gradient bitwise equal to the first launch's."""
    args = _act(_operands(dev, 4, 128, 8200, 16, seed=5, views=True), torch.bfloat16)
    gen = torch.Generator(device=dev).manual_seed(1)
    dout = torch.randn((4, 128, 8200), device=dev, generator=gen).to(torch.bfloat16)
    dh_last = torch.randn((4, 8200, 16), device=dev, generator=gen)
    first = selective_scan_bwd(*args, dout, dh_last)
    for _ in range(7):
        again = selective_scan_bwd(*args, dout, dh_last)
        torch.cuda.synchronize()
        assert all(torch.equal(x, y) for x, y in zip(first, again))


@pytest.mark.parametrize("what", ["state dim", "grad", "host operand"])
def test_scan_launch_refuses_on_the_card(dev, what):
    """Another N, a tensor that needs grad (the launch records no autograd
    graph: SelectiveScanFn does), an operand left on the host."""
    args = list(_operands(dev, 2, 3, 256, 16 if what != "state dim" else 4, seed=0))
    err, match = ValueError, "ssm_state_dim"
    if what == "grad":
        args[0], err, match = args[0].requires_grad_(), RuntimeError, "SelectiveScanFn"
    elif what == "host operand":
        args[7], match = args[7].cpu(), "CUDA device"
    with pytest.raises(err, match=match):
        launch_selective_scan(*args)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_jamba_training_on_the_card_matches_the_host(dev, dtype):
    """A loss-and-gradients pass of the reduced jamba (qk_norm on: a
    well-conditioned attention) on the card, remat "full": the scan's
    forward entry runs twice per Mamba sublayer (forward, recompute) and its
    backward once, and no plain version stands in; the loss and every
    gradient leaf against the host's from the same weights: fp32 at the
    port's train limits (loss 1e-4 relative, leaves 1e-3 * max|host|); bf16
    loss 1e-2 relative, the gradients' global norm 3e-2 and every leaf
    1e-1 * max|host| (both sides round every op to bf16, cuBLAS and the
    kernels in another order than the host: the worst leaf, a Mamba weight
    whose gradient peaks at 1.4e-3, lay at 5.6e-2 of its max on an H100)."""
    import dataclasses

    from repro_torch.tree import tree_leaves, tree_map

    cfg = dataclasses.replace(get_config("jamba-v0.1-52b", reduced=True), qk_norm=True)
    run = DEFAULT_RUN.replace(param_dtype=dtype)
    tdt = torch.bfloat16 if dtype == "bfloat16" else torch.float32
    params = M.init_params(cfg, torch.Generator().manual_seed(0), device="cpu", dtype=tdt)
    gen = torch.Generator().manual_seed(1)
    batch = {k: torch.randint(0, cfg.vocab_size, (2, 16), generator=gen, dtype=torch.int32)
             for k in ("tokens", "labels")}
    sfx = "bf16" if dtype == "bfloat16" else "f32"
    before = dict(SCAN_ENTRY_LAUNCHES)
    loss_c, g_c = loss_and_grads(cfg, run, tree_map(lambda t: t.to(dev), params),
                                 {k: v.to(dev) for k, v in batch.items()})
    launched = {e: k - before[e] for e, k in SCAN_ENTRY_LAUNCHES.items() if k != before[e]}
    assert launched == {f"repro_selective_scan_{sfx}": 14, f"repro_selective_scan_bwd_{sfx}": 7}
    loss_h, g_h = loss_and_grads(cfg, run.replace(remat="none"), params, batch)
    rl, rg = (1e-2, 1e-1) if dtype == "bfloat16" else (1e-4, 1e-3)
    assert abs(float(loss_c) - float(loss_h)) <= rl * abs(float(loss_h))
    g_c = [c.float().cpu() for c in tree_leaves(g_c)]
    g_h = [h.float() for h in tree_leaves(g_h)]
    if dtype == "bfloat16":
        n_c, n_h = (float(torch.stack([g.norm() for g in gs]).norm()) for gs in (g_c, g_h))
        assert abs(n_c - n_h) <= 3e-2 * n_h, (n_c, n_h)
    for c, h in zip(g_c, g_h):
        assert float((c - h).abs().max()) <= rg * float(h.abs().max())


@pytest.mark.parametrize("arch,prompt", [("jamba-v0.1-52b", 8), ("xlstm-125m", 8),
                                         ("xlstm-125m", 128)])
def test_reduced_on_the_card_matches_the_host(dev, arch, prompt):
    """Reduced jamba and xlstm, prefill then 3 teacher-forced decode steps
    over the fp32 request's caches: the card's logits (the scan kernel,
    cuBLAS) against the host's (the plain versions). xlstm at prompt 128
    takes the chunkwise mLSTM. (The int8 request, whose KV rounding may
    differ by a step between card and host, is held in `chip_smoke.py`
    with the rounding pinned.)"""
    cfg = get_config(arch, reduced=True)
    params_cpu = M.init_params(cfg, torch.Generator().manual_seed(0), device="cpu")
    params = M.init_params(cfg, torch.Generator().manual_seed(0), device=dev)
    toks = torch.randint(0, cfg.vocab_size, (2, prompt + 3),
                         generator=torch.Generator().manual_seed(1), dtype=torch.int32)
    rel, floor = (1e-3, 0.0) if cfg.family == "hybrid" else (1e-4, 1e-6)
    outs = {}
    for where, p in (("cpu", params_cpu), ("cuda", params)):
        cache = M.init_cache(cfg, 2, prompt + 4, device=where)
        with torch.no_grad():
            lg, cache = M.prefill(cfg, p, cache, {"tokens": toks[:, :prompt].to(where)})
            seq = [lg.cpu()]
            for t in range(prompt, prompt + 3):
                lg, cache = M.decode_step(cfg, p, cache, {"tokens": toks[:, t:t + 1].to(where)},
                                          t)
                seq.append(lg.cpu())
        outs[where] = seq
    for c, h in zip(outs["cuda"], outs["cpu"]):
        err, scale = float((c - h).abs().max()), float(h.abs().max())
        assert err <= rel * scale + floor, (err, scale)
