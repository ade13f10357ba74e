"""The selective scan (`csrc/selective_scan.cu`) against its plain PyTorch
version on the card, and the reduced jamba and xlstm on the card against the
host. These tests need an NVIDIA GPU and nvcc; without a card they skip (the
check runs inside the fixture, never at import). This file imports no JAX
(the card's machine need not have it): run it on the card with
`PYTHONPATH=src python -m pytest --noconftest -m cuda tests/test_torch_ssm_cuda.py`.
The host's parity tests against the JAX package are `tests/test_torch_ssm.py`.

Limits: the kernel against the plain version, out and h_last within
1e-4 * max|plain| + 1e-5 * min(1, max|plain|), the port's fp32 rule (the
same fp32 arithmetic with the sum over N in another order and products
contracted into FMAs); whole reduced models, card against host (fp32
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


def _check(got, want):
    for name, g, w in zip(("out", "h_last"), got, want):
        assert g.dtype == torch.float32 and g.shape == w.shape, name
        scale = float(w.abs().max())
        err = float((g - w).abs().max())
        assert err <= 1e-4 * scale + 1e-5 * min(1.0, scale), (name, err, scale)


# (B, S, di, N, h0, views): full-width jamba's decode and prefill shapes (di
# 8192, N 16), the reduced (di 256, N 8), S past one and four chunks of 32
# steps, di not a multiple of the block's 128 channels, zero and carried
# states, and the model's strided views
SCAN_CASES = [
    (4, 1, 8192, 16, True, True),
    (4, 32, 8192, 16, False, True),
    (2, 7, 256, 8, True, False),
    (2, 32, 256, 8, False, True),
    (1, 129, 200, 16, True, False),
    (3, 129, 200, 8, True, True),
    (2, 33, 1000, 16, False, False),
    (1, 1, 1, 8, True, False),
]


@pytest.mark.parametrize("case", SCAN_CASES, ids=lambda c: "-".join(map(str, c)))
def test_scan_kernel_matches_plain(dev, case):
    """One launch of the entry point per call, within the fp32 limit."""
    b, s, di, n, h0, views = case
    args = _operands(dev, b, s, di, n, seed=s + di + n, h0=h0, views=views)
    before = SCAN_ENTRY_LAUNCHES["repro_selective_scan_f32"], selective_scan.launches
    with torch.no_grad():
        got = selective_scan(*args)
    torch.cuda.synchronize()
    assert (SCAN_ENTRY_LAUNCHES["repro_selective_scan_f32"], selective_scan.launches) == (
        before[0] + 1, before[1] + 1)
    _check(got, selective_scan_plain(*args))


def test_scan_kernel_repeats_bitwise(dev):
    args = _operands(dev, 4, 32, 8192, 16, seed=3, views=True)
    with torch.no_grad():
        first, second = selective_scan(*args), selective_scan(*args)
    torch.cuda.synchronize()
    assert all(torch.equal(x, y) for x, y in zip(first, second))


@pytest.mark.parametrize("what", ["state dim", "grad", "host operand"])
def test_scan_launch_refuses_on_the_card(dev, what):
    """Another N, a tensor that needs grad (the kernel has no backward:
    ROADMAP queue 1 item 25), an operand left on the host."""
    args = list(_operands(dev, 2, 3, 256, 16 if what != "state dim" else 4, seed=0))
    err, match = ValueError, "ssm_state_dim"
    if what == "grad":
        args[0], err, match = args[0].requires_grad_(), RuntimeError, "item 25"
    elif what == "host operand":
        args[7], match = args[7].cpu(), "CUDA device"
    with pytest.raises(err, match=match):
        launch_selective_scan(*args)


def test_jamba_training_on_the_card_refuses(dev):
    """A loss-and-gradients pass of the reduced jamba on the card reaches
    the scan under autograd and raises, naming the scan's backward item;
    no plain version stands in."""
    cfg = get_config("jamba-v0.1-52b", reduced=True)
    params = M.init_params(cfg, torch.Generator().manual_seed(0), device=dev)
    batch = {"tokens": torch.zeros((1, 8), dtype=torch.int32, device=dev),
             "labels": torch.zeros((1, 8), dtype=torch.int32, device=dev)}
    with pytest.raises(RuntimeError, match="item 25"):
        loss_and_grads(cfg, DEFAULT_RUN.replace(param_dtype="float32"), params, batch)


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
