"""The selective scan backward's scratch on the host: `scan_bwd_scratch`
(the shapes the wrapper allocates, `repro_torch/kernels/cuda.py`) at
literal shapes, and the wrapper's copy of the kernel's channels a block and
steps a chunk against `csrc/selective_scan.cu`'s (the library checks them
again when it loads: `check_scan_geometry`). No card needed, no JAX."""
import re

import pytest

torch = pytest.importorskip("torch")

from repro_torch.kernels import cuda as kcuda  # noqa: E402

# (B, S, di, N) -> the scratch {ck, pbc, pa, pd} at 32 channels a block and
# 8 steps a chunk: full-width training and a served prefill and decode; di
# not a multiple of the block's channels at N 8 and 16; S within one chunk,
# at two, and past two (ragged); a batch at the grid's y limit
SCRATCH_CASES = [
    ((4, 128, 8192, 16), {"ck": (4, 14, 8192, 16), "pbc": (256, 4, 128, 32),
                          "pa": (4, 8192, 16), "pd": (4, 8192)}),
    ((4, 32, 8192, 16), {"ck": (4, 2, 8192, 16), "pbc": (256, 4, 32, 32),
                         "pa": (4, 8192, 16), "pd": (4, 8192)}),
    ((4, 1, 8192, 16), {"ck": (4, 0, 8192, 16), "pbc": (256, 4, 1, 32),
                        "pa": (4, 8192, 16), "pd": (4, 8192)}),
    ((2, 40, 328, 8), {"ck": (2, 3, 328, 8), "pbc": (11, 2, 40, 16),
                       "pa": (2, 328, 8), "pd": (2, 328)}),
    ((4, 48, 8200, 16), {"ck": (4, 4, 8200, 16), "pbc": (257, 4, 48, 32),
                         "pa": (4, 8200, 16), "pd": (4, 8200)}),
    ((1, 16, 1, 8), {"ck": (1, 0, 1, 8), "pbc": (1, 1, 16, 16), "pa": (1, 1, 8),
                     "pd": (1, 1)}),
    ((2, 17, 64, 16), {"ck": (2, 1, 64, 16), "pbc": (2, 2, 17, 32), "pa": (2, 64, 16),
                       "pd": (2, 64)}),
    ((65535, 2, 3, 8), {"ck": (65535, 0, 3, 8), "pbc": (1, 65535, 2, 16),
                        "pa": (65535, 3, 8), "pd": (65535, 3)}),
]


@pytest.mark.parametrize("case,want", SCRATCH_CASES, ids=lambda c: "-".join(map(str, c))
                         if isinstance(c, tuple) else "")
def test_scan_bwd_scratch(case, want):
    assert kcuda.scan_bwd_scratch(*case) == want


def test_scan_bwd_partials_are_no_larger_than_before():
    """At full-width training (B 4, S 128, di 8192, N 16) the dB / dC
    partials take no more than the 16.8 MB of per-warp partials before
    (256 warps x B x S x 2N fp32)."""
    pbc = kcuda.scan_bwd_scratch(4, 128, 8192, 16)["pbc"]
    assert 4 * torch.Size(pbc).numel() <= 4 * 256 * 4 * 128 * 32


def test_scratch_geometry_matches_the_kernel_source():
    """The wrapper's channels a block and steps a chunk are the kernel's
    kBwdChannels and kChunk."""
    src = (kcuda.CSRC / "selective_scan.cu").read_text()
    got = tuple(int(re.search(rf"constexpr int {name} = (\d+);", src).group(1))
                for name in ("kBwdChannels", "kChunk"))
    assert got == (kcuda.SCAN_BWD_CHANNELS, kcuda.SCAN_CHUNK)
    kcuda.check_scan_geometry(got)


@pytest.mark.parametrize("kernel", [(64, 8), (32, 16)])
def test_check_scan_geometry_refuses_another_kernel(kernel):
    with pytest.raises(RuntimeError, match="sizes its scratch"):
        kcuda.check_scan_geometry(kernel)
