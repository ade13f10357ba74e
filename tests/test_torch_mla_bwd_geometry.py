"""The MLA dkv backward pass's row chunks on the host: `mla_dkv_chunks`
(the wrapper's rule, `repro_torch/kernels/cuda.py`) against the tiling the
kernel (`csrc/flash_mla_bwd.cu`) walks, and the kernel's rule for skipping a
chunk, transcribed here, against a brute force over its tiles. No card
needed, no JAX."""
import pytest

torch = pytest.importorskip("torch")

from repro_torch.kernels import cuda as kcuda  # noqa: E402

# (batch, rows = Sq * H, Sk): deepseek-v2's training sublayer and the longer
# timed shape at 128 heads, decode-like and ragged shapes, one row, and
# more chunks wanted than tiles exist
SHAPES = [
    (2, 128 * 128, 128),
    (1, 1024 * 128, 1024),
    (1, 256 * 128, 256),
    (2, 7 * 24, 33),
    (1, 6 * 128, 33),
    (3, 1, 64),
    (1, 5 * 16, 70),
    (2, 7 * 3, 40),
    (1, 17, 1),
    (64, 4096, 4096),
]


def _chunks(b, rows, sk):
    """The kernel's tiling: nc chunks of `per` 16-row tiles each, the last
    cut at the tile count (parse in flash_mla_bwd.cu)."""
    nc = kcuda.mla_dkv_chunks(b, rows, sk)
    tiles = -(-rows // kcuda.MLA_DKV_ROWS)
    per = -(-tiles // nc)
    return nc, tiles, [range(c * per, min((c + 1) * per, tiles)) for c in range(nc)]


@pytest.mark.parametrize("shape", SHAPES, ids=lambda s: "-".join(map(str, s)))
def test_every_row_tile_lands_in_exactly_one_chunk(shape):
    b, rows, sk = shape
    nc, tiles, chunks = _chunks(b, rows, sk)
    assert 1 <= nc <= tiles
    seen = [t for c in chunks for t in c]
    assert seen == list(range(tiles))  # each tile once, in order
    assert all(len(c) > 0 for c in chunks)  # no chunk left empty


@pytest.mark.parametrize("shape", SHAPES, ids=lambda s: "-".join(map(str, s)))
def test_chunk_count_reaches_the_block_target(shape):
    """About MLA_BWD_BLOCKS blocks (key blocks x batch x chunks), unless the
    row tiles run out first: never fewer than half the target then."""
    b, rows, sk = shape
    nc, tiles, _ = _chunks(b, rows, sk)
    blocks = nc * b * -(-sk // kcuda.MLA_DKV_KEYS)
    assert nc == tiles or blocks >= kcuda.MLA_BWD_BLOCKS // 2
    per = -(-tiles // nc)
    assert -(-tiles // per) == nc  # the rule returns the count its own tiling gives


@pytest.mark.parametrize("shape", SHAPES, ids=lambda s: "-".join(map(str, s)))
def test_scratch_holds_every_partial_the_kernel_writes(shape):
    """The wrapper's scratch (nc, B, Sk, r + dr): the kernel's largest index,
    ((chunk * B + b) * Sk + key) * Dk + d at its largest chunk, batch, key
    and column, is the scratch's last element."""
    b, rows, sk = shape
    nc, _, _ = _chunks(b, rows, sk)
    dk = 512 + 64
    last = (((nc - 1) * b + b - 1) * sk + sk - 1) * dk + dk - 1
    scratch = torch.empty((nc, b, sk, dk), device="meta")
    assert last == scratch.numel() - 1


def _rows_blind(h, sk, causal, q_offset, kv_len, s_first, s_last, k0):
    """flash_mla_bwd.cu's rows_blind: no row at positions [s_first, s_last]
    takes a gradient from keys k0 on."""
    kv_lim = sk if kv_len is None else min(kv_len, sk)
    if kv_lim == 0 or (causal and q_offset + s_first < 0):
        return False
    return k0 >= kv_lim or (causal and k0 > q_offset + s_last)


def _chunk_blind(rows, h, sk, causal, q_offset, kv_len, nc, chunk, k0):
    """flash_mla_bwd.cu's chunk_blind: the chunk's first and last rows."""
    t = kcuda.MLA_DKV_ROWS
    tiles = -(-rows // t)
    per = -(-tiles // nc)
    tb, te = chunk * per, min((chunk + 1) * per, tiles)
    if tb >= te:
        return True
    return _rows_blind(h, sk, causal, q_offset, kv_len, tb * t // h,
                       (min(te * t, rows) - 1) // h, k0)


# (Sq, H, Sk, causal, q_offset, kv_len): causal squares, offsets past and
# before the keys (rows that see none), kv_len masks and kv_len 0
MASKS = [
    (128, 128, 128, True, 0, None),
    (16, 24, 33, True, 0, None),
    (6, 128, 33, True, 27, 33),
    (6, 4, 16, True, -3, None),
    (40, 3, 70, True, -20, 50),
    (5, 16, 70, False, 0, 67),
    (2, 4, 8, True, 0, 0),
    (9, 7, 100, False, 0, None),
]


@pytest.mark.parametrize("mask", MASKS, ids=lambda m: "-".join(map(str, m)))
def test_a_skipped_chunk_has_only_blind_tiles(mask):
    """A chunk is skipped (its block exits, the reduce leaves it out) exactly
    when every one of its tiles is blind to the key block: rows_blind is
    monotone in the first and the last row's position, so the chunk's ends
    decide, also where rows before the keys see none of them (negative
    offsets) and blind tiles sit between seeing ones."""
    sq, h, sk, causal, q_offset, kv_len = mask
    rows = sq * h
    t = kcuda.MLA_DKV_ROWS
    tiles = -(-rows // t)
    for nc in sorted({1, 2, 3, max(1, tiles // 2), tiles, kcuda.mla_dkv_chunks(1, rows, sk)}):
        per = -(-tiles // nc)
        for chunk in range(nc):
            for k0 in range(0, sk, kcuda.MLA_DKV_KEYS):
                brute = all(_rows_blind(h, sk, causal, q_offset, kv_len, i * t // h,
                                        (min(i * t + t, rows) - 1) // h, k0)
                            for i in range(chunk * per, min((chunk + 1) * per, tiles)))
                assert _chunk_blind(rows, h, sk, causal, q_offset, kv_len, nc, chunk,
                                    k0) == brute, (nc, chunk, k0)
