"""The MLA forward's work split on the host: `mla_fwd_split` (the wrapper's
rule, `repro_torch/kernels/cuda.py`) and the kernel's walk (`_blocks`,
`csrc/flash_mla.cu` transcribed) against a brute force over the rows,
columns and keys, and a plain-PyTorch mirror of the key-split combine
against `flash_fwd_mla_plain`. No card needed, no JAX.

Limits of the combine mirror against the plain version: fp32 out within
1e-4 * max|plain| + 1e-5 * min(1, max|plain|), m bitwise (a max of the same
scores), l within 1e-5 * max|plain|; over a bf16 latent out within 2^-7 *
max|plain| (p is rounded to bf16 against the chunk's max, not the row's)."""
import itertools

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.kernels import cuda as kcuda  # noqa: E402
from repro_torch.kernels.flash_attention.kernel import (  # noqa: E402
    NEG,
    _mask,
    _mla_prescaled,
    flash_fwd_mla_plain,
)

# (B, Sq, H, Sk, causal, q_offset, kv_len): the served prefill and decode
# (a 64-slot cache), a decode over 4,096 keys, ragged heads, rows that see
# no key (negative offsets), kv_len 0, a non-causal kv_len mask, a causal
# window at an offset, and more rows than fit one wave
GRID = [
    (4, 32, 128, 64, True, 0, 32),
    (4, 1, 128, 64, True, 32, 33),
    (4, 1, 128, 64, True, 63, 64),
    (4, 1, 128, 4096, True, 4095, 4096),
    (2, 1, 128, 1024, True, 700, 701),
    (1, 2, 64, 600, True, -1, None),
    (2, 6, 4, 16, True, -3, None),
    (1, 2, 128, 8, True, 0, 0),
    (1, 5, 16, 70, False, 0, 67),
    (2, 7, 3, 40, True, 33, 40),
    (1, 5, 128, 40, True, 30, 35),
    (2, 16, 128, 256, True, 0, None),
    (1, 3, 24, 300, False, 0, None),
]
DIMS = (512, 32)


def _blocks(b, h, sq, sk, r, causal, q_offset, kv_len, split=None):
    """Each MLA forward block's work as the kernel walks it (flash_mla_kernel,
    transcribed): (batch, column range, key chunk, [(row range, key range),
    ...] over its row tiles), key ranges in whole 16-key tiles, the last cut
    at Sk. `split` defaults to `mla_fwd_split` at the keys the rows visit."""
    rows = sq * h
    tiles = -(-rows // kcuda.MLA_FWD_ROWS)
    nrt, ncs, nks = split or kcuda.mla_fwd_split(
        b, rows, kcuda.mla_visit_end(sq, sk, causal, q_offset, kv_len), r)
    nrb = -(-tiles // nrt)  # row blocks: block rblk takes row tiles rblk, rblk + nrb, ...
    for bi in range(b):
        for x in range(nrb * ncs * nks):
            kc, cs, rblk = x % nks, (x // nks) % ncs, x // (nks * ncs)
            work = []
            for rt in range(rblk, tiles, nrb):
                r0, r1 = rt * kcuda.MLA_FWD_ROWS, min((rt + 1) * kcuda.MLA_FWD_ROWS, rows)
                kend = kcuda.mla_visit_end(sq, sk, causal, q_offset, kv_len, r0 // h,
                                           (r1 - 1) // h)
                nt = -(-kend // kcuda.MLA_FWD_KEYS)
                t0, t1 = 0, nt
                if nks > 1:
                    per = -(-nt // nks)
                    t0 = min(kc * per, nt)
                    t1 = min(t0 + per, nt)
                work.append(((r0, r1), (t0 * kcuda.MLA_FWD_KEYS,
                                        min(t1 * kcuda.MLA_FWD_KEYS, sk))))
            yield bi, (cs * r // ncs, (cs + 1) * r // ncs), kc, work


def _participating(sq, h, sk, causal, q_offset, kv_len):
    """(rows, Sk) True where a key takes part in a row's softmax: the keys
    it sees, or all Sk when it sees none (the mean of c_kv)."""
    seen = _mask(sq, sk, causal, q_offset, kv_len, "cpu").numpy()
    seen = np.repeat(seen, h, axis=0)  # row s * H + h
    seen[~seen.any(1)] = True
    return seen


@pytest.mark.parametrize("r", DIMS)
@pytest.mark.parametrize("case", GRID, ids=lambda c: "-".join(map(str, c)))
def test_every_row_column_and_key_is_covered_once(case, r):
    """Every (row, output column slice, key) a row's softmax needs is walked
    by exactly one block, and none twice (keys a tile visits past a row's
    own end are masked to p = 0, at most once)."""
    b, sq, h, sk, causal, q_offset, kv_len = case
    rows = sq * h
    slice_w = r // kcuda.MLA_FWD_COLUMN_SLICES  # the finest column slice
    count = np.zeros((b, rows, sk, kcuda.MLA_FWD_COLUMN_SLICES), np.int32)
    for bi, (c0, c1), _, work in _blocks(b, h, sq, sk, r, causal, q_offset, kv_len):
        for (r0, r1), (k0, k1) in work:
            count[bi, r0:r1, k0:k1, c0 // slice_w:c1 // slice_w] += 1
    need = _participating(sq, h, sk, causal, q_offset, kv_len)
    assert count.max() <= 1
    assert (count[:, need] == 1).all()


@pytest.mark.parametrize("r", DIMS)
@pytest.mark.parametrize("case", GRID, ids=lambda c: "-".join(map(str, c)))
def test_key_chunks_are_walked_and_combined_in_key_order(case, r):
    """A row tile's key chunks, in chunk order (the combine's order), are
    consecutive ranges from key 0 to the tile's visit end, and the column
    slices of a row tile see the same key ranges (their m and l agree)."""
    b, sq, h, sk, causal, q_offset, kv_len = case
    chunks = {}
    for bi, cols, kc, work in _blocks(b, h, sq, sk, r, causal, q_offset, kv_len):
        for rows_, keys in work:
            chunks.setdefault((bi, rows_, cols), []).append((kc, keys))
    by_tile = {}
    for (bi, (r0, r1), cols), got in chunks.items():
        got.sort()
        assert [kc for kc, _ in got] == list(range(len(got)))
        kend = kcuda.mla_visit_end(sq, sk, causal, q_offset, kv_len, r0 // h, (r1 - 1) // h)
        edge = 0
        for _, (k0, k1) in got:
            assert k0 == edge or k0 >= k1  # an empty chunk may sit past the end
            edge = max(edge, k1)
        assert edge == min(-(-kend // kcuda.MLA_FWD_KEYS) * kcuda.MLA_FWD_KEYS, sk)
        by_tile.setdefault((bi, r0), set()).add(tuple(k for _, k in got))
    assert all(len(v) == 1 for v in by_tile.values())


def test_the_served_shapes_split_as_designed():
    """The served prefill takes 8 row tiles a block (128 blocks), the served
    decode 4 column slices (128 blocks), a decode over 4,096 keys 4 key
    chunks (128 blocks); the reduced width never slices its 32 columns."""
    assert kcuda.mla_fwd_split(4, 32 * 128, 32) == (8, 1, 1)
    assert kcuda.mla_fwd_split(4, 128, 33) == (1, 4, 1)
    assert kcuda.mla_fwd_split(4, 128, 64) == (1, 4, 1)
    assert kcuda.mla_fwd_split(4, 128, 4096) == (1, 1, 4)
    assert kcuda.mla_fwd_split(4, 128, 33, r=32) == (1, 1, 1)
    assert kcuda.mla_visit_end(32, 64, True, 0, 32) == 32
    assert kcuda.mla_visit_end(1, 64, True, 32, 33) == 33
    assert kcuda.mla_visit_end(2, 600, True, -1, None) == 600  # a row sees no key
    assert kcuda.mla_visit_end(2, 8, True, 0, 0) == 8


@pytest.mark.parametrize("rows_sk", list(itertools.product((1, 16, 128, 4096, 16384),
                                                           (1, 16, 33, 64, 65, 1024, 4096))))
@pytest.mark.parametrize("b", [1, 4, 64])
def test_split_fills_the_card_without_idle_chunks(b, rows_sk):
    """Key chunks make about MLA_FWD_SLOTS blocks or fewer, and never
    outnumber the key tiles; column slices only at r = 512 and with fewer
    row tiles than MLA_FWD_SLOTS; one kind of split at a time."""
    rows, sk = rows_sk
    nrt, ncs, nks = kcuda.mla_fwd_split(b, rows, sk)
    tiles = b * -(-rows // kcuda.MLA_FWD_ROWS)
    assert nrt >= 1 and ncs in (1, kcuda.MLA_FWD_COLUMN_SLICES) and nks >= 1
    assert sum(x > 1 for x in (nrt, ncs, nks)) <= 1
    assert nks <= -(-sk // kcuda.MLA_FWD_KEYS)
    blocks = -(-tiles // nrt) * ncs * nks
    assert blocks <= max(kcuda.MLA_FWD_SLOTS, tiles) * ncs
    assert ncs == 1 or tiles < kcuda.MLA_FWD_SLOTS
    assert nrt == 1 or sk <= kcuda.MLA_FWD_RESIDENT
    assert kcuda.mla_fwd_split(b, rows, sk, r=32)[1] == 1


def _combined(q, c, k, *, scale, causal, q_offset, kv_len, nks):
    """The kernel's function by key chunks, in plain PyTorch: each chunk of
    each row tile (`_blocks` at `nks` chunks) scores its keys (keys
    at or past the tile's visit end -inf), takes its m (from NEG), l and
    unnormalised sum (p rounded to bf16 over a bf16 latent), and the
    combine adds the chunks in order: M = max m_j, w_j = exp(m_j - M), L =
    sum w_j l_j, out = sum w_j acc_j / max(L, 1e-30)."""
    b, sq, h, _ = q.shape
    sk, r = c.shape[1], c.shape[2]
    rows = sq * h
    keys = torch.cat([c, k], -1).float()
    s = torch.einsum("bqhd,bkd->bqhk", _mla_prescaled(q, scale), keys).reshape(b, rows, sk)
    seen = _mask(sq, sk, causal, q_offset, kv_len, "cpu").repeat_interleave(h, 0)
    s = torch.where(seen, s, torch.full((), NEG))
    parts = {}
    for bi, _, kc, work in _blocks(b, h, sq, sk, r, causal, q_offset, kv_len,
                                                split=(1, 1, nks)):
        for (r0, r1), (k0, k1) in work:
            kend = kcuda.mla_visit_end(sq, sk, causal, q_offset, kv_len, r0 // h, (r1 - 1) // h)
            x = s[bi, r0:r1, k0:max(k0, k1)].clone()
            x[:, max(0, kend - k0):] = -torch.inf
            m = torch.clamp_min(x.amax(-1) if x.shape[1] else torch.full((r1 - r0,), NEG), NEG)
            p = torch.exp(x - m[:, None])
            pr = p.to(torch.bfloat16).float() if c.dtype == torch.bfloat16 else p
            parts[(bi, r0, kc)] = (m, p.sum(-1), pr @ c[bi, k0:max(k0, k1)].float())
    out = torch.empty(b, rows, r)
    m_all, l_all = torch.empty(b, rows), torch.empty(b, rows)
    for bi, r0 in {(bi, r0) for bi, r0, _ in parts}:
        ms, ls, accs = zip(*(parts[(bi, r0, j)] for j in range(nks)))
        big = torch.full_like(ms[0], NEG)
        for m in ms:
            big = torch.maximum(big, m)
        l_sum, acc = torch.zeros_like(big), torch.zeros_like(accs[0])
        for m, l_, a in zip(ms, ls, accs):
            w = torch.exp(m - big)
            l_sum = l_sum + w * l_
            acc = acc + w[:, None] * a
        l_sum = torch.clamp_min(l_sum, 1e-30)
        r1 = r0 + big.shape[0]
        out[bi, r0:r1], m_all[bi, r0:r1], l_all[bi, r0:r1] = acc / l_sum[:, None], big, l_sum
    return out.reshape(b, sq, h, r).to(c.dtype), m_all, l_all


# (B, Sq, H, Sk, causal, q_offset, kv_len, chunks): rows that see no key
# (the mean over all Sk), kv_len 0 (every row averages), a chunk edge on
# the causal diagonal (16-key tiles, one tile a chunk: position 15 sees keys
# 0 .. 15 and ends exactly on the first edge), more chunks than key tiles
# (empty chunks), a decode whose kv_len ends inside a chunk, a non-causal
# kv_len mask
COMBINE_CASES = [
    (2, 3, 4, 40, True, -1, None, 3),
    (1, 2, 8, 24, True, 0, 0, 2),
    (1, 20, 2, 48, True, 0, None, 3),
    (2, 1, 16, 40, True, 39, 40, 8),
    (2, 1, 16, 200, True, 150, 151, 4),
    (1, 3, 5, 70, False, 0, 67, 3),
]


@pytest.mark.parametrize("latent", ["float32", "bfloat16"])
@pytest.mark.parametrize("case", COMBINE_CASES, ids=lambda c: "-".join(map(str, c)))
def test_key_split_combine_matches_the_plain_version(case, latent):
    b, sq, h, sk, causal, q_offset, kv_len, nks = case
    r, dr = 32, 16
    rng = np.random.default_rng(sk + h)
    q = torch.from_numpy(rng.standard_normal((b, sq, h, r + dr)).astype(np.float32))
    dt = torch.bfloat16 if latent == "bfloat16" else torch.float32
    c = torch.from_numpy(rng.standard_normal((b, sk, r)).astype(np.float32)).to(dt)
    k = torch.from_numpy(rng.standard_normal((b, sk, dr)).astype(np.float32)).to(dt)
    kw = dict(scale=(128 + dr) ** -0.5, causal=causal, q_offset=q_offset, kv_len=kv_len)
    out, m, l = _combined(q, c, k, nks=nks, **kw)
    w_out, w_m, w_l = flash_fwd_mla_plain(q, c, k, **kw)
    scale = float(w_out.float().abs().max())
    err = float((out.float() - w_out.float()).abs().max())
    limit = 2.0 ** -7 * scale if dt == torch.bfloat16 else 1e-4 * scale + 1e-5 * min(1.0, scale)
    assert out.dtype == w_out.dtype and err <= limit, (err, limit)
    assert torch.equal(m, w_m)
    assert float((l - w_l).abs().max()) <= 1e-5 * float(w_l.abs().max())
    if kv_len == 0 or q_offset < 0:  # rows that see no key: the mean over all Sk
        mean = c.float().mean(1)
        rows_none = torch.arange(sq) + q_offset < 0 if kv_len != 0 else torch.ones(sq, dtype=bool)
        got = out.float()[:, rows_none]
        assert float((got - mean[:, None, None]).abs().max()) <= limit
