"""Schedule and kernel geometry of the ECR / PECR conv ops and of the BSR
conv lowering (counterpart of `repro.kernels.tiles`).

`block_c` is the SCHEDULE granularity: the planner measures channel-block
occupancy at it, and the `(ids, cnt)` schedules count `block_c`-wide blocks.
The port keeps the reference's resolution rule bit for bit, so both packages
make identical plans and schedules.

`TileConfig` carries the reference's five dimensions, so tile-search
winners and calibration keys compare one to one between the packages; the
CUDA kernels honour what they can:
- `block_c`: the schedule's channel block (every conv kernel);
- `block_o`: the fp32 ECR / PECR kernel's output-channel tile, 64 or 128
  (`resolve_block_o`; 0 lets the kernel choose, the int8 conv kernel has a
  fixed 128-channel tile and ignores it);
- `bt`, `bf`: the BSR row and reduction blocks. The CUDA BSR kernels take
  8-row blocks only, so `bt` is always 8 and any other request falls back
  to it; `bf` is honoured by the reference's rule (`resolve_bsr_tile`);
- `bd`: the reference's column block. The CUDA BSR kernels tile the
  columns themselves, so it has no counterpart: carried in the key and
  ignored.
"""
from __future__ import annotations

from dataclasses import dataclass
from functools import lru_cache

# The JAX package's block-size rule (an activation tile of h*w*block_c bytes
# within this budget), kept so that plans match. It no longer sizes any
# buffer on the card.
SCHEDULE_BLOCK_BYTES = 8 * 1024 * 1024


# the output-channel tiles the fp32 ECR / PECR kernel takes (32 * NT
# columns per block, `ecr_conv.cu`)
CUDA_BLOCK_O = (64, 128)
# the row block of the CUDA BSR kernels (`bsr_matmul.cu`, `bsr_matmul_int8.cu`)
CUDA_BSR_BT = 8

# Shared memory a block may ask for on sm_90 (`kMaxSmem` of the conv
# kernels; the BSR launches refuse more), and the most that still leaves
# room for two blocks per SM (`kTwoPerSm`).
CUDA_MAX_SMEM = 227 * 1024
CUDA_TWO_PER_SM = 113 * 1024
# Streaming multiprocessors of the H100 SXM: the grid-size rule of the fp32
# conv kernel's (TM, TN) choice counts them (`ecr_conv.cu`, `launch`).
H100_SMS = 132


@dataclass(frozen=True)
class TileConfig:
    """One kernel-geometry choice. 0 anywhere = the default.

    block_c / block_o: ECR/PECR input-channel block (the schedule) and
                       output-channel tile.
    bt / bf / bd:      BSR row- / reduction- / column-block sizes.
    An all-zero config is falsy ("all defaults"), so `tile or fallback`
    composes with the block_c-only plumbing.
    """

    block_c: int = 0
    block_o: int = 0
    bt: int = 0
    bf: int = 0
    bd: int = 0

    def key(self) -> tuple:
        """The hashable 5-tuple the CalibrationDB and PlanKey key on (the
        reference's key, element for element)."""
        return (self.block_c, self.block_o, self.bt, self.bf, self.bd)

    def __bool__(self) -> bool:
        return any(self.key())

    @classmethod
    def from_key(cls, key) -> "TileConfig":
        bc, bo, bt, bf, bd = (int(v) for v in key)
        return cls(block_c=bc, block_o=bo, bt=bt, bf=bf, bd=bd)


DEFAULT_TILE = TileConfig()


def as_tile(tile=None, block_c: int = 0) -> TileConfig:
    """An explicit non-default tile wins, else the legacy block_c lifts into one."""
    if tile:
        return tile
    return TileConfig(block_c=int(block_c)) if block_c else DEFAULT_TILE


def pick_block_c(h: int, w: int, c: int, dtype_bytes: int = 4) -> int:
    """Largest power-of-two channel block whose (h, w, bc) activation tile
    fits `SCHEDULE_BLOCK_BYTES`."""
    bc = 128
    while bc > 8 and h * w * bc * dtype_bytes > SCHEDULE_BLOCK_BYTES:
        bc //= 2
    return bc


def resolve_block_c(h: int, w: int, c: int, tile: TileConfig | None = None,
                    dtype_bytes: int = 4) -> int:
    """The channel-block size actually scheduled for a (C, h, w) input.

    A requested block_c is honored iff 0 < block_c <= max(8, c); anything
    else falls back to `pick_block_c`, clamped so a small layer is at most
    one block."""
    bc = tile.block_c if tile is not None else 0
    if bc <= 0 or bc > max(8, c):
        bc = min(pick_block_c(h, w, c, dtype_bytes), max(8, c))
    return bc


def resolve_conv_tile(h: int, w: int, c: int, o: int,
                      tile: TileConfig | None = None,
                      dtype_bytes: int = 4) -> tuple:
    """(bc, bo) by the reference's rule; bo is clamped into [.., max(8, o)].
    `channel_block_occupancy` reads its bc; the launches resolve the output
    tile through `resolve_block_o`."""
    bc = resolve_block_c(h, w, c, tile, dtype_bytes)
    bo = tile.block_o if tile is not None and tile.block_o > 0 else 128
    bo = min(bo, max(8, o))
    return bc, bo


def resolve_block_o(o: int, block_o: int = 0) -> int:
    """The output-channel tile the fp32 ECR / PECR kernel is asked for: a
    requested block_o is honoured iff the kernel takes it (`CUDA_BLOCK_O`)
    and it is at most max(8, o) (one tile of padding, the reference's
    conformance bound); anything else is 0, the kernel's own choice."""
    return block_o if block_o in CUDA_BLOCK_O and block_o <= max(8, o) else 0


# ---------------------------------------------------------------------------
# The CUDA conv kernels' host-side tile choice, in Python
# ---------------------------------------------------------------------------

_F32_K, _F32_PAD = 8, 8  # channels per k-step, floats after a slab row
_I8_K, _I8_TILE = 32, 128  # channels per k-step, positions / channels per block
_F32_CHOICES = ((4, 4), (2, 4), (4, 2), (2, 2))  # (MT, NT): TM = 32*MT, TN = 32*NT


def _div0(a: int, b: int) -> int:
    """C++ integer division (truncates toward zero)."""
    q = abs(a) // b
    return q if a >= 0 else -q


@lru_cache(maxsize=4096)
def f32_pick_tile(oh: int, ow: int, kh: int, kw: int, stride: int, pool: int,
                  tm: int, tn: int) -> tuple:
    """`pick_tile` of `ecr_conv.cu` for one (TM, TN): the spatial tile
    (th, tw) of at most tm positions (multiples of the pool window) whose
    double-buffered split halo and one tap of the slab fit, needing the
    fewest tiles, then a width that is a multiple of 8, then the smallest
    halo. Returns (th, tw, spatial tiles, dynamic shared memory in bytes),
    or (0, 0, 0, 0) when no tile fits `CUDA_MAX_SMEM`."""
    pp = pool or 1
    cov_h, cov_w = oh // pp * pp, ow // pp * pp  # rows / cols the floor keeps
    if cov_h < 1 or cov_w < 1:
        return (0, 0, 0, 0)
    tap_floats = _F32_K * (tn + _F32_PAD)
    best = None
    for tw in range(pp, min(cov_w, tm) + 1, pp):
        th = min(tm // tw, cov_h) // pp * pp
        if th < 1:
            continue
        ih, iw = (th - 1) * stride + kh, (tw - 1) * stride + kw
        halo = ih * iw * _F32_K
        if (4 * halo + 2 * tap_floats) * 4 > CUDA_MAX_SMEM:
            continue
        tiles = -(-cov_h // th) * -(-cov_w // tw)
        key = (tiles * 2 + (tw % 8 != 0)) * CUDA_MAX_SMEM + halo
        if best is None or key < best[0]:
            best = (key, th, tw, tiles, halo)
    if best is None:
        return (0, 0, 0, 0)
    _, th, tw, tiles, _ = best
    return (th, tw, tiles, f32_smem_bytes(th, tw, kh, kw, stride, pool, tm, tn))


@lru_cache(maxsize=4096)
def f32_conv_tile(batch: int, oh: int, ow: int, o: int, kh: int, kw: int,
                  stride: int, pool: int, tn_req: int = 0,
                  sms: int = H100_SMS) -> tuple:
    """The (TM, TN) choice of `ecr_conv.cu`'s `launch`: of the tiles whose
    grid (spatial tiles x ceil(O/TN) x N) covers the SMs, the one with the
    least padded work, ties to the larger tile; else the grid with the most
    blocks. `tn_req` 64 / 128 keeps only TN = tn_req. Returns (tm, tn, th,
    tw, spatial tiles, O tiles, shared memory), all 0 when nothing fits."""
    best = None
    for mt, nt in _F32_CHOICES:
        tm, tn = 32 * mt, 32 * nt
        if tn_req and tn != tn_req:
            continue
        th, tw, tiles, smem = f32_pick_tile(oh, ow, kh, kw, stride, pool, tm, tn)
        o_tiles = -(-o // tn)
        if smem == 0 or o_tiles > 65535:
            continue
        blocks = tiles * o_tiles * batch
        short = int(blocks < sms)
        cost = -blocks if short else tiles * tm * o_tiles * tn
        if best is None or (short, cost) < best[0]:
            best = ((short, cost), (tm, tn, th, tw, tiles, o_tiles, smem))
    return best[1] if best is not None else (0,) * 7


@lru_cache(maxsize=4096)
def i8_conv_tile(oh: int, ow: int, o: int, kh: int, kw: int, stride: int) -> tuple:
    """`pick_tile` of `ecr_conv_int8.cu` (128 positions x 128 channels per
    block): (tm, tn, th, tw, spatial tiles, O tiles, shared memory), all 0
    when no spatial tile fits `CUDA_MAX_SMEM`."""
    tap_bytes = _I8_K * _I8_TILE
    best = None
    for tw in range(1, min(ow, _I8_TILE) + 1):
        th = min(_I8_TILE // tw, oh)
        ih, iw = (th - 1) * stride + kh, (tw - 1) * stride + kw
        halo = ih * iw * _I8_K
        if 2 * halo + 2 * tap_bytes > CUDA_MAX_SMEM:
            continue
        tiles = -(-oh // th) * -(-ow // tw)
        key = (tiles * 2 + (tw % 8 != 0)) * CUDA_MAX_SMEM + halo
        if best is None or key < best[0]:
            best = (key, th, tw, tiles, halo)
    if best is None:
        return (0,) * 7
    _, th, tw, tiles, _ = best
    return (_I8_TILE, _I8_TILE, th, tw, tiles, -(-o // _I8_TILE),
            i8_smem_bytes(th, tw, kh, kw, stride))


def f32_smem_bytes(th: int, tw: int, kh: int, kw: int, stride: int, pool: int,
                   tm: int, tn: int) -> int:
    """The shared memory `ecr_conv.cu` asks for at a given tile: the split
    halo's four buffers, a double-buffered slab of the taps per staged chunk
    (all of them if two blocks still fit an SM, else as many as fit that,
    else as many as fit one block), and the pool epilogue's tile. More than
    `CUDA_MAX_SMEM` when even one tap does not fit."""
    ih, iw = (th - 1) * stride + kh, (tw - 1) * stride + kw
    halo_bytes = 4 * ih * iw * _F32_K * 4
    tap_bytes = 2 * _F32_K * (tn + _F32_PAD) * 4
    left2 = _div0(CUDA_TWO_PER_SM - halo_bytes, tap_bytes)
    left1 = _div0(CUDA_MAX_SMEM - halo_bytes, tap_bytes)
    tc = max(1, min(kh * kw, left2 if left2 >= 1 else left1))
    epi = tm * (tn + _F32_PAD) * 4 if pool else 0
    return max(halo_bytes + tc * tap_bytes, epi)


def i8_smem_bytes(th: int, tw: int, kh: int, kw: int, stride: int) -> int:
    """The shared memory `ecr_conv_int8.cu` asks for at a given tile."""
    ih, iw = (th - 1) * stride + kh, (tw - 1) * stride + kw
    halo = ih * iw * _I8_K
    tap_bytes = _I8_K * _I8_TILE
    left2 = _div0(CUDA_TWO_PER_SM - 2 * halo, 2 * tap_bytes)
    left1 = _div0(CUDA_MAX_SMEM - 2 * halo, 2 * tap_bytes)
    tc = max(1, min(kh * kw, left2 if left2 >= 1 else left1))
    return 2 * halo + 2 * tc * tap_bytes


# the ConvLaunch fields that record the CUDA geometry (no reference
# counterpart: the reference's grid is the Pallas one)
CUDA_CONV_FIELDS = ("tn_req", "tm", "tn", "th", "tw", "tiles", "o_tiles",
                    "smem_bytes")


@dataclass(frozen=True)
class ConvLaunch:
    """Resolved geometry of one ECR / PECR conv op call, built by
    `ecr_conv_launch` / `conv_pool_launch`; the ops read their block size,
    channel padding, schedule length and the output tile they ask of the
    kernel (`tn_req`) back out of it.

    c/h/w are the input extents as the op sees them (h/w carry the ConvSpec's
    spatial padding; c is pre-channel-pad); `pool` is the fused pool window
    (0 = unfused).

    The CUDA geometry (`CUDA_CONV_FIELDS`) is what the kernel's host code
    would pick for this call on an H100 (`f32_conv_tile` / `i8_conv_tile`):
    `tn_req` the output tile asked for (64 / 128, 0 = the kernel's choice),
    the block's TM positions x TN output channels, the spatial tile th x tw,
    the grid (spatial tiles, O tiles, batch) and the dynamic shared memory,
    0 everywhere when no tile fits. The fields are stored, not derived, so a
    corrupted record is representable: `repro_torch.analysis.launch`
    re-derives each expectation and flags what disagrees.
    `acc_dtype` / `weight_scales` record the int8 kernel's contract."""

    kernel: str  # "ecr_conv" | "conv_pool"
    batch: int
    c: int
    h: int
    w: int
    o: int
    kh: int
    kw: int
    stride: int
    pool: int
    block_c: int
    c_pad: int  # channel padding up to a block_c multiple
    n_cb: int  # input-channel blocks = schedule length
    oh: int  # conv output spatial dims (pre-pool)
    ow: int
    dtype_bytes: int
    tn_req: int = 0  # output tile asked of the fp32 kernel (0 = its choice)
    tm: int = 0  # output positions per block
    tn: int = 0  # output channels per block
    th: int = 0  # spatial tile (rows x cols of output positions)
    tw: int = 0
    tiles: int = 0  # spatial tiles per sample (grid x)
    o_tiles: int = 0  # ceil(o / tn) (grid y)
    smem_bytes: int = 0  # dynamic shared memory per block
    acc_dtype: str = "float32"
    weight_scales: str = "none"  # "none" | "per_output_channel"

    @property
    def grid(self) -> tuple:
        """(spatial tiles, O tiles, batch): the CUDA grid."""
        return (self.tiles, self.o_tiles, self.batch)


@dataclass(frozen=True)
class BsrLaunch:
    """Resolved geometry of one BSR matmul kernel call: a (t, f) sparse left
    operand against (f, d), scheduled in (bt, bf) blocks. Built by
    `sparse_weights.conv.bsr_conv_launch` (t = output channels, f = K taps,
    d = patches) from the same `resolve_bsr_tile` call the op executes with.

    The schedule has nt = ceil(t/bt) row-blocks of nf = ceil(f/bf) reduction
    blocks, exactly as in the reference. The CUDA kernel takes the unpadded
    operands, masks the ragged edges and tiles the columns on its own, so
    the reference's column block and paddings have no counterpart here."""

    t: int
    f: int
    d: int
    bt: int
    bf: int
    nt: int  # row blocks (per-row-block (ids, cnt) schedules)
    nf: int  # reduction blocks = schedule width
    dtype_bytes: int
    acc_dtype: str = "float32"
    weight_scales: str = "none"  # "none" | "per_output_channel"

    @property
    def smem_bytes(self) -> int:
        """The most dynamic shared memory the kernel asks for (8 row-blocks
        per block): the staged ring of A^T and W steps and the schedule
        union (`bsr_matmul.cu` / `bsr_matmul_int8.cu`, `launch_vr`)."""
        if self.dtype_bytes == 1:  # 4 stages of 64 x 256 + 64 x 80 bytes
            return 4 * (64 * 256 + 8 * 8 * 80) + (2 * self.nf + 1) * 4
        # 2 stages of 32 x 264 + 64 x 36 floats
        return 2 * (32 * 264 + 8 * 8 * 36) * 4 + (2 * self.nf + 1 + 8 + self.nt) * 4


def resolve_bsr_tile(o: int, k_taps: int, p: int,
                     tile: TileConfig | None = None) -> tuple:
    """(bt, bf) for the BSR conv lowering of an (O, K) weight against (K, P)
    patches. The defaults are `sparse_weights.format.weight_block`, the
    geometry the pruner aligned its zeros to. A requested bf is honoured iff
    0 < bf <= max(8, K), the reference's per-dimension rule; bt is always
    `CUDA_BSR_BT` (the kernels' row block), so a request for another bt
    falls back to it, and bd (the reference's column block) has no
    counterpart: the kernels tile the P columns themselves, so `p` only
    keeps the reference's signature."""
    from repro_torch.sparse_weights.format import weight_block

    del p
    dbt, dbf = weight_block(o, k_taps)
    if tile is None:
        return dbt, dbf
    bf = tile.bf if 0 < tile.bf <= max(8, k_taps) else dbf
    return CUDA_BSR_BT, bf
