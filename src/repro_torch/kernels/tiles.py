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

# The JAX package's block-size rule (an activation tile of h*w*block_c bytes
# within this budget), kept so that plans match. It no longer sizes any
# buffer on the card.
SCHEDULE_BLOCK_BYTES = 8 * 1024 * 1024


# the output-channel tiles the fp32 ECR / PECR kernel takes (32 * NT
# columns per block, `ecr_conv.cu`)
CUDA_BLOCK_O = (64, 128)
# the row block of the CUDA BSR kernels (`bsr_matmul.cu`, `bsr_matmul_int8.cu`)
CUDA_BSR_BT = 8


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
    Kept for the parity test of the rule: the launches resolve the output
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


@dataclass(frozen=True)
class ConvLaunch:
    """Resolved geometry of one ECR / PECR conv op call, built by
    `ecr_conv_launch` / `conv_pool_launch`; the ops read their block size,
    channel padding and schedule length back out of it (the kernel's output
    tile is `resolve_block_o`'s, outside the schedule).

    c/h/w are the input extents as the op sees them (h/w carry the ConvSpec's
    spatial padding; c is pre-channel-pad); `pool` is the fused pool window
    (0 = unfused)."""

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
