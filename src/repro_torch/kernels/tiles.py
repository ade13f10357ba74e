"""Schedule geometry of the ECR / PECR conv ops and of the BSR conv lowering
(counterpart of `repro.kernels.tiles`).

`block_c` is the SCHEDULE granularity: the planner measures channel-block
occupancy at it, and the `(ids, cnt)` schedules count `block_c`-wide blocks.
The port keeps the reference's resolution rule bit for bit, so both packages
make identical plans and schedules. It does not size any buffer on the card:
the CUDA kernels tile shared memory on their own
(`repro_torch/kernels/csrc/ecr_conv.cu`).

`block_o` stays in `TileConfig` / `resolve_conv_tile` only so the resolution
rule compares one to one with the reference's; no launch reads it. The CUDA
kernels pick their own output-channel tile and need no output-channel
padding.
"""
from __future__ import annotations

from dataclasses import dataclass

# The JAX package's block-size rule (an activation tile of h*w*block_c bytes
# within this budget), kept so that plans match. It no longer sizes any
# buffer on the card.
SCHEDULE_BLOCK_BYTES = 8 * 1024 * 1024


@dataclass(frozen=True)
class TileConfig:
    """One schedule-geometry choice. 0 anywhere = the default. An all-zero
    config is falsy ("all defaults")."""

    block_c: int = 0
    block_o: int = 0

    def key(self) -> tuple:
        return (self.block_c, self.block_o)

    def __bool__(self) -> bool:
        return any(self.key())


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
    """(bc, bo) for the ECR / PECR conv ops; bo is clamped into [.., max(8, o)]."""
    bc = resolve_block_c(h, w, c, tile, dtype_bytes)
    bo = tile.block_o if tile is not None and tile.block_o > 0 else 128
    bo = min(bo, max(8, o))
    return bc, bo


@dataclass(frozen=True)
class ConvLaunch:
    """Resolved geometry of one ECR / PECR conv op call, built by
    `ecr_conv_launch` / `conv_pool_launch`; the ops read their block size,
    channel padding and schedule length back out of it.

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


def resolve_bsr_tile(o: int, k_taps: int) -> tuple:
    """(bt, bf) for the BSR conv lowering of an (O, K) weight:
    `sparse_weights.format.weight_block`, the geometry the pruner aligned its
    zeros to. The reference's per-dimension `tile=` override comes with tile
    search, in a later slice."""
    from repro_torch.sparse_weights.format import weight_block

    return weight_block(o, k_taps)
