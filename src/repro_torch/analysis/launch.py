"""Launch-geometry contracts on the card: verify a resolved launch record
(`repro_torch.kernels.tiles.ConvLaunch` / `BsrLaunch`) without launching it
(counterpart of `repro.analysis.launch`, redesigned for the CUDA kernels).

The records store every geometry field the kernels run with: the channel
schedule, and the CUDA tile and grid the kernels' host code picks on an H100
(`tiles.f32_conv_tile`, `tiles.i8_conv_tile`). The checks re-derive each
expectation from the primitive extents and flag any disagreement, so a
corrupted field cannot re-derive itself back to consistency.

Checks:
  RPA101  the grid covers each output element exactly once. ECR / PECR:
          spatial tiles of th x tw cover the (pool-floored) conv output,
          ceil(O / TN) output tiles cover the channels, one grid z per
          sample (`ecr_conv.cu`, `launch`), and the channel schedule is
          n_cb blocks of block_c with the minimal pad. BSR: row blocks of
          the kernels' 8 rows and ceil(F / bf) reduction blocks.
  RPA102  every gather stays in bounds: positive extents, and the last
          conv window fits the (already spatially padded) input.
  RPA103  the dynamic shared memory fits the card's 227 KB per block. When
          the kernel's own choice finds no tile that fits, that is a warn;
          a requested output tile (`tn_req`) that cannot fit is an error,
          as is an over-budget tile or BSR schedule.
  RPA104  int8 kernels accumulate in int32 and carry per-output-channel
          weight scales.
  RPA105  a fused pool epilogue tiles the conv output exactly (the kernel
          floors, so a remainder would silently truncate rows / cols).
"""
from __future__ import annotations

from repro_torch.analysis.diagnostics import DiagnosticSink
from repro_torch.kernels.tiles import (
    CUDA_BLOCK_O,
    CUDA_BSR_BT,
    CUDA_MAX_SMEM,
    BsrLaunch,
    ConvLaunch,
    f32_smem_bytes,
    i8_smem_bytes,
)


def _pad_ok(extent: int, pad: int, block: int, n_blocks: int) -> bool:
    """pad is the minimal fill of `extent` to a multiple of `block`, and
    `n_blocks` covers it exactly once."""
    return (block > 0 and 0 <= pad < block
            and (extent + pad) % block == 0
            and n_blocks * block == extent + pad)


def _check_conv_grid(L: ConvLaunch, is_int8: bool, sink, loc) -> None:
    """RPA101 / RPA103 of the CUDA tile and grid."""
    pp = L.pool or 1
    cov_h, cov_w = L.oh // pp * pp, L.ow // pp * pp
    if L.tn == 0:  # the kernel's host code found no tile that fits
        explicit = L.tn_req != 0
        sink.add("RPA103",
                 f"{L.kernel}: no spatial tile of the {L.oh}x{L.ow} output "
                 f"fits {CUDA_MAX_SMEM} B of shared memory at kernel "
                 f"{L.kh}x{L.kw}, stride {L.stride}"
                 + (f", output tile {L.tn_req}" if explicit else ""),
                 severity="error" if explicit else "warn",
                 hint=("ask for another output tile" if explicit else
                       "the launch would refuse this layer; run it dense"),
                 **loc)
        return
    tms, tns = ((128,), (128,)) if is_int8 else ((64, 128), CUDA_BLOCK_O)
    bad = []
    if L.tm not in tms or L.tn not in tns:
        bad.append(f"block {L.tm}x{L.tn} is not one the kernel has")
    if L.tn_req and L.tn != L.tn_req:
        bad.append(f"output tile {L.tn} where {L.tn_req} was asked for")
    if L.th < 1 or L.tw < 1 or L.th * L.tw > L.tm or L.th % pp or L.tw % pp:
        bad.append(f"spatial tile {L.th}x{L.tw} is not within {L.tm} "
                   f"positions in multiples of the pool window {pp}")
    elif L.tiles != -(-cov_h // L.th) * -(-cov_w // L.tw):
        bad.append(f"{L.tiles} spatial tiles of {L.th}x{L.tw} do not cover "
                   f"the {cov_h}x{cov_w} output once")
    if L.tn in tns and L.o_tiles != -(-L.o // L.tn):
        bad.append(f"{L.o_tiles} output tiles of {L.tn} do not cover "
                   f"o={L.o} once")
    if bad:
        sink.add("RPA101", f"{L.kernel}: " + "; ".join(bad),
                 hint="the grid is (spatial tiles, ceil(o / tn), batch)",
                 **loc)
        return
    smem = (i8_smem_bytes(L.th, L.tw, L.kh, L.kw, L.stride) if is_int8 else
            f32_smem_bytes(L.th, L.tw, L.kh, L.kw, L.stride, L.pool, L.tm, L.tn))
    if smem > CUDA_MAX_SMEM or L.smem_bytes != smem:
        sink.add("RPA103",
                 f"{L.kernel}: tile {L.th}x{L.tw} (block {L.tm}x{L.tn}) asks "
                 f"for {smem} B of shared memory (record: {L.smem_bytes} B) "
                 f"against {CUDA_MAX_SMEM} B per block",
                 hint="shrink the requested tile", **loc)


def check_conv_launch(L: ConvLaunch, sink: DiagnosticSink, *,
                      layer: int | None = None, kind: str = "",
                      impl: str = "") -> None:
    loc = dict(layer=layer, kind=kind, impl=impl)
    is_int8 = L.dtype_bytes == 1 or L.kernel.endswith("_int8")

    # --- RPA102: positive extents / in-bounds gathers --------------------
    if min(L.block_c, L.batch, L.stride) <= 0 or \
            min(L.c, L.h, L.w, L.o, L.kh, L.kw) <= 0:
        sink.add("RPA102",
                 f"{L.kernel}: non-positive launch dimension "
                 f"(c={L.c} h={L.h} w={L.w} o={L.o} k={L.kh}x{L.kw} "
                 f"stride={L.stride} block_c={L.block_c} batch={L.batch})",
                 hint="every extent and block size must be >= 1", **loc)
        return  # the remaining arithmetic would divide by zero
    oh = (L.h - L.kh) // L.stride + 1
    ow = (L.w - L.kw) // L.stride + 1
    if oh < 1 or ow < 1:
        sink.add("RPA102",
                 f"{L.kernel}: kernel {L.kh}x{L.kw} does not fit the padded "
                 f"{L.h}x{L.w} input (conv output {oh}x{ow})",
                 hint="the ConvSpec padding must leave >= one window", **loc)
        return
    last_h = (oh - 1) * L.stride + L.kh
    last_w = (ow - 1) * L.stride + L.kw
    if last_h > L.h or last_w > L.w:
        sink.add("RPA102",
                 f"{L.kernel}: last window reads row {last_h}/col {last_w} "
                 f"of a {L.h}x{L.w} input (out of bounds)", **loc)

    # --- RPA101: schedule and grid cover the output exactly once ---------
    if not _pad_ok(L.c, L.c_pad, L.block_c, L.n_cb):
        sink.add("RPA101",
                 f"{L.kernel}: channel blocking c={L.c}+{L.c_pad} pad != "
                 f"{L.n_cb} x block_c={L.block_c}",
                 hint="n_cb must equal ceil(c / block_c) with minimal pad",
                 **loc)
    if (L.oh, L.ow) != (oh, ow):
        sink.add("RPA101",
                 f"{L.kernel}: record says conv output {L.oh}x{L.ow} but "
                 f"(h,w,kh,kw,stride)=({L.h},{L.w},{L.kh},{L.kw},{L.stride}) "
                 f"gives {oh}x{ow}",
                 hint="oh/ow must be (h - kh) // stride + 1", **loc)
        return

    # --- RPA105: fused pool tiles the conv output exactly ----------------
    if L.pool:
        if L.pool < 0 or L.oh % L.pool or L.ow % L.pool:
            sink.add("RPA105",
                     f"{L.kernel}: pool {L.pool}x{L.pool} does not tile the "
                     f"{L.oh}x{L.ow} conv output exactly: the fused "
                     f"epilogue floors, silently truncating the remainder",
                     hint="run the unit unfused (conv + pool) instead", **loc)
            return

    # --- RPA101 / RPA103: the CUDA tile, grid and shared memory ----------
    _check_conv_grid(L, is_int8, sink, loc)

    # --- RPA104: int8 accumulation / scale contract ----------------------
    if is_int8:
        if L.acc_dtype != "int32":
            sink.add("RPA104",
                     f"{L.kernel}: int8 operands accumulate in "
                     f"{L.acc_dtype!r}, must be int32",
                     hint="int8 MACs overflow anything narrower", **loc)
        if L.weight_scales != "per_output_channel":
            sink.add("RPA104",
                     f"{L.kernel}: int8 weight scales are "
                     f"{L.weight_scales!r}, must be per_output_channel",
                     hint="quantize_weights calibrates one scale per output "
                          "channel", **loc)


def check_bsr_launch(L: BsrLaunch, sink: DiagnosticSink, *,
                     layer: int | None = None, kind: str = "",
                     impl: str = "") -> None:
    loc = dict(layer=layer, kind=kind, impl=impl)
    is_int8 = L.dtype_bytes == 1

    # --- RPA102: positive extents ----------------------------------------
    if min(L.bt, L.bf) <= 0 or min(L.t, L.f, L.d) <= 0:
        sink.add("RPA102",
                 f"bsr_matmul: non-positive launch dimension "
                 f"(t={L.t} f={L.f} d={L.d} blocks {L.bt}x{L.bf})",
                 hint="every extent and block size must be >= 1", **loc)
        return

    # --- RPA101: row blocks and reduction blocks cover the operands ------
    if L.bt != CUDA_BSR_BT:
        sink.add("RPA101",
                 f"bsr_matmul: row block {L.bt}, but the kernels' row blocks "
                 f"are {CUDA_BSR_BT} rows",
                 hint="the schedule must be made at bt=8", **loc)
    for name, ext, blk, n in (("t", L.t, L.bt, L.nt), ("f", L.f, L.bf, L.nf)):
        if n != -(-ext // blk):
            sink.add("RPA101",
                     f"bsr_matmul: {name}={ext} in {n} blocks of {blk}: the "
                     f"grid would tile {name!r} "
                     f"{'short' if n * blk < ext else 'over'}",
                     hint=f"n{name} must equal ceil({name} / b{name})", **loc)

    # --- RPA103: shared memory (the ring is fixed; the union grows with nf)
    if L.smem_bytes > CUDA_MAX_SMEM:
        sink.add("RPA103",
                 f"bsr_matmul: {L.smem_bytes} B of shared memory for a "
                 f"schedule of {L.nf} reduction blocks exceeds "
                 f"{CUDA_MAX_SMEM} B per block",
                 hint="ask for a wider bf", **loc)

    # --- RPA104: int8 contract -------------------------------------------
    if is_int8:
        if L.acc_dtype != "int32":
            sink.add("RPA104",
                     f"bsr_matmul_int8: int8 operands accumulate in "
                     f"{L.acc_dtype!r}, must be int32", **loc)
        if L.weight_scales != "per_output_channel":
            sink.add("RPA104",
                     f"bsr_matmul_int8: int8 weight scales are "
                     f"{L.weight_scales!r}, must be per_output_channel",
                     **loc)


def check_launch(L, sink: DiagnosticSink, *, layer: int | None = None,
                 kind: str = "", impl: str = "") -> None:
    """Dispatch on the record's type (the registry's `unit_launch` returns
    either family, or None for impls without a kernel)."""
    if L is None:
        return
    if isinstance(L, ConvLaunch):
        check_conv_launch(L, sink, layer=layer, kind=kind, impl=impl)
    elif isinstance(L, BsrLaunch):
        check_bsr_launch(L, sink, layer=layer, kind=kind, impl=impl)
    else:
        raise TypeError(f"unknown launch record {type(L).__name__}")
