"""Op registry: the one impl-dispatch site from planner to serving
(counterpart of `repro.graph.registry`).

Every (node kind, impl) pair maps to one `OpImpl` carrying its forward, its
cost hook and its fusion metadata. The ten (kind, impl) strings are the
reference's, so plan signatures of the two packages compare one to one:

  ("conv", "dense")             F.conv2d (cuDNN on the card, TF32 off)
  ("conv", "im2col")            window matrix + one GEMM (the paper's baseline)
  ("conv", "ecr")               ECR sparse conv, plain PyTorch oracle
  ("conv", "ecr_pallas")        ECR sparse conv, CUDA kernel on the card
  ("conv", "bsr")               weight-block-sparse conv, CUDA BSR kernel
  ("conv", "ecr_int8")          int8 ECR conv, CUDA kernel
  ("conv", "bsr_int8")          int8 weight-block-sparse conv, CUDA kernel
  ("conv_pool", "unfused")      dense conv -> ReLU -> max-pool, separate ops
  ("conv_pool", "pecr")         PECR fused conv+ReLU+maxpool, plain oracle
  ("conv_pool", "pecr_pallas")  PECR fused conv+ReLU+maxpool, CUDA kernel

The "_pallas" suffix names the reference's op family, not the kernel
language; `OpImpl.pallas` marks the impls that launch a hand-written
kernel. The oracles ("im2col", "ecr", "unfused", "pecr") run the paper's
methods in plain PyTorch, on the card when given card tensors. The fusion rule (`fusion_eligible`), the fused <-> plain impl
mapping and the modeled cost of a unit (`unit_cost`, `unit_model_us`, which
the planner's arms compare, at the datasheet constants or at a
`CalibrationDB`'s measured ones) live here too. Every forward takes the
layer's searched `tile=` (a `TileConfig`; None = the impl's defaults).
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Callable

from repro_torch.graph.ir import ConvUnit
from repro_torch.obs import constants


@dataclass(frozen=True)
class OpImpl:
    """One registered (kind, impl) implementation.

    forward: kind "conv"      -> f(x_padded, w, *, stride, block_c, tile) -> y
             kind "conv_pool" -> f(x_padded, w, *, stride, pool, block_c, tile) -> y
    cost:    f(c, h, w, o, kh, kw, *, stride, occupancy, batch, [pool]) -> dict
             with "flops"/"bytes"/"out_elems".
    sparse:  occupancy-dependent (skips dead channel blocks, or, for the
             oracles, masks zeros); its cost hook takes the occupancy.
    weight_sparse: weight-density-dependent (skips pruned weight blocks);
             its cost hook takes `weight_density`.
    pallas:  launches one of the port's hand-written CUDA kernels on the
             card, so it has a tile geometry to search (the reference's
             flag name, read by tile search and the planner).
    quantized: runs int8 operands (int32 accumulation, fp32 in and out).
    fused_with: for kind "conv_pool", the kind-"conv" impl of the same family
             (used on units whose pool is not fusion-eligible); for kind
             "conv", the kind-"conv_pool" impl it upgrades to.
    launch:  f(unit, *, tile, block_c, batch) -> the `ConvLaunch` /
             `BsrLaunch` this impl would resolve on `unit` (None for impls
             with no schedule).
    """

    kind: str
    impl: str
    forward: Callable
    cost: Callable | None = None
    sparse: bool = False
    fused_with: str | None = None
    launch: Callable | None = None
    weight_sparse: bool = False
    quantized: bool = False
    pallas: bool = False


_OPS: dict = {}


def register_op(op: OpImpl) -> OpImpl:
    key = (op.kind, op.impl)
    if key in _OPS:
        raise ValueError(f"op {key} already registered")
    _OPS[key] = op
    return op


def get_op(kind: str, impl: str) -> OpImpl:
    try:
        return _OPS[(kind, impl)]
    except KeyError:
        known = sorted(i for k, i in _OPS if k == kind)
        raise ValueError(
            f"unknown {kind} impl {impl!r} (registered: {known})") from None


def list_ops(kind: str | None = None) -> tuple:
    return tuple(op for op in _OPS.values() if kind is None or op.kind == kind)


# ---------------------------------------------------------------------------
# Fusion rule
# ---------------------------------------------------------------------------


def fusion_eligible(unit: ConvUnit) -> bool:
    """conv+ReLU+pool -> PECR is legal iff the triple is adjacent, the pool is
    non-overlapping (stride == p, not ceil mode) and the conv output tiles
    exactly (the fused epilogue floors)."""
    pool = unit.pool
    if pool is None or not unit.relu:
        return False
    if pool.s != pool.p or pool.mode == "ceil":
        return False
    _, oh, ow = unit.conv_out_shape
    return oh % pool.p == 0 and ow % pool.p == 0


def fused_impl(conv_impl: str) -> str | None:
    """The kind-"conv_pool" impl of `conv_impl`'s family (None = no fusion)."""
    return get_op("conv", conv_impl).fused_with


def conv_impl(fused: str) -> str:
    """The kind-"conv" impl a fused impl falls back to on unfusable units."""
    op = get_op("conv_pool", fused)
    if op.fused_with is None:
        raise ValueError(f"fused impl {fused!r} declares no conv fallback")
    return op.fused_with


def unit_impl(unit: ConvUnit, impl: str) -> tuple:
    """Resolve a requested impl against one unit's structure -> (kind, impl):
    a fused-family request becomes the fused op on fusion-eligible units and
    the family's plain conv elsewhere; a plain conv request passes through."""
    if ("conv_pool", impl) in _OPS:
        if fusion_eligible(unit):
            return ("conv_pool", impl)
        return ("conv", conv_impl(impl))
    get_op("conv", impl)  # validate
    return ("conv", impl)


# ---------------------------------------------------------------------------
# Cost dispatch (the one place a unit is costed as a (kind, impl))
# ---------------------------------------------------------------------------


def _pool_round_trip(base: dict, pool: int, dtype_bytes: int = 4) -> dict:
    """Cost of an unfused pool after a conv whose cost is `base`: the
    intermediate write and read and the pooled write that PECR fusion
    deletes, plus the pool's max."""
    conv_out = base["out_elems"] * dtype_bytes
    return {"flops": base["flops"] + base["out_elems"],
            "bytes": base["bytes"] + conv_out + conv_out / (pool * pool),
            "out_elems": base["out_elems"] // (pool * pool)}


def unit_cost(kind: str, impl: str, *, c, h, w, o, k, stride=1, pool=None,
              occupancy: float = 1.0, weight_density: float = 1.0,
              batch: int = 1) -> dict:
    """Modeled {"flops","bytes","out_elems"} of one conv unit executed as
    (kind, impl). h/w are the padded input dims; `pool` is the unit's pool
    window (None = no pool). A kind-"conv" impl with an adjacent pool is
    costed as its own hook plus the unfused round trip; a kind-"conv_pool"
    impl consumes the pool in its hook. Occupancy / weight_density reach
    only hooks whose impl declares that sparsity."""
    op = get_op(kind, impl)
    kws = dict(stride=stride, batch=batch,
               occupancy=occupancy if op.sparse else 1.0)
    if op.weight_sparse:
        kws["weight_density"] = weight_density
    if pool is not None and kind != "conv_pool":
        return _pool_round_trip(op.cost(c, h, w, o, k, k, **kws), pool)
    if pool is not None:
        kws["pool"] = pool
    return op.cost(c, h, w, o, k, k, **kws)


def unit_model_us(kind: str, impl: str, unit: ConvUnit, *,
                  occupancy: float = 1.0, weight_density: float = 1.0,
                  batch: int = 1, block_c: int = 0, tile=None,
                  calibration=None) -> float:
    """Roofline-modeled time (us) of executing `unit` as (kind, impl).

    `calibration` (a `repro_torch.obs.calibrate.CalibrationDB`, or None)
    supplies measured effective constants per (device kind, kind, impl, tile
    geometry); a key the DB does not cover, and calibration=None, divide by
    `constants.DEFAULT_ROOFLINE` (read at call time). `block_c` is the
    plan's channel-block size and `tile` the searched `TileConfig`: the
    geometry the calibration is keyed on."""
    conv = unit.conv
    c, h, w = unit.in_shape
    cost = unit_cost(kind, impl, c=c, h=h + 2 * conv.pad, w=w + 2 * conv.pad,
                     o=conv.c_out, k=conv.k, stride=conv.stride,
                     pool=unit.pool.p if unit.pool is not None else None,
                     occupancy=occupancy, weight_density=weight_density,
                     batch=batch)
    consts = constants.DEFAULT_ROOFLINE if calibration is None else \
        calibration.constants_for(kind, impl, block_c, tile=tile)
    return consts.time_us(cost["flops"], cost["bytes"])


# ---------------------------------------------------------------------------
# Launch descriptors
# ---------------------------------------------------------------------------


def _padded_unit_dims(unit):
    """(c, h, w, o, k, stride) of the op call `run_unit` makes for this unit."""
    c, h, w = unit.in_shape
    conv = unit.conv
    return c, h + 2 * conv.pad, w + 2 * conv.pad, conv.c_out, conv.k, conv.stride


def unit_launch(kind: str, impl: str, unit: ConvUnit, *, tile=None,
                block_c: int = 0, batch: int = 1):
    """The launch record of running `unit` as (kind, impl) at `tile` (None =
    defaults), None for an impl without one."""
    op = get_op(kind, impl)
    if op.launch is None:
        return None
    return op.launch(unit, tile=tile, block_c=block_c, batch=batch)


# ---------------------------------------------------------------------------
# Registrations
# ---------------------------------------------------------------------------


def _conv_dense(xp, w, *, stride, block_c=0, tile=None):
    from repro_torch.core.ecr import conv2d_dense

    return conv2d_dense(xp, w, stride)


def _conv_im2col(xp, w, *, stride, block_c=0, tile=None):
    from repro_torch.core.ecr import conv2d_im2col

    return conv2d_im2col(xp, w, stride)


def _conv_ecr(xp, w, *, stride, block_c=0, tile=None):
    from repro_torch.core.ecr import conv2d_ecr

    return conv2d_ecr(xp, w, stride)


def _conv_ecr_pallas(xp, w, *, stride, block_c=0, tile=None):
    from repro_torch.kernels.ecr_conv.ops import ecr_conv
    from repro_torch.kernels.tiles import as_tile

    t = as_tile(tile, block_c)
    return ecr_conv(xp, w, stride, block_c=t.block_c, block_o=t.block_o)


def _conv_pool_unfused(xp, w, *, stride, pool, block_c=0, tile=None):
    from repro_torch.core.pecr import conv_pool_unfused

    return conv_pool_unfused(xp, w, stride, pool.p, pool.s)


def _conv_pool_pecr(xp, w, *, stride, pool, block_c=0, tile=None):
    from repro_torch.core.pecr import conv_pool_pecr

    return conv_pool_pecr(xp, w, stride, pool.p, pool.s)


def _conv_pool_pecr_pallas(xp, w, *, stride, pool, block_c=0, tile=None):
    from repro_torch.kernels.conv_pool.ops import fused_conv_pool
    from repro_torch.kernels.tiles import as_tile

    t = as_tile(tile, block_c)
    return fused_conv_pool(xp, w, stride, pool.p, p_s=pool.s, block_c=t.block_c,
                           block_o=t.block_o)


def _conv_cost(c, h, w, o, kh, kw, **kw_args):
    from repro_torch.kernels.ecr_conv.ops import ecr_conv_cost

    return ecr_conv_cost(c, h, w, o, kh, kw, **kw_args)


def _conv_pool_unfused_cost(c, h, w, o, kh, kw, *, pool=2, dtype_bytes=4, **kw_args):
    """Unfused conv -> ReLU -> pool: the conv cost plus the round trip PECR
    deletes (`_pool_round_trip` over the conv hook)."""
    from repro_torch.kernels.ecr_conv.ops import ecr_conv_cost

    return _pool_round_trip(
        ecr_conv_cost(c, h, w, o, kh, kw, dtype_bytes=dtype_bytes, **kw_args),
        pool, dtype_bytes)


def _conv_pool_cost(c, h, w, o, kh, kw, **kw_args):
    from repro_torch.kernels.conv_pool.ops import conv_pool_cost

    return conv_pool_cost(c, h, w, o, kh, kw, **kw_args)


def _launch_ecr(unit, *, tile=None, block_c=0, batch=1):
    from repro_torch.kernels.ecr_conv.ops import ecr_conv_launch
    from repro_torch.kernels.tiles import as_tile

    c, h, w, o, k, stride = _padded_unit_dims(unit)
    return ecr_conv_launch(c, h, w, o, k, k, stride=stride,
                           tile=as_tile(tile, block_c), batch=batch)


def _conv_bsr(xp, w, *, stride, block_c=0, tile=None):
    from repro_torch.sparse_weights.conv import conv2d_bsr

    return conv2d_bsr(xp, w, stride, tile=tile if tile else None)


def _bsr_cost(c, h, w, o, kh, kw, **kw_args):
    from repro_torch.sparse_weights.conv import bsr_conv_cost

    return bsr_conv_cost(c, h, w, o, kh, kw, **kw_args)


def _conv_ecr_int8(xp, w, *, stride, block_c=0, tile=None):
    from repro_torch.kernels.tiles import as_tile
    from repro_torch.quant.ops import ecr_conv_int8

    return ecr_conv_int8(xp, w, stride, block_c=as_tile(tile, block_c).block_c)


def _conv_bsr_int8(xp, w, *, stride, block_c=0, tile=None):
    from repro_torch.quant.ops import conv2d_bsr_int8

    return conv2d_bsr_int8(xp, w, stride, tile=tile if tile else None)


def _ecr_int8_cost(c, h, w, o, kh, kw, **kw_args):
    from repro_torch.quant.ops import ecr_conv_int8_cost

    return ecr_conv_int8_cost(c, h, w, o, kh, kw, **kw_args)


def _bsr_int8_cost(c, h, w, o, kh, kw, **kw_args):
    from repro_torch.quant.ops import bsr_conv_int8_cost

    return bsr_conv_int8_cost(c, h, w, o, kh, kw, **kw_args)


def _launch_pecr(unit, *, tile=None, block_c=0, batch=1):
    from repro_torch.kernels.conv_pool.ops import conv_pool_launch
    from repro_torch.kernels.tiles import as_tile

    c, h, w, o, k, stride = _padded_unit_dims(unit)
    return conv_pool_launch(c, h, w, o, k, k, stride=stride,
                            pool=unit.pool.p if unit.pool is not None else 0,
                            tile=as_tile(tile, block_c), batch=batch)


def _bsr_unit_dims(unit, batch):
    """(o, k_taps, p) of the BSR lowering of `unit` at `batch`."""
    c, _, _, o, k, _ = _padded_unit_dims(unit)
    _, oh, ow = unit.conv_out_shape
    return o, c * k * k, batch * oh * ow


def _launch_bsr(unit, *, tile=None, block_c=0, batch=1):
    from repro_torch.sparse_weights.conv import bsr_conv_launch

    return bsr_conv_launch(*_bsr_unit_dims(unit, batch), tile=tile if tile else None)


def _launch_ecr_int8(unit, *, tile=None, block_c=0, batch=1):
    from repro_torch.kernels.tiles import as_tile
    from repro_torch.quant.ops import ecr_conv_int8_launch

    c, h, w, o, k, stride = _padded_unit_dims(unit)
    return ecr_conv_int8_launch(c, h, w, o, k, k, stride=stride,
                                tile=as_tile(tile, block_c), batch=batch)


def _launch_bsr_int8(unit, *, tile=None, block_c=0, batch=1):
    from repro_torch.quant.ops import bsr_conv_int8_launch

    return bsr_conv_int8_launch(*_bsr_unit_dims(unit, batch),
                                tile=tile if tile else None)


register_op(OpImpl("conv", "dense", _conv_dense, cost=_conv_cost))
register_op(OpImpl("conv", "im2col", _conv_im2col, cost=_conv_cost))
register_op(OpImpl("conv", "ecr", _conv_ecr, cost=_conv_cost, sparse=True,
                   fused_with="pecr"))
register_op(OpImpl("conv", "ecr_pallas", _conv_ecr_pallas, cost=_conv_cost,
                   sparse=True, pallas=True, fused_with="pecr_pallas",
                   launch=_launch_ecr))
register_op(OpImpl("conv", "bsr", _conv_bsr, cost=_bsr_cost,
                   weight_sparse=True, pallas=True, launch=_launch_bsr))
register_op(OpImpl("conv", "ecr_int8", _conv_ecr_int8, cost=_ecr_int8_cost,
                   sparse=True, pallas=True, quantized=True,
                   launch=_launch_ecr_int8))
register_op(OpImpl("conv", "bsr_int8", _conv_bsr_int8, cost=_bsr_int8_cost,
                   weight_sparse=True, pallas=True, quantized=True,
                   launch=_launch_bsr_int8))
register_op(OpImpl("conv_pool", "unfused", _conv_pool_unfused,
                   cost=_conv_pool_unfused_cost))
register_op(OpImpl("conv_pool", "pecr", _conv_pool_pecr, cost=_conv_pool_cost,
                   sparse=True, fused_with="ecr"))
register_op(OpImpl("conv_pool", "pecr_pallas", _conv_pool_pecr_pallas,
                   cost=_conv_pool_cost, sparse=True, pallas=True,
                   fused_with="ecr_pallas", launch=_launch_pecr))
