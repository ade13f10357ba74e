"""Graph / plan / params invariants, the RPA2xx / RPA3xx checks (counterpart
of `repro.analysis.plan`).

`check_plan` re-derives what a `PipelinePlan` claims from first principles
(shape inference over its graph, the registry's fusion rule, the port's
tile-conformance rules in `kernels/tiles.py`, the launch record of every
kernel layer through the registry's `unit_launch`, the params' measured
weight density) and reports each disagreement as a `Diagnostic`. Nothing
here launches a kernel: it is arithmetic over the plan's static fields plus,
for BSR layers, the params' block density and weight schedule.

PyTorch runs eagerly, so the params are always concrete and the
value-dependent checks (BSR density, static weight schedules) always run;
the reference skips them under a jit trace.
"""
from __future__ import annotations

from repro_torch.analysis.diagnostics import DiagnosticSink
from repro_torch.analysis.launch import check_launch
from repro_torch.analysis.schedules import check_schedule
from repro_torch.graph.ir import graph_weights
from repro_torch.graph.registry import fusion_eligible, get_op, unit_launch
from repro_torch.kernels.tiles import CUDA_BSR_BT, BsrLaunch, ConvLaunch, resolve_block_o


def _check_tile_conformance(lp, unit, op, sink) -> None:
    """RPA204: a requested tile dimension the port's resolvers will not
    honour (they fall back to the default for that dimension). The plan
    still runs, just not at the geometry it recorded. The rules are the
    port's: block_c is honoured iff 0 < block_c <= max(8, c) (the
    reference's rule); the fp32 ECR / PECR output tile iff it is 64 or 128
    and at most max(8, o) (`resolve_block_o`), and the int8 conv kernel's
    output tile is fixed; BSR bt must be the kernels' 8 rows and bf is
    honoured iff 0 < bf <= max(8, K); bd has no counterpart (the kernels
    tile the columns themselves), so a requested bd is never honoured."""
    tile = lp.tile
    if tile is None or not tile or op.launch is None:
        return  # no request, or an impl without a kernel
    loc = dict(layer=lp.index, kind=lp.kind, impl=lp.impl)
    c = unit.in_shape[0]
    o = unit.conv.c_out
    if op.weight_sparse:
        k_taps = c * unit.conv.k * unit.conv.k
        if tile.bt and tile.bt != CUDA_BSR_BT:
            sink.add("RPA204",
                     f"requested bt={tile.bt}: the CUDA BSR kernels take "
                     f"{CUDA_BSR_BT}-row blocks only and fall back to it",
                     **loc)
        if tile.bf and not 0 < tile.bf <= max(8, k_taps):
            sink.add("RPA204",
                     f"requested bf={tile.bf} does not conform to extent "
                     f"{k_taps} (honoured iff 0 < bf <= max(8, {k_taps})); "
                     f"the kernel falls back to its default", **loc)
        if tile.bd:
            sink.add("RPA204",
                     f"requested bd={tile.bd} is ignored: the CUDA BSR "
                     f"kernels tile the columns themselves", **loc)
        return
    if tile.block_c and not 0 < tile.block_c <= max(8, c):
        sink.add("RPA204",
                 f"requested block_c={tile.block_c} does not conform to "
                 f"c={c} (honoured iff 0 < block_c <= max(8, {c})); the "
                 f"op falls back to the default block", **loc)
    if tile.block_o:
        if op.quantized:
            sink.add("RPA204",
                     f"requested block_o={tile.block_o} is ignored: the int8 "
                     f"conv kernel's output tile is fixed at 128", **loc)
        elif resolve_block_o(o, tile.block_o) != tile.block_o:
            sink.add("RPA204",
                     f"requested block_o={tile.block_o} does not conform to "
                     f"o={o} (honoured iff it is 64 or 128 and <= max(8, "
                     f"{o})); the kernel picks its own output tile", **loc)


def _check_bsr_schedule(lp, w, launch, sink) -> None:
    """RPA207 for the static axis: the (ids, cnt) weight schedule a BSR
    layer runs is a pure function of the params, so it is derived and
    verified here."""
    from repro_torch.kernels.bsr_matmul.ops import block_schedule
    from repro_torch.sparse_weights.format import conv_weight_matrix

    ids, cnt = block_schedule(conv_weight_matrix(w), launch.bt, launch.bf)
    check_schedule(ids, cnt, launch.nf, sink, layer=lp.index, kind=lp.kind,
                   impl=lp.impl)


def check_plan(plan, params=None, graph=None, batch: int = 1) -> list:
    """Verify a `PipelinePlan` (and optionally its params / graph) without
    executing it. Returns the full diagnostic list; `verify.assert_plan_ok`
    turns error-severity findings into a raise.

    `graph` is a fallback `LayerGraph` for a plan that carries none
    (plan.graph wins); `batch` sizes the launch records' grid. `params` may
    be absent (a structure-only check, the PlanCache case)."""
    sink = DiagnosticSink()

    # --- plan-level sanity (RPA201 / RPA209) -----------------------------
    if not getattr(plan, "layers", None):
        sink.add("RPA201", "run_plan got an empty PipelinePlan (no layers)")
        return sink.items
    if plan.block_c < 0:
        sink.add("RPA209",
                 f"PipelinePlan.block_c must be >= 0 (0 = auto), "
                 f"got {plan.block_c}")

    # --- per-layer checks -------------------------------------------------
    units = {}
    for lp in plan.layers:
        loc = dict(layer=lp.index, kind=lp.kind, impl=lp.impl)
        if not 0.0 <= lp.occupancy <= 1.0:
            sink.add("RPA209",
                     f"occupancy {lp.occupancy} outside [0, 1]", **loc)
        if not 0.0 <= lp.weight_density <= 1.0:
            sink.add("RPA209",
                     f"weight_density {lp.weight_density} outside [0, 1]",
                     **loc)
        try:
            op = get_op(lp.kind, lp.impl)
        except ValueError as e:
            sink.add("RPA208", str(e), **loc)
            continue
        try:
            unit = lp.to_unit()
        except ValueError as e:
            sink.add("RPA201", str(e), **loc)  # "predates the LayerGraph IR"
            continue
        units[lp.index] = unit
        if lp.kind == "conv_pool" and not fusion_eligible(unit):
            sink.add("RPA203",
                     f"planned as fused conv+ReLU+pool but the unit fails "
                     f"the fusion rule (needs adjacent ReLU + pool, "
                     f"stride == p, exact tiling of the "
                     f"{unit.conv_out_shape[1]}x{unit.conv_out_shape[2]} "
                     f"conv output)",
                     hint="re-plan, or run conv + unfused pool", **loc)
        if op.quantized:
            rep = plan.int8_report
            if rep is None or lp.index not in getattr(rep, "layers", ()):
                sink.add("RPA206",
                         "int8 layer has no Int8Report entry: its accuracy "
                         "cost was never probed against the fp32 oracle",
                         hint="plan with plan_network(int8=True) so the "
                              "probe gates the placement", **loc)
        _check_tile_conformance(lp, unit, op, sink)
        if op.launch is not None:
            try:
                L = unit_launch(lp.kind, lp.impl, unit, tile=lp.tile,
                                block_c=plan.block_c, batch=batch)
            except ValueError as e:
                sink.add("RPA102", f"launch resolution failed: {e}", **loc)
                L = None
            check_launch(L, sink, **loc)

    # --- in-shape chain (each layer consumes its predecessor) -------------
    for prev, nxt in zip(plan.layers, plan.layers[1:]):
        if tuple(prev.out_shape) != tuple(nxt.in_shape):
            sink.add("RPA201",
                     f"plan/graph mismatch: conv_{nxt.index + 1} expects "
                     f"input {tuple(nxt.in_shape)} but conv_{prev.index + 1} "
                     f"produces {tuple(prev.out_shape)}",
                     layer=nxt.index, kind=nxt.kind, impl=nxt.impl)

    # --- graph cross-check (RPA201 / RPA202) ------------------------------
    g = plan.graph if plan.graph is not None else graph
    g_units = g_head = None
    if g is not None:
        try:
            g_units, g_head = g.units(), g.head()
        except ValueError as e:
            sink.add("RPA202", f"graph fails shape inference / topology "
                               f"validation: {e}")
    if g_units is not None:
        if len(g_units) != len(plan.layers):
            sink.add("RPA201",
                     f"plan has {len(plan.layers)} layers but its graph has "
                     f"{len(g_units)} conv units (plan/graph mismatch)")
        else:
            for lp, gu in zip(plan.layers, g_units):
                u = units.get(lp.index)
                if u is None:
                    continue
                drift = [f"{f}: plan {getattr(u, f)!r} vs graph "
                         f"{getattr(gu, f)!r}"
                         for f in ("conv", "relu", "pool", "in_shape",
                                   "out_shape")
                         if getattr(u, f) != getattr(gu, f)]
                if drift:
                    sink.add("RPA201",
                             "plan/graph mismatch: " + "; ".join(drift),
                             layer=lp.index, kind=lp.kind, impl=lp.impl)

    # --- params cross-check (RPA301 / RPA205 / static RPA207) -------------
    if params is None:
        return sink.items
    try:
        conv_ws, dense_ws = graph_weights(params)
    except Exception as e:
        sink.add("RPA301", f"params not readable as graph weights: {e}")
        return sink.items
    if len(conv_ws) != len(plan.layers):
        sink.add("RPA301",
                 f"plan has {len(plan.layers)} conv layers but params carry "
                 f"{len(conv_ws)} conv weights (zip would silently truncate)")
        return sink.items
    for lp, w in zip(plan.layers, conv_ws):
        loc = dict(layer=lp.index, kind=lp.kind, impl=lp.impl)
        if w.ndim != 4:
            sink.add("RPA301",
                     f"conv weight has {w.ndim} dims, want (O, C, kh, kw)",
                     **loc)
            continue
        if w.shape[1] != lp.in_shape[0]:
            sink.add("RPA301",
                     f"plan expects C_in={lp.in_shape[0]}, weight has "
                     f"C_in={w.shape[1]}", **loc)
        conv = lp.conv
        if conv.c_out and (w.shape[0] != conv.c_out
                           or tuple(w.shape[2:]) != (conv.k, conv.k)):
            sink.add("RPA301",
                     f"plan's ConvSpec wants weight "
                     f"({conv.c_out}, {lp.in_shape[0]}, {conv.k}, {conv.k}) "
                     f"but params carry {tuple(w.shape)}", **loc)
        try:
            op = get_op(lp.kind, lp.impl)
        except ValueError:
            continue  # already an RPA208
        if op.weight_sparse:
            from repro_torch.sparse_weights.format import weight_block_density

            d = weight_block_density(w)
            if abs(d - lp.weight_density) > 0.1:
                sink.add("RPA205",
                         f"plan runs '{lp.impl}' at weight block density "
                         f"{lp.weight_density:.2f} but the params measure "
                         f"{d:.2f}: a BSR plan must execute with the "
                         f"pruned params it was planned over "
                         f"(re-run plan_network)", **loc)
            u = units.get(lp.index)
            if u is not None and op.launch is not None:
                try:
                    L = unit_launch(lp.kind, lp.impl, u, tile=lp.tile,
                                    block_c=plan.block_c, batch=batch)
                except ValueError:
                    L = None  # already an RPA102 above
                if L is not None and isinstance(L, BsrLaunch) \
                        and not [d for d in sink.items
                                 if d.code == "RPA101" and d.layer == lp.index]:
                    _check_bsr_schedule(lp, w, L, sink)
    if g_head is not None and len(dense_ws) != len(g_head):
        sink.add("RPA301",
                 f"graph head has {len(g_head)} dense layers but params "
                 f"carry {len(dense_ws)} dense weights (zip would silently "
                 f"truncate)")
    return sink.items


def check_launch_descriptor(L) -> list:
    """Standalone launch-record check (ConvLaunch / BsrLaunch) -> diagnostics."""
    sink = DiagnosticSink()
    check_launch(L, sink)
    return sink.items


__all__ = ["check_plan", "check_launch_descriptor", "ConvLaunch", "BsrLaunch"]
