"""Collective byte accounting for the roofline (counterpart of
`repro.launch.hlo_analysis`).

The reference sums the result-shape bytes of every communication op in a
program's post-partitioning HLO. The port has no HLO: `collective_stats`
runs the function once and sums the result bytes of every c10d collective
this rank dispatches, by the reference's kind names, read off the same
dispatch-level counter as `hlo_cost.analyze`. What it records is the
per-rank payload entering the interconnect; ring factors belong to the
roofline's constants, as in the reference.
"""
from __future__ import annotations

from repro_torch.launch import hlo_cost


def collective_stats(fn, *args, **kwargs) -> dict:
    """{"bytes_by_kind", "counts", "total_bytes"} of the collectives one call
    `fn(*args, **kwargs)` dispatches."""
    a = hlo_cost.analyze(fn, *args, **kwargs)
    return {"bytes_by_kind": a["collective_bytes_by_kind"],
            "counts": a["collective_counts"],
            "total_bytes": a["collective_bytes"]}
