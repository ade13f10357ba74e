"""Plan cache: one built runner per (bucket, plan) key (counterpart of
`repro.serving.plan_cache`).

The key is (batch bucket, block_c, per-layer (kind, impl) decisions, graph
signature, weight signature, tile signature): the measured occupancies only
reach the executed program through which side of `occ_threshold` each layer
fell, so two re-plans whose occupancies drifted but whose schedules agree
share one entry. The weight signature lists each weight-sparse (BSR) layer
with its block density rounded to 2 dp, so two pruned variants of one graph
with the same decisions (the models `Engine.hot_swap` moves between) each
get a runner built for their own plan; every dense, ECR or PECR plan keeps
the key it had before. The tile signature lists each layer whose plan
carries a searched `TileConfig`, so a plan that differs only in kernel
geometry gets a runner of its own; a plan at the default geometry keeps the
key it had before.

The reference compiles each key ahead of time with XLA. PyTorch runs
eagerly, so a build here makes the runner closure once per key, and
`compiles` counts builds; capturing the runner as a CUDA graph is ROADMAP
queue 1, item 18. The reference's `mesh_shape` is item 13.
"""
from __future__ import annotations

from collections import OrderedDict
from dataclasses import dataclass


@dataclass(frozen=True)
class PlanKey:
    bucket: int  # padded batch size the runner serves
    block_c: int  # the plan's channel-block size (0 = per-layer auto)
    occ_sig: tuple  # per-layer (kind, impl) decisions — the occupancy bucket
    graph_sig: tuple  # LayerGraph.signature() — the network's structure
    weight_sig: tuple = ()  # (layer index, rounded density) per BSR layer
    tile_sig: tuple = ()  # (layer index, TileConfig.key()) per tiled layer


def plan_key(bucket: int, plan) -> PlanKey:
    """The cache key of executing `plan` at batch size `bucket`. Only
    weight-sparse layers enter `weight_sig` (density rounded to 2 dp, the
    granularity pruning achieves), and only layers with a non-default tile
    enter `tile_sig`."""
    from repro_torch.graph.registry import get_op

    weight_sig = tuple((lp.index, round(lp.weight_density, 2)) for lp in plan.layers
                       if get_op(lp.kind, lp.impl).weight_sparse)
    tile_sig = tuple((lp.index, lp.tile.key()) for lp in plan.layers
                     if getattr(lp, "tile", None) is not None and lp.tile)
    return PlanKey(bucket=int(bucket), block_c=int(plan.block_c),
                   occ_sig=tuple((lp.kind, lp.impl) for lp in plan.layers),
                   graph_sig=plan.graph.signature(), weight_sig=weight_sig,
                   tile_sig=tile_sig)


class PlanCache:
    """LRU cache of built runners, with hit/miss/build counters."""

    def __init__(self, max_entries: int = 32):
        self.max_entries = max_entries
        self._entries: OrderedDict = OrderedDict()  # PlanKey -> (runner, plan)
        self.compiles = 0
        self.hits = 0
        self.misses = 0
        self.evictions = 0

    def get_or_compile(self, key: PlanKey, plan, build):
        """Return the runner for `key`, building it via `build()` on a miss
        (exactly once per distinct key while the entry is resident).

        A miss verifies the plan first (`analysis.assert_plan_ok`, no
        params): a plan with an error-severity diagnostic raises
        `PlanVerificationError` before `build()` runs. Hits skip the check,
        since whatever is cached was verified; sentinel plans (None or no
        layers) used to exercise the cache alone are left alone."""
        if key in self._entries:
            self.hits += 1
            self._entries.move_to_end(key)
            return self._entries[key][0]
        self.misses += 1
        if plan is not None and getattr(plan, "layers", None):
            from repro_torch.analysis import assert_plan_ok

            assert_plan_ok(plan)
        exe = build()
        self.compiles += 1
        self._entries[key] = (exe, plan)
        if len(self._entries) > self.max_entries:
            self._entries.popitem(last=False)
            self.evictions += 1
        return exe

    def stats(self) -> dict:
        return {"entries": len(self._entries), "compiles": self.compiles,
                "hits": self.hits, "misses": self.misses,
                "evictions": self.evictions}
