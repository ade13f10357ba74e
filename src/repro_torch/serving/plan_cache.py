"""Plan cache: one built runner per (bucket, plan) key (counterpart of
`repro.serving.plan_cache`).

The key is (batch bucket, block_c, per-layer (kind, impl) decisions, graph
signature, weight signature, tile signature, mesh shape): the measured occupancies only
reach the executed program through which side of `occ_threshold` each layer
fell, so two re-plans whose occupancies drifted but whose schedules agree
share one entry. The weight signature lists each weight-sparse (BSR) layer
with its block density rounded to 2 dp, so two pruned variants of one graph
with the same decisions (the models `Engine.hot_swap` moves between) each
get a runner built for their own plan; every dense, ECR or PECR plan keeps
the key it had before. The tile signature lists each layer whose plan
carries a searched `TileConfig`, so a plan that differs only in kernel
geometry gets a runner of its own; a plan at the default geometry keeps the
key it had before. The mesh shape is the data mesh's ((axis, size), ...), ()
for no mesh or one slot: a sharded runner holds one captured runner per
slot, so one cache holds a schedule's 1..N-slot layouts side by side, and
every unsharded key is the one it was before.

The reference compiles each key ahead of time with XLA. Here the engine's
build is a `graph_runner.CompiledRunner`: the plan verified against the
params once and, on the card, the whole-batch executor captured as one CUDA
graph. `compiles` counts builds, one per distinct key as in the reference.
The cache's runners share one `GraphPool` per mesh slot (`pools`; slot 0's,
which every unsharded runner uses, is `graphs`): one CUDA graph memory
pool, the weight slots, and the capture and replay counters. Evicting an
entry releases its graphs.
"""
from __future__ import annotations

from collections import OrderedDict
from dataclasses import dataclass

from repro_torch.serving.graph_runner import GraphPool


@dataclass(frozen=True)
class PlanKey:
    bucket: int  # padded batch size the runner serves
    block_c: int  # the plan's channel-block size (0 = per-layer auto)
    occ_sig: tuple  # per-layer (kind, impl) decisions — the occupancy bucket
    graph_sig: tuple  # LayerGraph.signature() — the network's structure
    weight_sig: tuple = ()  # (layer index, rounded density) per BSR layer
    tile_sig: tuple = ()  # (layer index, TileConfig.key()) per tiled layer
    mesh_shape: tuple = ()  # ((axis, size), ...) of the data mesh; () = 1 slot


def plan_key(bucket: int, plan, mesh=None) -> PlanKey:
    """The cache key of executing `plan` at batch size `bucket` on `mesh`
    (None or a 1-slot mesh key as `()`). Only weight-sparse layers enter
    `weight_sig` (density rounded to 2 dp, the granularity pruning
    achieves), and only layers with a non-default tile enter `tile_sig`."""
    from repro_torch.graph.registry import get_op

    mesh_shape = () if mesh is None or mesh.size == 1 else tuple(
        (str(a), int(s)) for a, s in mesh.shape.items())

    weight_sig = tuple((lp.index, round(lp.weight_density, 2)) for lp in plan.layers
                       if get_op(lp.kind, lp.impl).weight_sparse)
    tile_sig = tuple((lp.index, lp.tile.key()) for lp in plan.layers
                     if getattr(lp, "tile", None) is not None and lp.tile)
    return PlanKey(bucket=int(bucket), block_c=int(plan.block_c),
                   occ_sig=tuple((lp.kind, lp.impl) for lp in plan.layers),
                   graph_sig=plan.graph.signature(), weight_sig=weight_sig,
                   tile_sig=tile_sig, mesh_shape=mesh_shape)


class PlanCache:
    """LRU cache of built runners, with hit/miss/build counters."""

    def __init__(self, max_entries: int = 32):
        self.max_entries = max_entries
        self._entries: OrderedDict = OrderedDict()  # PlanKey -> (runner, plan)
        self.pools = [GraphPool()]  # what this cache's runners share, per mesh slot
        self.compiles = 0
        self.hits = 0
        self.misses = 0
        self.evictions = 0

    @property
    def graphs(self) -> GraphPool:
        """Slot 0's pool: the one every unsharded runner uses."""
        return self.pools[0]

    def slot_pools(self, n: int) -> list:
        """The pools of mesh slots 0..n-1, made on first use."""
        while len(self.pools) < n:
            self.pools.append(GraphPool())
        return self.pools[:n]

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
            _, (old, _) = self._entries.popitem(last=False)
            release = getattr(old, "release", None)
            if release is not None:
                release()  # a runner frees its graphs
            self.evictions += 1
        return exe

    def stats(self) -> dict:
        return {"entries": len(self._entries), "compiles": self.compiles,
                "hits": self.hits, "misses": self.misses,
                "evictions": self.evictions}
