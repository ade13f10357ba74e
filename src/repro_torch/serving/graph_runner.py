"""Compiled CNN runners: one CUDA graph per plan-cache key (the port's
counterpart of the reference's `jax.jit(_make_runner(plan)).lower(params,
imgs, n_valid).compile()` in `repro.serving.engine.Engine._executable`).

A `CompiledRunner` is the whole-batch executor of one (bucket, plan) pair.
Building it:
- verifies the plan against the params once (`pipeline.validate_plan` at the
  bucket, which runs `analysis.assert_plan_ok`), as the reference checks
  once when it traces;
- allocates static inputs on the device: a (bucket, C, H, W) fp32 image
  buffer, a 0-dim int32 `n_valid`, and copies of the weights
  (`ParamSlots`);
- on the card, runs the body (`pipeline.run_plan_unchecked` with the
  occupancy statistic) on a side stream to warm it up, then captures it on
  that stream into one CUDA graph, in thread-local capture mode: the
  engine's background re-plan runs CUDA work of its own meanwhile.

A call `(params, imgs, n_valid)` copies the images and the count into the
static inputs (and the weights, when `params` is not what the slots hold),
replays the graph and returns clones of the logits and occupancies: the
next replay overwrites the static outputs. On the CPU the same object keeps
the same static buffers and "replays" by running the body eagerly on them.

A capture refuses every host read (`.item()`, `.tolist()`, a synchronize).
A failed capture raises, with the plan key in the exception's notes, and
nothing serves eagerly in its place.

The runners of one plan cache share a `GraphPool`: one CUDA graph memory
pool, the weight slots of each params layout (a hot swap copies the new
weights once, and every runner of that layout reads them), and the
counters. Sharing the pool is safe because the engine replays one graph at
a time on one stream, and every runner has its own static inputs and clones
its outputs before the next replay. The kernel wrappers count launches
(`.launches`) only while the body runs in Python, at warm-up and capture;
each replay adds the launches its capture recorded to
`GraphPool.replay_launches`.

A `ShardedRunner` is the executor of one (bucket, plan) pair over a 1-D
"data" mesh (`repro_torch.parallel`), the counterpart of the reference's
runner under `shard_map`: one `CompiledRunner` per mesh slot at the
bucket's slice of rows, each with its own CUDA graph, its slot's pool and
weight slots on its slot's device. Its runners are replayed back to back,
then their logits gathered and their occupancies aggregated
(`pipeline.planner.aggregate_occupancy`).
"""
from __future__ import annotations

import time

import torch

from repro_torch.graph.ir import graph_weights
from repro_torch.kernels.cuda import recording_launches
from repro_torch.pipeline.planner import (
    aggregate_occupancy,
    run_plan_unchecked,
    shard_n_valid,
    shard_rows,
    slot_params,
    validate_plan,
)

WARMUP_CALLS = 2  # eager runs on the capture stream before the capture


def _weights(params) -> list:
    conv, dense = graph_weights(params)
    return list(conv) + list(dense)


def params_layout(params) -> tuple:
    """The layout a set of weight slots holds: the conv weight count, and
    each weight's shape, dtype and device."""
    conv, _ = graph_weights(params)
    return (len(conv),) + tuple((tuple(w.shape), w.dtype, w.device)
                                for w in _weights(params))


class ParamSlots:
    """Static copies of one params layout, the weights every captured graph
    of that layout reads. `bind` refills them from another params object, or
    from the same tensors once they were changed in place."""

    def __init__(self, params):
        conv, dense = graph_weights(params)
        with torch.no_grad():
            self.params = {"conv": [w.detach().clone() for w in conv],
                           "dense": [w.detach().clone() for w in dense]}
        self.layout = params_layout(params)
        self._bound = [(w, w._version) for w in _weights(params)]
        self.copies = 0  # binds that copied (the first fill is the clone)

    def bind(self, params) -> bool:
        """Load `params` into the slots unless they hold them already.
        Returns whether it copied."""
        src = _weights(params)
        if len(src) == len(self._bound) and all(
                w is b and w._version == v for w, (b, v) in zip(src, self._bound)):
            return False
        if params_layout(params) != self.layout:
            raise ValueError("params do not have the layout this runner was "
                             "captured for (weight count, shapes, dtypes, device)")
        with torch.no_grad():
            for slot, w in zip(self.params["conv"] + self.params["dense"], src):
                slot.copy_(w)
        self._bound = [(w, w._version) for w in src]
        self.copies += 1
        return True


class GraphPool:
    """What the runners of one plan cache share: the CUDA graph memory pool,
    the weight slots per params layout, and the counters (`captures`;
    `replay_launches`, by kernel wrapper name, the launches the replays
    stand for)."""

    def __init__(self):
        self._handle = None
        self._slots: dict = {}
        self.captures = 0
        self.replay_launches: dict = {}

    def handle(self):
        """The pool's handle (`torch.cuda.graph_pool_handle`), made on first use."""
        if self._handle is None:
            self._handle = torch.cuda.graph_pool_handle()
        return self._handle

    def slots(self, params) -> ParamSlots:
        """The weight slots of `params`' layout, made (holding `params`) on
        first use."""
        layout = params_layout(params)
        if layout not in self._slots:
            self._slots[layout] = ParamSlots(params)
        return self._slots[layout]

    def nbytes(self) -> int:
        """Device memory held by the pool's segments (0 before a capture)."""
        if self._handle is None:
            return 0
        pool = tuple(self._handle)
        return sum(seg["total_size"] for seg in torch.cuda.memory_snapshot()
                   if tuple(seg.get("segment_pool_id", ())) == pool)


class CompiledRunner:
    """The whole-batch executor of `plan` at `bucket` images on `device`: one
    CUDA graph on the card, the eager body on the CPU (module docstring).
    `pool` is the plan cache's `GraphPool` (None: a private one)."""

    def __init__(self, plan, params, bucket: int, device, pool: GraphPool | None = None):
        from repro_torch.serving.plan_cache import plan_key

        self.plan = plan
        self.bucket = int(bucket)
        self.key = plan_key(self.bucket, plan)
        self.pool = pool if pool is not None else GraphPool()
        c, h, w = plan.layers[0].in_shape
        self._imgs = torch.zeros((self.bucket, c, h, w), dtype=torch.float32,
                                 device=torch.device(device))
        self.device = self._imgs.device
        self._nv = torch.full((), self.bucket, dtype=torch.int32, device=self.device)
        validate_plan(plan, params, self._imgs)
        self.slots = self.pool.slots(params)
        self.slots.bind(params)
        self.launches_per_replay: dict = {}
        self.replays = 0
        self.capture_s = 0.0  # warm-up and capture, host wall
        self._graph = None
        self._out = None
        try:
            self._capture()
        except Exception as e:
            e.add_note(f"while capturing the runner of {self.key}")
            raise

    def bind(self, params) -> bool:
        """Load `params` into the weight slots (`ParamSlots.bind`)."""
        return self.slots.bind(params)

    def _body(self):
        return run_plan_unchecked(self.plan, self.slots.params, self._imgs,
                                  collect_occupancy=True, n_valid=self._nv)

    def _capture(self) -> None:
        t0 = time.perf_counter()
        with torch.no_grad():
            if self.device.type != "cuda":
                self._out = self._body()  # the static outputs eager replays refill
                return
            stream = torch.cuda.Stream(self.device)
            stream.wait_stream(torch.cuda.current_stream(self.device))
            with torch.cuda.stream(stream):
                for _ in range(WARMUP_CALLS):
                    self._body()
            graph = torch.cuda.CUDAGraph()
            with recording_launches() as launches:
                with torch.cuda.graph(graph, pool=self.pool.handle(), stream=stream,
                                      capture_error_mode="thread_local"):
                    self._out = self._body()
        self._graph = graph
        self.launches_per_replay = launches
        self.pool.captures += 1
        self.capture_s = time.perf_counter() - t0

    def __call__(self, params, imgs: torch.Tensor, n_valid):
        """(logits (bucket, classes), occupancies (layers,)) of `imgs`, the
        occupancy over the first `n_valid` samples (an int or a 0-dim
        tensor)."""
        if self._out is None:
            raise RuntimeError(f"the runner of {self.key} was released")
        want = self._imgs
        if (tuple(imgs.shape) != tuple(want.shape) or imgs.dtype != want.dtype
                or imgs.device != want.device):
            raise ValueError(f"the runner of bucket {self.bucket} takes "
                             f"{tuple(want.shape)} {want.dtype} images on {want.device}, "
                             f"got {tuple(imgs.shape)} {imgs.dtype} on {imgs.device}")
        self.slots.bind(params)
        self._imgs.copy_(imgs)
        if isinstance(n_valid, torch.Tensor):
            self._nv.copy_(n_valid)
        else:
            self._nv.fill_(int(n_valid))
        self._replay()
        logits, occs = self._out
        return logits.clone(), occs.clone()

    def _replay(self) -> None:
        """Run the body once on the static buffers: the graph on the card,
        eagerly (into the static outputs) on the CPU."""
        if self._graph is None:
            with torch.no_grad():
                for out, new in zip(self._out, self._body()):
                    out.copy_(new)
            return
        self._graph.replay()
        self.replays += 1
        counts = self.pool.replay_launches
        for name, n in self.launches_per_replay.items():
            counts[name] = counts.get(name, 0) + n

    def release(self) -> None:
        """Free the graph and the static outputs (the plan cache evicted the
        runner); a later call raises."""
        if self._graph is not None:
            self._graph.reset()
        self._graph = None
        self._out = None


class ShardedRunner:
    """The whole-batch executor of `plan` at `bucket` images over the 1-D
    "data" mesh `mesh` (module docstring): slot i's `CompiledRunner` runs
    rows [i*bucket/N, (i+1)*bucket/N) on `mesh.slots[i]` with the params
    placed there once (`slot_params`). `pools` are the slots' `GraphPool`s
    (None: private ones). A call returns (logits (bucket, classes) on slot
    0's device, occupancies (layers,) aggregated over the shards by their
    real samples)."""

    def __init__(self, plan, params, bucket: int, mesh, pools=None):
        from repro_torch.serving.plan_cache import plan_key

        self.bucket = int(bucket)
        self.mesh = mesh
        self.key = plan_key(self.bucket, plan, mesh)
        self.rows = shard_rows(mesh, (self.bucket,))
        slots = mesh.slots
        pools = pools if pools is not None else [GraphPool() for _ in slots]
        self.runners = []
        for i, (dev, pool) in enumerate(zip(slots, pools)):
            try:
                self.runners.append(CompiledRunner(plan, slot_params(params, mesh, dev),
                                                   self.rows, dev, pool=pool))
            except Exception as e:
                e.add_note(f"while building slot {i} ({dev}) of the runner of {self.key}")
                self.release()
                raise

    def bind(self, params) -> bool:
        """Load `params` into every slot's weight slots. Returns whether any
        copied."""
        copied = [r.bind(slot_params(params, self.mesh, r.device)) for r in self.runners]
        return any(copied)

    def __call__(self, params, imgs: torch.Tensor, n_valid):
        """(logits, occupancies) of `imgs` (bucket, C, H, W), the occupancy
        over the first `n_valid` samples (an int or a 0-dim tensor)."""
        if imgs.ndim != 4 or int(imgs.shape[0]) != self.bucket:
            raise ValueError(f"the sharded runner of bucket {self.bucket} takes "
                             f"{self.bucket} images, got shape {tuple(imgs.shape)}")
        rows = self.rows
        logits, occs, weights = [], [], []
        for i, r in enumerate(self.runners):
            nv = shard_n_valid(n_valid, i, rows, r.device)
            out, occ = r(slot_params(params, self.mesh, r.device),
                         imgs[i * rows:(i + 1) * rows].to(r.device), nv)
            logits.append(out)
            occs.append(occ)
            weights.append(nv)
        dev0 = logits[0].device
        return torch.cat([o.to(dev0) for o in logits]), aggregate_occupancy(occs, weights)

    def release(self) -> None:
        """Free every slot's graph (the plan cache evicted the runner)."""
        for r in self.runners:
            r.release()
