"""Occupancy-adaptive serving engine over the static `PipelinePlan`
(counterpart of `repro.serving.engine`).

- Requests enter through the `MicroBatcher` (deadline-bounded power-of-two
  buckets); the ragged tail is padded with all-zero images, which the
  per-sample (ids, cnt) schedules skip at zero MAC cost.
- Each (bucket, plan) pair runs through ONE compiled runner from the
  `PlanCache` (`graph_runner.CompiledRunner`), built once per key: the plan
  is verified against the params when the runner is built and, on the
  card, the whole-batch executor is captured as one CUDA graph that every
  batch of that bucket replays. Runners are built at `warmup`, at a hot
  swap and at a re-plan's adoption, for every bucket the engine has served
  or warmed, so steady-state serving never captures; a bucket's first batch
  builds its runner only when no warmup covered it. A runner reads static
  copies of the weights: the swap points load the new params into them
  before they return.
- Every executed batch also measures the per-layer observed channel-block
  occupancy of its REAL samples and folds it into an EMA; when the EMA
  drifts out of the hysteresis band around the occupancies the plan was
  calibrated at, the engine re-plans on the most recent real batch
  (optionally in a background thread) and swaps the new plan in between
  batches.
- `hot_swap` replaces the served model (canonically a differently-pruned
  BSR variant) between batches; `PlanKey.weight_sig` keeps both variants'
  runners resident, so swapping back builds nothing. Every candidate plan
  (a hot swap's, an adopted re-plan's) is verified against the params it
  will run with before anything changes; a refused one is counted in
  `stats()["verify_rejects"]` and the current model keeps serving.
- With a data mesh of N > 1 slots (`mesh=`, `repro_torch.parallel`), a
  bucket is served data-parallel: the batcher's buckets are N-aligned, each
  slot runs its slice of the bucket through a captured runner of its own
  (`graph_runner.ShardedRunner`), the plan-cache keys carry the mesh shape,
  and the occupancy EMA reads the statistic aggregated over the shards by
  their real samples, so the drift detector sees all the traffic. It is
  one process and needs no collective: the shards' schedules are their
  own, and the statistic is summed on slot 0 after the gather.

Exactness contract, per bucket: a request's logits are bit-identical to
`run_plan` on the same bucket (the same images, padded with all-zero
samples to the bucket's size) whenever the co-batched samples share a
live-channel union (the compaction permutation is then
batch-composition-invariant); the all-zero pad samples never perturb the
union. Across buckets they can differ in the last bits on the card: cuDNN
picks its algorithm per batch size (up to 8.1e-10 between N=1 or 2 and N=8
on VGG-19 logits on an H100). On the host the dense layers are
batch-invariant too, as in the reference. Sharded, the bucket's slices are
the batches: a shard's logits are bitwise `run_plan` on its slice.

`int8=True` lets the first plan and every re-plan upgrade layers to the
int8 kernels under the probe's top-1 agreement budget `int8_budget`
(`plan_network(int8=...)`). `calibration=` and `tiles=` (`CalibrationDB`s)
price every plan the engine builds at measured constants and stamp the
searched tile winners on it; `tracer=` records plan / compile /
execute_batch / replan spans; `profile()` times the current plan per layer
and impl into `stats()["telemetry"]["profile"]`.

`use_pallas=False` plans the paper's methods as plain oracles ("ecr" /
"pecr"), as in the reference. Every plan the engine builds is verified by
the planner, and again by the plan cache before it builds a runner
(`repro_torch.analysis`).
"""
from __future__ import annotations

import threading
import time
from dataclasses import dataclass

import numpy as np
import torch

from repro_torch.device import resolve_device
from repro_torch.graph import as_graph
from repro_torch.graph.ir import graph_weights
from repro_torch.obs.trace import NULL_TRACER
from repro_torch.parallel.api import data_mesh, local_devices
from repro_torch.pipeline.planner import PipelinePlan, plan_network
from repro_torch.serving.batcher import MicroBatch, MicroBatcher, SimClock
from repro_torch.serving.graph_runner import CompiledRunner, ShardedRunner
from repro_torch.serving.metrics import MetricsTracker
from repro_torch.serving.plan_cache import PlanCache, plan_key


@dataclass(frozen=True)
class ServedResult:
    """One completed request: logits plus the latency-accounting timestamps
    (`t_formed` is when the batcher formed the request's bucket)."""

    id: int
    logits: np.ndarray  # (n_classes,)
    t_arrival: float
    t_done: float
    t_formed: float = 0.0

    @property
    def latency_s(self) -> float:
        return self.t_done - self.t_arrival


def auto_mesh(max_batch: int = 8, min_bucket: int = 2, devices=None):
    """The engine's mesh="auto" policy: a 1-D "data" mesh over the LARGEST
    prefix of `devices` (default `local_devices()`) whose size divides
    `max_batch` and leaves every shard at least `min_bucket` samples of a
    full bucket, the two constraints the batcher's device-aligned buckets
    enforce. Never raises for lack of devices: 3 devices at max_batch 8
    give 2, and 1 device is always acceptable."""
    devs = local_devices() if devices is None else list(devices)
    fits = [d for d in range(1, len(devs) + 1)
            if max_batch % d == 0 and max_batch // d >= min_bucket]
    return data_mesh(max(fits) if fits else 1, devices=devs)


class Engine:
    """Sparsity-aware serving engine for any planned LayerGraph conv stack
    (pass `graph=` or a legacy `CNNConfig`).

    Drive it with `submit()` + `poll()` (event loop), `drain()` (end of
    stream), or the synchronous convenience `serve(imgs)`. `device` (None =
    the card) is where requests are placed and must hold `params`.

    `mesh` is the data-parallel layout: "auto" (the default) spans the
    largest prefix of the local devices of the engine's device type that
    `auto_mesh` admits (one on a one-card machine and on the host), an
    explicit 1-D "data" mesh (`parallel.data_mesh`) pins the slots and
    raises when `max_batch` is not a multiple of them, and None serves
    unsharded. A one-slot mesh is None: the same keys, runners and
    numbers."""

    def __init__(self, params, ccfg=None, *, graph=None,
                 plan: PipelinePlan | None = None, calib=None,
                 occ_threshold: float = 0.75, block_c: int = 0,
                 use_pallas: bool = True, max_batch: int = 8, min_bucket: int = 2,
                 deadline_s: float = 0.010, clock=time.monotonic,
                 ema_alpha: float = 0.25, replan_band: float = 0.15,
                 replan_cooldown: int = 2, replan_async: bool = False,
                 cache_entries: int = 32, cache: PlanCache | None = None,
                 metrics: MetricsTracker | None = None,
                 sim_service_s=None, tracer=None, calibration=None,
                 tiles=None, int8: bool = False,
                 int8_budget: float = 0.98, device=None, mesh="auto"):
        # tracer: an obs.trace.Tracer for the plan / compile / execute /
        # re-plan spans; the NULL_TRACER default records nothing.
        # calibration / tiles: CalibrationDBs every plan this engine builds
        # (initial and drift re-plans) is priced and tiled with; None or an
        # empty DB keeps the datasheet defaults and default geometry.
        self.tracer = tracer if tracer is not None else NULL_TRACER
        self.calibration = calibration
        self.tiles = tiles
        self.device = resolve_device(device)
        self.int8 = bool(int8)
        self.int8_budget = float(int8_budget)
        self.use_pallas = bool(use_pallas)
        self._check_params_device(params)
        graph = plan.graph if plan is not None \
            else as_graph(graph if graph is not None else ccfg)
        if plan is None:
            if calib is None:
                raise ValueError("Engine needs either a prebuilt plan= or "
                                 "calib= images to plan on")
            with self.tracer.span("plan", graph=graph.name,
                                  occ_threshold=occ_threshold):
                plan = plan_network(params, self._to_device(calib), graph,
                                    occ_threshold=occ_threshold, block_c=block_c,
                                    use_pallas=self.use_pallas,
                                    calibration=calibration, tiles=tiles,
                                    int8=self.int8, int8_budget=self.int8_budget)
        if isinstance(mesh, str):
            if mesh != "auto":
                raise ValueError(f"mesh must be 'auto', None or a Mesh, got {mesh!r}")
            mesh = auto_mesh(max_batch, min_bucket, local_devices(self.device.type))
        if mesh is not None and mesh.size == 1:
            mesh = None
        if mesh is not None:
            if "data" not in mesh.axis_names:
                raise ValueError(f"Engine needs a mesh with a 'data' axis, got "
                                 f"{tuple(mesh.axis_names)}")
            if any(d.type != self.device.type for d in mesh.slots):
                raise ValueError(f"the engine serves on {self.device}, the mesh's "
                                 f"slots are {[str(d) for d in mesh.slots]}")
        self.mesh = mesh
        self.n_devices = int(mesh.shape["data"]) if mesh is not None else 1
        self.params = params
        self.graph = graph
        self.plan = plan
        self.clock = clock
        self.batcher = MicroBatcher(max_batch=max_batch, deadline_s=deadline_s,
                                    clock=clock, min_bucket=min_bucket,
                                    align=self.n_devices)
        self.cache = cache if cache is not None else PlanCache(max_entries=cache_entries)
        self.metrics = metrics if metrics is not None else MetricsTracker()
        # sim_service_s: deterministic service-time model for SimClock
        # replays (None = charge measured wall time; a float or
        # callable(bucket, n_real) -> seconds makes replays bit-identical)
        self.sim_service_s = sim_service_s
        self.ema_alpha = ema_alpha
        self.replan_band = replan_band
        self.replan_cooldown = replan_cooldown
        self.replan_async = replan_async
        self._lock = threading.Lock()
        self._pending_plan: PipelinePlan | None = None
        self._replanning = False
        self._replan_thread: threading.Thread | None = None
        self._plan_gen = 0  # bumped by hot_swap: a re-plan begun before drops
        self._warm: set = set()  # buckets with a runner: the swap points rebuild these
        self._cooldown = 0
        self._calib_recent = None  # last real (unpadded) executed batch
        self._occ_ema = np.array([lp.occupancy for lp in plan.layers])
        self.n_replans = 0
        self.replan_errors = 0
        self.n_hot_swaps = 0
        self.batch_builds = 0  # runners a served batch had to build itself
        self.verify_rejects = 0  # plans the static verifier refused to adopt
        self.n_batches = 0
        self.n_requests = 0
        self.n_pad_samples = 0
        self._fill_sum = 0.0
        self._profile_summary = None  # last Engine.profile() digest

    def _to_device(self, x) -> torch.Tensor:
        return torch.as_tensor(x, dtype=torch.float32).to(self.device)

    def _check_params_device(self, params) -> None:
        """Params must already live where the engine serves: never moved
        quietly (a host copy would run the kernels' plain versions)."""
        conv_ws, dense_ws = graph_weights(params)
        for w in conv_ws + dense_ws:
            if w.device.type != self.device.type:
                raise ValueError(f"params live on {w.device}, the engine "
                                 f"serves on {self.device}")

    # ------------------------------------------------------------------
    # request loop
    # ------------------------------------------------------------------

    def submit(self, img, now: float | None = None) -> int:
        """Queue one (C,H,W) image; returns the request id. `now` overrides
        the arrival stamp (replays pass the scheduled arrival, which can
        precede the clock when a previous batch advanced it)."""
        self.n_requests += 1
        rid = self.batcher.submit(self._to_device(img), now=now)
        self.metrics.on_submit(self.clock() if now is None else now)
        return rid

    def next_deadline(self) -> float | None:
        """Absolute time the driver must poll by (batcher deadline contract)."""
        return self.batcher.next_deadline()

    def poll(self) -> list:
        """Adopt any finished re-plan, then run EVERY due batch (an executed
        batch may advance a SimClock past further deadlines). Returns the
        completed `ServedResult`s ([] when nothing was due)."""
        out = []
        while True:
            self._adopt_pending_plan()
            batch = self.batcher.ready()
            if batch is None:
                return out
            out.extend(self._run_batch(batch))

    def drain(self) -> list:
        """Flush and run everything still queued (end of stream)."""
        out = []
        while self.batcher.pending():
            self._adopt_pending_plan()
            out.extend(self._run_batch(self.batcher.flush()))
        self._adopt_pending_plan()
        return out

    def serve(self, imgs) -> np.ndarray:
        """Submit every (C,H,W) image in `imgs`, drain, and return
        (N, n_classes) logits in submission order."""
        ids = [self.submit(img) for img in imgs]
        if not ids:
            return np.zeros((0, self.graph.n_classes()), np.float32)
        results = {r.id: r for r in self.drain()}
        return np.stack([results[i].logits for i in ids])

    def warmup(self, buckets=None) -> int:
        """Build the current plan's runner at the given bucket sizes (default:
        all of them). Returns the number of fresh builds."""
        before = self.cache.compiles
        for b in buckets or self.batcher.exec_buckets():
            self._executable(int(b))
        return self.cache.compiles - before

    def stats(self) -> dict:
        """Serving state + telemetry (`MetricsTracker.snapshot()` under
        ``"telemetry"``)."""
        c = self.plan.counts()
        pools = self.cache.slot_pools(self.n_devices)
        pool_bytes = [p.nbytes() for p in pools]
        return {
            **self.cache.stats(),
            "captures": sum(p.captures for p in self.cache.pools),
            "graph_pool_bytes": sum(p.nbytes() for p in self.cache.pools),
            "captures_per_slot": [p.captures for p in pools],
            "graph_pool_bytes_per_slot": pool_bytes,
            "device": str(self.device),
            "devices": self.n_devices,
            "requests": self.n_requests,
            "batches": self.n_batches,
            "pad_samples": self.n_pad_samples,
            "mean_fill": self._fill_sum / max(self.n_batches, 1),
            "replans": self.n_replans,
            "replan_errors": self.replan_errors,
            "hot_swaps": self.n_hot_swaps,
            "batch_builds": self.batch_builds,
            "verify_rejects": self.verify_rejects,
            "plan_sparse": c["sparse"],
            "plan_fused": c["fused"],
            "plan_dense": c["dense"],
            "plan_bsr": c["bsr"],
            "plan_int8": c["int8"],
            "plan_tiled": sum(1 for lp in self.plan.layers if lp.tile),
            "occ_ema": [float(v) for v in np.round(self._occ_ema, 4)],
            **{k: v for k, v in self.metrics.latency.percentiles_ms().items()
               if k != "count"},
            "lat_count": self.metrics.latency.count,
            "telemetry": {**self.metrics.snapshot(),
                          "profile": self._profile_summary},
        }

    def profile(self, imgs=None, *, impls=None, iters: int = 3,
                warmup: int = 1):
        """Per-layer measured-vs-modeled timing of the current plan
        (`obs.profile.profile_plan` at the engine's real shapes): every layer
        timed under each requested impl family beside its `unit_model_us`.
        The digest lands in ``stats()["telemetry"]["profile"]``; the full
        report is returned (`CalibrationDB.from_report` fits it).

        `imgs` defaults to the most recent real executed batch, the input
        the drift re-planner uses."""
        from repro_torch.obs.profile import PROFILE_IMPLS, profile_plan

        calib = self._calib_recent if imgs is None else self._to_device(imgs)
        if calib is None:
            raise ValueError("profile() needs imgs= before the engine has "
                             "executed its first batch")
        report = profile_plan(self.plan, self.params, calib,
                              impls=PROFILE_IMPLS if impls is None else impls,
                              iters=iters, warmup=warmup, tracer=self.tracer)
        self._profile_summary = report.summary()
        return report

    # ------------------------------------------------------------------
    # execution
    # ------------------------------------------------------------------

    def _executable(self, bucket: int, plan: PipelinePlan | None = None,
                    params=None):
        """The runner of `plan` at `bucket` (default: the served plan and
        params) on the engine's mesh, built on a cache miss: verified, and
        captured on the card (a `CompiledRunner`, or with a mesh a
        `ShardedRunner` over the cache's slot pools)."""
        plan = self.plan if plan is None else plan
        params = self.params if params is None else params
        mesh = self.mesh

        def build():
            with self.tracer.span("compile", bucket=bucket, devices=self.n_devices):
                if mesh is None:
                    return CompiledRunner(plan, params, bucket, self.device,
                                          pool=self.cache.graphs)
                return ShardedRunner(plan, params, bucket, mesh,
                                     pools=self.cache.slot_pools(mesh.size))

        exe = self.cache.get_or_compile(plan_key(bucket, plan, mesh), plan, build)
        self._warm.add(int(bucket))
        return exe

    def _prepare(self, plan: PipelinePlan, params) -> None:
        """Build `plan`'s runner at every bucket this engine has a runner for,
        and load `params` into their weight slots. The swap points call it
        before they change anything, so no served batch captures a graph or
        copies weights, and a failed capture leaves the served model as it
        was."""
        for b in sorted(self._warm):
            self._executable(b, plan, params).bind(params)

    def _run_batch(self, batch: MicroBatch) -> list:
        # spans on the engine's own clock: under a SimClock the charged
        # service time is exactly the span's duration
        with self.tracer.span("execute_batch", bucket=batch.bucket,
                              n_real=batch.n_real):
            return self._run_batch_traced(batch)

    def _run_batch_traced(self, batch: MicroBatch) -> list:
        imgs = torch.stack([r.img for r in batch.requests])
        if batch.bucket > batch.n_real:  # ragged tail: all-zero pad samples
            pad = imgs.new_zeros((batch.bucket - batch.n_real,) + imgs.shape[1:])
            imgs = torch.cat([imgs, pad])
        builds = self.cache.compiles
        exe = self._executable(batch.bucket)
        self.batch_builds += self.cache.compiles - builds  # no warmup built it
        t0 = time.perf_counter()
        logits, occs = exe(self.params, imgs, batch.n_real)
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        wall = time.perf_counter() - t0
        if self.sim_service_s is None:
            dt = wall
        elif callable(self.sim_service_s):
            dt = float(self.sim_service_s(batch.bucket, batch.n_real))
        else:
            dt = float(self.sim_service_s)
        if isinstance(self.clock, SimClock):
            self.clock.advance(dt)  # charge service time to the sim timeline
        t_done = self.clock()
        logits = logits.cpu().numpy()
        self.n_batches += 1
        self.n_pad_samples += batch.bucket - batch.n_real
        self._fill_sum += batch.fill
        self._calib_recent = imgs[: batch.n_real]
        results = [ServedResult(id=r.id, logits=logits[i], t_arrival=r.t_arrival,
                                t_done=t_done, t_formed=batch.t_formed)
                   for i, r in enumerate(batch.requests)]
        self.metrics.on_batch(t_done, batch.bucket, batch.n_real, dt)
        for r in results:
            self.metrics.on_result(r.latency_s)
        self._observe(occs.cpu().numpy())  # after results exist: a re-plan
        return results                     # failure must not drop served work

    # ------------------------------------------------------------------
    # occupancy drift -> re-plan
    # ------------------------------------------------------------------

    def _observe(self, occs: np.ndarray) -> None:
        a = self.ema_alpha
        self._occ_ema = (1.0 - a) * self._occ_ema + a * occs
        self.metrics.on_occupancy(self.clock(), self._occ_ema)
        if self._cooldown > 0:
            self._cooldown -= 1
            return
        if self._replanning:
            return
        planned = np.array([lp.occupancy for lp in self.plan.layers])
        delta = float(np.abs(self._occ_ema - planned).max())
        if delta > self.replan_band:
            self.metrics.on_replan_trigger(self.clock(), delta)
            self._launch_replan()

    def _launch_replan(self) -> None:
        calib = self._calib_recent
        if calib is None:
            return
        self._replanning = True
        plan = self.plan
        params = self.params
        gen = self._plan_gen

        def work():
            try:
                with self.tracer.span("replan", trigger="occupancy_drift"):
                    new = plan_network(params, calib, self.graph,
                                       occ_threshold=plan.occ_threshold,
                                       block_c=plan.block_c,
                                       use_pallas=self.use_pallas,
                                       calibration=self.calibration,
                                       tiles=self.tiles, int8=self.int8,
                                       int8_budget=self.int8_budget)
            except Exception:
                # a failed re-plan must not take down the serving loop: keep
                # the current plan, count the failure, retry on next drift
                with self._lock:
                    self._replanning = False
                    self.replan_errors += 1
                self.metrics.on_replan_error(self.clock())
                return
            with self._lock:
                if gen == self._plan_gen:
                    self._pending_plan = new
                else:
                    # a hot_swap landed while this re-plan was in flight: it
                    # was planned against the swapped-out params, so drop it
                    # and unblock the drift detector
                    self._replanning = False

        if self.replan_async:
            self._replan_thread = threading.Thread(target=work, daemon=True)
            self._replan_thread.start()
        else:
            work()

    def _adopt_pending_plan(self) -> None:
        """Swap point: a finished re-plan replaces the live plan only BETWEEN
        batches, once verified against the params and with its runners
        built; the EMA re-centres on the new plan's occupancies."""
        with self._lock:
            if self._pending_plan is None:
                return
            new, self._pending_plan = self._pending_plan, None
        self._replanning = False
        if not self._verify_candidate(new, self.params):
            return  # an erroring re-plan: keep serving the current plan
        self._prepare(new, self.params)
        changed = plan_key(0, new) != plan_key(0, self.plan)
        if changed:
            self.n_replans += 1
        self.plan = new
        self._occ_ema = np.array([lp.occupancy for lp in new.layers])
        self._cooldown = self.replan_cooldown
        self.metrics.on_replan_swap(self.clock(), changed)

    def _verify_candidate(self, plan, params) -> bool:
        """The static gate on every plan-adoption path: an error-severity
        diagnostic rejects the candidate before the engine changes anything;
        the reject is counted and lands in the telemetry events."""
        from repro_torch.analysis import errors, verify_plan

        bad = errors(verify_plan(plan, params, graph=self.graph))
        if not bad:
            return True
        self.verify_rejects += 1
        self.metrics.on_verify_reject(self.clock(), tuple(d.code for d in bad))
        return False

    def hot_swap(self, params, *, plan: PipelinePlan | None = None,
                 calib=None) -> bool:
        """Swap the served model between batches, canonically to a
        differently-pruned BSR variant of the same graph (the weight
        signature in `PlanKey` keeps both variants' runners resident, so
        swapping back and forth builds nothing). Call it outside
        `poll()` / `serve()`, e.g. from a scenario event.

        `params` must already live on the engine's device. `plan` pins the
        new schedule; otherwise the new params are planned on `calib`
        (default: the most recent real batch) at the current plan's
        occ_threshold and block_c. An in-flight background re-plan belongs
        to the old params: the generation bump drops its result on arrival.

        A given `plan` is verified against the new params first: an erroring
        pair returns False, counts in `stats()["verify_rejects"]` and
        changes nothing (a freshly planned candidate raises from
        `plan_network` itself). Before the swap lands, the new plan's runner
        is built (captured) at every bucket the engine has a runner for and
        the new params are loaded into the runners' weight slots (one copy),
        so the next batch replays. Returns True on a completed swap."""
        self._check_params_device(params)
        if plan is None:
            calib = self._calib_recent if calib is None else self._to_device(calib)
            if calib is None:
                raise ValueError("hot_swap needs plan= or calib= before the "
                                 "engine has executed its first batch")
            with self.tracer.span("plan", graph=self.graph.name,
                                  trigger="hot_swap"):
                plan = plan_network(params, calib, self.graph,
                                    occ_threshold=self.plan.occ_threshold,
                                    block_c=self.plan.block_c,
                                    use_pallas=self.use_pallas,
                                    calibration=self.calibration,
                                    tiles=self.tiles, int8=self.int8,
                                    int8_budget=self.int8_budget)
        elif not self._verify_candidate(plan, params):
            return False
        self._prepare(plan, params)
        with self._lock:
            self._plan_gen += 1
            self._pending_plan = None
        self.params = params
        self.plan = plan
        self.graph = plan.graph
        self._occ_ema = np.array([lp.occupancy for lp in plan.layers])
        self._cooldown = self.replan_cooldown
        self.n_hot_swaps += 1
        self.metrics.on_hot_swap(self.clock())
        return True

    def join_replan(self, timeout: float | None = 10.0) -> None:
        """Wait for an in-flight background re-plan."""
        t = self._replan_thread
        if t is not None:
            t.join(timeout)


def replay_stream(engine: Engine, imgs, rate_rps: float,
                  arrivals=None) -> list:
    """Drive the engine over a deterministic open-loop request stream on a
    `SimClock`: images arrive at `rate_rps` (or at the explicit `arrivals`),
    and the engine charges service time into the simulated timeline. Returns
    all `ServedResult`s."""
    from repro_torch.serving.scenarios import ListScenario, replay_scenario

    clock = engine.clock
    if not isinstance(clock, SimClock):
        raise ValueError("replay_stream needs an Engine built on a SimClock")
    if arrivals is None:
        t0 = clock()
        arrivals = [t0 + i / rate_rps for i in range(len(imgs))]
    scenario = ListScenario(imgs=tuple(imgs), arrivals=tuple(arrivals))
    return replay_scenario(engine, scenario)[""]
