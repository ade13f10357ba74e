"""Sparsity-aware serving engine over the pipeline planner (counterpart of
`repro.serving`): `MicroBatcher` buckets, `PlanCache` runners, the `Engine`
with its occupancy-drift re-planner, the SimClock replay driver, and the
offline (occ_threshold, block_c) `autotune`."""
from repro_torch.serving.autotune import AutotuneResult, Candidate, autotune, plan_model_us
from repro_torch.serving.batcher import (
    MicroBatch,
    MicroBatcher,
    Request,
    SimClock,
    bucket_sizes,
)
from repro_torch.serving.engine import Engine, ServedResult, replay_stream
from repro_torch.serving.metrics import LatencyReservoir, MetricsTracker
from repro_torch.serving.plan_cache import PlanCache, PlanKey, plan_key
from repro_torch.serving.scenarios import (
    ListScenario,
    Scenario,
    ScenarioRequest,
    replay_scenario,
)

__all__ = [
    "AutotuneResult",
    "Candidate",
    "Engine",
    "LatencyReservoir",
    "ListScenario",
    "MetricsTracker",
    "MicroBatch",
    "MicroBatcher",
    "PlanCache",
    "PlanKey",
    "Request",
    "Scenario",
    "ScenarioRequest",
    "ServedResult",
    "SimClock",
    "autotune",
    "bucket_sizes",
    "plan_key",
    "plan_model_us",
    "replay_scenario",
    "replay_stream",
]
