"""Sparsity-aware serving engine over the pipeline planner (counterpart of
`repro.serving`): `MicroBatcher` buckets, `PlanCache` runners, the `Engine`
with its occupancy-drift re-planner, `hot_swap` and data-parallel `mesh=`
(`auto_mesh`), the scenario library
(burst, diurnal drift, multi-tenant, hot swap) with its SimClock replay
driver, and the offline (occ_threshold, block_c) `autotune`."""
from repro_torch.serving.autotune import AutotuneResult, Candidate, autotune, plan_model_us
from repro_torch.serving.batcher import (
    MicroBatch,
    MicroBatcher,
    Request,
    SimClock,
    bucket_sizes,
)
from repro_torch.serving.engine import Engine, ServedResult, auto_mesh, replay_stream
from repro_torch.serving.metrics import LatencyReservoir, MetricsTracker
from repro_torch.serving.plan_cache import PlanCache, PlanKey, plan_key
from repro_torch.serving.scenarios import (
    DiurnalDriftScenario,
    HotSwapScenario,
    ListScenario,
    MultiTenantScenario,
    PoissonBurstScenario,
    Scenario,
    ScenarioRequest,
    TenantSpec,
    replay_scenario,
    synth_image,
)

__all__ = [
    "AutotuneResult",
    "Candidate",
    "DiurnalDriftScenario",
    "Engine",
    "HotSwapScenario",
    "LatencyReservoir",
    "ListScenario",
    "MetricsTracker",
    "MicroBatch",
    "MicroBatcher",
    "MultiTenantScenario",
    "PlanCache",
    "PlanKey",
    "PoissonBurstScenario",
    "Request",
    "Scenario",
    "ScenarioRequest",
    "ServedResult",
    "SimClock",
    "TenantSpec",
    "auto_mesh",
    "autotune",
    "bucket_sizes",
    "plan_key",
    "plan_model_us",
    "replay_scenario",
    "replay_stream",
    "synth_image",
]
