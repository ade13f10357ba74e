"""Batched sparse-CNN inference pipeline: planner + executor
(counterpart of `repro.pipeline`)."""
from repro_torch.pipeline.planner import (
    LayerPlan,
    PipelinePlan,
    measure_occupancy,
    occupancy_stat,
    plan_network,
    run_plan,
    run_plan_sharded,
    run_plan_unchecked,
    validate_plan,
)

__all__ = [
    "LayerPlan",
    "PipelinePlan",
    "measure_occupancy",
    "occupancy_stat",
    "plan_network",
    "run_plan",
    "run_plan_sharded",
    "run_plan_unchecked",
    "validate_plan",
]
