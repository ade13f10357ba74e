"""verify_plan: the entry point callers integrate against (counterpart of
`repro.analysis.verify`).

- `verify_plan(plan, params=None, ...)` -> the full diagnostic list, warns
  and infos included;
- `assert_plan_ok(...)` raises `PlanVerificationError`, a `ValueError`, so
  callers that guarded `validate_plan` keep working, carrying the
  error-severity diagnostics on `.diagnostics`.

Hook points: `pipeline.planner.plan_network` asserts before returning a
plan; `pipeline.planner.validate_plan` (so every `run_plan`) asserts after
its input-batch checks; `serving.plan_cache.PlanCache.get_or_compile`
refuses to build a runner for an erroring plan.
"""
from __future__ import annotations

from repro_torch.analysis.diagnostics import errors, format_diagnostics
from repro_torch.analysis.plan import check_plan


class PlanVerificationError(ValueError):
    """An error-severity diagnostic in a plan."""

    def __init__(self, diagnostics):
        self.diagnostics = list(diagnostics)
        super().__init__(format_diagnostics(self.diagnostics))


def verify_plan(plan, params=None, *, graph=None, batch: int = 1) -> list:
    """Statically verify a plan (and optionally its params). Returns every
    diagnostic (errors, warns, infos); never raises. See `plan.check_plan`
    for the checks."""
    return check_plan(plan, params, graph=graph, batch=batch)


def assert_plan_ok(plan, params=None, *, graph=None, batch: int = 1) -> list:
    """`verify_plan`, raising `PlanVerificationError` on any error-severity
    finding. Returns the (warn / info only) diagnostics otherwise."""
    diags = verify_plan(plan, params, graph=graph, batch=batch)
    bad = errors(diags)
    if bad:
        raise PlanVerificationError(bad)
    return diags
