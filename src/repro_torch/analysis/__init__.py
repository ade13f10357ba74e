"""repro_torch.analysis: diagnostics-coded static verification (counterpart
of `repro.analysis`).

Verifies graphs, plans and the CUDA kernels' launch geometry without
launching anything: `verify_plan(plan, params)` returns `Diagnostic` records
with the reference's stable RPAxxx codes; `assert_plan_ok` raises a
`PlanVerificationError` (a ValueError) on error-severity findings. The
planner, `validate_plan` (so every `run_plan`) and the plan cache verify
through here; `python -m repro_torch.analysis.cli` sweeps the model zoo.
"""
from repro_torch.analysis.diagnostics import (
    CODES,
    Diagnostic,
    DiagnosticSink,
    diag,
    diagnostics_json,
    errors,
    format_diagnostics,
    sort_diagnostics,
)
from repro_torch.analysis.launch import (
    check_bsr_launch,
    check_conv_launch,
    check_launch,
)
from repro_torch.analysis.plan import check_launch_descriptor, check_plan
from repro_torch.analysis.schedules import check_schedule, schedule_ok
from repro_torch.analysis.verify import (
    PlanVerificationError,
    assert_plan_ok,
    verify_plan,
)

__all__ = [
    "CODES",
    "Diagnostic",
    "DiagnosticSink",
    "PlanVerificationError",
    "assert_plan_ok",
    "check_bsr_launch",
    "check_conv_launch",
    "check_launch",
    "check_launch_descriptor",
    "check_plan",
    "check_schedule",
    "diag",
    "diagnostics_json",
    "errors",
    "format_diagnostics",
    "schedule_ok",
    "sort_diagnostics",
    "verify_plan",
]
