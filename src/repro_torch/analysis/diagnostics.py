"""Diagnostic records for the static verifier (counterpart of
`repro.analysis.diagnostics`).

Every check in `repro_torch.analysis` reports through one currency: a
`Diagnostic` with a stable machine-readable code (RPAxxx), a severity, a
location (layer index + (kind, impl)), a human message and a fix hint. The
codes and severities are the reference's, so the same plan gives the same
code set in both packages; a code is never renumbered or reused.

Code space:
  RPA1xx  launch geometry (CUDA grid / shared memory / dtype contracts)
  RPA2xx  graph / plan invariants (shapes, fusion legality, schedules, tiles)
  RPA3xx  plan-vs-params consistency (weight counts, shapes, density)
  RPA9xx  informational (dead modules, advisory notes)
"""
from __future__ import annotations

import json
from dataclasses import asdict, dataclass, field

ERROR = "error"
WARN = "warn"
INFO = "info"

#: code -> (default severity, one-line meaning): every diagnostic the
#: package can emit; tests/test_torch_analysis.py makes each one fire under
#: a targeted corruption.
CODES: dict = {
    "RPA101": (ERROR, "grid x block does not tile the output exactly once"),
    "RPA102": (ERROR, "index map / input gather out of bounds"),
    "RPA103": (ERROR, "kernel tile exceeds the shared-memory budget"),
    "RPA104": (ERROR, "int8 kernel without int32 accumulation or "
                      "per-output-channel scales"),
    "RPA105": (ERROR, "fused pool epilogue does not tile the conv output "
                      "exactly (the kernel floors)"),
    "RPA201": (ERROR, "plan/graph mismatch (layer count, shapes, specs)"),
    "RPA202": (ERROR, "graph topology or shape inference fails"),
    "RPA203": (ERROR, "fused layer fails the fusion-eligibility rule"),
    "RPA204": (WARN, "requested tile does not conform; kernel falls back "
                     "to defaults"),
    "RPA205": (ERROR, "BSR plan density disagrees with the params' measured "
                      "weight block density"),
    "RPA206": (WARN, "int8 layer without an Int8Report entry (accuracy "
                     "never probed)"),
    "RPA207": (ERROR, "(ids, cnt) schedule invariant violation"),
    "RPA208": (ERROR, "unknown (kind, impl) pair"),
    "RPA209": (ERROR, "plan field out of range (occupancy, density, "
                      "block_c)"),
    "RPA301": (ERROR, "params do not match the plan (weight counts or "
                      "shapes)"),
    "RPA901": (INFO, "module unreachable from the CNN spine (dead import)"),
}

_SEV_RANK = {ERROR: 0, WARN: 1, INFO: 2}


@dataclass(frozen=True)
class Diagnostic:
    """One verifier finding. `layer` is the 0-based conv index (None = whole
    plan / whole repo), (kind, impl) locate the op the finding is about."""

    code: str
    severity: str
    message: str
    layer: int | None = None
    kind: str = ""
    impl: str = ""
    hint: str = ""

    def where(self) -> str:
        loc = [] if self.layer is None else [f"conv_{self.layer + 1}"]
        if self.kind or self.impl:
            loc.append(f"{self.kind}/{self.impl}".strip("/"))
        return ":".join(loc) or "plan"

    def format(self) -> str:
        s = f"{self.code} [{self.severity}] {self.where()}: {self.message}"
        return f"{s} (hint: {self.hint})" if self.hint else s

    def to_json(self) -> dict:
        return asdict(self)


def diag(code: str, message: str, *, layer: int | None = None, kind: str = "",
         impl: str = "", hint: str = "", severity: str | None = None
         ) -> Diagnostic:
    """Build a `Diagnostic`, pulling the severity from the CODES table (an
    explicit `severity` overrides: RPA103 is a warn where the kernel's own
    tile choice cannot fit, an error where a requested tile cannot)."""
    default_sev, _ = CODES[code]
    return Diagnostic(code=code, severity=severity or default_sev,
                      message=message, layer=layer, kind=kind, impl=impl,
                      hint=hint)


def errors(diags) -> list:
    return [d for d in diags if d.severity == ERROR]


def sort_diagnostics(diags) -> list:
    """Errors first, then warns, then infos; stable within a severity."""
    return sorted(diags, key=lambda d: (_SEV_RANK.get(d.severity, 9),
                                        d.layer if d.layer is not None else -1))


def format_diagnostics(diags) -> str:
    return "\n".join(d.format() for d in sort_diagnostics(diags))


def diagnostics_json(diags, **extra) -> str:
    doc = {"diagnostics": [d.to_json() for d in sort_diagnostics(diags)],
           "n_errors": len(errors(diags)), **extra}
    return json.dumps(doc, indent=2)


@dataclass
class DiagnosticSink:
    """Tiny accumulator the checkers append into (keeps the check functions
    free of list plumbing)."""

    items: list = field(default_factory=list)

    def add(self, code: str, message: str, **kw) -> None:
        self.items.append(diag(code, message, **kw))
