"""Structured findings for the static verifier.

Every analysis pass (:mod:`repro_torch.analysis.verify`, ``plan``, ``alias``,
``kvaudit``) reports problems as :class:`Finding` records instead of
raising mid-pipeline: a stable machine-checkable code (``RA0xx``), a
severity, a human message, and provenance (node name / group index /
page id).  Callers decide what to do with them — the compiler refuses
ERROR plans, cache replay demotes to a miss, the CLI exits nonzero.

Code registry (stable — tests pin these; never renumber):

========  =======================================================
code      meaning
========  =======================================================
RA001     operand references an undefined node (use-before-def)
RA002     graph contains a cycle
RA003     declared output missing from the graph
RA004     invalid / unparseable dtype
RA005     dead compute node (unreachable from any output) [WARN]
RA010     elementwise operand shapes not broadcast-compatible
RA011     invalid broadcast dims
RA012     reshape element-count mismatch
RA013     invalid transpose permutation
RA014     invalid reduction axes / output shape
RA015     dot contraction or batch dimension mismatch
RA016     slice bounds invalid
RA017     gather output shape mismatch
RA020     plan group member not in graph
RA021     overlapping groups (node owned by more than one group)
RA022     compute node not covered by any group
RA023     induced group DAG has a cycle
RA024     group scratch request exceeds on-chip budget
RA025     unregistered custom kernel inside a fused group
RA026     recorded pattern-class stats inconsistent [WARN]
RA027     non-compute node (param/const/tuple) inside a group
RA028     invalid group kind in a plan record
RA030     donated input aliases a graph output (passthrough)
RA031     donated input read by a group after the donating group
RA032     donated name is not a graph parameter / unused [WARN]
RA040     page neither free nor allocated (lost)
RA041     page both free and allocated
RA042     page refcount disagrees with owner count
RA043     page refcounted but owned by nobody (leaked)
RA044     page owned more often than its refcount (double-owned)
RA045     allocator structure corrupt (free-list dup / page 0 / range)
RA046     page owned but not allocated (use-after-free)
RA047     page-table row disagrees with slot ownership
RA050     plan record file unreadable / structurally invalid
RA060     pack member subgraphs overlap / don't cover the group
RA061     pack data dependence crosses member subgraphs
RA062     pack register pressure exceeds budget
========  =======================================================
"""

from __future__ import annotations

from dataclasses import dataclass, field

__all__ = ["Finding", "VerificationError", "ERROR", "WARN", "CODES",
           "errors", "warnings_", "summarize", "format_findings"]

ERROR = "error"
WARN = "warning"

CODES: dict[str, str] = {
    "RA001": "undefined operand",
    "RA002": "graph cycle",
    "RA003": "missing output",
    "RA004": "invalid dtype",
    "RA005": "dead node",
    "RA010": "elementwise shape mismatch",
    "RA011": "invalid broadcast dims",
    "RA012": "reshape element-count mismatch",
    "RA013": "invalid transpose permutation",
    "RA014": "invalid reduction axes",
    "RA015": "dot dimension mismatch",
    "RA016": "slice bounds invalid",
    "RA017": "gather shape mismatch",
    "RA020": "group member not in graph",
    "RA021": "overlapping groups",
    "RA022": "uncovered compute node",
    "RA023": "induced group cycle",
    "RA024": "scratch over budget",
    "RA025": "unregistered custom in fused group",
    "RA026": "pattern-class stats inconsistent",
    "RA027": "non-compute node in group",
    "RA028": "invalid group kind",
    "RA030": "donated input aliases output",
    "RA031": "donated input read after donating group",
    "RA032": "donated name unused",
    "RA040": "lost page",
    "RA041": "page both free and allocated",
    "RA042": "page refcount mismatch",
    "RA043": "leaked page",
    "RA044": "double-owned page",
    "RA045": "allocator structure corrupt",
    "RA046": "page owned but not allocated",
    "RA047": "page-table row inconsistent",
    "RA050": "unreadable plan record",
    "RA060": "pack member subgraphs malformed",
    "RA061": "pack dependence crosses member subgraphs",
    "RA062": "pack register pressure over budget",
}

_WARN_CODES = frozenset({"RA005", "RA026", "RA032"})


@dataclass(frozen=True)
class Finding:
    """One defect found by a static pass.

    ``node`` is a graph node name (IR/alias passes), ``group`` a group
    index (plan pass), ``page`` a page id (KV pass); unused provenance
    fields stay None.
    """

    code: str
    message: str
    severity: str = ""          # derived from code when empty
    node: str | None = None
    group: int | None = None
    page: int | None = None

    def __post_init__(self) -> None:
        if not self.severity:
            object.__setattr__(
                self, "severity",
                WARN if self.code in _WARN_CODES else ERROR)

    @property
    def title(self) -> str:
        return CODES.get(self.code, "unknown code")

    def as_dict(self) -> dict:
        d: dict = {"code": self.code, "severity": self.severity,
                   "title": self.title, "message": self.message}
        if self.node is not None:
            d["node"] = self.node
        if self.group is not None:
            d["group"] = self.group
        if self.page is not None:
            d["page"] = self.page
        return d

    def __str__(self) -> str:
        where = ""
        if self.node is not None:
            where = f" node={self.node}"
        if self.group is not None:
            where += f" group={self.group}"
        if self.page is not None:
            where += f" page={self.page}"
        return (f"{self.code} [{self.severity.upper()}] {self.title}:"
                f"{where} {self.message}")


def errors(findings: list[Finding]) -> list[Finding]:
    return [f for f in findings if f.severity == ERROR]


def warnings_(findings: list[Finding]) -> list[Finding]:
    return [f for f in findings if f.severity == WARN]


def summarize(findings: list[Finding]) -> dict:
    """Compact dict for stats / bench records: counts + distinct codes."""
    return {
        "errors": len(errors(findings)),
        "warnings": len(warnings_(findings)),
        "codes": sorted({f.code for f in findings}),
    }


def format_findings(findings: list[Finding], limit: int = 20) -> str:
    lines = [str(f) for f in findings[:limit]]
    if len(findings) > limit:
        lines.append(f"... and {len(findings) - limit} more")
    return "\n".join(lines)


class VerificationError(Exception):
    """Raised by callers that refuse artifacts with ERROR findings (the
    compiler's ``verify=`` gate, the engine's debug KV audit).  Carries
    the full finding list so the failure is explainable."""

    def __init__(self, what: str, findings: list[Finding]):
        self.findings = findings
        super().__init__(
            f"{what}: {len(errors(findings))} error finding(s)\n"
            + format_findings(findings))

    @property
    def codes(self) -> set[str]:
        return {f.code for f in self.findings}
