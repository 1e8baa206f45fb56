"""repro_torch.analysis — static verification of StitchIR artifacts.

Every pass checks artifacts (graphs, fusion plans) without executing them,
emitting structured :class:`Finding` records with stable ``RA0xx`` codes.

Passes:
  * :func:`verify_graph`   — IR legality (SSA, shapes, dtypes, dead code)
  * :func:`verify_plan`    — fusion-plan legality (cover, cycles, scratch,
    registry membership); :func:`verify_compiled` for compiled artifacts

Wired in at ``StitchCompiler(verify=...)``, which refuses ERROR plans.
"""

from .findings import (CODES, ERROR, WARN, Finding, VerificationError,
                       errors, format_findings, summarize, warnings_)
from .plan import GroupView, verify_compiled, verify_plan, verify_record
from .verify import verify_graph

__all__ = [
    "Finding", "VerificationError", "CODES", "ERROR", "WARN",
    "errors", "warnings_", "summarize", "format_findings",
    "verify_graph",
    "GroupView", "verify_plan", "verify_record", "verify_compiled",
]
