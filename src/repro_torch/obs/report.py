"""The one execution-report schema every stitched caller shares.

Before this module, ``Engine.stitch_report()``, ``StitchedTrainStep.
report()`` and ``PackedAdamW.report()`` each exposed a slightly different
dict shape; dashboards and tests had to special-case all three.  Now every
path reports through :meth:`repro_torch.exec.StitchedFunction.report`, whose
output conforms to :data:`EXEC_REPORT_SCHEMA` — this module documents the
schema and provides the validator the schema test (and any external
consumer) checks against.

Schema (version ``repro_torch.obs/exec-report@1``) — keys always present:

==================  =========================================================
key                 meaning
==================  =========================================================
``schema``          the literal version string above
``name``            the stitched function's name
``mode``            ``stitch`` / ``shadow`` / ``offline`` / ``jit``
``status``          active specialization status (``hit`` / ``miss`` /
                    ``pending`` / ``compiled`` / ``failed`` / ``error``) or
                    None before the first call
``calls``           ``{"stitched": n, "fallback": n, "jit": n}`` — which
                    route served each call
``specializations`` number of traced (static-arg) specializations
``placement``       active mesh+PartitionSpec cache key ("" = single-device)
``plan``            active plan stats (mode, n_ops, n_kernels,
                    pallas_groups, modeled_time, cache_status) or None
``error``           this function's trace/compile failure message or None
``errors``          *all* per-key background-compile failures recorded by
                    the :class:`repro_torch.cache.CompilationService`
                    (stringified key -> message; {} when none / no service)
``diagnostics``     structured ``StitchInfeasible`` records from the active
                    plan's tuning run (stage / pattern_class / members /
                    reason dicts) — why chosen patterns degraded to
                    fused-jnp; [] when none
``cache``           the cache report: total/per-bucket/per-placement
                    hits+misses, tier sizes (None without a service)
``measured``        measured-kernel timing per path (histogram summaries,
                    see :mod:`repro_torch.obs.timer`) or None when never enabled
==================  =========================================================

Compatibility keys (``stitched_calls`` / ``fallback_calls`` /
``jit_calls`` / ``service_error``) are also emitted; new consumers should
prefer ``calls`` and ``errors``.
"""

from __future__ import annotations

__all__ = ["EXEC_REPORT_SCHEMA", "EXEC_REPORT_KEYS", "validate_exec_report"]

EXEC_REPORT_SCHEMA = "repro_torch.obs/exec-report@1"

# keys that must be present in every StitchedFunction.report()
EXEC_REPORT_KEYS = frozenset({
    "schema", "name", "mode", "status", "calls", "specializations",
    "placement", "plan", "error", "errors", "diagnostics", "cache",
    "measured",
})

_CALL_KEYS = frozenset({"stitched", "fallback", "jit"})


def validate_exec_report(rep: dict) -> list[str]:
    """Return the list of schema violations (empty = conforming)."""
    problems: list[str] = []
    if not isinstance(rep, dict):
        return [f"report is {type(rep).__name__}, not dict"]
    for k in sorted(EXEC_REPORT_KEYS - set(rep)):
        problems.append(f"missing key {k!r}")
    if rep.get("schema") != EXEC_REPORT_SCHEMA:
        problems.append(f"schema is {rep.get('schema')!r}, "
                        f"expected {EXEC_REPORT_SCHEMA!r}")
    calls = rep.get("calls")
    if not isinstance(calls, dict) or set(calls) != _CALL_KEYS:
        problems.append(f"calls must have exactly keys {sorted(_CALL_KEYS)}, "
                        f"got {calls!r}")
    if not isinstance(rep.get("errors", None), dict):
        problems.append("errors must be a dict (possibly empty)")
    plan = rep.get("plan")
    if plan is not None and not {"n_kernels", "n_ops",
                                 "modeled_time"} <= set(plan):
        problems.append(f"plan missing kernel/op/time stats: {plan!r}")
    cache = rep.get("cache")
    if cache is not None and not {"total_hits", "total_misses",
                                  "per_placement"} <= set(cache):
        problems.append(f"cache missing hit/miss/per_placement: "
                        f"{sorted(cache) if isinstance(cache, dict) else cache}")
    return problems
