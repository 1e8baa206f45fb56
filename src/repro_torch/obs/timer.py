"""Opt-in measured-kernel profiling — real wall clock, not the cost model.

The ROADMAP's "measured (not modeled) tuning" item and the perf-regression
gate both need *measured* timing data; the cost model alone cannot defend
real wall-clock (PowerFusion's feedback layer is the same lesson).  This
module is the measurement primitive: a ``block_until_ready``-bracketed
timer around each stitched-executable call (and its jit fallback), so the
recorded duration covers device execution, not just async dispatch.

It is **opt-in** because the bracket itself perturbs: ``block_until_ready``
serializes the dispatch pipeline, which an unobserved serving loop
deliberately keeps deep.  Disabled (the default), the check in the hot
path is one module-attribute read — free.

Measurements land in three places so every consumer sees the same numbers:

* the per-callable accumulators a ``StitchedFunction.report()`` exposes as
  ``measured`` (path -> histogram summary, with the plan's modeled time
  alongside for the measured-vs-modeled comparison);
* the process :class:`~repro_torch.obs.metrics.MetricsRegistry`
  (``exec_measured_seconds{fn=...,path=...}`` histograms);
* the active tracer as ``exec.measured`` events, which is what lets
  ``launch/inspect.py`` print a per-plan modeled-vs-measured table from a
  trace file alone.
"""

from __future__ import annotations

__all__ = ["enabled", "enable", "disable", "is_enabled", "record"]

# module-level flag: hot paths read `timer.enabled` directly (attribute
# lookup, no call) — do NOT `from ... import enabled` (that copies)
enabled = False


def enable() -> None:
    global enabled
    enabled = True


def disable() -> None:
    global enabled
    enabled = False


def is_enabled() -> bool:
    return enabled


def record(name: str, path: str, measured_s: float,
           modeled_s: float | None = None, placement: str = "") -> None:
    """Fan one measurement out to the registry and the tracer.

    ``name`` is the stitched function's name, ``path`` is which execution
    route served the call (``stitched`` / ``fallback`` / ``jit``);
    ``modeled_s`` is the active plan's cost-model time when one exists.
    """
    from . import registry, tracer

    reg = registry()
    reg.histogram("exec_measured_seconds", fn=name, path=path).observe(
        measured_s)
    if modeled_s is not None:
        reg.gauge("exec_modeled_seconds", fn=name, path=path).set(modeled_s)
    tracer.event("exec.measured", cat="measure", fn=name, path=path,
                 measured_s=measured_s, modeled_s=modeled_s,
                 placement=placement)
