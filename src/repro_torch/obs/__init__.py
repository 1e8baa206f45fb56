"""``repro_torch.obs`` — unified observability for the stitching pipeline.

One subsystem, three pieces (see the per-module docs):

* :mod:`.trace` — structured span tracing with Chrome-trace / Perfetto
  export.  Every pipeline stage is instrumented: trace → pattern-gen →
  ILP/greedy → tune, cache hit/miss/replay, background compile
  start/land/fail, the fallback→stitched upgrade, and per-step serve /
  train execution (slot occupancy, evictions).  A whole run renders as a
  timeline in https://ui.perfetto.dev.
* :mod:`.metrics` — counters / gauges / histograms with the one shared
  percentile summary, a process :class:`~.metrics.MetricsRegistry`, and
  JSON + Prometheus-text export.  Existing report dicts plug in via
  ``register_provider``.
* :mod:`.timer` — opt-in ``block_until_ready``-bracketed measured-kernel
  timing (measured-vs-modeled per plan), feeding the registry, the
  tracer, and ``benchmarks/run.py --json``.

Both the tracer and the timer are **off by default** and their hot-path
checks are single attribute reads, so instrumentation in per-token code
costs nothing unobserved.  Typical wiring (what ``launch/train.py`` and
``launch/serve.py`` do for ``--trace-out`` / ``--metrics-json``)::

    from repro_torch import obs

    obs.enable_tracing()          # spans + events start recording
    obs.enable_timing()           # measured kernel timer on
    ... run ...
    obs.save_trace("trace.json")  # load this in Perfetto
    obs.registry().to_json("metrics.json")
    print(obs.registry().to_prometheus())

``python -m repro_torch.launch.inspect trace.json`` prints the compile timeline
and the per-plan modeled-vs-measured table offline.
"""

from __future__ import annotations

from . import timer
from .metrics import (Counter, Gauge, Histogram, MetricsRegistry,
                      percentiles)
from .report import (EXEC_REPORT_KEYS, EXEC_REPORT_SCHEMA,
                     validate_exec_report)
from .trace import NULL_SPAN, Tracer

__all__ = [
    "Counter", "Gauge", "Histogram", "MetricsRegistry", "percentiles",
    "Tracer", "NULL_SPAN", "tracer", "registry",
    "span", "event", "counter_event",
    "enable_tracing", "disable_tracing", "tracing_enabled", "save_trace",
    "clear_trace",
    "enable_timing", "disable_timing", "timing_enabled",
    "EXEC_REPORT_KEYS", "EXEC_REPORT_SCHEMA", "validate_exec_report",
    "timer",
]

# the process-wide instances library code records into
tracer = Tracer()
_registry = MetricsRegistry()


def registry() -> MetricsRegistry:
    """The process metrics registry."""
    return _registry


# -- tracing façade (delegates to the process tracer) -------------------------
def span(name: str, cat: str = "", **args):
    """Time a pipeline stage: ``with obs.span("compile.ilp", graph=g.name):``.
    Returns a shared no-op context manager when tracing is disabled."""
    if not tracer.enabled:
        return NULL_SPAN
    return tracer.span(name, cat, **args)


def event(name: str, cat: str = "", **args) -> None:
    """Instant marker (cache hit, compile landed, upgrade, eviction)."""
    if tracer.enabled:
        tracer.event(name, cat, **args)


def counter_event(name: str, cat: str = "", **values) -> None:
    """Numeric time-series sample (slot occupancy, queue depth)."""
    if tracer.enabled:
        tracer.counter_event(name, cat, **values)


def enable_tracing() -> None:
    tracer.enable()


def disable_tracing() -> None:
    tracer.disable()


def tracing_enabled() -> bool:
    return tracer.enabled


def clear_trace() -> None:
    tracer.clear()


def save_trace(path: str) -> str:
    """Write the Chrome-trace JSON (loadable in Perfetto); returns path."""
    return tracer.save(path)


# -- measured-kernel timing ----------------------------------------------------
def enable_timing() -> None:
    """Turn on the opt-in block_until_ready-bracketed kernel timer."""
    timer.enable()


def disable_timing() -> None:
    timer.disable()


def timing_enabled() -> bool:
    return timer.enabled
