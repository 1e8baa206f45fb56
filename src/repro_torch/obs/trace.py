"""Structured span tracing with Chrome-trace / Perfetto export.

The paper's argument starts from *measuring* where memory-intensive time
goes (§2 profiles op-level breakdowns); this module is the repro's
equivalent for the whole stitching pipeline.  A :class:`Tracer` records
two event kinds into an in-memory buffer:

* **spans** (``tracer.span(name)`` as a context manager) — wall-clock
  intervals, exported as Chrome-trace *complete* events (``ph: "X"`` with
  ``ts``/``dur``), nesting naturally per thread;
* **instant events** (``tracer.event(name)``) — point markers such as a
  cache hit, a background compile landing, or the fallback→stitched
  upgrade (``ph: "i"``), plus **counter events**
  (``tracer.counter_event(name, **values)``, ``ph: "C"``) for time series
  like slot occupancy.

The buffer exports as the Chrome trace-event JSON dialect
(``{"traceEvents": [...]}``) that ``chrome://tracing`` and
https://ui.perfetto.dev load directly, so one stitched train or serve run
renders as a timeline: compile stages on the background threads, per-step
decode spans on the main thread, with hit/miss/upgrade markers in between.

Overhead contract: a *disabled* tracer's ``span()`` returns a shared
no-op context manager and ``event()`` returns immediately after one
attribute check — instrumentation left in hot paths (per-token decode) is
free when tracing is off.  Timestamps are microseconds since the tracer's
epoch (``time.perf_counter`` based), the unit Chrome trace expects.
"""

from __future__ import annotations

import json
import os
import threading
import time
from typing import Any

__all__ = ["Tracer", "NULL_SPAN"]


class _NullSpan:
    """Shared do-nothing span: the disabled tracer's fast path."""

    __slots__ = ()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False

    def set(self, **args) -> None:
        """No-op counterpart of :meth:`_Span.set`."""


NULL_SPAN = _NullSpan()


class _Span:
    """One live span; records a ``ph: "X"`` complete event on exit."""

    __slots__ = ("_tracer", "name", "cat", "args", "_t0")

    def __init__(self, tracer: "Tracer", name: str, cat: str, args: dict):
        self._tracer = tracer
        self.name = name
        self.cat = cat
        self.args = args

    def set(self, **args) -> None:
        """Attach/override args discovered while the span is open (e.g. a
        scheduler step's admission/eviction counts, known only at the end)."""
        self.args.update(args)

    def __enter__(self):
        self._t0 = self._tracer._now()
        return self

    def __exit__(self, *exc):
        t1 = self._tracer._now()
        self._tracer._record({
            "ph": "X", "name": self.name, "cat": self.cat or "span",
            "ts": self._t0, "dur": t1 - self._t0,
            "pid": self._tracer.pid, "tid": threading.get_ident(),
            "args": self.args,
        })
        return False


class Tracer:
    """Thread-safe trace-event buffer (disabled by default).

    One process-wide instance lives at :data:`repro_torch.obs.tracer`; library
    code calls the module-level :func:`repro_torch.obs.span` /
    :func:`repro_torch.obs.event` helpers, applications flip it on with
    :func:`repro_torch.obs.enable_tracing` and write the file with
    :func:`repro_torch.obs.save_trace`.
    """

    def __init__(self, enabled: bool = False):
        self.enabled = enabled
        self.pid = os.getpid()
        self._events: list[dict] = []
        self._thread_names: dict[int, str] = {}
        self._lock = threading.Lock()
        self._epoch = time.perf_counter()

    # -- clock ----------------------------------------------------------------
    def _now(self) -> float:
        """Microseconds since this tracer's epoch (Chrome-trace unit)."""
        return (time.perf_counter() - self._epoch) * 1e6

    # -- recording ------------------------------------------------------------
    def _record(self, ev: dict) -> None:
        tid = ev["tid"]
        with self._lock:
            self._events.append(ev)
            if tid not in self._thread_names:
                self._thread_names[tid] = threading.current_thread().name

    def span(self, name: str, cat: str = "", **args):
        """Context manager timing a pipeline stage; no-op when disabled."""
        if not self.enabled:
            return NULL_SPAN
        return _Span(self, name, cat, args)

    def event(self, name: str, cat: str = "", **args) -> None:
        """Instant marker (``ph: "i"``, thread scope)."""
        if not self.enabled:
            return
        self._record({
            "ph": "i", "name": name, "cat": cat or "event", "s": "t",
            "ts": self._now(), "pid": self.pid,
            "tid": threading.get_ident(), "args": args,
        })

    def counter_event(self, name: str, cat: str = "", **values) -> None:
        """Counter sample (``ph: "C"``) — numeric time series (occupancy,
        queue depth) Perfetto renders as stacked tracks."""
        if not self.enabled:
            return
        self._record({
            "ph": "C", "name": name, "cat": cat or "counter",
            "ts": self._now(), "pid": self.pid,
            "tid": threading.get_ident(), "args": values,
        })

    # -- lifecycle ------------------------------------------------------------
    def enable(self) -> None:
        self.enabled = True

    def disable(self) -> None:
        self.enabled = False

    def clear(self) -> None:
        with self._lock:
            self._events.clear()
            self._thread_names.clear()
        self._epoch = time.perf_counter()

    def __len__(self) -> int:
        with self._lock:
            return len(self._events)

    # -- export ---------------------------------------------------------------
    def events(self) -> list[dict]:
        """Snapshot of recorded events (copies the list, not the dicts)."""
        with self._lock:
            return list(self._events)

    def chrome_trace(self) -> dict:
        """The Chrome trace-event JSON object Perfetto loads.

        Thread-name metadata events (``ph: "M"``) label the main thread and
        every background compile thread that recorded anything.
        """
        with self._lock:
            events = list(self._events)
            names = dict(self._thread_names)
        meta: list[dict[str, Any]] = [{
            "ph": "M", "name": "process_name", "pid": self.pid, "tid": 0,
            "ts": 0, "args": {"name": "repro-stitching"},
        }]
        for tid, nm in names.items():
            meta.append({"ph": "M", "name": "thread_name", "pid": self.pid,
                         "tid": tid, "ts": 0, "args": {"name": nm}})
        return {"traceEvents": meta + events, "displayTimeUnit": "ms"}

    def save(self, path: str) -> str:
        """Write the Chrome-trace JSON file; returns ``path``."""
        with open(path, "w") as f:
            json.dump(self.chrome_trace(), f, default=str)
        return path
