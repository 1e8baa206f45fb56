"""Metrics registry: counters / gauges / histograms with one latency-summary
implementation.

Before this module, three ad-hoc reporters each summarized latencies their
own way (``serve/metrics.py`` percentiles, the serve driver's wall-clock
report, the bench harness's per-section timings) and engine / train step /
optimizer / cache each invented a dict shape.  The registry gives them one
vocabulary:

* :class:`Counter` — monotonically increasing count (tokens emitted,
  cache hits);
* :class:`Gauge` — last-written value (slot occupancy, modeled plan time);
* :class:`Histogram` — value stream with the shared
  :func:`percentiles` summary (p50/p95/p99 plus count/sum/min/max/mean).
  Empty and single-sample streams return well-defined summaries (all-zero
  / the sample itself) instead of edge-case behavior;
* :class:`MetricsRegistry` — the namespace.  ``snapshot()`` returns one
  nested dict (JSON-ready via ``to_json``); ``to_prometheus()`` renders
  the Prometheus text exposition format.  ``register_provider(name, fn)``
  pulls existing report dicts (``Engine.stitch_report``,
  ``StitchedTrainStep.report``, ``StitchCache.report``) into the same
  snapshot, so every layer exports through one file.

Metrics may carry labels (``registry.counter("cache_lookups",
result="hit")``); label sets are part of the identity, mirroring
Prometheus semantics.
"""

from __future__ import annotations

import json
import threading
from typing import Any, Callable, Iterable

import numpy as np

__all__ = ["percentiles", "Counter", "Gauge", "Histogram",
           "MetricsRegistry"]


def percentiles(values, ps: Iterable[int] = (50, 95, 99)) -> dict[str, float]:
    """THE latency-percentile summary every reporter shares.

    Well-defined on degenerate streams: an empty stream returns 0.0 for
    every percentile; a single sample returns that sample.
    """
    values = np.asarray(list(values), np.float64)
    if values.size == 0:
        return {f"p{p}": 0.0 for p in ps}
    return {f"p{p}": float(np.percentile(values, p)) for p in ps}


class Counter:
    """Monotonic counter."""

    __slots__ = ("value",)

    def __init__(self):
        self.value = 0.0

    def inc(self, n: float = 1.0) -> None:
        self.value += n

    def export(self) -> float:
        return self.value


class Gauge:
    """Last-written value."""

    __slots__ = ("value",)

    def __init__(self):
        self.value = 0.0

    def set(self, v: float) -> None:
        self.value = float(v)

    def export(self) -> float:
        return self.value


class Histogram:
    """Bounded value stream summarized with the shared percentiles.

    Keeps at most ``capacity`` most-recent samples (count/sum stay exact);
    a long-lived serving process never grows without bound.
    """

    __slots__ = ("values", "count", "total", "_min", "_max", "capacity")

    def __init__(self, capacity: int = 4096):
        self.values: list[float] = []
        self.count = 0
        self.total = 0.0
        self._min = float("inf")
        self._max = float("-inf")
        self.capacity = capacity

    def observe(self, v: float) -> None:
        v = float(v)
        self.count += 1
        self.total += v
        self._min = min(self._min, v)
        self._max = max(self._max, v)
        self.values.append(v)
        if len(self.values) > self.capacity:
            del self.values[: len(self.values) // 2]

    def summary(self) -> dict[str, float]:
        """count/sum/min/max/mean + p50/p95/p99; all-zero when empty."""
        if not self.count:
            return {"count": 0, "sum": 0.0, "min": 0.0, "max": 0.0,
                    "mean": 0.0, **percentiles(())}
        return {
            "count": self.count,
            "sum": self.total,
            "min": self._min,
            "max": self._max,
            "mean": self.total / self.count,
            **percentiles(self.values),
        }

    export = summary


def _metric_key(name: str, labels: dict) -> tuple:
    return (name, tuple(sorted(labels.items())))


def _label_str(labels: tuple) -> str:
    if not labels:
        return ""
    return "{" + ",".join(f'{k}="{v}"' for k, v in labels) + "}"


class MetricsRegistry:
    """Thread-safe namespace of counters/gauges/histograms + providers."""

    def __init__(self):
        self._metrics: dict[tuple, Any] = {}
        self._providers: dict[str, Callable[[], dict]] = {}
        self._lock = threading.Lock()

    # -- get-or-create ---------------------------------------------------------
    def _get(self, cls, name: str, labels: dict):
        key = _metric_key(name, labels)
        with self._lock:
            m = self._metrics.get(key)
            if m is None:
                m = cls()
                self._metrics[key] = m
            elif not isinstance(m, cls):
                raise TypeError(
                    f"metric {name!r}{labels} already registered as "
                    f"{type(m).__name__}, not {cls.__name__}")
            return m

    def counter(self, name: str, **labels) -> Counter:
        return self._get(Counter, name, labels)

    def gauge(self, name: str, **labels) -> Gauge:
        return self._get(Gauge, name, labels)

    def histogram(self, name: str, **labels) -> Histogram:
        return self._get(Histogram, name, labels)

    def register_provider(self, name: str, fn: Callable[[], dict]) -> None:
        """Pull an existing report dict (engine / train step / cache) into
        every snapshot under ``providers.<name>``; a provider that raises
        exports its error string instead of killing the snapshot."""
        with self._lock:
            self._providers[name] = fn

    def clear(self) -> None:
        with self._lock:
            self._metrics.clear()
            self._providers.clear()

    # -- export ----------------------------------------------------------------
    def snapshot(self) -> dict:
        """One nested JSON-ready dict of everything the process reports."""
        with self._lock:
            metrics = dict(self._metrics)
            providers = dict(self._providers)
        out: dict[str, Any] = {"counters": {}, "gauges": {}, "histograms": {}}
        section = {Counter: "counters", Gauge: "gauges",
                   Histogram: "histograms"}
        for (name, labels), m in sorted(metrics.items(),
                                        key=lambda kv: kv[0]):
            out[section[type(m)]][name + _label_str(labels)] = m.export()
        if providers:
            out["providers"] = {}
            for name, fn in sorted(providers.items()):
                try:
                    out["providers"][name] = fn()
                except Exception as e:      # noqa: BLE001 — report, don't die
                    out["providers"][name] = {
                        "error": f"{type(e).__name__}: {e}"}
        return out

    def to_json(self, path: str | None = None, **extra) -> str:
        """Serialize ``snapshot() | extra``; also writes ``path`` if given."""
        text = json.dumps({**self.snapshot(), **extra}, indent=2, default=str)
        if path is not None:
            with open(path, "w") as f:
                f.write(text)
        return text

    def to_prometheus(self) -> str:
        """Prometheus text exposition: counters/gauges as-is, histograms as
        summary quantiles + ``_count``/``_sum`` series."""
        with self._lock:
            metrics = dict(self._metrics)
        lines: list[str] = []
        typed: set[str] = set()
        for (name, labels), m in sorted(metrics.items(), key=lambda kv: kv[0]):
            ls = _label_str(labels)
            if isinstance(m, Counter):
                if name not in typed:
                    lines.append(f"# TYPE {name} counter")
                    typed.add(name)
                lines.append(f"{name}{ls} {m.value:g}")
            elif isinstance(m, Gauge):
                if name not in typed:
                    lines.append(f"# TYPE {name} gauge")
                    typed.add(name)
                lines.append(f"{name}{ls} {m.value:g}")
            else:
                if name not in typed:
                    lines.append(f"# TYPE {name} summary")
                    typed.add(name)
                s = m.summary()
                for q in (50, 95, 99):
                    ql = tuple(sorted(dict(labels,
                                           quantile=f"0.{q}").items()))
                    lines.append(f"{name}{_label_str(ql)} {s[f'p{q}']:g}")
                lines.append(f"{name}_count{ls} {s['count']:g}")
                lines.append(f"{name}_sum{ls} {s['sum']:g}")
        return "\n".join(lines) + ("\n" if lines else "")
