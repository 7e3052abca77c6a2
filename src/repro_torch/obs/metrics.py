"""A copy of ``repro.obs.metrics`` (numpy only).

Counter/gauge/histogram registry with Prometheus text exposition,
windowed live rates, and the shared percentile helper.

The registry is deliberately tiny (plain Python floats, no locks: the
engine is single-threaded host code between its steps) but speaks
standard Prometheus text exposition, so ``Engine.prometheus_text()``
scrapes straight into any collector.  :class:`WindowedSeries` backs
``Engine.live_metrics()``: time-stamped increments over a bounded deque
give tokens/s, shed rate, and preemption rate over the *last window*,
callable mid-run, unlike the end-of-run ``Engine.metrics()`` summary.

:func:`percentile` is the single home of the None-never-NaN contract:
percentiles over an empty sample serialize as JSON ``null``, never the
``NaN`` literal that poisons strict JSON consumers (enforced repo-wide
by ``benchmarks/check_invariants.py``).
"""
from __future__ import annotations

import math
from collections import deque
from typing import Iterable, Sequence

import numpy as np

# Prometheus classic duration buckets (seconds); generous tail so the
# virtual clock's step-unit latencies still land in finite buckets
DEFAULT_BUCKETS = (
    0.005, 0.01, 0.025, 0.05, 0.1, 0.25, 0.5, 1.0, 2.5, 5.0, 10.0,
    25.0, 50.0, 100.0,
)


def percentile(xs: Sequence | Iterable, q: float) -> float | None:
    """``float(np.percentile(xs, q))``, or None for an empty sample.

    None (JSON ``null``), never ``float("nan")``: the NaN literal is not
    valid JSON and poisons downstream artifact parsing — the bench
    invariant gate rejects any artifact carrying it.
    """
    xs = list(xs)
    return float(np.percentile(xs, q)) if xs else None


def _label_key(labels: dict) -> tuple:
    return tuple(sorted(labels.items()))


def _escape_label(v) -> str:
    """Prometheus label-value escaping: backslash, double-quote, newline
    (exposition-format spec) — unescaped values break any real scraper."""
    return str(v).replace("\\", "\\\\").replace('"', '\\"').replace("\n", "\\n")


def _escape_help(h: str) -> str:
    """HELP text escaping: backslash and newline (quotes are legal there)."""
    return h.replace("\\", "\\\\").replace("\n", "\\n")


def _label_str(key: tuple) -> str:
    if not key:
        return ""
    return "{" + ",".join(f'{k}="{_escape_label(v)}"' for k, v in key) + "}"


class Counter:
    """Monotonically increasing value, optionally split by labels."""

    kind = "counter"

    def __init__(self, name: str, help: str = ""):
        self.name = name
        self.help = help
        self._values: dict[tuple, float] = {}

    def inc(self, n: float = 1.0, **labels) -> None:
        if not (n >= 0):  # rejects negatives AND NaN (NaN compares false)
            raise ValueError("counters only go up")
        if math.isinf(n):
            raise ValueError("counters must stay finite")
        key = _label_key(labels)
        self._values[key] = self._values.get(key, 0.0) + n

    def value(self, **labels) -> float:
        return self._values.get(_label_key(labels), 0.0)

    def samples(self) -> list[tuple[str, str, float]]:
        if not self._values:
            return [(self.name, "", 0.0)]
        return [(self.name, _label_str(k), v)
                for k, v in sorted(self._values.items())]


class Gauge(Counter):
    """A value that can go either way (queue depth, occupancy, ...)."""

    kind = "gauge"

    def set(self, v: float, **labels) -> None:
        v = float(v)
        if not math.isfinite(v):
            raise ValueError("gauges must stay finite (exposition has no NaN)")
        self._values[_label_key(labels)] = v

    def inc(self, n: float = 1.0, **labels) -> None:
        if not math.isfinite(n):
            raise ValueError("gauges must stay finite (exposition has no NaN)")
        key = _label_key(labels)
        self._values[key] = self._values.get(key, 0.0) + n


class Histogram:
    """Cumulative-bucket histogram plus a bounded reservoir so live
    snapshots can report percentiles without unbounded growth."""

    kind = "histogram"

    def __init__(self, name: str, help: str = "",
                 buckets: Sequence[float] = DEFAULT_BUCKETS,
                 reservoir: int = 1024):
        self.name = name
        self.help = help
        self.buckets = tuple(sorted(buckets))
        self._counts = [0] * len(self.buckets)
        self.count = 0
        self.sum = 0.0
        self._reservoir: deque[float] = deque(maxlen=reservoir)

    def observe(self, v: float) -> None:
        v = float(v)
        if not math.isfinite(v):
            return  # never let NaN/Inf into sums/percentiles/exposition
        self.count += 1
        self.sum += v
        self._reservoir.append(v)
        for i, le in enumerate(self.buckets):
            if v <= le:
                self._counts[i] += 1

    def pct(self, q: float) -> float | None:
        return percentile(self._reservoir, q)

    def samples(self) -> list[tuple[str, str, float]]:
        out = []
        for le, c in zip(self.buckets, self._counts):
            out.append((f"{self.name}_bucket", f'{{le="{le:g}"}}', float(c)))
        out.append((f"{self.name}_bucket", '{le="+Inf"}', float(self.count)))
        out.append((f"{self.name}_sum", "", self.sum))
        out.append((f"{self.name}_count", "", float(self.count)))
        return out


class MetricsRegistry:
    """Create-or-get registry; exposition order is registration order."""

    def __init__(self):
        self._metrics: dict[str, Counter | Gauge | Histogram] = {}

    def _get(self, cls, name: str, help: str, **kw):
        m = self._metrics.get(name)
        if m is None:
            m = cls(name, help, **kw)
            self._metrics[name] = m
        elif not isinstance(m, cls):
            raise TypeError(f"{name} already registered as {type(m).__name__}")
        return m

    def counter(self, name: str, help: str = "") -> Counter:
        return self._get(Counter, name, help)

    def gauge(self, name: str, help: str = "") -> Gauge:
        return self._get(Gauge, name, help)

    def histogram(self, name: str, help: str = "",
                  buckets: Sequence[float] = DEFAULT_BUCKETS) -> Histogram:
        return self._get(Histogram, name, help, buckets=buckets)

    def snapshot(self) -> dict:
        """Plain-dict view (JSON-safe) of every metric's current state."""
        out: dict = {}
        for name, m in self._metrics.items():
            if isinstance(m, Histogram):
                out[name] = {"count": m.count, "sum": m.sum,
                             "p50": m.pct(50), "p99": m.pct(99)}
            elif len(m._values) == 1 and () in m._values:
                out[name] = m._values[()]
            else:
                out[name] = {_label_str(k) or "total": v
                             for k, v in sorted(m._values.items())}
        return out

    def prometheus_text(self) -> str:
        """Standard Prometheus text exposition (format version 0.0.4)."""
        lines = []
        for name, m in self._metrics.items():
            if m.help:
                lines.append(f"# HELP {name} {_escape_help(m.help)}")
            lines.append(f"# TYPE {name} {m.kind}")
            for sample, labels, v in m.samples():
                val = f"{v:g}"
                lines.append(f"{sample}{labels} {val}")
        return "\n".join(lines) + "\n"


class WindowedSeries:
    """Time-stamped increments over a bounded deque, summed per window.

    ``add(t, v)`` appends; ``sum(now, window)`` drops entries older than
    ``now - window`` (they can never be asked about again — time only
    moves forward) and returns the remaining total.  The ``maxlen``
    bound caps memory on the hot path regardless of call pattern.
    """

    def __init__(self, maxlen: int = 8192):
        self._q: deque[tuple[float, float]] = deque(maxlen=maxlen)

    def add(self, t: float, v: float = 1.0) -> None:
        self._q.append((t, v))

    def sum(self, now: float, window: float) -> float:
        cutoff = now - window
        q = self._q
        while q and q[0][0] < cutoff:
            q.popleft()
        return sum(v for _, v in q)

    def rate(self, now: float, window: float) -> float | None:
        """Events per unit time over the trailing window (None if the
        window is degenerate — never NaN/inf)."""
        if window <= 0:
            return None
        return self.sum(now, window) / window
