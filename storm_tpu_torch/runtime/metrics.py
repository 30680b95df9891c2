"""Metrics: counters, gauges and latency histograms with percentiles,
copied from ``storm_tpu/runtime/metrics.py`` (without the name registry,
consumers and the Prometheus exposition). The shed controller reads a
histogram's ``count`` and ``percentile``; the copy ledger its named
windows; a sampled record's trace id rides on the histogram it observes
as its exemplar."""

from __future__ import annotations

import threading
import time
from typing import Dict, Optional

import numpy as np


class Counter:
    __slots__ = ("value",)

    def __init__(self) -> None:
        self.value = 0

    def inc(self, n: int = 1) -> None:
        self.value += n


class Gauge:
    __slots__ = ("value",)

    def __init__(self) -> None:
        self.value = 0.0

    def set(self, v: float) -> None:
        self.value = float(v)


class Histogram:
    """Ring-buffer reservoir; percentiles over the most recent window.
    Thread-safe: device threads observe while the event loop snapshots."""

    def __init__(self, capacity: int = 65536) -> None:
        self._lock = threading.Lock()
        self._buf = np.zeros(capacity, dtype=np.float64)
        self._n = 0
        self._i = 0
        self.count = 0
        self.sum = 0.0
        # The latest sampled (trace_id, value, wall ts): links the
        # histogram to the trace that produced a point. None until a
        # sampled record observes.
        self.exemplar = None
        # Named windowed-rate cursors: key -> (count, sum, t) at last read.
        self._windows: Dict[str, tuple] = {}

    def observe(self, v: float, trace_id: Optional[str] = None) -> None:
        with self._lock:
            self._buf[self._i] = v
            self._i = (self._i + 1) % len(self._buf)
            self._n = min(self._n + 1, len(self._buf))
            self.count += 1
            self.sum += v
            if trace_id is not None:
                self.exemplar = (trace_id, v, time.time())

    def values(self) -> np.ndarray:
        """The reservoir's values (the most recent window), oldest first."""
        with self._lock:
            if self._n < len(self._buf):
                return self._buf[:self._n].copy()
            return np.roll(self._buf, -self._i)

    def window(self, key: str = "default") -> Dict[str, float]:
        """Count and sum since the last ``window(key)`` call. Cursors are
        named, so independent readers keep their own; the first call with
        a key reports a zero-length window."""
        now = time.monotonic()
        with self._lock:
            count, total = self.count, self.sum
            prev = self._windows.get(key)
            self._windows[key] = (count, total, now)
        if prev is None:
            return {"count": 0, "sum": 0.0, "dt_s": 0.0, "rate_per_s": 0.0, "mean": None}
        dc = max(0, count - prev[0])
        ds = max(0.0, total - prev[1])
        dt = max(0.0, now - prev[2])
        return {"count": dc, "sum": ds, "dt_s": dt,
                "rate_per_s": dc / dt if dt > 0 else 0.0,
                "mean": ds / dc if dc else None}

    def drop_window(self, key: str = "default") -> bool:
        """Forget one named cursor."""
        with self._lock:
            return self._windows.pop(key, None) is not None

    def window_keys(self) -> tuple:
        with self._lock:
            return tuple(self._windows)

    def percentile(self, q: float) -> float:
        """The ``q``-th percentile of the window (NaN when empty)."""
        with self._lock:
            if self._n == 0:
                return float("nan")
            window = self._buf[: self._n].copy()
        return float(np.percentile(window, q))

    def snapshot(self) -> Dict[str, float]:
        def clean(v: float):
            return None if v != v else v  # NaN -> None (JSON-safe)

        with self._lock:
            count, total = self.count, self.sum
            window = self._buf[: self._n].copy() if self._n else None
        if window is None:
            p50 = p90 = p95 = p99 = mx = float("nan")
        else:
            p50, p90, p95, p99 = (
                float(x) for x in np.percentile(window, (50, 90, 95, 99)))
            mx = float(window.max())
        return {"count": count, "sum": clean(total),
                "mean": clean(total / count if count else float("nan")),
                "p50": clean(p50), "p90": clean(p90), "p95": clean(p95),
                "p99": clean(p99), "max": clean(mx)}


class MetricsRegistry:
    """Per-topology registry: ``(component, name) -> metric``."""

    def __init__(self) -> None:
        self._lock = threading.Lock()
        self._counters: Dict[tuple, Counter] = {}
        self._gauges: Dict[tuple, Gauge] = {}
        self._histograms: Dict[tuple, Histogram] = {}

    def counter(self, component: str, name: str) -> Counter:
        c = self._counters.get((component, name))
        if c is None:
            with self._lock:
                c = self._counters.setdefault((component, name), Counter())
        return c

    def gauge(self, component: str, name: str) -> Gauge:
        g = self._gauges.get((component, name))
        if g is None:
            with self._lock:
                g = self._gauges.setdefault((component, name), Gauge())
        return g

    def histogram(self, component: str, name: str) -> Histogram:
        h = self._histograms.get((component, name))
        if h is None:
            with self._lock:
                h = self._histograms.setdefault((component, name), Histogram())
        return h

    def snapshot(self) -> Dict[str, Dict[str, object]]:
        out: Dict[str, Dict[str, object]] = {}
        for (comp, name), c in list(self._counters.items()):
            out.setdefault(comp, {})[name] = c.value
        for (comp, name), g in list(self._gauges.items()):
            out.setdefault(comp, {})[name] = g.value
        for (comp, name), h in list(self._histograms.items()):
            out.setdefault(comp, {})[name] = h.snapshot()
        return out
