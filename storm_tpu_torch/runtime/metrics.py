"""Metrics: counters, gauges and latency histograms with percentiles,
copied from ``storm_tpu/runtime/metrics.py``. The shed controller reads a
histogram's ``count`` and ``percentile``; the copy ledger its named
windows; a sampled record's trace id rides on the histogram it observes
as its exemplar. A name missing from the port's generated registry
(:mod:`.metric_names`) warns once when its metric is created. Metrics
consumers (Storm's ``IMetricsConsumer``) take periodic snapshots, and
:func:`prometheus_text` renders registries in the Prometheus text
exposition format, byte for byte as storm_tpu renders them."""

from __future__ import annotations

import json
import logging
import threading
import time
from typing import Dict, Optional

import numpy as np

log = logging.getLogger("storm_tpu_torch.metrics")

# Names already flagged as unknown: warn once per process, not per call.
_unknown_warned: set = set()


def _check_name(name: str) -> None:
    """Warn once for a metric name missing from the generated registry
    (``runtime/metric_names.py``): a misspelt writer name otherwise makes
    a parallel series while every reader watches a flat line. Names built
    at run time match the registry's wildcard patterns."""
    if name in _unknown_warned:
        return
    from storm_tpu_torch.runtime.metric_names import is_known

    if not is_known(name):
        _unknown_warned.add(name)
        log.warning("metric name %r is not in the generated registry: a typo, or "
                    "run `python -m storm_tpu_torch.runtime.metric_registry`", name)


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

    def reset(self) -> None:
        """Drop the reservoir, the counters, the exemplar and every named
        window (a harness discarding its warm-up traffic)."""
        with self._lock:
            self._n = 0
            self._i = 0
            self.count = 0
            self.sum = 0.0
            self.exemplar = None
            self._windows.clear()

    @property
    def mean(self) -> float:
        return self.sum / self.count if self.count else float("nan")

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
            _check_name(name)  # at creation only: off the hot path
            with self._lock:
                c = self._counters.setdefault((component, name), Counter())
        return c

    def gauge(self, component: str, name: str) -> Gauge:
        g = self._gauges.get((component, name))
        if g is None:
            _check_name(name)  # at creation only: off the hot path
            with self._lock:
                g = self._gauges.setdefault((component, name), Gauge())
        return g

    def histogram(self, component: str, name: str) -> Histogram:
        h = self._histograms.get((component, name))
        if h is None:
            _check_name(name)  # at creation only: off the hot path
            with self._lock:
                h = self._histograms.setdefault((component, name), Histogram())
        return h

    def drop_windows(self, key: str) -> int:
        """Drop the named ``window()`` cursor from every histogram of the
        registry; returns how many held one."""
        n = 0
        with self._lock:
            hists = list(self._histograms.values())
        for h in hists:
            if h.drop_window(key):
                n += 1
        return n

    def snapshot(self) -> Dict[str, Dict[str, object]]:
        out: Dict[str, Dict[str, object]] = {}
        for (comp, name), c in list(self._counters.items()):
            out.setdefault(comp, {})[name] = c.value
        for (comp, name), g in list(self._gauges.items()):
            out.setdefault(comp, {})[name] = g.value
        for (comp, name), h in list(self._histograms.items()):
            out.setdefault(comp, {})[name] = h.snapshot()
        return out


class MetricsConsumer:
    """Receives periodic snapshots of a running topology's metrics
    (Storm's ``IMetricsConsumer``); attach one with
    ``runtime.add_metrics_consumer(consumer, interval_s)``."""

    def handle(self, topology: str, ts: float,
               snapshot: Dict[str, Dict[str, object]]) -> None:
        raise NotImplementedError

    def close(self) -> None:
        pass


class JsonLinesConsumer(MetricsConsumer):
    """Appends one JSON line per snapshot to a file."""

    def __init__(self, path: str) -> None:
        self.path = path
        self._fh = open(path, "a", buffering=1)

    def handle(self, topology: str, ts: float, snapshot) -> None:
        self._fh.write(json.dumps({"ts": ts, "topology": topology, "metrics": snapshot},
                                  default=str) + "\n")

    def close(self) -> None:
        self._fh.close()


class CallbackConsumer(MetricsConsumer):
    """Any ``fn(topology, ts, snapshot)`` as a consumer."""

    def __init__(self, fn) -> None:
        self.fn = fn

    def handle(self, topology: str, ts: float, snapshot) -> None:
        self.fn(topology, ts, snapshot)


def _prom_escape(v: str) -> str:
    """Escape a label value per the exposition format (backslash, quote,
    newline)."""
    return v.replace("\\", "\\\\").replace('"', '\\"').replace("\n", "\\n")


def prometheus_text(registries: Dict[str, "MetricsRegistry"]) -> str:
    """Render ``{topology: MetricsRegistry}`` in the Prometheus text
    exposition format, with storm_tpu's metric names (``storm_tpu_``
    prefix), so one dashboard reads both packages. The kind comes from the
    registry: counters become ``storm_tpu_<name>_total``, gauges
    ``storm_tpu_<name>``, histograms a ``_count``/``_sum`` pair (the count
    carrying the latest sampled trace id as an OpenMetrics exemplar) and
    mean/p50/p90/p95/p99/max gauges. One ``# TYPE`` line per family."""
    lines = []

    def sane(v) -> str:
        try:
            f = float(v)
        except (TypeError, ValueError):
            return "NaN"
        return repr(f) if f == f else "NaN"

    def name_of(metric: str, suffix: str = "") -> str:
        safe = "".join(c if c.isalnum() else "_" for c in metric)
        return f"storm_tpu_{safe}{suffix}"

    typed: set = set()

    def type_line(family: str, kind: str) -> None:
        if family not in typed:
            typed.add(family)
            lines.append(f"# TYPE {family} {kind}")

    for topo, reg in sorted(registries.items()):
        for (comp, mname), c in sorted(reg._counters.items()):
            labels = f'{{topology="{_prom_escape(topo)}",component="{_prom_escape(comp)}"}}'
            type_line(name_of(mname, "_total"), "counter")
            lines.append(f"{name_of(mname, '_total')}{labels} {c.value}")
        for (comp, mname), g in sorted(reg._gauges.items()):
            labels = f'{{topology="{_prom_escape(topo)}",component="{_prom_escape(comp)}"}}'
            type_line(name_of(mname), "gauge")
            lines.append(f"{name_of(mname)}{labels} {sane(g.value)}")
        for (comp, mname), h in sorted(reg._histograms.items()):
            labels = f'{{topology="{_prom_escape(topo)}",component="{_prom_escape(comp)}"}}'
            ex = ""
            if h.exemplar is not None:
                tid, ev, ets = h.exemplar
                ex = (f' # {{trace_id="{_prom_escape(str(tid))}"}}'
                      f" {sane(ev)} {round(ets, 3)}")
            type_line(name_of(mname, "_count"), "counter")
            lines.append(f"{name_of(mname, '_count')}{labels} {h.count}{ex}")
            type_line(name_of(mname, "_sum"), "counter")
            lines.append(f"{name_of(mname, '_sum')}{labels} {sane(h.sum)}")
            snap = h.snapshot()
            for q in ("mean", "p50", "p90", "p95", "p99", "max"):
                type_line(name_of(mname, "_" + q), "gauge")
                lines.append(f"{name_of(mname, '_' + q)}{labels} {sane(snap.get(q))}")
    return "\n".join(lines) + "\n"
