"""Tracing: per-record traces, per-stage spans and the flight recorder,
copied from ``storm_tpu/runtime/tracing.py``.

A sampled record carries a :class:`TraceContext` (W3C ``traceparent``
ids) from spout ingress through batching, the device round trip (one
shared batch span linked to every member record's span) and sink egress,
so queue wait and device time separate per record. Finished traces live
in an in-process ring (:class:`TraceStore`); pipeline events (a batch
formed, an SLO breach, a shed decision, a graph captured) go to a bounded
JSONL :class:`FlightRecorder`.

Differences from storm_tpu:

- :class:`Tracer` owns its id generator and takes an optional ``seed``
  (storm_tpu draws from one module-global generator seeded by
  ``os.urandom``), so a seeded run's ids repeat;
- the flight recorder checks an event's kind against :data:`EVENT_KINDS`,
  the kinds the port emits, instead of storm_tpu's generated protocol
  registry; the one renamed kind is ``graph_capture`` (storm_tpu's
  ``xla_compile``: a bucket's eager forward and CUDA-graph capture);
- :func:`device_trace` runs ``torch.profiler`` (storm_tpu's runs
  ``jax.profiler``) and writes a Chrome trace into ``log_dir``.

Usage::

    with span(metrics, "inference-bolt", "decode"):
        ...                      # records decode_ms histogram

    with device_trace("/tmp/trace"):   # trace.json, loadable in Perfetto
        engine.predict(x)

    ctx = tracer.maybe_trace()         # None unless sampled (no allocation)
    if ctx is not None:
        tracer.record(ctx, "ingress", "spout", t0, t1)
"""

from __future__ import annotations

import collections
import contextlib
import json
import logging
import os
import random
import threading
import time
from typing import Any, Dict, Iterator, List, Optional, Tuple

from storm_tpu_torch.runtime.metrics import MetricsRegistry

log = logging.getLogger("storm_tpu_torch.tracing")

#: The flight-event kinds the port emits. A kind outside the set is still
#: recorded, with one warning per kind (a misspelt kind is otherwise
#: invisible: every reader filters on the spelling that never arrives).
EVENT_KINDS = frozenset({
    "autoscale_decision", "batch_formed", "bottleneck_shift", "cascade_escalation", "chaos_injection",
    "copy_amplification_high", "decode_session_evicted", "decode_session_migrated",
    "decode_session_started", "dist_circuit_close", "dist_circuit_open",
    "dist_heartbeat_miss", "dist_peer_replaced", "dist_reattached", "dist_worker_draining",
    "dist_worker_recovered", "dist_worker_restarted", "engine_quarantined", "engine_replaced", "executor_restart",
    "graph_capture", "plan_correction", "profile_regression", "ring_handoff", "scenario_phase",
    "shed_decision", "shed_degrade", "shed_reject", "slo_breach", "slo_burn", "tree_timeout",
    "wire_error", "worker_drained", "worker_draining",
})

_event_names_checked: set = set()


def _check_event_name(kind: str) -> None:
    if kind in _event_names_checked:
        return
    _event_names_checked.add(kind)
    if kind not in EVENT_KINDS:
        log.warning("flight event %r is not one of the port's event kinds "
                    "(storm_tpu_torch.runtime.tracing.EVENT_KINDS)", kind)


#: Split-phase substages of one device round trip, in execution order:
#: ``(timing key, stage label)``. The engine's ``InflightBatch.timings``
#: keys, the operator's substage histograms and the ``device_execute``
#: span's attributes all derive from this tuple. h2d = staging write +
#: host-to-device copy + replay launch (+ the capture of a cold bucket);
#: compute = launch -> forward done on the card; d2h = the device-to-host
#: copy and the rows out of the pinned buffer.
DEVICE_SUBSTAGES: Tuple[Tuple[str, str], ...] = (
    ("h2d_ms", "h2d"),
    ("compute_ms", "compute"),
    ("d2h_ms", "d2h"),
)


@contextlib.contextmanager
def span(metrics: Optional[MetricsRegistry], component: str, name: str) -> Iterator[None]:
    """Time a stage into the ``<name>_ms`` histogram of ``component``."""
    t0 = time.perf_counter()
    try:
        yield
    finally:
        if metrics is not None:
            metrics.histogram(component, f"{name}_ms").observe(
                (time.perf_counter() - t0) * 1e3)


@contextlib.contextmanager
def device_trace(log_dir: str) -> Iterator[Any]:
    """``torch.profiler`` trace of the host and, where a card exists, its
    kernels, written to ``<log_dir>/trace.json`` (Chrome trace format).
    Every thread of the process is recorded, as storm_tpu's device trace
    covers the whole process: a capture started on one thread holds the
    kernels that other threads launched (an engine's replays) with their
    launches. Yields the profiler, whose ``events()`` the caller may read."""
    import torch
    from torch.profiler import ProfilerActivity, _ExperimentalConfig, profile

    acts = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(ProfilerActivity.CUDA)
    os.makedirs(log_dir, exist_ok=True)
    with profile(activities=acts,
                 experimental_config=_ExperimentalConfig(profile_all_threads=True)) as prof:
        yield prof
        if torch.cuda.is_available():
            torch.cuda.synchronize()
    prof.export_chrome_trace(os.path.join(log_dir, "trace.json"))


# ---------------------------------------------------------------------------
# Per-record tracing
# ---------------------------------------------------------------------------

#: Sentinel for ``OutputCollector.emit(trace=...)``: the sampling decision
#: was already made upstream and missed; the collector must not roll again
#: (a spout that mints its own contexts would otherwise double the rate).
NOT_SAMPLED = object()


class TraceContext:
    """The W3C-trace-context identity a sampled tuple carries. Unsampled
    tuples carry ``trace=None``: sampling off allocates nothing."""

    __slots__ = ("trace_id", "span_id")

    def __init__(self, trace_id: str, span_id: str):
        self.trace_id = trace_id
        self.span_id = span_id

    def traceparent(self) -> str:
        # Version 00, sampled flag always 01: an unsampled record has no
        # context object at all.
        return f"00-{self.trace_id}-{self.span_id}-01"

    @classmethod
    def from_traceparent(cls, header: Optional[str]) -> Optional["TraceContext"]:
        """Parse ``00-<32hex>-<16hex>-<2hex>``; None on anything malformed
        (a garbage header must never take down the deliver path)."""
        if not header or not isinstance(header, str):
            return None
        parts = header.split("-")
        if len(parts) != 4 or len(parts[1]) != 32 or len(parts[2]) != 16:
            return None
        try:
            int(parts[1], 16), int(parts[2], 16)
        except ValueError:
            return None
        return cls(parts[1], parts[2])

    def to_bytes(self) -> Optional[bytes]:
        """24 raw bytes (16 trace id + 8 span id); None on a non-hex
        context."""
        try:
            return bytes.fromhex(self.trace_id) + bytes.fromhex(self.span_id)
        except ValueError:
            return None

    @classmethod
    def from_bytes(cls, raw: bytes) -> Optional["TraceContext"]:
        """Inverse of :meth:`to_bytes`; None on anything but 24 bytes."""
        if len(raw) != 24:
            return None
        return cls(raw[:16].hex(), raw[16:].hex())

    def __repr__(self) -> str:  # pragma: no cover - debug aid
        return f"TraceContext({self.traceparent()})"


class Span:
    """One timed operation of a trace. ``links`` holds the ids of other
    spans tied to this one without being its parent: the fan-in of N
    record spans into one shared device span."""

    __slots__ = ("name", "component", "span_id", "parent_id", "start",
                 "duration_ms", "attrs", "links")

    def __init__(self, name: str, component: str, span_id: str,
                 parent_id: Optional[str], start: float, duration_ms: float,
                 attrs: Optional[dict] = None,
                 links: Optional[Tuple[str, ...]] = None):
        self.name = name
        self.component = component
        self.span_id = span_id
        self.parent_id = parent_id
        self.start = start  # perf_counter of the recording process
        self.duration_ms = duration_ms
        self.attrs = attrs
        self.links = links

    def to_dict(self, t0: float) -> dict:
        d = {
            "name": self.name,
            "component": self.component,
            "span_id": self.span_id,
            "parent_id": self.parent_id,
            "offset_ms": round((self.start - t0) * 1e3, 3),
            "duration_ms": round(self.duration_ms, 3),
        }
        if self.attrs:
            d["attrs"] = self.attrs
        if self.links:
            d["links"] = list(self.links)
        return d


class TraceStore:
    """In-process ring of trace records: ``open`` starts one, spans append
    to it, ``finish`` moves it to the done ring (``capacity`` kept).
    Records of failed or timed-out trees are evicted oldest first once
    more than 4x ``capacity`` are open. Thread-safe: spans arrive from the
    event loop, the engine's fetch thread and the continuous queue's
    dispatcher."""

    def __init__(self, capacity: int = 256):
        self.capacity = max(1, int(capacity))
        self._lock = threading.Lock()
        # trace_id -> record, insertion-ordered for oldest-first eviction
        self._open: Dict[str, dict] = {}
        self._done: collections.deque = collections.deque(maxlen=self.capacity)
        self.dropped = 0  # evicted while open

    def _open_locked(self, trace_id: str) -> dict:
        rec = self._open.get(trace_id)
        if rec is None:
            rec = {"trace_id": trace_id, "opened_at": time.time(),
                   "t0": time.perf_counter(), "spans": []}
            self._open[trace_id] = rec
            while len(self._open) > 4 * self.capacity:
                self._open.pop(next(iter(self._open)))
                self.dropped += 1
        return rec

    def open(self, trace_id: str, t0: Optional[float] = None) -> None:
        with self._lock:
            rec = self._open_locked(trace_id)
            if t0 is not None:
                rec["t0"] = t0

    def add_span(self, trace_id: str, sp: Span) -> None:
        """Append a span, opening a partial record if none is open."""
        with self._lock:
            rec = self._open_locked(trace_id)
            if sp.start < rec["t0"]:
                rec["t0"] = sp.start
            rec["spans"].append(sp)

    def finish(self, trace_id: str, duration_ms: float) -> None:
        with self._lock:
            rec = self._open.pop(trace_id, None)
            if rec is None:
                return
            rec["duration_ms"] = round(duration_ms, 3)
            self._done.append(rec)

    # ---- read side --------------------------------------------------------

    @staticmethod
    def _render(rec: dict) -> dict:
        t0 = rec["t0"]
        return {"trace_id": rec["trace_id"], "opened_at": rec["opened_at"],
                "duration_ms": rec.get("duration_ms"),
                "spans": [s.to_dict(t0) for s in rec["spans"]]}

    def get(self, trace_id: str) -> Optional[dict]:
        with self._lock:
            for rec in self._done:
                if rec["trace_id"] == trace_id:
                    return self._render(rec)
            rec = self._open.get(trace_id)
            return self._render(rec) if rec else None

    def recent(self, n: int = 20) -> List[dict]:
        with self._lock:
            recs = list(self._done)[-n:]
        return [self._render(r) for r in reversed(recs)]

    def open_records(self, n: int = 20) -> List[dict]:
        """Still-open records, newest first (rendered under the lock: open
        span lists still grow)."""
        with self._lock:
            return [self._render(r) for r in reversed(list(self._open.values())[-n:])]

    def slowest(self, n: int = 20) -> List[dict]:
        with self._lock:
            recs = sorted(self._done, key=lambda r: r.get("duration_ms") or 0.0,
                          reverse=True)[:n]
        return [self._render(r) for r in recs]

    def stats(self) -> dict:
        with self._lock:
            return {"open": len(self._open), "done": len(self._done),
                    "dropped": self.dropped, "capacity": self.capacity}


class Tracer:
    """The sampling decision and span recording of one runtime. With
    ``sample_rate`` 0 (the default) :meth:`maybe_trace` returns None
    without allocating, and every call site guards span work behind
    ``tuple.trace is not None``. ``seed`` seeds the tracer's own id
    generator (None: from ``os.urandom``)."""

    def __init__(self, sample_rate: float = 0.0, store_capacity: int = 256,
                 seed: Optional[int] = None):
        self.sample_rate = float(sample_rate)
        self.store = TraceStore(store_capacity)
        self._rng = random.Random(os.urandom(16) if seed is None else seed)
        self._rng_lock = threading.Lock()

    @property
    def active(self) -> bool:
        return self.sample_rate > 0.0

    def _bits(self, n: int) -> int:
        with self._rng_lock:
            return self._rng.getrandbits(n)

    def new_trace_id(self) -> str:
        return f"{self._bits(128):032x}"

    def new_span_id(self) -> str:
        """A fresh span id (also for a span shared across traces: the
        batch's device span carries one id in every member trace)."""
        return f"{self._bits(64):016x}"

    def maybe_trace(self) -> Optional[TraceContext]:
        """A fresh sampled root context, or None (a miss, or sampling off)."""
        r = self.sample_rate
        if r <= 0.0:
            return None
        if r < 1.0:
            with self._rng_lock:
                miss = self._rng.random() >= r
            if miss:
                return None
        ctx = TraceContext(self.new_trace_id(), self.new_span_id())
        self.store.open(ctx.trace_id)
        return ctx

    def adopt(self, ctx: TraceContext) -> None:
        """Register a context minted elsewhere."""
        self.store.open(ctx.trace_id)

    def record(self, ctx: TraceContext, name: str, component: str,
               start: float, end: float, *, parent_id: Optional[str] = None,
               span_id: Optional[str] = None, attrs: Optional[dict] = None,
               links: Optional[Tuple[str, ...]] = None) -> str:
        """Record a finished span under ``ctx``'s trace; returns its id."""
        sid = span_id or self.new_span_id()
        self.store.add_span(ctx.trace_id, Span(
            name, component, sid, ctx.span_id if parent_id is None else parent_id,
            start, (end - start) * 1e3, attrs, links))
        return sid

    def finish(self, ctx: TraceContext, duration_ms: float) -> None:
        self.store.finish(ctx.trace_id, duration_ms)


class FlightRecorder:
    """Bounded structured-event log. Events always land in an in-memory
    ring (``tail``); with ``path`` set they are also appended as JSONL,
    rotated by size (``path`` -> ``path.1`` -> ... up to ``max_files``).
    Thread-safe. A failing disk never takes the pipeline down: a write
    error drops the file and keeps the ring."""

    def __init__(self, path: str = "", capacity: int = 512,
                 max_bytes: int = 4 * 1024 * 1024, max_files: int = 3):
        self.path = path or ""
        self.max_bytes = max(4096, int(max_bytes))
        self.max_files = max(1, int(max_files))
        self._ring: collections.deque = collections.deque(maxlen=max(16, int(capacity)))
        self._lock = threading.Lock()
        self._fh = None
        self._size = 0
        self._last: Dict[str, float] = {}  # kind -> last wall ts (throttle)
        if self.path:
            try:
                self._fh = open(self.path, "a", encoding="utf-8")
                self._size = self._fh.tell()
            except OSError:
                self._fh = None

    def _rotate_locked(self) -> None:
        self._fh.close()
        for i in range(self.max_files - 1, 0, -1):
            src = self.path if i == 1 else f"{self.path}.{i - 1}"
            try:
                os.replace(src, f"{self.path}.{i}")
            except OSError:
                pass
        self._fh = open(self.path, "a", encoding="utf-8")
        self._size = 0

    def event(self, kind: str, *, throttle_s: float = 0.0, **fields: Any) -> bool:
        """Record one event; False when throttled away (``throttle_s``
        drops repeats of ``kind`` within the window)."""
        _check_event_name(kind)
        now = time.time()
        with self._lock:
            if throttle_s > 0.0:
                if now - self._last.get(kind, 0.0) < throttle_s:
                    return False
                self._last[kind] = now
            ev = {"ts": round(now, 3), "kind": kind}
            ev.update(fields)
            self._ring.append(ev)
            if self._fh is not None:
                try:
                    line = json.dumps(ev, default=str) + "\n"
                    if self._size + len(line) > self.max_bytes:
                        self._rotate_locked()
                    self._fh.write(line)
                    self._fh.flush()
                    self._size += len(line)
                except (OSError, ValueError):
                    self._fh = None  # disk trouble: keep the ring, drop the file
        return True

    def tail(self, n: int = 50) -> List[dict]:
        with self._lock:
            return list(self._ring)[-n:]

    def close(self) -> None:
        with self._lock:
            if self._fh is not None:
                try:
                    self._fh.close()
                except OSError:
                    pass
                self._fh = None
