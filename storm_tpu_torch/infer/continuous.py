"""Per-engine continuous batching, the counterpart of
``storm_tpu/infer/continuous.py``: one slot-level queue per shared engine.

Every inference task on an engine ``submit``s its records' rows into the
engine's one queue, and a dispatcher thread forms batches from it and
refills a slot of the engine's pipeline ring the moment one frees,
instead of each task forming its own batches on a deadline. An engine
with only ``predict`` (the decode engine) runs each batch on the
dispatcher thread, one at a time. Dispatch rule
(work-conserving slot refill):

- ``max_batch`` rows pending -> dispatch (the ring parks the dispatcher:
  that is the backpressure);
- a ring slot free and at least one batch in flight -> dispatch at once,
  with whatever coalesced while the card worked;
- the card idle -> ``eager`` dispatches on arrival, otherwise the oldest
  row ages to ``max_wait_ms``.

Rows queue per ``tenant:lane`` key. A formation orders keys
earliest-deadline-first (lane deadlines from ``QosConfig``, so a fresh
high-priority record still preempts queued best-effort ones), takes rows
weighted-round-robin across keys (weight: the lane's priority), and
serves first a key passed over ``BatchConfig.starvation_rounds``
formations in a row.

Exactly-once per source: ``submit`` returns a :class:`Submission` whose
future resolves to that record's own rows; when a coalesced batch fails,
every member's future gets the exception and each source fails and
replays its own tuples.

The registry keeps one queue per live engine, held weakly. Unlike
storm_tpu's (``continuous.py:537-556``, which builds the queue while it
holds its non-reentrant lock, so a garbage collection there that runs a
dead engine's finalizer deadlocks the thread on that lock), the port runs
no finalizer work under its lock: an engine's finalizer only appends its
key to a lock-free deque, the queue is built outside the lock, and dead
entries are dropped, and their queues closed, outside the lock on the
next registry call.

Observability, bound with the metrics by the first task: each completed
batch records a throttled ``batch_formed`` flight event and, for its
sampled members, a ``queue_wait`` span each (submission -> the batch
leaving the dispatcher) and one shared device span linked to them all.
Both run on the engine's fetch thread after the batch's timings are
taken, and never under the queue's or the registry's lock.
"""

from __future__ import annotations

import threading
import time
import weakref
from collections import OrderedDict, deque
from concurrent.futures import Future
from typing import Callable, Dict, List, Optional

import numpy as np

from storm_tpu_torch.config import BatchConfig, QosConfig
from storm_tpu_torch.runtime.tracing import DEVICE_SUBSTAGES

# How long close() waits for the dispatcher thread, and how often an idle
# dispatcher checks that its engine is still alive.
JOIN_TIMEOUT_S = 5.0
IDLE_CHECK_S = 1.0


class Submission:
    """One submitted record in the queue. ``future`` resolves (on the
    engine's fetch thread) to this record's ``(n, K)`` prediction rows, or
    to the exception that failed the batch it rode in. ``batch_span`` is
    that batch's shared device span id once traced (a cascade links the
    next tier's ``queue_wait`` to it)."""

    __slots__ = ("data", "payload", "ts", "enq", "lane", "tenant", "source",
                 "deadline", "future", "batch_span")

    def __init__(self, data, payload, ts: float, enq: float, lane: Optional[str],
                 tenant: Optional[str], source: str, deadline: float) -> None:
        self.data = data
        self.payload = payload
        self.ts = ts
        self.enq = enq
        self.lane = lane
        self.tenant = tenant
        self.source = source
        self.deadline = deadline
        self.future: Future = Future()
        self.batch_span: Optional[str] = None

    @property
    def rows(self) -> int:
        return int(self.data.shape[0])


class ContinuousBatcher:
    """The continuous batch former of one shared engine.

    ``submit`` is thread-safe from any thread; one dispatcher thread owns
    batch formation and ``engine.dispatch`` (so the engine's dispatch
    order is total), and the engine's fetch thread resolves the members'
    futures through the batch's done-callback. The engine is held weakly:
    the engine cache must stay free to evict it; a dead engine fails the
    rows still queued."""

    def __init__(self, engine, cfg: BatchConfig, qos: Optional[QosConfig] = None) -> None:
        self.cfg = cfg
        self.qos = qos if (qos is not None and qos.enabled) else None
        self._engine_ref = weakref.ref(engine)
        self.engine_name = getattr(getattr(engine, "model_cfg", None), "name",
                                   type(engine).__name__)
        # The engine's ring depth: batches in flight. ``_inflight`` mirrors
        # it so "a slot just freed" is a local decision; the ring inside
        # engine.dispatch stays the hard bound.
        self.capacity = max(1, int(getattr(engine, "ring_capacity",
                                           getattr(engine, "pipeline_depth", 1)) or 1))
        self._cond = threading.Condition()
        # tenant:lane key -> FIFO of Submissions (deadlines rise along it).
        self._queues: "OrderedDict[tuple, deque]" = OrderedDict()
        self._skipped: Dict[tuple, int] = {}
        self._pending_rows = 0
        self._inflight = 0
        self._force = False  # flush(): dispatch regardless of the deadline
        self._thread: Optional[threading.Thread] = None
        self._closed = False
        # Stats.
        self.batches = 0
        self.rows_dispatched = 0
        self.fair_rows: Dict[tuple, int] = {}
        self.fair_starved: Dict[tuple, int] = {}
        self.last_batch: Optional[dict] = None
        self._fills: deque = deque(maxlen=256)
        # Metrics, tracer and flight recorder, bound by the first task to bind.
        self._metrics = None
        self._m: Dict[str, object] = {}
        self._cid: Optional[str] = None
        self._tracer = None
        self._flight = None
        self._trace_of: Optional[Callable] = None
        self._link_of: Optional[Callable] = None
        self._span_name = "device_execute"

    # ---- binding -------------------------------------------------------------

    def bind(self, metrics, component_id: str, tracer=None, flight=None,
             trace_of: Optional[Callable] = None,
             link_of: Optional[Callable] = None,
             span_name: str = "device_execute") -> None:
        """Attach the metrics the queue records (``batch_size``,
        ``batch_fill``, ``device_ms``, ``batch_wait_ms``,
        ``dispatch_wait_ms``, ``instances_inferred``, ``coalesced_sources``
        and the substages), the tracer (``trace_of(payload)`` gives a
        record's context, ``link_of(payload)`` the span its ``queue_wait``
        links back to, if any; the shared span is named ``span_name``) and
        the flight recorder. The first binder wins: the tasks sharing the
        engine all bind, and the queue's metrics land once."""
        with self._cond:
            if self._metrics is not None:
                return
            self._metrics = metrics
            self._cid = component_id
            self._tracer = tracer
            self._flight = flight
            self._trace_of = trace_of
            self._link_of = link_of
            self._span_name = span_name
            m, cid = metrics, component_id
            self._m = {
                "batch_size": m.histogram(cid, "batch_size"),
                "batch_fill": m.histogram(cid, "batch_fill"),
                "device_ms": m.histogram(cid, "device_ms"),
                "batch_wait": m.histogram(cid, "batch_wait_ms"),
                "disp_wait": m.histogram(cid, "dispatch_wait_ms"),
                "infer": m.counter(cid, "instances_inferred"),
                "coalesced": m.counter(cid, "coalesced_sources"),
                "substage": {key: m.histogram(cid, key) for key, _ in DEVICE_SUBSTAGES},
            }

    # ---- submission ----------------------------------------------------------

    def _key(self, tenant: Optional[str], lane: Optional[str]) -> tuple:
        if self.qos is not None:
            lane = lane if lane in self.qos.lanes else self.qos.default_lane
        return (tenant or "default", lane or "default")

    def _deadline_ms(self, lane: Optional[str]) -> float:
        if self.qos is not None:
            return self.qos.deadline_for(lane)
        return self.cfg.max_wait_ms

    def submit(self, data: np.ndarray, payload=None, ts: Optional[float] = None,
               lane: Optional[str] = None, tenant: Optional[str] = None,
               source: str = "anon") -> Submission:
        """Queue one record's rows; never blocks (per-source backpressure
        is the caller's, the ring the card's)."""
        now = time.perf_counter()
        base = ts if ts is not None else now
        sub = Submission(data, payload, base, now, lane, tenant, source,
                         base + self._deadline_ms(lane) / 1e3)
        with self._cond:
            if self._closed:
                raise RuntimeError("continuous batcher is closed")
            self._queues.setdefault(self._key(tenant, lane), deque()).append(sub)
            self._pending_rows += sub.rows
            if self._thread is None or not self._thread.is_alive():
                self._thread = threading.Thread(
                    target=self._loop, daemon=True,
                    name=f"storm-tpu-torch-contbatch-{self.engine_name}")
                self._thread.start()
            self._cond.notify_all()
        return sub

    def flush(self) -> None:
        """Dispatch everything pending (a graceful drain): the flag holds
        until the queue is empty."""
        with self._cond:
            self._force = True
            self._cond.notify_all()

    def close(self) -> None:
        """Refuse new rows, fail the rows still queued (their sources
        replay), and join the dispatcher thread (bounded)."""
        with self._cond:
            self._closed = True
            stranded = [s for q in self._queues.values() for s in q]
            self._queues.clear()
            self._pending_rows = 0
            self._cond.notify_all()
            thread = self._thread
        err = RuntimeError(f"continuous batcher of {self.engine_name!r} closed with rows queued")
        for s in stranded:
            s.future.set_exception(err)
        if thread is not None and thread is not threading.current_thread():
            thread.join(JOIN_TIMEOUT_S)

    def __len__(self) -> int:
        return self._pending_rows

    @property
    def inflight(self) -> int:
        return self._inflight

    # ---- the dispatcher thread -----------------------------------------------

    def _oldest_enq_locked(self) -> float:
        return min(q[0].enq for q in self._queues.values() if q)

    def _loop(self) -> None:
        while True:
            with self._cond:
                while True:
                    if self._closed:
                        return
                    if self._pending_rows == 0:
                        self._force = False
                        self._cond.wait(IDLE_CHECK_S)
                        if self._engine_ref() is None and self._pending_rows == 0:
                            self._closed = True  # the engine is gone: so is its queue
                            return
                        continue
                    now = time.perf_counter()
                    full = self._pending_rows >= self.cfg.max_batch
                    slot_free = self._inflight < self.capacity
                    due = (now - self._oldest_enq_locked()) * 1e3 >= self.cfg.max_wait_ms
                    if full or self._force or (slot_free and (
                            self._inflight > 0 or self.cfg.eager or due)):
                        # A full or forced batch may go with every slot
                        # busy: engine.dispatch parks on the ring, on this
                        # thread, never the event loop.
                        break
                    if slot_free:
                        # Idle and not eager: age toward the deadline.
                        wait_s = self.cfg.max_wait_ms / 1e3 - (now - self._oldest_enq_locked())
                        self._cond.wait(timeout=max(wait_s, 1e-4))
                    else:
                        # Every slot busy, too few rows to force a park.
                        self._cond.wait()
                items = self._form_locked()
                self._inflight += 1
            self._dispatch(items)

    # ---- batch formation: EDF, weighted round-robin, starvation bound --------

    def _lane_weight(self, key: tuple) -> int:
        if self.qos is None:
            return 1
        # The highest lane draws len(lanes) rows a pass, the lowest one.
        return len(self.qos.lanes) - self.qos.lane_index(key[1])

    def _form_locked(self) -> List[Submission]:
        """Up to ``max_batch`` rows across keys. Key order: starved keys
        (passed over >= starvation_rounds formations, most starved first),
        then the earliest head-of-line deadline; rows are taken
        weighted-round-robin in that order."""
        max_rows = max(1, self.cfg.max_batch)
        rounds = max(1, int(self.cfg.starvation_rounds))
        keys = [k for k, q in self._queues.items() if q]
        starved = sorted((k for k in keys if self._skipped.get(k, 0) >= rounds),
                         key=lambda k: -self._skipped.get(k, 0))
        rest = sorted((k for k in keys if k not in starved),
                      key=lambda k: self._queues[k][0].deadline)
        order = starved + rest
        for k in starved:
            self.fair_starved[k] = self.fair_starved.get(k, 0) + 1
            if self._metrics is not None and self.qos is not None:
                self._metrics.counter("qos", f"fair_starved_{k[0]}_{k[1]}").inc()
        items: List[Submission] = []
        size = 0
        capped = False
        while not capped:
            progressed = False
            for k in order:
                q = self._queues[k]
                for _ in range(self._lane_weight(k)):
                    if not q:
                        break
                    n = q[0].rows
                    if items and size + n > max_rows:
                        # Leftovers stay pending; an oversized record still
                        # ships alone.
                        capped = True
                        break
                    items.append(q.popleft())
                    size += n
                    progressed = True
                    if size >= max_rows:
                        capped = True
                        break
                if capped:
                    break
            if not progressed:
                break
        self._pending_rows -= size
        contributed: Dict[tuple, int] = {}
        for it in items:
            k = self._key(it.tenant, it.lane)
            contributed[k] = contributed.get(k, 0) + it.rows
        for k, n in contributed.items():
            self._skipped[k] = 0
            self.fair_rows[k] = self.fair_rows.get(k, 0) + n
            if self._metrics is not None and self.qos is not None:
                self._metrics.counter("qos", f"fair_rows_{k[0]}_{k[1]}").inc(n)
        for k in keys:
            if k not in contributed and self._queues.get(k):
                self._skipped[k] = self._skipped.get(k, 0) + 1
        if self._pending_rows == 0:
            self._force = False
        return items

    # ---- the device round trip -----------------------------------------------

    def _dispatch(self, items: List[Submission]) -> None:
        """On the dispatcher thread; ``engine.dispatch`` may park on the
        ring. Every outcome goes through :meth:`_finish`, which frees the
        mirrored slot once."""
        t0 = time.perf_counter()
        try:
            engine = self._engine_ref()
            if engine is None:
                raise RuntimeError(f"engine {self.engine_name!r} was evicted with rows queued")
            if self._m:
                for it in items:
                    self._m["batch_wait"].observe((t0 - it.enq) * 1e3)
            dispatch = getattr(engine, "dispatch", None)
            if dispatch is None:
                # A predict-only engine (the decode engine): one batch at
                # a time, here on the dispatcher thread.
                parts = [it.data for it in items]
                out = engine.predict(parts[0] if len(parts) == 1 else np.concatenate(parts))
                self._finish(items, out, None, None, t0)
                return
            handle = dispatch([it.data for it in items])
        except BaseException as e:  # noqa: BLE001 - fail ONLY this batch
            self._finish(items, None, e, None, t0)
            return
        t1 = time.perf_counter()
        if self._m:
            # Time parked on the engine's ring.
            self._m["disp_wait"].observe((t1 - t0) * 1e3)
        handle.future.add_done_callback(
            lambda f, its=items, h=handle, b=t1: self._on_done(its, f, h, b))

    def _on_done(self, items: List[Submission], fut: Future, handle, t_disp: float) -> None:
        exc = fut.exception()
        self._finish(items, None if exc is not None else fut.result(), exc, handle, t_disp)

    def _finish(self, items, out, exc, handle, t_disp: float) -> None:
        t_done = time.perf_counter()
        with self._cond:
            self._inflight -= 1
            self._cond.notify_all()
        if exc is not None:
            # Exactly-once per source: each member fails with the batch.
            for it in items:
                it.future.set_exception(exc)
            return
        rows = sum(it.rows for it in items)
        padded = int(getattr(handle, "padded", rows) or rows) if handle is not None else rows
        fill = rows / max(padded, 1)
        sources = {it.source for it in items}
        self.batches += 1
        self.rows_dispatched += rows
        self._fills.append(fill)
        self.last_batch = {"rows": rows, "padded": padded, "fill": round(fill, 4),
                           "records": len(items), "sources": sorted(sources)}
        timings = getattr(handle, "timings", None) if handle is not None else None
        if self._tracer is not None and self._tracer.active:
            batch_span = self._trace(items, t_disp, t_done, timings, fill, len(sources))
            if batch_span is not None:
                for it in items:
                    it.batch_span = batch_span
        if self._m:
            self._m["batch_size"].observe(rows)
            self._m["batch_fill"].observe(fill)
            self._m["device_ms"].observe((t_done - t_disp) * 1e3)
            self._m["infer"].inc(rows)
            self._m["coalesced"].inc(len(sources))
            for key, _ in DEVICE_SUBSTAGES:
                if timings and key in timings:
                    self._m["substage"][key].observe(timings[key])
        if self._flight is not None:
            self._flight.event(
                "batch_formed", throttle_s=1.0, component=self._cid or "continuous",
                size=rows, records=len(items), fill=round(fill, 3), sources=len(sources),
                device_ms=round((t_done - t_disp) * 1e3, 3), continuous=True)
        ofs = 0
        for it in items:
            it.future.set_result(out[ofs:ofs + it.rows])
            ofs += it.rows

    def _trace(self, items, t0, t1, timings, fill, n_sources) -> Optional[str]:
        """The operator's batch tracing at record granularity: a
        ``queue_wait`` span per sampled record (linked back to the span
        that escalated it, if any), one shared device span linked to all
        of them with the fill, sources and substages. Returns the shared
        span's id (None when no member is sampled)."""
        tracer = self._tracer
        cid = self._cid or "continuous"
        traced = []
        for it in items:
            ctx = self._trace_of(it.payload) if self._trace_of else None
            if ctx is not None:
                back = self._link_of(it.payload) if self._link_of else None
                traced.append((ctx, tracer.record(ctx, "queue_wait", cid, it.enq or t0, t0,
                                                  links=(back,) if back else ())))
        if not traced:
            return None
        batch_span = tracer.new_span_id()
        links = tuple(qid for _, qid in traced)
        attrs = {"batch_size": sum(it.rows for it in items), "records": len(items),
                 "fill": round(fill, 3), "sources": n_sources, "continuous": True}
        for key, _ in DEVICE_SUBSTAGES:
            if timings and key in timings:
                attrs[key] = round(timings[key], 3)
        for ctx, qid in traced:
            tracer.record(ctx, self._span_name, cid, t0, t1, span_id=batch_span,
                          parent_id=qid, links=links, attrs=attrs)
        return batch_span

    # ---- introspection -------------------------------------------------------

    def fill_median(self) -> Optional[float]:
        if not self._fills:
            return None
        return float(np.median(list(self._fills)))

    def stats(self) -> dict:
        """Fairness, fill and queue summary."""
        with self._cond:
            pending = {f"{k[0]}:{k[1]}": sum(s.rows for s in q)
                       for k, q in self._queues.items() if q}
            oldest_ms = 0.0
            if pending:
                oldest_ms = max(0.0, (time.perf_counter() - self._oldest_enq_locked()) * 1e3)
        med = self.fill_median()
        return {
            "engine": self.engine_name,
            "capacity": self.capacity,
            "inflight": self._inflight,
            "pending_rows": self._pending_rows,
            "oldest_ms": round(oldest_ms, 3),
            "pending_by_key": pending,
            "batches": self.batches,
            "rows": self.rows_dispatched,
            "batch_fill_p50": None if med is None else round(med, 4),
            "fair_rows": {f"{k[0]}:{k[1]}": v for k, v in self.fair_rows.items()},
            "fair_starved": {f"{k[0]}:{k[1]}": v for k, v in self.fair_starved.items()},
            "last_batch": self.last_batch,
        }


# ---- the per-engine registry -----------------------------------------------------

# One queue per live engine object: the tasks sharing an engine (through
# shared_engine) get the same queue, which is what makes them co-batch.
_REGISTRY: Dict[int, ContinuousBatcher] = {}
_REGISTRY_LOCK = threading.Lock()
# Keys of engines that died, appended by their finalizers. A deque's append
# and popleft are atomic: a finalizer that a garbage collection runs on a
# thread holding _REGISTRY_LOCK appends here and returns, never waiting on
# the lock (storm_tpu's C3 self-deadlock).
_DEAD: deque = deque()


def _take_dead_locked() -> List[ContinuousBatcher]:
    """Under the lock: drop the entries whose engine died, returned for
    the caller to close outside the lock."""
    dead = []
    while _DEAD:
        key = _DEAD.popleft()
        cb = _REGISTRY.get(key)
        # A live entry under the key is a new engine that reused the id.
        if cb is not None and cb._engine_ref() is None:
            dead.append(_REGISTRY.pop(key))
    return dead


def _close_all(batchers: List[ContinuousBatcher]) -> None:
    for cb in batchers:
        cb.close()


def continuous_for(engine, cfg: BatchConfig,
                   qos: Optional[QosConfig] = None) -> ContinuousBatcher:
    """The engine's continuous queue, made on first use; ``cfg`` and
    ``qos`` apply when it is made (the first caller's win: every source on
    an engine shares one formation policy, as it shares the buckets)."""
    key = id(engine)
    with _REGISTRY_LOCK:
        dead = _take_dead_locked()
        cb = _REGISTRY.get(key)
        if cb is not None and cb._engine_ref() is not engine:
            dead.append(_REGISTRY.pop(key))
            cb = None
    _close_all(dead)
    if cb is not None:
        return cb
    # Built outside the lock: a collection here may run any finalizer.
    new = ContinuousBatcher(engine, cfg, qos)
    with _REGISTRY_LOCK:
        cb = _REGISTRY.get(key)
        if cb is None or cb._engine_ref() is not engine:
            _REGISTRY[key] = cb = new
    if cb is new:
        weakref.finalize(engine, _DEAD.append, key)
    return cb


def registry_stats() -> List[dict]:
    """Stats of every live continuous queue."""
    with _REGISTRY_LOCK:
        dead = _take_dead_locked()
        cbs = [cb for cb in _REGISTRY.values() if cb._engine_ref() is not None]
    _close_all(dead)
    return [cb.stats() for cb in cbs]


def _reset_registry() -> None:
    """Close and drop every queue (tests)."""
    with _REGISTRY_LOCK:
        cbs = list(_REGISTRY.values())
        _REGISTRY.clear()
        _DEAD.clear()
    _close_all(cbs)
