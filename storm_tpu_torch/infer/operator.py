"""The inference operator, the counterpart of ``storm_tpu/infer/operator.py``
on its split-phase path, with QoS lanes and shedding and continuous
batching. Still trimmed from it: cascades (and with them
``qos.degrade_model``), record frames and chunked tuples, tracing beyond
the ``decode_ms`` and ``encode_ms`` spans and the flight recorder, the
copy ledger, and ``swap_model``.

Per tuple: decode the ``{"instances": ...}`` payload and check it against
the model's input shape — a failure emits a :class:`DeadLetter` on the
``dead_letter`` stream and acks (replaying poison can never succeed); feed
the micro-batcher; a full batch, the deadline, or (with ``eager``) a free
dispatch slot sends the batch to the shared engine's ``dispatch`` on a
worker thread (it may park on the engine's ring), and the batch's future
resolves from the engine's fetch thread, so the event loop keeps consuming
while the card computes. Then one ``{"predictions": ...}`` tuple per
record, anchored to it, and the ack. A failed batch fails every tuple in
it, which the spout replays.

When the engine's watchdog quarantines it, every task on that engine
records it and takes a fresh engine from ``shared_engine`` (built once for
them all) on a background thread, swapping it in once warm; batches
dispatched meanwhile fail fast (``EngineQuarantined``) and replay.

With QoS on (``qos=QosConfig(enabled=True)``) the batcher is the
earliest-deadline-first :class:`~storm_tpu_torch.qos.lanes.LaneBatcher`,
and while the shed level (gauge ``("qos", "shed_level")``) covers a
tuple's lane, the tuple is answered before its decode with one
:class:`Overloaded` record and acked (shed load is never replayed).
``passthrough`` names input fields copied onto every output tuple
(``("qos_lane",)`` carries the lane to the sink's per-lane histograms).

With ``BatchConfig(continuous=True)`` the task forms no batches: it
submits each record to its engine's shared queue
(:func:`~storm_tpu_torch.infer.continuous.continuous_for`), where every
task on the engine co-batches, and completes the record from a task of
its own when the record's rows come back; each task keeps at most
``max_inflight * max_batch`` rows outstanding.
"""

from __future__ import annotations

import asyncio
import logging
import threading
import time
import weakref
from typing import Optional, Sequence, Set

from storm_tpu_torch import native
from storm_tpu_torch.api.schema import (
    DeadLetter, Overloaded, SchemaError, decode_instances, encode_predictions)
from storm_tpu_torch.config import BatchConfig, ModelConfig, QosConfig
from storm_tpu_torch.infer.batcher import Batch, MicroBatcher
from storm_tpu_torch.infer.continuous import continuous_for
from storm_tpu_torch.infer.engine import DEVICE_SUBSTAGES, shared_engine
from storm_tpu_torch.runtime.base import Bolt, OutputCollector, TopologyContext
from storm_tpu_torch.runtime.tracing import span
from storm_tpu_torch.runtime.tuples import Tuple, Values

logger = logging.getLogger(__name__)


class _QuarantineFanout:
    """The one ``on_quarantine`` hook of an engine that several operator
    tasks share: it tells every task on the engine, so each swaps in the
    replacement. (storm_tpu assigns each task's own callback to the hook,
    ``storm_tpu/infer/operator.py:285-286``; the last task to prepare
    wins, and the others keep the quarantined engine for good.) Tasks are
    held weakly: the engine must not keep a finished topology alive."""

    def __init__(self) -> None:
        self._tasks: "weakref.WeakSet[InferenceBolt]" = weakref.WeakSet()
        self._lock = threading.Lock()

    def add(self, task: "InferenceBolt") -> None:
        with self._lock:
            self._tasks.add(task)

    def __call__(self, trips: int) -> None:
        with self._lock:
            tasks = list(self._tasks)
        for task in tasks:
            try:
                task._engine_quarantined(trips)
            except Exception:
                logger.exception("a task's quarantine handler failed")


def _listen_for_quarantine(engine, task: "InferenceBolt") -> None:
    """Add ``task`` to ``engine``'s quarantine fan-out, installing it as
    the engine's hook on first use."""
    hook = getattr(engine, "on_quarantine", None)
    if not isinstance(hook, _QuarantineFanout):
        hook = _QuarantineFanout()
        try:
            engine.on_quarantine = hook
        except AttributeError:
            return  # a slotted test double
    hook.add(task)


class InferenceBolt(Bolt):
    """``device``: where the shared engine runs (default ``cuda``; pass
    ``"cpu"`` for the CPU). ``engine``: an engine to use instead of the
    shared one (e.g. a ``NullEngine``); ``warmup=False`` skips building
    the buckets before traffic. ``passthrough``: input fields copied onto
    every output tuple. ``qos``: a ``QosConfig`` (on when enabled)."""

    def __init__(self, model: Optional[ModelConfig] = None,
                 batch: Optional[BatchConfig] = None, device=None,
                 engine=None, warmup: bool = True, passthrough: Sequence[str] = (),
                 qos: Optional[QosConfig] = None) -> None:
        self.model_cfg = model or ModelConfig()
        self.batch_cfg = batch or BatchConfig()
        self.device = device
        self._engine = engine
        self._warmup = warmup
        self.passthrough = tuple(passthrough)
        self.qos = qos if (qos is not None and qos.enabled) else None
        if self.qos is not None and self.qos.degrade_model:
            # storm_tpu serves shed lanes on this model through a
            # two-tier cascade (operator.py:151-164); the cascade is not
            # ported, and rejecting instead would be a different result.
            raise NotImplementedError(
                f"qos.degrade_model={self.qos.degrade_model!r} needs the cascade "
                "router, which storm_tpu_torch does not have yet")

    def clone(self) -> "InferenceBolt":
        return InferenceBolt(self.model_cfg, self.batch_cfg, self.device,
                             self._engine, self._warmup, self.passthrough, self.qos)

    def declare_output_fields(self):
        fields = ("message",) + self.passthrough
        return {"default": fields, "dead_letter": fields}

    def _extras(self, t: Tuple) -> list:
        # A stream without a passthrough field yields None for it.
        return [t.get(f, None) for f in self.passthrough]

    def _shared_engine(self):
        return shared_engine(self.model_cfg, self.batch_cfg, device=self.device)

    def prewarm(self) -> None:
        """Build and warm the engine, and build or load the native codec,
        off the event loop before this task receives traffic, so a cold
        build rides neither the loop nor live tuples; ``prepare`` then skips
        its warm-up. An engine given at construction is kept."""
        native.load()
        self._engine = self._engine or self._shared_engine()
        if self._warmup:
            self._engine.warmup()
        self._prewarmed = True

    def prepare(self, context: TopologyContext, collector: OutputCollector) -> None:
        super().prepare(context, collector)
        # The codec is built before traffic (a no-op once prewarmed): its
        # first use would otherwise compile it on the event loop.
        native.load()
        # One engine per model per process: the tasks share its weights.
        self.engine = self._engine or self._shared_engine()
        if self._warmup and not getattr(self, "_prewarmed", False):
            self.engine.warmup()
        if self.qos is not None:
            # Imported here: qos.lanes imports infer.batcher, whose package
            # imports this module.
            from storm_tpu_torch.qos.lanes import LaneBatcher

            self.batcher = LaneBatcher(self.batch_cfg, self.qos)
        else:
            self.batcher = MicroBatcher(self.batch_cfg)
        self._flush_task: Optional[asyncio.Task] = None
        self._inflight: Set[asyncio.Task] = set()
        self._dispatch_sem = asyncio.Semaphore(max(1, self.batch_cfg.max_inflight))
        self._eager = self.batch_cfg.eager
        # Eager dispatches created but not yet through the semaphore:
        # locked() alone is optimistic (the task acquires a tick later), and
        # two same-tick arrivals would otherwise each ship a tiny batch.
        self._eager_pending = 0
        m, cid = context.metrics, context.component_id
        self._m_batch = m.histogram(cid, "batch_size")
        self._m_device_ms = m.histogram(cid, "device_ms")
        self._m_dead = m.counter(cid, "dead_lettered")
        self._m_infer = m.counter(cid, "instances_inferred")
        # Where a record's time goes before the device: in the batcher,
        # then waiting for a dispatch slot (max_inflight).
        self._m_batch_wait = m.histogram(cid, "batch_wait_ms")
        self._m_disp_wait = m.histogram(cid, "dispatch_wait_ms")
        # Fragmentation: rows / padded bucket, and sources per batch.
        self._m_fill = m.histogram(cid, "batch_fill")
        self._m_coalesced = m.counter(cid, "coalesced_sources")
        # The engine's substages; together they decompose device_ms.
        self._m_substage = {key: m.histogram(cid, key) for key, _ in DEVICE_SUBSTAGES}
        # Quarantine -> replacement (batch.watchdog_trips).
        self._m_quarantined = m.gauge(cid, "engine_quarantined")
        self._m_wd_trips = m.counter(cid, "watchdog_trips")
        _listen_for_quarantine(self.engine, self)
        # QoS: the shed level is read once per tuple.
        if self.qos is not None:
            self._shed_gauge = m.gauge("qos", "shed_level")
            self._m_shed = m.counter(cid, "shed_rejected")
        # Continuous batching: formation moves to the engine's shared
        # queue; this task bounds its outstanding rows at the row
        # equivalent of max_inflight batches.
        self._continuous = bool(self.batch_cfg.continuous)
        if self._continuous:
            self._cb = self._bind_queue(self.engine)
            self._cb_cap = max(1, self.batch_cfg.max_inflight) * max(1, self.batch_cfg.max_batch)
            self._cb_rows = 0
            self._cb_room = asyncio.Event()
            self._cb_room.set()
            self._cb_source = f"{cid}#{context.task_index}"

    def _bind_queue(self, engine):
        """``engine``'s continuous queue, its metrics bound to this
        component (the first task to bind wins)."""
        cb = continuous_for(engine, self.batch_cfg, self.qos)
        cb.bind(self.context.metrics, self.context.component_id)
        return cb

    # ---- quarantine -> replacement -------------------------------------------

    def _engine_quarantined(self, trips: int) -> None:
        """Called once per quarantine of this task's engine (on its fetch
        thread, through the engine's :class:`_QuarantineFanout`): record
        the quarantine, then build and warm a replacement off-thread and
        swap it in. The quarantined engine left the shared cache, so
        ``shared_engine`` builds a fresh one; every task that shared the
        old engine asks for the same key, and the cache builds it once."""
        self._m_quarantined.set(1)
        self._m_wd_trips.inc(trips)
        old = self.engine

        def rebuild() -> None:
            try:
                eng = self._shared_engine()
                if self._warmup:
                    eng.warmup()
                eng.on_compile = old.on_compile
                _listen_for_quarantine(eng, self)
                if self._continuous:
                    # Every task re-aims at the replacement's one queue.
                    self._cb = self._bind_queue(eng)
                self.engine = eng
                self._m_quarantined.set(0)
            except Exception:
                logger.exception("replacement engine build failed; the component stays "
                                 "quarantined (batches fail fast and replay)")

        threading.Thread(target=rebuild, name="engine-replace", daemon=True).start()

    # ---- ingest --------------------------------------------------------------

    async def execute(self, t: Tuple) -> None:
        payload = t.get("message")
        lane = t.get("qos_lane", None) if self.qos is not None else None
        if self.qos is not None:
            level = int(self._shed_gauge.value)
            if level > 0 and self.qos.shed_eligible(lane, level):
                # Shed before the decode: spend nothing on traffic that
                # will not be served.
                await self._shed_tuple(t, lane, level)
                return
        try:
            with span(self.context.metrics, self.context.component_id, "decode"):
                inst = decode_instances(payload, ts=t.root_ts)
            if tuple(inst.data.shape[1:]) != self.engine.input_shape:
                raise SchemaError(
                    f"instance shape {tuple(inst.data.shape[1:])} != model "
                    f"input {self.engine.input_shape}")
        except SchemaError as e:
            await self._dead_letter(t, payload, str(e))
            return
        ts = t.root_ts or None
        if self._continuous:
            await self._submit_record(t, inst.data, ts, lane)
            return
        if self.qos is not None:
            batch = self.batcher.add(t, inst.data, ts=ts, lane=lane)
        else:
            batch = self.batcher.add(t, inst.data, ts=ts)
        while batch is not None:
            await self._dispatch(batch)
            batch = self.batcher.take_ready()
        self._kick_flush()

    async def _dead_letter(self, t: Tuple, payload, error: str) -> None:
        """Poison input: route to the dead-letter stream and ack."""
        self._m_dead.inc()
        if isinstance(payload, (bytes, bytearray)):
            payload = payload.decode("utf-8", "replace")
        dl = DeadLetter(payload=str(payload), error=error)
        await self.collector.emit(Values([dl.to_json(), *self._extras(t)]),
                                  stream="dead_letter", anchors=[t])
        self.collector.ack(t)

    async def _shed_tuple(self, t: Tuple, lane: Optional[str], level: int) -> None:
        """A tuple shed at ``level``: answered at once with an
        :class:`Overloaded` record and acked — never replayed (replaying
        rejected load is more load)."""
        msg = Overloaded(lane=lane or "", shed_level=level).to_json()
        await self.collector.emit(Values([msg, *self._extras(t)]), anchors=[t])
        self._m_shed.inc()
        self.collector.ack(t)

    # ---- the continuous path ---------------------------------------------------

    async def _submit_record(self, t: Tuple, data, ts, lane) -> None:
        """Hand one record to the engine's queue and complete it from a
        task of its own; waits while this task has ``max_inflight *
        max_batch`` rows outstanding."""
        n = int(data.shape[0])
        while self._cb_rows >= self._cb_cap:
            self._cb_room.clear()
            await self._cb_room.wait()
        self._cb_rows += n
        tenant = t.get("qos_tenant", None) if self.qos is not None else None
        sub = self._cb.submit(data, payload=t, ts=ts, lane=lane, tenant=tenant,
                              source=self._cb_source)
        task = asyncio.get_running_loop().create_task(self._finish_record(sub, n))
        self._inflight.add(task)
        task.add_done_callback(self._inflight.discard)

    async def _finish_record(self, sub, n_rows: int) -> None:
        """Emit and ack one record once its rows come back; a failed batch
        fails this record's tuple alone (its source replays it)."""
        t = sub.payload
        try:
            preds = await asyncio.wrap_future(sub.future)
            with span(self.context.metrics, self.context.component_id, "encode"):
                msg = encode_predictions(preds)
            await self.collector.emit(Values([msg, *self._extras(t)]), anchors=[t])
            self.collector.ack(t)
        except Exception as e:
            self.collector.report_error(e)
            self.collector.fail(t)
        finally:
            self._cb_rows -= n_rows
            if self._cb_rows < self._cb_cap:
                self._cb_room.set()

    def _kick_flush(self) -> None:
        try:
            loop = asyncio.get_running_loop()
        except RuntimeError:
            return  # the loop is torn down (shutdown race)
        if self._eager and len(self.batcher) and not self._dispatch_sem.locked() \
                and not self._eager_pending:
            # Work-conserving: a device slot is free and records wait —
            # dispatch now rather than age toward the deadline. Under load
            # every slot is busy, and batches fill while they queue.
            batch = self.batcher.take_all()
            self._eager_pending += 1
            task = loop.create_task(self._dispatch(batch))
            self._inflight.add(task)
            task.add_done_callback(self._inflight.discard)
            # Decrement when the task finishes, however it finishes: a
            # cancel before its first step never enters _dispatch.
            task.add_done_callback(
                lambda _t: setattr(self, "_eager_pending", self._eager_pending - 1))
            return
        if len(self.batcher) and (self._flush_task is None or self._flush_task.done()):
            self._flush_task = loop.create_task(self._deadline_flush())

    async def _deadline_flush(self) -> None:
        """Runs while records are pending; exits when the batcher drains
        (never cancelled mid-dispatch, which would drop the batch)."""
        while True:
            oldest = self.batcher.oldest_ts
            if oldest is None:
                return
            wait_s = self.batch_cfg.max_wait_ms / 1e3 - (time.perf_counter() - oldest)
            if wait_s > 0:
                await asyncio.sleep(wait_s)
            batch = self.batcher.take_if_due()
            while batch is not None:
                await self._dispatch(batch)
                batch = self.batcher.take_ready()

    async def _dispatch(self, batch: Batch) -> None:
        t0 = time.perf_counter()
        # Observed before the semaphore, so batch_wait and dispatch_wait
        # partition the clock.
        for it in batch.items:
            if it.enq:
                self._m_batch_wait.observe((t0 - it.enq) * 1e3)
        await self._dispatch_sem.acquire()
        self._m_disp_wait.observe((time.perf_counter() - t0) * 1e3)
        task = asyncio.get_running_loop().create_task(self._run_batch(batch))
        self._inflight.add(task)
        task.add_done_callback(self._inflight.discard)

    async def _run_batch(self, batch: Batch) -> None:
        engine = self.engine
        try:
            t0 = time.perf_counter()
            # The dispatch phase on a worker thread (it can park on the
            # engine's ring); the future resolves from the fetch thread.
            # The semaphore stays held for the whole round trip, so
            # max_inflight and the deferred acks keep their meaning.
            handle = await asyncio.to_thread(engine.dispatch, batch.parts())
            out = await asyncio.wrap_future(handle.future)
            t1 = time.perf_counter()
            self._m_device_ms.observe((t1 - t0) * 1e3)
            for key, _ in DEVICE_SUBSTAGES:
                if key in handle.timings:
                    self._m_substage[key].observe(handle.timings[key])
            self._m_batch.observe(batch.size)
            self._m_infer.inc(batch.size)
            padded = handle.padded or self.batch_cfg.bucket_for(batch.size)
            self._m_fill.observe(batch.size / max(padded, 1))
            self._m_coalesced.inc()  # a per-task batch has one source
            for item, preds in batch.split(out):
                with span(self.context.metrics, self.context.component_id, "encode"):
                    msg = encode_predictions(preds)
                await self.collector.emit(Values([msg, *self._extras(item)]),
                                          anchors=[item])
                self.collector.ack(item)
        except Exception as e:
            # Device failure: fail every tuple in the batch -> spout replay.
            self.collector.report_error(e)
            for item in batch.items:
                self.collector.fail(item.payload)
        finally:
            self._dispatch_sem.release()
            # A slot is free: eagerly pull whatever queued meanwhile.
            self._kick_flush()

    async def flush(self) -> None:
        """Drain: dispatch whatever is pending and wait for in-flight
        batches (the engine's ring included), so a graceful stop never
        strands acks."""
        if self._continuous:
            self._cb.flush()
        batch = self.batcher.take_all()
        if batch is not None:
            await self._dispatch(batch)
        while self._inflight:
            await asyncio.gather(*list(self._inflight), return_exceptions=True)

    def cleanup(self) -> None:
        if self._flush_task is not None and not self._flush_task.done():
            self._flush_task.cancel()
        self._flush_task = None
