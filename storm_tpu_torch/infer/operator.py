"""The inference operator, the counterpart of ``storm_tpu/infer/operator.py``
on its split-phase path, with QoS lanes and shedding, continuous
batching, tracing, the flight recorder, the copy ledger and the live
model swap, chunked tuples and record frames, and the confidence-gated
cascade (with it ``qos.degrade_model``).

Per tuple: decode the record (``{"instances": ...}`` JSON, or an Arrow
tensor message viewed zero-copy) and check it against the model's input
shape — a failure emits a :class:`DeadLetter` on the ``dead_letter``
stream and acks (replaying poison can never succeed); feed
the micro-batcher; a full batch, the deadline, or (with ``eager``) a free
dispatch slot sends the batch to the shared engine's ``dispatch`` on a
worker thread (it may park on the engine's ring), and the batch's future
resolves from the engine's fetch thread, so the event loop keeps consuming
while the card computes. Then one ``{"predictions": ...}`` tuple per
record, anchored to it, and the ack. A failed batch fails every tuple in
it, which the spout replays.

A chunked tuple (a list of records, or a
:class:`~storm_tpu_torch.runtime.frames.RecordFrame`) is decoded record by
record into one :class:`_ChunkHandle`, acked once every record completes
and failed (once) if any record's batch fails; a poison record
dead-letters alone, anchored to the chunk, which lives on. With frame
ingress and ``BatchConfig.frame_egress`` (the default) the records of one
frame that share a dispatched batch leave as ONE predictions payload.
Once a raw-scheme tuple arrives (bytes, a memoryview or a frame), the
task's predictions leave as utf-8 bytes, which the sink produces verbatim.

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

With a cascade (``cascade=CascadeConfig(enabled=True, ...)``, or the
two-tier shed-only cascade that ``qos.degrade_model`` synthesizes) the
task holds one engine and one batcher per tier
(:class:`~storm_tpu_torch.cascade.router.CascadeRouter`). A record enters
at its entry tier; after each tier's round trip the router accepts the
rows it trusts and the uncertain residue rides up to the next tier,
wrapped in :class:`~storm_tpu_torch.cascade.router.Escalated` so that
completion always targets the original tuple: a failure at any tier
fails it, and it replays from tier 0. A record emits once, merged in row
order, when its last row decides. While the shed level covers a record's
lane, a cascade serves it at tier 0 (a ``shed_degrade`` event,
``shed_degraded`` counted) instead of rejecting it. Each tier's round
trip is a ``cascade_tier{i}`` device span, linked to the span of the
batch that escalated its records, and an escalating batch records a
``cascade_escalation`` event.

With ``BatchConfig(continuous=True)`` the task forms no batches: it
submits each record to its engine's shared queue
(:func:`~storm_tpu_torch.infer.continuous.continuous_for`), where every
task on the engine co-batches, and completes the record from a task of
its own when the record's rows come back; each task keeps at most
``max_inflight * max_batch`` rows outstanding.

Observability. A sampled record's trace gets a ``queue_wait`` span (from
entering the batcher to the device round trip's start) and one
``device_execute`` span shared by every sampled member of its batch,
linked to all their ``queue_wait`` spans and carrying the substages
(``h2d_ms``, ``compute_ms``, ``d2h_ms``); a shed record gets a
``qos_shed`` span. The flight recorder gets ``batch_formed`` (throttled),
``shed_reject``, ``engine_quarantined``, ``engine_replaced`` and
``graph_capture`` (each cold bucket's eager forward and capture, with
storm_tpu's ``xla_compile`` fields: ``component``, ``batch_shape``,
``compile_ms``). The copy ledger gets ``json_decode`` rows (zero bytes and
copies for a tensor record's view) and ``json_encode`` rows (one per
payload, its ``records`` the rows it carries). ``prepare`` attaches the
copy ledger and the profile store before the engine warms, so warm-up's
builds are counted.

:meth:`InferenceBolt.swap_model` builds and warms the new model's engine
on a worker thread, then switches the task to it at once: batches in
flight finish on the old engine, which stays cached for a rollback. The
task moves its quarantine hook and its compile hook to the new engine,
and under continuous batching its queue too (storm_tpu's ``swap_model``
does neither, ``ROADMAP.md`` C7: its continuous task goes on submitting to
the old engine's queue). In a cascade the tier that held the old engine
follows the swap, its queue with it (storm_tpu moves the tier's engine
but not its queue, C11).
"""

from __future__ import annotations

import asyncio
import logging
import threading
import time
import weakref
from typing import Optional, Sequence, Set

import numpy as np

from storm_tpu_torch import native
from storm_tpu_torch.api.schema import (
    DeadLetter, Overloaded, SchemaError, decode_instances, encode_predictions)
from storm_tpu_torch.cascade.policy import CascadeConfig
from storm_tpu_torch.cascade.router import CascadeRouter, Escalated
from storm_tpu_torch.config import BatchConfig, ModelConfig, QosConfig, ShardingConfig
from storm_tpu_torch.infer.batcher import Batch, MicroBatcher
from storm_tpu_torch.infer.continuous import continuous_for
from storm_tpu_torch.infer.engine import shared_engine
from storm_tpu_torch.obs import copyledger as _copyledger
from storm_tpu_torch.obs import profile as _profile
from storm_tpu_torch.runtime.base import Bolt, OutputCollector, TopologyContext
from storm_tpu_torch.runtime.frames import RecordFrame
from storm_tpu_torch.runtime.tracing import DEVICE_SUBSTAGES, span
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

    def discard(self, task: "InferenceBolt") -> None:
        with self._lock:
            self._tasks.discard(task)

    def __call__(self, trips: int) -> None:
        with self._lock:
            tasks = list(self._tasks)
        for task in tasks:
            try:
                task._engine_quarantined(trips)
            except Exception:
                logger.exception("a task's quarantine handler failed")


def _stop_listening(engine, task: "InferenceBolt") -> None:
    hook = getattr(engine, "on_quarantine", None)
    if isinstance(hook, _QuarantineFanout):
        hook.discard(task)


class _ChunkHandle:
    """Ref-counted completion of a chunked input tuple (``BrokerSpout``
    ``chunk=N``): its N records share the one upstream tuple, which is
    acked when every record completes and failed (once) if any record's
    batch fails. A poison record dead-letters alone and counts as
    completed: one bad record must not replay the chunk forever."""

    __slots__ = ("tuple", "remaining", "failed", "frame")

    def __init__(self, t: Tuple, n: int, frame: bool = False) -> None:
        self.tuple = t
        self.remaining = n
        self.failed = False
        # The chunk arrived as a RecordFrame with frame egress on: its
        # records leave as one payload per dispatched batch.
        self.frame = frame

    def done(self, ok: bool, collector: OutputCollector) -> None:
        self.failed |= not ok
        self.remaining -= 1
        if self.remaining == 0:
            (collector.fail if self.failed else collector.ack)(self.tuple)


def _anchor_of(item) -> Tuple:
    """The input tuple a queued record completes: its own, or its chunk's,
    through the escalation wrapper of a cascade tier."""
    if isinstance(item, Escalated):
        item = item.payload
    return item.tuple if isinstance(item, _ChunkHandle) else item


def _trace_of(payload):
    """The trace context of a queued record (its tuple's)."""
    return _anchor_of(payload).trace


def _link_of(payload):
    """The device span that escalated a queued record, if any."""
    return payload.link_span if isinstance(payload, Escalated) else None


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


def _led(engine):
    """``engine``, unless it is a multi-rank engine that is not led (the
    class docstring)."""
    if getattr(engine, "multirank", False) and not engine.leading:
        raise ValueError(
            f"engine {engine.model_cfg.name!r} spans {engine.mesh.size} ranks and is not "
            f"led: a topology serves it from the mesh's leader (engine.lead() there, "
            f"engine.follow() on the other ranks)")
    return engine


class InferenceBolt(Bolt):
    """``device``: where the shared engines run (default ``cuda``; pass
    ``"cpu"`` for the CPU). ``engine``: an engine to use instead of the
    shared one (e.g. a ``NullEngine``); ``warmup=False`` skips building
    the buckets before traffic. ``passthrough``: input fields copied onto
    every output tuple. ``qos``: a ``QosConfig`` (on when enabled).
    ``cascade``: a ``CascadeConfig`` (on when enabled). ``sharding``: the
    ``ShardingConfig`` of every engine the task takes from
    ``shared_engine`` (storm_tpu's ``sharding``; the default is one rank).
    A multi-rank engine is served from its leader's topology alone: the
    leader's engine is led (``engine.lead()``) before the task prepares,
    and every other rank follows it (``engine.follow()``; the module
    docstring of ``infer/engine.py`` says why); the task refuses a
    multi-rank engine that is not led."""

    def __init__(self, model: Optional[ModelConfig] = None,
                 batch: Optional[BatchConfig] = None, device=None,
                 engine=None, warmup: bool = True, passthrough: Sequence[str] = (),
                 qos: Optional[QosConfig] = None,
                 cascade: Optional[CascadeConfig] = None,
                 sharding: Optional[ShardingConfig] = None) -> None:
        self.model_cfg = model or ModelConfig()
        self.batch_cfg = batch or BatchConfig()
        self.sharding_cfg = sharding or ShardingConfig()
        self.device = device
        self._engine = engine
        self._warmup = warmup
        self.passthrough = tuple(passthrough)
        self.qos = qos if (qos is not None and qos.enabled) else None
        self.cascade = cascade if (cascade is not None and cascade.enabled) else None

    def clone(self) -> "InferenceBolt":
        return InferenceBolt(self.model_cfg, self.batch_cfg, self.device,
                             self._engine, self._warmup, self.passthrough, self.qos,
                             self.cascade, self.sharding_cfg)

    def declare_output_fields(self):
        fields = ("message",) + self.passthrough
        return {"default": fields, "dead_letter": fields}

    def _extras(self, t: Tuple) -> list:
        # A stream without a passthrough field yields None for it.
        return [t.get(f, None) for f in self.passthrough]

    def _shared_engine(self, model_cfg: Optional[ModelConfig] = None):
        return _led(shared_engine(model_cfg or self.model_cfg, self.batch_cfg,
                                  device=self.device, sharding_cfg=self.sharding_cfg))

    def prewarm(self) -> None:
        """Build and warm the engine (and a cascade's tier engines), and
        build or load the native codec, off the event loop before this
        task receives traffic, so a cold build rides neither the loop nor
        live tuples; ``prepare`` then skips its warm-up. An engine given
        at construction is kept."""
        native.load()
        self._engine = self._engine or self._shared_engine()
        if self._warmup:
            self._engine.warmup()
        cas = self._cascade_cfg()
        if cas is not None:
            probe = CascadeRouter(cas, qos=self.qos)
            for i in range(len(cas.tiers)):
                mc = probe.tier_model(i, self.model_cfg)
                if mc is self.model_cfg:
                    continue  # the flagship, warmed above
                eng = self._shared_engine(mc)
                if self._warmup:
                    eng.warmup()
        self._prewarmed = True

    def _cascade_cfg(self) -> Optional[CascadeConfig]:
        """The effective cascade: the one given, else for
        ``qos.degrade_model`` a two-tier shed-only cascade (the degrade
        model, then this task's model) whose tier 0 serves shed lanes."""
        if self.cascade is not None:
            return self.cascade
        if self.qos is not None and self.qos.degrade_model:
            return CascadeConfig(enabled=True,
                                 tiers=(self.qos.degrade_model, self.model_cfg.name),
                                 thresholds=(0.0,), shed_only=True)
        return None

    def prepare(self, context: TopologyContext, collector: OutputCollector) -> None:
        super().prepare(context, collector)
        # The cost profile and the copy ledger attach before the engine
        # builds or warms, so warm-up's cold builds are counted.
        _profile.ensure_installed()
        _copyledger.ensure_installed()
        # The codec is built before traffic (a no-op once prewarmed): its
        # first use would otherwise compile it on the event loop.
        native.load()
        self._tracer = getattr(context, "tracer", None)
        self._flight = getattr(context, "flight", None)
        cid = context.component_id
        self._on_compile = None
        if self._flight is not None:
            # A cold bucket (eager forward and graph capture) rides the
            # hot path: the latency cliff a post-mortem needs to see.
            self._on_compile = (
                lambda padded, ms, fl=self._flight: fl.event(
                    "graph_capture", component=cid, batch_shape=padded,
                    compile_ms=round(ms, 1)))
        # One engine per model per process: the tasks share its weights.
        self.engine = _led(self._engine or self._shared_engine())
        self._hook_compile(self.engine)
        prewarmed = getattr(self, "_prewarmed", False)
        if self._warmup and not prewarmed:
            self.engine.warmup()
        # A cascade: one shared engine and one residue batcher per tier;
        # the flagship tier reuses this task's engine. max_inflight now
        # bounds round trips across tiers.
        cas = self._cascade_cfg()
        self._router = None
        if cas is not None:
            self._router = CascadeRouter(cas, qos=self.qos)
            self._router.build(self.model_cfg, self.batch_cfg,
                               build_engine=self._shared_engine, flagship=self.engine,
                               warmup=self._warmup and not prewarmed)
            for tier in self._router.tiers:
                self._hook_compile(tier.engine)
            # self.batcher is the default entry tier's batcher.
            self.batcher = self._router.tiers[self._router.entry_tier(None, 0)].batcher
        elif self.qos is not None:
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
        # Set by the first raw-scheme tuple (bytes, memoryview or frame):
        # predictions then leave as utf-8 bytes, produced verbatim by the
        # sink. A topology's scheme is uniform, so it stays set.
        self._bytes_egress = False
        m = context.metrics
        self._m_batch = m.histogram(cid, "batch_size")
        self._m_device_ms = m.histogram(cid, "device_ms")
        self._m_dead = m.counter(cid, "dead_lettered")
        self._m_infer = m.counter(cid, "instances_inferred")
        # Where a record's time goes before the device: broker append ->
        # this bolt, in the batcher, then waiting for a dispatch slot.
        self._m_ingest = m.histogram(cid, "ingest_lag_ms")
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
        if self._router is not None:
            self._router.bind_metrics(m, cid)
        # QoS: the shed level is read once per tuple.
        if self.qos is not None:
            self._shed_gauge = m.gauge("qos", "shed_level")
            self._m_shed = m.counter(cid, "shed_rejected")
            self._m_degraded = m.counter(cid, "shed_degraded")
        # Continuous batching: formation moves to the engines' shared
        # queues (one a tier in a cascade); this task bounds its
        # outstanding rows at the row equivalent of max_inflight batches.
        self._continuous = bool(self.batch_cfg.continuous)
        self._cbs = {}
        if self._continuous:
            if self._router is not None:
                for tier in self._router.tiers:
                    self._cbs[tier.index] = self._bind_queue(tier.engine, tier.index)
            else:
                self._cbs[None] = self._bind_queue(self.engine)
            self._cb_cap = max(1, self.batch_cfg.max_inflight) * max(1, self.batch_cfg.max_batch)
            self._cb_rows = 0
            self._cb_room = asyncio.Event()
            self._cb_room.set()
            self._cb_source = f"{cid}#{context.task_index}"

    @property
    def _sources(self) -> list:
        """``(tier, batcher)`` per batcher this task drains: one per tier in
        a cascade, else ``(None, self.batcher)``."""
        router = getattr(self, "_router", None)
        if router is None:
            return [(None, self.batcher)]
        return [(t.index, t.batcher) for t in router.tiers]

    @property
    def _cb(self):
        """The continuous queue of this task's engine (of its default entry
        tier in a cascade)."""
        if None in self._cbs:
            return self._cbs[None]
        return self._cbs[self._router.entry_tier(None, 0)]

    def _bind_queue(self, engine, tier: Optional[int] = None):
        """``engine``'s continuous queue, its metrics, tracer and flight
        recorder bound to this component (the first task to bind wins);
        a cascade tier's device span is ``cascade_tier{i}``."""
        cb = continuous_for(engine, self.batch_cfg, self.qos)
        cb.bind(self.context.metrics, self.context.component_id, tracer=self._tracer,
                flight=self._flight, trace_of=_trace_of, link_of=_link_of,
                span_name="device_execute" if tier is None else f"cascade_tier{tier}")
        return cb

    def _hook_compile(self, engine) -> None:
        """Point ``engine``'s cold-build hook at this task's flight
        recorder (every task of the component sets the same event)."""
        if self._on_compile is not None:
            try:
                engine.on_compile = self._on_compile
            except AttributeError:
                pass  # a slotted test double

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
        cid = self.context.component_id
        if self._flight is not None:
            self._flight.event("engine_quarantined", component=cid,
                               model=self.model_cfg.name, trips=trips)
        old = self.engine

        def rebuild() -> None:
            try:
                eng = self._shared_engine()
                if self._warmup:
                    eng.warmup()
                if self.engine is not old:
                    return  # swapped away meanwhile: the swap's engine stays
                self._adopt(eng, old)
                self._m_quarantined.set(0)
                if self._flight is not None:
                    self._flight.event("engine_replaced", component=cid,
                                       model=self.model_cfg.name)
            except Exception:
                logger.exception("replacement engine build failed; the component stays "
                                 "quarantined (batches fail fast and replay)")

        threading.Thread(target=rebuild, name="engine-replace", daemon=True).start()

    def _adopt(self, eng, old, model_cfg: Optional[ModelConfig] = None) -> None:
        """Switch this task from ``old`` to ``eng``: the compile hook and
        the quarantine fan-out move with it and, under continuous
        batching, the task's queue (the new engine's one queue). In a
        cascade every tier that held ``old`` follows, with its queue."""
        try:
            eng.on_compile = self._on_compile or getattr(old, "on_compile", None)
        except AttributeError:
            pass  # a slotted test double
        if eng is not old:
            _stop_listening(old, self)
        _listen_for_quarantine(eng, self)
        if self._router is not None:
            for tier in self._router.tiers:
                if tier.engine is old:
                    tier.engine = eng
                    if model_cfg is not None:
                        tier.model_cfg = model_cfg
                    if self._continuous:
                        self._cbs[tier.index] = self._bind_queue(eng, tier.index)
        elif self._continuous:
            self._cbs[None] = self._bind_queue(eng)
        self.engine = eng

    # ---- live model swap -------------------------------------------------------

    async def swap_model(self, model_cfg: ModelConfig) -> None:
        """Serve ``model_cfg`` from now on, under traffic. Its engine comes
        from ``shared_engine`` (built and warmed on a worker thread, or
        the cached one: a swap back to an earlier model builds nothing),
        then the task switches to it at once. Batches in flight finish on
        the old engine, which stays cached. A new input shape may fail
        and replay records still in this task's batcher."""

        def build():
            eng = _led(shared_engine(model_cfg, self.batch_cfg, device=self.device,
                                     sharding_cfg=self.sharding_cfg))
            self._hook_compile(eng)
            if self._warmup:
                eng.warmup()
            return eng

        new = await asyncio.to_thread(build)
        self._adopt(new, self.engine, model_cfg)
        self.model_cfg = model_cfg

    # ---- ingest --------------------------------------------------------------

    @staticmethod
    def _egress_groups(emit):
        """An emit list split into egress groups, order kept: the members
        of one frame handle coalesce under it (consecutive or not, through
        a cascade's escalation wrapper); every other record stays alone,
        keyed ``None``. Returns ``[(handle or None, [(item, preds), ...]),
        ...]``."""
        out = []
        index = {}
        for item, preds in emit:
            base = item.payload if isinstance(item, Escalated) else item
            if isinstance(base, _ChunkHandle) and base.frame:
                i = index.get(id(base))
                if i is None:
                    index[id(base)] = len(out)
                    out.append((base, [(item, preds)]))
                else:
                    out[i][1].append((item, preds))
            else:
                out.append((None, [(item, preds)]))
        return out

    def _complete(self, item, ok: bool) -> None:
        """Ack or fail a queued record: its own tuple, or one of its chunk's
        records, through a cascade's escalation wrapper."""
        if isinstance(item, Escalated):
            item = item.payload
        if isinstance(item, _ChunkHandle):
            item.done(ok, self.collector)
        elif ok:
            self.collector.ack(item)
        else:
            self.collector.fail(item)

    def _decode_checked(self, payload, root_ts):
        """Decode one record and check its shape (raises SchemaError), with
        its ``json_decode`` row: the parse's fresh float32 array, or zero
        bytes and copies for a tensor record's view."""
        with span(self.context.metrics, self.context.component_id, "decode"):
            inst = decode_instances(payload, ts=root_ts)
        if tuple(inst.data.shape[1:]) != self.engine.input_shape:
            raise SchemaError(
                f"instance shape {tuple(inst.data.shape[1:])} != model "
                f"input {self.engine.input_shape}")
        if _copyledger.active():
            if inst.view:
                _copyledger.record("json_decode", 0, copies=0, allocs=0, records=1,
                                   engine=self.context.component_id)
            else:
                _copyledger.record("json_decode", inst.data.nbytes, copies=1, allocs=1,
                                   records=1, engine=self.context.component_id)
        return inst

    def _pending(self) -> int:
        return sum(len(b) for _, b in self._sources)

    def batcher_stats(self) -> dict:
        """Depth and age of this task's batcher(s), summed over a cascade's
        tiers: what the observatory's ``EdgeLagTracker`` reads per task.
        Under continuous batching this reads ~0 by design: the records
        wait in the engine's shared queue (``Observatory.occupancy``)."""
        rows = depth = 0
        oldest_ms = 0.0
        for _tier, b in self._sources:
            st = b.stats()
            rows += st["pending_rows"]
            depth += st["depth"]
            oldest_ms = max(oldest_ms, st["oldest_ms"])
        return {"pending_rows": rows, "depth": depth, "oldest_ms": round(oldest_ms, 3),
                "continuous": bool(getattr(self, "_continuous", False))}

    async def execute(self, t: Tuple) -> None:
        if t.root_ts:
            # Broker append -> this bolt (broker queueing, the spout, the hop).
            self._m_ingest.observe((time.perf_counter() - t.root_ts) * 1e3)
        payload = t.get("message")
        if not self._bytes_egress and isinstance(
                payload, (bytes, bytearray, memoryview, RecordFrame)):
            self._bytes_egress = True
        lane = t.get("qos_lane", None) if self.qos is not None else None
        level = int(self._shed_gauge.value) if self.qos is not None else 0
        if level > 0 and self.qos.shed_eligible(lane, level):
            if self._router is None:
                # Shed before the decode: spend nothing on traffic that
                # will not be served.
                await self._shed_tuple(t, payload, lane, level)
                return
            # A cascade degrades instead: the record is served at tier 0
            # (the router pins it there), batched as any other.
            n = len(payload) if isinstance(payload, (list, tuple, RecordFrame)) else 1
            self._m_degraded.inc(n)
            if self._flight is not None:
                self._flight.event("shed_degrade", throttle_s=1.0,
                                   component=self.context.component_id, lane=lane,
                                   level=level, records=n)
        entry = self._router.entry_tier(lane, level) if self._router is not None else None
        if isinstance(payload, (list, tuple, RecordFrame)):
            await self._execute_chunk(t, payload, lane, entry)
            return
        try:
            inst = self._decode_checked(payload, t.root_ts)
        except SchemaError as e:
            await self._dead_letter(t, payload, str(e))
            return
        await self._ingest(t, inst.data, t.root_ts or None, lane, entry)
        self._kick_flush()

    async def _ingest(self, item, data, ts, lane, entry=None) -> None:
        """One record into its entry batcher (a cascade tier's, or the
        task's), or its tier's continuous queue, dispatching every batch
        that comes due."""
        if self._continuous:
            await self._submit_record(item, data, ts, lane, entry)
            return
        b = self.batcher if entry is None else self._router.tiers[entry].batcher
        if self.qos is not None:
            batch = b.add(item, data, ts=ts, lane=lane)
        else:
            batch = b.add(item, data, ts=ts)
        while batch is not None:
            await self._dispatch(batch, entry)
            batch = b.take_ready()

    async def _execute_chunk(self, t: Tuple, payloads, lane=None, entry=None) -> None:
        # frame_egress=False keeps one output message per record for frame
        # ingress: the handle is not marked as a frame, so egress never
        # coalesces (the zero-copy ingress and decode are unchanged).
        handle = _ChunkHandle(t, len(payloads),
                              frame=(isinstance(payloads, RecordFrame)
                                     and self.batch_cfg.frame_egress))
        for payload in payloads:
            try:
                inst = self._decode_checked(payload, t.root_ts)
            except SchemaError as e:
                # Dead-letter the record and keep the chunk alive: anchored
                # to the chunk's tuple, completed as handled.
                await self._emit_dead_letter(t, payload, str(e))
                handle.done(True, self.collector)
                continue
            await self._ingest(handle, inst.data, t.root_ts or None, lane, entry)
        self._kick_flush()

    async def _emit_dead_letter(self, anchor: Tuple, payload, error: str) -> None:
        self._m_dead.inc()
        if isinstance(payload, memoryview):
            # A frame record's view: materialized before the envelope.
            payload = bytes(payload)
        if isinstance(payload, (bytes, bytearray)):
            # Raw-scheme records: the envelope is JSON, so the payload goes
            # in as text, not as a bytes repr.
            payload = payload.decode("utf-8", "replace")
        dl = DeadLetter(payload=str(payload), error=error)
        await self.collector.emit(Values([dl.to_json(), *self._extras(anchor)]),
                                  stream="dead_letter", anchors=[anchor])

    async def _dead_letter(self, t: Tuple, payload, error: str) -> None:
        """Poison input: route to the dead-letter stream and ack."""
        await self._emit_dead_letter(t, payload, error)
        self.collector.ack(t)

    async def _shed_tuple(self, t: Tuple, payload, lane: Optional[str], level: int) -> None:
        """A tuple shed at ``level`` with no cascade to degrade onto:
        answered at once with one :class:`Overloaded` record per record it
        carries, and acked — never replayed (replaying rejected load is
        more load)."""
        payloads = payload if isinstance(payload, (list, tuple, RecordFrame)) else [payload]
        msg = Overloaded(lane=lane or "", shed_level=level).to_json()
        for _ in payloads:
            await self.collector.emit(Values([msg, *self._extras(t)]), anchors=[t])
        self._m_shed.inc(len(payloads))
        cid = self.context.component_id
        if self._flight is not None:
            self._flight.event("shed_reject", throttle_s=1.0, component=cid,
                               lane=lane, level=level, records=len(payloads))
        if t.trace is not None and self._tracer is not None:
            now = time.perf_counter()
            self._tracer.record(t.trace, "qos_shed", cid, t.root_ts or now, now,
                                attrs={"lane": lane or "", "level": level,
                                       "action": "reject"})
        self.collector.ack(t)

    def _encode_ledgered(self, preds, records: int = 1):
        """``encode_predictions`` and its ``json_encode`` ledger row: one
        fresh payload per emit, ``records`` the records it answers. After
        raw-scheme ingress the payload is utf-8 bytes, which the sink
        produces as they are (no ``sink_encode`` re-encode)."""
        msg = encode_predictions(preds)
        if self._bytes_egress:
            msg = msg.encode("utf-8")
        if _copyledger.active():
            _copyledger.record("json_encode", len(msg), copies=1, allocs=1, records=records,
                               engine=self.context.component_id)
        return msg

    def _shed_level(self) -> int:
        return int(self._shed_gauge.value) if self.qos is not None else 0

    def _escalation_event(self, **info) -> None:
        if self._flight is not None:
            self._flight.event("cascade_escalation", throttle_s=1.0,
                               component=self.context.component_id, **info)

    # ---- the continuous path ---------------------------------------------------

    async def _submit_record(self, item, data, ts, lane, entry=None) -> None:
        """Hand one record to its entry tier's queue (or the engine's) and
        complete it from a task of its own; waits while this task has
        ``max_inflight * max_batch`` rows outstanding."""
        n = int(data.shape[0])
        while self._cb_rows >= self._cb_cap:
            self._cb_room.clear()
            await self._cb_room.wait()
        self._cb_rows += n
        tenant = _anchor_of(item).get("qos_tenant", None) if self.qos is not None else None
        sub = self._cbs[entry].submit(data, payload=item, ts=ts, lane=lane, tenant=tenant,
                                      source=self._cb_source)
        task = asyncio.get_running_loop().create_task(self._finish_record(sub, entry, n))
        self._inflight.add(task)
        task.add_done_callback(self._inflight.discard)

    async def _finish_record(self, sub, tier: Optional[int], n_rows: int) -> None:
        """Await one record through as many cascade tiers as it needs, then
        emit and complete it (one payload per record, chunk records
        included). A failure at any tier fails the original tuple (or its
        chunk), which replays from tier 0."""
        item = sub.payload
        try:
            while True:
                out = await asyncio.wrap_future(sub.future)
                if tier is None:
                    preds = out
                    break
                merged, residue, info = self._router.decide_item(
                    item, sub.data, out, sub.lane, tier, self._shed_level(), ts=sub.ts)
                if residue is None:
                    preds = merged
                    break
                wrapper = residue.payload
                # The next tier's queue_wait links back to the span of the
                # batch that escalated these rows.
                wrapper.link_span = sub.batch_span
                self._escalation_event(
                    tier=tier, model=self._router.tiers[tier].name,
                    escalation_rate=round(self._router.escalation_rate(), 4), **info)
                item = wrapper
                tier += 1
                sub = self._cbs[tier].submit(residue.data, payload=wrapper, ts=residue.ts,
                                             lane=residue.lane, tenant=sub.tenant,
                                             source=self._cb_source)
            anchor = _anchor_of(item)
            with span(self.context.metrics, self.context.component_id, "encode"):
                msg = self._encode_ledgered(preds)
            await self.collector.emit(Values([msg, *self._extras(anchor)]), anchors=[anchor])
            self._complete(item, True)
        except Exception as e:
            self.collector.report_error(e)
            self._complete(item, False)
        finally:
            self._cb_rows -= n_rows
            if self._cb_rows < self._cb_cap:
                self._cb_room.set()

    # ---- batching and dispatch -------------------------------------------------

    def _kick_flush(self) -> None:
        try:
            loop = asyncio.get_running_loop()
        except RuntimeError:
            return  # the loop is torn down (shutdown race)
        if self._eager and self._pending() and not self._dispatch_sem.locked() \
                and not self._eager_pending:
            # Work-conserving: a device slot is free and records wait —
            # dispatch now rather than age toward the deadline. Under load
            # every slot is busy, and batches fill while they queue.
            batch, tier = None, None
            for tier, b in self._sources:
                batch = b.take_all()
                if batch is not None:
                    break
            if batch is not None:
                self._eager_pending += 1
                task = loop.create_task(self._dispatch(batch, tier))
                self._inflight.add(task)
                task.add_done_callback(self._inflight.discard)
                # Decrement when the task finishes, however it finishes: a
                # cancel before its first step never enters _dispatch.
                task.add_done_callback(
                    lambda _t: setattr(self, "_eager_pending", self._eager_pending - 1))
                return
        if self._pending() and (self._flush_task is None or self._flush_task.done()):
            self._flush_task = loop.create_task(self._deadline_flush())

    async def _deadline_flush(self) -> None:
        """Runs while records are pending; exits when the batchers drain
        (never cancelled mid-dispatch, which would drop the batch)."""
        while True:
            oldest = min((b.oldest_ts for _, b in self._sources if b.oldest_ts is not None),
                         default=None)
            if oldest is None:
                return
            wait_s = self.batch_cfg.max_wait_ms / 1e3 - (time.perf_counter() - oldest)
            if wait_s > 0:
                await asyncio.sleep(wait_s)
            await self.tick()

    def _spawn_dispatch(self, batch: Batch, tier: Optional[int]) -> None:
        """Dispatch on a task of its own: for ``_escalate``, which runs
        under ``_run_batch`` while it holds a semaphore slot (awaiting the
        semaphore there would deadlock at ``max_inflight=1``)."""
        task = asyncio.get_running_loop().create_task(self._dispatch(batch, tier))
        self._inflight.add(task)
        task.add_done_callback(self._inflight.discard)

    async def _dispatch(self, batch: Batch, tier: Optional[int] = None) -> None:
        t0 = time.perf_counter()
        # Observed before the semaphore, so batch_wait and dispatch_wait
        # partition the clock.
        for it in batch.items:
            if it.enq:
                self._m_batch_wait.observe((t0 - it.enq) * 1e3)
        await self._dispatch_sem.acquire()
        self._m_disp_wait.observe((time.perf_counter() - t0) * 1e3)
        task = asyncio.get_running_loop().create_task(self._run_batch(batch, tier))
        self._inflight.add(task)
        task.add_done_callback(self._inflight.discard)

    def _trace_batch(self, batch: Batch, t0: float, t1: float, timings: dict,
                     fill: float, tier: Optional[int] = None) -> Optional[str]:
        """A ``queue_wait`` span per sampled record (batcher entry -> the
        round trip's start; an escalated record's linked back to the span
        that escalated it) and one device span, ``device_execute`` or
        ``cascade_tier{i}``, the same id in every sampled member's trace,
        parented on the member's ``queue_wait`` and linked to all of them.
        Returns that span's id (None when no member is sampled)."""
        tracer = self._tracer
        cid = self.context.component_id
        traced = []
        for it in batch.items:
            ctx = _trace_of(it.payload)
            if ctx is not None:
                back = _link_of(it.payload)
                traced.append((ctx, tracer.record(ctx, "queue_wait", cid, it.enq or t0, t0,
                                                  links=(back,) if back else ())))
        if not traced:
            return None
        batch_span = tracer.new_span_id()
        links = tuple(qid for _, qid in traced)
        attrs = {"batch_size": batch.size, "records": len(batch.items),
                 "fill": round(fill, 3)}
        if tier is not None:
            attrs["tier"] = tier
            attrs["model"] = self._router.tiers[tier].name
        for key, _ in DEVICE_SUBSTAGES:
            if key in timings:
                attrs[key] = round(timings[key], 3)
        name = "device_execute" if tier is None else f"cascade_tier{tier}"
        for ctx, qid in traced:
            tracer.record(ctx, name, cid, t0, t1, span_id=batch_span,
                          parent_id=qid, links=links, attrs=attrs)
        return batch_span

    async def _run_batch(self, batch: Batch, tier: Optional[int] = None) -> None:
        rt = None if tier is None else self._router.tiers[tier]
        engine = self.engine if rt is None else rt.engine
        try:
            dispatch = getattr(engine, "dispatch", None)
            t0 = time.perf_counter()
            if dispatch is not None:
                # The dispatch phase on a worker thread (it can park on the
                # engine's ring); the future resolves from the fetch thread.
                # The semaphore stays held for the whole round trip, so
                # max_inflight and the deferred acks keep their meaning.
                handle = await asyncio.to_thread(dispatch, batch.parts())
                out = await asyncio.wrap_future(handle.future)
                timings, padded = handle.timings, handle.padded
            else:
                # An engine with ``predict`` alone (the remote bolt's, a
                # test double): the serialized forward, no substages.
                out = await asyncio.to_thread(engine.predict, batch.stack())
                timings, padded = {}, 0
            t1 = time.perf_counter()
            self._m_device_ms.observe((t1 - t0) * 1e3)
            if rt is not None:
                rt.m_device.observe((t1 - t0) * 1e3)
            for key, _ in DEVICE_SUBSTAGES:
                if key in timings:
                    self._m_substage[key].observe(timings[key])
            self._m_batch.observe(batch.size)
            self._m_infer.inc(batch.size)
            padded = padded or self.batch_cfg.bucket_for(batch.size)
            fill = batch.size / max(padded, 1)
            self._m_fill.observe(fill)
            self._m_coalesced.inc()  # a per-task batch has one source
            batch_span = None
            if self._tracer is not None and self._tracer.active:
                batch_span = self._trace_batch(batch, t0, t1, timings, fill, tier)
            if self._flight is not None:
                # Throttled: enough to see batch sizes and device time in a
                # post-mortem without a per-batch firehose.
                self._flight.event(
                    "batch_formed", throttle_s=1.0, component=self.context.component_id,
                    size=batch.size, records=len(batch.items), fill=round(fill, 3),
                    sources=1, device_ms=round((t1 - t0) * 1e3, 3),
                    **({} if rt is None else {"tier": tier, "model": rt.name}))
            if rt is None:
                emit, escalated, info = batch.split(out), (), None
            else:
                emit, escalated, info = self._router.decide(batch, out, tier,
                                                            self._shed_level())
            # The records of one frame leave together: their predictions
            # concatenate into ONE payload per (frame, dispatched batch).
            # Every other record keeps one payload of its own.
            for handle, group in self._egress_groups(emit):
                if handle is None:
                    item, preds = group[0]
                    records = 1
                else:
                    item = handle
                    preds = (group[0][1] if len(group) == 1
                             else np.concatenate([p for _, p in group], axis=0))
                    records = len(group)
                anchor = _anchor_of(item)
                with span(self.context.metrics, self.context.component_id, "encode"):
                    msg = self._encode_ledgered(preds, records=records)
                await self.collector.emit(Values([msg, *self._extras(anchor)]),
                                          anchors=[anchor])
                for member, _ in group:
                    self._complete(member, True)
            if escalated:
                self._escalation_event(**info)
                await self._escalate(escalated, tier + 1, batch_span)
        except Exception as e:
            # Device failure: fail every record in the batch -> spout replay
            # (a chunk fails once, however many of its records it held; an
            # escalated record fails its original tuple, replayed from
            # tier 0).
            self.collector.report_error(e)
            for item in batch.items:
                self._complete(item.payload, False)
        finally:
            self._dispatch_sem.release()
            # A slot is free: eagerly pull whatever queued meanwhile.
            self._kick_flush()

    async def _escalate(self, items, tier: int, link_span: Optional[str]) -> None:
        """The uncertain residue into tier ``tier``'s batcher, each record
        keeping its data, deadline and lane. A ready batch is dispatched on
        a task of its own (this runs under ``_run_batch``, which holds a
        semaphore slot)."""
        b = self._router.tiers[tier].batcher
        for it in items:
            payload = it.payload
            if isinstance(payload, Escalated):
                payload.link_span = link_span
            else:
                payload = Escalated(payload, link_span)
            if self.qos is not None:
                batch = b.add(payload, it.data, ts=it.ts, lane=it.lane)
            else:
                batch = b.add(payload, it.data, ts=it.ts)
            while batch is not None:
                self._spawn_dispatch(batch, tier)
                batch = b.take_ready()
        self._kick_flush()

    async def tick(self) -> None:
        """A tick tuple (``topology.tick_interval_s``) dispatches every due
        batch, as ``_deadline_flush`` does when its deadline comes."""
        for tier, b in self._sources:
            batch = b.take_if_due()
            while batch is not None:
                await self._dispatch(batch, tier)
                batch = b.take_ready()

    async def flush(self) -> None:
        """Drain: dispatch whatever is pending and wait for in-flight
        batches (the engines' rings included), so a graceful stop never
        strands acks. Loops: a cascade tier's batch can refill a later
        tier's batcher (or queue) with escalated residue."""
        if self._continuous:
            while self._inflight:
                for cb in set(self._cbs.values()):
                    cb.flush()
                await asyncio.wait(list(self._inflight), timeout=0.05)
            return
        while True:
            for tier, b in self._sources:
                batch = b.take_all()
                while batch is not None:
                    await self._dispatch(batch, tier)
                    batch = b.take_all()
            while self._inflight:
                await asyncio.gather(*list(self._inflight), return_exceptions=True)
            if not self._pending():
                return

    def cleanup(self) -> None:
        if self._flush_task is not None and not self._flush_task.done():
            self._flush_task.cancel()
        self._flush_task = None
