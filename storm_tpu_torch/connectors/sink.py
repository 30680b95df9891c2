"""Egress sinks (the KafkaBolt equivalent), copied from
``storm_tpu/connectors/sink.py``.

:class:`BrokerSink`'s delivery modes: 'async' (send with a completion
callback, ack on success, report + fail on error), 'sync' (await, then
ack/fail) and 'fire_and_forget' (send and ack at once); a ``None`` topic
from the selector acks without sending, and a mapping error reports and
fails the tuple. The tuple -> record mapping takes the ``message`` field
and, where declared, the ``key`` field. ``make_producer`` is the test
seam for a failing producer. It records the end-to-end (broker append ->
delivered) latency ``e2e_latency_ms``, the produce time ``produce_ms``,
and for a tuple that carries the QoS lane field (``qos_lane``) its lane's
``e2e_latency_ms_<lane>``; with ``config.tracing.slo_ms`` set it counts
each delivery slower than that in ``slo_breaches`` (the shed controller's
signal) and records a throttled ``slo_breach`` flight event. A sampled
record's trace closes here: an ``egress`` span from the send's start, the
trace finished with the record's e2e ms, and its id the e2e histogram's
exemplar. A bytes value is produced verbatim; the str -> bytes encode of
any other value is its ``sink_encode`` row in the copy ledger.

:class:`TransactionalBrokerSink` is exactly-once egress: one broker
transaction per micro-batch (``txn_batch`` tuples or ``txn_ms``), acked
only after its commit; with ``offsets_group`` each tree's outputs and its
source offsets commit together (see the class). Counters ``txn_commits``,
``txn_aborts`` and ``txn_offsets_deferred``.

A broker flagged ``blocking`` (the Kafka wire broker) is produced to, and
its transactions run, on a worker thread, never on the event loop.
"""

from __future__ import annotations

import asyncio
import logging
import time
from typing import Callable, Optional

from storm_tpu_torch.config import SinkConfig
from storm_tpu_torch.connectors.memory import MemoryBroker
from storm_tpu_torch.obs import copyledger as _copyledger
from storm_tpu_torch.runtime.base import Bolt, OutputCollector, TopologyContext
from storm_tpu_torch.runtime.tuples import Tuple, merge_offsets

log = logging.getLogger("storm_tpu_torch.sink")


class DefaultTopicSelector:
    """Constant topic (reference DefaultTopicSelector, MainTopology.java:56)."""

    def __init__(self, topic: Optional[str]) -> None:
        self.topic = topic

    def __call__(self, t: Tuple) -> Optional[str]:
        return self.topic


class Producer:
    """Minimal producer interface; raise from ``send`` to signal delivery
    failure. Implementations must be safe to call from the event loop."""

    async def send(self, topic: str, value: bytes, key: Optional[bytes]) -> None:
        raise NotImplementedError

    def close(self) -> None:
        pass


class MemoryProducer(Producer):
    """Produces into any broker with the MemoryBroker surface; a broker
    flagged ``blocking`` (network-backed, the Kafka wire broker) is called
    on a worker thread, keeping the event loop free."""

    def __init__(self, broker: MemoryBroker) -> None:
        self.broker = broker
        self._blocking = bool(getattr(broker, "blocking", False))

    async def send(self, topic: str, value: bytes, key: Optional[bytes]) -> None:
        if self._blocking:
            await asyncio.to_thread(self.broker.produce, topic, value, key)
        else:
            self.broker.produce(topic, value, key)


class BrokerSink(Bolt):
    def __init__(
        self,
        broker: Optional[MemoryBroker] = None,
        topic: Optional[str] = None,
        sink: Optional[SinkConfig] = None,
        topic_selector: Optional[Callable[[Tuple], Optional[str]]] = None,
    ) -> None:
        self.broker = broker
        self.sink_cfg = sink or SinkConfig()
        self.topic_selector = topic_selector or DefaultTopicSelector(topic)
        self._inflight: set = set()

    def clone(self) -> "BrokerSink":
        """Per-task instance sharing the broker handle. Works for subclasses
        that override ``make_producer`` (the test seam)."""
        c = type(self).__new__(type(self))
        c.broker = self.broker
        c.sink_cfg = self.sink_cfg
        c.topic_selector = self.topic_selector
        c._inflight = set()
        return c

    # Test seam, mirroring the reference's protected mkProducer
    # (KafkaBolt.java:109-113): override to inject a failing/mock producer.
    def make_producer(self) -> Producer:
        if self.broker is None:
            raise ValueError("BrokerSink needs a broker or an overridden make_producer")
        return MemoryProducer(self.broker)

    def prepare(self, context: TopologyContext, collector: OutputCollector) -> None:
        super().prepare(context, collector)
        # Byte-side observability (obs/copyledger): a sink-only worker
        # still re-encodes every record, so the ledger attaches here too.
        _copyledger.ensure_installed()
        self.producer = self.make_producer()
        self._latency = context.metrics.histogram(
            context.component_id, "e2e_latency_ms"
        )
        self._delivered = context.metrics.counter(context.component_id, "delivered")
        # Latency-decomposition stage: broker produce/confirm time.
        self._m_produce = context.metrics.histogram(
            context.component_id, "produce_ms")
        # Egress side of distributed tracing: close sampled traces here and
        # attach their ids as exemplars on the e2e latency histogram.
        self._tracer = getattr(context, "tracer", None)
        self._flight = getattr(context, "flight", None)
        tcfg = getattr(context.config, "tracing", None)
        self._slo_ms = float(getattr(tcfg, "slo_ms", 0.0) or 0.0)
        # Counter twin of the (throttled) slo_breach flight event: every
        # breach counts, so rates are computable — the load-shed
        # controller's breach-rate signal reads this.
        self._m_breach = context.metrics.counter(
            context.component_id, "slo_breaches")
        # Per-lane e2e histograms, built lazily the first time a tuple
        # arrives carrying the QoS lane field (spout passthrough).
        self._lane_latency: dict = {}

    async def _timed_send(self, topic: str, value: bytes,
                          key: Optional[bytes]) -> None:
        t0 = time.perf_counter()
        await self.producer.send(topic, value, key)
        self._m_produce.observe((time.perf_counter() - t0) * 1e3)

    # ---- mapping (FieldNameBasedTupleToKafkaMapper semantics) ----------------

    def _map(self, t: Tuple) -> tuple:
        # bytes/bytearray values pass through untouched: the raw-scheme
        # operator already produced the utf-8 payload (one json_encode
        # hop); only a str value needs the encode, its sink_encode row.
        value = t.get("message")
        if isinstance(value, str):
            value = value.encode("utf-8")
            if _copyledger.active():
                # Copy ledger: the egress str->bytes re-encode is the
                # last copy a record pays before the broker.
                _copyledger.record("sink_encode", len(value), copies=1,
                                   allocs=1, records=1,
                                   engine=self.context.component_id)
        elif not isinstance(value, (bytes, bytearray)):
            value = str(value).encode("utf-8")
            if _copyledger.active():
                _copyledger.record("sink_encode", len(value), copies=2,
                                   allocs=2, records=1,
                                   engine=self.context.component_id)
        key = None
        if "key" in t.fields:
            key = t.get("key")
            if isinstance(key, str):
                key = key.encode("utf-8")
        return key, value

    # ---- the three delivery modes --------------------------------------------

    async def execute(self, t: Tuple) -> None:
        try:
            key, value = self._map(t)
            topic = self.topic_selector(t)
        except Exception as e:
            # Mapping failure: report + fail (KafkaBolt.java:160-162).
            self.collector.report_error(e)
            self.collector.fail(t)
            return

        if topic is None:
            # Null topic: warn + ack without sending (KafkaBolt.java:156-159).
            log.warning("topic selector returned None; acking without send")
            self.collector.ack(t)
            return

        mode = self.sink_cfg.mode
        if mode == "fire_and_forget":
            task = asyncio.get_running_loop().create_task(
                self._send_quiet(topic, value, key)
            )
            self._inflight.add(task)
            task.add_done_callback(self._inflight.discard)
            self._ack_delivered(t)
        elif mode == "sync":
            t0 = time.perf_counter()
            try:
                await self._timed_send(topic, value, key)
            except Exception as e:
                self.collector.report_error(e)
                self.collector.fail(t)
                return
            self._ack_delivered(t, t0)
        else:  # async with callback
            task = asyncio.get_running_loop().create_task(
                self._send_tracked(t, topic, value, key)
            )
            self._inflight.add(task)
            task.add_done_callback(self._inflight.discard)

    async def _send_quiet(self, topic: str, value: bytes, key: Optional[bytes]) -> None:
        try:
            await self.producer.send(topic, value, key)
        except Exception as e:  # fire-and-forget: drop errors
            log.debug("fire-and-forget send failed: %s", e)

    async def _send_tracked(
        self, t: Tuple, topic: str, value: bytes, key: Optional[bytes]
    ) -> None:
        t0 = time.perf_counter()
        try:
            await self._timed_send(topic, value, key)
        except Exception as e:
            self.collector.report_error(e)
            self.collector.fail(t)
            return
        self._ack_delivered(t, t0)

    def _ack_delivered(self, t: Tuple, t0: Optional[float] = None) -> None:
        """Delivery confirmed: count it, close the trace (egress span +
        exemplar + SLO check), ack. ``t0`` is when the send started, for
        the egress span; the exactly-once sink's commit path reuses this
        so tracing semantics can't diverge between delivery modes."""
        self._delivered.inc()
        if t.root_ts:
            now = time.perf_counter()
            ms = (now - t.root_ts) * 1e3
            if t.trace is None:
                self._latency.observe(ms)
            else:
                self._latency.observe(ms, trace_id=t.trace.trace_id)
                if self._tracer is not None:
                    self._tracer.record(
                        t.trace, "egress", self.context.component_id,
                        t0 if t0 is not None else now, now,
                        attrs={"e2e_ms": round(ms, 3)})
                    self._tracer.finish(t.trace, ms)
            if "qos_lane" in t.fields:
                lane = t.get("qos_lane")
                if lane:
                    h = self._lane_latency.get(lane)
                    if h is None:
                        h = self._lane_latency[lane] = \
                            self.context.metrics.histogram(
                                self.context.component_id,
                                f"e2e_latency_ms_{lane}")
                    h.observe(ms)
            if self._slo_ms and ms > self._slo_ms:
                self._m_breach.inc()
                if self._flight is not None:
                    self._flight.event(
                        "slo_breach", throttle_s=1.0,
                        component=self.context.component_id,
                        e2e_ms=round(ms, 3), slo_ms=self._slo_ms,
                        trace_id=t.trace.trace_id if t.trace is not None
                        else None)
        self.collector.ack(t)

    async def flush(self) -> None:
        """Settle in-flight async sends before the producer closes."""
        while self._inflight:
            await asyncio.gather(*list(self._inflight), return_exceptions=True)

    def cleanup(self) -> None:
        self.producer.close()


class TransactionalBrokerSink(BrokerSink):
    """Exactly-once egress (KIP-98 transactions): tuples buffer into one
    Kafka transaction per micro-batch and ack only after EndTxn(commit) —
    a read-committed consumer sees each batch all-or-nothing. On any
    failure the transaction aborts and every buffered tuple fails back to
    the spout; the replayed batch runs in a NEW transaction.

    The transactional id is stable per task
    (``<topology>-<component>-<task>``), so a restarted task fences its
    own zombie (epoch bump at ``begin``). Works over any broker with
    ``txn()``: ``MemoryBroker.txn`` appends atomically at commit.

    With ``SinkConfig.offsets_group`` set (and the spout on
    ``offsets.policy='txn'`` with the same group), each tuple's source-log
    provenance (``Tuple.origins``, stamped by the spout and unioned through
    anchored emits) is folded into the transaction via
    ``txn.send_offsets`` — consumed offsets and produced records commit
    atomically, the full KIP-98 consume-transform-produce exactly-once
    loop. A crash between produce and commit aborts both: the restarted
    spout re-reads from the last committed offset and a read-committed
    consumer sees each result exactly once.

    Ordering: committing per-partition maxima is only safe because the
    spout's ``txn`` policy delivers per-partition ORDERED (one outstanding
    entry per partition, next fetched only after the previous tree acks —
    Kafka Streams' processing model). An earlier offset can therefore
    never still be in flight, or parked in the replay queue, while a later
    one commits. Cross-partition parallelism and spout chunking
    (``topology.spout_chunk``) carry the throughput.

    Fan-out: when one spout entry's tree yields MULTIPLE sink tuples
    (splitter bolt, chunked entries transformed per record), the tree's
    outputs and its offsets must land in ONE transaction — otherwise a
    crash between the tree's transactions either loses the uncommitted
    siblings (offset already advanced) or duplicates the committed ones
    (abort + full-tree replay). Origin-carrying tuples therefore PARK in
    the sink until the ack ledger's live-edge refcount shows every
    remaining edge of their tree is in the sink's buffer; only then does
    the whole tree (plus its offsets) commit. Trees that fail or time out
    drop their parked tuples (a ledger watch) and replay cleanly. This is
    why ``offsets_group`` requires sink parallelism 1 (enforced at
    ``prepare``): a tree split across sink executors could never close.

    Beyond the reference: its KafkaBolt acks on per-record delivery
    confirmation at best (KafkaBolt.java:129-155); duplicates on replay
    are unavoidable there."""

    def prepare(self, context: TopologyContext, collector: OutputCollector) -> None:
        super().prepare(context, collector)
        # batch/deadline knobs live on SinkConfig (one source of truth).
        self.txn_batch = self.sink_cfg.txn_batch
        self.txn_ms = self.sink_cfg.txn_ms
        if not hasattr(self.broker, "txn"):
            raise TypeError("TransactionalSink needs a broker with .txn()")
        txn_id = (f"{context.config.topology.name}-{context.component_id}"
                  f"-{context.task_index}")
        self._txn = self.broker.txn(txn_id)
        self._offsets_group = self.sink_cfg.offsets_group
        if self._offsets_group and not hasattr(self._txn, "send_offsets"):
            raise TypeError(
                "sink.offsets_group needs a transaction handle with "
                "send_offsets (MemoryTxn)")
        if self._offsets_group and context.parallelism > 1:
            # A fan-out tree split across sink executors can close in
            # neither (each holds part of the tree, so each sees live
            # edges elsewhere) — parked tuples would sit until tree
            # timeout, replaying forever. EOS egress is single-writer per
            # group, the same per-task model Kafka Streams uses.
            raise ValueError(
                "sink.offsets_group requires the transactional sink to "
                f"run with parallelism 1 (got {context.parallelism}): "
                "a tuple tree split across sink executors can never "
                "close in either. Scale EOS throughput with spout "
                "chunking and cross-partition parallelism instead.")
        self._buf: list = []
        self._flush_lock = asyncio.Lock()
        self._deadline_task: Optional[asyncio.Task] = None
        self._m_commits = context.metrics.counter(
            context.component_id, "txn_commits")
        self._m_aborts = context.metrics.counter(
            context.component_id, "txn_aborts")
        self._m_deferred = context.metrics.counter(
            context.component_id, "txn_offsets_deferred")
        # Fan-out safety (offsets_group only): a spout
        # entry's outputs and offsets must commit in ONE transaction, or a
        # crash mid-tree either loses outputs (offset already committed
        # past them) or duplicates them (abort + replay re-produces
        # already-committed siblings). Tuples whose tree still has live
        # edges outside the sink's hands are PARKED until the ledger's
        # live-edge refcount says the whole tree is held, then the full
        # tree + its offsets commit together. self._parked holds those
        # (t, topic, key, value) items; self._watched tracks ledger
        # watches that clean up parked tuples of failed trees.
        self._parked: list = []
        self._watched: set = set()
        self._live_watched: set = set()
        # root -> count of held tuples (buf + parked) anchored to it:
        # O(1) closure checks on the ack hot path (incremented on append,
        # rebuilt from the survivors at each flush — the flush is the one
        # place tuples leave in bulk, so rebuilding there absorbs every
        # drop path without per-path decrement bookkeeping)
        self._held_roots: dict = {}
        self._closure_kick = False
        self._kick_task: Optional[asyncio.Task] = None
        self._warned_unknown_tree = False

    async def execute(self, t: Tuple) -> None:
        try:
            key, value = self._map(t)
            topic = self.topic_selector(t)
        except Exception as e:
            self.collector.report_error(e)
            self.collector.fail(t)
            return
        if topic is None:
            log.warning("topic selector returned None; acking without send")
            self.collector.ack(t)
            return
        self._buf.append((t, topic, key, value))
        if self._offsets_group and t.anchors:
            for r in t.anchors:
                self._held_roots[r] = self._held_roots.get(r, 0) + 1
        if self._offsets_group and t.origins and t.anchors:
            # Tree-closure trigger: commit a held tree the moment its
            # last non-sink edge settles instead of waiting out the txn
            # deadline — without this, small spout entries (chunk x
            # partitions < txn_batch) pay the full txn_ms per gated
            # entry cycle (measured: chunk=1 ran at ~60 rec/s on a
            # 50 ms deadline). Two halves: (a) closure may ALREADY hold
            # at arrival (the bolt acked its input before this output
            # reached us) -> check now and flush; (b) closure may happen
            # later (an upstream branch still live) -> a ledger
            # live-watch re-checks on every ack of the tree.
            ledger = getattr(self.collector, "ledger", None)
            if ledger is not None:
                for r in t.anchors:
                    if r not in self._live_watched and ledger.watch_live(
                            r, self._on_live_edge_settled):
                        self._live_watched.add(r)
                if all(ledger.outstanding(r) == self._held_count(r)
                       for r in t.anchors):
                    await self._flush_txn()
                    return
        if len(self._buf) >= self.txn_batch:
            await self._flush_txn()
        else:
            self._rearm_deadline()

    def _held_count(self, root: int) -> int:
        return self._held_roots.get(root, 0)

    @staticmethod
    def _count_roots(items, into: Optional[dict] = None) -> dict:
        """Held-tuple count per anchor root — THE closure predicate's
        denominator; _plan's by_root and _rebuild_held must agree on it
        or the kick loop and the parking fixpoint diverge."""
        held: dict = {} if into is None else into
        for item in items:
            for r in item[0].anchors:
                held[r] = held.get(r, 0) + 1
        return held

    def _rebuild_held(self) -> None:
        """Recount held tuples per root from the survivors (buf + parked)
        — called after each flush, the one place tuples leave in bulk;
        also prunes _live_watched ids whose tuples are all gone (root ids
        are unique per tree instance, so gone means settled forever)."""
        held = self._count_roots(self._buf)
        self._count_roots(self._parked, into=held)
        self._held_roots = held
        self._live_watched &= set(held)

    async def _deadline_flush(self) -> None:
        await asyncio.sleep(self.txn_ms / 1e3)
        await self._flush_txn()

    async def flush(self) -> None:  # drain hook
        await self._flush_txn()

    def _on_live_edge_settled(self, root: int) -> None:
        """Ledger live-watch callback (on the loop): an edge of a held
        tree was acked — if every remaining live edge of ``root`` is now
        in our hands, the tree is closed and a flush commits it without
        waiting for txn_batch/txn_ms. Debounced to one pending kick; the
        kick re-scans after its flush so a closure that landed MID-flush
        (and bounced off the debounce) is picked up rather than regressing
        to the deadline."""
        if self._closure_kick:
            return
        ledger = getattr(self.collector, "ledger", None)
        if ledger is None:
            return
        held = self._held_count(root)
        if held and ledger.outstanding(root) == held:
            self._closure_kick = True

            async def kick():
                try:
                    while True:
                        before = len(self._buf) + len(self._parked)
                        await self._flush_txn()
                        # always yield, and stop when a flush made no
                        # progress: a closed root BRIDGED to an open one
                        # through a joint tuple parks everything (_plan's
                        # fixpoint), and looping on it would busy-spin —
                        # the open root's eventual ack fires a fresh kick,
                        # and the deadline poll is the backstop.
                        await asyncio.sleep(0)
                        made_progress = (len(self._buf)
                                         + len(self._parked)) < before
                        if not made_progress \
                                or not self._any_closed_held(ledger):
                            break
                finally:
                    self._closure_kick = False

            # strong ref: asyncio keeps tasks weakly; an unreferenced
            # kick could be GC'd before running
            self._kick_task = asyncio.get_running_loop().create_task(kick())

    def _any_closed_held(self, ledger) -> bool:
        return any(c and ledger.outstanding(r) == c
                   for r, c in self._held_roots.items())

    def _maybe_kick_closure(self) -> None:
        """Post-flush re-check for deadline/batch flushes: an upstream ack
        landing DURING the flush was evaluated against the pre-flush held
        counts and then dropped — if a held tree is closed now (counts
        just rebuilt), kick rather than regress it to the deadline."""
        if self._closure_kick:
            return
        ledger = getattr(self.collector, "ledger", None)
        if ledger is None:
            return
        for r, c in self._held_roots.items():
            if c and ledger.outstanding(r) == c:
                self._on_live_edge_settled(r)
                return

    def _on_tree_done(self, root: int, ok: bool) -> None:
        """Ledger watch callback for a parked root (fires on the loop).

        ok=False (tree failed/timed out): drop the root's parked tuples —
        the spout replays the whole entry, so producing stale outputs now
        would duplicate — and fail() each dropped tuple so a JOIN tuple's
        other, still-open trees settle immediately instead of waiting out
        the message timeout. ok=True can only fire for edge cases where
        the sink no longer holds the tree's tuples; nothing to do beyond
        the bookkeeping either way — the deadline poll re-plans the rest.
        """
        self._watched.discard(root)
        if not ok:
            # Reassign BEFORE failing: fail() can fire nested watchers
            # (a join tuple's other roots) that re-enter this method, and
            # they must see the already-pruned list — failing first would
            # let the outer call clobber their pruning with a stale copy.
            drop = [item for item in self._parked
                    if root in item[0].anchors]
            self._parked = [item for item in self._parked
                            if root not in item[0].anchors]
            for item in drop:
                self.collector.fail(item[0])
            if drop:
                self._rebuild_held()

    def _plan(self, held: list, n_prev: int = 0):
        """Split held tuples into (flush_now, park) and fold the offsets
        of flushing trees — synchronously on the loop BEFORE the produce
        (which may run in a thread), so ledger reads can't race it.

        A tree is flushable only when EVERY live edge the ledger tracks
        for it is in our hands: then its whole output set + its source
        offsets commit in one transaction (the KIP-98 EOS contract). A
        multi-root tuple (join) parks if ANY of its trees is still open,
        which re-opens its other trees — iterated to a fixpoint so no
        flushed tree ever leaves a sibling output behind.
        """
        ledger = getattr(self.collector, "ledger", None)
        by_root = self._count_roots(held)

        open_roots: set = set()
        dead_roots: set = set()
        remote = False
        if ledger is not None:
            for r in by_root:
                c = ledger.outstanding(r)
                if c is None:
                    remote = True  # remote-rooted tree: shape unknowable
                elif c > by_root[r]:
                    open_roots.add(r)
                elif c < by_root[r]:
                    # We hold by_root[r] unacked live edges of r; a live
                    # ledger entry must count at least those. Fewer (0)
                    # means the entry is GONE — and since completion needs
                    # our edges acked, gone == failed/timed out. Flushing
                    # these tuples would produce stale outputs (the spout
                    # is replaying the entry) and could commit an offset
                    # past a sibling that never ran: drop them instead.
                    dead_roots.add(r)
            # Dropping a joint (multi-root) tuple fails its OTHER trees
            # too (the fail() below settles them) — those trees' tuples
            # must drop in THIS pass, not flush ahead of the replay.
            changed = True
            while changed:
                changed = False
                for t, *_ in held:
                    if (t.anchors
                            and not t.anchors.isdisjoint(dead_roots)
                            and not t.anchors <= dead_roots):
                        dead_roots |= t.anchors
                        changed = True
            open_roots -= dead_roots
            # Parking a joint tuple strands its other trees' outputs:
            # treat those trees as open too, until nothing changes.
            changed = True
            while changed:
                changed = False
                for t, *_ in held:
                    if (t.origins and t.anchors
                            and t.anchors.isdisjoint(dead_roots)
                            and not t.anchors.isdisjoint(open_roots)
                            and not t.anchors <= open_roots):
                        open_roots |= t.anchors
                        changed = True
        if remote and not self._warned_unknown_tree:
            self._warned_unknown_tree = True
            log.warning(
                "EOS sink holds tuples of a tree rooted on a remote "
                "worker: tree shape is unknowable locally, so offsets "
                "commit with the first batch that carries them. Safe only "
                "for 1:1 entry->sink-tuple topologies; co-locate the txn "
                "sink with the spout for fan-out trees.")

        now, park, offs = [], [], {}
        for idx, item in enumerate(held):
            t = item[0]
            if t.anchors and not t.anchors.isdisjoint(dead_roots):
                # Stale output of a failed/timed-out tree: the spout is
                # replaying the whole entry. fail() settles a join
                # tuple's other trees now (no-op for the dead root).
                self.collector.fail(t)
                continue
            if (ledger is None or not t.origins or not t.anchors
                    or t.anchors.isdisjoint(open_roots)):
                now.append(item)
                if t.origins:
                    merge_offsets(offs, (((src_t, src_p), off)
                                         for (src_t, src_p, off)
                                         in t.origins))
            else:
                park.append(item)
                if idx >= n_prev:  # count deferrals once, not per re-plan
                    self._m_deferred.inc()
                for r in t.anchors:
                    if r not in self._watched and ledger.watch(
                            r, (lambda ok, _r=r:
                                self._on_tree_done(_r, ok))):
                        self._watched.add(r)
        return now, park, offs

    async def _flush_txn(self) -> None:
        async with self._flush_lock:
            n_prev = len(self._parked)
            held = self._parked + self._buf
            self._buf = []
            self._parked = []
            if not held:
                return
            if self._offsets_group:
                batch, self._parked, offs = self._plan(held, n_prev)
                if not batch:
                    # _plan may have DROPPED dead-tree tuples even with
                    # nothing to commit — the held counts must reflect it
                    self._rebuild_held()
                    self._rearm_deadline()  # poll until the trees close
                    return
            else:
                batch, offs = held, {}

            def run() -> None:
                self._txn.begin()
                for t, topic, key, value in batch:
                    self._txn.produce(topic, value, key)
                # Offsets (planned above) commit INSIDE the transaction —
                # they never land without the records.
                if offs:
                    self._txn.send_offsets(self._offsets_group, offs)
                self._txn.commit()

            # A network-backed broker's transaction runs off the loop.
            blocking = bool(getattr(self.broker, "blocking", False))
            try:
                if blocking:
                    await asyncio.to_thread(run)
                else:
                    run()
            except Exception as e:
                self._m_aborts.inc()
                try:
                    if blocking:
                        await asyncio.to_thread(self._txn.abort)
                    else:
                        self._txn.abort()
                except Exception:
                    log.exception("txn abort failed (id fenced on next begin)")
                self.collector.report_error(e)
                for t, *_ in batch:
                    self.collector.fail(t)
            else:
                self._m_commits.inc()
                for t, *_ in batch:
                    self._ack_delivered(t)
            # Root-id bookkeeping: recount held tuples per root from the
            # survivors (covers every leave path — committed, failed, and
            # the dead-tree drops inside _plan) and prune stale
            # live-watch ids.
            if self._offsets_group:
                self._rebuild_held()
            # Re-arm the deadline for tuples that arrived while this flush
            # held the lock, AND for parked tuples (their trees close when
            # upstream acks land, so the poll is what re-plans them) — on
            # BOTH the commit and the failed/abort path (a failed flush
            # leaves mid-flush arrivals just as stranded) — without it
            # they could sit unflushed until another tuple shows up (and
            # then double-commit after replay).
            if self._buf or self._parked:
                self._rearm_deadline()
        # Outside the lock: closures that landed mid-flush were judged
        # against pre-flush counts — re-check against the rebuilt ones.
        if self._offsets_group:
            self._maybe_kick_closure()

    def _rearm_deadline(self) -> None:
        # NB: when the current flush was triggered by the deadline task,
        # that task is still `running` (it is us), so `.done()` is False —
        # treat the currently-executing task as done or the re-arm is
        # skipped and the buffered tuples sit unacked until tree timeout +
        # replay (the double-commit this re-arm prevents).
        stale = (self._deadline_task is None
                 or self._deadline_task.done()
                 or self._deadline_task is asyncio.current_task())
        if stale:
            self._deadline_task = asyncio.get_running_loop().create_task(
                self._deadline_flush())

    def cleanup(self) -> None:
        if self._deadline_task is not None:
            self._deadline_task.cancel()
        if self._kick_task is not None:
            # same hazard class as the deadline task: a pending closure
            # kick must not run _flush_txn against a closed producer
            self._kick_task.cancel()
        super().cleanup()
