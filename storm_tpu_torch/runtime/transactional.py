"""Exactly-once micro-batches (Storm's Trident), copied from
``storm_tpu/runtime/transactional.py``: numbered batches whose state
writes and egress record the txid, so a replayed batch applies once.

- :class:`TransactionalSpout`: numbered batches from a broker topic; a
  txid always holds the same records. The batch's offset ranges are
  committed to a second group before its first emit, so a restarted
  coordinator re-forms the identical batch; txids are the sum of the
  partitions' cursors, so they increase across restarts. Only task 0
  coordinates.
- :class:`TransactionalState`: per-key ``(txid, value)`` cells over a
  :class:`~storm_tpu_torch.runtime.state.KeyValueState`; a txid at or
  below the stored one is a no-op.
- :class:`OpaqueState`: ``(txid, value, prev)`` cells that re-apply the
  same txid over ``prev`` (a source that cannot replay identically).
- :class:`TransactionalBolt`: one batch per tuple through
  ``process_batch``; its state is checkpointed before the ack.
- :class:`TransactionalSink`: each batch produced once. Over a broker
  with transactions (``.txn()``) the records and a ``last_txid`` marker
  (a consumer-group offset) commit in one transaction, so a sink that
  lost its state reads the marker back and skips the replay; without
  transactions it produces txid-idempotently.

Transactional bolts and sinks refuse a parallelism above 1: the txid
dedup is per task. One batch is in flight at a time, so commits are in
txid order.
"""

from __future__ import annotations

import json
from typing import Any, Callable, Dict, List, Sequence, Tuple as Tup

from storm_tpu_torch.runtime.base import OutputCollector, Spout, TopologyContext
from storm_tpu_torch.runtime.state import KeyValueState, StatefulBolt
from storm_tpu_torch.runtime.tuples import Tuple, Values


class TransactionalSpout(Spout):
    """Numbered, immutable micro-batches from a broker topic.

    Single coordinator: only task 0 emits (Trident's batch coordinator is
    one instance); extra tasks idle.

    The txid is the sum of ALL partitions' post-batch cursors — strictly
    increasing batch to batch (each batch advances at least one cursor),
    identical when a batch is re-formed from persisted pending ranges, and
    monotonic across restarts.
    """

    def __init__(self, broker, topic: str, batch_size: int = 100,
                 group: str = "tx") -> None:
        self.broker = broker
        self.topic = topic
        self.batch_size = batch_size
        self.group = group

    def clone(self) -> "TransactionalSpout":
        return TransactionalSpout(self.broker, self.topic, self.batch_size,
                                  self.group)

    def declare_output_fields(self):
        return {"default": ("batch", "txid")}

    @property
    def _pending_group(self) -> str:
        return self.group + ".pending"

    # commit_many is emulated with per-partition commits where the adapter lacks it (the
    # partial-commit window is safe here: state is checkpointed before ack,
    # so a half-committed batch re-forms as the same txid with the already-
    # applied subset, which the txid cells skip and the re-ack completes).
    def _commit_sync(self, group: str, offsets: Dict[int, int]) -> None:
        commit_many = getattr(self.broker, "commit_many", None)
        if commit_many is not None:
            commit_many(group, self.topic, offsets)
        else:
            for p, off in offsets.items():
                self.broker.commit(group, self.topic, p, off)

    def open(self, context: TopologyContext, collector: OutputCollector) -> None:
        super().open(context, collector)
        self._coordinator = context.task_index == 0
        self._inflight: Dict[int, Dict[int, Tup[int, int]]] = {}  # txid -> {part: (start, end)}
        self._replays: List[int] = []
        self._cursor: Dict[int, int] = {}
        self._to_commit: "Dict[int, int] | None" = None
        if not self._coordinator:
            return
        n = self.broker.partitions_for(self.topic)
        bases: Dict[int, int] = {}
        pend_ranges: Dict[int, Tup[int, int]] = {}
        for p in range(n):
            committed = self.broker.committed(self.group, self.topic, p)
            base = (committed if committed is not None
                    else self.broker.earliest_offset(self.topic, p))
            bases[p] = base
            pend = self.broker.committed(self._pending_group, self.topic, p)
            if pend is not None and pend > base:
                pend_ranges[p] = (base, pend)
        self._cursor = dict(bases)
        if pend_ranges:
            # Crash recovery: a batch was planned (ranges persisted) but
            # never fully committed. Re-form the IDENTICAL batch — same
            # ranges, same txid — and replay it first.
            for p, (_s, end) in pend_ranges.items():
                self._cursor[p] = end
            txid = sum(self._cursor.values())
            self._inflight[txid] = pend_ranges
            self._replays.append(txid)

    # ---- batch assembly ------------------------------------------------------

    def _fetch_range(self, ranges: Dict[int, Tup[int, int]]) -> List[str]:
        records: List[str] = []
        for p, (start, end) in sorted(ranges.items()):
            for r in self.broker.fetch(self.topic, p, start, max_records=end - start):
                v = r.value
                records.append(v.decode("utf-8", "replace") if isinstance(v, bytes) else v)
        return records

    async def next_tuple(self) -> bool:
        if not self._coordinator:
            return False
        if self._to_commit:
            # acks defer their offset commit here: commits must precede
            # the next batch
            offsets, self._to_commit = self._to_commit, None
            self._commit_sync(self.group, offsets)
        if self._replays:
            txid = self._replays.pop(0)
            ranges = self._inflight[txid]
            records = self._fetch_range(ranges)
            await self.collector.emit(Values([records, txid]), msg_id=txid)
            return True
        if self._inflight:
            return False  # single batch in flight: commits stay ordered
        ranges: Dict[int, Tup[int, int]] = {}
        records: List[str] = []
        budget = self.batch_size

        for p in sorted(self._cursor):
            if budget <= 0:
                break
            start = self._cursor[p]
            got = self.broker.fetch(self.topic, p, start, max_records=budget)
            if got:
                ranges[p] = (start, start + len(got))
                budget -= len(got)
                for r in got:
                    v = r.value
                    # errors="replace", like BrokerSpout: one undecodable
                    # record must not stall the coordinator forever
                    records.append(
                        v.decode("utf-8", "replace") if isinstance(v, bytes) else v
                    )
        if not ranges:
            return False
        # Persist the planned ranges BEFORE first emit: a coordinator crash
        # mid-batch must re-form this exact batch, not a different one that
        # could overlap already-applied state updates (Trident persists its
        # coordinator metadata for the same reason).
        self._commit_sync(self._pending_group,
                          {p: end for p, (_s, end) in ranges.items()})
        for p, (_s, end) in ranges.items():
            self._cursor[p] = end
        txid = sum(self._cursor.values())
        self._inflight[txid] = ranges
        await self.collector.emit(Values([records, txid]), msg_id=txid)
        return True

    # ---- completion ----------------------------------------------------------

    def ack(self, msg_id: Any) -> None:
        ranges = self._inflight.pop(msg_id, None)
        if ranges is None:
            return
        # Deferred to next_tuple (async context): with one batch in flight
        # the queue depth is <=1 and the commit always lands before the next
        # batch forms. A crash before the flush replays the batch, whose
        # effects are already checkpointed -> txid cells skip, re-ack
        # completes the commit.
        self._to_commit = {p: end for p, (_s, end) in ranges.items()}

    def fail(self, msg_id: Any) -> None:
        if msg_id in self._inflight and msg_id not in self._replays:
            self._replays.append(msg_id)


def _require_single_task(context: TopologyContext) -> None:
    """txid dedup state is per-task; with shuffle grouping and >1 task a
    replayed txid can land on a task that never saw it — double-apply.
    Batches are one tuple anyway, so extra tasks buy nothing: refuse."""
    if context.parallelism != 1:
        raise ValueError(
            f"{context.component_id}: transactional bolts/sinks require "
            f"parallelism=1 (got {context.parallelism}); txid replay dedup "
            "is per-task state"
        )


class TransactionalState:
    """Per-key ``{"txid": t, "v": value}`` cells: exactly-once updates under
    replay, provided a replayed txid carries identical records (the
    transactional spout contract) and commits are in txid order."""

    def __init__(self, kv: KeyValueState) -> None:
        self.kv = kv

    def apply(self, key: str, txid: int, fn: Callable[[Any], Any],
              init: Any = None) -> Any:
        """Set ``key`` to ``fn(previous)`` for this txid; replayed txids
        return the stored value untouched."""
        cell = self.kv.get(key)
        if cell is not None and cell["txid"] >= txid:
            return cell["v"]  # replay: already applied
        value = fn(cell["v"] if cell is not None else init)
        self.kv.put(key, {"txid": txid, "v": value})
        return value

    def value(self, key: str, default: Any = None) -> Any:
        cell = self.kv.get(key)
        return default if cell is None else cell["v"]

    def items(self):
        for k, cell in self.kv.items():
            yield k, cell["v"]


class OpaqueState(TransactionalState):
    """Trident's opaque-transactional state: cells are
    ``{"txid": t, "v": value, "prev": value_before_t}``.

    When the SAME txid is applied again, the update is recomputed over
    ``prev`` instead of skipped — correct even if that txid's batch content
    changed (a source that can't replay identical batches). Still requires
    in-order commits."""

    def apply(self, key: str, txid: int, fn: Callable[[Any], Any],
              init: Any = None) -> Any:
        cell = self.kv.get(key)
        if cell is None:
            value = fn(init)
            self.kv.put(key, {"txid": txid, "v": value, "prev": init})
            return value
        if cell["txid"] == txid:
            value = fn(cell["prev"])  # same batch again: redo over prev
            self.kv.put(key, {"txid": txid, "v": value, "prev": cell["prev"]})
            return value
        if cell["txid"] > txid:
            return cell["v"]  # older replay: already folded in
        value = fn(cell["v"])
        self.kv.put(key, {"txid": txid, "v": value, "prev": cell["v"]})
        return value


class TransactionalBolt(StatefulBolt):
    """One batch per tuple; subclasses implement ``process_batch``.

    ``process_batch`` returns the batch's output *messages*; they are
    emitted downstream as ONE ``(batch, txid)`` tuple — the batch stays
    atomic through the topology, which is what lets the txid-keyed sink
    dedup replays (per-record emits sharing a txid would make the second
    record of a batch look like a replay of the first). Anchored to the
    input tuple, so a downstream failure fails and replays the whole
    batch; state updates (through :class:`TransactionalState`) still
    apply exactly once. Set ``opaque = True`` for :class:`OpaqueState`
    semantics."""

    opaque = False

    def declare_output_fields(self):
        return {"default": ("batch", "txid")}

    def prepare(self, context: TopologyContext, collector: OutputCollector) -> None:
        super().prepare(context, collector)
        _require_single_task(context)

    def init_state(self, state: KeyValueState) -> None:
        super().init_state(state)
        self.tx_state = (OpaqueState if self.opaque else TransactionalState)(state)

    async def process_batch(self, txid: int, records: Sequence[str],
                            state: TransactionalState) -> List[Any]:
        raise NotImplementedError

    async def execute(self, t: Tuple) -> None:
        txid = t.get("txid")
        outs = await self.process_batch(txid, t.get("batch"), self.tx_state)
        if outs:
            await self.collector.emit(Values([list(outs), txid]), anchors=[t])
        # Persist BEFORE ack: the ack chain ends in an offset commit, and a
        # committed batch must never be replayable while its state updates
        # sit only in memory (crash between ack and the periodic snapshot).
        self.checkpoint_now()
        self.collector.ack(t)


class TransactionalSink(StatefulBolt):
    """Exactly-once egress: produce each batch's output once, keyed by txid.

    Expects tuples with fields ``(message, txid)`` (or ``(batch, txid)``
    with a list payload). Skips txids at or below the last produced one —
    the replayed half of a failed tuple tree does not duplicate output.

    When the broker supports transactions (``.txn()``), the batch's
    records and the txid marker commit ATOMICALLY: the marker is written
    as a consumer-group offset inside the producer transaction
    (``send_offsets`` -> KIP-98 AddOffsetsToTxn/TxnOffsetCommit on the
    wire broker), so a crash between produce and state checkpoint cannot
    double-produce — on replay the durable marker (read back at first
    execute) says the txid already committed. ``use_txn=False`` forces
    the plain idempotent path (effectively-once across that crash
    window)."""

    # Defaults for instances driven without prepare() (unit harnesses):
    # plain idempotent produce, no broker transaction.
    _txn = None
    _marker_synced = True

    def __init__(self, broker, topic: str,
                 use_txn: "bool | None" = None) -> None:
        self.broker = broker
        self.topic = topic
        # None = auto: transactional whenever the broker can
        self.use_txn = use_txn

    def clone(self) -> "TransactionalSink":
        return TransactionalSink(self.broker, self.topic, self.use_txn)

    def prepare(self, context: TopologyContext, collector: OutputCollector) -> None:
        super().prepare(context, collector)
        _require_single_task(context)
        use = self.use_txn
        if use is None:
            use = hasattr(self.broker, "txn")
        self._txn = None
        self._marker_synced = not use
        if use:
            ident = (f"{context.config.topology.name}-"
                     f"{context.component_id}-{context.task_index}")
            self._txn = self.broker.txn(ident)
            # txid marker namespace: a consumer group whose 'offset' for
            # (topic, 0) is the last committed txid — durable at the
            # broker, atomic with the records.
            self._marker_group = f"txnsink.{ident}"

    def _sync_marker(self) -> None:
        """Adopt the broker-side txid marker when it is ahead of local
        state — the exact crash shape the atomic commit exists for
        (produced + marker committed, state checkpoint lost)."""
        marker = self.broker.committed(self._marker_group, self.topic, 0)
        if marker is not None and marker > self.state.get("last_txid", -1):
            self.state.put("last_txid", marker)
        self._marker_synced = True

    async def execute(self, t: Tuple) -> None:
        if not self._marker_synced:
            self._sync_marker()
        txid = t.get("txid", None)
        last = self.state.get("last_txid", -1)
        if txid is not None and txid <= last:
            self.collector.ack(t)  # replay: output already produced
            return
        payload = t.get("batch", None)
        messages = payload if payload is not None else [t.get("message")]
        values = [m if isinstance(m, (str, bytes)) else json.dumps(m)
                  for m in messages]
        if self._txn is not None:
            try:
                self._txn.begin()
                for value in values:
                    self._txn.produce(self.topic, value)
                if txid is not None:
                    self._txn.send_offsets(
                        self._marker_group, {(self.topic, 0): txid})
                self._txn.commit()
            except Exception as e:
                try:
                    self._txn.abort()
                except Exception:
                    pass  # fenced on next begin()
                self.collector.report_error(e)
                self.collector.fail(t)
                return
        else:
            for value in values:
                self.broker.produce(self.topic, value)
        if txid is not None:
            self.state.put("last_txid", txid)
        self.checkpoint_now()
        self.collector.ack(t)
