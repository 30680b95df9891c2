"""Ingest spout (the KafkaSpout equivalent), copied from
``storm_tpu/connectors/spout.py`` for the in-process broker, without group
coordination and seeks.

Offsets are policy: 'latest' + ``max_behind=0`` starts at the log end and
drops backlog; 'resume' commits on ack and resumes; 'earliest' replays
the log; 'txn' starts from the group's committed offsets and never
commits itself (the transactional sink commits each entry's offsets
inside its producer transaction), and delivers in order per partition:
one entry (a record, or a chunk) outstanding per partition, the next
fetched only once the previous tree has acked, so no later offset can
commit while an earlier one is in flight. Every emitted entry carries its
source position as ``origins`` ``(topic, partition, last offset + 1)``.
Each record is emitted with ``msg_id=(partition, offset)``;
failed trees are re-emitted from a replay queue before new fetches unless
the freshness policy says they are too stale. Partitions are assigned to
spout tasks round-robin by task index.

``scheme``: "string" emits each record decoded to ``str``; "raw" emits
the broker bytes untouched. ``chunk`` > 1 slices one fetch into tuples of
up to ``chunk`` consecutive records, each emitted with ``msg_id=("c",
partition, first offset, last offset)``, its ``root_ts`` the oldest
record's append time and one sampling roll; a chunk acks, fails and
replays whole, and offsets commit per chunk. ``frames=True`` (raw scheme
only) carries a chunk as one :class:`~storm_tpu_torch.runtime.frames.
RecordFrame` value instead of a list of payloads; a replay rebuilds the
frame from the same pending records.

With QoS on (``qos=QosConfig(enabled=True)``) each fetched record is
classified from its key (``tenant:lane``) and run through the task's
:class:`~storm_tpu_torch.qos.admission.AdmissionController`: a record not
admitted (its tenant over quota, or its lane shed at the edge) is dropped
with the cursor advanced, and the lane rides downstream as the declared
``qos_lane`` field. A chunk is lane-homogeneous: each slice is split by
lane, highest priority first.

Each emitted tuple rolls the runtime tracer's sampling once: a sampled
tuple's trace opens with an ``ingress`` span from its broker append time;
a miss is passed on as ``NOT_SAMPLED``. With the copy ledger attached,
each emit records its ``spout_ingest`` row (the payloads as they arrived,
no copy), under the string scheme its ``spout_scheme`` row (the bytes ->
str decode, one copy a record), and for a frame its ``batch_route`` row
(one reference moved: zero bytes, zero copies).
"""

from __future__ import annotations

import collections
import logging
import time
import uuid
from typing import Any, Deque, Dict, List, Optional, Tuple

from storm_tpu_torch.config import OffsetsConfig
from storm_tpu_torch.connectors.memory import MemoryBroker, Record
from storm_tpu_torch.obs import copyledger as _copyledger
from storm_tpu_torch.runtime.base import OutputCollector, Spout, TopologyContext
from storm_tpu_torch.runtime.frames import RecordFrame
from storm_tpu_torch.runtime.tracing import NOT_SAMPLED
from storm_tpu_torch.runtime.tuples import Values

log = logging.getLogger("storm_tpu_torch.spout")


class BrokerSpout(Spout):
    def __init__(self, broker: MemoryBroker, topic: str,
                 offsets: Optional[OffsetsConfig] = None,
                 fetch_size: int = 256, chunk: int = 0, scheme: str = "string",
                 qos=None, frames: bool = False) -> None:
        self.broker = broker
        self.topic = topic
        self.offsets_cfg = offsets or OffsetsConfig()
        self.fetch_size = fetch_size
        self.chunk = chunk
        # QosConfig or None; a constructor argument because
        # declare_output_fields runs when the topology is built.
        self.qos = qos if (qos is not None and qos.enabled) else None
        if scheme not in ("string", "raw"):
            raise ValueError(f"unknown spout scheme {scheme!r}")
        self.scheme = scheme
        if frames and scheme != "raw":
            raise ValueError(
                "spout frames need scheme='raw' (record frames carry "
                "broker bytes by reference; the string scheme decodes "
                "per record). Set topology.spout_scheme='raw' or disable "
                "topology.spout_frames.")
        self.frames = bool(frames)

    def clone(self) -> "BrokerSpout":
        """Per-task instance sharing the broker handle."""
        return type(self)(self.broker, self.topic, self.offsets_cfg, self.fetch_size,
                          self.chunk, self.scheme, self.qos, self.frames)

    def declare_output_fields(self):
        if self.qos is not None:
            return {"default": ("message", "qos_lane")}
        return {"default": ("message",)}

    def open(self, context: TopologyContext, collector: OutputCollector) -> None:
        super().open(context, collector)
        self._tracer = getattr(context, "tracer", None)
        # QoS admission, per task (the tenant's rate is split across tasks).
        self._admission = None
        if self.qos is not None:
            from storm_tpu_torch.qos.admission import AdmissionController

            self._admission = AdmissionController(
                self.qos, parallelism=context.parallelism, metrics=context.metrics)
        # A random group per run unless the user pins one for resume.
        self.group = self.offsets_cfg.group_id or f"storm-tpu-torch-{uuid.uuid4()}"
        n_parts = self.broker.partitions_for(self.topic)
        self.my_partitions = [p for p in range(n_parts)
                              if p % context.parallelism == context.task_index]
        # msg_id -> a Record, or a chunk's list of Records.
        self.pending: Dict[Any, Any] = {}
        self.replay: Deque[Any] = collections.deque()
        self.dropped = 0
        self._rr = 0
        # policy='txn': at most one outstanding entry per partition.
        self._txn_mode = self.offsets_cfg.policy == "txn"
        if self._txn_mode and max(1, self.chunk) < 16:
            # Ordered delivery pays a commit and an ack round trip per
            # entry, so small entries cost throughput; the cost goes from
            # chunk >= txn_batch / partitions (storm_tpu's threshold, 16).
            log.warning(
                "offsets.policy='txn' with spout chunk %d: exactly-once "
                "delivers one gated entry per partition at a time; "
                "entries this small cost throughput (free at chunk >= "
                "txn_batch/partitions, typically 16). Raise "
                "topology.spout_chunk.", max(1, self.chunk))
        self._part_inflight: Dict[int, int] = {}
        self.positions = {p: self._initial_position(p) for p in self.my_partitions}

    def ingress_lag(self) -> dict:
        """How far this task's cursors trail the broker's log end, summed
        over its partitions: the observatory's ingress row. The memory
        broker answers offsets at once, so ``records_behind`` is always
        a number (storm_tpu's wire brokers give None)."""
        behind = 0
        for p in self.my_partitions:
            pos = self.positions.get(p)
            if pos is None:
                continue
            behind += max(0, self.broker.latest_offset(self.topic, p) - pos)
        return {"records_behind": behind, "partitions": len(self.my_partitions)}

    def _initial_position(self, p: int) -> int:
        cfg = self.offsets_cfg
        if cfg.policy == "latest":
            return self.broker.latest_offset(self.topic, p)
        if cfg.policy == "earliest":
            return self.broker.earliest_offset(self.topic, p)
        committed = self.broker.committed(self.group, self.topic, p)
        pos = committed if committed is not None else self.broker.earliest_offset(self.topic, p)
        if cfg.max_behind is not None:
            latest = self.broker.latest_offset(self.topic, p)
            if latest - pos > cfg.max_behind:
                self.dropped += latest - cfg.max_behind - pos
                pos = latest - cfg.max_behind
        return pos

    async def next_tuple(self) -> bool:
        # Replays first: failed trees take priority over new data.
        if self.replay:
            entry = self.replay.popleft()
            if isinstance(entry, list):
                await self._emit_chunk(entry)
            else:
                await self._emit(entry)
            return True
        for _ in range(len(self.my_partitions)):
            p = self.my_partitions[self._rr % len(self.my_partitions)]
            self._rr += 1
            if self._txn_mode and self._part_inflight.get(p, 0):
                continue  # ordered delivery: the previous entry is open
            # txn mode: one entry a fetch (the chunk, or one record).
            size = max(1, self.chunk) if self._txn_mode else self.fetch_size
            records = self.broker.fetch(self.topic, p, self.positions[p], size)
            if not records:
                continue
            last_off = records[-1].offset
            if self._admission is not None:
                # Records not admitted are dropped with the cursor advanced.
                records = self._admit_records(records)
            # Emit first, advance the cursor after: an exception mid-loop
            # must re-fetch the unemitted tail (duplicates are the safe
            # direction for at-least-once).
            # txn mode counts an entry after its emit: one counted before
            # an emit that raised would gate the partition forever.
            if self.chunk > 1:
                # One fetch sliced into chunk tuples; under QoS each slice
                # splits into lane-homogeneous groups.
                for i in range(0, len(records), self.chunk):
                    for group in self._lane_groups(records[i: i + self.chunk]):
                        await self._emit_chunk(group)
                        if self._txn_mode:
                            self._part_inflight[p] = self._part_inflight.get(p, 0) + 1
            else:
                for rec in records:
                    await self._emit(rec)
                    if self._txn_mode:
                        self._part_inflight[p] = self._part_inflight.get(p, 0) + 1
            self.positions[p] = last_off + 1
            return True
        return False

    def _admit_records(self, records: List[Record]) -> List[Record]:
        """The fetched records the admission controller admits; it counts
        the others."""
        admitted = []
        for rec in records:
            tenant, lane = self._admission.classify(rec.key, self.topic)
            if self._admission.admit(tenant, lane)[0]:
                admitted.append(rec)
            else:
                self.dropped += 1
        return admitted

    def _lane_of(self, rec: Record) -> str:
        return self._admission.classify(rec.key, self.topic)[1]

    def _lane_groups(self, records: List[Record]):
        """One chunk slice split into lane-homogeneous groups, highest
        priority first (the lane comes from the key, so a replayed chunk
        keeps its lane); without QoS the slice whole."""
        if self._admission is None:
            yield records
            return
        groups: Dict[str, List[Record]] = {}
        for rec in records:
            groups.setdefault(self._lane_of(rec), []).append(rec)
        for lane in sorted(groups, key=self.qos.lane_index):
            yield groups[lane]

    def _append_root_ts(self, rec: Record) -> float:
        """E2E ingress clock = broker append time, rebased onto
        ``perf_counter`` and clamped to now."""
        now_perf = time.perf_counter()
        if rec.timestamp <= 0:
            return now_perf
        return now_perf - max(time.time() - rec.timestamp, 0.0)

    def _scheme_value(self, value: bytes):
        return value if self.scheme == "raw" else value.decode("utf-8", "replace")

    def _mint_trace(self, root_ts: float, partition: int, offset: int, records: int = 1):
        """The sampling roll of one root: a TraceContext whose ``ingress``
        span starts at broker-append time (so it shows queueing in the
        broker too), or NOT_SAMPLED, so the collector does not roll
        again."""
        tracer = self._tracer
        if tracer is None or not tracer.active:
            return NOT_SAMPLED
        ctx = tracer.maybe_trace()
        if ctx is None:
            return NOT_SAMPLED
        attrs = {"topic": self.topic, "partition": partition, "offset": offset}
        if records > 1:
            attrs["records"] = records
        tracer.record(ctx, "ingress", self.context.component_id, root_ts,
                      time.perf_counter(), attrs=attrs)
        return ctx

    def _ledger_ingest(self, records: List[Record]) -> None:
        """One call per emit: the payloads as they arrived (not a copy)
        and, under the string scheme, their bytes -> str decode."""
        if not _copyledger.active():
            return
        payload = sum(len(r.value) for r in records)
        comp = self.context.component_id
        _copyledger.record("spout_ingest", payload, copies=0, allocs=0,
                           records=len(records), engine=comp)
        if self.scheme != "raw":
            _copyledger.record("spout_scheme", payload, copies=len(records),
                               allocs=len(records), records=len(records), engine=comp)

    async def _emit_chunk(self, records: List[Record]) -> None:
        first, last = records[0], records[-1]
        msg_id = ("c", first.partition, first.offset, last.offset)
        self.pending[msg_id] = records
        root_ts = self._append_root_ts(first)
        self._ledger_ingest(records)
        if self.frames:
            # The chunk rides as ONE frame: routing moves a reference.
            frame = RecordFrame([r.value for r in records])
            if _copyledger.active():
                _copyledger.record("batch_route", 0, copies=0, allocs=1,
                                   records=len(records), engine=self.context.component_id)
            vals = [frame]
        else:
            vals = [[self._scheme_value(r.value) for r in records]]
        if self.qos is not None:
            # Lane-homogeneous: the first record's lane is the chunk's.
            vals.append(self._lane_of(first))
        # The oldest record's append time: its queueing is the one that counts.
        await self.collector.emit(Values(vals), msg_id=msg_id, root_ts=root_ts,
                                  origins=frozenset({(self.topic, first.partition,
                                                      last.offset + 1)}),
                                  trace=self._mint_trace(root_ts, first.partition,
                                                         first.offset, len(records)))

    async def _emit(self, rec: Record) -> None:
        msg_id = (rec.partition, rec.offset)
        self.pending[msg_id] = rec
        root_ts = self._append_root_ts(rec)
        self._ledger_ingest([rec])
        vals = [self._scheme_value(rec.value)]
        if self._admission is not None:
            # Derived from the key again, so a replay carries the same lane.
            vals.append(self._lane_of(rec))
        await self.collector.emit(Values(vals), msg_id=msg_id, root_ts=root_ts,
                                  origins=frozenset({(self.topic, rec.partition,
                                                      rec.offset + 1)}),
                                  trace=self._mint_trace(root_ts, rec.partition, rec.offset))

    @staticmethod
    def _msg_part_off(msg_id) -> Tuple[int, int]:
        """(partition, last offset) of a record's or a chunk's msg id."""
        if msg_id[0] == "c":
            return msg_id[1], msg_id[3]
        return msg_id

    def ack(self, msg_id: Any) -> None:
        self.pending.pop(msg_id, None)
        if self._txn_mode:
            # The entry's offsets committed in the sink's transaction: the
            # partition may fetch its next entry. A failed entry stays
            # counted through its replay until the replay acks.
            p, _ = self._msg_part_off(msg_id)
            n = self._part_inflight.get(p, 0)
            if n > 0:
                self._part_inflight[p] = n - 1
        if self.offsets_cfg.policy != "resume":
            return
        p, off = self._msg_part_off(msg_id)
        # Commit the contiguous low-water mark of the partition, counting
        # the first offset of every open record or chunk and the records
        # awaiting replay, so a restart never skips them.
        open_offs = [mid[2] if mid[0] == "c" else mid[1] for mid in self.pending
                     if self._msg_part_off(mid)[0] == p]
        for entry in self.replay:
            recs = entry if isinstance(entry, list) else [entry]
            open_offs += [r.offset for r in recs if r.partition == p]
        low = min(open_offs) if open_offs else off + 1
        prev = self.broker.committed(self.group, self.topic, p)
        if prev is None or low > prev:
            self.broker.commit(self.group, self.topic, p, low)

    def fail(self, msg_id: Any) -> None:
        entry = self.pending.pop(msg_id, None)
        if entry is None:
            return
        max_behind = self.offsets_cfg.max_behind
        # Staleness by the entry's newest record: a chunk stays whole while
        # its tail is fresh.
        rec = entry[-1] if isinstance(entry, list) else entry
        if max_behind is not None and \
                self.broker.latest_offset(self.topic, rec.partition) - rec.offset > max_behind:
            # Too stale to replay under the freshness policy.
            n = len(entry) if isinstance(entry, list) else 1
            self.dropped += n
            self.context.metrics.counter(self.context.component_id, "dropped_stale").inc(n)
            return
        self.replay.append(entry)
