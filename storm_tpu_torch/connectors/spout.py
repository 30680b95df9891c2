"""Ingest spout (the KafkaSpout equivalent), copied from
``storm_tpu/connectors/spout.py`` for the in-process broker, without
chunks, frames, QoS admission, group coordination and tracing.

Offsets are policy: 'latest' + ``max_behind=0`` starts at the log end and
drops backlog; 'resume' commits on ack and resumes; 'earliest' replays
the log. Each record is emitted with ``msg_id=(partition, offset)``;
failed trees are re-emitted from a replay queue before new fetches unless
the freshness policy says they are too stale. Partitions are assigned to
spout tasks round-robin by task index.
"""

from __future__ import annotations

import collections
import time
import uuid
from typing import Any, Deque, Dict, Optional, Tuple

from storm_tpu_torch.config import OffsetsConfig
from storm_tpu_torch.connectors.memory import MemoryBroker, Record
from storm_tpu_torch.runtime.base import OutputCollector, Spout, TopologyContext
from storm_tpu_torch.runtime.tuples import Values


class BrokerSpout(Spout):
    def __init__(self, broker: MemoryBroker, topic: str,
                 offsets: Optional[OffsetsConfig] = None,
                 fetch_size: int = 256) -> None:
        self.broker = broker
        self.topic = topic
        self.offsets_cfg = offsets or OffsetsConfig()
        self.fetch_size = fetch_size

    def clone(self) -> "BrokerSpout":
        """Per-task instance sharing the broker handle."""
        return type(self)(self.broker, self.topic, self.offsets_cfg, self.fetch_size)

    def open(self, context: TopologyContext, collector: OutputCollector) -> None:
        super().open(context, collector)
        # A random group per run unless the user pins one for resume.
        self.group = self.offsets_cfg.group_id or f"storm-tpu-torch-{uuid.uuid4()}"
        n_parts = self.broker.partitions_for(self.topic)
        self.my_partitions = [p for p in range(n_parts)
                              if p % context.parallelism == context.task_index]
        self.pending: Dict[Tuple[int, int], Record] = {}
        self.replay: Deque[Record] = collections.deque()
        self.dropped = 0
        self._rr = 0
        self.positions = {p: self._initial_position(p) for p in self.my_partitions}

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
            await self._emit(self.replay.popleft())
            return True
        for _ in range(len(self.my_partitions)):
            p = self.my_partitions[self._rr % len(self.my_partitions)]
            self._rr += 1
            records = self.broker.fetch(self.topic, p, self.positions[p], self.fetch_size)
            if not records:
                continue
            # Emit first, advance the cursor after: an exception mid-loop
            # must re-fetch the unemitted tail (duplicates are the safe
            # direction for at-least-once).
            for rec in records:
                await self._emit(rec)
            self.positions[p] = records[-1].offset + 1
            return True
        return False

    def _append_root_ts(self, rec: Record) -> float:
        """E2E ingress clock = broker append time, rebased onto
        ``perf_counter`` and clamped to now."""
        now_perf = time.perf_counter()
        if rec.timestamp <= 0:
            return now_perf
        return now_perf - max(time.time() - rec.timestamp, 0.0)

    async def _emit(self, rec: Record) -> None:
        msg_id = (rec.partition, rec.offset)
        self.pending[msg_id] = rec
        await self.collector.emit(Values([rec.value.decode("utf-8", "replace")]),
                                  msg_id=msg_id, root_ts=self._append_root_ts(rec))

    def ack(self, msg_id: Any) -> None:
        self.pending.pop(msg_id, None)
        if self.offsets_cfg.policy != "resume":
            return
        p, off = msg_id
        # Commit the contiguous low-water mark of the partition, counting
        # failed records awaiting replay, so a restart never skips them.
        open_offs = [o for (pp, o) in self.pending if pp == p]
        open_offs += [r.offset for r in self.replay if r.partition == p]
        low = min(open_offs) if open_offs else off + 1
        prev = self.broker.committed(self.group, self.topic, p)
        if prev is None or low > prev:
            self.broker.commit(self.group, self.topic, p, low)

    def fail(self, msg_id: Any) -> None:
        rec = self.pending.pop(msg_id, None)
        if rec is None:
            return
        max_behind = self.offsets_cfg.max_behind
        if max_behind is not None and \
                self.broker.latest_offset(self.topic, rec.partition) - rec.offset > max_behind:
            # Too stale to replay under the freshness policy.
            self.dropped += 1
            self.context.metrics.counter(self.context.component_id, "dropped_stale").inc()
            return
        self.replay.append(rec)
