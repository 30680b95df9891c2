"""In-process broker with Kafka semantics (topics, partitions, offsets,
consumer-group commits), copied from ``storm_tpu/connectors/memory.py``
without transactions. Thread-safe: producers on other threads feed the
asyncio runtime."""

from __future__ import annotations

import threading
import time
from dataclasses import dataclass
from typing import Dict, List, Optional, Tuple


@dataclass(frozen=True)
class Record:
    topic: str
    partition: int
    offset: int
    key: Optional[bytes]
    value: bytes
    timestamp: float


class MemoryBroker:
    """Append-only per-partition logs + consumer-group offset store."""

    def __init__(self, default_partitions: int = 4) -> None:
        self._lock = threading.Lock()
        self._logs: Dict[Tuple[str, int], List[Record]] = {}
        self._partitions: Dict[str, int] = {}
        self._committed: Dict[Tuple[str, str, int], int] = {}  # (group, topic, part)
        self.default_partitions = default_partitions
        self._rr: Dict[str, int] = {}

    def _ensure(self, topic: str) -> None:
        if topic not in self._partitions:
            n = self.default_partitions
            self._partitions[topic] = n
            for p in range(n):
                self._logs[(topic, p)] = []
            self._rr[topic] = 0

    def partitions_for(self, topic: str) -> int:
        with self._lock:
            self._ensure(topic)
            return self._partitions[topic]

    def produce(self, topic: str, value: bytes | str,
                key: Optional[bytes | str] = None,
                partition: Optional[int] = None) -> Tuple[int, int]:
        """Append a record; returns (partition, offset). Hash of the key
        picks the partition when present, round-robin otherwise."""
        if isinstance(value, str):
            value = value.encode("utf-8")
        if isinstance(key, str):
            key = key.encode("utf-8")
        with self._lock:
            self._ensure(topic)
            n = self._partitions[topic]
            if partition is None:
                if key is not None:
                    partition = hash(key) % n
                else:
                    partition = self._rr[topic] % n
                    self._rr[topic] += 1
            log = self._logs[(topic, partition)]
            rec = Record(topic, partition, len(log), key, value, time.time())
            log.append(rec)
            return partition, rec.offset

    def fetch(self, topic: str, partition: int, offset: int,
              max_records: int = 512) -> List[Record]:
        with self._lock:
            self._ensure(topic)
            return self._logs[(topic, partition)][max(0, offset): max(0, offset) + max_records]

    def earliest_offset(self, topic: str, partition: int) -> int:
        return 0

    def latest_offset(self, topic: str, partition: int) -> int:
        """Offset one past the last record (Kafka's 'log end offset')."""
        with self._lock:
            self._ensure(topic)
            return len(self._logs[(topic, partition)])

    def commit(self, group: str, topic: str, partition: int, offset: int) -> None:
        with self._lock:
            self._committed[(group, topic, partition)] = offset

    def committed(self, group: str, topic: str, partition: int) -> Optional[int]:
        with self._lock:
            return self._committed.get((group, topic, partition))

    def drain_topic(self, topic: str) -> List[Record]:
        """Every record ever produced to ``topic``, in append order (does
        not consume)."""
        with self._lock:
            self._ensure(topic)
            out: List[Record] = []
            for p in range(self._partitions[topic]):
                out.extend(self._logs[(topic, p)])
            return sorted(out, key=lambda r: (r.timestamp, r.partition, r.offset))

    def topic_size(self, topic: str) -> int:
        with self._lock:
            self._ensure(topic)
            return sum(len(self._logs[(topic, p)]) for p in range(self._partitions[topic]))
