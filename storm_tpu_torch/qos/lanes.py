"""Earliest-deadline-first batch formation over weighted priority lanes,
copied from ``storm_tpu/qos/lanes.py``.

A drop-in for :class:`~storm_tpu_torch.infer.batcher.MicroBatcher` (the
same ``add``/``take_ready``/``take_if_due``/``take_all``/``oldest_ts``
surface, plus ``stats``). Pending records sit in a min-heap keyed by absolute
deadline (broker append time + the lane's ``lane_deadline_ms``), and a take
pops at most ``max_batch`` instances in deadline order, leaving the rest
pending: a fresh high-priority record preempts queued best-effort ones.
Dispatch timing keeps the MicroBatcher's contract (full, or the oldest
record waited ``max_wait_ms``), so QoS does not move an idle topology's
latency floor.
"""

from __future__ import annotations

import heapq
import time
from typing import Any, List, Optional

import numpy as np

from storm_tpu_torch.config import BatchConfig, QosConfig
from storm_tpu_torch.infer.batcher import Batch, BatchItem


class LaneBatcher:
    def __init__(self, cfg: BatchConfig, qos: QosConfig) -> None:
        self.cfg = cfg
        self.qos = qos
        # (deadline_s, seq, BatchItem); seq keeps a lane FIFO on ties.
        self._heap: List[tuple] = []
        self._seq = 0
        self._count = 0

    def __len__(self) -> int:
        return self._count

    @property
    def oldest_ts(self) -> Optional[float]:
        """Oldest arrival among pending items: deadlines order the take,
        age still bounds the dispatch."""
        if not self._heap:
            return None
        return min(entry[2].ts for entry in self._heap)

    def stats(self) -> dict:
        """Depth, age from batcher entry (queue dwell, not deadline
        slack) and the pending rows per lane."""
        now = time.perf_counter()
        oldest = min((entry[2].enq for entry in self._heap), default=None)
        by_lane: dict = {}
        for _deadline, _seq, item in self._heap:
            lane = item.lane or ""
            by_lane[lane] = by_lane.get(lane, 0) + item.data.shape[0]
        return {
            "kind": "lane",
            "pending_rows": self._count,
            "depth": len(self._heap),
            "oldest_ms": (round(max(0.0, (now - oldest) * 1e3), 3)
                          if oldest is not None else 0.0),
            "pending_by_lane": by_lane,
        }

    def add(self, payload: Any, data: np.ndarray, ts: Optional[float] = None,
            lane: Optional[str] = None) -> Optional[Batch]:
        """Add one record (n_i instances). Returns a deadline-ordered batch
        once ``max_batch`` instances are pending; later-deadline items
        past ``max_batch`` stay pending for the next take."""
        now = time.perf_counter()
        base = ts if ts is not None else now
        deadline = base + self.qos.deadline_for(lane) / 1e3
        heapq.heappush(self._heap, (deadline, self._seq,
                                    BatchItem(payload, data, base, now, lane)))
        self._seq += 1
        self._count += data.shape[0]
        if self._count >= self.cfg.max_batch:
            return self._take()
        return None

    def take_ready(self) -> Optional[Batch]:
        """Another full batch of leftovers (a take caps at max_batch, so
        heavy records can leave a full batch pending after ``add``)."""
        if self._count >= self.cfg.max_batch:
            return self._take()
        return None

    def take_if_due(self, now: Optional[float] = None) -> Optional[Batch]:
        if not self._heap:
            return None
        now = now if now is not None else time.perf_counter()
        oldest = self.oldest_ts
        if oldest is not None and (now - oldest) * 1e3 >= self.cfg.max_wait_ms:
            return self._take()
        return None

    def take_all(self) -> Optional[Batch]:
        return self._take() if self._heap else None

    def _take(self) -> Batch:
        """Earliest-deadline items up to max_batch instances; always at
        least one item, so an oversized record still ships alone."""
        items: List[BatchItem] = []
        size = 0
        while self._heap:
            n = self._heap[0][2].data.shape[0]
            if items and size + n > self.cfg.max_batch:
                break
            items.append(heapq.heappop(self._heap)[2])
            size += n
        self._count -= size
        return Batch(items, size)
