"""Deadline-based micro-batcher, copied from ``storm_tpu/infer/batcher.py``
(the QoS lanes' earliest-deadline-first batcher is
:class:`storm_tpu_torch.qos.lanes.LaneBatcher`, on the same surface).

Dispatch when ``max_batch`` instances are waiting or the oldest has waited
``max_wait_ms``. Pure accumulation logic; the operator owns timing and
tasks.
"""

from __future__ import annotations

import time
from dataclasses import dataclass
from typing import Any, List, Optional, Tuple

import numpy as np

from storm_tpu_torch.config import BatchConfig


@dataclass
class BatchItem:
    payload: Any  # opaque per-record context (the runtime tuple)
    data: np.ndarray  # (n_i, *instance_shape)
    ts: float  # deadline clock: root (append) time when known
    # batcher-entry time: what the operator's batch_wait_ms is measured from
    enq: float = 0.0
    # QoS priority lane (None outside QoS mode), for the lane batcher.
    lane: Optional[str] = None


@dataclass
class Batch:
    items: List[BatchItem]
    size: int  # total instances

    def stack(self) -> np.ndarray:
        return np.concatenate([it.data for it in self.items], axis=0)

    def parts(self) -> List[np.ndarray]:
        return [it.data for it in self.items]

    def split(self, out: np.ndarray) -> List[Tuple[Any, np.ndarray]]:
        """Slice a (size, K) result back per item."""
        res = []
        ofs = 0
        for it in self.items:
            n = it.data.shape[0]
            res.append((it.payload, out[ofs: ofs + n]))
            ofs += n
        return res


class MicroBatcher:
    def __init__(self, cfg: BatchConfig) -> None:
        self.cfg = cfg
        self._items: List[BatchItem] = []
        self._count = 0

    def __len__(self) -> int:
        return self._count

    @property
    def oldest_ts(self) -> Optional[float]:
        return self._items[0].ts if self._items else None

    def add(self, payload: Any, data: np.ndarray,
            ts: Optional[float] = None) -> Optional[Batch]:
        """Add one record (n_i instances); returns a ready Batch when
        ``max_batch`` is reached, else None. A record that would overshoot
        first flushes the pending batch; if the new record alone then
        fills a batch, the caller drains it with :meth:`take_ready`."""
        n = data.shape[0]
        flushed: Optional[Batch] = None
        if self._count and self._count + n > self.cfg.max_batch:
            flushed = self._take()
        now = time.perf_counter()
        self._items.append(BatchItem(payload, data, ts if ts is not None else now, now))
        self._count += n
        if self._count >= self.cfg.max_batch and flushed is None:
            return self._take()
        return flushed

    def take_ready(self) -> Optional[Batch]:
        """Drain a pending batch that already reached max_batch."""
        if self._count >= self.cfg.max_batch:
            return self._take()
        return None

    def take_if_due(self, now: Optional[float] = None) -> Optional[Batch]:
        """The pending batch if its oldest record passed the deadline."""
        if not self._items:
            return None
        now = now if now is not None else time.perf_counter()
        if (now - self._items[0].ts) * 1e3 >= self.cfg.max_wait_ms:
            return self._take()
        return None

    def take_all(self) -> Optional[Batch]:
        return self._take() if self._items else None

    def _take(self) -> Batch:
        b = Batch(self._items, self._count)
        self._items = []
        self._count = 0
        return b
