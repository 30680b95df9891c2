"""Cross-caller micro-batching for the inference worker, copied from
``storm_tpu/serve/batcher.py``: concurrent ``Predict`` calls from
different callers are coalesced into one forward on the card.

Leader window: the first request into an empty window leads; it sleeps
``window_ms`` while followers queue, then runs ONE ``engine.predict`` over
the concatenated rows (in chunks of ``max_batch``, the engine's largest
bucket, when the callers bring more) and hands each caller its slice.
Followers wait on an event; an engine error reaches every caller of the
window. While the leader is on the card, the next arrival opens the next
window.

With ``continuous=True`` there is no window: each call submits its rows to
the engine's shared continuous queue
(:func:`storm_tpu_torch.infer.continuous.continuous_for`), where they
co-batch with topology traffic on the same engine.
"""

from __future__ import annotations

import threading
import time
from typing import List, Optional

import numpy as np


class _Req:
    __slots__ = ("x", "event", "out", "err")

    def __init__(self, x: np.ndarray) -> None:
        self.x = x
        self.event = threading.Event()
        self.out: Optional[np.ndarray] = None
        self.err: Optional[Exception] = None


class CrossCallerBatcher:
    def __init__(self, engine, window_ms: float = 2.0,
                 max_batch: Optional[int] = None,
                 continuous: bool = False, batch_cfg=None,
                 qos=None) -> None:
        self.engine = engine
        self.window_s = window_ms / 1000.0
        cfg = batch_cfg or getattr(engine, "batch_cfg", None)
        self.max_batch = max_batch or getattr(cfg, "max_batch", None) or 8
        self._lock = threading.Lock()
        self._pending: List[_Req] = []
        self._leader_active = False
        self.dispatches = 0  # forwards on the card (continuous: the queue's batches)
        self._cb = None
        if continuous:
            from storm_tpu_torch.infer.continuous import continuous_for

            if cfg is None:
                from storm_tpu_torch.config import BatchConfig

                cfg = BatchConfig()
            self._cb = continuous_for(engine, cfg, qos)

    def predict(self, x: np.ndarray, lane: Optional[str] = None,
                tenant: Optional[str] = None) -> np.ndarray:
        if self._cb is not None:
            # The shared queue owns the window and the coalescing (across
            # calls and topology sources); this thread waits on its slice.
            sub = self._cb.submit(x, lane=lane, tenant=tenant, source="serve")
            out = sub.future.result()
            self.dispatches = self._cb.batches
            return out
        req = _Req(x)
        with self._lock:
            self._pending.append(req)
            is_leader = not self._leader_active
            if is_leader:
                self._leader_active = True
        if is_leader:
            time.sleep(self.window_s)
            with self._lock:
                batch = self._pending
                self._pending = []
                self._leader_active = False
            self._run(batch)
        else:
            req.event.wait()
        if req.err is not None:
            raise req.err
        assert req.out is not None
        return req.out

    def _run(self, batch: List[_Req]) -> None:
        try:
            xs = np.concatenate([r.x for r in batch]) if len(batch) > 1 else batch[0].x
            outs = []
            # Callers together past the largest bucket: one forward a chunk.
            for i in range(0, xs.shape[0], self.max_batch):
                outs.append(self.engine.predict(xs[i: i + self.max_batch]))
                self.dispatches += 1
            out = np.concatenate(outs) if len(outs) > 1 else outs[0]
            off = 0
            for r in batch:
                n = r.x.shape[0]
                r.out = out[off: off + n]
                off += n
        except Exception as e:
            for r in batch:
                r.err = e
        finally:
            for r in batch:
                r.event.set()
