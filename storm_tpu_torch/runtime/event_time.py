"""Event-time windows with watermarks, copied from
``storm_tpu/runtime/event_time.py`` (Storm's ``withTimestampField``,
``withLag`` and ``withLateTupleStream``):

- windows are aligned buckets ``[k*slide_s, k*slide_s + window_s)`` of the
  event-time axis (tumbling when ``slide_s == window_s``, the default);
- ``watermark = max(event time seen) - lag_s``; a window fires once, when
  the watermark reaches its end, with its tuples in event-time order;
- a tuple strictly behind the watermark at arrival goes to the ``late``
  stream as ``(values, event_ts)``, anchored and acked;
- a tuple is acked when its last window fires; a failing
  ``execute_window`` fails that window's tuples not yet acked;
- ``flush()`` (graceful drain) fires every remaining bucket.

Subclasses implement ``execute_window(tuples, start, end)``.
"""

from __future__ import annotations

import math
import time
from typing import Dict, List, Optional, Tuple as Tup

from storm_tpu_torch.runtime.base import Bolt
from storm_tpu_torch.runtime.tuples import Tuple, Values


class EventTimeWindowBolt(Bolt):
    def __init__(
        self,
        window_s: float,
        slide_s: Optional[float] = None,
        timestamp_field: str = "ts",
        lag_s: float = 1.0,
        idle_advance_s: float = 0.0,
    ) -> None:
        self.window_s = float(window_s)
        self.slide_s = float(slide_s or window_s)
        if not 0 < self.slide_s <= self.window_s:
            raise ValueError("need 0 < slide_s <= window_s")
        if lag_s < 0:
            raise ValueError("lag_s must be >= 0")
        self.timestamp_field = timestamp_field
        self.lag_s = float(lag_s)
        # idle_advance_s > 0: if no tuple arrives for this much PROCESSING
        # time, collapse the lag — the watermark jumps to max event time and
        # pending windows fire (an idle stream must not strand its tail
        # until drain). Needs topology.tick_interval_s > 0 to get ticks.
        self.idle_advance_s = float(idle_advance_s)
        if self.idle_advance_s > 0:
            # self-provision ticks (the executor honors this attribute, the
            # same mechanism processing-time windows use) — the knob must
            # work without separately setting topology.tick_interval_s
            self.tick_interval_s = self.idle_advance_s / 2
        self._last_arrival = None
        #: bucket INDEX k -> [(tuple, event_ts)] where the window is
        #: [k*slide_s, k*slide_s + window_s). Integer keys: float bucket
        #: starts computed by repeated addition drift (0.1 + 0.1 + ...),
        #: splitting one logical window into several that fire separately.
        self._buckets: Dict[int, List[Tup[Tuple, float]]] = {}
        #: per-tuple remaining bucket count (ack when it reaches zero)
        self._refs: Dict[int, List] = {}
        self._watermark = -math.inf
        self._max_event = -math.inf
        self._min_end = math.inf  # earliest live bucket end (fire fast path)

    def declare_output_fields(self):
        return {"default": ("message",), "late": ("values", "event_ts")}

    # ---- user surface --------------------------------------------------------

    async def execute_window(self, tuples: List[Tuple], start: float,
                             end: float) -> None:
        raise NotImplementedError

    @property
    def watermark(self) -> float:
        return self._watermark

    # ---- machinery -----------------------------------------------------------

    @staticmethod
    def _floor_div(x: float, d: float) -> int:
        """floor(x/d) with a relative epsilon: 11.7/0.1 is 116.999...994 in
        floats, and a raw floor would put a boundary timestamp in the
        previous bucket (splitting one logical window across two keys)."""
        q = x / d
        return math.floor(q + 1e-9 * max(1.0, abs(q)))

    def _bucket_indices(self, ts: float):
        """Every k with k*slide_s <= ts < k*slide_s + window_s."""
        k_max = self._floor_div(ts, self.slide_s)
        k_min = self._floor_div(ts - self.window_s, self.slide_s) + 1
        return range(k_min, k_max + 1)

    def _bucket_end(self, k: int) -> float:
        return k * self.slide_s + self.window_s

    async def execute(self, t: Tuple) -> None:
        ts = t.get(self.timestamp_field, None)
        if ts is None:
            raise ValueError(
                f"tuple from {t.source_component} lacks event-time field "
                f"{self.timestamp_field!r}")
        ts = float(ts)
        # ANY arrival counts as stream activity — a steady stream of
        # stragglers must not be mistaken for idleness (collapsing the lag
        # would misdivert on-time tuples to the late stream).
        self._last_arrival = time.monotonic()
        if ts < self._watermark:  # strict: a tie's window has NOT fired yet
            # Late: its windows already fired. Divert, never silently drop.
            await self.collector.emit(
                Values([list(t.values), ts]), stream="late", anchors=[t],
            )
            self.collector.ack(t)
            return
        entry = [t, ts, 0]  # refcount in slot 2
        for k in self._bucket_indices(ts):
            self._buckets.setdefault(k, []).append((t, ts))
            entry[2] += 1
            end = self._bucket_end(k)
            if end < self._min_end:
                self._min_end = end
        self._refs[id(t)] = entry
        if ts > self._max_event:
            self._max_event = ts
            new_wm = ts - self.lag_s
            if new_wm > self._watermark:
                self._watermark = new_wm
                await self._fire_ready()

    async def _fire_ready(self, everything: bool = False) -> None:
        if not everything and self._min_end > self._watermark:
            return  # O(1) on the hot path: nothing is ready
        for k in sorted(self._buckets):
            start = k * self.slide_s
            end = self._bucket_end(k)
            if not everything and end > self._watermark:
                break  # buckets are ordered; later ones can't be ready
            entries = self._buckets.pop(k)
            entries.sort(key=lambda e: e[1])  # event-time order
            window = [t for t, _ in entries]
            try:
                await self.execute_window(window, start, end)
            except Exception as e:
                self.collector.report_error(e)
                for t, _ in entries:
                    ref = self._refs.pop(id(t), None)
                    if ref is not None:
                        self.collector.fail(t)
                continue
            for t, _ in entries:
                ref = self._refs.get(id(t))
                if ref is None:
                    continue  # failed out of an earlier window
                ref[2] -= 1
                if ref[2] == 0:
                    del self._refs[id(t)]
                    self.collector.ack(t)
        self._min_end = (min(self._bucket_end(k) for k in self._buckets)
                         if self._buckets else math.inf)

    async def tick(self) -> None:
        """Idle advance: with no arrivals for idle_advance_s, fire every
        window up to the max event time seen (lag collapsed)."""
        if self.idle_advance_s <= 0 or self._last_arrival is None:
            return
        if time.monotonic() - self._last_arrival < self.idle_advance_s:
            return
        if self._max_event > self._watermark:
            self._watermark = self._max_event
            await self._fire_ready()

    async def flush(self) -> None:
        """Graceful drain: fire every remaining bucket (watermark ignored —
        the stream has ended, nothing later can arrive)."""
        await self._fire_ready(everything=True)

    def cleanup(self) -> None:
        self._buckets.clear()
        self._refs.clear()
