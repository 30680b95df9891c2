"""Windowed bolts, copied from ``storm_tpu/runtime/window.py``: tumbling
and sliding windows by count or processing time (Storm's
``BaseWindowedBolt``).

- count windows fire every ``slide_count`` tuples with the last
  ``window_count`` tuples;
- time windows fire every ``slide_s`` seconds (on the executor's ticks)
  with the tuples of the last ``window_s`` seconds;
- a tuple is acked when it expires, once no future window can hold it, so
  a replay after a failure covers whole windows; an exception from
  ``execute_window`` fails every buffered tuple;
- a graceful drain (``flush``) fires one final partial window.

Subclasses implement ``execute_window(tuples)`` instead of ``execute``.
"""

from __future__ import annotations

import time
from collections import deque
from typing import Deque, List, Optional, Tuple as Tup

from storm_tpu_torch.runtime.base import Bolt
from storm_tpu_torch.runtime.tuples import Tuple


class WindowedBolt(Bolt):
    def __init__(
        self,
        window_count: Optional[int] = None,
        slide_count: Optional[int] = None,
        window_s: Optional[float] = None,
        slide_s: Optional[float] = None,
    ) -> None:
        count_mode = window_count is not None
        time_mode = window_s is not None
        if count_mode == time_mode:
            raise ValueError("set exactly one of window_count / window_s")
        if count_mode:
            self.window_count = int(window_count)
            self.slide_count = int(slide_count or window_count)
            if not 1 <= self.slide_count <= self.window_count:
                raise ValueError("need 1 <= slide_count <= window_count")
        else:
            self.window_s = float(window_s)
            self.slide_s = float(slide_s or window_s)
            if not 0 < self.slide_s <= self.window_s:
                raise ValueError("need 0 < slide_s <= window_s")
            # Executor reads this attr and drives tick() at this period.
            self.tick_interval_s = self.slide_s
        self._count_mode = count_mode
        self._buf: Deque[Tup[Tuple, float]] = deque()
        self._since_fire = 0
        self._last_fire = time.monotonic()

    # ---- user surface --------------------------------------------------------

    async def execute_window(self, tuples: List[Tuple]) -> None:
        raise NotImplementedError

    # ---- machinery -----------------------------------------------------------

    async def execute(self, t: Tuple) -> None:
        self._buf.append((t, time.monotonic()))
        if self._count_mode:
            self._since_fire += 1
            if self._since_fire >= self.slide_count:
                self._since_fire = 0
                await self._fire()

    async def tick(self) -> None:
        if not self._count_mode and self._buf:
            await self._fire()

    async def _fire(self, final: bool = False) -> None:
        if self._count_mode:
            window = [t for t, _ in list(self._buf)[-self.window_count:]]
            # Expire tuples that can't reach any future window: only the
            # newest (window - slide) stay live.
            keep = 0 if final else max(0, self.window_count - self.slide_count)
        else:
            now = time.monotonic()
            # A tuple the previous fire never saw (ts > _last_fire) is
            # included even if it has aged past window_s: when a tick
            # arrives late (event-loop stall), the late window must still
            # carry the stall's tuples — excluding them would leave them
            # buffered forever, unacked, until the ledger timeout fails
            # the whole tree.
            window = [
                t for t, ts in self._buf
                if now - ts <= self.window_s or ts > self._last_fire
            ]
            keep = 0 if final else sum(
                1 for _, ts in self._buf if now - ts <= self.window_s - self.slide_s
            )
            self._last_fire = now
        if window:
            try:
                await self.execute_window(window)
            except Exception as e:
                # Fail the whole buffer: windows are the unit of replay.
                self.collector.report_error(e)
                while self._buf:
                    t, _ = self._buf.popleft()
                    self.collector.fail(t)
                self._since_fire = 0
                return
        # Trim even when this window was empty: tuples past every future
        # window must be expiry-acked regardless (every buffered tuple has
        # ridden at least one fired window by induction on the inclusion
        # rule above — an un-trimmed leftover would sit unacked until the
        # ledger timeout).
        while len(self._buf) > keep:
            t, _ = self._buf.popleft()
            self.collector.ack(t)

    async def flush(self) -> None:
        await self._fire(final=True)


class TumblingWindowBolt(WindowedBolt):
    """Every tuple in exactly one window (window == slide)."""

    def __init__(self, count: Optional[int] = None,
                 duration_s: Optional[float] = None) -> None:
        super().__init__(window_count=count, window_s=duration_s)
