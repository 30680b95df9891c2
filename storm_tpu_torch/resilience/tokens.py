"""Token bucket, copied from ``storm_tpu/resilience/tokens.py``: replay-storm
suppression for recovering peers.

When a worker comes back, every tree that timed out during the outage
replays at once; un-paced, the burst re-saturates the fresh worker and
can knock it straight back over. Senders route their first
post-recovery window through a bucket: ``rate`` tokens/s with a
``burst`` ceiling, so the drain is a ramp instead of a wall.

``take`` returns the wait rather than sleeping (callers are on an event
loop); ``throttle_sync`` is the blocking variant: never hold a lock
across it.
"""

from __future__ import annotations

import threading
import time
from typing import Callable


class TokenBucket:
    def __init__(self, rate: float, burst: float = 0.0,
                 clock: Callable[[], float] = time.monotonic) -> None:
        self.rate = max(0.001, float(rate))
        self.burst = max(1.0, float(burst) if burst else self.rate)
        self._clock = clock
        self._lock = threading.Lock()
        self._tokens = self.burst
        self._last = clock()
        #: pacing evidence: how many takes had to wait, and for how long
        self.waits = 0
        self.waited_s = 0.0

    def set_rate(self, rate: float) -> None:
        with self._lock:
            self.rate = max(0.001, float(rate))

    def take(self, n: float = 1.0) -> float:
        """Deduct ``n`` tokens; returns the seconds the caller must wait
        before acting on them (0.0 = go now). The debt model (tokens may
        go negative) keeps queued callers FIFO-paced instead of racing
        the refill."""
        with self._lock:
            now = self._clock()
            self._tokens = min(self.burst,
                               self._tokens + (now - self._last) * self.rate)
            self._last = now
            self._tokens -= n
            if self._tokens >= 0:
                return 0.0
            wait = -self._tokens / self.rate
            self.waits += 1
            self.waited_s += wait
            return wait

    def throttle_sync(self, n: float = 1.0) -> float:
        """Blocking take (sleeps out the wait); returns the wait served."""
        wait = self.take(n)
        if wait > 0:
            time.sleep(wait)
        return wait
