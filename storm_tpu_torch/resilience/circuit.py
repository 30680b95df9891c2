"""Per-peer circuit breaker: closed -> open -> half-open -> closed, copied
from ``storm_tpu/resilience/circuit.py``.

The retry policy handles weather; the breaker handles outages. Once a
peer fails ``failures`` consecutive sends it is OPEN: callers stop
burning retry budgets (and connect timeouts) on it and instead
park or re-route. After ``reset_s`` one probe is allowed through
(HALF_OPEN); success closes the breaker, failure re-opens it for
another ``reset_s``.

Thread-safe; used from the worker event loop and (for state gauges)
metric readers on the transport's server threads.
"""

from __future__ import annotations

import threading
import time
from typing import Callable, Optional

CLOSED, OPEN, HALF_OPEN = "closed", "open", "half_open"


class CircuitBreaker:
    def __init__(self, failures: int = 5, reset_s: float = 5.0,
                 clock: Callable[[], float] = time.monotonic,
                 on_open: Optional[Callable[[], None]] = None,
                 on_close: Optional[Callable[[], None]] = None) -> None:
        self.failures = max(1, int(failures))
        self.reset_s = max(0.05, float(reset_s))
        self._clock = clock
        self._lock = threading.Lock()
        self._state = CLOSED
        self._consecutive = 0
        self._opened_at = 0.0
        self._probing = False
        self.on_open = on_open
        self.on_close = on_close
        #: lifetime open transitions (exported as a counter)
        self.opens = 0

    @property
    def state(self) -> str:
        with self._lock:
            return self._state

    def allow(self) -> bool:
        """May the caller attempt a send right now? OPEN allows exactly
        one in-flight probe once ``reset_s`` has elapsed."""
        with self._lock:
            if self._state == CLOSED:
                return True
            if self._state == OPEN:
                if self._clock() - self._opened_at >= self.reset_s:
                    self._state = HALF_OPEN
                    self._probing = True
                    return True
                return False
            # HALF_OPEN: one probe at a time
            if self._probing:
                return False
            self._probing = True
            return True

    def wait_s(self) -> float:
        """Seconds until the next probe becomes possible (0 when a send
        is already allowed)."""
        with self._lock:
            if self._state != OPEN:
                return 0.0
            return max(0.0, self.reset_s - (self._clock() - self._opened_at))

    def record_success(self) -> None:
        fire = None
        with self._lock:
            was = self._state
            self._state = CLOSED
            self._consecutive = 0
            self._probing = False
            if was != CLOSED:
                fire = self.on_close
        if fire is not None:
            try:
                fire()
            except Exception:
                pass

    def record_failure(self) -> None:
        fire = None
        with self._lock:
            self._consecutive += 1
            self._probing = False
            if self._state == HALF_OPEN or (
                    self._state == CLOSED
                    and self._consecutive >= self.failures):
                self._state = OPEN
                self._opened_at = self._clock()
                self.opens += 1
                fire = self.on_open
            elif self._state == OPEN:
                # late failure while already open: push the probe out
                self._opened_at = self._clock()
        if fire is not None:
            try:
                fire()
            except Exception:
                pass
