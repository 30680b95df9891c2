"""Deadline-budgeted retry with exponential backoff and full jitter, copied
from ``storm_tpu/resilience/retry.py``, with the transport's own status
codes in place of gRPC's.

The port's dist RPCs run over the standard library's sockets
(:mod:`storm_tpu_torch.dist.transport`), so a failed call raises an
:class:`RpcError` carrying a :class:`StatusCode` of this module. The codes
keep gRPC's names and numbers, so the classification reads as storm_tpu's:

- ``RETRYABLE_BROAD``: safe for idempotent-or-reconcilable ops (Control,
  Ack): UNAVAILABLE, DEADLINE_EXCEEDED, RESOURCE_EXHAUSTED, ABORTED. An
  Ack batch applied twice can only toggle XOR parity back: the tree then
  times out and replays, it never completes falsely.
- ``RETRYABLE_NARROW``: Deliver only, UNAVAILABLE alone. The transport
  raises UNAVAILABLE only when the request never reached the server
  (refused connection, or a failure before its first byte was written),
  so a resend cannot enqueue twice; a call that timed out or lost its
  connection after the request left may have been enqueued, and is left
  to the ledger's timeout replay.
- ``FATAL_CODES``: UNAUTHENTICATED, PERMISSION_DENIED, INVALID_ARGUMENT,
  UNIMPLEMENTED, FAILED_PRECONDITION: retrying cannot help, so the caller
  sees the error at once.

``ConnectionError``/``OSError`` count as retryable; any other exception
type is a bug in the caller and propagates on the first attempt.
"""

from __future__ import annotations

import enum
import random
import time
from dataclasses import dataclass, field
from typing import Any, Callable, FrozenSet, Optional


class StatusCode(enum.Enum):
    """RPC status codes, gRPC's names and numbers."""

    OK = 0
    CANCELLED = 1
    UNKNOWN = 2
    INVALID_ARGUMENT = 3
    DEADLINE_EXCEEDED = 4
    NOT_FOUND = 5
    ALREADY_EXISTS = 6
    PERMISSION_DENIED = 7
    RESOURCE_EXHAUSTED = 8
    FAILED_PRECONDITION = 9
    ABORTED = 10
    OUT_OF_RANGE = 11
    UNIMPLEMENTED = 12
    INTERNAL = 13
    UNAVAILABLE = 14
    DATA_LOSS = 15
    UNAUTHENTICATED = 16


class RpcError(Exception):
    """A failed RPC: ``code()`` and ``details()`` as on a gRPC error."""

    def __init__(self, code: StatusCode, details: str = "") -> None:
        super().__init__(f"{code.name}: {details}")
        self._code = code
        self._details = details

    def code(self) -> StatusCode:
        return self._code

    def details(self) -> str:
        return self._details


RETRYABLE_BROAD: FrozenSet[StatusCode] = frozenset({
    StatusCode.UNAVAILABLE,
    StatusCode.DEADLINE_EXCEEDED,
    StatusCode.RESOURCE_EXHAUSTED,
    StatusCode.ABORTED,
})

#: Deliver may only be sent again when the request never reached the
#: server; UNAVAILABLE is the one code that guarantees that.
RETRYABLE_NARROW: FrozenSet[StatusCode] = frozenset({
    StatusCode.UNAVAILABLE,
})

FATAL_CODES: FrozenSet[StatusCode] = frozenset({
    StatusCode.UNAUTHENTICATED,
    StatusCode.PERMISSION_DENIED,
    StatusCode.INVALID_ARGUMENT,
    StatusCode.UNIMPLEMENTED,
    StatusCode.FAILED_PRECONDITION,
})


def _rpc_code(exc: BaseException) -> Optional[StatusCode]:
    if not isinstance(exc, RpcError):
        return None
    return exc.code()


def is_fatal_rpc(exc: BaseException) -> bool:
    """True when the RPC failed for a reason retrying cannot fix
    (auth, malformed request, unimplemented method)."""
    return _rpc_code(exc) in FATAL_CODES


def is_retryable(exc: BaseException,
                 codes: FrozenSet[StatusCode] = RETRYABLE_BROAD) -> bool:
    code = _rpc_code(exc)
    if code is not None:
        return code in codes
    # Plain sockets (broker adapters): connection weather retries;
    # anything else is a programming error and must surface at once.
    return isinstance(exc, (ConnectionError, OSError))


@dataclass
class RetryPolicy:
    """Exponential backoff and full jitter under a total deadline.

    ``attempts`` bounds the count, ``deadline_s`` the wall clock across
    all attempts and their sleeps; whichever runs out first ends the loop
    with the last exception. Full jitter (``uniform(0, min(cap, base *
    2^n))``) decorrelates many senders hammering one recovering peer.
    """

    attempts: int = 4
    base_s: float = 0.05
    cap_s: float = 2.0
    deadline_s: float = 30.0
    _rng: random.Random = field(default_factory=random.Random, repr=False)

    def backoff(self, attempt: int) -> float:
        return self._rng.uniform(0.0, min(self.cap_s,
                                          self.base_s * (2 ** attempt)))

    def _plan(self, op_timeout: Optional[float]) -> float:
        budget = self.deadline_s
        if op_timeout is not None:
            budget = min(budget, max(op_timeout, 0.001))
        return time.monotonic() + budget

    def _next_delay(self, attempt: int, exc: BaseException,
                    deadline: float,
                    codes: FrozenSet[StatusCode],
                    on_retry) -> float:
        """The jittered sleep before attempt ``attempt`` + 1, or ``exc``
        raised again when out of budget or attempts, or not retryable."""
        remaining = deadline - time.monotonic()
        if (attempt >= self.attempts - 1 or remaining <= 0
                or not is_retryable(exc, codes)):
            raise exc
        if on_retry is not None:
            try:
                on_retry(attempt, exc)
            except Exception:
                pass
        return min(self.backoff(attempt), max(remaining, 0.0))

    def call_sync(self, fn: Callable[[Optional[float]], Any], *,
                  op_timeout: Optional[float] = None,
                  codes: FrozenSet[StatusCode] = RETRYABLE_BROAD,
                  on_retry: Optional[Callable[[int, BaseException],
                                              None]] = None) -> Any:
        """Blocking variant (sleeps with ``time.sleep``: never call it
        under a lock). ``fn`` gets the attempt's timeout: the remaining
        deadline, further capped by ``op_timeout``."""
        deadline = self._plan(op_timeout)
        attempt = 0
        while True:
            remaining = max(deadline - time.monotonic(), 0.001)
            t = remaining if op_timeout is None else min(op_timeout, remaining)
            try:
                return fn(t)
            except Exception as e:
                delay = self._next_delay(attempt, e, deadline, codes,
                                         on_retry)
            time.sleep(delay)
            attempt += 1

    async def call_async(self, fn: Callable[[Optional[float]], Any], *,
                         op_timeout: Optional[float] = None,
                         codes: FrozenSet[StatusCode] = RETRYABLE_BROAD,
                         on_retry: Optional[Callable[[int, BaseException],
                                                     None]] = None) -> Any:
        """Event-loop variant: ``fn`` (a blocking callable taking the
        attempt's timeout) runs on a worker thread; the backoff sleeps are
        ``asyncio.sleep``, so the loop keeps serving other peers."""
        import asyncio

        deadline = self._plan(op_timeout)
        attempt = 0
        while True:
            remaining = max(deadline - time.monotonic(), 0.001)
            t = remaining if op_timeout is None else min(op_timeout, remaining)
            try:
                return await asyncio.to_thread(fn, t)
            except Exception as e:
                delay = self._next_delay(attempt, e, deadline, codes,
                                         on_retry)
            await asyncio.sleep(delay)
            attempt += 1
