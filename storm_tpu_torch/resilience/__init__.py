"""Resilience primitives for the dist mesh, copied from
``storm_tpu/resilience``:

- :mod:`.retry`: deadline-budgeted retries with exponential backoff and
  full jitter, and the status-code classification (UNAVAILABLE retries,
  UNAUTHENTICATED fails at once) over the port's own :class:`StatusCode`;
- :mod:`.circuit`: the per-peer circuit breaker (closed -> open on
  consecutive failures, a half-open probe on a timer);
- :mod:`.tokens`: the token bucket that paces the replay drained at a
  recovered peer;
- :mod:`.chaos`: the process-wide fault injector (wire latency and drops,
  frame corruption, engine hangs), armed by ``Config.chaos`` or the
  worker's ``chaos`` control op; every injection is a ``chaos_injection``
  flight event.
"""

from storm_tpu_torch.resilience.chaos import (ChaosDrop, ChaosInjector,
                                              get_injector, install_chaos)
from storm_tpu_torch.resilience.circuit import CircuitBreaker
from storm_tpu_torch.resilience.retry import (FATAL_CODES, RETRYABLE_BROAD,
                                              RETRYABLE_NARROW, RetryPolicy,
                                              RpcError, StatusCode,
                                              is_fatal_rpc, is_retryable)
from storm_tpu_torch.resilience.tokens import TokenBucket

__all__ = [
    "CircuitBreaker",
    "ChaosDrop",
    "ChaosInjector",
    "FATAL_CODES",
    "RETRYABLE_BROAD",
    "RETRYABLE_NARROW",
    "RetryPolicy",
    "RpcError",
    "StatusCode",
    "TokenBucket",
    "get_injector",
    "install_chaos",
    "is_fatal_rpc",
    "is_retryable",
]
