"""Spout-edge admission, copied from ``storm_tpu/qos/admission.py``:
tenant/lane classification and per-tenant token buckets.

Classification rides the broker record's key (``tenant:lane``), so the
edge parses no payload. Each tenant has a token bucket of capacity
``rate * burst_s``, refilled continuously at ``rate``/s; a record is
admitted when a token is there. The tenant's configured rate is split
evenly across the spout's tasks. A record not admitted is dropped with
the cursor advanced and counted per tenant (``throttled_<tenant>``); a
lane shed at the edge by the shed level is counted as ``shed_<tenant>``.
"""

from __future__ import annotations

import time
from typing import Optional, Tuple

from storm_tpu_torch.config import QosConfig


class TokenBucket:
    """Continuous-refill token bucket (``rate``/s, capacity ``burst``)."""

    __slots__ = ("rate", "burst", "tokens", "_last")

    def __init__(self, rate: float, burst: float, now: Optional[float] = None) -> None:
        self.rate = float(rate)
        self.burst = max(1.0, float(burst))
        self.tokens = self.burst  # start full: a fresh tenant gets its burst
        self._last = now if now is not None else time.monotonic()

    def try_take(self, n: float = 1.0, now: Optional[float] = None) -> bool:
        now = now if now is not None else time.monotonic()
        # Clamped at zero: a caller's clock behind ours must not drain it.
        self.tokens = min(self.burst, self.tokens + max(0.0, now - self._last) * self.rate)
        self._last = now
        if self.tokens >= n:
            self.tokens -= n
            return True
        return False


class AdmissionController:
    """Per-spout-task admission: classify a record, then admit or drop.
    Built by ``BrokerSpout.open()`` when QoS is on; buckets start full."""

    def __init__(self, qos: QosConfig, parallelism: int = 1, metrics=None,
                 component: str = "qos") -> None:
        self.qos = qos
        self.parallelism = max(1, int(parallelism))
        self._buckets: dict = {}
        self._metrics = metrics
        self._component = component
        # The shed level the LoadShedController publishes; reading it is an
        # attribute load.
        self._shed = metrics.gauge("qos", "shed_level") if metrics is not None else None

    def classify(self, key: Optional[bytes], topic: str = "") -> Tuple[str, str]:
        """``(tenant, lane)`` of one record: key ``tenant:lane``; a missing
        piece defaults to the topic (tenant) or the default lane."""
        qos = self.qos
        if not key:
            return (topic or "default", qos.default_lane)
        text = key.decode("utf-8", "replace") if isinstance(
            key, (bytes, bytearray)) else str(key)
        tenant, sep, lane = text.partition(":")
        if not sep or lane not in qos.lanes:
            lane = qos.default_lane
        return (tenant or (topic or "default"), lane)

    def _bucket(self, tenant: str) -> Optional[TokenBucket]:
        if tenant not in self._buckets:
            rate = self.qos.rate_for(tenant)
            per_task = rate / self.parallelism
            # None: unlimited, and the miss cached.
            self._buckets[tenant] = (TokenBucket(per_task, per_task * self.qos.tenant_burst_s)
                                     if rate > 0 else None)
        return self._buckets[tenant]

    def admit(self, tenant: str, lane: str, now: Optional[float] = None) -> Tuple[bool, str]:
        """``(admitted, reason)``: ``"ok"``, ``"throttled"`` (the tenant
        is over its quota) or ``"shed"`` (the lane is dropped at the edge
        at the current shed level)."""
        m = self._metrics
        if self._shed is not None and self.qos.shed_eligible(lane, int(self._shed.value)):
            if m is not None:
                m.counter(self._component, f"shed_{tenant}").inc()
                m.counter(self._component, f"shed_lane_{lane}").inc()
            return False, "shed"
        bucket = self._bucket(tenant)
        if bucket is not None and not bucket.try_take(1.0, now):
            if m is not None:
                m.counter(self._component, f"throttled_{tenant}").inc()
                m.counter(self._component, f"throttled_lane_{lane}").inc()
            return False, "throttled"
        if m is not None:
            m.counter(self._component, f"admitted_{tenant}").inc()
            m.counter(self._component, f"admitted_lane_{lane}").inc()
        return True, "ok"
