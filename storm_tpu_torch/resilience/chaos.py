"""Dist-grade fault injector (chaos beyond the in-process ChaosMonkey),
copied from ``storm_tpu/resilience/chaos.py``.

One process-wide :class:`ChaosInjector` per worker/driver, armed either
from ``Config.chaos`` (which rides the submit recipe to every
worker) or live via the worker ``chaos`` control
RPC. :class:`~storm_tpu_torch.runtime.chaos.ChaosMonkey` stays the
executor-level tool; this layer reaches the surfaces it can't:

- **wire latency/jitter** and **drop** on the PeerSender send path
  (drops surface as :class:`ChaosDrop`, a ``ConnectionError`` subclass,
  so the retry/circuit stack treats them exactly like real outages);
- **frame corruption** (a bit flip mid-payload) exercising the CRC
  check in :mod:`storm_tpu_torch.dist.wire` and the replay path behind it;
- **engine hang**: the next N dispatched batches hold their results, so
  the fetch-ring watchdog (``batch.watchdog_ms``) has something real to
  catch.

Every injection emits a ``chaos_injection`` flight event (throttled per
kind) and bumps an internal counter surfaced by :meth:`snapshot`.
"""

from __future__ import annotations

import random
import threading
from typing import Any, Dict, Optional


class ChaosDrop(ConnectionError):
    """An injected wire drop — retryable, like the outage it imitates."""


_KNOBS = ("wire_latency_ms", "wire_jitter_ms", "wire_drop_pct",
          "corrupt_pct", "corrupt_next", "engine_hang_ms",
          "engine_hang_next", "controller_crash_next")


class ChaosInjector:
    def __init__(self, seed: int = 0) -> None:
        self._lock = threading.Lock()
        self._rng = random.Random(seed)
        self._flight = None
        self.wire_latency_ms = 0.0
        self.wire_jitter_ms = 0.0
        self.wire_drop_pct = 0.0
        self.corrupt_pct = 0.0
        self.corrupt_next = 0        # one-shot budget (control RPC)
        self.engine_hang_ms = 0.0
        self.engine_hang_next = 0    # one-shot budget (control RPC)
        self.controller_crash_next = 0  # one-shot budget (driver-side)
        self.counts: Dict[str, int] = {}

    # ---- arming ----------------------------------------------------------

    def configure(self, **knobs: Any) -> Dict[str, Any]:
        """Set any subset of the knobs; unknown names raise (the control
        RPC must not silently ignore a typo'd injection)."""
        with self._lock:
            for name, value in knobs.items():
                if name not in _KNOBS:
                    raise ValueError(f"unknown chaos knob {name!r}")
                cur = getattr(self, name)
                setattr(self, name,
                        type(cur)(value) if value is not None else cur)
            return {k: getattr(self, k) for k in _KNOBS}

    def bind_flight(self, flight) -> None:
        self._flight = flight

    def _event(self, target: str, **fields: Any) -> None:
        with self._lock:
            self.counts[target] = self.counts.get(target, 0) + 1
        flight = self._flight
        if flight is not None:
            try:
                flight.event("chaos_injection", target=target,
                             throttle_s=0.5, **fields)
            except Exception:
                pass

    def snapshot(self) -> Dict[str, Any]:
        with self._lock:
            out: Dict[str, Any] = {k: getattr(self, k) for k in _KNOBS}
            out["counts"] = dict(self.counts)
            return out

    # ---- wire path (PeerSender) ------------------------------------------

    def wire_delay_s(self) -> float:
        with self._lock:
            base, jit = self.wire_latency_ms, self.wire_jitter_ms
            if base <= 0 and jit <= 0:
                return 0.0
            d = (base + self._rng.uniform(0.0, jit)) / 1e3
        self._event("wire_latency", delay_ms=round(d * 1e3, 2))
        return d

    def should_drop(self) -> bool:
        with self._lock:
            drop = self.wire_drop_pct > 0 and \
                self._rng.random() < self.wire_drop_pct
        if drop:
            self._event("wire_drop")
        return drop

    def corrupt(self, payload: bytes) -> Optional[bytes]:
        """Return a bit-flipped copy of ``payload`` when corruption is
        armed (pct roll or one-shot budget), else None."""
        with self._lock:
            hit = self.corrupt_next > 0 or (
                self.corrupt_pct > 0
                and self._rng.random() < self.corrupt_pct)
            if not hit or not payload:
                return None
            if self.corrupt_next > 0:
                self.corrupt_next -= 1
            pos = self._rng.randrange(len(payload))
        bad = bytearray(payload)
        bad[pos] ^= 0x40
        self._event("frame_corruption", at=pos, nbytes=len(payload))
        return bytes(bad)

    # ---- engine path ------------------------------------------------------

    def engine_hang_s(self) -> float:
        """Hold duration for the NEXT dispatched batch (0 = no injection);
        consumes one unit of the one-shot budget per call."""
        with self._lock:
            if self.engine_hang_next <= 0 or self.engine_hang_ms <= 0:
                return 0.0
            self.engine_hang_next -= 1
            hold = self.engine_hang_ms / 1e3
        self._event("engine_hang", hold_s=round(hold, 3))
        return hold

    # ---- control plane ----------------------------------------------------

    def take_controller_crash(self) -> bool:
        """Consume one unit of the controller-crash budget. The DRIVER
        polls this — unlike the other knobs there is
        no in-band hook for the controller to crash itself, the process
        holding it has to decide to drop it."""
        with self._lock:
            if self.controller_crash_next <= 0:
                return False
            self.controller_crash_next -= 1
        self._event("controller_crash")
        return True


_INJECTOR = ChaosInjector()


def get_injector() -> ChaosInjector:
    return _INJECTOR


def install_chaos(chaos_cfg, flight=None) -> Optional[ChaosInjector]:
    """Arm the process injector from a :class:`ChaosConfig`; no-op (and
    returns None) when the section is disabled, so the hot paths keep
    their zero-knob fast exit."""
    if chaos_cfg is None or not getattr(chaos_cfg, "enabled", False):
        return None
    inj = get_injector()
    if flight is not None:
        inj.bind_flight(flight)
    inj.configure(
        wire_latency_ms=chaos_cfg.wire_latency_ms,
        wire_jitter_ms=chaos_cfg.wire_jitter_ms,
        wire_drop_pct=chaos_cfg.wire_drop_pct,
        corrupt_pct=chaos_cfg.corrupt_pct,
        engine_hang_ms=chaos_cfg.engine_hang_ms,
    )
    return inj
