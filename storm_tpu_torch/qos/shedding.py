"""Adaptive load shedding, copied from ``storm_tpu/qos/shedding.py``: a
hysteresis controller that rejects best-effort traffic while the topology
is overloaded.

Signals, read from the topology's metrics registry and its executors:

- the **inbox occupancy** of the inference component (records queued over
  the inbox's capacity, the fullest task);
- the **batch-wait p95** of the inference component (``batch_wait_ms``);
- the **SLO-breach rate**: the sink's ``slo_breaches`` counter, per second
  of interval.

``hot_steps`` consecutive intervals with any signal above its threshold
raise the shed level by one; ``calm_steps`` consecutive intervals with
every signal below half its threshold lower it. The level is published as
the gauge ``("qos", "shed_level")``, which the spout's admission and the
inference operator read. Each change is kept in ``decisions``. The
observatory's burn-rate signal (``burn``) and the flight recorder's
events are not ported: ``burn`` stays None, and the runtime has no
``flight``.
"""

from __future__ import annotations

import asyncio
import logging
from dataclasses import dataclass
from typing import Optional

from storm_tpu_torch.config import QosConfig

log = logging.getLogger("storm_tpu_torch.qos")


@dataclass
class ShedPolicy:
    """The control loop's wiring and thresholds (defaults as QosConfig's)."""

    component: str = "inference-bolt"   # whose inbox and batch wait to watch
    latency_source: str = "kafka-bolt"  # whose slo_breaches counter to watch
    interval_s: float = 1.0
    inbox_frac: float = 0.5    # hot above this inbox occupancy
    wait_ms: float = 0.0       # hot above this batch_wait p95 (0 = off)
    breach_rate: float = 1.0   # hot above this many sink breaches a second
    hot_steps: int = 2
    calm_steps: int = 5
    max_level: int = 2         # usually len(qos.lanes) - 1

    @classmethod
    def from_qos(cls, qos: QosConfig, component: str = "inference-bolt",
                 latency_source: str = "kafka-bolt") -> "ShedPolicy":
        return cls(component=component, latency_source=latency_source,
                   interval_s=qos.shed_interval_s, inbox_frac=qos.shed_inbox_frac,
                   wait_ms=qos.shed_wait_ms, breach_rate=qos.shed_breach_rate,
                   hot_steps=qos.shed_hot_steps, calm_steps=qos.shed_calm_steps,
                   max_level=qos.max_shed_level)


class LoadShedController:
    """``LoadShedController(runtime, policy).start()`` inside the
    runtime's event loop; ``await stop()`` before the topology is killed.
    It hangs itself on ``runtime.qos``."""

    def __init__(self, runtime, policy: Optional[ShedPolicy] = None) -> None:
        self.rt = runtime
        self.policy = policy or ShedPolicy()
        self.level = 0
        self.decisions: list = []  # ("shed" | "restore", old, new) per change
        self._task: Optional[asyncio.Task] = None
        self._hot = 0
        self._calm = 0
        self._prev_breaches: Optional[int] = None
        self._gauge = runtime.metrics.gauge("qos", "shed_level")
        self._gauge.set(0.0)
        # The observatory's SLO burn-rate tracker, an extra hot signal when
        # attached (not ported yet).
        self.burn = None
        runtime.qos = self

    def start(self) -> "LoadShedController":
        self._task = asyncio.get_running_loop().create_task(self._loop())
        return self

    async def stop(self) -> None:
        if self._task:
            self._task.cancel()
            try:
                await self._task
            except (asyncio.CancelledError, Exception):
                pass

    async def _loop(self) -> None:
        while True:
            await asyncio.sleep(self.policy.interval_s)
            try:
                self.step()
            except Exception as e:  # pragma: no cover
                log.warning("shed step failed: %s", e)

    def _signals(self) -> dict:
        p = self.policy
        execs = self.rt.bolt_execs.get(p.component, [])
        inbox_frac = max((self._inbox_rows(e.inbox) / max(1, e.inbox.maxsize)
                          for e in execs), default=0.0)
        wait = self.rt.metrics.histogram(p.component, "batch_wait_ms")
        wait_p95 = wait.percentile(95) if wait.count else 0.0
        breaches = self.rt.metrics.counter(p.latency_source, "slo_breaches").value
        delta = 0 if self._prev_breaches is None else max(0, breaches - self._prev_breaches)
        self._prev_breaches = breaches
        burn = self.burn
        return {
            "inbox_frac": inbox_frac,
            "wait_p95_ms": wait_p95,
            "breach_rate": delta / p.interval_s,
            "burn_rate": burn.fast_burn if burn is not None else 0.0,
            "burn_tripped": burn.tripped if burn is not None else False,
        }

    @staticmethod
    def _inbox_rows(inbox) -> int:
        """Queued records, not queued tuples: a tuple whose message is a
        list of records counts each. Reads the asyncio queue's deque on
        the event loop's thread."""
        rows = 0
        for item in getattr(inbox, "_queue", ()):
            payload = item.values[0] if getattr(item, "values", None) else None
            rows += len(payload) if isinstance(payload, (list, tuple)) else 1
        return rows

    def step(self) -> Optional[int]:
        """One evaluation; returns the new shed level if it changed."""
        p = self.policy
        s = self._signals()
        hot = (s["inbox_frac"] > p.inbox_frac
               or (p.wait_ms > 0 and s["wait_p95_ms"] > p.wait_ms)
               or s["breach_rate"] > p.breach_rate
               or s["burn_tripped"])
        calm = (s["inbox_frac"] < p.inbox_frac / 2
                and (p.wait_ms <= 0 or s["wait_p95_ms"] < p.wait_ms / 2)
                and s["breach_rate"] < p.breach_rate / 2
                and not s["burn_tripped"])
        if hot:
            self._hot += 1
            self._calm = 0
        elif calm:
            self._calm += 1
            self._hot = 0
        else:
            self._hot = 0
            self._calm = 0
        if self._hot >= p.hot_steps and self.level < p.max_level:
            return self._set_level(self.level + 1, "shed", s)
        if self._calm >= p.calm_steps and self.level > 0:
            return self._set_level(self.level - 1, "restore", s)
        return None

    def _set_level(self, new: int, direction: str, signals: dict) -> int:
        old = self.level
        self.level = new
        self._gauge.set(float(new))
        self._hot = 0
        self._calm = 0
        self.decisions.append((direction, old, new))
        self.rt.metrics.counter("qos", "shed_decisions").inc()
        log.info("shed level %d->%d (%s): inbox=%.0f%% wait_p95=%.1fms breaches/s=%.1f",
                 old, new, direction, signals["inbox_frac"] * 100,
                 signals["wait_p95_ms"], signals["breach_rate"])
        return new
