"""The latency-driven autoscaler, copied from ``storm_tpu/runtime/autoscale.py``:
watch the sink's end-to-end latency and the operator's inbox depth, and
call the runtime's live ``rebalance``.

Policy (hysteretic, one step per interval, within [min, max]):

- scale UP one step when p50 exceeds ``high_ms``, or any inbox is more
  than half full, or the attached bottleneck attributor names this
  component the leader at or above ``capacity_hot``, for two checks;
- scale DOWN one step when p50 is under ``low_ms`` and the inboxes are
  near-empty for ``cooldown`` consecutive checks.

With a load-shed controller attached (``shedder=``) the first scale-up
waits one interval while the shed level is 0 (shed first, scale second);
with an enabled plan corrector attached (``scaler.corrector``) scale-up is
the corrector's, and a hot step records ``defer_plan``. Every decision is
an ``autoscale_decision`` flight event.

``ACCEL_MAX_PARALLELISM`` and the policy defaults are storm_tpu's, set on
its TPU (its operator's micro-batches fragment past ~3 tasks); they are
kept so that the tests can hold the port to storm_tpu, and were not tuned
on the card.
"""

from __future__ import annotations

import asyncio
import logging
from dataclasses import dataclass
from typing import Optional

log = logging.getLogger("storm_tpu_torch.autoscale")


#: Cap for bolts that front a batching accelerator: past ~2-3 tasks,
#: deadline flushes fragment micro-batches and throughput inverts
#: (storm_tpu's measurement on its TPU). CPU-bound bolts take the
#: Storm-style cap below.
ACCEL_MAX_PARALLELISM = 3

#: Storm-style cap for CPU-bound bolts, where more executors do scale.
CPU_MAX_PARALLELISM = 16


@dataclass
class AutoscalePolicy:
    component: str = "inference-bolt"
    latency_source: str = "kafka-bolt"  # component whose e2e histogram we watch
    high_ms: float = 200.0
    low_ms: float = 50.0
    min_parallelism: int = 1
    # None = by component kind: the standard inference component ids
    # ("inference-bolt", "<pipeline>-inference") take
    # ACCEL_MAX_PARALLELISM, everything else the CPU cap. An explicit
    # value is always honored.
    max_parallelism: Optional[int] = None
    interval_s: float = 5.0
    cooldown: int = 3  # consecutive calm checks before scaling down

    def __post_init__(self) -> None:
        if self.max_parallelism is None:
            accel = (self.component == "inference-bolt"
                     or self.component.endswith("-inference"))
            self.max_parallelism = (
                ACCEL_MAX_PARALLELISM if accel else CPU_MAX_PARALLELISM)


class Autoscaler:
    def __init__(self, runtime, policy: Optional[AutoscalePolicy] = None,
                 shedder=None) -> None:
        self.rt = runtime
        self.policy = policy or AutoscalePolicy()
        # Shed-first/scale-second (qos/shedding.py): with a
        # LoadShedController attached, the first scale-up is deferred until
        # the shedder has reacted (level > 0) or stayed calm through one
        # extra hot interval — cheap shedding gets a head start over
        # expensive scale-out, and a transient spike the shedder absorbs
        # never pays a rebalance at all.
        self.shedder = shedder
        # Bottleneck-aware scale-up (obs.bottleneck): attach the topology's
        # BottleneckAttributor (``scaler.bottleneck = obs.bottleneck``, same
        # idiom as ``shedder.burn = obs.burn``) and saturation of the policy
        # component becomes a third hot signal — the attributor must NAME
        # this component the current leader AND report its capacity at or
        # above the obs ``capacity_hot`` threshold. Scaling the *named*
        # bottleneck means a component pegged at capacity scales before its
        # queue backs up far enough to move p50/inbox_frac.
        self.bottleneck = None
        # Planner deferral (plan/corrector.py): with an enabled
        # PlanCorrector attached (``scaler.corrector = obs.corrector``),
        # scale-UP is the corrector's job — it moves the NAMED limiter
        # instead of this policy's fixed component — so step() only
        # records a ``defer_plan`` decision when hot. Scale-down (cost
        # reclamation) stays here; the corrector only walks back its own
        # corrections.
        self.corrector = None
        self._deferred = 0
        self._task: Optional[asyncio.Task] = None
        self._calm = 0
        self._hot = 0
        self.decisions: list = []

    def start(self) -> "Autoscaler":
        self._task = asyncio.get_running_loop().create_task(self._loop())
        return self

    async def stop(self) -> None:
        if self._task:
            self._task.cancel()
            try:
                await self._task
            except (asyncio.CancelledError, Exception):
                pass

    # ---- the control loop ----------------------------------------------------

    async def _loop(self) -> None:
        p = self.policy
        while True:
            await asyncio.sleep(p.interval_s)
            try:
                await self.step()
            except Exception as e:  # pragma: no cover
                log.warning("autoscale step failed: %s", e)

    async def step(self) -> Optional[int]:
        """One evaluation; returns the new parallelism if changed."""
        p = self.policy
        current = self.rt.parallelism_of(p.component)
        lat = self.rt.metrics.histogram(p.latency_source, "e2e_latency_ms")
        p50 = lat.percentile(50) if lat.count else None
        execs = self.rt.bolt_execs.get(p.component, [])
        inbox_frac = max(
            (e.inbox.qsize() / max(1, e.inbox.maxsize) for e in execs), default=0.0
        )

        # Third signal (when an attributor is attached): the bottleneck
        # observatory names this very component as the topology's limiter
        # and it is running hot. Read, never sampled here — the Observatory
        # loop owns the capacity cursors; step() only consumes its verdict.
        capacity = None
        cap_hot = False
        bn = self.bottleneck
        if bn is not None:
            verdict = getattr(bn, "last_verdict", None) or {}
            if verdict.get("leader") == p.component:
                for row in verdict.get("ranked", ()):
                    if row.get("component") == p.component:
                        capacity = row.get("capacity")
                        break
                cap_hot = (capacity is not None
                           and capacity >= bn.cfg.capacity_hot)

        hot = (p50 is not None and p50 > p.high_ms) or inbox_frac > 0.5 \
            or cap_hot
        calm = ((p50 is None or p50 < p.low_ms) and inbox_frac < 0.05
                and not cap_hot)

        if hot:
            self._hot += 1
            self._calm = 0
        elif calm:
            self._calm += 1
            self._hot = 0
            self._deferred = 0
        else:
            self._hot = 0
            self._calm = 0
            self._deferred = 0

        if self._hot >= 2 and current < p.max_parallelism:
            if (self.corrector is not None
                    and getattr(self.corrector, "enabled", False)):
                # Planning enabled: the corrector owns targeted scale-up.
                log.info(
                    "scale-up of %s deferred to the plan corrector",
                    p.component)
                self._flight("defer_plan", current, current, p50,
                             inbox_frac, capacity, cap_hot)
                self._hot = 0
                return None
            if (self.shedder is not None and self.shedder.level == 0
                    and self._deferred < 1):
                # Shed-first/scale-second: give the (faster) shed loop one
                # interval to absorb the spike before paying a rebalance.
                self._deferred += 1
                log.info(
                    "scale-up of %s deferred one interval (shedder level 0)",
                    p.component)
                self._flight("defer", current, current, p50, inbox_frac,
                             capacity, cap_hot)
                return None
            self._deferred = 0
            new = current + 1
            log.info(
                "scaling %s UP %d->%d (p50=%s ms, inbox=%.0f%%)",
                p.component, current, new, p50, inbox_frac * 100,
            )
            await self.rt.rebalance(p.component, new)
            self.decisions.append(("up", current, new))
            self._flight("up", current, new, p50, inbox_frac,
                         capacity, cap_hot)
            self._hot = 0
            return new
        if self._calm >= p.cooldown and current > p.min_parallelism:
            new = current - 1
            log.info("scaling %s DOWN %d->%d (p50=%s ms)", p.component, current, new, p50)
            await self.rt.rebalance(p.component, new)
            self.decisions.append(("down", current, new))
            self._flight("down", current, new, p50, inbox_frac,
                         capacity, cap_hot)
            self._calm = 0
            return new
        return None

    def _flight(self, direction: str, current: int, new: int,
                p50, inbox_frac: float, capacity=None,
                bottleneck: bool = False) -> None:
        """Flight-recorder breadcrumb: every scaling decision plus the
        signals that drove it, for post-mortems of soak/chaos runs.
        ``capacity``/``bottleneck`` record the attributor's view of the
        policy component at decision time (None/False when no attributor
        is attached), so a post-mortem can tell a latency-triggered scale
        from a capacity-triggered one."""
        flight = getattr(self.rt, "flight", None)
        if flight is not None:
            flight.event(
                "autoscale_decision", component=self.policy.component,
                direction=direction, parallelism=(current, new),
                p50_ms=round(p50, 3) if p50 is not None else None,
                inbox_frac=round(inbox_frac, 3),
                capacity=capacity, bottleneck=bool(bottleneck),
            )
