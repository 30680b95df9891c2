"""Online corrector: move only the named limiter's knob, one step.

InferLine's reactive half. The Autoscaler already reacts to latency and
inbox depth, but its move is GLOBAL — scale the policy component —
whether or not that component is the problem. With planning enabled the
corrector takes over the reactive role: it acts only when the SLO-burn
tracker says the budget is actually burning (``tripped``) AND the
BottleneckAttributor names a leader, and then it moves that ONE
component's parallelism by one bounded step. Hysteresis on every edge:
``hot_steps`` consecutive hot observations before a move, a
``hold_steps`` cooldown after one (watch, don't flap), and
``calm_steps`` of sustained calm before a correction is walked back.

Every decision — up, pinned-at-cap, revert — lands as a
``plan_correction`` flight event with the verdict that drove it, and the
``plan_corrections`` counter ticks for dashboards. The Autoscaler defers
its own scale-up while a corrector is attached and enabled
(``autoscale_decision`` event with direction ``defer_plan``), so the two
loops never tug the same topology in opposite directions.

Stepped by the Observatory loop (``obs.corrector``), same lifecycle as
the burn tracker and attributor; ``step()`` is async only because the
runtime's ``rebalance`` is.
"""

from __future__ import annotations

import logging
import time
from typing import List, Optional

from storm_tpu_torch.runtime.autoscale import (
    ACCEL_MAX_PARALLELISM,
    CPU_MAX_PARALLELISM,
)

log = logging.getLogger("storm_tpu_torch.plan")


class PlanCorrector:
    def __init__(self, runtime, cfg=None, attributor=None, burn=None,
                 clock=time.monotonic) -> None:
        from storm_tpu_torch.config import PlanConfig

        self.rt = runtime
        self.cfg = cfg or PlanConfig()
        #: BottleneckAttributor (names the limiter) + SloBurnTracker
        #: (says the SLO is actually burning) — attach idiom mirrors
        #: ``scaler.bottleneck`` / ``shedder.burn``.
        self.attributor = attributor
        self.burn = burn
        self.clock = clock
        self.enabled = bool(self.cfg.correct)
        #: correction ledger: (action, component, old, new) — newest last.
        self.corrections: List[tuple] = []
        # component -> outstanding correction steps (what revert undoes)
        self._moves: dict = {}
        self._hot = 0
        self._calm = 0
        self._cooldown = 0
        self._m_corr = runtime.metrics.counter("plan", "plan_corrections")
        runtime.metrics.gauge("plan", "plan_active").set(
            1 if self.enabled else 0)

    # ---- bounds --------------------------------------------------------------

    def cap_for(self, component: str) -> int:
        """One-sided bound for the limiter's knob: the measured accel
        fragmentation cap for inference bolts, the Storm-style cap for
        CPU-bound components; ``plan.max_parallelism`` overrides both."""
        if self.cfg.max_parallelism > 0:
            return int(self.cfg.max_parallelism)
        accel = (component == "inference-bolt"
                 or component.endswith("-inference"))
        return ACCEL_MAX_PARALLELISM if accel else CPU_MAX_PARALLELISM

    # ---- the control step ----------------------------------------------------

    async def step(self) -> Optional[tuple]:
        """One evaluation; returns ``(component, new_parallelism)`` when a
        knob moved (correction or revert), else None."""
        if not self.enabled:
            return None
        if self._cooldown > 0:
            self._cooldown -= 1
            return None

        verdict = getattr(self.attributor, "last_verdict", None) or {}
        leader = verdict.get("leader")
        burning = bool(getattr(self.burn, "tripped", False))
        hot = burning and leader is not None

        if hot:
            self._hot += 1
            self._calm = 0
        else:
            self._calm += 1
            self._hot = 0

        if hot and self._hot >= self.cfg.hot_steps:
            return await self._correct(leader, verdict)
        if not hot and self._calm >= self.cfg.calm_steps and self._moves:
            return await self._revert()
        return None

    async def _correct(self, component: str, verdict: dict) -> Optional[tuple]:
        self._hot = 0
        self._cooldown = self.cfg.hold_steps
        current = self.rt.parallelism_of(component)
        cap = self.cap_for(component)
        score = None
        for row in verdict.get("ranked", ()):
            if row.get("component") == component:
                score = row.get("score")
                break
        if current >= cap:
            # the named limiter is already at its bound: record the fact
            # (an operator reading the flight tail should see WHY nothing
            # moved) but never push past a measured cliff.
            log.info("plan: %s is the limiter but pinned at cap %d",
                     component, cap)
            self._flight("pinned", component, current, current, score)
            return None
        new = current + 1
        log.info("plan: correcting %s %d->%d (named limiter, burn tripped)",
                 component, current, new)
        await self.rt.rebalance(component, new)
        self._moves[component] = self._moves.get(component, 0) + 1
        self.corrections.append(("up", component, current, new))
        self._m_corr.inc()
        self._flight("up", component, current, new, score)
        return (component, new)

    async def _revert(self) -> Optional[tuple]:
        self._calm = 0
        self._cooldown = self.cfg.hold_steps
        # walk back the most recent outstanding correction first
        component = next(
            (c for _, c, _, _ in reversed(self.corrections)
             if self._moves.get(c, 0) > 0), None)
        if component is None:
            return None
        current = self.rt.parallelism_of(component)
        if current <= 1:
            self._moves.pop(component, None)
            return None
        new = current - 1
        log.info("plan: reverting correction on %s %d->%d (sustained calm)",
                 component, current, new)
        await self.rt.rebalance(component, new)
        self._moves[component] -= 1
        if self._moves[component] <= 0:
            del self._moves[component]
        self.corrections.append(("revert", component, current, new))
        self._flight("revert", component, current, new, None)
        return (component, new)

    def _flight(self, action: str, component: str, current: int, new: int,
                score) -> None:
        flight = getattr(self.rt, "flight", None)
        if flight is not None:
            flight.event(
                "plan_correction", action=action, component=component,
                parallelism=(current, new), score=score,
                burn=bool(getattr(self.burn, "tripped", False)),
            )

    def snapshot(self) -> dict:
        return {
            "enabled": self.enabled,
            "corrections": [list(c) for c in self.corrections[-20:]],
            "outstanding": dict(self._moves),
            "hot": self._hot, "calm": self._calm,
            "cooldown": self._cooldown,
        }
