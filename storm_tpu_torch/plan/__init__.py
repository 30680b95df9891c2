"""The SLO planner, copied from ``storm_tpu/plan/``: an offline cost-model
solve and an online corrector, over what the observatory measures.

- :mod:`storm_tpu_torch.plan.model`: :class:`CostModel` reads a
  ProfileStore snapshot (the live store, or a ``PROFILE_*.json`` artifact
  wrapping one) and predicts one candidate config's per-stage latency,
  throughput and device utilization (bucket, batching deadline,
  parallelism, continuous on or off, ``pipeline_depth``,
  ``max_inflight``), with a cold shape's build cost amortized.
- :mod:`storm_tpu_torch.plan.solver`: :func:`solve` searches the
  candidates for the cheapest config meeting a target (arrival rate, p99
  SLO) and returns a :class:`Plan` that validates onto the port's
  :class:`~storm_tpu_torch.config.Config`, or a report naming the binding
  stage and the missing curves.
- :mod:`storm_tpu_torch.plan.corrector`: :class:`PlanCorrector`, stepped
  by the Observatory loop, moves only the named limiter's parallelism, one
  bounded step with hysteresis (``plan_correction`` flight events); the
  autoscaler defers its scale-up to an enabled corrector.

Surfaces: ``python -m storm_tpu_torch.main plan``, ``GET
/api/v1/topology/{name}/plan``. Config: ``[plan]``
(:class:`storm_tpu_torch.config.PlanConfig`). The curves the port solves
on are the card's when its own store recorded them; a storm_tpu
``PROFILE_*.json`` holds TPU curves.
"""

from __future__ import annotations

from storm_tpu_torch.plan.corrector import PlanCorrector
from storm_tpu_torch.plan.model import Candidate, CostModel, Target, unwrap_snapshot
from storm_tpu_torch.plan.solver import Plan, SolveResult, solve

__all__ = [
    "Candidate",
    "CostModel",
    "Plan",
    "PlanCorrector",
    "SolveResult",
    "Target",
    "solve",
    "unwrap_snapshot",
]
