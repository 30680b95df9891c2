"""Offline solver: cheapest config meeting a (rate, p99 SLO) target
(copied from ``storm_tpu/plan/solver.py``).

Deterministic exhaustive search — the candidate space the cost model can
actually defend is small (profiled buckets x a handful of deadlines x
bolt parallelism x pipeline on/off x inflight depth), so the solver
enumerates it in sorted order and ranks feasible candidates by cost:

1. fewest replicas (``inference_parallelism`` — the unit the autoscaler
   pays for and the A/B artifact compares against worst-case
   provisioning);
2. no cold-compile debt before any (amortized compile cost);
3. lowest predicted p99, then highest capacity headroom.

The winner becomes a :class:`Plan` that maps ONLY onto existing knobs
(``TopologyConfig``/``BatchConfig``/``QosConfig``) and validates by
constructing those dataclasses — a plan that can't round-trip through
the config tree is a solver bug, not an operator surprise.

Infeasible targets return a report that says *why*: the binding stage of
the closest candidate (by capacity, then p99) plus the coverage table,
so "no plan" always distinguishes "the hardware can't" from "the profile
hasn't seen that shape yet" (cold/unknown — ``ProfileStore.coverage``).
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import List, Optional

from storm_tpu_torch.plan.model import Candidate, CostModel, Target
from storm_tpu_torch.runtime.autoscale import ACCEL_MAX_PARALLELISM

#: Batching deadlines (ms) always tried alongside each bucket's own
#: fill time — spans the latency-first .. throughput-first range.
DEADLINES_MS = (5.0, 10.0, 25.0, 50.0, 100.0)


@dataclass
class Plan:
    """A solved config in existing-knob terms, plus its prediction."""

    engine: str
    bucket: int
    deadline_ms: float
    parallelism: int
    continuous: bool
    pipeline_depth: int
    max_inflight: int
    eager: bool = False
    replica_cost: int = 1
    prediction: dict = field(default_factory=dict)
    target: dict = field(default_factory=dict)

    def to_overrides(self) -> dict:
        """The plan as a config patch (``Config.apply_dict`` shape). The
        batch section pins ONE bucket — a single compiled shape, no
        fragmentation, and the exact curve the prediction used."""
        return {
            "topology": {"inference_parallelism": int(self.parallelism)},
            "batch": {
                "max_batch": int(self.bucket),
                "buckets": [int(self.bucket)],
                "max_wait_ms": float(self.deadline_ms),
                "continuous": bool(self.continuous),
                "pipeline_depth": int(self.pipeline_depth),
                "max_inflight": int(self.max_inflight),
                "eager": bool(self.eager),
            },
        }

    def override_args(self) -> List[str]:
        """The same patch as ``section.key=value`` CLI overrides
        (``python -m storm_tpu_torch.main run --set ...``), ready to paste."""
        import json

        out = []
        for section, kv in sorted(self.to_overrides().items()):
            for k, v in sorted(kv.items()):
                out.append(f"{section}.{k}={json.dumps(v)}")
        return out

    def validate(self) -> bool:
        """Round-trip the plan through the real config dataclasses; their
        ``__post_init__`` validation is the contract. Raises on a plan
        that maps onto no legal config."""
        from storm_tpu_torch.config import Config

        cfg = Config()
        cfg.apply_dict(self.to_overrides())
        if cfg.batch.bucket_for(1) != int(self.bucket):
            raise ValueError(
                f"plan bucket {self.bucket} did not survive BatchConfig "
                f"normalization (got {cfg.batch.buckets})")
        return True

    def to_dict(self) -> dict:
        return {
            "engine": self.engine, "bucket": int(self.bucket),
            "deadline_ms": float(self.deadline_ms),
            "parallelism": int(self.parallelism),
            "continuous": bool(self.continuous),
            "pipeline_depth": int(self.pipeline_depth),
            "max_inflight": int(self.max_inflight),
            "eager": bool(self.eager),
            "replica_cost": int(self.replica_cost),
            "overrides": self.to_overrides(),
            "override_args": self.override_args(),
            "prediction": self.prediction,
            "target": self.target,
        }


@dataclass
class SolveResult:
    feasible: bool
    plan: Optional[Plan]
    why: Optional[str]  # infeasibility reason (binding stage named)
    binding_stage: Optional[str]
    best_infeasible: Optional[dict]  # closest candidate's prediction
    coverage: dict
    considered: int
    target: dict
    engines_ranked: List[dict] = field(default_factory=list)
    framework_risks: List[dict] = field(default_factory=list)

    def to_dict(self) -> dict:
        return {
            "feasible": self.feasible,
            "plan": self.plan.to_dict() if self.plan else None,
            "why": self.why,
            "binding_stage": self.binding_stage,
            "best_infeasible": self.best_infeasible,
            "coverage": self.coverage,
            "considered": self.considered,
            "target": self.target,
            "engines_ranked": self.engines_ranked,
            "framework_risks": self.framework_risks,
        }


def _rank_engines(model: CostModel) -> List[dict]:
    """Engines by marginal cost (ms/row at the largest trusted bucket) —
    the cascade tier-order input: cheapest first is tier 0."""
    rows = []
    for eng in model.engine_names():
        buckets = model.buckets_of(eng)
        if not buckets:
            continue
        b = buckets[-1]
        dev = model.stage_ms(eng, b, "device_ms")
        if dev is None:
            continue
        rows.append({"engine": eng, "bucket": b,
                     "ms_per_row": round(dev / b, 5),
                     "capacity_rows_s": round(b * 1e3 / dev, 1)})
    rows.sort(key=lambda r: r["ms_per_row"])
    return rows


def solve(snapshot: dict, target: Target, *, engine: Optional[str] = None,
          utilization: Optional[dict] = None,
          overhead_ms: float = 15.0, default_compile_ms: float = 500.0,
          min_samples: int = 8,
          max_parallelism: int = ACCEL_MAX_PARALLELISM) -> SolveResult:
    """Search candidates over ``snapshot`` for the cheapest feasible
    config; see module doc for the ranking. ``engine=None`` with exactly
    one profiled engine resolves to it; with several, the cheapest tier
    (ranked by ms/row) is planned and the full ranking reported."""
    model = CostModel(snapshot, overhead_ms=overhead_ms,
                      default_compile_ms=default_compile_ms,
                      min_samples=min_samples, utilization=utilization)
    coverage = model.coverage()
    ranked = _rank_engines(model)
    risks = model.framework_risks()

    if engine is None:
        if not ranked:
            return SolveResult(
                False, None,
                "no trusted curves in the profile snapshot — every "
                "(engine, bucket) cell is cold or absent; run traffic "
                "through the engine first",
                None, None, coverage, 0, target.to_dict(), ranked, risks)
        engine = ranked[0]["engine"]

    buckets = model.buckets_of(engine)
    if not buckets:
        return SolveResult(
            False, None,
            f"engine {engine!r} has no trusted curve (>= {min_samples} "
            "samples per bucket) — see coverage for cold/unknown cells",
            None, None, coverage, 0, target.to_dict(), ranked, risks)

    feasible: List[tuple] = []
    best_inf: Optional[dict] = None
    best_inf_key: Optional[tuple] = None
    considered = 0
    for bucket in buckets:
        fill_ms = min(500.0, max(1.0, bucket / target.rate_rows_s * 1e3))
        deadlines = sorted(set(DEADLINES_MS) | {round(fill_ms, 3)})
        for deadline in deadlines:
            for par in range(1, max(1, int(max_parallelism)) + 1):
                for continuous in (True, False):
                    for depth in (2, 0):
                        for inflight in (2, 1):
                            considered += 1
                            cand = Candidate(
                                engine=engine, bucket=bucket,
                                deadline_ms=deadline, parallelism=par,
                                continuous=continuous,
                                pipeline_depth=depth,
                                max_inflight=inflight)
                            pred = model.evaluate(cand, target)
                            if pred["feasible"]:
                                key = (
                                    par,
                                    pred["amortized_compile_ms_per_row"] > 0,
                                    pred["p99_ms"],
                                    -pred["capacity_rows_s"],
                                    bucket, deadline, not continuous,
                                    depth, inflight)
                                feasible.append((key, cand, pred))
                            else:
                                cap = pred.get("capacity_rows_s", 0.0) or 0.0
                                p99 = pred.get("p99_ms")
                                ikey = (-cap, p99 if p99 is not None
                                        else float("inf"))
                                if best_inf_key is None or ikey < best_inf_key:
                                    best_inf_key = ikey
                                    best_inf = pred

    if not feasible:
        why = (best_inf or {}).get("why") or (
            f"no candidate meets rate {target.rate_rows_s:.0f} rows/s at "
            f"p99 {target.slo_p99_ms:.0f} ms")
        return SolveResult(
            False, None, why, (best_inf or {}).get("binding_stage"),
            best_inf, coverage, considered, target.to_dict(), ranked, risks)

    feasible.sort(key=lambda t: t[0])
    _, cand, pred = feasible[0]
    plan = Plan(
        engine=cand.engine, bucket=cand.bucket,
        deadline_ms=cand.deadline_ms, parallelism=cand.parallelism,
        continuous=cand.continuous, pipeline_depth=cand.pipeline_depth,
        max_inflight=cand.max_inflight, eager=cand.eager,
        replica_cost=cand.parallelism, prediction=pred,
        target=target.to_dict())
    plan.validate()
    return SolveResult(True, plan, None, None, None, coverage, considered,
                       target.to_dict(), ranked, risks)
