"""Cost model: predict a candidate config's latency/throughput from the
profile curves (copied from ``storm_tpu/plan/model.py``).

The model is deliberately analytic and explainable — every predicted
number decomposes into terms an operator can check against the live
histograms with the same names:

- ``batch_wait_ms``: batch-formation wait. A record waits for its batch
  to fill or for the deadline, whichever ends first; with continuous
  batching all replicas feed ONE queue (fill rate = offered rate), with
  the legacy per-operator batcher the stream is split ``parallelism``
  ways and fills that much slower — the fragmentation cliff storm_tpu
  measured falls out of the model instead of being a special case.
- device stages (``h2d_ms``/``compute_ms``/``d2h_ms``/``device_ms``):
  read straight off the profiled (engine, padded bucket) curve; linear
  interpolation between profiled buckets when asked about an unprofiled
  size (flagged, never silent).
- ``queue_ms``: waiting behind in-flight batches. With the split-phase
  pipeline (``pipeline_depth`` >= 1) a batch occupies the device for its
  SLOWEST stage (stages overlap across batches); serialized, for the sum.
  M/D/1 waiting time ``rho * s / (2 (1 - rho))`` on that service time.
- compile amortization: a candidate bucket with no recorded build (eager forward and graph capture)
  is "cold" — its first dispatch pays the compile; the solver charges it
  amortized over ``horizon_s`` at the target rate so warm shapes win
  ties and a plan never hides a first-batch stall.

Everything consumes the JSON-safe :meth:`ProfileStore.snapshot` shape,
so the same model runs against the live singleton or a committed
``PROFILE_*.json`` artifact (:func:`unwrap_snapshot` mirrors
``ProfileStore.load_baseline``'s artifact handling).
"""

from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Dict, List, Optional

#: Stage names the model predicts and the runtime measures (histograms of
#: the same names on the inference component), plus the model-only
#: ``queue_ms`` term.
PREDICTED_STAGES = ("batch_wait_ms", "h2d_ms", "compute_ms", "d2h_ms",
                    "device_ms")


def unwrap_snapshot(snap: dict) -> dict:
    """Accept a raw ``ProfileStore.snapshot()`` dict or a committed
    ``PROFILE_*.json`` bench artifact wrapping one under ``profile``
    (same contract as ``ProfileStore.load_baseline``)."""
    if isinstance(snap, dict) and isinstance(snap.get("profile"), dict) \
            and isinstance(snap["profile"].get("engines"), dict):
        snap = snap["profile"]
    if not isinstance(snap, dict) or not isinstance(snap.get("engines"), dict):
        raise ValueError("need a ProfileStore snapshot (dict with an "
                         "'engines' mapping) or a PROFILE_*.json artifact "
                         "wrapping one")
    return snap


@dataclass(frozen=True)
class Target:
    """What the plan must meet: offered arrival rate and an e2e p99 SLO.

    ``headroom`` is the max device utilization a feasible candidate may
    predict (capacity planning never runs a queue at rho=1);
    ``horizon_s`` amortizes cold-shape compile cost."""

    rate_rows_s: float
    slo_p99_ms: float
    headroom: float = 0.8
    horizon_s: float = 600.0

    def to_dict(self) -> dict:
        return {"rate_rows_s": self.rate_rows_s,
                "slo_p99_ms": self.slo_p99_ms,
                "headroom": self.headroom,
                "horizon_s": self.horizon_s}


@dataclass(frozen=True)
class Candidate:
    """One point in the solver's search space, in existing-knob terms."""

    engine: str
    bucket: int
    deadline_ms: float  # BatchConfig.max_wait_ms
    parallelism: int = 1  # TopologyConfig.inference_parallelism
    continuous: bool = True  # BatchConfig.continuous
    pipeline_depth: int = 2  # BatchConfig.pipeline_depth
    max_inflight: int = 2  # BatchConfig.max_inflight
    eager: bool = False  # BatchConfig.eager


class CostModel:
    """Predict per-stage latency/throughput for candidates over one
    profile snapshot."""

    def __init__(self, snapshot: dict, *, overhead_ms: float = 15.0,
                 default_compile_ms: float = 500.0,
                 min_samples: int = 8,
                 utilization: Optional[dict] = None) -> None:
        self.engines: Dict[str, dict] = unwrap_snapshot(snapshot)["engines"]
        self.overhead_ms = float(overhead_ms)
        self.default_compile_ms = float(default_compile_ms)
        self.min_samples = max(1, int(min_samples))
        #: optional live/merged per-component utilization rows (the
        #: /bottleneck route's ``utilization`` mapping, possibly merged
        #: across dist workers) — non-device framework headroom input.
        self.utilization = utilization

    # ---- curve access --------------------------------------------------------

    def engine_names(self) -> List[str]:
        return sorted(self.engines)

    def buckets_of(self, engine: str, trusted: bool = True) -> List[int]:
        """Profiled padded buckets for ``engine``; with ``trusted``, only
        those whose device curve has >= ``min_samples`` observations."""
        eng = self.engines.get(engine, {})
        out = []
        for b, row in eng.get("buckets", {}).items():
            n = row.get("stages", {}).get("device_ms", {}).get("count", 0)
            if not trusted or n >= self.min_samples:
                out.append(int(b))
        return sorted(out)

    def coverage(self) -> dict:
        """Snapshot-side mirror of ``ProfileStore.coverage``: per engine,
        per bucket sample counts + ok/cold status, and which shapes have
        a known compile cost — what the solver reports when it has to
        skip or refuse."""
        out: Dict[str, dict] = {}
        for key in sorted(self.engines):
            eng = self.engines[key]
            rows = {}
            for b in sorted(eng.get("buckets", {}), key=int):
                n = eng["buckets"][b].get("stages", {}).get(
                    "device_ms", {}).get("count", 0)
                rows[str(b)] = {"samples": n,
                                "status": ("ok" if n >= self.min_samples
                                           else "cold")}
            out[key] = {"buckets": rows,
                        "compile_known": sorted(eng.get("compiles", {}),
                                                key=int)}
        return out

    def stage_ms(self, engine: str, bucket: int, stage: str,
                 q: str = "mean") -> Optional[float]:
        """Stage cost at a padded bucket: exact curve value when
        profiled, linear interpolation between the two nearest profiled
        buckets otherwise (extrapolation clamps to the nearest curve's
        per-row slope). None when the engine has no curve for the stage."""
        eng = self.engines.get(engine, {})
        buckets = eng.get("buckets", {})
        pts = []
        for b, row in buckets.items():
            s = row.get("stages", {}).get(stage)
            if s is not None and s.get(q) is not None:
                pts.append((int(b), float(s[q])))
        if not pts:
            return None
        pts.sort()
        b = int(bucket)
        for pb, pv in pts:
            if pb == b:
                return pv
        lo = [p for p in pts if p[0] < b]
        hi = [p for p in pts if p[0] > b]
        if lo and hi:
            (b0, v0), (b1, v1) = lo[-1], hi[0]
            return v0 + (v1 - v0) * (b - b0) / (b1 - b0)
        # extrapolate per-row from the nearest profiled point
        nb, nv = (lo[-1] if lo else hi[0])
        return nv * (b / nb)

    def is_profiled(self, engine: str, bucket: int) -> bool:
        return str(int(bucket)) in self.engines.get(
            engine, {}).get("buckets", {})

    def compile_cost(self, engine: str, bucket: int) -> dict:
        """Warm/cold verdict for one shape: warm shapes already paid
        their compile; cold ones get the engine's max recorded compile
        (or the default floor) as the estimate to amortize."""
        compiles = self.engines.get(engine, {}).get("compiles", {})
        row = compiles.get(str(int(bucket)))
        if row is not None:
            return {"cold": False, "compile_ms": float(row.get("last_ms", 0.0))}
        known = [float(c.get("last_ms", 0.0)) for c in compiles.values()]
        return {"cold": True,
                "compile_ms": max(known) if known else self.default_compile_ms}

    # ---- the prediction ------------------------------------------------------

    def evaluate(self, cand: Candidate, target: Target) -> dict:
        """Predict what ``cand`` does under ``target``'s offered rate.

        Returns a JSON-safe dict: per-stage predicted means, the
        batching/queueing decomposition, capacity + utilization,
        predicted e2e p99, feasibility, and — when infeasible — the
        binding stage and a human-readable why."""
        rate = float(target.rate_rows_s)
        if rate <= 0:
            raise ValueError("target.rate_rows_s must be > 0")
        eng = cand.engine
        bucket = int(cand.bucket)
        par = max(1, int(cand.parallelism))

        # batch formation: continuous co-batches all replicas into one
        # queue; legacy splits the stream and fills parallelism-x slower.
        fill_rate = rate if cand.continuous else rate / par
        fill_full_ms = bucket / fill_rate * 1e3
        window_ms = min(float(cand.deadline_ms), fill_full_ms)
        wait_mean_ms = window_ms / 2.0
        rows_per_batch = max(1.0, min(float(bucket),
                                      fill_rate * cand.deadline_ms / 1e3))

        stages = {}
        missing = []
        for stage in ("h2d_ms", "compute_ms", "d2h_ms", "device_ms"):
            v = self.stage_ms(eng, bucket, stage)
            if v is None:
                missing.append(stage)
            else:
                stages[stage] = v
        if "device_ms" not in stages:
            return {"candidate": self._cand_dict(cand), "feasible": False,
                    "why": (f"no profiled curve for engine {eng!r} — "
                            "missing stages: " + ", ".join(missing)),
                    "binding_stage": None, "missing_stages": missing}

        # service time: what one batch occupies the device pipeline for.
        phase = {k: stages[k] for k in ("h2d_ms", "compute_ms", "d2h_ms")
                 if k in stages}
        if cand.pipeline_depth >= 1 and phase:
            service_ms = max(phase.values())
        else:
            service_ms = stages["device_ms"]
        batches_per_s = rate / rows_per_batch
        util = batches_per_s * service_ms / 1e3
        capacity_rows_s = rows_per_batch * 1e3 / service_ms

        if util < 1.0:
            queue_mean_ms = util * service_ms / (2.0 * (1.0 - util))
        else:
            queue_mean_ms = math.inf
        device_p95 = self.stage_ms(eng, bucket, "device_ms", q="p95") \
            or stages["device_ms"] * 1.2
        p99_ms = (window_ms + 2.0 * queue_mean_ms + device_p95
                  + self.overhead_ms)

        comp = self.compile_cost(eng, bucket)
        amortized = (comp["compile_ms"] / (rate * target.horizon_s)
                     if comp["cold"] else 0.0)

        feasible = True
        why = None
        binding = None
        if util > target.headroom:
            feasible = False
            binding = max(phase or {"device_ms": stages["device_ms"]},
                          key=lambda k: (phase or stages)[k])
            why = (f"{binding} at bucket {bucket} caps capacity at "
                   f"{capacity_rows_s:.0f} rows/s; offered {rate:.0f} "
                   f"rows/s needs utilization {util:.2f} > headroom "
                   f"{target.headroom:.2f}")
        elif not math.isfinite(p99_ms) or p99_ms > target.slo_p99_ms:
            feasible = False
            terms = {"batch_wait_ms": window_ms, "queue_ms": 2 * queue_mean_ms,
                     "device_ms": device_p95}
            binding = max(terms, key=lambda k: terms[k])
            why = (f"predicted p99 {p99_ms:.0f} ms > SLO "
                   f"{target.slo_p99_ms:.0f} ms; largest term is {binding} "
                   f"({terms[binding]:.0f} ms) at bucket {bucket}, "
                   f"deadline {cand.deadline_ms:.0f} ms")

        pred_stages = {"batch_wait_ms": round(wait_mean_ms, 3)}
        for k, v in stages.items():
            pred_stages[k] = round(v, 3)
        return {
            "candidate": self._cand_dict(cand),
            "stages": pred_stages,
            "queue_ms": (round(queue_mean_ms, 3)
                         if math.isfinite(queue_mean_ms) else None),
            "service_ms": round(service_ms, 3),
            "rows_per_batch": round(rows_per_batch, 2),
            "batch_fill_frac": round(rows_per_batch / bucket, 4),
            "capacity_rows_s": round(capacity_rows_s, 1),
            "util": round(util, 4),
            "p99_ms": (round(p99_ms, 2) if math.isfinite(p99_ms) else None),
            "interpolated": not self.is_profiled(eng, bucket),
            "cold": comp["cold"],
            "compile_ms": round(comp["compile_ms"], 2),
            "amortized_compile_ms_per_row": round(amortized, 6),
            "feasible": feasible,
            "why": why,
            "binding_stage": binding,
        }

    @staticmethod
    def _cand_dict(cand: Candidate) -> dict:
        return {"engine": cand.engine, "bucket": int(cand.bucket),
                "deadline_ms": float(cand.deadline_ms),
                "parallelism": int(cand.parallelism),
                "continuous": bool(cand.continuous),
                "pipeline_depth": int(cand.pipeline_depth),
                "max_inflight": int(cand.max_inflight),
                "eager": bool(cand.eager)}

    # ---- framework (non-device) input ----------------------------------------

    def framework_risks(self, hot: float = 0.8) -> List[dict]:
        """Components the measured utilization says are near capacity —
        the planner's non-device input. Accepts the /bottleneck route's
        ``utilization`` mapping, including the dist controller's view
        merged across workers; a plan can be device-feasible and still
        fail on a hot resize bolt, so these surface as risks with the
        knob the corrector would move."""
        rows = []
        for comp, row in sorted((self.utilization or {}).items()):
            cap = row.get("capacity")
            if cap is None or cap < hot:
                continue
            rows.append({"component": comp, "capacity": round(cap, 4),
                         "knob": "parallelism",
                         "note": (f"{comp} at {cap:.0%} of the measured "
                                  "window — plan headroom depends on "
                                  "scaling it, not the device")})
        return rows
