"""Cost profile: per-(engine, bucket) stage-cost curves, copied from
``storm_tpu/obs/profile.py``.

Every completed device batch carries its per-phase wall-clock split
(``InflightBatch.timings``: h2d, compute, d2h), and every cold bucket (its
eager forward and CUDA-graph capture) is reported once. The
:class:`ProfileStore` keys that stream by (engine, padded bucket), so the
runtime's own traffic becomes per-stage latency and throughput curves.

The engine layer exposes ``set_profile_sink`` (a module-level hook);
:func:`ensure_installed` points it at the process singleton. Recording is
one lock and a few histogram updates per batch, on the engine's fetch
thread. :meth:`ProfileStore.snapshot` round-trips through
:meth:`ProfileStore.load_baseline`, and :meth:`ProfileStore.regressions`
compares live curves with that baseline.
"""

from __future__ import annotations

import threading
from typing import Dict, List, Optional

from storm_tpu_torch.runtime.metrics import Histogram

# Stage keys tracked per (engine, bucket). device_ms is the synthetic
# whole-batch stage (sum of the split phases) so throughput math and the
# sentinel have one total-cost row even when a backend reports only some
# phases.
STAGE_KEYS = ("h2d_ms", "compute_ms", "d2h_ms", "device_ms")

# Reservoir per (engine, bucket, stage): small — a profile tracks the
# recent cost distribution, not history (the artifact snapshots it).
_RING = 512


class _Bucket:
    __slots__ = ("stages", "batches", "rows")

    def __init__(self) -> None:
        self.stages: Dict[str, Histogram] = {
            k: Histogram(_RING) for k in STAGE_KEYS}
        self.batches = 0
        self.rows = 0


class ProfileStore:
    """Per-process cost profile: ``engines[key].buckets[padded]`` curves
    plus the cold-build cost per shape (a bucket's eager forward and graph
    capture). Thread-safe (engine fetch threads write; anyone reads)."""

    def __init__(self) -> None:
        self._lock = threading.Lock()
        # engine key -> {padded: _Bucket}
        self._buckets: Dict[str, Dict[int, _Bucket]] = {}
        # engine key -> {padded: {"count": n, "sum_ms": s, "last_ms": x}}
        self._compiles: Dict[str, Dict[int, Dict[str, float]]] = {}
        self._baseline: Optional[dict] = None

    # ---- the write path (engine layer) ---------------------------------------

    def record_batch(self, key: str, padded: int, rows: int,
                     timings: Dict[str, float]) -> None:
        """One completed device batch: ``timings`` is the engine's
        per-phase dict (any subset of h2d/compute/d2h)."""
        if not timings:
            return
        with self._lock:
            per = self._buckets.setdefault(key, {})
            b = per.get(int(padded))
            if b is None:
                b = per[int(padded)] = _Bucket()
            b.batches += 1
            b.rows += int(rows)
        total = 0.0
        for stage in ("h2d_ms", "compute_ms", "d2h_ms"):
            v = timings.get(stage)
            if v is None:
                continue
            total += float(v)
            b.stages[stage].observe(float(v))
        b.stages["device_ms"].observe(total)

    def record_compile(self, key: str, padded: int, ms: float) -> None:
        with self._lock:
            per = self._compiles.setdefault(key, {})
            c = per.get(int(padded))
            if c is None:
                c = per[int(padded)] = {"count": 0, "sum_ms": 0.0,
                                        "last_ms": 0.0}
            c["count"] += 1
            c["sum_ms"] += float(ms)
            c["last_ms"] = float(ms)

    def reset(self) -> None:
        with self._lock:
            self._buckets.clear()
            self._compiles.clear()

    # ---- the read path -------------------------------------------------------

    def snapshot(self) -> dict:
        """JSON-safe curves: per engine, per padded bucket, per stage
        {count, mean, p50, p95, max} plus rows/s throughput; compile cost
        per shape. Bucket keys are stringified ints (JSON round-trip)."""
        with self._lock:
            buckets = {k: dict(v) for k, v in self._buckets.items()}
            compiles = {k: {str(n): dict(c) for n, c in v.items()}
                        for k, v in self._compiles.items()}
        engines: Dict[str, dict] = {}
        for key in sorted(set(buckets) | set(compiles)):
            rows_out: Dict[str, dict] = {}
            for padded in sorted(buckets.get(key, ())):
                b = buckets[key][padded]
                stages = {}
                for stage, h in b.stages.items():
                    s = h.snapshot()
                    if not s["count"]:
                        continue
                    stages[stage] = {
                        "count": s["count"], "mean": round(s["mean"], 4),
                        "p50": round(s["p50"], 4), "p95": round(s["p95"], 4),
                        "max": round(s["max"], 4)}
                dev = stages.get("device_ms")
                thr = (b.rows / (dev["mean"] * dev["count"] / 1e3)
                       if dev and dev["mean"] else None)
                rows_out[str(padded)] = {
                    "batches": b.batches,
                    "rows": b.rows,
                    "ms_per_row": (round(dev["mean"] / padded, 5)
                                   if dev else None),
                    "throughput_rows_s": (round(thr, 1)
                                          if thr is not None else None),
                    "stages": stages,
                }
            engines[key] = {"buckets": rows_out,
                            "compiles": compiles.get(key, {})}
        return {"engines": engines}

    def cost_of(self, key: str,
                min_samples: int = 1) -> Optional[dict]:
        """Live per-row cost summary for one engine: mean device ms per
        row at the largest profiled bucket (the marginal cost).

        Returns ``None`` when the curve can't answer; callers that need
        to know *why* (cold curve vs never-seen key) use
        :meth:`coverage`, which reports a per-(engine, bucket) status
        instead of collapsing both cases into ``None``."""
        with self._lock:
            per = self._buckets.get(key)
            if not per:
                return None
            padded = max(per)
            b = per[padded]
        s = b.stages["device_ms"].snapshot()
        if s["count"] < max(1, int(min_samples)):
            return None
        return {"bucket": padded, "batches": b.batches,
                "device_ms_mean": round(s["mean"], 4),
                "ms_per_row": round(s["mean"] / padded, 5)}

    def coverage(self, min_samples: int = 1) -> dict:
        """Which curves exist and which are trustworthy: the answer to
        ``cost_of`` returning a bare ``None``.

        Per engine, per padded bucket: ``samples`` (device-stage
        observations) and ``status`` — ``"ok"`` at or above
        ``min_samples``, ``"cold"`` below it. A key absent from the
        returned mapping entirely is *unknown* (never profiled), the
        third state ``None`` used to hide. ``compile_known`` lists the
        shapes with a recorded cold-build cost."""
        with self._lock:
            buckets = {k: dict(v) for k, v in self._buckets.items()}
            compiles = {k: sorted(v) for k, v in self._compiles.items()}
        need = max(1, int(min_samples))
        out: Dict[str, dict] = {}
        for key in sorted(set(buckets) | set(compiles)):
            rows = {}
            for padded in sorted(buckets.get(key, ())):
                n = buckets[key][padded].stages["device_ms"].snapshot()["count"]
                rows[str(padded)] = {
                    "samples": n,
                    "status": "ok" if n >= need else "cold"}
            out[key] = {"buckets": rows,
                        "compile_known": [str(p) for p in
                                          compiles.get(key, [])]}
        return out

    # ---- baseline / regression sentinel --------------------------------------

    def load_baseline(self, snap: dict) -> None:
        """Adopt an earlier :meth:`snapshot` as the baseline
        :meth:`regressions` compares with. Accepts a raw snapshot or a
        document that wraps one under its ``profile`` key."""
        if isinstance(snap, dict) and isinstance(snap.get("profile"), dict) \
                and isinstance(snap["profile"].get("engines"), dict):
            snap = snap["profile"]
        if not isinstance(snap, dict) \
                or not isinstance(snap.get("engines"), dict):
            raise ValueError("baseline must be a ProfileStore snapshot "
                             "(dict with an 'engines' mapping) or a "
                             "document wrapping one under 'profile'")
        with self._lock:
            self._baseline = snap

    @property
    def baseline(self) -> Optional[dict]:
        with self._lock:
            return self._baseline

    def regressions(self, factor: float = 1.5,
                    min_samples: int = 20) -> List[dict]:
        """Stage costs drifted beyond ``factor`` x the loaded baseline.

        Compares mean stage cost per (engine, bucket, stage) between the
        live curves and the baseline snapshot, skipping cells with fewer
        than ``min_samples`` live observations (cold curves flap). Empty
        list when no baseline is loaded or nothing drifted."""
        base = self.baseline
        if base is None:
            return []
        live = self.snapshot()["engines"]
        out: List[dict] = []
        for key, eng in base.get("engines", {}).items():
            for bucket, row in eng.get("buckets", {}).items():
                lrow = live.get(key, {}).get("buckets", {}).get(bucket)
                if lrow is None:
                    continue
                for stage, bs in row.get("stages", {}).items():
                    ls = lrow.get("stages", {}).get(stage)
                    if ls is None or ls["count"] < min_samples:
                        continue
                    b_mean = bs.get("mean") or 0.0
                    if b_mean <= 0:
                        continue
                    ratio = ls["mean"] / b_mean
                    if ratio > factor:
                        out.append({
                            "engine": key, "bucket": bucket, "stage": stage,
                            "live_ms": ls["mean"], "baseline_ms": b_mean,
                            "ratio": round(ratio, 3)})
        return out


# ---- process singleton + engine-layer wiring ---------------------------------

_STORE = ProfileStore()
_ENABLED = True


def profile_store() -> ProfileStore:
    """The process-wide store (engines are process-cached through
    ``shared_engine``, so their cost curves are process-scoped too)."""
    return _STORE


def ensure_installed() -> ProfileStore:
    """Point the engine layer's profile sink at the singleton
    (idempotent). Called from the inference operator's ``prepare``; the
    engine module is imported here, so ``obs`` imports without torch."""
    from storm_tpu_torch.infer import engine as _engine

    _engine.set_profile_sink(_STORE if _ENABLED else None)
    return _STORE


def set_enabled(flag: bool) -> None:
    """Profiling kill switch: detaches the engine sink so the hot path
    pays a single None check per batch."""
    global _ENABLED
    _ENABLED = bool(flag)
    ensure_installed()


def enabled() -> bool:
    return _ENABLED
