"""The observatory, copied from ``storm_tpu/obs/``: what the served path
costs, how fast the SLO budget burns, and which component limits it.

- :mod:`storm_tpu_torch.obs.profile`: :class:`ProfileStore`, per-(engine,
  bucket) stage-cost curves and the cold-build cost per shape, fed by the
  engine layer's profile sink;
- :mod:`storm_tpu_torch.obs.copyledger`: :class:`CopyLedger`, the bytes
  and copies of each hop of the record path;
- :mod:`storm_tpu_torch.obs.slo`: :class:`SloBurnTracker`, multi-window
  error-budget burn from the sink's ``delivered`` and ``slo_breaches``,
  an extra hot signal for the load-shed controller;
- :mod:`storm_tpu_torch.obs.capacity`: :class:`CapacityTracker` (windowed
  busy, wait and flush per executor) and :class:`EdgeLagTracker` (inbox
  depth and growth per edge, batcher ages, spout ingress lag);
- :mod:`storm_tpu_torch.obs.bottleneck`: :class:`BottleneckAttributor`,
  the ranked verdict and the critical path, with ``bottleneck_shift``
  events on a change of leader;
- :class:`Observatory` (here): the per-topology control loop. Each step
  steps the burn tracker, publishes the engines' occupancy gauges (ring
  slots, continuous-queue depth and oldest age, staging buffers), steps
  the attribution and the copy ledger's window (``copies_*`` gauges, the
  ``copy_amplification_high`` event), and on its own cadence runs the
  regression sentinel against a loaded baseline (``profile_regression``
  events).

Not ported yet: the UI routes and CLI subcommands that serve these, the
autoscaler's bottleneck signal and the plan corrector (``corrector``
stays None).
"""

from __future__ import annotations

import asyncio
import json
import logging
import sys
import time
from typing import List, Optional, Sequence

from storm_tpu_torch.obs import copyledger
from storm_tpu_torch.obs.bottleneck import BottleneckAttributor
from storm_tpu_torch.obs.capacity import (
    CapacityTracker,
    EdgeLagTracker,
    utilization_snapshot,
)
from storm_tpu_torch.obs.copyledger import CopyLedger, copy_ledger
from storm_tpu_torch.obs.profile import (
    ProfileStore,
    ensure_installed,
    profile_store,
    set_enabled,
)
from storm_tpu_torch.obs.slo import SloBurnTracker

log = logging.getLogger("storm_tpu_torch.obs")

__all__ = [
    "BottleneckAttributor",
    "CapacityTracker",
    "CopyLedger",
    "EdgeLagTracker",
    "Observatory",
    "ProfileStore",
    "SloBurnTracker",
    "copy_ledger",
    "copyledger",
    "ensure_installed",
    "profile_store",
    "set_enabled",
    "utilization_snapshot",
]


class Observatory:
    """One per topology (``runtime.obs``), with the load-shed controller's
    lifecycle: ``start()`` inside the runtime's event loop spins the step
    loop, ``await stop()`` ends it, and ``step()`` is synchronous (tests
    drive it by hand, with an injected ``clock``)."""

    def __init__(self, runtime, cfg=None,
                 sink_components: Sequence[str] = ("kafka-bolt",),
                 clock=time.monotonic) -> None:
        from storm_tpu_torch.config import ObsConfig

        self.rt = runtime
        self.cfg = cfg or ObsConfig()
        self.profile = ensure_installed()
        # The copy ledger, stepped into ``copies_*`` gauges and the
        # amplification check.
        self.ledger = copyledger.ensure_installed()
        self._amp_high = False  # copy_amplification_high de-flap latch
        self.last_copies: dict = {}  # latest windowed copy tree
        self.burn = SloBurnTracker(
            runtime.metrics,
            components=sink_components,
            objective=self.cfg.slo_objective,
            fast_window_s=self.cfg.burn_fast_window_s,
            slow_window_s=self.cfg.burn_slow_window_s,
            threshold=self.cfg.burn_threshold,
            flight=getattr(runtime, "flight", None),
            clock=clock,
        )
        self.clock = clock
        # Windowed executor utilization, edge lag watermarks and the
        # ranked verdict, stepped with the rest of the loop.
        self.capacity = CapacityTracker(runtime, clock=clock)
        self.lag = EdgeLagTracker(runtime, clock=clock)
        self.bottleneck = BottleneckAttributor(
            runtime, self.cfg, self.capacity, self.lag, clock=clock)
        self.last_regressions: List[dict] = []
        # storm_tpu's online plan corrector; the planner is not ported.
        self.corrector = None
        self._m_regress = runtime.metrics.counter("obs", "profile_regressions")
        self._last_sentinel = clock()
        self._task: Optional[asyncio.Task] = None
        if self.cfg.baseline_path:
            try:
                with open(self.cfg.baseline_path) as fh:
                    self.profile.load_baseline(json.load(fh))
                log.info("obs: loaded profile baseline %s",
                         self.cfg.baseline_path)
            except (OSError, ValueError) as e:
                log.warning("obs: cannot load baseline %s: %s",
                            self.cfg.baseline_path, e)
        runtime.obs = self

    # ---- lifecycle -----------------------------------------------------------

    def start(self) -> "Observatory":
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
            await asyncio.sleep(self.cfg.interval_s)
            try:
                self.step()
            except Exception as e:  # pragma: no cover
                log.warning("obs step failed: %s", e)

    # ---- the control step ----------------------------------------------------

    def step(self) -> None:
        self.burn.step()
        self._sample_occupancy()
        self.bottleneck.step()
        self._step_copies()
        now = self.clock()
        if now - self._last_sentinel >= self.cfg.sentinel_interval_s:
            self._last_sentinel = now
            self.sentinel_check()

    def _step_copies(self) -> None:
        """One windowed read of the copy ledger: publish per-stage
        bytes/copies-per-record gauges and the amplification ratio, trip
        the ``copy_amplification_high`` flight event past the configured
        ceiling (de-flapped: re-arms at 80% of it), and prune hops whose
        engine/component a rebalance or swap retired."""
        self.ledger.prune(copyledger.live_keys(self.rt))
        tree = self.ledger.windowed("obs")
        self.last_copies = tree
        metrics = self.rt.metrics
        for stage, row in tree["stages"].items():
            if row["bytes_per_record"] is not None:
                metrics.gauge("obs", f"copies_bytes_per_rec_{stage}").set(
                    row["bytes_per_record"])
            if row["copies_per_record"] is not None:
                metrics.gauge("obs", f"copies_per_rec_{stage}").set(
                    row["copies_per_record"])
        amp = tree.get("copy_amplification")
        metrics.gauge("obs", "copies_amplification").set(
            amp if amp is not None else 0.0)
        ceiling = float(self.cfg.copy_amp_ceiling or 0.0)
        if ceiling <= 0 or amp is None:
            return
        if amp > ceiling:
            if not self._amp_high:
                self._amp_high = True
                flight = getattr(self.rt, "flight", None)
                if flight is not None:
                    top = max(
                        tree["stages"].items(),
                        key=lambda kv: kv[1]["bytes"]
                        if kv[0] != copyledger.INGEST_STAGE else -1.0)
                    flight.event(
                        "copy_amplification_high", throttle_s=5.0,
                        amplification=amp, ceiling=ceiling,
                        top_stage=top[0],
                        top_bytes_per_record=top[1]["bytes_per_record"],
                        ingest_bytes=tree["totals"]["ingest_bytes"])
        elif amp < 0.8 * ceiling:
            self._amp_high = False

    def _sample_occupancy(self) -> None:
        for row in self.occupancy():
            key = row["engine"]
            g = self.rt.metrics.gauge
            g("obs", f"ring_inflight_{key}").set(row["ring_inflight"])
            g("obs", f"ring_capacity_{key}").set(row["ring_capacity"])
            g("obs", f"staging_in_use_{key}").set(row["staging_in_use"])
            g("obs", f"queue_depth_{key}").set(row["queue_depth"])
            g("obs", f"queue_oldest_ms_{key}").set(row["queue_oldest_ms"])

    def occupancy(self) -> List[dict]:
        """Live occupancy per process engine: pipeline-ring slots in use,
        staging-buffer utilization, and (when continuous batching is on)
        the engine's queue depth/oldest-age."""
        from storm_tpu_torch.infer.continuous import registry_stats
        from storm_tpu_torch.infer.engine import live_engines

        queues = {}
        for q in registry_stats():
            queues[q.get("engine")] = q
        rows = []
        for e in live_engines():
            key = getattr(e, "profile_key",
                          getattr(getattr(e, "model_cfg", None), "name", "?"))
            staging = (e.staging_stats()
                       if hasattr(e, "staging_stats") else {})
            q = queues.get(getattr(
                getattr(e, "model_cfg", None), "name", None), {})
            rows.append({
                "engine": key,
                "ring_inflight": int(getattr(e, "ring_inflight", 0)),
                "ring_capacity": int(getattr(e, "ring_capacity", 1)),
                "staging_in_use": int(staging.get("in_use", 0)),
                "staging_allocated": int(staging.get("allocated", 0)),
                "staging_limit": int(staging.get("limit", 0)),
                "queue_depth": int(q.get("pending_rows", 0)),
                "queue_oldest_ms": float(q.get("oldest_ms", 0.0)),
            })
        return rows

    def sentinel_check(self) -> List[dict]:
        """Compare live curves to the loaded baseline; record one
        ``profile_regression`` flight event per drifted (engine, bucket,
        stage) cell. Returns the regressions found (empty without a
        baseline)."""
        regs = self.profile.regressions(
            factor=self.cfg.regression_factor,
            min_samples=self.cfg.min_samples)
        self.last_regressions = regs
        flight = getattr(self.rt, "flight", None)
        for r in regs:
            self._m_regress.inc()
            if flight is not None:
                flight.event(
                    "profile_regression", throttle_s=5.0,
                    engine=r["engine"], bucket=r["bucket"],
                    stage=r["stage"], live_ms=r["live_ms"],
                    baseline_ms=r["baseline_ms"], ratio=r["ratio"])
        return regs

    def snapshot(self) -> dict:
        return {
            "slo": self.burn.snapshot(),
            "occupancy": self.occupancy(),
            "regressions": self.last_regressions,
            "baseline_loaded": self.profile.baseline is not None,
            "utilization": self.capacity.last,
            "bottleneck": self.last_verdict(),
            "copies": self.copies_snapshot(),
            "corrector": (self.corrector.snapshot()
                          if self.corrector is not None else None),
            "decode": self.decode_snapshot(),
        }

    def decode_snapshot(self) -> dict:
        """Decode-tier rows (sessions and KV arenas) when a decode package
        is loaded in this process, storm_tpu's empty shape otherwise. The
        port has no decode tier yet: a ``storm_tpu_torch.decode`` module
        with ``decode_stats`` fills this once it exists."""
        mod = sys.modules.get("storm_tpu_torch.decode")
        if mod is None or not hasattr(mod, "decode_stats"):
            return {"stores": [], "engines": [], "sessions_live": 0,
                    "tokens_emitted": 0}
        return mod.decode_stats()

    def copies_snapshot(self) -> dict:
        """The copy tree both ways: cumulative totals, and the loop's
        latest windowed view (empty until the second step with
        traffic)."""
        return {"cumulative": self.ledger.snapshot(),
                "window": self.last_copies,
                "amp_ceiling": float(self.cfg.copy_amp_ceiling or 0.0)}

    def last_verdict(self) -> dict:
        """The latest attribution verdict: empty until the first step with
        traffic. A reader takes the loop's view rather than sampling
        again (both would advance the same windowed cursors)."""
        return self.bottleneck.last_verdict

    def bottleneck_snapshot(self) -> dict:
        return {"utilization": self.capacity.last,
                "bottleneck": self.last_verdict(),
                "interval_s": self.cfg.interval_s}
