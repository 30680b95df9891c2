"""UI adapter for the distributed runtime, copied from
``storm_tpu/dist/ui.py``: serve the Storm-UI HTTP API
(:mod:`storm_tpu_torch.runtime.ui`) over a
:class:`~storm_tpu_torch.dist.DistCluster`.

The local UI server reads ``AsyncLocalCluster``/``TopologyRuntime``
directly; the dist controller is synchronous (blocking frame clients to
worker processes), so this module wraps it in duck-typed async views:

- :class:`DistRuntimeView` — looks like a ``TopologyRuntime`` to the
  routes: ``health()`` aggregates per-worker health (component rows come
  from the worker that hosts the component; in-flight trees are summed),
  ``metrics.snapshot()`` is the controller's placement-merged snapshot,
  and the lifecycle actions run the blocking controller calls off-loop.
- :class:`DistClusterView` — the ``runtimes``/``kill`` surface.

Prometheus note: worker snapshots arrive as plain JSON, so metric *kind*
is inferred from value type here (int -> counter, float -> gauge, dict ->
histogram) — unlike the in-process path, which reads kinds from the live
registry. Workers only ever serialize counters as ints and gauges as
floats, so the inference is faithful to what they sent.

Usage (wired into ``python -m storm_tpu_torch.main dist-run --ui-port N``)::

    ui = await start_dist_ui(dist, name, port)
    ...
    await ui.stop()
"""

from __future__ import annotations

import asyncio
from typing import Any, Dict, List

from storm_tpu_torch.runtime.ui import UIServer


class _Value:
    __slots__ = ("value",)

    def __init__(self, v) -> None:
        self.value = v


class _Hist:
    """Histogram facade over a worker's snapshot dict (for prometheus_text)."""

    def __init__(self, snap: Dict[str, Any]) -> None:
        self._snap = dict(snap)
        self.count = snap.get("count", 0)
        total = snap.get("sum")
        if total is None:  # older worker snapshots: reconstruct
            mean = snap.get("mean")
            total = mean * self.count if mean is not None else float("nan")
        self.sum = total
        # Worker snapshots don't carry exemplars; the renderer probes this.
        self.exemplar = None

    def snapshot(self) -> Dict[str, Any]:
        return self._snap


class DistMetrics:
    """Registry facade over the controller's merged metrics snapshot.

    One Prometheus scrape reads ``_counters``/``_gauges``/``_histograms``
    in sequence; the worker fan-out runs ONCE per scrape (short-TTL cache)
    so the three views are consistent and the RPC cost is 1x, not 3x."""

    _TTL_S = 0.5

    def __init__(self, dist) -> None:
        self._dist = dist
        self._cached = None
        self._cached_at = 0.0

    def snapshot(self) -> Dict[str, Dict[str, Any]]:
        return self._dist.metrics()

    def _split(self):
        import time

        now = time.monotonic()
        if self._cached is not None and now - self._cached_at < self._TTL_S:
            return self._cached
        counters, gauges, hists = {}, {}, {}
        for comp, vals in self.snapshot().items():
            for name, v in vals.items():
                key = (comp, name)
                if isinstance(v, dict):
                    hists[key] = _Hist(v)
                elif isinstance(v, bool):
                    gauges[key] = _Value(float(v))
                elif isinstance(v, int):
                    counters[key] = _Value(v)
                else:
                    gauges[key] = _Value(v)
        self._cached = (counters, gauges, hists)
        self._cached_at = now
        return self._cached

    @property
    def _counters(self):
        return self._split()[0]

    @property
    def _gauges(self):
        return self._split()[1]

    @property
    def _histograms(self):
        return self._split()[2]


class DistRuntimeView:
    """TopologyRuntime look-alike over a DistCluster, async at the edges."""

    def __init__(self, dist, name: str) -> None:
        self._dist = dist
        self.name = name
        self.metrics = DistMetrics(dist)
        self.errors: List = []  # worker errors surface via worker logs

    def is_active(self) -> bool:
        return self._dist.activated

    def health(self) -> Dict[str, Any]:
        per_worker = self._dist.health()
        components: Dict[str, Any] = {}
        inflight = 0
        placement = self._dist._placement
        for widx, h in per_worker.items():
            inflight += h.get("inflight_trees", 0)
            for cid, info in h.get("components", {}).items():
                # the hosting worker's row wins; proxy rows fill gaps
                if placement.get(cid) == widx or cid not in components:
                    components[cid] = info
        return {
            "topology": self.name,
            "inflight_trees": inflight,
            "workers": sorted(per_worker),
            "components": components,
        }

    async def activate(self) -> None:
        await asyncio.to_thread(self._dist.activate)

    async def deactivate(self) -> None:
        await asyncio.to_thread(self._dist.deactivate)

    async def drain(self, timeout_s: float = 30.0) -> bool:
        return await asyncio.to_thread(self._dist.drain, timeout_s)

    async def rebalance(self, component: str, parallelism: int) -> None:
        await asyncio.to_thread(self._dist.rebalance, component, parallelism)

    async def swap_model(self, component: str, overrides: dict,
                         tasks=None) -> dict:
        return await asyncio.to_thread(
            self._dist.swap_model, component, overrides, tasks)

    def component_stats(self, component: str) -> list:
        # Called via asyncio.to_thread by the UI route, so the blocking
        # worker RPC is already off-loop.
        return self._dist.component_stats(component)

    async def seek(self, component: str, position) -> int:
        return await asyncio.to_thread(self._dist.seek, component, position)

    async def profile(self, log_dir: str, seconds: float,
                      worker: int = 0) -> dict:
        return await asyncio.to_thread(
            self._dist.profile, worker, log_dir, seconds)

    async def traces(self, n: int = 20) -> Dict[str, Any]:
        return await asyncio.to_thread(self._dist.traces, n)

    async def bottleneck(self) -> Dict[str, Any]:
        """Dist flavor of the /bottleneck action: merged windowed
        utilization per component (controller cursors under the "ui"
        key, so this route's window is between ITS OWN calls, never
        stealing the bench/Observatory deltas). No cross-worker
        attributor runs controller-side — ``bottleneck`` is None and the
        per-component capacity table is the verdict."""
        out = await asyncio.to_thread(self._dist.utilization, "ui")
        return {"topology": self.name,
                "utilization": out["components"],
                "workers": out["workers"],
                "bottleneck": None}

    async def copies(self) -> Dict[str, Any]:
        """Dist flavor of the /copies action: the copy-ledger tree
        merged across workers (controller cursors under the "ui" key —
        this route's window is between its own calls, never stealing
        the bench/Observatory deltas)."""
        out = await asyncio.to_thread(self._dist.copies, "ui")
        return {"topology": self.name,
                "copies": out["merged"],
                "workers": out["workers"]}

    async def plan(self, query: dict) -> Dict[str, Any]:
        """Dist flavor of the /plan action. Engines (and their profile
        curves) live in the workers, not the controller, so the
        controller solves over a committed baseline when the operator
        points ``obs.baseline_path`` at one — but it always contributes
        what only it has: per-component utilization MERGED across
        workers, the planner's framework-headroom input."""
        util = await asyncio.to_thread(self._dist.utilization, "ui")
        out: Dict[str, Any] = {"topology": self.name,
                               "workers": util["workers"],
                               "utilization": util["components"]}
        try:
            rate = float(query.get("rate", 0) or 0)
            slo = float(query.get("slo_ms", 0) or 0)
        except ValueError:
            return {**out, "error": "rate/slo_ms must be numbers"}
        from storm_tpu_torch.obs.profile import profile_store

        snap = await asyncio.to_thread(profile_store().snapshot)
        base = profile_store().baseline
        if not snap.get("engines") and base is not None:
            snap = base  # controller-side curves come from the baseline
        if rate <= 0 or slo <= 0:
            from storm_tpu_torch.plan.model import CostModel

            out["coverage"] = CostModel(snap).coverage()
            out["note"] = ("no target given: pass ?rate=<rows/s>"
                           "&slo_ms=<ms> to solve")
            return out
        from storm_tpu_torch.plan import Target, solve

        res = await asyncio.to_thread(
            solve, snap, Target(rate, slo), engine=query.get("engine"),
            utilization=util["components"])
        out.update(res.to_dict())
        return out

    async def worker_logs(self, index: int, tail_bytes: int = 16384) -> str:
        return await asyncio.to_thread(self._dist.worker_logs, index, tail_bytes)

    async def kill(self, wait_secs: float = 0.0) -> None:
        await asyncio.to_thread(self._dist.kill, wait_secs)


class DistClusterView:
    """The ``runtimes`` surface UIServer expects, over one dist topology."""

    def __init__(self, dist, name: str) -> None:
        self._view = DistRuntimeView(dist, name)
        self._killed = False

    @property
    def runtimes(self) -> Dict[str, DistRuntimeView]:
        return {} if self._killed else {self._view.name: self._view}

    def runtime(self, name: str) -> DistRuntimeView:
        return self.runtimes[name]

    async def kill(self, name: str, wait_secs: float = 0.0) -> None:
        if self._killed or name != self._view.name:
            return
        self._killed = True
        await self._view.kill(wait_secs)


async def start_dist_ui(dist, name: str, port: int = 0,
                        host: str = "127.0.0.1",
                        auth_token: str = "") -> UIServer:
    """Serve the Storm-UI HTTP API for a running DistCluster topology."""
    return await UIServer(DistClusterView(dist, name), host=host, port=port,
                          auth_token=auth_token).start()
