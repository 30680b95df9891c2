"""The in-process cluster, copied from ``storm_tpu/runtime/cluster.py``
without rebalance, seek, supervision and metrics consumers: routing,
lifecycle, graceful drain, the at-least-once timeout sweep, the live
model swap with canary (``swap_model``) and the per-task stats
(``component_stats``). A runtime's ``bolt_execs`` (each task's bounded
inbox) and ``metrics`` are what the load-shed controller reads; it hangs
itself on ``runtime.qos``. The observatory reads the executors' busy and
wait seconds and the routing table (``Router.edges``), and hangs itself
on ``runtime.obs``. Each runtime builds its :class:`Tracer` and
:class:`FlightRecorder` from ``config.tracing``; every task's context
carries them.

:class:`AsyncLocalCluster` runs inside an event loop; :class:`LocalCluster`
is its synchronous facade with its own loop thread (Storm's
``LocalCluster``).
"""

from __future__ import annotations

import asyncio
import dataclasses
import logging
import threading
import time
from typing import Any, Dict, List, Optional, Tuple as Tup

from storm_tpu_torch.config import Config, TracingConfig
from storm_tpu_torch.runtime.acker import AckLedger
from storm_tpu_torch.runtime.executor import BoltExecutor, SpoutExecutor, clone_component
from storm_tpu_torch.runtime.metrics import MetricsRegistry
from storm_tpu_torch.runtime.topology import Topology
from storm_tpu_torch.runtime.tracing import FlightRecorder, Tracer

log = logging.getLogger("storm_tpu_torch.cluster")


class TargetGroup:
    """The inboxes of one downstream component."""

    def __init__(self, component_id: str) -> None:
        self.component_id = component_id
        self.inboxes: List[asyncio.Queue] = []


class Router:
    def __init__(self) -> None:
        self._subs: Dict[Tup[str, str], List[Tup[Any, TargetGroup]]] = {}

    def add(self, source: str, stream: str, grouping: Any, group: TargetGroup) -> None:
        grouping.prepare(len(group.inboxes))
        self._subs.setdefault((source, stream), []).append((grouping, group))

    def subscriptions(self, source: str, stream: str) -> List[Tup[Any, TargetGroup]]:
        return self._subs.get((source, stream), [])

    def edges(self):
        """``(source, stream, TargetGroup)`` rows, one per subscription:
        the observatory's read-only view of the routing table (its
        ``EdgeLagTracker`` reads each target's inboxes). Two groupings on
        one edge give two rows; consumers dedupe."""
        for (source, stream), subs in list(self._subs.items()):
            for _grouping, group in subs:
                yield source, stream, group


class TopologyRuntime:
    """Everything live for one submitted topology."""

    def __init__(self, name: str, topology: Topology, config: Config) -> None:
        self.name = name
        self.topology = topology
        self.config = config
        self.metrics = MetricsRegistry()
        tr = getattr(config, "tracing", None) or TracingConfig()
        self.tracer = Tracer(sample_rate=tr.sample_rate, store_capacity=tr.store_capacity)
        self.flight = FlightRecorder(path=tr.flight_path, capacity=tr.flight_capacity,
                                     max_bytes=tr.flight_max_bytes,
                                     max_files=tr.flight_max_files)
        self.ledger = AckLedger(timeout_s=config.topology.message_timeout_s)
        self.router = Router()
        self.bolt_execs: Dict[str, List[BoltExecutor]] = {}
        self.spout_execs: Dict[str, List[SpoutExecutor]] = {}
        self.errors: List[Tup[str, int, BaseException]] = []
        self._sweeper: Optional[asyncio.Task] = None
        # The topology's LoadShedController and Observatory, once attached.
        self.qos = None
        self.obs = None

    def _make_executors(self) -> None:
        tcfg = self.config.topology
        groups: Dict[str, TargetGroup] = {}
        for spec in self.topology.specs.values():
            group = groups[spec.component_id] = TargetGroup(spec.component_id)
            if spec.is_spout:
                self.spout_execs[spec.component_id] = [
                    SpoutExecutor(self, spec.component_id, i,
                                  clone_component(spec.obj),
                                  tcfg.max_spout_pending)
                    for i in range(spec.parallelism)]
            else:
                execs = self.bolt_execs[spec.component_id] = [
                    BoltExecutor(self, spec.component_id, i,
                                 clone_component(spec.obj), tcfg.inbox_capacity)
                    for i in range(spec.parallelism)]
                group.inboxes = [e.inbox for e in execs]
        for spec in self.topology.specs.values():
            for sub in spec.inputs:
                self.router.add(sub.source, sub.stream, sub.grouping,
                                groups[spec.component_id])

    async def start(self) -> None:
        self._make_executors()
        # Bolts first (downstream ready before data flows), then spouts.
        for execs in self.bolt_execs.values():
            for e in execs:
                e.start()
        for execs in self.spout_execs.values():
            for e in execs:
                e.start()
        self._sweeper = asyncio.create_task(self._sweep_loop())

    async def _sweep_loop(self) -> None:
        interval = max(0.25, min(1.0, self.config.topology.message_timeout_s / 4))
        while True:
            await asyncio.sleep(interval)
            n = self.ledger.sweep()
            if n:
                log.warning("%s: %d tuple trees timed out", self.name, n)
                self.flight.event("tree_timeout", topology=self.name, trees=n)
            for cid, execs in self.bolt_execs.items():
                self.metrics.gauge(cid, "inbox_depth").set(
                    sum(e.inbox.qsize() for e in execs))

    # ---- runtime services (used by collectors/executors) ---------------------

    def parallelism_of(self, component_id: str) -> int:
        return self.topology.specs[component_id].parallelism

    def spout_done_cb(self, component_id: str, task_index: int):
        ex = self.spout_execs[component_id][task_index]
        ex.track()
        return ex.on_done

    def spout_done(self, component_id: str, task_index: int, msg_id, ok: bool) -> None:
        """Completion for roots that never entered the ledger (emit with
        no subscribers)."""
        ex = self.spout_execs[component_id][task_index]
        self.metrics.counter(component_id, "tree_acked" if ok else "tree_failed").inc()
        (ex.spout.ack if ok else ex.spout.fail)(msg_id)

    def report_error(self, component_id: str, task_index: int, err: BaseException) -> None:
        self.errors.append((component_id, task_index, err))
        self.metrics.counter(component_id, "errors").inc()
        log.error("error in %s[%d]: %r", component_id, task_index, err, exc_info=err)

    # ---- lifecycle -----------------------------------------------------------

    async def deactivate(self) -> None:
        """Stop spouts pulling; in-flight tuples keep flowing."""
        for execs in self.spout_execs.values():
            for e in execs:
                e._active = False

    async def drain(self, timeout_s: float = 30.0) -> bool:
        """Wait for all in-flight tuple trees and inboxes to empty."""
        deadline = time.monotonic() + timeout_s
        while time.monotonic() < deadline:
            busy = self.ledger.inflight > 0 or any(
                not e.inbox.empty()
                for execs in self.bolt_execs.values() for e in execs)
            if not busy:
                return True
            await asyncio.sleep(0.01)
        return False

    async def kill(self, wait_secs: float = 0.0) -> None:
        """Kill the topology; ``wait_secs`` > 0 deactivates and drains
        first (Storm's KillOptions)."""
        if wait_secs > 0:
            await self.deactivate()
            await self.drain(timeout_s=wait_secs)
        if self._sweeper:
            self._sweeper.cancel()
        for execs in self.spout_execs.values():
            for e in execs:
                await e.stop()
        for execs in self.bolt_execs.values():
            for e in execs:
                await e.stop(drain=wait_secs > 0)
        self.flight.close()

    # ---- live model swap -----------------------------------------------------

    async def swap_model(self, component_id: str, overrides: dict,
                         tasks: Optional[list] = None):
        """Roll the inference component's tasks onto a new model under
        traffic: ``overrides`` (e.g. ``{"checkpoint": "checkpoints/v2"}``)
        apply to the prototype's ModelConfig. Returns the new config.

        ``tasks=[i, ...]`` swaps only those tasks, a canary: compare their
        ``component_stats`` rows (the per-task ``model`` descriptor, the
        execute time, the errors) with the rest, then swap the rest or
        swap the canary back. A canary leaves the prototype as it was."""
        execs = self.bolt_execs.get(component_id)
        if execs is None:
            raise KeyError(component_id)
        swappable = [e for e in execs if hasattr(e.bolt, "swap_model")]
        if not swappable:
            raise TypeError(f"component {component_id!r} has no model to swap")
        # Based on the prototype, not a task: after a canary the tasks'
        # configs differ, and a task's would carry its fields into every
        # later swap.
        proto = self.topology.specs[component_id].obj
        base = proto.model_cfg if hasattr(proto, "model_cfg") else swappable[0].bolt.model_cfg
        new_cfg = dataclasses.replace(base, **overrides)
        if tasks is not None:
            if not tasks:
                raise ValueError("tasks must be a non-empty list")
            chosen = [e for e in swappable if e.task_index in set(tasks)]
            missing = set(tasks) - {e.task_index for e in chosen}
            if missing:
                raise KeyError(f"no swappable task(s) {sorted(missing)} in {component_id!r}")
            for e in chosen:
                await e.bolt.swap_model(new_cfg)
            return new_cfg
        if hasattr(proto, "model_cfg"):
            proto.model_cfg = new_cfg
        # The first swap builds and warms the engine (shared per process);
        # the others take it from the cache.
        for e in swappable:
            if e.bolt.model_cfg is not new_cfg:
                await e.bolt.swap_model(new_cfg)
        return new_cfg

    def component_stats(self, component_id: str) -> list:
        """Per-task stats of one component: for a bolt the executed count,
        mean execute ms, errors, inbox depth and the model descriptor
        (``name[:checkpoint][:seed=N][:weights]``, as storm_tpu spells it);
        for a spout the acked and failed trees, errors and in-flight
        roots."""
        if component_id in self.bolt_execs:
            def model_of(e):
                cfg = getattr(e.bolt, "model_cfg", None)
                if cfg is None:
                    return None
                parts = [cfg.name]
                if cfg.checkpoint:
                    parts.append(cfg.checkpoint)
                if cfg.seed:
                    parts.append(f"seed={cfg.seed}")
                if getattr(cfg, "weights", "float") != "float":
                    parts.append(cfg.weights)
                return ":".join(parts)

            return [
                {"task": e.task_index, "executed": e.n_executed,
                 "avg_execute_ms": round(e.exec_ms_total / e.n_executed, 3)
                 if e.n_executed else None,
                 "errors": e.n_errors, "inbox_depth": e.inbox.qsize(),
                 **({"model": m} if (m := model_of(e)) else {})}
                for e in self.bolt_execs[component_id]]
        if component_id in self.spout_execs:
            return [{"task": e.task_index, "acked": e.n_acked, "failed": e.n_failed,
                     "errors": e.n_errors, "inflight": e.inflight}
                    for e in self.spout_execs[component_id]]
        raise KeyError(component_id)


class AsyncLocalCluster:
    """Async-native cluster API (use inside an event loop)."""

    def __init__(self) -> None:
        self._topologies: Dict[str, TopologyRuntime] = {}

    async def submit(self, name: str, config: Config, topology: Topology) -> TopologyRuntime:
        if name in self._topologies:
            raise ValueError(f"topology {name!r} already running")
        topology.validate()
        rt = TopologyRuntime(name, topology, config)
        self._topologies[name] = rt
        await rt.start()
        return rt

    def runtime(self, name: str) -> TopologyRuntime:
        return self._topologies[name]

    async def kill(self, name: str, wait_secs: float = 0.0) -> None:
        rt = self._topologies.pop(name, None)
        if rt is not None:
            await rt.kill(wait_secs)

    async def shutdown(self) -> None:
        for name in list(self._topologies):
            await self.kill(name, wait_secs=0.0)


class LocalCluster:
    """Synchronous facade over :class:`AsyncLocalCluster`, running its own
    event loop in a background thread."""

    def __init__(self) -> None:
        self._loop = asyncio.new_event_loop()
        self._thread = threading.Thread(
            target=self._loop.run_forever, name="storm-tpu-torch-cluster",
            daemon=True)
        self._thread.start()
        self._cluster = AsyncLocalCluster()
        self._closed = False

    def _run(self, coro, timeout: Optional[float] = None):
        return asyncio.run_coroutine_threadsafe(coro, self._loop).result(timeout)

    def submit_topology(self, name: str, config: Config, topology: Topology) -> None:
        self._run(self._cluster.submit(name, config, topology))

    def kill_topology(self, name: str, wait_secs: float = 0.0) -> None:
        self._run(self._cluster.kill(name, wait_secs))

    def drain(self, name: str, timeout_s: float = 30.0) -> bool:
        return self._run(self._cluster.runtime(name).drain(timeout_s))

    def metrics(self, name: str) -> Dict[str, Dict[str, object]]:
        # Marshal onto the loop thread: snapshot() iterates dicts the
        # executors mutate there.
        async def snap():
            return self._cluster.runtime(name).metrics.snapshot()

        return self._run(snap())

    def errors(self, name: str) -> List[Tup[str, int, BaseException]]:
        async def errs():
            return list(self._cluster.runtime(name).errors)

        return self._run(errs())

    def shutdown(self) -> None:
        if self._closed:
            return
        self._closed = True
        self._run(self._cluster.shutdown())
        self._loop.call_soon_threadsafe(self._loop.stop)
        self._thread.join(timeout=10)
        self._loop.close()

    def __enter__(self) -> "LocalCluster":
        return self

    def __exit__(self, *exc) -> None:
        self.shutdown()
