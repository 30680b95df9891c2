"""The in-process cluster, copied from ``storm_tpu/runtime/cluster.py``
without rebalance, model swap, seek, supervision and metrics consumers:
routing, lifecycle, graceful drain and the at-least-once timeout sweep.
A runtime's ``bolt_execs`` (each task's bounded inbox) and ``metrics`` are
what the load-shed controller reads; it hangs itself on ``runtime.qos``.

:class:`AsyncLocalCluster` runs inside an event loop; :class:`LocalCluster`
is its synchronous facade with its own loop thread (Storm's
``LocalCluster``).
"""

from __future__ import annotations

import asyncio
import logging
import threading
import time
from typing import Any, Dict, List, Optional, Tuple as Tup

from storm_tpu_torch.config import Config
from storm_tpu_torch.runtime.acker import AckLedger
from storm_tpu_torch.runtime.executor import BoltExecutor, SpoutExecutor, clone_component
from storm_tpu_torch.runtime.metrics import MetricsRegistry
from storm_tpu_torch.runtime.topology import Topology

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


class TopologyRuntime:
    """Everything live for one submitted topology."""

    def __init__(self, name: str, topology: Topology, config: Config) -> None:
        self.name = name
        self.topology = topology
        self.config = config
        self.metrics = MetricsRegistry()
        self.ledger = AckLedger(timeout_s=config.topology.message_timeout_s)
        self.router = Router()
        self.bolt_execs: Dict[str, List[BoltExecutor]] = {}
        self.spout_execs: Dict[str, List[SpoutExecutor]] = {}
        self.errors: List[Tup[str, int, BaseException]] = []
        self._sweeper: Optional[asyncio.Task] = None
        # The topology's LoadShedController, once one is attached.
        self.qos = None

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
