"""The in-process cluster, copied from ``storm_tpu/runtime/cluster.py``:
routing, lifecycle, graceful drain, the at-least-once timeout sweep, the
live model swap with canary (``swap_model``), the per-task stats
(``component_stats``) and ``seek`` (a spout component repositioned:
each task applies it at its next poll).

- ``rebalance`` changes a component's parallelism under traffic: a new
  bolt task is prewarmed off the loop (``prewarm``, where the bolt has
  one: an InferenceBolt takes the process's shared engine), joins the
  executors before it starts, and a ``prepare`` that raises rolls back
  every task the call added; then the routing table takes the new
  inboxes and the removed tasks drain. A new spout task inherits the
  component's activation state.
- ``deactivate`` / ``activate`` stop and resume the spouts' pulls.
- The sweep loop supervises: a task that died (a framework fault, not a
  user exception) is replaced by a fresh clone on the same inbox, counted
  in ``executor_restarts`` and recorded as an ``executor_restart`` flight
  event; a spout keeps its activation state. It also publishes each
  bolt's ``inbox_depth`` and ``execute_rate`` and each spout's
  ``ack_rate``.
- ``health`` reports live tasks and in-flight trees; metrics consumers
  get a snapshot every interval and a last one at ``kill``.
- Stateful bolts checkpoint into ``state_backend``, files under
  ``topology.state_dir`` or memory.

A runtime's ``bolt_execs`` (each task's bounded
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
from typing import Any, Callable, Dict, List, Optional, Tuple as Tup

from storm_tpu_torch.config import Config, TracingConfig
from storm_tpu_torch.runtime.acker import AckLedger
from storm_tpu_torch.runtime.executor import BoltExecutor, SpoutExecutor, clone_component
from storm_tpu_torch.runtime.metrics import MetricsRegistry
from storm_tpu_torch.runtime.state import make_backend
from storm_tpu_torch.runtime.topology import Topology
from storm_tpu_torch.runtime.tracing import FlightRecorder, Tracer

log = logging.getLogger("storm_tpu_torch.cluster")


class TargetGroup:
    """The inboxes of one downstream component (mutable, so a rebalance
    can swap tasks under live producers)."""

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

    def reprepare(self, component_id: str) -> None:
        """Re-size every grouping that targets ``component_id`` (after a
        rebalance changed its inboxes)."""
        for subs in self._subs.values():
            for grouping, group in subs:
                if group.component_id == component_id:
                    grouping.prepare(len(group.inboxes))

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
        self.state_backend = make_backend(config.topology.state_dir)
        tr = getattr(config, "tracing", None) or TracingConfig()
        self.tracer = Tracer(sample_rate=tr.sample_rate, store_capacity=tr.store_capacity)
        self.flight = FlightRecorder(path=tr.flight_path, capacity=tr.flight_capacity,
                                     max_bytes=tr.flight_max_bytes,
                                     max_files=tr.flight_max_files)
        self.ledger = AckLedger(timeout_s=config.topology.message_timeout_s)
        self.router = Router()
        self.groups: Dict[str, TargetGroup] = {}
        self.bolt_execs: Dict[str, List[BoltExecutor]] = {}
        self.spout_execs: Dict[str, List[SpoutExecutor]] = {}
        self.errors: List[Tup[str, int, BaseException]] = []
        self._sweeper: Optional[asyncio.Task] = None
        self._error_cb: Optional[Callable] = None
        self._consumer_tasks: List[asyncio.Task] = []
        self._consumers: List[Any] = []
        # A grow suspends at the prewarm await: without the lock, two
        # rebalances of one component would see the same task count.
        self._rebalance_lock = asyncio.Lock()
        # The topology's LoadShedController and Observatory, once attached.
        self.qos = None
        self.obs = None

    def _make_executors(self) -> None:
        tcfg = self.config.topology
        for spec in self.topology.specs.values():
            group = self.groups[spec.component_id] = TargetGroup(spec.component_id)
            if spec.is_spout:
                self.spout_execs[spec.component_id] = [
                    SpoutExecutor(self, spec.component_id, i,
                                  clone_component(spec.obj),
                                  tcfg.max_spout_pending)
                    for i in range(spec.parallelism)]
            else:
                execs = self.bolt_execs[spec.component_id] = [
                    BoltExecutor(self, spec.component_id, i,
                                 clone_component(spec.obj), tcfg.inbox_capacity,
                                 tcfg.tick_interval_s)
                    for i in range(spec.parallelism)]
                group.inboxes = [e.inbox for e in execs]
        for spec in self.topology.specs.values():
            for sub in spec.inputs:
                self.router.add(sub.source, sub.stream, sub.grouping,
                                self.groups[spec.component_id])

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
        prev_counts: Dict[str, int] = {}
        prev_t = time.monotonic()
        while True:
            await asyncio.sleep(interval)
            n = self.ledger.sweep()
            if n:
                log.warning("%s: %d tuple trees timed out", self.name, n)
                self.flight.event("tree_timeout", topology=self.name, trees=n)
            self._supervise()
            for cid, execs in self.bolt_execs.items():
                self.metrics.gauge(cid, "inbox_depth").set(
                    sum(e.inbox.qsize() for e in execs))
            # Rates: counter deltas per sweep, executed/s for bolts and
            # acked trees/s for spouts.
            now = time.monotonic()
            dt = max(1e-6, now - prev_t)
            prev_t = now

            def rate_of(cid: str, counter_name: str) -> float:
                cur = self.metrics.counter(cid, counter_name).value
                rate = (cur - prev_counts.get(cid, cur)) / dt
                prev_counts[cid] = cur
                return round(rate, 3)

            for cid in self.bolt_execs:
                self.metrics.gauge(cid, "execute_rate").set(rate_of(cid, "executed"))
            for cid in self.spout_execs:
                self.metrics.gauge(cid, "ack_rate").set(rate_of(cid, "tree_acked"))

    def _supervise(self) -> None:
        """Storm's supervisor: an executor task that died (a framework
        fault; user exceptions are caught in the loop) is replaced by a
        fresh clone of the component on the same inbox."""
        tcfg = self.config.topology

        def replace(cid, i, execs, old, make_fresh, dispose):
            exc = old._task.exception()
            log.error("executor %s[%d] died (%r); restarting", cid, i, exc)
            self.metrics.counter(cid, "executor_restarts").inc()
            self.flight.event("executor_restart", topology=self.name,
                              component=cid, task=i, error=repr(exc))
            try:
                dispose()  # release the crashed component's resources
            except Exception as ce:
                log.warning("cleanup of dead %s[%d] failed: %s", cid, i, ce)
            fresh = make_fresh(clone_component(self.topology.specs[cid].obj))
            execs[i] = fresh
            fresh.start()
            return fresh

        def died(e) -> bool:
            return e._task is not None and e._task.done() and not e._task.cancelled()

        for cid, execs in self.bolt_execs.items():
            for i, e in enumerate(execs):
                if died(e):
                    # The dead task's tickers would go on feeding the inbox.
                    for ticker in (e._tick_task, e._ckpt_task):
                        if ticker is not None:
                            ticker.cancel()
                    replace(cid, i, execs, e,
                            lambda proto, e=e, cid=cid, i=i: BoltExecutor(
                                self, cid, i, proto, tcfg.inbox_capacity,
                                tcfg.tick_interval_s, inbox=e.inbox),
                            e.bolt.cleanup)
        for cid, execs in self.spout_execs.items():
            for i, e in enumerate(execs):
                if died(e):
                    fresh = replace(cid, i, execs, e,
                                    lambda proto, cid=cid, i=i: SpoutExecutor(
                                        self, cid, i, proto, tcfg.max_spout_pending),
                                    e.spout.close)
                    # A drain in progress must not resurrect an emitting spout.
                    fresh._active = e._active

    def health(self) -> Dict[str, Any]:
        """Liveness: tasks and live tasks per component, trees in flight."""
        comps: Dict[str, Any] = {}
        for cid, execs in {**self.bolt_execs, **self.spout_execs}.items():
            comps[cid] = {"tasks": len(execs),
                          "alive": sum(1 for e in execs
                                       if e._task is not None and not e._task.done())}
        return {"topology": self.name, "inflight_trees": self.ledger.inflight,
                "components": comps}

    # ---- runtime services (used by collectors/executors) ---------------------

    def parallelism_of(self, component_id: str) -> int:
        if component_id in self.bolt_execs:
            return len(self.bolt_execs[component_id])
        if component_id in self.spout_execs:
            return len(self.spout_execs[component_id])
        return self.topology.specs[component_id].parallelism

    def spout_done_cb(self, component_id: str, task_index: int):
        ex = self.spout_execs[component_id][task_index]
        ex.track()
        return ex.on_done

    def spout_done(self, component_id: str, task_index: int, msg_id, ok: bool,
                   ts: float) -> None:
        """Completion for roots that never entered the ledger (emit with
        no subscribers)."""
        ex = self.spout_execs[component_id][task_index]
        self.metrics.counter(component_id, "tree_acked" if ok else "tree_failed").inc()
        (ex.spout.ack if ok else ex.spout.fail)(msg_id)

    def report_error(self, component_id: str, task_index: int, err: BaseException) -> None:
        self.errors.append((component_id, task_index, err))
        self.metrics.counter(component_id, "errors").inc()
        log.error("error in %s[%d]: %r", component_id, task_index, err, exc_info=err)
        if self._error_cb is not None:
            self._error_cb(component_id, task_index, err)

    # ---- lifecycle -----------------------------------------------------------

    async def deactivate(self) -> None:
        """Stop the spouts pulling; in-flight tuples keep flowing (the
        first phase of a graceful drain)."""
        for execs in self.spout_execs.values():
            for e in execs:
                e._active = False
                await e.spout.deactivate()

    async def activate(self) -> None:
        """Resume the spouts after a ``deactivate``."""
        for execs in self.spout_execs.values():
            for e in execs:
                e._active = True
                await e.spout.activate()

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

    def add_metrics_consumer(self, consumer, interval_s: float = 10.0) -> None:
        """Hand ``consumer.handle(topology, ts, snapshot)`` a metrics
        snapshot every ``interval_s`` seconds until the topology dies, and
        a last one at ``kill`` (Storm's ``registerMetricsConsumer``)."""
        self._consumers.append(consumer)

        async def pump() -> None:
            while True:
                await asyncio.sleep(interval_s)
                try:
                    consumer.handle(self.name, time.time(), self.metrics.snapshot())
                except Exception:
                    log.exception("metrics consumer %r failed", consumer)

        self._consumer_tasks.append(asyncio.get_running_loop().create_task(pump()))

    async def kill(self, wait_secs: float = 0.0) -> None:
        """Kill the topology; ``wait_secs`` > 0 deactivates and drains
        first (Storm's KillOptions)."""
        if wait_secs > 0:
            await self.deactivate()
            await self.drain(timeout_s=wait_secs)
        for task in self._consumer_tasks:
            task.cancel()
        for consumer in self._consumers:
            # A last snapshot, so a short-lived topology records once; a
            # failing handle must not leak the consumer's resources.
            try:
                consumer.handle(self.name, time.time(), self.metrics.snapshot())
            except Exception:
                log.exception("metrics consumer %r final handle failed", consumer)
            finally:
                try:
                    consumer.close()
                except Exception:
                    log.exception("metrics consumer %r close failed", consumer)
        self._consumer_tasks.clear()
        self._consumers.clear()
        if self._sweeper:
            self._sweeper.cancel()
        for execs in self.spout_execs.values():
            for e in execs:
                await e.stop()
        for execs in self.bolt_execs.values():
            for e in execs:
                await e.stop(drain=wait_secs > 0)
        self.flight.close()

    # ---- elasticity ----------------------------------------------------------

    async def seek(self, component_id: str, position) -> int:
        """Reposition a spout component's consumption (replay, backfill).
        Returns the number of tasks repositioned."""
        execs = self.spout_execs.get(component_id)
        if execs is None:
            raise KeyError(component_id)
        seekable = [e for e in execs if hasattr(e.spout, "request_seek")]
        if not seekable:
            raise TypeError(f"component {component_id!r} is not seekable")
        for e in seekable:
            e.spout.request_seek(position)
        return len(seekable)

    async def rebalance(self, component_id: str, parallelism: int) -> None:
        """Change a component's parallelism under traffic."""
        if parallelism < 1:
            raise ValueError("parallelism must be >= 1")
        async with self._rebalance_lock:
            await self._rebalance_locked(component_id, parallelism)

    async def _rebalance_locked(self, component_id: str, parallelism: int) -> None:
        tcfg = self.config.topology
        proto = self.topology.specs[component_id].obj
        if component_id in self.bolt_execs:
            execs = self.bolt_execs[component_id]
            added: list = []
            try:
                while len(execs) < parallelism:
                    clone = clone_component(proto)
                    # Warm the replica's expensive state (its engine) on a
                    # worker thread before it joins the routing table: a
                    # cold prepare on the loop would stall every executor.
                    prewarm = getattr(clone, "prewarm", None)
                    if prewarm is not None:
                        await asyncio.to_thread(prewarm)
                    e = BoltExecutor(self, component_id, len(execs), clone,
                                     tcfg.inbox_capacity, tcfg.tick_interval_s)
                    # Appended before start, so prepare() sees the grown
                    # parallelism (the exactly-once sink's guard reads it)...
                    execs.append(e)
                    added.append(e)
                    e.start()
            except BaseException:
                # ...and a prepare() that raises rolls back every executor
                # this call added: a registered, never-started one would
                # swallow routed tuples.
                for e in reversed(added):
                    if e in execs:
                        execs.remove(e)
                    await e.stop(drain=False)
                raise
            removed = []
            while len(execs) > parallelism:
                removed.append(execs.pop())
            self.groups[component_id].inboxes = [e.inbox for e in execs]
            self.router.reprepare(component_id)
            for e in removed:
                await e.stop(drain=True)
        elif component_id in self.spout_execs:
            execs = self.spout_execs[component_id]
            # A grow during a deactivate must not start an emitting spout.
            active = all(e._active for e in execs) if execs else True
            while len(execs) < parallelism:
                e = SpoutExecutor(self, component_id, len(execs),
                                  clone_component(proto), tcfg.max_spout_pending)
                e._active = active
                execs.append(e)
                e.start()
            while len(execs) > parallelism:
                await execs.pop().stop()
        else:
            raise KeyError(component_id)
        self.topology.specs[component_id].parallelism = parallelism

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
        # The prototype first: a task a rebalance clones during the awaits
        # below takes the new model.
        if hasattr(proto, "model_cfg"):
            proto.model_cfg = new_cfg
        # The first swap builds and warms the engine (shared per process);
        # the others take it from the cache. Re-scanned until stable: a
        # rebalance during an await may add tasks cloned before.
        while True:
            pending = [e for e in self.bolt_execs.get(component_id, ())
                       if hasattr(e.bolt, "swap_model") and e.bolt.model_cfg is not new_cfg]
            if not pending:
                return new_cfg
            for e in pending:
                await e.bolt.swap_model(new_cfg)

    def component_stats(self, component_id: str) -> list:
        """Per-task stats of one component: for a bolt the executed count,
        mean execute ms, errors, inbox depth and the model descriptor
        (``name[:checkpoint][:seed=N][:weights]``, as storm_tpu spells it);
        for a spout the acked and failed trees, errors, in-flight roots
        and, where the spout has them, the partitions it owns."""
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
                     "errors": e.n_errors, "inflight": e.inflight,
                     **({"partitions": list(p)}
                        if (p := getattr(e.spout, "my_partitions", None)) is not None else {})}
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

    @property
    def runtimes(self) -> Dict[str, TopologyRuntime]:
        """Live topologies by name (a read-only view)."""
        return dict(self._topologies)

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

    def rebalance(self, name: str, component_id: str, parallelism: int) -> None:
        self._run(self._cluster.runtime(name).rebalance(component_id, parallelism))

    def deactivate(self, name: str) -> None:
        self._run(self._cluster.runtime(name).deactivate())

    def activate(self, name: str) -> None:
        self._run(self._cluster.runtime(name).activate())

    def drain(self, name: str, timeout_s: float = 30.0) -> bool:
        return self._run(self._cluster.runtime(name).drain(timeout_s))

    def metrics(self, name: str) -> Dict[str, Dict[str, object]]:
        # Marshal onto the loop thread: snapshot() iterates dicts the
        # executors mutate there.
        async def snap():
            return self._cluster.runtime(name).metrics.snapshot()

        return self._run(snap())

    def reset_histogram(self, name: str, component: str, metric: str) -> None:
        """Clear one histogram (a harness dropping its warm-up traffic)."""
        async def reset():
            self._cluster.runtime(name).metrics.histogram(component, metric).reset()

        self._run(reset())

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
