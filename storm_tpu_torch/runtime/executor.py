"""Executors, copied from ``storm_tpu/runtime/executor.py`` without state
checkpoints and tracing: one asyncio task per operator instance.

Each bolt instance owns a bounded inbox (the backpressure point) and each
spout instance runs a pull loop gated on ``max_spout_pending``.

A bolt task yields to the event loop after each tuple while its inbox
holds more. storm_tpu's executor takes tuple after tuple without a
suspension point (``Queue.get`` on a non-empty queue returns at once), so
one task working through a full inbox holds the loop: under a burst the
load-shed controller's timer and the other tasks waited until the burst
was through, and the controller never saw the queues it watches.
"""

from __future__ import annotations

import asyncio
import copy
import logging
import time
from typing import Any, Optional

from storm_tpu_torch.runtime.base import Bolt, OutputCollector, Spout, TopologyContext
from storm_tpu_torch.runtime.tuples import Tuple

log = logging.getLogger("storm_tpu_torch.executor")

_STOP = object()  # inbox sentinel


class BoltExecutor:
    def __init__(self, runtime: Any, component_id: str, task_index: int,
                 bolt: Bolt, inbox_capacity: int) -> None:
        self.rt = runtime
        self.component_id = component_id
        self.task_index = task_index
        self.bolt = bolt
        self.inbox: asyncio.Queue = asyncio.Queue(maxsize=inbox_capacity)
        self._task: Optional[asyncio.Task] = None
        self.collector = OutputCollector(runtime, component_id, task_index)
        self.collector.set_output_fields(bolt.declare_output_fields())

    def start(self) -> None:
        ctx = TopologyContext(self.component_id, self.task_index,
                              self.rt.parallelism_of(self.component_id),
                              self.rt.config, self.rt.metrics)
        self.bolt.prepare(ctx, self.collector)
        self._task = asyncio.create_task(
            self._run(), name=f"{self.component_id}[{self.task_index}]")

    async def _run(self) -> None:
        m = self.rt.metrics
        executed = m.counter(self.component_id, "executed")
        exec_ms = m.histogram(self.component_id, "execute_ms")
        while True:
            item = await self.inbox.get()
            if item is _STOP:
                break
            t: Tuple = item
            executed.inc()
            t0 = time.perf_counter()
            try:
                await self.bolt.execute(t)
            except asyncio.CancelledError:
                raise
            except Exception as e:  # fail the tuple, keep the executor alive
                self.rt.report_error(self.component_id, self.task_index, e)
                self.collector.fail(t)
            finally:
                exec_ms.observe((time.perf_counter() - t0) * 1e3)
            if not self.inbox.empty():
                await asyncio.sleep(0)  # let timers and the other tasks run

    async def stop(self, drain: bool) -> None:
        if self._task is None:
            return
        if drain:
            try:
                # Bounded: if the run loop died with a full inbox the
                # sentinel can never land.
                await asyncio.wait_for(self.inbox.put(_STOP), timeout=30.0)
                await asyncio.wait_for(self._task, timeout=30.0)
            except asyncio.TimeoutError:  # pragma: no cover
                self._task.cancel()
            try:
                # Settle deferred work (pending batches, in-flight sends)
                # before cleanup closes resources under it.
                await asyncio.wait_for(self.bolt.flush(), timeout=30.0)
            except Exception as e:
                log.warning("flush error in %s: %s", self.component_id, e)
        else:
            self._task.cancel()
        try:
            await self._task
        except (asyncio.CancelledError, Exception):
            pass
        try:
            self.bolt.cleanup()
        except Exception as e:  # pragma: no cover
            log.warning("cleanup error in %s: %s", self.component_id, e)


class SpoutExecutor:
    def __init__(self, runtime: Any, component_id: str, task_index: int,
                 spout: Spout, max_pending: int) -> None:
        self.rt = runtime
        self.component_id = component_id
        self.task_index = task_index
        self.spout = spout
        self.max_pending = max_pending
        self.inflight = 0
        self._slot = asyncio.Event()
        self._slot.set()
        self._task: Optional[asyncio.Task] = None
        self._active = True
        self.collector = OutputCollector(runtime, component_id, task_index)
        self.collector.set_output_fields(spout.declare_output_fields())

    def on_done(self, msg_id: Any, ok: bool) -> None:
        """Ledger callback: the tuple tree for msg_id completed or failed."""
        self.inflight -= 1
        if self.inflight < self.max_pending:
            self._slot.set()
        m = self.rt.metrics
        if ok:
            m.counter(self.component_id, "tree_acked").inc()
            self.spout.ack(msg_id)
        else:
            m.counter(self.component_id, "tree_failed").inc()
            self.spout.fail(msg_id)

    def track(self) -> None:
        """Called by the runtime when this spout opens a ledger entry."""
        self.inflight += 1
        if self.inflight >= self.max_pending:
            self._slot.clear()

    def start(self) -> None:
        ctx = TopologyContext(self.component_id, self.task_index,
                              self.rt.parallelism_of(self.component_id),
                              self.rt.config, self.rt.metrics)
        self.spout.open(ctx, self.collector)
        self._task = asyncio.create_task(
            self._run(), name=f"{self.component_id}[{self.task_index}]")

    async def _run(self) -> None:
        idle_backoff = 0.001
        while True:
            await self._slot.wait()
            if not self._active:
                await asyncio.sleep(0.05)
                continue
            try:
                emitted = await self.spout.next_tuple()
            except asyncio.CancelledError:
                raise
            except Exception as e:
                self.rt.report_error(self.component_id, self.task_index, e)
                emitted = False
            if emitted:
                idle_backoff = 0.001
            else:
                await asyncio.sleep(idle_backoff)
                idle_backoff = min(idle_backoff * 2, 0.05)

    async def stop(self) -> None:
        if self._task is None:
            return
        self._task.cancel()
        try:
            await self._task
        except (asyncio.CancelledError, Exception):
            pass
        try:
            self.spout.close()
        except Exception as e:  # pragma: no cover
            log.warning("close error in %s: %s", self.component_id, e)


def clone_component(obj: Any) -> Any:
    """Per-task instance from the prototype handed to TopologyBuilder:
    ``obj.clone()`` where defined (to share a read-only resource such as
    a broker handle), else a deep copy."""
    if hasattr(obj, "clone"):
        return obj.clone()
    return copy.deepcopy(obj)
