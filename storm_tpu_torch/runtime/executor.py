"""Executors, copied from ``storm_tpu/runtime/executor.py``: one asyncio
task per operator instance. A sampled tuple's ``execute`` is recorded as
a span of its trace. A bolt gets tick tuples every
``topology.tick_interval_s`` (or its own ``tick_interval_s``); a
:class:`~storm_tpu_torch.runtime.state.StatefulBolt` gets its state
restored before its first tuple, checkpointed between tuples every
``topology.checkpoint_interval_s`` and once more at a graceful stop. A
replacement executor (the supervisor's) takes over its predecessor's
inbox.

Each bolt instance owns a bounded inbox (the backpressure point) and each
spout instance runs a pull loop gated on ``max_spout_pending``.

A bolt task yields to the event loop after each tuple while its inbox
holds more. storm_tpu's executor takes tuple after tuple without a
suspension point (``Queue.get`` on a non-empty queue returns at once), so
one task working through a full inbox holds the loop: under a burst the
load-shed controller's timer and the other tasks waited until the burst
was through, and the controller never saw the queues it watches.

Every executor splits its wall time into ``busy_s`` (a bolt's
``execute`` and ``tick``, a spout's emitting polls), ``wait_s`` (a bolt
blocked on its inbox, a spout on its pending slots, empty polls and their
backoff) and ``flush_s`` (a bolt's drain at a graceful stop; a checkpoint
counts as none of the three), as storm_tpu's do; the
observatory's ``CapacityTracker`` reads them as windowed deltas. The yield
between tuples is inbox time: it counts as ``wait_s``, as the whole gap
between two tuples does in storm_tpu. ``clock`` is injectable (set it
before ``start``).
"""

from __future__ import annotations

import asyncio
import copy
import logging
import time
from typing import Any, Optional

from storm_tpu_torch.runtime.base import Bolt, OutputCollector, Spout, TopologyContext
from storm_tpu_torch.runtime.tuples import TickTuple, Tuple, is_tick

log = logging.getLogger("storm_tpu_torch.executor")

_STOP = object()  # inbox sentinel
_CKPT = object()  # checkpoint sentinel: a snapshot between tuples


class BoltExecutor:
    def __init__(self, runtime: Any, component_id: str, task_index: int,
                 bolt: Bolt, inbox_capacity: int, tick_interval_s: float = 0.0,
                 inbox: Optional[asyncio.Queue] = None) -> None:
        self.rt = runtime
        self.component_id = component_id
        self.task_index = task_index
        self.bolt = bolt
        # A supervisor's replacement takes its predecessor's inbox, so the
        # routing tables stay valid across the swap.
        self.inbox: asyncio.Queue = inbox if inbox is not None else asyncio.Queue(
            maxsize=inbox_capacity)
        self.tick_interval_s = tick_interval_s
        self._task: Optional[asyncio.Task] = None
        self._tick_task: Optional[asyncio.Task] = None
        self._ckpt_task: Optional[asyncio.Task] = None
        self._stateful = False
        self.collector = OutputCollector(runtime, component_id, task_index)
        self.collector.set_output_fields(bolt.declare_output_fields())
        # Per-task stats (the runtime's component_stats).
        self.n_executed = 0
        self.exec_ms_total = 0.0
        self.n_errors = 0
        # Busy, inbox-wait and drain-flush seconds.
        self.clock = time.perf_counter
        self.busy_s = 0.0
        self.wait_s = 0.0
        self.flush_s = 0.0

    def start(self) -> None:
        self.bolt.prepare(_context(self.rt, self.component_id, self.task_index),
                          self.collector)
        self._init_state()
        self._task = asyncio.create_task(
            self._run(), name=f"{self.component_id}[{self.task_index}]")
        interval = self.tick_interval_s or getattr(self.bolt, "tick_interval_s", 0.0)
        if interval > 0:
            self._tick_task = asyncio.create_task(self._ticker(interval))
        ckpt = self.rt.config.topology.checkpoint_interval_s
        if self._stateful and ckpt > 0:
            self._ckpt_task = asyncio.create_task(self._ticker(ckpt, payload=_CKPT))

    def _init_state(self) -> None:
        """Restore and hand the state to a StatefulBolt (Storm's prepare ->
        initState order): a replacement executor resumes from the last
        checkpoint."""
        from storm_tpu_torch.runtime.state import KeyValueState, StatefulBolt

        self._stateful = isinstance(self.bolt, StatefulBolt)
        self._state_version = 0
        if not self._stateful:
            return
        got = self.rt.state_backend.load(self.component_id, self.task_index)
        if got is not None:
            self._state_version, snap = got
            state = KeyValueState(snap)
        else:
            state = KeyValueState()
        self._state = state
        self.bolt.init_state(state)
        # The synchronous checkpoint: a transactional bolt persists its
        # state BEFORE acking, so an offset commit never outruns the
        # snapshot it depends on.
        self.bolt.checkpoint_now = self._checkpoint

    def _checkpoint(self) -> None:
        if not self._state.dirty:
            return
        self.bolt.pre_checkpoint()
        self._state_version += 1
        self.rt.state_backend.save(self.component_id, self.task_index,
                                   self._state_version, self._state.snapshot())
        self._state.dirty = False
        self.rt.metrics.counter(self.component_id, "checkpoints").inc()

    async def _ticker(self, interval: float, payload: Any = None) -> None:
        while True:
            await asyncio.sleep(interval)
            # A full inbox skips the tick rather than stall.
            try:
                self.inbox.put_nowait(payload if payload is not None else TickTuple())
            except asyncio.QueueFull:
                pass

    async def _run(self) -> None:
        m = self.rt.metrics
        executed = m.counter(self.component_id, "executed")
        exec_ms = m.histogram(self.component_id, "execute_ms")
        tracer = getattr(self.rt, "tracer", None)
        clock = self.clock
        more = False
        while True:
            w0 = clock()
            if more:
                await asyncio.sleep(0)  # let timers and the other tasks run
            item = await self.inbox.get()
            self.wait_s += clock() - w0
            more = not self.inbox.empty()
            if item is _STOP:
                break
            if item is _CKPT:
                # Neither busy nor waiting, as storm_tpu counts it.
                try:
                    self._checkpoint()
                except Exception as e:
                    self.n_errors += 1
                    self.rt.report_error(self.component_id, self.task_index, e)
                continue
            t: Tuple = item
            if is_tick(t):
                t0 = clock()
                try:
                    await self.bolt.tick()
                except asyncio.CancelledError:
                    raise
                except Exception as e:  # a tick has no tuple to fail
                    self.n_errors += 1
                    self.rt.report_error(self.component_id, self.task_index, e)
                finally:
                    self.busy_s += clock() - t0
                continue
            executed.inc()
            self.n_executed += 1
            t0 = clock()
            try:
                await self.bolt.execute(t)
            except asyncio.CancelledError:
                raise
            except Exception as e:  # fail the tuple, keep the executor alive
                self.n_errors += 1
                self.rt.report_error(self.component_id, self.task_index, e)
                self.collector.fail(t)
            finally:
                t1 = clock()
                exec_ms.observe((t1 - t0) * 1e3)
                self.exec_ms_total += (t1 - t0) * 1e3
                self.busy_s += t1 - t0
                if t.trace is not None and tracer is not None:
                    tracer.record(t.trace, "execute", self.component_id, t0, t1)
            more = not self.inbox.empty()

    async def stop(self, drain: bool) -> None:
        for ticker in (self._tick_task, self._ckpt_task):
            if ticker is not None:
                ticker.cancel()
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
            f0 = self.clock()
            try:
                # Settle deferred work (pending batches, in-flight sends)
                # before cleanup closes resources under it.
                await asyncio.wait_for(self.bolt.flush(), timeout=30.0)
            except Exception as e:
                log.warning("flush error in %s: %s", self.component_id, e)
            finally:
                self.flush_s += self.clock() - f0
            if self._stateful:
                # The final checkpoint: a graceful stop keeps the tail of
                # the updates since the last periodic one.
                try:
                    self._checkpoint()
                except Exception as e:
                    log.warning("final checkpoint of %s failed: %s", self.component_id, e)
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
        self.n_acked = 0
        self.n_failed = 0
        self.n_errors = 0
        # Busy (emitting polls) and wait seconds; flush_s is always 0, kept
        # for the same surface as a bolt's.
        self.clock = time.perf_counter
        self.busy_s = 0.0
        self.wait_s = 0.0
        self.flush_s = 0.0

    def on_done(self, msg_id: Any, ok: bool, root_ts: float) -> None:
        """Ledger callback: the tuple tree for msg_id completed or failed."""
        self.inflight -= 1
        if self.inflight < self.max_pending:
            self._slot.set()
        m = self.rt.metrics
        if ok:
            self.n_acked += 1
            m.counter(self.component_id, "tree_acked").inc()
            self.spout.ack(msg_id)
        else:
            self.n_failed += 1
            m.counter(self.component_id, "tree_failed").inc()
            self.spout.fail(msg_id)

    def track(self) -> None:
        """Called by the runtime when this spout opens a ledger entry."""
        self.inflight += 1
        if self.inflight >= self.max_pending:
            self._slot.clear()

    def start(self) -> None:
        self.spout.open(_context(self.rt, self.component_id, self.task_index),
                        self.collector)
        self._task = asyncio.create_task(
            self._run(), name=f"{self.component_id}[{self.task_index}]")

    async def _run(self) -> None:
        idle_backoff = 0.001
        clock = self.clock
        while True:
            w0 = clock()
            await self._slot.wait()
            if not self._active:
                await asyncio.sleep(0.05)
                self.wait_s += clock() - w0
                continue
            self.wait_s += clock() - w0
            b0 = clock()
            try:
                emitted = await self.spout.next_tuple()
            except asyncio.CancelledError:
                raise
            except Exception as e:
                self.n_errors += 1
                self.rt.report_error(self.component_id, self.task_index, e)
                emitted = False
            finally:
                dt = clock() - b0
            if emitted:
                self.busy_s += dt
                idle_backoff = 0.001
            else:
                # An empty poll is idle time: a drained spout reads ~0.
                self.wait_s += dt
                s0 = clock()
                await asyncio.sleep(idle_backoff)
                self.wait_s += clock() - s0
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


def _context(rt: Any, component_id: str, task_index: int) -> TopologyContext:
    return TopologyContext(component_id, task_index, rt.parallelism_of(component_id),
                           rt.config, rt.metrics, tracer=getattr(rt, "tracer", None),
                           flight=getattr(rt, "flight", None))


def clone_component(obj: Any) -> Any:
    """Per-task instance from the prototype handed to TopologyBuilder:
    ``obj.clone()`` where defined (to share a read-only resource such as
    a broker handle), else a deep copy."""
    if hasattr(obj, "clone"):
        return obj.clone()
    return copy.deepcopy(obj)
