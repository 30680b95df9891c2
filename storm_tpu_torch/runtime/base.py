"""Operator API: Spout / Bolt / OutputCollector / TopologyContext, copied
from ``storm_tpu/runtime/base.py``. A tuple's trace context and its
source-log ``origins`` follow anchoring (origins folded to the largest
offset per partition); ``emit_direct`` names the consumer task of a
direct grouping; each emit records its ``tuple_route`` row in the copy
ledger. Spouts have ``activate``/``deactivate`` hooks and bolts a
``tick`` hook.

``execute``/``next_tuple`` are coroutines, because emitting into a bounded
downstream inbox is a backpressure point; an uncaught exception in
``execute`` fails the input tuple and keeps the executor alive.
"""

from __future__ import annotations

import time
from typing import Any, Dict, Iterable, List, Optional, Sequence

from storm_tpu_torch.obs import copyledger as _copyledger
from storm_tpu_torch.runtime.groupings import DirectGrouping
from storm_tpu_torch.runtime.tracing import NOT_SAMPLED
from storm_tpu_torch.runtime.tuples import Tuple, merge_offsets, new_id


class TopologyContext:
    """What an operator instance knows about itself and its surroundings.
    ``tracer`` and ``flight`` are the runtime's (None for a context built
    outside a runtime)."""

    def __init__(self, component_id: str, task_index: int, parallelism: int,
                 config: Any, metrics: Any = None, *, tracer: Any = None,
                 flight: Any = None) -> None:
        self.component_id = component_id
        self.task_index = task_index
        self.parallelism = parallelism
        self.config = config
        self.metrics = metrics
        self.tracer = tracer
        self.flight = flight


class OutputCollector:
    """Routes emits and keeps the ack/anchor bookkeeping (Storm's
    ``OutputCollector``/``SpoutOutputCollector``)."""

    def __init__(self, runtime: Any, component_id: str, task_index: int) -> None:
        self._rt = runtime
        self.component_id = component_id
        self.task_index = task_index
        self._out_fields: Dict[str, Sequence[str]] = {"default": ("message",)}
        self._m_emitted = runtime.metrics.counter(component_id, "emitted")
        self._m_acked = runtime.metrics.counter(component_id, "acked")
        self._m_failed = runtime.metrics.counter(component_id, "failed")
        self._tracer = getattr(runtime, "tracer", None)

    def set_output_fields(self, fields: Dict[str, Sequence[str]]) -> None:
        self._out_fields = fields

    async def emit(self, values: Sequence[Any], *, stream: str = "default",
                   anchors: Optional[Iterable[Tuple]] = None,
                   msg_id: Any = None, root_ts: Optional[float] = None,
                   origins: Optional[frozenset] = None,
                   direct_task: Optional[int] = None, trace: Any = None) -> int:
        """Emit a tuple downstream; returns the number of deliveries.

        Bolts: ``await collector.emit(Values(out), anchors=[in_tuple])``.
        Spouts: ``await collector.emit(Values(x), msg_id=offset)`` — a
        non-None ``msg_id`` opens an at-least-once ledger entry whose
        completion or failure is reported back to the spout. ``trace``: a
        spout's own sampled context, or ``NOT_SAMPLED`` when its roll
        missed; a bolt's tuple takes its anchors' context. ``origins``: a
        spout's source-log positions; a bolt's tuple takes the fold of its
        anchors'. ``direct_task`` (normally through :meth:`emit_direct`)
        delivers only to direct-grouped consumers, at that task."""
        fields = self._out_fields.get(stream, ("message",))
        subs = self._rt.router.subscriptions(self.component_id, stream)

        ts = root_ts if root_ts is not None else time.perf_counter()
        roots: frozenset = frozenset()
        if anchors:
            anchor_list = list(anchors)
            roots = frozenset().union(*(a.anchors for a in anchor_list))
            if anchor_list and root_ts is None:
                ts = min(a.root_ts for a in anchor_list)
            if trace is None:
                # The trace follows anchoring, like root_ts; attribute
                # reads only, no allocation when nothing is sampled.
                for a in anchor_list:
                    if a.trace is not None:
                        trace = a.trace
                        break
            if origins is None and any(a.origins for a in anchor_list):
                # Provenance follows anchoring, folded to the largest
                # offset per (topic, partition): the transactional sink
                # commits only the maximum.
                acc: dict = {}
                for a in anchor_list:
                    merge_offsets(acc, (((src_t, src_p), off)
                                        for (src_t, src_p, off) in a.origins))
                origins = frozenset((src_t, src_p, off)
                                    for (src_t, src_p), off in acc.items())
        origin_set = origins if origins is not None else frozenset()

        probe = Tuple(values=list(values), fields=fields,
                      source_component=self.component_id,
                      source_task=self.task_index, stream=stream, root_ts=ts)
        deliveries: List[Any] = []
        for grouping, group in subs:
            if direct_task is not None:
                # emit_direct: only direct-grouped consumers, at the named
                # task; out of range is the producer's bug, not a wrap.
                if isinstance(grouping, DirectGrouping):
                    if not 0 <= direct_task < len(group.inboxes):
                        raise ValueError(
                            f"emit_direct task {direct_task} out of range "
                            f"for {len(group.inboxes)}-instance consumer")
                    deliveries.append(group.inboxes[direct_task])
            else:
                for idx in grouping.choose(probe):
                    deliveries.append(group.inboxes[idx])

        if msg_id is not None:
            if not deliveries:
                # No subscribers: complete immediately (Storm acks these).
                self._rt.spout_done(self.component_id, self.task_index, msg_id, True, ts)
                return 0
            root_id = new_id()
            self._rt.ledger.init_root(
                root_id, msg_id,
                self._rt.spout_done_cb(self.component_id, self.task_index), ts)
            roots = frozenset((root_id,))
            if trace is None and self._tracer is not None and self._tracer.active:
                # A spout that mints no context of its own (BrokerSpout
                # does, and passes NOT_SAMPLED on a miss): the root gets a
                # generic ingress span.
                trace = self._tracer.maybe_trace()
                if trace is not None:
                    self._tracer.record(trace, "ingress", self.component_id,
                                        ts, time.perf_counter())
        if trace is NOT_SAMPLED:
            trace = None

        # Anchor every new edge in the ledger BEFORE the first (possibly
        # yielding) queue put — otherwise a fast consumer could zero the
        # ledger while later deliveries of the same emit are still pending.
        edges = [new_id() for _ in deliveries]
        for edge in edges:
            for r in roots:
                self._rt.ledger.anchor(r, edge)
        for inbox, edge in zip(deliveries, edges):
            await inbox.put(Tuple(
                # Fresh list per delivery: fan-out targets never share one
                # mutable values object.
                values=list(probe.values), fields=fields,
                source_component=self.component_id,
                source_task=self.task_index, stream=stream, edge_id=edge,
                anchors=roots, root_ts=ts, origins=origin_set, trace=trace))
        n = len(deliveries)
        self._m_emitted.inc(n)
        if n and _copyledger.active():
            # Routing moves references, not payloads: bytes 0 is the
            # point of the row. Allocations: the probe tuple and one Tuple
            # (and values list) per delivery.
            _copyledger.record("tuple_route", 0, copies=0, allocs=n + 1,
                               records=n, engine=self.component_id)
        return n

    async def emit_direct(self, task: int, values: Sequence[Any], *,
                          stream: str = "default",
                          anchors: Optional[Iterable[Tuple]] = None,
                          msg_id: Any = None,
                          root_ts: Optional[float] = None) -> int:
        """Emit to task ``task`` of every direct-grouped subscriber
        (Storm's ``emitDirect``; consumers subscribe with
        ``direct_grouping``)."""
        return await self.emit(values, stream=stream, anchors=anchors, msg_id=msg_id,
                               root_ts=root_ts, direct_task=task)

    def ack(self, t: Tuple) -> None:
        """Mark the input tuple consumed."""
        for r in t.anchors:
            self._rt.ledger.ack_edge(r, t.edge_id)
        self._m_acked.inc()

    def fail(self, t: Tuple) -> None:
        """Fail the input tuple's roots -> spout replay."""
        for r in t.anchors:
            self._rt.ledger.fail_root(r)
        self._m_failed.inc()

    def report_error(self, err: BaseException) -> None:
        self._rt.report_error(self.component_id, self.task_index, err)

    @property
    def ledger(self):
        """The runtime's ack ledger, for the exactly-once sink's questions
        about a tree's shape (``outstanding``, ``watch``)."""
        return self._rt.ledger


class Component:
    """Shared declarations for spouts and bolts."""

    def declare_output_fields(self) -> Dict[str, Sequence[str]]:
        return {"default": ("message",)}


class Spout(Component):
    def open(self, context: TopologyContext, collector: OutputCollector) -> None:
        self.context = context
        self.collector = collector

    async def next_tuple(self) -> bool:
        """Emit zero or more tuples; return True if anything was emitted
        (False lets the executor back off briefly)."""
        raise NotImplementedError

    def ack(self, msg_id: Any) -> None:
        """Tuple tree for ``msg_id`` fully processed."""

    def fail(self, msg_id: Any) -> None:
        """Tuple tree failed or timed out; replayable spouts re-emit."""

    def close(self) -> None:
        pass

    async def activate(self) -> None:
        pass

    async def deactivate(self) -> None:
        pass


class Bolt(Component):
    def prepare(self, context: TopologyContext, collector: OutputCollector) -> None:
        """One-time init per executor. Heavy state belongs here, not in
        ``__init__``: the topology clones the instance per task."""
        self.context = context
        self.collector = collector

    async def execute(self, t: Tuple) -> None:
        raise NotImplementedError

    async def tick(self) -> None:
        """Periodic timer callback (tick tuples)."""

    async def flush(self) -> None:
        """Drain hook, awaited after the last tuple of a graceful stop."""

    def cleanup(self) -> None:
        """Graceful shutdown."""
