"""Egress sink (the KafkaBolt equivalent), copied from
``storm_tpu/connectors/sink.py`` without transactions.

Delivery modes: 'async' (send with a completion callback, ack on success,
report + fail on error), 'sync' (await, then ack/fail) and
'fire_and_forget' (send and ack at once). Records the end-to-end (broker
append -> delivered) latency histogram ``e2e_latency_ms``; for a tuple
that carries the QoS lane field (``qos_lane``), also its lane's
``e2e_latency_ms_<lane>``; and with ``config.tracing.slo_ms`` set, counts
each delivery slower than it in ``slo_breaches`` (the shed controller's
breach-rate signal) and records a throttled ``slo_breach`` flight event.
A sampled record's trace closes here: an ``egress`` span from the send's
start, the trace finished with the record's e2e ms, and its id the e2e
histogram's exemplar. A bytes value (what the inference operator emits
after raw-scheme ingress) is produced verbatim, with no ``sink_encode``
row; with the copy ledger attached, the str -> bytes encode of any other
value is its ``sink_encode`` row.
"""

from __future__ import annotations

import asyncio
import logging
import time
from typing import Optional

from storm_tpu_torch.config import SinkConfig
from storm_tpu_torch.connectors.memory import MemoryBroker
from storm_tpu_torch.obs import copyledger as _copyledger
from storm_tpu_torch.runtime.base import Bolt, OutputCollector, TopologyContext
from storm_tpu_torch.runtime.tuples import Tuple

log = logging.getLogger("storm_tpu_torch.sink")


class BrokerSink(Bolt):
    def __init__(self, broker: MemoryBroker, topic: str,
                 sink: Optional[SinkConfig] = None) -> None:
        self.broker = broker
        self.topic = topic
        self.sink_cfg = sink or SinkConfig()

    def clone(self) -> "BrokerSink":
        """Per-task instance sharing the broker handle."""
        return type(self)(self.broker, self.topic, self.sink_cfg)

    def prepare(self, context: TopologyContext, collector: OutputCollector) -> None:
        super().prepare(context, collector)
        # A sink re-encodes every record, so the ledger attaches here too.
        _copyledger.ensure_installed()
        self._inflight: set = set()
        m, cid = context.metrics, context.component_id
        self._latency = m.histogram(cid, "e2e_latency_ms")
        self._delivered = m.counter(cid, "delivered")
        tracing = getattr(context.config, "tracing", None)
        self._slo_ms = float(getattr(tracing, "slo_ms", 0.0) or 0.0)
        self._m_breach = m.counter(cid, "slo_breaches")
        # Per-lane e2e histograms, built the first time a lane arrives.
        self._lane_latency: dict = {}
        self._tracer = getattr(context, "tracer", None)
        self._flight = getattr(context, "flight", None)

    async def _send(self, t: Tuple) -> None:
        value = t.get("message")
        if isinstance(value, str):
            value = value.encode("utf-8")
            if _copyledger.active():
                _copyledger.record("sink_encode", len(value), copies=1, allocs=1,
                                   records=1, engine=self.context.component_id)
        elif not isinstance(value, (bytes, bytearray)):
            value = str(value).encode("utf-8")
            if _copyledger.active():
                _copyledger.record("sink_encode", len(value), copies=2, allocs=2,
                                   records=1, engine=self.context.component_id)
        key = t.get("key", None)
        self.broker.produce(self.topic, value, key)

    async def execute(self, t: Tuple) -> None:
        mode = self.sink_cfg.mode
        if mode == "fire_and_forget":
            self._spawn(self._send_quiet(t))
            self._ack_delivered(t)
        elif mode == "sync":
            await self._send_tracked(t)
        else:
            self._spawn(self._send_tracked(t))

    def _spawn(self, coro) -> None:
        task = asyncio.get_running_loop().create_task(coro)
        self._inflight.add(task)
        task.add_done_callback(self._inflight.discard)

    async def _send_quiet(self, t: Tuple) -> None:
        try:
            await self._send(t)
        except Exception as e:  # fire-and-forget: drop errors
            log.debug("fire-and-forget send failed: %s", e)

    async def _send_tracked(self, t: Tuple) -> None:
        t0 = time.perf_counter()
        try:
            await self._send(t)
        except Exception as e:
            self.collector.report_error(e)
            self.collector.fail(t)
            return
        self._ack_delivered(t, t0)

    def _ack_delivered(self, t: Tuple, t0: Optional[float] = None) -> None:
        """Delivery confirmed: count it, close its trace (the egress span
        from ``t0``, when the send started), check the SLO, ack."""
        self._delivered.inc()
        if t.root_ts:
            now = time.perf_counter()
            ms = (now - t.root_ts) * 1e3
            if t.trace is None:
                self._latency.observe(ms)
            else:
                self._latency.observe(ms, trace_id=t.trace.trace_id)
                if self._tracer is not None:
                    self._tracer.record(t.trace, "egress", self.context.component_id,
                                        t0 if t0 is not None else now, now,
                                        attrs={"e2e_ms": round(ms, 3)})
                    self._tracer.finish(t.trace, ms)
            lane = t.get("qos_lane", None) if "qos_lane" in t.fields else None
            if lane:
                h = self._lane_latency.get(lane)
                if h is None:
                    h = self._lane_latency[lane] = self.context.metrics.histogram(
                        self.context.component_id, f"e2e_latency_ms_{lane}")
                h.observe(ms)
            if self._slo_ms and ms > self._slo_ms:
                self._m_breach.inc()
                if self._flight is not None:
                    self._flight.event(
                        "slo_breach", throttle_s=1.0, component=self.context.component_id,
                        e2e_ms=round(ms, 3), slo_ms=self._slo_ms,
                        trace_id=t.trace.trace_id if t.trace is not None else None)
        self.collector.ack(t)

    async def flush(self) -> None:
        """Settle in-flight sends before shutdown."""
        while self._inflight:
            await asyncio.gather(*list(self._inflight), return_exceptions=True)
