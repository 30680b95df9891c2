"""Egress sink (the KafkaBolt equivalent), copied from
``storm_tpu/connectors/sink.py`` without transactions and tracing.

Delivery modes: 'async' (send with a completion callback, ack on success,
report + fail on error), 'sync' (await, then ack/fail) and
'fire_and_forget' (send and ack at once). Records the end-to-end (broker
append -> delivered) latency histogram ``e2e_latency_ms``; for a tuple
that carries the QoS lane field (``qos_lane``), also its lane's
``e2e_latency_ms_<lane>``; and with ``config.tracing.slo_ms`` set, counts
each delivery slower than it in ``slo_breaches`` (the shed controller's
breach-rate signal).
"""

from __future__ import annotations

import asyncio
import logging
import time
from typing import Optional

from storm_tpu_torch.config import SinkConfig
from storm_tpu_torch.connectors.memory import MemoryBroker
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
        self._inflight: set = set()
        m, cid = context.metrics, context.component_id
        self._latency = m.histogram(cid, "e2e_latency_ms")
        self._delivered = m.counter(cid, "delivered")
        tracing = getattr(context.config, "tracing", None)
        self._slo_ms = float(getattr(tracing, "slo_ms", 0.0) or 0.0)
        self._m_breach = m.counter(cid, "slo_breaches")
        # Per-lane e2e histograms, built the first time a lane arrives.
        self._lane_latency: dict = {}

    async def _send(self, t: Tuple) -> None:
        value = t.get("message")
        if isinstance(value, str):
            value = value.encode("utf-8")
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
        try:
            await self._send(t)
        except Exception as e:
            self.collector.report_error(e)
            self.collector.fail(t)
            return
        self._ack_delivered(t)

    def _ack_delivered(self, t: Tuple) -> None:
        self._delivered.inc()
        if t.root_ts:
            ms = (time.perf_counter() - t.root_ts) * 1e3
            self._latency.observe(ms)
            lane = t.get("qos_lane", None) if "qos_lane" in t.fields else None
            if lane:
                h = self._lane_latency.get(lane)
                if h is None:
                    h = self._lane_latency[lane] = self.context.metrics.histogram(
                        self.context.component_id, f"e2e_latency_ms_{lane}")
                h.observe(ms)
            if self._slo_ms and ms > self._slo_ms:
                self._m_breach.inc()
        self.collector.ack(t)

    async def flush(self) -> None:
        """Settle in-flight sends before shutdown."""
        while self._inflight:
            await asyncio.gather(*list(self._inflight), return_exceptions=True)
