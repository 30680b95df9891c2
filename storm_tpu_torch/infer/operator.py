"""The inference operator, the counterpart of ``storm_tpu/infer/operator.py``
without QoS, cascades, record frames, continuous batching and tracing.

Per tuple: decode the ``{"instances": ...}`` payload and check it against
the model's input shape — a failure emits a :class:`DeadLetter` on the
``dead_letter`` stream and acks (replaying poison can never succeed); feed
the micro-batcher; a full batch, or the deadline, dispatches to the shared
engine on a worker thread, so the event loop keeps consuming while the
card computes; when the batch returns, emit one ``{"predictions": ...}``
tuple per record, anchored to it, and ack. A failed batch fails every tuple
in it, which the spout replays.
"""

from __future__ import annotations

import asyncio
import time
from typing import Optional, Set

from storm_tpu_torch.api.schema import (
    DeadLetter, SchemaError, decode_instances, encode_predictions)
from storm_tpu_torch.config import BatchConfig, ModelConfig
from storm_tpu_torch.infer.batcher import Batch, MicroBatcher
from storm_tpu_torch.infer.engine import shared_engine
from storm_tpu_torch.runtime.base import Bolt, OutputCollector, TopologyContext
from storm_tpu_torch.runtime.tuples import Tuple, Values


class InferenceBolt(Bolt):
    """``device``: where the shared engine runs (default ``cuda``; pass
    ``"cpu"`` for the CPU)."""

    def __init__(self, model: Optional[ModelConfig] = None,
                 batch: Optional[BatchConfig] = None, device=None) -> None:
        self.model_cfg = model or ModelConfig()
        self.batch_cfg = batch or BatchConfig()
        self.device = device

    def clone(self) -> "InferenceBolt":
        return InferenceBolt(self.model_cfg, self.batch_cfg, self.device)

    def declare_output_fields(self):
        return {"default": ("message",), "dead_letter": ("message",)}

    def prepare(self, context: TopologyContext, collector: OutputCollector) -> None:
        super().prepare(context, collector)
        # One engine per model per process: the tasks share its weights.
        self.engine = shared_engine(self.model_cfg, self.batch_cfg, device=self.device)
        self.engine.warmup()
        self.batcher = MicroBatcher(self.batch_cfg)
        self._flush_task: Optional[asyncio.Task] = None
        self._inflight: Set[asyncio.Task] = set()
        self._dispatch_sem = asyncio.Semaphore(self.batch_cfg.max_inflight)
        m, cid = context.metrics, context.component_id
        self._m_batch = m.histogram(cid, "batch_size")
        self._m_device_ms = m.histogram(cid, "device_ms")
        self._m_dead = m.counter(cid, "dead_lettered")
        self._m_infer = m.counter(cid, "instances_inferred")

    async def execute(self, t: Tuple) -> None:
        payload = t.get("message")
        try:
            inst = decode_instances(payload, ts=t.root_ts)
            if tuple(inst.data.shape[1:]) != self.engine.input_shape:
                raise SchemaError(
                    f"instance shape {tuple(inst.data.shape[1:])} != model "
                    f"input {self.engine.input_shape}")
        except SchemaError as e:
            await self._dead_letter(t, payload, str(e))
            return
        batch = self.batcher.add(t, inst.data, ts=t.root_ts or None)
        while batch is not None:
            await self._dispatch(batch)
            batch = self.batcher.take_ready()
        self._kick_flush()

    async def _dead_letter(self, t: Tuple, payload, error: str) -> None:
        """Poison input: route to the dead-letter stream and ack."""
        self._m_dead.inc()
        if isinstance(payload, (bytes, bytearray)):
            payload = payload.decode("utf-8", "replace")
        dl = DeadLetter(payload=str(payload), error=error)
        await self.collector.emit(Values([dl.to_json()]), stream="dead_letter",
                                  anchors=[t])
        self.collector.ack(t)

    def _kick_flush(self) -> None:
        if len(self.batcher) and (self._flush_task is None or self._flush_task.done()):
            self._flush_task = asyncio.get_running_loop().create_task(
                self._deadline_flush())

    async def _deadline_flush(self) -> None:
        """Runs while records are pending; exits when the batcher drains
        (never cancelled mid-dispatch, which would drop the batch)."""
        while True:
            oldest = self.batcher.oldest_ts
            if oldest is None:
                return
            wait_s = self.batch_cfg.max_wait_ms / 1e3 - (time.perf_counter() - oldest)
            if wait_s > 0:
                await asyncio.sleep(wait_s)
            batch = self.batcher.take_if_due()
            while batch is not None:
                await self._dispatch(batch)
                batch = self.batcher.take_ready()

    async def _dispatch(self, batch: Batch) -> None:
        await self._dispatch_sem.acquire()
        task = asyncio.get_running_loop().create_task(self._run_batch(batch))
        self._inflight.add(task)
        task.add_done_callback(self._inflight.discard)

    async def _run_batch(self, batch: Batch) -> None:
        try:
            t0 = time.perf_counter()
            handle = await asyncio.to_thread(self.engine.dispatch, batch.parts())
            out = await asyncio.wrap_future(handle.future)
            self._m_device_ms.observe((time.perf_counter() - t0) * 1e3)
            self._m_batch.observe(batch.size)
            self._m_infer.inc(batch.size)
            for item, preds in batch.split(out):
                await self.collector.emit(Values([encode_predictions(preds)]),
                                          anchors=[item])
                self.collector.ack(item)
        except Exception as e:
            # Device failure: fail every tuple in the batch -> spout replay.
            self.collector.report_error(e)
            for item in batch.items:
                self.collector.fail(item.payload)
        finally:
            self._dispatch_sem.release()

    async def flush(self) -> None:
        """Drain: dispatch whatever is pending and wait for in-flight
        batches, so a graceful stop never strands acks."""
        batch = self.batcher.take_all()
        if batch is not None:
            await self._dispatch(batch)
        while self._inflight:
            await asyncio.gather(*list(self._inflight), return_exceptions=True)

    def cleanup(self) -> None:
        if self._flush_task is not None and not self._flush_task.done():
            self._flush_task.cancel()
        self._flush_task = None
