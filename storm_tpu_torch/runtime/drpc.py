"""Distributed RPC, copied from ``storm_tpu/runtime/drpc.py``: synchronous
request and response through a topology (Storm's DRPC).

- :class:`DRPCServer` brokers requests: hands them to spouts, holds one
  future per request, resolves it on a result, a failure or a timeout.
- :class:`DRPCSpout` emits ``(message, request_id)`` for one function; a
  failed or timed-out tree fails the request.
- :class:`ReturnResultsBolt` delivers a result (its first field) to the
  waiting future by ``request_id``.
- :class:`ReturnErrorBolt` fails the future with an error stream's payload
  (e.g. the inference operator's ``dead_letter``), so a poison call fails
  with the schema error instead of timing out.
- :func:`drpc_inference_topology`: DRPC spout -> InferenceBolt -> return
  bolts, a synchronous path into the served model through the same
  runtime (request ids ride the operator's ``passthrough`` fields).

The server lives on the cluster's event loop.
"""

from __future__ import annotations

import asyncio
from typing import Any, Dict, Optional, Tuple as Tup

from storm_tpu_torch.runtime.base import Bolt, OutputCollector, Spout, TopologyContext
from storm_tpu_torch.runtime.tuples import Tuple, Values, new_id


class DRPCError(RuntimeError):
    """Request failed inside the topology (Storm's DRPCExecutionException)."""


class DRPCTimeout(DRPCError):
    """No result within the client's deadline."""


class DRPCUnknownFunction(DRPCError):
    """No spout has registered the requested function."""


class DRPCServer:
    """Request broker between callers and DRPC spouts.

    One instance is shared by the caller side (``execute``) and the
    topology side (spouts/return bolts reference it; their ``clone()``
    shares rather than deep-copies it, like connectors share a broker).
    """

    def __init__(self) -> None:
        self._queues: Dict[str, asyncio.Queue] = {}
        self._pending: Dict[str, asyncio.Future] = {}

    # ---- caller side ---------------------------------------------------------

    async def execute(self, function: str, args: str,
                      timeout_s: float = 30.0) -> str:
        """Run ``function`` on ``args`` through the topology; return the
        result. Raises :class:`DRPCTimeout` / :class:`DRPCError`."""
        queue = self._queues.get(function)
        if queue is None:
            # Only spout-registered functions accept work: enqueueing for an
            # unknown name would leak the payload forever (nothing consumes
            # the queue) and turn typos into silent timeouts.
            raise DRPCUnknownFunction(
                f"no spout registered for drpc function {function!r} "
                f"(registered: {sorted(self._queues)})"
            )
        rid = new_id()
        fut = asyncio.get_running_loop().create_future()
        self._pending[rid] = fut
        await queue.put((args, rid))
        try:
            return await asyncio.wait_for(fut, timeout_s)
        except asyncio.TimeoutError:
            raise DRPCTimeout(
                f"drpc {function!r} gave no result in {timeout_s}s"
            ) from None
        finally:
            self._pending.pop(rid, None)

    # ---- topology side -------------------------------------------------------

    def queue_for(self, function: str) -> asyncio.Queue:
        return self._queues.setdefault(function, asyncio.Queue())

    def result(self, request_id: str, value: Any) -> None:
        fut = self._pending.get(request_id)
        if fut is not None and not fut.done():
            fut.set_result(value)

    def fail(self, request_id: str, error: str) -> None:
        fut = self._pending.get(request_id)
        if fut is not None and not fut.done():
            fut.set_exception(DRPCError(error))

    def fail_all(self, error: str) -> None:
        """Fail every in-flight request (the serving topology died); call
        when killing a topology so blocked callers error immediately instead
        of waiting out their timeouts."""
        for fut in list(self._pending.values()):
            if not fut.done():
                fut.set_exception(DRPCError(error))

    @property
    def inflight(self) -> int:
        return len(self._pending)


class DRPCSpout(Spout):
    """Feeds one function's requests into the topology.

    Output fields are ``(message, request_id)`` so downstream operators
    that read ``message`` (e.g. InferenceBolt) work unmodified; the id
    rides alongside (declare it in the operator's ``passthrough``)."""

    def __init__(self, server: DRPCServer, function: str = "predict") -> None:
        self.server = server
        self.function = function

    def clone(self) -> "DRPCSpout":
        return DRPCSpout(self.server, self.function)

    def declare_output_fields(self):
        return {"default": ("message", "request_id")}

    def open(self, context: TopologyContext, collector: OutputCollector) -> None:
        super().open(context, collector)
        self._queue = self.server.queue_for(self.function)

    async def next_tuple(self) -> bool:
        try:
            args, rid = self._queue.get_nowait()
        except asyncio.QueueEmpty:
            return False
        await self.collector.emit(Values([args, rid]), msg_id=rid)
        return True

    def ack(self, msg_id: Any) -> None:
        pass  # result delivery happened via ReturnResultsBolt

    def fail(self, msg_id: Any) -> None:
        # Tuple-tree failure/timeout inside the topology: surface to the
        # caller immediately rather than letting the client deadline burn.
        self.server.fail(msg_id, "request failed in topology (replay exhausted)")


class ReturnResultsBolt(Bolt):
    """Terminal bolt: first value is the result, routed by ``request_id``."""

    def __init__(self, server: DRPCServer) -> None:
        self.server = server

    def clone(self) -> "ReturnResultsBolt":
        return ReturnResultsBolt(self.server)

    async def execute(self, t: Tuple) -> None:
        self.server.result(t.get("request_id"), t.values[0])
        self.collector.ack(t)


class ReturnErrorBolt(Bolt):
    """Terminal bolt for error streams: fails the request future."""

    def __init__(self, server: DRPCServer) -> None:
        self.server = server

    def clone(self) -> "ReturnErrorBolt":
        return ReturnErrorBolt(self.server)

    async def execute(self, t: Tuple) -> None:
        self.server.fail(t.get("request_id"), str(t.values[0]))
        self.collector.ack(t)


def drpc_inference_topology(
    server: DRPCServer,
    model_cfg=None,
    batch_cfg=None,
    device=None,
    function: str = "predict",
    spout_parallelism: int = 1,
    infer_parallelism: int = 2,
    warmup: bool = True,
):
    """DRPC spout -> InferenceBolt -> return-results/err wiring.

    The synchronous serving path through the streaming runtime: callers
    ``await server.execute(function, instances_json)`` and get the
    ``{"predictions": ...}`` JSON back; poison input fails the call with
    the schema error instead of timing out. ``device``: where the model
    runs (default ``cuda``; pass ``"cpu"`` for the CPU)."""
    from storm_tpu_torch.infer import InferenceBolt
    from storm_tpu_torch.runtime.topology import TopologyBuilder

    tb = TopologyBuilder()
    tb.set_spout("drpc-spout", DRPCSpout(server, function),
                 parallelism=spout_parallelism)
    tb.set_bolt(
        "inference-bolt",
        InferenceBolt(model_cfg, batch_cfg, device=device, warmup=warmup,
                      passthrough=("request_id",)),
        parallelism=infer_parallelism,
    ).shuffle_grouping("drpc-spout")
    tb.set_bolt("drpc-return", ReturnResultsBolt(server), parallelism=1)\
        .shuffle_grouping("inference-bolt")
    tb.set_bolt("drpc-error", ReturnErrorBolt(server), parallelism=1)\
        .shuffle_grouping("inference-bolt", stream="dead_letter")
    return tb.build()
