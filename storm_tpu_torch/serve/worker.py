"""The inference worker, the counterpart of ``storm_tpu/serve/worker.py``: a
service a front end (another topology's :class:`RemoteInferenceBolt`, or
any client of the port's frames) sends batches to, keeping tuple-ack
semantics on the caller's side.

The service ``storm_tpu.Inference`` rides the port's stdlib frames
(:mod:`storm_tpu_torch.dist.transport`), as the Dist service does, not
gRPC; its methods are storm_tpu's:

- ``Predict``: an Arrow IPC tensor (N, ...) in, an Arrow IPC tensor (N, K)
  out (:mod:`storm_tpu_torch.serve.marshal`; the request decodes as a view
  of the received frame);
- ``PredictJson``: the ``{"instances": ...}`` -> ``{"predictions": ...}``
  contract;
- ``Info``: model metadata as JSON, storm_tpu's keys (``model``,
  ``input_shape``, ``num_classes``, ``dtype``, ``mesh``, ``buckets``),
  ``mesh`` the engine's mesh shape.

Status codes as storm_tpu's: a malformed tensor, a wrong instance shape or
bad JSON is ``INVALID_ARGUMENT``; an engine failure is ``INTERNAL``; a
method the service lacks (a Dist method, say) is ``UNIMPLEMENTED``. A gRPC
client cannot call this worker; the Arrow payloads are the same bytes.

The engine is the process's shared one (``device`` as every entry point:
the card unless ``"cpu"`` is asked for). The frame server runs one thread
a connection (storm_tpu's gRPC server a pool of ``max_workers``, which
the port does not take). ``cross_batch_ms > 0`` coalesces
concurrent calls (:class:`~storm_tpu_torch.serve.batcher.CrossCallerBatcher`);
``batch.continuous`` sends them to the engine's continuous queue instead.
"""

from __future__ import annotations

import json
import logging
import threading
from typing import Optional

import numpy as np

from storm_tpu_torch.api.schema import SchemaError, decode_instances, encode_predictions
from storm_tpu_torch.config import BatchConfig, ModelConfig, ShardingConfig
from storm_tpu_torch.dist.transport import TransportServer
from storm_tpu_torch.resilience.retry import StatusCode
from storm_tpu_torch.serve.marshal import decode_tensor, encode_tensor

log = logging.getLogger("storm_tpu_torch.serve")

SERVICE = "storm_tpu.Inference"


class _Handler:
    """The inference service's method table for the frame server."""

    name = SERVICE

    def __init__(self, worker: "InferenceWorker") -> None:
        self._methods = {"Predict": worker._predict, "PredictJson": worker._predict_json,
                         "Info": worker._info}

    def service(self, method: str):
        return self._methods.get(method)


class InferenceWorker:
    def __init__(
        self,
        model: Optional[ModelConfig] = None,
        sharding: Optional[ShardingConfig] = None,
        batch: Optional[BatchConfig] = None,
        engine=None,
        port: int = 50051,
        cross_batch_ms: float = 0.0,
        device=None,
        host: str = "0.0.0.0",
    ) -> None:
        from storm_tpu_torch.infer.engine import shared_engine

        self.model_cfg = model or ModelConfig()
        bc = batch or BatchConfig()
        self.engine = engine or shared_engine(self.model_cfg, bc, device=device,
                                              sharding_cfg=sharding or ShardingConfig())
        self._batcher = None
        if bc.continuous:
            from storm_tpu_torch.serve.batcher import CrossCallerBatcher

            self._batcher = CrossCallerBatcher(self.engine, continuous=True, batch_cfg=bc)
        elif cross_batch_ms > 0:
            from storm_tpu_torch.serve.batcher import CrossCallerBatcher

            self._batcher = CrossCallerBatcher(self.engine, window_ms=cross_batch_ms)
        self._server = TransportServer(_Handler(self), port=port, host=host)
        self.port = self._server.port
        self._stopped = threading.Event()

    # ---- methods -------------------------------------------------------------

    def _predict(self, request, context) -> bytes:
        try:
            x = decode_tensor(request)
        except Exception as e:
            context.abort(StatusCode.INVALID_ARGUMENT, f"bad tensor: {e}")
        if tuple(x.shape[1:]) != tuple(self.engine.input_shape):
            context.abort(StatusCode.INVALID_ARGUMENT,
                          f"instance shape {tuple(x.shape[1:])} != model input "
                          f"{tuple(self.engine.input_shape)}")
        try:
            # The view sits where the frame put it: copied only when its
            # dtype is not float32 or its body is not aligned.
            out = self._run_predict(np.require(x, np.float32, ["C", "A"]))
        except Exception as e:
            log.exception("predict failed")
            context.abort(StatusCode.INTERNAL, str(e))
        return encode_tensor(out)

    def _run_predict(self, x: np.ndarray) -> np.ndarray:
        if self._batcher is not None:
            return self._batcher.predict(x)
        return self.engine.predict(x)

    def _predict_json(self, request, context) -> bytes:
        try:
            inst = decode_instances(request)
            if tuple(inst.data.shape[1:]) != tuple(self.engine.input_shape):
                raise SchemaError(
                    f"instance shape {tuple(inst.data.shape[1:])} != model "
                    f"input {tuple(self.engine.input_shape)}")
        except SchemaError as e:
            context.abort(StatusCode.INVALID_ARGUMENT, str(e))
        try:
            out = self._run_predict(inst.data)
        except Exception as e:
            log.exception("predict failed")
            context.abort(StatusCode.INTERNAL, str(e))
        return encode_predictions(out).encode("utf-8")

    def _info(self, request, context) -> bytes:
        mesh = getattr(self.engine, "mesh", None)
        return json.dumps({
            "model": self.model_cfg.name,
            "input_shape": list(self.engine.input_shape),
            "num_classes": self.model_cfg.num_classes,
            "dtype": self.model_cfg.dtype,
            "mesh": dict(mesh.shape) if mesh is not None else {},
            "buckets": list(self.engine.batch_cfg.buckets),
        }).encode("utf-8")

    # ---- lifecycle -----------------------------------------------------------

    def start(self) -> "InferenceWorker":
        self._server.start()
        log.info("inference worker on port %d (model=%s)", self.port, self.model_cfg.name)
        return self

    def stop(self) -> None:
        """Close the listening socket and every connection."""
        self._server.stop()
        self._stopped.set()

    def wait(self) -> None:
        """Block until :meth:`stop`."""
        self._stopped.wait()
