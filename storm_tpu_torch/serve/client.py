"""Client of the inference worker (``storm_tpu/serve/client.py``'s
counterpart), over the port's frames: a connection pool to one worker's
``storm_tpu.Inference`` service. A failed call raises
:class:`~storm_tpu_torch.resilience.RpcError` with the worker's status
code (``INVALID_ARGUMENT``, ``INTERNAL``, ``UNAVAILABLE``, ...)."""

from __future__ import annotations

import json
from typing import Optional

import numpy as np

from storm_tpu_torch.dist.transport import _Channel
from storm_tpu_torch.serve.marshal import decode_tensor, encode_tensor

_SERVICE = "storm_tpu.Inference"


class InferenceClient:
    def __init__(self, target: str = "localhost:50051") -> None:
        self._channel = _Channel(target, service=_SERVICE)

    def call(self, method: str, payload: bytes, timeout: Optional[float] = 60.0) -> bytes:
        """One raw call: ``method`` of the inference service, or a full
        ``/<service>/<method>`` path."""
        return self._channel.call(method, payload, timeout)

    def predict(self, x: np.ndarray, timeout: Optional[float] = 60.0) -> np.ndarray:
        """Arrow tensor round trip: an (N, ...) batch in, (N, K) scores out."""
        return decode_tensor(self.call("Predict", encode_tensor(x), timeout))

    def predict_json(self, payload: str | bytes, timeout: Optional[float] = 60.0) -> str:
        if isinstance(payload, str):
            payload = payload.encode("utf-8")
        return self.call("PredictJson", payload, timeout).decode("utf-8")

    def info(self, timeout: Optional[float] = 10.0) -> dict:
        return json.loads(self.call("Info", b"", timeout))

    def close(self) -> None:
        self._channel.close()

    def __enter__(self) -> "InferenceClient":
        return self

    def __exit__(self, *exc) -> None:
        self.close()
