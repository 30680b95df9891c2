"""The JSON wire contract, copied from ``storm_tpu/api/schema.py`` (its
pure-Python paths): ``{"instances": ...}`` in, ``{"predictions": ...}`` out.

A malformed payload raises :class:`SchemaError`, which the inference
operator turns into a :class:`DeadLetter` record — never a silent
``null``.
"""

from __future__ import annotations

import json
from dataclasses import dataclass
from typing import Any

import numpy as np


class SchemaError(ValueError):
    """A payload that does not satisfy the wire contract."""


@dataclass(frozen=True)
class Instances:
    """Decoded input record: a batch of instances as one dense float32
    array of rank >= 2, axis 0 the batch axis."""

    data: np.ndarray
    # Arrival timestamp (perf_counter seconds).
    ts: float = 0.0


@dataclass(frozen=True)
class Predictions:
    """Decoded/encodable output record: ``(N, K)`` class scores."""

    data: np.ndarray


@dataclass(frozen=True)
class DeadLetter:
    """A poisoned input routed to the dead-letter stream."""

    payload: str
    error: str
    stage: str = "decode"

    def to_json(self) -> str:
        return json.dumps(
            {"error": self.error, "stage": self.stage, "payload": self.payload[:4096]})


def _to_dense_f32(obj: Any) -> np.ndarray:
    """Nested lists -> dense float32 ndarray, rejecting ragged/non-numeric."""
    try:
        return np.asarray(obj, dtype=np.float32)
    except (ValueError, TypeError) as e:
        raise SchemaError(f"instances is ragged or non-numeric: {e}") from e


def decode_instances(payload: str | bytes, *, ts: float = 0.0) -> Instances:
    """Parse a ``{"instances": [[[[...]]]]}`` JSON payload into a dense
    float32 array; raises :class:`SchemaError` on any contract violation."""
    if isinstance(payload, (bytes, bytearray, memoryview)):
        try:
            payload = bytes(payload).decode("utf-8")
        except UnicodeDecodeError as e:
            raise SchemaError(f"payload is not UTF-8: {e}") from e
    try:
        obj = json.loads(payload)
    except json.JSONDecodeError as e:
        raise SchemaError(f"payload is not valid JSON: {e}") from e
    if not isinstance(obj, dict) or "instances" not in obj:
        raise SchemaError('payload missing "instances" key')
    arr = _to_dense_f32(obj["instances"])
    if arr.ndim < 2:
        raise SchemaError(
            f"instances must have rank >= 2 (batch axis + features); got rank {arr.ndim}")
    if arr.shape[0] == 0:
        raise SchemaError("instances batch is empty")
    return Instances(data=arr, ts=ts)


def encode_predictions(preds: Predictions | np.ndarray) -> str:
    """Serialize predictions to the ``{"predictions": [[...]]}`` wire form."""
    arr = preds.data if isinstance(preds, Predictions) else np.asarray(preds)
    if arr.ndim == 1:
        arr = arr[None, :]
    return json.dumps({"predictions": arr.astype(np.float64).round(7).tolist()})


def decode_predictions(payload: str | bytes) -> Predictions:
    """Parse a ``{"predictions": ...}`` payload (tests and clients)."""
    if isinstance(payload, bytes):
        payload = payload.decode("utf-8")
    try:
        obj = json.loads(payload)
    except json.JSONDecodeError as e:
        raise SchemaError(f"payload is not valid JSON: {e}") from e
    if not isinstance(obj, dict) or "predictions" not in obj:
        raise SchemaError('payload missing "predictions" key')
    arr = _to_dense_f32(obj["predictions"])
    if arr.ndim == 1:
        arr = arr[None, :]
    return Predictions(data=arr)
