"""The wire contract, copied from ``storm_tpu/api/schema.py``:
``{"instances": ...}`` or an Arrow tensor message in, ``{"predictions":
...}`` out.

:func:`decode_instances` reads a record whose first byte is 0xFF as an
Arrow IPC tensor message (the continuation marker every encapsulated
Arrow message leads with; no JSON document starts with 0xFF) and returns
a zero-copy view of its body (``Instances.view``); any other record is
JSON, parsed by the native codec (``storm_tpu_torch/native``, the C++ of
storm_tpu's ``fastjson.cpp``), so records parse to the reference's floats.
:func:`encode_predictions` writes the reference's bytes. The pure-Python
JSON codec stays beside them as :func:`decode_instances_reference` and
:func:`encode_predictions_reference`, the version the tests hold the
native one to; the serving path does not call it.

A malformed payload raises :class:`SchemaError`, with storm_tpu's text,
which the inference operator turns into a :class:`DeadLetter` record —
never a silent ``null``. A record shed under overload is answered with an
:class:`Overloaded` record.
"""

from __future__ import annotations

import json
from dataclasses import dataclass
from typing import Any

import numpy as np

from storm_tpu_torch import native


class SchemaError(ValueError):
    """A payload that does not satisfy the wire contract."""


@dataclass(frozen=True)
class Instances:
    """Decoded input record: a batch of instances as one dense float32
    array of rank >= 2, axis 0 the batch axis."""

    data: np.ndarray
    # Arrival timestamp (perf_counter seconds).
    ts: float = 0.0
    # True when ``data`` views the payload's buffer (an Arrow tensor
    # record): the decode wrote nothing, and the ledger's row says so.
    view: bool = False

    @property
    def batch_size(self) -> int:
        return int(self.data.shape[0])


@dataclass(frozen=True)
class Predictions:
    """Decoded/encodable output record: ``(N, K)`` class scores."""

    data: np.ndarray

    @property
    def batch_size(self) -> int:
        return int(self.data.shape[0])


@dataclass(frozen=True)
class DeadLetter:
    """A poisoned input routed to the dead-letter stream."""

    payload: str
    error: str
    stage: str = "decode"

    def to_json(self) -> str:
        return json.dumps(
            {"error": self.error, "stage": self.stage, "payload": self.payload[:4096]})


@dataclass(frozen=True)
class Overloaded:
    """The typed rejection the inference operator emits for a record that
    load shedding drops (QoS): an immediate, parseable answer instead of a
    timeout, told apart from a :class:`DeadLetter` and from predictions by
    its ``"overloaded"`` key. Its JSON is storm_tpu's, byte for byte."""

    lane: str = ""
    tenant: str = ""
    shed_level: int = 0

    def to_json(self) -> str:
        return json.dumps({
            "overloaded": True,
            "lane": self.lane,
            "tenant": self.tenant,
            "shed_level": self.shed_level,
        })


def _to_dense_f32(obj: Any) -> np.ndarray:
    """Nested lists -> dense float32 ndarray, rejecting ragged/non-numeric."""
    try:
        return np.asarray(obj, dtype=np.float32)
    except (ValueError, TypeError) as e:
        raise SchemaError(f"instances is ragged or non-numeric: {e}") from e


def _check_batch(arr: np.ndarray) -> None:
    if arr.ndim < 2:
        raise SchemaError(
            f"instances must have rank >= 2 (batch axis + features); got rank {arr.ndim}")
    if arr.shape[0] == 0:
        raise SchemaError("instances batch is empty")


def decode_instances(payload: str | bytes | bytearray | memoryview, *,
                     ts: float = 0.0) -> Instances:
    """A record -> its instances as an array of rank >= 2, axis 0 the
    batch axis; raises :class:`SchemaError`, with storm_tpu's message, on
    any contract violation.

    A bytes-like record led by 0xFF is an Arrow tensor message: the result
    views its body (float32 kept as is, another element type cast to
    float32, which copies). Any other record is ``{"instances":
    [[[[...]]]]}`` JSON, parsed by the native parser into a fresh float32
    array; the parser takes one contiguous ``bytes``, so a ``str`` is
    encoded and any other buffer (a frame's ``memoryview`` record)
    copied once."""
    if isinstance(payload, (bytes, bytearray, memoryview)) and len(payload) >= 1 \
            and payload[0] == 0xFF:
        # Imported here: marshal imports this module's SchemaError.
        from storm_tpu_torch.serve.marshal import decode_tensor

        try:
            arr = decode_tensor(payload)
        except Exception as e:
            raise SchemaError(f"payload is not a valid tensor frame: {e}") from e
        view = True
        if arr.dtype != np.float32:
            arr = arr.astype(np.float32)
            view = False
        _check_batch(arr)
        return Instances(data=arr, ts=ts, view=view)
    if isinstance(payload, str):
        try:
            payload = payload.encode("utf-8")
        except UnicodeEncodeError as e:
            raise SchemaError(f"payload is not UTF-8: {e}") from e
    elif not isinstance(payload, bytes):
        payload = bytes(payload)
    try:
        arr = native.parse_instances(payload)
    except native.ParseError as e:
        raise SchemaError(str(e)) from None
    _check_batch(arr)
    return Instances(data=arr, ts=ts)


def encode_predictions(preds: Predictions | np.ndarray) -> str:
    """Serialize predictions to the ``{"predictions": [[...]]}`` wire form
    with the native writer (float32 values rounded to 7 decimals, each in
    its shortest round-trip form)."""
    arr = preds.data if isinstance(preds, Predictions) else np.asarray(preds)
    return native.format_predictions(arr)


def decode_instances_reference(payload: str | bytes, *, ts: float = 0.0) -> Instances:
    """The pure-Python :func:`decode_instances` (``json`` and nested lists):
    the version the native parser is held to."""
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
    _check_batch(arr)
    return Instances(data=arr, ts=ts)


def encode_predictions_reference(preds: Predictions | np.ndarray) -> str:
    """The pure-Python :func:`encode_predictions` (``json.dumps`` of the
    float64 values rounded to 7 decimals)."""
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
