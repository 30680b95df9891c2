"""Arrow tensor marshalling, copied from ``storm_tpu/serve/marshal.py``.

:func:`encode_tensor` writes an array as one Arrow IPC tensor message with
the native marshaller (``storm_tpu_torch/native/arrow_tensor.cpp``), the
body written once with no element-wise conversion; :func:`decode_tensor`
returns an array viewing the received buffer's body, zero-copy. These are
the binary record plane's payloads: a record whose first byte is 0xFF is
such a message (:func:`storm_tpu_torch.api.schema.decode_instances`).

storm_tpu falls back to pyarrow where its native code declines a message
(other strides, rank 0 or above 8, a type it does not view). The port has
no pyarrow: its native decoder reads those layouts itself and gives the
array pyarrow gives; an element type numpy cannot view is refused with a
:class:`~storm_tpu_torch.api.schema.SchemaError` naming it.

With the copy ledger attached, each call records its row: the encode one
copy (two for a non-contiguous input, which is made contiguous first), the
decode zero bytes and zero copies, with ``records`` the batch axis.
"""

from __future__ import annotations

import numpy as np

from storm_tpu_torch import native
from storm_tpu_torch.api.schema import SchemaError
from storm_tpu_torch.obs import copyledger as _copyledger


def _records_of(arr: np.ndarray) -> int:
    """Batch-axis length as the ledger's record count (rank 0: 1)."""
    return int(arr.shape[0]) if arr.ndim else 1


def encode_tensor(x: np.ndarray) -> bytes:
    """Array -> Arrow IPC tensor message bytes."""
    c = np.ascontiguousarray(x)
    out = native.encode_tensor(c)
    _copyledger.record("marshal_encode", len(out), copies=1 if c is x else 2, allocs=1,
                       records=_records_of(c))
    return out


def decode_tensor(buf) -> np.ndarray:
    """Arrow IPC tensor message (``bytes`` or any buffer object) -> an
    array viewing its body; the view keeps ``buf`` alive. Raises
    ``ValueError`` on a malformed message, :class:`SchemaError` on a
    layout numpy cannot view."""
    try:
        arr = native.decode_tensor(buf)
    except native.TensorLayoutError as e:
        raise SchemaError(str(e)) from None
    # A view moves no bytes: the row's zeros say so, its records that the
    # hop ran. The measurement must not copy the buffer either.
    _copyledger.record("marshal_decode", 0, copies=0, allocs=0, records=_records_of(arr))
    return arr
