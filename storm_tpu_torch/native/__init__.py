"""The native host codec: ``fastjson.cpp``, ``arrow_tensor.cpp`` and
``crc32c.cpp`` through ctypes.

The counterpart of ``storm_tpu/native/__init__.py`` for the JSON wire and
the Arrow tensor wire: :func:`parse_instances` turns an
``{"instances": ...}`` payload into one float32 array,
:func:`format_predictions` writes an (N, K) array as
``{"predictions": [[...]]}``, :func:`encode_tensor` writes an array as an
Arrow IPC tensor message and :func:`decode_tensor` views one as an array
without copying its body. Both sources are compiled by ``g++`` at first
use into one library under ``build/storm_tpu_torch/`` at the repository
root, cached by a hash of the sources and the flags (as ``ops/_build.py``
caches the CUDA kernels), and loaded with :mod:`ctypes`. Nothing is built
when the module is imported.

There is no fallback: a failed build or load raises. The pure-Python JSON
codec stays in ``storm_tpu_torch/api/schema.py`` as the reference the
tests hold this one to. Where storm_tpu hands a tensor message to pyarrow
(a layout its raw view declines), the port reads it with its own
``stpu_tensor_decode_layout`` and gives the array pyarrow gives; an
element type numpy cannot view is refused (:class:`TensorLayoutError`).
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path

import numpy as np

SOURCES = tuple(Path(__file__).resolve().parent / f
                for f in ("fastjson.cpp", "arrow_tensor.cpp", "crc32c.cpp"))
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "storm_tpu_torch"
CXX_FLAGS = ("-O3", "-std=c++17", "-shared", "-fPIC")
MAX_RANK = 8
# The tensor decoder's shape buffer: arrow_tensor.cpp's kMaxRank.
TENSOR_MAX_RANK = 32

_lib = None
_lib_lock = threading.Lock()
# Per-thread ctypes out-params of the parser, reused call to call
# (allocating them per call shows in a per-record profile).
_tls = threading.local()


class ParseError(ValueError):
    """A payload the parser refused; the message is the parser's own."""


class TensorLayoutError(ValueError):
    """A valid Arrow tensor message whose layout the port cannot view: an
    element type numpy has no dtype for, a rank above 32, or a negative
    stride. The message names the layout."""


def library_path() -> Path:
    h = hashlib.sha256()
    for src in SOURCES:
        h.update(src.name.encode())
        h.update(src.read_bytes())
    h.update(" ".join(CXX_FLAGS).encode())
    return BUILD_DIR / f"libstpu_native-{h.hexdigest()[:16]}.so"


def _build(lib: Path) -> None:
    cxx = shutil.which("g++")
    if cxx is None:
        raise RuntimeError("g++ not found on PATH; storm_tpu_torch builds its codec "
                           "(native/fastjson.cpp, native/arrow_tensor.cpp, native/crc32c.cpp) "
                           "from source "
                           "at first use")
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    # Build into a private name, then rename: a concurrent build in another
    # process never loads a half-written library.
    tmp = lib.with_suffix(f".{os.getpid()}.{threading.get_ident()}.tmp")
    proc = subprocess.run([cxx, *CXX_FLAGS, "-o", str(tmp), *map(str, SOURCES)],
                          capture_output=True, text=True, timeout=300)
    if proc.returncode != 0:
        raise RuntimeError(f"g++ failed for {', '.join(s.name for s in SOURCES)} "
                           f"(exit {proc.returncode}):\n"
                           f"{proc.stdout}{proc.stderr}")
    os.replace(tmp, lib)


def load() -> ctypes.CDLL:
    """The codec's library, built on first use; raises if it cannot be
    built or loaded."""
    global _lib
    if _lib is not None:
        return _lib
    with _lib_lock:
        if _lib is None:
            path = library_path()
            if not path.exists():
                _build(path)
            lib = ctypes.CDLL(str(path))
            lib.stpu_parse_instances.restype = ctypes.c_void_p
            lib.stpu_parse_instances.argtypes = [
                ctypes.c_char_p, ctypes.c_size_t,
                ctypes.POINTER(ctypes.c_int64),   # out shape[MAX_RANK]
                ctypes.POINTER(ctypes.c_int32),   # out rank
                ctypes.POINTER(ctypes.c_char_p),  # out error message
            ]
            lib.stpu_format_predictions.restype = ctypes.c_void_p
            lib.stpu_format_predictions.argtypes = [
                ctypes.c_void_p, ctypes.c_int64, ctypes.c_int64,
                ctypes.POINTER(ctypes.c_size_t),  # out length
            ]
            lib.stpu_free.restype = None
            lib.stpu_free.argtypes = [ctypes.c_void_p]
            lib.stpu_tensor_encode.restype = ctypes.c_void_p
            lib.stpu_tensor_encode.argtypes = [
                ctypes.c_void_p, ctypes.c_int, ctypes.c_int,  # data, dtype code, ndim
                ctypes.POINTER(ctypes.c_int64),               # shape
                ctypes.POINTER(ctypes.c_size_t),              # out length
            ]
            size_p = ctypes.POINTER(ctypes.c_size_t)
            int_p, i64_p = ctypes.POINTER(ctypes.c_int), ctypes.POINTER(ctypes.c_int64)
            lib.stpu_tensor_decode.restype = ctypes.c_int
            lib.stpu_tensor_decode.argtypes = [
                ctypes.c_void_p, ctypes.c_size_t,  # buffer address (kept alive by the caller)
                int_p, int_p, i64_p,               # out dtype, ndim, shape[8]
                size_p, size_p,                    # out body offset, body length
            ]
            lib.stpu_tensor_decode_layout.restype = ctypes.c_int
            lib.stpu_tensor_decode_layout.argtypes = [
                ctypes.c_void_p, ctypes.c_size_t,
                int_p, int_p, i64_p, i64_p,        # out dtype, ndim, shape, strides
                size_p, size_p,                    # out data offset, data span
                int_p, int_p,                      # out Arrow type id, Int bit width
            ]
            lib.stpu_crc32c.restype = ctypes.c_uint32
            lib.stpu_crc32c.argtypes = [ctypes.c_char_p, ctypes.c_size_t, ctypes.c_uint32]
            _lib = lib
    return _lib


def parse_instances(payload: bytes) -> np.ndarray:
    """One ``{"instances": ...}`` payload (contiguous ``bytes``) -> a
    float32 array of the nested list's shape. Raises :class:`ParseError`
    with the parser's message on a payload it refuses."""
    lib = load()
    try:
        shape, rank, rank_ref, err, err_ref = _tls.bufs
    except AttributeError:
        shape = (ctypes.c_int64 * MAX_RANK)()
        rank = ctypes.c_int32(0)
        err = ctypes.c_char_p(None)
        _tls.bufs = (shape, rank, ctypes.byref(rank), err, ctypes.byref(err))
        shape, rank, rank_ref, err, err_ref = _tls.bufs
    err.value = None
    ptr = lib.stpu_parse_instances(payload, len(payload), shape, rank_ref, err_ref)
    if not ptr:
        raise ParseError(err.value.decode("utf-8", "replace") if err.value
                         else "native parse failed")
    shp = tuple(int(shape[i]) for i in range(rank.value))
    out = np.empty(shp, np.float32)
    ctypes.memmove(out.ctypes.data, ptr, out.nbytes)
    lib.stpu_free(ptr)
    return out


def format_predictions(arr: np.ndarray) -> str:
    """An (N, K) (or (K,)) array -> ``{"predictions": [[...]]}``: each
    value as float32, rounded to 7 decimals and printed in its shortest
    round-trip form (``NaN``/``Infinity`` as Python's ``json`` writes
    them)."""
    a = np.ascontiguousarray(arr, dtype=np.float32)
    if a.ndim == 1:
        a = a[None, :]
    if a.ndim != 2:
        raise ValueError(f"predictions must be (N, K), got shape {a.shape}")
    lib = load()
    length = ctypes.c_size_t(0)
    ptr = lib.stpu_format_predictions(a.ctypes.data, a.shape[0], a.shape[1],
                                      ctypes.byref(length))
    if not ptr:
        raise MemoryError("stpu_format_predictions could not allocate its output")
    s = ctypes.string_at(ptr, length.value).decode("ascii")
    lib.stpu_free(ptr)
    return s


# Dtype codes shared with arrow_tensor.cpp (enum DType), storm_tpu's.
_DTYPE_TO_CODE = {
    np.dtype(np.float32): 0,
    np.dtype(np.float64): 1,
    np.dtype(np.float16): 2,
    np.dtype(np.uint8): 3,
    np.dtype(np.int8): 4,
    np.dtype(np.uint16): 5,
    np.dtype(np.int16): 6,
    np.dtype(np.uint32): 7,
    np.dtype(np.int32): 8,
    np.dtype(np.uint64): 9,
    np.dtype(np.int64): 10,
}
_CODE_TO_DTYPE = {v: k for k, v in _DTYPE_TO_CODE.items()}
# stpu_tensor_decode's "valid Arrow, not viewable raw"
_RC_UNSUPPORTED = 100
# Arrow's Type union ids (format/Schema.fbs), to name a refused element type.
_ARROW_TYPES = {0: "NONE", 1: "Null", 2: "Int", 3: "FloatingPoint", 4: "Binary",
                5: "Utf8", 6: "Bool", 7: "Decimal", 8: "Date", 9: "Time",
                10: "Timestamp", 11: "Interval", 12: "List", 13: "Struct_",
                14: "Union", 15: "FixedSizeBinary", 16: "FixedSizeList", 17: "Map",
                18: "Duration", 19: "LargeBinary", 20: "LargeUtf8", 21: "LargeList"}


def encode_tensor(x: np.ndarray) -> bytes:
    """A C-contiguous array -> one Arrow IPC tensor message (pyarrow's
    ``write_tensor`` bytes). A bool array is written as pyarrow writes
    it, as uint8; a dtype Arrow tensors do not take raises
    ``NotImplementedError`` with pyarrow's text."""
    if x.dtype == np.bool_:
        x = x.view(np.uint8)
    code = _DTYPE_TO_CODE.get(x.dtype)
    if code is None:
        raise NotImplementedError(f"Unsupported numpy type {x.dtype.num}")
    if not 1 <= x.ndim <= TENSOR_MAX_RANK:
        raise ValueError(f"tensor rank {x.ndim} outside 1..{TENSOR_MAX_RANK}")
    if not x.flags.c_contiguous:
        raise ValueError("encode_tensor takes a C-contiguous array")
    lib = load()
    shape = (ctypes.c_int64 * TENSOR_MAX_RANK)(*x.shape)
    length = ctypes.c_size_t(0)
    ptr = lib.stpu_tensor_encode(x.ctypes.data, code, x.ndim, shape, ctypes.byref(length))
    if not ptr:
        raise MemoryError("stpu_tensor_encode could not allocate its output")
    out = ctypes.string_at(ptr, length.value)
    lib.stpu_free(ptr)
    return out


def decode_tensor(buf) -> np.ndarray:
    """One Arrow IPC tensor message (``bytes`` or any buffer object) -> an
    array viewing its body, zero-copy: the array's base chain keeps
    ``buf`` alive. A C-contiguous body is read by ``stpu_tensor_decode``
    (storm_tpu's code); what that declines (other strides, rank 0 or
    above 8) by ``stpu_tensor_decode_layout``, with the strides the
    message states, as pyarrow's ``Tensor.to_numpy`` views it. Raises
    ``ValueError`` with storm_tpu's text on a malformed message and
    :class:`TensorLayoutError` on a layout numpy cannot view."""
    lib = load()
    raw = np.frombuffer(buf, dtype=np.uint8)
    dtype, ndim = ctypes.c_int(0), ctypes.c_int(0)
    shape = (ctypes.c_int64 * TENSOR_MAX_RANK)()
    off, size = ctypes.c_size_t(0), ctypes.c_size_t(0)
    rc = lib.stpu_tensor_decode(raw.ctypes.data, raw.size, ctypes.byref(dtype),
                                ctypes.byref(ndim), shape, ctypes.byref(off),
                                ctypes.byref(size))
    if rc == 0:
        view = raw[off.value: off.value + size.value]
        return view.view(_CODE_TO_DTYPE[dtype.value]).reshape(
            tuple(shape[i] for i in range(ndim.value)))
    if rc != _RC_UNSUPPORTED:
        raise ValueError(f"malformed Arrow tensor message (native rc={rc})")
    strides = (ctypes.c_int64 * TENSOR_MAX_RANK)()
    type_id, bits = ctypes.c_int(0), ctypes.c_int(0)
    rc = lib.stpu_tensor_decode_layout(
        raw.ctypes.data, raw.size, ctypes.byref(dtype), ctypes.byref(ndim), shape,
        strides, ctypes.byref(off), ctypes.byref(size), ctypes.byref(type_id),
        ctypes.byref(bits))
    if rc == _RC_UNSUPPORTED:
        name = _ARROW_TYPES.get(type_id.value, f"type id {type_id.value}")
        if type_id.value == 2:
            name = f"Int(bitWidth={bits.value})"
        raise TensorLayoutError(f"Arrow tensor of element type {name}: no numpy "
                                "dtype views it")
    if rc == 101:
        raise TensorLayoutError(f"Arrow tensor of rank above {TENSOR_MAX_RANK}")
    if rc == 102:
        raise TensorLayoutError("Arrow tensor with a negative stride")
    if rc != 0:
        raise ValueError(f"malformed Arrow tensor message (native rc={rc})")
    n = ndim.value
    return np.ndarray(tuple(shape[i] for i in range(n)), _CODE_TO_DTYPE[dtype.value],
                      buffer=raw, offset=off.value,
                      strides=tuple(strides[i] for i in range(n)))


# ---------------------------------------------------------------------------
# CRC32C (Castagnoli): Kafka's record-batch v2 checksum and the dist wire's


def crc32c(data, crc: int = 0) -> int:
    """CRC32C over ``data`` (any bytes-like object); incremental: pass a
    previous result as ``crc``."""
    if not isinstance(data, bytes):
        data = bytes(data)
    return load().stpu_crc32c(data, len(data), crc)


_CRC32C_TABLE = None


def crc32c_reference(data, crc: int = 0) -> int:
    """The pure-Python table version of :func:`crc32c` (the same
    polynomial, storm_tpu's fallback), the twin the tests hold the native
    one to."""
    global _CRC32C_TABLE
    if _CRC32C_TABLE is None:
        table = []
        for i in range(256):
            c = i
            for _ in range(8):
                c = (c >> 1) ^ 0x82F63B78 if c & 1 else c >> 1
            table.append(c)
        _CRC32C_TABLE = table
    crc ^= 0xFFFFFFFF
    for b in bytes(data):
        crc = (crc >> 8) ^ _CRC32C_TABLE[(crc ^ b) & 0xFF]
    return crc ^ 0xFFFFFFFF
