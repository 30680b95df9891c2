"""The native host codec: ``fastjson.cpp`` through ctypes.

The counterpart of ``storm_tpu/native/__init__.py`` for the JSON wire:
:func:`parse_instances` turns an ``{"instances": ...}`` payload into one
float32 array, :func:`format_predictions` writes an (N, K) array as
``{"predictions": [[...]]}``. The source is compiled by ``g++`` at first
use into ``build/storm_tpu_torch/`` at the repository root, cached by a
hash of the source and the flags (as ``ops/_build.py`` caches the CUDA
kernels), and loaded with :mod:`ctypes`. Nothing is built when the
module is imported.

There is no fallback: a failed build or load raises. The pure-Python
codec stays in ``storm_tpu_torch/api/schema.py`` as the reference the
tests hold this one to.
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

SOURCE = Path(__file__).resolve().parent / "fastjson.cpp"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "storm_tpu_torch"
CXX_FLAGS = ("-O3", "-std=c++17", "-shared", "-fPIC")
MAX_RANK = 8

_lib = None
_lib_lock = threading.Lock()
# Per-thread ctypes out-params of the parser, reused call to call
# (allocating them per call shows in a per-record profile).
_tls = threading.local()


class ParseError(ValueError):
    """A payload the parser refused; the message is the parser's own."""


def library_path() -> Path:
    h = hashlib.sha256(SOURCE.read_bytes())
    h.update(" ".join(CXX_FLAGS).encode())
    return BUILD_DIR / f"libstpu_fastjson-{h.hexdigest()[:16]}.so"


def _build(lib: Path) -> None:
    cxx = shutil.which("g++")
    if cxx is None:
        raise RuntimeError("g++ not found on PATH; storm_tpu_torch builds its JSON "
                           "codec (native/fastjson.cpp) from source at first use")
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    # Build into a private name, then rename: a concurrent build in another
    # process never loads a half-written library.
    tmp = lib.with_suffix(f".{os.getpid()}.{threading.get_ident()}.tmp")
    proc = subprocess.run([cxx, *CXX_FLAGS, "-o", str(tmp), str(SOURCE)],
                          capture_output=True, text=True, timeout=300)
    if proc.returncode != 0:
        raise RuntimeError(f"g++ failed for {SOURCE.name} (exit {proc.returncode}):\n"
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
