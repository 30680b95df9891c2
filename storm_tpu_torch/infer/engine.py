"""The inference engine: a model's batched forward on one device, the
counterpart of ``storm_tpu/infer/engine.py`` on its serialized path
(``pipeline_depth=0``).

``predict`` pads the batch to its bucket with zero rows, casts it to the
compute dtype on the host (or, with ``transfer_dtype="uint8"``,
affine-quantizes it to bytes there and dequantizes it on the device),
copies it to the device, runs the forward under a lock (one forward at a
time per engine), takes the f32 softmax and copies the probabilities back,
sliced to the real rows. ``shared_engine`` keeps one engine per model
identity per process, so every inference operator task of a topology
shares one copy of the weights on the card.
"""

from __future__ import annotations

import threading
from concurrent.futures import Future
from typing import Dict, Optional, Sequence, Tuple

import numpy as np
import torch

from storm_tpu_torch.config import BatchConfig, ModelConfig
from storm_tpu_torch.device import resolve_device
from storm_tpu_torch.models.convert import from_jax_params, init_params
from storm_tpu_torch.models.registry import check_checkpoint, load_checkpoint, model_def

DTYPES = {"bfloat16": torch.bfloat16, "float32": torch.float32}


class InflightBatch:
    """Handle of one dispatched batch: ``future`` resolves to the host
    result, or to the exception that failed this batch only."""

    __slots__ = ("future",)

    def __init__(self) -> None:
        self.future: Future = Future()


def quantize_wire(x: np.ndarray, n: Optional[int] = None) -> Tuple[np.ndarray, np.float32,
                                                                     np.float32]:
    """The uint8 wire of ``storm_tpu/infer/engine.py:926-937``: the range
    from the first ``n`` (real, unpadded) rows of float32 ``x``, ``scale =
    max((hi - lo) / 255, 1e-12)`` in float32, and ``clip(rint((x - lo) /
    scale), 0, 255)`` over every row as uint8. Returns ``(bytes, scale,
    lo)``; the device computes ``bytes * scale + lo`` in float32."""
    real = x if n is None else x[:n]
    lo, hi = float(real.min()), float(real.max())
    scale = np.float32(max((hi - lo) / 255.0, 1e-12))
    offset = np.float32(lo)
    xq = np.clip(np.rint((x - offset) / scale), 0, 255).astype(np.uint8)
    return xq, scale, offset


class InferenceEngine:
    """``params`` and ``state``: numpy trees in the JAX layout (e.g.
    carried from storm_tpu). With ``params`` None the engine loads
    ``model_cfg.checkpoint`` (an exported checkpoint, see
    :func:`storm_tpu_torch.models.registry.checkpoint_path`), or, without
    one, initializes from ``model_cfg.seed``."""

    def __init__(self, model_cfg: ModelConfig,
                 batch_cfg: Optional[BatchConfig] = None, *,
                 device=None, params=None, state=None) -> None:
        if model_cfg.dtype not in DTYPES:
            raise ValueError(
                f"model.dtype must be one of {sorted(DTYPES)}, got {model_cfg.dtype!r}")
        self.model_cfg = model_cfg
        self.batch_cfg = batch_cfg or BatchConfig()
        self.device = resolve_device(device)
        self.dtype = DTYPES[model_cfg.dtype]
        self.model_def = model_def(model_cfg.name, num_classes=model_cfg.num_classes,
                                   input_shape=tuple(model_cfg.input_shape),
                                   **model_cfg.extra)
        if params is None and model_cfg.checkpoint:
            params, state, meta = load_checkpoint(model_cfg.checkpoint)
            check_checkpoint(self.model_def, params, state, meta, model_cfg.checkpoint)
        elif params is None:
            params, state = init_params(self.model_def, model_cfg.seed)
        self.model = from_jax_params(params, self.model_def, state,
                                     weights=model_cfg.weights, dtype=self.dtype,
                                     device=self.device)
        self.wire_uint8 = model_cfg.transfer_dtype == "uint8"
        self._lock = threading.Lock()
        # Forwards run (warmup included): the batch count the kernels'
        # launch counters are held against.
        self.forwards = 0
        self._warmed: set = set()

    @property
    def input_shape(self) -> Tuple[int, ...]:
        return tuple(self.model_def.input_shape)

    def param_bytes(self) -> int:
        return sum(b.numel() * b.element_size() for b in self.model.buffers())

    def pad_batch(self, n: int) -> int:
        """The bucket a batch of ``n`` pads to; a batch larger than
        ``max_batch`` keeps its own size."""
        return max(n, self.batch_cfg.bucket_for(n))

    def warmup(self, buckets: Optional[Tuple[int, ...]] = None) -> None:
        """Run each bucket shape once before traffic arrives (first CUDA
        use, cuDNN algorithm choice, kernel builds); a bucket already
        warmed is skipped, so every operator task sharing the engine may
        call this."""
        for b in buckets or self.batch_cfg.buckets:
            if b not in self._warmed:
                self.predict(np.zeros((b, *self.input_shape), np.float32))
                self._warmed.add(b)

    def predict(self, x: np.ndarray) -> np.ndarray:
        """Blocking batched forward: (n, *input_shape) float -> (n, classes)
        float32 probabilities. Call it from a worker thread, never the
        event loop."""
        n = x.shape[0]
        padded = self.pad_batch(n)
        x = np.asarray(x, np.float32)
        if padded != n:
            x = np.concatenate([x, np.zeros((padded - n, *x.shape[1:]), x.dtype)])
        if self.wire_uint8:
            # One byte per value crosses to the card, plus two scalars.
            xq, scale, offset = quantize_wire(x, n)
            xt = torch.from_numpy(xq)
        else:
            # Cast on the host: the copy to the card then moves the compute
            # dtype's bytes (half of f32 for bf16).
            xt = torch.from_numpy(np.ascontiguousarray(x)).to(self.dtype)
        with self._lock, torch.inference_mode():
            xd = xt.to(self.device)
            if self.wire_uint8:
                xd = (xd.float() * float(scale) + float(offset)).to(self.dtype)
            probs = self.model(xd).float().softmax(dim=-1)
            host = probs.cpu().numpy()
            self.forwards += 1
        return host[:n]

    def dispatch(self, parts: Sequence[np.ndarray]) -> InflightBatch:
        """Run ``parts`` (per-record arrays) as one batch; returns an
        already-resolved handle (the serialized path: no device pipeline)."""
        handle = InflightBatch()
        x = parts[0] if len(parts) == 1 else np.concatenate(parts)
        try:
            handle.future.set_result(self.predict(x))
        except Exception as e:  # fail ONLY this batch
            handle.future.set_exception(e)
        return handle


# ---- engine sharing across operator tasks ------------------------------------

_ENGINES: Dict[tuple, InferenceEngine] = {}
_ENGINES_LOCK = threading.Lock()


def _freeze(v):
    """Hashable deep-freeze for cache keys."""
    if isinstance(v, dict):
        return tuple(sorted((k, _freeze(x)) for k, x in v.items()))
    if isinstance(v, (list, tuple)):
        return tuple(_freeze(x) for x in v)
    return v


def shared_engine(model_cfg: ModelConfig, batch_cfg: Optional[BatchConfig] = None,
                  *, device=None) -> InferenceEngine:
    """One engine per (model identity, batch policy, device) per process:
    operator tasks share one copy of the weights on the device."""
    dev = resolve_device(device)
    key = (model_cfg.name, model_cfg.dtype, model_cfg.transfer_dtype,
           tuple(model_cfg.input_shape), model_cfg.num_classes,
           model_cfg.checkpoint, model_cfg.seed, model_cfg.weights,
           _freeze(model_cfg.extra),
           (batch_cfg.max_batch, tuple(batch_cfg.buckets)) if batch_cfg else None,
           str(dev))
    # Built under the lock: a second task asking for the same engine
    # waits for the first build instead of allocating a duplicate.
    with _ENGINES_LOCK:
        engine = _ENGINES.get(key)
        if engine is None:
            engine = _ENGINES[key] = InferenceEngine(model_cfg, batch_cfg, device=dev)
        return engine


def clear_engines() -> None:
    """Drop every cached engine (their weights free once unreferenced)."""
    with _ENGINES_LOCK:
        _ENGINES.clear()
