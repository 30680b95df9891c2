"""The inference engine: a model's batched forward on one device, the
counterpart of ``storm_tpu/infer/engine.py``.

The default path is the split-phase pipeline (``BatchConfig.pipeline_depth``
2, as in storm_tpu). :meth:`InferenceEngine.dispatch` stages a batch into a
pooled pinned host buffer with one fused write (cast to the wire dtype as
it lands; the uint8 wire quantizes in place), then, under the engine's
lock, copies it to the card on the engine's copy stream and replays the
bucket's CUDA graph on its compute stream (``infer/graphs.py``), and
returns an :class:`InflightBatch` at once. A dedicated fetch thread waits,
in dispatch order, for each batch's event and copies its rows out of the
pinned output buffer, so batch N+1's staging and copy overlap batch N's
compute. A ring of ``pipeline_depth`` slots bounds the batches in flight; a
per-batch watchdog (``watchdog_ms``) fails only a stuck batch, and
``watchdog_trips`` consecutive trips quarantine the engine. On the CPU the
same ring runs with the eager forward in place of the replay.
``pipeline_depth=0`` is the serialized predict: pad, cast, forward and
fetch, one batch at a time.

Observability: each batch's ``staging``, ``h2d`` and ``d2h`` hops go to
the copy ledger (``storm_tpu_torch/obs/copyledger.py``, which says where
the port's copies differ from storm_tpu's), each completed batch's
timings and each cold bucket's build time to the process profile sink
(``set_profile_sink``), and each cold bucket to the engine's
``on_compile`` hook. None of them runs under the engine's lock or inside
a timed phase.

``shared_engine`` keeps one engine per model identity and batch policy per
process, so the inference operator tasks of a topology share one copy of
the weights on the card; its cache is bounded by a byte budget (85 % of
the card's memory by default) that evicts only engines nothing else holds.
"""

from __future__ import annotations

import gc
import logging
import queue
import sys
import threading
import time
import weakref
from collections import Counter, OrderedDict, deque
from concurrent.futures import Future
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from storm_tpu_torch.config import BatchConfig, ModelConfig
from storm_tpu_torch.device import resolve_device
from storm_tpu_torch.infer.graphs import BucketForward
from storm_tpu_torch.models.convert import from_jax_params, init_params
from storm_tpu_torch.models.registry import check_checkpoint, load_checkpoint, model_def
from storm_tpu_torch.obs import copyledger as _copyledger
from storm_tpu_torch.resilience.chaos import get_injector
from storm_tpu_torch.runtime.tracing import DEVICE_SUBSTAGES

logger = logging.getLogger(__name__)

DTYPES = {"bfloat16": torch.bfloat16, "float32": torch.float32}


# ---- split-phase pipeline plumbing --------------------------------------------


class StagingPool:
    """Preallocated, recycled host staging buffers keyed by (shape, dtype).

    The dispatch phase stages a batch into one of these with a single fused
    write and hands it to a ``non_blocking`` copy, which the copy engine
    reads asynchronously: the buffer goes back to the pool only after the
    batch's FETCH, never when ``dispatch`` returns. ``pin`` allocates
    page-locked memory (CUDA engines; a copy from pageable memory would not
    be asynchronous). ``limit`` bounds buffers per key; ``acquire`` blocks
    when that many are in flight, which the pipeline ring normally
    prevents."""

    def __init__(self, limit: int, pin: bool = False) -> None:
        self.limit = max(1, int(limit))
        self.pin = pin
        self.allocated = 0  # fresh allocations ever made (alloc guard)
        self._lock = threading.Lock()
        self._free: Dict[tuple, List[torch.Tensor]] = {}
        self._sems: Dict[tuple, threading.Semaphore] = {}

    def acquire(self, shape: tuple, dtype: torch.dtype) -> torch.Tensor:
        key = (tuple(shape), dtype)
        with self._lock:
            sem = self._sems.get(key)
            if sem is None:
                sem = self._sems[key] = threading.Semaphore(self.limit)
        sem.acquire()
        with self._lock:
            free = self._free.setdefault(key, [])
            if free:
                return free.pop()
            self.allocated += 1
        return torch.empty(shape, dtype=dtype, pin_memory=self.pin)

    def release(self, buf: torch.Tensor) -> None:
        key = (tuple(buf.shape), buf.dtype)
        with self._lock:
            self._free.setdefault(key, []).append(buf)
            sem = self._sems[key]
        sem.release()

    def stats(self) -> Dict[str, int]:
        """Buffers ever allocated, currently free, and (the difference)
        held by in-flight batches."""
        with self._lock:
            free = sum(len(v) for v in self._free.values())
            return {"allocated": self.allocated, "free": free,
                    "in_use": max(0, self.allocated - free), "limit": self.limit}


class EngineWatchdogTimeout(RuntimeError):
    """A batch overran ``batch.watchdog_ms`` on the fetch ring. Raised on
    the fetch thread inside the per-batch try: only the stuck batch's
    future fails (its sources replay) and its ring slot and staging
    buffers are released; the program on the card may still run."""


class EngineQuarantined(RuntimeError):
    """Dispatch refused: the engine tripped its watchdog
    ``batch.watchdog_trips`` times in a row. Callers fail the batch
    (sources replay) until the operator swaps in a replacement."""


class InflightBatch:
    """Handle of one batch inside the split-phase pipeline.

    ``future`` resolves (on the engine's fetch thread) to the host
    ``np.ndarray`` result sliced to the true batch size, or to the
    exception that failed THIS batch only. ``timings`` holds
    :data:`DEVICE_SUBSTAGES`' keys once known; ``compute_ms`` and
    ``d2h_ms`` are filled by the fetch, so read them after ``future``
    resolves."""

    __slots__ = ("future", "n", "padded", "timings", "profile_key", "_out",
                 "_buf", "_host_out", "_t_launched", "watchdog_ms", "on_done",
                 "_owner")

    def __init__(self, n: int, padded: int) -> None:
        self.future: Future = Future()
        self.n = n
        self.padded = padded
        self.timings: Dict[str, float] = {}
        # Which engine's cost curve this batch feeds (None: not profiled).
        self.profile_key: Optional[str] = None
        self._out = None  # the device result, dropped after fetch
        self._buf = None  # pinned input staging buffer, recycled after fetch
        self._host_out = None  # pinned output buffer, recycled after fetch
        self._t_launched = 0.0
        # Fetch waits at most watchdog_ms (0 = forever) and reports the
        # outcome to on_done, a bound engine method: the handle pins the
        # engine only while the batch is in flight.
        self.watchdog_ms = 0.0
        self.on_done = None
        # The engine, held while the batch is in flight: the cache's
        # budget evicts only engines nothing else references, so an
        # engine swapped out under traffic stays until its batches land.
        self._owner = None

    def result(self, timeout: Optional[float] = None) -> np.ndarray:
        return self.future.result(timeout)


class _DeviceResult:
    """A launched batch's result: ``host`` (pinned, padded) and the CUDA
    events after its forward (``computed``) and after its copy to the host
    (``done``); both None on the CPU, where the result is ready at once.
    The protocol of a jax.Array that the fetch thread reads."""

    __slots__ = ("host", "computed", "done")

    def __init__(self, host: torch.Tensor, computed=None, done=None) -> None:
        self.host = host
        self.computed = computed
        self.done = done

    def is_ready(self) -> bool:
        return self.computed is None or self.computed.query()

    def block_until_ready(self):
        if self.computed is not None:
            self.computed.synchronize()
        return self

    def __array__(self, dtype=None, copy=None):
        if self.done is not None:
            self.done.synchronize()
        a = self.host.numpy()
        return a if dtype is None else a.astype(dtype, copy=False)


def _fetch_loop(fetch_q: "queue.SimpleQueue", ring: threading.Semaphore,
                staging: StagingPool) -> None:
    """Dedicated fetch thread: completes in-flight batches in dispatch
    order. Module-level so the thread never references the engine (cache
    eviction finds orphaned engines by refcount); a None sentinel (the
    engine's finalizer, tests) stops it.

    A batch is settled before its future resolves: the watchdog hears the
    outcome, the pinned buffers and the ring slot go back, and the
    handle drops its engine pin. A caller woken by the result may at once
    ask the cache for another model, and the budget must then find this
    engine unreferenced."""
    while True:
        handle = fetch_q.get()
        if handle is None:
            return
        res, exc = None, None
        try:
            _watchdog_wait(handle)
            t1 = time.perf_counter()
            # The rows out of the pooled pinned buffer, into a fresh array,
            # before the buffer is recycled.
            res = np.array(np.asarray(handle._out)[:handle.n])
            t2 = time.perf_counter()
            handle.timings["compute_ms"] = (t1 - handle._t_launched) * 1e3
            handle.timings["d2h_ms"] = (t2 - t1) * 1e3
            handle._out = None
            # Copy ledger, after t2: the card's copy of the padded result
            # into the pooled pinned output buffer, then the real rows out
            # of it into a fresh array (storm_tpu's np.asarray of the
            # device result is one copy of the padded result). Recorded,
            # with the cost profile's batch, before the future resolves, so
            # a caller that has the result finds its rows (storm_tpu
            # records them after, and a reader can miss the last batch's).
            if _copyledger.active() and handle._host_out is not None:
                out = handle._host_out
                _copyledger.record("d2h", out.numel() * out.element_size() + res.nbytes,
                                   copies=2, allocs=1, records=handle.n,
                                   engine=handle.profile_key or "-")
            sink = _profile_sink
            if sink is not None and handle.profile_key is not None:
                try:
                    sink.record_batch(handle.profile_key, handle.padded, handle.n,
                                      handle.timings)
                except Exception:
                    pass  # an observability hook must never fail a batch
        except BaseException as e:  # noqa: BLE001 - fail ONLY this batch
            handle._out = None
            exc = e
        try:
            _notify_done(handle, exc)
            # A batch failed by the watchdog may still be running on the
            # card; recycling is safe all the same: its input copy only
            # reads the buffer, and a later batch's output copy is ordered
            # after its own on the compute stream.
            _release_buffers(handle, staging)
            handle._owner = None
            ring.release()
        finally:
            if exc is None:
                handle.future.set_result(res)
            else:
                handle.future.set_exception(exc)


def _release_buffers(handle: InflightBatch, staging: StagingPool) -> None:
    """Give the batch's pinned input and output buffers back to the pool."""
    for attr in ("_buf", "_host_out"):
        buf = getattr(handle, attr)
        setattr(handle, attr, None)
        if buf is not None:
            staging.release(buf)


def _watchdog_wait(handle: InflightBatch) -> None:
    """Wait for the batch's device result, bounded by ``watchdog_ms``:
    without a deadline (or a result that cannot report readiness) the
    plain blocking wait; with one, poll ``is_ready()`` (``Event.query`` on
    the card) and raise :class:`EngineWatchdogTimeout` past it."""
    out = handle._out
    ms = handle.watchdog_ms
    is_ready = getattr(out, "is_ready", None)
    if ms <= 0 or is_ready is None:
        out.block_until_ready()
        return
    deadline = time.monotonic() + ms / 1e3
    while not is_ready():
        if time.monotonic() > deadline:
            raise EngineWatchdogTimeout(
                f"batch (n={handle.n}, padded={handle.padded}) exceeded "
                f"watchdog_ms={ms:g} on the fetch ring")
        time.sleep(min(0.002, ms / 1e4))
    out.block_until_ready()


class _HangingResult:
    """Chaos wrapper: a device result that refuses to report ready until
    its hold expires (:meth:`ChaosInjector.engine_hang_s`), a stuck batch
    for the watchdog without wedging a real program on the card."""

    __slots__ = ("_inner", "_until")

    def __init__(self, inner, until: float) -> None:
        self._inner = inner
        self._until = until

    def is_ready(self) -> bool:
        if time.monotonic() < self._until:
            return False
        ir = getattr(self._inner, "is_ready", None)
        return True if ir is None else ir()

    def block_until_ready(self):
        rem = self._until - time.monotonic()
        if rem > 0:
            time.sleep(rem)
        bur = getattr(self._inner, "block_until_ready", None)
        if bur is not None:
            bur()
        return self

    def __array__(self, dtype=None, copy=None):
        a = np.asarray(self._inner)
        return a if dtype is None else a.astype(dtype, copy=False)


def _notify_done(handle: InflightBatch, exc) -> None:
    cb = handle.on_done
    handle.on_done = None  # drop the engine ref with the batch
    if cb is None:
        return
    try:
        cb(exc)
    except Exception:
        pass  # a watchdog accounting hook must never fail the loop


# ---- cost-profile sink ----------------------------------------------------------

# Process-wide observer of completed batches and cold captures: needs
# ``record_batch(key, padded, rows, timings)`` and ``record_compile(key,
# padded, ms)`` (obs/profile.py's ProfileStore). None = off; the hot path
# pays one global read per batch.
_profile_sink = None


def set_profile_sink(sink) -> None:
    """Install (or, with None, remove) the process profile sink."""
    global _profile_sink
    _profile_sink = sink


def _report_compile(key: str, padded: int, ms: float) -> None:
    sink = _profile_sink
    if sink is not None:
        try:
            sink.record_compile(key, padded, ms)
        except Exception:
            pass  # an observability hook must never fail a batch


# ---- the wire ------------------------------------------------------------------


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


def _quantize_staged(f32: np.ndarray, out: np.ndarray, n: int) -> Tuple[np.float32,
                                                                        np.float32]:
    """:func:`quantize_wire` in place: the range from the first ``n`` rows
    of the staged ``f32`` buffer, the affine passes over it in place, one
    cast into the uint8 ``out``; the same float32 arithmetic, so the same
    bytes."""
    lo, hi = float(f32[:n].min()), float(f32[:n].max())
    scale = np.float32(max((hi - lo) / 255.0, 1e-12))
    offset = np.float32(lo)
    np.subtract(f32, offset, out=f32)
    np.divide(f32, scale, out=f32)
    np.rint(f32, out=f32)
    np.clip(f32, 0, 255, out=f32)
    np.copyto(out, f32, casting="unsafe")
    return scale, offset


def _forward_fn(model: torch.nn.Module, dtype: torch.dtype):
    """What a graph covers (``fwd`` / ``fwd_q`` of storm_tpu's engine): the
    uint8 wire's dequantization in f32, the model, the f32 softmax."""

    def forward(x: torch.Tensor, scale: Optional[torch.Tensor],
                offset: Optional[torch.Tensor]) -> torch.Tensor:
        if scale is not None:
            x = (x.float() * scale + offset).to(dtype)
        return model(x).float().softmax(dim=-1)

    return forward


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
        self.num_classes = int(model_cfg.num_classes)
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
        # The forward the buckets run; it holds the model, never the engine,
        # so the engine stays free of reference cycles (the cache finds
        # orphans by refcount).
        self._forward = _forward_fn(self.model, self.dtype)
        # The dtype that crosses to the card: one byte a value on the
        # uint8 wire, else the compute dtype (half of f32 for bf16).
        self.wire_dtype = torch.uint8 if self.wire_uint8 else self.dtype
        self._lock = threading.Lock()
        cuda = self.device.type == "cuda"
        # Split-phase pipeline state (see dispatch / _fetch_loop).
        self.pipeline_depth = max(0, int(self.batch_cfg.pipeline_depth))
        pool = int(self.batch_cfg.staging_pool) or self.pipeline_depth + 1
        self._staging = StagingPool(pool, pin=cuda)
        self._ring: Optional[threading.Semaphore] = (
            threading.BoundedSemaphore(self.pipeline_depth)
            if self.pipeline_depth else None)
        self._fetch_q: "queue.SimpleQueue[Optional[InflightBatch]]" = queue.SimpleQueue()
        self._fetch_thread: Optional[threading.Thread] = None
        self._fetch_thread_lock = threading.Lock()
        # Dispatch slots: the ring's depth, or the one serialized predict.
        self.ring_capacity = max(1, self.pipeline_depth)
        self._next_slot = 0
        # Watchdog / quarantine state (batch.watchdog_ms, watchdog_trips).
        self.quarantined = False
        self.on_quarantine = None
        self._watchdog_trips = 0
        self._watchdog_lock = threading.Lock()
        # One graph per padded bucket (infer/graphs.py), all captured into
        # one memory pool, on the engine's own compute and copy streams.
        self._buckets: Dict[int, BucketForward] = {}
        self._streams = (torch.cuda.Stream(self.device), torch.cuda.Stream(self.device)) \
            if cuda else None
        self._graph_pool = torch.cuda.graph_pool_handle() if cuda else None
        # Device bytes the builds of the buckets took at their peak:
        # torch.cuda.max_memory_allocated over each build (graph pool,
        # static buffers and the eager forward's transients), largest kept.
        self.graph_pool_bytes = 0
        # Observability hook: ``on_compile(padded_batch, ms)`` the first
        # time a bucket runs (its eager forward and capture). Cold builds
        # happen under the lock; their reports wait here until it is
        # released.
        self.on_compile = None
        self._cold_reports: deque = deque()
        ckpt = model_cfg.checkpoint
        self.profile_key = f"{model_cfg.name}@{ckpt}" if ckpt else model_cfg.name
        # Forwards run on the card or the CPU (replays and eager forwards,
        # warm-up included), and the kernel launches they made: each
        # replay adds its graph's launches as recorded at capture.
        self.forwards = 0
        self._tally: Counter = Counter()

    # ---- occupancy telemetry -------------------------------------------------

    @property
    def input_shape(self) -> Tuple[int, ...]:
        return tuple(self.model_def.input_shape)

    @property
    def ring_inflight(self) -> int:
        """Ring slots held by in-flight batches (telemetry: may be a step
        stale; the ring itself stays the bound)."""
        if self._ring is None:
            return 0
        return max(0, self.pipeline_depth - self._ring._value)

    def staging_stats(self) -> Dict[str, int]:
        return self._staging.stats()

    @property
    def compiled_batches(self) -> set:
        """The padded sizes whose bucket is built (captured, on the card)."""
        return set(self._buckets)

    def launch_tally(self) -> Dict[str, int]:
        """Kernel launches of this engine's forwards, by kernel: each
        replay counts its graph's launches (recorded at capture), each
        eager forward its own."""
        with self._lock:
            return dict(self._tally)

    # ---- memory accounting ---------------------------------------------------

    def param_bytes(self) -> int:
        """Device bytes held by the weights and state."""
        return sum(b.numel() * b.element_size() for b in self.model.buffers())

    def param_bytes_per_device(self) -> int:
        """The weights' bytes on the one device that holds them all (the
        cache's budget is per device)."""
        return self.param_bytes()

    # ---- shape management ----------------------------------------------------

    def pad_batch(self, n: int) -> int:
        """The bucket a batch of ``n`` pads to; a batch larger than
        ``max_batch`` keeps its own size (a bucket of its own)."""
        return max(n, self.batch_cfg.bucket_for(n))

    def warmup(self, buckets: Optional[Tuple[int, ...]] = None) -> None:
        """Build each bucket before traffic arrives: its eager forward
        (kernel builds, library algorithm choice) and its graph's capture.
        A built bucket is skipped, so every operator task sharing the
        engine may call this."""
        for b in buckets or self.batch_cfg.buckets:
            n = self.pad_batch(b)
            if n not in self.compiled_batches:
                self.predict(np.zeros((n, *self.input_shape), np.float32))

    def graph_for(self, padded: int) -> BucketForward:
        """The bucket of ``padded`` rows, built on first use (eager forward,
        then the capture on the card); reports a cold build once through
        ``on_compile`` and the profile sink."""
        with self._lock:
            bucket = self._bucket(padded)
        self._report_cold()
        return bucket

    def _report_cold(self) -> None:
        """Outside the lock: each cold build's report to the profile sink
        and ``on_compile``."""
        while self._cold_reports:
            try:
                padded, ms = self._cold_reports.popleft()
            except IndexError:
                return  # another thread took it
            _report_compile(self.profile_key, padded, ms)
            hook = self.on_compile
            if hook is not None:
                try:
                    hook(padded, ms)
                except Exception:
                    pass  # an observability hook must never fail a batch

    def _bucket(self, padded: int) -> BucketForward:
        bucket = self._buckets.get(padded)
        if bucket is not None:
            return bucket
        t0 = time.perf_counter()
        cuda = self._streams is not None
        if cuda:
            base = torch.cuda.memory_allocated(self.device)
            torch.cuda.reset_peak_memory_stats(self.device)
        bucket = BucketForward(
            self._forward, padded, self.input_shape, self.wire_dtype, self.num_classes,
            self.device, self.ring_capacity, wire=self.wire_uint8, streams=self._streams,
            pool=self._graph_pool)
        counts = bucket.build()
        if cuda:
            self._note_forward(counts)
            peak = torch.cuda.max_memory_allocated(self.device) - base
            self.graph_pool_bytes = max(self.graph_pool_bytes, peak)
        self._buckets[padded] = bucket
        self._cold_reports.append((padded, (time.perf_counter() - t0) * 1e3))
        return bucket

    def _note_forward(self, counts) -> None:
        self.forwards += 1
        self._tally.update(counts)

    def _launch(self, padded: int, host_in: torch.Tensor, host_out: torch.Tensor,
                scale=None, offset=None, eager: bool = False) -> _DeviceResult:
        """Under the lock: the batch through the bucket's next ring slot."""
        bucket = self._bucket(padded)
        slot = self._next_slot
        self._next_slot = (slot + 1) % self.ring_capacity
        computed, done, counts = bucket.run(
            slot, host_in, host_out, None if scale is None else float(scale),
            None if offset is None else float(offset), eager=eager)
        self._note_forward(counts if eager or not bucket.cuda else bucket.launches)
        return _DeviceResult(host_out, computed, done)

    # ---- the hot call --------------------------------------------------------

    def predict(self, x: np.ndarray) -> np.ndarray:
        """Blocking batched forward: (n, *input_shape) float -> (n, classes)
        float32 probabilities. Thread-safe; call it from a worker thread,
        never the event loop. With the ring on it is one ``dispatch`` and
        a wait; with ``pipeline_depth=0`` the serialized chain."""
        if self._ring is None:
            return self._predict_serial(x)
        return self.dispatch((x,)).future.result()

    def predict_eager(self, x: np.ndarray) -> np.ndarray:
        """The serialized chain with the bucket's forward run eagerly
        instead of replayed: the reference a graph is held to."""
        return self._predict_serial(x, eager=True)

    def dispatch(self, parts: Sequence[np.ndarray]) -> InflightBatch:
        """Split-phase entry: stage ``parts`` (per-record arrays, already
        shape-checked) into a pooled pinned buffer, copy it to the card and
        replay the bucket's graph asynchronously; the results fetch happens
        on the engine's fetch thread in dispatch order. Returns an
        :class:`InflightBatch` at once; its future resolves to the host
        result, or to the exception that failed THIS batch only.

        Blocks (bounded) while ``pipeline_depth`` batches are in flight,
        so call it from a worker thread. With the ring off it is the
        serialized predict in an already-resolved handle."""
        if self.quarantined:
            raise EngineQuarantined(
                f"engine {self.model_cfg.name!r} is quarantined after "
                f"{self._watchdog_trips} consecutive watchdog trips")
        n = sum(int(p.shape[0]) for p in parts)
        handle = InflightBatch(n, self.pad_batch(n))
        handle.profile_key = self.profile_key
        wd = float(self.batch_cfg.watchdog_ms or 0.0)
        if wd > 0:
            handle.watchdog_ms = wd
            handle.on_done = self._watchdog_note
        if self._ring is None:
            x = parts[0] if len(parts) == 1 else np.concatenate(parts)
            try:
                handle.future.set_result(self._predict_serial(x))
            except BaseException as e:  # noqa: BLE001 - fail ONLY this batch
                handle.future.set_exception(e)
            return handle
        self._ensure_fetch_thread()
        handle._owner = self
        self._ring.acquire()
        try:
            self._dispatch_phase(handle, parts)
        except BaseException as e:  # noqa: BLE001 - fail ONLY this batch
            _release_buffers(handle, self._staging)
            self._ring.release()
            handle._owner = None
            handle.future.set_exception(e)
            return handle
        self._fetch_q.put(handle)
        return handle

    def _stage(self, buf: torch.Tensor, parts: Sequence[np.ndarray], n: int) -> None:
        """The ONE host-side write of the dispatch phase: each part into
        the padded buffer, cast to its dtype as it lands (f32 first, so a
        float64 record rounds as the serial path's ``np.asarray(x,
        float32)`` does), and the padding rows zeroed."""
        ofs = 0
        for p in parts:
            k = p.shape[0]
            buf[ofs:ofs + k].copy_(torch.from_numpy(np.asarray(p, np.float32)))
            ofs += k
        if ofs < buf.shape[0]:
            buf[ofs:].zero_()

    def _dispatch_phase(self, handle: InflightBatch, parts: Sequence[np.ndarray]) -> None:
        t0 = time.perf_counter()
        padded, n = handle.padded, handle.n
        shape = (padded, *self.input_shape)
        scale = offset = None
        if self.wire_uint8:
            # Stage at full precision (the range comes from the real rows),
            # quantize in place and cast once into the wire buffer; the f32
            # buffer never reaches the card, so it recycles at once.
            f32 = self._staging.acquire(shape, torch.float32)
            try:
                self._stage(f32, parts, n)
                buf = handle._buf = self._staging.acquire(shape, torch.uint8)
                scale, offset = _quantize_staged(f32.numpy(), buf.numpy(), n)
            finally:
                self._staging.release(f32)
        else:
            buf = handle._buf = self._staging.acquire(shape, self.dtype)
            self._stage(buf, parts, n)
        out = handle._host_out = self._staging.acquire((padded, self.num_classes),
                                                       torch.float32)
        with self._lock:
            result = self._launch(padded, buf, out, scale, offset)
        t1 = time.perf_counter()
        # After t1, so neither the ledger nor a cold build's report lands
        # in the h2d_ms it sits beside.
        if _copyledger.active():
            nbytes = buf.numel() * buf.element_size()
            engine = self.profile_key or "-"
            if self.wire_uint8:
                # Two passes: the f32 stage write (4 bytes a value), then
                # the cast into the uint8 wire buffer (1 byte); the affine
                # passes rewrite the f32 buffer in place and count as no
                # copy.
                _copyledger.record("staging", nbytes * 5, copies=2, records=n,
                                   engine=engine)
            else:
                # The one fused pad + cast write into the pinned buffer.
                _copyledger.record("staging", nbytes, copies=1, records=n, engine=engine)
            _copyledger.record("h2d", nbytes, copies=1, records=n, engine=engine)
        self._report_cold()
        hold = self._chaos_hang_s()
        if hold > 0:
            result = _HangingResult(result, time.monotonic() + hold)
        handle._out = result
        handle._t_launched = t1
        # Staging + copy + replay launch (+ the build of a cold bucket).
        handle.timings["h2d_ms"] = (t1 - t0) * 1e3

    @staticmethod
    def _chaos_hang_s() -> float:
        """One-shot engine-hang injection; 0 when the injector is unarmed."""
        return get_injector().engine_hang_s()

    def _watchdog_note(self, exc) -> None:
        """Fetch-thread callback (``InflightBatch.on_done``): count
        CONSECUTIVE watchdog trips; at ``batch.watchdog_trips`` flip to
        quarantined once, leave the shared cache (the next
        ``shared_engine`` builds a fresh engine) and fire
        ``on_quarantine``."""
        if not isinstance(exc, EngineWatchdogTimeout):
            # Keep the count once quarantined, so the refusal names the
            # real streak.
            if exc is None and not self.quarantined:
                with self._watchdog_lock:
                    self._watchdog_trips = 0
            return
        limit = int(self.batch_cfg.watchdog_trips or 0)
        with self._watchdog_lock:
            self._watchdog_trips += 1
            trips = self._watchdog_trips
            if limit <= 0 or trips < limit or self.quarantined:
                return
            self.quarantined = True
        logger.error(
            "engine %s QUARANTINED after %d consecutive watchdog trips "
            "(watchdog_ms=%g); dispatch refuses batches until a replacement "
            "is swapped in", self.model_cfg.name, trips, self.batch_cfg.watchdog_ms)
        # Evict BEFORE the hook: it rebuilds through shared_engine, and a
        # cache hit on this engine would swap the quarantined one back in.
        try:
            unload_engine(self)
        except Exception:
            logger.exception("evicting quarantined engine failed")
        cb = self.on_quarantine
        if cb is not None:
            try:
                cb(trips)
            except Exception:
                logger.exception("on_quarantine hook failed")

    def _ensure_fetch_thread(self) -> None:
        if self._fetch_thread is not None:
            return
        with self._fetch_thread_lock:
            if self._fetch_thread is None:
                # The thread gets only the queue, ring and pool, never the
                # engine (not even a bound method), and a finalizer stops it
                # when the engine dies.
                t = threading.Thread(
                    target=_fetch_loop, args=(self._fetch_q, self._ring, self._staging),
                    daemon=True, name=f"storm-tpu-torch-fetch-{self.model_cfg.name}")
                t.start()
                self._fetch_thread = t
                weakref.finalize(self, self._fetch_q.put, None)

    def _predict_serial(self, x: np.ndarray, eager: bool = False) -> np.ndarray:
        """The serialized chain (``pipeline_depth=0``): pad with zero rows,
        cast on the host (or quantize to the uint8 wire there), then under
        the lock the copy to the card, the forward and the copy back, and
        the wait outside it."""
        n = x.shape[0]
        padded = self.pad_batch(n)
        x = np.asarray(x, np.float32)
        if padded != n:
            x = np.concatenate([x, np.zeros((padded - n, *x.shape[1:]), x.dtype)])
        scale = offset = None
        if self.wire_uint8:
            xq, scale, offset = quantize_wire(x, n)
            xt = torch.from_numpy(xq)
        else:
            xt = torch.from_numpy(np.ascontiguousarray(x)).to(self.dtype)
        out = torch.empty((padded, self.num_classes), dtype=torch.float32,
                          pin_memory=self._streams is not None)
        with self._lock:
            result = self._launch(padded, xt, out, scale, offset, eager=eager)
        self._report_cold()
        return np.array(np.asarray(result)[:n])


# ---- the device-free engine -----------------------------------------------------


class NullEngine:
    """Device-free engine: a uniform distribution, at once. Plugs into
    ``InferenceBolt(engine=NullEngine(...))`` to measure the framework's
    share of the broker-to-broker path with device time pinned to zero.
    The protocol the operator uses: ``input_shape``, ``warmup``,
    ``predict``, ``dispatch``."""

    def __init__(self, input_shape: Tuple[int, ...], num_classes: int) -> None:
        self.input_shape = tuple(input_shape)
        self.num_classes = int(num_classes)
        self.ring_capacity = 1

    def warmup(self, buckets=None) -> None:  # no device, nothing to build
        pass

    def predict(self, x: np.ndarray) -> np.ndarray:
        return np.full((x.shape[0], self.num_classes), 1.0 / self.num_classes, np.float32)

    def dispatch(self, parts: Sequence[np.ndarray]) -> InflightBatch:
        # An already-resolved handle with zeroed phase timings.
        n = sum(int(p.shape[0]) for p in parts)
        handle = InflightBatch(n, n)
        handle.timings = {key: 0.0 for key, _ in DEVICE_SUBSTAGES}
        handle.future.set_result(
            np.full((n, self.num_classes), 1.0 / self.num_classes, np.float32))
        return handle


# ---- engine sharing across operator tasks ------------------------------------

_ENGINES: "OrderedDict[tuple, InferenceEngine]" = OrderedDict()
_ENGINES_LOCK = threading.Lock()
# key -> in-progress build: concurrent shared_engine calls for one key wait
# on it instead of each allocating a duplicate copy of the weights.
_BUILDS: Dict[tuple, Future] = {}
# Cap on the cached engines' bytes per device; None = 85 % of the card's
# memory (no cap on the CPU). Eviction drops only engines nothing outside
# the cache references, so a cap never forces a live engine's rebuild.
_ENGINE_CACHE_LIMIT: Optional[int] = None
# Engines owned elsewhere, surfaced by live_engines (weakly).
_AUX_ENGINES: "weakref.WeakSet" = weakref.WeakSet()


def register_aux_engine(engine) -> None:
    """Surface an externally-owned engine through :func:`live_engines`
    (weak: dropping the last strong reference unregisters it)."""
    with _ENGINES_LOCK:
        _AUX_ENGINES.add(engine)


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
    operator tasks share one copy of the weights on the device. The
    engine is built outside the cache's lock; concurrent requests for one
    key build once and wait on that build."""
    dev = resolve_device(device)
    key = (model_cfg.name, model_cfg.dtype, model_cfg.transfer_dtype,
           tuple(model_cfg.input_shape), model_cfg.num_classes,
           model_cfg.checkpoint, model_cfg.seed, model_cfg.weights,
           _freeze(model_cfg.extra),
           # the batch policy is part of the identity: buckets, ring and
           # pool are the engine's
           (batch_cfg.max_batch, tuple(batch_cfg.buckets), batch_cfg.pipeline_depth,
            batch_cfg.staging_pool) if batch_cfg else None,
           str(dev))
    with _ENGINES_LOCK:
        if key in _ENGINES:
            _ENGINES.move_to_end(key)  # LRU: most recently used last
            return _ENGINES[key]
        fut = _BUILDS.get(key)
        owner = fut is None
        if owner:
            fut = _BUILDS[key] = Future()
    if not owner:
        # Another thread owns the build; its finally resolves the future.
        return fut.result()
    # The try starts right after registration, so any exception before
    # completion still pops the _BUILDS entry and resolves the future.
    engine = None
    try:
        engine = InferenceEngine(model_cfg, batch_cfg, device=dev)
        if _insert_would_exceed_budget(engine):
            # Outside the lock: an engine held only by a reference cycle
            # looks referenced until the collector runs, and finalizers may
            # re-enter the cache (the lock is not reentrant).
            gc.collect()
        with _ENGINES_LOCK:
            _ENGINES[key] = engine
            try:
                _evict_to_budget_locked(keep=key)
                _log_memory_inventory()
            except Exception:
                # Bookkeeping only: the engine is built and cached.
                logger.exception("engine cache bookkeeping failed")
    finally:
        with _ENGINES_LOCK:
            _BUILDS.pop(key, None)
        if engine is not None:
            fut.set_result(engine)
        else:
            exc = sys.exc_info()[1]
            fut.set_exception(exc if exc is not None
                              else RuntimeError("engine build aborted before completion"))
    return engine


def unload_engine(engine: InferenceEngine) -> bool:
    """Drop ``engine`` from the process cache, so its memory is reclaimed
    once nothing references it. Returns True if it was cached."""
    with _ENGINES_LOCK:
        for k, e in list(_ENGINES.items()):
            if e is engine:
                del _ENGINES[k]
                return True
    return False


def clear_engines() -> None:
    """Drop every cached engine (their weights free once unreferenced)."""
    with _ENGINES_LOCK:
        _ENGINES.clear()


def set_engine_cache_limit(max_param_bytes: Optional[int]) -> None:
    """Cap the cached engines' weight bytes per device; least recently used
    orphans are dropped on the next ``shared_engine`` insert. ``None``
    restores the default (85 % of the card's memory; none on the CPU).

    Best effort: only orphaned engines (no reference outside the cache)
    are evicted, since dropping one a bolt still serves from would free
    nothing and force a duplicate build. Orphans are found by refcount
    (CPython), after a ``gc.collect()`` when over budget; the cap is a
    target, never a reason to drop a live engine."""
    global _ENGINE_CACHE_LIMIT
    with _ENGINES_LOCK:
        _ENGINE_CACHE_LIMIT = max_param_bytes


def _refs_of_value(d: dict, k) -> int:
    """getrefcount of ``d[k]`` through one fixed call shape, so the
    internal references are the same in the calibration probe and the
    real check (CPython changed this count between versions)."""
    return sys.getrefcount(d[k])


_REF_BASELINE: Optional[int] = None


def _ref_baseline() -> int:
    """Refcount of an object held only as a dict value, measured through
    :func:`_refs_of_value` on this interpreter."""
    global _REF_BASELINE
    if _REF_BASELINE is None:
        _REF_BASELINE = _refs_of_value({0: object()}, 0)
    return _REF_BASELINE


def _externally_referenced(k: tuple) -> bool:
    """Does anything outside the cache hold ``_ENGINES[k]``? Without
    refcounts (non-CPython), everything counts as referenced."""
    try:
        return _refs_of_value(_ENGINES, k) > _ref_baseline()
    except Exception:  # pragma: no cover - non-CPython
        return True


def _device_memory_limit(device: torch.device) -> Optional[int]:
    """The card's total memory; None on the CPU."""
    if device.type != "cuda":
        return None
    return int(torch.cuda.mem_get_info(device)[1])


def _cache_limit(device: torch.device) -> Optional[int]:
    if _ENGINE_CACHE_LIMIT is not None:
        return _ENGINE_CACHE_LIMIT
    total = _device_memory_limit(device)
    return int(0.85 * total) if total else None


def _cached_bytes(device: torch.device) -> int:
    return sum(e.param_bytes_per_device() for e in _ENGINES.values()
               if e.device == device)


def _insert_would_exceed_budget(engine: InferenceEngine) -> bool:
    """Brief-lock probe: whether to ``gc.collect()`` (unlocked) before
    inserting ``engine``."""
    limit = _cache_limit(engine.device)
    if limit is None:
        return False
    with _ENGINES_LOCK:
        total = _cached_bytes(engine.device)
    return total + engine.param_bytes_per_device() > limit


def _evict_to_budget_locked(keep: tuple) -> None:
    device = _ENGINES[keep].device
    limit = _cache_limit(device)
    if limit is None:
        return
    total = _cached_bytes(device)
    for k in list(_ENGINES):  # oldest first
        if total <= limit:
            break
        if k == keep or _ENGINES[k].device != device:
            continue
        if _externally_referenced(k):
            # A bolt still serves from it: evicting frees nothing and the
            # next lookup would build a duplicate.
            continue
        e = _ENGINES.pop(k)
        per_dev = e.param_bytes_per_device()
        total -= per_dev
        logger.info("evicted orphaned LRU engine %s (%.1f MB) from the cache "
                    "(budget %.1f MB)", e.model_cfg.name, per_dev / 1e6, limit / 1e6)
        del e  # the last reference: its memory is reclaimed


def live_engines() -> list:
    """Strong references to every cached engine and every registered
    auxiliary one (their ring and staging state live on the objects)."""
    with _ENGINES_LOCK:
        return list(_ENGINES.values()) + list(_AUX_ENGINES)


def engine_inventory() -> dict:
    """The process's cached engines and their weight bytes: the budget of
    co-resident models on one card."""
    with _ENGINES_LOCK:
        engines = list(_ENGINES.values())
    rows = [{"model": e.model_cfg.name,
             "checkpoint": e.model_cfg.checkpoint or None,
             "weights": e.model_cfg.weights,
             "dtype": str(e.dtype),
             "device": str(e.device),
             "param_bytes": e.param_bytes(),
             "param_bytes_per_device": e.param_bytes_per_device()}
            for e in engines]
    return {"engines": rows,
            "total_param_bytes": sum(r["param_bytes"] for r in rows),
            "total_param_bytes_per_device": sum(r["param_bytes_per_device"] for r in rows)}


def _log_memory_inventory() -> None:
    # Called with _ENGINES_LOCK held.
    by_device: Dict[torch.device, List[Tuple[str, int]]] = {}
    for e in _ENGINES.values():
        by_device.setdefault(e.device, []).append(
            (e.model_cfg.name, e.param_bytes_per_device()))
    for device, rows in by_device.items():
        total = sum(b for _, b in rows)
        limit = _device_memory_limit(device)
        logger.info("engine memory on %s: %s (total %.1f MB)", device,
                    ", ".join(f"{n}={b / 1e6:.1f}MB" for n, b in rows), total / 1e6)
        if limit and total > 0.85 * limit:
            logger.warning(
                "co-resident engine weights at %.0f%% of %s's memory (%.1f MB of "
                "%.1f MB): the multi-model budget is nearly exhausted",
                100 * total / limit, device, total / 1e6, limit / 1e6)
