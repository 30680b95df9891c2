"""One CUDA graph per padded bucket: the port's counterpart of the JAX
engine's ``jax.jit`` of its forward (``storm_tpu/infer/engine.py``, one
compiled program per bucket shape, dispatched in one call).

A :class:`BucketForward` owns one bucket's buffers on the device and, on a
CUDA device, the graph of the engine's whole forward at that shape: the
uint8 wire's dequantization, the model and the f32 softmax. A graph bakes
every pointer and every kernel argument at capture (the w8a16 kernel's
activation tensor map included), so it reads one static input and writes
one static output, and the wire's scale and offset are device tensors
written per batch, never Python floats.

Per batch (:meth:`BucketForward.run`), with the engine's two streams:

- copy stream: the pinned host buffer goes to the ring slot's own device
  buffer (``non_blocking``), after the slot's previous batch has left it;
- compute stream: wait for that copy, copy the slot buffer into the static
  input (device to device), write the wire's scalars, replay the graph,
  copy the static output to the pinned host output and record events.

So batch N+1's host-to-device copy overlaps batch N's replay, and since
the compute stream runs replay and output copy in order, N+1's replay
cannot overwrite N's output before N's copy has read it.

On the CPU there is no graph: the same buffers and copies run, with the
eager forward writing the static output in place of a replay. Nor is
there one on the card for a forward built with ``capture=False`` (a
multi-rank engine's, whose collectives run on the host): each batch runs
it eagerly on the compute stream.
"""

from __future__ import annotations

import threading
import time
from collections import Counter
from typing import Callable, Dict, List, Optional, Tuple

import torch

from storm_tpu_torch.ops import _build

# One capture at a time in the process (CUDA's and PyTorch's rule), whatever
# engine captures: each holds only its own lock.
_CAPTURE_LOCK = threading.Lock()


class BucketForward:
    """The forward of one padded bucket.

    ``forward(x, scale, offset)``: the engine's forward on a device tensor
    of the wire dtype (``scale``/``offset`` are 0-d f32 device tensors,
    None without the uint8 wire), to (padded, ``classes``) f32. ``slots``:
    the ring slots, each with its own device input buffer. ``streams``: (compute, copy) CUDA streams,
    None on the CPU. ``pool``: the engine's graph memory pool, shared by
    all its buckets (their replays never overlap: one compute stream).
    ``capture``: False runs every batch eagerly, with no graph."""

    def __init__(self, forward: Callable, padded: int, input_shape: Tuple[int, ...],
                 wire_dtype: torch.dtype, classes: int, device: torch.device, slots: int,
                 *, wire: bool, streams: Optional[Tuple] = None, pool=None,
                 capture: bool = True) -> None:
        self.forward = forward
        self.padded = padded
        self.device = device
        self.cuda = device.type == "cuda"
        self.capture = capture
        shape = (padded, *input_shape)
        self.static_in = torch.zeros(shape, dtype=wire_dtype, device=device)
        self.slot_in: List[torch.Tensor] = [
            torch.zeros(shape, dtype=wire_dtype, device=device) for _ in range(slots)]
        self.scale = self.offset = None
        if wire:
            self.scale = torch.ones((), dtype=torch.float32, device=device)
            self.offset = torch.zeros((), dtype=torch.float32, device=device)
        # On the card the capture allocates it (in the graph's pool).
        self.static_out = None if self.cuda else torch.empty(
            (padded, classes), dtype=torch.float32)
        self.graph = None
        # Kernel launches per replay, recorded at capture.
        self.launches: Dict[str, int] = {}
        self.replays = 0
        self._streams = streams
        self._pool = pool
        if self.cuda:
            # loaded[s]: the slot's copy to the card is done; free[s]: the
            # compute stream has read the slot, which may be overwritten.
            self._loaded = [torch.cuda.Event() for _ in range(slots)]
            self._free = [torch.cuda.Event() for _ in range(slots)]

    def _eager(self) -> torch.Tensor:
        return self.forward(self.static_in, self.scale, self.offset)

    def build(self) -> Counter:
        """Make the bucket ready to run on the card; returns the kernel
        launches of the eager forward it ran (None on the CPU, where
        nothing is to be done). One eager forward on the compute stream
        first (it builds the kernels, sets their attributes and lets the
        libraries pick their algorithms), then the capture, in
        ``thread_local`` mode so another thread's calls cannot invalidate
        it. A failed capture raises: there is no eager fallback. Without
        ``capture`` nothing is built (None), once the streams are ordered
        after the buffers' zeroing."""
        if not self.cuda:
            return None
        compute, copy = self._streams
        # The buffers were zeroed on the current stream: a batch's copy into
        # a slot on the copy stream must not race that zeroing.
        compute.wait_stream(torch.cuda.current_stream(self.device))
        copy.wait_stream(torch.cuda.current_stream(self.device))
        if not self.capture:
            return None
        with torch.inference_mode(), _build.record_launches() as eager_counts:
            with torch.cuda.stream(compute):
                self._eager()
            compute.synchronize()
        graph = torch.cuda.CUDAGraph()
        with _CAPTURE_LOCK, torch.inference_mode(), \
                _build.record_launches(capturing=True) as counts:
            with torch.cuda.graph(graph, pool=self._pool, stream=compute,
                                  capture_error_mode="thread_local"):
                self.static_out = self._eager()
        self.graph = graph
        self.launches = dict(counts)
        return eager_counts

    def run(self, slot: int, host_in: torch.Tensor, host_out: torch.Tensor,
            scale: Optional[float] = None, offset: Optional[float] = None,
            eager: bool = False) -> Tuple[Optional[object], Optional[object], Counter]:
        """Enqueue one batch: ``host_in`` (the staged, padded batch in the
        wire dtype) through ring slot ``slot`` to ``host_out`` (padded,
        classes) f32. Returns ``(computed, done, eager launches)``: CUDA
        events recorded after the forward and after the copy to the host
        (None on the CPU, where the call completes before it returns), and
        the kernel launches of an eager forward (``eager=True``, the
        reference a replay is held to, or any forward on the CPU)."""
        counts: Counter = Counter()
        eager = eager or self.graph is None
        if not self.cuda:
            self.slot_in[slot].copy_(host_in)
            self.static_in.copy_(self.slot_in[slot])
            if self.scale is not None:
                self.scale.fill_(scale)
                self.offset.fill_(offset)
            with torch.inference_mode(), _build.record_launches() as counts:
                self.static_out.copy_(self._eager())
            host_out.copy_(self.static_out)
            return None, None, counts
        compute, copy = self._streams
        with torch.cuda.stream(copy):
            copy.wait_event(self._free[slot])
            self.slot_in[slot].copy_(host_in, non_blocking=True)
            self._loaded[slot].record(copy)
        with torch.cuda.stream(compute):
            compute.wait_event(self._loaded[slot])
            self.static_in.copy_(self.slot_in[slot])
            self._free[slot].record(compute)
            if self.scale is not None:
                self.scale.fill_(scale)
                self.offset.fill_(offset)
            if eager:
                with torch.inference_mode(), _build.record_launches() as counts:
                    out = self._eager()
            else:
                self.graph.replay()
                self.replays += 1
                out = self.static_out
            # Blocking events: the fetch thread waiting on one sleeps instead
            # of spinning a core, which the next batch's staging (a cast
            # spread over the host's cores) needs.
            computed = torch.cuda.Event(blocking=True)
            computed.record(compute)
            host_out.copy_(out, non_blocking=True)
            done = torch.cuda.Event(blocking=True)
            done.record(compute)
        return computed, done, counts


    def replay(self, reps: int = 1) -> None:
        """Replay the graph ``reps`` times on the compute stream outside any
        batch, on the static buffers as the last batch left them (timing
        and profiling; the caller keeps the engine idle meanwhile)."""
        compute, _ = self._streams
        with torch.cuda.stream(compute):
            for _ in range(reps):
                self.graph.replay()


def replay_kernel_names(bucket: BucketForward, attempts: int = 5) -> Dict[str, int]:
    """The CUDA kernels one replay of ``bucket``'s graph ran, by name, as
    ``torch.profiler`` traced them (memcpys and memsets left out): what a
    capture's record of launches is held to. The profiler can miss the
    first kernels it records on a stream, so the replay runs once to warm
    it, then a spin kernel, then again, and only what the card ran after
    the spin counts; a trace with no kernel after the spin is taken again,
    up to ``attempts`` times. The caller keeps the engine idle meanwhile
    (a replay writes the bucket's buffers)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    if not bucket.cuda:
        raise ValueError("a replay's kernels are traced on the card only")
    for _ in range(attempts):
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            bucket.replay()
            torch.cuda.synchronize(bucket.device)
            torch.cuda._sleep(100_000)
            torch.cuda.synchronize(bucket.device)
            bucket.replay()
            torch.cuda.synchronize(bucket.device)
        kernels = sorted((ev for ev in prof.events() if ev.device_type == DeviceType.CUDA
                          and "Memcpy" not in ev.name and "Memset" not in ev.name),
                         key=lambda ev: ev.time_range.start)
        spins = [i for i, ev in enumerate(kernels) if "spin_kernel" in ev.name]
        if spins and spins[-1] + 1 < len(kernels):
            return dict(Counter(ev.name for ev in kernels[spins[-1] + 1:]))
    raise RuntimeError(f"the profiler recorded no spin kernel with kernels after it "
                       f"in {attempts} traces")


def replay_ms(bucket: BucketForward, reps: int = 20) -> float:
    """Device ms of one replay of ``bucket``'s graph, between CUDA events
    on its compute stream."""
    compute, _ = bucket._streams
    bucket.replay()
    t0 = torch.cuda.Event(enable_timing=True)
    t1 = torch.cuda.Event(enable_timing=True)
    t0.record(compute)
    bucket.replay(reps)
    t1.record(compute)
    t1.synchronize()
    return t0.elapsed_time(t1) / reps


def eager_ms(bucket: BucketForward, reps: int = 5) -> float:
    """Wall ms of one eager forward of ``bucket`` on its compute stream,
    ending in a synchronize: host launch overhead included."""
    compute, _ = bucket._streams
    with torch.inference_mode(), torch.cuda.stream(compute):
        bucket._eager()
        compute.synchronize()
        t = time.perf_counter()
        for _ in range(reps):
            bucket._eager()
        compute.synchronize()
    return (time.perf_counter() - t) * 1e3 / reps
