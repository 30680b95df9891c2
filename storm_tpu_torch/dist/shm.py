"""Shared-memory delivery lane, copied from ``storm_tpu/dist/shm.py``: ship
batch frames between co-located workers without a socket copy.

The TCP wire pays three whole-frame touches per delivery batch: the
encoder's parts-list join (``wire_encode``), the socket send+recv pair,
and the receiver's decode materialization (``wire_decode``). For two
workers on the SAME host all three are waste — the bytes never needed to
leave the machine. This lane collapses them to ONE:

- the sender writes the UNSEALED deliveries frame
  (:func:`storm_tpu_torch.dist.wire.encode_delivery_parts`) part-by-part into
  a fresh ``multiprocessing.shared_memory`` segment. That sequential
  write is the lane's single copy and is what the ``shm_transport``
  ledger hop records (bytes = frame length, copies = 1);
- a tiny 0xB9 header frame (segment name + offset + length, CRC over
  the header only — the body never touches the network) rides the
  normal Deliver RPC, so ordering, retry and backpressure semantics are
  untouched;
- the receiver attaches the segment and decodes zero-copy views
  (:func:`storm_tpu_torch.dist.wire.decode_deliveries_view` — ``wire_decode``
  bytes=0, copies=0).

Lifecycle: the receiver's decode is synchronous inside the Deliver RPC
(worker.deliver_threadsafe decodes before enqueueing), so the sender may
``close()`` + ``unlink()`` the segment as soon as the RPC returns — no
distributed refcount. The receiver keeps a small LRU of attached
segments (repeat senders reuse nothing today — one segment per batch —
but the cache bounds fd churn and makes eviction the single place that
handles mmap's refusal to close while views are exported).

Eligibility is negotiated, never assumed: a peer advertises its
:func:`host_key` in the wire ping, and the lane engages only when the
key matches ours (same machine, same boot) AND the batch is big enough
to beat the segment-setup cost (``TopologyConfig.shm_min_bytes``).
"""

from __future__ import annotations

import socket
import threading
from collections import OrderedDict
from typing import List, Optional, Tuple

from storm_tpu_torch.obs import copyledger as _copyledger

try:  # pragma: no cover - stdlib, but keep the worker importable anywhere
    from multiprocessing import shared_memory as _shm
    from multiprocessing import resource_tracker as _tracker
except ImportError:  # pragma: no cover
    _shm = None
    _tracker = None

__all__ = ["available", "host_key", "write_segment", "SegmentCache"]


def available() -> bool:
    """True when the platform can create shared-memory segments."""
    return _shm is not None


_host_key: Optional[str] = None
_host_key_lock = threading.Lock()


def host_key() -> str:
    """A string equal across processes on the same machine+boot, and
    (almost surely) distinct otherwise.

    hostname alone collides across containers cloned from one image, so
    the kernel's random boot id is appended when readable; two workers
    only shortcut through /dev/shm when both halves agree.
    """
    global _host_key
    if _host_key is None:
        with _host_key_lock:
            if _host_key is None:
                boot = ""
                try:
                    with open("/proc/sys/kernel/random/boot_id") as fh:
                        boot = fh.read().strip()
                except OSError:
                    pass
                _host_key = f"{socket.gethostname()}:{boot}"
    return _host_key


def _untrack(seg) -> None:
    """Detach a segment from this process's resource tracker.

    ``SharedMemory(name=..., create=False)`` REGISTERS the attachment
    with the resource tracker (Python < 3.13 has no ``track=False``), so
    a receiver exiting would unlink segments the sender still owns and
    spew "leaked shared_memory" warnings. Unregister immediately: the
    sender is the sole owner and unlinks after the RPC.
    """
    if _tracker is None:  # pragma: no cover
        return
    try:
        _tracker.unregister(seg._name, "shared_memory")
    except Exception:  # pragma: no cover - tracker internals vary
        pass


def write_segment(parts: List[bytes]):
    """Create a segment holding ``parts`` joined; return the handle.

    The sequential part-by-part write IS the lane's one whole-frame copy
    — recorded as the ``shm_transport`` hop. Caller must ``close()`` +
    ``unlink()`` the returned segment once the peer has decoded (i.e.
    after the Deliver RPC returns or permanently fails).
    """
    if _shm is None:  # pragma: no cover
        raise RuntimeError("shared memory is unavailable on this platform")
    total = 0
    for p in parts:
        total += p.nbytes if isinstance(p, memoryview) else len(p)
    seg = _shm.SharedMemory(create=True, size=max(total, 1))
    try:
        view = seg.buf
        pos = 0
        for p in parts:
            n = p.nbytes if isinstance(p, memoryview) else len(p)
            view[pos:pos + n] = p
            pos += n
        _copyledger.record("shm_transport", total, copies=1, allocs=1)
    except BaseException:
        seg.close()
        try:
            seg.unlink()
        except OSError:  # pragma: no cover
            pass
        raise
    return seg, total


class SegmentCache:
    """Receiver-side LRU of attached segments, keyed by name.

    One batch = one segment today, so hits are rare — the cache's real
    job is bounding attach churn and centralizing teardown. Eviction
    must survive mmap's ``BufferError`` ("cannot close exported pointers
    exist"): a decoded view may still be alive downstream (a record
    frame riding a queue), so refused closes park on a zombie list and
    retry on every later eviction cycle instead of leaking or crashing.
    """

    def __init__(self, capacity: int = 64) -> None:
        self._capacity = int(capacity)
        self._lock = threading.Lock()
        self._segments: "OrderedDict[str, object]" = OrderedDict()
        self._zombies: List[object] = []

    def view(self, name: str, offset: int, length: int) -> memoryview:
        """Attach (or reuse) ``name`` and return the mapped byte range.

        Raises ``FileNotFoundError`` if the sender already unlinked the
        segment (a protocol bug — the sender must hold it through the
        RPC) and ``ValueError`` if the range overruns the mapping.
        """
        if _shm is None:  # pragma: no cover
            raise RuntimeError("shared memory is unavailable on this platform")
        with self._lock:
            seg = self._segments.get(name)
            if seg is not None:
                self._segments.move_to_end(name)
            else:
                seg = _shm.SharedMemory(name=name, create=False)
                _untrack(seg)
                self._segments[name] = seg
                self._evict_locked()
            buf = seg.buf
            if offset < 0 or length < 0 or offset + length > len(buf):
                raise ValueError(
                    f"shm range [{offset}, {offset + length}) overruns "
                    f"segment {name!r} of {len(buf)} bytes")
            return memoryview(buf)[offset:offset + length]

    def _evict_locked(self) -> None:
        while len(self._segments) > self._capacity:
            _name, seg = self._segments.popitem(last=False)
            self._zombies.append(seg)
        still: List[object] = []
        for seg in self._zombies:
            try:
                seg.close()
            except BufferError:
                still.append(seg)  # views still exported; retry later
        self._zombies = still

    def close(self) -> None:
        """Best-effort teardown (worker shutdown)."""
        with self._lock:
            self._zombies.extend(self._segments.values())
            self._segments.clear()
            still: List[object] = []
            for seg in self._zombies:
                try:
                    seg.close()
                except BufferError:
                    still.append(seg)
            self._zombies = still

    def stats(self) -> Tuple[int, int]:
        with self._lock:
            return len(self._segments), len(self._zombies)
