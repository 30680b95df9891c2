"""KvCacheManager, the counterpart of ``storm_tpu/decode/kvcache.py``:
per-session KV blocks leased from one preallocated arena.

The arena is ONE float32 tensor ``(blocks, layers, 2, max_seq, d_model)``
on the engine's device, allocated up front; sessions lease block slots
from it and the decode engine writes each step's k and v straight into the
leased slot. The lengths, leases, pins and last-use times stay on the
host, so leasing and eviction never touch the card.

Eviction is cost-aware, not LRU: the victim is the unpinned session with
the smallest ``cached_len / age`` (cheapest to recompute and coldest goes
first). Slots pinned by an in-flight batch are never victims.

``serialize``/``restore`` carry a slot's used prefix as storm_tpu's
``KV20`` blob (``<4sIIII`` header: magic, layers, d_model, length, 0;
then the float32 body), so a blob written by either package restores in
the other. ``serialize`` and ``serialize_many`` (one read for many
sessions) are the only readers of the arena to the host.
"""

from __future__ import annotations

import struct
import threading
import time
from typing import Callable, Dict, List, Optional

import numpy as np
import torch

from storm_tpu_torch.device import resolve_device
from storm_tpu_torch.obs import copyledger as _copyledger

_MAGIC = b"KV20"
_HEADER = struct.Struct("<4sIIII")  # magic, layers, d_model, length, reserved


class ArenaFullError(RuntimeError):
    """Every block is leased and pinned: nothing is evictable."""


class KvCacheManager:
    """Slot-leasing KV arena of one decode engine. ``device``: where the
    arena lives (default ``cuda``; pass ``"cpu"`` for the CPU).

    Thread-safe: the batcher's dispatcher thread writes k and v during
    ``predict`` while the operator's event loop leases and releases slots
    and the checkpoint path serializes them."""

    def __init__(self, blocks: int, layers: int, max_seq: int, d_model: int, *,
                 engine_key: str = "decode", device=None,
                 clock: Callable[[], float] = time.monotonic,
                 on_evict: Optional[Callable[[str, int], None]] = None) -> None:
        if blocks < 1:
            raise ValueError(f"arena needs >= 1 block, got {blocks}")
        self.blocks = int(blocks)
        self.layers = int(layers)
        self.max_seq = int(max_seq)
        self.d_model = int(d_model)
        self.engine_key = engine_key
        self.device = resolve_device(device)
        self.arena = torch.zeros((self.blocks, self.layers, 2, self.max_seq, self.d_model),
                                 dtype=torch.float32, device=self.device)
        self.lens = np.zeros(self.blocks, np.int32)
        self._clock = clock
        self._lock = threading.RLock()
        self._free: List[int] = list(range(self.blocks - 1, -1, -1))
        self._owner: Dict[str, int] = {}      # session_id -> slot
        self._sid: Dict[int, str] = {}        # slot -> session_id
        self._used_at: Dict[str, float] = {}  # session_id -> last touch
        self._pins: Dict[int, int] = {}       # slot -> pin refcount
        self.evictions = 0
        self.on_evict = on_evict

    # ---- leasing -------------------------------------------------------------

    def slot_of(self, session_id: str) -> Optional[int]:
        with self._lock:
            return self._owner.get(session_id)

    def acquire(self, session_id: str) -> int:
        """Lease a slot for ``session_id`` (idempotent for a live lease).
        A full arena evicts the cost-aware victim; raises
        :class:`ArenaFullError` when every slot is pinned."""
        with self._lock:
            slot = self._owner.get(session_id)
            if slot is not None:
                self._used_at[session_id] = self._clock()
                return slot
            if not self._free:
                self._evict_locked()
            slot = self._free.pop()
            self._owner[session_id] = slot
            self._sid[slot] = session_id
            self._used_at[session_id] = self._clock()
            self.lens[slot] = 0
            return slot

    def _evict_locked(self) -> None:
        now = self._clock()
        best_sid, best_score = None, None
        for sid, slot in self._owner.items():
            if self._pins.get(slot, 0) > 0:
                continue
            age = max(now - self._used_at.get(sid, now), 1e-9)
            # Recompute cost (the cached prefix) over idle time: colder and
            # cheaper-to-rebuild sessions score lower and go first.
            score = float(self.lens[slot]) / age
            if best_score is None or score < best_score:
                best_sid, best_score = sid, score
        if best_sid is None:
            raise ArenaFullError(f"kv arena: all {self.blocks} blocks leased and pinned")
        cached = int(self.lens[self._owner[best_sid]])
        self._release_locked(best_sid)
        self.evictions += 1
        if self.on_evict is not None:
            self.on_evict(best_sid, cached)

    def release(self, session_id: str) -> None:
        with self._lock:
            self._release_locked(session_id)

    def _release_locked(self, session_id: str) -> None:
        slot = self._owner.pop(session_id, None)
        if slot is None:
            return
        del self._sid[slot]
        self._used_at.pop(session_id, None)
        self._pins.pop(slot, None)
        self.lens[slot] = 0
        self._free.append(slot)

    def touch(self, session_id: str) -> None:
        """Freshen a live session's last use (its eviction age)."""
        with self._lock:
            if session_id in self._owner:
                self._used_at[session_id] = self._clock()

    def pin(self, session_id: str) -> None:
        """Protect the session's slot from eviction while a batch holding
        its rows is in flight."""
        with self._lock:
            slot = self._owner.get(session_id)
            if slot is not None:
                self._pins[slot] = self._pins.get(slot, 0) + 1

    def unpin(self, session_id: str) -> None:
        with self._lock:
            slot = self._owner.get(session_id)
            if slot is not None and self._pins.get(slot, 0) > 0:
                self._pins[slot] -= 1

    # ---- lengths (the engine writes k and v by indexing the arena) ------------

    def append(self, slot: int, layer: int, pos: int, k, v) -> None:
        """Write one position's k and v (``d_model`` values each) of one
        layer into the arena; the engine writes its batches by indexing.
        Writing the last layer past the cached length extends it."""
        with self._lock:
            self.arena[slot, layer, 0, pos] = torch.as_tensor(k, dtype=torch.float32)
            self.arena[slot, layer, 1, pos] = torch.as_tensor(v, dtype=torch.float32)
            if layer == self.layers - 1 and pos >= self.lens[slot]:
                self.lens[slot] = pos + 1

    def advance(self, slot: int, new_len: int) -> None:
        with self._lock:
            if new_len > self.lens[slot]:
                self.lens[slot] = new_len

    # ---- migration -----------------------------------------------------------

    def serialize(self, session_id: str) -> Optional[bytes]:
        """The session's used prefix as a ``KV20`` blob, or None for a
        session without a live slot."""
        with self._lock:
            slot = self._owner.get(session_id)
            if slot is None:
                return None
            n = int(self.lens[slot])
            body = self.arena[slot, :, :, :n, :].contiguous().cpu().numpy().tobytes()
        blob = _HEADER.pack(_MAGIC, self.layers, self.d_model, n, 0) + body
        if _copyledger.active():
            _copyledger.record("kv_migrate", len(blob), copies=1, allocs=1,
                               records=1, engine=self.engine_key)
        return blob

    def serialize_many(self, session_ids) -> Dict[str, bytes]:
        """:meth:`serialize` for several sessions with one read of the
        arena to the host (a checkpoint folds every live session at once);
        sessions without a live slot are left out. Each blob equals what
        ``serialize`` gives."""
        with self._lock:
            live = [(sid, self._owner[sid]) for sid in session_ids if sid in self._owner]
            if not live:
                return {}
            lens = [int(self.lens[slot]) for _, slot in live]
            host = self.arena[[slot for _, slot in live], :, :, :max(lens)].cpu().numpy()
        blobs = {}
        for (sid, _), n, kv in zip(live, lens, host):
            blobs[sid] = _HEADER.pack(_MAGIC, self.layers, self.d_model, n, 0) + \
                np.ascontiguousarray(kv[:, :, :n, :]).tobytes()
            if _copyledger.active():
                _copyledger.record("kv_migrate", len(blobs[sid]), copies=1, allocs=1,
                                   records=1, engine=self.engine_key)
        return blobs

    def restore(self, session_id: str, blob: bytes) -> int:
        """Lease a slot and load a serialized prefix into it; returns the
        slot. Raises ``ValueError`` on a dimension mismatch or a malformed
        blob."""
        if len(blob) < _HEADER.size:
            raise ValueError("kv blob shorter than its header")
        magic, layers, d_model, n, _ = _HEADER.unpack_from(blob, 0)
        if magic != _MAGIC:
            raise ValueError(f"kv blob bad magic {magic!r}")
        if layers != self.layers or d_model != self.d_model:
            raise ValueError(
                f"kv blob dims (layers={layers}, d={d_model}) do not match "
                f"arena (layers={self.layers}, d={self.d_model})")
        if n > self.max_seq:
            raise ValueError(f"kv blob length {n} exceeds arena max_seq {self.max_seq}")
        want = layers * 2 * n * d_model * 4
        body = blob[_HEADER.size:]
        if len(body) != want:
            raise ValueError(f"kv blob body {len(body)}B != expected {want}B")
        data = np.frombuffer(body, np.float32).reshape(layers, 2, n, d_model)
        with self._lock:
            slot = self.acquire(session_id)
            self.arena[slot, :, :, :n, :] = torch.from_numpy(data.copy()).to(self.device)
            self.lens[slot] = n
        if _copyledger.active():
            _copyledger.record("kv_migrate", len(blob), copies=1, allocs=0,
                               records=1, engine=self.engine_key)
        return slot

    # ---- observability -------------------------------------------------------

    def occupancy(self) -> dict:
        with self._lock:
            used = len(self._owner)
            rows = int(self.lens.sum())
        row_bytes = self.layers * 2 * self.d_model * 4
        return {
            "slots_total": self.blocks,
            "slots_used": used,
            "utilization": used / self.blocks,
            "cached_rows": rows,
            "cached_bytes": rows * row_bytes,
            "arena_bytes": int(self.arena.numel() * self.arena.element_size()),
            "evictions": self.evictions,
        }
