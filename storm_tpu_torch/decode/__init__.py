"""Stateful decode serving, the counterpart of ``storm_tpu/decode/``:
KV-cache sessions, sticky routing and one emit per token, with char_tiny's
step in torch on the card.

- :mod:`.kvcache`: per-session KV blocks leased from one preallocated
  device arena, cost-aware eviction, ``KV20`` serialize and restore;
- :mod:`.session`: the token log, the ``committed`` emit watermark and the
  per-task :class:`SessionStore`;
- :mod:`.engine`: the co-batched step (prefill rows, per-token steps and
  stateless classify rows on one continuous queue over one arena);
- :mod:`.operator`: :class:`DecodeBolt`, one anchored emit per token,
  sticky through ``ring_fields_grouping("session_id")``, migration at
  drain.

``decode_stats()`` is the observatory's hook: a row per live session
store (bolt task) and per shared engine.
"""

from __future__ import annotations

from storm_tpu_torch.decode.engine import STATELESS, DecodeEngine, shared_decode_engine
from storm_tpu_torch.decode.kvcache import ArenaFullError, KvCacheManager
from storm_tpu_torch.decode.operator import (
    DecodeBolt, DecodeConfig, InjectedFailure, SessionSpout)
from storm_tpu_torch.decode.session import DecodeSession, SessionStore

__all__ = [
    "ArenaFullError", "KvCacheManager", "DecodeSession", "SessionStore",
    "DecodeEngine", "shared_decode_engine", "STATELESS", "DecodeBolt",
    "DecodeConfig", "InjectedFailure", "SessionSpout", "decode_stats",
]


def decode_stats() -> dict:
    """The process's decode tier: one row per live :class:`SessionStore`
    and one per shared engine; empty lists when the tier is idle."""
    from storm_tpu_torch.decode.engine import _SHARED, _SHARED_LOCK

    stores = [s.stats() for s in SessionStore.all_stores()]
    with _SHARED_LOCK:
        engines = [e.stats() for e in _SHARED.values()]
    return {
        "stores": sorted(stores, key=lambda r: (r["component"], r["task"])),
        "engines": engines,
        "sessions_live": sum(r["sessions_live"] for r in stores),
        "tokens_emitted": sum(r["tokens_emitted"] for r in stores),
    }
