"""DecodeSession and SessionStore, copied from
``storm_tpu/decode/session.py``: the per-task session tier.

A :class:`DecodeSession` is what the decode tier is keyed on: the ring
grouping hashes its ``session_id``, the KV arena leases a block per live
session, every emitted token carries ``(session_id, token_index)``, and
checkpoints fold sessions (token log, commit watermark, serialized KV)
into the bolt's :class:`~storm_tpu_torch.runtime.state.KeyValueState`.

Exactly-once bookkeeping is two integers:

- ``len(tokens)``: how far generation has gone (greedy decode is
  deterministic, so the log is also the replay oracle);
- ``committed``: the emit watermark; tokens below it were emitted and
  checkpointed and are never emitted again. A replayed request emits
  exactly ``tokens[committed:]``.

``restored`` records how a session came back after a restart: ``"kv"``
(cache migrated, nothing recomputed), ``"log"`` (the log survived but not
the KV: one warm re-prefill rebuilds the cache, no token lost or
re-emitted) or ``""`` (fresh).
"""

from __future__ import annotations

import base64
import threading
import time
import weakref
from dataclasses import dataclass, field
from typing import Dict, List, Optional

__all__ = ["DecodeSession", "SessionStore"]


@dataclass
class DecodeSession:
    session_id: str
    prompt: List[int] = field(default_factory=list)
    max_new_tokens: int = 16
    tokens: List[int] = field(default_factory=list)   # generated so far
    committed: int = 0   # emit watermark: tokens[:committed] are downstream
    done: bool = False
    restored: str = ""   # "" | "kv" | "log"
    created: float = field(default_factory=time.monotonic)
    ttft_ms: Optional[float] = None
    early_exits: int = 0

    @property
    def context(self) -> List[int]:
        """Full token context (prompt + generated) — what a warm
        re-prefill replays into a fresh KV slot."""
        return self.prompt + self.tokens

    def to_state(self, kv_blob: Optional[bytes] = None) -> dict:
        """JSON-serializable snapshot for KeyValueState (FileStateBackend
        stores JSON, so the KV blob rides base64)."""
        d = {
            "session_id": self.session_id,
            "prompt": list(self.prompt),
            "max_new_tokens": int(self.max_new_tokens),
            "tokens": list(self.tokens),
            "committed": int(self.committed),
            "done": bool(self.done),
        }
        if kv_blob is not None:
            d["kv_b64"] = base64.b64encode(kv_blob).decode("ascii")
        return d

    @classmethod
    def from_state(cls, d: dict) -> "DecodeSession":
        return cls(
            session_id=str(d["session_id"]),
            prompt=[int(t) for t in d.get("prompt", ())],
            max_new_tokens=int(d.get("max_new_tokens", 16)),
            tokens=[int(t) for t in d.get("tokens", ())],
            committed=int(d.get("committed", 0)),
            done=bool(d.get("done", False)),
        )


def state_kv_blob(d: dict) -> Optional[bytes]:
    b64 = d.get("kv_b64")
    return base64.b64decode(b64) if b64 else None


class SessionStore:
    """Session registry for one decode bolt task.

    Registered in a module-weak set at construction so the observatory
    (``storm_tpu_torch.decode.decode_stats``) can aggregate live sessions and
    token counts across every replica in the process without holding
    them alive.
    """

    _ALL: "weakref.WeakSet[SessionStore]" = weakref.WeakSet()

    def __init__(self, component: str = "decode-bolt",
                 task_index: int = 0) -> None:
        self.component = component
        self.task_index = task_index
        self._lock = threading.Lock()
        self._sessions: Dict[str, DecodeSession] = {}
        self.tokens_emitted = 0
        self.sessions_started = 0
        self.sessions_restored = 0   # restored with state (kv or log)
        self.sessions_cold = 0       # arrived with no restorable state
        SessionStore._ALL.add(self)

    # ---- CRUD ---------------------------------------------------------------

    def get(self, session_id: str) -> Optional[DecodeSession]:
        with self._lock:
            return self._sessions.get(session_id)

    def put(self, sess: DecodeSession) -> DecodeSession:
        with self._lock:
            self._sessions[sess.session_id] = sess
        return sess

    def get_or_create(self, session_id: str, prompt: List[int],
                      max_new_tokens: int) -> DecodeSession:
        with self._lock:
            sess = self._sessions.get(session_id)
            if sess is None:
                sess = DecodeSession(session_id, list(prompt),
                                     int(max_new_tokens))
                self._sessions[session_id] = sess
                self.sessions_started += 1
            return sess

    def remove(self, session_id: str) -> None:
        with self._lock:
            self._sessions.pop(session_id, None)

    def all(self) -> List[DecodeSession]:
        with self._lock:
            return list(self._sessions.values())

    def __len__(self) -> int:
        with self._lock:
            return len(self._sessions)

    # ---- stats ---------------------------------------------------------------

    def stats(self) -> dict:
        with self._lock:
            sessions = list(self._sessions.values())
        live = [s for s in sessions if not s.done]
        return {
            "component": self.component,
            "task": self.task_index,
            "sessions": len(sessions),
            "sessions_live": len(live),
            "sessions_done": len(sessions) - len(live),
            "sessions_started": self.sessions_started,
            "sessions_restored": self.sessions_restored,
            "sessions_cold": self.sessions_cold,
            "tokens": sum(len(s.tokens) for s in sessions),
            "tokens_emitted": self.tokens_emitted,
            "committed": sum(s.committed for s in sessions),
        }

    @classmethod
    def all_stores(cls) -> List["SessionStore"]:
        return list(cls._ALL)
