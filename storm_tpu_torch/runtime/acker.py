"""XOR ack ledger: at-least-once tuple tracking, copied from
``storm_tpu/runtime/acker.py`` (the single-process algorithm, without the
exactly-once sink's live-edge bookkeeping).

A spout root opens an entry; every anchored emit XORs a fresh edge id in
and every ack XORs the consumed edge out; the entry reaching zero means the
whole tuple tree was processed and the spout's ``ack(msg_id)`` fires. An
explicit fail or a timeout fires ``fail(msg_id)`` instead.
"""

from __future__ import annotations

import time
from dataclasses import dataclass
from typing import Any, Callable, Dict


@dataclass
class _Entry:
    ack_val: int
    msg_id: Any
    on_done: Callable[[Any, bool], None]  # (msg_id, ok)
    born: float


class AckLedger:
    def __init__(self, timeout_s: float = 30.0) -> None:
        self.timeout_s = timeout_s
        self._entries: Dict[int, _Entry] = {}
        self.acked = 0
        self.failed = 0
        self.timed_out = 0

    @property
    def inflight(self) -> int:
        return len(self._entries)

    def init_root(self, root_id: int, msg_id: Any,
                  on_done: Callable[[Any, bool], None], root_ts: float) -> None:
        # ack_val starts at 0; the emitting collector XORs in one edge id per
        # delivery before the first enqueue, so the entry reaches zero again
        # only once every delivered edge has been acked.
        self._entries[root_id] = _Entry(0, msg_id, on_done, time.monotonic())

    def xor(self, root_id: int, edge_id: int) -> None:
        """Fold one edge event (emit or ack of that edge) into the ledger."""
        e = self._entries.get(root_id)
        if e is None:  # already completed/failed/timed out: late event
            return
        e.ack_val ^= edge_id
        if e.ack_val == 0:
            del self._entries[root_id]
            self.acked += 1
            e.on_done(e.msg_id, True)

    def fail_root(self, root_id: int) -> None:
        e = self._entries.pop(root_id, None)
        if e is None:
            return
        self.failed += 1
        e.on_done(e.msg_id, False)

    def sweep(self) -> int:
        """Fail entries older than the message timeout; returns how many."""
        if self.timeout_s <= 0:
            return 0
        now = time.monotonic()
        stale = [rid for rid, e in self._entries.items()
                 if now - e.born > self.timeout_s]
        for rid in stale:
            e = self._entries.pop(rid, None)
            if e is not None:
                self.timed_out += 1
                self.failed += 1
                e.on_done(e.msg_id, False)
        return len(stale)
