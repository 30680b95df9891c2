"""XOR ack ledger, copied from ``storm_tpu/runtime/acker.py``: Storm's
at-least-once tuple tracking, plus the live-edge bookkeeping the
exactly-once sink reads.

- A spout root opens an entry whose value is the XOR of every live edge
  anchored to it: each anchored emit XORs a fresh edge id in
  (:meth:`AckLedger.anchor`) and each ack XORs the consumed edge out
  (:meth:`AckLedger.ack_edge`). The entry reaching zero means the whole
  tuple tree was processed, and the spout's ``ack(msg_id)`` fires; an
  explicit fail or a timeout fires ``fail(msg_id)`` instead.
- Beside the XOR each entry keeps the exact count of live (delivered,
  unacked) edges: :meth:`AckLedger.outstanding` answers the
  transactional sink's "does my buffer hold the whole rest of this
  tree?", :meth:`AckLedger.watch_live` wakes it after every ack of the
  tree, and :meth:`AckLedger.watch` tells it the tree's fate. An ack
  that arrives before its anchor parks and cancels against it, so the
  count never dips.

One dict for one process (Storm shards the entries across acker tasks).
"""

from __future__ import annotations

import time
from dataclasses import dataclass, field
from typing import Any, Callable, Dict, List


@dataclass
class _Entry:
    ack_val: int
    msg_id: Any
    on_done: Callable[[Any, bool, float], None]  # (msg_id, ok, root_ts)
    born: float
    root_ts: float
    # Exact live-edge refcount (kept alongside the XOR so the EOS sink can
    # ask "is this batch the tree's last outstanding work?" — see
    # ``outstanding``). Only maintained by anchor/ack_edge; the legacy
    # ``xor`` entry point can't tell an emit from an ack and leaves it.
    live: int = 0
    # Anchored-but-unacked edge ids, plus acks that ARRIVED BEFORE their
    # anchor: in dist topologies the anchor travels from the emitting
    # worker and the ack from the consuming worker over independent
    # links, so the owner can see them out of order. Pairing them here
    # keeps ``live`` exact and completion correct under any interleaving
    # — without it a transient dip could fake tree closure for the EOS
    # sink (committing offsets past unproduced siblings) or fake tree
    # death (spurious replays).
    edges: set = field(default_factory=set)
    early_acks: set = field(default_factory=set)
    watchers: List[Callable[[bool], None]] = field(default_factory=list)
    # fired (with the root id) after every live-count DECREASE while the
    # entry is open — the EOS sink's tree-closure trigger (flush the
    # moment the last non-sink edge settles instead of waiting out the
    # txn deadline). Die with the entry.
    live_watchers: List[Callable[[int], None]] = field(default_factory=list)


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

    def init_root(
        self,
        root_id: int,
        msg_id: Any,
        on_done: Callable[[Any, bool, float], None],
        root_ts: float,
    ) -> None:
        # ack_val starts at 0; the emitting collector XORs in one edge id per
        # delivery before the first enqueue, so the entry can only reach zero
        # again once every delivered edge has been acked.
        self._entries[root_id] = _Entry(
            ack_val=0,
            msg_id=msg_id,
            on_done=on_done,
            born=time.monotonic(),
            root_ts=root_ts,
        )

    def xor(self, root_id: int, edge_id: int) -> None:
        """Fold one edge event (emit or ack of that edge) into the ledger."""
        e = self._entries.get(root_id)
        if e is None:  # already completed/failed/timed out — late event, drop
            return
        e.ack_val ^= edge_id
        if e.ack_val == 0:
            del self._entries[root_id]
            self.acked += 1
            e.on_done(e.msg_id, True, e.root_ts)
            for w in e.watchers:
                w(True)

    def anchor(self, root_id: int, edge_id: int) -> None:
        """A new live edge was delivered under this root (emit event)."""
        e = self._entries.get(root_id)
        if e is not None:
            if edge_id in e.early_acks:
                # its ack overtook it on another link: cancel the pair —
                # net zero live edges, net zero XOR
                e.early_acks.discard(edge_id)
                return
            e.edges.add(edge_id)
            e.live += 1
        self.xor(root_id, edge_id)

    def ack_edge(self, root_id: int, edge_id: int) -> None:
        """A live edge was consumed (ack event)."""
        e = self._entries.get(root_id)
        if e is not None:
            if edge_id not in e.edges:
                # ack before its anchor (independent dist links): park it;
                # the anchor cancels against it, counts never dip
                e.early_acks.add(edge_id)
                return
            e.edges.discard(edge_id)
            e.live -= 1
            watchers = list(e.live_watchers)
        else:
            watchers = []
        self.xor(root_id, edge_id)
        for w in watchers:
            w(root_id)

    def watch_live(self, root_id: int, cb: Callable[[int], None]) -> bool:
        """Register ``cb(root_id)`` to fire after every live-edge DECREASE
        on this root while it is open. Returns False if the root is
        already gone. Watchers die with the entry (no unregistration)."""
        e = self._entries.get(root_id)
        if e is None:
            return False
        e.live_watchers.append(cb)
        return True

    def outstanding(self, root_id: int) -> int:
        """Exact count of live (delivered, unacked) edges for this root.

        0 means the tree is complete (or never existed / already failed).
        Valid only if every edge event went through anchor/ack_edge.
        """
        e = self._entries.get(root_id)
        return e.live if e is not None else 0

    def watch(self, root_id: int, cb: Callable[[bool], None]) -> bool:
        """Register ``cb(ok)`` to fire when the root completes, fails, or
        times out. Returns False (cb NOT registered) if the root is already
        gone — the caller saw a stale id and must decide for itself.
        """
        e = self._entries.get(root_id)
        if e is None:
            return False
        e.watchers.append(cb)
        return True

    def fail_root(self, root_id: int) -> None:
        e = self._entries.pop(root_id, None)
        if e is None:
            return
        self.failed += 1
        e.on_done(e.msg_id, False, e.root_ts)
        for w in e.watchers:
            w(False)

    def sweep(self) -> int:
        """Fail entries older than the message timeout. Returns count failed.

        Called periodically by the cluster (replaces Storm's
        ``topology.message.timeout.secs`` mechanism).
        """
        if self.timeout_s <= 0:
            return 0
        now = time.monotonic()
        stale = [rid for rid, e in self._entries.items() if now - e.born > self.timeout_s]
        for rid in stale:
            e = self._entries.pop(rid, None)
            if e is not None:
                self.timed_out += 1
                self.failed += 1
                e.on_done(e.msg_id, False, e.root_ts)
                for w in e.watchers:
                    w(False)
        return len(stale)
