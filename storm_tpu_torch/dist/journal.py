"""The controller's write-ahead journal, copied from
``storm_tpu/dist/journal.py``: durable control-plane state, in the same
format byte for byte, so each package's loader reads the other's journal
and folds it to the same state.

``DistCluster`` holds the mesh recipe (submit config + builder), the
rebalance and swap history, the activation flag and the peer map. The
journal makes every control-plane transition durable *before* the RPCs
that apply it, so a restarted controller folds the log back into a
:class:`ControlPlaneState` and reattaches to the live workers instead of
rebuilding them (and capturing every CUDA graph again).

Format: one JSON object per line in ``<dir>/journal.jsonl``::

    {"crc": 123456, "data": {...}, "kind": "rebalance", "seq": 7}

``crc`` is crc32 over the canonical encoding of ``[seq, kind, data]``,
so a torn write (power loss mid-append) is detected. Recovery contract:

* a corrupt or truncated FINAL record is tolerated: replay stops at the
  last good CRC (the append that never made it simply didn't happen);
* a corrupt record with good records AFTER it means the file itself is
  damaged (bit rot, concurrent writers): :class:`JournalCorrupt`.

Compaction: every ``snapshot_every`` appends the journal folds its own
records into a snapshot (``<dir>/snapshot.json``, CRC-stamped, written
tmp + fsync + rename + directory fsync) and truncates the WAL. A crash
between the snapshot rename and the truncate leaves overlapping records;
the scan skips records at or below the snapshot watermark. Unknown record
kinds are ignored (a newer controller wrote them).

Write-ahead ordering matters for reconciliation: because intent is
journaled before the worker RPCs run, the journal can only ever be
*ahead* of the mesh, never behind. On reattach the journaled value wins
and the controller re-issues the transition to any worker whose actual
state disagrees (see ``DistCluster``'s reattach).
"""

from __future__ import annotations

import json
import logging
import os
import threading
import zlib
from dataclasses import dataclass, field
from typing import Any, Dict, List, Optional, Tuple

log = logging.getLogger("storm_tpu_torch.dist.journal")

JOURNAL_FILE = "journal.jsonl"
SNAPSHOT_FILE = "snapshot.json"

#: Event kinds the fold understands. Unknown kinds are ignored on replay
#: (forward compatibility, mirroring the wire-envelope contract).
KINDS = ("workers", "submit", "rebalance", "swap_model", "peer_update",
         "activation", "kill")


class JournalError(RuntimeError):
    """Base class for journal failures."""


class JournalCorrupt(JournalError):
    """A record failed its CRC (or JSON/seq check) with good records
    after it: the journal file is damaged, not merely torn at the tail.
    Operator action: restore the journal dir from a backup, or delete it
    to force a cold rebuild."""


def _crc(seq: int, kind: str, data: Dict[str, Any]) -> int:
    payload = json.dumps([seq, kind, data], sort_keys=True,
                         separators=(",", ":")).encode("utf-8")
    return zlib.crc32(payload) & 0xFFFFFFFF


def _canonical(data: Dict[str, Any]) -> Dict[str, Any]:
    """``data`` as a reload sees it: through one JSON round trip, so an int
    key is the string a reader gets back. The CRC and the line are taken
    from this form, so the reader's recomputed CRC sorts the same keys the
    same way. storm_tpu stamps the int-keyed form, whose keys sort as
    numbers (2 before 10) where the reloaded strings sort as text ("10"
    before "2"): its journal of a mesh of 11 workers or more fails its own
    CRC on reload (ROADMAP C18). For keys of one digit the bytes are
    storm_tpu's."""
    return json.loads(json.dumps(data))


def _fsync_dir(path: str) -> None:
    """fsync a directory so a rename/create inside it is durable."""
    fd = os.open(path, os.O_RDONLY)
    try:
        os.fsync(fd)
    finally:
        os.close(fd)


@dataclass
class ControlPlaneState:
    """The fold of a journal: everything a controller needs to reattach.

    ``peers``/``pids`` are keyed by worker index (ints — JSON round-trip
    re-keys them, so :meth:`from_dict` coerces back). ``recipe`` mirrors
    ``DistCluster._recipe`` (name, config dict, builder name);
    ``rebalances``/``swaps`` mirror the controller's replay history.
    """

    peers: Dict[int, str] = field(default_factory=dict)
    pids: Dict[int, int] = field(default_factory=dict)
    recipe: Optional[Dict[str, Any]] = None
    placement: Dict[str, int] = field(default_factory=dict)
    rebalances: Dict[str, int] = field(default_factory=dict)
    swaps: Dict[str, Dict[str, Any]] = field(default_factory=dict)
    activated: bool = True
    seq: int = 0        # last folded record's seq (0 = empty journal)
    replayed: int = 0   # WAL records folded by load() (excludes snapshot)

    def apply(self, kind: str, data: Dict[str, Any]) -> None:
        if kind == "workers":
            self.peers = {int(k): v for k, v in data["peers"].items()}
            self.pids = {int(k): int(v)
                         for k, v in (data.get("pids") or {}).items()}
        elif kind == "submit":
            self.recipe = {"name": data["name"], "config": data["config"],
                           "builder": data["builder"]}
            self.placement = dict(data.get("placement") or {})
            self.rebalances = {}
            self.swaps = {}
            self.activated = True
        elif kind == "rebalance":
            self.rebalances[data["component"]] = int(data["parallelism"])
        elif kind == "swap_model":
            self.swaps[data["component"]] = dict(data["overrides"])
        elif kind == "peer_update":
            idx = int(data["idx"])
            self.peers[idx] = data["addr"]
            if data.get("pid") is not None:
                self.pids[idx] = int(data["pid"])
        elif kind == "activation":
            self.activated = bool(data["activated"])
        elif kind == "kill":
            self.recipe = None
            self.placement = {}
            self.rebalances = {}
            self.swaps = {}
            self.activated = True
        # unknown kinds: ignore (a newer controller wrote them)

    def to_dict(self) -> Dict[str, Any]:
        return {"peers": self.peers, "pids": self.pids,
                "recipe": self.recipe, "placement": self.placement,
                "rebalances": self.rebalances, "swaps": self.swaps,
                "activated": self.activated, "seq": self.seq}

    @classmethod
    def from_dict(cls, d: Dict[str, Any]) -> "ControlPlaneState":
        st = cls()
        st.peers = {int(k): v for k, v in (d.get("peers") or {}).items()}
        st.pids = {int(k): int(v) for k, v in (d.get("pids") or {}).items()}
        st.recipe = d.get("recipe")
        st.placement = dict(d.get("placement") or {})
        st.rebalances = {k: int(v)
                         for k, v in (d.get("rebalances") or {}).items()}
        st.swaps = {k: dict(v) for k, v in (d.get("swaps") or {}).items()}
        st.activated = bool(d.get("activated", True))
        st.seq = int(d.get("seq", 0))
        return st


class ControllerJournal:
    """CRC-stamped append-only JSONL WAL with snapshot+compaction.

    Thread-safe; appends fsync the file (and, on first creation, the
    directory) before returning, so an acknowledged transition survives
    a crash. The journal keeps a live fold of its own records so
    :meth:`maybe_snapshot` can compact without the caller rebuilding
    state. The first touch of an existing dir (``load`` or ``append``)
    scans the files, so seqs stay contiguous across controller restarts.
    """

    def __init__(self, journal_dir: str, snapshot_every: int = 64) -> None:
        if snapshot_every < 0:
            raise ValueError("snapshot_every must be >= 0 (0 = never)")
        self.dir = journal_dir
        self.snapshot_every = snapshot_every
        self.path = os.path.join(journal_dir, JOURNAL_FILE)
        self.snap_path = os.path.join(journal_dir, SNAPSHOT_FILE)
        os.makedirs(journal_dir, exist_ok=True)
        self._lock = threading.RLock()
        self._f: Optional[Any] = None
        self._state = ControlPlaneState()
        self._scanned = False
        self._since_snapshot = 0
        self.appends = 0
        self.snapshots = 0

    # ------------------------------------------------------------------
    # recovery

    def load(self) -> ControlPlaneState:
        """Fold snapshot + WAL into a :class:`ControlPlaneState`.

        Tolerates a torn tail (last record bad → replay stops at the
        last good CRC); raises :class:`JournalCorrupt` when a bad record
        has good records after it.
        """
        with self._lock:
            self._state, _good, torn = self._scan()
            self._scanned = True
            self._since_snapshot = self._state.replayed
            if torn:
                log.warning("journal %s: torn tail discarded (%s)",
                            self.path, torn)
            return self._state

    def _scan(self) -> Tuple[ControlPlaneState, List[str], Optional[str]]:
        """Fold the files → (state, replayable WAL lines, torn-tail why).

        Raises :class:`JournalCorrupt` for mid-log damage or a bad
        snapshot; a bad tail is returned as ``torn`` instead.
        """
        st = ControlPlaneState()
        if os.path.exists(self.snap_path):
            st = self._load_snapshot()
        good: List[str] = []
        torn: Optional[str] = None
        replayed = 0
        if os.path.exists(self.path):
            with open(self.path, "r", encoding="utf-8") as f:
                lines = [ln for ln in f.read().splitlines() if ln.strip()]
            for i, line in enumerate(lines):
                rec, why = self._check(line)
                if rec is None:
                    if torn is None:
                        torn = f"line {i + 1}: {why}"
                    continue
                if torn is not None:
                    raise JournalCorrupt(
                        f"{self.path}: {torn} — but line {i + 1} after it "
                        "is valid; the journal is damaged mid-log, "
                        "refusing to replay across a gap")
                if rec["seq"] <= st.seq:
                    # snapshot overlap after an interrupted compaction
                    good.append(line)
                    continue
                if rec["seq"] != st.seq + 1:
                    raise JournalCorrupt(
                        f"{self.path}: line {i + 1} jumps seq "
                        f"{st.seq} -> {rec['seq']}; records are missing "
                        "mid-log, refusing to replay across the gap")
                good.append(line)
                st.apply(rec["kind"], rec["data"])
                st.seq = rec["seq"]
                replayed += 1
        st.replayed = replayed
        return st, good, torn

    def _load_snapshot(self) -> ControlPlaneState:
        try:
            with open(self.snap_path, encoding="utf-8") as f:
                snap = json.load(f)
            want = snap["crc"]
            got = _crc(snap["state"].get("seq", 0), "snapshot", snap["state"])
        except (ValueError, KeyError, TypeError, AttributeError) as e:
            raise JournalCorrupt(
                f"{self.snap_path}: unreadable snapshot: {e}")
        if want != got:
            raise JournalCorrupt(
                f"{self.snap_path}: snapshot CRC mismatch "
                f"(recorded {want}, computed {got})")
        return ControlPlaneState.from_dict(snap["state"])

    @staticmethod
    def _check(line: str):
        """Parse+verify one record line → (record | None, reason)."""
        try:
            rec = json.loads(line)
        except ValueError as e:
            return None, f"bad JSON ({e})"
        if not isinstance(rec, dict) or \
                not {"seq", "kind", "data", "crc"} <= set(rec):
            return None, "missing fields"
        if _crc(rec["seq"], rec["kind"], rec["data"]) != rec["crc"]:
            return None, "CRC mismatch"
        return rec, ""

    # ------------------------------------------------------------------
    # append path

    def append(self, kind: str, **data: Any) -> int:
        """Durably append one record; returns its seq."""
        with self._lock:
            if self._f is None:
                self._open_for_append()
            seq = self._state.seq + 1
            data = _canonical(data)
            rec = {"seq": seq, "kind": kind, "data": data,
                   "crc": _crc(seq, kind, data)}
            self._f.write(json.dumps(rec, sort_keys=True,
                                     separators=(",", ":")) + "\n")
            self._f.flush()
            os.fsync(self._f.fileno())
            self._state.apply(kind, data)
            self._state.seq = seq
            self._since_snapshot += 1
            self.appends += 1
            return seq

    def _open_for_append(self) -> None:
        """Open the WAL, folding existing content and dropping any torn
        tail first — appending after a torn line would put a good record
        behind a bad one, exactly the mid-log shape ``load`` rejects."""
        existed = os.path.exists(self.path)
        state, good, torn = self._scan()
        if not self._scanned:
            self._state = state
            self._scanned = True
            self._since_snapshot = state.replayed
        if torn is not None:
            with open(self.path, "w", encoding="utf-8") as f:
                f.write("".join(ln + "\n" for ln in good))
                f.flush()
                os.fsync(f.fileno())
        self._f = open(self.path, "a", encoding="utf-8")
        if not existed:
            _fsync_dir(self.dir)

    # ------------------------------------------------------------------
    # snapshot + compaction

    def maybe_snapshot(self) -> bool:
        """Compact when ``snapshot_every`` appends have accumulated."""
        with self._lock:
            due = bool(self.snapshot_every) and \
                self._since_snapshot >= self.snapshot_every
            if due:
                self.snapshot()
            return due

    def snapshot(self) -> None:
        """Write a durable snapshot of the fold, then truncate the WAL.

        Ordering is the rename trick from ``FileStateBackend.save``: the
        snapshot is complete and fsynced (file AND directory) before the
        WAL shrinks, so a crash anywhere leaves a replayable journal.
        """
        with self._lock:
            state = _canonical(self._state.to_dict())
            snap = {"state": state,
                    "crc": _crc(state.get("seq", 0), "snapshot", state)}
            tmp = self.snap_path + ".tmp"
            with open(tmp, "w", encoding="utf-8") as f:
                json.dump(snap, f, sort_keys=True, separators=(",", ":"))
                f.flush()
                os.fsync(f.fileno())
            os.replace(tmp, self.snap_path)
            _fsync_dir(self.dir)
            if self._f is not None:
                self._f.close()
                self._f = None
            with open(self.path, "w", encoding="utf-8") as f:
                f.flush()
                os.fsync(f.fileno())
            self._since_snapshot = 0
            self.snapshots += 1

    # ------------------------------------------------------------------

    def stats(self) -> Dict[str, int]:
        with self._lock:
            return {"appends": self.appends, "snapshots": self.snapshots,
                    "seq": self._state.seq,
                    "since_snapshot": self._since_snapshot}

    def close(self) -> None:
        with self._lock:
            if self._f is not None:
                self._f.close()
                self._f = None
