"""Data-plane copy ledger: the bytes and copies of each hop of the record
path, copied from ``storm_tpu/obs/copyledger.py``.

Every serialize, deserialize or copy boundary on the record path reports
one :func:`record` call per batch (per record where no batch exists):

============= =====================================================
stage          boundary
============= =====================================================
spout_ingest   raw broker payload arrival (the amplification denominator)
spout_scheme   the spout's bytes -> str conversion ("string" scheme)
json_decode    ``{"instances": ...}`` parse -> a fresh float32 array
tuple_route    tuple materialization and fan-out in the collector
staging        the engine's fused pad + cast write into a pooled pinned
               buffer (two passes on the uint8 wire: the f32 stage and
               the cast into the wire buffer)
h2d            the pinned buffer's copy to the card on the copy stream
d2h            the result back: the card's copy into the pooled pinned
               output buffer, then the real rows out of it into a fresh
               array (two copies; storm_tpu's ``np.asarray`` of the
               device result is one, see below)
json_encode    ``{"predictions": ...}`` serialization
sink_encode    the sink's str -> bytes re-encode before produce
wire_encode    dist binary or JSON frame encode (``dist/wire.py``;
               bytes 0 when the shm lane wrote the frame)
shm_transport  the shared-memory segment write between two dist workers
               on one host (``dist/shm.py``): the lane's one copy
wire_decode    dist frame decode back to tuples (bytes 0 over shm views)
============= =====================================================

:func:`merge_windows` adds the trees of several dist workers.

Where the port moves bytes otherwise than storm_tpu, its rows say what the
port does. One hop differs: ``d2h`` is two copies per batch (the padded
result into the pinned ``host_out``, which the pool recycles, then the
``n`` real rows into a fresh array), ``padded * K * 4 + n * K * 4`` bytes
with one allocation; storm_tpu copies the padded result once into a fresh
host array (``padded * K * 4`` bytes, one copy, one allocation). Every
other hop moves the same bytes with the same copies.

Each ``(stage, engine)`` hop keeps a reservoir :class:`Histogram` of bytes
per call plus copy, allocation and record counters, all windowed by named
cursors. ``snapshot()`` folds the hops into the per-record copy tree:
bytes and copies per record by stage, and ``copy_amplification`` (bytes
moved over payload bytes ingested; ``spout_ingest`` is the denominator).

A process singleton behind a module-level sink: :func:`ensure_installed`
attaches it (the inference operator's and the sink's ``prepare`` call
it), :func:`set_enabled` detaches it, and while detached :func:`record`
and :func:`active` cost one global read. :func:`record` never fails a
batch: it swallows everything.
"""

from __future__ import annotations

import threading
from typing import Dict, Iterable, List, Optional, Tuple

from storm_tpu_torch.runtime.metrics import Histogram

__all__ = [
    "CopyLedger",
    "STAGE_ORDER",
    "active",
    "copy_ledger",
    "copy_snapshot",
    "derive_tree",
    "enabled",
    "ensure_installed",
    "live_keys",
    "merge_windows",
    "record",
    "set_enabled",
]

#: Record-path order, used for display ranking ties and docs; a stage
#: missing here still ledgers (sorted last) — the set is not closed.
STAGE_ORDER = (
    "spout_ingest", "spout_scheme", "batch_route", "json_decode",
    "tuple_route", "wire_encode", "shm_transport", "wire_decode",
    "marshal_encode", "marshal_decode",
    "staging", "h2d", "d2h", "json_encode", "sink_encode",
)

#: The amplification denominator: payload bytes as they arrived.
INGEST_STAGE = "spout_ingest"

# Small reservoir — the ledger tracks the recent bytes-per-call
# distribution; cumulative totals live in the counters.
_RING = 512


class _Hop:
    """One (stage, engine) boundary: a bytes-per-call reservoir plus
    monotonic copy/alloc/record counters with named windowed cursors
    (keys shared with the bytes histogram's own cursors)."""

    __slots__ = ("bytes", "copies", "allocs", "records",
                 "_lock", "_windows")

    def __init__(self) -> None:
        self.bytes = Histogram(_RING)
        self.copies = 0
        self.allocs = 0
        self.records = 0
        self._lock = threading.Lock()
        # key -> (copies, allocs, records) at last window() call.
        self._windows: Dict[str, tuple] = {}

    def observe(self, nbytes: int, copies: int, allocs: int,
                records: int) -> None:
        self.bytes.observe(float(nbytes))
        with self._lock:
            self.copies += copies
            self.allocs += allocs
            self.records += records

    def totals(self) -> dict:
        with self._lock:
            copies, allocs, records = self.copies, self.allocs, self.records
        return {"calls": self.bytes.count, "bytes": self.bytes.sum,
                "copies": copies, "allocs": allocs, "records": records}

    def window(self, key: str) -> Optional[dict]:
        """Delta since the last ``window(key)`` (None on the first call —
        the zero-length-window contract of ``Histogram.window``)."""
        w = self.bytes.window(key)
        with self._lock:
            cur = (self.copies, self.allocs, self.records)
            prev = self._windows.get(key)
            self._windows[key] = cur
        if prev is None:
            return None
        return {"calls": w["count"], "bytes": w["sum"], "dt_s": w["dt_s"],
                "copies": max(0, cur[0] - prev[0]),
                "allocs": max(0, cur[1] - prev[1]),
                "records": max(0, cur[2] - prev[2])}

    def drop_window(self, key: str) -> bool:
        hit = self.bytes.drop_window(key)
        with self._lock:
            return self._windows.pop(key, None) is not None or hit

    def window_keys(self) -> tuple:
        with self._lock:
            return tuple(set(self.bytes.window_keys())
                         | set(self._windows))


class CopyLedger:
    """Process-wide copy tree: ``(stage, engine) -> _Hop``. Thread-safe
    (the event loop and the engines' fetch threads write; readers read
    from anywhere)."""

    def __init__(self) -> None:
        self._lock = threading.Lock()
        self._hops: Dict[Tuple[str, str], _Hop] = {}

    # ---- the write path ------------------------------------------------------

    def record(self, stage: str, nbytes: int, *, copies: int = 1,
               allocs: int = 0, records: int = 1,
               engine: str = "-") -> None:
        """One batched crossing of a copy boundary. ``nbytes`` is the
        payload size that crossed the hop; ``copies`` counts physical
        copy passes actually made (0 for arrivals and zero-copy views),
        ``allocs`` fresh buffer/object allocations, ``records`` the
        pipeline records the call covered."""
        key = (stage, engine)
        hop = self._hops.get(key)
        if hop is None:
            with self._lock:
                hop = self._hops.setdefault(key, _Hop())
        hop.observe(int(nbytes), int(copies), int(allocs), int(records))

    # ---- the read path -------------------------------------------------------

    def _items(self) -> List[Tuple[Tuple[str, str], _Hop]]:
        with self._lock:
            return list(self._hops.items())

    def hop_keys(self) -> List[Tuple[str, str]]:
        with self._lock:
            return sorted(self._hops)

    def snapshot(self) -> dict:
        """Cumulative copy tree (JSON-safe): per-stage rollups with
        per-engine rows, totals, and the amplification ratio."""
        rows = [{"stage": s, "engine": e, **hop.totals()}
                for (s, e), hop in self._items()]
        return derive_tree(rows)

    def windowed(self, key: str) -> dict:
        """Copy tree of the deltas since the last ``windowed(key)`` call.
        The first call with a key primes the cursors and reports an empty
        tree."""
        rows = []
        dt = 0.0
        for (s, e), hop in self._items():
            w = hop.window(key)
            if w is None:
                continue
            dt = max(dt, w.pop("dt_s"))
            rows.append({"stage": s, "engine": e, **w})
        out = derive_tree(rows)
        out["dt_s"] = round(dt, 3)
        return out

    # ---- cursor / hop hygiene ------------------------------------------------

    def drop_window(self, key: str) -> bool:
        """Forget one named cursor on every hop (a retiring reader)."""
        hit = False
        for _k, hop in self._items():
            hit = hop.drop_window(key) or hit
        return hit

    def window_keys(self) -> tuple:
        """Union of live cursor names across hops (leak check)."""
        keys: set = set()
        for _k, hop in self._items():
            keys.update(hop.window_keys())
        return tuple(sorted(keys))

    def prune(self, live: Iterable[str]) -> int:
        """Drop hops whose engine or component is not in ``live``: a
        model swap that retires an engine must not pin its histograms
        (and every named cursor on them) for the process's lifetime. Hops
        on the shared ``"-"`` engine always survive. Returns the number of
        hops dropped."""
        keep = set(live)
        keep.add("-")
        dropped = 0
        with self._lock:
            for key in [k for k in self._hops if k[1] not in keep]:
                del self._hops[key]
                dropped += 1
        return dropped

    def reset(self) -> None:
        """Drop every hop (a measured run starts clean)."""
        with self._lock:
            self._hops.clear()


# ---- tree math ------------------------------------------------------------------


def derive_tree(rows: List[dict]) -> dict:
    """Fold raw hop rows into the per-record copy tree.

    ``rows`` are ``{stage, engine, calls, bytes, copies, allocs,
    records}`` dicts, live hop totals or windowed deltas; the math is the
    same for both."""
    stages: Dict[str, dict] = {}
    for r in rows:
        st = stages.setdefault(r["stage"], {
            "bytes": 0.0, "copies": 0, "allocs": 0, "records": 0,
            "calls": 0, "engines": {}})
        for k in ("bytes", "copies", "allocs", "records", "calls"):
            st[k] += r.get(k, 0) or 0
        eng = st["engines"].setdefault(r["engine"], {
            "bytes": 0.0, "copies": 0, "allocs": 0, "records": 0,
            "calls": 0})
        for k in ("bytes", "copies", "allocs", "records", "calls"):
            eng[k] += r.get(k, 0) or 0
    order = {s: i for i, s in enumerate(STAGE_ORDER)}
    out_stages: Dict[str, dict] = {}
    total_bytes = total_copies = total_allocs = 0.0
    for stage in sorted(stages, key=lambda s: (order.get(s, len(order)), s)):
        st = stages[stage]
        recs = st["records"]
        out_stages[stage] = {
            "bytes": round(st["bytes"], 1),
            "copies": st["copies"],
            "allocs": st["allocs"],
            "records": recs,
            "calls": st["calls"],
            "bytes_per_record": (round(st["bytes"] / recs, 1)
                                 if recs else None),
            "copies_per_record": (round(st["copies"] / recs, 3)
                                  if recs else None),
            "engines": st["engines"],
        }
        if stage != INGEST_STAGE:
            total_bytes += st["bytes"]
            total_copies += st["copies"]
            total_allocs += st["allocs"]
    ingest = stages.get(INGEST_STAGE, {})
    ingest_bytes = float(ingest.get("bytes", 0.0))
    ingest_records = int(ingest.get("records", 0))
    amp = (round(total_bytes / ingest_bytes, 3) if ingest_bytes > 0
           else None)
    return {
        "stages": out_stages,
        "totals": {"bytes": round(total_bytes, 1),
                   "copies": int(total_copies),
                   "allocs": int(total_allocs),
                   "ingest_bytes": round(ingest_bytes, 1),
                   "ingest_records": ingest_records},
        "copy_amplification": amp,
    }


def merge_windows(per_worker: Dict[int, dict]) -> dict:
    """The dist ``copies`` merge: add the raw bytes, copies, allocations,
    records and calls of each (stage, engine) across workers, take the
    longest window span, and derive the per-record figures and the
    amplification again from the totals (ratios do not merge, quantities
    do)."""
    acc: Dict[Tuple[str, str], dict] = {}
    dt = 0.0
    for _idx, tree in sorted(per_worker.items()):
        dt = max(dt, float(tree.get("dt_s", 0.0) or 0.0))
        for stage, st in (tree.get("stages") or {}).items():
            for engine, row in (st.get("engines") or {}).items():
                a = acc.setdefault((stage, engine), {
                    "stage": stage, "engine": engine, "bytes": 0.0,
                    "copies": 0, "allocs": 0, "records": 0, "calls": 0})
                for k in ("bytes", "copies", "allocs", "records", "calls"):
                    a[k] += row.get(k, 0) or 0
    out = derive_tree(list(acc.values()))
    out["dt_s"] = round(dt, 3)
    return out


def live_keys(rt) -> set:
    """Everything the ledger's engine dimension may reference for ``rt``
    now: component ids (spout, decode and sink hops) and the live
    engines' profile keys (staging, h2d and d2h hops). The prune set after
    a model swap."""
    live = set(getattr(rt, "spout_execs", None) or {})
    live.update(getattr(rt, "bolt_execs", None) or {})
    try:
        from storm_tpu_torch.infer.engine import live_engines

        for e in live_engines():
            key = getattr(e, "profile_key", None)
            if key:
                live.add(key)
    except Exception:
        pass  # the engine layer cannot load: component ids are the whole set
    return live


def copy_snapshot(rt, key: str = "copies") -> dict:
    """Windowed copy tree for one runtime (the first call with a key
    primes and reports empty). Hops of engines or components no longer
    live in ``rt`` are pruned first, so an idle reader's cursors cannot
    pin retired state."""
    _LEDGER.prune(live_keys(rt))
    return _LEDGER.windowed(key)


# ---- process singleton + record-path wiring -----------------------------------

_LEDGER = CopyLedger()
_ENABLED = True
# The record-path sink: None until ensure_installed — detached, every
# instrumentation site pays one module-global read and returns.
_SINK: Optional[CopyLedger] = None


def copy_ledger() -> CopyLedger:
    """The process-wide ledger (the record path spans threads and
    components; per-topology trees are cut by the engine dimension)."""
    return _LEDGER


def ensure_installed() -> CopyLedger:
    """Attach the record-path hook to the singleton (idempotent). Called
    from the inference operator's and the sink's ``prepare``: wherever a
    record path starts moving bytes."""
    global _SINK
    _SINK = _LEDGER if _ENABLED else None
    return _LEDGER


def set_enabled(flag: bool) -> None:
    """Ledger kill switch: detaches the sink so every hop pays a single
    None check."""
    global _ENABLED
    _ENABLED = bool(flag)
    ensure_installed()


def enabled() -> bool:
    return _ENABLED


def active() -> bool:
    """True when the ledger is attached — hot paths that must *compute*
    a size before recording (a sum over a chunk) gate on this so the
    detached path pays nothing but this call."""
    return _SINK is not None


def record(stage: str, nbytes: int, *, copies: int = 1, allocs: int = 0,
           records: int = 1, engine: str = "-") -> None:
    """Module-level hot-path entry: no-op when detached; never raises
    (an observability hook must never fail a batch)."""
    sink = _SINK
    if sink is None:
        return
    try:
        sink.record(stage, nbytes, copies=copies, allocs=allocs,
                    records=records, engine=engine)
    except Exception:
        pass
