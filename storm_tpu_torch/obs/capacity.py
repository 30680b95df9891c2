"""Per-executor utilization and per-edge lag watermarks, copied from
``storm_tpu/obs/capacity.py``: the measuring half of the bottleneck
attribution (the fusing half is :mod:`storm_tpu_torch.obs.bottleneck`).

- :class:`CapacityTracker` samples the executors' busy, wait and flush
  seconds (``runtime/executor.py``) into ``capacity = busy / window`` per
  component. Cursors are named (the ``Histogram.window`` contract), so
  independent consumers never take each other's deltas.
- :class:`EdgeLagTracker`: inbox depth and growth per (src -> dst) edge
  from the routing table, the oldest queued record's age per batching
  task (``InferenceBolt.batcher_stats``), the transport's outbound depth
  per peer (none on one host) and the spout's ingress lag
  (``BrokerSpout.ingress_lag``).
- :func:`utilization_snapshot`: one runtime's windowed utilization.

Everything reads plain per-executor floats updated on the owning loop
and queue sizes: no lock on any hot path.
"""

from __future__ import annotations

import time
from typing import Dict, Iterator, List, Optional, Tuple

__all__ = ["CapacityTracker", "EdgeLagTracker", "utilization_snapshot"]


class CapacityTracker:
    """Windowed busy/wait/flush fractions per component.

    ``sample(key)`` returns, per component, the deltas since the last
    ``sample`` with the same key plus derived figures::

        {"component", "tasks", "busy_s", "wait_s", "flush_s", "dt_s",
         "capacity",                    # busy / (tasks * wallclock window)
         "busy_frac", "wait_frac", "flush_frac"}  # of *accounted* time

    ``capacity`` is the Storm UI number (1.0 = every task executing for
    the whole window); the fractions normalize over accounted time so
    they sum to ~1 regardless of scheduler gaps. First call with a key
    (or a task added by rebalance) reports nothing for that task — the
    zero-length-window contract of ``Histogram.window``.
    """

    def __init__(self, runtime, clock=time.monotonic) -> None:
        self.rt = runtime
        self.clock = clock
        # key -> {(component, task): (busy, wait, flush, t)} at last read
        self._cursors: Dict[str, Dict[Tuple[str, int], tuple]] = {}
        # Latest per-component rows from the most recent sample(): the
        # attributor reads them.
        self.last: Dict[str, dict] = {}

    def _executors(self) -> Iterator[Tuple[str, object]]:
        for comp, execs in {**(getattr(self.rt, "spout_execs", None) or {}),
                            **(getattr(self.rt, "bolt_execs", None) or {}),
                            }.items():
            for e in execs:
                yield comp, e

    def sample(self, key: str = "default",
               publish: bool = True) -> Dict[str, dict]:
        now = self.clock()
        cur = self._cursors.setdefault(key, {})
        per_comp: Dict[str, dict] = {}
        seen = set()
        for comp, e in self._executors():
            tkey = (comp, getattr(e, "task_index", 0))
            seen.add(tkey)
            busy = float(getattr(e, "busy_s", 0.0))
            wait = float(getattr(e, "wait_s", 0.0))
            flush = float(getattr(e, "flush_s", 0.0))
            prev = cur.get(tkey)
            cur[tkey] = (busy, wait, flush, now)
            if prev is None:
                continue  # zero-length first window for this task
            row = per_comp.setdefault(comp, {
                "component": comp, "tasks": 0, "busy_s": 0.0,
                "wait_s": 0.0, "flush_s": 0.0, "dt_s": 0.0})
            row["tasks"] += 1
            row["busy_s"] += max(0.0, busy - prev[0])
            row["wait_s"] += max(0.0, wait - prev[1])
            row["flush_s"] += max(0.0, flush - prev[2])
            row["dt_s"] = max(row["dt_s"], max(0.0, now - prev[3]))
        # A task that went away: drop its tuple from EVERY named cursor,
        # not just the one sampled (an idle consumer's key would otherwise
        # pin stale (comp, task) state for the tracker's lifetime). The
        # executor set is the runtime's, so `seen` holds for all keys.
        for ckey, cdict in list(self._cursors.items()):
            for tkey in [k for k in cdict if k not in seen]:
                del cdict[tkey]
            if not cdict and ckey != key:
                del self._cursors[ckey]
        for row in per_comp.values():
            _finish_row(row)
        self.last = per_comp
        if publish:
            g = self.rt.metrics.gauge
            for comp, row in per_comp.items():
                if row["capacity"] is not None:
                    g(comp, "capacity").set(row["capacity"])
                g(comp, "busy_frac").set(row["busy_frac"])
                g(comp, "wait_frac").set(row["wait_frac"])
                g(comp, "flush_frac").set(row["flush_frac"])
        return per_comp

    def drop(self, key: str) -> bool:
        """Forget a named cursor, the tracker's ``Histogram.drop_window``:
        a consumer that lives shorter than the topology calls this on
        exit."""
        return self._cursors.pop(key, None) is not None

    def cursor_keys(self) -> tuple:
        """Live cursor names."""
        return tuple(self._cursors)


def _finish_row(row: dict) -> None:
    """Derive capacity and the accounted-time fractions in place."""
    denom = row["tasks"] * row["dt_s"]
    row["capacity"] = (round(min(1.0, row["busy_s"] / denom), 4)
                       if denom > 0 else None)
    acct = row["busy_s"] + row["wait_s"] + row["flush_s"]
    for k, frac in (("busy_s", "busy_frac"), ("wait_s", "wait_frac"),
                    ("flush_s", "flush_frac")):
        row[frac] = round(row[k] / acct, 4) if acct > 0 else 0.0
    for k in ("busy_s", "wait_s", "flush_s", "dt_s"):
        row[k] = round(row[k], 6)


class EdgeLagTracker:
    """Queue watermarks: where records are piling up, and how fast.

    ``sample()`` returns::

        {"edges":   [{edge, src, dst, stream, depth, growth_per_s}],
         "queues":  [{component, task, pending_rows, oldest_ms}],
         "ingress": [{component, task, records_behind, partitions}],
         "transport": {peer_<idx>: outbound_depth}}

    Depth growth is a windowed delta (one cursor per edge; the first
    sample reports ``growth_per_s: None``). ``queues`` covers the per-task
    batchers in both batching modes; continuous engine queues also show
    in ``Observatory.occupancy``.
    """

    def __init__(self, runtime, clock=time.monotonic) -> None:
        self.rt = runtime
        self.clock = clock
        self._prev: Dict[str, tuple] = {}  # edge -> (depth, t)
        self.last: dict = {}

    def sample(self) -> dict:
        now = self.clock()
        edges: List[dict] = []
        seen_edges = set()
        router = getattr(self.rt, "router", None)
        for src, stream, group in (router.edges() if router is not None
                                   else ()):
            dst = getattr(group, "component_id", "?")
            ekey = f"{src}->{dst}" + ("" if stream == "default"
                                      else f"[{stream}]")
            if ekey in seen_edges:  # two groupings on one edge: one row
                continue
            seen_edges.add(ekey)
            depth = 0
            for q in getattr(group, "inboxes", []):
                try:
                    depth += q.qsize()
                except Exception:
                    pass  # remote proxy without a size
            prev = self._prev.get(ekey)
            self._prev[ekey] = (depth, now)
            growth = None
            if prev is not None:
                dt = now - prev[1]
                growth = round((depth - prev[0]) / dt, 3) if dt > 0 else 0.0
            edges.append({"edge": ekey, "src": src, "dst": dst,
                          "stream": stream, "depth": depth,
                          "growth_per_s": growth})
        for ekey in [k for k in self._prev if k not in seen_edges]:
            del self._prev[ekey]

        queues: List[dict] = []
        for comp, execs in (getattr(self.rt, "bolt_execs", None) or {}).items():
            for e in execs:
                stats_fn = getattr(getattr(e, "bolt", None),
                                   "batcher_stats", None)
                if stats_fn is None:
                    continue
                try:
                    st = stats_fn()
                except Exception:
                    continue
                queues.append({"component": comp,
                               "task": getattr(e, "task_index", 0), **st})

        ingress: List[dict] = []
        for comp, execs in (getattr(self.rt, "spout_execs", None) or {}).items():
            for e in execs:
                lag_fn = getattr(getattr(e, "spout", None),
                                 "ingress_lag", None)
                if lag_fn is None:
                    continue
                try:
                    lag = lag_fn()
                except Exception:
                    continue
                ingress.append({"component": comp,
                                "task": getattr(e, "task_index", 0), **lag})

        out = {"edges": edges, "queues": queues, "ingress": ingress,
               "transport": transport_depths(self.rt)}
        self.last = out
        g = getattr(getattr(self.rt, "metrics", None), "gauge", None)
        if g is not None:
            for row in edges:
                g("obs", f"edge_depth_{row['edge']}").set(row["depth"])
                if row["growth_per_s"] is not None:
                    g("obs", f"edge_growth_{row['edge']}").set(
                        row["growth_per_s"])
            behind = sum(r["records_behind"] for r in ingress
                         if r.get("records_behind") is not None)
            g("obs", "spout_records_behind").set(behind)
        return out


def transport_depths(rt) -> Dict[str, int]:
    """Outbound transport queue depth per peer. Empty for a runtime of
    one process (it has no ``senders``); a dist worker's per peer."""
    out: Dict[str, int] = {}
    for idx, sender in (getattr(rt, "senders", None) or {}).items():
        q = getattr(sender, "queue", None)
        if q is not None:
            out[f"peer_{idx}"] = q.qsize()
    return out


def utilization_snapshot(rt, key: str = "dist") -> dict:
    """Windowed per-component utilization of one runtime. The tracker is
    cached on the runtime, so repeated calls advance its cursor instead
    of priming it again."""
    tr = getattr(rt, "_capacity_tracker", None)
    if tr is None:
        tr = CapacityTracker(rt)
        rt._capacity_tracker = tr
    return {"components": tr.sample(key=key, publish=False),
            "transport": transport_depths(rt)}
