"""Controller: the Nimbus-equivalent of the distributed runtime, ported
from ``storm_tpu/dist/controller.py``.

The reference submits through ``StormSubmitter``/``NimbusClient`` over
Thrift and lets Nimbus schedule executors onto 8 workers
(MainTopology.java:69-77). Here the controller:

- spawns worker processes on this host (``subprocess.Popen`` of a fresh
  interpreter running ``python -m storm_tpu_torch.dist.worker``, never a
  fork of this process, so a CUDA context here is never inherited), each
  on the controller's ``device`` (the card unless the caller asks for the
  CPU), or attaches to running workers by address;
- ships each worker the topology *recipe* (``Config.to_dict()``, a
  builder name, the placement and the peer table) over the Control RPC:
  workers rebuild the topology locally, so no object crosses the wire;
- starts it in two phases: bolts everywhere first, then spouts;
- merges metrics, utilization, copies, traces and health; rebalances,
  swaps models, drains, deactivates, activates and kills;
- watches the workers' heartbeats (``start_monitor``) and replaces a dead
  one (``recover_worker``): respawned at its index, its peers rewired,
  the recipe shipped to it again at the live parallelism and model;
- with a ``journal_dir``, journals every control-plane transition
  (:mod:`storm_tpu_torch.dist.journal`) before the calls that apply it:
  ``workers``, ``submit``, ``rebalance``, ``swap_model``, ``peer_update``,
  ``activation`` and ``kill``. A controller started on that journal
  (``reattach=True``) probes each journaled worker (``state_report``),
  adopts the live ones as they are (no submit, so engines and CUDA
  graphs stay), re-issues the rebalances a worker missed
  (``reconcile_parallelism``) and replaces the dead ones; with no
  survivor it spawns a fresh mesh. ``abandon`` drops the controller's
  handles and leaves the workers serving (a controller crash, in
  process). An adopted worker has no ``Popen`` handle: it is waited for,
  and killed where it must be, by its pid, and only while that pid is
  still the worker's;
- restarts the workers one at a time (``rolling_restart``: drain, exit,
  respawn at the same index on the controller's device, recipe shipped
  again, the monitor held off the restarting worker), repositions a
  spout (``seek``), starts a ``torch.profiler`` capture on a worker
  (``profile``) and merges the workers' decode tiers
  (``decode_sessions``).

Placement: explicit ``{component_id: worker_idx}``, resource-aware when
``topology.component_resources`` hints exist (``plan_placement``), else
round-robin with spouts pinned to worker 0 (the ledgers live with their
spouts). Submit applies the dist default of the raw scheme with record
frames (:func:`storm_tpu_torch.config.apply_dist_defaults`) to its copy
of the config.
"""

from __future__ import annotations

import copy
import json
import logging
import os
import signal
import subprocess
import sys
import tempfile
import threading
import time
from pathlib import Path
from typing import Any, Callable, Dict, List, Optional, Set

from storm_tpu_torch.config import Config, apply_dist_defaults
from storm_tpu_torch.dist.journal import ControllerJournal, ControlPlaneState
from storm_tpu_torch.dist.transport import WorkerClient

#: The directory holding the ``storm_tpu_torch`` package: put on a spawned
#: worker's PYTHONPATH, so a worker imports the same code as its controller.
_REPO_ROOT = str(Path(__file__).resolve().parents[2])

log = logging.getLogger("storm_tpu_torch.dist.controller")


def _probe_raw_spouts(cfg, builder: str) -> list:
    """Build the recipe against a throwaway MemoryBroker and return the
    component ids of any raw-scheme spouts. Best-effort: a custom builder
    may inspect the broker at build time (partitions_for, wire-broker type
    checks) and fail against the probe broker — that must not fail submit
    for a valid topology so a probe failure skips the static
    check and leaves the transport-level TypeError as the backstop."""
    from storm_tpu_torch.connectors import MemoryBroker
    from storm_tpu_torch.dist.worker import _resolve_builder

    # Resolution errors (typo'd builder name) must still fail fast at
    # submit — only the *invocation* against the probe broker is
    # best-effort.
    build_fn = _resolve_builder(builder)
    try:
        probe_topo = build_fn(cfg, MemoryBroker(), device="cpu")
    except Exception as exc:  # noqa: BLE001 — builder is user code
        log.warning(
            "raw-scheme static check skipped: builder %r could not be "
            "probed against a MemoryBroker (%s); a raw-scheme spout "
            "would fail at transport encode instead", builder, exc)
        return []
    return sorted(
        cid for cid, spec in probe_topo.specs.items()
        if getattr(spec.obj, "scheme", None) == "raw")


def _worker_alive(pid: int, index: int) -> bool:
    """Whether ``pid`` is still worker ``index``'s process. A pid the
    kernel has since given to another process is not, nor is a zombie
    (reaped here when this process is its parent), so a stale journaled
    pid is never taken for a live worker, or killed. Without procfs the
    pid alone answers."""
    try:
        os.waitpid(pid, os.WNOHANG)
    except ChildProcessError:
        pass
    if not os.path.isdir("/proc/self"):
        try:
            os.kill(pid, 0)
        except ProcessLookupError:
            return False
        except PermissionError:
            pass
        return True
    try:
        with open(f"/proc/{pid}/cmdline", "rb") as f:
            argv = f.read().split(b"\0")
    except OSError:
        return False
    return (b"storm_tpu_torch.dist.worker" in argv and b"--index" in argv[:-1]
            and argv[argv.index(b"--index") + 1] == str(index).encode())


def _kill_worker_pid(pid: Optional[int], index: int) -> None:
    """SIGKILL worker ``index`` by its pid, if that pid is still the
    worker's."""
    if pid and _worker_alive(pid, index):
        try:
            os.kill(pid, signal.SIGKILL)
        except (ProcessLookupError, PermissionError):
            pass


def _await_worker_exit(pid: Optional[int], index: int, timeout_s: float) -> None:
    """Wait for worker ``index``'s process, known by its pid alone, to exit;
    kill it if it has not in ``timeout_s``."""
    deadline = time.monotonic() + timeout_s
    while pid and _worker_alive(pid, index) and time.monotonic() < deadline:
        time.sleep(0.05)
    _kill_worker_pid(pid, index)


def merge_utilization(per_worker: Dict[int, dict]) -> Dict[str, dict]:
    """Fuse per-worker utilization snapshots (``obs.capacity.
    utilization_snapshot`` payloads) into one per-component view.

    Raw busy/wait/flush seconds and task counts ADD across workers;
    ``dt_s`` takes the max (each worker measured roughly the same wall
    window — summing would double-count time); capacity and the fractions
    are then re-derived from the merged totals, exactly the formula
    ``obs.capacity._finish_row`` applies per process. Each row also keeps
    the contributing worker indices. Per-worker transport depths stay in
    the caller's ``workers`` payload — they are per-peer-link, so a
    cross-worker sum would have no referent."""
    from storm_tpu_torch.obs.capacity import _finish_row

    merged: Dict[str, dict] = {}
    for i, snap in per_worker.items():
        for comp, row in (snap.get("components") or {}).items():
            m = merged.setdefault(comp, {
                "component": comp, "tasks": 0, "busy_s": 0.0,
                "wait_s": 0.0, "flush_s": 0.0, "dt_s": 0.0, "workers": []})
            m["tasks"] += int(row.get("tasks", 0))
            for k in ("busy_s", "wait_s", "flush_s"):
                m[k] += float(row.get(k, 0.0))
            m["dt_s"] = max(m["dt_s"], float(row.get("dt_s", 0.0)))
            m["workers"].append(i)
    for m in merged.values():
        _finish_row(m)
    return merged


class DistCluster:
    def __init__(
        self,
        n_workers: int = 2,
        addrs: Optional[List[str]] = None,
        env: Optional[dict] = None,
        worker_resources: Optional[dict] = None,
        auth_token: Optional[str] = None,
        device: str = "cuda",
        worker_threads: int = 0,
        journal_dir: Optional[str] = None,
        reattach: bool = True,
        journal_snapshot_every: int = 64,
    ) -> None:
        """Spawn ``n_workers`` local worker processes on ``device`` (the
        card unless ``"cpu"``; raises without a card), or attach to
        ``addrs`` (["host:port", ...]) if given. ``env`` is added to a
        spawned worker's environment; ``worker_threads`` > 0 sets its
        torch intra-op threads. ``worker_resources`` is each
        worker's capacity for resource-aware placement (default
        {"memory_mb": 4096, "cpu": 400}). ``auth_token`` (default:
        $STORM_TPU_CONTROL_TOKEN) is the shared control-plane secret:
        exported to spawned workers and carried by every call; workers
        refuse calls without it; ``submit`` refuses a config whose
        ``control`` token resolves to another.

        ``journal_dir`` arms the control-plane journal (compacted every
        ``journal_snapshot_every`` appends; 0 = never). A controller
        started on a journal that names workers reattaches to them
        (``reattach=True``, unless ``addrs`` are given): the live ones are
        adopted without a submit, the dead ones replaced; when none
        answers, a fresh mesh is spawned and the journal reset.
        ``self.reattached`` says which path ran. A worker that reports
        another device than ``device`` is refused."""
        from storm_tpu_torch.device import resolve_device
        from storm_tpu_torch.dist.transport import TOKEN_ENV, _env_token

        self.device = str(resolve_device(device))
        self._worker_threads = int(worker_threads)
        self._token = _env_token() if auth_token is None else auth_token
        self._token_env = TOKEN_ENV
        self._worker_resources = worker_resources or {
            "memory_mb": 4096.0, "cpu": 400.0}
        self.procs: List[Optional[subprocess.Popen]] = []
        self.clients: List[WorkerClient] = []
        self._stderr_files: List = []
        self._stderr_by_index: Dict[int, Any] = {}
        self._env = env
        self._lock = threading.Lock()
        self._monitor: Optional[threading.Thread] = None
        self._monitor_stop = threading.Event()
        self._recipe: Optional[dict] = None
        self._rebalances: Dict[str, int] = {}
        self._swaps: Dict[str, dict] = {}
        self._activated = True
        self._closing = False
        # Controller-side observability: heartbeat misses and recoveries
        # happen HERE, not on any worker, so they need their own registry
        # and flight recorder. Named ctrl_metrics because .metrics() is
        # already the worker-aggregation method.
        from storm_tpu_torch.runtime.metrics import MetricsRegistry
        from storm_tpu_torch.runtime.tracing import FlightRecorder

        self.ctrl_metrics = MetricsRegistry()
        self.flight = FlightRecorder()
        self._hb_miss = self.ctrl_metrics.counter(
            "controller", "dist_heartbeat_miss")
        self._journal_appends = self.ctrl_metrics.counter(
            "controller", "dist_journal_appends")
        self._journal_snapshots = self.ctrl_metrics.counter(
            "controller", "dist_journal_snapshots")
        self._journal_replayed = self.ctrl_metrics.counter(
            "controller", "dist_journal_replayed")
        # Workers the controller itself is draining: the heartbeat
        # monitor must not declare these dead.
        self._draining: Set[int] = set()
        self._pids: Dict[int, int] = {}
        self._placement: Dict[str, int] = {}
        self.peers: Dict[int, str] = {}
        self.reattached = False
        self._journal: Optional[ControllerJournal] = None
        if journal_dir:
            self._journal = ControllerJournal(
                journal_dir, snapshot_every=journal_snapshot_every)
            st = self._journal.load()
            if st.replayed:
                self._journal_replayed.inc(st.replayed)
            if reattach and not addrs and st.peers:
                self.reattached = self._try_reattach(st)
                if self.reattached:
                    return  # the mesh is adopted: nothing to spawn
                # The journaled mesh is gone: reset the fold, so its recipe
                # cannot come back at the next restart on a mesh it was
                # never shipped to.
                self._jappend("kill")
        try:
            if addrs:
                for addr in addrs:
                    self.clients.append(WorkerClient(addr, token=self._token))
            else:
                # All started before any is awaited: the interpreters and
                # their imports come up side by side.
                started = [self._start_worker(i) for i in range(n_workers)]
                for i, (proc, errf) in enumerate(started):
                    self.procs.append(proc)
                    self._pids[i] = proc.pid
                for i, (proc, errf) in enumerate(started):
                    self.clients.append(self._await_ready(i, proc, errf))
            for c in self.clients:
                c.wait_ready()
        except BaseException:
            self.shutdown()
            raise
        self.peers = {i: c.target for i, c in enumerate(self.clients)}
        self._jappend("workers", peers=self.peers, pids=self._pids)

    def _start_worker(self, index: int):
        """Popen one worker: a fresh interpreter (never a fork), the repo
        on its PYTHONPATH, the control token pinned in its environment
        (to "" too, so a stale export cannot make it demand a token the
        controller will not send), its stderr in a temporary file (an
        unread pipe would block a chatty worker)."""
        errf = tempfile.TemporaryFile()
        self._stderr_files.append(errf)
        self._stderr_by_index[index] = errf
        env = {**os.environ, **(self._env or {}), self._token_env: self._token}
        env["PYTHONPATH"] = os.pathsep.join(
            p for p in (_REPO_ROOT, env.get("PYTHONPATH", "")) if p)
        proc = subprocess.Popen(
            [sys.executable, "-m", "storm_tpu_torch.dist.worker",
             "--port", "0", "--index", str(index), "--device", self.device,
             "--threads", str(self._worker_threads)],
            stdout=subprocess.PIPE, stderr=errf, stdin=subprocess.DEVNULL,
            env=env)
        return proc, errf

    def _await_ready(self, index: int, proc, errf) -> WorkerClient:
        """The worker's one JSON ready-line with its bound port."""
        line = proc.stdout.readline().decode()
        if not line.strip():
            proc.wait(timeout=10)
            errf.seek(0)
            tail = errf.read()[-4000:].decode("utf-8", "replace")
            raise RuntimeError(
                f"worker {index} died during startup; stderr tail:\n{tail}"
            )
        info = json.loads(line)
        return WorkerClient(f"127.0.0.1:{info['port']}", token=self._token)

    def _spawn_worker(self, index: int):
        proc, errf = self._start_worker(index)
        try:
            return proc, self._await_ready(index, proc, errf)
        except BaseException:
            proc.kill()
            proc.wait(timeout=10)
            raise

    # ---- control-plane durability (dist/journal.py) --------------------------

    def _jappend(self, kind: str, **data: Any) -> None:
        """Journal one transition. Callers append before the calls that
        apply it, so the journal is only ever ahead of the mesh. A journal
        that cannot write fails the transition (its error propagates)."""
        j = self._journal
        if j is None:
            return
        j.append(kind, **data)
        self._journal_appends.inc()
        if j.maybe_snapshot():
            self._journal_snapshots.inc()

    def journal_stats(self) -> Optional[Dict[str, int]]:
        return self._journal.stats() if self._journal is not None else None

    def state_reports(self, timeout: float = 5.0) -> Dict[int, dict]:
        """Each worker's ``state_report``: its pid, submits and live
        parallelisms (what reattach reconciles against)."""
        return {i: c.control("state_report", timeout=timeout)
                for i, c in enumerate(self.clients)}

    @staticmethod
    def reconcile_parallelism(
        rebalances: Dict[str, int],
        placement: Dict[str, int],
        reports: Dict[int, dict],
    ) -> Dict[str, int]:
        """Components whose journaled parallelism disagrees with the
        hosting worker's. The journal records intent (write-ahead), so its
        value wins and the rebalance is issued again: a worker can only be
        behind the journal (a call that never ran), never ahead of it."""
        out: Dict[str, int] = {}
        for component, par in rebalances.items():
            rep = reports.get(placement.get(component)) or {}
            actual = (rep.get("parallelism") or {}).get(component)
            if actual is not None and int(actual) != int(par):
                out[component] = int(par)
        return out

    def _try_reattach(self, st: ControlPlaneState) -> bool:
        """Adopt the journaled mesh: probe every journaled worker, keep the
        live ones as they are (no submit: engines and graphs stay),
        reconcile them against the journal, replace the dead ones. False
        (the caller spawns a fresh mesh) when no worker answers."""
        t0 = time.monotonic()
        reports: Dict[int, dict] = {}
        clients: Dict[int, WorkerClient] = {}
        for idx in sorted(st.peers):
            c = WorkerClient(st.peers[idx], token=self._token)
            clients[idx] = c
            try:
                rep = c.probe("state_report", timeout=3.0)
                if rep.get("index") != idx:
                    raise RuntimeError(f"it answers as worker {rep.get('index')}")
                reports[idx] = rep
            except Exception as e:
                log.warning("reattach: worker %d at %s unreachable (%s)",
                            idx, st.peers[idx], e)
        wrong = {i: r.get("device") for i, r in reports.items()
                 if r.get("device") != self.device}
        if not reports or wrong:
            for c in clients.values():
                c.close()
            if wrong:
                raise ValueError(f"reattach: workers {wrong} run on another device "
                                 f"than this controller's {self.device!r}")
            log.warning("reattach: no survivors among %d journaled workers; "
                        "spawning a fresh mesh", len(st.peers))
            return False
        n = max(st.peers) + 1
        self.clients = [clients[i] for i in range(n)]
        self.procs = [None] * n  # survivors are adopted, not owned
        self.peers = dict(st.peers)
        self._pids = {**st.pids, **{i: int(r["pid"]) for i, r in reports.items()}}
        self._placement = dict(st.placement)
        self._recipe = dict(st.recipe) if st.recipe else None
        self._rebalances = dict(st.rebalances)
        self._swaps = {k: dict(v) for k, v in st.swaps.items()}
        self._activated = st.activated
        # The journal's intent wins: re-issue the rebalances that never
        # landed (the host first when growing, its peers first when
        # shrinking, as rebalance() orders them).
        fixes = self.reconcile_parallelism(self._rebalances, self._placement, reports)
        for component, par in fixes.items():
            w = self._placement[component]
            current = int(reports[w]["parallelism"][component])
            others = [self.clients[i] for i in sorted(reports) if i != w]
            targets = ([self.clients[w], *others] if par >= current
                       else [*others, self.clients[w]])
            for c in targets:
                c.control("rebalance", component=component, parallelism=par)
        for idx in sorted(reports):
            rep = reports[idx]
            if self._recipe is not None and not rep.get("topology"):
                # Alive but empty (restarted between controllers): it gets
                # the whole recipe.
                self._reship(idx, self.clients[idx])
            elif rep.get("active") is not None and bool(rep["active"]) != self._activated:
                self.clients[idx].control("activate" if self._activated else "deactivate")
        dead = [i for i in range(n) if i not in reports]
        self.flight.event(
            "dist_reattached", survivors=sorted(reports), dead=dead,
            replayed=st.replayed, reconciled=sorted(fixes),
            reattach_s=round(time.monotonic() - t0, 3))
        log.info("reattached to %d/%d workers in %.2fs (reconciled: %s)",
                 len(reports), n, time.monotonic() - t0, sorted(fixes) or "-")
        for idx in dead:
            self.recover_worker(idx)
        return True

    def _reship(self, idx: int, client: WorkerClient) -> None:
        """Send one worker the full live recipe: submit + two-phase start
        at the current lifecycle state, then the live rebalances and
        swaps (what recover_worker runs for a replacement)."""
        client.control(
            "submit",
            name=self._recipe["name"],
            config=self._recipe["config"],
            placement=self._placement,
            peers=self.peers,
            builder=self._recipe["builder"],
        )
        client.control("start_bolts")
        if not self._activated:
            # Executors exist after start_bolts; pausing before
            # start_spouts means they start with _active=False and
            # never emit.
            client.control("deactivate")
        client.control("start_spouts")
        # Re-apply live rebalances AFTER start (rebalance starts the
        # executors it adds; applying pre-start would double-start
        # them). Until these land, deliveries to not-yet-grown tasks
        # drop and replay — at-least-once covers the window.
        for component, par in self._rebalances.items():
            client.control(
                "rebalance", component=component, parallelism=par)
        # Re-apply live model swaps, or the worker serves the
        # submit-time model (silent rollout rollback).
        for component, overrides in self._swaps.items():
            if self._placement.get(component) == idx:
                client.control(
                    "swap_model", component=component,
                    model=overrides, timeout=600.0)

    # ---- topology lifecycle --------------------------------------------------

    def submit(
        self,
        name: str,
        cfg: Config,
        placement: Optional[Dict[str, int]] = None,
        builder: str = "standard",
    ) -> Dict[str, int]:
        """Ship the recipe to every worker and start it (two-phase).
        Returns the placement used."""
        # The workers hold the token they were started with: a config that
        # names another would be served by workers that check a different
        # secret (or none) than the one it asks for.
        token = cfg.control.resolve_token()
        if token and token != self._token:
            raise ValueError(
                "cfg.control's token is not the one this cluster's workers "
                "were started with; start the cluster with "
                "DistCluster(auth_token=cfg.control.resolve_token())")
        # Known-statically incompatible: raw-scheme (bytes) tuple values
        # cannot cross the JSON inter-worker wire. The binary wire (the
        # default) carries bytes natively, so the check only applies when
        # the topology pins wire_format="json". Rejecting here fails fast;
        # the per-batch TypeError in transport.encode_deliveries would
        # otherwise be swallowed by the send loop's warn-and-replay,
        # livelocking the topology. Build the recipe locally
        # exactly as each worker will and inspect the REAL spout objects —
        # a config-only check cannot see raw spouts constructed by a
        # custom builder.
        cfg = apply_dist_defaults(copy.deepcopy(cfg))
        if getattr(cfg.topology, "wire_format", "binary") == "json":
            raw_spouts = _probe_raw_spouts(cfg, builder)
            if raw_spouts:
                raise ValueError(
                    f"spout(s) {raw_spouts} use scheme='raw' (bytes tuple "
                    "values), which cannot cross the JSON inter-worker "
                    "wire; use scheme='string' or wire_format='binary' "
                    "for distributed topologies")
        if placement is None:
            placement = self._auto_place(cfg, builder)
        bad = {c: w for c, w in placement.items() if w >= len(self.clients)}
        if bad:
            raise ValueError(f"placement onto unknown workers: {bad}")
        with self._lock:
            self._placement = placement
            self._recipe = {
                "name": name, "config": cfg.to_dict(), "builder": builder,
            }
            self._activated = True  # fresh topology starts active
            self._rebalances.clear()
            self._swaps.clear()
            self._jappend("submit", name=name, config=cfg.to_dict(),
                          builder=builder, placement=placement)
            for c in self.clients:
                c.control(
                    "submit",
                    name=name,
                    config=cfg.to_dict(),
                    placement=placement,
                    peers=self.peers,
                    builder=builder,
                )
            for c in self.clients:
                c.control("start_bolts")
            for c in self.clients:
                c.control("start_spouts")
        return placement

    @staticmethod
    def plan_placement(
        demands: "Dict[str, dict]",
        worker_capacities: "List[dict]",
    ) -> Dict[str, int]:
        """Resource-aware placement (Storm's RAS): worst-fit-decreasing
        bin-packing — biggest demands first, each onto the worker with the
        most remaining memory, which balances load across workers.

        ``demands``: component -> {"memory_mb", "cpu", "is_spout"} (already
        multiplied by parallelism). ``worker_capacities``: one
        {"memory_mb", "cpu"} per worker; a missing capacity key means
        unconstrained. Spouts place first and prefer worker 0 (the ack
        ledger lives with its spout) when it fits. Zero-demand components
        spread by assignment count (hinting one component must not collapse
        the rest onto a single worker). Raises ValueError when a component
        fits nowhere — Storm's RAS refuses rather than oversubscribes.
        """
        inf = float("inf")
        remaining = [{"memory_mb": float(c.get("memory_mb", inf)),
                      "cpu": float(c.get("cpu", inf))}
                     for c in worker_capacities]
        counts = [0] * len(remaining)
        placement: Dict[str, int] = {}
        order = sorted(
            demands.items(),
            key=lambda kv: (not kv[1].get("is_spout", False),
                            -kv[1].get("memory_mb", 0.0),
                            -kv[1].get("cpu", 0.0)),
        )

        def fits(w: int, d: dict) -> bool:
            return (remaining[w]["memory_mb"] >= d.get("memory_mb", 0.0)
                    and remaining[w]["cpu"] >= d.get("cpu", 0.0))

        def take(w: int, d: dict, cid: str) -> None:
            remaining[w]["memory_mb"] -= d.get("memory_mb", 0.0)
            remaining[w]["cpu"] -= d.get("cpu", 0.0)
            counts[w] += 1
            placement[cid] = w

        for cid, d in order:
            zero = not d.get("memory_mb") and not d.get("cpu")
            if d.get("is_spout") and fits(0, d):
                take(0, d, cid)
                continue
            if zero:
                # spread by assignment count, not remaining memory
                w = min(range(len(remaining)), key=lambda i: (counts[i], i))
                take(w, d, cid)
                continue
            best = None
            best_key = None
            for w_ in range(len(remaining)):
                if fits(w_, d):
                    # worst fit on memory, then cpu, then fewest assignments
                    # (cpu-only workloads must still spread)
                    key = (remaining[w_]["memory_mb"], remaining[w_]["cpu"],
                           -counts[w_])
                    if best_key is None or key > best_key:
                        best, best_key = w_, key
            if best is None:
                raise ValueError(
                    f"component {cid!r} (demand {d}) fits no worker "
                    f"(remaining: {remaining})")
            take(best, d, cid)
        return placement

    def _auto_place(self, cfg: Config, builder: str) -> Dict[str, int]:
        """Spouts on worker 0 (ledger lives with its spout); bolts
        round-robin over the rest (or worker 0 when single-worker)."""
        from storm_tpu_torch.connectors import MemoryBroker
        from storm_tpu_torch.dist.worker import _resolve_builder

        topo = _resolve_builder(builder)(cfg, MemoryBroker(), device="cpu")
        hints = dict(getattr(cfg.topology, "component_resources", {}) or {})
        unknown = set(hints) - set(topo.specs)
        if unknown:
            raise ValueError(
                f"component_resources for unknown components {sorted(unknown)} "
                f"(topology has {sorted(topo.specs)})")
        for cid, h in hints.items():
            bad_keys = set(h) - {"memory_mb", "cpu"}
            if bad_keys:
                raise ValueError(
                    f"component_resources[{cid!r}] has unknown keys "
                    f"{sorted(bad_keys)} (allowed: memory_mb, cpu)")
        for spec in topo.specs.values():
            if spec.component_id not in hints and getattr(spec, "resources", None):
                hints[spec.component_id] = spec.resources
        if hints:
            # Resource-aware path (Storm's RAS): demands are per-task hints
            # times parallelism; unhinted components count as zero-demand
            # and pack wherever capacity remains.
            demands = {}
            for spec in topo.specs.values():
                h = hints.get(spec.component_id, {})
                demands[spec.component_id] = {
                    "memory_mb": float(h.get("memory_mb", 0.0)) * spec.parallelism,
                    "cpu": float(h.get("cpu", 0.0)) * spec.parallelism,
                    "is_spout": spec.is_spout,
                }
            caps = self._worker_capacities()
            return self.plan_placement(demands, caps)
        placement: Dict[str, int] = {}
        n = len(self.clients)
        rr = 1 % n
        for spec in topo.specs.values():
            if spec.is_spout:
                placement[spec.component_id] = 0
            else:
                placement[spec.component_id] = rr
                rr = (rr + 1) % n or (1 % n)
        return placement

    def _worker_capacities(self) -> "List[dict]":
        return [dict(self._worker_resources) for _ in self.clients]

    # ---- observation ---------------------------------------------------------

    def metrics(self) -> Dict[str, dict]:
        """Merged metrics: each component's numbers come from the worker
        that hosts it."""
        merged: Dict[str, dict] = {}
        for i, c in enumerate(self.clients):
            snap = c.control("metrics")["metrics"]
            for comp, vals in snap.items():
                if self._placement.get(comp, 0) == i or comp not in merged:
                    merged[comp] = vals
        return merged

    def copies(self, key: str = "dist", cumulative: bool = False,
               reset: bool = False) -> Dict[str, Any]:
        """Cluster-wide windowed copy-ledger tree: every worker reports
        its per-(stage, engine) bytes/copies/allocs/records deltas since
        the last ``copies`` call with the same ``key`` (cursors live
        worker-side), and the controller ADDs the raw quantities and
        re-derives bytes-per-record and amplification from the totals —
        the ``utilization`` merge stance, applied to bytes. First call
        primes the cursors and reports an empty tree.

        Bench-exact variants: ``reset=True`` clears every worker's
        ledger (a measured cell starts clean) and ``cumulative=True``
        merges lifetime totals instead of windows — a cursor can't see
        a hop born mid-window, so exact per-cell accounting is a reset
        followed by one cumulative read."""
        from storm_tpu_torch.obs.copyledger import merge_windows

        req: Dict[str, Any] = {"key": key}
        if cumulative:
            req["cumulative"] = True
        if reset:
            req["reset"] = True
        per_worker = {i: c.control("copies", **req)["copies"]
                      for i, c in enumerate(self.clients)}
        return {"workers": per_worker,
                "merged": merge_windows(per_worker)}

    def utilization(self, key: str = "dist") -> Dict[str, Any]:
        """Cluster-wide windowed utilization: every worker reports its
        busy/wait/flush deltas since the last ``utilization`` call with
        the same ``key`` (cursors live worker-side), and the controller
        merges them per component. The first call primes the cursors and
        reports empty components — sample twice around a traffic window.
        Unlike ``metrics()`` there is no hosting-worker-wins rule: a
        rebalance can leave tasks of one component on several workers, so
        raw seconds are summed and capacity recomputed from the totals."""
        per_worker = {i: c.control("utilization", key=key)["utilization"]
                      for i, c in enumerate(self.clients)}
        return {"workers": per_worker,
                "components": merge_utilization(per_worker)}

    def health(self) -> Dict[int, dict]:
        return {i: c.control("health")["health"]
                for i, c in enumerate(self.clients)}

    def traces(self, n: int = 20) -> Dict[str, Any]:
        """Merged distributed-trace picture: every worker holds only the
        spans its own executors recorded, so records are merged by trace id
        (spans deduped by span id and tagged with the recording worker).
        Span ``offset_ms`` values are relative to each worker's own
        perf_counter domain — comparable within a worker, not across.
        Flight-recorder events carry wall timestamps and merge cleanly."""
        merged: Dict[str, dict] = {}
        flight: List[dict] = []
        stats: Dict[str, Any] = {}
        for i, c in enumerate(self.clients):
            sl = c.control("traces", n=n)
            if "stats" in sl:
                stats[str(i)] = sl["stats"]
            for ev in sl.get("flight") or []:
                flight.append({**ev, "worker": i})
            for rec in ((sl.get("recent") or []) + (sl.get("slowest") or [])
                        + (sl.get("open") or [])):
                cur = merged.get(rec["trace_id"])
                if cur is None:
                    cur = {"trace_id": rec["trace_id"],
                           "opened_at": rec["opened_at"],
                           "duration_ms": rec.get("duration_ms"),
                           "spans": []}
                    merged[rec["trace_id"]] = cur
                else:
                    cur["opened_at"] = min(cur["opened_at"], rec["opened_at"])
                    if cur.get("duration_ms") is None:
                        cur["duration_ms"] = rec.get("duration_ms")
                seen = {s["span_id"] for s in cur["spans"]}
                for s in rec["spans"]:
                    if s["span_id"] not in seen:
                        cur["spans"].append({**s, "worker": i})
                        seen.add(s["span_id"])
        recs = list(merged.values())
        flight.sort(key=lambda e: e.get("ts", 0.0))
        return {
            "slowest": sorted(recs, key=lambda r: r.get("duration_ms") or 0.0,
                              reverse=True)[:n],
            "recent": sorted(recs, key=lambda r: r["opened_at"],
                             reverse=True)[:n],
            "stats": stats,
            "flight": flight[-n:],
        }

    def worker_logs(self, index: int, tail_bytes: int = 16384) -> str:
        """Tail of a spawned worker's stderr (the Storm logviewer
        equivalent). pread leaves the fd offset alone — the file
        description is shared with the writing child process, so a seek
        here would corrupt its write position. Locked against
        recovery/shutdown closing the file mid-read."""
        tail_bytes = max(1, tail_bytes)
        with self._lock:
            f = self._stderr_by_index.get(index)
            if f is None or self._closing or f.closed:
                raise KeyError(f"no spawned worker {index} (attached workers "
                               "keep their own logs)")
            import os as _os

            fd = f.fileno()
            size = _os.fstat(fd).st_size
            start = max(0, size - tail_bytes)
            return _os.pread(fd, size - start, start).decode("utf-8", "replace")

    def rebalance(self, component: str, parallelism: int) -> None:
        """Live parallelism change across the cluster (the reference's
        scale-out knob, at runtime and across processes).

        The hosting worker changes its executor count; every other worker
        resizes its proxy-inbox view so groupings route over the new task
        set. Ordering prevents routing to tasks that don't exist: grow the
        host before peers widen; shrink peers before the host removes."""
        if parallelism < 1:
            # Validate before touching ANY worker: peers' proxy views are
            # resized with no rollback, so a bad value must never reach them.
            raise ValueError("parallelism must be >= 1")
        with self._lock:  # serialize against a recovery in flight
            w = self._placement.get(component)
            if w is None:
                raise KeyError(component)
            host = self.clients[w]
            current = host.control("parallelism", component=component)["parallelism"]
            others = [c for i, c in enumerate(self.clients) if i != w]
            targets = [host, *others] if parallelism >= current else [*others, host]
            # Write-ahead: journaled before any worker changes, so a
            # controller that dies midway leaves the intent for reattach to
            # re-issue (reconcile_parallelism).
            self._jappend("rebalance", component=component, parallelism=parallelism)
            for c in targets:
                c.control("rebalance", component=component, parallelism=parallelism)
            # Recorded so a recovered worker rebuilds at the LIVE
            # parallelism, not the submit-time one (else survivors route to
            # tasks the replacement doesn't have).
            self._rebalances[component] = parallelism

    def swap_model(self, component: str, overrides: dict, tasks=None,
                   timeout: float = 600.0) -> dict:
        """Live model swap on the worker hosting ``component`` (components
        are placed whole, so exactly one worker owns its executors).

        The RPC runs OUTSIDE the controller lock: engine build+warmup can
        take minutes and must not stall heartbeats/recovery. The swap is
        recorded (like rebalances) so a recovered replacement worker
        rebuilds on the swapped model, not the submit-time one."""
        with self._lock:
            w = self._placement.get(component)
            if w is None:
                raise KeyError(component)
            client = self.clients[w]
        try:
            resp = client.control(
                "swap_model", component=component, model=overrides,
                tasks=tasks, timeout=timeout,
            )
        except RuntimeError as e:
            if "KeyError" in str(e):
                raise KeyError(str(e)) from e
            raise
        if tasks is None:
            # Canary swaps are deliberately NOT recorded for recovery
            # replay: a replaced worker restarts on the majority model.
            # Journaled after the swap took (unlike a rebalance): replaying
            # one a canary rejected would roll it onto the whole component.
            with self._lock:
                merged = {**self._swaps.get(component, {}), **overrides}
                self._swaps[component] = merged
                self._jappend("swap_model", component=component, overrides=merged)
        return resp.get("model", {})

    def component_stats(self, component: str) -> list:
        """Per-executor stats from the worker hosting ``component``."""
        with self._lock:
            w = self._placement.get(component)
            if w is None:
                raise KeyError(component)
            client = self.clients[w]
        try:
            return client.control(
                "component_stats", component=component)["executors"]
        except RuntimeError as e:
            if "KeyError" in str(e):
                raise KeyError(component) from e
            raise

    def seek(self, component: str, position) -> int:
        """Reposition a spout component on its hosting worker; returns the
        number of tasks repositioned."""
        with self._lock:
            w = self._placement.get(component)
            if w is None:
                raise KeyError(component)
            client = self.clients[w]
        try:
            return int(client.control(
                "seek", component=component, position=position)["instances"])
        except RuntimeError as e:
            # Worker errors come back as "TypeName: message"; re-typed as
            # the in-process runtime raises them.
            msg = str(e)
            if "KeyError" in msg:
                raise KeyError(component) from e
            if "TypeError" in msg:
                raise TypeError(msg) from e
            raise

    def profile(self, worker: int, log_dir: str, seconds: float) -> dict:
        """Start a ``torch.profiler`` capture on one worker (the card's
        timeline lives with the worker's engines)."""
        with self._lock:
            if not 0 <= worker < len(self.clients):
                raise KeyError(f"no worker {worker}")
            client = self.clients[worker]
        return client.control("profile", log_dir=log_dir, seconds=seconds)

    def decode_sessions(self) -> Dict[str, Any]:
        """The decode tier across workers: each worker's session stores and
        engines, concatenated. Sticky routing keeps each session on one
        worker, so the totals are sums."""
        per_worker = {i: c.control("decode_sessions")["decode"]
                      for i, c in enumerate(self.clients)}
        stores: List[dict] = []
        engines: List[dict] = []
        for i, d in sorted(per_worker.items()):
            stores += [{**row, "worker": i} for row in d.get("stores", ())]
            engines += [{**row, "worker": i} for row in d.get("engines", ())]
        return {"workers": per_worker,
                "merged": {
                    "stores": stores,
                    "engines": engines,
                    "sessions_live": sum(d.get("sessions_live", 0)
                                         for d in per_worker.values()),
                    "tokens_emitted": sum(d.get("tokens_emitted", 0)
                                          for d in per_worker.values()),
                }}

    # ---- failure detection + elastic recovery --------------------------------

    def start_monitor(
        self,
        interval_s: float = 1.0,
        misses: int = 3,
        on_dead: Optional[Callable[[int], None]] = None,
    ) -> None:
        """Heartbeat monitor: ping every worker each ``interval_s``; after
        ``misses`` consecutive failures declare it dead and recover — the
        Storm-supervisor/Nimbus role the reference delegates wholesale
        (the supervisors that restart dead workers). Default
        recovery is :meth:`recover_worker`; pass ``on_dead`` to override
        (e.g. multi-host deployments that respawn remotely)."""
        if self._monitor is not None:
            raise RuntimeError("monitor already running")
        self._monitor_stop.clear()
        fails = [0] * len(self.clients)

        def loop() -> None:
            while not self._monitor_stop.wait(interval_s):
                for i in range(len(self.clients)):
                    with self._lock:
                        client = self.clients[i]
                        draining = i in self._draining
                    if draining:
                        # A controller-initiated drain is not a death:
                        # the worker is unresponsive ON PURPOSE (flushing,
                        # restarting). Declaring it dead here would race
                        # recover_worker against the caller's own
                        # respawn of the same index.
                        fails[i] = 0
                        continue
                    try:
                        client.control("ping", timeout=max(1.0, interval_s))
                        fails[i] = 0
                    except Exception as e:
                        fails[i] += 1
                        self._hb_miss.inc()
                        self.flight.event(
                            "dist_heartbeat_miss", worker=i,
                            consecutive=fails[i], error=str(e),
                            throttle_s=0.5)
                    if fails[i] < misses:
                        continue
                    log.error("worker %d missed %d heartbeats; recovering",
                              i, fails[i])
                    try:
                        (on_dead or self.recover_worker)(i)
                    except Exception:
                        # Leave fails[i] at the threshold: the next missed
                        # ping re-triggers recovery IMMEDIATELY. Resetting
                        # before recovery succeeded (the old behaviour)
                        # granted a failed recovery a second full `misses`
                        # grace window on top of the first — doubling
                        # detection latency exactly when the worker is
                        # provably down.
                        log.exception("recovery of worker %d failed "
                                      "(will retry on next detection)", i)
                    else:
                        fails[i] = 0
                        self.flight.event("dist_worker_recovered", worker=i)

        self._monitor = threading.Thread(
            target=loop, name="dist-heartbeat", daemon=True
        )
        self._monitor.start()

    def stop_monitor(self) -> None:
        if self._monitor is None:
            return
        self._monitor_stop.set()
        # A recovery in flight (spawn + wait_ready + submit) can take tens
        # of seconds; joining short and proceeding would let shutdown race
        # it and orphan the replacement process.
        self._monitor.join(timeout=120)
        self._monitor = None

    def recover_worker(self, idx: int, times: Optional[Dict[str, float]] = None) -> None:
        """Replace a dead worker: respawn the process at the same index,
        rewire surviving peers to the new address, and re-ship the topology
        recipe so the replacement rebuilds and restarts its components.

        Tuples that were in flight on the dead worker are gone; the spout
        ledger times their trees out and replays them through the
        replacement (at-least-once — exactly Storm's story when a
        supervisor restarts a worker). Only valid for controller-spawned
        (or adopted) workers: attached remote workers must be respawned by
        their own host, then re-wired via ``on_dead``. ``times``, when
        given, gets ``resubmit_s``: the recipe's submit and start on the
        replacement."""
        with self._lock:
            if self._closing:
                return
            if not self.procs:
                raise RuntimeError(
                    "recover_worker only applies to spawned workers"
                )
            old_proc = self.procs[idx]
            if old_proc is not None:
                old_proc.kill()
                old_proc.wait(timeout=10)
            else:
                # Adopted by reattach: no Popen handle, but the journaled
                # pid, so a half-dead worker holds nothing.
                _kill_worker_pid(self._pids.get(idx), idx)
            try:
                self.clients[idx].close()
            except Exception:
                pass
            proc, client = self._spawn_worker(idx)
            client.wait_ready()
            self.procs[idx] = proc
            self.clients[idx] = client
            self.peers[idx] = client.target
            self._pids[idx] = proc.pid
            self._jappend("peer_update", idx=idx, addr=client.target, pid=proc.pid)
            # Surviving peers aim their senders at the replacement. A peer
            # left pointing at the dead address would replay its tuples
            # forever, so retry; if a LIVE peer stays unreachable, kill the
            # replacement and raise — its dead heartbeat makes the monitor
            # re-run the whole recovery rather than half-wire the cluster.
            # A peer that is itself dead is skipped: its own recovery
            # re-ships the fresh peers table (which includes this
            # replacement's address), so rewiring it here is both
            # impossible and unnecessary — and aborting on it would
            # livelock two simultaneous deaths against each other.
            for i, c in enumerate(self.clients):
                if i == idx or self._recipe is None:
                    continue  # no topology -> nothing to rewire
                for attempt in range(3):
                    try:
                        c.control("update_peer", idx=idx, addr=client.target)
                        break
                    except Exception as e:
                        try:
                            c.control("ping", timeout=2.0)
                        except Exception:
                            log.warning(
                                "peer %d is down too; its own recovery "
                                "will rewire it", i)
                            break
                        if attempt == 2:
                            proc.kill()
                            raise RuntimeError(
                                f"peer {i} rewire failed; recovery aborted"
                            ) from e
                        time.sleep(0.5 * 2**attempt)
            # Replacement rebuilds its share of the topology, at the LIVE
            # lifecycle state: current parallelisms, and spouts paused if
            # the cluster is deactivated/draining.
            if self._recipe is not None:
                t0 = time.monotonic()
                self._reship(idx, client)
                if times is not None:
                    times["resubmit_s"] = time.monotonic() - t0

    # ---- graceful drain and rolling restart ----------------------------------

    def drain_worker(self, idx: int, timeout_s: float = 30.0) -> dict:
        """Gracefully drain ONE worker: it stops intake (new deliveries
        park on the senders' side), flushes its local inflight, writes a
        final state checkpoint for its stateful bolts, and acks. While
        draining, the heartbeat monitor is suppressed for this index —
        the worker is busy on purpose; declaring it dead would race the
        caller's own restart of the same slot. The mark clears on
        failure, on :meth:`clear_drain`, or when :meth:`rolling_restart`
        has replaced the worker."""
        with self._lock:
            if not 0 <= idx < len(self.clients):
                raise KeyError(f"no worker {idx}")
            client = self.clients[idx]
            self._draining.add(idx)
        self.flight.event("dist_worker_draining", worker=idx)
        try:
            return client.control("drain_worker", timeout_s=timeout_s,
                                  timeout=timeout_s + 30.0)
        except Exception:
            with self._lock:
                self._draining.discard(idx)
            raise

    def clear_drain(self, idx: int) -> None:
        """Re-arm the heartbeat monitor for a worker after a drain that
        was not followed by a restart (drill / cancelled maintenance)."""
        with self._lock:
            self._draining.discard(idx)

    def rolling_restart(self, drain_timeout_s: float = 30.0,
                        settle_s: float = 0.0) -> List[dict]:
        """Restart every worker, one at a time: drain (intake off, its own
        trees flushed) -> clean exit -> respawn at its index on the
        controller's device, peers rewired, the recipe shipped again
        (:meth:`recover_worker`). The drain mark holds the monitor off the
        worker throughout. At-least-once covers each worker's blackout
        (the spout's ledger replays trees headed for it). ``settle_s``
        pauses between workers so the mesh catches up on the replays.
        Returns one row per worker: ``drained``, the pids, and the drain,
        restart (exit + spawn) and resubmit (the recipe's submit and start,
        with the new process's CUDA context, engine build and graph
        capture) seconds."""
        results: List[dict] = []
        last = len(self.clients) - 1
        for idx in range(len(self.clients)):
            t0 = time.monotonic()
            old_pid = self._pids.get(idx)
            drained = False
            times: Dict[str, float] = {}
            try:
                try:
                    ack = self.drain_worker(idx, timeout_s=drain_timeout_s)
                    drained = bool(ack.get("ok"))
                except Exception as e:
                    log.warning("rolling restart: drain of worker %d failed (%s); "
                                "restarting it anyway", idx, e)
                    with self._lock:
                        self._draining.add(idx)
                t1 = time.monotonic()
                times["drain_s"] = t1 - t0
                with self._lock:
                    client = self.clients[idx]
                try:
                    client.probe("shutdown", timeout=5.0)
                except Exception:
                    pass  # dead already, or killed below
                self._wait_worker_exit(idx, timeout_s=15.0)
                self.recover_worker(idx, times=times)
                times["restart_s"] = time.monotonic() - t1 - times.get("resubmit_s", 0.0)
            finally:
                self.clear_drain(idx)
            row = {"worker": idx, "drained": drained, "old_pid": old_pid,
                   "new_pid": self._pids.get(idx),
                   "drain_s": round(times.get("drain_s", 0.0), 3),
                   "restart_s": round(times.get("restart_s", 0.0), 3),
                   "resubmit_s": round(times.get("resubmit_s", 0.0), 3),
                   "total_s": round(time.monotonic() - t0, 3)}
            results.append(row)
            self.flight.event("dist_worker_restarted", worker=idx,
                              drained=drained, restart_s=row["total_s"])
            if settle_s > 0 and idx < last:
                time.sleep(settle_s)
        return results

    def _wait_worker_exit(self, idx: int, timeout_s: float = 15.0) -> None:
        """Wait for a worker's process to exit after a shutdown call: by its
        Popen handle when spawned here, by its journaled pid when adopted;
        killed when it does not exit in ``timeout_s``."""
        with self._lock:
            proc = self.procs[idx] if self.procs else None
            pid = self._pids.get(idx)
        if proc is not None:
            try:
                proc.wait(timeout=timeout_s)
            except subprocess.TimeoutExpired:
                proc.kill()
                proc.wait(timeout=5)
            return
        _await_worker_exit(pid, idx, timeout_s)

    def abandon(self) -> None:
        """Drop the controller's handles without touching the workers: a
        controller crash, in process (the workers go on serving). The
        journal keeps the control-plane state; a new ``DistCluster`` on
        the same ``journal_dir`` reattaches to them."""
        self.stop_monitor()
        with self._lock:
            self._closing = True
            clients, self.clients = list(self.clients), []
            self.procs = []
            files, self._stderr_files = list(self._stderr_files), []
            self._stderr_by_index.clear()
        for c in clients:
            c.close()
        for f in files:
            f.close()
        if self._journal is not None:
            self._journal.close()

    # ---- teardown ------------------------------------------------------------

    def drain(self, timeout_s: float = 30.0) -> bool:
        with self._lock:  # serialize against a recovery in flight
            self._activated = False  # a recovery mid-drain must not re-emit
            self._jappend("activation", activated=False)
            for c in self.clients:
                c.control("deactivate")
            ok = True
            for c in self.clients:
                ok = c.control("drain", timeout_s=timeout_s).get("ok", False) and ok
            return ok

    def deactivate(self) -> None:
        """Stop spouts pulling; in-flight tuples keep flowing (the first
        phase of drain(), without the drain wait).

        Flag flips under the lock; the RPCs run outside it (LCK001, same
        contract as swap_model) — a recovery that interleaves re-applies
        spout state from ``self._activated``, which is already False."""
        with self._lock:
            self._activated = False
            self._jappend("activation", activated=False)
            clients = list(self.clients)
        for c in clients:
            c.control("deactivate")

    def activate(self) -> None:
        """Resume spouts after a deactivate/drain (Storm's 'activate')."""
        with self._lock:
            self._activated = True
            self._jappend("activation", activated=True)
            clients = list(self.clients)
        for c in clients:
            c.control("activate")

    @property
    def activated(self) -> bool:
        return self._activated

    def kill(self, wait_secs: float = 0.0) -> None:
        # State clears under the lock (a recovery after kill must not
        # resurrect the topology); the kill RPCs run outside it (LCK001) —
        # with the recipe gone, an interleaved recovery is a no-op.
        with self._lock:
            self._recipe = None
            self._rebalances.clear()
            self._swaps.clear()
            self._jappend("kill")
            clients = list(self.clients)
        for c in clients:
            c.control("kill", wait_secs=wait_secs)

    def shutdown(self) -> None:
        self._closing = True  # recoveries that start after this are no-ops
        self.stop_monitor()
        # Detach everything under the lock (serializes against a recovery
        # still in flight — it sees empty lists and _closing), then do the
        # slow teardown outside it: shutdown RPCs plus up-to-10s process
        # waits under the controller lock stalled every stats/ctl caller
        # for the whole drain (LCK001).
        with self._lock:
            clients, self.clients = list(self.clients), []
            # Adopted workers have no Popen handle: their pids stand in.
            adopted = {i: self._pids.get(i) for i, p in enumerate(self.procs) if p is None}
            procs, self.procs = [p for p in self.procs if p is not None], []
            files, self._stderr_files = list(self._stderr_files), []
            self._stderr_by_index.clear()
        for c in clients:
            try:
                c.probe("shutdown", timeout=5.0)
            except Exception:
                pass  # dead already, or killed below
            c.close()
        for i, pid in adopted.items():
            _await_worker_exit(pid, i, 10.0)
        for p in procs:
            try:
                p.wait(timeout=10)
            except subprocess.TimeoutExpired:
                p.kill()
                p.wait(timeout=10)
            if p.stdout is not None:
                p.stdout.close()
        for f in files:
            f.close()
        if self._journal is not None:
            self._journal.close()

    def __enter__(self) -> "DistCluster":
        return self

    def __exit__(self, *exc) -> None:
        self.shutdown()
