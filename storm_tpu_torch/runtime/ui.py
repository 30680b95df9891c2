"""HTTP status + admin API — the Storm UI equivalent, copied from
``storm_tpu/runtime/ui.py``: a dependency-free asyncio HTTP server over
the running :class:`AsyncLocalCluster` (or the dist controller's view,
:mod:`storm_tpu_torch.dist.ui`), speaking JSON on routes modeled after
Storm's REST API (``/api/v1/...``), with storm_tpu's routes, keys and
status codes.

Read routes
    GET /healthz                              liveness of the server itself
    GET /api/v1/cluster/summary               all topologies + uptime
    GET /api/v1/topology/summary              per-topology health summaries
    GET /api/v1/topology/{name}               health + component table
    GET /api/v1/topology/{name}/metrics       full metrics snapshot
    GET /api/v1/topology/{name}/errors        reported component errors
    GET /api/v1/topology/{name}/graph         the DAG (components + edges)
    GET /api/v1/topology/{name}/component/{id}  per-executor stats table
    GET /api/v1/topology/{name}/logs          dist worker stderr tail
                                              (?worker=N&bytes=M)
    GET /api/v1/topology/{name}/traces        slowest/recent trace trees +
                                              flight tail (?n=20)
    GET /api/v1/topology/{name}/flight        flight-recorder events only
    GET /api/v1/topology/{name}/qos           admission/shed state
    GET /api/v1/topology/{name}/scorecard     fleet scenario-matrix scores
                                              (404 until one is attached as
                                              ``rt.scorecard``)
    GET /api/v1/topology/{name}/cascade       per-tier engines + escalation
    GET /api/v1/topology/{name}/profile       the live cost model (curves,
                                              burn, occupancy)
    GET /api/v1/topology/{name}/bottleneck    per-component utilization +
                                              ranked bottleneck verdict
    GET /api/v1/topology/{name}/copies        the copy ledger
    GET /api/v1/topology/{name}/plan          SLO-aware planner: solve for
                                              ?rate=&slo_ms= (+ coverage,
                                              online corrector state)
    GET /metrics                              Prometheus text exposition

Admin routes (POST, like Storm UI's topology actions)
    POST /api/v1/topology/{name}/activate
    POST /api/v1/topology/{name}/deactivate
    POST /api/v1/topology/{name}/drain        deactivate + wait in-flight
    POST /api/v1/topology/{name}/rebalance    body {"component":, "parallelism":}
    POST /api/v1/topology/{name}/kill         body {"wait_secs": 0} (optional)
    POST /api/v1/topology/{name}/swap_model   body {"component":, "model": {...}}
    POST /api/v1/topology/{name}/profile      body {"log_dir":, "seconds": 5}:
                                              a torch.profiler capture
                                              (trace.json in log_dir)
    POST /api/v1/topology/{name}/seek         body {"component":, "position":}
    POST /api/v1/topology/submit              a Flux definition (needs
                                              ``resources`` and the header
                                              X-Storm-Tpu-Submit: 1)
    POST /api/v1/drpc/{function}              body {"args": "<str>"}

Everything returns ``application/json``. The server binds 127.0.0.1 by
default. With ``auth_token`` set (config ``control.auth_token``), every
mutating route — the admin POSTs above and remote submit — requires
``Authorization: Bearer <token>``; mismatches get 401 and a log line
Read routes and DRPC (the data plane, like Storm's unauthenticated
DRPC servers) stay open; ``auth_token=""`` disables the check.
"""

from __future__ import annotations

import asyncio
import json
import time
from typing import Any, Dict, Optional, Tuple
from urllib.parse import parse_qs, urlsplit

import logging

log = logging.getLogger("storm_tpu_torch.ui")

_MAX_BODY = 32 << 20  # 32 MiB: sized for DRPC inference payloads, not just admin


class _PlainText(str):
    """Marker: route result is already rendered text, not JSON."""


class UIServer:
    """Serve status/admin HTTP for the topologies in an AsyncLocalCluster."""

    def __init__(self, cluster, host: str = "127.0.0.1", port: int = 0,
                 drpc=None, resources=None, auth_token: str = "") -> None:
        self.cluster = cluster
        self.host = host
        self.port = port  # replaced by the bound port after start()
        self.drpc = drpc  # optional DRPCServer: enables /api/v1/drpc/{fn}
        #: shared secret for mutating routes; "" disables (see module doc)
        self.auth_token = auth_token
        # shared objects exposed to submitted Flux definitions ($broker...);
        # None disables remote submission entirely
        self.resources = resources
        #: module prefixes a submitted definition's class paths may use
        self.submit_class_prefixes: tuple = ("storm_tpu_torch.",)
        self._server: Optional[asyncio.AbstractServer] = None
        self._started = time.monotonic()
        self._kill_tasks: set = set()
        self._profile_task = None

    async def start(self) -> "UIServer":
        self._server = await asyncio.start_server(self._serve, self.host, self.port)
        self.port = self._server.sockets[0].getsockname()[1]
        self._started = time.monotonic()
        log.info("ui listening on http://%s:%d", self.host, self.port)
        return self

    async def stop(self) -> None:
        if self._server is not None:
            self._server.close()
            await self._server.wait_closed()
            self._server = None
        if self._kill_tasks:
            # Exceptions are logged by _kill_done; never let a failing kill
            # abort the caller's shutdown sequence.
            await asyncio.gather(*list(self._kill_tasks), return_exceptions=True)
        if self._profile_task is not None and not self._profile_task.done():
            # A capture sleeps in a worker thread; wait it out so the
            # profiler stops before the loop tears down (cancel() could
            # not interrupt the thread anyway).
            await asyncio.gather(self._profile_task, return_exceptions=True)

    def _profile_done(self, task) -> None:
        if not task.cancelled() and task.exception() is not None:
            log.error("profile capture failed: %r", task.exception())

    def _kill_done(self, task) -> None:
        self._kill_tasks.discard(task)
        if not task.cancelled() and task.exception() is not None:
            log.error("topology kill failed: %r", task.exception())

    # ---- HTTP plumbing -------------------------------------------------------

    async def _serve(self, reader: asyncio.StreamReader,
                     writer: asyncio.StreamWriter) -> None:
        try:
            status, payload = await self._handle_one(reader)
        except Exception as e:  # defense: a handler bug must not kill the loop
            log.exception("ui handler error")
            status, payload = 500, {"error": str(e)}
        if isinstance(payload, _PlainText):
            body = str(payload).encode()
            ctype = "text/plain; version=0.0.4"  # Prometheus exposition
        else:
            body = json.dumps(payload, default=str).encode()
            ctype = "application/json"
        reason = {200: "OK", 400: "Bad Request", 401: "Unauthorized",
                  403: "Forbidden",
                  404: "Not Found",
                  405: "Method Not Allowed", 413: "Payload Too Large",
                  500: "Internal Server Error", 502: "Bad Gateway",
                  504: "Gateway Timeout"}
        head = (
            f"HTTP/1.1 {status} {reason.get(status, 'OK')}\r\n"
            f"Content-Type: {ctype}\r\n"
            f"Content-Length: {len(body)}\r\n"
            f"Connection: close\r\n\r\n"
        )
        try:
            writer.write(head.encode() + body)
            await writer.drain()
            writer.close()
            await writer.wait_closed()
        except (ConnectionError, BrokenPipeError):
            pass

    async def _handle_one(self, reader) -> Tuple[int, Any]:
        request_line = (await reader.readline()).decode("latin-1").strip()
        parts = request_line.split()
        if len(parts) != 3:
            return 400, {"error": "malformed request line"}
        method, target, _version = parts
        content_length = 0
        headers: Dict[str, str] = {}
        while True:
            line = (await reader.readline()).decode("latin-1").strip()
            if not line:
                break
            k, _, v = line.partition(":")
            headers[k.strip().lower()] = v.strip()
            if k.strip().lower() == "content-length":
                try:
                    content_length = int(v)
                except ValueError:
                    return 400, {"error": "bad content-length"}
                if content_length < 0:
                    return 400, {"error": "bad content-length"}
                if content_length > _MAX_BODY:
                    # explicit refusal beats silent truncation + bogus 400
                    return 413, {"error": f"body exceeds {_MAX_BODY} bytes"}
        body: Dict[str, Any] = {}
        if content_length:
            raw = await reader.readexactly(content_length)
            if raw.strip():
                try:
                    body = json.loads(raw)
                except ValueError:
                    return 400, {"error": "body is not JSON"}
                if not isinstance(body, dict):
                    return 400, {"error": "body must be a JSON object"}
        url = urlsplit(target)
        query = {k: v[-1] for k, v in parse_qs(url.query).items()}
        return await self._route(method, url.path.rstrip("/"), query, body,
                                 headers)

    # ---- routing -------------------------------------------------------------

    def _authorized(self, headers: Dict[str, str]) -> bool:
        """Bearer-token check for mutating routes (no-op when no token is
        configured). Constant-time comparison; rejects are logged with the
        failing route by the caller."""
        if not self.auth_token:
            return True
        import hmac

        auth = headers.get("authorization", "")
        scheme, _, cred = auth.partition(" ")
        # compare as bytes: compare_digest raises on non-ASCII str (a
        # non-ASCII secret or a garbage header would 500 instead of 401)
        return (scheme.lower() == "bearer"
                and hmac.compare_digest(
                    cred.strip().encode("utf-8", "surrogateescape"),
                    self.auth_token.encode("utf-8")))

    async def _route(self, method: str, path: str, query: Dict[str, str],
                     body: Dict[str, Any],
                     headers: Dict[str, str] = None) -> Tuple[int, Any]:
        headers = headers or {}
        # Auth gate for every mutating route: admin topology actions and
        # remote submit. GET/read routes and DRPC (data plane) stay open.
        if (method == "POST" and not path.startswith("/api/v1/drpc/")
                and not self._authorized(headers)):
            log.warning("rejected unauthenticated %s %s", method, path)
            return 401, {"error": "missing or invalid bearer token "
                                  "(control.auth_token is set)"}
        if path == "/healthz":
            return 200, {"status": "ok", "uptime_s": round(time.monotonic() - self._started, 3)}
        if path == "/metrics":
            # Prometheus text exposition over every live topology. Off-loop:
            # a dist-backed registry fans out blocking RPCs to workers, and
            # a slow worker must not freeze every other route.
            from storm_tpu_torch.runtime.metrics import prometheus_text

            regs = {name: rt.metrics for name, rt in self._runtimes().items()}
            text = await asyncio.to_thread(prometheus_text, regs)
            return 200, _PlainText(text)
        if path == "/api/v1/cluster/summary":
            # Off-loop: engine_inventory takes _ENGINES_LOCK, which a model
            # swap/submit holds for an entire engine build.
            return 200, await asyncio.to_thread(self._cluster_summary)
        if path == "/api/v1/topology/summary":
            rts = list(self._runtimes().values())
            return 200, {"topologies": await asyncio.to_thread(
                lambda: [self._topo_summary(rt) for rt in rts])}
        if path == "/api/v1/topology/submit":
            # StormSubmitter over the wire: a Flux definition becomes a
            # running topology on this daemon's cluster.
            if method != "POST":
                return 405, {"error": "submit is POST"}
            if self.resources is None:
                return 404, {"error": "remote submission disabled "
                                      "(server started without resources)"}
            # The custom header blocks browser CSRF (cross-origin requests
            # cannot attach it without a CORS preflight this server never
            # approves); class paths are allowlisted because a dotted path
            # is arbitrary code execution on untrusted input.
            if headers.get("x-storm-tpu-submit") != "1":
                return 403, {"error": "missing X-Storm-Tpu-Submit: 1 header"}
            definition = body.get("definition")
            name = body.get("name")
            if not name or not isinstance(definition, dict):
                return 400, {"error": 'need {"name": ..., "definition": {...}}'}
            if name in self._runtimes():
                return 400, {"error": f"topology {name!r} already running"}
            from storm_tpu_torch.config import Config as _Config
            from storm_tpu_torch.flux import FluxError, load_topology

            try:
                topo = await asyncio.to_thread(
                    load_topology, definition, dict(self.resources),
                    self.submit_class_prefixes)
                await self.cluster.submit(name, _Config(), topo)
            except (FluxError, ValueError, TypeError) as e:
                # malformed definitions, bad wiring, and the duplicate-name
                # race are all client errors, not server faults
                return 400, {"error": str(e)}
            return 200, {"status": "SUBMITTED", "name": name,
                         "components": sorted(topo.specs)}
        if path.startswith("/api/v1/drpc/"):
            if method != "POST":
                return 405, {"error": "drpc is POST"}
            if self.drpc is None:
                return 404, {"error": "no DRPC server attached"}
            function = path[len("/api/v1/drpc/"):]
            args = body.get("args") if isinstance(body, dict) else None
            if not function or not isinstance(args, str):
                return 400, {"error": 'need function in path and {"args": "<str>"}'}
            try:
                timeout_s = float(query.get("timeout_s", 30.0))
            except ValueError:
                return 400, {"error": "timeout_s must be a number"}
            # finite + bounded: inf would park the handler forever and leak
            # the pending future; cap keeps hung clients from pinning sockets
            if not (0 < timeout_s <= 600):
                return 400, {"error": "timeout_s must be in (0, 600]"}
            from storm_tpu_torch.runtime.drpc import (
                DRPCError,
                DRPCTimeout,
                DRPCUnknownFunction,
            )

            try:
                result = await self.drpc.execute(function, args, timeout_s)
            except DRPCUnknownFunction as e:
                return 404, {"error": str(e)}
            except DRPCTimeout as e:
                return 504, {"error": str(e)}
            except DRPCError as e:
                return 502, {"error": str(e)}
            return 200, {"result": result}
        if path.startswith("/api/v1/topology/"):
            rest = path[len("/api/v1/topology/"):]
            name, _, action = rest.partition("/")
            rt = self._runtimes().get(name)
            if rt is None:
                return 404, {"error": f"no topology named {name!r}"}
            if not action:
                if method != "GET":
                    return 405, {"error": "use GET"}
                # off-loop: dist-backed health()/snapshot() block on worker RPCs
                return 200, await asyncio.to_thread(self._topo_detail, rt)
            if action == "logs":
                if method != "GET":
                    return 405, {"error": "use GET"}
                if not hasattr(rt, "worker_logs"):
                    return 404, {"error": "logs only available for dist "
                                          "topologies (local runtimes log "
                                          "to their own stderr)"}
                try:
                    widx = int(query.get("worker", 0))
                    tail = int(query.get("bytes", 16384))
                except ValueError:
                    return 400, {"error": "worker and bytes must be ints"}
                if tail < 1:
                    return 400, {"error": "bytes must be >= 1"}
                tail = min(tail, 1 << 20)
                try:
                    text = await rt.worker_logs(widx, tail)
                except KeyError as e:
                    return 404, {"error": e.args[0] if e.args else str(e)}
                return 200, {"worker": widx, "log": text}
            if action.startswith("component/"):
                # Per-executor stats table (Storm UI's executor rows).
                if method != "GET":
                    return 405, {"error": "use GET"}
                from urllib.parse import unquote

                cid = unquote(action[len("component/"):])
                try:
                    stats = await asyncio.to_thread(rt.component_stats, cid)
                except KeyError:
                    return 404, {"error": f"no component {cid!r}"}
                return 200, {"component": cid, "executors": stats}
            if action == "graph":
                if method != "GET":
                    return 405, {"error": "use GET"}
                graph = self._topo_graph(rt)
                if graph is None:
                    return 404, {"error": "graph unavailable for this runtime"}
                return 200, graph
            if action in ("traces", "flight"):
                # Slowest/recent trace trees + flight-recorder tail
                # (?n= caps list sizes). /flight is the events-only view.
                if method != "GET":
                    return 405, {"error": "use GET"}
                try:
                    n = int(query.get("n", 20))
                except ValueError:
                    return 400, {"error": "n must be an int"}
                if not 1 <= n <= 500:
                    return 400, {"error": "n must be in [1, 500]"}
                if hasattr(rt, "traces"):
                    # dist view: per-worker RPC fan-out, already off-loop
                    data = await rt.traces(n)
                else:
                    tracer = getattr(rt, "tracer", None)
                    flight = getattr(rt, "flight", None)
                    if tracer is None and flight is None:
                        return 404, {"error": "tracing unavailable for "
                                              "this runtime"}
                    data = {
                        "slowest": tracer.store.slowest(n) if tracer else [],
                        "recent": tracer.store.recent(n) if tracer else [],
                        "stats": tracer.store.stats() if tracer else {},
                        "flight": flight.tail(n) if flight else [],
                    }
                if action == "flight":
                    return 200, {"topology": rt.name,
                                 "flight": data.get("flight", [])}
                return 200, {"topology": rt.name, **data}
            if action in ("metrics", "errors"):
                if method != "GET":
                    return 405, {"error": "use GET"}
                if action == "metrics":
                    return 200, await asyncio.to_thread(rt.metrics.snapshot)
                return 200, {"errors": [
                    {"component": cid, "task": idx, "error": repr(err)}
                    for cid, idx, err in rt.errors
                ]}
            if action == "qos":
                # Admission/shed state: the "qos" metrics component (shed
                # level gauge, per-tenant/per-lane admission counters —
                # present on dist views too via the merged snapshot) plus
                # the local shed controller's decision ledger when one is
                # attached (LoadShedController sets rt.qos).
                if method != "GET":
                    return 405, {"error": "use GET"}
                snap = await asyncio.to_thread(rt.metrics.snapshot)
                out = {"topology": rt.name, "qos": snap.get("qos", {})}
                shedder = getattr(rt, "qos", None)
                if shedder is not None:
                    out["shed_level"] = shedder.level
                    out["decisions"] = [
                        {"direction": d, "from": a, "to": b}
                        for d, a, b in shedder.decisions]
                # Continuous-batching fairness: per-engine queue state with
                # fair_rows/fair_starved per tenant:lane key and the batch
                # fill median — shed decisions and batching fairness read
                # from one place. Empty when continuous batching is off.
                from storm_tpu_torch.infer.continuous import registry_stats

                out["continuous"] = await asyncio.to_thread(registry_stats)
                return 200, out
            if action == "scorecard":
                # Fleet scenario-matrix scorecard (storm_tpu_torch.loadgen): the
                # fleet matrix attaches its accumulated matrix to the
                # runtime it is currently driving (rt.scorecard), so an
                # operator can watch cells land mid-run; 404 on topologies
                # no fleet drill is scoring.
                if method != "GET":
                    return 405, {"error": "use GET"}
                sc = getattr(rt, "scorecard", None)
                if sc is None:
                    return 404, {"error": "no scorecard attached (run python -m "
                                          "storm_tpu_torch.loadgen.fleet)"}
                return 200, {"topology": rt.name, **sc}
            if action == "cascade":
                # Tiered-serving state: per-tier engine attribution (model,
                # checkpoint, gate, device memory) from every cascading bolt executor
                # plus the escalation-rate gauge and the process engine
                # inventory — a multi-engine bolt reads as N sized tiers,
                # not one opaque blob.
                if method != "GET":
                    return 405, {"error": "use GET"}
                bolts = []
                for cid, execs in getattr(rt, "bolt_execs", {}).items():
                    for e in execs:
                        router = getattr(e.bolt, "_router", None)
                        if router is None:
                            continue
                        bolts.append({
                            "component": cid, "task": e.task_index,
                            "escalation_rate": round(
                                router.escalation_rate(), 4),
                            "tiers": router.inventory()})
                snap = await asyncio.to_thread(rt.metrics.snapshot)
                from storm_tpu_torch.infer.engine import engine_inventory

                return 200, {
                    "topology": rt.name, "bolts": bolts,
                    "cascade": snap.get("cascade", {}),
                    "engines": await asyncio.to_thread(engine_inventory)}
            if action == "profile" and method == "GET":
                # Live cost model (obs/): per-(engine, bucket)
                # stage-cost curves + compile costs from the process
                # ProfileStore, plus — when an Observatory is attached
                # (rt.obs) — SLO burn state, occupancy, and the sentinel's
                # latest regressions. (POST /profile stays the
                # torch.profiler capture action below.)
                from storm_tpu_torch.obs.profile import profile_store

                out = {"topology": rt.name,
                       "profile": await asyncio.to_thread(
                           profile_store().snapshot)}
                obs = getattr(rt, "obs", None)
                if obs is not None:
                    out.update(await asyncio.to_thread(obs.snapshot))
                else:
                    snap = await asyncio.to_thread(rt.metrics.snapshot)
                    out["slo"] = snap.get("slo", {})
                return 200, out
            if action == "bottleneck" and method == "GET":
                # Where is the topology limited right now? Local runtimes
                # answer from the attached Observatory's control loop —
                # its last verdict, not a fresh sample (sampling here
                # would race the loop's windowed cursors). Dist views
                # answer with controller-merged per-worker utilization.
                if hasattr(rt, "bottleneck"):  # DistRuntimeView
                    return 200, await rt.bottleneck()
                obs = getattr(rt, "obs", None)
                if obs is None:
                    return 404, {"error": "no observatory attached "
                                          "(obs.enabled=false?)"}
                out = {"topology": rt.name}
                out.update(await asyncio.to_thread(obs.bottleneck_snapshot))
                return 200, out
            if action == "copies" and method == "GET":
                # Data-plane copy ledger: bytes/copies per record-path
                # hop plus the derived amplification ratio. Local
                # runtimes answer from the attached Observatory (its
                # windowed view + cumulative totals); without one the
                # process ledger's cumulative snapshot still answers.
                # Dist views merge per-worker windows controller-side.
                if hasattr(rt, "copies"):  # DistRuntimeView
                    return 200, await rt.copies()
                obs = getattr(rt, "obs", None)
                out = {"topology": rt.name}
                if obs is not None:
                    out.update(await asyncio.to_thread(obs.copies_snapshot))
                else:
                    from storm_tpu_torch.obs.copyledger import copy_ledger

                    out["cumulative"] = await asyncio.to_thread(
                        copy_ledger().snapshot)
                return 200, out
            if action == "plan" and method == "GET":
                # SLO-aware planner (plan/): with ?rate=<rows/s>
                # &slo_ms=<ms> (optional &engine=, &headroom=) solve over
                # the live ProfileStore for the cheapest config meeting
                # the target; without a target, report curve coverage and
                # the online corrector's state. Dist views answer through
                # the controller (merged utilization as the planner's
                # framework input).
                if hasattr(rt, "plan"):  # DistRuntimeView
                    return 200, await rt.plan(query)
                obs = getattr(rt, "obs", None)
                corr = getattr(obs, "corrector", None)
                out: Dict[str, Any] = {
                    "topology": rt.name,
                    "corrector": (corr.snapshot() if corr is not None
                                  else None)}
                from storm_tpu_torch.obs.profile import profile_store

                snap = await asyncio.to_thread(profile_store().snapshot)
                try:
                    rate = float(query.get("rate", 0) or 0)
                    slo = float(query.get("slo_ms", 0) or 0)
                    headroom = float(query.get("headroom", 0.8))
                except ValueError:
                    return 400, {"error": "rate/slo_ms/headroom must be "
                                          "numbers"}
                if rate <= 0 or slo <= 0:
                    from storm_tpu_torch.plan.model import CostModel

                    out["coverage"] = CostModel(snap).coverage()
                    out["note"] = ("no target given: pass ?rate=<rows/s>"
                                   "&slo_ms=<ms> to solve")
                    return 200, out
                from storm_tpu_torch.plan import Target, solve

                target = Target(rate, slo, headroom=headroom)
                util = obs.capacity.last if obs is not None else None
                res = await asyncio.to_thread(
                    solve, snap, target, engine=query.get("engine"),
                    utilization=util)
                out.update(res.to_dict())
                return 200, out
            if method != "POST":
                return 405, {"error": "topology actions are POST"}
            return await self._action(rt, action, {**query, **body})
        return 404, {"error": f"no route {path!r}"}

    def _runtimes(self):
        return self.cluster.runtimes

    def _cluster_summary(self) -> Dict[str, Any]:
        from storm_tpu_torch.infer.engine import engine_inventory

        return {
            "uptime_s": round(time.monotonic() - self._started, 3),
            "topologies": sorted(self._runtimes()),
            # Multi-model device-memory budget: engines co-resident in this process
            # (empty when topologies run in dist workers — each worker
            # owns its own engines).
            "engines": engine_inventory(),
        }

    def _topo_summary(self, rt, health: Dict[str, Any] = None) -> Dict[str, Any]:
        h = health if health is not None else rt.health()
        if hasattr(rt, "is_active"):  # dist adapter and other views
            active = rt.is_active()
        else:
            active = all(
                e._active for execs in rt.spout_execs.values() for e in execs
            ) if rt.spout_execs else True
        return {
            "name": rt.name,
            "status": "ACTIVE" if active else "INACTIVE",
            "inflight_trees": h["inflight_trees"],
            "components": {cid: c["tasks"] for cid, c in h["components"].items()},
        }

    def _topo_detail(self, rt) -> Dict[str, Any]:
        # One health fetch serves both summary and detail: on the dist
        # backend each fetch is a per-worker RPC fan-out, and two fetches
        # could disagree mid-rebalance.
        health = rt.health()
        summary = self._topo_summary(rt, health)
        snap = rt.metrics.snapshot()
        comps = {}
        for cid, info in health["components"].items():
            m = snap.get(cid, {})
            comps[cid] = {
                "tasks": info["tasks"],
                "alive": info["alive"],
                # the Storm UI headline columns, where the component has them
                "executed": m.get("executed"),
                "acked": m.get("tree_acked"),
                "failed": m.get("tree_failed"),
                "errors": m.get("errors"),
                "execute_ms": m.get("execute_ms"),
            }
        summary["components"] = comps
        summary["errors"] = len(rt.errors)
        return summary

    def _topo_graph(self, rt) -> Optional[Dict[str, Any]]:
        """The topology DAG (Storm UI's visualization data): components with
        their parallelism and declared streams, edges with groupings."""
        topo = getattr(rt, "topology", None)
        if topo is None:
            return None  # e.g. dist-backed views; the route 404s
        components, edges = {}, []
        for spec in topo.specs.values():
            obj = spec.obj
            components[spec.component_id] = {
                "type": "spout" if spec.is_spout else "bolt",
                "parallelism": spec.parallelism,
                "streams": {k: list(v)
                            for k, v in obj.declare_output_fields().items()},
            }
            for sub in spec.inputs:
                edge = {
                    "from": sub.source,
                    "stream": sub.stream,
                    "to": spec.component_id,
                    "grouping": type(sub.grouping).__name__,
                }
                fields = getattr(sub.grouping, "field_names", None)
                if fields:  # the routing key is the edge's defining info
                    edge["fields"] = list(fields)
                edges.append(edge)
        return {"name": rt.name, "components": components, "edges": edges}

    async def _action(self, rt, action: str,
                      args: Dict[str, Any]) -> Tuple[int, Any]:
        if action == "activate":
            await rt.activate()
            return 200, {"status": "ACTIVE"}
        if action == "deactivate":
            await rt.deactivate()
            return 200, {"status": "INACTIVE"}
        if action == "drain":
            try:
                timeout_s = float(args.get("timeout_s", 30.0))
            except (TypeError, ValueError):
                return 400, {"error": "timeout_s must be a number"}
            await rt.deactivate()
            ok = await rt.drain(timeout_s=timeout_s)
            return 200, {"status": "INACTIVE", "drained": bool(ok)}
        if action == "seek":
            from storm_tpu_torch.connectors.spout import parse_seek_position

            component = args.get("component")
            try:
                position = parse_seek_position(args.get("position"))
            except ValueError as e:
                return 400, {"error": str(e)}
            if not component:
                return 400, {"error": "need component"}
            try:
                n = await rt.seek(component, position)
            except KeyError:
                return 404, {"error": f"no component {component!r}"}
            except TypeError as e:
                return 400, {"error": str(e)}
            return 200, {"component": component, "position": position,
                         "instances": n}
        if action == "profile":
            # On-demand torch.profiler capture: card and host timelines
            # for ``seconds`` into ``log_dir`` (trace.json, a Chrome
            # trace). The capture runs as a background task; the response
            # returns immediately with the target dir.
            log_dir = args.get("log_dir")
            try:
                seconds = float(args.get("seconds", 5.0))
            except (TypeError, ValueError):
                return 400, {"error": "seconds must be a number"}
            import math

            if not log_dir or not math.isfinite(seconds) or \
                    not 0 < seconds <= 300:
                return 400, {"error": "need log_dir and 0 < seconds <= 300"}
            if hasattr(rt, "profile"):
                # Dist runtime: capture on the worker owning the engines
                # (body {"worker": N}), not in the controller process.
                try:
                    worker = int(args.get("worker", 0))
                except (TypeError, ValueError):
                    return 400, {"error": "worker must be an int"}
                try:
                    resp = await rt.profile(log_dir, seconds, worker)
                except KeyError as e:
                    return 404, {"error": str(e)}
                except RuntimeError as e:
                    if "already running" in str(e):
                        return 409, {"error": str(e)}
                    raise
                return 200, {"log_dir": log_dir, "seconds": seconds,
                             "worker": worker, "status": "capturing",
                             **{k: v for k, v in resp.items() if k != "ok"}}
            if self._profile_task is not None and not self._profile_task.done():
                return 409, {"error": "a profile capture is already running"}

            async def capture():
                from storm_tpu_torch.runtime.tracing import device_trace

                def run_trace():
                    with device_trace(log_dir):
                        time.sleep(seconds)

                await asyncio.to_thread(run_trace)

            self._profile_task = asyncio.ensure_future(capture())
            self._profile_task.add_done_callback(self._profile_done)
            return 200, {"log_dir": log_dir, "seconds": seconds,
                         "status": "capturing"}
        if action == "swap_model":
            component = args.get("component")
            overrides = args.get("model")
            tasks = args.get("tasks")
            if not component or not isinstance(overrides, dict) or not overrides:
                return 400, {"error": "need component and a non-empty "
                                      "model overrides object"}
            if tasks is not None and (
                    not isinstance(tasks, list)
                    or not all(isinstance(t, int) for t in tasks)
                    or not tasks):
                return 400, {"error": "tasks must be a non-empty int list"}
            try:
                new_cfg = await rt.swap_model(component, overrides,
                                              tasks=tasks)
            except KeyError as e:
                return 404, {"error": e.args[0] if e.args
                             else f"no component {component!r}"}
            except TypeError as e:
                return 400, {"error": str(e)}
            except ValueError as e:
                return 400, {"error": f"invalid model config: {e}"}
            import dataclasses as _dc

            model = _dc.asdict(new_cfg) if _dc.is_dataclass(new_cfg) else new_cfg
            return 200, {"component": component, "model": model,
                         **({"tasks": tasks} if tasks is not None else {})}
        if action == "rebalance":
            component = args.get("component")
            try:
                parallelism = int(args.get("parallelism", 0))
            except (TypeError, ValueError):
                return 400, {"error": "parallelism must be an int"}
            if not component or parallelism < 1:
                return 400, {"error": "need component and parallelism >= 1"}
            try:
                await rt.rebalance(component, parallelism)
            except KeyError:
                return 404, {"error": f"no component {component!r}"}
            return 200, {"component": component, "parallelism": parallelism}
        if action == "kill":
            try:
                wait_secs = float(args.get("wait_secs", 0.0))
            except (TypeError, ValueError):
                return 400, {"error": "wait_secs must be a number"}
            # Mirror Storm UI: respond once the kill is initiated. Retain the
            # task so its exceptions are observed (and a double-kill is a
            # no-op at the cluster layer).
            task = asyncio.ensure_future(
                self.cluster.kill(rt.name, wait_secs=wait_secs)
            )
            self._kill_tasks.add(task)
            task.add_done_callback(self._kill_done)
            if self.drpc is not None:
                # a dead topology can never answer: fail in-flight DRPC
                # callers now instead of letting their timeouts burn
                task.add_done_callback(
                    lambda _t: self.drpc.fail_all("topology killed")
                )
            return 200, {"status": "KILLED", "wait_secs": wait_secs}
        return 404, {"error": f"no action {action!r}"}
