"""The command line and the topology builders, the counterpart of
``storm_tpu/main.py``::

    python -m storm_tpu_torch.main run <name> <input-topic> <output-topic> \
        [--config cfg.toml] [--set section.key=value ...] [--duration SECS] \
        [--autoscale-target-ms MS] [--ui-port PORT] [--device cuda|cpu]
    python -m storm_tpu_torch.main dist-run <name> <in> <out> --workers N ...
    python -m storm_tpu_torch.main serve --model vit_b16 --port 50051
    python -m storm_tpu_torch.main info
    python -m storm_tpu_torch.main ctl --url http://127.0.0.1:8080 <command> ...
    python -m storm_tpu_torch.main traces|profile|bottleneck|copies <topology>
    python -m storm_tpu_torch.main plan [<topology>] --rate R --slo-ms MS \
        [--baseline PROFILE.json]
    python -m storm_tpu_torch.main scorecard [<topology>] [--file SCORECARD.json]

``run`` builds the standard topology (spout -> inference -> sink, plus a
dead-letter sink; one chain per ``[[pipelines]]`` entry, or a Flux file)
and runs it as a daemon, with the shedders, the Observatory, the plan
corrector, the autoscaler and the UI its config and flags ask for; a
signal or ``--duration`` deactivates, drains and kills it. ``dist-run``
spreads the topology over worker processes (:mod:`storm_tpu_torch.dist`).
``serve`` starts the inference worker (:mod:`storm_tpu_torch.serve`) over
the port's frames. ``run``, ``dist-run`` and ``serve`` run on the card
unless ``--device cpu`` is given (storm_tpu picks its platform from
``JAX_PLATFORMS`` instead). ``scorecard`` renders the fleet matrix's
scorecard (:mod:`storm_tpu_torch.loadgen`), from a file or from the route
the fleet matrix attaches to the topology it drives. storm_tpu's
``lint`` (its analyzer) is not ported.

The builders: ``build_standard_topology``, the reference DAG (one ingest
spout, the inference operator, an egress sink and a dead-letter sink, with
the topology config's parallelism and the spout's chunks, scheme and
frames taken from ``cfg.topology``); ``build_null_engine_topology``, the
same DAG with a device-free :class:`NullEngine` in the inference slot;
``build_multi_model_topology``, one such chain per pipeline. Both sinks
are transactional under ``cfg.sink.mode == "transactional"``
(``_make_sink``). ``_make_broker`` builds ``cfg.broker``: the memory
broker, or the Kafka wire broker that dist workers share. The topics
default to ``cfg.broker``'s, which is how a dist worker builds them.
"""

from __future__ import annotations

import argparse
import asyncio
import json
import logging
import os
import signal
import sys
import threading
import time
from typing import Optional

from storm_tpu_torch.config import Config


def _make_sink(cfg: Config, broker, topic: str):
    from storm_tpu_torch.connectors import BrokerSink, TransactionalBrokerSink

    if cfg.sink.mode == "transactional":
        return TransactionalBrokerSink(broker, topic, cfg.sink)
    return BrokerSink(broker, topic, cfg.sink)


def _make_broker(cfg: Config):
    """``cfg.broker`` as a broker object: ``kind="memory"`` an in-process
    :class:`MemoryBroker`, ``kind="kafka"`` the pure-Python wire client's
    :class:`KafkaWireBroker` at ``bootstrap``."""
    if cfg.broker.kind == "memory":
        from storm_tpu_torch.connectors import MemoryBroker

        return MemoryBroker(default_partitions=cfg.broker.partitions)
    if cfg.broker.kind == "kafka":
        from storm_tpu_torch.connectors.kafka_protocol import KafkaWireBroker

        return KafkaWireBroker(cfg.broker.bootstrap,
                               message_format=cfg.broker.message_format,
                               compression=cfg.broker.compression,
                               idempotent=cfg.broker.idempotent,
                               isolation=cfg.broker.isolation,
                               security=cfg.broker.security_dict())
    raise ValueError(f"unknown broker kind {cfg.broker.kind!r}")


def _build(cfg: Config, broker, bolt, input_topic, output_topic, dead_letter_topic):
    from storm_tpu_torch.connectors import BrokerSpout
    from storm_tpu_torch.runtime import TopologyBuilder

    qos = cfg.qos if cfg.qos.enabled else None
    topo = cfg.topology
    tb = TopologyBuilder()
    tb.set_spout("kafka-spout",
                 BrokerSpout(broker, input_topic or cfg.broker.input_topic, cfg.offsets,
                             chunk=topo.spout_chunk, scheme=topo.spout_scheme, qos=qos,
                             frames=topo.spout_frames),
                 parallelism=topo.spout_parallelism)
    tb.set_bolt("inference-bolt", bolt,
                parallelism=topo.inference_parallelism).shuffle_grouping("kafka-spout")
    tb.set_bolt("kafka-bolt", _make_sink(cfg, broker, output_topic or cfg.broker.output_topic),
                parallelism=topo.sink_parallelism).shuffle_grouping("inference-bolt")
    tb.set_bolt("dlq-bolt",
                _make_sink(cfg, broker, dead_letter_topic or cfg.broker.dead_letter_topic),
                parallelism=1).shuffle_grouping("inference-bolt", stream="dead_letter")
    return tb.build()


def build_standard_topology(cfg: Config, broker, *, input_topic: Optional[str] = None,
                            output_topic: Optional[str] = None,
                            dead_letter_topic: Optional[str] = None, device=None,
                            engine=None):
    """``broker``'s input topic -> ``kafka-spout`` -> ``inference-bolt``
    (``cfg.model`` and ``cfg.batch`` on ``device``, or ``engine``) ->
    ``kafka-bolt`` -> the output topic, and the operator's dead letters ->
    ``dlq-bolt`` -> the dead-letter topic; a topic not given is
    ``cfg.broker``'s. With ``cfg.qos`` enabled the spout classifies and
    admits records and the lane rides to the sink
    (``passthrough=("qos_lane",)``); with ``cfg.cascade`` enabled the
    operator serves through the cascade's tiers."""
    from storm_tpu_torch.infer import InferenceBolt

    qos = cfg.qos if cfg.qos.enabled else None
    cascade = cfg.cascade if cfg.cascade.enabled else None
    bolt = InferenceBolt(cfg.model, cfg.batch, device=device, engine=engine, qos=qos,
                         sharding=cfg.sharding,
                         cascade=cascade, passthrough=("qos_lane",) if qos else ())
    return _build(cfg, broker, bolt, input_topic, output_topic, dead_letter_topic)


def build_null_engine_topology(cfg: Config, broker, *, input_topic: Optional[str] = None,
                               output_topic: Optional[str] = None,
                               dead_letter_topic: Optional[str] = None, device=None):
    """The standard DAG with a :class:`NullEngine` in the inference slot:
    no device work, predictions a uniform distribution computed at once,
    so everything measured is the framework's cost (spout, routing,
    ledger, the inter-worker wire). ``device`` is accepted for the dist
    workers' builder call and unused."""
    from storm_tpu_torch.infer import InferenceBolt
    from storm_tpu_torch.infer.engine import NullEngine

    qos = cfg.qos if cfg.qos.enabled else None
    cascade = cfg.cascade if cfg.cascade.enabled else None
    engine = NullEngine(cfg.model.input_shape, cfg.model.num_classes)
    bolt = InferenceBolt(cfg.model, cfg.batch, engine=engine, warmup=False, qos=qos,
                         sharding=cfg.sharding,
                         cascade=cascade, passthrough=("qos_lane",) if qos else ())
    return _build(cfg, broker, bolt, input_topic, output_topic, dead_letter_topic)

def build_multi_model_topology(cfg: Config, broker, *, device=None):
    """One spout -> inference -> sink chain per ``cfg.pipelines`` entry in
    one topology: each pipeline its own model, batching, sharding and
    topics, its components named ``<name>-spout``, ``<name>-inference``,
    ``<name>-sink`` and ``<name>-dlq``. The engines are the process's shared
    ones (``shared_engine``), so two pipelines of one model share weights
    on the card."""
    from storm_tpu_torch.connectors import BrokerSink, BrokerSpout
    from storm_tpu_torch.infer import InferenceBolt
    from storm_tpu_torch.runtime import TopologyBuilder

    if not cfg.pipelines:
        raise ValueError("build_multi_model_topology needs cfg.pipelines")
    qos = cfg.qos if cfg.qos.enabled else None  # shared across pipelines
    cascade = cfg.cascade if cfg.cascade.enabled else None
    tb = TopologyBuilder()
    for p in cfg.pipelines:
        spout_id, infer_id = f"{p.name}-spout", f"{p.name}-inference"
        scheme = p.spout_scheme or cfg.topology.spout_scheme
        tb.set_spout(spout_id,
                     BrokerSpout(broker, p.input_topic, p.offsets,
                                 chunk=p.spout_chunk or cfg.topology.spout_chunk,
                                 scheme=scheme, qos=qos,
                                 frames=cfg.topology.spout_frames and scheme == "raw"),
                     parallelism=p.spout_parallelism)
        tb.set_bolt(infer_id,
                    InferenceBolt(p.model, p.batch, device=device, qos=qos,
                                  sharding=p.sharding, cascade=cascade,
                                  passthrough=("qos_lane",) if qos else ()),
                    parallelism=p.inference_parallelism).shuffle_grouping(spout_id)
        tb.set_bolt(f"{p.name}-sink", BrokerSink(broker, p.output_topic, cfg.sink),
                    parallelism=p.sink_parallelism).shuffle_grouping(infer_id)
        tb.set_bolt(f"{p.name}-dlq", BrokerSink(broker, p.dead_letter_topic, cfg.sink),
                    parallelism=1).shuffle_grouping(infer_id, stream="dead_letter")
    return tb.build()


def setup_logging(level: str = "") -> None:
    """storm_tpu's logging setup (``storm_tpu/utils/logging.py``): the
    level from ``level`` or ``$STORM_TPU_LOG`` (default INFO)."""
    level = level or os.environ.get("STORM_TPU_LOG", "INFO")
    logging.basicConfig(level=getattr(logging, level.upper(), logging.INFO),
                        format="%(asctime)s %(levelname)s %(name)s: %(message)s")


def _load_config(args) -> Config:
    cfg = Config.load(args.config) if args.config else Config()
    if args.set:
        cfg.apply_overrides(args.set)
    return cfg


async def _run_daemon(name: str, cfg: Config, duration: float,
                      autoscale_target_ms: float = 0.0,
                      ui_port: int = -1,
                      metrics_file: str = "",
                      metrics_interval_s: float = 10.0,
                      topology_file: str = "",
                      device: str = "cuda",
                      stop: Optional[asyncio.Event] = None,
                      started=None, autoscale_interval_s: float = 5.0) -> None:
    """The ``run`` daemon: submit the topology, wire the shedders, the
    Observatory, the plan corrector, the autoscalers and the UI as the
    config and flags ask, serve until a signal, ``duration`` or ``stop``,
    then stop them, deactivate, drain and kill. ``started(info)``, when
    given, is called once everything is up with ``{"runtime", "cluster",
    "ui", "scalers", "shedders", "observatory", "broker"}`` (an embedding
    caller's handle; the CLI passes none). ``autoscale_interval_s`` is the
    autoscalers' step interval (the policy's default)."""
    from storm_tpu_torch.runtime.cluster import AsyncLocalCluster

    broker = _make_broker(cfg)
    if topology_file:
        from storm_tpu_torch.flux import load_topology

        topo = load_topology(topology_file, resources={"broker": broker})
        desc = f"flux:{topology_file}"
    elif cfg.pipelines:
        topo = build_multi_model_topology(cfg, broker, device=device)
        desc = "+".join(p.model.name for p in cfg.pipelines)
    else:
        topo = build_standard_topology(cfg, broker, device=device)
        desc = cfg.model.name
    cluster = AsyncLocalCluster()
    rt = await cluster.submit(name, cfg, topo)
    if metrics_file:
        from storm_tpu_torch.runtime.metrics import JsonLinesConsumer

        rt.add_metrics_consumer(JsonLinesConsumer(metrics_file),
                                interval_s=metrics_interval_s)
    # One control pair per inference/sink chain: the standard topology has
    # one; a multi-model topology has one per pipeline.
    pairs = (
        [(f"{p.name}-inference", f"{p.name}-sink") for p in cfg.pipelines]
        if cfg.pipelines
        else [("inference-bolt", "kafka-bolt")]
    )
    shedders = []
    if cfg.qos.enabled and not topology_file:
        from storm_tpu_torch.qos import LoadShedController, ShedPolicy

        # The shed loop runs faster than the autoscaler (1 s vs 5 s
        # default) and is handed to it below: shed first, scale second.
        shedders = [
            LoadShedController(
                rt, ShedPolicy.from_qos(cfg.qos, infer_id, sink_id)).start()
            for infer_id, sink_id in pairs
        ]
    observatory = None
    if cfg.obs.enabled and not topology_file:
        from storm_tpu_torch.obs import Observatory

        # Burn is computed over ALL sink components (one per pipeline);
        # the trip feeds every shedder as an extra hot signal.
        observatory = Observatory(
            rt, cfg.obs,
            sink_components=tuple(sink_id for _, sink_id in pairs)).start()
        for shedder in shedders:
            shedder.burn = observatory.burn
        if cfg.plan.enabled:
            from storm_tpu_torch.plan import PlanCorrector

            # Online half of the planner: stepped by the Observatory
            # loop, consumes this topology's verdict + burn state, and
            # (below) makes the autoscalers defer their global scale-up.
            observatory.corrector = PlanCorrector(
                rt, cfg.plan, attributor=observatory.bottleneck,
                burn=observatory.burn)
    scalers = []
    if autoscale_target_ms > 0:
        from storm_tpu_torch.runtime.autoscale import (
            ACCEL_MAX_PARALLELISM,
            Autoscaler,
            AutoscalePolicy,
        )

        # The inference operator fronts a batching accelerator, so ITS
        # policy carries the measured inversion cap (not the global
        # dataclass default).
        scalers = [
            Autoscaler(
                rt,
                AutoscalePolicy(
                    component=infer_id,
                    latency_source=sink_id,
                    high_ms=autoscale_target_ms,
                    low_ms=autoscale_target_ms / 4,
                    max_parallelism=ACCEL_MAX_PARALLELISM,
                    interval_s=autoscale_interval_s,
                ),
                shedder=shedders[i] if shedders else None,
            ).start()
            for i, (infer_id, sink_id) in enumerate(pairs)
        ]
        if observatory is not None:
            # Bottleneck verdicts become a scale-up signal: a scaler
            # whose component is the NAMED bottleneck at capacity goes
            # hot even before the latency policy trips.
            for scaler in scalers:
                scaler.bottleneck = observatory.bottleneck
                scaler.corrector = observatory.corrector
    ui = None
    if ui_port >= 0:
        from storm_tpu_torch.runtime.ui import UIServer

        # remote submission gets the daemon's broker as $broker
        ui = await UIServer(cluster, port=ui_port,
                            resources={"broker": broker},
                            auth_token=cfg.control.resolve_token()).start()
    print(f"topology {name!r} running "
          f"(model={desc}, broker={cfg.broker.kind}"
          f"{', qos' if shedders else ''}"
          f"{', obs' if observatory else ''}"
          f"{', plan' if observatory and observatory.corrector else ''}"
          f"{', autoscaling' if scalers else ''}"
          f"{f', ui http://127.0.0.1:{ui.port}' if ui else ''})",
          file=sys.stderr)

    stop = stop or asyncio.Event()
    loop = asyncio.get_running_loop()
    if threading.current_thread() is threading.main_thread():
        for sig in (signal.SIGINT, signal.SIGTERM):
            loop.add_signal_handler(sig, stop.set)
    if duration > 0:
        loop.call_later(duration, stop.set)
    if started is not None:
        started({"runtime": rt, "cluster": cluster, "ui": ui, "scalers": scalers,
                 "shedders": shedders, "observatory": observatory, "broker": broker})
    await stop.wait()

    print("draining...", file=sys.stderr)
    if threading.current_thread() is threading.main_thread():
        for sig in (signal.SIGINT, signal.SIGTERM):
            loop.remove_signal_handler(sig)
    if ui is not None:
        await ui.stop()
    for scaler in scalers:
        await scaler.stop()
    if observatory is not None:
        await observatory.stop()
    for shedder in shedders:
        await shedder.stop()
    await rt.deactivate()
    await rt.drain(timeout_s=30)
    snap = rt.metrics.snapshot()
    await cluster.kill(name, wait_secs=0)
    print(json.dumps(snap, default=str), file=sys.stderr)


def _ctl(args) -> int:
    """Drive a running daemon's UI HTTP API from the command line."""
    import os
    import urllib.error
    import urllib.parse
    import urllib.request

    base = args.url.rstrip("/")
    topo = urllib.parse.quote(getattr(args, "topology", ""), safe="")
    # Admin auth (control.auth_token on the daemon): --token wins, else
    # the shared control-plane env fallback.
    from storm_tpu_torch.config import env_control_token

    token = getattr(args, "token", None) or env_control_token()

    def call(method, path, body=None, timeout=30, headers=None):
        req = urllib.request.Request(
            base + path, method=method,
            data=json.dumps(body).encode() if body is not None else None)
        if token:
            req.add_header("Authorization", f"Bearer {token}")
        for k, v in (headers or {}).items():
            req.add_header(k, v)
        try:
            with urllib.request.urlopen(req, timeout=timeout) as r:
                return 0, json.loads(r.read())
        except urllib.error.HTTPError as e:
            raw = e.read()
            try:
                return 1, json.loads(raw)
            except ValueError:
                # not our daemon (proxy error page etc.): show what came back
                return 1, {"error": f"HTTP {e.code} from {base}",
                           "body": raw[:500].decode("utf-8", "replace")}
        except urllib.error.URLError as e:
            print(f"cannot reach {base}: {e}", file=sys.stderr)
            raise SystemExit(2)

    cmd = args.ctl_cmd
    if cmd == "list":
        rc, out = call("GET", "/api/v1/topology/summary")
    elif cmd == "status":
        rc, out = call("GET", f"/api/v1/topology/{topo}")
    elif cmd in ("metrics", "graph", "errors"):
        rc, out = call("GET", f"/api/v1/topology/{topo}/{cmd}")
    elif cmd == "component":
        import urllib.parse as _up

        rc, out = call("GET", f"/api/v1/topology/{topo}/component/"
                              f"{_up.quote(args.component, safe='')}")
    elif cmd in ("activate", "deactivate"):
        rc, out = call("POST", f"/api/v1/topology/{topo}/{cmd}")
    elif cmd == "drain":
        # client timeout comfortably beyond the server's drain wait, or a
        # slow drain would look like a connectivity failure
        rc, out = call("POST", f"/api/v1/topology/{topo}/drain",
                       {"timeout_s": 30.0}, timeout=60)
    elif cmd == "kill":
        rc, out = call("POST", f"/api/v1/topology/{topo}/kill",
                       {"wait_secs": args.wait_secs})
    elif cmd == "rebalance":
        rc, out = call("POST", f"/api/v1/topology/{topo}/rebalance",
                       {"component": args.component,
                        "parallelism": args.parallelism})
    elif cmd == "seek":
        from storm_tpu_torch.connectors.spout import parse_seek_position

        try:
            pos = parse_seek_position(args.position)
        except ValueError as e:
            print(str(e), file=sys.stderr)
            return 2
        rc, out = call("POST", f"/api/v1/topology/{topo}/seek",
                       {"component": args.component, "position": pos})
    elif cmd == "profile":
        rc, out = call("POST", f"/api/v1/topology/{topo}/profile",
                       {"log_dir": args.log_dir, "seconds": args.seconds,
                        "worker": args.worker})
    elif cmd == "swap-model":
        overrides = {}
        for kv in args.set:
            if "=" not in kv:
                print(f"--set needs key=value, got {kv!r}", file=sys.stderr)
                return 2
            k, v = kv.split("=", 1)
            try:
                overrides[k] = json.loads(v)  # numbers/bools/lists/null
            except ValueError:
                overrides[k] = v  # bare string (checkpoint paths etc.)
        # Engine warmup happens inside this call; give it compile time.
        body = {"component": args.component, "model": overrides}
        if args.task:
            body["tasks"] = args.task
        rc, out = call("POST", f"/api/v1/topology/{topo}/swap_model",
                       body, timeout=600)
    elif cmd == "logs":
        rc, out = call(
            "GET",
            f"/api/v1/topology/{topo}/logs"
            f"?worker={args.worker}&bytes={args.bytes}")
        if rc == 0:
            print(out.get("log", ""))
            return 0
    elif cmd == "submit":
        from storm_tpu_torch.flux import _load_spec

        rc, out = call("POST", "/api/v1/topology/submit",
                       {"name": args.topology,
                        "definition": _load_spec(args.definition)},
                       headers={"X-Storm-Tpu-Submit": "1"})
    print(json.dumps(out, indent=2, default=str))
    return rc


def _read_route(args, path: str, timeout: float = 30):
    """GET ``path`` from the UI at ``args.url``, with ``--token`` or the
    environment's control token (the read routes are open; the header is
    harmless where unneeded). ``(body, 0)``; ``(None, 1)`` on an HTTP error,
    its body on stderr; ``(None, 2)`` when the UI cannot be reached."""
    import urllib.error
    import urllib.request

    from storm_tpu_torch.config import env_control_token

    base = args.url.rstrip("/")
    req = urllib.request.Request(base + path)
    token = args.token or env_control_token()
    if token:
        req.add_header("Authorization", f"Bearer {token}")
    try:
        with urllib.request.urlopen(req, timeout=timeout) as r:
            return json.loads(r.read()), 0
    except urllib.error.HTTPError as e:
        print(e.read().decode("utf-8", "replace"), file=sys.stderr)
        return None, 1
    except urllib.error.URLError as e:
        print(f"cannot reach {base}: {e}", file=sys.stderr)
        return None, 2


def _traces(args) -> int:
    """Dump slowest-N traces / flight-recorder tail from a running
    topology's UI endpoint (``main traces <topology>``)."""
    import urllib.parse

    topo = urllib.parse.quote(args.topology, safe="")
    action = "flight" if args.flight else "traces"
    out, rc = _read_route(args, f"/api/v1/topology/{topo}/{action}?n={args.n}")
    if rc:
        return rc
    if args.json:
        print(json.dumps(out, indent=2, default=str))
        return 0
    if args.flight:
        for ev in out.get("flight", []):
            extra = {k: v for k, v in ev.items() if k not in ("ts", "kind")}
            print(f"{ev.get('ts')} {ev.get('kind'):<18} "
                  + " ".join(f"{k}={v}" for k, v in extra.items()))
        return 0
    order = "recent" if args.recent else "slowest"
    for rec in out.get(order, []):
        print(f"trace {rec['trace_id']}  "
              f"duration={rec.get('duration_ms')}ms  "
              f"opened_at={rec.get('opened_at')}")
        for s in rec.get("spans", []):
            attrs = s.get("attrs") or {}
            links = s.get("links") or []
            parts = [f"  +{s.get('offset_ms'):>9}ms {s['name']:<15} "
                     f"{s.get('duration_ms'):>9}ms  {s.get('component', '')}"]
            if attrs:
                parts.append(" " + " ".join(f"{k}={v}"
                                            for k, v in attrs.items()))
            if links:
                parts.append(f" links={len(links)}")
            print("".join(parts))
    stats = out.get("stats")
    if stats:
        print(f"store: {json.dumps(stats, default=str)}", file=sys.stderr)
    return 0


def _profile_cmd(args) -> int:
    """Dump the live cost model (per-engine per-bucket stage curves,
    compile costs, SLO burn, occupancy) from a running topology's UI
    endpoint (``main profile <topology>``), the queryable face of
    ``obs/``, mirroring the traces/flight CLI."""
    import urllib.parse

    topo = urllib.parse.quote(args.topology, safe="")
    out, rc = _read_route(args, f"/api/v1/topology/{topo}/profile")
    if rc:
        return rc
    if args.json:
        print(json.dumps(out, indent=2, default=str))
        return 0
    engines = out.get("profile", {}).get("engines", {})
    if not engines:
        print("no profiled batches yet (profiler records on dispatch; "
              "send traffic first)")
    for key, eng in engines.items():
        print(f"engine {key}")
        for bucket, row in eng.get("buckets", {}).items():
            st = row.get("stages", {})
            dev = st.get("device_ms", {})
            parts = [f"  bucket {bucket:>6}: batches={row['batches']:<6}"
                     f" rows={row['rows']:<8}"
                     f" device p50={dev.get('p50')}ms p95={dev.get('p95')}ms"
                     f" ms/row={row.get('ms_per_row')}"
                     f" thr={row.get('throughput_rows_s')} rows/s"]
            print("".join(parts))
        for shape, c in eng.get("compiles", {}).items():
            print(f"  compile bucket {shape}: n={c['count']} "
                  f"last={round(c['last_ms'], 1)}ms")
    slo = out.get("slo")
    if slo:
        print(f"slo: fast_burn={slo.get('fast_burn')} "
              f"slow_burn={slo.get('slow_burn')} "
              f"tripped={slo.get('tripped')} trips={slo.get('trips')}")
    for row in out.get("occupancy", []) or []:
        print(f"occupancy {row['engine']}: "
              f"ring {row['ring_inflight']}/{row['ring_capacity']} "
              f"staging {row['staging_in_use']}/{row['staging_allocated']} "
              f"queue depth={row['queue_depth']} "
              f"oldest={row['queue_oldest_ms']}ms")
    regs = out.get("regressions") or []
    for r in regs:
        print(f"REGRESSION {r['engine']} bucket {r['bucket']} {r['stage']}: "
              f"{r['live_ms']}ms vs baseline {r['baseline_ms']}ms "
              f"(x{r['ratio']})")
    return 0


def _bottleneck_cmd(args) -> int:
    """Render the bottleneck observatory's verdict from a running
    topology's UI endpoint (``main bottleneck <topology>``): ranked
    per-component capacity table, edge lag watermarks, and the
    critical-path latency decomposition. Against a dist UI the table is
    the controller-merged per-worker utilization (no attributor runs
    cross-worker)."""
    import urllib.parse

    topo = urllib.parse.quote(args.topology, safe="")
    out, rc = _read_route(args, f"/api/v1/topology/{topo}/bottleneck")
    if rc:
        return rc
    if args.json:
        print(json.dumps(out, indent=2, default=str))
        return 0
    verdict = out.get("bottleneck") or {}
    leader = verdict.get("leader")
    print(f"bottleneck: {leader if leader else '(none above threshold)'}")
    ranked = verdict.get("ranked") or []
    util = out.get("utilization") or {}
    if ranked:
        print(f"{'component':<24} {'score':>6} {'cap':>6} {'busy':>6} "
              f"{'wait':>6} {'inflow':>8}  reasons")
        for row in ranked:
            print(f"{row['component']:<24} {row['score']:>6} "
                  f"{_fmt(row.get('capacity')):>6} "
                  f"{_fmt(row.get('busy_frac')):>6} "
                  f"{_fmt(row.get('wait_frac')):>6} "
                  f"{_fmt(row.get('inflow_growth_per_s')):>8}  "
                  f"{','.join(row.get('reasons') or []) or '-'}")
    elif util:
        # dist view (or local before the first Observatory tick): plain
        # merged utilization table, no scores
        print(f"{'component':<24} {'cap':>6} {'busy':>6} {'wait':>6} "
              f"{'flush':>6} {'tasks':>5}  workers")
        for comp, row in util.items():
            print(f"{comp:<24} {_fmt(row.get('capacity')):>6} "
                  f"{_fmt(row.get('busy_frac')):>6} "
                  f"{_fmt(row.get('wait_frac')):>6} "
                  f"{_fmt(row.get('flush_frac')):>6} "
                  f"{row.get('tasks', '?'):>5}  "
                  f"{row.get('workers', '-')}")
    else:
        print("no utilization window yet (obs enabled? traffic flowing?)")
    for row in verdict.get("edges") or []:
        print(f"edge {row['edge']:<30} depth={row['depth']:<6} "
              f"growth={_fmt(row['growth_per_s'])}/s")
    for row in verdict.get("ingress") or []:
        print(f"ingress {row['component']}[{row['task']}]: "
              f"behind={row['records_behind']} "
              f"partitions={row['partitions']}")
    cp = verdict.get("critical_path") or {}
    stages = cp.get("stages") or {}
    if stages:
        print(f"critical path (e2e mean={cp.get('e2e_mean_ms')}ms "
              f"p95={cp.get('e2e_p95_ms')}ms, n={cp.get('records')}):")
        for name, st in stages.items():
            sub = st.get("substages_ms")
            extra = f"  {sub}" if sub else ""
            print(f"  {name:<26} {_fmt(st.get('mean_ms')):>9}ms "
                  f"frac={_fmt(st.get('frac_of_e2e'))}{extra}")
    return 0


def _copies_cmd(args) -> int:
    """Render the data-plane copy ledger from a running topology's UI
    endpoint (``main copies <topology>``): per-stage bytes/record and
    copies/record ranked by bytes moved, plus the derived copy
    amplification ratio (bytes moved / payload bytes ingested). Against
    a dist UI the tree is the controller-merged per-worker window."""
    import urllib.parse

    topo = urllib.parse.quote(args.topology, safe="")
    out, rc = _read_route(args, f"/api/v1/topology/{topo}/copies")
    if rc:
        return rc
    if args.json:
        print(json.dumps(out, indent=2, default=str))
        return 0
    # Dist route ships the merged window as "copies"; the local route
    # ships cumulative totals (always populated) + the Observatory's
    # latest window.
    tree = out.get("copies") or out.get("cumulative") or {}
    stages = tree.get("stages") or {}
    if not stages:
        print("no copy-ledger rows yet (record path idle? ledger "
              "disabled via set_enabled(False)?)")
        return 0
    amp = tree.get("copy_amplification")
    totals = tree.get("totals") or {}
    print(f"copy amplification: {amp if amp is not None else '-'} "
          f"(moved {_fmt(totals.get('bytes'))}B / ingested "
          f"{_fmt(totals.get('ingest_bytes'))}B over "
          f"{totals.get('ingest_records', 0)} records)")
    print(f"{'stage':<16} {'B/rec':>10} {'copies/rec':>10} "
          f"{'bytes':>12} {'copies':>8} {'allocs':>8} {'records':>9}  "
          f"engines")
    ranked = sorted(
        stages.items(),
        key=lambda kv: -(kv[1].get("bytes") or 0.0))
    for stage, row in ranked:
        engines = ",".join(sorted(row.get("engines") or {})) or "-"
        print(f"{stage:<16} {_fmt(row.get('bytes_per_record')):>10} "
              f"{_fmt(row.get('copies_per_record')):>10} "
              f"{_fmt(row.get('bytes')):>12} {row.get('copies', 0):>8} "
              f"{row.get('allocs', 0):>8} {row.get('records', 0):>9}  "
              f"{engines}")
    win = out.get("window") or {}
    wamp = win.get("copy_amplification")
    if wamp is not None:
        print(f"window: amplification={wamp} over {win.get('dt_s')}s "
              f"(obs step loop)")
    ceiling = out.get("amp_ceiling")
    if ceiling:
        print(f"ceiling: copy_amplification_high fires past "
              f"{ceiling} (obs.copy_amp_ceiling)")
    workers = out.get("workers") or {}
    if workers:
        for idx in sorted(workers, key=str):
            t = workers[idx].get("totals") or {}
            print(f"worker {idx}: moved {_fmt(t.get('bytes'))}B "
                  f"ingested {_fmt(t.get('ingest_bytes'))}B "
                  f"amp={workers[idx].get('copy_amplification')}")
    return 0


def _scorecard_cmd(args) -> int:
    """Render the fleet scenario-matrix scorecard
    (:mod:`storm_tpu_torch.loadgen`): one row per (scenario, traffic
    pattern) cell with goodput, protected-lane p99, burn, shed fraction,
    the bottleneck verdict, and the declared-target pass/fail. Offline
    mode (``--file``) renders a saved scorecard; online mode queries the
    /scorecard route the fleet matrix attaches mid-run."""
    import urllib.parse

    from storm_tpu_torch.loadgen.scorecard import render_table

    if args.file:
        with open(args.file) as f:
            out = json.load(f)
    else:
        if not args.topology:
            print("scorecard: give a topology name or --file "
                  "SCORECARD_*.json", file=sys.stderr)
            return 2
        topo = urllib.parse.quote(args.topology, safe="")
        out, rc = _read_route(args, f"/api/v1/topology/{topo}/scorecard")
        if rc:
            return rc
    if args.json:
        print(json.dumps(out, indent=2, default=str))
        return 0
    print(render_table(out))
    if out.get("in_progress"):
        print("(matrix still running: cells land as they are scored)")
    return 0


def _render_solve(out: dict) -> int:
    """Human view of one solver result (shared by the online and offline
    ``main plan`` paths)."""
    cov = out.get("coverage") or {}
    if not out.get("feasible"):
        if "feasible" in out:
            print("INFEASIBLE:", out.get("why") or "no reason reported")
            if out.get("binding_stage"):
                print(f"binding stage: {out['binding_stage']}")
            best = out.get("best_infeasible") or {}
            if best.get("capacity_rows_s") is not None:
                print(f"closest candidate: {best.get('candidate')} -> "
                      f"capacity {best['capacity_rows_s']} rows/s, "
                      f"p99 {best.get('p99_ms')} ms")
        else:
            print(out.get("note", "no target given"))
        for eng, row in cov.items():
            cells = ", ".join(
                f"{b}:{c['status']}({c['samples']})"
                for b, c in row.get("buckets", {}).items()) or "(none)"
            print(f"coverage {eng}: {cells}")
        return 1 if "feasible" in out else 0
    plan = out["plan"]
    pred = plan.get("prediction", {})
    print(f"PLAN engine={plan['engine']} bucket={plan['bucket']} "
          f"deadline={plan['deadline_ms']}ms "
          f"parallelism={plan['parallelism']} "
          f"continuous={plan['continuous']} "
          f"pipeline_depth={plan['pipeline_depth']} "
          f"max_inflight={plan['max_inflight']} "
          f"(replica cost {plan['replica_cost']})")
    print(f"predicted: p99={pred.get('p99_ms')}ms "
          f"capacity={pred.get('capacity_rows_s')} rows/s "
          f"util={pred.get('util')} "
          f"cold={pred.get('cold')}")
    for stage, ms in (pred.get("stages") or {}).items():
        print(f"  {stage:<16} {ms:>9}ms")
    if pred.get("queue_ms") is not None:
        print(f"  {'queue_ms':<16} {pred['queue_ms']:>9}ms")
    print("apply with: python -m storm_tpu_torch.main run ... " +
          " ".join(f"--set {a}" for a in plan.get("override_args", [])))
    for risk in out.get("framework_risks") or []:
        print(f"risk: {risk['note']}")
    corr = out.get("corrector")
    if corr is not None:
        print(f"corrector: enabled={corr.get('enabled')} "
              f"corrections={corr.get('corrections')}")
    return 0


def _plan_cmd(args) -> int:
    """``main plan``: solve for the cheapest config meeting a
    (rate, p99 SLO) target. Online against a running topology's UI
    endpoint (live curves + corrector state), or offline from a
    committed ``PROFILE_*.json`` via ``--baseline`` — no daemon needed."""
    if args.baseline:
        from storm_tpu_torch.plan import Target, solve

        with open(args.baseline) as fh:
            snap = json.load(fh)
        if not (args.rate > 0 and args.slo_ms > 0):
            print("offline solve needs --rate and --slo-ms", file=sys.stderr)
            return 2
        res = solve(snap, Target(args.rate, args.slo_ms,
                                 headroom=args.headroom),
                    engine=args.engine)
        out = res.to_dict()
        if args.json:
            print(json.dumps(out, indent=2, default=str))
            return 0 if res.feasible else 1
        return _render_solve(out)

    import urllib.parse

    topo = urllib.parse.quote(args.topology, safe="")
    q = {}
    if args.rate > 0:
        q["rate"] = args.rate
    if args.slo_ms > 0:
        q["slo_ms"] = args.slo_ms
    if args.engine:
        q["engine"] = args.engine
    q["headroom"] = args.headroom
    qs = urllib.parse.urlencode(q)
    out, rc = _read_route(args, f"/api/v1/topology/{topo}/plan?{qs}", timeout=60)
    if rc:
        return rc
    if args.json:
        print(json.dumps(out, indent=2, default=str))
        return 0
    return _render_solve(out)


def _fmt(v):
    return "-" if v is None else v


def main(argv=None) -> int:
    setup_logging()
    ap = argparse.ArgumentParser(prog="storm_tpu_torch")
    sub = ap.add_subparsers(dest="cmd", required=True)

    runp = sub.add_parser("run", help="run a topology daemon")
    runp.add_argument("name")
    runp.add_argument("input_topic")
    runp.add_argument("output_topic")
    runp.add_argument("--config", help="TOML/JSON config file")
    runp.add_argument("--set", action="append", default=[],
                      metavar="section.key=value")
    runp.add_argument("--duration", type=float, default=0.0,
                      help="run window in seconds (0 = until signal)")
    runp.add_argument("--autoscale-target-ms", type=float, default=0.0,
                      help="autoscale inference parallelism to keep e2e p50 "
                           "under this latency (0 = off)")
    runp.add_argument("--ui-port", type=int, default=-1,
                      help="serve the Storm-UI-equivalent HTTP status/admin "
                           "API on this port (0 = ephemeral, -1 = off)")
    runp.add_argument("--metrics-file", default="",
                      help="append a JSON-lines metrics snapshot to this "
                           "file every --metrics-interval seconds")
    runp.add_argument("--metrics-interval", type=float, default=10.0)
    runp.add_argument("--device", default="cuda",
                      help="where the engines run: cuda (the default) or cpu")
    runp.add_argument("--topology-file", default="",
                      help="declarative topology definition (TOML/JSON, the "
                           "Storm Flux equivalent) instead of the standard "
                           "spout->inference->sink shape; the configured "
                           "broker is available as the $broker resource")

    distp = sub.add_parser(
        "dist-run",
        help="run a topology across worker processes (the port's frame transport)")
    distp.add_argument("name")
    distp.add_argument("input_topic")
    distp.add_argument("output_topic")
    distp.add_argument("--config", help="TOML/JSON config file")
    distp.add_argument("--set", action="append", default=[],
                       metavar="section.key=value")
    distp.add_argument("--workers", type=int, default=3,
                       help="local worker processes to spawn")
    distp.add_argument("--attach", action="append", default=[],
                       metavar="host:port",
                       help="attach to pre-started workers instead of "
                            "spawning (multi-host)")
    distp.add_argument("--duration", type=float, default=0.0)
    distp.add_argument("--ui-port", type=int, default=-1,
                       help="serve the Storm-UI HTTP API over the dist "
                            "controller (0 = ephemeral, -1 = off)")
    distp.add_argument("--device", default="cuda",
                       help="where the workers' engines run: cuda or cpu")
    distp.add_argument("--journal-dir", default="",
                       help="controller write-ahead journal directory "
                            "(overrides control.journal_dir): a restarted "
                            "controller replays it and reattaches to live "
                            "workers instead of rebuilding them")

    servep = sub.add_parser("serve", help="run the inference worker (frames over TCP)")
    servep.add_argument("--config", help="TOML/JSON config file")
    servep.add_argument("--set", action="append", default=[])
    servep.add_argument("--model", default=None, help="model registry name")
    servep.add_argument("--port", type=int, default=50051)
    servep.add_argument("--device", default="cuda",
                        help="where the engine runs: cuda (the default) or cpu")
    servep.add_argument("--cross-batch-ms", type=float, default=0.0,
                        help="coalesce concurrent Predict RPCs into one "
                             "device dispatch within this window (0 = off)")

    sub.add_parser("info", help="print devices and registered models")

    ctlp = sub.add_parser(
        "ctl", help="control a running daemon over its UI HTTP API "
                    "(the storm kill/activate/deactivate/rebalance CLI)")
    ctlp.add_argument("--url", default="http://127.0.0.1:8080",
                      help="base URL of the daemon's --ui-port server")
    ctlp.add_argument("--token", default=None,
                      help="bearer token for daemons running with "
                           "control.auth_token (default: "
                           "$STORM_TPU_CONTROL_TOKEN)")
    ctlsub = ctlp.add_subparsers(dest="ctl_cmd", required=True)
    for cmd in ("list", "status", "metrics", "graph", "errors"):
        c = ctlsub.add_parser(cmd)
        if cmd != "list":
            c.add_argument("topology")
    for cmd in ("activate", "deactivate", "drain"):
        c = ctlsub.add_parser(cmd)
        c.add_argument("topology")
    c = ctlsub.add_parser("kill")
    c.add_argument("topology")
    c.add_argument("--wait-secs", type=float, default=0.0)
    c = ctlsub.add_parser("rebalance")
    c.add_argument("topology")
    c.add_argument("component")
    c.add_argument("parallelism", type=int)
    c = ctlsub.add_parser(
        "component",
        help="per-executor stats table for one component (Storm UI's "
             "executor rows)")
    c.add_argument("topology")
    c.add_argument("component")
    c = ctlsub.add_parser(
        "seek",
        help="reposition a spout's consumption: earliest|latest|<offset>|"
             "-<records-behind-latest> (live replay/backfill)")
    c.add_argument("topology")
    c.add_argument("component")
    c.add_argument("position")
    c = ctlsub.add_parser(
        "profile",
        help="capture a torch.profiler trace (card and host timelines, "
             "trace.json) on the daemon for N seconds")
    c.add_argument("topology")
    c.add_argument("log_dir")
    c.add_argument("--seconds", type=float, default=5.0)
    c.add_argument("--worker", type=int, default=0,
                   help="dist mode: worker index to capture on")
    c = ctlsub.add_parser(
        "swap-model",
        help="live model swap: apply ModelConfig field overrides to a "
             "running inference component (zero-downtime rollout/rollback)")
    c.add_argument("topology")
    c.add_argument("component")
    c.add_argument("--set", action="append", default=[], metavar="KEY=VALUE",
                   help="ModelConfig field override, repeatable "
                        "(e.g. --set checkpoint=/models/v2)")
    c.add_argument("--task", action="append", type=int, default=[],
                   metavar="N",
                   help="canary: swap only these task indexes (repeatable); "
                        "compare with `ctl component`, then swap the rest "
                        "or roll back")
    c = ctlsub.add_parser("logs")
    c.add_argument("topology")
    c.add_argument("--worker", type=int, default=0)
    c.add_argument("--bytes", type=int, default=16384)
    c = ctlsub.add_parser(
        "submit", help="submit a Flux topology definition to the daemon")
    c.add_argument("topology")
    c.add_argument("definition", help="TOML/JSON topology file")

    tracesp = sub.add_parser(
        "traces",
        help="dump the slowest traces (or the flight-recorder tail) from a "
             "running topology's UI endpoint; needs tracing.sample_rate > 0 "
             "on the daemon for span data")
    tracesp.add_argument("topology")
    tracesp.add_argument("--url", default="http://127.0.0.1:8080",
                         help="base URL of the daemon's --ui-port server")
    tracesp.add_argument("--token", default=None,
                         help="bearer token (default: "
                              "$STORM_TPU_CONTROL_TOKEN)")
    tracesp.add_argument("-n", type=int, default=10,
                         help="how many traces/events to show")
    tracesp.add_argument("--recent", action="store_true",
                         help="most recent traces instead of slowest")
    tracesp.add_argument("--flight", action="store_true",
                         help="flight-recorder events only")
    tracesp.add_argument("--json", action="store_true",
                         help="raw JSON instead of the rendered view")

    profp = sub.add_parser(
        "profile",
        help="dump the live cost model (per-engine/bucket stage curves, "
             "compile costs, SLO burn, occupancy) from a running "
             "topology's UI endpoint; enable [obs] on the daemon for "
             "burn/occupancy state")
    profp.add_argument("topology")
    profp.add_argument("--url", default="http://127.0.0.1:8080",
                       help="base URL of the daemon's --ui-port server")
    profp.add_argument("--token", default=None,
                       help="bearer token (default: "
                            "$STORM_TPU_CONTROL_TOKEN)")
    profp.add_argument("--json", action="store_true",
                       help="raw JSON instead of the rendered view")

    bottp = sub.add_parser(
        "bottleneck",
        help="show where a running topology is limited: ranked "
             "per-component capacity, edge lag watermarks, and the "
             "critical-path latency decomposition (needs [obs] enabled "
             "on the daemon; dist UIs answer with merged per-worker "
             "utilization)")
    bottp.add_argument("topology")
    bottp.add_argument("--url", default="http://127.0.0.1:8080",
                       help="base URL of the daemon's --ui-port server")
    bottp.add_argument("--token", default=None,
                       help="bearer token (default: "
                            "$STORM_TPU_CONTROL_TOKEN)")
    bottp.add_argument("--json", action="store_true",
                       help="raw JSON instead of the rendered view")

    copiesp = sub.add_parser(
        "copies",
        help="show the data-plane copy ledger for a running topology: "
             "per-stage bytes/record + copies/record ranked by bytes "
             "moved, and the copy amplification ratio (dist UIs answer "
             "with the controller-merged per-worker window)")
    copiesp.add_argument("topology")
    copiesp.add_argument("--url", default="http://127.0.0.1:8080",
                         help="base URL of the daemon's --ui-port server")
    copiesp.add_argument("--token", default=None,
                         help="bearer token (default: "
                              "$STORM_TPU_CONTROL_TOKEN)")
    copiesp.add_argument("--json", action="store_true",
                         help="raw JSON instead of the rendered view")

    planp = sub.add_parser(
        "plan",
        help="solve for the cheapest config meeting a (rate, p99 SLO) "
             "target over the profile curves: online against a running "
             "topology's /plan route, or offline from a committed "
             "PROFILE_*.json via --baseline (no daemon needed); prints "
             "the plan as ready-to-paste --set overrides")
    planp.add_argument("topology", nargs="?", default="inference-topology")
    planp.add_argument("--rate", type=float, default=0.0,
                       help="target offered rate, rows/s")
    planp.add_argument("--slo-ms", type=float, default=0.0, dest="slo_ms",
                       help="target end-to-end p99 SLO, ms")
    planp.add_argument("--engine", default=None,
                       help="engine/model key to plan for (default: the "
                            "cheapest profiled engine)")
    planp.add_argument("--headroom", type=float, default=0.8,
                       help="max predicted device utilization a feasible "
                            "plan may run at")
    planp.add_argument("--baseline", default=None,
                       help="solve offline over this PROFILE_*.json "
                            "instead of a running topology")
    planp.add_argument("--url", default="http://127.0.0.1:8080",
                       help="base URL of the daemon's --ui-port server")
    planp.add_argument("--token", default=None,
                       help="bearer token (default: "
                            "$STORM_TPU_CONTROL_TOKEN)")
    planp.add_argument("--json", action="store_true",
                       help="raw JSON instead of the rendered view")

    scorep = sub.add_parser(
        "scorecard",
        help="render the fleet scenario-matrix scorecard as a table: "
             "live from a running topology's /scorecard route (attached "
             "mid-run by python -m storm_tpu_torch.loadgen.fleet), or "
             "offline from a saved scorecard via --file")
    scorep.add_argument("topology", nargs="?", default=None,
                        help="topology to query (omit with --file)")
    scorep.add_argument("--file", default=None,
                        help="render this scorecard JSON file instead of "
                             "querying a running topology")
    scorep.add_argument("--url", default="http://127.0.0.1:8080",
                        help="base URL of the daemon's --ui-port server")
    scorep.add_argument("--token", default=None,
                        help="bearer token (default: "
                             "$STORM_TPU_CONTROL_TOKEN)")
    scorep.add_argument("--json", action="store_true",
                        help="raw JSON instead of the rendered table")

    args = ap.parse_args(argv)

    if args.cmd == "run":
        cfg = _load_config(args)
        cfg.broker.input_topic = args.input_topic
        cfg.broker.output_topic = args.output_topic
        if cfg.pipelines:
            print(
                "note: multi-model config — per-pipeline topics are used; the "
                f"positional topics {args.input_topic!r}/{args.output_topic!r} "
                "are ignored",
                file=sys.stderr,
            )
        asyncio.run(_run_daemon(args.name, cfg, args.duration,
                                args.autoscale_target_ms, args.ui_port,
                                args.metrics_file, args.metrics_interval,
                                args.topology_file, device=args.device))
        return 0

    if args.cmd == "ctl":
        return _ctl(args)

    if args.cmd == "traces":
        return _traces(args)

    if args.cmd == "profile":
        return _profile_cmd(args)

    if args.cmd == "bottleneck":
        return _bottleneck_cmd(args)

    if args.cmd == "copies":
        return _copies_cmd(args)

    if args.cmd == "plan":
        return _plan_cmd(args)

    if args.cmd == "scorecard":
        return _scorecard_cmd(args)

    if args.cmd == "dist-run":
        cfg = _load_config(args)
        cfg.broker.input_topic = args.input_topic
        cfg.broker.output_topic = args.output_topic
        if cfg.broker.kind != "kafka":
            print("dist-run needs broker.kind=kafka (workers are separate "
                  "processes; a memory broker cannot be shared)", file=sys.stderr)
            return 2
        # Dist-run default scheme is "raw" (+ record frames) since r19:
        # the binary wire (already the default) carries bytes natively,
        # so the bytes->str->bytes round trip and per-record routing only
        # survive when the user pins scheme="string" — or pins
        # wire_format="json", which cannot carry bytes and therefore
        # keeps the string scheme (the submit-time check would reject
        # raw+json loudly). See TopologyConfig.spout_scheme deprecation
        # note.
        if (not getattr(cfg.topology, "_scheme_pinned", False)
                and cfg.topology.wire_format != "json"):
            cfg.topology.spout_scheme = "raw"
            cfg.topology.spout_frames = True
        from storm_tpu_torch.dist import DistCluster

        builder = "multi" if cfg.pipelines else "standard"
        # One resolution for BOTH the frame plane and the dist UI (config
        # wins, else the shared env fallback inside resolve_token): the
        # UI must never stay open while the workers think the cluster is
        # locked.
        control_token = cfg.control.resolve_token()
        if args.journal_dir:
            cfg.control.journal_dir = args.journal_dir
        # The drill thread below may REPLACE the controller mid-run
        # (abandon + journal reattach), so everything after this point
        # reads the live handle through `holder` instead of a binding
        # frozen at construction time.
        cluster = DistCluster(
            n_workers=args.workers, addrs=args.attach or None,
            auth_token=control_token, device=args.device,
            journal_dir=cfg.control.journal_dir or None,
            reattach=cfg.control.reattach,
            journal_snapshot_every=cfg.control.journal_snapshot_every,
        )
        holder = {"cluster": cluster}
        try:
            if cluster.reattached:
                running = (cluster._recipe or {}).get("name", args.name)
                print(f"controller reattached to {len(cluster.clients)} "
                      f"workers from journal {cfg.control.journal_dir!r}; "
                      f"topology {running!r} kept running", file=sys.stderr)
            else:
                placement = cluster.submit(args.name, cfg, builder=builder)
                print(f"topology {args.name!r} across {len(cluster.clients)} "
                      f"workers: {placement}", file=sys.stderr)
            ui = ui_loop = None
            if args.ui_port >= 0:
                # The dist controller is synchronous; the UI server runs on
                # its own loop in a daemon thread, calling the controller
                # off-loop through the DistRuntimeView adapter.
                import threading

                from storm_tpu_torch.dist.ui import start_dist_ui

                ui_loop = asyncio.new_event_loop()
                threading.Thread(target=ui_loop.run_forever, daemon=True).start()
                ui = asyncio.run_coroutine_threadsafe(
                    start_dist_ui(cluster, args.name, args.ui_port,
                                  auth_token=control_token),
                    ui_loop,
                ).result(timeout=10)
                print(f"ui http://127.0.0.1:{ui.port}", file=sys.stderr)
            chaos_thread = None
            if cfg.chaos.enabled and cfg.chaos.kill_worker_s > 0:
                # Chaos drill ([chaos] kill_worker_s): SIGKILL a random
                # non-controller worker every interval; the heartbeat
                # monitor detects and recovers it. Wire/corruption knobs
                # already rode the submit recipe into every worker.
                import random as _random
                import threading

                cluster.start_monitor()
                stop_chaos = threading.Event()
                rng = _random.Random(cfg.chaos.seed)

                def kill_loop() -> None:
                    while not stop_chaos.wait(cfg.chaos.kill_worker_s):
                        c = holder["cluster"]
                        live = [i for i, p in enumerate(c.procs)
                                if p is not None and p.poll() is None]
                        if len(live) < 2:
                            continue  # never kill the last worker standing
                        victim = rng.choice(live[1:])  # spare the spout host
                        print(f"chaos: SIGKILL worker {victim}",
                              file=sys.stderr)
                        c.flight.event("chaos_injection",
                                       target="worker_kill",
                                       worker=victim)
                        c.procs[victim].kill()

                chaos_thread = threading.Thread(
                    target=kill_loop, name="chaos-kill", daemon=True)
                chaos_thread.start()
            ctl_thread = None
            stop_ctl = None
            if (cfg.chaos.enabled and cfg.chaos.kill_controller_s > 0
                    and cfg.control.journal_dir):
                # Controller-crash drill ([chaos] kill_controller_s):
                # abandon the controller mid-run — drop every client and
                # process handle, workers untouched — then build a fresh
                # one from the journal and prove it reattaches without a
                # recompile storm. One-shot, gated through the injector's
                # controller_crash_next budget so it logs like any other
                # injection.
                import threading

                from storm_tpu_torch.resilience.chaos import get_injector

                inj = get_injector()
                inj.bind_flight(cluster.flight)
                inj.configure(controller_crash_next=1)
                stop_ctl = threading.Event()

                def ctl_crash_loop() -> None:
                    if stop_ctl.wait(cfg.chaos.kill_controller_s):
                        return
                    if not inj.take_controller_crash():
                        return
                    old = holder["cluster"]
                    monitored = old._monitor is not None
                    print("chaos: abandoning controller (workers keep "
                          "serving)", file=sys.stderr)
                    old.abandon()
                    t0 = time.monotonic()
                    fresh = DistCluster(
                        n_workers=args.workers,
                        auth_token=control_token, device=args.device,
                        journal_dir=cfg.control.journal_dir,
                        reattach=True,
                        journal_snapshot_every=(
                            cfg.control.journal_snapshot_every),
                    )
                    holder["cluster"] = fresh
                    if monitored:
                        fresh.start_monitor()
                    print(f"chaos: controller restarted in "
                          f"{time.monotonic() - t0:.2f}s "
                          f"(reattached={fresh.reattached})",
                          file=sys.stderr)

                ctl_thread = threading.Thread(
                    target=ctl_crash_loop, name="chaos-ctl-crash",
                    daemon=True)
                ctl_thread.start()
            try:
                if args.duration > 0:
                    time.sleep(args.duration)
                else:
                    signal.sigwait({signal.SIGINT, signal.SIGTERM})
            except KeyboardInterrupt:
                pass
            if ctl_thread is not None:
                stop_ctl.set()
                ctl_thread.join(timeout=60)
            if chaos_thread is not None:
                stop_chaos.set()
                chaos_thread.join(timeout=5)
                holder["cluster"].stop_monitor()
            if ui is not None:
                asyncio.run_coroutine_threadsafe(ui.stop(), ui_loop).result(timeout=10)
                ui_loop.call_soon_threadsafe(ui_loop.stop)
            print("draining...", file=sys.stderr)
            holder["cluster"].drain(timeout_s=30)
            print(json.dumps(holder["cluster"].metrics(), default=str),
                  file=sys.stderr)
            holder["cluster"].kill()
        finally:
            holder["cluster"].shutdown()
        return 0

    if args.cmd == "serve":
        cfg = _load_config(args)
        if args.model:
            cfg.model.name = args.model
        from storm_tpu_torch.serve import InferenceWorker

        worker = InferenceWorker(cfg.model, cfg.sharding, cfg.batch, port=args.port,
                                 cross_batch_ms=args.cross_batch_ms, device=args.device)
        worker.start()
        # SIGTERM stops the worker as SIGINT does: close the socket, exit 0.
        signal.signal(signal.SIGTERM, lambda *_: worker.stop())
        print(f"serving {cfg.model.name} on port {worker.port}", file=sys.stderr, flush=True)
        try:
            worker.wait()
        except KeyboardInterrupt:
            worker.stop()
        return 0

    if args.cmd == "info":
        import torch

        from storm_tpu_torch.models import registry_names

        devices, mem = ["cpu"], None
        if torch.cuda.is_available():
            devices = [f"cuda:{i} {torch.cuda.get_device_name(i)}"
                       for i in range(torch.cuda.device_count())]
            free, total = torch.cuda.mem_get_info(0)
            mem = {"bytes_free": free, "bytes_limit": total,
                   "bytes_in_use": torch.cuda.memory_allocated(0)}
        print(json.dumps({
            "devices": devices,
            "memory_stats": mem,
            "models": registry_names(),
            "version": __import__("storm_tpu_torch").__version__,
        }, indent=2))
        return 0

    return 1


if __name__ == "__main__":
    sys.exit(main())
