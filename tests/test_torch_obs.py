"""The port's observatory (``storm_tpu_torch/obs/``) against storm_tpu's on
the CPU: ``SloBurnTracker``, ``CapacityTracker``, ``EdgeLagTracker``,
``BottleneckAttributor`` and ``Observatory.step`` fed the same counter and
histogram sequences, executors carrying the same busy, wait and flush
seconds, the same copy-ledger rows and profile curves, and one injected
clock, give the same burn, capacity rows, edge rows, verdicts, critical
paths, flight events (``slo_burn``, ``bottleneck_shift``,
``copy_amplification_high`` with its latch, ``profile_regression``) and
``snapshot()``, timestamps removed. ``ObsConfig`` refuses what storm_tpu's
refuses, with its messages. Then a 1/1/1 lenet5 topology per package on
the CPU, the observatory stepped by hand: the same components, edges and
verdict fields.
"""

from __future__ import annotations

import asyncio
import copy
import dataclasses
import json
import time
from types import SimpleNamespace

import numpy as np
import pytest

import storm_tpu.config as jax_config
import storm_tpu.connectors as jax_connectors
import storm_tpu.infer as jax_infer
import storm_tpu.infer.continuous as jax_continuous
import storm_tpu.infer.engine as jax_engine
import storm_tpu.obs as jax_obs
import storm_tpu.obs.copyledger as jax_ledger
import storm_tpu.runtime as jax_runtime
import storm_tpu.runtime.cluster as jax_cluster
import storm_tpu.runtime.metrics as jax_metrics
import storm_tpu.runtime.tracing as jax_tracing
import storm_tpu_torch.config as port_config
import storm_tpu_torch.connectors as port_connectors
import storm_tpu_torch.infer as port_infer
import storm_tpu_torch.infer.continuous as port_continuous
import storm_tpu_torch.infer.engine as port_engine
import storm_tpu_torch.obs as port_obs
import storm_tpu_torch.obs.copyledger as port_ledger
import storm_tpu_torch.runtime as port_runtime
import storm_tpu_torch.runtime.cluster as port_cluster
import storm_tpu_torch.runtime.metrics as port_metrics
import storm_tpu_torch.runtime.tracing as port_tracing
from tests.test_torch_copyledger import clear_engine_caches

IMPLS = {
    "storm_tpu": SimpleNamespace(
        name="storm_tpu", config=jax_config, obs=jax_obs, ledger=jax_ledger,
        metrics=jax_metrics, tracing=jax_tracing, engine=jax_engine,
        continuous=jax_continuous, cluster=jax_cluster, runtime=jax_runtime,
        connectors=jax_connectors, infer=jax_infer),
    "port": SimpleNamespace(
        name="port", config=port_config, obs=port_obs, ledger=port_ledger,
        metrics=port_metrics, tracing=port_tracing, engine=port_engine,
        continuous=port_continuous, cluster=port_cluster, runtime=port_runtime,
        connectors=port_connectors, infer=port_infer),
}


def _both(fn):
    """``fn(impl)`` for both packages; the results must be equal."""
    got = {name: fn(impl) for name, impl in IMPLS.items()}
    assert got["port"] == got["storm_tpu"], (got["port"], got["storm_tpu"])
    return got["port"]


class Clock:
    def __init__(self, t: float = 100.0) -> None:
        self.t = t

    def __call__(self) -> float:
        return self.t


def _events(flight, kinds=None) -> list:
    return [{k: v for k, v in ev.items() if k != "ts"} for ev in flight.tail(1000)
            if kinds is None or ev["kind"] in kinds]


@pytest.fixture
def wall(monkeypatch):
    """One wall clock for both flight recorders' throttles."""
    clock = Clock(1_760_000_000.0)
    monkeypatch.setattr(time, "time", clock)
    return clock


# ---- ObsConfig -------------------------------------------------------------------------

BAD_OBS = [dict(interval_s=0), dict(sentinel_interval_s=-1), dict(capacity_hot=0.0),
           dict(capacity_hot=1.5), dict(lag_growth_eps=-1), dict(lag_depth_hot=-2),
           dict(bottleneck_min_score=-0.1), dict(slo_objective=1.0),
           dict(slo_objective=0.0), dict(burn_fast_window_s=0),
           dict(burn_fast_window_s=10, burn_slow_window_s=5),
           dict(regression_factor=1.0), dict(copy_amp_ceiling=-1)]


@pytest.mark.parametrize("kw", BAD_OBS, ids=[",".join(k) for k in BAD_OBS])
def test_obs_config_refuses_alike(kw):
    def refusal(impl):
        with pytest.raises(ValueError) as e:
            impl.config.ObsConfig(**kw)
        return str(e.value)

    _both(refusal)


def test_obs_config_defaults_alike():
    _both(lambda impl: dataclasses.asdict(impl.config.ObsConfig()))
    assert dataclasses.asdict(port_config.Config().obs) == \
        dataclasses.asdict(jax_config.Config().obs)


# ---- SloBurnTracker --------------------------------------------------------------------


def test_slo_burn_alike():
    def drive(impl):
        reg, flight, clock = impl.metrics.MetricsRegistry(), impl.tracing.FlightRecorder(), Clock()
        tr = impl.obs.SloBurnTracker(reg, components=("sink-a", "sink-b"), objective=0.9,
                                     fast_window_s=2.0, slow_window_s=6.0, threshold=1.0,
                                     flight=flight, clock=clock)
        rng = np.random.RandomState(1)
        out = []
        for i in range(40):
            clock.t += 0.5
            for sink in ("sink-a", "sink-b"):
                d = int(rng.randint(0, 6))
                reg.counter(sink, "delivered").inc(d)
                # a storm of breaches in the middle, calm at both ends
                b = int(rng.binomial(d, 0.6 if 10 <= i < 25 else 0.02))
                if i in (30, 31):
                    b, d = 3, 0  # breaches with no delivery
                reg.counter(sink, "slo_breaches").inc(b)
            out.append(tr.step())
            out.append({n: reg.gauge("slo", n).value
                        for n in ("burn_rate", "burn_rate_slow", "tripped")})
        return out, tr.snapshot(), _events(flight)

    out, snap, events = _both(drive)
    assert snap["trips"] >= 1 and any(ev["kind"] == "slo_burn" for ev in events)


def test_slo_burn_refuses_alike():
    def refusal(impl):
        msgs = []
        for kw in (dict(objective=1.0), dict(fast_window_s=5, slow_window_s=1)):
            with pytest.raises(ValueError) as e:
                impl.obs.SloBurnTracker(impl.metrics.MetricsRegistry(), **kw)
            msgs.append(str(e.value))
        return msgs

    _both(refusal)


# ---- a fake runtime both packages read alike ----------------------------------------------


class _Queue:
    def __init__(self) -> None:
        self.n = 0

    def qsize(self) -> int:
        return self.n


class _Exec:
    def __init__(self, task_index: int, **kw) -> None:
        self.task_index = task_index
        self.busy_s = self.wait_s = self.flush_s = 0.0
        for k, v in kw.items():
            setattr(self, k, v)


class _Bolt:
    def __init__(self) -> None:
        self.stats = {"pending_rows": 0, "depth": 0, "oldest_ms": 0.0, "continuous": False}

    def batcher_stats(self) -> dict:
        return dict(self.stats)


class _Spout:
    def __init__(self) -> None:
        self.behind = 0

    def ingress_lag(self) -> dict:
        return {"records_behind": self.behind, "partitions": 2}


class _Router:
    def __init__(self, groups) -> None:
        self.groups = groups

    def edges(self):
        yield from self.groups


def _fake_runtime(impl):
    """spout (1 task) -> infer (2 tasks) -> sink (1 task), and a second
    subscription of infer on the dead-letter stream."""
    infer_q, sink_q = [_Queue(), _Queue()], [_Queue()]
    rt = SimpleNamespace(
        metrics=impl.metrics.MetricsRegistry(), flight=impl.tracing.FlightRecorder(),
        spout_execs={"spout": [_Exec(0, spout=_Spout())]},
        bolt_execs={"infer": [_Exec(0, bolt=_Bolt()), _Exec(1, bolt=_Bolt())],
                    "sink": [_Exec(0)]},
        router=_Router([
            ("spout", "default", SimpleNamespace(component_id="infer", inboxes=infer_q)),
            ("infer", "default", SimpleNamespace(component_id="sink", inboxes=sink_q)),
            ("infer", "dead_letter", SimpleNamespace(component_id="sink",
                                                     inboxes=sink_q))]))
    rt.queues = {"infer": infer_q, "sink": sink_q}
    return rt


def _advance(rt, rng, phase: str, dt: float) -> None:
    """One interval of made-up work. ``phase`` says who limits: the
    infer bolt (busy, its inbox growing) or the sink."""
    hot = {"infer": phase == "infer", "sink": phase == "sink", "spout": phase == "spout"}
    for comp, execs in {**rt.spout_execs, **rt.bolt_execs}.items():
        for e in execs:
            busy = dt * (0.95 if hot[comp] else float(rng.uniform(0.05, 0.3)))
            e.busy_s += busy
            e.wait_s += dt - busy
            e.flush_s += 0.0
    for comp, qs in rt.queues.items():
        for q in qs:
            q.n = max(0, q.n + (int(rng.randint(20, 60)) if hot[comp] else -5))
    rt.spout_execs["spout"][0].spout.behind += 40 if phase == "spout" else 0
    for e in rt.bolt_execs["infer"]:
        e.bolt.stats = {"pending_rows": int(rng.randint(0, 9)), "depth": int(rng.randint(0, 3)),
                        "oldest_ms": round(float(rng.uniform(0, 20)), 3), "continuous": False}
    m = rt.metrics
    for _ in range(int(rng.randint(3, 8))):
        m.histogram("sink", "e2e_latency_ms").observe(float(rng.uniform(20, 80)))
        m.histogram("infer", "ingest_lag_ms").observe(float(rng.uniform(1, 5)))
        m.histogram("infer", "batch_wait_ms").observe(float(rng.uniform(1, 10)))
        m.histogram("infer", "dispatch_wait_ms").observe(float(rng.uniform(0, 4)))
        m.histogram("infer", "device_ms").observe(float(rng.uniform(5, 30)))
        for sub in ("h2d_ms", "compute_ms", "d2h_ms"):
            m.histogram("infer", sub).observe(float(rng.uniform(0.1, 3)))


def _ledger_rows(impl, rng, scale: float = 1.0) -> None:
    led = impl.ledger.copy_ledger()
    n = int(rng.randint(4, 9))
    led.record("spout_ingest", 1000 * n, copies=0, records=n, engine="spout")
    led.record("json_decode", int(800 * n * scale), copies=1, allocs=1, records=n,
               engine="infer")
    led.record("staging", int(900 * n * scale), copies=1, records=n, engine="lenet5")
    led.record("h2d", int(900 * n * scale), copies=1, records=n, engine="lenet5")
    led.record("json_encode", 120 * n, copies=1, allocs=1, records=n, engine="infer")


def _fresh_ledger(impl) -> None:
    led = impl.ledger.copy_ledger()
    led.reset()
    for key in led.window_keys():
        led.drop_window(key)


PHASES = ["infer"] * 5 + ["sink"] * 5 + ["spout"] * 4 + ["idle"] * 3 + ["infer"] * 3


def test_capacity_and_edge_lag_alike():
    def drive(impl):
        rt, clock, rng = _fake_runtime(impl), Clock(), np.random.RandomState(2)
        cap = impl.obs.CapacityTracker(rt, clock=clock)
        lag = impl.obs.EdgeLagTracker(rt, clock=clock)
        out = [cap.sample("a"), lag.sample()]
        for i, phase in enumerate(PHASES):
            clock.t += 0.25
            _advance(rt, rng, phase, 0.25)
            out.append(cap.sample("a"))
            if i % 3 == 0:
                out.append(cap.sample("b", publish=False))
            out.append(lag.sample())
        del rt.bolt_execs["infer"][1]  # a task went away
        clock.t += 0.25
        out.append(cap.sample("a"))
        out.append(cap.cursor_keys())
        out.append(cap.drop("b"))
        out.append(cap.cursor_keys())
        # utilization_snapshot keeps its own tracker on the wall clock:
        # compare all but the window's length
        for _ in range(2):
            util = impl.obs.utilization_snapshot(rt)
            for row in util["components"].values():
                row.pop("dt_s")
                row.pop("capacity")
            out.append(util)
        out.append(rt.metrics.snapshot())
        return out

    out = _both(drive)
    assert out[-3]["components"] == {} and out[-2]["transport"] == {}
    assert sorted(out[-2]["components"]) == ["infer", "sink", "spout"]
    assert out[-1]["infer"]["capacity"] is not None


def test_bottleneck_attribution_alike(wall):
    def drive(impl):
        _fresh_ledger(impl)
        rt, clock, rng = _fake_runtime(impl), Clock(), np.random.RandomState(4)
        cfg = impl.config.ObsConfig()
        cap = impl.obs.CapacityTracker(rt, clock=clock)
        lag = impl.obs.EdgeLagTracker(rt, clock=clock)
        attr = impl.obs.BottleneckAttributor(rt, cfg, cap, lag, clock=clock)
        verdicts = [attr.step()]
        for phase in PHASES:
            clock.t += 0.25
            wall.t += 6.0  # past the bottleneck_shift throttle
            _advance(rt, rng, phase, 0.25)
            _ledger_rows(impl, rng)
            verdicts.append(attr.step())
        return (verdicts, attr.critical_path(), attr.leader,
                _events(rt.flight, {"bottleneck_shift"}), rt.metrics.snapshot())

    verdicts, _, leader, shifts, _ = _both(drive)
    leaders = [v["leader"] for v in verdicts]
    assert {"infer", "sink", "spout"} <= set(leaders) and None in leaders
    assert [ev["component"] for ev in shifts] == ["infer", "sink", "spout", "sink", "infer"]
    cp = verdicts[3]["critical_path"]
    assert cp["stages"]["device"]["substages_ms"] and cp["copy_amplification"] is not None
    assert cp["stages"]["queue_wait_batch"]["bytes_per_record"] > 0


# ---- the Observatory ---------------------------------------------------------------------


class _Engine:
    profile_key = "lenet5"
    ring_inflight = 1
    ring_capacity = 2

    def __init__(self) -> None:
        self.model_cfg = SimpleNamespace(name="lenet5")

    def staging_stats(self) -> dict:
        return {"in_use": 1, "allocated": 2, "limit": 4}


QUEUES = [{"engine": "lenet5", "pending_rows": 3, "oldest_ms": 7.5}]


def _observatory(impl, monkeypatch, rt, clock, **cfg_kw):
    engine = _Engine()
    monkeypatch.setattr(impl.engine, "live_engines", lambda: [engine])
    monkeypatch.setattr(impl.continuous, "registry_stats", lambda: list(QUEUES))
    cfg = impl.config.ObsConfig(enabled=True, **cfg_kw)
    obs = impl.obs.Observatory(rt, cfg, sink_components=("sink",), clock=clock)
    obs.profile = impl.obs.ProfileStore()
    return obs


def _profile_rows(store, rng, scale: float, n: int = 6) -> None:
    for _ in range(n):
        for padded in (8, 32):
            store.record_batch("lenet5", padded, int(rng.randint(1, padded + 1)),
                               {"h2d_ms": scale * float(rng.uniform(0.5, 1.0)),
                                "compute_ms": scale * float(rng.uniform(1.0, 2.0)),
                                "d2h_ms": scale * float(rng.uniform(0.05, 0.1))})


def _strip(doc):
    """A snapshot without its wall-clock fields."""
    doc = copy.deepcopy(doc)
    doc["occupancy"] = [{k: v for k, v in r.items()} for r in doc["occupancy"]]
    for tree in (doc["copies"]["cumulative"], doc["copies"]["window"]):
        tree.pop("dt_s", None)
    return doc


def test_observatory_step_alike(monkeypatch, wall):
    def drive(impl):
        _fresh_ledger(impl)
        rt, clock, rng = _fake_runtime(impl), Clock(), np.random.RandomState(6)
        obs = _observatory(impl, monkeypatch, rt, clock, interval_s=0.25,
                           burn_fast_window_s=1.0, burn_slow_window_s=3.0,
                           sentinel_interval_s=2.0, min_samples=5, copy_amp_ceiling=2.5,
                           regression_factor=1.5)
        _profile_rows(obs.profile, rng, 1.0)
        obs.profile.load_baseline(obs.profile.snapshot())
        out = [rt.obs is obs, obs.snapshot()]
        # the copy amplification: low, high (trips once), high (latched),
        # low (re-arms), high (trips again)
        scales = [1.0, 1.0, 4.0, 4.0, 1.0, 0.5, 4.0, 1.0]
        for i, phase in enumerate(PHASES):
            clock.t += 0.25
            wall.t += 6.0
            _advance(rt, rng, phase, 0.25)
            _ledger_rows(impl, rng, scales[i % len(scales)])
            rt.metrics.counter("sink", "delivered").inc(10)
            rt.metrics.counter("sink", "slo_breaches").inc(4 if 4 <= i < 12 else 0)
            # the live curves drift to 3x the baseline half way
            _profile_rows(obs.profile, rng, 3.0 if i >= 10 else 1.0, n=2)
            obs.step()
            out.append(_strip(obs.snapshot()))
            out.append(obs.bottleneck_snapshot())
        out.append(obs.sentinel_check())
        out.append(_events(rt.flight))
        out.append(rt.metrics.snapshot())
        out.append(obs.decode_snapshot())
        return out

    out = _both(drive)
    events = out[-3]
    kinds = [ev["kind"] for ev in events]
    # the latch: one event per rise above the ceiling, re-armed below 80 %
    amps = [o["copies"]["window"].get("copy_amplification") for o in out[2:-4:2]]
    high, rises = False, 0
    for amp in amps:
        if amp is not None and amp > 2.5 and not high:
            high, rises = True, rises + 1
        elif amp is not None and amp < 0.8 * 2.5:
            high = False
    assert rises >= 2 and kinds.count("copy_amplification_high") == rises
    assert len([a for a in amps if a is not None and a > 2.5]) > rises
    assert "slo_burn" in kinds and "bottleneck_shift" in kinds
    regs = [ev for ev in events if ev["kind"] == "profile_regression"]
    final = out[-4]  # the last sentinel_check's regressions
    assert regs and final and all(r["ratio"] > 1.5 for r in final)
    assert {r["stage"] for r in final} == {"h2d_ms", "compute_ms", "d2h_ms", "device_ms"}
    # every regression counted; the events throttled per kind (5 s)
    assert out[-2]["obs"]["profile_regressions"] >= len(regs) + len(final)
    snap = out[-6]
    assert snap["occupancy"] == [{"engine": "lenet5", "ring_inflight": 1, "ring_capacity": 2,
                                  "staging_in_use": 1, "staging_allocated": 2,
                                  "staging_limit": 4, "queue_depth": 3,
                                  "queue_oldest_ms": 7.5}]
    assert snap["corrector"] is None and snap["baseline_loaded"]


def test_observatory_loads_a_baseline_file(monkeypatch, tmp_path):
    good = tmp_path / "profile.json"
    rng = np.random.RandomState(7)
    store = port_obs.ProfileStore()
    _profile_rows(store, rng, 1.0)
    good.write_text(json.dumps(store.snapshot()))

    def load(impl, path):
        rt = _fake_runtime(impl)
        engine = _Engine()
        monkeypatch.setattr(impl.engine, "live_engines", lambda: [engine])
        obs = impl.obs.Observatory(rt, impl.config.ObsConfig(baseline_path=str(path)))
        loaded = obs.profile.baseline is not None
        obs.profile._baseline = None  # the process store: leave it as found
        return loaded

    assert _both(lambda impl: load(impl, good)) is True
    assert _both(lambda impl: load(impl, tmp_path / "missing.json")) is False


def test_router_edges_alike():
    def edges(impl):
        from importlib import import_module

        groupings = import_module(f"{impl.runtime.__name__}.groupings")
        router = impl.cluster.Router()
        a, b = impl.cluster.TargetGroup("infer"), impl.cluster.TargetGroup("sink")
        a.inboxes, b.inboxes = [asyncio.Queue(), asyncio.Queue()], [asyncio.Queue()]
        router.add("spout", "default", groupings.ShuffleGrouping(), a)
        router.add("infer", "default", groupings.ShuffleGrouping(), b)
        router.add("infer", "dead_letter", groupings.ShuffleGrouping(), b)
        return [(src, stream, g.component_id, len(g.inboxes))
                for src, stream, g in router.edges()]

    assert _both(edges) == [("spout", "default", "infer", 2), ("infer", "default", "sink", 1),
                            ("infer", "dead_letter", "sink", 1)]


# ---- a lenet5 topology per package, stepped by hand -----------------------------------------

SHAPE = (28, 28, 1)


async def _observed(impl, n: int = 12):
    model = impl.config.ModelConfig(name="lenet5", dtype="float32", num_classes=10,
                                    input_shape=SHAPE)
    batch = impl.config.BatchConfig(max_batch=4, buckets=(4,), max_wait_ms=5)
    if impl.name == "storm_tpu":
        bolt = jax_infer.InferenceBolt(model, batch, jax_config.ShardingConfig(data_parallel=1))
    else:
        bolt = port_infer.InferenceBolt(model, batch, device="cpu")
    cfg = impl.config.Config()
    cfg.tracing.slo_ms = 1e-3  # every record breaches
    c = impl.connectors
    broker = c.MemoryBroker(default_partitions=1)
    tb = impl.runtime.TopologyBuilder()
    tb.set_spout("kafka-spout", c.BrokerSpout(
        broker, "input", impl.config.OffsetsConfig(policy="earliest", max_behind=None)))
    tb.set_bolt("inference-bolt", bolt).shuffle_grouping("kafka-spout")
    tb.set_bolt("kafka-bolt", c.BrokerSink(broker, "output", cfg.sink)) \
        .shuffle_grouping("inference-bolt")
    cluster = impl.cluster.AsyncLocalCluster()
    rt = await cluster.submit("observed", cfg, tb.build())
    obs = impl.obs.Observatory(rt, impl.config.ObsConfig(enabled=True, min_samples=1),
                               sink_components=("kafka-bolt",))
    obs.step()  # primes every cursor
    for i in range(n):
        x = np.random.RandomState(i).rand(1, *SHAPE).astype(np.float32)
        broker.produce("input", json.dumps({"instances": x.tolist()}))
    deadline = asyncio.get_running_loop().time() + 60
    while broker.topic_size("output") < n:
        assert asyncio.get_running_loop().time() < deadline, "records stuck"
        await asyncio.sleep(0.01)
    obs.step()
    snap = obs.snapshot()
    await rt.drain(timeout_s=30)
    await cluster.shutdown()
    return snap


def test_lenet5_topology_observed_alike(run):
    snaps = {}
    for name, impl in IMPLS.items():
        clear_engine_caches()
        snaps[name] = run(_observed(impl), timeout=120)

    def shape(snap):
        v = snap["bottleneck"]
        return {
            "components": sorted(snap["utilization"]),
            "row_keys": sorted(next(iter(snap["utilization"].values()))),
            "verdict_keys": sorted(v),
            "ranked": sorted(r["component"] for r in v["ranked"]),
            "ranked_keys": sorted(v["ranked"][0]),
            "edges": sorted((e["edge"], e["src"], e["dst"], e["stream"]) for e in v["edges"]),
            "queues": sorted((q["component"], q["task"], sorted(q)) for q in v["queues"]),
            "ingress": sorted((r["component"], r["task"], r["partitions"])
                              for r in v["ingress"]),
            "path": sorted(v["critical_path"]["stages"]),
            "slo": sorted(snap["slo"]),
            "copies": sorted(snap["copies"]),
            "snapshot_keys": sorted(snap),
        }

    port = shape(snaps["port"])
    assert port == shape(snaps["storm_tpu"])
    assert port["components"] == ["inference-bolt", "kafka-bolt", "kafka-spout"]
    assert {"queue_wait_ingest", "queue_wait_batch", "device"} <= set(port["path"])
    for snap in snaps.values():
        assert snap["slo"]["fast_burn"] > 0
        leader = snap["bottleneck"]["leader"]
        assert leader is None or leader in port["components"]
