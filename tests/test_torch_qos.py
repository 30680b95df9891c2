"""The port's QoS against storm_tpu's on the CPU (``tests/test_qos.py``'s
cases): each sequence runs through ``storm_tpu.qos`` and
``storm_tpu_torch.qos`` (the ``impl`` fixture, or both side by side), with
injected clocks where time matters — admission verdicts and counters, the
lane batcher's take order, and the shed controller's levels on a fake
runtime. Then the port end to end on the CPU (``longseq_tiny``): the lane
field rides from the spout to the sink's per-lane histograms, a raised
shed level drops best-effort records at the spout edge, and records that
reached the operator before the level rose come back as ``Overloaded``,
acked and never replayed; ``qos.degrade_model`` gives storm_tpu's
synthesized shed-only cascade.
"""

import asyncio
import json
from types import SimpleNamespace

import numpy as np
import pytest

import storm_tpu.api.schema as jax_schema
import storm_tpu.config as jax_config
import storm_tpu.qos as jax_qos
import storm_tpu.runtime.metrics as jax_metrics
import storm_tpu_torch.api.schema as port_schema
import storm_tpu_torch.config as port_config
import storm_tpu_torch.qos as port_qos
import storm_tpu_torch.runtime.metrics as port_metrics
from storm_tpu_torch.api.schema import decode_predictions
from storm_tpu_torch.config import BatchConfig, Config, ModelConfig, OffsetsConfig, QosConfig
from storm_tpu_torch.connectors import BrokerSink, BrokerSpout, MemoryBroker
from storm_tpu_torch.infer import InferenceBolt
from storm_tpu_torch.infer.continuous import _reset_registry
from storm_tpu_torch.infer.engine import clear_engines
from storm_tpu_torch.runtime import AsyncLocalCluster, Spout, TopologyBuilder, Values

IMPLS = {
    "storm_tpu": SimpleNamespace(name="storm_tpu", config=jax_config, qos=jax_qos,
                                 metrics=jax_metrics, schema=jax_schema),
    "port": SimpleNamespace(name="port", config=port_config, qos=port_qos,
                            metrics=port_metrics, schema=port_schema),
}


@pytest.fixture(params=sorted(IMPLS))
def impl(request):
    return IMPLS[request.param]


def _both(fn):
    """``fn(impl)`` for both packages; the two results must be equal."""
    got = {name: fn(i) for name, i in IMPLS.items()}
    assert got["port"] == got["storm_tpu"], got
    return got["port"]


# ---- config, token bucket, admission -------------------------------------------


def test_qos_config_lane_helpers_match():
    def helpers(i):
        q = i.config.QosConfig(enabled=True, tenant_rate=5.0, tenant_rates={"gold": 50.0})
        lanes = ("high", "normal", "best_effort", "bogus", None)
        return ([q.lane_index(ln) for ln in lanes], [q.deadline_for(ln) for ln in lanes],
                q.max_shed_level,
                [[q.shed_eligible(ln, lv) for lv in range(5)] for ln in lanes],
                [q.rate_for(t) for t in ("gold", "free")])

    _both(helpers)


@pytest.mark.parametrize("kw", [dict(lanes=()), dict(lanes=("a", "a")),
                                dict(lane_deadline_ms=(1.0,)), dict(default_lane="x"),
                                dict(shed_interval_s=0), dict(shed_hot_steps=0)])
def test_qos_config_validation_matches(impl, kw):
    with pytest.raises(ValueError):
        impl.config.QosConfig(**kw)


def test_batch_config_continuous_fields_match():
    _both(lambda i: (i.config.BatchConfig().continuous,
                     i.config.BatchConfig().starvation_rounds))


def test_token_bucket_sequences_match():
    def seq(i):
        b = i.qos.TokenBucket(rate=10.0, burst=3.0, now=100.0)
        clock = [100.0, 100.0, 100.0, 100.0, 100.05, 100.1, 100.35, 99.0, 101.0]
        return [b.try_take(1.0, now=t) for t in clock] + [round(b.tokens, 9)]

    out = _both(seq)
    assert out[:4] == [True, True, True, False]  # the burst, then empty


@pytest.mark.parametrize("parallelism", [1, 3])
def test_admission_verdicts_and_counters_match(parallelism):
    keys = [b"gold:high", b"free:best_effort", b"free", None, b":normal", b"gold:bogus",
            b"free:best_effort", b"free:best_effort", b"gold:high", b"free:normal"]
    clock = [10.0 + 0.01 * i for i in range(len(keys))]

    def seq(i):
        reg = i.metrics.MetricsRegistry()
        q = i.config.QosConfig(enabled=True, tenant_rate=12.0, tenant_burst_s=0.25,
                               tenant_rates={"gold": 0.0})
        ac = i.qos.AdmissionController(q, parallelism=parallelism, metrics=reg)
        verdicts = []
        for level in (0.0, 1.0, 2.0):
            reg.gauge("qos", "shed_level").set(level)
            for key, now in zip(keys, clock):
                tenant, lane = ac.classify(key, "topic")
                verdicts.append((tenant, lane, ac.admit(tenant, lane, now=now + level)))
        return verdicts, reg.snapshot()["qos"]

    verdicts, counters = _both(seq)
    assert {v[2][1] for v in verdicts} == {"ok", "throttled", "shed"}
    assert counters["shed_lane_best_effort"] > 0


# ---- the lane batcher ------------------------------------------------------------


def _arrivals():
    rng = np.random.RandomState(3)
    lanes = ("high", "normal", "best_effort", None)
    return [(f"r{i}", int(rng.randint(1, 4)), lanes[rng.randint(4)], 50.0 + 0.001 * i)
            for i in range(40)]


def test_lane_batcher_take_order_matches():
    def seq(i):
        q = i.config.QosConfig(enabled=True)
        lb = i.qos.LaneBatcher(i.config.BatchConfig(max_batch=8, buckets=(8,),
                                                     max_wait_ms=5.0), q)
        taken = []

        def take(batch):
            if batch is not None:
                taken.append([it.payload for it in batch.items])

        for name, rows, lane, ts in _arrivals():
            take(lb.add(name, np.zeros((rows, 2), np.float32), ts=ts, lane=lane))
            take(lb.take_ready())
        take(lb.take_if_due(now=1e9))
        while len(lb):
            take(lb.take_all())
        stats = lb.stats()
        return taken, stats["kind"], stats["pending_rows"]

    taken, kind, pending = _both(seq)
    assert kind == "lane" and pending == 0
    assert sorted(p for b in taken for p in b) == sorted(f"r{i}" for i in range(40))


def test_lane_batcher_high_preempts_queued_best_effort(impl):
    lb = impl.qos.LaneBatcher(impl.config.BatchConfig(max_batch=3, buckets=(3,)),
                              impl.config.QosConfig(enabled=True))
    x = np.zeros((1, 2), np.float32)
    assert lb.add("p0", x, ts=1.0, lane="best_effort") is None
    assert lb.add("p1", x, ts=1.0, lane="best_effort") is None
    batch = lb.add("p2", x, ts=1.0, lane="high")
    assert [it.payload for it in batch.items] == ["p2", "p0", "p1"]


# ---- the shed controller ----------------------------------------------------------


class _Inbox:
    def __init__(self, n: int, maxsize: int = 100) -> None:
        self._queue = [SimpleNamespace(values=["rec"])] * n
        self.maxsize = maxsize


def _shed_levels(i, script):
    """Run ``script`` (per step: breaches added, inbox rows, a batch wait)
    through a controller on a fake runtime; the levels and decisions."""
    reg = i.metrics.MetricsRegistry()
    inbox = _Inbox(0)
    rt = SimpleNamespace(metrics=reg, bolt_execs={"inference-bolt": [SimpleNamespace(
        inbox=inbox)]}, flight=None)
    pol = i.qos.ShedPolicy(interval_s=1.0, breach_rate=1.0, wait_ms=40.0, inbox_frac=0.5,
                           hot_steps=2, calm_steps=3, max_level=2)
    ctl = i.qos.LoadShedController(rt, pol)
    assert rt.qos is ctl
    levels = []
    for breaches, rows, wait in script:
        reg.counter("kafka-bolt", "slo_breaches").inc(breaches)
        inbox._queue = [SimpleNamespace(values=["rec"])] * rows
        if wait is not None:
            reg.histogram("inference-bolt", "batch_wait_ms").observe(wait)
        levels.append(ctl.step())
    return levels, ctl.level, ctl.decisions, reg.gauge("qos", "shed_level").value, \
        reg.counter("qos", "shed_decisions").value


def test_shed_controller_levels_match():
    script = ([(0, 0, None)] + [(5, 0, None)] * 5 + [(0, 0, None)] * 8
              + [(0, 80, None)] * 3 + [(0, 10, None)] * 2 + [(0, 0, 90.0)] * 3
              + [(1, 30, None)] * 4)
    levels, level, decisions, gauge, n = _both(lambda i: _shed_levels(i, script))
    assert max(lv for lv in levels if lv is not None) == 2  # capped at max_level
    assert ("shed", 0, 1) in decisions and ("restore", 1, 0) in decisions
    assert n == len(decisions) and gauge == level


def test_shed_policy_from_qos_matches():
    def pol(i):
        q = i.config.QosConfig(enabled=True, shed_interval_s=0.25, shed_breach_rate=3.0,
                               shed_hot_steps=4, shed_calm_steps=9, shed_wait_ms=7.0,
                               shed_inbox_frac=0.3)
        p = i.qos.ShedPolicy.from_qos(q, component="c", latency_source="s")
        return (p.component, p.latency_source, p.interval_s, p.inbox_frac, p.wait_ms,
                p.breach_rate, p.hot_steps, p.calm_steps, p.max_level)

    _both(pol)


def test_overloaded_json_is_storm_tpus():
    _both(lambda i: [i.schema.Overloaded().to_json(),
                     i.schema.Overloaded(lane="best_effort", tenant="free",
                                         shed_level=2).to_json()])


def test_degrade_model_waits_for_the_cascade():
    """``qos.degrade_model`` no longer raises: as storm_tpu's, the bolt
    synthesizes a two-tier shed-only cascade (the degrade model, then its
    own) whose tier 0 serves shed lanes."""
    import dataclasses

    import storm_tpu.infer.operator as jax_operator

    port = InferenceBolt(ModelConfig(name="longseq_tiny", input_shape=(64, 16)),
                         qos=QosConfig(enabled=True, degrade_model="lenet5"),
                         device="cpu")._cascade_cfg()
    jax = jax_operator.InferenceBolt(
        jax_config.ModelConfig(name="longseq_tiny", input_shape=(64, 16)),
        qos=jax_config.QosConfig(enabled=True, degrade_model="lenet5"))._cascade_cfg()
    assert dataclasses.asdict(port) == dataclasses.asdict(jax)
    assert port.shed_only and port.tiers == ("lenet5", "longseq_tiny")


# ---- end to end on the CPU ------------------------------------------------------------

MODEL = ModelConfig(name="longseq_tiny", dtype="float32", num_classes=10,
                    input_shape=(64, 16))
BATCH = BatchConfig(max_batch=8, max_wait_ms=20, buckets=(8,))


def _payload(seed):
    x = np.random.RandomState(seed).randn(1, 64, 16).astype(np.float32)
    return json.dumps({"instances": x.tolist()})


class _LaneSpout(Spout):
    """Tuples that were admitted with their lane before the shed level
    rose: (message, qos_lane), one per record, acked or failed back."""

    def __init__(self, records) -> None:
        self.records = records

    def clone(self):
        return _LaneSpout(self.records)

    def declare_output_fields(self):
        return {"default": ("message", "qos_lane")}

    def open(self, context, collector):
        super().open(context, collector)
        self.i, self.acked, self.failed = 0, [], []

    async def next_tuple(self):
        if self.i >= len(self.records):
            return False
        payload, lane = self.records[self.i]
        await self.collector.emit(Values([payload, lane]), msg_id=self.i)
        self.i += 1
        return True

    def ack(self, msg_id):
        self.acked.append(msg_id)

    def fail(self, msg_id):
        self.failed.append(msg_id)


async def _serve(spout, keys_or_n, shed_level=0.0, n_expect=None, continuous=False):
    broker = MemoryBroker(default_partitions=2)
    cfg = Config()
    qos = QosConfig(enabled=True)
    tb = TopologyBuilder()
    tb.set_spout("kafka-spout", spout(broker, qos), parallelism=1)
    tb.set_bolt("inference-bolt", InferenceBolt(
        MODEL, BatchConfig(max_batch=8, max_wait_ms=20, buckets=(8,), continuous=continuous),
        device="cpu", passthrough=("qos_lane",), qos=qos), parallelism=2) \
        .shuffle_grouping("kafka-spout")
    tb.set_bolt("kafka-bolt", BrokerSink(broker, "output", cfg.sink), parallelism=1) \
        .shuffle_grouping("inference-bolt")
    cluster = AsyncLocalCluster()
    rt = await cluster.submit("qos", cfg, tb.build())
    rt.metrics.gauge("qos", "shed_level").set(shed_level)
    n = keys_or_n
    if isinstance(keys_or_n, list):
        for i, key in enumerate(keys_or_n):
            broker.produce("input", _payload(i), key=key)
        n = len(keys_or_n)
    total = n_expect if n_expect is not None else n
    deadline = asyncio.get_running_loop().time() + 60
    while broker.topic_size("output") < total:
        assert asyncio.get_running_loop().time() < deadline, "records stuck"
        await asyncio.sleep(0.02)
    await rt.drain(timeout_s=30)
    spouts = [e.spout for e in rt.spout_execs["kafka-spout"]]
    snap = rt.metrics.snapshot()
    outs = broker.drain_topic("output")
    await cluster.shutdown()
    _reset_registry()  # closes the continuous queues and joins their threads
    return outs, snap, spouts


def _broker_spout(broker, qos):
    return BrokerSpout(broker, "input", OffsetsConfig(policy="earliest", max_behind=None),
                       qos=qos)


@pytest.mark.parametrize("continuous", [False, True])
def test_lane_field_reaches_the_sinks_per_lane_histograms(run, continuous):
    clear_engines()
    keys = [b"gold:high"] * 3 + [b"free:best_effort"] * 3
    outs, snap, _ = run(_serve(_broker_spout, keys, continuous=continuous), timeout=120)
    assert len(outs) == 6
    assert all(decode_predictions(r.value).data.shape == (1, 10) for r in outs)
    q = snap["qos"]
    assert q["admitted_gold"] == 3 and q["admitted_lane_best_effort"] == 3
    sink = snap["kafka-bolt"]
    assert sink["e2e_latency_ms_high"]["count"] == 3
    assert sink["e2e_latency_ms_best_effort"]["count"] == 3
    assert snap["kafka-spout"]["tree_acked"] == 6
    clear_engines()


def test_edge_shed_drops_best_effort_at_the_spout(run):
    clear_engines()
    keys = [b"free:best_effort"] * 3 + [b"gold:high"] * 3
    outs, snap, spouts = run(_serve(_broker_spout, keys, shed_level=1.0, n_expect=3),
                             timeout=120)
    assert len(outs) == 3
    assert snap["qos"]["shed_free"] == 3 and snap["qos"]["admitted_gold"] == 3
    assert sum(s.dropped for s in spouts) == 3  # cursor advanced, no replay
    assert snap["kafka-spout"]["tree_acked"] == 3
    assert snap["kafka-bolt"]["e2e_latency_ms_high"]["count"] == 3
    clear_engines()


def test_operator_sheds_best_effort_with_overloaded_and_acks(run):
    """Records already past admission when the level rises: best-effort
    ones are answered Overloaded before any decode and acked; high ones
    are served; every lane's e2e histogram fills."""
    clear_engines()
    records = [(_payload(i), lane) for i, lane in enumerate(
        ["best_effort", "high", "best_effort", "high", "best_effort", "high"])]
    outs, snap, spouts = run(_serve(lambda b, q: _LaneSpout(records), 6, shed_level=1.0),
                             timeout=120)
    msgs = [json.loads(r.value) for r in outs]
    over = [m for m in msgs if "overloaded" in m]
    assert len(over) == 3 and len(msgs) == 6
    assert all(m == {"overloaded": True, "lane": "best_effort", "tenant": "",
                     "shed_level": 1} for m in over)
    assert sum(1 for m in msgs if "predictions" in m) == 3
    bolt = snap["inference-bolt"]
    assert bolt["shed_rejected"] == 3 and bolt["instances_inferred"] == 3
    assert sorted(spouts[0].acked) == list(range(6)) and spouts[0].failed == []
    sink = snap["kafka-bolt"]
    assert sink["e2e_latency_ms_best_effort"]["count"] == 3
    assert sink["e2e_latency_ms_high"]["count"] == 3
    clear_engines()
