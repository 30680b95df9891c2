"""End to end on the port, the shape of tests/test_e2e.py: broker JSON in
-> 2 spouts -> 4 InferenceBolts (vit_tiny on the CPU) -> 2 sinks -> broker
JSON out, with the dead-letter stream and deferred acks."""

import asyncio
import json

import numpy as np

from storm_tpu_torch.api.schema import decode_predictions
from storm_tpu_torch.config import BatchConfig, Config, ModelConfig, OffsetsConfig
from storm_tpu_torch.connectors import BrokerSink, BrokerSpout, MemoryBroker
from storm_tpu_torch.infer import InferenceBolt
from storm_tpu_torch.infer.engine import clear_engines, shared_engine
from storm_tpu_torch.runtime import AsyncLocalCluster, TopologyBuilder

SHAPE = (32, 32, 3)
MODEL = ModelConfig(name="vit_tiny", dtype="float32", num_classes=10,
                    input_shape=SHAPE, weights="int8_fused")
BATCH = BatchConfig(max_batch=8, max_wait_ms=20, buckets=(8,))


def _payload(seed):
    x = np.random.RandomState(seed).rand(1, *SHAPE).astype(np.float32)
    return json.dumps({"instances": x.tolist()}), x


async def _run(n_msgs, poison_at=None):
    broker = MemoryBroker(default_partitions=2)
    cfg = Config()
    tb = TopologyBuilder()
    tb.set_spout("kafka-spout", BrokerSpout(
        broker, "input", OffsetsConfig(policy="earliest", max_behind=None)),
        parallelism=2)
    tb.set_bolt("inference-bolt", InferenceBolt(MODEL, BATCH, device="cpu"),
                parallelism=4).shuffle_grouping("kafka-spout")
    tb.set_bolt("kafka-bolt", BrokerSink(broker, "output", cfg.sink),
                parallelism=2).shuffle_grouping("inference-bolt")
    tb.set_bolt("dlq-bolt", BrokerSink(broker, "dead-letter", cfg.sink)) \
        .shuffle_grouping("inference-bolt", stream="dead_letter")
    cluster = AsyncLocalCluster()
    rt = await cluster.submit("e2e", cfg, tb.build())
    inputs = []
    for i in range(n_msgs):
        if i == poison_at:
            broker.produce("input", '{"instances": [[1.0, 2.0], [3.0]]}')
        else:
            payload, x = _payload(i)
            inputs.append(x)
            broker.produce("input", payload)
    deadline = asyncio.get_running_loop().time() + 60
    while broker.topic_size("output") + broker.topic_size("dead-letter") < n_msgs:
        assert asyncio.get_running_loop().time() < deadline, "records stuck"
        await asyncio.sleep(0.02)
    await rt.drain(timeout_s=30)
    snap = rt.metrics.snapshot()
    engines = {id(e.bolt.engine) for e in rt.bolt_execs["inference-bolt"]}
    outs, dlq = broker.drain_topic("output"), broker.drain_topic("dead-letter")
    await cluster.shutdown()
    return np.concatenate(inputs), outs, dlq, snap, engines


def test_topology_serves_and_dead_letters(run):
    clear_engines()
    inputs, outs, dlq, snap, engines = run(_run(10, poison_at=4), timeout=120)
    assert len(outs) == 9 and len(dlq) == 1
    dl = json.loads(dlq[0].value)
    assert dl["stage"] == "decode" and "instances" in dl["payload"]
    preds = np.concatenate([decode_predictions(r.value).data for r in outs])
    assert preds.shape == (9, 10)
    np.testing.assert_allclose(preds.sum(-1), 1.0, atol=1e-5)
    # each output is the engine's own prediction for one of the inputs
    direct = shared_engine(MODEL, BATCH, device="cpu").predict(inputs)
    nearest = np.abs(preds[:, None] - direct[None]).max(-1).min(-1)
    assert nearest.max() < 1e-5
    assert snap["inference-bolt"]["dead_lettered"] == 1
    assert snap["inference-bolt"]["instances_inferred"] == 9
    assert snap["kafka-spout"]["tree_acked"] == 10  # poison acked, not replayed
    assert snap["kafka-spout"].get("tree_failed", 0) == 0
    assert snap["kafka-bolt"]["e2e_latency_ms"]["count"] == 9
    assert len(engines) == 1  # the 4 bolt tasks share one copy of the weights
    clear_engines()


def test_local_cluster_facade_runs_the_topology():
    """The synchronous LocalCluster (own loop thread) serves the same
    topology; poison records are acked, never replayed."""
    import time

    from storm_tpu_torch.runtime import LocalCluster

    clear_engines()
    broker = MemoryBroker(default_partitions=2)
    cfg = Config()
    tb = TopologyBuilder()
    tb.set_spout("spout", BrokerSpout(
        broker, "in", OffsetsConfig(policy="earliest", max_behind=None)))
    tb.set_bolt("infer", InferenceBolt(MODEL, BATCH, device="cpu"),
                parallelism=2).shuffle_grouping("spout")
    tb.set_bolt("sink", BrokerSink(broker, "out", cfg.sink)).shuffle_grouping("infer")
    for i in range(3):
        broker.produce("in", _payload(i)[0])
    broker.produce("in", "not json")
    with LocalCluster() as cluster:
        cluster.submit_topology("t", cfg, tb.build())
        deadline = time.monotonic() + 60
        while broker.topic_size("out") < 3 and time.monotonic() < deadline:
            time.sleep(0.02)
        assert cluster.drain("t", timeout_s=30)
        snap = cluster.metrics("t")
        assert cluster.errors("t") == []
        cluster.kill_topology("t")
    assert broker.topic_size("out") == 3
    assert snap["infer"]["dead_lettered"] == 1
    assert snap["spout"]["tree_acked"] == 4
    clear_engines()
