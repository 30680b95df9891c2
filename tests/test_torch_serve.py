"""The port's serving boundary (``storm_tpu_torch/serve/``) against
storm_tpu's on the CPU, lenet5 float32 (28, 28, 1) on storm_tpu's seeded
weights carried across by ``models/convert.py`` ``from_jax_params``: the
worker's ``Info`` keys, ``Predict`` and ``PredictJson`` within 1e-5, the
status codes of a bad shape, a garbage tensor, bad JSON and an unknown
method; the cross-caller batcher's coalescing, chunking and error
propagation (window mode on one engine double, continuous mode on the
engines); the remote bolt's topology; the JVM conformance fixtures; and
the inference operator on an engine with ``predict`` alone (storm_tpu's
``dispatch is None`` branch), side by side.

storm_tpu's gRPC servers stop with a grace period in ``finally``; its
continuous queue is built once per module with the collector off (its
``continuous_for`` can deadlock inside a collection), and every helper
thread is a daemon joined with a timeout."""

from __future__ import annotations

import asyncio
import gc
import json
import os
import threading
from types import SimpleNamespace

import grpc
import jax
import numpy as np
import pytest

import storm_tpu.config as jax_config
import storm_tpu.infer.engine as jax_engine
import storm_tpu.runtime as jax_runtime
import storm_tpu.serve as jax_serve
import storm_tpu.serve.batcher as jax_batcher
import storm_tpu.serve.remote_bolt as jax_remote
from storm_tpu.connectors import BrokerSink as JaxSink
from storm_tpu.connectors import BrokerSpout as JaxSpout
from storm_tpu.connectors import MemoryBroker as JaxBroker
from storm_tpu.infer.operator import InferenceBolt as JaxBolt
from storm_tpu.models import registry as jax_registry
from storm_tpu.runtime.cluster import AsyncLocalCluster as JaxCluster
import storm_tpu_torch.config as port_config
import storm_tpu_torch.runtime as port_runtime
import storm_tpu_torch.serve.batcher as port_batcher
import storm_tpu_torch.serve.remote_bolt as port_remote
from storm_tpu_torch.api.schema import decode_predictions
from storm_tpu_torch.connectors import BrokerSink, BrokerSpout, MemoryBroker
from storm_tpu_torch.infer.engine import InferenceEngine
from storm_tpu_torch.infer.operator import InferenceBolt
from storm_tpu_torch.resilience import RpcError, StatusCode
from storm_tpu_torch.runtime.cluster import AsyncLocalCluster
from storm_tpu_torch.serve import decode_tensor
from storm_tpu_torch.serve.client import InferenceClient
from storm_tpu_torch.serve.worker import InferenceWorker
from tests.fixtures.jvm_conformance.generate import request_array, response_array

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SHAPE = (28, 28, 1)
TOL = 1e-5
POISON = '{"instances": [[1.0, 2.0], [3.0]]}'


def _cfgs(cfg):
    return (cfg.ModelConfig(name="lenet5", dtype="float32", num_classes=10,
                            input_shape=SHAPE),
            cfg.BatchConfig(max_batch=8, buckets=(8,), max_wait_ms=20.0))


def _x(n, seed=0):
    return np.random.RandomState(seed).rand(n, *SHAPE).astype(np.float32)


@pytest.fixture(scope="module")
def workers():
    """storm_tpu's gRPC worker on its shared lenet5 engine (seed 0), and the
    port's on an engine built from the same parameters."""
    jm, jb = _cfgs(jax_config)
    pm, pb = _cfgs(port_config)
    jax_eng = jax_engine.shared_engine(jm, jax_config.ShardingConfig(), jb)
    md = jax_registry.build_model("lenet5", num_classes=10, input_shape=SHAPE)
    params, state = jax.tree.map(np.asarray, jax_registry.init_params(md, 0))
    port_eng = InferenceEngine(pm, pb, device="cpu", params=params, state=state)
    jw = jax_serve.InferenceWorker(jm, jax_config.ShardingConfig(), jb, engine=jax_eng,
                                   port=0).start()
    pw = InferenceWorker(pm, batch=pb, engine=port_eng, port=0, host="127.0.0.1").start()
    try:
        yield SimpleNamespace(jax=jw, port=pw, jax_engine=jax_eng, port_engine=port_eng)
    finally:
        pw.stop()
        jw.stop(grace=1.0)


@pytest.fixture(scope="module")
def clients(workers):
    jc = jax_serve.InferenceClient(f"localhost:{workers.jax.port}")
    pc = InferenceClient(f"127.0.0.1:{workers.port.port}")
    try:
        yield SimpleNamespace(jax=jc, port=pc)
    finally:
        jc.close()
        pc.close()


# ---- the worker ---------------------------------------------------------------------


def test_info_keys_and_values_match(clients):
    ji, pi = clients.jax.info(), clients.port.info()
    assert sorted(pi) == sorted(ji)
    assert {k: pi[k] for k in pi if k != "mesh"} == {k: ji[k] for k in ji if k != "mesh"}
    assert sorted(pi["mesh"]) == sorted(ji["mesh"]) and pi["mesh"] == {"data": 1, "model": 1}


def test_predict_arrow_agrees(clients, workers):
    x = _x(5, seed=1)
    got, want = clients.port.predict(x), clients.jax.predict(x)
    assert got.shape == (5, 10) and got.dtype == np.float32
    np.testing.assert_allclose(got, want, rtol=0, atol=TOL)
    np.testing.assert_array_equal(got, workers.port_engine.predict(x))


def test_predict_json_agrees(clients):
    x = _x(3, seed=2)
    body = json.dumps({"instances": x.tolist()})
    got = np.asarray(json.loads(clients.port.predict_json(body))["predictions"])
    want = np.asarray(json.loads(clients.jax.predict_json(body))["predictions"])
    np.testing.assert_allclose(got, want, rtol=0, atol=TOL)


def _jax_call(worker, method, payload):
    ch = grpc.insecure_channel(f"localhost:{worker.port}")
    try:
        ch.unary_unary(method)(payload, timeout=30)
    except grpc.RpcError as e:
        return e.code().name
    finally:
        ch.close()
    return "OK"


def _port_call(worker, method, payload):
    c = InferenceClient(f"127.0.0.1:{worker.port}")
    try:
        c.call(method, payload)
    except RpcError as e:
        return e.code().name
    finally:
        c.close()
    return "OK"


@pytest.mark.parametrize("case", ["bad_shape", "garbage_tensor", "bad_json", "ragged_json",
                                  "unknown_method"])
def test_status_codes_agree(workers, case):
    from storm_tpu_torch.serve import encode_tensor

    method, payload = {
        "bad_shape": ("/storm_tpu.Inference/Predict",
                      encode_tensor(np.zeros((1, 5, 5, 1), np.float32))),
        "garbage_tensor": ("/storm_tpu.Inference/Predict", b"not an arrow tensor"),
        "bad_json": ("/storm_tpu.Inference/PredictJson", b"{nope"),
        "ragged_json": ("/storm_tpu.Inference/PredictJson", POISON.encode()),
        "unknown_method": ("/storm_tpu.Dist/Control", b"{}"),
    }[case]
    want = "UNIMPLEMENTED" if case == "unknown_method" else "INVALID_ARGUMENT"
    assert _jax_call(workers.jax, method, payload) == want
    assert _port_call(workers.port, method, payload) == want


def test_engine_failure_is_internal():
    class Broken:
        input_shape = SHAPE
        batch_cfg = port_config.BatchConfig(max_batch=8, buckets=(8,))

        def predict(self, x):
            raise RuntimeError("card fell off")

    w = InferenceWorker(port_config.ModelConfig(name="lenet5", input_shape=SHAPE,
                                                num_classes=10),
                        engine=Broken(), port=0, host="127.0.0.1").start()
    try:
        with InferenceClient(f"127.0.0.1:{w.port}") as c, pytest.raises(RpcError) as ei:
            c.predict(_x(1))
        assert ei.value.code() is StatusCode.INTERNAL and "card fell off" in ei.value.details()
    finally:
        w.stop()


def test_jvm_fixtures_decode_to_documented_arrays():
    d = os.path.join(ROOT, "tests", "fixtures", "jvm_conformance")
    for name, want in (("predict_request.arrow", request_array()),
                       ("predict_response.arrow", response_array())):
        with open(os.path.join(d, name), "rb") as f:
            got = decode_tensor(f.read())
        assert got.dtype == np.float32 and got.shape == want.shape
        np.testing.assert_array_equal(got, want)


# ---- the cross-caller batcher ---------------------------------------------------------


class _Engine:
    """An engine double: counts forwards, raises when told to."""

    def __init__(self, fail=False):
        self.calls = []
        self.fail = fail
        self.lock = threading.Lock()

    def predict(self, x):
        with self.lock:
            self.calls.append(x.shape[0])
        if self.fail:
            raise RuntimeError("boom")
        return np.repeat(x.reshape(x.shape[0], -1)[:, :1], 3, axis=1) * [1.0, 2.0, 3.0]


def _callers(batcher, xs, timeout=30.0):
    outs, errs = [None] * len(xs), [None] * len(xs)
    go = threading.Barrier(len(xs))

    def call(i):
        go.wait(timeout)
        try:
            outs[i] = batcher.predict(xs[i])
        except Exception as e:  # noqa: BLE001 - the caller's error is the result
            errs[i] = e

    threads = [threading.Thread(target=call, args=(i,), daemon=True) for i in range(len(xs))]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout)
        assert not t.is_alive(), "a caller never returned"
    return outs, errs


def _window_case(mod, case):
    eng = _Engine(fail=case == "errors")
    b = mod.CrossCallerBatcher(eng, window_ms=150.0, max_batch=4)
    if case == "chunking":
        x = np.arange(10, dtype=np.float32).reshape(10, 1)
        return b.predict(x).tolist(), eng.calls, b.dispatches, None
    xs = [np.full((2, 1), i, np.float32) for i in range(4)]
    outs, errs = _callers(b, xs)
    return ([None if o is None else o.tolist() for o in outs], sorted(eng.calls),
            b.dispatches, [None if e is None else str(e) for e in errs])


@pytest.mark.parametrize("case", ["coalescing", "chunking", "errors"])
def test_window_batcher_cases_agree(case):
    got, want = _window_case(port_batcher, case), _window_case(jax_batcher, case)
    assert got == want
    outs, calls, dispatches, errs = got
    if case == "coalescing":
        # 4 callers, 8 rows: two forwards of the largest bucket, not four.
        assert dispatches == 2 and calls == [4, 4] and errs == [None] * 4
        assert outs == [[[float(i), 2.0 * i, 3.0 * i]] * 2 for i in range(4)]
    elif case == "chunking":
        assert calls == [4, 4, 2] and dispatches == 3
        assert outs == [[float(i), 2.0 * i, 3.0 * i] for i in range(10)]
    else:
        assert errs == ["boom"] * 4 and outs == [None] * 4


@pytest.fixture(scope="module")
def continuous_runs(workers):
    """Both packages' continuous batchers on the workers' engines: 4
    callers of 2 rows each. storm_tpu's is built once, collector off."""
    xs = [_x(2, seed=10 + i) for i in range(4)]
    res = {}
    gc.collect()
    gc.disable()
    try:
        jb = jax_batcher.CrossCallerBatcher(workers.jax_engine, continuous=True,
                                            batch_cfg=_cfgs(jax_config)[1])
        res["jax"] = _callers(jb, xs)[0], jb.dispatches
    finally:
        gc.enable()
    pb = port_batcher.CrossCallerBatcher(workers.port_engine, continuous=True,
                                         batch_cfg=_cfgs(port_config)[1])
    res["port"] = _callers(pb, xs)[0], pb.dispatches
    res["xs"] = xs
    return res


def test_continuous_batcher_coalesces_and_agrees(continuous_runs, workers):
    (jouts, jn), (pouts, pn) = continuous_runs["jax"], continuous_runs["port"]
    assert 1 <= pn < 4 and 1 <= jn < 4
    for x, j, p in zip(continuous_runs["xs"], jouts, pouts):
        np.testing.assert_allclose(p, j, rtol=0, atol=TOL)
        np.testing.assert_allclose(p, workers.port_engine.predict(x), rtol=0, atol=1e-6)


# ---- the remote bolt and the predict-only engine ------------------------------------


def _records(n):
    xs = _x(n, seed=3)
    return xs, [json.dumps({"instances": xs[i:i + 1].tolist()}) for i in range(n)]


async def _drive(rt_mod, Cluster, Broker, Spout, Sink, bolt, cfg, n=16, poison_at=5):
    broker = Broker(default_partitions=2)
    tb = rt_mod.TopologyBuilder()
    tb.set_spout("kafka-spout", Spout(broker, "input", cfg.OffsetsConfig(
        policy="earliest", max_behind=None)), parallelism=2)
    tb.set_bolt("inference-bolt", bolt, parallelism=4).shuffle_grouping("kafka-spout")
    tb.set_bolt("kafka-bolt", Sink(broker, "output"), parallelism=2) \
        .shuffle_grouping("inference-bolt")
    tb.set_bolt("dlq-bolt", Sink(broker, "dead-letter")) \
        .shuffle_grouping("inference-bolt", stream="dead_letter")
    xs, payloads = _records(n)
    for i, p in enumerate(payloads):
        if i == poison_at:
            broker.produce("input", POISON)
        broker.produce("input", p)
    cluster = Cluster()
    rt = await cluster.submit("serve-twin", cfg.Config(), tb.build())
    loop = asyncio.get_running_loop()
    deadline = loop.time() + 60
    while broker.topic_size("output") + broker.topic_size("dead-letter") < n + 1:
        assert loop.time() < deadline, "records stuck"
        await asyncio.sleep(0.02)
    await rt.drain(timeout_s=30)
    snap = rt.metrics.snapshot()
    outs, dlq = broker.drain_topic("output"), broker.drain_topic("dead-letter")
    errors = list(rt.errors)
    await cluster.kill("serve-twin", wait_secs=0)
    preds = np.concatenate([decode_predictions(r.value).data for r in outs])
    return {"preds": preds, "dlq": [json.loads(r.value)["stage"] for r in dlq],
            "errors": errors, "acked": snap["kafka-spout"]["tree_acked"],
            "failed": snap["kafka-spout"].get("tree_failed", 0),
            "dead": snap["inference-bolt"]["dead_lettered"]}


def _by_row(preds, ref):
    """``preds`` in the order of the reference rows they match best."""
    idx = np.abs(preds[:, None, :] - ref[None, :, :]).max(axis=2).argmin(axis=0)
    return preds[idx]


def test_remote_bolt_topology_agrees(run, workers):
    pm, pb = _cfgs(port_config)
    jm, jb = _cfgs(jax_config)
    port = run(_drive(port_runtime, AsyncLocalCluster, MemoryBroker, BrokerSpout, BrokerSink,
                      port_remote.RemoteInferenceBolt(f"127.0.0.1:{workers.port.port}", pb),
                      port_config), timeout=120)
    jaxr = run(_drive(jax_runtime, JaxCluster, JaxBroker, JaxSpout, JaxSink,
                      jax_remote.RemoteInferenceBolt(f"localhost:{workers.jax.port}", jb),
                      jax_config), timeout=120)
    xs, _ = _records(16)
    direct = workers.port_engine.predict(xs)
    for r in (port, jaxr):
        assert r["errors"] == [] and r["dlq"] == ["decode"] and r["dead"] == 1
        assert r["preds"].shape == (16, 10) and r["acked"] == 17 and r["failed"] == 0
    np.testing.assert_allclose(_by_row(port["preds"], direct), direct, rtol=0, atol=1e-6)
    np.testing.assert_allclose(_by_row(jaxr["preds"], direct), direct, rtol=0, atol=TOL)


class _PredictOnly:
    """An engine with ``predict`` alone: a fixed linear map of the mean."""

    def __init__(self):
        self.input_shape = SHAPE
        self.batches = []

    def predict(self, x):
        self.batches.append(x.shape[0])
        m = x.reshape(x.shape[0], -1).mean(axis=1, keepdims=True)
        return (m * np.arange(1, 11, dtype=np.float32)).astype(np.float32)

    def warmup(self, buckets=None):
        pass


def test_predict_only_engine_served_alike(run):
    """storm_tpu's operator serves an engine without ``dispatch`` through
    its ``predict`` (``storm_tpu/infer/operator.py``, the ``dispatch is
    None`` branch); the port's does too: same outputs, acks, dead
    letters."""
    pm, pb = _cfgs(port_config)
    jm, jb = _cfgs(jax_config)
    pe, je = _PredictOnly(), _PredictOnly()
    port = run(_drive(port_runtime, AsyncLocalCluster, MemoryBroker, BrokerSpout, BrokerSink,
                      InferenceBolt(pm, pb, engine=pe, warmup=False), port_config),
               timeout=60)
    jaxr = run(_drive(jax_runtime, JaxCluster, JaxBroker, JaxSpout, JaxSink,
                      JaxBolt(jm, jb, engine=je, warmup=False), jax_config), timeout=60)
    for r in (port, jaxr):
        assert r["errors"] == [] and r["dlq"] == ["decode"] and r["dead"] == 1
        assert r["acked"] == 17 and r["failed"] == 0
    assert sum(pe.batches) == sum(je.batches) == 16
    np.testing.assert_allclose(np.sort(port["preds"], axis=0), np.sort(jaxr["preds"], axis=0),
                               rtol=0, atol=1e-6)
