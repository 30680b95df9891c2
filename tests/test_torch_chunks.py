"""Chunked spouts, record frames and frame egress: the same seeded stream
through storm_tpu's topology and the port's on the CPU.

``lenet5_rgb_digits`` (float32) serves held-out digits rows sent as Arrow
tensor records of shape (1, 32, 32, 3), with one JSON record of the same
shape and one poison record (0xFF-led, truncated) among them, through
1 spout -> 1 InferenceBolt -> 1 sink (+ a dead-letter sink), one
partition, so both packages form the same chunks and batches. Each case
sets the spout's chunk, scheme and frames, ``frame_egress`` and
``continuous`` (and QoS lanes in one), and both packages must give:

- the same predictions for every record, within ``TOL`` (float32 on the
  CPU, XLA against PyTorch), each record answered exactly once;
- the same dead letters, byte for byte (the poison alone: its chunk lives
  on, nothing is replayed);
- the same number of output messages, and the same acked roots;
- the same copy-ledger rows: calls, copies, allocations and records per
  stage, and the bytes except where the port moves bytes otherwise, as
  ``tests/test_torch_copyledger.py`` holds them (``d2h``; the
  ``json_encode`` text each package wrote).

A batch forced to fail replays its chunk once, in both packages; under
QoS every chunk is lane-homogeneous.
"""

from __future__ import annotations

import asyncio
import gc
import json
import os
from types import SimpleNamespace

import numpy as np
import pytest

import storm_tpu.config as jax_config
import storm_tpu.connectors as jax_connectors
import storm_tpu.connectors.spout as jax_spout
import storm_tpu.infer as jax_infer
import storm_tpu.infer.engine as jax_engine
import storm_tpu.obs.copyledger as jax_ledger
import storm_tpu.runtime as jax_runtime
import storm_tpu.runtime.cluster as jax_cluster
import storm_tpu_torch.config as port_config
import storm_tpu_torch.connectors as port_connectors
import storm_tpu_torch.connectors.spout as port_spout
import storm_tpu_torch.infer as port_infer
import storm_tpu_torch.obs.copyledger as port_ledger
import storm_tpu_torch.runtime as port_runtime
import storm_tpu_torch.runtime.cluster as port_cluster
from storm_tpu.infer.continuous import _reset_registry as jax_reset_registry
from storm_tpu_torch.api.schema import decode_predictions
from storm_tpu_torch.data import load_digits_nhwc
from storm_tpu_torch.infer.continuous import _reset_registry
from storm_tpu_torch.infer.engine import clear_engines, shared_engine
from storm_tpu_torch.serve.marshal import encode_tensor
from tests.test_torch_checkpoints import abstract_init  # noqa: F401 (fixture)
from tests.test_torch_codec import storm_tpu_native  # noqa: F401 (module fixture)
from tests.test_torch_copyledger import settled_snapshot

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SHAPE = (32, 32, 3)
TOL = 1e-5  # a row's probabilities, storm_tpu against the port (float32, CPU)
N_TENSOR = 22
POISON_AT = 11  # inside the second chunk of 8
JSON_AT = 5
IMPLS = {
    "storm_tpu": SimpleNamespace(name="storm_tpu", config=jax_config, connectors=jax_connectors,
                                 runtime=jax_runtime, cluster=jax_cluster, ledger=jax_ledger,
                                 spout=jax_spout),
    "port": SimpleNamespace(name="port", config=port_config, connectors=port_connectors,
                            runtime=port_runtime, cluster=port_cluster, ledger=port_ledger,
                            spout=port_spout),
}
STAGES_TENSOR = ["spout_ingest", "batch_route", "json_decode", "tuple_route",
                 "marshal_decode", "staging", "h2d", "d2h", "json_encode", "sink_encode"]


def _clear_all():
    clear_engines()
    _reset_registry()
    with jax_engine._ENGINES_LOCK:
        jax_engine._ENGINES.clear()
    jax_reset_registry()
    # Collect the dropped engines here, where no registry lock is held: a
    # storm_tpu engine's finalizer that ran inside a later test's
    # continuous_for would deadlock there (ROADMAP C3).
    gc.collect()


@pytest.fixture(scope="module", autouse=True)
def _engines_of_this_module():
    """Both packages' engine caches start and end empty, so each case
    finds both alike (built and warmed by the first case that needs it)."""
    _clear_all()
    yield
    _clear_all()


def _rows():
    _, _, x, _ = load_digits_nhwc(SHAPE)
    _, first = np.unique(x.reshape(len(x), -1), axis=0, return_index=True)
    return x[np.sort(first)][:N_TENSOR + 1]


def _stream(scheme: str):
    """(payload, key, row index or None) in produce order: tensor records
    (JSON ones under the string scheme), one JSON record, one poison."""
    rows = _rows()
    lanes = [b"t1:high", b"t2:normal", b"t1:best_effort"]
    out = []
    for i in range(N_TENSOR + 1):
        x = rows[i:i + 1]
        if scheme == "string" or i == JSON_AT:
            payload = json.dumps({"instances": x.tolist()}).encode()
        else:
            payload = encode_tensor(x)
        out.append((payload, lanes[i % 3], i))
    poison = encode_tensor(rows[:1])[:100]  # 0xFF-led, truncated
    if scheme == "string":
        poison = b'{"instances": [[1.0, 2.0], [3.0]]}'
    out.insert(POISON_AT, (poison, lanes[0], None))
    return out


def _model(impl):
    if impl.name == "storm_tpu":
        return jax_config.ModelConfig(
            name="lenet5", dtype="float32", num_classes=10, input_shape=SHAPE,
            checkpoint=os.path.join(ROOT, "checkpoints", "lenet5_rgb_digits"))
    return port_config.ModelConfig.from_checkpoint("checkpoints/lenet5_rgb_digits",
                                                   dtype="float32")


async def _serve(impl, case: dict, fail_first: bool = False):
    cfg = impl.config.Config()
    c = impl.connectors
    qos = impl.config.QosConfig(enabled=True) if case.get("qos") else None
    batch = impl.config.BatchConfig(max_batch=8, buckets=(8,), max_wait_ms=200,
                                    max_inflight=1, continuous=case.get("continuous", False))
    batch.frame_egress = case.get("frame_egress", True)
    model = _model(impl)
    extra = dict(qos=qos, passthrough=("qos_lane",)) if qos else {}
    if impl.name == "storm_tpu":
        bolt = jax_infer.InferenceBolt(model, batch, jax_config.ShardingConfig(data_parallel=1),
                                       **extra)
    else:
        bolt = port_infer.InferenceBolt(model, batch, device="cpu", **extra)
    broker = c.MemoryBroker(default_partitions=1)
    tb = impl.runtime.TopologyBuilder()
    tb.set_spout("spout", c.BrokerSpout(
        broker, "input", impl.config.OffsetsConfig(policy="earliest", max_behind=None),
        chunk=case["chunk"], scheme=case["scheme"], qos=qos, frames=case.get("frames", False)))
    tb.set_bolt("infer", bolt).shuffle_grouping("spout")
    tb.set_bolt("sink", c.BrokerSink(broker, "output", cfg.sink)).shuffle_grouping("infer")
    tb.set_bolt("dlq", c.BrokerSink(broker, "dead-letter", cfg.sink)) \
        .shuffle_grouping("infer", stream="dead_letter")
    stream = _stream(case["scheme"])  # before the reset: the port's encode is ledgered
    impl.ledger.ensure_installed()
    impl.ledger.copy_ledger().reset()
    groups = []
    emit_chunk = impl.spout.BrokerSpout._emit_chunk

    async def spy(self, records):
        if self.qos is not None:
            groups.append({self._lane_of(r) for r in records})
        await emit_chunk(self, records)

    impl.spout.BrokerSpout._emit_chunk = spy
    cluster = impl.cluster.AsyncLocalCluster()
    try:
        rt = await cluster.submit("chunks", cfg, tb.build())
        engine = rt.bolt_execs["infer"][0].bolt.engine
        if fail_first:
            dispatch = engine.dispatch

            def fail_once(parts):
                engine.dispatch = dispatch
                raise RuntimeError("forced batch failure")

            engine.dispatch = fail_once
        for payload, key, _ in stream:
            broker.produce("input", payload, key)
        n_good = len(stream) - 1
        deadline = asyncio.get_running_loop().time() + 60
        while not (broker.topic_size("dead-letter") == 1 and _rows_out(broker) >= n_good):
            assert asyncio.get_running_loop().time() < deadline, "records stuck"
            await asyncio.sleep(0.01)
        await rt.drain(timeout_s=30)
        snap = rt.metrics.snapshot()
        if fail_first:
            del engine.dispatch
        outs, dlq = broker.drain_topic("output"), broker.drain_topic("dead-letter")
    finally:
        impl.spout.BrokerSpout._emit_chunk = emit_chunk
        await cluster.shutdown()
    tree = settled_snapshot(impl.ledger)
    impl.ledger.copy_ledger().reset()
    return SimpleNamespace(outs=outs, dlq=dlq, snap=snap, tree=tree, groups=groups,
                           stream=stream)


def _rows_out(broker) -> int:
    """Prediction rows in the output topic so far (read, not drained)."""
    return sum(decode_predictions(r.value).data.shape[0]
               for p in range(broker.partitions_for("output"))
               for r in broker.fetch("output", p, 0, 1 << 20))


def _per_record(res, direct: np.ndarray) -> np.ndarray:
    """Each record's prediction row, in row order: every output row matched
    to the engine's direct forward of the input rows (each used once)."""
    preds = np.concatenate([decode_predictions(r.value).data for r in res.outs])
    dist = np.abs(preds[:, None, :] - direct[None, :, :]).max(axis=2)
    idx = dist.argmin(axis=1)
    assert dist[np.arange(len(idx)), idx].max() < TOL
    assert sorted(idx.tolist()) == list(range(len(direct))), "a record missing or twice"
    out = np.empty_like(preds)
    out[idx] = preds
    return out


CASES = {
    "chunk1-raw": dict(chunk=1, scheme="raw"),
    "chunk8-list": dict(chunk=8, scheme="raw"),
    "chunk8-string": dict(chunk=8, scheme="string"),
    "chunk8-frames": dict(chunk=8, scheme="raw", frames=True),
    "chunk8-frames-no-egress": dict(chunk=8, scheme="raw", frames=True, frame_egress=False),
    "chunk8-frames-continuous": dict(chunk=8, scheme="raw", frames=True, continuous=True),
    "chunk8-frames-qos": dict(chunk=8, scheme="raw", frames=True, qos=True),
}


def _check_ledgers(res: dict, case: dict) -> None:
    # Predictions leave as str (re-encoded by the sink) unless the bolt saw
    # a raw-scheme tuple: bytes, or a frame (a chunk's list is neither).
    str_egress = case["scheme"] == "string" or (case["chunk"] > 1 and not case.get("frames"))
    j, p = res["storm_tpu"].tree["stages"], res["port"].tree["stages"]
    assert list(j) == list(p)
    for stage in j:
        if stage == "d2h":
            # the port copies the result out of its pinned buffer again
            assert p[stage]["copies"] == 2 * j[stage]["copies"]
            assert p[stage]["calls"] == j[stage]["calls"]
            continue
        assert (p[stage]["copies"], p[stage]["allocs"], p[stage]["records"],
                p[stage]["calls"]) == (j[stage]["copies"], j[stage]["allocs"],
                                       j[stage]["records"], j[stage]["calls"]), stage
        if stage in ("json_encode", "sink_encode"):
            # each package's own prediction text (and the dead letter)
            for r in res.values():
                text = sum(len(o.value) for o in r.outs)
                want = {"json_encode": text,
                        "sink_encode": text * str_egress + sum(len(d.value) for d in r.dlq)}
                assert r.tree["stages"][stage]["bytes"] == want[stage], stage
            continue
        assert p[stage]["bytes"] == j[stage]["bytes"], stage
    if case["scheme"] == "raw":
        assert "spout_scheme" not in p
        assert p["sink_encode"]["calls"] == (len(res["port"].outs) * str_egress + 1)
        # one view per tensor record: no bytes; the JSON record's array
        assert p["json_decode"]["bytes"] == int(np.prod(SHAPE)) * 4
        assert p["marshal_decode"]["bytes"] == p["marshal_decode"]["copies"] == 0
    if case.get("frames"):
        n_frames = (len(res["port"].groups) if case.get("qos")
                    else -(-len(res["port"].stream) // case["chunk"]))
        assert p["batch_route"]["calls"] == n_frames and p["batch_route"]["bytes"] == 0
        assert list(p) == STAGES_TENSOR


@pytest.mark.parametrize("name", list(CASES))
def test_same_stream_same_answers(run, abstract_init, name):  # noqa: F811
    case = CASES[name]
    res = {k: run(_serve(impl, case), timeout=110) for k, impl in IMPLS.items()}
    rows = _rows()
    direct = shared_engine(_model(IMPLS["port"]), port_config.BatchConfig(
        max_batch=8, buckets=(8,)), device="cpu").predict(rows)
    got, want = _per_record(res["port"], direct), _per_record(res["storm_tpu"], direct)
    np.testing.assert_allclose(got, want, atol=TOL, rtol=0)
    assert [r.value for r in res["port"].dlq] == [r.value for r in res["storm_tpu"].dlq]
    assert json.loads(res["port"].dlq[0].value)["error"].startswith(
        "payload is not a valid tensor frame" if case["scheme"] == "raw" else "")
    n_out = {k: len(r.outs) for k, r in res.items()}
    assert n_out["port"] == n_out["storm_tpu"]
    n_records = len(rows)
    if case["chunk"] > 1 and case.get("frames") and case.get("frame_egress", True) \
            and not case.get("continuous"):
        assert n_out["port"] < n_records  # one payload per (frame, batch)
    else:
        assert n_out["port"] == n_records  # one per record
    n_chunks = -(-len(res["port"].stream) // case["chunk"])
    for r in res.values():
        spout = r.snap["spout"]
        assert spout.get("tree_failed", 0) == 0
        # one root per tuple: a record, a chunk, or a chunk's lane group
        assert spout["tree_acked"] == (len(r.groups) if case.get("qos") else n_chunks)
        assert r.snap["infer"]["dead_lettered"] == 1
    if case.get("qos"):
        assert res["port"].groups == res["storm_tpu"].groups
        assert all(len(g) == 1 for g in res["port"].groups)
        assert len(res["port"].groups) > n_chunks
        for lane in ("high", "normal", "best_effort"):
            key = f"e2e_latency_ms_{lane}"
            assert res["port"].snap["sink"][key]["count"] == \
                res["storm_tpu"].snap["sink"][key]["count"] > 0
    _check_ledgers(res, case)


def test_failed_batch_replays_its_chunk_once(run, abstract_init):  # noqa: F811
    case = dict(chunk=8, scheme="raw", frames=True)
    rows = _rows()
    direct = shared_engine(_model(IMPLS["port"]), port_config.BatchConfig(
        max_batch=8, buckets=(8,)), device="cpu").predict(rows)
    res = {k: run(_serve(impl, case, fail_first=True), timeout=110)
           for k, impl in IMPLS.items()}
    for r in res.values():
        spout = r.snap["spout"]
        assert spout["tree_failed"] == 1  # the first chunk, once
        assert spout["tree_acked"] == -(-len(r.stream) // 8)
        _per_record(r, direct)  # every record answered exactly once
        assert len(r.dlq) == 1
    assert len(res["port"].outs) == len(res["storm_tpu"].outs)
