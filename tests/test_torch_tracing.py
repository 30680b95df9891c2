"""The port's tracing (``storm_tpu_torch/runtime/tracing.py``) against
storm_tpu's on the CPU: trace contexts and their wire forms, the trace
store's bounds, the flight recorder (ring, throttle, rotation, a bad path,
and the same JSONL lines for the same events), sampling off, and a lenet5
2/4/2 topology run by both packages at ``sample_rate=1`` whose traces must
have the same span names, parents, links and attribute keys per record.
"""

from __future__ import annotations

import asyncio
import json
import os
import time
from types import SimpleNamespace

import numpy as np
import pytest

import storm_tpu.config as jax_config
import storm_tpu.connectors as jax_connectors
import storm_tpu.infer as jax_infer
import storm_tpu.runtime as jax_runtime
import storm_tpu.runtime.cluster as jax_cluster
import storm_tpu.runtime.tracing as jax_tracing
import storm_tpu_torch.config as port_config
import storm_tpu_torch.connectors as port_connectors
import storm_tpu_torch.infer as port_infer
import storm_tpu_torch.runtime as port_runtime
import storm_tpu_torch.runtime.cluster as port_cluster
import storm_tpu_torch.runtime.tracing as port_tracing
from storm_tpu_torch.infer.engine import clear_engines
from tests.test_torch_copyledger import clear_engine_caches

SHAPE = (28, 28, 1)
IMPLS = {
    "storm_tpu": SimpleNamespace(name="storm_tpu", tracing=jax_tracing, config=jax_config,
                                 connectors=jax_connectors, infer=jax_infer,
                                 runtime=jax_runtime, cluster=jax_cluster),
    "port": SimpleNamespace(name="port", tracing=port_tracing, config=port_config,
                            connectors=port_connectors, infer=port_infer,
                            runtime=port_runtime, cluster=port_cluster),
}


def _ids(n: int, seed: int = 0):
    rng = np.random.RandomState(seed)
    return [("".join(f"{b:02x}" for b in rng.randint(0, 256, 16)),
             "".join(f"{b:02x}" for b in rng.randint(0, 256, 8))) for _ in range(n)]


def test_traceparent_and_bytes_round_trip_alike():
    for trace_id, span_id in _ids(16):
        heads, raws = [], []
        for impl in IMPLS.values():
            ctx = impl.tracing.TraceContext(trace_id, span_id)
            head = ctx.traceparent()
            back = impl.tracing.TraceContext.from_traceparent(head)
            assert (back.trace_id, back.span_id) == (trace_id, span_id)
            raw = ctx.to_bytes()
            again = impl.tracing.TraceContext.from_bytes(raw)
            assert (again.trace_id, again.span_id) == (trace_id, span_id)
            heads.append(head)
            raws.append(raw)
        assert heads[0] == heads[1] and raws[0] == raws[1] and len(raws[0]) == 24


@pytest.mark.parametrize("header", [
    None, "", 7, "garbage", "00-abc-def-01", "00-" + "0" * 32 + "-" + "0" * 16,
    "00-" + "g" * 32 + "-" + "0" * 16 + "-01", "00-" + "0" * 32 + "-" + "z" * 16 + "-01",
    "00-" + "0" * 31 + "-" + "0" * 16 + "-01", "00-" + "0" * 32 + "-" + "0" * 17 + "-01",
    "00-" + "0" * 32 + "-" + "0" * 16 + "-01-extra"])
def test_malformed_traceparent_rejected_alike(header):
    for impl in IMPLS.values():
        assert impl.tracing.TraceContext.from_traceparent(header) is None


def test_bad_bytes_and_non_hex_contexts_alike():
    for impl in IMPLS.values():
        TC = impl.tracing.TraceContext
        assert TC.from_bytes(b"\x00" * 23) is None and TC.from_bytes(b"\x00" * 25) is None
        assert TC("zz" * 16, "00" * 8).to_bytes() is None


def _store_sequence(impl):
    store = impl.tracing.TraceStore(capacity=3)
    for i in range(30):
        tid = f"{i:032x}"
        store.open(tid, t0=100.0)
        store.add_span(tid, impl.tracing.Span("ingress", "spout", f"{i:016x}", None,
                                              100.0 + i * 1e-3, 0.5, {"offset": i}))
        if i % 5 == 4:
            store.finish(tid, 1.0 + i)
    store.add_span("f" * 32, impl.tracing.Span("egress", "sink", "e" * 16, "d" * 16,
                                               99.0, 2.0, None, ("a" * 16,)))
    rows = []
    for rec in store.recent(10) + store.slowest(2) + store.open_records(20):
        rows.append({k: v for k, v in rec.items() if k != "opened_at"})
    return store.stats(), rows, store.get(f"{29:032x}") is not None


def test_trace_store_bounds_alike():
    jax_out, port_out = (_store_sequence(IMPLS[k]) for k in ("storm_tpu", "port"))
    assert jax_out == port_out
    stats = port_out[0]
    assert stats["done"] == 3 and stats["open"] <= 4 * 3 and stats["dropped"] > 0


def _flight_sequence(impl, path):
    fr = impl.tracing.FlightRecorder(path=path, capacity=16, max_bytes=4096, max_files=2)
    took = []
    for i in range(40):
        took.append(fr.event("batch_formed", component="infer", size=i,
                             fill=round(i / 40, 3)))
    took.append(fr.event("slo_breach", throttle_s=30.0, e2e_ms=12.5))
    took.append(fr.event("slo_breach", throttle_s=30.0, e2e_ms=13.5))
    for i in range(60):
        fr.event("shed_decision", component="infer", level=(0, 1), inbox_frac=0.5 + i)
    tail = [{k: v for k, v in ev.items() if k != "ts"} for ev in fr.tail(100)]
    fr.close()
    return took, tail


def test_flight_recorder_ring_throttle_rotation_alike(tmp_path, monkeypatch):
    # Both recorders write ``round(time.time(), 3)`` into each line, and a
    # stamp's length moves where a file rotates: one clock for both.
    monkeypatch.setattr(time, "time", lambda: 1_760_000_000.125)
    outs = {}
    for name, impl in IMPLS.items():
        d = tmp_path / name
        d.mkdir()
        took, tail = _flight_sequence(impl, str(d / "flight.jsonl"))
        files = sorted(os.listdir(d))
        lines = []
        for f in sorted(files, reverse=True):  # oldest generation first
            with open(d / f) as fh:
                lines += [{k: v for k, v in json.loads(ln).items() if k != "ts"} for ln in fh]
        outs[name] = (took, tail, files, lines)
    assert outs["storm_tpu"] == outs["port"]
    took, tail, files, lines = outs["port"]
    assert took[-2:] == [True, False]  # the second breach inside the window
    assert len(tail) == 16  # the ring
    assert files == ["flight.jsonl", "flight.jsonl.1"]  # rotated, two kept
    assert all(os.path.getsize(tmp_path / "port" / f) <= 4096 for f in files)
    assert lines[-1]["inbox_frac"] == tail[-1]["inbox_frac"] and lines[-1]["level"] == [0, 1]


def test_flight_recorder_survives_a_bad_path(tmp_path):
    for impl in IMPLS.values():
        fr = impl.tracing.FlightRecorder(path=str(tmp_path / "missing" / "f.jsonl"))
        assert fr.event("tree_timeout", topology="t", trees=2)
        assert fr.tail(1)[0]["trees"] == 2
        fr.close()


def test_seeded_tracer_repeats_its_ids():
    a, b = port_tracing.Tracer(1.0, seed=7), port_tracing.Tracer(1.0, seed=7)
    ids_a = [(c.trace_id, c.span_id) for c in (a.maybe_trace() for _ in range(4))]
    ids_b = [(c.trace_id, c.span_id) for c in (b.maybe_trace() for _ in range(4))]
    assert ids_a == ids_b and len(set(ids_a)) == 4
    half = port_tracing.Tracer(0.5, seed=3)
    hits = sum(half.maybe_trace() is not None for _ in range(2000))
    assert 900 < hits < 1100


# ---- a lenet5 topology through both packages ---------------------------------


def _payload(i):
    x = np.random.RandomState(i).rand(1, *SHAPE).astype(np.float32)
    return json.dumps({"instances": x.tolist()})


async def _serve(impl, n, sample_rate, flight_path="", slo_ms=0.0):
    cfg = impl.config.Config()
    cfg.tracing.sample_rate = sample_rate
    cfg.tracing.flight_path = flight_path
    cfg.tracing.slo_ms = slo_ms
    model = impl.config.ModelConfig(name="lenet5", dtype="float32", num_classes=10,
                                    input_shape=SHAPE)
    batch = impl.config.BatchConfig(max_batch=4, buckets=(4,), max_wait_ms=20)
    if impl.name == "storm_tpu":
        bolt = jax_infer.InferenceBolt(model, batch, jax_config.ShardingConfig(data_parallel=1))
    else:
        bolt = port_infer.InferenceBolt(model, batch, device="cpu")
    c = impl.connectors
    broker = c.MemoryBroker(default_partitions=2)
    tb = impl.runtime.TopologyBuilder()
    tb.set_spout("kafka-spout", c.BrokerSpout(
        broker, "input", impl.config.OffsetsConfig(policy="earliest", max_behind=None)),
        parallelism=2)
    tb.set_bolt("inference-bolt", bolt, parallelism=4).shuffle_grouping("kafka-spout")
    tb.set_bolt("kafka-bolt", c.BrokerSink(broker, "output", cfg.sink),
                parallelism=2).shuffle_grouping("inference-bolt")
    tb.set_bolt("dlq-bolt", c.BrokerSink(broker, "dead-letter", cfg.sink)) \
        .shuffle_grouping("inference-bolt", stream="dead_letter")
    cluster = impl.cluster.AsyncLocalCluster()
    rt = await cluster.submit("traced", cfg, tb.build())
    for i in range(n):
        broker.produce("input", _payload(i))
        if i == n // 2:
            broker.produce("input", '{"instances": [[1.0, 2.0], [3.0]]}')
    deadline = asyncio.get_running_loop().time() + 60
    while broker.topic_size("output") + broker.topic_size("dead-letter") < n + 1:
        assert asyncio.get_running_loop().time() < deadline, "records stuck"
        await asyncio.sleep(0.01)
    await rt.drain(timeout_s=30)
    traces = rt.tracer.store.recent(4 * n)
    stats = rt.tracer.store.stats()
    exemplar = rt.metrics.histogram("kafka-bolt", "e2e_latency_ms").exemplar
    flight = rt.flight.tail(100)
    await cluster.shutdown()
    return traces, stats, exemplar, flight


def _shape(trace, names_by_id) -> tuple:
    """A trace's structure without times: per span its name, component,
    its parent's name (``root`` for the trace's own context) and the
    names of the spans it links to, and its attribute keys."""
    own = {s["span_id"]: s for s in trace["spans"]}
    rows = []
    for s in trace["spans"]:
        parent = own[s["parent_id"]]["name"] if s["parent_id"] in own else "root"
        links = tuple(sorted(names_by_id.get(i, "?") for i in s.get("links", ())))
        rows.append((s["name"], s["component"], parent,
                     tuple(sorted(set(links))), tuple(sorted(s.get("attrs", {})))))
    return tuple(sorted(rows))


def test_lenet5_traces_have_the_same_structure(run):
    shapes = {}
    for name, impl in IMPLS.items():
        clear_engine_caches()
        traces, stats, exemplar, _ = run(_serve(impl, 12, 1.0), timeout=120)
        assert stats["done"] == 13 and stats["open"] == 0, (name, stats)
        names_by_id = {s["span_id"]: s["name"] for t in traces for s in t["spans"]}
        shapes[name] = sorted(_shape(t, names_by_id) for t in traces)
        assert exemplar is not None and exemplar[0] in {t["trace_id"] for t in traces}
        for t in traces:
            dev = [s for s in t["spans"] if s["name"] == "device_execute"]
            for s in dev:
                # linked to every member's queue_wait, one per record
                assert len(s["links"]) == s["attrs"]["records"], name
                assert all(names_by_id[i] == "queue_wait" for i in s["links"])
    assert shapes["storm_tpu"] == shapes["port"]
    served = [s for s in shapes["port"] if any(r[0] == "device_execute" for r in s)]
    assert len(served) == 12
    names = sorted(r[0] for r in served[0])
    assert names == ["device_execute", "egress", "execute", "execute", "ingress",
                     "queue_wait"]


def test_sampling_off_attaches_no_trace(run, monkeypatch, tmp_path):
    clear_engines()
    made = []
    init = port_tracing.TraceContext.__init__

    def counting(self, *a):
        made.append(1)
        init(self, *a)

    monkeypatch.setattr(port_tracing.TraceContext, "__init__", counting)
    traces, stats, exemplar, flight = run(_serve(IMPLS["port"], 6, 0.0,
                                                 str(tmp_path / "f.jsonl"), slo_ms=1e-3),
                                          timeout=120)
    assert not made and not traces and stats["open"] == 0 and exemplar is None
    # the flight recorder runs with sampling off
    kinds = {ev["kind"] for ev in flight}
    assert {"batch_formed", "graph_capture", "slo_breach"} <= kinds
    breach = next(ev for ev in flight if ev["kind"] == "slo_breach")
    assert breach["trace_id"] is None and breach["slo_ms"] == 1e-3
    with open(tmp_path / "f.jsonl") as fh:
        assert [json.loads(ln)["kind"] for ln in fh] == [ev["kind"] for ev in flight]


class _Unacked(port_runtime.Bolt):
    """Takes every tuple and never acks it."""

    async def execute(self, t):
        pass


def test_timed_out_trees_reach_the_flight_recorder(run):
    async def go():
        cfg = port_config.Config()
        cfg.topology.message_timeout_s = 0.3
        broker = port_connectors.MemoryBroker()
        tb = port_runtime.TopologyBuilder()
        tb.set_spout("spout", port_connectors.BrokerSpout(
            broker, "in", port_config.OffsetsConfig(policy="earliest", max_behind=None)))
        tb.set_bolt("hole", _Unacked()).shuffle_grouping("spout")
        cluster = port_cluster.AsyncLocalCluster()
        rt = await cluster.submit("lossy", cfg, tb.build())
        broker.produce("in", "x")
        for _ in range(300):
            if any(ev["kind"] == "tree_timeout" for ev in rt.flight.tail()):
                break
            await asyncio.sleep(0.01)
        events = rt.flight.tail()
        await cluster.shutdown()
        return events

    events = run(go(), timeout=30)
    ev = next(ev for ev in events if ev["kind"] == "tree_timeout")
    assert ev["topology"] == "lossy" and ev["trees"] >= 1


def test_device_trace_writes_a_chrome_trace(tmp_path):
    import torch

    with port_tracing.device_trace(str(tmp_path / "trace")):
        torch.mm(torch.ones(8, 8), torch.ones(8, 8))
    with open(tmp_path / "trace" / "trace.json") as fh:
        doc = json.load(fh)
    assert any(ev.get("name") == "aten::mm" for ev in doc["traceEvents"])


def test_histogram_values_and_windows():
    from storm_tpu_torch.runtime.metrics import Histogram

    h = Histogram(capacity=4)
    assert h.window("a")["count"] == 0  # primes
    for v in range(6):
        h.observe(float(v), trace_id="t" if v == 5 else None)
    assert h.values().tolist() == [2.0, 3.0, 4.0, 5.0]  # oldest first, last 4
    assert h.exemplar[:2] == ("t", 5.0)
    w = h.window("a")
    assert (w["count"], w["sum"]) == (6, 15.0) and h.window_keys() == ("a",)
    assert h.drop_window("a") and not h.drop_window("a")
