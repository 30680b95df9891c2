"""The port's live model swap (``TopologyRuntime.swap_model``,
``InferenceBolt.swap_model``) on the CPU:

- canary, promote and rollback under a running 1/4/1 topology, from
  ``lenet5_rgb_digits`` to ``vit_tiny_digits`` and back, in waves: each
  wave served by the model it should be (the canary wave by both), no
  record lost or duplicated, and the rollback building nothing;
- ``component_stats``' per-task model descriptors equal storm_tpu's for
  the same configs;
- ROADMAP C7: under ``continuous=True`` storm_tpu's task goes on serving
  the old model after a swap (its queue still points at the old engine),
  and the port's serves the new one;
- after a swap the task follows the new engine's quarantine (replaced by
  the new model) and ignores the old engine's;
- the engine cache's budget does not evict an engine while a batch is in
  flight on it.

Every thread a test starts is joined with a timeout.
"""

from __future__ import annotations

import asyncio
import gc
import json
import threading
import time
from types import SimpleNamespace

import numpy as np
import pytest

import storm_tpu.config as jax_config
import storm_tpu.infer.continuous as jax_continuous
import storm_tpu.infer.engine as jax_engine
import storm_tpu.infer.operator as jax_operator
import storm_tpu.runtime.base as jax_base
import storm_tpu.runtime.cluster as jax_cluster
import storm_tpu.runtime.metrics as jax_metrics
import storm_tpu.runtime.tuples as jax_tuples
import storm_tpu_torch.config as port_config
import storm_tpu_torch.infer.engine as port_engine
import storm_tpu_torch.infer.operator as port_operator
import storm_tpu_torch.runtime.base as port_base
import storm_tpu_torch.runtime.cluster as port_cluster
import storm_tpu_torch.runtime.metrics as port_metrics
import storm_tpu_torch.runtime.tuples as port_tuples
from storm_tpu_torch.api.schema import decode_predictions
from storm_tpu_torch.config import BatchConfig, Config, ModelConfig, OffsetsConfig
from storm_tpu_torch.connectors import BrokerSink, BrokerSpout, MemoryBroker
from storm_tpu_torch.data import load_digits_nhwc
from storm_tpu_torch.infer import InferenceBolt
from storm_tpu_torch.infer.continuous import _reset_registry
from storm_tpu_torch.infer.engine import (
    clear_engines, live_engines, set_engine_cache_limit, shared_engine)
from storm_tpu_torch.obs import profile_store
from storm_tpu_torch.resilience import get_injector
from storm_tpu_torch.runtime import AsyncLocalCluster, TopologyBuilder
from storm_tpu_torch.runtime.tracing import FlightRecorder
from tests.test_torch_pipeline import _Collector

DIGITS = (32, 32, 3)
LENET = {"checkpoint": "checkpoints/lenet5_rgb_digits", "name": "lenet5"}
VIT = {"checkpoint": "checkpoints/vit_tiny_digits", "name": "vit_tiny"}
TOL = 1e-4  # a row's output against its model's direct forward (float32, CPU)
IMPLS = {
    "storm_tpu": SimpleNamespace(name="storm_tpu", config=jax_config, engine=jax_engine,
                                 operator=jax_operator, base=jax_base, cluster=jax_cluster,
                                 metrics=jax_metrics, tuples=jax_tuples),
    "port": SimpleNamespace(name="port", config=port_config, engine=port_engine,
                            operator=port_operator, base=port_base, cluster=port_cluster,
                            metrics=port_metrics, tuples=port_tuples),
}


@pytest.fixture(autouse=True)
def _fresh():
    clear_engines()
    _reset_registry()
    yield
    _reset_registry()
    clear_engines()


def _join_named(name: str, timeout: float = 10.0) -> None:
    for t in [t for t in threading.enumerate() if t.name == name]:
        t.join(timeout)
        assert not t.is_alive(), f"thread {name} did not finish"


# ---- canary, promote, rollback ------------------------------------------------


def _wave_rows():
    """Four waves of distinct held-out digits rows."""
    _, _, x, _ = load_digits_nhwc(DIGITS)
    _, first = np.unique(x.reshape(len(x), -1), axis=0, return_index=True)
    x = x[np.sort(first)][:48]
    return [x[i:i + 12] for i in range(0, 48, 12)]


async def _swap_run(continuous: bool):
    base = ModelConfig.from_checkpoint("checkpoints/lenet5_rgb_digits", dtype="float32",
                                       weights="int8_fused")
    batch = BatchConfig(max_batch=8, buckets=(8,), max_wait_ms=5, continuous=continuous)
    cfg = Config()
    cfg.tracing.sample_rate = 1.0
    broker = MemoryBroker(default_partitions=1)
    tb = TopologyBuilder()
    tb.set_spout("spout", BrokerSpout(broker, "input",
                                      OffsetsConfig(policy="earliest", max_behind=None)))
    tb.set_bolt("infer", InferenceBolt(base, batch, device="cpu"),
                parallelism=4).shuffle_grouping("spout")
    tb.set_bolt("sink", BrokerSink(broker, "output", cfg.sink)).shuffle_grouping("infer")
    cluster = AsyncLocalCluster()
    rt = await cluster.submit("swap", cfg, tb.build())
    lenet_engine = rt.bolt_execs["infer"][0].bolt.engine
    waves = _wave_rows()
    outs, stats, produced = [], {}, 0

    async def wave(x):
        nonlocal produced
        start = broker.topic_size("output")
        for row in x:
            broker.produce("input", json.dumps({"instances": [row.tolist()]}))
        produced += len(x)
        deadline = asyncio.get_running_loop().time() + 60
        while broker.topic_size("output") < start + len(x):
            assert asyncio.get_running_loop().time() < deadline, "wave stuck"
            await asyncio.sleep(0.01)
        await rt.drain(timeout_s=30)
        outs.append(np.concatenate([decode_predictions(r.value).data
                                    for r in broker.drain_topic("output")[start:]]))

    await wave(waves[0])
    await rt.swap_model("infer", VIT, tasks=[0])
    stats["canary"] = rt.component_stats("infer")
    await wave(waves[1])
    await rt.swap_model("infer", VIT)
    stats["promoted"] = rt.component_stats("infer")
    vit_engine = rt.bolt_execs["infer"][0].bolt.engine
    await wave(waves[2])
    captured = set(lenet_engine.compiled_batches)
    compiles = dict(profile_store().snapshot()["engines"][lenet_engine.profile_key]["compiles"])
    captures = sum(ev["kind"] == "graph_capture" for ev in rt.flight.tail(500))
    t0 = time.perf_counter()
    await rt.swap_model("infer", LENET)
    stats["rollback_ms"] = (time.perf_counter() - t0) * 1e3
    stats["rolled_back"] = rt.component_stats("infer")
    stats["rollback_reused"] = all(e.bolt.engine is lenet_engine
                                   for e in rt.bolt_execs["infer"])
    stats["rollback_built"] = (
        set(lenet_engine.compiled_batches) != captured
        or profile_store().snapshot()["engines"][lenet_engine.profile_key]["compiles"]
        != compiles
        or sum(ev["kind"] == "graph_capture" for ev in rt.flight.tail(500)) != captures)
    await wave(waves[3])
    spout = rt.metrics.snapshot()["spout"]
    await cluster.shutdown()
    preds = {name: np.concatenate([eng.predict(x) for x in waves])
             for name, eng in (("lenet5", lenet_engine), ("vit_tiny", vit_engine))}
    return waves, outs, stats, spout, produced, preds


def _served_by(out, rows, preds, offset):
    """For each output row: the model whose direct forward of some row of
    the wave it equals (within TOL), or None."""
    who = []
    for p in out:
        hits = {name for name, ref in preds.items()
                if np.abs(ref[offset:offset + len(rows)] - p).max(axis=1).min() <= TOL}
        who.append(hits.pop() if len(hits) == 1 else None)
    return who


def _descriptor_lists(rows):
    return [r.get("model") for r in sorted(rows, key=lambda r: r["task"])]


@pytest.mark.parametrize("continuous", [False, True])
def test_canary_promote_rollback(run, continuous):
    waves, outs, stats, spout, produced, preds = run(_swap_run(continuous), timeout=180)
    assert spout["tree_acked"] == produced and spout.get("tree_failed", 0) == 0
    offset = 0
    served = []
    for x, out in zip(waves, outs):
        assert out.shape == (len(x), 10)  # none lost, none duplicated
        served.append(_served_by(out, x, preds, offset))
        offset += len(x)
    assert set(served[0]) == {"lenet5"}
    assert set(served[2]) == {"vit_tiny"}  # under continuous=True: C7 avoided
    assert set(served[3]) == {"lenet5"}
    canary = served[1]
    assert None not in canary and 0 < canary.count("vit_tiny") < len(canary)
    lenet_d = "lenet5:checkpoints/lenet5_rgb_digits:int8_fused"
    vit_d = "vit_tiny:checkpoints/vit_tiny_digits:int8_fused"
    assert _descriptor_lists(stats["canary"]) == [vit_d, lenet_d, lenet_d, lenet_d]
    assert _descriptor_lists(stats["promoted"]) == [vit_d] * 4
    assert _descriptor_lists(stats["rolled_back"]) == [lenet_d] * 4
    assert stats["rollback_reused"] and not stats["rollback_built"]


def test_component_stats_descriptors_equal_storm_tpus():
    cases = [dict(name="lenet5"), dict(name="lenet5", seed=3),
             dict(name="lenet5", checkpoint="checkpoints/lenet5_rgb_digits",
                  weights="int8_fused"),
             dict(name="vit_tiny", checkpoint="checkpoints/vit_tiny_digits", weights="int8"),
             dict(name="resnet20", checkpoint="checkpoints/resnet20_digits", seed=2)]
    rows = {}
    for name, impl in IMPLS.items():
        execs = [SimpleNamespace(task_index=i, n_executed=i, exec_ms_total=2.0 * i,
                                 n_errors=0, inbox=asyncio.Queue(),
                                 bolt=SimpleNamespace(model_cfg=impl.config.ModelConfig(**kw)))
                 for i, kw in enumerate(cases)]
        fake = SimpleNamespace(bolt_execs={"infer": execs}, spout_execs={})
        rows[name] = impl.cluster.TopologyRuntime.component_stats(fake, "infer")
    assert rows["storm_tpu"] == rows["port"]
    assert [r["model"] for r in rows["port"]] == [
        "lenet5", "lenet5:seed=3", "lenet5:checkpoints/lenet5_rgb_digits:int8_fused",
        "vit_tiny:checkpoints/vit_tiny_digits:int8", "resnet20:checkpoints/resnet20_digits:seed=2"]


# ---- C7: the continuous queue after a swap --------------------------------------


SHAPE = (28, 28, 1)


class _Tagged:
    """A dispatch-protocol engine whose every prediction is its tag."""

    input_shape = SHAPE
    ring_capacity = 1

    def __init__(self, impl, tag: float) -> None:
        self.impl, self.tag, self.rows = impl, tag, 0

    def warmup(self, buckets=None):
        pass

    def dispatch(self, parts):
        n = sum(int(p.shape[0]) for p in parts)
        self.rows += n
        h = self.impl.engine.InflightBatch(n, n)
        h.timings = {"h2d_ms": 0.1, "compute_ms": 0.1, "d2h_ms": 0.1}
        h.future.set_result(np.full((n, 10), self.tag, np.float32))
        return h


def _model(impl, **kw):
    return impl.config.ModelConfig(name="lenet5", dtype="float32", num_classes=10,
                                   input_shape=SHAPE, **kw)


def _bolt(impl, engine, continuous=True, flight=None):
    batch = impl.config.BatchConfig(max_batch=1, buckets=(1,), max_wait_ms=1,
                                    continuous=continuous)
    bolt = impl.operator.InferenceBolt(model=_model(impl), batch=batch, engine=engine,
                                       warmup=False)
    ctx = impl.base.TopologyContext("infer", 0, 1, impl.config.Config(),
                                    metrics=impl.metrics.MetricsRegistry(), flight=flight)
    coll = _Collector()
    bolt.prepare(ctx, coll)
    return bolt, coll


def _tuple(impl):
    payload = json.dumps({"instances": np.zeros((1, *SHAPE), np.float32).tolist()})
    return impl.tuples.Tuple(values=[payload], fields=("message",),
                             source_component="spout", root_ts=time.perf_counter())


async def _emitted(coll, n):
    for _ in range(500):
        if len(coll.emitted) >= n:
            return
        await asyncio.sleep(0.01)
    raise AssertionError(f"{len(coll.emitted)} of {n} records emitted")


async def _swap_under_continuous(impl, monkeypatch):
    old, new = _Tagged(impl, 0.25), _Tagged(impl, 0.75)
    bolt, coll = _bolt(impl, old)
    await bolt.execute(_tuple(impl))
    await _emitted(coll, 1)
    monkeypatch.setattr(impl.operator, "shared_engine", lambda *a, **k: new)
    await bolt.swap_model(_model(impl, seed=1))
    await bolt.execute(_tuple(impl))
    await _emitted(coll, 2)
    await bolt.flush()
    served = json.loads(coll.emitted[1][1][0])["predictions"][0][0]
    queues = bolt._cbs.values() if impl.name == "storm_tpu" else [bolt._cb]
    threads = [cb._thread for cb in queues if cb._thread is not None]
    for cb in queues:
        cb.close()
    for t in threads:
        t.join(10)
        assert not t.is_alive()
    return {"engine_is_new": bolt.engine is new, "old_rows": old.rows,
            "new_rows": new.rows, "second_record_served_by": served,
            "acked": len(coll.acked)}


def test_c7_storm_tpu_keeps_serving_the_old_model_the_port_does_not(run, monkeypatch):
    # storm_tpu's queue registry deadlocks if a collection runs a dead
    # engine's finalizer while it holds its lock (ROADMAP C3): no
    # collection runs during its part, and its engines die here.
    gc.collect()
    gc.disable()
    try:
        jax_out = run(_swap_under_continuous(IMPLS["storm_tpu"], monkeypatch), timeout=60)
        monkeypatch.undo()
        jax_continuous._reset_registry()
    finally:
        gc.collect()
        gc.enable()
    port_out = run(_swap_under_continuous(IMPLS["port"], monkeypatch), timeout=60)
    # storm_tpu: the task reports the new engine, the old one served
    assert jax_out == {"engine_is_new": True, "old_rows": 2, "new_rows": 0,
                       "second_record_served_by": 0.25, "acked": 2}
    # the port: the queue followed the swap
    assert port_out == {"engine_is_new": True, "old_rows": 1, "new_rows": 1,
                        "second_record_served_by": 0.75, "acked": 2}


@pytest.mark.parametrize("continuous", [False, True])
def test_quarantine_follows_the_swapped_in_engine(run, monkeypatch, continuous):
    impl = IMPLS["port"]
    old, new, replacement = (_Tagged(impl, v) for v in (0.25, 0.75, 0.5))
    built = []

    def fake_shared_engine(model_cfg, batch_cfg=None, device=None, sharding_cfg=None):
        built.append(model_cfg)
        return new if len(built) == 1 else replacement

    flight = FlightRecorder()

    async def go():
        bolt, coll = _bolt(impl, old, continuous=continuous, flight=flight)
        monkeypatch.setattr(port_operator, "shared_engine", fake_shared_engine)
        swapped = _model(impl, seed=1)
        await bolt.swap_model(swapped)
        # the old engine's quarantine no longer reaches the task
        old.on_quarantine(2)
        assert bolt.engine is new and len(built) == 1
        # the new engine's does: the replacement serves the swapped-in model
        new.on_quarantine(2)
        for _ in range(500):
            if bolt.engine is replacement:
                break
            await asyncio.sleep(0.01)
        _join_named("engine-replace")
        assert bolt.engine is replacement and built[-1] is swapped
        assert isinstance(replacement.on_quarantine, port_operator._QuarantineFanout)
        await bolt.execute(_tuple(impl))
        await _emitted(coll, 1)
        await bolt.flush()
        assert json.loads(coll.emitted[0][1][0])["predictions"][0][0] == 0.5
        assert replacement.rows == 1 and new.rows == 0 and old.rows == 0
        events = [(ev["kind"], ev.get("trips")) for ev in flight.tail(10)
                  if ev["kind"].startswith("engine_")]
        assert events == [("engine_quarantined", 2), ("engine_replaced", None)]
        # each engine the task served got its cold-build hook
        assert new.on_compile is replacement.on_compile is not None

    run(go(), timeout=60)


def test_budget_keeps_an_engine_with_a_batch_in_flight():
    batch = BatchConfig(max_batch=4, buckets=(4,))
    cfgs = [ModelConfig(name="lenet5", dtype="float32", num_classes=10, input_shape=SHAPE,
                        seed=s) for s in (1, 2, 3)]
    inj = get_injector()
    try:
        a = shared_engine(cfgs[0], batch, device="cpu")
        a.warmup()
        # The batch must still be in flight when the next engine's build
        # (seconds under a loaded test run) evicts: a hang of 3 s.
        inj.configure(engine_hang_ms=3000, engine_hang_next=1)
        h = a.dispatch((np.zeros((4, *SHAPE), np.float32),))
        a_id = id(a)
        del a
        set_engine_cache_limit(1)  # every orphan over budget
        shared_engine(cfgs[1], batch, device="cpu")
        assert a_id in {id(e) for e in live_engines()}, "evicted with a batch in flight"
        h.future.result(timeout=30)
        shared_engine(cfgs[2], batch, device="cpu")
        assert a_id not in {id(e) for e in live_engines()}, "an orphan stayed over budget"
    finally:
        inj.configure(engine_hang_ms=0, engine_hang_next=0)
        set_engine_cache_limit(None)


def test_fetch_thread_unpins_the_engine_before_the_result(monkeypatch):
    """ROADMAP C12: the fetch thread settles a batch (watchdog note,
    buffers, ring slot, the handle's engine pin) before its future
    resolves. ``_notify_done`` is made to take 0.3 s: had the future
    resolved first, the caller below would ask the cache for another
    model while the fetch thread still pinned the old engine, and the
    orphan would stay over budget."""
    batch = BatchConfig(max_batch=4, buckets=(4,))
    cfgs = [ModelConfig(name="lenet5", dtype="float32", num_classes=10, input_shape=SHAPE,
                        seed=s) for s in (4, 5, 6)]
    notify = port_engine._notify_done

    def slow_notify(handle, exc):
        time.sleep(0.3)
        notify(handle, exc)

    monkeypatch.setattr(port_engine, "_notify_done", slow_notify)
    inj = get_injector()
    try:
        a = shared_engine(cfgs[0], batch, device="cpu")
        a.warmup()
        inj.configure(engine_hang_ms=500, engine_hang_next=1)
        h = a.dispatch((np.zeros((4, *SHAPE), np.float32),))
        a_id = id(a)
        del a
        set_engine_cache_limit(1)
        shared_engine(cfgs[1], batch, device="cpu")
        assert a_id in {id(e) for e in live_engines()}, "evicted with a batch in flight"
        rows = h.future.result(timeout=30)
        assert rows.shape == (4, 10) and h._owner is None and h.on_done is None
        shared_engine(cfgs[2], batch, device="cpu")
        assert a_id not in {id(e) for e in live_engines()}, "an orphan stayed over budget"
    finally:
        inj.configure(engine_hang_ms=0, engine_hang_next=0)
        set_engine_cache_limit(None)
