"""The port's shared-engine cache and eager dispatch against storm_tpu's on
the CPU: the counterparts of ``tests/test_infer.py``'s inventory of
co-resident models, unload and LRU eviction under a byte budget,
concurrent requests building once, and eager (work-conserving) dispatch,
each run on the same call sequence through storm_tpu and the port (the
``impl`` fixture). Every thread a test starts is joined with a timeout.
"""

import asyncio
import gc
import json
import threading
import time
from types import SimpleNamespace

import numpy as np
import pytest
import torch

import storm_tpu.config as jax_config
import storm_tpu.infer.engine as jax_engine
import storm_tpu.infer.operator as jax_operator
import storm_tpu.runtime as jax_runtime
import storm_tpu.runtime.cluster as jax_cluster
import storm_tpu_torch.config as port_config
import storm_tpu_torch.infer.engine as port_engine
import storm_tpu_torch.infer.operator as port_operator
import storm_tpu_torch.runtime as port_runtime

SHAPE = (28, 28, 1)
IMPLS = {
    "storm_tpu": SimpleNamespace(name="storm_tpu", config=jax_config, engine=jax_engine,
                                 operator=jax_operator, runtime=jax_runtime,
                                 cluster=jax_cluster.AsyncLocalCluster),
    "port": SimpleNamespace(name="port", config=port_config, engine=port_engine,
                            operator=port_operator, runtime=port_runtime,
                            cluster=port_runtime.AsyncLocalCluster),
}


@pytest.fixture(params=sorted(IMPLS))
def impl(request):
    return IMPLS[request.param]


def _model(impl, name="lenet5", shape=SHAPE, **kw):
    return impl.config.ModelConfig(name=name, dtype="float32", num_classes=10,
                                   input_shape=shape, **kw)


def _shared(impl, model, batch):
    if impl.name == "storm_tpu":
        return jax_engine.shared_engine(model, jax_config.ShardingConfig(data_parallel=1),
                                        batch)
    return port_engine.shared_engine(model, batch, device="cpu")


def test_engine_inventory_tracks_coresident_models(impl):
    """engine_inventory sums the weight bytes of the process's live
    engines: the budget of co-resident models."""
    bc = impl.config.BatchConfig(max_batch=4, buckets=(4,))
    e1 = _shared(impl, _model(impl), bc)
    e2 = _shared(impl, _model(impl, shape=(32, 32, 3)), bc)  # lenet5_rgb's shape
    assert e1 is not e2
    inv = impl.engine.engine_inventory()
    assert sum(r["model"] == "lenet5" for r in inv["engines"]) >= 2
    assert e1.param_bytes() > 100_000  # lenet5 f32: a few hundred KB
    assert inv["total_param_bytes"] >= e1.param_bytes() + e2.param_bytes()
    assert all(r["param_bytes"] > 0 for r in inv["engines"])
    assert e1.param_bytes_per_device() == e1.param_bytes()
    live = impl.engine.live_engines()
    assert any(e is e1 for e in live) and any(e is e2 for e in live)
    for e in (e1, e2):
        impl.engine.unload_engine(e)


def test_engine_cache_unload_and_lru_eviction(impl):
    """Under a byte budget the least recently used ORPHAN is evicted on
    insert (a referenced engine is kept: evicting it would free nothing
    and force a duplicate build); unload_engine drops one engine."""
    mod = impl.engine
    bc = impl.config.BatchConfig(max_batch=4, buckets=(4,))

    def eng(seed):
        return _shared(impl, _model(impl, seed=seed), bc)

    def cached_seeds():
        return {k[6] for k in mod._ENGINES}  # the seed's place in the key

    gc.collect()
    try:
        e1 = eng(101)
        if impl.name == "port":
            e1.warmup()  # a built bucket must not pin the engine by a cycle
        mod.set_engine_cache_limit(e1.param_bytes() + 1)
        e2 = eng(102)
        assert e1 in list(mod._ENGINES.values())  # referenced -> kept
        assert e2 in list(mod._ENGINES.values())
        del e1
        e3 = eng(103)
        cached = list(mod._ENGINES.values())
        assert e2 in cached and e3 in cached
        assert 101 not in cached_seeds()  # the orphan was evicted
        assert eng(102) is e2  # a hit returns the same object
        assert mod.unload_engine(e2) is True
        assert e2 not in list(mod._ENGINES.values())
        assert mod.unload_engine(e2) is False
        mod.unload_engine(e3)
    finally:
        mod.set_engine_cache_limit(None)


def test_shared_engine_concurrent_requests_build_once(impl, monkeypatch):
    """N tasks asking for one engine at once cost ONE build; the others
    wait on it."""
    mod = impl.engine
    builds = []
    orig_init = mod.InferenceEngine.__init__

    def counting_init(self, *a, **kw):
        builds.append(threading.get_ident())
        time.sleep(0.2)  # widen the race window
        orig_init(self, *a, **kw)

    monkeypatch.setattr(mod.InferenceEngine, "__init__", counting_init)
    results = []
    bc = impl.config.BatchConfig(max_batch=4, buckets=(4,))
    threads = [threading.Thread(
        target=lambda: results.append(_shared(impl, _model(impl, seed=201), bc)),
        daemon=True) for _ in range(4)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(30)
    assert not any(t.is_alive() for t in threads)
    assert len(builds) == 1 and len(results) == 4
    assert all(r is results[0] for r in results)
    mod.unload_engine(results[0])


def test_cache_key_holds_the_ring_and_pool(impl):
    """Two batch policies that differ only in pipeline depth or staging
    pool get engines of their own."""
    cfgs = [impl.config.BatchConfig(max_batch=4, buckets=(4,), **kw)
            for kw in ({}, {"pipeline_depth": 0}, {"staging_pool": 5})]
    engines = [_shared(impl, _model(impl, seed=301), c) for c in cfgs]
    assert len({id(e) for e in engines}) == 3
    assert [e.pipeline_depth for e in engines] == [2, 0, 2]
    assert engines[2].staging_stats()["limit"] == 5
    for e in engines:
        impl.engine.unload_engine(e)


def test_port_cache_limit_is_the_cards_memory():
    """No budget on the CPU; on a card 85 % of its memory."""
    assert port_engine._cache_limit(torch.device("cpu")) is None
    port_engine.set_engine_cache_limit(1234)
    try:
        assert port_engine._cache_limit(torch.device("cpu")) == 1234
    finally:
        port_engine.set_engine_cache_limit(None)


def test_eager_dispatch_low_latency_and_batching_under_load(impl, run):
    """eager=True: an idle device gets records at once (no max_wait
    aging)."""
    rt_mod = impl.runtime

    class TwoShotSpout(rt_mod.Spout):
        def open(self, ctx, col):
            super().open(ctx, col)
            self.sent = 0

        async def next_tuple(self):
            if self.sent >= 2:
                return False
            self.sent += 1
            await self.collector.emit(rt_mod.Values([json.dumps(
                {"instances": np.zeros((1, *SHAPE)).tolist()})]), msg_id=self.sent)
            return True

    async def go():
        tb = rt_mod.TopologyBuilder()
        tb.set_spout("s", TwoShotSpout(), 1)
        # A huge deadline: only eager dispatch can flush these records fast.
        batch = impl.config.BatchConfig(max_batch=64, max_wait_ms=30_000.0, buckets=(64,),
                                        eager=True)
        kw = {} if impl.name == "storm_tpu" else {"device": "cpu"}
        tb.set_bolt("infer", impl.operator.InferenceBolt(_model(impl), batch, **kw),
                    1).shuffle_grouping("s")
        cluster = impl.cluster()
        rt = await cluster.submit("eager", impl.config.Config(), tb.build())
        t0 = time.perf_counter()
        for _ in range(100):
            done = rt.metrics.snapshot()["infer"].get("instances_inferred", 0)
            if done >= 2:
                break
            await asyncio.sleep(0.1)
        dt = time.perf_counter() - t0
        await cluster.shutdown()
        assert done >= 2, f"only {done} inferred"
        assert dt < 15.0, f"eager dispatch should beat the 30 s deadline, took {dt:.1f} s"

    run(go(), timeout=120)


def test_eager_pending_restored_on_cancelled_dispatch(impl, run):
    """An eager dispatch task cancelled during shutdown, whether parked on
    the device-slot semaphore or before its first step, still decrements
    _eager_pending, or eager dispatch would stay off for the bolt."""

    class FakeBatcher:
        def __len__(self):
            return 1

        def take_all(self):
            return "batch"  # never reaches the engine: the task is cancelled

    def skeleton(slots):
        bolt = object.__new__(impl.operator.InferenceBolt)
        bolt._eager = True
        bolt._eager_pending = 0
        bolt._dispatch_sem = asyncio.Semaphore(slots)
        bolt._inflight = set()
        bolt._flush_task = None
        bolt.batcher = FakeBatcher()
        if impl.name == "storm_tpu":
            bolt._sources = [(None, bolt.batcher)]
        return bolt

    async def main():
        bolt = skeleton(slots=1)  # cancelled before its first step
        bolt._kick_flush()
        assert bolt._eager_pending == 1
        task = next(iter(bolt._inflight))
        task.cancel()
        await asyncio.gather(task, return_exceptions=True)
        assert bolt._eager_pending == 0

        bolt = skeleton(slots=1)  # cancelled while parked on the semaphore
        bolt._kick_flush()
        assert bolt._eager_pending == 1
        await bolt._dispatch_sem.acquire()  # steal the slot
        task = next(iter(bolt._inflight))
        await asyncio.sleep(0.01)
        task.cancel()
        await asyncio.gather(task, return_exceptions=True)
        assert bolt._eager_pending == 0

    run(main(), timeout=10)
