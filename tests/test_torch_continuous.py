"""The port's continuous batching (``storm_tpu_torch/infer/continuous.py``)
on the CPU: the cases of ``tests/test_continuous.py`` that need neither
the cascade nor the serve path, and a regression test of storm_tpu's
registry self-deadlock (ROADMAP C3).

Batch formation (weighted round-robin, the starvation bound, lane
preemption, a seeded mixed sequence) runs through storm_tpu's
``ContinuousBatcher`` and the port's on the same submissions and must take
the same records in the same order; storm_tpu's registry is not called
here (its lock is the C3 deadlock). The queue's dispatch (slot refill,
idle aging), the registry's identity and close on eviction, exactly-once
per source on a failed coalesced batch, and ``batch_fill`` and
``coalesced_sources`` on both dispatch paths run on the port with an
engine whose batches the test resolves. Every thread a test starts is
joined with a timeout; every queue is closed after each test.
"""

from __future__ import annotations

import asyncio
import gc
import threading
import time
from collections import deque
from types import SimpleNamespace

import numpy as np
import pytest

import storm_tpu.config as jax_config
import storm_tpu.infer.continuous as jax_continuous
import storm_tpu.qos.lanes as jax_lanes
import storm_tpu_torch.config as port_config
import storm_tpu_torch.infer.continuous as port_continuous
import storm_tpu_torch.qos.lanes as port_lanes
from storm_tpu_torch.config import BatchConfig, Config, ModelConfig
from storm_tpu_torch.infer.continuous import (
    ContinuousBatcher, _reset_registry, continuous_for, registry_stats)
from storm_tpu_torch.infer.engine import InflightBatch
from storm_tpu_torch.infer.operator import InferenceBolt
from storm_tpu_torch.runtime.base import TopologyContext
from storm_tpu_torch.runtime.metrics import MetricsRegistry
from tests.test_torch_pipeline import IMPLS as PIPELINE_IMPLS
from tests.test_torch_pipeline import _Collector, _tuple

SHAPE = (28, 28, 1)
IMPLS = {
    "storm_tpu": SimpleNamespace(name="storm_tpu", config=jax_config,
                                 continuous=jax_continuous, lanes=jax_lanes),
    "port": SimpleNamespace(name="port", config=port_config,
                            continuous=port_continuous, lanes=port_lanes),
}


@pytest.fixture(autouse=True)
def _fresh_registry():
    _reset_registry()
    yield
    _reset_registry()


class _SlotEngine:
    """A dispatch-protocol engine whose batches the TEST resolves;
    ``pad_to`` mimics a bucket, so a fill below 1 shows."""

    input_shape = SHAPE

    def __init__(self, capacity: int = 1, pad_to: int = 0) -> None:
        self.ring_capacity = capacity
        self.pad_to = pad_to
        self.handles = []
        self.sizes = []  # rows per part, per dispatch

    def warmup(self, buckets=None):
        pass

    def dispatch(self, parts):
        n = sum(int(p.shape[0]) for p in parts)
        h = InflightBatch(n, max(self.pad_to, n) if self.pad_to else n)
        self.handles.append(h)
        self.sizes.append([int(p.shape[0]) for p in parts])
        return h


def _resolve(h, v=0.1):
    h.future.set_result(np.full((h.n, 10), v, np.float32))


def _wait(cond, timeout=5.0, msg="condition not met in time"):
    t0 = time.perf_counter()
    while not cond():
        assert time.perf_counter() - t0 < timeout, msg
        time.sleep(0.002)


async def _until(cond, timeout=5.0, msg="condition not met in time"):
    t0 = time.perf_counter()
    while not cond():
        assert time.perf_counter() - t0 < timeout, msg
        await asyncio.sleep(0.005)


def _rows(n=1, c=0.0):
    return np.full((n, *SHAPE), c, np.float32)


def _bolt(engine, metrics=None, task_index=0, **batch_kw):
    bolt = InferenceBolt(ModelConfig(name="lenet5", dtype="float32", input_shape=SHAPE,
                                     num_classes=10),
                         BatchConfig(**batch_kw), engine=engine, warmup=False)
    ctx = TopologyContext("inference-bolt", task_index, 1, Config(),
                          metrics=metrics or MetricsRegistry())
    coll = _Collector()
    bolt.prepare(ctx, coll)
    return bolt, coll


def _port_tuple():
    return _tuple(PIPELINE_IMPLS["port"])


# ---- the queue: slot refill, deadline aging ----------------------------------------


def test_slot_refill_on_free_dispatches_immediately():
    """Rows that arrive while the card works ship the moment a slot frees:
    with a 10 s deadline only the refill explains the second batch."""
    eng = _SlotEngine(capacity=1)
    cb = continuous_for(eng, BatchConfig(max_batch=8, buckets=(8,), max_wait_ms=10_000,
                                         eager=True, continuous=True))
    a = cb.submit(_rows(), source="s1")
    _wait(lambda: len(eng.handles) == 1)
    b = cb.submit(_rows(), source="s1")
    c = cb.submit(_rows(), source="s2")
    time.sleep(0.05)
    assert len(eng.handles) == 1, "slot busy: later rows must coalesce, not dispatch"
    _resolve(eng.handles[0])
    _wait(lambda: len(eng.handles) == 2, msg="a freed slot must refill before the deadline")
    assert eng.sizes[1] == [1, 1], "both queued records ship in one refill batch"
    _resolve(eng.handles[1])
    for sub in (a, b, c):
        assert sub.future.result(timeout=5).shape == (1, 10)
    assert cb.last_batch["sources"] == ["s1", "s2"]


def test_idle_non_eager_ages_to_deadline():
    eng = _SlotEngine(capacity=1)
    cb = continuous_for(eng, BatchConfig(max_batch=8, buckets=(8,), max_wait_ms=50.0,
                                         eager=False, continuous=True))
    t0 = time.perf_counter()
    sub = cb.submit(_rows(), source="s1")
    time.sleep(0.01)
    assert not eng.handles, "idle and not eager: wait for the deadline"
    _wait(lambda: eng.handles)
    assert time.perf_counter() - t0 >= 0.045
    _resolve(eng.handles[0])
    assert sub.future.result(timeout=5).shape == (1, 10)


# ---- formation, held to storm_tpu's ------------------------------------------------


def _manual_cb(impl, cfg_kw, qos=True):
    """A queue whose dispatcher never starts: formation driven directly."""
    q = impl.config.QosConfig(enabled=True) if qos else None
    return impl.continuous.ContinuousBatcher(
        _SlotEngine(), impl.config.BatchConfig(**cfg_kw), q)


def _enqueue(impl, cb, rows, lane, tenant, ts, payload=None, source="s"):
    sub = impl.continuous.Submission(_rows(rows), payload, ts, ts, lane, tenant, source,
                                     ts + cb._deadline_ms(lane) / 1e3)
    cb._queues.setdefault(cb._key(tenant, lane), deque()).append(sub)
    cb._pending_rows += sub.rows
    return sub


def _both(fn):
    got = {name: fn(i) for name, i in IMPLS.items()}
    assert got["port"] == got["storm_tpu"], got
    return got["port"]


def test_weighted_round_robin_across_lanes():
    def form(i):
        cb = _manual_cb(i, dict(max_batch=4, buckets=(4,)))
        for _ in range(4):
            _enqueue(i, cb, 1, "high", "gold", 1.0)
        for _ in range(4):
            _enqueue(i, cb, 1, "best_effort", "brz", 1.0)
        return [s.lane for s in cb._form_locked()]

    # high (weight 3) draws 3 rows a pass, best_effort (weight 1) one.
    assert _both(form) == ["high", "high", "high", "best_effort"]


def test_tenant_fairness_starvation_bound():
    def form(i):
        cb = _manual_cb(i, dict(max_batch=2, buckets=(2,), starvation_rounds=2))
        for k in range(12):
            _enqueue(i, cb, 1, "normal", "flood", 1.0, payload=f"f{k}")
        _enqueue(i, cb, 1, "normal", "quiet", 1.01, payload="quiet")
        batches = [[s.payload for s in cb._form_locked()] for _ in range(3)]
        return batches, dict(cb.fair_starved), dict(cb.fair_rows)

    batches, starved, rows = _both(form)
    assert batches[2][0] == "quiet", "the starved key leads once the bound trips"
    assert starved == {("quiet", "normal"): 1}
    assert rows == {("flood", "normal"): 5, ("quiet", "normal"): 1}


def test_lane_preemption_parity_with_lane_batcher():
    """A fresh high-priority record preempts queued best-effort ones in the
    queue as in the lane batcher's EDF heap, in both packages."""
    arrivals = [("p0", "best_effort"), ("p1", "best_effort"), ("p2", "high")]

    def form(i):
        qos = i.config.QosConfig(enabled=True)
        lb = i.lanes.LaneBatcher(i.config.BatchConfig(max_batch=3, buckets=(3,)), qos)
        got = None
        for name, lane in arrivals:
            got = lb.add(name, _rows(), ts=1.0, lane=lane) or got
        cb = _manual_cb(i, dict(max_batch=3, buckets=(3,)))
        for name, lane in arrivals:
            _enqueue(i, cb, 1, lane, None, 1.0, payload=name)
        return [it.payload for it in got.items], [s.payload for s in cb._form_locked()]

    assert _both(form) == (["p2", "p0", "p1"], ["p2", "p0", "p1"])


@pytest.mark.parametrize("qos", [True, False])
def test_mixed_sequence_forms_as_storm_tpus(qos):
    """A seeded sequence of records over tenants, lanes, sizes and
    arrival times, formed to the end in both packages."""
    rng = np.random.RandomState(7)
    lanes = ("high", "normal", "best_effort", "bogus", None)
    seq = [(int(rng.randint(1, 5)), lanes[rng.randint(5)], ("a", "b", "c", None)[rng.randint(4)],
            1.0 + 0.003 * rng.randint(100)) for _ in range(60)]

    def form(i):
        cb = _manual_cb(i, dict(max_batch=8, buckets=(8,), starvation_rounds=3), qos=qos)
        for n, (rows, lane, tenant, ts) in enumerate(seq):
            _enqueue(i, cb, rows, lane, tenant, ts, payload=n)
        batches = []
        while cb._pending_rows:
            batches.append([s.payload for s in cb._form_locked()])
        return batches, sorted(cb.fair_rows.items(), key=str), \
            sorted(cb.fair_starved.items(), key=str)

    batches, _, _ = _both(form)
    assert sorted(p for b in batches for p in b) == list(range(60))


# ---- cross-source guarantees ---------------------------------------------------------


def test_exactly_once_per_source_on_coalesced_batch_failure(run):
    """A coalesced batch fails: every member gets the exception and each
    task fails only its own tuple; the replay then succeeds."""
    async def go():
        eng = _SlotEngine(capacity=1)
        m = MetricsRegistry()
        kw = dict(max_batch=8, buckets=(8,), max_wait_ms=10_000, eager=True,
                  continuous=True)
        b1, c1 = _bolt(eng, metrics=m, task_index=0, **kw)
        b2, c2 = _bolt(eng, metrics=m, task_index=1, **kw)
        assert b1._cb is b2._cb, "tasks sharing an engine share one queue"
        cb = b1._cb
        warm = cb.submit(_rows(), source="warm")
        await _until(lambda: len(eng.handles) == 1)
        t1, t2 = _port_tuple(), _port_tuple()
        await b1.execute(t1)
        await b2.execute(t2)
        await _until(lambda: len(cb) == 2)
        _resolve(eng.handles[0])
        await _until(lambda: len(eng.handles) == 2)
        assert eng.sizes[1] == [1, 1], "both sources coalesced"
        eng.handles[1].future.set_exception(RuntimeError("device fault"))
        await b1.flush()
        await b2.flush()
        assert [id(t) for t in c1.failed] == [id(t1)]
        assert [id(t) for t in c2.failed] == [id(t2)]
        assert not c1.acked and not c2.acked and c1.errors and c2.errors
        await b1.execute(t1)
        await b2.execute(t2)
        t0 = time.perf_counter()
        while not (c1.acked and c2.acked):
            for h in eng.handles:
                if not h.future.done():
                    _resolve(h)
            assert time.perf_counter() - t0 < 10.0, "the replay did not ack"
            await asyncio.sleep(0.01)
        await b1.flush()
        await b2.flush()
        assert [id(t) for t in c1.acked] == [id(t1)]
        assert [id(t) for t in c2.acked] == [id(t2)]
        snap = m.snapshot()["inference-bolt"]
        assert snap["coalesced_sources"] >= 1 + 2  # the warm batch, then two tasks
        warm.future.result(timeout=1)

    run(go(), timeout=60)


def test_task_row_cap_holds_records_back(run):
    """A task keeps at most max_inflight * max_batch rows outstanding: the
    next record waits until one completes."""
    async def go():
        eng = _SlotEngine(capacity=1)
        bolt, coll = _bolt(eng, max_batch=2, buckets=(2,), max_inflight=1,
                           max_wait_ms=10_000, eager=True, continuous=True)
        assert bolt._cb_cap == 2
        for _ in range(2):
            await bolt.execute(_port_tuple())
        third = asyncio.get_running_loop().create_task(bolt.execute(_port_tuple()))
        await asyncio.sleep(0.05)
        assert not third.done() and bolt._cb_rows == 2
        await _until(lambda: eng.handles)
        _resolve(eng.handles[0])
        await asyncio.wait_for(third, 5)
        t0 = time.perf_counter()
        while len(coll.acked) < 3:
            for h in eng.handles:
                if not h.future.done():
                    _resolve(h)
            assert time.perf_counter() - t0 < 10.0, "records did not ack"
            await asyncio.sleep(0.01)
        await bolt.flush()
        assert len(coll.acked) == 3 and bolt._cb_rows == 0

    run(go(), timeout=60)


# ---- the registry -------------------------------------------------------------------


def test_registry_identity_and_close_on_eviction():
    eng = _SlotEngine()
    cfg = BatchConfig(max_batch=8, buckets=(8,), continuous=True)
    cb = continuous_for(eng, cfg)
    assert continuous_for(eng, cfg) is cb
    sub = cb.submit(_rows(), source="s")
    _wait(lambda: eng.handles)
    _resolve(eng.handles[0])
    sub.future.result(timeout=5)
    assert len(registry_stats()) == 1
    thread = cb._thread
    del eng, sub
    gc.collect()
    assert registry_stats() == [], "an evicted engine drops its queue"
    with pytest.raises(RuntimeError, match="closed"):
        cb.submit(_rows())
    thread.join(5)
    assert not thread.is_alive(), "close joins the dispatcher thread"


def test_close_fails_rows_still_queued():
    eng = _SlotEngine(capacity=1)
    cb = continuous_for(eng, BatchConfig(max_batch=8, buckets=(8,), max_wait_ms=10_000,
                                         eager=True, continuous=True))
    first = cb.submit(_rows(), source="s")
    _wait(lambda: eng.handles)
    queued = cb.submit(_rows(), source="s")
    cb.close()
    with pytest.raises(RuntimeError, match="closed with rows queued"):
        queued.future.result(timeout=5)
    _resolve(eng.handles[0])
    assert first.future.result(timeout=5).shape == (1, 10)


def test_c3_gc_during_construction_does_not_deadlock(monkeypatch):
    """storm_tpu's registry builds the queue under its non-reentrant lock;
    a garbage collection there runs a dead engine's finalizer, which
    takes the same lock on the same thread: a deadlock (ROADMAP C3). The
    port's finalizer only appends to a deque and the queue is built
    outside the lock: the same collection, forced during the
    construction, completes."""
    class _Cyclic(_SlotEngine):
        pass

    dead = _Cyclic()
    dead.self_ref = dead  # only a collection frees it: its finalizer is pending
    dead_cb = continuous_for(dead, BatchConfig(continuous=True))
    del dead
    init = ContinuousBatcher.__init__
    collected = []

    def init_with_gc(self, *a, **kw):
        collected.append(gc.collect())
        init(self, *a, **kw)

    monkeypatch.setattr(ContinuousBatcher, "__init__", init_with_gc)
    live = _SlotEngine()
    box = {}
    th = threading.Thread(target=lambda: box.setdefault(
        "cb", continuous_for(live, BatchConfig(continuous=True))), daemon=True)
    th.start()
    th.join(10)
    assert not th.is_alive(), "continuous_for deadlocked under a collection"
    assert collected and collected[0] > 0
    assert box["cb"] is continuous_for(live, BatchConfig(continuous=True))
    # The dead engine's entry went on the next registry call, outside the lock.
    assert [s["engine"] for s in registry_stats()] == ["_SlotEngine"]
    with pytest.raises(RuntimeError, match="closed"):
        dead_cb.submit(_rows())


# ---- batch_fill and coalesced_sources on both paths ----------------------------------


def test_legacy_path_observes_batch_fill(run):
    async def go():
        eng = _SlotEngine(pad_to=8)
        bolt, coll = _bolt(eng, max_batch=8, buckets=(8,), max_wait_ms=10_000)
        assert not bolt._continuous
        for _ in range(3):
            await bolt.execute(_port_tuple())
        flush = asyncio.get_running_loop().create_task(bolt.flush())
        await _until(lambda: len(eng.handles) == 1)
        _resolve(eng.handles[0])
        await flush
        assert len(coll.acked) == 3
        m = bolt.context.metrics.snapshot()["inference-bolt"]
        assert m["batch_fill"]["count"] == 1
        assert m["batch_fill"]["p50"] == pytest.approx(3 / 8)
        assert m["coalesced_sources"] == 1, "a per-task batch has one source"

    run(go(), timeout=60)


def test_continuous_path_observes_batch_fill():
    eng = _SlotEngine(pad_to=8)
    m = MetricsRegistry()
    cb = continuous_for(eng, BatchConfig(max_batch=8, buckets=(8,), max_wait_ms=10_000,
                                         eager=True, continuous=True))
    cb.bind(m, "engine")
    subs = [cb.submit(_rows(), source=f"s{i}") for i in range(3)]
    t0 = time.perf_counter()
    while not all(s.future.done() for s in subs):
        assert time.perf_counter() - t0 < 5.0
        for h in list(eng.handles):
            if not h.future.done():
                _resolve(h)
        time.sleep(0.002)
    for s in subs:
        s.future.result(timeout=5)
    snap = m.snapshot()["engine"]
    assert snap["batch_fill"]["count"] == len(eng.handles)
    assert sum(sum(sz) for sz in eng.sizes) == 3
    assert snap["coalesced_sources"] >= len(eng.handles)
    assert cb.fill_median() is not None and cb.stats()["batches"] == len(eng.handles)
