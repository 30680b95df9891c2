"""The port's split-phase engine against storm_tpu's on the CPU.

Each test is the counterpart of one in ``tests/test_pipeline.py`` or
``tests/test_resilience.py`` and, where both packages can run it, runs the
same call sequence through storm_tpu and the port (the ``impl`` fixture):
dispatch overlaps the next batch with a gated fetch and isolates a failed
batch; staging buffers recycle, and the port's pool counts as storm_tpu's;
depth 0 serializes; the config validates its knobs; the operator completes
tuples from fetch futures and ``flush`` drains the ring; the ``NullEngine``
protocol; the fetch loop's watchdog, consecutive trips quarantining, and an
injected hang quarantining a real engine. Then the port alone: its
pipelined predictions bit-identical to its serial ones and within
``tests/test_torch_cnn.py``'s bounds of storm_tpu's pipelined dispatch on
the trained digits checkpoints, the bucket's ring slots and static buffers,
and the staged uint8 wire. Every thread a test starts is joined with a
timeout.
"""

import asyncio
import json
import os
import queue
import threading
import time
from types import SimpleNamespace

import numpy as np
import pytest
import torch

import storm_tpu.config as jax_config
import storm_tpu.infer.engine as jax_engine
import storm_tpu.infer.operator as jax_operator
import storm_tpu.resilience as jax_resilience
import storm_tpu.runtime.base as jax_base
import storm_tpu.runtime.metrics as jax_metrics
import storm_tpu.runtime.tuples as jax_tuples
import storm_tpu_torch.config as port_config
import storm_tpu_torch.infer.engine as port_engine
import storm_tpu_torch.infer.operator as port_operator
import storm_tpu_torch.resilience as port_resilience
import storm_tpu_torch.runtime.base as port_base
import storm_tpu_torch.runtime.metrics as port_metrics
import storm_tpu_torch.runtime.tuples as port_tuples
from storm_tpu.runtime.tracing import DEVICE_SUBSTAGES as JAX_SUBSTAGES
from storm_tpu_torch.data import load_digits_nhwc
from storm_tpu_torch.infer.graphs import BucketForward
from tests.test_torch_checkpoints import abstract_init  # noqa: F401  (fixture)
from tests.test_torch_cnn import BOUND, MODES, ROOT, _config

SHAPE = (28, 28, 1)
IMPLS = {
    "storm_tpu": SimpleNamespace(
        name="storm_tpu", config=jax_config, engine=jax_engine, operator=jax_operator,
        base=jax_base, metrics=jax_metrics, tuples=jax_tuples, chaos=jax_resilience,
        float32=np.float32),
    "port": SimpleNamespace(
        name="port", config=port_config, engine=port_engine, operator=port_operator,
        base=port_base, metrics=port_metrics, tuples=port_tuples, chaos=port_resilience,
        float32=torch.float32),
}
SUBSTAGES = {k for k, _ in JAX_SUBSTAGES}


@pytest.fixture(params=sorted(IMPLS))
def impl(request):
    return IMPLS[request.param]


def _model(impl, **kw):
    return impl.config.ModelConfig(name="lenet5", dtype="float32", num_classes=10,
                                   input_shape=SHAPE, **kw)


def _engine(impl, **batch_kw):
    batch = impl.config.BatchConfig(max_batch=8, buckets=(8,), **batch_kw)
    if impl.name == "storm_tpu":
        return jax_engine.InferenceEngine(_model(impl), jax_config.ShardingConfig(
            data_parallel=1), batch)
    return port_engine.InferenceEngine(_model(impl), batch, device="cpu")


def _join(threads, timeout=10.0):
    for t in threads:
        t.join(timeout)
    assert not any(t.is_alive() for t in threads), "a thread did not finish"


# ---- engine-level: overlap / isolation / staging -----------------------------


class _GatedOut:
    """Stands in for a launched batch's result: the fetch thread blocks on
    the gate, so the test decides when each in-flight batch finishes."""

    def __init__(self, tag: int, gate: threading.Event, n: int, fail: bool) -> None:
        self.tag, self.gate, self.n, self.fail = tag, gate, n, fail

    def block_until_ready(self):
        assert self.gate.wait(10), "test never opened the gate"
        if self.fail:
            raise RuntimeError(f"device fault in batch {self.tag}")
        return self

    def __array__(self, dtype=None, copy=None):
        return np.full((self.n, 10), float(self.tag), np.float32)


def _gate(impl, eng, fail_tags=()):
    """Replace the engine's launch (storm_tpu: the jit forward; the port:
    the bucket's replay) with a recorder returning gated results."""
    launches, gates = [], {}

    def launched(rows):
        tag = len(launches)
        launches.append(time.perf_counter())
        gates[tag] = threading.Event()
        return _GatedOut(tag, gates[tag], rows, tag in fail_tags)

    if impl.name == "storm_tpu":
        eng._fwd = lambda params, state, x: launched(x.shape[0])
    else:
        eng._launch = lambda padded, host_in, host_out, scale=None, offset=None, \
            eager=False: launched(padded)
    return launches, gates


def test_dispatch_overlaps_next_batch_with_compute(impl):
    """Batch 1's staging, copy and launch complete while batch 0 is still
    computing (its gate closed); a third dispatch parks on the ring."""
    eng = _engine(impl)
    launches, gates = _gate(impl, eng)
    x = np.zeros((8, *SHAPE), np.float32)
    h0, h1 = eng.dispatch((x,)), eng.dispatch((x,))
    assert len(launches) == 2, "the second launch must not wait for a fetch"
    assert not h0.future.done() and not h1.future.done()
    box = []
    t = threading.Thread(target=lambda: box.append(eng.dispatch((x,))), daemon=True)
    t.start()
    time.sleep(0.2)
    assert len(launches) == 2, "the ring must bound in-flight batches at its depth"
    gates[0].set()
    assert np.all(h0.future.result(10) == 0.0)
    _join([t])
    assert len(launches) == 3
    gates[1].set()
    gates[2].set()
    assert np.all(h1.future.result(10) == 1.0)
    assert np.all(box[0].future.result(10) == 2.0)
    for h in (h0, h1, box[0]):
        assert set(h.timings) == SUBSTAGES


def test_exception_fails_only_its_own_batch(impl):
    eng = _engine(impl)
    launches, gates = _gate(impl, eng, fail_tags={0})
    x = np.zeros((8, *SHAPE), np.float32)
    h0, h1 = eng.dispatch((x,)), eng.dispatch((x,))
    gates[0].set()
    gates[1].set()
    with pytest.raises(RuntimeError, match="batch 0"):
        h0.future.result(10)
    assert np.all(h1.future.result(10) == 1.0)
    # the failed batch released its ring slot and staging buffers
    h2 = eng.dispatch((x,))
    gates[2].set()
    assert np.all(h2.future.result(10) == 2.0)
    for _ in range(200):  # the fetch thread releases just after resolving
        if eng.ring_inflight == 0:
            break
        time.sleep(0.01)
    assert eng.ring_inflight == 0


def test_staging_buffers_recycle_no_per_batch_growth(impl):
    eng = _engine(impl)
    eng.warmup()
    x = np.random.RandomState(0).rand(5, *SHAPE).astype(np.float32)
    eng.predict(x)
    before = eng._staging.allocated
    for _ in range(25):
        eng.predict(x)
    assert eng._staging.allocated == before


def test_staging_pool_counts_as_storm_tpus():
    """One acquire/release sequence through both pools, a blocked acquire
    included: the same stats at every step, the same buffer recycled."""
    pools = {name: impl.engine.StagingPool(limit=2) for name, impl in IMPLS.items()}
    steps = {name: [] for name in pools}
    for name, pool in pools.items():
        f32 = IMPLS[name].float32
        a = pool.acquire((4, 2), f32)
        b = pool.acquire((4, 2), f32)
        steps[name].append(pool.stats())
        got = []
        t = threading.Thread(target=lambda: got.append(pool.acquire((4, 2), f32)),
                             daemon=True)
        t.start()
        time.sleep(0.1)
        assert not got, "a third acquire must block at the pool's limit"
        pool.release(a)
        _join([t])
        assert got[0] is a
        steps[name].append(pool.stats())
        c = pool.acquire((8, 2), f32)
        steps[name].append(pool.stats())
        for buf in (b, c, got[0]):
            pool.release(buf)
        steps[name].append(pool.stats())
    assert steps["port"] == steps["storm_tpu"]
    assert steps["port"][-1] == {"allocated": 3, "free": 3, "in_use": 0, "limit": 2}


def test_dispatch_parts_match_stacked_predict(impl):
    eng = _engine(impl)
    rng = np.random.RandomState(7)
    parts = [rng.rand(3, *SHAPE).astype(np.float32), rng.rand(2, *SHAPE).astype(np.float32)]
    want = eng.predict(np.concatenate(parts))
    got = eng.dispatch(parts).future.result(30)
    if impl.name == "port":
        assert np.array_equal(got, want)  # the same staged bytes, the same forward
    np.testing.assert_allclose(got, want, atol=1e-6)


def test_pipeline_depth_zero_serializes(impl):
    eng0 = _engine(impl, pipeline_depth=0)
    assert eng0._ring is None and eng0.pipeline_depth == 0
    x = np.random.RandomState(1).rand(4, *SHAPE).astype(np.float32)
    h = eng0.dispatch((x,))
    assert h.future.done(), "depth 0 resolves synchronously"
    np.testing.assert_allclose(h.future.result(), _engine(impl).predict(x), atol=1e-6)


@pytest.mark.parametrize("knob,value", [("pipeline_depth", -1), ("staging_pool", -2),
                                        ("watchdog_ms", -1.0), ("watchdog_trips", -1)])
def test_batch_config_validates_pipeline_knobs(impl, knob, value):
    with pytest.raises(ValueError, match=knob):
        impl.config.BatchConfig(**{knob: value})
    cfg = impl.config.BatchConfig()
    assert (cfg.pipeline_depth, cfg.staging_pool, cfg.watchdog_ms, cfg.watchdog_trips,
            cfg.eager) == (2, 0, 0.0, 3, False)


# ---- operator-level: futures, drain ------------------------------------------


class _Collector:
    def __init__(self):
        self.emitted, self.acked, self.failed, self.errors = [], [], [], []

    def set_output_fields(self, fields):
        pass

    async def emit(self, values, stream="default", anchors=None, **kw):
        self.emitted.append((stream, list(values)))
        return 1

    def ack(self, t):
        self.acked.append(t)

    def fail(self, t):
        self.failed.append(t)

    def report_error(self, e):
        self.errors.append(e)


class _ManualEngine:
    """dispatch-protocol engine whose futures the TEST resolves."""

    input_shape = SHAPE

    def __init__(self, impl):
        self.impl = impl
        self.handles = []

    def warmup(self, buckets=None):
        pass

    def dispatch(self, parts):
        n = sum(int(p.shape[0]) for p in parts)
        h = self.impl.engine.InflightBatch(n, n)
        h.timings = {"h2d_ms": 0.5, "compute_ms": 1.0, "d2h_ms": 0.25}
        self.handles.append(h)
        return h


def _prepared_bolt(impl, engine, **batch_kw):
    bolt = impl.operator.InferenceBolt(_model(impl), impl.config.BatchConfig(**batch_kw),
                                       engine=engine, warmup=False)
    ctx = impl.base.TopologyContext("inference-bolt", 0, 1, impl.config.Config(),
                                    metrics=impl.metrics.MetricsRegistry())
    coll = _Collector()
    bolt.prepare(ctx, coll)
    return bolt, coll


def _tuple(impl):
    payload = json.dumps({"instances": np.zeros((1, *SHAPE), np.float32).tolist()})
    return impl.tuples.Tuple(values=[payload], fields=("message",),
                             source_component="spout", root_ts=time.perf_counter())


def test_operator_completes_tuples_from_fetch_futures(impl, run):
    async def go():
        eng = _ManualEngine(impl)
        bolt, coll = _prepared_bolt(impl, eng, max_batch=2, max_wait_ms=10_000,
                                    max_inflight=4)
        tuples = [_tuple(impl) for _ in range(4)]
        for t in tuples:
            await bolt.execute(t)
        await asyncio.sleep(0.05)
        assert len(eng.handles) == 2 and not coll.acked, \
            "acks must defer until the fetch future resolves"
        eng.handles[0].future.set_exception(RuntimeError("boom"))
        eng.handles[1].future.set_result(np.full((2, 10), 0.1, np.float32))
        await bolt.flush()
        assert {id(t) for t in coll.failed} == {id(t) for t in tuples[:2]}
        assert {id(t) for t in coll.acked} == {id(t) for t in tuples[2:]}
        assert len(coll.emitted) == 2
        assert coll.errors and "boom" in str(coll.errors[0])
        m = bolt.context.metrics
        for key in SUBSTAGES:
            assert m.histogram("inference-bolt", key).count == 1
        assert m.histogram("inference-bolt", "batch_fill").count == 1
        assert m.histogram("inference-bolt", "batch_wait_ms").count == 4
        assert m.histogram("inference-bolt", "dispatch_wait_ms").count == 2

    run(go(), timeout=60)


def test_operator_flush_drains_ring_and_pending(impl, run):
    async def go():
        eng = _ManualEngine(impl)
        bolt, coll = _prepared_bolt(impl, eng, max_batch=2, max_wait_ms=10_000,
                                    max_inflight=4)
        for _ in range(5):  # two full batches in flight + one pending
            await bolt.execute(_tuple(impl))
        await asyncio.sleep(0.05)
        assert len(eng.handles) == 2 and len(bolt.batcher) == 1

        async def resolve():
            for _ in range(100):
                if len(eng.handles) == 3:
                    break
                await asyncio.sleep(0.01)
            for h in eng.handles:
                if not h.future.done():
                    h.future.set_result(np.zeros((h.n, 10), np.float32))

        await asyncio.gather(bolt.flush(), resolve())
        assert len(coll.acked) == 5 and not coll.failed
        assert len(bolt.batcher) == 0 and not bolt._inflight

    run(go(), timeout=60)


def test_operator_tick_dispatches_a_due_partial_batch(impl, run):
    """A tick tuple dispatches a partial batch once its deadline has
    passed (storm_tpu's ``InferenceBolt.tick``), and nothing before."""
    async def go():
        eng = _ManualEngine(impl)
        bolt, coll = _prepared_bolt(impl, eng, max_batch=4, max_wait_ms=10_000,
                                    max_inflight=4)
        for _ in range(3):
            await bolt.execute(_tuple(impl))
        await bolt.tick()
        await asyncio.sleep(0.05)
        assert not eng.handles and len(bolt.batcher) == 3, "not due yet"
        bolt.batcher.cfg.max_wait_ms = 0.0  # the deadline flush still sleeps
        await bolt.tick()
        await asyncio.sleep(0.05)
        assert [h.n for h in eng.handles] == [3] and len(bolt.batcher) == 0
        eng.handles[0].future.set_result(np.zeros((3, 10), np.float32))
        await bolt.flush()
        assert len(coll.acked) == 3 and not coll.failed and len(coll.emitted) == 3
        bolt.cleanup()

    run(go(), timeout=60)


def test_null_engine_dispatch_protocol(impl):
    ne = impl.engine.NullEngine(SHAPE, 10)
    h = ne.dispatch((np.zeros((3, *SHAPE), np.float32),))
    assert h.future.done()
    out = h.future.result()
    assert out.shape == (3, 10)
    np.testing.assert_allclose(out.sum(-1), np.ones(3), atol=1e-6)
    assert h.timings == dict.fromkeys(SUBSTAGES, 0.0)


# ---- watchdog and quarantine (tests/test_resilience.py) ----------------------


def test_fetch_loop_watchdog_trips_and_releases_ring(impl):
    class NeverReady:
        def is_ready(self):
            return False

    fetch_q, ring = queue.SimpleQueue(), threading.BoundedSemaphore(1)
    ring.acquire()
    staging = impl.engine.StagingPool(1)
    outcomes = []
    handle = impl.engine.InflightBatch(1, 8)
    handle._out = NeverReady()
    handle._buf = staging.acquire((8, 2), impl.float32)
    handle.watchdog_ms = 40.0
    handle.on_done = outcomes.append
    t = threading.Thread(target=impl.engine._fetch_loop, args=(fetch_q, ring, staging),
                         daemon=True)
    t.start()
    try:
        fetch_q.put(handle)
        with pytest.raises(impl.engine.EngineWatchdogTimeout):
            handle.future.result(timeout=5)
        assert ring.acquire(timeout=2)
        assert isinstance(outcomes[0], impl.engine.EngineWatchdogTimeout)
        assert handle._buf is None and staging.stats()["in_use"] == 0
    finally:
        fetch_q.put(None)
        _join([t], 5)


def test_fetch_loop_no_watchdog_blocks_normally(impl):
    class Ready:
        def is_ready(self):
            return True

        def block_until_ready(self):
            return self

        def __array__(self, dtype=None, copy=None):
            return np.arange(8, dtype=np.float32).reshape(4, 2)

    fetch_q, ring = queue.SimpleQueue(), threading.BoundedSemaphore(1)
    ring.acquire()
    handle = impl.engine.InflightBatch(3, 4)
    handle._out = Ready()
    handle._t_launched = time.perf_counter()
    t = threading.Thread(target=impl.engine._fetch_loop,
                         args=(fetch_q, ring, impl.engine.StagingPool(1)), daemon=True)
    t.start()
    try:
        fetch_q.put(handle)
        out = handle.future.result(timeout=5)
        assert out.shape == (3, 2) and out[2, 1] == 5.0  # sliced to the true n
    finally:
        fetch_q.put(None)
        _join([t], 5)


def test_watchdog_note_quarantines_on_consecutive_trips(impl):
    fired = []
    eng = SimpleNamespace(
        batch_cfg=impl.config.BatchConfig(watchdog_ms=10.0, watchdog_trips=2),
        model_cfg=SimpleNamespace(name="stub"), _watchdog_lock=threading.Lock(),
        _watchdog_trips=0, quarantined=False, on_quarantine=fired.append)
    note = impl.engine.InferenceEngine._watchdog_note
    trip = impl.engine.EngineWatchdogTimeout
    note(eng, trip("t1"))
    assert not eng.quarantined
    note(eng, None)  # a success resets the consecutive count
    note(eng, trip("t2"))
    note(eng, trip("t3"))
    assert eng.quarantined and fired == [2]
    note(eng, trip("t4"))  # already quarantined: the hook fires once
    assert fired == [2]


def test_engine_hang_injection_quarantines_real_engine(impl):
    """Armed engine-hang injections make batches miss their fetch deadline;
    two consecutive trips quarantine the engine and dispatch fails fast."""
    eng = _engine(impl, watchdog_ms=100.0, watchdog_trips=2)
    eng.warmup()
    x = np.zeros((4, *SHAPE), np.float32)
    assert eng.dispatch((x,)).future.result(timeout=30).shape == (4, 10)
    inj = impl.chaos.get_injector()
    inj.configure(engine_hang_ms=600.0, engine_hang_next=2)
    try:
        for _ in range(2):
            with pytest.raises(impl.engine.EngineWatchdogTimeout):
                eng.dispatch((x,)).future.result(timeout=10)
        for _ in range(200):  # the fetch thread notes the trip after failing the future
            if eng.quarantined:
                break
            time.sleep(0.01)
        assert eng.quarantined
        with pytest.raises(impl.engine.EngineQuarantined):
            eng.dispatch((x,))
    finally:
        inj.configure(engine_hang_ms=0.0, engine_hang_next=0)


def test_chaos_injector_engine_hang_budget():
    inj = port_resilience.ChaosInjector()
    assert inj.engine_hang_s() == 0.0
    inj.configure(engine_hang_ms=250.0, engine_hang_next=2)
    assert inj.engine_hang_s() == pytest.approx(0.25)
    assert inj.engine_hang_s() == pytest.approx(0.25)
    assert inj.engine_hang_s() == 0.0  # the budget is spent
    assert inj.counts["engine_hang"] == 2
    with pytest.raises(ValueError, match="unknown chaos knob"):
        inj.configure(engine_hang_s=1.0)  # a misspelt knob


# ---- the port's pipelined predictions, against storm_tpu's -------------------


@pytest.mark.parametrize("tag,mode", [("lenet5_digits", "float32"), ("lenet5_digits", "bf16"),
                                      ("vit_tiny_digits", "bf16")])
def test_pipelined_dispatch_matches_serial_and_storm_tpu(tag, mode, abstract_init):
    """Batches of 8, 32, 5 and 19 held-out rows (buckets 8 and 32, full and
    padded) in flight together through the port's ring: bit-identical to
    the port's serialized predict, and within test_torch_cnn.py's bound of
    storm_tpu's pipelined dispatch of the same batches."""
    x = load_digits_nhwc(_config(tag, mode).input_shape)[2]
    sizes = (8, 32, 5, 19)
    cuts = np.cumsum((0,) + sizes)
    parts = [x[a:b] for a, b in zip(cuts[:-1], cuts[1:])]

    def port(depth):
        return port_engine.InferenceEngine(_config(tag, mode), port_config.BatchConfig(
            max_batch=32, buckets=(8, 32), pipeline_depth=depth), device="cpu")

    piped = port(2)
    handles = [piped.dispatch((p,)) for p in parts]
    got = [h.future.result(60) for h in handles]
    serial = port(0)
    for g, p in zip(got, parts):
        assert np.array_equal(g, serial.predict(p))
    cfg = _config(tag, mode)
    jeng = jax_engine.InferenceEngine(
        jax_config.ModelConfig(name=cfg.name, checkpoint=os.path.join(ROOT, "checkpoints", tag),
                               input_shape=cfg.input_shape, num_classes=cfg.num_classes,
                               **MODES[mode]),
        jax_config.ShardingConfig(data_parallel=1),
        jax_config.BatchConfig(max_batch=32, buckets=(8, 32)))
    want = [np.asarray(h.future.result(60), np.float32)
            for h in [jeng.dispatch((p,)) for p in parts]]
    bound = 1e-5 if mode == "float32" else BOUND.get((tag, mode), 1e-2)
    for g, w in zip(got, want):
        assert g.shape == w.shape
        assert np.abs(g - w).max() <= bound


# ---- the bucket's static buffers and ring slots (CPU) ------------------------


def test_bucket_slots_rotate_over_static_buffers(monkeypatch):
    """Each batch goes through the next ring slot's buffer into the one
    static input; the buffers are the bucket's for its life."""
    eng = port_engine.InferenceEngine(
        port_config.ModelConfig(name="vit_tiny", dtype="bfloat16", num_classes=10,
                                input_shape=(32, 32, 3)),
        port_config.BatchConfig(max_batch=8, buckets=(8,)), device="cpu")
    slots, staged = [], []
    run_orig = BucketForward.run

    def spy(self, slot, host_in, host_out, *a, **k):
        slots.append(slot)
        staged.append(host_in.clone())
        out = run_orig(self, slot, host_in, host_out, *a, **k)
        assert torch.equal(self.slot_in[slot], host_in)
        assert torch.equal(self.static_in, host_in)
        return out

    monkeypatch.setattr(BucketForward, "run", spy)
    rng = np.random.RandomState(3)
    xs = [rng.rand(n, 32, 32, 3).astype(np.float32) for n in (8, 3, 8, 1, 6)]
    bucket = eng.graph_for(8)
    ptrs = (bucket.static_in.data_ptr(), bucket.static_out.data_ptr(),
            [b.data_ptr() for b in bucket.slot_in])
    outs = [h.future.result(30) for h in [eng.dispatch((x,)) for x in xs]]
    assert slots == [0, 1, 0, 1, 0] and len(bucket.slot_in) == eng.pipeline_depth == 2
    assert (bucket.static_in.data_ptr(), bucket.static_out.data_ptr(),
            [b.data_ptr() for b in bucket.slot_in]) == ptrs
    for x, s, o in zip(xs, staged, outs):
        n = len(x)
        assert torch.equal(s[:n], torch.from_numpy(x).to(torch.bfloat16))
        assert not s[n:].any()  # padding rows zeroed
        assert o.shape == (n, 10)
    assert eng.forwards == len(xs) and eng.compiled_batches == {8}


@pytest.mark.parametrize("transfer", [None, "uint8"])
def test_depth2_results_equal_serial_per_batch(transfer):
    """Batches of distinct inputs in flight together at depth 2, each
    equal to its own serial forward (a shared buffer would mix them)."""
    cfg = port_config.ModelConfig(name="vit_tiny", dtype="bfloat16", num_classes=10,
                                  input_shape=(32, 32, 3), transfer_dtype=transfer)
    rng = np.random.RandomState(4)
    xs = [(rng.rand(n, 32, 32, 3) * (1 + i)).astype(np.float32)
          for i, n in enumerate((8, 2, 7, 8, 4, 8))]
    engines = [port_engine.InferenceEngine(cfg, port_config.BatchConfig(
        max_batch=8, buckets=(8,), pipeline_depth=d), device="cpu") for d in (2, 0)]
    results = [None] * len(xs)

    def feed(first):
        for i in range(first, len(xs), 2):
            results[i] = engines[0].dispatch((xs[i],))

    threads = [threading.Thread(target=feed, args=(k,), daemon=True) for k in range(2)]
    for t in threads:
        t.start()
    _join(threads, 30)
    for x, h in zip(xs, results):
        assert np.array_equal(h.future.result(30), engines[1].predict(x))
    stats = engines[0].staging_stats()
    assert stats["allocated"] <= 3 * stats["limit"]


def test_staged_uint8_wire_equals_quantize_wire():
    """The dispatch phase's in-place quantization gives quantize_wire's
    bytes, scale and offset (range from the real rows, padding included)."""
    rng = np.random.RandomState(5)
    x = (rng.rand(8, 4, 4, 3) * 7 - 2).astype(np.float32)
    x[5:] = 0.0  # padding rows
    want, scale, offset = port_engine.quantize_wire(x, 5)
    f32, out = x.copy(), np.empty(x.shape, np.uint8)
    got_scale, got_offset = port_engine._quantize_staged(f32, out, 5)
    assert np.array_equal(out, want) and (got_scale, got_offset) == (scale, offset)
