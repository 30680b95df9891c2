"""The port's confidence-gated cascade (``storm_tpu_torch/cascade/`` and the
inference operator's cascade paths) against storm_tpu's on the CPU:

- ``CascadeConfig`` refuses what storm_tpu's refuses, with its messages,
  and routes alike (entry tier, pins, per-lane and shed thresholds);
- ``uncertainty`` and ``fit_temperature`` equal storm_tpu's on seeded
  rows (and, by hypothesis, over metrics and temperatures);
- ``CascadeRouter.decide_item`` / ``decide`` over the same sequence
  (partial rows, budget windows, shed pins, lane thresholds) give the same
  merged outputs, residues and counters;
- a cascade bolt of each package over injected tier engines that answer
  the same per-row predictions, on the batch path (records of several
  rows, chunks and record frames) and the continuous path, emits the same
  outputs, acks and fails alike when a tier fails, and records the same
  events; the degrade cascade of ``qos.degrade_model`` serves shed lanes
  at tier 0;
- the three digits checkpoints through a port topology on the CPU in
  float32 serve each of 64 odd held-out rows at the tier that storm_tpu's
  ``uncertainty`` picks from the JAX engine's float32 predictions;
- a swap under ``continuous=True``: the port's flagship tier moves to the
  new engine's queue, storm_tpu's keeps submitting to the old one
  (``ROADMAP.md`` C11), side by side.
"""

from __future__ import annotations

import asyncio
import dataclasses
import gc
import json
import threading
import time
from types import SimpleNamespace

import numpy as np
import pytest
from hypothesis import given, settings
from hypothesis import strategies as st

import storm_tpu.cascade.policy as jax_policy
import storm_tpu.config as jax_config
import storm_tpu.infer.batcher as jax_batcher
import storm_tpu.infer.continuous as jax_continuous
import storm_tpu.infer.engine as jax_engine
import storm_tpu.infer.operator as jax_operator
import storm_tpu.runtime.base as jax_base
import storm_tpu.runtime.frames as jax_frames
import storm_tpu.runtime.metrics as jax_metrics
import storm_tpu.runtime.tracing as jax_tracing
import storm_tpu.runtime.tuples as jax_tuples
import storm_tpu_torch.cascade.policy as port_policy
import storm_tpu_torch.cascade.router as port_router
import storm_tpu_torch.config as port_config
import storm_tpu_torch.infer.batcher as port_batcher
import storm_tpu_torch.infer.continuous as port_continuous
import storm_tpu_torch.infer.engine as port_engine
import storm_tpu_torch.infer.operator as port_operator
import storm_tpu_torch.runtime.base as port_base
import storm_tpu_torch.runtime.frames as port_frames
import storm_tpu_torch.runtime.metrics as port_metrics
import storm_tpu_torch.runtime.tracing as port_tracing
import storm_tpu_torch.runtime.tuples as port_tuples
from tests.test_torch_copyledger import clear_engine_caches
from tests.test_torch_pipeline import _Collector

# storm_tpu's router imports its infer package, whose operator imports the
# router: it loads through the operator, imported above.
jax_router = jax_operator.CascadeRouter.__module__ and __import__(
    "storm_tpu.cascade.router", fromlist=["CascadeRouter"])

IMPLS = {
    "storm_tpu": SimpleNamespace(
        name="storm_tpu", policy=jax_policy, router=jax_router, config=jax_config,
        batcher=jax_batcher, continuous=jax_continuous, engine=jax_engine,
        operator=jax_operator, base=jax_base, frames=jax_frames, metrics=jax_metrics,
        tracing=jax_tracing, tuples=jax_tuples),
    "port": SimpleNamespace(
        name="port", policy=port_policy, router=port_router, config=port_config,
        batcher=port_batcher, continuous=port_continuous, engine=port_engine,
        operator=port_operator, base=port_base, frames=port_frames, metrics=port_metrics,
        tracing=port_tracing, tuples=port_tuples),
}
K = 10


def _both(fn):
    got = {name: fn(impl) for name, impl in IMPLS.items()}
    assert _plain(got["port"]) == _plain(got["storm_tpu"]), (got["port"], got["storm_tpu"])
    return got["port"]


def _plain(x):
    """Arrays to lists, recursively, so results compare with ``==``."""
    if isinstance(x, np.ndarray):
        return x.tolist()
    if isinstance(x, dict):
        return {k: _plain(v) for k, v in x.items()}
    if isinstance(x, (list, tuple)):
        return [_plain(v) for v in x]
    return x


def _probs(rng, n, sharp):
    z = rng.randn(n, K) * sharp
    z -= z.max(axis=-1, keepdims=True)
    p = np.exp(z)
    return (p / p.sum(axis=-1, keepdims=True)).astype(np.float32)


# ---- the config and the math -------------------------------------------------------------

TIERS3 = dict(enabled=True, tiers=("a", "b", "c"), thresholds=(0.2, 0.4))
BAD_CASCADE = [
    dict(enabled=True, tiers=("a",)),
    dict(enabled=True, tiers=("a", "b"), checkpoints=("x",), thresholds=(0.1,)),
    dict(enabled=True, tiers=("a", "b"), thresholds=()),
    dict(enabled=True, tiers=("a", "b"), thresholds=(1.5,)),
    dict(TIERS3, metric="nope"),
    dict(TIERS3, temperature=0.0),
    dict(TIERS3, escalation_budget=1.5),
    dict(TIERS3, budget_window=0),
    dict(TIERS3, shed_tighten=-0.1),
    dict(TIERS3, lane_thresholds={"high": (0.1,)}),
    dict(TIERS3, lane_thresholds={"high": (0.1, 2.0)}),
]


@pytest.mark.parametrize("kw", BAD_CASCADE, ids=range(len(BAD_CASCADE)))
def test_cascade_config_refuses_alike(kw):
    def refusal(impl):
        with pytest.raises(ValueError) as e:
            impl.policy.CascadeConfig(**kw)
        return str(e.value)

    _both(refusal)


def test_cascade_config_routes_alike():
    def routes(impl):
        qos = impl.config.QosConfig(enabled=True)
        out = [dataclasses.asdict(impl.config.Config().cascade)]
        for shed_only in (False, True):
            cfg = impl.policy.CascadeConfig(**TIERS3, lane_thresholds={"high": (0.5, 0.6)},
                                            shed_only=shed_only)
            for lane in ("high", "normal", "best_effort", None):
                for level in (0, 1, 2):
                    out.append((cfg.entry_tier(lane, level, qos), cfg.pinned(lane, level, qos),
                                [cfg.threshold_for(i, lane, level) for i in (0, 1)]))
        return out

    _both(routes)


def test_uncertainty_and_temperature_alike():
    rng = np.random.RandomState(0)
    p = _probs(rng, 64, 3.0)
    labels = rng.randint(0, K, 64)
    for metric in port_policy.CONFIDENCE_METRICS:
        for t in (0.5, 1.0, 1.25, 3.0):
            np.testing.assert_array_equal(port_policy.uncertainty(p, metric, t),
                                          jax_policy.uncertainty(p, metric, t))
    assert port_policy.fit_temperature(p, labels) == jax_policy.fit_temperature(p, labels)
    with pytest.raises(ValueError, match="unknown cascade metric"):
        port_policy.uncertainty(p, "nope")


@settings(max_examples=40, deadline=None)
@given(metric=st.sampled_from(port_policy.CONFIDENCE_METRICS),
       temperature=st.floats(0.05, 8.0), seed=st.integers(0, 2**16),
       sharp=st.floats(0.0, 20.0), k=st.integers(2, 12))
def test_uncertainty_alike_by_hypothesis(metric, temperature, seed, sharp, k):
    z = np.random.RandomState(seed).randn(5, k) * sharp
    p = np.exp(z - z.max(axis=-1, keepdims=True))
    p /= p.sum(axis=-1, keepdims=True)
    got = port_policy.uncertainty(p, metric, temperature)
    np.testing.assert_array_equal(got, jax_policy.uncertainty(p, metric, temperature))
    assert np.all((got >= -1e-12) & (got <= 1 + 1e-12))


# ---- the router ------------------------------------------------------------------------------


def _router(impl, **kw):
    cfg = impl.policy.CascadeConfig(**{**TIERS3, **kw})
    qos = impl.config.QosConfig(enabled=True)
    r = impl.router.CascadeRouter(cfg, qos=qos)
    for t in r.tiers:
        t.model_cfg = impl.config.ModelConfig(name=cfg.tiers[t.index])
    reg = impl.metrics.MetricsRegistry()
    r.bind_metrics(reg, "infer")
    return r, reg


def _residue(res):
    if res is None:
        return None
    w = res.payload
    return {"data": res.data, "ts": res.ts, "lane": res.lane, "payload": w.payload,
            "partial": w.partial, "row_idx": w.row_idx, "link": w.link_span}


@pytest.mark.parametrize("kw", [{}, dict(escalation_budget=0.3, budget_window=8),
                                dict(escalation_budget=0.0),
                                dict(lane_thresholds={"high": (0.6, 0.7)})],
                         ids=["plain", "budget", "tier0_only", "lanes"])
def test_router_decides_alike(kw):
    def drive(impl):
        r, reg = _router(impl, **kw)
        rng = np.random.RandomState(11)
        out = []
        for rec in range(40):
            n = int(rng.randint(1, 5))
            data = rng.rand(n, 2).astype(np.float32)
            lane = ("high", "normal", "best_effort")[rec % 3]
            level = 1 if 20 <= rec < 28 else 0
            payload, tier = f"rec{rec}", 0
            while True:
                preds = _probs(rng, int(data.shape[0]), float(rng.uniform(0.5, 6)))
                merged, res, info = r.decide_item(payload, data, preds, lane, tier, level,
                                                  ts=float(rec))
                out.append((merged, _residue(res), info, r.escalation_rate()))
                if res is None:
                    break
                payload, data, tier = res.payload, res.data, tier + 1
        # a whole fetched batch through decide
        items = [impl.batcher.BatchItem(f"b{i}", rng.rand(2, 2).astype(np.float32),
                                        float(i), lane=("high", "normal")[i % 2])
                 for i in range(6)]
        batch = impl.batcher.Batch(items, 12)
        acc, esc, info = r.decide(batch, _probs(rng, 12, 2.0), 0, 0)
        out.append((acc, [_residue(e) for e in esc], info))
        out.append(reg.snapshot())
        return out

    out = _both(drive)
    counters = out[-1]["infer"]
    if kw.get("escalation_budget") == 0.0:
        assert counters["cascade_budget_capped"] > 0
        assert counters["cascade_escalations"] == 0
    else:
        assert counters["cascade_escalations"] > 0
    assert counters["cascade_shed_pinned"] > 0


# ---- the bolt over injected tier engines -------------------------------------------------

SHAPE = (4, 4, 1)
N_IDS = 64
TIER_NAMES = ("vit_tiny", "lenet5", "resnet20")
# Per tier, each row id's prediction: tier 0 sure of about a third of the
# rows, tier 1 of most of the rest, the flagship of none in particular.
_RNG = np.random.RandomState(21)
TABLE = {name: _probs(_RNG, N_IDS, sharp) for name, sharp in
         zip(TIER_NAMES + ("lenet5_new",), (6.0, 9.0, 2.0, 9.0))}


class _TierEngine:
    """A dispatch-protocol engine answering TABLE[name] per row id (the
    first value of the row); a batch holding a row id of ``fail_ids``
    fails."""

    input_shape = SHAPE
    ring_capacity = 2

    def __init__(self, impl, name: str, fail_ids=()) -> None:
        self.impl, self.name, self.fail_ids = impl, name, set(fail_ids)
        self.model_cfg = SimpleNamespace(name=name)
        self.profile_key = name
        self.rows = 0
        self.on_compile = self.on_quarantine = None

    def warmup(self, buckets=None):
        pass

    def param_bytes(self) -> int:
        return 1000

    def param_bytes_per_device(self) -> int:
        return 1000

    def dispatch(self, parts):
        x = np.concatenate(parts, axis=0)
        n = int(x.shape[0])
        self.rows += n
        h = self.impl.engine.InflightBatch(n, n)
        h.timings = {"h2d_ms": 0.1, "compute_ms": 0.1, "d2h_ms": 0.1}
        ids = x.reshape(n, -1)[:, 0].astype(int)
        if self.fail_ids & set(ids.tolist()):
            h.future.set_exception(RuntimeError(f"{self.name} failed"))
        else:
            h.future.set_result(TABLE[self.name][ids])
        return h


def _record(ids) -> str:
    x = np.zeros((len(ids), *SHAPE), np.float32)
    x.reshape(len(ids), -1)[:, 0] = ids
    return json.dumps({"instances": x.tolist()})


def _tuple(impl, payload, key, lane=None):
    fields, values = ("message", "key"), [payload, key]
    if lane is not None:
        fields, values = fields + ("qos_lane",), values + [lane]
    return impl.tuples.Tuple(values=values, fields=fields, source_component="spout",
                             root_ts=time.perf_counter())


def _cascade(impl, **kw):
    return impl.policy.CascadeConfig(
        enabled=True, tiers=TIER_NAMES, thresholds=(0.05, 0.2),
        checkpoints=("checkpoints/vit_tiny_digits", "checkpoints/lenet5_rgb_digits",
                     "checkpoints/resnet20_digits"), **kw)


def _model(impl, name="resnet20", ckpt="checkpoints/resnet20_digits"):
    return impl.config.ModelConfig(name=name, dtype="float32", num_classes=K,
                                   input_shape=SHAPE, checkpoint=ckpt)


async def _settle(bolt, coll, n_done, timeout_s=20.0):
    """Drain the bolt (its partial batches included), then wait until
    every tuple is acked or failed."""
    await bolt.flush()
    deadline = time.monotonic() + timeout_s
    while len(coll.acked) + len(coll.failed) < n_done:
        assert time.monotonic() < deadline, (len(coll.acked), len(coll.failed), n_done)
        await asyncio.sleep(0.005)


def _engines(impl, fail=None):
    fail = fail or {}
    return {name: _TierEngine(impl, name, fail.get(name, ())) for name in TIER_NAMES}


async def _serve(impl, monkeypatch, tuples_of, *, continuous=False, fail=None,
                 qos=None, cascade="tiers", base=None, max_batch=4, shed_level=0,
                 traced=False):
    engines = _engines(impl, fail)
    monkeypatch.setattr(impl.operator, "shared_engine",
                        lambda mc, *a, **k: engines[mc.name])
    batch = impl.config.BatchConfig(max_batch=max_batch, buckets=(max_batch,),
                                    max_wait_ms=10_000, max_inflight=1,
                                    continuous=continuous)
    kw = {"qos": qos, "cascade": _cascade(impl) if cascade == "tiers" else cascade,
          "passthrough": ("key",)}
    if impl.name == "port":
        kw["device"] = "cpu"
    bolt = impl.operator.InferenceBolt(base or _model(impl), batch, **kw)
    flight = impl.tracing.FlightRecorder()
    metrics = impl.metrics.MetricsRegistry()
    metrics.gauge("qos", "shed_level").set(float(shed_level))
    tracer = impl.tracing.Tracer(sample_rate=1.0) if traced else None
    ctx = impl.base.TopologyContext("infer", 0, 1, impl.config.Config(), metrics=metrics,
                                    flight=flight, tracer=tracer)
    coll = _Collector()
    bolt.prepare(ctx, coll)
    tuples = tuples_of(impl)
    for t in tuples:
        if tracer is not None:
            t.trace = tracer.maybe_trace()
        await bolt.execute(t)
    await _settle(bolt, coll, len(tuples))
    if continuous:
        for cb in set(bolt._cbs.values()):
            cb.close()
    out = {}
    for stream, values in coll.emitted:
        doc = json.loads(values[0])
        out.setdefault(values[-1], []).append(
            (stream, doc.get("predictions", doc.get("error"))))
    snap = metrics.snapshot()["infer"]
    return {
        "emitted": {k: sorted(v, key=str) for k, v in out.items()},
        "acked": sorted(t.get("key") for t in coll.acked),
        "failed": sorted(t.get("key") for t in coll.failed),
        "errors": len(coll.errors),
        "counters": {k: v for k, v in snap.items()
                     if k.startswith(("cascade_", "shed_", "dead_lettered"))},
        "events": sorted({ev["kind"] for ev in flight.tail(1000)}),
        "rows": {n: e.rows for n, e in engines.items()},
        "inventory": ([{k: v for k, v in r.items() if k != "cost"}
                       for r in bolt._router.inventory()]),
        "traces": ({t.get("key"): _trace_shape(tracer.store.get(t.trace.trace_id))
                    for t in tuples} if tracer is not None else None),
    }


def _trace_shape(trace) -> list:
    """A trace without times or ids: per span its name, its parent's name
    and the names of the spans it links to."""
    spans = trace["spans"] if trace else []
    names = {sp["span_id"]: sp["name"] for sp in spans}
    return sorted((sp["name"], names.get(sp["parent_id"], "root"),
                   sorted(names.get(i, "?") for i in sp.get("links", ()))) for sp in spans)


def _records(impl):
    """Single- and multi-row records, one poison."""
    rng = np.random.RandomState(5)
    out, i = [], 0
    for rec in range(14):
        n = int(rng.randint(1, 4))
        out.append(_tuple(impl, _record(list(range(i, i + n))), f"r{rec}"))
        i += n
    out.append(_tuple(impl, '{"instances": [[1.0]]}', "poison"))
    return out


def _chunks(impl):
    """Lists of records and record frames, frame egress on."""
    out = []
    for c in range(4):
        payloads = [_record([8 * c + j, 8 * c + j + 1]) for j in range(0, 8, 2)]
        if c % 2:
            frame = impl.frames.RecordFrame([p.encode() for p in payloads])
            out.append(_tuple(impl, frame, f"f{c}"))
        else:
            out.append(_tuple(impl, payloads, f"l{c}"))
    return out


def _gc_off(impl):
    # storm_tpu's continuous registry deadlocks if a collection runs a
    # dead engine's finalizer under its lock (ROADMAP C3).
    if impl.name == "storm_tpu":
        gc.collect()
        gc.disable()


def _run_both(run, monkeypatch, tuples_of, **kw):
    got = {}
    for name, impl in IMPLS.items():
        if kw.get("continuous"):
            _gc_off(impl)
        try:
            got[name] = run(_serve(impl, monkeypatch, tuples_of, **kw), timeout=60)
        finally:
            gc.enable()
            monkeypatch.undo()
            jax_continuous._reset_registry()
            port_continuous._reset_registry()
    assert _plain(got["port"]) == _plain(got["storm_tpu"]), got
    return got["port"]


def _reference_tier(ids, thresholds=(0.05, 0.2)):
    u0 = jax_policy.uncertainty(TABLE["vit_tiny"][ids], "max_softmax", 1.0)
    u1 = jax_policy.uncertainty(TABLE["lenet5"][ids], "max_softmax", 1.0)
    return np.where(u0 < thresholds[0], 0, np.where(u1 < thresholds[1], 1, 2))


def test_bolt_batch_path_alike(run, monkeypatch):
    res = _run_both(run, monkeypatch, _records)
    assert res["acked"] == sorted([f"r{i}" for i in range(14)] + ["poison"])
    assert res["emitted"]["poison"][0][0] == "dead_letter"
    rows = sum(len(v[0][1]) for k, v in res["emitted"].items() if k != "poison")
    tiers = _reference_tier(np.arange(rows))
    assert [res["counters"][f"cascade_accepted_tier{i}"] for i in range(3)] == \
        np.bincount(tiers, minlength=3).tolist()
    assert "cascade_escalation" in res["events"]
    assert [r["tier"] for r in res["inventory"]] == [0, 1, 2]


@pytest.mark.parametrize("continuous", [False, True])
def test_bolt_traces_each_tier_alike(run, monkeypatch, continuous):
    """A record's trace holds one ``queue_wait`` and one ``cascade_tier{i}``
    span per tier it rode, the next tier's ``queue_wait`` linked back to
    the span of the batch that escalated it."""
    res = _run_both(run, monkeypatch, _singles, continuous=continuous, max_batch=1,
                    traced=True)
    tiers = _reference_tier(np.arange(24))
    for i, t in enumerate(tiers):
        spans = res["traces"][f"s{i}"]
        assert sorted(sp[0] for sp in spans) == sorted(
            [f"cascade_tier{k}" for k in range(t + 1)] + ["queue_wait"] * (t + 1))
        for k in range(1, t + 1):
            assert ("queue_wait", "root", [f"cascade_tier{k - 1}"]) in spans


def test_bolt_rows_merge_from_their_tiers(run, monkeypatch):
    res = _run_both(run, monkeypatch, lambda impl: [_tuple(impl, _record(list(range(10))),
                                                           "wide")])
    [(stream, preds)] = res["emitted"]["wide"]
    tiers = _reference_tier(np.arange(10))
    want = np.stack([TABLE[TIER_NAMES[t]][i] for i, t in enumerate(tiers)])
    np.testing.assert_allclose(np.asarray(preds), want, atol=1e-6)
    assert len(set(tiers.tolist())) > 1


def test_bolt_chunks_and_frames_alike(run, monkeypatch):
    res = _run_both(run, monkeypatch, _chunks)
    assert res["acked"] == ["f1", "f3", "l0", "l2"]
    rows = {k: sum(len(p) for _, p in v) for k, v in res["emitted"].items()}
    assert rows == {"l0": 8, "f1": 8, "l2": 8, "f3": 8}
    # a frame's records leave coalesced, a list's one message each
    assert len(res["emitted"]["l0"]) == 4 and len(res["emitted"]["f1"]) < 4


def test_bolt_tier_failure_fails_the_original(run, monkeypatch):
    res = _run_both(run, monkeypatch, _records, fail={"lenet5": {7}}, max_batch=1)
    assert res["failed"] and res["errors"] >= 1
    assert not set(res["failed"]) & set(res["emitted"])
    assert set(res["failed"]) | set(res["acked"]) == \
        {f"r{i}" for i in range(14)} | {"poison"}


def _singles(impl):
    return [_tuple(impl, _record([i]), f"s{i}") for i in range(24)]


def test_bolt_continuous_path_alike(run, monkeypatch):
    res = _run_both(run, monkeypatch, _singles, continuous=True, max_batch=1)
    assert res["acked"] == sorted(f"s{i}" for i in range(24))
    tiers = _reference_tier(np.arange(24))
    for i, t in enumerate(tiers):
        np.testing.assert_allclose(np.asarray(res["emitted"][f"s{i}"][0][1]),
                                   TABLE[TIER_NAMES[t]][[i]], atol=1e-6)
    failed = _run_both(run, monkeypatch, _singles, continuous=True, max_batch=1,
                       fail={"resnet20": set(np.flatnonzero(tiers == 2).tolist())})
    assert failed["failed"] == sorted(f"s{i}" for i in np.flatnonzero(tiers == 2))


# ---- degrade ---------------------------------------------------------------------------------


def _laned(impl):
    lanes = ("high", "normal", "best_effort")
    return [_tuple(impl, _record([i]), f"{lanes[i % 3]}{i}", lane=lanes[i % 3])
            for i in range(12)]


@pytest.mark.parametrize("continuous", [False, True])
def test_degrade_serves_shed_lanes_at_tier_0(run, monkeypatch, continuous):
    def qos(impl):
        return impl.config.QosConfig(enabled=True, degrade_model="lenet5")

    got = {}
    for name, impl in IMPLS.items():
        if continuous:
            _gc_off(impl)
        try:
            got[name] = run(_serve(impl, monkeypatch, _laned, qos=qos(impl), cascade=None,
                                   continuous=continuous, max_batch=1, shed_level=1),
                            timeout=60)
        finally:
            gc.enable()
            monkeypatch.undo()
            jax_continuous._reset_registry()
            port_continuous._reset_registry()
    assert _plain(got["port"]) == _plain(got["storm_tpu"])
    res = got["port"]
    for key, [(stream, preds)] in res["emitted"].items():
        i = int("".join(c for c in key if c.isdigit()))
        model = "lenet5" if key.startswith("best_effort") else "resnet20"
        np.testing.assert_allclose(np.asarray(preds), TABLE[model][[i]], atol=1e-6)
    assert res["counters"]["shed_degraded"] == 4
    assert "shed_degrade" in res["events"] and "cascade_accepted_tier0" in res["counters"]
    assert res["counters"]["cascade_shed_pinned"] == 4


# ---- the digits rows through a port topology -------------------------------------------------


def test_digits_rows_served_at_the_reference_tier(run):
    from storm_tpu_torch.api.schema import decode_predictions
    from storm_tpu_torch.config import BatchConfig, Config, ModelConfig, OffsetsConfig
    from storm_tpu_torch.connectors import MemoryBroker
    from storm_tpu_torch.data import load_digits_nhwc
    from storm_tpu_torch.infer.engine import shared_engine
    from storm_tpu_torch.main import build_standard_topology
    from storm_tpu_torch.models.registry import CHECKPOINTS
    from storm_tpu_torch.runtime import AsyncLocalCluster

    tags = ("vit_tiny_digits", "lenet5_rgb_digits", "resnet20_digits")
    thresholds, temperature = (0.02, 0.1), 1.25
    _, _, x, y = load_digits_nhwc((32, 32, 3))
    rows = np.arange(1, len(x), 2)[:64]
    with np.load(CHECKPOINTS / "reference_predictions.npz") as f:
        ref = [f[f"{t}/float32"][rows] for t in tags]
    u = [jax_policy.uncertainty(p, "max_softmax", temperature) for p in ref[:2]]
    want = np.where(u[0] < thresholds[0], 0, np.where(u[1] < thresholds[1], 1, 2))

    cfg = Config()
    cfg.model = ModelConfig.from_checkpoint("checkpoints/resnet20_digits", dtype="float32")
    cfg.batch = BatchConfig(max_batch=32, buckets=(8, 32), max_wait_ms=20)
    cfg.offsets = OffsetsConfig(policy="earliest", max_behind=None)
    cfg.topology.inference_parallelism = 2
    cfg.cascade = port_policy.CascadeConfig(
        enabled=True, tiers=("vit_tiny", "lenet5", "resnet20"),
        checkpoints=tuple(f"checkpoints/{t}" for t in tags), metric="max_softmax",
        thresholds=thresholds, temperature=temperature)

    async def serve():
        broker = MemoryBroker(default_partitions=2)
        cluster = AsyncLocalCluster()
        rt = await cluster.submit("digits", cfg, build_standard_topology(cfg, broker,
                                                                         device="cpu"))
        for i in rows:
            broker.produce("input", json.dumps({"instances": [x[i].tolist()]}))
        deadline = asyncio.get_running_loop().time() + 60
        while broker.topic_size("output") < len(rows):
            assert asyncio.get_running_loop().time() < deadline, "records stuck"
            await asyncio.sleep(0.01)
        await rt.drain(timeout_s=30)
        counters = rt.metrics.snapshot()["inference-bolt"]
        outs = broker.drain_topic("output")
        await cluster.shutdown()
        return outs, counters

    clear_engine_caches()
    outs, counters = run(serve(), timeout=120)
    batch = BatchConfig(max_batch=32, buckets=(8, 32))
    direct = [shared_engine(ModelConfig.from_checkpoint(f"checkpoints/{t}", dtype="float32"),
                            batch, device="cpu").predict(x[rows]) for t in tags]
    # each output is the direct forward of exactly one (row, tier)
    stacked = np.stack(direct)  # (tier, row, K)
    got = {}
    for r in outs:
        pred = decode_predictions(r.value).data[0]
        dist = np.abs(stacked - pred).max(axis=-1)
        tier, row = np.unravel_index(np.argmin(dist), dist.shape)
        assert dist[tier, row] < 1e-5 and row not in got, (row, dist[tier, row])
        got[row] = int(tier)
    served = np.array([got[j] for j in range(len(rows))])
    np.testing.assert_array_equal(served, want)
    assert [counters[f"cascade_accepted_tier{i}"] for i in range(3)] == \
        np.bincount(want, minlength=3).tolist()
    assert counters["cascade_escalations"] == int((want >= 1).sum() + (want == 2).sum())
    clear_engine_caches()


# ---- swap under continuous batching: the tier's queue follows (C11) ------------------------


async def _swap_flagship(impl, monkeypatch):
    """A shed-only degrade cascade (normal traffic enters at the flagship
    tier), continuous batching; swap the flagship, then serve one more."""
    engines = _engines(impl)
    new = _TierEngine(impl, "lenet5_new")
    built = {**engines, "lenet5_new": new}
    monkeypatch.setattr(impl.operator, "shared_engine", lambda mc, *a, **k: built[mc.name])
    batch = impl.config.BatchConfig(max_batch=1, buckets=(1,), max_wait_ms=1,
                                    continuous=True)
    kw = {"qos": impl.config.QosConfig(enabled=True, degrade_model="vit_tiny"),
          "passthrough": ("key",)}
    if impl.name == "port":
        kw["device"] = "cpu"
    bolt = impl.operator.InferenceBolt(_model(impl, "resnet20"), batch, **kw)
    ctx = impl.base.TopologyContext("infer", 0, 1, impl.config.Config(),
                                    metrics=impl.metrics.MetricsRegistry())
    coll = _Collector()
    bolt.prepare(ctx, coll)
    await bolt.execute(_tuple(impl, _record([3]), "before", lane="normal"))
    await _settle(bolt, coll, 1)
    await bolt.swap_model(_model(impl, "lenet5_new", None))
    await bolt.execute(_tuple(impl, _record([3]), "after", lane="normal"))
    await _settle(bolt, coll, 2)
    served = json.loads(coll.emitted[1][1][0])["predictions"][0]
    flagship = bolt._router.tiers[-1]
    out = {"tier_engine_is_new": flagship.engine is new,
           "old_rows": engines["resnet20"].rows, "new_rows": new.rows,
           "served_by_new": bool(np.allclose(served, TABLE["lenet5_new"][3], atol=1e-6))}
    for cb in set(bolt._cbs.values()):
        cb.close()
    return out


def test_swap_moves_the_flagship_tiers_queue(run, monkeypatch):
    got = {}
    for name, impl in IMPLS.items():
        _gc_off(impl)
        try:
            got[name] = run(_swap_flagship(impl, monkeypatch), timeout=60)
        finally:
            gc.enable()
            monkeypatch.undo()
            jax_continuous._reset_registry()
            port_continuous._reset_registry()
    # storm_tpu: the tier reports the new engine, the old one served
    assert got["storm_tpu"] == {"tier_engine_is_new": True, "old_rows": 2, "new_rows": 0,
                                "served_by_new": False}
    # the port: the tier's queue followed the swap
    assert got["port"] == {"tier_engine_is_new": True, "old_rows": 1, "new_rows": 1,
                           "served_by_new": True}
    assert not [t for t in threading.enumerate() if t.name.startswith("continuous")
                and t.is_alive() and not t.daemon]
