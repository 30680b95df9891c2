"""The port's cost profile (``storm_tpu_torch/obs/profile.py``) against
storm_tpu's on the CPU: the same ``record_batch`` / ``record_compile``
sequence gives the same snapshot, ``cost_of``, ``coverage`` and
``regressions``; and the port's engine feeds the store: batches counted
per (engine, bucket) equal the batches dispatched, one compile row per
cold bucket, reported outside the engine's lock.
"""

from __future__ import annotations

import numpy as np

import storm_tpu.obs.profile as jax_profile
import storm_tpu_torch.obs.profile as port_profile
from storm_tpu_torch.config import BatchConfig, ModelConfig
from storm_tpu_torch.infer import engine as port_engine
from storm_tpu_torch.infer.engine import InferenceEngine

SHAPE = (28, 28, 1)


def _drive(mod, baseline=None):
    store = mod.ProfileStore()
    rng = np.random.RandomState(3)
    for _ in range(120):
        key = ("lenet5", "vit_tiny@checkpoints/vit_tiny_digits")[rng.randint(2)]
        padded = (8, 32)[rng.randint(2)]
        timings = {"h2d_ms": float(rng.gamma(2.0, 0.3)),
                   "compute_ms": float(rng.gamma(3.0, 0.5)),
                   "d2h_ms": float(rng.gamma(1.5, 0.05))}
        if rng.rand() < 0.1:
            timings.pop("d2h_ms")
        store.record_batch(key, padded, int(rng.randint(1, padded + 1)), timings)
    for padded in (8, 32, 32):
        store.record_compile("lenet5", padded, float(rng.gamma(5.0, 20.0)))
    store.record_compile("cold-only", 8, 12.5)
    store.record_batch("lenet5", 8, 3, {})  # no timings: ignored
    out = {"snapshot": store.snapshot(),
           "cost_of": [store.cost_of(k, min_samples=m) for k in
                       ("lenet5", "vit_tiny@checkpoints/vit_tiny_digits", "cold-only",
                        "unknown") for m in (1, 40, 400)],
           "coverage": [store.coverage(m) for m in (1, 40)],
           "regressions_none": store.regressions()}
    if baseline is not None:
        store.load_baseline({"profile": baseline})
        out["regressions"] = store.regressions(factor=0.9, min_samples=10)
        out["regressions_strict"] = store.regressions(factor=1.5, min_samples=10)
    return out


def _halved(snap: dict) -> dict:
    """A baseline whose every stage mean is half the live one."""
    import copy

    base = copy.deepcopy(snap)
    for eng in base["engines"].values():
        for row in eng["buckets"].values():
            for st in row["stages"].values():
                st["mean"] = st["mean"] / 2
    return base


def test_same_sequence_gives_the_same_profile():
    first = _drive(port_profile)
    assert first == _drive(jax_profile)
    base = _halved(first["snapshot"])
    jax_out, port_out = _drive(jax_profile, base), _drive(port_profile, base)
    assert jax_out == port_out
    assert port_out["regressions"] and port_out["regressions_strict"]
    assert port_out["regressions_none"] == []
    # against its own snapshot nothing regressed
    store = port_profile.ProfileStore()
    store.load_baseline(first["snapshot"])
    assert store.regressions() == []


def test_bad_baseline_refused():
    for mod in (jax_profile, port_profile):
        store = mod.ProfileStore()
        try:
            store.load_baseline({"nope": 1})
        except ValueError:
            continue
        raise AssertionError(f"{mod.__name__} took a bad baseline")


def test_engine_feeds_the_store():
    store = port_profile.ProfileStore()
    try:
        eng = InferenceEngine(ModelConfig(name="lenet5", dtype="float32", num_classes=10,
                                          input_shape=SHAPE),
                              BatchConfig(max_batch=8, buckets=(4, 8)), device="cpu")
        locked = []

        class Sink:
            """Forwards to the store and notes whether the engine's lock
            was held during the call."""

            def record_batch(self, *a):
                store.record_batch(*a)

            def record_compile(self, *a):
                locked.append(eng._lock.locked())
                store.record_compile(*a)

        port_engine.set_profile_sink(Sink())
        hooked = []
        eng.on_compile = lambda padded, ms: hooked.append((padded, eng._lock.locked()))
        eng.warmup()
        rng = np.random.RandomState(0)
        sizes = [3, 8, 1, 4, 6, 2, 8]
        handles = [eng.dispatch((rng.rand(n, *SHAPE).astype(np.float32),)) for n in sizes]
        for h in handles:
            h.future.result(timeout=30)
        snap = store.snapshot()["engines"]["lenet5"]
        padded = [eng.pad_batch(n) for n in sizes]
        # warm-up dispatched one batch per bucket
        assert snap["buckets"]["4"]["batches"] == padded.count(4) + 1
        assert snap["buckets"]["8"]["batches"] == padded.count(8) + 1
        assert snap["buckets"]["8"]["rows"] == sum(n for n, p in zip(sizes, padded)
                                                   if p == 8) + 8
        assert {k: v["count"] for k, v in snap["compiles"].items()} == {"4": 1, "8": 1}
        assert locked == [False, False]  # reported outside the engine's lock
        assert sorted(p for p, _ in hooked) == [4, 8] and not any(h for _, h in hooked)
        cov = store.coverage(min_samples=2)["lenet5"]
        assert cov["compile_known"] == ["4", "8"]
        assert cov["buckets"]["8"]["status"] == "ok"
        # a batch beyond max_batch builds a bucket of its own, reported once
        eng.predict(rng.rand(11, *SHAPE).astype(np.float32))
        eng.predict(rng.rand(11, *SHAPE).astype(np.float32))
        assert store.snapshot()["engines"]["lenet5"]["compiles"]["11"]["count"] == 1
        eng._fetch_q.put(None)  # stop the fetch thread
        eng._fetch_thread.join(10)
        assert not eng._fetch_thread.is_alive()
    finally:
        port_engine.set_profile_sink(None)
    port_profile.ensure_installed()
    assert port_engine._profile_sink is port_profile.profile_store()
    port_profile.set_enabled(False)
    assert port_engine._profile_sink is None
    port_profile.set_enabled(True)
    assert port_engine._profile_sink is port_profile.profile_store()
