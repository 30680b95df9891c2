"""The port's decode tier (``storm_tpu_torch/decode/``, ``models/
chartiny.py``) against storm_tpu's on the CPU, side by side on the same
seeded inputs:

- chartiny's parameters byte-identical per seed, its stateless classify
  view within 1e-5;
- the engine's step on mixed prefill, step and classify rows within 1e-5
  with the same greedy tokens, the same early-exit counts and a complete
  arena after an exit; batched prefill equal to incremental steps;
- ``KV20`` blobs written by either package restore in the other; the
  same cost-aware eviction victim; the same refusals;
- the same requests give the same token streams through both
  ``DecodeBolt``s; replay exactly once after ``InjectedFailure``; a warm
  rebuild after eviction re-emits nothing; migration after a drain
  restores ``"kv"``;
- sticky routing over two tasks and a rolling restart on a running port
  cluster; ``decode_stats`` and ``Observatory.decode_snapshot``;
- the continuous batcher's predict-only branch.

storm_tpu's ``DecodeBolt.prepare`` builds its queue through
``continuous_for``, where a garbage collection deadlocks (ROADMAP C3), so
every storm_tpu bolt is prepared with the collector off.
"""

from __future__ import annotations

import asyncio
import contextlib
import gc
import json
from types import SimpleNamespace

import numpy as np
import pytest
import torch

import storm_tpu.config as jax_config
import storm_tpu.decode as jax_decode
import storm_tpu.decode.engine as jax_dengine
import storm_tpu.runtime.base as jax_base
import storm_tpu.runtime.metrics as jax_metrics
import storm_tpu.runtime.state as jax_state
import storm_tpu.runtime.tuples as jax_tuples
from storm_tpu.models import chartiny as jct
import storm_tpu_torch.config as port_config
import storm_tpu_torch.decode as port_decode
import storm_tpu_torch.decode.engine as port_dengine
import storm_tpu_torch.runtime.base as port_base
import storm_tpu_torch.runtime.metrics as port_metrics
import storm_tpu_torch.runtime.state as port_state
import storm_tpu_torch.runtime.tuples as port_tuples
from storm_tpu_torch.decode.session import state_kv_blob
from storm_tpu_torch.infer.continuous import ContinuousBatcher, continuous_for
from storm_tpu_torch.models import chartiny as pct
from storm_tpu_torch.models.convert import chartiny_params
from storm_tpu_torch.obs import copyledger

IMPLS = {
    "storm_tpu": SimpleNamespace(name="storm_tpu", decode=jax_decode, dengine=jax_dengine,
                                 config=jax_config, base=jax_base, metrics=jax_metrics,
                                 state=jax_state, tuples=jax_tuples, kw={}),
    "port": SimpleNamespace(name="port", decode=port_decode, dengine=port_dengine,
                            config=port_config, base=port_base, metrics=port_metrics,
                            state=port_state, tuples=port_tuples, kw={"device": "cpu"}),
}


@pytest.fixture(params=sorted(IMPLS))
def impl(request):
    return IMPLS[request.param]


@pytest.fixture(autouse=True)
def _fresh_engines():
    """Each test starts with empty shared-engine caches, and drops what it
    built (collected here, with no registry lock held)."""
    for m in IMPLS.values():
        m.dengine._reset_engines()
    yield
    for m in IMPLS.values():
        m.dengine._reset_engines()
    gc.collect()


@contextlib.contextmanager
def _gc_off():
    """storm_tpu's queue registry deadlocks on a collection under its lock
    (ROADMAP C3): collect first, then keep the collector off."""
    gc.collect()
    gc.disable()
    try:
        yield
    finally:
        gc.enable()


def _engine(impl, **kw):
    return impl.dengine.DecodeEngine(**kw, **impl.kw)


def _kv(impl, *args, **kw):
    return impl.decode.KvCacheManager(*args, **kw, **impl.kw)


def _arena(eng) -> np.ndarray:
    a = eng.kv.arena
    return a.numpy() if isinstance(a, torch.Tensor) else a


# ---- chartiny ------------------------------------------------------------------


@pytest.mark.parametrize("seed", [0, 7])
def test_chartiny_params_byte_identical(seed):
    ref, got = jct.build_params(seed), pct.build_params(seed)
    assert sorted(ref) == sorted(got)
    for k in ref:
        assert ref[k].dtype == got[k].dtype and ref[k].tobytes() == got[k].tobytes(), k
    assert pct.encode_text("Hi~é") == jct.encode_text("Hi~é")
    assert pct.decode_tokens([0, 40, 1, 97]) == jct.decode_tokens([0, 40, 1, 97])


def test_chartiny_classify_view_matches():
    """``stateless_logits`` and the registry's ``char_tiny`` module on the
    CPU, against storm_tpu's numpy view (1e-5)."""
    from storm_tpu_torch.models import build_model

    toks = np.array([0, 5, 40, 97], np.int64)
    ref = jct.stateless_logits(jct.build_params(4), toks)
    got = pct.stateless_logits(chartiny_params(pct.build_params(4), "cpu"),
                               torch.from_numpy(toks)).numpy()
    np.testing.assert_allclose(got, ref, rtol=0, atol=1e-5)
    model = build_model("char_tiny", device="cpu", seed=4, dtype=torch.float32)
    out = model(torch.from_numpy(toks[:, None].astype(np.float32))).detach().numpy()
    np.testing.assert_allclose(out, ref, rtol=0, atol=1e-5)


# ---- the engine's step -----------------------------------------------------------


def _mixed_rounds(eng_ref, eng_port, steps: int = 4):
    """Prefill two sessions and two classify rows in one batch, then
    ``steps`` greedy steps of both sessions co-batched with a classify
    row, in both engines; returns the max logit difference."""
    prompts = {"a": [jct.BOS] + jct.encode_text("hello world"),
               "b": [jct.BOS] + jct.encode_text("storm")}
    slots = {sid: (eng_ref.kv.acquire(sid), eng_port.kv.acquire(sid)) for sid in prompts}
    assert all(r == p for r, p in slots.values())
    rows = np.concatenate([eng_ref.prefill_rows(slots[s][0], p) for s, p in prompts.items()]
                          + [np.array([[-1, 40, 0], [-1, 5, 0]])])
    worst = 0.0
    pos = {s: len(p) for s, p in prompts.items()}
    for step in range(steps + 1):
        ref, got = eng_ref.predict(rows), eng_port.predict(rows)
        assert got.shape == ref.shape == (len(rows), jct.VOCAB) and got.dtype == np.float32
        worst = max(worst, float(np.abs(got - ref).max()))
        assert (got.argmax(1) == ref.argmax(1)).all()
        last = {}
        ofs = 0
        for s, p in prompts.items():
            n = len(p) if step == 0 else 1
            last[s] = int(ref[ofs + n - 1].argmax())
            ofs += n
        rows = np.array([[slots[s][0], last[s], pos[s]] for s in prompts] + [[-1, 7 + step, 0]])
        for s in prompts:
            pos[s] += 1
    return worst


@pytest.mark.parametrize("threshold", [None, 0.0, 0.03])
def test_engine_mixed_rows_match(threshold):
    """Mixed prefill, step and classify rows: logits within 1e-5, the same
    greedy tokens, the same early exits, the same arena and lengths."""
    ref = _engine(IMPLS["storm_tpu"], seed=3, blocks=4, max_seq=64,
                  early_exit_threshold=threshold)
    port = _engine(IMPLS["port"], seed=3, blocks=4, max_seq=64,
                   early_exit_threshold=threshold)
    assert _mixed_rounds(ref, port) <= 1e-5
    assert port.early_exits == ref.early_exits
    assert (threshold is None) == (port.early_exits == 0)
    np.testing.assert_allclose(_arena(port), ref.kv.arena, rtol=0, atol=1e-5)
    assert (port.kv.lens == ref.kv.lens).all()
    assert {k: v for k, v in port.stats().items() if k != "kv"} == \
        {k: v for k, v in ref.stats().items() if k != "kv"}


def test_engine_early_exit_keeps_cache_complete():
    """Every row exits after layer 0, and layer 1 of the arena still holds
    every position, as in storm_tpu."""
    engines = [_engine(i, seed=0, blocks=2, max_seq=16, early_exit_threshold=0.0)
               for i in IMPLS.values()]
    for eng in engines:
        slot = eng.kv.acquire("a")
        rows = eng.prefill_rows(slot, [jct.BOS] + jct.encode_text("hi"))
        eng.predict(rows)
        assert eng.early_exits == len(rows) and int(eng.kv.lens[slot]) == len(rows)
        assert (np.abs(_arena(eng)[slot, 1, :, :len(rows)]).sum(-1) > 0).all()
    np.testing.assert_allclose(_arena(engines[1]), _arena(engines[0]), rtol=0, atol=1e-5)


def test_engine_batched_prefill_equals_incremental_steps():
    """A prompt as one batch of rows leaves the same cache and the same
    last logits as the same prompt fed one token at a time (1e-5)."""
    prompt = [jct.BOS] + jct.encode_text("storm")
    one = _engine(IMPLS["port"], seed=1, blocks=2, max_seq=32)
    s1 = one.kv.acquire("a")
    batch_logits = one.predict(one.prefill_rows(s1, prompt))
    inc = _engine(IMPLS["port"], seed=1, blocks=2, max_seq=32)
    s2 = inc.kv.acquire("a")
    for i, tok in enumerate(prompt):
        step_logits = inc.predict(np.array([[s2, tok, i]], np.int64))
    np.testing.assert_allclose(batch_logits[-1], step_logits[0], rtol=0, atol=1e-5)
    np.testing.assert_allclose(_arena(one)[s1, :, :, :len(prompt)],
                               _arena(inc)[s2, :, :, :len(prompt)], rtol=0, atol=1e-5)
    assert int(one.kv.lens[s1]) == int(inc.kv.lens[s2]) == len(prompt)


def test_engine_refusals_and_default_device(impl):
    eng = _engine(impl, seed=0, blocks=1, max_seq=4)
    with pytest.raises(ValueError, match=r"\(B, 3\)"):
        eng.predict(np.zeros((2, 2), np.int64))
    slot = eng.kv.acquire("a")
    with pytest.raises(ValueError, match="exceeds kv arena max_seq 4"):
        eng.predict(np.array([[slot, 5, 4]], np.int64))
    if impl.name == "port" and not torch.cuda.is_available():
        # The port's entry points run on the card unless asked for the CPU.
        for make in (lambda: port_dengine.DecodeEngine(blocks=1),
                     lambda: port_dengine.shared_decode_engine(blocks=1),
                     lambda: port_decode.KvCacheManager(1, 2, 4, 8)):
            with pytest.raises(RuntimeError, match="no CUDA device"):
                make()


def test_shared_engine_keyed_by_config_and_device():
    from storm_tpu_torch.infer.engine import live_engines

    a = port_dengine.shared_decode_engine(seed=7, blocks=4, device="cpu")
    assert port_dengine.shared_decode_engine(seed=7, blocks=4, device="cpu") is a
    assert port_dengine.shared_decode_engine(seed=8, blocks=4, device="cpu") is not a
    assert a.device == torch.device("cpu") and a.kv.arena.device == torch.device("cpu")
    assert a in live_engines()
    assert a.model_cfg.name == "char_tiny" and a.ring_capacity == 1


# ---- the arena -------------------------------------------------------------------


@pytest.mark.parametrize("writer,reader", [("port", "storm_tpu"), ("storm_tpu", "port")])
def test_kv20_blob_crosses_packages(writer, reader):
    """A session's prefix serialized by one package restores in the other,
    byte-identical in both directions."""
    src = _engine(IMPLS[writer], seed=5, blocks=2, max_seq=32)
    slot = src.kv.acquire("s")
    src.predict(src.prefill_rows(slot, [jct.BOS] + jct.encode_text("migrate me")))
    blob = src.kv.serialize("s")
    assert blob[:4] == b"KV20" and src.kv.serialize("missing") is None
    dst = _kv(IMPLS[reader], 3, jct.N_LAYERS, 32, jct.D_MODEL)
    s2 = dst.restore("s", blob)
    assert int(dst.lens[s2]) == int(src.kv.lens[slot]) == 11
    n = int(dst.lens[s2])
    arena = dst.arena.numpy() if isinstance(dst.arena, torch.Tensor) else dst.arena
    np.testing.assert_array_equal(arena[s2, :, :, :n], _arena(src)[slot, :, :, :n])
    assert dst.serialize("s") == blob


def test_serialize_many_equals_serialize():
    """One read of the arena for several sessions gives each session the
    blob ``serialize`` gives (a checkpoint folds them all at once)."""
    eng = _engine(IMPLS["port"], seed=6, blocks=4, max_seq=32)
    for sid, text in (("a", "one"), ("b", "a longer prompt"), ("c", "")):
        slot = eng.kv.acquire(sid)
        eng.predict(eng.prefill_rows(slot, [jct.BOS] + jct.encode_text(text)))
    eng.kv.acquire("empty")
    blobs = eng.kv.serialize_many(["c", "a", "gone", "b", "empty"])
    assert sorted(blobs) == ["a", "b", "c", "empty"]
    assert all(blobs[sid] == eng.kv.serialize(sid) for sid in blobs)
    assert eng.kv.serialize_many([]) == {} and eng.kv.serialize_many(["gone"]) == {}


def test_kv_eviction_picks_the_same_victim():
    """Victim = smallest cached_len / age (not LRU), in both packages."""
    got = {}
    for name, impl in IMPLS.items():
        now = [0.0]
        evicted = []
        kv = _kv(impl, 3, 1, 16, 2, clock=lambda: now[0],
                 on_evict=lambda sid, n: evicted.append((sid, n)))
        for sid, t, n in (("long", 0.0, 12), ("short", 5.0, 1), ("mid", 5.5, 4)):
            now[0] = t
            kv.acquire(sid)
            kv.advance(kv.slot_of(sid), n)
        now[0] = 6.0
        kv.acquire("new1")  # short 1/1 < long 12/6 < mid 4/0.5: not LRU
        kv.advance(kv.slot_of("new1"), 6)
        kv.pin("long")
        now[0] = 7.0
        kv.acquire("new2")  # long pinned; mid 4/1.5 < new1 6/1
        got[name] = (evicted, kv.evictions, kv.occupancy())
    assert got["port"] == got["storm_tpu"]
    assert got["port"][0] == [("short", 1), ("mid", 4)]


def test_kv_touch_append_and_greedy_step_match():
    """``touch`` freshens a session's age (so eviction spares it) and
    ``append`` writes one position's k and v and extends the length on the
    last layer, with the same effect on the arena in both packages; then
    ``greedy_step`` gives storm_tpu's token for char_tiny from one init,
    step after step, and leaves the same arena."""
    got = {}
    rng = np.random.default_rng(5)
    rows = [(layer, pos, rng.standard_normal(4).astype(np.float32),
             rng.standard_normal(4).astype(np.float32))
            for pos in range(3) for layer in range(2)]
    for name, impl in IMPLS.items():
        now = [0.0]
        evicted = []
        kv = _kv(impl, 2, 2, 8, 4, clock=lambda: now[0],
                 on_evict=lambda sid, n: evicted.append(sid))
        a = kv.acquire("a")
        now[0] = 1.0
        b = kv.acquire("b")
        for layer, pos, k, v in rows:
            kv.append(a, layer, pos, k, v)
        kv.append(b, 0, 5, rows[0][2], rows[0][3])  # layer 0 only: no length
        now[0] = 10.0
        kv.touch("a")
        kv.touch("gone")  # no live lease: nothing happens
        now[0] = 11.0
        kv.acquire("c")  # a 3/1 beats b 0/10
        arena = kv.arena.numpy() if isinstance(kv.arena, torch.Tensor) else kv.arena
        got[name] = (evicted, kv.lens.tolist(), arena.copy())
    assert got["port"][:2] == got["storm_tpu"][:2] == (["b"], [3, 0])
    np.testing.assert_array_equal(got["port"][2], got["storm_tpu"][2])

    engines = {name: _engine(impl, seed=2, blocks=2, max_seq=32) for name, impl in IMPLS.items()}
    tokens = {}
    for name, eng in engines.items():
        slot = eng.kv.acquire("s")
        tok, out = jct.BOS, []
        for pos in range(12):
            tok = eng.greedy_step(slot, tok, pos)
            out.append(tok)
        tokens[name] = out
    assert tokens["port"] == tokens["storm_tpu"]
    np.testing.assert_allclose(_arena(engines["port"]), _arena(engines["storm_tpu"]),
                               rtol=0, atol=1e-5)


def test_kv_leases_pins_and_refusals(impl):
    kv = _kv(impl, 1, 2, 8, 3)
    s = kv.acquire("a")
    assert kv.acquire("a") == s and kv.occupancy()["arena_bytes"] == 1 * 2 * 2 * 8 * 3 * 4
    kv.pin("a")
    with pytest.raises(impl.decode.ArenaFullError):
        kv.acquire("b")
    kv.unpin("a")
    kv.advance(s, 2)
    blob = kv.serialize("a")
    for bad, msg in ((b"short", "shorter than its header"), (b"XXXX" + blob[4:], "bad magic"),
                     (blob[:-4], "body")):
        with pytest.raises(ValueError, match=msg):
            kv.restore("x", bad)
    with pytest.raises(ValueError, match="do not match"):
        _kv(impl, 1, 3, 8, 3).restore("x", blob)
    kv.acquire("b")
    assert kv.slot_of("a") is None and kv.evictions == 1


# ---- the session tier ------------------------------------------------------------


def test_session_state_and_store_stats_match():
    got = {}
    for name, impl in IMPLS.items():
        sess = impl.decode.DecodeSession("s1", prompt=[0, 5, 6], max_new_tokens=4,
                                         tokens=[9, 9], committed=1)
        snap = json.loads(json.dumps(sess.to_state(kv_blob=b"\x00\x01kv")))
        back = impl.decode.DecodeSession.from_state(snap)
        store = impl.decode.SessionStore("decode-bolt", 2)
        a = store.get_or_create("a", [0], 4)
        store.get_or_create("a", [0], 4)
        store.get_or_create("b", [0, 1], 4).tokens = [7]
        a.tokens, a.committed, a.done = [5, 6], 2, True
        got[name] = (snap, back.context, store.stats(),
                     store in impl.decode.SessionStore.all_stores())
    assert got["port"] == got["storm_tpu"]
    assert state_kv_blob(got["port"][0]) == b"\x00\x01kv"


# ---- DecodeBolt, standalone --------------------------------------------------------


class _Collector:
    """A fake OutputCollector recording anchored emits, acks and fails."""

    def __init__(self):
        self.emitted, self.acked, self.failed = [], [], []

    async def emit(self, values, stream="default", anchors=None, **kw):
        self.emitted.append((list(values), list(anchors or ())))

    def ack(self, t):
        self.acked.append(t)

    def fail(self, t):
        self.failed.append(t)


def _mk_bolt(impl, **cfg_kw):
    cfg_kw.setdefault("arena_blocks", 4)
    bolt = impl.decode.DecodeBolt(impl.decode.DecodeConfig(**cfg_kw), **impl.kw)
    col = _Collector()
    ctx = impl.base.TopologyContext("decode-bolt", 0, 1, impl.config.Config(),
                                    metrics=impl.metrics.MetricsRegistry())
    with _gc_off():
        bolt.prepare(ctx, col)
    bolt.init_state(impl.state.KeyValueState())
    return bolt, col


def _req(impl, sid, prompt="hello", n=6):
    return impl.tuples.Tuple(values=[{"session_id": sid, "prompt": prompt,
                                      "max_new_tokens": n}],
                             fields=("message",), source_component="spout")


async def _drive(bolt, t):
    await bolt.execute(t)
    while bolt._tasks:
        await asyncio.gather(*list(bolt._tasks), return_exceptions=True)


def _stream(col, sid):
    """(token_index, message) pairs emitted for one session, in order."""
    return [(v[2], v[0]) for v, _ in col.emitted if v[1] == sid]


def _close(bolt):
    """Drop the shared engine a bolt used: the next scenario builds a fresh
    engine and queue (a queue closes when its engine dies)."""
    impl = IMPLS["port" if isinstance(bolt, port_decode.DecodeBolt) else "storm_tpu"]
    impl.dengine._reset_engines()


def test_bolts_give_the_same_token_streams(run):
    """The same five requests (and one follow-up turn) through each
    package's DecodeBolt: identical anchored streams, identical logs."""
    reqs = [("s0", "hello", 6), ("s1", "the quick brown fox", 8), ("s2", "", 5),
            ("s3", "Storm!", 7), ("s4", "~~", 4), ("s1", "", 3)]

    async def serve(impl):
        bolt, col = _mk_bolt(impl, seed=11, max_new_tokens=8)
        try:
            for sid, prompt, n in reqs:
                await _drive(bolt, _req(impl, sid, prompt, n))
            assert len(col.acked) == len(reqs) and not col.failed
            assert all(len(a) == 1 for _, a in col.emitted)
            return ({sid: _stream(col, sid) for sid, _, _ in reqs},
                    {s.session_id: s.tokens for s in bolt.sessions.all()},
                    bolt.sessions.tokens_emitted)
        finally:
            _close(bolt)

    got = {name: run(serve(impl), timeout=60) for name, impl in IMPLS.items()}
    assert got["port"] == got["storm_tpu"]
    streams = got["port"][0]
    for sid, pairs in streams.items():
        assert [i for i, _ in pairs] == list(range(len(pairs))) and pairs


def test_bolt_replay_exactly_once(run):
    """An injected failure after 3 tokens fails the request; its replay
    continues from the watermark, gapless and duplicate-free, and the log
    equals storm_tpu's uninterrupted run."""
    async def scenario():
        bolt, col = _mk_bolt(IMPLS["port"], seed=12, max_new_tokens=10)
        try:
            t = _req(IMPLS["port"], "s1", n=10)
            bolt.fail_after_tokens = 3
            await _drive(bolt, t)
            assert col.failed == [t] and not col.acked and len(_stream(col, "s1")) == 3
            t2 = _req(IMPLS["port"], "s1", n=10)
            await _drive(bolt, t2)
            assert col.acked == [t2]
            return _stream(col, "s1"), bolt.sessions.get("s1").tokens
        finally:
            _close(bolt)

    async def reference():
        bolt, col = _mk_bolt(IMPLS["storm_tpu"], seed=12, max_new_tokens=10)
        try:
            await _drive(bolt, _req(IMPLS["storm_tpu"], "s1", n=10))
            return _stream(col, "s1"), bolt.sessions.get("s1").tokens
        finally:
            _close(bolt)

    got, ref = run(scenario(), timeout=60), run(reference(), timeout=60)
    assert got == ref and [i for i, _ in got[0]] == list(range(len(got[0]))) and len(got[0]) > 3


def test_bolt_warm_rebuild_after_eviction_reemits_nothing(run):
    """A one-block arena: b evicts a; a's follow-up turn re-prefills from
    its log, emits only new indices, and continues as storm_tpu does."""
    async def serve(impl):
        bolt, col = _mk_bolt(impl, seed=14, arena_blocks=1, max_new_tokens=3)
        try:
            await _drive(bolt, _req(impl, "a", "first", 3))
            first = len(_stream(col, "a"))
            await _drive(bolt, _req(impl, "b", "second", 3))
            assert bolt.engine.kv.slot_of("a") is None and bolt._m_evicted.value >= 1
            await _drive(bolt, _req(impl, "a", "first", 3))
            pairs = _stream(col, "a")
            assert [i for i, _ in pairs] == list(range(len(pairs))) and len(pairs) > first
            return pairs, bolt.engine.kv.evictions
        finally:
            _close(bolt)

    got = {name: run(serve(impl), timeout=60) for name, impl in IMPLS.items()}
    assert got["port"] == got["storm_tpu"]


def test_bolt_drain_migration_restores_kv(run):
    """A drain in migrate mode suspends a live session and folds its KV
    into the checkpoint; a fresh task on a fresh arena restores it
    ``"kv"`` and finishes it above the watermark, with storm_tpu's log.
    storm_tpu's checkpoint restores in the port's bolt too."""
    port = IMPLS["port"]

    async def drained(impl):
        bolt, col = _mk_bolt(impl, seed=16, max_new_tokens=40)
        try:
            t = _req(impl, "s1", n=40)
            await bolt.execute(t)
            while len(col.emitted) < 3:
                await asyncio.sleep(0.001)
            await bolt.flush()
            assert col.failed == [t] and not col.acked
            return json.loads(json.dumps(bolt.state.snapshot()))
        finally:
            _close(bolt)

    async def resume(snap):
        port_dengine._reset_engines()
        bolt, col = _mk_bolt(port, seed=16, max_new_tokens=40)
        try:
            bolt.init_state(port.state.KeyValueState(snap))
            sess = bolt.sessions.get("s1")
            assert sess.restored == "kv" and bolt._m_migrated.value == 1
            slot = bolt.engine.kv.slot_of("s1")
            assert int(bolt.engine.kv.lens[slot]) >= len(sess.context) - 1
            committed = sess.committed
            await _drive(bolt, _req(port, "s1", n=40))
            idxs = [i for i, _ in _stream(col, "s1")]
            assert idxs == list(range(committed, committed + len(idxs))) and idxs
            assert bolt.sessions.sessions_cold == 0
            return bolt.sessions.get("s1").tokens
        finally:
            _close(bolt)

    async def uninterrupted():
        bolt, _ = _mk_bolt(IMPLS["storm_tpu"], seed=16, max_new_tokens=40)
        try:
            await _drive(bolt, _req(IMPLS["storm_tpu"], "s1", n=40))
            return bolt.sessions.get("s1").tokens
        finally:
            _close(bolt)

    want = run(uninterrupted(), timeout=60)
    for impl in IMPLS.values():
        snap = run(drained(impl), timeout=60)
        assert "kv_b64" in snap["sess:s1"] and not snap["sess:s1"]["done"]
        assert snap["sess:s1"]["committed"] == len(snap["sess:s1"]["tokens"])
        assert run(resume(snap), timeout=60) == want


def test_bolt_classify_rows_share_the_queue(run):
    """slot = -1 rows ride the decode engine's continuous queue and return
    the classify view's logits."""
    async def scenario():
        bolt, _ = _mk_bolt(IMPLS["port"], seed=15)
        try:
            await _drive(bolt, _req(IMPLS["port"], "s1", n=3))
            assert continuous_for(bolt.engine, bolt.cfg.batch) is bolt.batcher
            sub = bolt.batcher.submit(np.array([[port_decode.STATELESS, 40, 0]], np.int64),
                                      source="classify")
            out = await asyncio.wrap_future(sub.future)
            ref = jct.stateless_logits(jct.build_params(15), np.array([40]))
            np.testing.assert_allclose(out[0], ref[0], rtol=0, atol=1e-5)
            st = bolt.engine.stats()
            assert st["rows_classify"] >= 1 and st["rows_decode"] >= 1
        finally:
            _close(bolt)

    run(scenario(), timeout=60)


def test_bolt_prunes_done_sessions_and_acks_garbage(run, impl):
    async def scenario():
        bolt, col = _mk_bolt(impl, seed=18, retain_done=2, max_new_tokens=2)
        try:
            for i in range(5):
                await _drive(bolt, _req(impl, f"s{i}", f"p{i}", 2))
            bad = impl.tuples.Tuple(values=["not json {"], fields=("message",),
                                    source_component="spout")
            await _drive(bolt, bad)
            return (len([s for s in bolt.sessions.all() if s.done]),
                    sorted(bolt.state.snapshot()), col.acked[-1] is bad, len(col.emitted))
        finally:
            _close(bolt)

    done, keys, garbage_acked, emitted = run(scenario(), timeout=60)
    assert done == 2 and keys == ["sess:s3", "sess:s4"] and garbage_acked and emitted >= 5


# ---- the batcher's predict-only branch ---------------------------------------------


class _PredictOnly:
    """An engine with ``predict`` and no ``dispatch``."""

    def __init__(self, fail=False):
        self.model_cfg = SimpleNamespace(name="predict-only")
        self.calls = []
        self.fail = fail

    def predict(self, x):
        self.calls.append(np.array(x))
        if self.fail:
            raise ValueError("engine refused")
        return np.asarray(x, np.float32) * 2.0


def test_continuous_predict_only_branch():
    """Coalesced submissions run as one ``predict`` on the dispatcher
    thread, each future gets its own rows back; a failure fails every
    member with the engine's exception."""
    cfg = port_config.BatchConfig(max_batch=8, max_wait_ms=50.0, buckets=(8,))
    for fail in (False, True):
        eng = _PredictOnly(fail)
        cb = ContinuousBatcher(eng, cfg)
        try:
            subs = [cb.submit(np.full((n, 3), i, np.int64), source=f"s{i}")
                    for i, n in enumerate((1, 3, 2))]
            for i, (sub, n) in enumerate(zip(subs, (1, 3, 2))):
                if fail:
                    with pytest.raises(ValueError, match="engine refused"):
                        sub.future.result(timeout=10)
                else:
                    np.testing.assert_array_equal(sub.future.result(timeout=10),
                                                  np.full((n, 3), 2.0 * i, np.float32))
            assert sum(len(c) for c in eng.calls) == 6 and len(eng.calls) <= 3
            assert cb.stats()["inflight"] == 0
        finally:
            cb.close()


# ---- on a running port cluster -----------------------------------------------------


def _capture_cls(base):
    class Cap(base.Bolt):
        seen = []

        async def execute(self, t):
            Cap.seen.append((t.get("session_id"), t.get("token_index"), t.get("message")))
            self.collector.ack(t)

    return Cap


def _topo_cfg(**kw):
    cfg = port_config.Config()
    cfg.topology.message_timeout_s = kw.pop("message_timeout_s", 20.0)
    cfg.topology.checkpoint_interval_s = kw.pop("checkpoint_interval_s", 0.05)
    for k, v in kw.items():
        setattr(cfg.topology, k, v)
    return cfg


def test_cluster_sticky_routing_over_two_tasks(run):
    """ring_fields_grouping("session_id"): each session's requests and
    tokens on one of two tasks, both used, owners disjoint, every stream
    gapless and equal to storm_tpu's standalone bolt's."""
    from storm_tpu_torch.runtime import TopologyBuilder
    from storm_tpu_torch.runtime.cluster import AsyncLocalCluster

    reqs = [{"session_id": f"s{i}", "prompt": f"prompt {i}", "max_new_tokens": 4}
            for i in range(8)]
    Cap = _capture_cls(port_base)

    async def scenario():
        b = TopologyBuilder()
        b.set_spout("requests", port_decode.SessionSpout(reqs), 1)
        b.set_bolt("decode-bolt", port_decode.DecodeBolt(
            port_decode.DecodeConfig(seed=21, arena_blocks=16), device="cpu"), 2) \
            .ring_fields_grouping("requests", "session_id")
        b.set_bolt("capture", Cap(), 1).shuffle_grouping("decode-bolt")
        cluster = AsyncLocalCluster()
        rt = await cluster.submit("decode-sticky", _topo_cfg(), b.build())
        try:
            sp = rt.spout_execs["requests"][0].spout
            for _ in range(400):
                if len(sp.acked) >= len(reqs):
                    break
                await asyncio.sleep(0.05)
            assert len(sp.acked) == len(reqs) and not sp.failed
            owners = {}
            for ex in rt.bolt_execs["decode-bolt"]:
                for sess in ex.bolt.sessions.all():
                    assert sess.session_id not in owners
                    owners[sess.session_id] = ex.bolt.sessions.task_index
            return owners
        finally:
            await cluster.shutdown()

    async def reference():
        bolt, col = _mk_bolt(IMPLS["storm_tpu"], seed=21, arena_blocks=16)
        try:
            for r in reqs:
                await _drive(bolt, _req(IMPLS["storm_tpu"], r["session_id"], r["prompt"], 4))
            return col
        finally:
            _close(bolt)

    owners = run(scenario(), timeout=90)
    assert set(owners) == {r["session_id"] for r in reqs} and len(set(owners.values())) == 2
    from storm_tpu.dist.ring import RingFieldsGrouping

    ring = RingFieldsGrouping("session_id")
    ring.prepare(2)
    for sid, task in owners.items():
        probe = jax_tuples.Tuple([None, sid], ("message", "session_id"), "requests")
        assert ring.choose(probe) == (task,)
    col = run(reference(), timeout=60)
    for sid in owners:
        got = sorted((i, m) for s, i, m in Cap.seen if s == sid)
        assert got == _stream(col, sid)


def test_cluster_rolling_restart_migrates_sessions(run, tmp_path):
    """A graceful kill mid-generation with the file backend, then the same
    topology again: every live session restored ``"kv"`` (none cold), the
    streams gapless and duplicate-free, ``kv_migrate`` rows in the copy
    ledger."""
    from storm_tpu_torch.runtime import TopologyBuilder
    from storm_tpu_torch.runtime.cluster import AsyncLocalCluster

    reqs = [{"session_id": f"m{i}", "prompt": f"migrate {i}", "max_new_tokens": 120}
            for i in range(3)]
    Cap = _capture_cls(port_base)
    cfg = _topo_cfg(checkpoint_interval_s=30.0, state_dir=str(tmp_path))

    def build():
        b = TopologyBuilder()
        b.set_spout("requests", port_decode.SessionSpout(reqs), 1)
        b.set_bolt("decode-bolt", port_decode.DecodeBolt(port_decode.DecodeConfig(
            seed=22, arena_blocks=8, drain_mode="migrate"), device="cpu"), 1) \
            .ring_fields_grouping("requests", "session_id")
        b.set_bolt("capture", Cap(), 1).shuffle_grouping("decode-bolt")
        return b.build()

    async def scenario():
        ledger = copyledger.ensure_installed()
        ledger.reset()
        cluster = AsyncLocalCluster()
        try:
            await cluster.submit("decode-migrate", cfg, build())
            for _ in range(800):
                if len({s for s, _, _ in Cap.seen}) == len(reqs) and len(Cap.seen) >= 6:
                    break
                await asyncio.sleep(0.01)
            await cluster.kill("decode-migrate", wait_secs=0.2)
            n_before = len(Cap.seen)
            rt2 = await cluster.submit("decode-migrate", cfg, build())
            sp = rt2.spout_execs["requests"][0].spout
            for _ in range(800):
                if len(sp.acked) >= len(reqs):
                    break
                await asyncio.sleep(0.05)
            bolt = rt2.bolt_execs["decode-bolt"][0].bolt
            restored = [s.restored for s in bolt.sessions.all() if s.restored]
            return (n_before, len(sp.acked), bolt.sessions.sessions_cold, restored,
                    ledger.snapshot()["stages"].get("kv_migrate", {}))
        finally:
            await cluster.shutdown()

    n_before, acked, cold, restored, migrate = run(scenario(), timeout=120)
    assert n_before >= 6 and acked == len(reqs) and len(Cap.seen) > n_before
    assert cold == 0 and restored and all(r == "kv" for r in restored)
    assert migrate and migrate["calls"] >= 2 * len(restored)
    for r in reqs:
        idxs = [i for s, i, _ in Cap.seen if s == r["session_id"]]
        assert sorted(idxs) == list(range(len(idxs))) and len(idxs) == len(set(idxs))


# ---- observability -----------------------------------------------------------------


def test_decode_stats_and_observatory_rows(run):
    """``decode_stats`` and ``Observatory.decode_snapshot`` hold real rows
    (the same keys as storm_tpu's), and the occupancy sweep has the decode
    engine's row."""
    async def serve(impl):
        bolt, _ = _mk_bolt(impl, seed=23)
        try:
            await _drive(bolt, _req(impl, "s1", n=3))
            d = impl.decode.decode_stats()
            if impl.name == "storm_tpu":
                return d
            from storm_tpu_torch.obs import Observatory

            rt = SimpleNamespace(metrics=port_metrics.MetricsRegistry(), flight=None)
            obs = Observatory(rt)
            return d, obs.snapshot()["decode"], obs.occupancy()
        finally:
            _close(bolt)

    ref = run(serve(IMPLS["storm_tpu"]), timeout=60)
    got, snap, occupancy = run(serve(IMPLS["port"]), timeout=60)
    assert got["tokens_emitted"] == ref["tokens_emitted"] >= 1
    assert snap["tokens_emitted"] == got["tokens_emitted"] and snap["engines"]
    assert sorted(got) == sorted(ref)
    assert [sorted(r) for r in got["stores"]] == [sorted(r) for r in ref["stores"]]
    assert [sorted(e) for e in got["engines"]] == [sorted(e) for e in ref["engines"]]
    assert got["engines"][0]["engine"] == "char_tiny@decode"
    assert got["engines"][0]["kv"]["slots_used"] == 1
    assert any(r["engine"] == "char_tiny@decode" for r in occupancy)
