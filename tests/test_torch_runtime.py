"""The port's Storm runtime core (``storm_tpu_torch/runtime/``) against
storm_tpu's on the CPU, the behaviours of ``tests/test_runtime.py``
(the groupings and the builder are in ``tests/test_torch_groupings.py``):

- the ack ledger's XOR, live edges, ``watch`` and an ack before its
  anchor give the same event sequences;
- through a running topology, each package alike: shuffle delivery,
  anchoring over two hops, explicit and uncaught failures,
  ``emit_direct``, none and custom groupings, a live rebalance that loses
  no tuple, deactivate and activate, ``health``, a rebalance whose
  ``prepare`` raises rolled back, supervision of a chaos-crashed task
  (``executor_restarts``, the ``executor_restart`` and ``chaos_injection``
  flight events), tick tuples, the rate gauges, origins folded through
  anchoring, the capacity tracker after a rebalance, and the synchronous
  ``LocalCluster`` facades;
- a lenet5 InferenceBolt rebalanced 1 -> 3 -> 1 under traffic shares its
  engine and answers every record, in both packages alike.

Every cluster is shut down inside its test, with a timeout.
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
import storm_tpu.infer.engine as jax_engine
import storm_tpu.obs.capacity as jax_capacity
import storm_tpu.runtime as jax_runtime
import storm_tpu.runtime.acker as jax_acker
import storm_tpu.runtime.chaos as jax_chaos
import storm_tpu.runtime.cluster as jax_cluster
import storm_tpu.runtime.groupings as jax_groupings
import storm_tpu.runtime.tuples as jax_tuples
import storm_tpu_torch.config as port_config
import storm_tpu_torch.connectors as port_connectors
import storm_tpu_torch.infer as port_infer
import storm_tpu_torch.infer.engine as port_engine
import storm_tpu_torch.obs.capacity as port_capacity
import storm_tpu_torch.runtime as port_runtime
import storm_tpu_torch.runtime.acker as port_acker
import storm_tpu_torch.runtime.chaos as port_chaos
import storm_tpu_torch.runtime.cluster as port_cluster
import storm_tpu_torch.runtime.groupings as port_groupings
import storm_tpu_torch.runtime.tuples as port_tuples
from tests.test_torch_checkpoints import abstract_init  # noqa: F401  (fixture)
from tests.test_torch_copyledger import clear_engine_caches

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

IMPLS = {
    "storm_tpu": SimpleNamespace(
        name="storm_tpu", config=jax_config, runtime=jax_runtime, acker=jax_acker,
        chaos=jax_chaos, cluster=jax_cluster, groupings=jax_groupings, tuples=jax_tuples,
        connectors=jax_connectors, capacity=jax_capacity, infer=jax_infer,
        engine=jax_engine),
    "port": SimpleNamespace(
        name="port", config=port_config, runtime=port_runtime, acker=port_acker,
        chaos=port_chaos, cluster=port_cluster, groupings=port_groupings,
        tuples=port_tuples, connectors=port_connectors, capacity=port_capacity,
        infer=port_infer, engine=port_engine),
}


@pytest.fixture(params=sorted(IMPLS))
def impl(request):
    return IMPLS[request.param]


def components(impl):
    """The test components of ``tests/test_runtime.py``, on ``impl``'s
    Spout and Bolt. ``seen`` is shared by every clone of a CaptureBolt."""
    rt = impl.runtime
    Values = rt.Values
    seen: list = []

    class ListSpout(rt.Spout):
        """Emits each item once from task 0; records acks and fails;
        replays a failure once when asked."""

        def __init__(self, items, replay_on_fail=False, origins=None):
            self.items = list(items)
            self.replay_on_fail = replay_on_fail
            self.origins = origins

        def open(self, context, collector):
            super().open(context, collector)
            self.queue = list(self.items) if context.task_index == 0 else []
            self.acked, self.failed = [], []

        async def next_tuple(self):
            if not self.queue:
                return False
            item = self.queue.pop(0)
            kw = {}
            if self.origins is not None:
                kw["origins"] = self.origins(item)
            await self.collector.emit(Values([item]), msg_id=item, **kw)
            return True

        def ack(self, msg_id):
            self.acked.append(msg_id)

        def fail(self, msg_id):
            self.failed.append(msg_id)
            if self.replay_on_fail:
                self.queue.append(msg_id)
                self.replay_on_fail = False

    class CaptureBolt(rt.Bolt):
        async def execute(self, t):
            seen.append((self.context.task_index, t.get("message")))
            self.collector.ack(t)

    class PassBolt(rt.Bolt):
        async def execute(self, t):
            await self.collector.emit(Values([t.get("message")]), anchors=[t])
            self.collector.ack(t)

    class FailOnceBolt(rt.Bolt):
        failed_once = False

        async def execute(self, t):
            if not FailOnceBolt.failed_once:
                FailOnceBolt.failed_once = True
                self.collector.fail(t)
                return
            self.collector.ack(t)

    class ExplodingBolt(rt.Bolt):
        async def execute(self, t):
            raise RuntimeError("boom")

    return SimpleNamespace(ListSpout=ListSpout, CaptureBolt=CaptureBolt, PassBolt=PassBolt,
                           FailOnceBolt=FailOnceBolt, ExplodingBolt=ExplodingBolt,
                           seen=seen, Values=Values)


async def settle(rt, spout_id, n_items, timeout=10.0):
    """Wait until every tree the spout's task 0 emitted acked or failed."""
    deadline = asyncio.get_running_loop().time() + timeout
    while asyncio.get_running_loop().time() < deadline:
        live = rt.spout_execs[spout_id][0].spout
        if len(live.acked) + len(live.failed) >= n_items:
            await rt.drain(timeout_s=timeout)
            return True
        await asyncio.sleep(0.01)
    return False


async def one_hop(impl, items, bolt, parallelism=2, declare=None, cfg=None):
    """spout -> bolt, ``declare(declarer)`` subscribing the bolt (shuffle
    by default); returns (settled, spout, runtime)."""
    c = components(impl)
    cluster = impl.cluster.AsyncLocalCluster()
    b = impl.runtime.TopologyBuilder()
    b.set_spout("spout", c.ListSpout(items), 1)
    d = b.set_bolt("bolt", bolt, parallelism)
    (declare or (lambda x: x.shuffle_grouping("spout")))(d)
    rt = await cluster.submit("t", cfg or impl.config.Config(), b.build())
    try:
        ok = await settle(rt, "spout", len(items))
    finally:
        await cluster.shutdown()
    return ok, rt.spout_execs["spout"][0].spout, rt


# ---- the ack ledger ------------------------------------------------------------------

def _ledger_script(impl) -> list:
    """tests/test_runtime.py's ledger cases on one ledger each, as one
    event log: completions, counts, live edges and watch results."""
    A, new_id = impl.acker.AckLedger, impl.tuples.new_id
    log = []
    led = A(timeout_s=0)
    root = new_id()
    led.init_root(root, "m1", lambda m, ok, ts: log.append(("done", m, ok, ts)), 1.5)
    e1 = new_id()
    led.xor(root, e1)
    log.append(("inflight", led.inflight))
    led.xor(root, e1)
    log.append(("inflight", led.inflight, led.acked))
    # a tree of three edges
    root = new_id()
    led.init_root(root, "m", lambda m, ok, ts: log.append(("done", m, ok)), 0.0)
    e1, e2, e3 = new_id(), new_id(), new_id()
    for e in (e1, e2, e3, e1):
        led.xor(root, e)
    log.append(("open", led.inflight))
    led.xor(root, e2)
    led.xor(root, e3)
    # live edges and watch
    root = new_id()
    led.init_root(root, "w", lambda *a: None, 0.0)
    e1, e2, e3 = new_id(), new_id(), new_id()
    led.anchor(root, e1)
    led.anchor(root, e2)
    log.append(("live", led.outstanding(root)))
    lives = []
    log.append(("watch_live", led.watch_live(root, lives.append) and True))
    led.ack_edge(root, e1)
    led.anchor(root, e3)
    log.append(("live", led.outstanding(root), len(lives)))
    fates = []
    log.append(("watch", led.watch(root, fates.append)))
    led.ack_edge(root, e2)
    led.ack_edge(root, e3)
    log.append(("gone", led.outstanding(root), fates, len(lives),
                led.watch(root, fates.append), led.watch_live(root, lives.append)))
    # failure: watchers hear False
    r2 = new_id()
    led.init_root(r2, "f", lambda m, ok, ts: log.append(("done", m, ok)), 0.0)
    led.anchor(r2, new_id())
    fates2 = []
    led.watch(r2, fates2.append)
    led.fail_root(r2)
    log.append(("failed", fates2, led.outstanding(r2), led.failed))
    # an ack that overtakes its anchor
    done = []
    led = A(timeout_s=0)
    root = new_id()
    led.init_root(root, "e", lambda *a: done.append(a[:2]), 0.0)
    e_spout, e_fast, e_slow = new_id(), new_id(), new_id()
    led.anchor(root, e_spout)
    led.anchor(root, e_fast)
    led.ack_edge(root, e_slow)
    log.append(("early", led.outstanding(root)))
    led.ack_edge(root, e_spout)
    log.append(("early", led.outstanding(root)))
    led.anchor(root, e_slow)
    log.append(("early", led.outstanding(root), list(done)))
    led.ack_edge(root, e_fast)
    log.append(("early", led.outstanding(root), list(done)))
    # the timeout sweep
    led = A(timeout_s=0.01)
    r = new_id()
    led.init_root(r, "t", lambda m, ok, ts: log.append(("done", m, ok)), 0.0)
    led.anchor(r, new_id())
    time.sleep(0.03)
    log.append(("swept", led.sweep(), led.timed_out, led.failed))
    return log


def test_ledger_alike():
    got = _ledger_script(IMPLS["port"])
    assert got == _ledger_script(IMPLS["storm_tpu"])
    assert ("early", 1, []) in got and ("early", 0, [("e", True)]) in got
    assert ("gone", 0, [True], 3, False, False) in got  # a live watch per ack


# ---- through a running topology -----------------------------------------------------

def test_shuffle_delivers_all_and_acks(impl, run):
    c = components(impl)
    items = [f"m{i}" for i in range(50)]
    ok, spout, rt = run(one_hop(impl, items, c.CaptureBolt(), parallelism=3))
    assert ok and sorted(m for _, m in c.seen) == sorted(items)
    assert sorted(spout.acked) == sorted(items) and spout.failed == []
    assert {t for t, _ in c.seen} == {0, 1, 2}


def test_multi_hop_anchoring_and_origins(impl, run):
    """spout -> pass -> capture: a tree acks after both hops; the spout's
    origins reach the last hop."""
    c = components(impl)
    got = []

    class OriginBolt(impl.runtime.Bolt):
        async def execute(self, t):
            got.append((t.get("message"), sorted(t.origins)))
            self.collector.ack(t)

    async def go():
        cluster = impl.cluster.AsyncLocalCluster()
        b = impl.runtime.TopologyBuilder()
        b.set_spout("s", c.ListSpout(["a", "b", "c"],
                                     origins=lambda m: frozenset({("in", ord(m) % 2,
                                                                   ord(m))})), 1)
        b.set_bolt("mid", c.PassBolt(), 2).shuffle_grouping("s")
        b.set_bolt("end", OriginBolt(), 2).shuffle_grouping("mid")
        rt = await cluster.submit("t", impl.config.Config(), b.build())
        try:
            assert await settle(rt, "s", 3)
            return sorted(rt.spout_execs["s"][0].spout.acked)
        finally:
            await cluster.shutdown()

    assert run(go()) == ["a", "b", "c"]
    assert sorted(got) == [("a", [("in", 1, 97)]), ("b", [("in", 0, 98)]),
                           ("c", [("in", 1, 99)])]


def _fold_origins(impl, run) -> list:
    """A bolt anchored to several tuples carries their origins folded to
    the largest offset per partition."""
    out = []

    class Join(impl.runtime.Bolt):
        held: list = []

        async def execute(self, t):
            Join.held.append(t)
            if len(Join.held) == 3:
                await self.collector.emit(impl.runtime.Values(["j"]), anchors=Join.held)
                for h in Join.held:
                    self.collector.ack(h)

    class Sink(impl.runtime.Bolt):
        async def execute(self, t):
            out.append(sorted(t.origins))
            self.collector.ack(t)

    c = components(impl)
    origins = {"x": {("in", 0, 5), ("in", 1, 2)}, "y": {("in", 0, 9)}, "z": {("in", 1, 1)}}

    async def go():
        cluster = impl.cluster.AsyncLocalCluster()
        b = impl.runtime.TopologyBuilder()
        b.set_spout("s", c.ListSpout(["x", "y", "z"], origins=lambda m: frozenset(origins[m])))
        b.set_bolt("join", Join(), 1).shuffle_grouping("s")
        b.set_bolt("sink", Sink(), 1).shuffle_grouping("join")
        rt = await cluster.submit("t", impl.config.Config(), b.build())
        try:
            assert await settle(rt, "s", 3)
        finally:
            await cluster.shutdown()

    run(go())
    return out


def test_origins_fold_alike(run):
    got = {name: _fold_origins(impl, run) for name, impl in IMPLS.items()}
    assert got["port"] == got["storm_tpu"] == [[("in", 0, 9), ("in", 1, 2)]]


def test_explicit_fail_and_uncaught_exception(impl, run):
    c = components(impl)
    ok, spout, _ = run(one_hop(impl, ["x"], c.FailOnceBolt(), parallelism=1))
    assert ok and spout.failed == ["x"]
    ok, spout, rt = run(one_hop(impl, ["x", "y"], c.ExplodingBolt(), parallelism=1))
    assert ok and sorted(spout.failed) == ["x", "y"] and spout.acked == []
    assert len(rt.errors) == 2


def test_replay_after_fail(impl, run):
    c = components(impl)

    async def go():
        cluster = impl.cluster.AsyncLocalCluster()
        b = impl.runtime.TopologyBuilder()
        b.set_spout("s", c.ListSpout(["r"], replay_on_fail=True), 1)
        b.set_bolt("f", c.FailOnceBolt(), 1).shuffle_grouping("s")
        rt = await cluster.submit("t", impl.config.Config(), b.build())
        try:
            for _ in range(200):
                if rt.spout_execs["s"][0].spout.acked:
                    break
                await asyncio.sleep(0.02)
            live = rt.spout_execs["s"][0].spout
            return list(live.acked), list(live.failed)
        finally:
            await cluster.shutdown()

    assert run(go()) == (["r"], ["r"])


def test_emit_direct(impl, run):
    c = components(impl)

    class RouteBolt(impl.runtime.Bolt):
        async def execute(self, t):
            i = int(t.values[0][1:])
            await self.collector.emit_direct(i % 3, c.Values(t.values), anchors=[t])
            self.collector.ack(t)

    class BadRoute(impl.runtime.Bolt):
        async def execute(self, t):
            await self.collector.emit_direct(7, c.Values(t.values), anchors=[t])

    async def go(route):
        cluster = impl.cluster.AsyncLocalCluster()
        b = impl.runtime.TopologyBuilder()
        b.set_spout("s", c.ListSpout([f"m{i}" for i in range(12)]), 1)
        b.set_bolt("r", route, 1).shuffle_grouping("s")
        b.set_bolt("c", c.CaptureBolt(), 3).direct_grouping("r")
        b.set_bolt("other", c.CaptureBolt(), 1).shuffle_grouping("r")
        rt = await cluster.submit("t", impl.config.Config(), b.build())
        try:
            assert await settle(rt, "s", 12)
            return rt
        finally:
            await cluster.shutdown()

    run(go(RouteBolt()))
    # only the direct-grouped consumer, at the named task
    assert sorted(c.seen) == sorted((int(m[1:]) % 3, m) for m in (f"m{i}" for i in range(12)))
    c.seen.clear()
    rt = run(go(BadRoute()))
    assert c.seen == [] and len(rt.errors) == 12
    assert all("out of range" in str(e) for _, _, e in rt.errors)


def test_none_and_custom_grouping(impl, run):
    c = components(impl)

    class LastCharGrouping(impl.groupings.Grouping):
        def choose(self, t):
            return (int(t.values[0][-1]) % self.n,)

    async def go():
        cluster = impl.cluster.AsyncLocalCluster()
        b = impl.runtime.TopologyBuilder()
        b.set_spout("s", c.ListSpout([f"m{i}" for i in range(10)]), 1)
        b.set_bolt("p", c.PassBolt(), 2).none_grouping("s")
        b.set_bolt("c", c.CaptureBolt(), 2).custom_grouping("p", LastCharGrouping())
        rt = await cluster.submit("t", impl.config.Config(), b.build())
        try:
            assert await settle(rt, "s", 10)
        finally:
            await cluster.shutdown()

    run(go())
    assert sorted(c.seen) == sorted((int(m[-1]) % 2, m) for m in (f"m{i}" for i in range(10)))


def test_all_and_global_grouping(impl, run):
    c = components(impl)

    async def go():
        cluster = impl.cluster.AsyncLocalCluster()
        b = impl.runtime.TopologyBuilder()
        b.set_spout("s", c.ListSpout(["a", "b"]), 1)
        b.set_bolt("every", c.CaptureBolt(), 3).all_grouping("s")
        b.set_bolt("one", c.PassBolt(), 3).global_grouping("s")
        rt = await cluster.submit("t", impl.config.Config(), b.build())
        try:
            assert await settle(rt, "s", 2)
            return {e.task_index: e.n_executed for e in rt.bolt_execs["one"]}
        finally:
            await cluster.shutdown()

    assert run(go()) == {0: 2, 1: 0, 2: 0}
    assert sorted(c.seen) == sorted((t, m) for m in ("a", "b") for t in range(3))


def test_rebalance_live_loses_no_tuple(impl, run):
    c = components(impl)

    async def go():
        cluster = impl.cluster.AsyncLocalCluster()
        b = impl.runtime.TopologyBuilder()
        b.set_spout("s", c.ListSpout([f"m{i}" for i in range(300)]), 1)
        b.set_bolt("c", c.CaptureBolt(), 1).shuffle_grouping("s")
        rt = await cluster.submit("t", impl.config.Config(), b.build())
        try:
            await asyncio.sleep(0.02)
            await rt.rebalance("c", 4)
            grown = rt.parallelism_of("c")
            await asyncio.sleep(0.02)
            await rt.rebalance("c", 2)
            assert await settle(rt, "s", 300)
            with pytest.raises(ValueError):
                await rt.rebalance("c", 0)
            with pytest.raises(KeyError):
                await rt.rebalance("nope", 2)
            return grown, rt.parallelism_of("c"), rt.topology.specs["c"].parallelism, \
                sorted(rt.spout_execs["s"][0].spout.acked), rt.health()
        finally:
            await cluster.shutdown()

    grown, after, spec_p, acked, health = run(go())
    assert (grown, after, spec_p) == (4, 2, 2)
    assert len(acked) == 300 and sorted(m for _, m in c.seen) == sorted(acked)
    assert health["components"]["c"] == {"tasks": 2, "alive": 2}


def test_deactivate_activate(impl, run):
    """deactivate stops the spout pulling; a spout grown meanwhile comes
    up paused; activate resumes it; the spout's hooks are called."""
    c = components(impl)
    calls = []

    class HookedSpout(c.ListSpout):
        async def activate(self):
            calls.append("activate")

        async def deactivate(self):
            calls.append("deactivate")

    async def go():
        cluster = impl.cluster.AsyncLocalCluster()
        b = impl.runtime.TopologyBuilder()
        b.set_spout("s", HookedSpout([f"m{i}" for i in range(20000)]), 1)
        b.set_bolt("c", c.CaptureBolt(), 1).shuffle_grouping("s")
        rt = await cluster.submit("t", impl.config.Config(), b.build())
        try:
            await rt.deactivate()
            assert await rt.drain(timeout_s=30.0)
            spout = rt.spout_execs["s"][0].spout
            paused_at = len(spout.acked)
            await rt.rebalance("s", 2)
            paused = [e._active for e in rt.spout_execs["s"]]
            await asyncio.sleep(0.2)
            still = len(spout.acked)
            await rt.activate()
            deadline = asyncio.get_running_loop().time() + 10
            while asyncio.get_running_loop().time() < deadline and len(spout.acked) <= paused_at:
                await asyncio.sleep(0.01)
            return paused_at, paused, still, len(spout.acked), \
                [e._active for e in rt.spout_execs["s"]]
        finally:
            await cluster.shutdown()

    paused_at, paused, still, resumed, active = run(go())
    assert paused_at < 20000 and still == paused_at and resumed > paused_at
    assert paused == [False, False] and active == [True, True]
    # deactivate reaches the one task; activate both (the grown one too)
    assert calls == ["deactivate", "activate", "activate"]


def _rollback(impl, run):
    c = components(impl)

    class PickyBolt(c.CaptureBolt):
        def prepare(self, context, collector):
            super().prepare(context, collector)
            if context.task_index >= 2:
                raise ValueError("no third task")

    async def go():
        cluster = impl.cluster.AsyncLocalCluster()
        b = impl.runtime.TopologyBuilder()
        b.set_spout("s", c.ListSpout([f"m{i}" for i in range(20)]), 1)
        b.set_bolt("c", PickyBolt(), 1).shuffle_grouping("s")
        rt = await cluster.submit("t", impl.config.Config(), b.build())
        try:
            with pytest.raises(ValueError, match="no third task"):
                await rt.rebalance("c", 4)
            assert await settle(rt, "s", 20)
            return rt.parallelism_of("c"), len(rt.groups["c"].inboxes), rt.health()
        finally:
            await cluster.shutdown()

    got = run(go())
    assert len(c.seen) == 20
    return got


def test_rebalance_whose_prepare_raises_rolls_back(run):
    got = {name: _rollback(impl, run) for name, impl in IMPLS.items()}
    assert got["port"] == got["storm_tpu"]
    # task 2's prepare raised: the call took back task 1 too
    assert got["port"][:2] == (1, 1) and got["port"][2]["components"]["c"] == {
        "tasks": 1, "alive": 1}


def _supervised(impl, run) -> dict:
    """Crash the bolt's task 0 and the spout's task 0 with the chaos
    monkey: the sweep replaces both, on the same inbox; the spout stays
    deactivated; tick tuples reach the bolt."""
    c = components(impl)
    ticks = []

    class TickBolt(c.CaptureBolt):
        async def tick(self):
            ticks.append(self.context.task_index)

    async def go():
        cfg = impl.config.Config()
        cfg.topology.message_timeout_s = 1.0
        cfg.topology.tick_interval_s = 0.05
        cluster = impl.cluster.AsyncLocalCluster()
        b = impl.runtime.TopologyBuilder()
        b.set_spout("s", c.ListSpout([f"m{i}" for i in range(8)], replay_on_fail=True), 1)
        b.set_bolt("c", TickBolt(), 1).shuffle_grouping("s")
        rt = await cluster.submit("t", cfg, b.build())
        try:
            assert await settle(rt, "s", 8)
            inbox = rt.bolt_execs["c"][0].inbox
            monkey = impl.chaos.ChaosMonkey(rt, seed=0)
            monkey.crash_bolt("c", 0)
            rt.spout_execs["s"][0].spout.queue.append("late")
            for _ in range(200):
                if rt.metrics.snapshot().get("c", {}).get("executor_restarts", 0):
                    break
                await asyncio.sleep(0.02)
            replaced = rt.bolt_execs["c"][0]
            spout = rt.spout_execs["s"][0].spout
            for _ in range(300):
                if "late" in spout.acked:
                    break
                await asyncio.sleep(0.02)
            # The spout dies on its next pull; deactivated before the
            # supervisor (run by hand, the sweep paused) replaces it.
            rt._sweeper.cancel()
            monkey.crash_spout("s", 0)
            dead = rt.spout_execs["s"][0]
            for _ in range(500):
                if dead._task.done():
                    break
                await asyncio.sleep(0.002)
            await rt.deactivate()
            rt._supervise()
            health = rt.health()
            events = [(ev["kind"], ev.get("component"), ev.get("task"))
                      for ev in rt.flight.tail(100)
                      if ev["kind"] in ("executor_restart", "chaos_injection")]
            snap = rt.metrics.snapshot()
            return {"same_inbox": replaced.inbox is inbox, "late": "late" in spout.acked,
                    "failed": spout.failed, "restarts": (snap["c"]["executor_restarts"],
                                                         snap["s"]["executor_restarts"]),
                    "spout_active": rt.spout_execs["s"][0]._active,
                    "events": events, "health": health["components"],
                    "kills": monkey.kills, "ticks": bool(ticks)}
        finally:
            await cluster.shutdown()

    return run(go(), timeout=60)


def test_supervision_alike(run):
    got = {name: _supervised(impl, run) for name, impl in IMPLS.items()}
    assert got["port"] == got["storm_tpu"]
    port = got["port"]
    assert port["same_inbox"] and port["late"] and port["restarts"] == (1, 1)
    assert port["failed"] == ["late"]  # the tuple on the crashed task replayed
    assert port["events"] == [("chaos_injection", "c", 0), ("executor_restart", "c", 0),
                              ("chaos_injection", "s", 0), ("executor_restart", "s", 0)]
    assert port["spout_active"] is False  # the replacement kept the deactivation
    assert port["health"] == {"c": {"tasks": 1, "alive": 1}, "s": {"tasks": 1, "alive": 1}}
    assert port["ticks"]


def test_chaos_run_and_crash_random(impl, run):
    c = components(impl)

    async def go():
        cfg = impl.config.Config()
        cfg.topology.message_timeout_s = 1.0
        cluster = impl.cluster.AsyncLocalCluster()
        b = impl.runtime.TopologyBuilder()
        b.set_spout("s", c.ListSpout([f"m{i}" for i in range(400)], replay_on_fail=True), 1)
        b.set_bolt("c", c.CaptureBolt(), 2).shuffle_grouping("s")
        rt = await cluster.submit("t", cfg, b.build())
        try:
            monkey = impl.chaos.ChaosMonkey(rt, seed=3)
            target = monkey.crash_random()
            kills = await monkey.run(0.3, interval_s=0.1, components=["c"])
            for _ in range(200):
                h = rt.health()["components"]
                if all(v["alive"] == v["tasks"] for v in h.values()):
                    break
                await asyncio.sleep(0.02)
            return target, kills, rt.health()["components"]
        finally:
            await cluster.shutdown()

    target, kills, health = run(go(), timeout=60)
    assert target in ("c[0]", "c[1]", "s[0]") and kills >= 3
    assert health == {"c": {"tasks": 2, "alive": 2}, "s": {"tasks": 1, "alive": 1}}


def test_rate_gauges_and_health(impl, run):
    c = components(impl)

    class Trickle(impl.runtime.Spout):
        async def next_tuple(self):
            await asyncio.sleep(0.005)
            await self.collector.emit(c.Values(["x"]), msg_id=time.monotonic())
            return True

    async def go():
        cluster = impl.cluster.AsyncLocalCluster()
        b = impl.runtime.TopologyBuilder()
        b.set_spout("spout", Trickle(), 1)
        b.set_bolt("echo", c.PassBolt(), 2).shuffle_grouping("spout")
        cfg = impl.config.Config()
        cfg.topology.message_timeout_s = 1.0  # a sweep each 0.25 s
        rt = await cluster.submit("m", cfg, b.build())
        try:
            deadline = asyncio.get_running_loop().time() + 20
            while asyncio.get_running_loop().time() < deadline:
                snap = rt.metrics.snapshot()
                if snap.get("echo", {}).get("execute_rate", 0) > 0 and \
                        snap.get("spout", {}).get("ack_rate", 0) > 0:
                    break
                await asyncio.sleep(0.05)
            return rt.metrics.snapshot(), rt.health()
        finally:
            await cluster.shutdown()

    snap, health = run(go())
    assert snap["echo"]["execute_rate"] > 0 and snap["spout"]["ack_rate"] > 0
    assert "inbox_depth" in snap["echo"]
    assert health["topology"] == "m" and health["components"] == {
        "echo": {"tasks": 2, "alive": 2}, "spout": {"tasks": 1, "alive": 1}}


def _capacity_after_rebalance(impl, run) -> list:
    """The capacity tracker's rows around a shrink: the removed tasks
    leave every named cursor."""
    c = components(impl)

    async def go():
        cluster = impl.cluster.AsyncLocalCluster()
        b = impl.runtime.TopologyBuilder()
        b.set_spout("s", c.ListSpout([]), 1)
        b.set_bolt("c", c.CaptureBolt(), 3).shuffle_grouping("s")
        rt = await cluster.submit("t", impl.config.Config(), b.build())
        try:
            t = [0.0]
            cap = impl.capacity.CapacityTracker(rt, clock=lambda: t[0])
            for e in [*rt.bolt_execs["c"], *rt.spout_execs["s"]]:
                e.busy_s = e.wait_s = e.flush_s = 0.0
            rows = [cap.sample("a"), cap.sample("b")]
            for e in rt.bolt_execs["c"]:
                e.busy_s += 0.5
            t[0] = 1.0
            rows.append(cap.sample("a"))
            await rt.rebalance("c", 1)
            for e in rt.bolt_execs["c"]:
                e.busy_s += 0.25
            t[0] = 2.0
            rows.append(cap.sample("a"))
            rows.append(sorted(cap._cursors["a"]))
            rows.append(sorted(cap._cursors.get("b", {})))
            # the spout's task runs on the wall clock: its rows are not
            # compared
            return [{"c": row["c"]} if isinstance(row, dict) and "c" in row else row
                    for row in rows]
        finally:
            await cluster.shutdown()

    return run(go())


def test_capacity_tracker_after_a_rebalance_alike(run):
    got = {name: _capacity_after_rebalance(impl, run) for name, impl in IMPLS.items()}
    assert got["port"] == got["storm_tpu"]
    after = got["port"]
    assert after[2]["c"]["tasks"] == 3 and after[3]["c"]["tasks"] == 1
    # the removed tasks left both named cursors
    assert after[4] == after[5] == [("c", 0), ("s", 0)]


def test_localcluster_facades(impl):
    c = components(impl)
    with impl.cluster.LocalCluster() as cluster:
        b = impl.runtime.TopologyBuilder()
        b.set_spout("s", c.ListSpout([str(i) for i in range(5)]), 1)
        b.set_bolt("c", c.PassBolt(), 1).shuffle_grouping("s")
        cluster.submit_topology("t", impl.config.Config(), b.build())
        for _ in range(500):
            if cluster.metrics("t").get("s", {}).get("tree_acked", 0) >= 5:
                break
            time.sleep(0.01)
        cluster.rebalance("t", "c", 3)
        cluster.deactivate("t")
        cluster.activate("t")
        assert cluster.drain("t", timeout_s=5)
        assert cluster.metrics("t")["c"]["execute_ms"]["count"] == 5
        cluster.reset_histogram("t", "c", "execute_ms")
        assert cluster.metrics("t")["c"]["execute_ms"]["count"] == 0
        rt = cluster._cluster.runtimes["t"]
        assert rt.parallelism_of("c") == 3 and list(cluster._cluster.runtimes) == ["t"]
        cluster.kill_topology("t")


# ---- an inference component rebalanced under traffic ---------------------------------

LENET = "lenet5_digits"


def _lenet5(impl):
    """lenet5 on its exported digits checkpoint, float32, in ``impl``."""
    batch = impl.config.BatchConfig(max_batch=4, buckets=(4,), max_wait_ms=5)
    if impl.name == "storm_tpu":
        model = impl.config.ModelConfig(name="lenet5", dtype="float32", num_classes=10,
                                        input_shape=(32, 32, 1),
                                        checkpoint=os.path.join(ROOT, "checkpoints", LENET))
        return impl.infer.InferenceBolt(model, batch,
                                        impl.config.ShardingConfig(data_parallel=1))
    model = impl.config.ModelConfig.from_checkpoint(f"checkpoints/{LENET}", dtype="float32")
    return impl.infer.InferenceBolt(model, batch, device="cpu")


async def _serve_rebalanced(impl, xs: np.ndarray):
    n = len(xs)
    c = impl.connectors
    broker = c.MemoryBroker(default_partitions=2)
    cfg = impl.config.Config()
    tb = impl.runtime.TopologyBuilder()
    tb.set_spout("kafka-spout", c.BrokerSpout(
        broker, "input", impl.config.OffsetsConfig(policy="earliest", max_behind=None)), 1)
    tb.set_bolt("inference-bolt", _lenet5(impl), 1).shuffle_grouping("kafka-spout")
    tb.set_bolt("kafka-bolt", c.BrokerSink(broker, "output", cfg.sink), 1) \
        .shuffle_grouping("inference-bolt")
    cluster = impl.cluster.AsyncLocalCluster()
    rt = await cluster.submit("rb", cfg, tb.build())
    try:
        engine = rt.bolt_execs["inference-bolt"][0].bolt.engine
        grown = None
        for i, x in enumerate(xs):
            broker.produce("input", json.dumps({"instances": x[None].tolist()}))
            if i == n // 3:
                await rt.rebalance("inference-bolt", 3)
                grown = [e.bolt.engine is engine for e in rt.bolt_execs["inference-bolt"]]
            if i == 2 * n // 3:
                await rt.rebalance("inference-bolt", 1)
            await asyncio.sleep(0.005)
        deadline = asyncio.get_running_loop().time() + 60
        while broker.topic_size("output") < n:
            assert asyncio.get_running_loop().time() < deadline, "records stuck"
            await asyncio.sleep(0.01)
        await rt.drain(timeout_s=30)
        preds = np.array([json.loads(r.value)["predictions"][0]
                          for r in broker.drain_topic("output")])
        snap = rt.metrics.snapshot()
        return preds, grown, snap["kafka-spout"].get("tree_failed", 0), \
            rt.parallelism_of("inference-bolt")
    finally:
        await cluster.shutdown()


def test_inference_bolt_rebalanced_under_traffic(run, abstract_init):
    """lenet5 on its digits checkpoint, 1 -> 3 -> 1 tasks while 24 records
    flow: every record answered once, the added tasks on the first task's
    engine (one engine built), and each of the port's answers one of
    storm_tpu's within float32 rounding (1e-5)."""
    from storm_tpu_torch.data import load_digits_nhwc

    xs = load_digits_nhwc((32, 32, 1))[2][:24]
    got = {}
    for name, impl in IMPLS.items():
        clear_engine_caches()
        got[name] = run(_serve_rebalanced(impl, xs), timeout=120)
        if name == "port":
            assert len(port_engine.live_engines()) == 1
    for name, (preds, grown, failed, par) in got.items():
        assert preds.shape == (24, 10) and grown == [True, True, True], name
        assert failed == 0 and par == 1, name
    port, ref = got["port"][0], got["storm_tpu"][0]
    nearest = np.abs(port[:, None] - ref[None]).max(-1)
    assert nearest.min(-1).max() <= 1e-5 and nearest.min(0).max() <= 1e-5
    assert sorted(port.argmax(-1)) == sorted(ref.argmax(-1))
    clear_engine_caches()
