"""The port's exactly-once delivery (the spout's ``txn`` policy, the
memory broker's transactions, ``TransactionalBrokerSink``) and its
producer seam against storm_tpu's on the CPU, the behaviours of
``tests/test_connectors.py``'s transactional cases, each in both packages
on the same records:

- ``MemoryTxn``: begin, produce, staged offsets, an atomic commit (the
  largest offset wins), abort; ``commit_many`` and ``create_topic``;
- the sink's delivery modes through the ``make_producer`` seam, a failing
  producer and a ``None`` topic;
- a failed commit aborts all-or-nothing and its tuples replay in a new
  transaction; the deadline is re-armed after the sink's own flush;
- a fanned-out tree commits whole in one transaction with its offsets, a
  sibling's failure drops its parked tuples, the tree-closure trigger
  commits without the deadline, ``offsets_group`` refuses a parallel sink
  at submit and at a rebalance (rolled back), and a small txn chunk warns;
- the audited run of ``soak_harness.py`` in short: lenet5 (its digits
  checkpoint) and an echo bolt into one transactional sink over a txn
  spout in chunks, one inference task crashed by the chaos monkey and one
  commit failed: every record's echo hash and prediction committed
  exactly once, the group's offsets at the log end, the same hashes,
  predictions (argmax equal, within 1e-5) and offsets in both packages.
"""

from __future__ import annotations

import asyncio
import hashlib
import json
import logging
import os
import time
from collections import Counter
from types import SimpleNamespace

import numpy as np
import pytest

import storm_tpu.connectors.memory as jax_memory
import storm_tpu.connectors.sink as jax_sink
import storm_tpu_torch.connectors.memory as port_memory
import storm_tpu_torch.connectors.sink as port_sink
from tests.test_torch_checkpoints import abstract_init  # noqa: F401  (fixture)
from tests.test_torch_copyledger import clear_engine_caches
from tests.test_torch_runtime import IMPLS, ROOT, components

EXTRA = {"storm_tpu": dict(memory=jax_memory, sink=jax_sink),
         "port": dict(memory=port_memory, sink=port_sink)}


def _impl(name):
    return SimpleNamespace(**vars(IMPLS[name]), **EXTRA[name])


@pytest.fixture(params=sorted(IMPLS))
def impl(request):
    return _impl(request.param)


def both(fn, run, timeout=60):
    return {name: run(fn(_impl(name)), timeout=timeout) for name in sorted(IMPLS)}


def _txn_sink(impl, broker, topic="out", **kw):
    return impl.connectors.TransactionalBrokerSink(
        broker, topic, impl.config.SinkConfig(mode="transactional", **kw))


def _txn_offsets(impl, group):
    return impl.config.OffsetsConfig(policy="txn", group_id=group, max_behind=None)


# ---- the broker's transactions --------------------------------------------------------

def _memory_txn(impl) -> list:
    b = impl.memory.MemoryBroker(default_partitions=2)
    b.create_topic("wide", partitions=5)
    out = [b.partitions_for("wide"), b.partitions_for("narrow")]
    t = b.txn("tid")
    t.begin()
    t.produce("out", "a", partition=0)
    t.produce("out", b"b", key="k")
    t.send_offsets("g", {("in", 0): 4, ("in", 1): 2})
    t.send_offsets("g", {("in", 0): 3})  # the larger stays staged
    out.append(b.topic_size("out"))  # nothing visible before commit
    t.commit()
    out += [b.topic_size("out"), b.committed("g", "in", 0), b.committed("g", "in", 1)]
    t.begin()
    t.produce("out", "c")
    t.send_offsets("g", {("in", 0): 9})
    t.abort()
    out += [b.topic_size("out"), b.committed("g", "in", 0)]
    t.begin()
    t.send_offsets("g", {("in", 0): 1})  # an older offset never regresses
    t.commit()
    out.append(b.committed("g", "in", 0))
    b.commit_many("g2", "in", {0: 7, 1: 8})
    out += [b.committed("g2", "in", 0), b.committed("g2", "in", 1), t.txn_id]
    with pytest.raises(AssertionError):
        b.txn("x").produce("out", "nope")
    return out


def test_memory_txn_alike():
    got = {n: _memory_txn(_impl(n)) for n in sorted(IMPLS)}
    assert got["port"] == got["storm_tpu"] == [5, 2, 0, 2, 4, 2, 2, 4, 4, 7, 8, "tid"]


# ---- the producer seam and delivery modes -------------------------------------------

async def _sink_run(impl, broker, sink, items):
    c = components(impl)
    cluster = impl.cluster.AsyncLocalCluster()
    tb = impl.runtime.TopologyBuilder()
    tb.set_spout("s", c.ListSpout(items), 1)
    tb.set_bolt("sink", sink, 1).shuffle_grouping("s")
    rt = await cluster.submit("t", impl.config.Config(), tb.build())
    try:
        deadline = asyncio.get_running_loop().time() + 5
        live = rt.spout_execs["s"][0].spout
        while len(live.acked) + len(live.failed) < len(items):
            assert asyncio.get_running_loop().time() < deadline
            await asyncio.sleep(0.01)
        await asyncio.sleep(0.05)
        snap = rt.metrics.snapshot()["sink"]
        return sorted(live.acked), sorted(live.failed), snap.get("produce_ms", {}).get("count")
    finally:
        await cluster.shutdown()


def _sink_with(impl, broker, mode, fail_first=0, topic="out"):
    class FlakyProducer(impl.sink.Producer):
        def __init__(self):
            self.sent = 0

        async def send(self, topic, value, key):
            self.sent += 1
            if self.sent <= fail_first:
                raise IOError("delivery failed")
            broker.produce(topic, value, key)

    class TestSink(impl.connectors.BrokerSink):
        def make_producer(self):
            return FlakyProducer()

    return TestSink(broker, topic, impl.config.SinkConfig(mode=mode))


@pytest.mark.parametrize("case", ["async", "sync", "async_fail", "sync_fail",
                                  "fire_and_forget_fail", "null_topic", "default_producer"])
def test_sink_modes_alike(case, run):
    async def go(impl):
        broker = impl.connectors.MemoryBroker()
        if case == "null_topic":
            sink = impl.connectors.BrokerSink(broker, None, impl.config.SinkConfig(mode="sync"))
        elif case == "default_producer":
            sink = impl.connectors.BrokerSink(broker, "out")
            assert isinstance(sink.make_producer(), impl.sink.MemoryProducer)
            assert impl.connectors.DefaultTopicSelector("x")(None) == "x"
        else:
            mode = case[:-5] if case.endswith("_fail") else case
            sink = _sink_with(impl, broker, mode, fail_first=int(case.endswith("_fail")))
        got = await _sink_run(impl, broker, sink, ["a", "b"])
        return got, [r.value for r in broker.drain_topic("out")]

    got = both(go, run)
    assert got["port"] == got["storm_tpu"]
    (acked, failed, produced), values = got["port"]
    if case in ("async", "sync", "default_producer"):
        assert acked == ["a", "b"] and failed == [] and sorted(values) == [b"a", b"b"]
    elif case == "fire_and_forget_fail":
        assert acked == ["a", "b"] and len(values) == 1
    elif case == "null_topic":
        assert acked == ["a", "b"] and values == []
    else:
        assert len(failed) == 1 and len(values) == 1


def test_sink_without_broker_or_producer_refused(impl):
    with pytest.raises(ValueError, match="needs a broker"):
        impl.connectors.BrokerSink(None, "out").make_producer()


# ---- the transactional sink -----------------------------------------------------------

def _commit_and_abort(impl):
    class FlakyTxn:
        """Fails the first commit, then delegates."""

        def __init__(self, inner):
            self._inner = inner
            self.fail_next = 1

        def begin(self):
            self._inner.begin()

        def produce(self, *a, **kw):
            self._inner.produce(*a, **kw)

        def commit(self):
            if self.fail_next:
                self.fail_next -= 1
                self._inner.abort()
                raise RuntimeError("injected commit failure")
            self._inner.commit()

        def abort(self):
            self._inner.abort()

    class FlakyBroker(impl.connectors.MemoryBroker):
        def txn(self, txn_id):
            return FlakyTxn(super().txn(txn_id))

    class ReplaySpout(impl.runtime.Spout):
        def open(self, ctx, col):
            super().open(ctx, col)
            self.q = [f"m{i}" for i in range(6)] if ctx.task_index == 0 else []

        async def next_tuple(self):
            if not self.q:
                return False
            m = self.q.pop(0)
            await self.collector.emit(impl.runtime.Values([m]), msg_id=m)
            return True

        def fail(self, msg_id):
            self.q.append(msg_id)

    async def go():
        broker = FlakyBroker()
        tb = impl.runtime.TopologyBuilder()
        tb.set_spout("s", ReplaySpout(), 1)
        tb.set_bolt("sink", _txn_sink(impl, broker, txn_batch=3, txn_ms=30.0), 1) \
            .shuffle_grouping("s")
        cluster = impl.cluster.AsyncLocalCluster()
        rt = await cluster.submit("txn", impl.config.Config(), tb.build())
        try:
            deadline = asyncio.get_running_loop().time() + 20
            while broker.topic_size("out") < 6:
                assert asyncio.get_running_loop().time() < deadline
                await asyncio.sleep(0.02)
            await asyncio.sleep(0.2)
            snap = rt.metrics.snapshot()["sink"]
            return sorted(r.value.decode() for r in broker.drain_topic("out")), \
                snap["txn_aborts"], snap["txn_commits"] >= 2, len(rt.errors)
        finally:
            await cluster.shutdown()

    return go()


def test_transactional_sink_commit_and_abort_alike(run):
    got = both(_commit_and_abort, run)
    assert got["port"] == got["storm_tpu"] == ([f"m{i}" for i in range(6)], 1, True, 1)


def _rearm(impl):
    class SlowTxn:
        def __init__(self, inner):
            self._inner = inner

        def begin(self):
            self._inner.begin()

        def produce(self, *a, **kw):
            self._inner.produce(*a, **kw)

        def commit(self):
            time.sleep(0.25)  # a commit in flight while "b" arrives
            self._inner.commit()

        def abort(self):
            self._inner.abort()

    class SlowBroker(impl.connectors.MemoryBroker):
        # storm_tpu commits a blocking broker's transactions on a worker
        # thread, so there "b" arrives mid-commit and the deadline task
        # re-arms itself; the port has no blocking broker and commits on
        # the loop, so "b" lands after the commit. Both must end alike.
        blocking = True

        def txn(self, txn_id):
            return SlowTxn(super().txn(txn_id))

    class TwoPhaseSpout(impl.runtime.Spout):
        def open(self, ctx, col):
            super().open(ctx, col)
            self.plan = [("a", 0.0), ("b", 0.1)] if ctx.task_index == 0 else []
            self.t0 = time.monotonic()
            self.acked, self.failed = [], []

        async def next_tuple(self):
            if not self.plan or time.monotonic() - self.t0 < self.plan[0][1]:
                return False
            m, _ = self.plan.pop(0)
            await self.collector.emit(impl.runtime.Values([m]), msg_id=m)
            return True

        def ack(self, msg_id):
            self.acked.append(msg_id)

        def fail(self, msg_id):
            self.failed.append(msg_id)

    async def go():
        broker = SlowBroker()
        tb = impl.runtime.TopologyBuilder()
        tb.set_spout("s", TwoPhaseSpout(), 1)
        tb.set_bolt("sink", _txn_sink(impl, broker, txn_batch=100, txn_ms=30.0), 1) \
            .shuffle_grouping("s")
        cluster = impl.cluster.AsyncLocalCluster()
        rt = await cluster.submit("txn-rearm", impl.config.Config(), tb.build())
        try:
            spout = rt.spout_execs["s"][0].spout
            deadline = asyncio.get_running_loop().time() + 3.0
            while asyncio.get_running_loop().time() < deadline and len(spout.acked) < 2:
                await asyncio.sleep(0.02)
            return sorted(spout.acked), spout.failed, \
                sorted(r.value.decode() for r in broker.drain_topic("out"))
        finally:
            await cluster.shutdown()

    return go()


def test_deadline_rearmed_after_own_flush_alike(run):
    got = both(_rearm, run)
    assert got["port"] == got["storm_tpu"] == (["a", "b"], [], ["a", "b"])


def _fanout_harness(impl, group: str, fan: int, violations: list):
    """A broker whose commits record duplicate outputs and any committed
    source offset whose tree's outputs are not all in the topic; and the
    1 -> ``fan`` splitter bolt."""

    class RecTxn:
        def __init__(self, inner, broker):
            self._inner, self._broker = inner, broker

        def begin(self):
            self._inner.begin()

        def produce(self, *a, **kw):
            self._inner.produce(*a, **kw)

        def send_offsets(self, *a, **kw):
            self._inner.send_offsets(*a, **kw)

        def abort(self):
            self._inner.abort()

        def commit(self):
            self._inner.commit()
            vals = [r.value.decode() for r in self._broker.drain_topic("out")]
            if len(vals) != len(set(vals)):
                violations.append(("dupes", sorted(vals)))
            for p in range(2):
                k = self._broker.committed(group, "in", p)
                for rec in self._broker.fetch("in", p, 0, 100)[:k or 0]:
                    v = rec.value.decode()
                    missing = [j for j in range(fan) if f"{v}/{j}" not in vals]
                    if missing:
                        violations.append((v, missing))

    class RecBroker(impl.connectors.MemoryBroker):
        def txn(self, txn_id):
            return RecTxn(super().txn(txn_id), self)

    class SplitBolt(impl.runtime.Bolt):
        async def execute(self, t):
            for j in range(fan):
                await self.collector.emit(impl.runtime.Values([f'{t.get("message")}/{j}']),
                                          anchors=[t])
            self.collector.ack(t)

    return RecBroker, SplitBolt


def _fanout(impl, flaky: bool):
    G, FAN, n = ("eos-fail", 3, 4) if flaky else ("eos-fan", 3, 8)
    violations: list = []
    RecBroker, SplitBolt = _fanout_harness(impl, G, FAN, violations)

    class FlakyPass(impl.runtime.Bolt):
        failed = False

        async def execute(self, t):
            v = t.get("message")
            if v.endswith("/1") and not FlakyPass.failed:
                FlakyPass.failed = True
                self.collector.fail(t)  # the whole tree fails
                return
            await self.collector.emit(impl.runtime.Values([v]), anchors=[t])
            self.collector.ack(t)

    async def go():
        broker = RecBroker(default_partitions=2)
        for i in range(n):
            broker.produce("in", f"r{i}", partition=i % 2)
        tb = impl.runtime.TopologyBuilder()
        tb.set_spout("s", impl.connectors.BrokerSpout(broker, "in", _txn_offsets(impl, G)), 1)
        tb.set_bolt("split", SplitBolt(), 1).shuffle_grouping("s")
        last = "split"
        if flaky:
            tb.set_bolt("mid", FlakyPass(), 1).shuffle_grouping("split")
            last = "mid"
        # txn_batch 2 < FAN: only parking keeps a tree in one transaction
        tb.set_bolt("sink", _txn_sink(impl, broker, txn_batch=2, txn_ms=20.0,
                                      offsets_group=G), 1).shuffle_grouping(last)
        cluster = impl.cluster.AsyncLocalCluster()
        rt = await cluster.submit("fan", impl.config.Config(), tb.build())
        try:
            deadline = asyncio.get_running_loop().time() + 25
            while not (broker.topic_size("out") >= n * FAN and all(
                    broker.committed(G, "in", p) == n // 2 for p in range(2))):
                assert asyncio.get_running_loop().time() < deadline, "trees stuck"
                await asyncio.sleep(0.02)
            snap = rt.metrics.snapshot()
            return violations, sorted(r.value.decode() for r in broker.drain_topic("out")), \
                {p: broker.committed(G, "in", p) for p in range(2)}, \
                snap["sink"]["txn_offsets_deferred"] > 0, snap["s"].get("tree_failed", 0)
        finally:
            await cluster.shutdown()

    return go()


@pytest.mark.parametrize("flaky", [False, True], ids=["whole_tree", "sibling_failure"])
def test_fanout_tree_commits_whole_alike(flaky, run):
    got = both(lambda impl: _fanout(impl, flaky), run)
    assert got["port"] == got["storm_tpu"]
    violations, vals, committed, deferred, tree_failed = got["port"]
    n = 4 if flaky else 8
    assert violations == [] and vals == sorted(f"r{i}/{j}" for i in range(n) for j in range(3))
    assert committed == {0: n // 2, 1: n // 2} and deferred
    assert tree_failed == (1 if flaky else 0)


def _closure(impl):
    async def go():
        c = components(impl)
        broker = impl.connectors.MemoryBroker(default_partitions=1)
        for i in range(3):
            broker.produce("in", f"m{i}", partition=0)
        tb = impl.runtime.TopologyBuilder()
        tb.set_spout("s", impl.connectors.BrokerSpout(broker, "in",
                                                      _txn_offsets(impl, "cl-g")), 1)
        tb.set_bolt("mid", c.PassBolt(), 1).shuffle_grouping("s")
        # deadline and batch far past the test: only tree closure commits
        tb.set_bolt("sink", _txn_sink(impl, broker, txn_batch=512, txn_ms=30_000.0,
                                      offsets_group="cl-g"), 1).shuffle_grouping("mid")
        cluster = impl.cluster.AsyncLocalCluster()
        await cluster.submit("closure", impl.config.Config(), tb.build())
        try:
            t0 = asyncio.get_running_loop().time()
            while asyncio.get_running_loop().time() - t0 < 10 and broker.topic_size("out") < 3:
                await asyncio.sleep(0.02)
            took = asyncio.get_running_loop().time() - t0
            return broker.topic_size("out"), took < 5.0, broker.committed("cl-g", "in", 0)
        finally:
            await cluster.shutdown()

    return go()


def test_tree_closure_commits_without_deadline_alike(run):
    got = both(_closure, run)
    assert got["port"] == got["storm_tpu"] == (3, True, 3)


def _parallel_refused(impl):
    async def go():
        broker = impl.connectors.MemoryBroker(default_partitions=2)
        for i in range(3):
            broker.produce("in", f"a{i}", partition=i % 2)
        spout = impl.connectors.BrokerSpout(broker, "in", _txn_offsets(impl, "rb-g"))
        tb = impl.runtime.TopologyBuilder()
        tb.set_spout("s", spout, 1)
        tb.set_bolt("sink", _txn_sink(impl, broker, offsets_group="g"), 2) \
            .shuffle_grouping("s")
        cluster = impl.cluster.AsyncLocalCluster()
        with pytest.raises(ValueError, match="parallelism 1") as refused:
            await cluster.submit("fan2", impl.config.Config(), tb.build())
        await cluster.shutdown()
        tb = impl.runtime.TopologyBuilder()
        tb.set_spout("s", spout, 1)
        tb.set_bolt("sink", _txn_sink(impl, broker, txn_batch=2, txn_ms=20.0,
                                      offsets_group="rb-g"), 1).shuffle_grouping("s")
        cluster = impl.cluster.AsyncLocalCluster()
        rt = await cluster.submit("rb", impl.config.Config(), tb.build())
        try:
            with pytest.raises(ValueError, match="parallelism 1"):
                await rt.rebalance("sink", 2)
            par = rt.parallelism_of("sink")
            for i in range(3, 6):
                broker.produce("in", f"a{i}", partition=i % 2)
            deadline = asyncio.get_running_loop().time() + 20
            while broker.topic_size("out") < 6:
                assert asyncio.get_running_loop().time() < deadline
                await asyncio.sleep(0.02)
            return str(refused.value), par, broker.topic_size("out"), \
                {p: broker.committed("rb-g", "in", p) for p in range(2)}
        finally:
            await cluster.shutdown()

    return go()


def test_offsets_group_refuses_a_parallel_sink_alike(run):
    got = both(_parallel_refused, run)
    assert got["port"] == got["storm_tpu"]
    assert got["port"][1:] == (1, 6, {0: 3, 1: 3})


def test_sink_without_txn_broker_refused(impl, run):
    class Plain:
        def partitions_for(self, topic):
            return 1

    async def go():
        c = components(impl)
        tb = impl.runtime.TopologyBuilder()
        tb.set_spout("s", c.ListSpout([]), 1)
        tb.set_bolt("sink", _txn_sink(impl, Plain()), 1).shuffle_grouping("s")
        cluster = impl.cluster.AsyncLocalCluster()
        try:
            with pytest.raises(TypeError, match="txn"):
                await cluster.submit("x", impl.config.Config(), tb.build())
        finally:
            await cluster.shutdown()

    run(go(), timeout=20)


def test_small_txn_chunk_warns(impl, caplog):
    class Ctx:
        parallelism, task_index, component_id = 1, 0, "spout"
        metrics = impl.cluster.MetricsRegistry()
        tracer = None

    logger = "storm_tpu.spout" if impl.name == "storm_tpu" else "storm_tpu_torch.spout"
    broker = impl.connectors.MemoryBroker(default_partitions=2)
    with caplog.at_level(logging.WARNING, logger=logger):
        impl.connectors.BrokerSpout(broker, "in", _txn_offsets(impl, "g"), chunk=4) \
            .open(Ctx(), None)
    assert any("spout_chunk" in r.getMessage() and "gated entry" in r.getMessage()
               for r in caplog.records if r.name == logger)
    caplog.clear()
    with caplog.at_level(logging.WARNING, logger=logger):
        impl.connectors.BrokerSpout(broker, "in2", _txn_offsets(impl, "g"), chunk=16) \
            .open(Ctx(), None)
    assert not [r for r in caplog.records if r.name == logger]


def test_offsets_and_sink_configs_alike():
    bad = [dict(policy="txn"), dict(policy="txn", group_id="g"), dict(policy="nope")]
    for kw in bad:
        msgs = []
        for impl in IMPLS.values():
            with pytest.raises(ValueError) as e:
                impl.config.OffsetsConfig(**kw)
            msgs.append(str(e.value))
        assert msgs[0] == msgs[1]
    for impl in IMPLS.values():
        assert impl.config.OffsetsConfig(policy="txn", group_id="g", max_behind=None)
        s = impl.config.SinkConfig(mode="transactional", txn_batch=8, txn_ms=5.0,
                                   offsets_group="g")
        assert (s.txn_batch, s.txn_ms, s.offsets_group) == (8, 5.0, "g")
        with pytest.raises(ValueError, match="unknown sink mode"):
            impl.config.SinkConfig(mode="exactly")
        t = impl.config.TopologyConfig()
        assert (t.name, t.tick_interval_s, t.checkpoint_interval_s, t.state_dir) == \
            ("inference-topology", 0.0, 5.0, "")


def test_standard_topology_makes_transactional_sinks():
    from storm_tpu_torch.main import build_standard_topology

    cfg = IMPLS["port"].config.Config()
    cfg.model = IMPLS["port"].config.ModelConfig(name="lenet5", input_shape=(28, 28, 1))
    cfg.sink = IMPLS["port"].config.SinkConfig(mode="transactional")
    topo = build_standard_topology(cfg, port_memory.MemoryBroker(), device="cpu")
    kinds = {cid: type(spec.obj).__name__ for cid, spec in topo.specs.items()}
    assert kinds["kafka-bolt"] == kinds["dlq-bolt"] == "TransactionalBrokerSink"
    cfg.sink = IMPLS["port"].config.SinkConfig()
    topo = build_standard_topology(cfg, port_memory.MemoryBroker(), device="cpu")
    assert type(topo.specs["kafka-bolt"].obj).__name__ == "BrokerSink"


# ---- the audited exactly-once run, in short --------------------------------------------

GROUP, IN, OUT, DLQ, PARTS, N, CHUNK = "eos-audit", "eos-in", "eos-out", "eos-dlq", 4, 32, 4


def _lenet5_bolt(impl):
    batch = impl.config.BatchConfig(max_batch=8, buckets=(8,), max_wait_ms=10)
    if impl.name == "storm_tpu":
        model = impl.config.ModelConfig(
            name="lenet5", dtype="float32", num_classes=10, input_shape=(32, 32, 1),
            checkpoint=os.path.join(ROOT, "checkpoints", "lenet5_digits"))
        return impl.infer.InferenceBolt(model, batch, impl.config.ShardingConfig(data_parallel=1))
    model = impl.config.ModelConfig.from_checkpoint("checkpoints/lenet5_digits",
                                                    dtype="float32")
    return impl.infer.InferenceBolt(model, batch, device="cpu")


def _audited(impl, payloads: list, monkeypatch):
    class EchoBolt(impl.runtime.Bolt):
        """The identity lane: each record's content hash, anchored to the
        tree of its prediction, so the sink commits both or neither."""

        async def execute(self, t):
            m = t.get("message")
            for rec in (m if isinstance(m, list) else [m]):
                h = hashlib.sha256(rec.encode()).hexdigest()[:24]
                await self.collector.emit(impl.runtime.Values([f"h:{h}"]), anchors=[t])
            self.collector.ack(t)

    commit = impl.memory.MemoryTxn.commit
    state = {"commits": 0, "failed": 0}

    def flaky_commit(txn):
        state["commits"] += 1
        if state["commits"] == 3 and not state["failed"]:
            state["failed"] = 1
            raise RuntimeError("injected commit failure")
        commit(txn)

    monkeypatch.setattr(impl.memory.MemoryTxn, "commit", flaky_commit)

    async def go():
        broker = impl.connectors.MemoryBroker(default_partitions=PARTS)
        cfg = impl.config.Config()
        cfg.topology.message_timeout_s = 2.0
        tb = impl.runtime.TopologyBuilder()
        tb.set_spout("spout", impl.connectors.BrokerSpout(
            broker, IN, _txn_offsets(impl, GROUP), chunk=CHUNK), 1)
        tb.set_bolt("infer", _lenet5_bolt(impl), 2).shuffle_grouping("spout")
        tb.set_bolt("echo", EchoBolt(), 1).shuffle_grouping("spout")
        tb.set_bolt("sink", _txn_sink(impl, broker, OUT, txn_batch=64, txn_ms=50.0,
                                      offsets_group=GROUP), 1) \
            .shuffle_grouping("infer").shuffle_grouping("echo")
        tb.set_bolt("dlq", impl.connectors.BrokerSink(broker, DLQ, cfg.sink), 1) \
            .shuffle_grouping("infer", stream="dead_letter")
        cluster = impl.cluster.AsyncLocalCluster()
        rt = await cluster.submit("eos", cfg, tb.build())
        try:
            monkey = impl.chaos.ChaosMonkey(rt, seed=0)
            for i, p in enumerate(payloads):
                broker.produce(IN, p, partition=i % PARTS)
                if i == N // 4:
                    monkey.crash_bolt("infer", 1)
                await asyncio.sleep(0.002)
            deadline = asyncio.get_running_loop().time() + 60
            while not all(broker.committed(GROUP, IN, p) == N // PARTS for p in range(PARTS)):
                assert asyncio.get_running_loop().time() < deadline, \
                    {p: broker.committed(GROUP, IN, p) for p in range(PARTS)}
                await asyncio.sleep(0.05)
            await rt.drain(timeout_s=10)
            snap = rt.metrics.snapshot()
            return {"out": [r.value.decode() for r in broker.drain_topic(OUT)],
                    "committed": {p: broker.committed(GROUP, IN, p) for p in range(PARTS)},
                    "dlq": broker.topic_size(DLQ), "restarts": snap["infer"]["executor_restarts"],
                    "aborts": snap["sink"]["txn_aborts"], "commits": snap["sink"]["txn_commits"],
                    "failed_commit": state["failed"]}
        finally:
            await cluster.shutdown()

    return go()


def test_audited_exactly_once_run_alike(run, monkeypatch, abstract_init):
    from storm_tpu_torch.data import load_digits_nhwc

    xs = load_digits_nhwc((32, 32, 1))[2][:N]
    payloads = [json.dumps({"instances": x[None].round(4).tolist()}) for x in xs]
    want = Counter(hashlib.sha256(p.encode()).hexdigest()[:24] for p in payloads)
    got = {}
    for name in sorted(IMPLS):
        clear_engine_caches()
        got[name] = run(_audited(_impl(name), payloads, monkeypatch), timeout=120)
    clear_engine_caches()
    preds = {}
    for name, g in got.items():
        echoes = Counter(v[2:] for v in g["out"] if v.startswith("h:"))
        assert echoes == want, name  # each record's hash exactly once
        rows = [json.loads(v)["predictions"][0] for v in g["out"] if not v.startswith("h:")]
        preds[name] = np.array(rows)
        assert preds[name].shape == (N, 10), name
        assert g["committed"] == {p: N // PARTS for p in range(PARTS)}, name
        assert g["dlq"] == 0 and g["restarts"] == 1 and g["failed_commit"] == 1, name
        assert g["aborts"] >= 1 and g["commits"] >= 1, name
    port, ref = preds["port"], preds["storm_tpu"]
    nearest = np.abs(port[:, None] - ref[None]).max(-1)
    assert nearest.min(-1).max() <= 1e-5 and nearest.min(0).max() <= 1e-5
    assert sorted(port.argmax(-1)) == sorted(ref.argmax(-1))
    assert got["port"]["committed"] == got["storm_tpu"]["committed"]
