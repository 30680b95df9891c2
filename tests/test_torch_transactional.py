"""The port's exactly-once micro-batches (``storm_tpu_torch/runtime/
transactional.py``) against storm_tpu's on the CPU, case by case as
``tests/test_transactional.py`` drives storm_tpu's: txid-idempotent and
opaque state, the spout's immutable batches under replay, a coordinator
that re-forms its batch after a crash, only task 0 coordinating, exact
counts through a forced replay, the sink skipping a replayed txid, a
parallelism above 1 refused, a broker without ``commit_many``, the state
checkpointed before the ack, and the sink's txid marker surviving the
loss of its state. Each case runs in both packages on the same records
and must give the same batches, txids, outputs and counts.
"""

from __future__ import annotations

import asyncio
import json
from types import SimpleNamespace

import pytest

import storm_tpu.runtime.base as jax_base
import storm_tpu.runtime.state as jax_state
import storm_tpu.runtime.transactional as jax_tx
import storm_tpu_torch.runtime.base as port_base
import storm_tpu_torch.runtime.state as port_state
import storm_tpu_torch.runtime.transactional as port_tx
from tests.test_torch_runtime import IMPLS

EXTRA = {"storm_tpu": dict(tx=jax_tx, state=jax_state, base=jax_base),
         "port": dict(tx=port_tx, state=port_state, base=port_base)}


def _impl(name):
    return SimpleNamespace(**vars(IMPLS[name]), **EXTRA[name])


@pytest.fixture(params=sorted(IMPLS))
def impl(request):
    return _impl(request.param)


def both(fn, run=None):
    """``fn(impl)`` in each package (a coroutine through ``run``)."""
    out = {}
    for name in sorted(IMPLS):
        got = fn(_impl(name))
        out[name] = run(got, timeout=60) if run is not None else got
    return out


# ---- state -------------------------------------------------------------------------

def _state_script(impl) -> list:
    st = impl.tx.TransactionalState(impl.state.KeyValueState())
    out = [st.apply("k", 10, lambda v: v + 1, init=0),
           st.apply("k", 10, lambda v: v + 1, init=0),  # replay: no-op
           st.apply("k", 9, lambda v: v + 1, init=0),   # older: no-op
           st.apply("k", 11, lambda v: v + 1, init=0), st.value("k"),
           st.value("absent", "d"), list(st.items())]
    op = impl.tx.OpaqueState(impl.state.KeyValueState())
    out += [op.apply("k", 10, lambda v: v + 5, init=0),
            op.apply("k", 10, lambda v: v + 3, init=0),  # same txid: over prev
            op.apply("k", 11, lambda v: v + 1, init=0),
            op.apply("k", 10, lambda v: v + 9, init=0),  # older: no-op
            op.kv.snapshot()]
    return out


def test_states_alike():
    got = both(_state_script)
    assert got["port"] == got["storm_tpu"]
    assert got["port"][:5] == [1, 1, 1, 2, 2]
    assert got["port"][7:11] == [5, 3, 4, 4]


# ---- the spout's batch contract -------------------------------------------------------

class _Capture:
    """Collector stand-in capturing spout emits."""

    def __init__(self):
        self.emits = []

    def set_output_fields(self, fields):
        pass

    async def emit(self, values, **kw):
        self.emits.append((list(values), kw.get("msg_id")))
        return 1


class _Ctx:
    def __init__(self, task_index=0):
        self.task_index = task_index
        self.parallelism = 1
        self.component_id = "tx-spout"
        self.config = None
        self.metrics = None


def _spout(impl, broker, **kw):
    s = impl.tx.TransactionalSpout(broker, "in", **kw)
    cap = _Capture()
    s.open(_Ctx(), cap)
    return s, cap


def _immutable_batches(impl):
    async def go():
        broker = impl.connectors.MemoryBroker(default_partitions=2)
        for i in range(10):
            broker.produce("in", f"r{i}")
        s, cap = _spout(impl, broker, batch_size=6)
        assert await s.next_tuple()
        txid1 = cap.emits[0][1]
        for i in range(5):
            broker.produce("in", f"late{i}")
        s.fail(txid1)
        s.fail(txid1)  # a second fail queues one replay
        assert await s.next_tuple()
        assert not await s.next_tuple()  # one batch in flight
        s.ack(txid1)
        s.ack(txid1)  # a late ack is ignored
        assert await s.next_tuple()
        return cap.emits, {p: broker.committed("tx", "in", p) for p in range(2)}, \
            {p: broker.committed("tx.pending", "in", p) for p in range(2)}

    return go()


def test_tx_spout_batches_immutable_under_replay_alike(run):
    got = both(_immutable_batches, run)
    assert got["port"] == got["storm_tpu"]
    emits, committed, pending = got["port"]
    (b1, t1), (b1r, t1r), (b2, t2) = emits
    assert len(b1[0]) == 6 and b1 == b1r and t1 == t1r == b1[1]
    assert t2 > t1 and set(b2[0]).isdisjoint(b1[0])
    assert committed == {0: 5, 1: 1}  # the first batch's ranges, at the next poll


def _coordinator_crash(impl):
    async def go():
        broker = impl.connectors.MemoryBroker(default_partitions=2)
        for i in range(8):
            broker.produce("in", f"r{i}")
        s1, cap1 = _spout(impl, broker, batch_size=5)
        assert await s1.next_tuple()
        for i in range(4):
            broker.produce("in", f"late{i}")
        s2, cap2 = _spout(impl, broker, batch_size=5)  # a fresh coordinator
        assert await s2.next_tuple()
        s2.ack(cap2.emits[0][1])
        assert await s2.next_tuple()
        return cap1.emits, cap2.emits

    return go()


def test_tx_spout_coordinator_crash_reforms_identical_batch_alike(run):
    got = both(_coordinator_crash, run)
    assert got["port"] == got["storm_tpu"]
    first, again = got["port"]
    assert again[0] == first[0]  # same records, same txid
    assert again[1][1] > first[0][1]


def test_tx_spout_only_task0_coordinates(impl, run):
    async def go():
        broker = impl.connectors.MemoryBroker()
        broker.produce("in", "x")
        s = impl.tx.TransactionalSpout(broker, "in")
        s.open(_Ctx(task_index=1), _Capture())
        return await s.next_tuple()

    assert run(go(), timeout=10) is False


def test_tx_spout_works_without_commit_many(impl, run):
    class NoCommitMany:
        def __init__(self, inner):
            self._b = inner

        def __getattr__(self, name):
            if name == "commit_many":
                raise AttributeError(name)
            return getattr(self._b, name)

    async def go():
        inner = impl.connectors.MemoryBroker(default_partitions=2)
        for i in range(6):
            inner.produce("in", f"r{i}")
        s, cap = _spout(impl, NoCommitMany(inner), batch_size=4)
        assert await s.next_tuple()
        s.ack(cap.emits[0][1])
        assert await s.next_tuple()  # flushes the per-partition commits
        return sum(inner.committed("tx", "in", p) or 0 for p in range(2))

    assert run(go(), timeout=30) == 4


# ---- end to end ------------------------------------------------------------------------

def _count_bolt(impl, fail_first: bool):
    class CountBolt(impl.tx.TransactionalBolt):
        """Counts words per batch into transactional state; emits totals."""

        failed = not fail_first

        async def process_batch(self, txid, records, state):
            totals = {}
            for rec in records:
                word = rec.split(":")[0]
                totals[word] = totals.get(word, 0) + 1
            return [json.dumps({w: state.apply(w, txid, lambda v, n=n: v + n, init=0)})
                    for w, n in sorted(totals.items())]

        async def execute(self, t):
            if not CountBolt.failed:
                CountBolt.failed = True  # the first batch fails once: a replay
                self.collector.fail(t)
                return
            await super().execute(t)

    return CountBolt


def _exactly_once(impl, state_dir=None, fail_first=True, words=("a", "b", "a", "c", "a", "b"),
                  batch_size=3):
    async def go():
        broker = impl.connectors.MemoryBroker(default_partitions=1)
        for i, w in enumerate(words):
            broker.produce("in", f"{w}:{i}")
        cfg = impl.config.Config()
        cfg.topology.message_timeout_s = 2.0
        if state_dir is not None:
            cfg.topology.state_dir = state_dir
            cfg.topology.checkpoint_interval_s = 3600.0  # the timer never fires
        tb = impl.runtime.TopologyBuilder()
        tb.set_spout("tx-spout", impl.tx.TransactionalSpout(broker, "in",
                                                            batch_size=batch_size), 1)
        tb.set_bolt("count", _count_bolt(impl, fail_first)(), 1).shuffle_grouping("tx-spout")
        tb.set_bolt("sink", impl.tx.TransactionalSink(broker, "out"), 1) \
            .shuffle_grouping("count")
        cluster = impl.cluster.AsyncLocalCluster()
        rt = await cluster.submit("tx", cfg, tb.build())
        try:
            want = len(set(words[:batch_size])) + len(set(words[batch_size:]))
            deadline = asyncio.get_running_loop().time() + 30
            while broker.topic_size("out") < want:
                assert asyncio.get_running_loop().time() < deadline, "batches stuck"
                await asyncio.sleep(0.02)
            await rt.drain(timeout_s=10)
            outs = [r.value.decode() for r in broker.drain_topic("out")]
            stored = None
            if state_dir is not None:
                stored = impl.state.FileStateBackend(state_dir).load("count", 0)
            sink = rt.bolt_execs["sink"][0].bolt
            return outs, stored, sink.state.get("last_txid"), \
                rt.metrics.snapshot()["tx-spout"]
        finally:
            await cluster.shutdown()

    return go()


def test_exactly_once_counts_despite_replay_alike(run):
    got = both(_exactly_once, run)
    outs = {n: g[0] for n, g in got.items()}
    assert outs["port"] == outs["storm_tpu"]
    totals = {}
    for o in outs["port"]:
        totals.update(json.loads(o))
    assert totals == {"a": 3, "b": 2, "c": 1}
    assert got["port"][2] == got["storm_tpu"][2] == 6  # the last txid
    assert got["port"][3]["tree_failed"] == got["storm_tpu"][3]["tree_failed"] == 1


def test_tx_state_checkpointed_before_ack_alike(run, tmp_path):
    got = {n: run(_exactly_once(_impl(n), state_dir=str(tmp_path / n), fail_first=False,
                                words=("a", "a", "b"), batch_size=10), timeout=60)
           for n in sorted(IMPLS)}
    for name, (outs, stored, _last, _snap) in got.items():
        assert stored is not None, name
        _version, snap = stored
        assert snap["a"]["v"] == 2 and snap["b"]["v"] == 1, name
    assert got["port"][1] == got["storm_tpu"][1]


class _Coll:
    def __init__(self):
        self.acked, self.failed = [], []

    def ack(self, t):
        self.acked.append(t)

    def fail(self, t):
        self.failed.append(t)

    def report_error(self, e):
        pass


def test_tx_sink_skips_replayed_txid(impl, run):
    async def go():
        broker = impl.connectors.MemoryBroker()
        sink = impl.tx.TransactionalSink(broker, "out")
        sink.init_state(impl.state.KeyValueState())
        sink.collector = _Coll()
        t1 = impl.tuples.Tuple(values=[["m1", {"k": 2}], 7], fields=("batch", "txid"),
                               source_component="c", source_task=0)
        await sink.execute(t1)
        await sink.execute(t1)  # the same txid again
        t2 = impl.tuples.Tuple(values=["solo", 8], fields=("message", "txid"),
                               source_component="c", source_task=0)
        await sink.execute(t2)
        return [r.value for r in broker.drain_topic("out")], len(sink.collector.acked)

    assert run(go(), timeout=10) == ([b"m1", b'{"k": 2}', b"solo"], 3)


def test_tx_parallelism_above_one_refused(impl, run):
    async def go():
        broker = impl.connectors.MemoryBroker()
        tb = impl.runtime.TopologyBuilder()
        tb.set_spout("tx-spout", impl.tx.TransactionalSpout(broker, "in"), 1)
        tb.set_bolt("sink", impl.tx.TransactionalSink(broker, "out"), 2) \
            .shuffle_grouping("tx-spout")
        cluster = impl.cluster.AsyncLocalCluster()
        try:
            with pytest.raises(ValueError, match="parallelism=1"):
                await cluster.submit("tx", impl.config.Config(), tb.build())
        finally:
            await cluster.shutdown()

    run(go(), timeout=30)


def _marker(impl):
    def make_sink(broker):
        sink = impl.tx.TransactionalSink(broker, "out")
        sink.prepare(impl.base.TopologyContext("sink", 0, 1, impl.config.Config()), None)
        sink.collector = _Coll()
        sink.init_state(impl.state.KeyValueState())
        return sink

    async def go():
        broker = impl.connectors.MemoryBroker()
        T = impl.tuples.Tuple
        t = T(values=[["m1", "m2"], 7], fields=("batch", "txid"), source_component="c")
        sink = make_sink(broker)
        assert sink._txn is not None
        await sink.execute(t)
        out = [broker.topic_size("out"), broker.committed(sink._marker_group, "out", 0),
               sink._marker_group]
        sink2 = make_sink(broker)  # its state lost: a fresh sink
        await sink2.execute(t)
        out += [broker.topic_size("out"), len(sink2.collector.acked)]
        await sink2.execute(T(values=[["m3"], 8], fields=("batch", "txid"),
                              source_component="c"))
        out += [broker.topic_size("out"), sink2.state.get("last_txid")]
        no_txn = impl.tx.TransactionalSink(broker, "plain", use_txn=False)
        no_txn.prepare(impl.base.TopologyContext("sink", 0, 1, impl.config.Config()), None)
        out.append(no_txn._txn is None)
        return out

    return go()


def test_tx_sink_marker_survives_state_loss_alike(run):
    got = both(_marker, run)
    assert got["port"] == got["storm_tpu"]
    assert got["port"] == [2, 7, "txnsink.inference-topology-sink-0", 2, 1, 3, 8, True]
