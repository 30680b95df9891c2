"""The port's consumer-group protocol, spout seeks and Trident over the wire
broker, against storm_tpu's, on the CPU over real sockets on 127.0.0.1,
on the port's Kafka stub and on storm_tpu's ``tests/kafka_stub.py``:

- ``GroupMembership``: a port member and a storm_tpu member in one group
  get the range assignment either package's assignor computes; the group
  rebalances when a member leaves, a silent member expires, three members
  split five partitions 1/2/2 (after ``tests/test_kafka_protocol.py``);
  the subscription and assignment codecs give the same bytes;
- the spout's ``offsets.group_protocol``: two tasks split the partitions
  disjointly and cover them, every record read (after
  ``tests/test_connectors.py``); refused without a wire broker, without a
  ``group_id`` and with the 'txn' policy, as storm_tpu's config refuses;
- ``seek`` to "earliest", "latest", an offset and a count behind the end
  replays and skips the same records in both packages;
  ``parse_seek_position`` refuses the same strings;
- ``TransactionalSpout`` -> a counting ``TransactionalBolt`` ->
  ``TransactionalSink`` over each package's ``KafkaWireBroker``, with one
  forced replay: the same committed outputs (read_committed), txid marker
  and group offsets.
"""

import asyncio
import json

import numpy as np
import pytest

import storm_tpu.connectors.kafka_protocol as jax_kp
import storm_tpu.connectors.spout as jax_spout
import storm_tpu_torch.connectors.kafka_protocol as kp
import storm_tpu_torch.connectors.spout as port_spout
from storm_tpu_torch.connectors.kafka_stub import KafkaStubBroker
from tests.kafka_stub import KafkaStubBroker as JaxStub
from tests.test_kafka_protocol import _stabilize
from tests.test_torch_runtime import IMPLS
from tests.test_torch_transactional import _count_bolt, _impl

STUBS = {"storm_tpu_stub": JaxStub, "port_stub": KafkaStubBroker}
ALL = [("t", p) for p in range(4)]


@pytest.fixture(params=sorted(STUBS))
def stub_cls(request):
    return STUBS[request.param]


# ---- GroupMembership -----------------------------------------------------------------


def test_mixed_group_gets_the_range_assignment(stub_cls):
    stub = stub_cls(partitions=4)
    try:
        c1 = kp.KafkaWireClient(f"127.0.0.1:{stub.port}")
        c2 = jax_kp.KafkaWireClient(f"127.0.0.1:{stub.port}")
        c1.partitions_for("t")
        port_m = kp.GroupMembership(c1, "mixed", ["t"])
        jax_m = jax_kp.GroupMembership(c2, "mixed", ["t"])
        a_port, a_jax = _stabilize([port_m, jax_m])
        assert sorted(a_port + a_jax) == ALL and not set(a_port) & set(a_jax)
        assert len(a_port) == len(a_jax) == 2
        # Either package's assignor, given the two members' subscriptions,
        # gives exactly what the group handed out.
        members = {port_m.member_id: kp.GroupMembership._encode_subscription(["t"]),
                   jax_m.member_id: jax_kp.GroupMembership._encode_subscription(["t"])}
        for m in (port_m, jax_m):
            blobs = m._range_assign(members)
            got = {mid: kp.GroupMembership._decode_assignment(b) for mid, b in blobs.items()}
            assert got == {port_m.member_id: a_port, jax_m.member_id: a_jax}
        assert port_m._range_assign(members) == jax_m._range_assign(members)
        port_m.leave()
        jax_m.leave()
        c1.close()
        c2.close()
    finally:
        stub.close()


def test_group_rebalances_when_a_member_leaves(stub_cls):
    stub = stub_cls(partitions=4)
    try:
        c1, c2 = (kp.KafkaWireClient(f"127.0.0.1:{stub.port}") for _ in range(2))
        c1.partitions_for("t")
        m1, m2 = kp.GroupMembership(c1, "g", ["t"]), kp.GroupMembership(c2, "g", ["t"])
        (a1,) = _stabilize([m1])
        assert sorted(a1) == ALL
        a1, a2 = _stabilize([m1, m2])
        assert sorted(a1 + a2) == ALL and len(a1) == len(a2) == 2
        m2.leave()
        assert m2.generation == -1 and m2.member_id == ""
        assert not m1.heartbeat()  # the leave started a rebalance
        (a1,) = _stabilize([m1])
        assert sorted(a1) == ALL
        m1.leave()
    finally:
        stub.close()


def test_group_dead_member_expires(stub_cls):
    import time

    stub = stub_cls(partitions=2)
    try:
        c1, c2 = (kp.KafkaWireClient(f"127.0.0.1:{stub.port}") for _ in range(2))
        c1.partitions_for("t")
        m1 = kp.GroupMembership(c1, "g", ["t"], session_timeout_ms=500)
        m2 = kp.GroupMembership(c2, "g", ["t"], session_timeout_ms=500)
        a1, a2 = _stabilize([m1, m2])
        assert len(a1) == len(a2) == 1
        time.sleep(0.8)  # m2 neither heartbeats nor leaves
        assert not m1.heartbeat()
        (a1,) = _stabilize([m1])
        assert sorted(a1) == [("t", 0), ("t", 1)]
    finally:
        stub.close()


def test_three_members_split_five_partitions():
    stub = KafkaStubBroker(partitions=5)
    try:
        clients = [kp.KafkaWireClient(f"127.0.0.1:{stub.port}") for _ in range(3)]
        clients[0].partitions_for("t")
        assigns = _stabilize([kp.GroupMembership(c, "g3", ["t"]) for c in clients])
        assert sorted(p for a in assigns for p in a) == [("t", i) for i in range(5)]
        assert sorted(len(a) for a in assigns) == [1, 2, 2]
    finally:
        stub.close()


def test_group_codecs_same_bytes():
    rng = np.random.RandomState(15)
    for _ in range(50):
        topics = [f"topic-{i}" for i in rng.choice(9, rng.randint(1, 4), replace=False)]
        parts = sorted({(topics[rng.randint(len(topics))], int(rng.randint(16)))
                        for _ in range(rng.randint(0, 12))})
        for a, b in ((kp, jax_kp), (jax_kp, kp)):
            sub = a.GroupMembership._encode_subscription(topics)
            assert sub == b.GroupMembership._encode_subscription(topics)
            assert b.GroupMembership._decode_subscription(sub) == topics
            blob = a.GroupMembership._encode_assignment(parts)
            assert blob == b.GroupMembership._encode_assignment(parts)
            assert b.GroupMembership._decode_assignment(blob) == parts
    assert kp.GroupMembership._decode_assignment(b"") == []


# ---- the spout's group protocol ----------------------------------------------------------


def test_spout_group_protocol_splits_partitions(stub_cls, run):
    from storm_tpu_torch.config import Config, OffsetsConfig
    from storm_tpu_torch.runtime import Bolt, TopologyBuilder
    from storm_tpu_torch.runtime.cluster import AsyncLocalCluster

    got = []

    class Gather(Bolt):
        async def execute(self, t):
            got.append(t.get("message"))
            self.collector.ack(t)

    async def go():
        stub = stub_cls(partitions=4)
        broker = kp.KafkaWireBroker(f"127.0.0.1:{stub.port}")
        try:
            for i in range(12):
                broker.produce("gin", f"m{i}", key=str(i))
            tb = TopologyBuilder()
            tb.set_spout("spout", port_spout.BrokerSpout(
                broker, "gin", OffsetsConfig(policy="earliest", max_behind=None,
                                             group_id="gspout", group_protocol=True)), 2)
            tb.set_bolt("gather", Gather(), 1).shuffle_grouping("spout")
            cluster = AsyncLocalCluster()
            rt = await cluster.submit("gp", Config(), tb.build())
            spouts = [e.spout for e in rt.spout_execs["spout"]]
            deadline = asyncio.get_running_loop().time() + 60
            while asyncio.get_running_loop().time() < deadline:
                if sorted(len(s.my_partitions) for s in spouts) == [2, 2] and len(got) >= 12:
                    break
                await asyncio.sleep(0.1)
            assert sorted(len(s.my_partitions) for s in spouts) == [2, 2]
            assert sorted(p for s in spouts for p in s.my_partitions) == [0, 1, 2, 3]
            await cluster.shutdown()
            # the handoff re-reads a moved partition from 'earliest': never a loss
            assert set(got) == {f"m{i}" for i in range(12)}
        finally:
            broker.close()
            stub.close()

    run(go(), timeout=120)


def test_group_protocol_refusals_alike():
    import storm_tpu.config as jax_config
    import storm_tpu_torch.config as port_config

    class Ctx:
        task_index, parallelism, component_id, config, metrics = 0, 1, "s", None, None

    for cfg_mod, spout_mod, memory in (
            (port_config, port_spout, port_spout.MemoryBroker),
            (jax_config, jax_spout, jax_spout.MemoryBroker)):
        with pytest.raises(ValueError, match="group_id"):
            cfg_mod.OffsetsConfig(group_protocol=True)
        with pytest.raises(ValueError, match="group_protocol=False"):
            cfg_mod.OffsetsConfig(policy="txn", group_id="g", max_behind=None,
                                  group_protocol=True)
        spout = spout_mod.BrokerSpout(memory(), "t",
                                      cfg_mod.OffsetsConfig(group_protocol=True, group_id="g"))
        with pytest.raises(ValueError, match="wire-protocol broker"):
            spout.open(Ctx(), None)
    cfg = port_config.Config.from_dict(
        {"offsets": {"group_protocol": True, "group_id": "g", "policy": "resume"}})
    assert port_config.Config.from_dict(cfg.to_dict()).offsets.group_protocol is True


# ---- seek ------------------------------------------------------------------------------------


@pytest.mark.parametrize("s", ["earliest", "latest", "3", "-2", 7, -1, "0", "+3", "3.0", "",
                               "EARLIEST", " 3", "1e3", None, 2.5, "latest "])
def test_parse_seek_position_alike(s):
    def outcome(fn):
        try:
            return ("ok", fn(s))
        except ValueError:
            return ("ValueError",)

    assert outcome(port_spout.parse_seek_position) == outcome(jax_spout.parse_seek_position)


def _seek_scenario(impl):
    """10 records in 2 partitions; then seek earliest, latest (one record
    produced after), offset 3 and -2 behind the end: the values read
    after each seek."""
    spout_mod = port_spout if impl.name == "port" else jax_spout

    async def go():
        broker = impl.connectors.MemoryBroker(default_partitions=2)
        for i in range(10):
            broker.produce("t", json.dumps({"i": i}), partition=i % 2)
        seen = []

        class Count(impl.runtime.Bolt):
            async def execute(self, t):
                seen.append(t.values[0])
                self.collector.ack(t)

        async def settle(n, label):
            loop = asyncio.get_running_loop()
            deadline = loop.time() + 15
            while len(seen) < n:
                assert loop.time() < deadline, (label, len(seen), n)
                await asyncio.sleep(0.02)
            await asyncio.sleep(0.3)  # any extra surfaces
            assert len(seen) == n, (label, len(seen), n)

        tb = impl.runtime.TopologyBuilder()
        tb.set_spout("s", spout_mod.BrokerSpout(
            broker, "t", impl.config.OffsetsConfig(policy="earliest")), 1)
        tb.set_bolt("c", Count(), 1).shuffle_grouping("s")
        cluster = impl.cluster.AsyncLocalCluster()
        rt = await cluster.submit("seek", impl.config.Config(), tb.build())
        steps = []
        try:
            await settle(10, "first read")
            steps.append(sorted(seen))
            for position, produce, want in (("earliest", False, 10), ("latest", True, 1),
                                            (3, False, 5), (-2, False, 4)):
                base = len(seen)
                assert await rt.seek("s", position) == 1
                await asyncio.sleep(0.2)  # applied at the spout's next poll
                if produce:
                    broker.produce("t", json.dumps({"i": 99}), partition=1)
                await settle(base + want, position)
                steps.append(sorted(seen[base:]))
            errors = []
            for comp in ("nope", "c"):
                try:
                    await rt.seek(comp, "earliest")
                except KeyError as e:
                    errors.append(("KeyError", str(e)))
            return steps, errors
        finally:
            await cluster.shutdown()

    return go()


def test_seek_replays_and_skips_alike(run):
    got = {name: run(_seek_scenario(IMPLS[name]), timeout=60) for name in sorted(IMPLS)}
    assert got["port"] == got["storm_tpu"]
    steps, errors = got["port"]
    everything = sorted(json.dumps({"i": i}) for i in range(10))
    assert steps[0] == steps[1] == everything
    assert steps[2] == [json.dumps({"i": 99})]
    # offset 3 in each partition: p0 holds 0,2,4,6,8 (offsets 3, 4 -> 6, 8), p1
    # holds 1,3,5,7,9,99 (offsets 3..5 -> 7, 9, 99)
    assert steps[3] == sorted(json.dumps({"i": i}) for i in (6, 8, 7, 9, 99))
    assert steps[4] == sorted(json.dumps({"i": i}) for i in (6, 8, 9, 99))
    assert len(errors) == 2


def test_seek_on_a_spout_without_request_seek_is_a_type_error(run):
    from storm_tpu_torch.config import Config
    from storm_tpu_torch.runtime import Bolt, Spout, TopologyBuilder
    from storm_tpu_torch.runtime.cluster import AsyncLocalCluster

    class Idle(Spout):
        async def next_tuple(self):
            return False

    class Sink(Bolt):
        async def execute(self, t):
            self.collector.ack(t)

    async def go():
        tb = TopologyBuilder()
        tb.set_spout("idle", Idle(), 1)
        tb.set_bolt("sink", Sink(), 1).shuffle_grouping("idle")
        cluster = AsyncLocalCluster()
        rt = await cluster.submit("noseek", Config(), tb.build())
        try:
            with pytest.raises(TypeError, match="not seekable"):
                await rt.seek("idle", "earliest")
        finally:
            await cluster.shutdown()

    run(go(), timeout=30)


# ---- Trident over the wire broker ----------------------------------------------------------


def _trident_over_wire(impl, kp_mod, stub):
    async def go():
        broker = kp_mod.KafkaWireBroker(f"127.0.0.1:{stub.port}", message_format="v2")
        reader = kp_mod.KafkaWireBroker(f"127.0.0.1:{stub.port}", message_format="v2",
                                        isolation="read_committed")
        words = ("a", "b", "a", "c", "a", "b", "d", "a")
        try:
            for i, w in enumerate(words):
                broker.produce("in", f"{w}:{i}".encode(), partition=0)
            cfg = impl.config.Config()
            cfg.topology.message_timeout_s = 2.0
            tb = impl.runtime.TopologyBuilder()
            tb.set_spout("tx-spout", impl.tx.TransactionalSpout(broker, "in", batch_size=3), 1)
            tb.set_bolt("count", _count_bolt(impl, True)(), 1).shuffle_grouping("tx-spout")
            tb.set_bolt("sink", impl.tx.TransactionalSink(broker, "out"), 1) \
                .shuffle_grouping("count")
            cluster = impl.cluster.AsyncLocalCluster()
            rt = await cluster.submit("tx-wire", cfg, tb.build())
            want = len(set(words[:3])) + len(set(words[3:6])) + len(set(words[6:]))
            loop = asyncio.get_running_loop()
            deadline = loop.time() + 40
            outs = []
            try:
                while True:
                    outs = [r.value.decode() for r in reader.fetch("out", 0, 0)]
                    if len(outs) >= want:
                        break
                    assert loop.time() < deadline, ("batches stuck", outs)
                    await asyncio.sleep(0.05)
                await rt.drain(timeout_s=10)
                sink = rt.bolt_execs["sink"][0].bolt
                groups = {g: broker.committed(g, "in", 0) for g in ("tx", "tx.pending")}
                return (outs, sink.state.get("last_txid"), groups,
                        rt.metrics.snapshot()["tx-spout"].get("tree_failed"))
            finally:
                await cluster.shutdown()
        finally:
            broker.close()
            reader.close()

    return go()


def test_trident_over_the_wire_broker_alike(run):
    got = {}
    for name, kp_mod in (("port", kp), ("storm_tpu", jax_kp)):
        stub = KafkaStubBroker(partitions=1)
        stub.log_transactional = True
        try:
            got[name] = run(_trident_over_wire(_impl(name), kp_mod, stub), timeout=90)
        finally:
            stub.close()
    assert got["port"] == got["storm_tpu"]
    outs, last_txid, groups, failed = got["port"]
    totals = {}
    for o in outs:
        totals.update(json.loads(o))
    assert totals == {"a": 4, "b": 2, "c": 1, "d": 1}
    assert groups["tx"] == 8 and failed == 1
