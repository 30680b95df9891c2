"""The port's Kafka wire client beyond plain produce and fetch, against
storm_tpu's stub and the port's, side by side with storm_tpu's client, on
the CPU over real sockets on 127.0.0.1:

- SASL (PLAIN, SCRAM-SHA-256, SCRAM-SHA-512) authenticates, and a wrong
  password is refused; SSL and SASL_SSL through ``_make_broker``'s reading
  of ``cfg.broker``'s security keys;
- KIP-98 idempotent produce: the same producer ids, offsets and errors as
  storm_tpu's client (a retried batch appends once, a sequence gap is
  refused), and ``KafkaWireBroker(idempotent=True)``'s sequences;
- ``KafkaTxn``: commit, abort, zombie fencing and offsets inside the
  transaction; ``read_committed`` fetches drop aborted records as
  storm_tpu's do;
- the port's stub serves storm_tpu's consumer-group client as storm_tpu's
  stub does;
- the port's ``TransactionalBrokerSink`` over the wire broker (the caller
  of ``KafkaTxn``): every record out once, the group's offsets committed
  with it.
"""

import asyncio

import pytest

import storm_tpu.connectors.kafka_protocol as jax_kp
from storm_tpu_torch.connectors import kafka_protocol as kp
from storm_tpu_torch.connectors.kafka_stub import KafkaStubBroker
from tests.kafka_stub import KafkaStubBroker as JaxStub
from tests.test_kafka_protocol import _stabilize

STUBS = {"storm_tpu_stub": JaxStub, "port_stub": KafkaStubBroker}


@pytest.fixture(params=sorted(STUBS))
def stub_cls(request):
    return STUBS[request.param]


@pytest.fixture(scope="module")
def ssl_certs(tmp_path_factory):
    import subprocess

    d = tmp_path_factory.mktemp("certs")
    crt, key = str(d / "broker.crt"), str(d / "broker.key")
    subprocess.run(["openssl", "req", "-x509", "-newkey", "rsa:2048", "-nodes", "-keyout", key,
                    "-out", crt, "-days", "2", "-subj", "/CN=127.0.0.1", "-addext",
                    "subjectAltName=IP:127.0.0.1"], check=True, capture_output=True)
    return crt, key


def _round_trip(client_mod, port: int, security: dict, value: bytes) -> list:
    c = client_mod.KafkaWireClient(f"127.0.0.1:{port}", security=security)
    try:
        c.produce("t", 0, [(None, value)])
        return [r.value for r in c.fetch("t", 0, 0, max_wait_ms=10)]
    finally:
        c.close()


@pytest.mark.parametrize("mech", ["PLAIN", "SCRAM-SHA-256", "SCRAM-SHA-512"])
def test_sasl_authenticates_like_storm_tpu(stub_cls, mech):
    stub = stub_cls(partitions=1)
    stub.sasl, stub.sasl_mechanism = ("svc", "pw"), mech
    sec = {"protocol": "SASL_PLAINTEXT", "sasl_mechanism": mech, "sasl_username": "svc",
           "sasl_password": "pw"}
    try:
        assert _round_trip(kp, stub.port, sec, b"port") == [b"port"]
        assert _round_trip(jax_kp, stub.port, sec, b"jax") == [b"port", b"jax"]
        for mod in (kp, jax_kp):
            with pytest.raises((mod.KafkaProtocolError, OSError)):
                _round_trip(mod, stub.port, {**sec, "sasl_password": "wrong"}, b"x")
            with pytest.raises((mod.KafkaProtocolError, OSError)):
                _round_trip(mod, stub.port, None, b"x")  # no handshake at all
        assert stub.topic_size("t") == 2
    finally:
        stub.close()


@pytest.mark.parametrize("protocol", ["SSL", "SASL_SSL"])
def test_ssl_through_the_broker_config(ssl_certs, protocol):
    """``_make_broker`` hands ``cfg.broker``'s security keys to the wire
    client: TLS with the broker's certificate checked against the CA file,
    then SASL over it for SASL_SSL."""
    import ssl

    from storm_tpu_torch.config import Config
    from storm_tpu_torch.main import _make_broker

    crt, key = ssl_certs
    stub = JaxStub(partitions=1)
    stub.ssl_context = ssl.SSLContext(ssl.PROTOCOL_TLS_SERVER)
    stub.ssl_context.load_cert_chain(crt, key)
    if protocol == "SASL_SSL":
        stub.sasl = ("svc", "pw")
    cfg = Config()
    cfg.broker.kind, cfg.broker.bootstrap = "kafka", f"127.0.0.1:{stub.port}"
    cfg.broker.security_protocol, cfg.broker.ssl_cafile = protocol, crt
    cfg.broker.ssl_check_hostname = False
    cfg.broker.sasl_username, cfg.broker.sasl_password = "svc", "pw"
    broker = _make_broker(cfg)
    try:
        broker.produce("t", b"tls", partition=0)
        assert [r.value for r in broker.fetch("t", 0, 0)] == [b"tls"]
    finally:
        broker.close()
        stub.close()
    cfg.broker.ssl_cafile = ""  # the system's CAs do not vouch for the stub
    stub = JaxStub(partitions=1)
    stub.ssl_context = ssl.SSLContext(ssl.PROTOCOL_TLS_SERVER)
    stub.ssl_context.load_cert_chain(crt, key)
    cfg.broker.bootstrap = f"127.0.0.1:{stub.port}"
    try:
        with pytest.raises((kp.KafkaProtocolError, OSError)):
            broker = _make_broker(cfg)
            broker.produce("t", b"x", partition=0)
    finally:
        stub.close()


def _idempotent_steps(mod, port: int) -> list:
    c = mod.KafkaWireClient(f"127.0.0.1:{port}")
    try:
        pid, epoch = c.init_producer_id()
        out = [epoch]
        out.append(c.produce("t", 0, [(None, b"a")], message_format="v2",
                             producer=(pid, epoch, 0)))
        # a retried batch (same sequence) answers its first offset
        out.append(c.produce("t", 0, [(None, b"a")], message_format="v2",
                             producer=(pid, epoch, 0)))
        out.append(c.produce("t", 0, [(None, b"b"), (None, b"c")], message_format="v2",
                             producer=(pid, epoch, 1)))
        with pytest.raises(mod.KafkaProtocolError, match="45"):  # OUT_OF_ORDER_SEQUENCE
            c.produce("t", 0, [(None, b"d")], message_format="v2", producer=(pid, epoch, 9))
        return out
    finally:
        c.close()


def test_idempotent_produce_like_storm_tpu(stub_cls):
    got = {}
    for name, mod in (("port", kp), ("storm_tpu", jax_kp)):
        stub = stub_cls(partitions=1)
        try:
            got[name] = _idempotent_steps(mod, stub.port) + [stub.topic_size("t")]
        finally:
            stub.close()
    assert got["port"] == got["storm_tpu"] == [0, 0, 0, 1, 3]


def test_idempotent_broker_sequences_like_storm_tpu():
    got = {}
    for name, mod in (("port", kp), ("storm_tpu", jax_kp)):
        stub = KafkaStubBroker(partitions=2)
        b = mod.KafkaWireBroker(f"127.0.0.1:{stub.port}", message_format="v2", idempotent=True)
        try:
            placed = [b.produce("t", f"m{i}".encode(), partition=i % 2) for i in range(6)]
            vals = sorted(r.value for p in (0, 1) for r in b.fetch("t", p, 0))
            got[name] = (placed, vals)
            with pytest.raises(mod.KafkaProtocolError, match="message_format"):
                mod.KafkaWireBroker(f"127.0.0.1:{stub.port}", idempotent=True)
        finally:
            b.close()
            stub.close()
    assert got["port"] == got["storm_tpu"]
    assert got["port"][1] == [f"m{i}".encode() for i in range(6)]


def _txn_steps(mod, port: int, stub) -> list:
    b = mod.KafkaWireBroker(f"127.0.0.1:{port}", message_format="v2")
    b2 = mod.KafkaWireBroker(f"127.0.0.1:{port}", message_format="v2")
    try:
        txn = b.txn("tx-0")
        txn.begin()
        txn.produce("t", b"a", partition=0)
        txn.produce("t", b"b", partition=0)
        txn.send_offsets("g", {("in", 0): 5})
        out = [stub.topic_size("t"), b.committed("g", "in", 0)]  # nothing before commit
        txn.commit()
        out += [stub.topic_size("t"), b.committed("g", "in", 0)]
        txn.begin()
        txn.produce("t", b"dropped", partition=0)
        txn.send_offsets("g", {("in", 0): 9})
        txn.abort()
        out += [stub.topic_size("t"), b.committed("g", "in", 0)]
        # a second handle on the same id bumps the epoch: the first is fenced
        winner = b2.txn("tx-0")
        winner.begin()
        txn.begin()
        with pytest.raises(mod.KafkaProtocolError):
            txn.produce("t", b"zombie", partition=0)
            txn.commit()
        winner.produce("t", b"winner", partition=0)
        winner.commit()
        out.append([r.value for r in b.fetch("t", 0, 0)])
        return out
    finally:
        b.close()
        b2.close()


def test_txn_commit_abort_fencing_like_storm_tpu(stub_cls):
    got = {}
    for name, mod in (("port", kp), ("storm_tpu", jax_kp)):
        stub = stub_cls(partitions=1)
        try:
            got[name] = _txn_steps(mod, stub.port, stub)
        finally:
            stub.close()
    assert got["port"] == got["storm_tpu"] == [0, None, 2, 5, 2, 5, [b"a", b"b", b"winner"]]


def _read_committed(mod, port: int) -> tuple:
    good = mod.KafkaWireBroker(f"127.0.0.1:{port}", message_format="v2", client_id="good")
    bad = mod.KafkaWireBroker(f"127.0.0.1:{port}", message_format="v2", client_id="bad")
    rc = mod.KafkaWireBroker(f"127.0.0.1:{port}", message_format="v2",
                             isolation="read_committed")
    try:
        t = good.txn("rc-good")
        t.begin()
        t.produce("rc", b"ok-0", partition=0)
        t.commit()
        # an aborted transaction whose records reached the log
        pid, epoch = bad.client.init_producer_id(transactional_id="rc-bad")
        bad.client.add_partitions_to_txn("rc-bad", pid, epoch, [("rc", 0)])
        bad.client.produce("rc", 0, [(None, b"POISON")], acks=-1, message_format="v2",
                           producer=(pid, epoch, 0), transactional_id="rc-bad")
        bad.client.end_txn("rc-bad", pid, epoch, commit=False)
        t.begin()
        t.produce("rc", b"ok-1", partition=0)
        t.commit()
        everything = [r.value for r in good.fetch("rc", 0, 0)]
        committed = [(r.offset, r.value) for r in rc.fetch("rc", 0, 0)]
        return everything, committed
    finally:
        good.close()
        bad.close()
        rc.close()


def test_read_committed_like_storm_tpu(stub_cls):
    got = {}
    for name, mod in (("port", kp), ("storm_tpu", jax_kp)):
        stub = stub_cls(partitions=1)
        stub.log_transactional = True  # records land at once, EndTxn writes a marker
        try:
            got[name] = _read_committed(mod, stub.port)
        finally:
            stub.close()
    assert got["port"] == got["storm_tpu"]
    everything, committed = got["port"]
    assert b"POISON" in everything
    assert [v for _o, v in committed] == [b"ok-0", b"ok-1"]


def test_port_stub_serves_storm_tpus_group_client():
    got = {}
    for name, cls in sorted(STUBS.items()):
        stub = cls(partitions=5)
        try:
            clients = [jax_kp.KafkaWireClient(f"127.0.0.1:{stub.port}") for _ in range(3)]
            clients[0].partitions_for("t")
            members = [jax_kp.GroupMembership(c, "g", ["t"]) for c in clients]
            assigns = _stabilize(members)
            got[name] = (sorted(p for a in assigns for p in a),
                         sorted(len(a) for a in assigns))
            members[2].leave()
            assert not members[0].heartbeat()  # the leave starts a rebalance
            for m in members[:2]:
                m.leave()
            for c in clients:
                c.close()
        finally:
            stub.close()
    assert got["port_stub"] == got["storm_tpu_stub"] == ([("t", i) for i in range(5)],
                                                         [1, 2, 2])


def test_transactional_sink_over_the_wire_broker():
    """The port's txn spout and TransactionalBrokerSink on the wire broker:
    each record's output committed once, in a transaction with the
    group's offsets, which end at the log's end."""
    from storm_tpu_torch.config import Config, OffsetsConfig, SinkConfig
    from storm_tpu_torch.connectors import BrokerSpout, TransactionalBrokerSink
    from storm_tpu_torch.runtime import AsyncLocalCluster, Bolt, TopologyBuilder

    class Upper(Bolt):
        def declare_output_fields(self):
            return {"default": ("message",)}

        async def execute(self, t):
            await self.collector.emit([t.values[0].upper()], anchors=[t])
            self.collector.ack(t)

    stub = KafkaStubBroker(partitions=2)
    stub.log_transactional = True
    broker = kp.KafkaWireBroker(f"127.0.0.1:{stub.port}", message_format="v2",
                                isolation="read_committed")
    try:
        for i in range(12):
            broker.produce("in", f"rec-{i}".encode(), partition=i % 2)
        offsets = OffsetsConfig(policy="txn", group_id="eos", max_behind=None)
        sink_cfg = SinkConfig(mode="transactional", txn_batch=4, txn_ms=20,
                              offsets_group="eos")

        def committed() -> int:
            return sum(broker.committed("eos", "in", p) or 0 for p in range(2))

        async def run():
            tb = TopologyBuilder()
            tb.set_spout("spout", BrokerSpout(broker, "in", offsets), parallelism=1)
            tb.set_bolt("up", Upper(), parallelism=2).shuffle_grouping("spout")
            tb.set_bolt("sink", TransactionalBrokerSink(broker, "out", sink_cfg),
                        parallelism=1).shuffle_grouping("up")
            cluster = AsyncLocalCluster()
            rt = await cluster.submit("eos-wire", Config(), tb.build())
            for _ in range(400):
                if committed() == 12:
                    break
                await asyncio.sleep(0.05)
            snap = rt.metrics.snapshot()["sink"]
            await cluster.shutdown()
            return snap

        snap = asyncio.run(run())
        outs = sorted(r.value for p in range(2) for r in broker.fetch("out", p, 0, 100))
        assert outs == sorted(f"REC-{i}".encode() for i in range(12))
        assert committed() == 12
        assert snap["txn_commits"] >= 1 and snap.get("txn_aborts", 0) == 0
    finally:
        broker.close()
        stub.close()
