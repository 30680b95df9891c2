"""The port's Kafka wire client and stub broker against storm_tpu's, on the
CPU, over real sockets on 127.0.0.1.

- the port's ``KafkaWireBroker`` produces to and fetches from storm_tpu's
  ``tests/kafka_stub.KafkaStubBroker`` (message sets, record batches and
  their codecs), and commits and reads group offsets there;
- storm_tpu's client works against the port's stub alike;
- ``encode_message_set`` and ``encode_record_batch`` give storm_tpu's
  bytes, and each package decodes the other's;
- lz4 and snappy decompress as storm_tpu's do, on the codecs' own frames,
  on hand-made streams with back-references, and on random bytes (the
  same output, or the same error);
- the port's stub runs as ``python -m storm_tpu_torch.connectors.kafka_stub``;
- the port's spout and sink run over the wire broker (its blocking calls
  go through worker threads) and commit offsets.
"""

import asyncio
import json
import struct
import subprocess
import sys

import numpy as np
import pytest
from hypothesis import given, settings
from hypothesis import strategies as st

import storm_tpu.connectors.kafka_protocol as jax_kp
import storm_tpu.connectors.lz4 as jax_lz4
import storm_tpu.connectors.snappy as jax_snappy
from storm_tpu_torch.connectors import kafka_protocol as kp
from storm_tpu_torch.connectors import lz4, snappy
from storm_tpu_torch.connectors.kafka_stub import KafkaStubBroker
from tests.kafka_stub import KafkaStubBroker as JaxStub
from tests.test_torch_codec import storm_tpu_native  # noqa: F401 (module fixture)

ROOT = __import__("pathlib").Path(__file__).resolve().parents[1]


def _records(seed: int, n: int = 12) -> list:
    rng = np.random.RandomState(seed)
    return [(None if i % 3 == 0 else f"k{i}".encode(),
             bytes(rng.randint(0, 256, size=int(rng.randint(1, 3000))).astype(np.uint8)))
            for i in range(n)]


def _roundtrip(stub_port: int, broker_cls, records: list, **kw) -> list:
    b = broker_cls(f"127.0.0.1:{stub_port}", **kw)
    try:
        for key, value in records:
            b.produce("t", value, key)
        got = []
        for p in range(b.partitions_for("t")):
            off = b.earliest_offset("t", p)
            while off < b.latest_offset("t", p):
                recs = b.fetch("t", p, off, 5)
                got += [(r.key, r.value) for r in recs]
                off = recs[-1].offset + 1
        b.commit("g", "t", 0, 3)
        assert b.committed("g", "t", 0) == 3
        return got
    finally:
        b.close()


MODES = [dict(), dict(message_format="v2"), dict(message_format="v2", compression="gzip"),
         dict(message_format="v2", compression="snappy"),
         dict(message_format="v2", compression="lz4")]


@pytest.mark.parametrize("mode", MODES, ids=lambda m: "-".join(m.values()) or "v1")
def test_port_client_against_storm_tpu_stub(mode):
    stub = JaxStub(partitions=2)
    try:
        recs = _records(0)
        got = _roundtrip(stub.port, kp.KafkaWireBroker, recs, **mode)
        assert sorted(got, key=repr) == sorted(recs, key=repr)
        assert stub.topic_size("t") == len(recs)
    finally:
        stub.close()


@pytest.mark.parametrize("mode", MODES[:3], ids=lambda m: "-".join(m.values()) or "v1")
def test_storm_tpu_client_against_port_stub(mode):
    stub = KafkaStubBroker(partitions=3)
    try:
        recs = _records(1)
        got = _roundtrip(stub.port, jax_kp.KafkaWireBroker, recs, **mode)
        assert sorted(got, key=repr) == sorted(recs, key=repr)
    finally:
        stub.close()


def test_port_stub_serves_record_batches():
    stub = KafkaStubBroker(partitions=1)
    stub.serve_batches = True
    try:
        recs = _records(2, n=5)
        assert _roundtrip(stub.port, kp.KafkaWireBroker, recs) == recs
    finally:
        stub.close()


@pytest.mark.parametrize("compression", [None, "gzip", "snappy", "lz4"])
def test_record_batch_and_message_set_bytes(compression):
    recs = _records(3, n=6)
    mine = kp.encode_record_batch(recs, 1_700_000_000_123, base_offset=7,
                                  compression=compression, producer=(11, 2, 5))
    theirs = jax_kp.encode_record_batch(recs, 1_700_000_000_123, base_offset=7,
                                        compression=compression, producer=(11, 2, 5))
    if compression != "gzip":  # gzip stamps its own mtime
        assert mine == theirs
    def rows(decode, blob):
        recs, used = decode("t", 0, blob, verify_crc=True)
        assert used == len(blob)
        return [(r.key, r.value, r.offset) for r in recs]

    want = rows(jax_kp.decode_record_batch, theirs)
    assert want == [(k, v, 7 + i) for i, (k, v) in enumerate(recs)]
    assert rows(kp.decode_record_batch, theirs) == want
    assert rows(jax_kp.decode_record_batch, mine) == want
    ms = kp.encode_message_set(recs, 1_700_000_000_123, offsets=list(range(6)))
    assert ms == jax_kp.encode_message_set(recs, 1_700_000_000_123, offsets=list(range(6)))
    assert ([(r.key, r.value) for r in kp.decode_message_set("t", 0, ms)]
            == [(r.key, r.value) for r in jax_kp.decode_message_set("t", 0, ms)] == recs)


def _snappy_with_copies(data: bytes) -> bytes:
    """A raw snappy block: 8 literal bytes, then 1-byte-offset copies of
    them (tag 01) and one 2-byte-offset copy (tag 10)."""
    lit = data[:8]
    out = bytearray()
    n = 8 + 3 * 8 + 5
    while True:  # varint length
        b = n & 0x7F
        n >>= 7
        out.append(b | (0x80 if n else 0))
        if not n:
            break
    out += bytes([(8 - 1) << 2]) + lit
    for _ in range(3):
        out += bytes([0b01 | ((8 - 4) << 2), 8])  # copy 8 bytes at offset 8
    out += bytes([0b10 | ((5 - 1) << 2)]) + struct.pack("<H", 16)
    return bytes(out)


def _lz4_block_with_match(data: bytes) -> bytes:
    """An lz4 block: 6 literals, a 12-byte match at offset 6, 5 literals."""
    out = bytearray([(6 << 4) | (12 - 4)]) + data[:6] + struct.pack("<H", 6)
    out += bytes([5 << 4]) + data[6:11]
    return bytes(out)


@pytest.mark.parametrize("seed", [0, 1])
def test_codecs_decompress_as_storm_tpus(seed):
    rng = np.random.RandomState(seed)
    data = bytes(rng.randint(0, 256, size=5000).astype(np.uint8))
    for xerial in (False, True):
        blob = snappy.compress(data, xerial=xerial)
        assert blob == jax_snappy.compress(data, xerial=xerial)
        assert snappy.decompress(blob) == jax_snappy.decompress(blob) == data
    raw = _snappy_with_copies(data)
    assert snappy.decompress_raw(raw) == jax_snappy.decompress_raw(raw)
    assert len(snappy.decompress_raw(raw)) == 8 + 3 * 8 + 5
    frame = lz4.compress_frame(data, block_size=1024)
    assert frame == jax_lz4.compress_frame(data, block_size=1024)
    assert lz4.decompress_frame(frame) == jax_lz4.decompress_frame(frame) == data
    block = _lz4_block_with_match(data)
    assert lz4.decompress_block(block) == jax_lz4.decompress_block(block)
    assert lz4.decompress_block(block)[6:18] == data[:6] * 2


def _outcome(fn, blob):
    try:
        return ("ok", fn(blob))
    except Exception as e:
        return ("error", type(e).__name__, str(e))


@settings(max_examples=80, deadline=None)
@given(blob=st.binary(max_size=64))
def test_codecs_agree_on_random_bytes(blob):
    assert _outcome(snappy.decompress_raw, blob) == _outcome(jax_snappy.decompress_raw, blob)
    assert _outcome(lz4.decompress_block, blob) == _outcome(jax_lz4.decompress_block, blob)
    framed = b"\x04\x22\x4d\x18" + blob
    assert _outcome(lz4.decompress_frame, framed) == _outcome(jax_lz4.decompress_frame, framed)


def test_stub_runs_as_a_process():
    proc = subprocess.Popen([sys.executable, "-m", "storm_tpu_torch.connectors.kafka_stub",
                             "--port", "0", "--partitions", "2"], cwd=str(ROOT),
                            stdout=subprocess.PIPE, stdin=subprocess.DEVNULL)
    try:
        info = json.loads(proc.stdout.readline())
        assert info["ready"] is True
        got = _roundtrip(info["port"], kp.KafkaWireBroker, _records(4, n=4))
        assert len(got) == 4
    finally:
        proc.terminate()
        assert proc.wait(timeout=10) == 0
        proc.stdout.close()


def test_spout_and_sink_over_the_wire_broker():
    """A pass-through bolt between the port's BrokerSpout and BrokerSink,
    both on the wire broker: every record out once, and the group's
    offsets committed to the log's end ('resume' commits on ack, through
    the worker-thread hop)."""
    from storm_tpu_torch.config import Config, OffsetsConfig
    from storm_tpu_torch.connectors import BrokerSink, BrokerSpout
    from storm_tpu_torch.runtime import AsyncLocalCluster, Bolt, TopologyBuilder

    class Upper(Bolt):
        def declare_output_fields(self):
            return {"default": ("message",)}

        async def execute(self, t):
            await self.collector.emit([t.values[0].upper()], anchors=[t])
            self.collector.ack(t)

    stub = KafkaStubBroker(partitions=2)
    broker = kp.KafkaWireBroker(f"127.0.0.1:{stub.port}")
    try:
        for i in range(10):
            broker.produce("in", f"rec-{i}".encode(), f"k{i}".encode())
        offsets = OffsetsConfig(policy="resume", group_id="g1", max_behind=None)

        async def run():
            tb = TopologyBuilder()
            tb.set_spout("spout", BrokerSpout(broker, "in", offsets), parallelism=2)
            tb.set_bolt("up", Upper(), parallelism=2).shuffle_grouping("spout")
            tb.set_bolt("sink", BrokerSink(broker, "out"), parallelism=1) \
                .shuffle_grouping("up")
            cluster = AsyncLocalCluster()
            await cluster.submit("wire", Config(), tb.build())
            for _ in range(400):
                if stub.topic_size("out") >= 10 and committed() == 10:
                    break  # the commits are background tasks: wait for them
                await asyncio.sleep(0.05)
            await cluster.shutdown()

        def committed() -> int:
            return sum(broker.committed("g1", "in", p) or 0 for p in range(2))

        asyncio.run(run())
        outs = sorted(r.value for p in range(2) for r in broker.fetch("out", p, 0, 100))
        assert outs == sorted(f"REC-{i}".encode() for i in range(10))
        assert committed() == 10
    finally:
        broker.close()
        stub.close()


def _spout_acked_out_of_order(mod, broker, offsets_cls):
    """Three records of one partition emitted, then acked 2, 0, 1: the
    group's committed offset after each ack."""
    from types import SimpleNamespace

    class Collector:
        async def emit(self, *a, **kw):
            return None

    spout = mod.BrokerSpout(broker, "in", offsets_cls(policy="resume", group_id="g",
                                                      max_behind=None))
    spout.open(SimpleNamespace(component_id="s", task_index=0, parallelism=1,
                               metrics=None, tracer=None), Collector())
    for i in range(3):
        broker.produce("in", f"r{i}".encode(), partition=0)

    async def go():
        assert await spout.next_tuple()
        seen = []
        for off in (2, 0, 1):
            spout.ack((0, off))
            await asyncio.sleep(0.05)  # a blocking broker commits off the loop
            for _ in range(100):
                if broker.committed("g", "in", 0) is not None:
                    break
                await asyncio.sleep(0.01)
            seen.append(broker.committed("g", "in", 0))
        for _ in range(100):  # the last background commit
            if seen[-1] == 3 or getattr(spout, "_blocking", False) is False:
                break
            await asyncio.sleep(0.01)
            seen[-1] = broker.committed("g", "in", 0)
        return seen

    return asyncio.run(go())


@pytest.mark.parametrize("broker_kind", ["memory", "wire"])
def test_resume_commit_after_out_of_order_acks(broker_kind):
    """The port's 'resume' spout commits the log's end once every record
    is acked, whatever order the acks came in (ROADMAP C17); storm_tpu's
    commits the last acked offset + 1 and falls one record short."""
    import storm_tpu.connectors.spout as jax_spout
    from storm_tpu.config import OffsetsConfig as JaxOffsets
    from storm_tpu.connectors import MemoryBroker as JaxMemory
    from storm_tpu_torch.config import OffsetsConfig
    from storm_tpu_torch.connectors import MemoryBroker
    from storm_tpu_torch.connectors import spout as port_spout

    stub = KafkaStubBroker(partitions=1) if broker_kind == "wire" else None
    broker = (kp.KafkaWireBroker(f"127.0.0.1:{stub.port}") if stub
              else MemoryBroker(default_partitions=1))
    try:
        assert _spout_acked_out_of_order(port_spout, broker, OffsetsConfig) == [0, 1, 3]
    finally:
        if stub:
            broker.close()
            stub.close()
    assert _spout_acked_out_of_order(jax_spout, JaxMemory(default_partitions=1),
                                     JaxOffsets) == [0, 1, 2]
