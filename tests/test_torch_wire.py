"""The port's dist wire (``storm_tpu_torch/dist/wire.py`` and the JSON
envelope of ``dist/transport.py``) against storm_tpu's, on the CPU.

Seeded tuples cover every slot tag (None, False, True, i64, f64, str,
bytes, ndarray, list, JSON, record frame) with anchors, origins and a
trace context. For each frame kind (deliveries at wire versions 2 and 1,
acks, the shared-memory header) and each checksum (CRC32C, zlib):

- the port encodes exactly storm_tpu's bytes for the same tuples;
- each package decodes the other's frame to the same tuples;
- a flipped byte makes both raise their ``WireError``.

And: the port's native ``crc32c`` and its pure-Python twin agree with
storm_tpu's on hypothesis-drawn bytes; the JSON envelope (``encode_tuple``,
``decode_tuple``, ``encode_deliveries``, ``encode_acks``) gives storm_tpu's
bytes and values. storm_tpu's checksum is CRC32C only when its native
library loads (else zlib), so its library is built by
``tests/test_torch_codec.py``'s module fixture.
"""

import json

import numpy as np
import pytest
from hypothesis import given, settings
from hypothesis import strategies as st

import storm_tpu.dist.transport as jax_transport
import storm_tpu.dist.wire as jax_wire
import storm_tpu.native as jax_native
from storm_tpu.runtime.frames import RecordFrame as JaxFrame
from storm_tpu.runtime.tracing import TraceContext as JaxTrace
from storm_tpu.runtime.tuples import Tuple as JaxTuple
from storm_tpu_torch.dist import transport, wire
from storm_tpu_torch.native import crc32c, crc32c_reference
from storm_tpu_torch.runtime.frames import RecordFrame
from storm_tpu_torch.runtime.tracing import TraceContext
from storm_tpu_torch.runtime.tuples import Tuple
from tests.test_torch_codec import storm_tpu_native  # noqa: F401 (module fixture)

NOW = 1234.5


def _values(rng: np.random.RandomState, frame_cls) -> list:
    """One value of every slot kind, from the seed."""
    arr = rng.rand(2, 3, 4).astype(np.float32)
    recs = [bytes(rng.randint(0, 256, size=rng.randint(1, 40)).astype(np.uint8))
            for _ in range(3)]
    return [None, False, True, int(rng.randint(-2**40, 2**40)), float(rng.randn()),
            "tensor é中", bytes(rng.randint(0, 256, 17).astype(np.uint8)), arr,
            [1, "two", [3.5, None]], {"k": [1, 2]}, 2**70, frame_cls(recs)]


def _pair(seed: int, n: int = 5):
    """The same n deliveries as storm_tpu tuples and as the port's."""
    rng = np.random.RandomState(seed)
    jax_out, out = [], []
    for i in range(n):
        vals_j = _values(np.random.RandomState(seed * 100 + i), JaxFrame)
        vals_p = _values(np.random.RandomState(seed * 100 + i), RecordFrame)
        anchors = [int(rng.randint(1, 2**62)) for _ in range(rng.randint(0, 4))]
        origins = [(f"topic-{k}", int(rng.randint(0, 8)), int(rng.randint(0, 10**9)))
                   for k in range(rng.randint(0, 3))]
        tid, sid = f"{rng.randint(1, 2**62):032x}", f"{rng.randint(1, 2**62):016x}"
        common = dict(fields=tuple(f"f{k}" for k in range(len(vals_p))),
                      source_component=f"comp-{i}", source_task=i, stream="default",
                      edge_id=int(rng.randint(1, 2**62)), root_ts=NOW - 0.25 * i)
        jax_out.append((f"bolt-{i % 2}", i, JaxTuple(
            values=vals_j, anchors=frozenset(anchors), origins=frozenset(origins),
            trace=JaxTrace(tid, sid) if i % 2 else None, **common)))
        out.append((f"bolt-{i % 2}", i, Tuple(
            values=vals_p, anchors=frozenset(anchors), origins=frozenset(origins),
            trace=TraceContext(tid, sid) if i % 2 else None, **common)))
    return jax_out, out


@pytest.fixture(params=["crc32c", "zlib"])
def checksum(request, monkeypatch):
    """Both packages stamping one checksum: storm_tpu stamps zlib when its
    native library is missing, the port by its module's ``_checksum``."""
    assert jax_native.native_available()
    if request.param == "zlib":
        monkeypatch.setattr(jax_wire, "native_available", lambda: False)
        monkeypatch.setattr(wire, "_checksum", "zlib")
    return request.param


def _plain(v):
    if isinstance(v, (RecordFrame, JaxFrame)):
        return ("frame", [bytes(r) for r in v])
    if isinstance(v, np.ndarray):
        return ("nd", v.dtype.str, v.shape, v.tobytes())
    if isinstance(v, memoryview):
        return bytes(v)
    if isinstance(v, list):
        return [_plain(x) for x in v]
    return v


def _same(a, b) -> None:
    """Two decoded (component, task, tuple) lists hold the same tuples."""
    assert len(a) == len(b)
    for (ca, ia, ta), (cb, ib, tb) in zip(a, b):
        assert (ca, ia) == (cb, ib)
        assert [_plain(v) for v in ta.values] == [_plain(v) for v in tb.values]
        for f in ("fields", "source_component", "source_task", "stream", "edge_id",
                  "anchors", "origins"):
            assert getattr(ta, f) == getattr(tb, f), f
        assert ta.root_ts == pytest.approx(tb.root_ts, abs=0.05)
        assert (ta.trace is None) == (tb.trace is None)
        if ta.trace is not None:
            assert ta.trace.traceparent() == tb.trace.traceparent()


@pytest.mark.parametrize("seed", [0, 1])
@pytest.mark.parametrize("version", [2, 1])
def test_deliveries_frame_is_storm_tpus_bytes(seed, version, checksum):
    jax_d, port_d = _pair(seed)
    mine = wire.encode_deliveries(port_d, now=NOW, version=version)
    theirs = jax_wire.encode_deliveries(jax_d, now=NOW, version=version)
    assert mine == theirs
    assert mine[2] & 1 == (checksum == "zlib")


@pytest.mark.parametrize("seed", [3, 4])
def test_each_package_decodes_the_others_deliveries(seed, checksum):
    jax_d, port_d = _pair(seed)
    mine = wire.encode_deliveries(port_d, now=NOW)
    theirs = jax_wire.encode_deliveries(jax_d, now=NOW)
    _same(wire.decode_deliveries(theirs, now=NOW + 1.0),
          jax_wire.decode_deliveries(mine, now=NOW + 1.0))
    _same(wire.decode_deliveries(theirs, now=NOW), jax_d)
    # and through the transports' format sniffing
    _same(transport.decode_deliveries(theirs), jax_transport.decode_deliveries(mine))


def test_unsealed_parts_and_view_decode_match(checksum):
    jax_d, port_d = _pair(5)
    parts, flags = wire.encode_delivery_parts(port_d, now=NOW)
    jparts, jflags = jax_wire.encode_delivery_parts(jax_d, now=NOW)
    body = b"".join(bytes(p) for p in parts)
    assert (body, flags) == (b"".join(bytes(p) for p in jparts), jflags)
    _same(wire.decode_deliveries_view(memoryview(body), now=NOW),
          jax_wire.decode_deliveries_view(memoryview(body), now=NOW))


def test_acks_and_shm_header_frames_are_storm_tpus_bytes(checksum):
    rng = np.random.RandomState(6)
    ops = [(op, int(rng.randint(1, 2**63)), int(rng.randint(0, 2**63)))
           for op in ("xor", "anc", "ake", "fail") * 3]
    mine, theirs = wire.encode_acks(ops), jax_wire.encode_acks(ops)
    assert mine == theirs
    assert wire.decode_acks(theirs) == jax_wire.decode_acks(mine) == ops
    assert transport.decode_acks(theirs) == ops
    name = "psm_0123abcd"
    h, jh = wire.encode_shm_header(name, 64, 4096), jax_wire.encode_shm_header(name, 64, 4096)
    assert h == jh
    assert wire.decode_shm_header(jh) == jax_wire.decode_shm_header(h) == (name, 64, 4096)


@pytest.mark.parametrize("kind", ["deliveries", "acks", "shm"])
def test_a_flipped_byte_raises_wire_error_in_both(kind, checksum):
    jax_d, port_d = _pair(7, n=2)
    frame = {"deliveries": lambda: wire.encode_deliveries(port_d, now=NOW),
             "acks": lambda: wire.encode_acks([("xor", 5, 6), ("fail", 7, 0)]),
             "shm": lambda: wire.encode_shm_header("psm_x", 0, 10)}[kind]()
    decode = {"deliveries": (wire.decode_deliveries, jax_wire.decode_deliveries),
              "acks": (wire.decode_acks, jax_wire.decode_acks),
              "shm": (wire.decode_shm_header, jax_wire.decode_shm_header)}[kind]
    rng = np.random.RandomState(8)
    for pos in sorted(set(rng.randint(2, len(frame), size=6).tolist()) | {len(frame) - 1}):
        bad = bytearray(frame)
        bad[pos] ^= 0x40
        with pytest.raises(wire.WireError):
            decode[0](bytes(bad))
        with pytest.raises(jax_wire.WireError):
            decode[1](bytes(bad))


@settings(max_examples=60, deadline=None)
@given(data=st.binary(max_size=300), seed=st.integers(0, 2**32 - 1))
def test_crc32c_agrees_with_storm_tpus(data, seed):
    want = jax_native.crc32c(data, seed)
    assert crc32c(data, seed) == want
    assert crc32c_reference(data, seed) == want
    assert jax_native._crc32c_py(data, seed) == want


def test_crc32c_check_value():
    assert crc32c(b"123456789") == crc32c_reference(b"123456789") == 0xE3069283
    assert crc32c(memoryview(b"abc")) == crc32c(b"abc")


@pytest.mark.parametrize("seed", [0, 1])
def test_json_envelope_matches_storm_tpus(seed):
    rng = np.random.RandomState(seed)
    jax_d, port_d = [], []
    for i in range(4):
        vals = [str(rng.randint(0, 100)), float(rng.rand()), [1, 2], {"a": i}, None]
        tid, sid = f"{rng.randint(1, 2**62):032x}", f"{rng.randint(1, 2**62):016x}"
        common = dict(values=vals, fields=("a", "b", "c", "d", "e"), source_component="s",
                      source_task=i, stream="default", edge_id=int(rng.randint(1, 2**63)),
                      anchors=frozenset([int(rng.randint(1, 2**63))]),
                      origins=frozenset([("in", i, 10 + i)]), root_ts=NOW - i)
        jax_d.append(("b", i, JaxTuple(trace=JaxTrace(tid, sid) if i % 2 else None,
                                       **common)))
        port_d.append(("b", i, Tuple(trace=TraceContext(tid, sid) if i % 2 else None,
                                     **common)))
    for (_, _, tj), (_, _, tp) in zip(jax_d, port_d):
        enc = transport.encode_tuple(tp, NOW)
        assert enc == jax_transport.encode_tuple(tj, NOW)
        back = transport.decode_tuple(json.loads(json.dumps(enc)), NOW + 2)
        jback = jax_transport.decode_tuple(json.loads(json.dumps(enc)), NOW + 2)
        _same([("b", 0, back)], [("b", 0, jback)])
        assert back.root_ts == pytest.approx(tp.root_ts + 2)
    mine = transport.decode_deliveries(jax_transport.encode_deliveries(jax_d))
    _same(mine, jax_transport.decode_deliveries(transport.encode_deliveries(port_d)))
    ops = [("xor", 2**63 + 5, 7), ("fail", 9, 0)]
    assert transport.encode_acks(ops) == jax_transport.encode_acks(ops)
    assert transport.decode_acks(jax_transport.encode_acks(ops)) == ops


def test_json_envelope_refuses_bytes_values():
    t = Tuple(values=[b"raw"], fields=("m",), source_component="s")
    with pytest.raises(TypeError, match="binary wire"):
        transport.encode_deliveries([("b", 0, t)])
