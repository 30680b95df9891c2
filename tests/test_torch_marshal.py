"""The port's Arrow tensor codec (``storm_tpu_torch/native/arrow_tensor.cpp``,
``serve/marshal.py`` and the 0xFF path of ``api/schema.py``) against
storm_tpu's, on the CPU, with storm_tpu's native library built by
``tests/test_torch_codec.py``'s fixture:

- ``encode_tensor`` writes storm_tpu's bytes, for every dtype of its
  ``_DTYPE_TO_CODE`` at ranks 1 to 8;
- ``decode_tensor`` gives storm_tpu's arrays (dtype, shape, strides,
  values) as views that share memory with the message;
- the layouts storm_tpu hands to pyarrow (Fortran order, other strides,
  rank 0, ranks above 8) come out as pyarrow's arrays, without pyarrow;
- malformed messages are refused with storm_tpu's ``SchemaError`` texts,
  and so are the 0xFF-led records that are no tensor;
- element types numpy cannot view are refused by both; the port's text
  names the layout, storm_tpu's is pyarrow's (``ROADMAP.md`` §C);
- above rank 8 and for bool arrays storm_tpu's bytes are pyarrow's, whose
  flatbuffer layout differs: the port's message decodes to the same array
  in storm_tpu and in pyarrow (``ROADMAP.md`` §C);
- the ``marshal_encode`` and ``marshal_decode`` ledger rows are storm_tpu's.
"""

import struct

import numpy as np
import pyarrow as pa
import pytest

import storm_tpu.api.schema as jax_schema
import storm_tpu.obs.copyledger as jax_ledger
import storm_tpu.serve.marshal as jax_marshal
from storm_tpu.native import _DTYPE_TO_CODE
from storm_tpu_torch import native
from storm_tpu_torch.api import schema
from storm_tpu_torch.obs import copyledger as port_ledger
from storm_tpu_torch.serve import marshal
from tests.test_torch_codec import storm_tpu_native  # noqa: F401 (module fixture)

DTYPES = list(_DTYPE_TO_CODE)


def _array(rng, dtype, shape):
    x = rng.rand(*shape) * 200 - 100
    return x.astype(dtype)


def _pyarrow_message(x: np.ndarray) -> bytes:
    sink = pa.BufferOutputStream()
    pa.ipc.write_tensor(pa.Tensor.from_numpy(x), sink)
    return sink.getvalue().to_pybytes()


def _same_array(got: np.ndarray, want: np.ndarray) -> None:
    assert got.dtype == want.dtype and got.shape == want.shape
    assert got.strides == want.strides
    assert np.array_equal(got, want, equal_nan=True)


def _shares(arr: np.ndarray, msg) -> bool:
    return np.shares_memory(arr, np.frombuffer(msg, np.uint8))


@pytest.mark.parametrize("dtype", DTYPES, ids=str)
def test_encode_byte_identical_and_decode_alike(dtype):
    rng = np.random.RandomState(DTYPES.index(dtype))
    for rank in range(1, 9):
        shape = tuple(int(rng.randint(1, 4)) for _ in range(rank))
        x = _array(rng, dtype, shape)
        msg = marshal.encode_tensor(x)
        assert msg == jax_marshal.encode_tensor(x), (dtype, shape)
        got = marshal.decode_tensor(msg)
        _same_array(got, jax_marshal.decode_tensor(msg))
        assert _shares(got, msg) and not got.flags.writeable
    # a non-contiguous input is made contiguous first, as in storm_tpu
    y = _array(rng, dtype, (4, 6))[:, ::2]
    assert marshal.encode_tensor(y) == jax_marshal.encode_tensor(y)


def test_decode_takes_any_buffer_and_keeps_it_alive():
    x = np.arange(24, dtype=np.float32).reshape(2, 3, 4)
    msg = marshal.encode_tensor(x)
    for buf in (msg, bytearray(msg), memoryview(msg), memoryview(b"abc" + msg)[3:]):
        got = marshal.decode_tensor(buf)
        _same_array(got, jax_marshal.decode_tensor(buf))
        assert _shares(got, buf)
    got = marshal.decode_tensor(bytearray(msg))
    assert got.base is not None and np.array_equal(got, x)  # the bytearray lives on


def _fb_field(fb, table, slot):
    soff = struct.unpack_from("<i", fb, table)[0]
    vt = table - soff
    if 4 + 2 * slot + 2 > struct.unpack_from("<H", fb, vt)[0]:
        return 0
    off = struct.unpack_from("<H", fb, vt + 4 + 2 * slot)[0]
    return table + off if off else 0


def _fb_ind(fb, at):
    return at + struct.unpack_from("<I", fb, at)[0]


def _locate(msg) -> dict:
    """Offsets in a message (continuation-marker framing) of the
    Message's header type, the Tensor's type id, its Int bit width, its
    strides vector and each dim's size."""
    fb = memoryview(msg)[8:]
    root = _fb_ind(fb, 0)
    tensor = _fb_ind(fb, _fb_field(fb, root, 2))
    type_tbl = _fb_ind(fb, _fb_field(fb, tensor, 1))
    shape = _fb_ind(fb, _fb_field(fb, tensor, 2))
    n = struct.unpack_from("<I", fb, shape)[0]
    dims = [8 + _fb_field(fb, _fb_ind(fb, shape + 4 + 4 * i), 0) for i in range(n)]
    return {"header_type": 8 + _fb_field(fb, root, 1),
            "type_id": 8 + _fb_field(fb, tensor, 0),
            "bit_width": 8 + _fb_field(fb, type_tbl, 0),
            "strides": 8 + _fb_ind(fb, _fb_field(fb, tensor, 3)), "dims": dims}


def _patched(base: bytes, at: int, fmt: str, value) -> bytes:
    out = bytearray(base)
    struct.pack_into(fmt, out, at, value)
    return bytes(out)


def _layouts():
    """Messages storm_tpu's raw view declines (rc 100): pyarrow's own
    writes, and strides patched into a C-order message."""
    rng = np.random.RandomState(7)
    out = [("fortran f32", _pyarrow_message(np.asfortranarray(rng.rand(3, 4, 5)
                                                              .astype(np.float32)))),
           ("fortran i16", _pyarrow_message(np.asfortranarray(
               rng.randint(-9, 9, (2, 3)).astype(np.int16)))),
           ("transposed", _pyarrow_message(
               np.arange(60, dtype=np.float64).reshape(3, 4, 5).transpose(2, 0, 1))),
           ("rank 0", _pyarrow_message(np.array(2.5, np.float32))),
           ("rank 0 u8", _pyarrow_message(np.array(7, np.uint8)))]
    for rank in (9, 10, 12):
        x = rng.randint(0, 100, tuple(int(rng.randint(1, 3)) for _ in range(rank)))
        out.append((f"rank {rank}", _pyarrow_message(x.astype(np.int32))))
    # every other element: strides (16, 8) over a body of 2x4 f32 read as 2x2
    msg = bytearray(marshal.encode_tensor(np.arange(8, dtype=np.float32).reshape(2, 4)))
    loc = _locate(msg)
    struct.pack_into("<qq", msg, loc["strides"] + 4, 16, 8)
    struct.pack_into("<q", msg, loc["dims"][1], 2)
    out.append(("gapped strides", bytes(msg)))
    return out


LAYOUTS = [n for n, _ in _layouts()]


@pytest.mark.parametrize("i", range(len(LAYOUTS)), ids=LAYOUTS)
def test_layouts_storm_tpu_hands_to_pyarrow(i):
    _name, msg = _layouts()[i]
    got = marshal.decode_tensor(msg)
    _same_array(got, jax_marshal.decode_tensor(msg))
    _same_array(got, pa.ipc.read_tensor(pa.py_buffer(msg)).to_numpy())
    assert _shares(got, msg)


def test_fortran_record_decodes_as_a_view_of_instances():
    x = np.asfortranarray(np.random.RandomState(3).rand(2, 4, 4, 3).astype(np.float32))
    msg = _pyarrow_message(x)
    got, want = schema.decode_instances(msg, ts=1.5), jax_schema.decode_instances(msg)
    _same_array(got.data, want.data)
    assert got.view and want.view and got.ts == 1.5
    # another element type is cast to float32 (a copy), as in storm_tpu
    msg = marshal.encode_tensor(np.arange(12, dtype=np.int16).reshape(2, 6))
    got, want = schema.decode_instances(msg), jax_schema.decode_instances(msg)
    _same_array(got.data, want.data)
    assert not got.view and not want.view and got.data.dtype == np.float32


def _malformed():
    base = marshal.encode_tensor(np.arange(24, dtype=np.float32).reshape(2, 3, 4))
    loc = _locate(base)
    return [b"\xff", b"\xff" * 20, base[:40], base[:-1], base[:len(base) // 2],
            _patched(base, 4, "<i", 1 << 20),                  # metadata past the end
            _patched(base, 4, "<i", -8),
            _patched(base, loc["header_type"], "<B", 1),       # a Schema message
            _patched(base, loc["dims"][0], "<q", -2),          # negative dim
            _patched(base, loc["dims"][0], "<q", 1 << 40),     # body too short
            b"\xff\xff\xff\xff" + b"\x00" * 12,
            b'\xff{"instances": [[1.0]]}']


@pytest.mark.parametrize("payload", _malformed())
def test_malformed_messages_refused_with_storm_tpus_text(payload):
    with pytest.raises(jax_schema.SchemaError) as want:
        jax_schema.decode_instances(payload)
    with pytest.raises(schema.SchemaError) as got:
        schema.decode_instances(payload)
    assert str(got.value) == str(want.value)
    assert str(got.value).startswith("payload is not a valid tensor frame: ")
    text = payload.decode("utf-8", "replace")
    assert (schema.DeadLetter(payload=text, error=str(got.value)).to_json()
            == jax_schema.DeadLetter(payload=text, error=str(want.value)).to_json())


def test_records_of_the_wrong_rank_or_empty_refused_alike():
    for x in (np.zeros(5, np.float32), np.zeros((0, 3), np.float32)):
        msg = marshal.encode_tensor(x)
        with pytest.raises(jax_schema.SchemaError) as want:
            jax_schema.decode_instances(msg)
        with pytest.raises(schema.SchemaError) as got:
            schema.decode_instances(msg)
        assert str(got.value) == str(want.value)


@pytest.mark.parametrize("type_id, bits, name", [
    (2, 12, "Int(bitWidth=12)"), (2, 128, "Int(bitWidth=128)"), (2, 1, "Int(bitWidth=1)"),
    (6, 16, "Bool"), (5, 16, "Utf8"), (1, 16, "Null")])
def test_element_types_numpy_cannot_view_are_refused_by_both(type_id, bits, name):
    base = marshal.encode_tensor(np.arange(8, dtype=np.uint16).reshape(2, 4))
    loc = _locate(base)
    msg = _patched(_patched(base, loc["bit_width"], "<i", bits), loc["type_id"], "<B", type_id)
    with pytest.raises(jax_schema.SchemaError) as want:
        jax_schema.decode_instances(msg)
    with pytest.raises(schema.SchemaError) as got:
        schema.decode_instances(msg)
    assert str(want.value).startswith("payload is not a valid tensor frame: ")
    assert str(got.value) == ("payload is not a valid tensor frame: Arrow tensor of "
                              f"element type {name}: no numpy dtype views it")
    with pytest.raises(schema.SchemaError, match=name.replace("(", r"\(").replace(")", r"\)")):
        marshal.decode_tensor(msg)


def test_above_rank_8_and_bool_decode_alike_though_bytes_differ():
    rng = np.random.RandomState(11)
    cases = [rng.randint(0, 9, (2, 1, 2, 1, 2, 1, 2, 1, 2)).astype(np.float32),
             rng.randint(0, 9, (1,) * 32).astype(np.int64),
             rng.rand(3, 4) > 0.5]
    for x in cases:
        msg = marshal.encode_tensor(x)
        want = x.view(np.uint8) if x.dtype == np.bool_ else x
        for got in (marshal.decode_tensor(msg), jax_marshal.decode_tensor(msg),
                    pa.ipc.read_tensor(pa.py_buffer(msg)).to_numpy()):
            assert got.dtype == want.dtype and got.shape == want.shape
            assert np.array_equal(got, want)
        # storm_tpu's bytes are pyarrow's: the same array, another layout
        assert jax_marshal.decode_tensor(jax_marshal.encode_tensor(x)).shape == x.shape
    with pytest.raises(NotImplementedError, match="Unsupported numpy type 14"):
        marshal.encode_tensor(np.zeros(3, np.complex64))


def test_ledger_rows_match_storm_tpu():
    rng = np.random.RandomState(2)
    calls = [rng.rand(3, 4).astype(np.float32), rng.rand(1, 2, 2), np.zeros(5, np.int8),
             rng.rand(4, 6).astype(np.float32)[:, ::3]]
    trees = []
    for led, mar in ((jax_ledger, jax_marshal), (port_ledger, marshal)):
        led.ensure_installed()
        led.copy_ledger().reset()
        for x in calls:
            mar.decode_tensor(mar.encode_tensor(x))
        trees.append(led.copy_ledger().snapshot())
        led.copy_ledger().reset()
    assert trees[0] == trees[1]
    st = trees[1]["stages"]
    assert list(st) == ["marshal_encode", "marshal_decode"]
    assert st["marshal_decode"]["bytes"] == st["marshal_decode"]["copies"] == 0
    assert st["marshal_encode"]["copies"] == 5  # the sliced input copied twice


def test_json_records_as_memoryviews_still_parse():
    payload = b'{"instances": [[1.5, 2.0]]}'
    for p in (memoryview(payload), memoryview(b"zz" + payload)[2:]):
        got = schema.decode_instances(p)
        assert not got.view and got.data.tolist() == [[1.5, 2.0]]
        assert np.array_equal(got.data, jax_schema.decode_instances(p).data)


def test_native_decode_refuses_what_the_port_cannot_view():
    base = native.encode_tensor(np.zeros((2, 2), np.uint8))
    with pytest.raises(native.TensorLayoutError):
        native.decode_tensor(_patched(base, _locate(base)["type_id"], "<B", 6))


def test_malformed_layouts_storm_tpu_sends_to_pyarrow_are_refused_by_both():
    """A Fortran-order message cut short: storm_tpu's raw view declines
    the layout before it sees the short body and pyarrow refuses it; the
    port's layout reader finds the short body (``ROADMAP.md`` C9)."""
    msg = _pyarrow_message(np.asfortranarray(np.arange(24, dtype=np.float32).reshape(4, 6)))
    cut = msg[:-8]
    with pytest.raises(jax_schema.SchemaError):
        jax_schema.decode_instances(cut)
    with pytest.raises(schema.SchemaError) as got:
        schema.decode_instances(cut)
    assert str(got.value) == ("payload is not a valid tensor frame: malformed Arrow tensor "
                              "message (native rc=11)")


@pytest.mark.parametrize("rank", [33, 40])
def test_rank_above_32_refused_by_the_port_read_by_pyarrow(rank):
    """``ROADMAP.md`` C9: pyarrow writes and reads a tensor of rank above
    32, and storm_tpu (which hands such a layout to pyarrow) decodes it;
    the port refuses it and names the layout."""
    x = np.arange(2, dtype=np.int8).reshape((2,) + (1,) * (rank - 1))
    msg = _pyarrow_message(x)
    for got in (pa.ipc.read_tensor(pa.py_buffer(msg)).to_numpy(),
                jax_marshal.decode_tensor(msg), jax_schema.decode_instances(msg).data):
        assert got.shape == x.shape and np.array_equal(got, x)
    with pytest.raises(schema.SchemaError) as got:
        marshal.decode_tensor(msg)
    assert str(got.value) == "Arrow tensor of rank above 32"
    with pytest.raises(schema.SchemaError) as got:
        schema.decode_instances(msg)
    assert str(got.value) == ("payload is not a valid tensor frame: Arrow tensor of rank "
                              "above 32")


@pytest.mark.parametrize("strides", [(-16, 4), (16, -4), (-16, -4)])
def test_negative_strides_refused_by_all(strides):
    """``ROADMAP.md`` C9: strides patched negative into a C-order message.
    pyarrow refuses them ("negative strides not supported"), so storm_tpu
    does, with pyarrow's text; the port refuses them and names the
    layout."""
    base = marshal.encode_tensor(np.arange(8, dtype=np.float32).reshape(2, 4))
    msg = bytearray(base)
    struct.pack_into("<qq", msg, _locate(base)["strides"] + 4, *strides)
    msg = bytes(msg)
    with pytest.raises(pa.ArrowInvalid, match="negative strides not supported"):
        pa.ipc.read_tensor(pa.py_buffer(msg))
    with pytest.raises(jax_schema.SchemaError) as want:
        jax_schema.decode_instances(msg)
    assert str(want.value) == ("payload is not a valid tensor frame: negative strides "
                               "not supported")
    with pytest.raises(schema.SchemaError) as got:
        marshal.decode_tensor(msg)
    assert str(got.value) == "Arrow tensor with a negative stride"
    with pytest.raises(schema.SchemaError) as got:
        schema.decode_instances(msg)
    assert str(got.value) == ("payload is not a valid tensor frame: Arrow tensor with a "
                              "negative stride")
