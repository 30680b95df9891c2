"""The port's ``RecordFrame`` (``storm_tpu_torch/runtime/frames.py``) against
storm_tpu's on the CPU: the same records give the same sequence, sizes and
serialized parts; ``from_buffer`` round-trips over any buffer as zero-copy
views; its three refusals raise storm_tpu's ``ValueError`` texts."""

import struct

import numpy as np
import pytest

from storm_tpu.runtime.frames import RecordFrame as JaxFrame
from storm_tpu_torch.runtime.frames import RecordFrame


def _records(seed: int, n: int) -> list:
    rng = np.random.RandomState(seed)
    out = []
    for i in range(n):
        body = rng.bytes(int(rng.randint(0, 300)))
        out.append([body, bytearray(body), memoryview(b"pad" + body)[3:]][i % 3])
    return out


@pytest.mark.parametrize("n", [0, 1, 3, 17])
def test_frame_matches_storm_tpu(n):
    recs = _records(n, n)
    got, want = RecordFrame(recs), JaxFrame(recs)
    assert len(got) == len(want) == n
    assert got.nbytes == want.nbytes == sum(len(bytes(r)) for r in recs)
    assert got.encoded_nbytes() == want.encoded_nbytes()
    assert [bytes(p) for p in got.encode_parts()] == [bytes(p) for p in want.encode_parts()]
    assert got.tolist() == want.tolist() == [bytes(r) for r in recs]
    assert [bytes(r) for r in got] == [bytes(got[i]) for i in range(n)]
    # the records are held by reference, never joined
    assert all(a is b for a, b in zip(got, recs))
    body = b"".join(bytes(p) for p in got.encode_parts())
    assert len(body) == got.encoded_nbytes()
    for buf in (body, bytearray(body), memoryview(b"xx" + body)[2:]):
        back, jback = RecordFrame.from_buffer(buf), JaxFrame.from_buffer(buf)
        assert back.tolist() == jback.tolist() == got.tolist()
        # views over the buffer itself, not copies
        base = buf.obj if isinstance(buf, memoryview) else buf
        assert all(isinstance(r, memoryview) and r.obj is base for r in back)
        assert back.nbytes == got.nbytes


def _bad_bodies():
    good = b"".join(bytes(p) for p in RecordFrame([b"abc", b"de"]).encode_parts())
    return [b"", b"\x01\x00", struct.pack("<I", 3) + b"\x00" * 4,   # short header
            good[:-1],                                              # overrun
            good + b"zz",                                           # trailing bytes
            struct.pack("<II", 1, 10) + b"abc"]


@pytest.mark.parametrize("body", _bad_bodies())
def test_refusals_match_storm_tpu(body):
    with pytest.raises(ValueError) as want:
        JaxFrame.from_buffer(body)
    with pytest.raises(ValueError) as got:
        RecordFrame.from_buffer(body)
    assert str(got.value) == str(want.value)
