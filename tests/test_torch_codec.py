"""The port's native JSON codec against storm_tpu's, on the CPU.

The port builds its own copy of ``fastjson.cpp`` (``storm_tpu_torch/native``)
with g++ at first use. storm_tpu loads ``storm_tpu/native/libstormtpu.so``
when it exists and otherwise falls back to its Python codec; that library
is a build product, not in the repository. So the module fixture
:func:`storm_tpu_native` builds it here, from storm_tpu's sources with its
Makefile's flags, into a private file under ``build/`` (written under a
temporary name, then renamed), points storm_tpu's loader at it for the
module and restores the loader after. The comparisons hold the port to
storm_tpu's native codec whatever ran before, and other test files that
compare with storm_tpu's native path use the same fixture.
On a seeded corpus of payloads:

- every payload both parse gives the same array, bit for bit (the same
  code on both sides), and lies within 1 ulp of the port's pure-Python
  reference decode (which rounds twice, JSON -> float64 -> float32);
- every payload storm_tpu's native parser refuses, the port refuses with
  the same ``SchemaError`` text, so the same ``DeadLetter`` record: ragged
  and non-numeric instances, rank 9, empty dimensions, a missing
  ``"instances"`` key, bad JSON, bytes that are not UTF-8, and values
  beyond float32's range (which the Python reference would turn into
  infinities);
- ``str``, ``bytes`` and ``memoryview`` payloads decode alike;
- ``encode_predictions`` writes storm_tpu's bytes exactly on seeded (N, K)
  arrays, and the same numbers as the Python reference within its 7
  decimals;
- the inference bolt records ``decode_ms`` and ``encode_ms``.
"""

import hashlib
import json
import os
import shutil
import subprocess
import threading
from pathlib import Path

import numpy as np
import pytest

import storm_tpu.api.schema as jax_schema
import storm_tpu.native as jax_native
from storm_tpu.native import native_available
from storm_tpu_torch import native
from storm_tpu_torch.api import schema
from tests.test_torch_topology import _run

ROOT = Path(__file__).resolve().parents[1]
JAX_NATIVE_SOURCES = tuple(ROOT / "storm_tpu" / "native" / f
                           for f in ("fastjson.cpp", "arrow_tensor.cpp", "crc32c.cpp"))
# storm_tpu/native/Makefile's CXXFLAGS and LDFLAGS.
JAX_NATIVE_FLAGS = ("-O3", "-std=c++17", "-fPIC", "-Wall", "-Wextra", "-shared")


def build_storm_tpu_library() -> Path:
    """storm_tpu's ``libstormtpu.so``, built from its sources into
    ``build/storm_tpu_reference/``, named by a hash of the sources and the
    flags; a concurrent build in another process never loads a half-written
    file (private name, then rename)."""
    h = hashlib.sha256(" ".join(JAX_NATIVE_FLAGS).encode())
    for src in JAX_NATIVE_SOURCES:
        h.update(src.read_bytes())
    out = ROOT / "build" / "storm_tpu_reference" / f"libstormtpu-{h.hexdigest()[:16]}.so"
    if not out.exists():
        out.parent.mkdir(parents=True, exist_ok=True)
        tmp = out.with_suffix(f".{os.getpid()}.{threading.get_ident()}.tmp")
        cxx = shutil.which("g++") or "g++"
        proc = subprocess.run([cxx, *JAX_NATIVE_FLAGS, "-o", str(tmp),
                               *map(str, JAX_NATIVE_SOURCES)],
                              capture_output=True, text=True, timeout=300)
        assert proc.returncode == 0, proc.stdout + proc.stderr
        os.replace(tmp, out)
    return out


@pytest.fixture(scope="module", autouse=True)
def storm_tpu_native():
    """storm_tpu's loader pointed at :func:`build_storm_tpu_library`'s file
    for the module (its cached load reset), restored on teardown."""
    saved = (jax_native._LIB_PATH, jax_native._load_attempted, jax_native._lib)
    jax_native._LIB_PATH = build_storm_tpu_library()
    jax_native._load_attempted, jax_native._lib = False, None
    try:
        yield jax_native
    finally:
        jax_native._LIB_PATH, jax_native._load_attempted, jax_native._lib = saved


def test_storm_tpu_native_library_loads():
    """The comparisons below hold the port to storm_tpu's native codec,
    not to its Python fallback."""
    assert native_available()
    assert jax_native._LIB_PATH.parent.name == "storm_tpu_reference"


def _floats(rng: np.random.RandomState, n: int) -> list:
    """n number literals of the kinds a client writes: float64 reprs,
    float32 reprs, integers, exponents, long mantissas (past the parser's
    15-digit fast path), signed zeros, subnormal and huge-but-finite
    float32 values."""
    kinds = [
        lambda: repr(float(rng.rand())),
        lambda: repr(float(np.float32(rng.randn() * 10))),
        lambda: str(int(rng.randint(-300, 300))),
        lambda: f"{rng.randn():.3e}",
        lambda: f"{rng.rand() * 10 ** rng.randint(-30, 30):E}",
        lambda: f"{rng.rand():.20f}",
        lambda: rng.choice(["-0", "-0.0", "0", "0.0", "1", "-1"]),
        lambda: f"{rng.rand() * 1e-40:.6e}",
        lambda: f"{rng.rand() * 3e38:.8e}",
        lambda: f"{rng.randint(0, 256)}.{rng.randint(0, 10 ** 6):06d}",
    ]
    return [kinds[rng.randint(len(kinds))]() for _ in range(n)]


def _nest(lits: list, shape: tuple, sep: str) -> str:
    if len(shape) == 1:
        return "[" + sep.join(lits) + "]"
    step = len(lits) // shape[0]
    return "[" + sep.join(_nest(lits[i * step:(i + 1) * step], shape[1:], sep)
                          for i in range(shape[0])) + "]"


def _valid_corpus(seed: int = 0, n: int = 60) -> list:
    rng = np.random.RandomState(seed)
    out = []
    for i in range(n):
        rank = 2 + i % 4
        shape = tuple(int(rng.randint(1, 5)) for _ in range(rank))
        body = _nest(_floats(rng, int(np.prod(shape))), shape,
                     [",", ", ", " ,\n "][i % 3])
        doc = {0: '{"instances": %s}', 1: '{"model": "vit", "instances": %s}',
               2: ' {\n "instances" : %s , "meta": {"a": [1, {"b": "x\\"]"}], "c": null}}\n',
               3: '{"id": "r\\u00e9\\n", "instances":%s,"t":[true,false]}'}[i % 4]
        out.append(doc % body)
    return out


REFUSED = [
    '{"instances": [[1.0, 2.0], [3.0]]}',                    # ragged
    '{"instances": [[1.0, [2.0]], [3.0, 4.0]]}',             # mixed nesting depth
    '{"instances": [[[1.0]], [2.0]]}',
    '{"instances": [[1.0, "a"]]}',                           # non-numeric
    '{"instances": [[1.0, true]]}',
    '{"instances": [[1.0, null]]}',
    '{"instances": ' + "[" * 9 + "1.0" + "]" * 9 + "}",      # rank 9
    '{"instances": [[]]}',                                   # empty dimension
    '{"instances": []}',
    '{"instances": [[1.0], []]}',
    '{"data": [[1.0]]}',                                     # missing key
    "{}",
    "[[1.0]]",                                               # not an object
    "not json",
    '{"instances": [[1.0, 2.0]]',                            # truncated
    '{"instances": [[1.0, 2.0]]} trailing',
    '{"instances": [[1.0 2.0]]}',
    '{"instances": 3}',
    '{"instances": [1.0, 2.0]}',                             # rank 1
    '{"instances": [[1e39]]}',                               # beyond float32
    '{"instances": [[-3.5e38, 1.0]]}',
    "",
]
# Not UTF-8 (none leads with 0xFF, which storm_tpu reads as a tensor frame).
REFUSED_BYTES = [b'{"instances": [[1.0, \xc3\x28]]}', b"\xc3\x28",
                 b'{"instances": [[1.0, 2.0]]}\xe2\x82',
                 b'{"inst\xffances": [[1.0]]}']


def _ulps_apart(a: np.ndarray, b: np.ndarray) -> np.ndarray:
    """Distance in float32 ulps; +0 and -0 are equal."""
    def key(x):
        i = x.view(np.int32).astype(np.int64)
        return np.where(i < 0, -(i & 0x7FFFFFFF), i)
    return np.abs(key(a) - key(b))


@pytest.mark.parametrize("block", range(4))
def test_parse_bit_identical_to_storm_tpu_and_within_an_ulp_of_python(block):
    corpus = _valid_corpus()[block * 15:(block + 1) * 15]
    for payload in corpus:
        got = schema.decode_instances(payload).data
        want = jax_schema.decode_instances(payload).data
        assert got.dtype == np.float32 and got.shape == want.shape
        assert np.array_equal(got.view(np.int32), want.view(np.int32)), payload[:200]
        py = schema.decode_instances_reference(payload).data
        assert py.shape == got.shape
        assert _ulps_apart(got, py).max() <= 1, payload[:200]


@pytest.mark.parametrize("payload", REFUSED + REFUSED_BYTES)
def test_refusals_and_dead_letters_match_storm_tpu(payload):
    with pytest.raises(jax_schema.SchemaError) as want:
        jax_schema.decode_instances(payload)
    with pytest.raises(schema.SchemaError) as got:
        schema.decode_instances(payload)
    assert str(got.value) == str(want.value)
    text = payload.decode("utf-8", "replace") if isinstance(payload, bytes) else payload
    assert (schema.DeadLetter(payload=text, error=str(got.value)).to_json()
            == jax_schema.DeadLetter(payload=text, error=str(want.value)).to_json())


def test_non_finite_literals_are_read_as_storm_tpu_reads_them():
    """``NaN`` and ``Infinity``, which Python's json also reads: the parser
    (``std::from_chars``) takes them, in storm_tpu as in the port."""
    payload = '{"instances": [[1.0, NaN], [Infinity, -Infinity]]}'
    got = schema.decode_instances(payload).data
    assert np.array_equal(got.view(np.int32),
                          jax_schema.decode_instances(payload).data.view(np.int32))
    ref = schema.decode_instances_reference(payload).data
    assert np.array_equal(got, ref, equal_nan=True)


def test_non_utf8_inside_a_skipped_string_is_accepted_as_by_storm_tpu():
    """The parser skips the strings of other keys without decoding them,
    in storm_tpu as in the port: such a payload is served, not refused."""
    payload = b'{"note": "\xc3\x28", "instances": [[1.5, 2.0]]}'
    got = schema.decode_instances(payload).data
    assert np.array_equal(got, jax_schema.decode_instances(payload).data)
    assert got.tolist() == [[1.5, 2.0]]


def test_payload_types_decode_alike():
    payload = _valid_corpus(seed=3, n=1)[0]
    raw = payload.encode("utf-8")
    want = schema.decode_instances(raw).data
    for p in (payload, memoryview(raw), bytearray(raw), memoryview(b"xx" + raw)[2:]):
        assert np.array_equal(schema.decode_instances(p).data.view(np.int32),
                              want.view(np.int32))
    assert np.array_equal(jax_schema.decode_instances(memoryview(raw)).data, want)
    with pytest.raises(schema.SchemaError, match="not UTF-8"):
        schema.decode_instances('{"instances": [[1.0, "\ud800"]]}')
    assert schema.decode_instances(payload, ts=2.5).ts == 2.5


def _prediction_arrays():
    rng = np.random.RandomState(5)
    out = []
    for n, k in [(1, 10), (3, 1000), (8, 7), (2, 1)]:
        x = rng.randn(n, k) * 4
        out.append((np.exp(x) / np.exp(x).sum(-1, keepdims=True)).astype(np.float32))
    edge = np.array([[0.0, -0.0, 1.0, 0.5, 1e-9, 4.9999999e-8, 5.0000001e-8, -2.5,
                      123456.78, 0.1234567891, 3e38, 1.17549435e-38]], np.float32)
    out += [edge, edge.astype(np.float64), rng.rand(4, 3), edge[0]]
    return out


@pytest.mark.parametrize("i", range(len(_prediction_arrays())))
def test_encode_byte_identical_to_storm_tpu(i):
    arr = _prediction_arrays()[i]
    got = schema.encode_predictions(arr)
    assert got == jax_schema.encode_predictions(arr)
    assert got == schema.encode_predictions(schema.Predictions(arr))
    # The same numbers as the Python writer, within its 7 decimals (the
    # writers differ in form: "0" against "0.0", float32 against float64).
    ref = json.loads(schema.encode_predictions_reference(arr))["predictions"]
    np.testing.assert_allclose(np.array(json.loads(got)["predictions"]), np.array(ref),
                               rtol=1e-6, atol=1.5e-7)
    back = schema.decode_predictions(got).data
    assert back.shape == (np.atleast_2d(arr)).shape


def test_encode_refuses_a_rank_3_array():
    with pytest.raises(ValueError, match=r"\(N, K\)"):
        schema.encode_predictions(np.zeros((2, 2, 2), np.float32))


def test_library_is_built_once_and_cached_by_source_hash():
    path = native.library_path()
    native.load()
    assert path.exists() and path.parent.name == "storm_tpu_torch"
    assert native.load() is native.load()
    # The port's library holds the JSON codec and the Arrow tensor codec;
    # the CRC comes with the dist wire, which uses it.
    lib = native.load()
    for fn in ("stpu_parse_instances", "stpu_format_predictions", "stpu_free",
               "stpu_tensor_encode", "stpu_tensor_decode", "stpu_tensor_decode_layout"):
        assert hasattr(lib, fn)
    assert not hasattr(lib, "stpu_crc32c")
    # the hash covers both sources
    assert [s.name for s in native.SOURCES] == ["fastjson.cpp", "arrow_tensor.cpp"]
    with pytest.raises(native.ParseError, match="payload missing"):
        native.parse_instances(b'{"x": 1}')


def test_bolt_records_decode_and_encode_ms(run):
    inputs, outs, dlq, snap, _engines = run(_run(6, poison_at=2), timeout=120)
    bolt = snap["inference-bolt"]
    assert len(outs) == 5 and len(dlq) == 1
    assert bolt["decode_ms"]["count"] == 6  # the poison record's decode too
    assert bolt["encode_ms"]["count"] == 5
    assert bolt["decode_ms"]["p50"] > 0
    # the records carry the native writer's bytes
    for r in outs:
        value = r.value.decode() if isinstance(r.value, bytes) else r.value
        assert value == schema.encode_predictions(schema.decode_predictions(value).data)
