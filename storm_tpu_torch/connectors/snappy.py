"""Dependency-free Snappy decompression for the Kafka wire client,
copied from ``storm_tpu/connectors/snappy.py``.

Kafka-0.11-era producers commonly ship ``compression.type=snappy``
(reference pom.xml:55-78 pins that era's kafka-clients); the fetch path
must read it. Two containers appear on the wire:

- **raw block format** (record batches, magic 2): one varint uncompressed
  length followed by literal/copy tagged elements;
- **xerial framing** (message-set wrapper values, magic 0/1): the
  snappy-java header ``\\x82SNAPPY\\x00`` + two version ints, then
  ``[i32 length][raw block]`` chunks — Kafka's Java producer always frames
  snappy this way.

``compress`` emits literal-only raw blocks (valid Snappy, no backrefs) —
enough for the in-repo stub broker and tests to produce compressed sets
without a codec dependency; the real decoder on the other side handles it
like any other stream.
"""

from __future__ import annotations

_XERIAL_MAGIC = b"\x82SNAPPY\x00"


class SnappyError(ValueError):
    pass


def _read_uvarint(data: bytes, pos: int) -> tuple[int, int]:
    result = 0
    shift = 0
    while True:
        if pos >= len(data):
            raise SnappyError("truncated varint")
        b = data[pos]
        pos += 1
        result |= (b & 0x7F) << shift
        if not b & 0x80:
            return result, pos
        shift += 7
        if shift > 35:
            raise SnappyError("varint too long")


def decompress_raw(data: bytes) -> bytes:
    """Decompress one raw Snappy block."""
    ulen, pos = _read_uvarint(data, 0)
    out = bytearray()
    n = len(data)
    while pos < n:
        tag = data[pos]
        pos += 1
        kind = tag & 3
        if kind == 0:  # literal
            ln = (tag >> 2) + 1
            if ln > 60:
                nbytes = ln - 60
                if pos + nbytes > n:
                    raise SnappyError("truncated literal length")
                ln = int.from_bytes(data[pos:pos + nbytes], "little") + 1
                pos += nbytes
            if pos + ln > n:
                raise SnappyError("truncated literal")
            out += data[pos:pos + ln]
            pos += ln
            continue
        if kind == 1:  # copy, 1-byte offset; length 4..11
            if pos >= n:
                raise SnappyError("truncated copy-1")
            ln = ((tag >> 2) & 0x7) + 4
            off = ((tag >> 5) << 8) | data[pos]
            pos += 1
        elif kind == 2:  # copy, 2-byte offset
            if pos + 2 > n:
                raise SnappyError("truncated copy-2")
            ln = (tag >> 2) + 1
            off = int.from_bytes(data[pos:pos + 2], "little")
            pos += 2
        else:  # copy, 4-byte offset
            if pos + 4 > n:
                raise SnappyError("truncated copy-4")
            ln = (tag >> 2) + 1
            off = int.from_bytes(data[pos:pos + 4], "little")
            pos += 4
        if off == 0 or off > len(out):
            raise SnappyError(f"bad copy offset {off} at output {len(out)}")
        if off >= ln:  # non-overlapping: one slice
            start = len(out) - off
            out += out[start:start + ln]
        else:  # overlapping run (RLE-style): byte at a time
            for _ in range(ln):
                out.append(out[-off])
    if len(out) != ulen:
        raise SnappyError(f"length mismatch: got {len(out)}, header {ulen}")
    return bytes(out)


def decompress(data: bytes) -> bytes:
    """Decompress Kafka snappy payloads: xerial-framed when the magic
    header is present, raw block otherwise."""
    if data.startswith(_XERIAL_MAGIC):
        if len(data) < len(_XERIAL_MAGIC) + 8:
            raise SnappyError("truncated xerial header (missing version/compat)")
        pos = len(_XERIAL_MAGIC) + 8  # skip version + compat ints
        out = bytearray()
        while pos < len(data):
            if pos + 4 > len(data):
                raise SnappyError("truncated xerial chunk header")
            ln = int.from_bytes(data[pos:pos + 4], "big")
            pos += 4
            if pos + ln > len(data):
                raise SnappyError("truncated xerial chunk")
            out += decompress_raw(data[pos:pos + ln])
            pos += ln
        return bytes(out)
    return decompress_raw(data)


def _write_uvarint(out: bytearray, v: int) -> None:
    while True:
        b = v & 0x7F
        v >>= 7
        if v:
            out.append(b | 0x80)
        else:
            out.append(b)
            return


def compress(data: bytes, xerial: bool = False) -> bytes:
    """Literal-only Snappy encoding (valid, uncompressed-size output)."""
    block = bytearray()
    _write_uvarint(block, len(data))
    pos = 0
    while pos < len(data):
        ln = min(len(data) - pos, 1 << 16)
        block.append((60 + 2) << 2)  # literal, 3-byte explicit length
        block += (ln - 1).to_bytes(3, "little")
        block += data[pos:pos + ln]
        pos += ln
    raw = bytes(block)
    if not xerial:
        return raw
    return (_XERIAL_MAGIC + (1).to_bytes(4, "big") + (1).to_bytes(4, "big")
            + len(raw).to_bytes(4, "big") + raw)
