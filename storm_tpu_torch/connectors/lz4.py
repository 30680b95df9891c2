"""Dependency-free LZ4 decoder for Kafka payloads (decode side only),
copied from ``storm_tpu/connectors/lz4.py``.

Kafka's lz4 codec (attributes bits = 3) wraps messages in the LZ4 *Frame*
format (magic ``0x184D2204``) whose blocks are LZ4 *block*-compressed.
0.11-era producers commonly ship it (reference pom.xml:55-78 pins Kafka
0.11; lz4 was a stock producer codec there alongside gzip/snappy), so a
complete ingest path must read it. Like :mod:`storm_tpu_torch.connectors.snappy`
this is a from-scratch implementation, with no ``lz4`` package needed.

Quirk handled: message-format v0/v1 Kafka framed lz4 with an incorrectly
computed frame-header checksum (KIP-57 fixed it for v2 record batches);
checksums are therefore parsed but NOT validated here — TCP and the
record-batch CRC32C already cover integrity, and rejecting the legacy
"broken" HC byte would refuse exactly the producers this decoder exists
for.

Encode side: ``compress_frame`` emits a valid literal-only frame (every
block stored uncompressed with the high bit set) — enough for tests and
for symmetric produce support without porting the match-finder.
"""

from __future__ import annotations

import struct

_FRAME_MAGIC = 0x184D2204


class Lz4Error(RuntimeError):
    pass


def decompress_block(data: bytes, max_size: int = 1 << 27) -> bytes:
    """One LZ4 block: token-driven (literal run, 2-byte LE offset, match
    run) sequences. ``max_size`` bounds output against corrupt streams."""
    out = bytearray()
    pos = 0
    n = len(data)
    while pos < n:
        token = data[pos]
        pos += 1
        # literals
        lit_len = token >> 4
        if lit_len == 15:
            while True:
                if pos >= n:
                    raise Lz4Error("truncated literal length")
                b = data[pos]
                pos += 1
                lit_len += b
                if b != 255:
                    break
        if pos + lit_len > n:
            raise Lz4Error("truncated literals")
        out += data[pos:pos + lit_len]
        pos += lit_len
        if len(out) > max_size:
            raise Lz4Error("output exceeds max_size (corrupt stream?)")
        if pos >= n:
            break  # last sequence carries literals only
        # match
        if pos + 2 > n:
            raise Lz4Error("truncated match offset")
        offset = data[pos] | (data[pos + 1] << 8)
        pos += 2
        if offset == 0 or offset > len(out):
            raise Lz4Error(f"bad match offset {offset} at output {len(out)}")
        match_len = (token & 0x0F) + 4  # minmatch = 4
        if (token & 0x0F) == 15:
            while True:
                if pos >= n:
                    raise Lz4Error("truncated match length")
                b = data[pos]
                pos += 1
                match_len += b
                if b != 255:
                    break
        if len(out) + match_len > max_size:
            raise Lz4Error("output exceeds max_size (corrupt stream?)")
        if offset >= match_len:
            start = len(out) - offset
            out += out[start:start + match_len]
        else:  # overlapping (RLE-style): byte at a time
            for _ in range(match_len):
                out.append(out[-offset])
    return bytes(out)


def decompress_frame(data: bytes) -> bytes:
    """LZ4 Frame -> payload. Parses FLG/BD descriptor, optional content
    size, and per-block uncompressed flag; skips (does not validate)
    header/block/content checksums — see the module docstring for why."""
    if len(data) < 7:
        raise Lz4Error("truncated frame header")
    magic, = struct.unpack_from("<I", data, 0)
    if magic != _FRAME_MAGIC:
        raise Lz4Error(f"bad frame magic {magic:#x}")
    flg = data[4]
    version = flg >> 6
    if version != 1:
        raise Lz4Error(f"unsupported frame version {version}")
    block_checksum = bool(flg & 0x10)
    content_size_flag = bool(flg & 0x08)
    content_checksum = bool(flg & 0x04)
    pos = 6  # magic(4) + FLG + BD
    if content_size_flag:
        pos += 8
    pos += 1  # header checksum (HC) byte — legacy-broken variant tolerated
    out = bytearray()
    while True:
        if pos + 4 > len(data):
            raise Lz4Error("truncated block size")
        size, = struct.unpack_from("<I", data, pos)
        pos += 4
        if size == 0:
            break  # EndMark
        uncompressed = bool(size & 0x80000000)
        size &= 0x7FFFFFFF
        if pos + size > len(data):
            raise Lz4Error("truncated block")
        block = data[pos:pos + size]
        pos += size
        out += block if uncompressed else decompress_block(block)
        if block_checksum:
            pos += 4
    if content_checksum:
        pos += 4
    if pos > len(data):
        raise Lz4Error("truncated trailing checksum")
    return bytes(out)


def compress_frame(data: bytes, block_size: int = 1 << 20) -> bytes:
    """Valid literal-only LZ4 frame (blocks stored uncompressed). Interop:
    any conformant decoder (including Kafka's) reads it; ratio is 1.0."""
    out = bytearray(struct.pack("<I", _FRAME_MAGIC))
    flg = 1 << 6  # version 01, no optional fields
    bd = 7 << 4  # max block size 4MB
    out.append(flg)
    out.append(bd)
    # Header checksum per spec: (xxh32(descriptor) >> 8) & 0xFF — strict
    # decoders validate it, so it must be spec-correct on the encode side.
    out.append((_xxh32(bytes([flg, bd])) >> 8) & 0xFF)
    for i in range(0, len(data), block_size):
        chunk = data[i:i + block_size]
        out += struct.pack("<I", len(chunk) | 0x80000000)
        out += chunk
    out += struct.pack("<I", 0)  # EndMark
    return bytes(out)


# ---- minimal xxHash32 (frame header checksum only) ---------------------------

_P1, _P2, _P3, _P4, _P5 = (2654435761, 2246822519, 3266489917,
                           668265263, 374761393)
_M = 0xFFFFFFFF


def _rotl(x: int, r: int) -> int:
    return ((x << r) | (x >> (32 - r))) & _M


def _xxh32(data: bytes, seed: int = 0) -> int:
    n = len(data)
    pos = 0
    if n >= 16:
        v1 = (seed + _P1 + _P2) & _M
        v2 = (seed + _P2) & _M
        v3 = seed
        v4 = (seed - _P1) & _M
        while pos <= n - 16:
            for i, v in enumerate((v1, v2, v3, v4)):
                lane, = struct.unpack_from("<I", data, pos + 4 * i)
                v = (v + lane * _P2) & _M
                v = (_rotl(v, 13) * _P1) & _M
                if i == 0:
                    v1 = v
                elif i == 1:
                    v2 = v
                elif i == 2:
                    v3 = v
                else:
                    v4 = v
            pos += 16
        h = (_rotl(v1, 1) + _rotl(v2, 7) + _rotl(v3, 12) + _rotl(v4, 18)) & _M
    else:
        h = (seed + _P5) & _M
    h = (h + n) & _M
    while pos <= n - 4:
        lane, = struct.unpack_from("<I", data, pos)
        h = (h + lane * _P3) & _M
        h = (_rotl(h, 17) * _P4) & _M
        pos += 4
    while pos < n:
        h = (h + data[pos] * _P5) & _M
        h = (_rotl(h, 11) * _P1) & _M
        pos += 1
    h ^= h >> 15
    h = (h * _P2) & _M
    h ^= h >> 13
    h = (h * _P3) & _M
    h ^= h >> 16
    return h
