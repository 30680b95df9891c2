"""Pure-Python Kafka wire-protocol client (no external client library),
copied from ``storm_tpu/connectors/kafka_protocol.py``.

The reference reaches Kafka through storm-kafka + kafka-clients jars
(pom.xml:39-78); the framework speaks the binary protocol directly, so
it needs no client package. Deliberately targets the
old, stable, non-flexible encodings every broker since 0.10 accepts —
the same era as the reference's Kafka 0.11 (pom.xml:55-78):

- Metadata v0 (api 3) — brokers + partition leaders
- Produce v2/v3 (api 0) — message-format v1 sets, or KIP-98 RecordBatch v2
  (CRC32C + zigzag-varint records; ``message_format='v2'``)
- Fetch v2 (api 1) — brokers down-convert to message format v1
- ListOffsets v0 (api 2) — latest (-1) / earliest (-2)
- FindCoordinator v0/v1 (api 10) — group + transaction coordinators
- OffsetCommit v2 (api 8) / OffsetFetch v1 (api 9) — "simple consumer"
  commits (generation -1, empty member)
- JoinGroup, SyncGroup, Heartbeat and LeaveGroup v0 (apis 11, 14, 12, 13)
  — :class:`GroupMembership`, consumer groups with the range assignor
- InitProducerId v0 (api 22), AddPartitionsToTxn v0 (api 24), EndTxn v0
  (api 26) — KIP-98 idempotent + transactional produce
- AddOffsetsToTxn v0 (api 25), TxnOffsetCommit v0 (api 28) — offsets
  inside the transaction (consume-transform-produce exactly-once)
- ApiVersions v0 (api 18) — connect-time probe that fails LOUDLY with a
  compatibility matrix on brokers that dropped these pinned versions
  (post-KIP-896 removals), making the era-pinning an explicit contract

Codecs: gzip, snappy (xerial + raw), and lz4 (Kafka framing, legacy
broken-HC header tolerated) are decoded on fetch — the full 0.11-era
producer codec surface; zstd (post-2.1) is rejected with a clear error.
Produce ships uncompressed, gzip, snappy, or lz4 (v2 batches).

:class:`KafkaWireBroker` adapts this client to the same surface as
:class:`storm_tpu_torch.connectors.memory.MemoryBroker`, so ``BrokerSpout`` /
``BrokerSink`` run unchanged against a real cluster (``blocking = True``
tells the spout to fetch via a worker thread). Exercised end-to-end against
the stub broker speaking the same protocol over real sockets
(:mod:`storm_tpu_torch.connectors.kafka_stub`, and storm_tpu's
``tests/kafka_stub.py``). The dist runtime's workers share their topics
through this broker; its spout and sink use produce, fetch, offsets,
transactions and, with ``offsets.group_protocol``, the group protocol.
"""

from __future__ import annotations

import logging
import socket
import struct
import threading
import time
import zlib
from dataclasses import dataclass
from typing import Dict, List, Optional, Tuple

from storm_tpu_torch.connectors.memory import Record

#: SASL mechanisms the wire client speaks; SCRAM per RFC 5802/7677.
SASL_MECHANISMS = ("PLAIN", "SCRAM-SHA-256", "SCRAM-SHA-512")

logger = logging.getLogger("storm_tpu_torch.kafka")


class KafkaProtocolError(RuntimeError):
    """Protocol-level failure. ``code`` carries the Kafka error code when
    the failure is an in-band broker error (None for framing/local
    errors), so callers can distinguish retriable cluster churn from
    hard failures."""

    def __init__(self, msg: str, code: "Optional[int]" = None) -> None:
        super().__init__(msg)
        self.code = code


#: Kafka error-code names (the subset this client can encounter), so
#: failures read as NOT_LEADER_FOR_PARTITION instead of "error code 6".
ERROR_NAMES = {
    0: "NONE", 1: "OFFSET_OUT_OF_RANGE", 2: "CORRUPT_MESSAGE",
    3: "UNKNOWN_TOPIC_OR_PARTITION", 4: "INVALID_FETCH_SIZE",
    5: "LEADER_NOT_AVAILABLE", 6: "NOT_LEADER_FOR_PARTITION",
    7: "REQUEST_TIMED_OUT", 8: "BROKER_NOT_AVAILABLE",
    9: "REPLICA_NOT_AVAILABLE", 10: "MESSAGE_TOO_LARGE",
    14: "COORDINATOR_LOAD_IN_PROGRESS", 15: "COORDINATOR_NOT_AVAILABLE",
    16: "NOT_COORDINATOR", 22: "ILLEGAL_GENERATION",
    25: "UNKNOWN_MEMBER_ID", 27: "REBALANCE_IN_PROGRESS",
    28: "INVALID_COMMIT_OFFSET_SIZE", 33: "UNSUPPORTED_SASL_MECHANISM",
    34: "ILLEGAL_SASL_STATE", 35: "UNSUPPORTED_VERSION",
    45: "OUT_OF_ORDER_SEQUENCE_NUMBER", 46: "DUPLICATE_SEQUENCE_NUMBER",
    47: "INVALID_PRODUCER_EPOCH", 48: "INVALID_TXN_STATE",
}

#: Partition-level errors that a leader election / broker bounce produces;
#: the 0.11-era client behavior is refresh-metadata + bounded backoff +
#: retry, not death (the reference's kafka-clients 0.11, pom.xml:74-78).
LEADER_RETRIABLE = frozenset({3, 5, 6, 8, 9})

#: Coordinator-moved errors: re-discover the coordinator and retry.
COORD_RETRIABLE = frozenset({14, 15, 16})


def _proto_error(api: str, code: int) -> KafkaProtocolError:
    name = ERROR_NAMES.get(code, "UNKNOWN")
    return KafkaProtocolError(f"{api} error {code} ({name})", code=code)


# ---- primitive encoding ------------------------------------------------------


class Writer:
    def __init__(self) -> None:
        self.buf = bytearray()

    def i8(self, v):  self.buf += struct.pack(">b", v); return self
    def i16(self, v): self.buf += struct.pack(">h", v); return self
    def i32(self, v): self.buf += struct.pack(">i", v); return self
    def i64(self, v): self.buf += struct.pack(">q", v); return self

    def string(self, s: Optional[str]):
        if s is None:
            return self.i16(-1)
        b = s.encode("utf-8")
        self.i16(len(b))
        self.buf += b
        return self

    def bytes_(self, b: Optional[bytes]):
        if b is None:
            return self.i32(-1)
        self.i32(len(b))
        self.buf += b
        return self

    def raw(self, b: bytes):
        self.buf += b
        return self


class Reader:
    def __init__(self, data: bytes) -> None:
        self.data = data
        self.pos = 0

    def _take(self, n: int) -> bytes:
        if self.pos + n > len(self.data):
            raise KafkaProtocolError("short read in response")
        b = self.data[self.pos : self.pos + n]
        self.pos += n
        return b

    def i8(self) -> int:  return struct.unpack(">b", self._take(1))[0]
    def i16(self) -> int: return struct.unpack(">h", self._take(2))[0]
    def i32(self) -> int: return struct.unpack(">i", self._take(4))[0]
    def i64(self) -> int: return struct.unpack(">q", self._take(8))[0]

    def string(self) -> Optional[str]:
        n = self.i16()
        return None if n < 0 else self._take(n).decode("utf-8")

    def bytes_(self) -> Optional[bytes]:
        n = self.i32()
        return None if n < 0 else self._take(n)

    @property
    def remaining(self) -> int:
        return len(self.data) - self.pos


# ---- message sets (format v1) ------------------------------------------------


def encode_message_set(
    records: List[Tuple[Optional[bytes], bytes]],
    ts_ms: int,
    offsets: Optional[List[int]] = None,
) -> bytes:
    """[(key, value)] -> MessageSet with magic-1 messages, no compression.

    ``offsets`` is used by the broker side (tests/kafka_stub.py) to encode
    real log offsets; producers leave it None (the broker assigns)."""
    out = bytearray()
    for i, (key, value) in enumerate(records):
        msg = Writer()
        msg.i8(1)      # magic
        msg.i8(0)      # attributes (no compression)
        msg.i64(ts_ms)
        msg.bytes_(key)
        msg.bytes_(value)
        crc = zlib.crc32(bytes(msg.buf)) & 0xFFFFFFFF
        full = Writer()
        full.i64(offsets[i] if offsets else 0)
        full.i32(4 + len(msg.buf))
        full.buf += struct.pack(">I", crc)
        full.raw(bytes(msg.buf))
        out += full.buf
    return bytes(out)


def decode_message_set(topic: str, partition: int, data: bytes) -> List[Record]:
    """MessageSet (v0/v1 messages) -> Records. gzip wrapper messages are
    decompressed (external producers commonly enable it); snappy/lz4 are
    rejected (no codec dependency), as is RecordBatch
    (magic 2)."""
    records: List[Record] = []
    r = Reader(data)
    while r.remaining >= 12:
        # Sniff the magic byte (offset 16 in both framings: v0/v1 put it
        # after offset+size+crc, v2 after baseOffset+batchLength+leaderEpoch)
        if len(data) - r.pos >= 17 and data[r.pos + 16] == 2:
            batch, consumed = decode_record_batch(
                topic, partition, data[r.pos:])
            records.extend(batch)
            r.pos += consumed
            continue
        offset = r.i64()
        size = r.i32()
        if r.remaining < size:
            break  # partial trailing message (Kafka truncates at max_bytes)
        body = Reader(r._take(size))
        body.i32()  # crc (trusted; TCP already checksums)
        magic = body.i8()
        if magic == 2:  # unreachable after the sniff; defensive
            raise KafkaProtocolError("unexpected magic 2 in message set")
        attrs = body.i8()
        codec = attrs & 0x07
        ts = body.i64() / 1e3 if magic == 1 else time.time()
        key = body.bytes_()
        value = body.bytes_() or b""
        if codec == 0:
            records.append(Record(topic, partition, offset, key, value, ts))
            continue
        if codec == 1:
            import gzip as _gzip

            decompressed = _gzip.decompress(value)
        elif codec == 2:
            from storm_tpu_torch.connectors.snappy import decompress as _snappy

            decompressed = _snappy(value)
        elif codec == 3:
            from storm_tpu_torch.connectors.lz4 import decompress_frame as _lz4

            # v0/v1-era Kafka lz4 (including the legacy broken-HC frame
            # header variant — checksums unvalidated by design)
            decompressed = _lz4(value)
        else:
            raise KafkaProtocolError(
                f"unsupported compression codec {codec} "
                "(gzip=1, snappy=2, lz4=3 supported; zstd is not)"
            )
        # compressed wrapper: the value is an inner message set. For magic 1
        # (KIP-31) inner offsets are 0-based relative and the wrapper carries
        # the offset of the LAST inner message; for magic 0 they're absolute.
        inner = decode_message_set(topic, partition, decompressed)
        if magic == 1 and inner:
            base = offset - (len(inner) - 1)
            inner = [
                Record(rec.topic, rec.partition, base + i, rec.key, rec.value,
                       rec.timestamp)
                for i, rec in enumerate(inner)
            ]
        records.extend(inner)
    return records


# ---- record batches (format v2, KIP-98) --------------------------------------


def _zigzag_encode(v: int) -> int:
    return (v << 1) ^ (v >> 63)


def _zigzag_decode(v: int) -> int:
    return (v >> 1) ^ -(v & 1)


def _write_varint(out: bytearray, v: int) -> None:
    u = _zigzag_encode(v) & 0xFFFFFFFFFFFFFFFF
    while True:
        b = u & 0x7F
        u >>= 7
        if u:
            out.append(b | 0x80)
        else:
            out.append(b)
            return


def _read_varint(data: bytes, pos: int) -> Tuple[int, int]:
    shift = 0
    u = 0
    while True:
        if pos >= len(data):
            raise KafkaProtocolError("truncated varint in record batch")
        b = data[pos]
        pos += 1
        u |= (b & 0x7F) << shift
        if not b & 0x80:
            return _zigzag_decode(u), pos
        shift += 7
        if shift > 63:
            raise KafkaProtocolError("varint overflow in record batch")


def encode_control_batch(control_type: int, producer: Tuple[int, int],
                         base_offset: int, ts_ms: int) -> bytes:
    """A KIP-98 transaction marker batch (attrs bit 5): one record whose
    key is version(i16)+type(i16) — 0=ABORT, 1=COMMIT. Occupies one log
    offset, exactly like a real broker's marker."""
    key = struct.pack(">hh", 0, control_type)
    return encode_record_batch(
        [(key, b"")], ts_ms, base_offset=base_offset,
        producer=(producer[0], producer[1], -1), transactional=True,
        control=True)


def encode_record_batch(
    records: List[Tuple[Optional[bytes], bytes]],
    ts_ms: int,
    base_offset: int = 0,
    compression: Optional[str] = None,
    producer: Optional[Tuple[int, int, int]] = None,
    transactional: bool = False,
    control: bool = False,
) -> bytes:
    """[(key, value)] -> one RecordBatch (magic 2; ``compression='gzip'``
    gzips the records block, codec bit 1; ``'snappy'`` wraps it in a raw
    snappy block, codec bit 2). CRC32C (Castagnoli) covers everything
    after the crc field, computed by the native layer when built.
    ``producer=(producer_id, epoch, base_sequence)`` stamps the KIP-98
    idempotence fields (default: -1/-1/-1, non-idempotent)."""
    from storm_tpu_torch.native import crc32c

    if compression not in (None, "gzip", "snappy", "lz4"):
        raise KafkaProtocolError(
            f"unsupported compression {compression!r} (gzip/snappy/lz4)")
    body = bytearray()
    for i, (key, value) in enumerate(records):
        rec = bytearray()
        rec.append(0)  # record attributes
        _write_varint(rec, 0)  # timestampDelta
        _write_varint(rec, i)  # offsetDelta
        if key is None:
            _write_varint(rec, -1)
        else:
            _write_varint(rec, len(key))
            rec += key
        _write_varint(rec, len(value))
        rec += value
        _write_varint(rec, 0)  # headers
        _write_varint(body, len(rec))
        body += rec

    payload = bytes(body)
    attrs = 0x10 if transactional else 0  # bit 4: isTransactional (KIP-98)
    if control:
        attrs |= 0x20  # bit 5: isControl (transaction marker)
    if compression == "gzip":
        import gzip as _gzip

        payload = _gzip.compress(payload)
        attrs |= 1  # codec bits: gzip
    elif compression == "snappy":
        from storm_tpu_torch.connectors import snappy as _snappy

        # xerial framing: Kafka's Java stack (broker record validation AND
        # consumers) decompresses snappy via SnappyInputStream, which
        # requires the \x82SNAPPY\x00 stream header — in the record-batch
        # era too, not just v0/v1 wrapper messages.
        payload = _snappy.compress(payload, xerial=True)
        attrs |= 2  # codec bits: snappy
    elif compression == "lz4":
        from storm_tpu_torch.connectors import lz4 as _lz4

        # spec-correct frame (KIP-57 fixed header checksum for v2 batches)
        payload = _lz4.compress_frame(payload)
        attrs |= 3  # codec bits: lz4
    after_crc = Writer()
    after_crc.i16(attrs)
    after_crc.i32(len(records) - 1)  # lastOffsetDelta
    after_crc.i64(ts_ms)  # baseTimestamp
    after_crc.i64(ts_ms)  # maxTimestamp
    pid, epoch, base_seq = producer if producer is not None else (-1, -1, -1)
    after_crc.i64(pid)  # producerId
    after_crc.i16(epoch)  # producerEpoch
    after_crc.i32(base_seq)  # baseSequence
    after_crc.i32(len(records))
    after_crc.raw(payload)
    crc = crc32c(bytes(after_crc.buf))

    batch = Writer()
    batch.i64(base_offset)
    batch.i32(4 + 1 + 4 + len(after_crc.buf))  # batchLength (after this field)
    batch.i32(-1)  # partitionLeaderEpoch
    batch.i8(2)  # magic
    batch.buf += struct.pack(">I", crc)
    batch.raw(bytes(after_crc.buf))
    return bytes(batch.buf)


def decode_record_batch(topic: str, partition: int, data: bytes,
                        verify_crc: bool = False) -> Tuple[List[Record], int]:
    """One RecordBatch -> (records, bytes consumed). ``data`` starts at
    baseOffset. Control batches (transaction markers) are skipped."""
    records, consumed, _pid, _ctrl = decode_record_batch_ex(
        topic, partition, data, verify_crc)
    return records, consumed


def decode_record_batch_ex(
    topic: str, partition: int, data: bytes, verify_crc: bool = False,
) -> Tuple[List[Record], int, int, Optional[int]]:
    """Like :func:`decode_record_batch` but also returns the batch's
    ``producer_id`` and, for control batches, the marker type (0=ABORT,
    1=COMMIT; None for data batches) — what read_committed filtering
    needs (KIP-98: aborted producers' data batches are dropped until
    their ABORT marker)."""
    r = Reader(data)
    base_offset = r.i64()
    batch_len = r.i32()
    if r.remaining < batch_len:
        # partial trailing batch (broker truncation)
        return [], len(data), -1, None
    end = r.pos + batch_len
    r.i32()  # partitionLeaderEpoch
    magic = r.i8()
    if magic != 2:
        raise KafkaProtocolError(f"expected magic 2, got {magic}")
    crc = struct.unpack(">I", r._take(4))[0]
    if verify_crc:
        from storm_tpu_torch.native import crc32c

        got = crc32c(data[r.pos:end])
        if got != crc:
            raise KafkaProtocolError(
                f"record batch CRC32C mismatch ({got:#x} != {crc:#x})")
    attrs = r.i16()
    codec = attrs & 0x07
    is_control = bool(attrs & 0x20)
    r.i32()  # lastOffsetDelta
    base_ts = r.i64()
    r.i64()  # maxTimestamp
    producer_id = r.i64()
    r.i16()  # producerEpoch
    r.i32()  # baseSequence
    count = r.i32()
    payload = data[r.pos:end]
    if codec == 1:
        import gzip as _gzip

        payload = _gzip.decompress(payload)
    elif codec == 2:
        from storm_tpu_torch.connectors.snappy import decompress as _snappy

        # snappy-java frames record batches xerially too; decompress()
        # sniffs the header and accepts raw blocks as well (non-Java
        # producers sometimes ship them).
        payload = _snappy(payload)
    elif codec == 3:
        from storm_tpu_torch.connectors.lz4 import decompress_frame as _lz4

        payload = _lz4(payload)
    elif codec != 0:
        raise KafkaProtocolError(
            f"unsupported record-batch codec {codec} "
            "(none/gzip/snappy/lz4 supported; zstd is not)")
    records: List[Record] = []
    control_type: Optional[int] = None
    pos = 0
    for _ in range(count):
        rec_len, pos = _read_varint(payload, pos)
        rec_end = pos + rec_len
        pos += 1  # record attributes
        ts_delta, pos = _read_varint(payload, pos)
        off_delta, pos = _read_varint(payload, pos)
        klen, pos = _read_varint(payload, pos)
        key = None
        if klen >= 0:
            key = payload[pos:pos + klen]
            pos = pos + klen
        vlen, pos = _read_varint(payload, pos)
        value = b""
        if vlen >= 0:
            value = payload[pos:pos + vlen]
            pos = pos + vlen
        n_headers, pos = _read_varint(payload, pos)
        for _ in range(n_headers):
            hklen, pos = _read_varint(payload, pos)
            pos += max(0, hklen)
            hvlen, pos = _read_varint(payload, pos)
            pos += max(0, hvlen)
        if pos != rec_end:
            pos = rec_end  # tolerate forward-compatible extra fields
        if is_control:
            # control record key: version(i16) + type(i16): 0=ABORT,
            # 1=COMMIT (KIP-98 transaction markers)
            if control_type is None and key is not None and len(key) >= 4:
                control_type = struct.unpack(">h", key[2:4])[0]
        else:
            records.append(Record(topic, partition, base_offset + off_delta,
                                  key, value, (base_ts + ts_delta) / 1e3))
    return records, end, producer_id, control_type


def filter_read_committed(
    topic: str, partition: int, data: bytes,
    aborted: List[Tuple[int, int]],
) -> List[Record]:
    """Decode a fetch record-set under ``isolation_level=read_committed``
    (KIP-98, the KafkaConsumer algorithm): walk batches in offset order,
    activating each ``(producer_id, first_offset)`` entry from the
    broker's ``aborted_transactions`` list once the log reaches its
    ``first_offset``; data batches from an active aborted producer are
    dropped until that producer's ABORT control marker. v0/v1 message
    sets (pre-transactions) pass through untouched."""
    records: List[Record] = []
    pending = sorted(aborted, key=lambda e: e[1])  # by first_offset
    idx = 0
    aborted_pids: set = set()
    r = Reader(data)
    while r.remaining >= 12:
        if not (len(data) - r.pos >= 17 and data[r.pos + 16] == 2):
            # legacy message set: cannot be transactional
            records.extend(decode_message_set(
                topic, partition, data[r.pos:]))
            break
        base_offset = struct.unpack_from(">q", data, r.pos)[0]
        while idx < len(pending) and pending[idx][1] <= base_offset:
            aborted_pids.add(pending[idx][0])
            idx += 1
        batch, consumed, pid, ctrl = decode_record_batch_ex(
            topic, partition, data[r.pos:])
        if consumed <= 0:  # pragma: no cover - defensive
            break
        r.pos += consumed
        if ctrl is not None:
            if ctrl == 0:  # ABORT marker closes the producer's range
                aborted_pids.discard(pid)
            continue
        if pid >= 0 and pid in aborted_pids:
            continue  # data from an aborted transaction
        records.extend(batch)
    return records


# ---- connection --------------------------------------------------------------


class _Conn:
    def __init__(self, host: str, port: int, client_id: str, timeout: float,
                 security: "Optional[dict]" = None) -> None:
        self.sock = socket.create_connection((host, port), timeout=timeout)
        self.sock.setsockopt(socket.IPPROTO_TCP, socket.TCP_NODELAY, 1)
        self.client_id = client_id
        self.lock = threading.Lock()
        self._corr = 0
        proto = (security or {}).get("protocol", "PLAINTEXT")
        try:
            if proto in ("SSL", "SASL_SSL"):
                import ssl as _ssl

                cafile = security.get("ssl_cafile") or None
                ctx = _ssl.create_default_context(cafile=cafile)
                if not security.get("ssl_check_hostname", True):
                    # skips hostname/SAN matching ONLY; the chain is
                    # still verified against the CA bundle (or system CAs)
                    ctx.check_hostname = False
                if not security.get("ssl_verify", True):
                    # explicit, separate opt-out: accept any cert
                    # (encryption without authentication — last resort)
                    ctx.check_hostname = False
                    ctx.verify_mode = _ssl.CERT_NONE
                self.sock = ctx.wrap_socket(self.sock, server_hostname=host)
            if proto in ("SASL_PLAINTEXT", "SASL_SSL"):
                self._sasl_plain(security)
        except BaseException:
            # a failed TLS/SASL step must not leak the connected socket
            # (the retry loops would accumulate fds until GC)
            self.close()
            raise

    _SCRAM_ALGOS = {"SCRAM-SHA-256": "sha256", "SCRAM-SHA-512": "sha512"}

    def _sasl_plain(self, security: dict) -> None:
        """0.10/0.11-era SASL: a Kafka-framed SaslHandshake (api 17 v0)
        naming the mechanism, then RAW length-prefixed token frames — the
        tokens are not wrapped in the Kafka protocol until KIP-152 (broker
        1.0+); this client speaks the era of its pinned APIs. Mechanisms:
        PLAIN (the era's standard) and SCRAM-SHA-256/-512 (KIP-84,
        broker 0.10.2+ — the password never crosses the wire, and the
        server signature is verified for mutual authentication)."""
        mech = security.get("sasl_mechanism", "PLAIN")
        if mech not in SASL_MECHANISMS:
            raise KafkaProtocolError(
                f"unsupported sasl_mechanism {mech!r} "
                f"(one of {list(SASL_MECHANISMS)})")
        r = self.request(17, 0, bytes(Writer().string(mech).buf))
        err = r.i16()
        mechs = [r.string() for _ in range(max(0, r.i32()))]
        if err:
            raise KafkaProtocolError(
                f"SaslHandshake({mech}) refused: error {err} "
                f"({ERROR_NAMES.get(err, 'UNKNOWN')}); broker offers "
                f"{mechs}", code=err)
        user = security.get("sasl_username") or ""
        pwd = security.get("sasl_password") or ""
        with self.lock:
            if mech == "PLAIN":
                self._sasl_token(
                    mech, b"\x00" + user.encode() + b"\x00" + pwd.encode())
            else:
                self._sasl_scram(mech, user, pwd)

    def _sasl_token(self, mech: str, token: bytes) -> bytes:
        """One raw (pre-KIP-152) token round trip. Caller holds the lock.

        Success = a (possibly empty) server token; failure = broker closes
        (FIN -> KafkaProtocolError from _recv, RST -> OSError) — both must
        surface AS an auth failure, not leak out as a transport error the
        leader-retry path would re-auth against with the same bad
        credentials."""
        try:
            self.sock.sendall(struct.pack(">i", len(token)) + token)
            size = struct.unpack(">i", self._recv(4))[0]
            return self._recv(size) if size > 0 else b""
        except (KafkaProtocolError, OSError) as e:
            raise KafkaProtocolError(
                f"SASL/{mech} authentication failed (broker closed the "
                f"connection): {e}") from e

    def _sasl_scram(self, mech: str, user: str, pwd: str) -> None:
        """SCRAM client exchange (RFC 5802/7677 over Kafka raw frames)."""
        import base64
        import hashlib
        import hmac as hmac_mod
        import os

        algo = self._SCRAM_ALGOS[mech]

        def hm(key: bytes, data: bytes) -> bytes:
            return hmac_mod.new(key, data, algo).digest()

        def fields_of(msg: bytes, what: str) -> dict:
            try:
                return dict(kv.split("=", 1)
                            for kv in msg.decode("utf-8").split(","))
            except ValueError:
                raise KafkaProtocolError(
                    f"{mech}: malformed {what} message {msg!r}") from None

        def b64(s: str, what: str) -> bytes:
            # keep malformed-server failures inside the module's error
            # taxonomy (KafkaProtocolError/OSError — what callers and the
            # retry paths catch), never a bare binascii/ValueError
            try:
                return base64.b64decode(s, validate=True)
            except (ValueError, TypeError):
                raise KafkaProtocolError(
                    f"{mech}: malformed base64 in {what}: {s!r}") from None

        esc = user.replace("=", "=3D").replace(",", "=2C")
        cnonce = base64.b64encode(os.urandom(18)).decode()
        first_bare = f"n={esc},r={cnonce}"
        server_first = self._sasl_token(mech, b"n,," + first_bare.encode())
        f = fields_of(server_first, "server-first")
        snonce = f.get("r", "")
        try:
            iterations = int(f.get("i", "0"))
        except ValueError:
            raise KafkaProtocolError(
                f"{mech}: non-integer iteration count "
                f"{f.get('i')!r}") from None
        if not snonce.startswith(cnonce) or len(snonce) <= len(cnonce):
            raise KafkaProtocolError(
                f"{mech}: server nonce does not extend the client nonce")
        if "s" not in f:
            raise KafkaProtocolError(
                f"{mech}: bad server-first message {server_first!r}")
        # RFC 7677 floor: an attacker posing as the broker must not be
        # able to request i=1 and dictionary-crack the resulting proof
        # ~4096x faster; huge i would hang connect in CPU-bound PBKDF2
        # that no socket timeout covers.
        if not 4096 <= iterations <= 10_000_000:
            raise KafkaProtocolError(
                f"{mech}: iteration count {iterations} outside the "
                "accepted range [4096, 10000000]")
        salted = hashlib.pbkdf2_hmac(
            algo, pwd.encode(), b64(f["s"], "salt"), iterations)
        client_key = hm(salted, b"Client Key")
        final_wo_proof = f"c=biws,r={snonce}"  # biws = b64("n,,")
        auth_msg = ",".join((first_bare, server_first.decode("utf-8"),
                             final_wo_proof)).encode()
        signature = hm(hashlib.new(algo, client_key).digest(), auth_msg)
        proof = bytes(a ^ b for a, b in zip(client_key, signature))
        final = (final_wo_proof + ",p="
                 + base64.b64encode(proof).decode()).encode()
        server_final = self._sasl_token(mech, final)
        f = fields_of(server_final, "server-final")
        if "e" in f:
            raise KafkaProtocolError(
                f"SASL/{mech} authentication failed: {f['e']}")
        # Mutual auth: a broker that doesn't hold the credentials cannot
        # produce this signature — verification is mandatory, not optional.
        expected = hm(hm(salted, b"Server Key"), auth_msg)
        if not hmac_mod.compare_digest(
                b64(f.get("v", ""), "server signature"), expected):
            raise KafkaProtocolError(
                f"SASL/{mech}: server signature mismatch (the broker does "
                "not hold these credentials — possible man-in-the-middle)")

    def request(
        self, api_key: int, api_version: int, body: bytes, oneway: bool = False
    ) -> Optional[Reader]:
        """``oneway`` skips the response read — required for acks=0 produce,
        where the broker sends nothing back."""
        with self.lock:
            self._corr += 1
            corr = self._corr
            head = Writer()
            head.i16(api_key).i16(api_version).i32(corr).string(self.client_id)
            payload = bytes(head.buf) + body
            self.sock.sendall(struct.pack(">i", len(payload)) + payload)
            if oneway:
                return None
            size = struct.unpack(">i", self._recv(4))[0]
            resp = Reader(self._recv(size))
        got = resp.i32()
        if got != corr:
            raise KafkaProtocolError(f"correlation mismatch {got} != {corr}")
        return resp

    def _recv(self, n: int) -> bytes:
        chunks = bytearray()
        while len(chunks) < n:
            c = self.sock.recv(n - len(chunks))
            if not c:
                raise KafkaProtocolError("connection closed by broker")
            chunks += c
        return bytes(chunks)

    def close(self) -> None:
        try:
            self.sock.close()
        except OSError:
            pass


# ---- client ------------------------------------------------------------------


@dataclass
class _PartitionMeta:
    leader: int


#: Every (api, version) this client can put on the wire, grouped by the
#: FEATURE that needs it — the compat probe hard-fails only on features a
#: handle actually uses ('core' always; the rest are registered by
#: KafkaWireBroker and KafkaTxn; 'group' by storm_tpu's GroupMembership,
#: which the port takes up with the spout's group protocol), so a genuine
#: 0.10 broker with no transaction support still serves the core path while a
#: post-KIP-896 broker is refused loudly.
API_FEATURES: "Dict[str, Dict[int, Tuple[str, Tuple[int, ...]]]]" = {
    "core": {
        0: ("Produce", (2,)),
        1: ("Fetch", (2,)),
        2: ("ListOffsets", (0,)),
        3: ("Metadata", (0,)),
        8: ("OffsetCommit", (2,)),
        9: ("OffsetFetch", (1,)),
        10: ("FindCoordinator", (0,)),
    },
    # message_format='v2' (KIP-98 record batches; idempotence rides it)
    "batches-v2": {
        0: ("Produce", (3,)),
        22: ("InitProducerId", (0,)),
    },
    # KIP-98 transactions (incl. offsets-in-transaction)
    "txn": {
        10: ("FindCoordinator", (1,)),
        22: ("InitProducerId", (0,)),
        24: ("AddPartitionsToTxn", (0,)),
        25: ("AddOffsetsToTxn", (0,)),
        26: ("EndTxn", (0,)),
        28: ("TxnOffsetCommit", (0,)),
    },
    # isolation_level=read_committed fetches (KIP-98 consumer side)
    "read-committed": {
        1: ("Fetch", (4,)),
    },
    # consumer-group coordination (offsets.group_protocol)
    "group": {
        11: ("JoinGroup", (0,)),
        12: ("Heartbeat", (0,)),
        13: ("LeaveGroup", (0,)),
        14: ("SyncGroup", (0,)),
    },
}

#: Flat view (api -> (name, every pinned version)) — what a fully-featured
#: era broker serves; the test stub advertises this by default.
PINNED_API_VERSIONS: "Dict[int, Tuple[str, Tuple[int, ...]]]" = {}
for _apis in API_FEATURES.values():
    for _k, (_n, _vs) in _apis.items():
        _, _have = PINNED_API_VERSIONS.get(_k, (_n, ()))
        PINNED_API_VERSIONS[_k] = (_n, tuple(sorted(set(_have) | set(_vs))))


class KafkaWireClient:
    def __init__(
        self,
        bootstrap: str,
        client_id: str = "storm-tpu",
        timeout: float = 30.0,
        security: "Optional[dict]" = None,
    ) -> None:
        """``security``: None/PLAINTEXT, or a dict with ``protocol``
        ('SSL' | 'SASL_PLAINTEXT' | 'SASL_SSL'), ``sasl_mechanism``
        ('PLAIN'), ``sasl_username``/``sasl_password``, ``ssl_cafile``,
        ``ssl_check_hostname`` — applied to EVERY broker connection
        (cached, probe, coordinator)."""
        host, _, port = bootstrap.partition(":")
        self.bootstrap = (host, int(port or 9092))
        self.client_id = client_id
        self.timeout = timeout
        self.security = security
        self._conns: Dict[Tuple[str, int], _Conn] = {}
        self._conn_locks: Dict[Tuple[str, int], threading.Lock] = {}
        self._brokers: Dict[int, Tuple[str, int]] = {}
        self._meta: Dict[str, Dict[int, _PartitionMeta]] = {}
        self._coordinators: Dict[str, Tuple[str, int]] = {}
        self._lock = threading.Lock()
        self._compat_checked = False
        #: feature groups this client must have (see API_FEATURES);
        #: broker handles register more via ensure_features.
        self.features: set = {"core"}
        self._advertised: Optional[Dict[int, Tuple[int, int]]] = None

    # -- connections ----------------------------------------------------------

    def _conn(self, addr: Tuple[str, int]) -> _Conn:
        """Cached connection per broker address.

        The blocking TCP connect happens under a *per-address* lock, never the
        client-wide one — a dead broker's connect timeout must not stall
        cache hits for healthy brokers on other threads."""
        with self._lock:
            c = self._conns.get(addr)
            if c is not None:
                return c
            addr_lock = self._conn_locks.setdefault(addr, threading.Lock())
        with addr_lock:
            with self._lock:
                c = self._conns.get(addr)
                if c is not None:
                    return c
            c = _Conn(addr[0], addr[1], self.client_id, self.timeout,
                      self.security)
            with self._lock:
                self._conns[addr] = c
            return c

    def _evict(self, addr: Tuple[str, int], conn: _Conn) -> None:
        with self._lock:
            if self._conns.get(addr) is conn:
                del self._conns[addr]
        conn.close()

    def _request(
        self,
        addr: Tuple[str, int],
        api_key: int,
        api_version: int,
        body: bytes,
        oneway: bool = False,
        _retry: bool = True,
    ) -> Optional[Reader]:
        """Request with one transparent reconnect: a dead cached connection
        (broker restart, idle-closed socket) is evicted and the request
        retried on a fresh one, so a single TCP drop doesn't poison a
        long-running topology. At-least-once semantics tolerate the rare
        duplicate produce a retry can cause."""
        conn = self._conn(addr)
        try:
            return conn.request(api_key, api_version, body, oneway)
        except (OSError, KafkaProtocolError):
            self._evict(addr, conn)
            if not _retry:
                raise
            return self._request(addr, api_key, api_version, body, oneway, _retry=False)

    def _leader_addr(self, topic: str, partition: int) -> Tuple[str, int]:
        meta = self._meta.get(topic)
        if meta is None or partition not in meta:
            self.refresh_metadata([topic])
            meta = self._meta.get(topic)
            if meta is None or partition not in meta:
                raise KafkaProtocolError(f"unknown partition {topic}[{partition}]")
        leader = meta[partition].leader
        return self._brokers.get(leader, self.bootstrap)

    def _leader_retry(self, topic: str, partition: int, what: str, fn):
        """Run ``fn()`` (which must resolve the leader address fresh each
        call) surviving leader elections: on a retriable partition error
        (LEADER_RETRIABLE — NOT_LEADER_FOR_PARTITION et al.) refresh
        metadata and retry with bounded exponential backoff, the
        reference-era kafka-clients 0.11 behavior.
        Non-retriable codes and exhaustion surface to the caller's
        fail/replay path. Duplicate-safety of a produce retry whose first
        attempt landed rides on idempotent produce (sequence dedupe) or
        on at-least-once semantics otherwise.

        OSError is retriable too: the most common real election trigger
        is the leader BROKER dying, which surfaces as a connect/socket
        failure against the stale cached leader address — not as an
        in-band NOT_LEADER reply. One metadata refresh then finds the
        new leader."""
        delay = 0.05
        for attempt in range(6):
            try:
                return fn()
            except (KafkaProtocolError, OSError) as e:
                # TLS failures (bad cert, TLS-to-PLAINTEXT-listener, ...)
                # are configuration errors, not elections — retrying them
                # over the same failing bootstrap just churns for seconds
                # before surfacing. ssl is imported lazily here so
                # PLAINTEXT deployments never load it.
                import ssl as _ssl

                retriable = ((isinstance(e, OSError)
                              and not isinstance(e, _ssl.SSLError))
                             or (isinstance(e, KafkaProtocolError)
                                 and e.code in LEADER_RETRIABLE))
                if not retriable or attempt == 5:
                    raise
                logger.warning(
                    "%s %s[%d]: %s — refreshing metadata and retrying "
                    "(attempt %d)", what, topic, partition, e, attempt + 1)
                time.sleep(delay)
                delay = min(1.0, delay * 2)
                try:
                    self.refresh_metadata([topic])
                except (OSError, KafkaProtocolError):
                    pass  # next attempt re-resolves via bootstrap anyway

    def _coord_retry(self, key, what: str, fn):
        """Run ``fn()`` surviving coordinator moves: on NOT_COORDINATOR /
        COORDINATOR_NOT_AVAILABLE / LOAD_IN_PROGRESS drop the cached
        coordinator address (``key`` into ``self._coordinators``) and
        retry with bounded backoff — the coordinator lookup inside ``fn``
        then re-discovers."""
        delay = 0.05
        for attempt in range(6):
            try:
                return fn()
            except KafkaProtocolError as e:
                if e.code not in COORD_RETRIABLE or attempt == 5:
                    raise
                logger.warning(
                    "%s: %s — re-finding coordinator (attempt %d)",
                    what, e, attempt + 1)
                with self._lock:
                    self._coordinators.pop(key, None)  # group or txn key
                time.sleep(delay)
                delay = min(1.0, delay * 2)

    def close(self) -> None:
        with self._lock:
            for c in self._conns.values():
                c.close()
            self._conns.clear()

    # -- broker compatibility --------------------------------------------------

    def probe_api_versions(self) -> Optional[Dict[int, Tuple[int, int]]]:
        """ApiVersions (api 18 v0) against the bootstrap broker:
        ``{api_key: (min, max)}``, or None when the broker won't answer
        (pre-0.10 brokers close the connection on unknown requests — they
        ARE this client's era, so no-answer is treated as compatible).

        Uses a throwaway connection: a broker that hangs up on the probe
        must not poison the cached request connection."""
        w = Writer()
        try:
            conn = _Conn(self.bootstrap[0], self.bootstrap[1],
                         self.client_id, self.timeout, self.security)
        except OSError:
            return None  # unreachable: let the real request surface it
        try:
            r = conn.request(18, 0, bytes(w.buf))
            err = r.i16()
            # Per the protocol an UNSUPPORTED_VERSION (35) reply still
            # carries the supported-versions array — a future broker
            # answering v0 with error 35 is exactly the case the loud
            # KIP-896 check exists for, so parse and validate rather
            # than treating it as a silent no-answer.
            if err and err != 35:
                return None
            out: Dict[int, Tuple[int, int]] = {}
            for _ in range(r.i32()):
                key = r.i16()
                out[key] = (r.i16(), r.i16())
            if err and not out:
                return None  # errored AND empty array: nothing to learn
            return out
        except (OSError, KafkaProtocolError):
            return None  # no/garbled answer: era-compatible broker assumed
        finally:
            conn.close()

    def ensure_features(self, feats) -> None:
        """Register feature groups (API_FEATURES keys) this client will
        use. Registered before the first connect, they're validated by the
        connect-time probe; registered after (e.g. the first ``txn()``
        handle on a live client), they're checked against the cached
        advertisement immediately."""
        new = set(feats) - self.features
        self.features |= set(feats)
        if new and self._compat_checked:
            self._validate_features(new)

    @staticmethod
    def _feature_gaps(feats, advertised) -> List[str]:
        broken: List[str] = []
        for feat in sorted(feats):
            for key, (name, pinned) in API_FEATURES[feat].items():
                rng = advertised.get(key)
                missing = [v for v in pinned
                           if rng is None or not rng[0] <= v <= rng[1]]
                if missing:
                    have = ("absent" if rng is None
                            else f"v{rng[0]}-v{rng[1]}")
                    broken.append(
                        f"  [{feat}] {name} (api {key}): need "
                        f"v{'/v'.join(map(str, missing))}, broker serves {have}")
        return broken

    def _validate_features(self, feats) -> None:
        if self._advertised is None:
            return  # broker didn't answer the probe: era-compatible assumed
        broken = self._feature_gaps(feats, self._advertised)
        if broken:
            raise KafkaProtocolError(
                "broker is incompatible with this client's 0.10/0.11-era "
                "protocol pinning (KIP-896 removed legacy versions in "
                "Kafka 4.0; use a broker <= 3.x or one compatible with the "
                "reference's Kafka 0.11 era):\n" + "\n".join(broken))

    def check_broker_compat(self) -> None:
        """Fail LOUDLY if the broker no longer serves a pinned (api,
        version) of any feature in use — modern brokers removed the
        0.10/0.11-era encodings (KIP-896), and without this probe that
        surfaces as a cryptic disconnect on the first produce/fetch.
        Features NOT in use (e.g. transactions on a plain 0.10 broker)
        only log a warning, so older brokers keep the core path. Runs once
        per client, from the first metadata refresh."""
        self._advertised = self.probe_api_versions()
        if self._advertised is None:
            return
        self._validate_features(self.features)
        unused = set(API_FEATURES) - self.features
        gaps = self._feature_gaps(unused, self._advertised)
        if gaps:
            logger.info(
                "broker lacks optional protocol features (fine unless "
                "enabled later):\n%s", "\n".join(gaps))

    # -- metadata -------------------------------------------------------------

    def refresh_metadata(self, topics: Optional[List[str]] = None) -> None:
        if not self._compat_checked:
            self._compat_checked = True  # once; errors are permanent anyway
            self.check_broker_compat()
        w = Writer()
        ts = topics or []
        w.i32(len(ts))
        for t in ts:
            w.string(t)
        r = self._request(self.bootstrap, 3, 0, bytes(w.buf))
        n_brokers = r.i32()
        brokers = {}
        for _ in range(n_brokers):
            node = r.i32()
            host = r.string()
            port = r.i32()
            brokers[node] = (host, port)
        self._brokers = brokers
        n_topics = r.i32()
        for _ in range(n_topics):
            err = r.i16()
            name = r.string()
            n_parts = r.i32()
            parts = {}
            for _ in range(n_parts):
                r.i16()  # partition error
                pid = r.i32()
                leader = r.i32()
                for _ in range(r.i32()):
                    r.i32()  # replicas
                for _ in range(r.i32()):
                    r.i32()  # isr
                parts[pid] = _PartitionMeta(leader)
            if err == 0:
                self._meta[name] = parts

    def partitions_for(self, topic: str) -> int:
        if topic not in self._meta:
            self.refresh_metadata([topic])
        return max(1, len(self._meta.get(topic, {})))

    # -- produce --------------------------------------------------------------

    def produce(
        self,
        topic: str,
        partition: int,
        records: List[Tuple[Optional[bytes], bytes]],
        acks: int = 1,
        timeout_ms: int = 30000,
        message_format: str = "v1",
        compression: Optional[str] = None,
        producer: Optional[Tuple[int, int, int]] = None,
        transactional_id: Optional[str] = None,
    ) -> int:
        """Returns the base offset assigned by the broker.

        ``message_format='v2'`` ships a KIP-98 RecordBatch over Produce v3
        (CRC32C, varint records; optional gzip) — what modern brokers store
        natively; 'v1' keeps the 0.11-era message set the reference ran
        against. ``producer=(pid, epoch, base_seq)`` (v2 only) enables
        idempotent produce: the broker dedups retried batches by sequence."""
        ts_ms = int(time.time() * 1e3)
        if message_format == "v2":
            payload = encode_record_batch(records, ts_ms,
                                          compression=compression,
                                          producer=producer,
                                          transactional=transactional_id
                                          is not None)
            api_version = 3
        elif message_format == "v1":
            if compression:
                raise KafkaProtocolError(
                    "compression is only wired for message_format='v2'")
            if producer is not None:
                raise KafkaProtocolError(
                    "idempotent produce needs message_format='v2' "
                    "(KIP-98 RecordBatch carries the producer fields)")
            payload = encode_message_set(records, ts_ms)
            api_version = 2
        else:
            raise KafkaProtocolError(
                f"message_format must be v1|v2, got {message_format!r}")
        w = Writer()
        if api_version >= 3:
            w.string(transactional_id)
        elif transactional_id is not None:
            raise KafkaProtocolError(
                "transactions need message_format='v2' (Produce v3)")
        w.i16(acks).i32(timeout_ms)
        w.i32(1)
        w.string(topic)
        w.i32(1)
        w.i32(partition)
        w.bytes_(payload)
        if acks == 0:
            # Broker sends no response for acks=0; reading one would hang
            # (and with no response there is no error to retry on).
            self._request(self._leader_addr(topic, partition), 0,
                          api_version, bytes(w.buf), oneway=True)
            return -1

        def attempt() -> int:
            r = self._request(self._leader_addr(topic, partition), 0,
                              api_version, bytes(w.buf))
            base_offset = -1
            for _ in range(r.i32()):  # topics
                r.string()
                for _ in range(r.i32()):  # partitions
                    r.i32()  # partition id
                    err = r.i16()
                    base_offset = r.i64()
                    r.i64()  # log_append_time
                    if err == 46:
                        # DUPLICATE_SEQUENCE_NUMBER: the broker's
                        # "already appended" answer to an idempotent
                        # resend whose first attempt landed but whose
                        # response was lost — SUCCESS (this duplicate
                        # suppression is what idempotence exists for;
                        # treating it as fatal would reset the producer
                        # and re-produce under a fresh pid, creating the
                        # very duplicate it prevented).
                        continue
                    if err:
                        raise _proto_error("produce", err)
            r.i32()  # throttle
            return base_offset

        return self._leader_retry(topic, partition, "produce", attempt)

    # -- fetch ----------------------------------------------------------------

    def fetch(
        self,
        topic: str,
        partition: int,
        offset: int,
        max_bytes: int = 1 << 20,
        max_wait_ms: int = 100,
        min_bytes: int = 1,
        isolation: str = "read_uncommitted",
    ) -> List[Record]:
        """``isolation='read_committed'`` uses Fetch v4 (Kafka 0.11,
        KIP-98): the broker bounds the fetch at the last stable offset and
        reports aborted-transaction ranges, which are filtered out here —
        open and aborted transactions' records never reach the caller.
        The default keeps the v2 path (sees everything, like a pre-KIP-98
        consumer)."""
        committed = isolation == "read_committed"
        w = Writer()
        w.i32(-1).i32(max_wait_ms).i32(min_bytes)
        if committed:
            w.i32(max_bytes)  # response-level max_bytes (v3+)
            w.i8(1)  # isolation_level: read_committed
        w.i32(1)
        w.string(topic)
        w.i32(1)
        w.i32(partition).i64(offset).i32(max_bytes)

        def attempt() -> List[Record]:
            r = self._request(self._leader_addr(topic, partition), 1,
                              4 if committed else 2, bytes(w.buf))
            r.i32()  # throttle
            out: List[Record] = []
            for _ in range(r.i32()):
                r.string()
                for _ in range(r.i32()):
                    r.i32()  # partition
                    err = r.i16()
                    r.i64()  # high watermark
                    aborted: List[Tuple[int, int]] = []
                    if committed:
                        r.i64()  # last stable offset
                        n_aborted = r.i32()
                        for _ in range(max(0, n_aborted)):  # -1 = null
                            pid = r.i64()
                            first = r.i64()
                            aborted.append((pid, first))
                    data = r.bytes_() or b""
                    if err:
                        raise _proto_error("fetch", err)
                    if committed:
                        out.extend(filter_read_committed(
                            topic, partition, data, aborted))
                    else:
                        out.extend(decode_message_set(topic, partition, data))
            return out

        out = self._leader_retry(topic, partition, "fetch", attempt)
        # Skip messages below the requested offset (brokers may return the
        # whole containing batch).
        return [rec for rec in out if rec.offset >= offset]

    # -- offsets --------------------------------------------------------------

    def init_producer_id(self, timeout_ms: int = 30000,
                         transactional_id: Optional[str] = None,
                         ) -> Tuple[int, int]:
        """InitProducerId (api 22 v0, KIP-98): allocate a (producer_id,
        epoch). With ``transactional_id``, re-initializing the same id
        bumps the epoch — fencing any zombie producer still using the old
        one (its sends fail with INVALID_PRODUCER_EPOCH)."""
        w = Writer()
        w.string(transactional_id)
        w.i32(timeout_ms)
        def attempt() -> Tuple[int, int]:
            if transactional_id is None:
                r = self._request(self.bootstrap, 22, 0, bytes(w.buf))
            else:
                r = self._txn_request(transactional_id, 22, 0, bytes(w.buf))
            r.i32()  # throttle
            err = r.i16()
            if err:
                raise _proto_error("init_producer_id", err)
            return r.i64(), r.i16()

        if transactional_id is None:
            return attempt()
        return self._coord_retry(("txn", transactional_id),
                                 f"init_producer_id({transactional_id})",
                                 attempt)

    def add_partitions_to_txn(self, txn_id: str, pid: int, epoch: int,
                              parts: List[Tuple[str, int]]) -> None:
        """AddPartitionsToTxn (api 24 v0): register partitions with the
        transaction before producing to them."""
        w = Writer()
        w.string(txn_id).i64(pid).i16(epoch)
        by_topic: Dict[str, List[int]] = {}
        for t, p in parts:
            by_topic.setdefault(t, []).append(p)
        w.i32(len(by_topic))
        for t, ps in by_topic.items():
            w.string(t)
            w.i32(len(ps))
            for p in ps:
                w.i32(p)
        def attempt() -> None:
            r = self._txn_request(txn_id, 24, 0, bytes(w.buf))
            r.i32()  # throttle
            for _ in range(r.i32()):
                r.string()
                for _ in range(r.i32()):
                    r.i32()
                    err = r.i16()
                    if err:
                        raise _proto_error("add_partitions_to_txn", err)

        self._coord_retry(("txn", txn_id), f"add_partitions_to_txn({txn_id})",
                          attempt)

    def add_offsets_to_txn(self, txn_id: str, pid: int, epoch: int,
                           group: str) -> None:
        """AddOffsetsToTxn (api 25 v0, KIP-98): register a consumer group's
        offsets topic with the transaction, so a subsequent TxnOffsetCommit
        commits atomically with the produced records. Routed to the
        TRANSACTION coordinator."""
        w = Writer()
        w.string(txn_id).i64(pid).i16(epoch).string(group)
        def attempt() -> None:
            r = self._txn_request(txn_id, 25, 0, bytes(w.buf))
            r.i32()  # throttle
            err = r.i16()
            if err:
                raise _proto_error("add_offsets_to_txn", err)

        self._coord_retry(("txn", txn_id), f"add_offsets_to_txn({txn_id})",
                          attempt)

    def txn_offset_commit(self, txn_id: str, group: str, pid: int,
                          epoch: int,
                          offsets: Dict[Tuple[str, int], int]) -> None:
        """TxnOffsetCommit (api 28 v0, KIP-98): stage consumed offsets
        inside the open transaction. They become the group's committed
        offsets only when EndTxn commits (and vanish on abort) — the other
        half of the consume-transform-produce exactly-once loop. Routed to
        the GROUP coordinator (which owns the __consumer_offsets partition),
        not the transaction coordinator."""
        w = Writer()
        w.string(txn_id).string(group).i64(pid).i16(epoch)
        by_topic: Dict[str, List[Tuple[int, int]]] = {}
        for (t, p), off in offsets.items():
            by_topic.setdefault(t, []).append((p, off))
        w.i32(len(by_topic))
        for t, parts in by_topic.items():
            w.string(t)
            w.i32(len(parts))
            for p, off in parts:
                w.i32(p).i64(off).string(None)  # metadata
        def attempt() -> None:
            r = self._coordinator_request(group, 28, 0, bytes(w.buf))
            r.i32()  # throttle
            for _ in range(r.i32()):
                r.string()
                for _ in range(r.i32()):
                    r.i32()
                    err = r.i16()
                    if err:
                        raise _proto_error("txn_offset_commit", err)

        self._coord_retry(group, f"txn_offset_commit({group})", attempt)

    def end_txn(self, txn_id: str, pid: int, epoch: int,
                commit: bool) -> None:
        """EndTxn (api 26 v0): commit or abort the open transaction."""
        w = Writer()
        w.string(txn_id).i64(pid).i16(epoch).i8(1 if commit else 0)
        def attempt() -> None:
            r = self._txn_request(txn_id, 26, 0, bytes(w.buf))
            r.i32()  # throttle
            err = r.i16()
            if err:
                raise _proto_error("end_txn", err)

        self._coord_retry(("txn", txn_id), f"end_txn({txn_id})", attempt)

    def list_offset(self, topic: str, partition: int, timestamp: int) -> int:
        """timestamp -1 = log end, -2 = log start."""
        w = Writer()
        w.i32(-1)
        w.i32(1)
        w.string(topic)
        w.i32(1)
        w.i32(partition).i64(timestamp).i32(1)

        def attempt() -> int:
            r = self._request(self._leader_addr(topic, partition), 2, 0,
                              bytes(w.buf))
            result = 0
            for _ in range(r.i32()):
                r.string()
                for _ in range(r.i32()):
                    r.i32()
                    err = r.i16()
                    if err:
                        raise _proto_error("list_offsets", err)
                    n = r.i32()
                    offsets = [r.i64() for _ in range(n)]
                    if offsets:
                        result = offsets[0]
            return result

        return self._leader_retry(topic, partition, "list_offsets", attempt)

    def _coordinator_addr(self, group: str) -> Tuple[str, int]:
        """Coordinator lookup, cached per group (refreshing on every commit
        would cost an extra round trip per acked tuple)."""
        with self._lock:
            cached = self._coordinators.get(group)
        if cached is not None:
            return cached
        w = Writer()
        w.string(group)
        r = self._request(self.bootstrap, 10, 0, bytes(w.buf))
        err = r.i16()
        r.i32()  # node id
        host = r.string()
        port = r.i32()
        if err:
            raise _proto_error("find_coordinator", err)
        with self._lock:
            self._coordinators[group] = (host, port)
        return (host, port)

    def _txn_coordinator_addr(self, txn_id: str) -> Tuple[str, int]:
        """Transaction-coordinator lookup (FindCoordinator v1 with
        coordinator_type=1), cached per transactional id."""
        key = ("txn", txn_id)
        with self._lock:
            cached = self._coordinators.get(key)
        if cached is not None:
            return cached
        w = Writer()
        w.string(txn_id)
        w.i8(1)  # coordinator_type: transaction
        r = self._request(self.bootstrap, 10, 1, bytes(w.buf))
        r.i32()  # throttle (v1)
        err = r.i16()
        r.string()  # error_message (v1)
        r.i32()  # node id
        host = r.string()
        port = r.i32()
        if err:
            raise _proto_error("find_coordinator(txn)", err)
        with self._lock:
            self._coordinators[key] = (host, port)
        return (host, port)

    def _txn_request(self, txn_id: str, api: int, version: int,
                     body: bytes) -> Reader:
        try:
            return self._request(
                self._txn_coordinator_addr(txn_id), api, version, body)
        except (OSError, KafkaProtocolError):
            with self._lock:
                self._coordinators.pop(("txn", txn_id), None)
            return self._request(
                self._txn_coordinator_addr(txn_id), api, version, body)

    def invalidate_coordinator(self, group: str) -> None:
        """Drop the cached coordinator address (it moved / its broker
        died); the next coordinator RPC re-discovers via FindCoordinator."""
        with self._lock:
            self._coordinators.pop(group, None)

    def _coordinator_request(
        self, group: str, api: int, version: int, body: bytes
    ) -> Reader:
        try:
            return self._request(self._coordinator_addr(group), api, version, body)
        except (OSError, KafkaProtocolError):
            # Coordinator may have moved; re-discover once.
            self.invalidate_coordinator(group)
            return self._request(self._coordinator_addr(group), api, version, body)

    def offset_commit(self, group: str, topic: str, partition: int, offset: int) -> None:
        w = Writer()
        w.string(group)
        w.i32(-1)      # generation (simple consumer)
        w.string("")   # member id
        w.i64(-1)      # retention
        w.i32(1)
        w.string(topic)
        w.i32(1)
        w.i32(partition).i64(offset).string(None)

        def attempt() -> None:
            r = self._coordinator_request(group, 8, 2, bytes(w.buf))
            for _ in range(r.i32()):
                r.string()
                for _ in range(r.i32()):
                    r.i32()
                    err = r.i16()
                    if err:
                        raise _proto_error("offset_commit", err)

        self._coord_retry(group, f"offset_commit({group})", attempt)

    def offset_fetch(self, group: str, topic: str, partition: int) -> Optional[int]:
        w = Writer()
        w.string(group)
        w.i32(1)
        w.string(topic)
        w.i32(1)
        w.i32(partition)

        def attempt() -> Optional[int]:
            r = self._coordinator_request(group, 9, 1, bytes(w.buf))
            result: Optional[int] = None
            for _ in range(r.i32()):
                r.string()
                for _ in range(r.i32()):
                    r.i32()
                    off = r.i64()
                    r.string()  # metadata
                    err = r.i16()
                    if err:
                        raise _proto_error("offset_fetch", err)
                    result = None if off < 0 else off
            return result

        return self._coord_retry(group, f"offset_fetch({group})", attempt)


# ---- consumer groups -----------------------------------------------------------


class GroupMembership:
    """Kafka consumer-group coordination (JoinGroup/SyncGroup/Heartbeat/
    LeaveGroup v0), copied from storm_tpu's: dynamic partition assignment
    across cooperating consumers, the modern replacement for the
    reference's ZooKeeper-based assignment (MainTopology.java:96-99).

    ``join()`` runs the join->sync cycle (the elected leader computes a
    range assignment over ``topics``) and returns this member's
    ``[(topic, partition), ...]``. ``heartbeat()`` returns False when the
    group is rebalancing — call ``join()`` again (positions should then be
    re-resolved per the offsets policy). ``leave()`` exits cleanly,
    triggering a rebalance for the survivors.
    """

    PROTOCOL = "range"

    # ConsumerProtocol v0 (Kafka's cross-client subscription/assignment
    # format): interop with standard consumers requires speaking it — a
    # foreign leader's assignment must parse here, and our leader's
    # assignments must parse in kafka-python/Java clients.

    @staticmethod
    def _encode_subscription(topics: List[str]) -> bytes:
        w = Writer()
        w.i16(0)
        w.i32(len(topics))
        for t in topics:
            w.string(t)
        w.bytes_(b"")  # userdata
        return bytes(w.buf)

    @staticmethod
    def _decode_subscription(blob: bytes) -> List[str]:
        r = Reader(blob)
        r.i16()
        return [r.string() for _ in range(r.i32())]

    @staticmethod
    def _encode_assignment(parts: List[Tuple[str, int]]) -> bytes:
        by_topic: Dict[str, List[int]] = {}
        for t, p in parts:
            by_topic.setdefault(t, []).append(p)
        w = Writer()
        w.i16(0)
        w.i32(len(by_topic))
        for t, ps in sorted(by_topic.items()):
            w.string(t)
            w.i32(len(ps))
            for p in sorted(ps):
                w.i32(p)
        w.bytes_(b"")  # userdata
        return bytes(w.buf)

    @staticmethod
    def _decode_assignment(blob: bytes) -> List[Tuple[str, int]]:
        if not blob:
            return []
        try:
            r = Reader(blob)
            r.i16()
            out: List[Tuple[str, int]] = []
            for _ in range(r.i32()):
                t = r.string()
                for _ in range(r.i32()):
                    out.append((t, r.i32()))
            return sorted(out)
        except KafkaProtocolError as e:
            raise KafkaProtocolError(
                f"undecodable ConsumerProtocol assignment: {e}") from e

    def __init__(self, client: "KafkaWireClient", group: str,
                 topics: List[str], session_timeout_ms: int = 10000) -> None:
        client.ensure_features({"group"})
        self.client = client
        self.group = group
        self.topics = list(topics)
        self.session_timeout_ms = session_timeout_ms
        self.member_id = ""
        self.generation = -1
        self.is_leader = False

    # v0 wire bodies ----------------------------------------------------------

    def _rpc(self, api: int, body: bytes) -> Reader:
        """Membership RPC to the GROUP coordinator (FindCoordinator-cached,
        re-discovered once on transport errors — a dead coordinator broker
        must not wedge the member on a stale cached address)."""
        return self.client._coordinator_request(self.group, api, 0, body)

    def _rpc_err(self, api: int, body: bytes):
        """(reader, None) or (None, code) when the coordinator LOOKUP
        itself answers a retriable error (COORDINATOR_NOT_AVAILABLE on a
        freshly started cluster, NOT_COORDINATOR mid-move) — the join
        loop's in-band retry must also cover lookup-phase failures, or a
        routine startup race escapes its 40-attempt patience."""
        try:
            return self._rpc(api, body), None
        except KafkaProtocolError as e:
            if e.code in COORD_RETRIABLE:
                self.client.invalidate_coordinator(self.group)
                return None, e.code
            raise

    def join(self, max_attempts: int = 40) -> List[Tuple[str, int]]:
        for _ in range(max_attempts):
            w = Writer()
            w.string(self.group).i32(self.session_timeout_ms)
            w.string(self.member_id).string("consumer")
            w.i32(1)
            w.string(self.PROTOCOL)
            w.bytes_(self._encode_subscription(self.topics))
            r, lookup_err = self._rpc_err(11, bytes(w.buf))
            if r is None:
                time.sleep(0.05)
                continue
            err = r.i16()
            if err:
                # retryable coordination errors: evicted member (25 — rejoin
                # as new), coordinator moving/loading (14/15/16), rebalance
                # (27). Anything else is a real fault.
                if err == 25:
                    self.member_id = ""
                if err in COORD_RETRIABLE:
                    self.client.invalidate_coordinator(self.group)
                if err in (14, 15, 16, 25, 27):
                    time.sleep(0.05)
                    continue
                raise _proto_error("join_group", err)
            self.generation = r.i32()
            r.string()  # protocol
            leader = r.string()
            self.member_id = r.string()
            members = {}
            for _ in range(r.i32()):
                mid = r.string()
                members[mid] = r.bytes_() or b""
            self.is_leader = leader == self.member_id
            assignments: Dict[str, bytes] = {}
            if self.is_leader:
                assignments = self._range_assign(members)
            # sync; on REBALANCE_IN_PROGRESS the generation is still valid
            # and only the leader's sync is pending — retry the SYNC, not
            # the whole join (rejoining would never let a follower settle
            # while its own retry loop holds the thread)
            err, blob = 27, b""
            for _ in range(20):
                w = Writer()
                w.string(self.group).i32(self.generation).string(self.member_id)
                w.i32(len(assignments))
                for mid, ablob in assignments.items():
                    w.string(mid)
                    w.bytes_(ablob)
                r, lookup_err = self._rpc_err(14, bytes(w.buf))
                if r is None:
                    err, blob = lookup_err, b""
                    time.sleep(0.05)
                    continue
                err = r.i16()
                blob = r.bytes_()
                if err != 27:
                    break
                time.sleep(0.05)
            if err == 27:
                continue  # leader still absent after patience: rejoin
            if err:
                self.member_id = self.member_id if err != 25 else ""
                if err in COORD_RETRIABLE:
                    self.client.invalidate_coordinator(self.group)
                time.sleep(0.05)
                continue
            return self._decode_assignment(blob or b"")
        raise KafkaProtocolError(
            f"group {self.group!r} did not stabilize in {max_attempts} attempts")

    def _range_assign(self, members: Dict[str, bytes]) -> Dict[str, bytes]:
        """Contiguous ranges per topic, over the members SUBSCRIBED to that
        topic (parsed from each member's ConsumerProtocol metadata)."""
        subscriptions: Dict[str, List[str]] = {}
        for mid, meta in members.items():
            try:
                subscriptions[mid] = self._decode_subscription(meta)
            except KafkaProtocolError:
                subscriptions[mid] = list(self.topics)  # tolerate odd members
        all_topics = sorted({t for ts in subscriptions.values() for t in ts})
        per_member: Dict[str, List[Tuple[str, int]]] = {m: [] for m in members}
        for topic in all_topics:
            subscribed = sorted(m for m, ts in subscriptions.items()
                                if topic in ts)
            if not subscribed:
                continue
            n_parts = self.client.partitions_for(topic)
            base, extra = divmod(n_parts, len(subscribed))
            p = 0
            for i, m in enumerate(subscribed):
                take = base + (1 if i < extra else 0)
                for _ in range(take):
                    per_member[m].append((topic, p))
                    p += 1
        return {m: self._encode_assignment(parts)
                for m, parts in per_member.items()}

    def heartbeat(self) -> bool:
        """True = group stable; False = rejoin needed (rebalance in
        progress, member evicted, ...). A coordinator MOVE is handled
        in place: re-find and retry the heartbeat once — member and
        generation stay valid on the new coordinator (group state lives
        in __consumer_offsets), so a routine broker roll must not force
        a group-wide rebalance."""
        w = Writer()
        w.string(self.group).i32(self.generation).string(self.member_id)
        body = bytes(w.buf)
        r, _ = self._rpc_err(12, body)
        err = r.i16() if r is not None else 16
        if err in COORD_RETRIABLE:
            self.client.invalidate_coordinator(self.group)
            r, _ = self._rpc_err(12, body)
            err = r.i16() if r is not None else 16
        return err == 0

    def leave(self) -> None:
        """Prompt exit (survivors rebalance immediately instead of waiting
        out the session timeout) — so a leave answered NOT_COORDINATOR by
        a stale cached address re-finds and retries; best-effort beyond
        that (the session timeout is the backstop)."""
        if not self.member_id:
            return
        w = Writer()
        w.string(self.group).string(self.member_id)
        body = bytes(w.buf)
        try:
            err = self._rpc(13, body).i16()
            if err in COORD_RETRIABLE:
                self.client.invalidate_coordinator(self.group)
                self._rpc(13, body)
        except (OSError, KafkaProtocolError):
            pass  # best effort; session timeout reclaims the member
        self.member_id = ""
        self.generation = -1


# ---- MemoryBroker-surface adapter -------------------------------------------


class KafkaWireBroker:
    """Real-Kafka backend with the MemoryBroker surface, so BrokerSpout /
    BrokerSink work unchanged (``BrokerConfig.kind='kafka'``)."""

    #: BrokerSpout runs fetches through a worker thread when this is set
    #: (network calls must not block the event loop).
    blocking = True

    def __init__(self, bootstrap: str, client_id: str = "storm-tpu",
                 message_format: str = "v1",
                 compression: Optional[str] = None,
                 idempotent: bool = False,
                 isolation: str = "read_uncommitted",
                 security: Optional[dict] = None) -> None:
        self.client = KafkaWireClient(bootstrap, client_id,
                                      security=security)
        if idempotent and message_format != "v2":
            raise KafkaProtocolError(
                "idempotent=True requires message_format='v2'")
        if message_format == "v2":
            self.client.ensure_features({"batches-v2"})
        if isolation not in ("read_uncommitted", "read_committed"):
            raise KafkaProtocolError(
                f"isolation must be read_uncommitted|read_committed, "
                f"got {isolation!r}")
        self.isolation = isolation
        if isolation == "read_committed":
            self.client.ensure_features({"read-committed"})
        self.message_format = message_format
        self.compression = compression
        # KIP-98 idempotent produce: one (producer_id, epoch) per broker
        # handle, lazily initialized; per-partition monotone sequences.
        # A network-error retry of produce() resends the SAME sequence,
        # which the broker recognizes and appends at most once — closing
        # the duplicate window of the sink's retry path.
        self.idempotent = idempotent
        self._producer: Optional[Tuple[int, int]] = None
        self._seqs: Dict[Tuple[str, int], int] = {}
        self._pid_lock = threading.Lock()
        self._part_locks: Dict[Tuple[str, int], threading.Lock] = {}
        self._rr = 0
        # Decoded-but-not-yet-returned tail of the last wire fetch, per
        # partition: a 1MB fetch can decode far more than max_records, and
        # re-fetching the discarded tail on every poll is quadratic during
        # backlog catch-up. Each partition is polled serially by its owning
        # spout task, matching this cache's consistency model.
        self._prefetch: Dict[Tuple[str, int], List[Record]] = {}

    def partitions_for(self, topic: str) -> int:
        return self.client.partitions_for(topic)

    def _select_partition(self, topic, key, partition):
        """Shared partitioner: explicit > stable key hash > round robin.
        (Python's hash() is seed-randomized per run; a durable Kafka log
        outlives the seed, so keyed ordering uses crc32.)"""
        if partition is not None:
            return partition
        n = self.partitions_for(topic)
        if key is not None:
            return zlib.crc32(key) % n
        p = self._rr % n
        self._rr += 1
        return p

    def produce(self, topic, value, key=None, partition=None):
        if isinstance(value, str):
            value = value.encode("utf-8")
        if isinstance(key, str):
            key = key.encode("utf-8")
        partition = self._select_partition(topic, key, partition)
        if not self.idempotent:
            off = self.client.produce(topic, partition, [(key, value)],
                                      message_format=self.message_format,
                                      compression=self.compression)
            return partition, off
        # The broker requires strictly ordered sequences per partition, so
        # idempotent sends are serialized per partition: reserve + send +
        # advance under one lock (concurrency buys nothing the broker
        # would accept out of order). Network retries resend the SAME
        # sequence — the broker appends at most once, so a timeout whose
        # write actually landed does not duplicate. The sequence advances
        # only after success; any final failure re-inits the producer id
        # (fresh pid => sequences restart at 0, the real producer's
        # epoch-bump dance) so the partition can never wedge out-of-order.
        with self._pid_lock:
            plock = self._part_locks.setdefault(
                (topic, partition), threading.Lock())
        with plock:
            with self._pid_lock:
                producer = self._producer
            if producer is None:
                # Init OUTSIDE _pid_lock: the coordinator retry loop can
                # sleep for seconds, and holding the broker-wide lock
                # across it would stall every other partition's produce
                # behind one init. Two racing inits just allocate one
                # extra pid; the loser's is discarded unused (no
                # sequences ever attach to it), and both partitions
                # converge on whichever landed in _producer first.
                fresh = self.client.init_producer_id()
                with self._pid_lock:
                    if self._producer is None:
                        self._producer = fresh
                    producer = self._producer
            pid, epoch = producer
            # Sequences are valid only for the pid that reserved them: a
            # concurrent failure-reset swaps the pid, and a stale entry
            # must read as "start at 0", not leak the old chain.
            spid, seq = self._seqs.get((topic, partition), (pid, 0))
            if spid != pid:
                seq = 0
            last_err: Optional[Exception] = None
            for attempt in range(3):
                try:
                    # acks=all: idempotence at acks=1 can lose an acked
                    # sequenced batch on leader failover and then wedge
                    # out-of-order — real producers force all() too.
                    off = self.client.produce(
                        topic, partition, [(key, value)], acks=-1,
                        message_format=self.message_format,
                        compression=self.compression,
                        producer=(pid, epoch, seq))
                    # int32 sequence wraps mod 2^31 like Kafka's producer.
                    self._seqs[(topic, partition)] = (
                        pid, (seq + 1) & 0x7FFFFFFF)
                    return partition, off
                except (OSError, ConnectionError) as e:
                    last_err = e
                    if attempt < 2:
                        time.sleep(0.05 * 2 ** attempt)
                except KafkaProtocolError as e:
                    # Broker-rejected (not-leader, too-large, sequence
                    # state lost...): same-sequence retry won't change the
                    # verdict — reset the producer instead.
                    last_err = e
                    break
            with self._pid_lock:
                self._producer = None
            raise last_err

    def fetch(self, topic, partition, offset, max_records=512):
        key = (topic, partition)
        buf = self._prefetch.pop(key, None)
        if buf and buf[0].offset == offset:
            if len(buf) > max_records:
                self._prefetch[key] = buf[max_records:]
            return buf[:max_records]
        recs = self.client.fetch(topic, partition, offset,
                                 isolation=self.isolation)
        if len(recs) > max_records:
            self._prefetch[key] = recs[max_records:]
        return recs[:max_records]

    def earliest_offset(self, topic, partition):
        return self.client.list_offset(topic, partition, -2)

    def latest_offset(self, topic, partition):
        return self.client.list_offset(topic, partition, -1)

    def txn(self, txn_id: str) -> "KafkaTxn":
        """A transaction handle bound to ``txn_id`` (KIP-98 exactly-once
        egress; see :class:`KafkaTxn`)."""
        return KafkaTxn(self, txn_id)

    def commit(self, group, topic, partition, offset):
        self.client.offset_commit(group, topic, partition, offset)

    def committed(self, group, topic, partition):
        return self.client.offset_fetch(group, topic, partition)

    def close(self) -> None:
        self.client.close()


class KafkaTxn:
    """One Kafka transaction bound to a ``transactional_id`` (KIP-98).

    Usage (the TransactionalBrokerSink's loop)::

        txn = broker.txn("sink-topo-kafka-bolt-0")   # once per task
        txn.begin(); txn.produce(...); ...; txn.commit()   # per batch

    ``produce`` only buffers locally; ``commit`` registers partitions,
    ships ONE sequenced RecordBatch per partition, and ends the
    transaction — wire cost is O(partitions), not O(records). ``begin``
    lazily (re)initializes the producer id for the transactional id;
    re-initialization bumps the epoch, fencing any zombie task still
    holding the old one. All control RPCs route via the transaction
    coordinator (FindCoordinator type=1).

    ``send_offsets(group, offsets)`` stages consumed offsets INSIDE the
    transaction (AddOffsetsToTxn + TxnOffsetCommit at commit time): the
    group's committed position and the produced records become visible
    atomically — the KIP-98 consume-transform-produce exactly-once loop
    from the reference's own Kafka 0.11 era (pom.xml:55-78)."""

    def __init__(self, broker: "KafkaWireBroker", txn_id: str) -> None:
        self._broker = broker
        self._client = broker.client
        self._client.ensure_features({"txn"})
        self.txn_id = txn_id
        self._pid: Optional[int] = None
        self._epoch = -1
        self._seqs: Dict[Tuple[str, int], int] = {}
        self._pending: Dict[Tuple[str, int], List[Tuple[Optional[bytes], bytes]]] = {}
        self._offsets: Dict[str, Dict[Tuple[str, int], int]] = {}
        self._open = False

    def begin(self) -> None:
        if self._pid is None:
            self._pid, self._epoch = self._client.init_producer_id(
                transactional_id=self.txn_id)
            self._seqs.clear()
        self._pending.clear()
        self._offsets.clear()
        self._open = True

    def send_offsets(self, group: str,
                     offsets: Dict[Tuple[str, int], int]) -> None:
        """Stage consumed offsets ``{(topic, partition): next_offset}`` to
        commit atomically with this transaction's records. Merged max-wins
        across calls within one transaction."""
        assert self._open, "begin() first"
        from storm_tpu_torch.runtime.tuples import merge_offsets

        merge_offsets(self._offsets.setdefault(group, {}), offsets.items())

    def produce(self, topic: str, value, key=None, partition=None) -> None:
        assert self._open, "begin() first"
        if isinstance(value, str):
            value = value.encode("utf-8")
        if isinstance(key, str):
            key = key.encode("utf-8")
        partition = self._broker._select_partition(topic, key, partition)
        self._pending.setdefault((topic, partition), []).append((key, value))

    def commit(self) -> None:
        self._end(True)

    def abort(self) -> None:
        self._end(False)

    def _end(self, commit: bool) -> None:
        if not self._open:
            # abort() after a failed commit(): the transaction is already
            # closed (and possibly fenced) — nothing further to send.
            return
        self._open = False
        pending, self._pending = self._pending, {}
        offsets, self._offsets = self._offsets, {}
        try:
            if commit and pending:
                self._client.add_partitions_to_txn(
                    self.txn_id, self._pid, self._epoch, list(pending))
                for (topic, partition), records in pending.items():
                    seq = self._seqs.get((topic, partition), 0)
                    self._client.produce(
                        topic, partition, records, acks=-1,
                        message_format="v2",
                        compression=self._broker.compression,
                        producer=(self._pid, self._epoch, seq),
                        transactional_id=self.txn_id)
                    self._seqs[(topic, partition)] = \
                        (seq + len(records)) & 0x7FFFFFFF
            if commit:
                for group, offs in offsets.items():
                    if not offs:
                        continue
                    self._client.add_offsets_to_txn(
                        self.txn_id, self._pid, self._epoch, group)
                    self._client.txn_offset_commit(
                        self.txn_id, group, self._pid, self._epoch, offs)
            self._client.end_txn(self.txn_id, self._pid, self._epoch, commit)
        except Exception:
            # Fenced / coordinator lost the txn — OR the socket died mid-way
            # (OSError/ConnectionError): in every failure case the
            # coordinator may still hold this transaction OPEN with records
            # already appended.  Force a fresh InitProducerId on the next
            # begin(): the epoch bump makes the coordinator abort the
            # dangling transaction (KIP-98 fencing), so the replayed batch
            # cannot be committed together with the failed attempt's
            # records.  Resetting only on KafkaProtocolError left network
            # failures re-using the open txn and double-committing.
            self._pid = None
            raise
