"""Kafka broker stub speaking the real wire protocol over real sockets,
copied from storm_tpu's ``tests/kafka_stub.py`` onto the port's
:mod:`storm_tpu_torch.connectors.kafka_protocol`: the broker that dist
workers share when no Kafka cluster is at hand, and the test double for
``KafkaWireClient``/``KafkaWireBroker``.

In a process of its own::

    python -m storm_tpu_torch.connectors.kafka_stub --port 0 [--partitions N]

prints one JSON line ``{"ready": true, "port": P}`` and serves until it is
sent SIGTERM or SIGINT.

Implements the exact API subset the client uses: Metadata v0, Produce
v2/v3 (message sets and KIP-98 record batches, gzip included), Fetch v2
(optionally serving magic-2 batches via ``serve_batches``), ListOffsets
v0, FindCoordinator v0, OffsetCommit v2, OffsetFetch v1, and
consumer-group coordination — JoinGroup/SyncGroup/Heartbeat/LeaveGroup v0
with immediate-join semantics and session-timeout expiry of dead members.
Single node."""

from __future__ import annotations

import argparse
import json
import signal
import socket
import struct
import sys
import threading
import time
from typing import Dict, List, Optional, Tuple

from storm_tpu_torch.connectors.kafka_protocol import (
    Reader,
    Writer,
    decode_message_set,
    encode_message_set,
)


class KafkaStubBroker:
    #: serve fetches as record batches (magic 2) instead of message sets —
    #: exercises the client's v2 decode over a real socket
    serve_batches = False

    #: ApiVersions (api 18) behavior: None = advertise every version the
    #: client pins (compatible broker); a dict {api: (min, max)} simulates
    #: a broker with a different surface (e.g. post-KIP-896 removals);
    #: "closed" = hang up on the probe like a pre-0.10 broker.
    api_versions: "dict | str | None" = None

    #: answer idempotent duplicates with DUPLICATE_SEQUENCE_NUMBER (46)
    #: instead of silently acking with the original offset
    duplicate_error = False

    #: SASL/PLAIN: set to ("user", "password") to require the 0.11-era
    #: handshake (Kafka-framed SaslHandshake api 17, then RAW
    #: length-prefixed tokens) before any other API on the connection;
    #: wrong credentials close the socket like a real broker.
    sasl: "tuple | None" = None

    #: SASL mechanisms the stub advertises/accepts: "PLAIN" (default) or
    #: "SCRAM-SHA-256"/"SCRAM-SHA-512" (full RFC 5802 server exchange,
    #: proof verified via StoredKey, server signature returned).
    sasl_mechanism = "PLAIN"

    #: SCRAM PBKDF2 iteration count the stub requests (lower it to test
    #: the client's RFC 7677 downgrade refusal).
    scram_iterations = 4096

    #: SSL: an ssl.SSLContext to wrap accepted connections with (combine
    #: with ``sasl`` for SASL_SSL).
    ssl_context = None

    #: True = REAL-broker transactional log semantics: transactional
    #: records append to the log immediately (tagged with their producer
    #: id) and EndTxn appends a control marker, occupying an offset —
    #: read_uncommitted fetches see everything, Fetch v4 read_committed
    #: clients filter via the aborted_transactions ranges the stub
    #: reports. Default False keeps the simpler buffer-until-commit model
    #: the rest of the suite uses (nothing visible before commit).
    log_transactional = False

    def __init__(self, partitions: int = 2, nodes: int = 1, port: int = 0) -> None:
        """``nodes > 1`` runs extra listeners that share ALL state (logs,
        groups, transactions) but have distinct node ids/ports — enough to
        move a partition leader or the coordinator mid-stream and exercise
        the client's election-survival path: a non-leader node answers
        produce/fetch/list_offsets with NOT_LEADER_FOR_PARTITION (6) and a
        non-coordinator node answers group/txn RPCs with NOT_COORDINATOR
        (16), exactly like a real broker after the metadata moved.
        ``port`` is node 0's (0 = any free port; see ``self.port``)."""
        self.partitions = partitions
        self.nodes = nodes
        #: (topic, partition) -> leader node id (missing = node 0)
        self._leaders: Dict[Tuple[str, int], int] = {}
        #: node answering group + txn coordinator RPCs
        self._coord_node = 0
        self._logs: Dict[Tuple[str, int], List[Tuple[Optional[bytes], bytes, float]]] = {}
        self._topics: Dict[str, int] = {}
        self._commits: Dict[Tuple[str, str, int], int] = {}
        # consumer groups: group -> {"generation", "members": {member_id:
        # metadata}, "leader", "assignments": {member_id: bytes},
        # "stable": set(member ids that joined the current generation)}
        self._groups: Dict[str, dict] = {}
        self._member_seq = 0
        # KIP-98 idempotence: allocated producer ids and, per
        # (pid, topic, partition), the last accepted (base_seq, count,
        # base_offset) for duplicate/out-of-order detection.
        self._next_pid = 1000
        self._pid_state: Dict[Tuple[int, str, int], Tuple[int, int, int]] = {}
        # Transactions (KIP-98): txn_id -> {"pid", "epoch", "pending":
        # [(topic, part, key, value)], "parts": set}. Produced transactional
        # batches buffer in "pending" and append at EndTxn(commit) — i.e.
        # read-committed visibility; abort drops them. Re-InitProducerId on
        # the same txn_id bumps the epoch (zombie fencing).
        self._txns: Dict[str, dict] = {}
        # log_transactional mode: per-(topic, partition) list of
        # (producer_id, first_offset, marker_offset) for ABORTED
        # transactions; Fetch v4 reports (pid, first_offset) for ranges
        # whose ABORT marker lies within/after the fetched region — a
        # range whose marker precedes the fetch offset is history (its
        # aborted data can't appear in the response), and reporting it
        # would wrongly re-activate the producer and drop its later
        # committed records.
        self._aborted: Dict[Tuple[str, int], List[Tuple[int, int, int]]] = {}
        self._lock = threading.Lock()
        self._socks: List[socket.socket] = []
        self.ports: List[int] = []
        self._running = True
        self._threads: List[threading.Thread] = []
        for node in range(nodes):
            sock = socket.socket(socket.AF_INET, socket.SOCK_STREAM)
            sock.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
            sock.bind(("127.0.0.1", port if node == 0 else 0))
            sock.listen(16)
            self._socks.append(sock)
            self.ports.append(sock.getsockname()[1])
            t = threading.Thread(target=self._accept_loop,
                                 args=(sock, node), daemon=True)
            t.start()
            self._threads.append(t)
        self.port = self.ports[0]

    # ---- leadership / coordinator moves (election simulation) ----------------

    def move_leader(self, topic: str, partition: int, node: int) -> None:
        with self._lock:
            self._ensure(topic)
            self._leaders[(topic, partition)] = node

    def move_coordinator(self, node: int) -> None:
        with self._lock:
            self._coord_node = node

    # ---- plumbing ------------------------------------------------------------

    def _accept_loop(self, sock: socket.socket, node: int) -> None:
        while self._running:
            try:
                conn, _ = sock.accept()
            except OSError:
                return
            t = threading.Thread(target=self._serve, args=(conn, node),
                                 daemon=True)
            t.start()
            self._threads.append(t)

    def _serve(self, conn: socket.socket, node: int = 0) -> None:
        try:
            if self.ssl_context is not None:
                conn = self.ssl_context.wrap_socket(conn, server_side=True)
            authed = self.sasl is None
            while True:
                head = self._recv(conn, 4)
                if head is None:
                    return
                size = struct.unpack(">i", head)[0]
                data = self._recv(conn, size)
                if data is None:
                    return
                r = Reader(data)
                api_key = r.i16()
                api_version = r.i16()
                corr = r.i32()
                r.string()  # client id
                if not authed:
                    if api_key != 17:
                        return  # real brokers drop pre-auth requests
                    mech = r.string()
                    ok = mech == self.sasl_mechanism
                    w = Writer()
                    w.i16(0 if ok else 33)  # UNSUPPORTED_SASL_MECHANISM
                    w.i32(1).string(self.sasl_mechanism)
                    resp = struct.pack(">i", corr) + bytes(w.buf)
                    conn.sendall(struct.pack(">i", len(resp)) + resp)
                    if not ok:
                        return
                    if mech == "PLAIN":
                        # raw (pre-KIP-152) token frame: \0user\0password
                        token = self._recv_token(conn)
                        parts = (token or b"").split(b"\x00")
                        if (len(parts) != 3
                                or parts[1].decode() != self.sasl[0]
                                or parts[2].decode() != self.sasl[1]):
                            return  # auth failure: close, like a real broker
                        conn.sendall(struct.pack(">i", 0))  # empty token
                    else:
                        if not self._scram_serve(conn, mech):
                            return
                    authed = True
                    continue
                body = self._dispatch(api_key, api_version, r, node)
                resp = struct.pack(">i", corr) + body
                conn.sendall(struct.pack(">i", len(resp)) + resp)
        except (OSError, Exception):
            pass
        finally:
            conn.close()

    @classmethod
    def _recv_token(cls, conn: socket.socket) -> Optional[bytes]:
        head = cls._recv(conn, 4)
        if head is None:
            return None
        return cls._recv(conn, struct.unpack(">i", head)[0])

    def _scram_serve(self, conn: socket.socket, mech: str) -> bool:
        """RFC 5802 server side over raw token frames: verify the client
        proof against StoredKey, return the server signature. False =
        auth failure (caller closes, like a real broker)."""
        import base64
        import hashlib
        import hmac as hmac_mod
        import os

        algo = mech.replace("SCRAM-SHA-", "sha")

        def hm(key: bytes, data: bytes) -> bytes:
            return hmac_mod.new(key, data, algo).digest()

        first = self._recv_token(conn)
        if first is None or not first.startswith(b"n,,"):
            return False
        first_bare = first[3:].decode()
        f = dict(kv.split("=", 1) for kv in first_bare.split(","))
        user = f["n"].replace("=2C", ",").replace("=3D", "=")
        if user != self.sasl[0]:
            return False
        salt, iterations = os.urandom(12), self.scram_iterations
        snonce = f["r"] + base64.b64encode(os.urandom(12)).decode()
        server_first = (f"r={snonce},s={base64.b64encode(salt).decode()},"
                        f"i={iterations}")
        conn.sendall(struct.pack(">i", len(server_first))
                     + server_first.encode())
        final = self._recv_token(conn)
        if final is None:
            return False
        ff = dict(kv.split("=", 1) for kv in final.decode().split(","))
        if ff.get("c") != "biws" or ff.get("r") != snonce or "p" not in ff:
            return False
        salted = hashlib.pbkdf2_hmac(
            algo, self.sasl[1].encode(), salt, iterations)
        stored_key = hashlib.new(algo, hm(salted, b"Client Key")).digest()
        final_wo = final.decode().rsplit(",p=", 1)[0]
        auth_msg = ",".join((first_bare, server_first, final_wo)).encode()
        signature = hm(stored_key, auth_msg)
        client_key = bytes(a ^ b for a, b in zip(
            base64.b64decode(ff["p"]), signature))
        if hashlib.new(algo, client_key).digest() != stored_key:
            return False  # wrong password
        v = base64.b64encode(hm(hm(salted, b"Server Key"), auth_msg))
        server_final = b"v=" + v
        conn.sendall(struct.pack(">i", len(server_final)) + server_final)
        return True

    @staticmethod
    def _recv(conn: socket.socket, n: int) -> Optional[bytes]:
        buf = bytearray()
        while len(buf) < n:
            c = conn.recv(n - len(buf))
            if not c:
                return None
            buf += c
        return bytes(buf)

    def close(self) -> None:
        self._running = False
        for sock in self._socks:
            try:
                sock.close()
            except OSError:
                pass

    # ---- state helpers -------------------------------------------------------

    def _ensure(self, topic: str) -> None:
        if topic not in self._topics:
            self._topics[topic] = self.partitions
            for p in range(self.partitions):
                self._logs[(topic, p)] = []

    def topic_size(self, topic: str) -> int:
        with self._lock:
            self._ensure(topic)
            return sum(len(self._logs[(topic, p)]) for p in range(self.partitions))

    # ---- api dispatch --------------------------------------------------------

    def _dispatch(self, api: int, version: int, r: Reader,
                  node: int = 0) -> bytes:
        if api == 18:
            return self._api_versions(r)
        if api == 3:
            return self._metadata(r)
        if api == 0:
            return self._produce(r, version, node)
        if api == 1:
            return self._fetch(r, version, node)
        if api == 2:
            return self._list_offsets(r, node)
        if api == 10:
            return self._find_coordinator(r, version)
        # Coordinator-owned RPCs: a node that is NOT the coordinator
        # answers NOT_COORDINATOR (16) in the API's error slot, like a
        # real broker after the coordinator moved.
        not_coord = node != self._coord_node
        if api == 8:
            return self._offset_commit(r, err_override=16 if not_coord else 0)
        if api == 9:
            return self._offset_fetch(r, err_override=16 if not_coord else 0)
        if api == 11:
            if not_coord:  # JoinGroup v0 error shape
                return bytes(Writer().i16(16).i32(-1).string("")
                             .string("").string("").i32(0).buf)
            return self._join_group(r)
        if api == 14:
            if not_coord:  # SyncGroup v0 error shape
                return bytes(Writer().i16(16).bytes_(b"").buf)
            return self._sync_group(r)
        if api == 12:
            if not_coord:
                return bytes(Writer().i16(16).buf)
            return self._heartbeat(r)
        if api == 13:
            if not_coord:
                return bytes(Writer().i16(16).buf)
            return self._leave_group(r)
        if api == 22:
            return self._init_producer_id(r) if not not_coord \
                else bytes(Writer().i32(0).i16(16).i64(-1).i16(-1).buf)
        if api == 24:
            return self._add_partitions_to_txn(r, err_override=16) \
                if not_coord else self._add_partitions_to_txn(r)
        if api == 25:
            return self._add_offsets_to_txn(r) if not not_coord \
                else bytes(Writer().i32(0).i16(16).buf)
        if api == 26:
            return self._end_txn(r) if not not_coord \
                else bytes(Writer().i32(0).i16(16).buf)
        if api == 28:
            return self._txn_offset_commit(r, err_override=16) \
                if not_coord else self._txn_offset_commit(r)
        raise RuntimeError(f"stub does not implement api {api}")


    def _api_versions(self, r: Reader) -> bytes:
        if self.api_versions == "closed":
            raise OSError("simulated pre-0.10 broker: hang up on probe")
        err = 0
        if self.api_versions is None:
            from storm_tpu_torch.connectors.kafka_protocol import PINNED_API_VERSIONS
            ranges = {key: (min(vs), max(vs))
                      for key, (_n, vs) in PINNED_API_VERSIONS.items()}
            ranges[18] = (0, 0)
        elif (isinstance(self.api_versions, tuple)
              and self.api_versions[0] == "error35"):
            # KIP-511-era behavior: the broker rejects the request version
            # with UNSUPPORTED_VERSION but still advertises what it serves.
            err, ranges = 35, self.api_versions[1]
        else:
            ranges = self.api_versions
        w = Writer()
        w.i16(err)
        w.i32(len(ranges))
        for key, (lo, hi) in sorted(ranges.items()):
            w.i16(key).i16(lo).i16(hi)
        return bytes(w.buf)

    def _metadata(self, r: Reader) -> bytes:
        n = r.i32()
        topics = [r.string() for _ in range(n)]
        with self._lock:
            for t in topics:
                self._ensure(t)
            listing = {t: self._topics[t] for t in (topics or self._topics)}
        w = Writer()
        w.i32(self.nodes)
        for node in range(self.nodes):
            w.i32(node).string("127.0.0.1").i32(self.ports[node])
        w.i32(len(listing))
        for t, nparts in listing.items():
            w.i16(0).string(t)
            w.i32(nparts)
            for p in range(nparts):
                leader = self._leaders.get((t, p), 0)
                w.i16(0).i32(p).i32(leader)
                w.i32(1).i32(leader)  # replicas
                w.i32(1).i32(leader)  # isr
        return bytes(w.buf)

    def _init_producer_id(self, r: Reader) -> bytes:
        txn_id = r.string()
        r.i32()  # timeout_ms
        with self._lock:
            if txn_id is None:
                pid, epoch = self._next_pid, 0
                self._next_pid += 1
            else:
                st = self._txns.get(txn_id)
                if st is None:
                    st = {"pid": self._next_pid, "epoch": 0,
                          "pending": [], "parts": set(),
                          "pending_offsets": {}, "offset_groups": set()}
                    self._next_pid += 1
                    self._txns[txn_id] = st
                else:
                    # fencing: bump epoch, drop any half-open transaction
                    # (log_transactional mode: the fenced txn's appended
                    # records become an implicit abort range + marker,
                    # like a real coordinator's bumpEpoch abort)
                    if self.log_transactional:
                        for (topic, part), first in \
                                st.get("first", {}).items():
                            self._aborted.setdefault(
                                (topic, part), []).append(
                                    (st["pid"], first,
                                     len(self._logs[(topic, part)])))
                            self._logs[(topic, part)].append(
                                ("c", 0, time.time(), st["pid"]))
                    st["epoch"] += 1
                    st["pending"] = []
                    st["parts"] = set()
                    st["pending_offsets"] = {}
                    st["offset_groups"] = set()
                    st["first"] = {}
                pid, epoch = st["pid"], st["epoch"]
        w = Writer()
        w.i32(0).i16(0).i64(pid).i16(epoch)  # throttle, err, pid, epoch
        return bytes(w.buf)

    def _txn_check(self, txn_id, pid, epoch):
        """error code for a txn RPC: 48 INVALID_TXN_STATE if unknown,
        47 INVALID_PRODUCER_EPOCH if fenced."""
        st = self._txns.get(txn_id)
        if st is None or st["pid"] != pid:
            return None, 48
        if st["epoch"] != epoch:
            return None, 47
        return st, 0

    def _add_partitions_to_txn(self, r: Reader,
                               err_override: int = 0) -> bytes:
        txn_id = r.string()
        pid = r.i64()
        epoch = r.i16()
        topics = []
        for _ in range(r.i32()):
            t = r.string()
            for _ in range(r.i32()):
                topics.append((t, r.i32()))
        w = Writer()
        w.i32(0)  # throttle
        if err_override:
            err = err_override
        else:
            with self._lock:
                st, err = self._txn_check(txn_id, pid, epoch)
                if not err:
                    st["parts"].update(topics)
        by_topic: Dict[str, List[int]] = {}
        for t, p in topics:
            by_topic.setdefault(t, []).append(p)
        w.i32(len(by_topic))
        for t, ps in by_topic.items():
            w.string(t)
            w.i32(len(ps))
            for p in ps:
                w.i32(p).i16(err)
        return bytes(w.buf)

    def _add_offsets_to_txn(self, r: Reader) -> bytes:
        """AddOffsetsToTxn v0: register a group with the transaction; the
        group's TxnOffsetCommit offsets then land atomically at EndTxn."""
        txn_id = r.string()
        pid = r.i64()
        epoch = r.i16()
        group = r.string()
        with self._lock:
            st, err = self._txn_check(txn_id, pid, epoch)
            if not err:
                st["offset_groups"].add(group)
        w = Writer()
        w.i32(0).i16(err)  # throttle, error
        return bytes(w.buf)

    def _txn_offset_commit(self, r: Reader, err_override: int = 0) -> bytes:
        """TxnOffsetCommit v0: stage offsets inside the open transaction —
        visible in OffsetFetch only after EndTxn(commit)."""
        txn_id = r.string()
        group = r.string()
        pid = r.i64()
        epoch = r.i16()
        staged: List[Tuple[str, int, int]] = []
        w = Writer()
        w.i32(0)  # throttle
        n_topics = r.i32()
        w.i32(n_topics)
        with self._lock:
            if err_override:
                st, err = None, err_override
            else:
                st, err = self._txn_check(txn_id, pid, epoch)
                if not err and group not in st["offset_groups"]:
                    err = 48  # group not registered via AddOffsetsToTxn
            for _ in range(n_topics):
                topic = r.string()
                w.string(topic)
                n_parts = r.i32()
                w.i32(n_parts)
                for _ in range(n_parts):
                    part = r.i32()
                    off = r.i64()
                    r.string()  # metadata
                    if not err:
                        staged.append((topic, part, off))
                    w.i32(part).i16(err)
            if not err:
                for topic, part, off in staged:
                    st["pending_offsets"][(group, topic, part)] = off
        return bytes(w.buf)

    def _end_txn(self, r: Reader) -> bytes:
        txn_id = r.string()
        pid = r.i64()
        epoch = r.i16()
        commit = bool(r.i8())
        with self._lock:
            st, err = self._txn_check(txn_id, pid, epoch)
            if not err:
                if self.log_transactional:
                    # real-broker semantics: a control marker per touched
                    # partition, occupying one offset; aborts register the
                    # (pid, first_offset) range for Fetch v4 filtering
                    for (topic, part) in sorted(st["parts"]):
                        self._ensure(topic)
                        log = self._logs[(topic, part)]
                        first = st.get("first", {}).get((topic, part))
                        if not commit and first is not None:
                            self._aborted.setdefault(
                                (topic, part), []).append(
                                    (pid, first, len(log)))
                        log.append(("c", 1 if commit else 0,
                                    time.time(), pid))
                    st["first"] = {}
                elif commit:
                    for topic, part, key, value in st["pending"]:
                        self._ensure(topic)
                        self._logs[(topic, part)].append(
                            (key, value, time.time()))
                if commit:
                    # offsets land atomically with the records (KIP-98:
                    # the commit marker covers __consumer_offsets too)
                    for (group, topic, part), off in \
                            st["pending_offsets"].items():
                        self._commits[(group, topic, part)] = off
                st["pending"] = []
                st["parts"] = set()
                st["pending_offsets"] = {}
                st["offset_groups"] = set()
        w = Writer()
        w.i32(0).i16(err)
        return bytes(w.buf)

    @staticmethod
    def _batch_producer_fields(data: bytes):
        """(producer_id, base_sequence, record_count) of a magic-2 batch,
        or None for v0/v1 message sets / non-idempotent batches."""
        # baseOffset(8) len(4) leaderEpoch(4) magic(1) crc(4) attrs(2)
        # lastOffsetDelta(4) baseTs(8) maxTs(8) pid(8) epoch(2) baseSeq(4)
        # count(4)
        if len(data) < 61 or data[16] != 2:
            return None
        prod_id, = struct.unpack(">q", data[43:51])
        if prod_id < 0:
            return None
        epoch, = struct.unpack(">h", data[51:53])
        base_seq, = struct.unpack(">i", data[53:57])
        count, = struct.unpack(">i", data[57:61])
        return prod_id, base_seq, count, epoch

    def _produce(self, r: Reader, version: int = 2, node: int = 0) -> bytes:
        txn_id = r.string() if version >= 3 else None
        r.i16()  # acks
        r.i32()  # timeout
        w = Writer()
        n_topics = r.i32()
        w.i32(n_topics)
        for _ in range(n_topics):
            topic = r.string()
            w.string(topic)
            n_parts = r.i32()
            w.i32(n_parts)
            for _ in range(n_parts):
                pid = r.i32()
                data = r.bytes_() or b""
                if self._leaders.get((topic, pid), 0) != node:
                    w.i32(pid).i16(6).i64(-1).i64(-1)  # NOT_LEADER
                    continue
                prod = self._batch_producer_fields(data)
                err = 0
                with self._lock:
                    self._ensure(topic)
                    log = self._logs[(topic, pid)]
                    base = len(log)
                    if txn_id is not None:
                        # transactional: buffer until EndTxn(commit) — or,
                        # in log_transactional mode, append immediately
                        # tagged with the producer id (real-broker
                        # semantics; visibility is the CONSUMER's job)
                        st = self._txns.get(txn_id)
                        p_pid, _, _, p_epoch = prod if prod else (
                            -1, -1, -1, -1)
                        if st is None or st["pid"] != p_pid:
                            err = 48  # INVALID_TXN_STATE
                        elif st["epoch"] != p_epoch:
                            err = 47  # INVALID_PRODUCER_EPOCH (fenced)
                        elif (topic, pid) not in st["parts"]:
                            err = 48  # partition not added to the txn
                        elif self.log_transactional:
                            st.setdefault("first", {}).setdefault(
                                (topic, pid), len(log))
                            for rec in decode_message_set(topic, pid, data):
                                log.append(("d", rec.key, rec.value,
                                            time.time(), p_pid))
                        else:
                            for rec in decode_message_set(topic, pid, data):
                                st["pending"].append(
                                    (topic, pid, rec.key, rec.value))
                        data = b""
                    elif prod is not None:
                        prod_id, base_seq, count, _ = prod
                        key = (prod_id, topic, pid)
                        last = self._pid_state.get(key)
                        expected = 0 if last is None else last[0] + last[1]
                        if last is not None and base_seq == last[0]:
                            # exact duplicate of the last batch: already
                            # appended; ack with the original base offset
                            # (or, in duplicate_error mode, answer the
                            # explicit DUPLICATE_SEQUENCE_NUMBER code some
                            # 0.11-era paths return — the client must
                            # treat BOTH as success)
                            if self.duplicate_error:
                                err = 46
                            base = last[2]
                            data = b""
                        elif base_seq != expected:
                            err = 45  # OUT_OF_ORDER_SEQUENCE_NUMBER
                            data = b""
                        else:
                            self._pid_state[key] = (base_seq, count, base)
                    if data:
                        for rec in decode_message_set(topic, pid, data):
                            if self.log_transactional:
                                # uniform tagged entries in this mode
                                # (pid -1 = non-transactional data)
                                log.append(("d", rec.key, rec.value,
                                            time.time(), -1))
                            else:
                                log.append((rec.key, rec.value, time.time()))
                w.i32(pid).i16(err).i64(base).i64(-1)
        w.i32(0)  # throttle
        return bytes(w.buf)

    @staticmethod
    def _encode_tagged(chunk, offset: int) -> bytes:
        """log_transactional entries -> record batches: consecutive data
        records from one producer share a batch; control markers get their
        own control batch (exactly the shapes a real broker serves)."""
        from storm_tpu_torch.connectors.kafka_protocol import (
            encode_control_batch, encode_record_batch)

        out = bytearray()
        i = 0
        now_ms = int(time.time() * 1e3)
        while i < len(chunk):
            entry = chunk[i]
            if entry[0] == "c":
                out += encode_control_batch(entry[1], (entry[3], 0),
                                            offset + i, now_ms)
                i += 1
                continue
            run = [entry]
            while (i + len(run) < len(chunk)
                   and chunk[i + len(run)][0] == "d"
                   and chunk[i + len(run)][4] == entry[4]):
                run.append(chunk[i + len(run)])
            prod_id = entry[4]
            out += encode_record_batch(
                [(e[1], e[2]) for e in run], now_ms,
                base_offset=offset + i,
                producer=(prod_id, 0, 0) if prod_id >= 0 else None,
                transactional=prod_id >= 0)
            i += len(run)
        return bytes(out)

    def _fetch(self, r: Reader, version: int = 2, node: int = 0) -> bytes:
        r.i32()  # replica
        r.i32()  # max wait
        r.i32()  # min bytes
        if version >= 3:
            r.i32()  # response-level max_bytes
        isolation = 0
        if version >= 4:
            isolation = r.i8()
        w = Writer()
        w.i32(0)  # throttle
        n_topics = r.i32()
        w.i32(n_topics)
        for _ in range(n_topics):
            topic = r.string()
            w.string(topic)
            n_parts = r.i32()
            w.i32(n_parts)
            for _ in range(n_parts):
                pid = r.i32()
                offset = r.i64()
                r.i32()  # max bytes
                if self._leaders.get((topic, pid), 0) != node:
                    w.i32(pid).i16(6).i64(-1)  # NOT_LEADER
                    if version >= 4:
                        w.i64(-1).i32(0)
                    w.bytes_(b"")
                    continue
                with self._lock:
                    self._ensure(topic)
                    log = self._logs[(topic, pid)]
                    hw = len(log)
                    # LSO = first offset of any OPEN transaction (real
                    # brokers never serve read_committed past it)
                    lso = hw
                    for st in self._txns.values():
                        first = st.get("first", {}).get((topic, pid))
                        if first is not None:
                            lso = min(lso, first)
                    end = min(offset + 256, lso) if isolation == 1 else \
                        offset + 256
                    chunk = log[offset:end]
                    aborted = [
                        (a_pid, first)
                        for a_pid, first, marker in
                        self._aborted.get((topic, pid), [])
                        if marker >= offset
                    ]
                tagged = bool(chunk) and len(chunk[0]) >= 4
                if tagged:
                    msgset = self._encode_tagged(chunk, offset)
                elif self.serve_batches and chunk:
                    from storm_tpu_torch.connectors.kafka_protocol import (
                        encode_record_batch,
                    )

                    msgset = encode_record_batch(
                        [(k, v) for k, v, _ in chunk],
                        int(time.time() * 1e3),
                        base_offset=offset,
                    )
                else:
                    msgset = encode_message_set(
                        [(k, v) for k, v, _ in chunk],
                        int(time.time() * 1e3),
                        offsets=list(range(offset, offset + len(chunk))),
                    )
                w.i32(pid).i16(0).i64(hw)
                if version >= 4:
                    w.i64(lso)  # last stable offset
                    w.i32(len(aborted))
                    for a_pid, first in aborted:
                        w.i64(a_pid).i64(first)
                w.bytes_(msgset)
        return bytes(w.buf)

    def _list_offsets(self, r: Reader, node: int = 0) -> bytes:
        r.i32()  # replica
        w = Writer()
        n_topics = r.i32()
        w.i32(n_topics)
        for _ in range(n_topics):
            topic = r.string()
            w.string(topic)
            n_parts = r.i32()
            w.i32(n_parts)
            for _ in range(n_parts):
                pid = r.i32()
                ts = r.i64()
                r.i32()  # max offsets
                if self._leaders.get((topic, pid), 0) != node:
                    w.i32(pid).i16(6).i32(0)  # NOT_LEADER, no offsets
                    continue
                with self._lock:
                    self._ensure(topic)
                    end = len(self._logs[(topic, pid)])
                off = 0 if ts == -2 else end
                w.i32(pid).i16(0)
                w.i32(1).i64(off)
        return bytes(w.buf)

    def _find_coordinator(self, r: Reader, version: int = 0) -> bytes:
        r.string()  # group / transactional id
        w = Writer()
        if version >= 1:
            r.i8()  # coordinator_type (group=0 / txn=1 — same node here)
            w.i32(0)  # throttle
            w.i16(0)  # error
            w.string(None)  # error_message
        else:
            w.i16(0)
        coord = self._coord_node
        w.i32(coord).string("127.0.0.1").i32(self.ports[coord])
        return bytes(w.buf)

    def _offset_commit(self, r: Reader, err_override: int = 0) -> bytes:
        group = r.string()
        r.i32()  # generation
        r.string()  # member
        r.i64()  # retention
        w = Writer()
        n_topics = r.i32()
        w.i32(n_topics)
        for _ in range(n_topics):
            topic = r.string()
            w.string(topic)
            n_parts = r.i32()
            w.i32(n_parts)
            for _ in range(n_parts):
                pid = r.i32()
                off = r.i64()
                r.string()  # metadata
                if not err_override:
                    with self._lock:
                        self._commits[(group, topic, pid)] = off
                w.i32(pid).i16(err_override)
        return bytes(w.buf)

    def _offset_fetch(self, r: Reader, err_override: int = 0) -> bytes:
        group = r.string()
        w = Writer()
        n_topics = r.i32()
        w.i32(n_topics)
        for _ in range(n_topics):
            topic = r.string()
            w.string(topic)
            n_parts = r.i32()
            w.i32(n_parts)
            for _ in range(n_parts):
                pid = r.i32()
                if err_override:
                    w.i32(pid).i64(-1).string(None).i16(err_override)
                    continue
                with self._lock:
                    off = self._commits.get((group, topic, pid), -1)
                w.i32(pid).i64(off).string(None).i16(0)
        return bytes(w.buf)

    # ---- consumer-group coordination (JoinGroup/SyncGroup/Heartbeat/Leave) ---
    # v0 request formats; "immediate join" semantics: a join bumps the
    # generation and existing members discover via REBALANCE_IN_PROGRESS
    # heartbeats, then rejoin — the real protocol flow without the broker's
    # join-window timers.

    _REBALANCE_IN_PROGRESS = 27
    _ILLEGAL_GENERATION = 22
    _UNKNOWN_MEMBER = 25

    def _group(self, gid: str) -> dict:
        g = self._groups.setdefault(gid, {
            "generation": 0, "members": {}, "leader": None,
            "assignments": {}, "stable": set(), "deadlines": {},
            "sessions": {},
        })
        # expire members that vanished without leave(): a dead member must
        # not wedge the group in permanent rebalance
        now = time.time()
        dead = [m for m, dl in g.get("deadlines", {}).items() if dl < now]
        for m in dead:
            g["members"].pop(m, None)
            g["stable"].discard(m)
            g["assignments"].pop(m, None)
            g["deadlines"].pop(m, None)
            g["sessions"].pop(m, None)
            if g["leader"] == m:
                g["leader"] = next(iter(g["members"]), None)
        if dead and g["members"]:
            g["generation"] += 1
            g["stable"] = set()
            g["assignments"] = {}
        return g

    def _join_group(self, r: Reader) -> bytes:
        gid = r.string()
        session_ms = r.i32()
        member = r.string() or ""
        r.string()  # protocol_type
        protos = []
        for _ in range(r.i32()):
            protos.append((r.string(), r.bytes_() or b""))
        with self._lock:
            g = self._group(gid)
            if not member:
                self._member_seq += 1
                member = f"member-{self._member_seq}"
            fresh = member not in g["members"]
            was_stable = g["members"] and g["stable"] == set(g["members"])
            g["members"][member] = protos[0][1] if protos else b""
            if fresh or was_stable:
                # a NEW member, or a stable member voluntarily rejoining,
                # starts a rebalance; rejoins DURING a rebalance just count
                # toward completion (bumping again would livelock)
                g["generation"] += 1
                g["stable"] = {member}
                g["assignments"] = {}
            else:
                g["stable"].add(member)
            g["sessions"][member] = session_ms / 1e3
            g["deadlines"][member] = time.time() + session_ms / 1e3
            if g["leader"] not in g["members"]:
                g["leader"] = member
            leader = g["leader"]
            gen = g["generation"]
            members = dict(g["members"]) if member == leader else {}
            proto_name = protos[0][0] if protos else "range"
        w = Writer()
        w.i16(0).i32(gen).string(proto_name).string(leader).string(member)
        w.i32(len(members))
        for mid, meta in members.items():
            w.string(mid)
            w.bytes_(meta)
        return bytes(w.buf)

    def _sync_group(self, r: Reader) -> bytes:
        gid = r.string()
        gen = r.i32()
        member = r.string()
        assignments = {}
        for _ in range(r.i32()):
            mid = r.string()
            assignments[mid] = r.bytes_() or b""
        w = Writer()
        with self._lock:
            g = self._group(gid)
            if member not in g["members"]:
                w.i16(self._UNKNOWN_MEMBER).bytes_(b"")
                return bytes(w.buf)
            if gen != g["generation"]:
                w.i16(self._ILLEGAL_GENERATION).bytes_(b"")
                return bytes(w.buf)
            if assignments:  # the leader distributes
                g["assignments"] = assignments
            g["stable"].add(member)
            mine = g["assignments"].get(member)
        if mine is None:
            w.i16(self._REBALANCE_IN_PROGRESS).bytes_(b"")
        else:
            w.i16(0).bytes_(mine)
        return bytes(w.buf)

    def _heartbeat(self, r: Reader) -> bytes:
        gid = r.string()
        gen = r.i32()
        member = r.string()
        w = Writer()
        with self._lock:
            g = self._group(gid)
            if member not in g["members"]:
                w.i16(self._UNKNOWN_MEMBER)
            else:
                session_s = g["sessions"].get(member)
                if session_s is not None:
                    # a heartbeat renews the member's session window
                    g["deadlines"][member] = time.time() + session_s
                if gen != g["generation"] or g["stable"] != set(g["members"]):
                    w.i16(self._REBALANCE_IN_PROGRESS)
                else:
                    w.i16(0)
        return bytes(w.buf)

    def _leave_group(self, r: Reader) -> bytes:
        gid = r.string()
        member = r.string()
        with self._lock:
            g = self._group(gid)
            g["members"].pop(member, None)
            g["stable"].discard(member)
            g["assignments"].pop(member, None)
            if g["members"]:
                g["generation"] += 1
                g["stable"] = set()
                g["assignments"] = {}
                if g["leader"] == member:
                    g["leader"] = next(iter(g["members"]))
            else:
                g["leader"] = None
        w = Writer()
        w.i16(0)
        return bytes(w.buf)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="storm_tpu_torch.connectors.kafka_stub")
    ap.add_argument("--port", type=int, default=0)
    ap.add_argument("--partitions", type=int, default=2)
    args = ap.parse_args(argv)
    broker = KafkaStubBroker(partitions=args.partitions, port=args.port)
    stop = threading.Event()
    for sig in (signal.SIGTERM, signal.SIGINT):
        signal.signal(sig, lambda *_: stop.set())
    print(json.dumps({"ready": True, "port": broker.port}), flush=True)
    stop.wait()
    broker.close()
    return 0


if __name__ == "__main__":
    sys.exit(main())
