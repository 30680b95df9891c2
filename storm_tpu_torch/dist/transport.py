"""Wire envelopes and the RPC plumbing of the distributed runtime, ported
from ``storm_tpu/dist/transport.py``, over the standard library's TCP
sockets in place of gRPC.

Three methods, as on storm_tpu's ``storm_tpu.Dist`` service:

- ``Deliver``: a batch of tuples for components hosted on the receiving
  worker. The call returns only after every tuple is in its executor's
  inbox, so bounded-inbox backpressure crosses processes.
- ``Ack``: a batch of ledger ops (xor / anchor / ack-edge / fail) routed
  to the worker whose spout owns the tuple tree (the id's top byte,
  ``tuples.owner_of``).
- ``Control``: controller -> worker requests (submit, start, metrics,
  drain, kill, ping, ...), JSON in, JSON out.

Their payloads are storm_tpu's, byte for byte: the binary frames of
:mod:`.wire` (0xB7 deliveries, 0xB8 acks, 0xB9 shared-memory headers) or
the JSON envelope, told apart by the first byte (a JSON array starts with
``[``); ids travel as decimal strings in JSON (past 2^53 a JSON number
loses them); ``root_ts``, a ``perf_counter`` value of the sender's
process, crosses as an age and is rebased on arrival, so e2e latency
holds across processes.

The call itself (gRPC's part in storm_tpu) is a length-prefixed frame on
a persistent connection, little-endian::

    request   u32 length | u8 method id | f64 timeout_s (0 = none)
              | u16 + token | u16 + traceparent | payload
    response  u32 length | u8 status | u32 + details (utf-8) | payload

with gRPC's contract: a refused connection, or a failure before the
whole request was written, is ``UNAVAILABLE`` (the server runs a handler
only on a complete request, so a resend cannot deliver twice: the
pre-first-byte guarantee ``Deliver``'s narrow retry relies on); a
deadline that passes is ``DEADLINE_EXCEEDED``; a connection lost after
the request left is ``ABORTED`` (the handler may have run, so a
``Deliver`` is not sent again; Control and Ack retry it); an exception in
a handler is ``UNKNOWN``; a token mismatch is ``UNAUTHENTICATED``. A
pooled connection the server closed is dropped before reuse.

A server serves one service, as a gRPC server with one handler does:
:data:`SERVICES` gives each service's methods their id bytes, the Dist
service's 1-3 and the inference service's (``storm_tpu.Inference``,
:mod:`storm_tpu_torch.serve.worker`) 0x11-0x13. A call to a method its
server's service lacks, or to an id no service has, is
``UNIMPLEMENTED``, as a gRPC call to a path the server does not route.
"""

from __future__ import annotations

import hmac
import json
import logging
import select
import socket
import struct
import threading
import time
from typing import Any, Callable, Dict, Iterable, List, Optional, Tuple as Tup

from storm_tpu_torch.config import CONTROL_TOKEN_ENV as TOKEN_ENV
from storm_tpu_torch.config import env_control_token as _env_token
from storm_tpu_torch.dist import wire
from storm_tpu_torch.dist.wire import WIRE_VERSION
from storm_tpu_torch.obs import copyledger as _copyledger
from storm_tpu_torch.resilience.retry import (RETRYABLE_BROAD, RETRYABLE_NARROW,
                                              RetryPolicy, RpcError, StatusCode,
                                              _rpc_code, is_fatal_rpc)
from storm_tpu_torch.runtime.tracing import TraceContext
from storm_tpu_torch.runtime.tuples import Tuple

__all__ = [
    "DistHandler", "TOKEN_ENV", "TransportServer", "WIRE_VERSION", "WorkerClient",
    "decode_acks", "decode_deliveries", "decode_tuple", "encode_acks",
    "encode_deliveries", "encode_tuple",
]

log = logging.getLogger("storm_tpu_torch.dist.transport")

#: Each service's method table: name -> the method id byte of a request.
SERVICES = {
    "storm_tpu.Dist": {"Deliver": 1, "Ack": 2, "Control": 3},
    "storm_tpu.Inference": {"Predict": 0x11, "PredictJson": 0x12, "Info": 0x13},
}
SERVICE = "storm_tpu.Dist"
_BY_ID = {i: (svc, m) for svc, table in SERVICES.items() for m, i in table.items()}

#: Largest request or response a peer accepts (gRPC's limit in storm_tpu).
MAX_MESSAGE_BYTES = 64 * 1024 * 1024

_TOKEN_MD_KEY = "x-storm-tpu-token"

_BIN_DELIVER = bytes((wire.DELIVERY_MAGIC,))
_BIN_ACK = bytes((wire.ACK_MAGIC,))
_BIN_SHM = bytes((wire.SHM_MAGIC,))

_u32 = struct.Struct("<I")
_req_fix = struct.Struct("<Bd")
_resp_fix = struct.Struct("<BI")

# Receiver half of the shared-memory lane: one process-wide LRU of
# attached segments (shm.SegmentCache), built lazily so importing this
# module never touches /dev/shm.
_segments = None


def _segment_cache():
    global _segments
    if _segments is None:
        from storm_tpu_torch.dist import shm as _shm_lane

        _segments = _shm_lane.SegmentCache()
    return _segments


# ---- tuple envelope ----------------------------------------------------------


def encode_tuple(t: Tuple, now: float) -> list:
    return [
        list(t.values),
        list(t.fields),
        t.stream,
        t.source_component,
        t.source_task,
        str(t.edge_id),
        [str(a) for a in t.anchors],
        now - t.root_ts,  # age, rebased on arrival
        # Source-log provenance (exactly-once offsets): sequential
        # positions, far below 2^53, so plain JSON ints are lossless.
        [[tp, p, off] for tp, p, off in t.origins],
        # W3C traceparent (None when unsampled), a trailing element.
        t.trace.traceparent() if t.trace is not None else None,
    ]


def decode_tuple(enc: list, now: float) -> Tuple:
    # Tolerant unpack: an 8-element envelope (no origins, no trace)
    # decodes with empty origins; unknown trailing elements are ignored.
    values, fields, stream, src, src_task, edge, anchors, age = enc[:8]
    origins = enc[8] if len(enc) > 8 else []
    tp_hdr = enc[9] if len(enc) > 9 else None
    return Tuple(
        values=values,
        fields=tuple(fields),
        source_component=src,
        source_task=src_task,
        stream=stream,
        edge_id=int(edge),
        anchors=frozenset(int(a) for a in anchors),
        root_ts=now - age,
        origins=frozenset((tp, p, off) for tp, p, off in origins),
        # A malformed header degrades to "unsampled", not a failed call.
        trace=TraceContext.from_traceparent(tp_hdr) if tp_hdr else None,
    )


def encode_deliveries(deliveries: Iterable[Tup[str, int, Tuple]]) -> bytes:
    """(component_id, task_index, tuple) triples as the JSON envelope."""
    now = time.perf_counter()
    if not isinstance(deliveries, (list, tuple)):
        deliveries = list(deliveries)
    enc = encode_tuple
    out: list = [None] * len(deliveries)
    try:
        for j, (c, i, t) in enumerate(deliveries):
            out[j] = [c, i, enc(t, now)]
        payload = json.dumps(out).encode("utf-8")
        # The JSON wire serializes every value into the envelope and then
        # encodes the whole string: two full-payload passes.
        _copyledger.record("wire_encode", len(payload), copies=2,
                           allocs=2, records=len(deliveries))
        return payload
    except TypeError as e:
        raise TypeError(
            "tuple values must be JSON-serializable to cross the JSON "
            "inter-worker wire; spout scheme='raw' (bytes values) needs "
            "the binary wire (topology.wire_format='binary', the default)"
            " or topology.spout_scheme='string'"
        ) from e


def decode_deliveries(payload) -> List[Tup[str, int, Tuple]]:
    """A Deliver payload, its format told by the first byte: binary frames
    (0xB7) and shared-memory headers (0xB9) go to :mod:`.wire`, a JSON
    array to the envelope above."""
    head = bytes(payload[:1])
    if head == _BIN_DELIVER:
        return wire.decode_deliveries(payload, time.perf_counter())
    if head == _BIN_SHM:
        # The payload names a segment on THIS host; the body decodes as
        # views over the mapping. Attach or range failures are WireErrors.
        name, offset, length = wire.decode_shm_header(payload)
        try:
            body = _segment_cache().view(name, offset, length)
        except (OSError, ValueError, RuntimeError) as e:
            raise wire.WireError(
                f"shm segment {name!r} unavailable: {e}") from e
        return wire.decode_deliveries_view(body, time.perf_counter())
    now = time.perf_counter()
    out = [(c, i, decode_tuple(enc, now)) for c, i, enc in json.loads(bytes(payload))]
    # json.loads materializes every value: one full-payload pass.
    _copyledger.record("wire_decode", len(payload), copies=1,
                       allocs=len(out), records=len(out))
    return out


def encode_acks(ops: Iterable[Tup[str, int, int]]) -> bytes:
    """('xor'|'anc'|'ake'|'fail', root_id, edge_id) triples (JSON wire)."""
    return json.dumps([[op, str(r), str(e)] for op, r, e in ops]).encode("utf-8")


def decode_acks(payload) -> List[Tup[str, int, int]]:
    """An Ack payload: binary (0xB8) or JSON."""
    if bytes(payload[:1]) == _BIN_ACK:
        return wire.decode_acks(payload)
    return [(op, int(r), int(e)) for op, r, e in json.loads(bytes(payload))]


# ---- framing -----------------------------------------------------------------


def _recv_exact(sock: socket.socket, n: int) -> bytearray:
    """Exactly ``n`` bytes (a socket read may return fewer); EOF raises
    ``ConnectionResetError``."""
    buf = bytearray(n)
    view = memoryview(buf)
    got = 0
    while got < n:
        k = sock.recv_into(view[got:], n - got)
        if k == 0:
            raise ConnectionResetError("connection closed by peer")
        got += k
    return buf


def _vstr(s: str) -> bytes:
    b = s.encode("utf-8")
    if len(b) > 0xFFFF:
        raise ValueError("header string longer than 65535 bytes")
    return struct.pack("<H", len(b)) + b


def _read_vstr(buf, pos: int) -> Tup[str, int]:
    (n,) = struct.unpack_from("<H", buf, pos)
    pos += 2
    return bytes(buf[pos:pos + n]).decode("utf-8", "surrogateescape"), pos + n


def _send_parts(sock: socket.socket, parts: List) -> None:
    for p in parts:
        sock.sendall(p)


def _method_id(service: str, method: str) -> int:
    if method.startswith("/"):
        service, _, method = method[1:].partition("/")
    try:
        return SERVICES[service][method]
    except KeyError:
        raise ValueError(f"no method /{service}/{method} in {sorted(SERVICES)}") from None


def _split_target(target: str) -> Tup[str, int]:
    host, _, port = target.rpartition(":")
    return host.strip("[]") or "127.0.0.1", int(port)


# ---- client ------------------------------------------------------------------


class _Channel:
    """Persistent connections to one server, pooled: a call takes an idle
    one (or connects), and gives it back after a complete response. A
    method is named in ``service``'s table, or by its full path
    ``/<service>/<method>`` in any service's."""

    def __init__(self, target: str, service: str = SERVICE) -> None:
        self.target = target
        self.service = service
        self._addr = _split_target(target)
        self._idle: List[socket.socket] = []
        self._lock = threading.Lock()
        self._closed = False

    def _take(self, timeout: float) -> socket.socket:
        while True:
            with self._lock:
                sock = self._idle.pop() if self._idle else None
            if sock is None:
                break
            # A pooled connection the server closed (a worker that died
            # or restarted) reads as EOF: drop it before writing to it.
            try:
                readable, _, _ = select.select([sock], [], [], 0)
            except (OSError, ValueError):
                readable = [sock]
            if not readable:
                return sock
            sock.close()
        try:
            sock = socket.create_connection(self._addr, timeout=max(timeout, 0.001))
        except socket.timeout as e:
            raise RpcError(StatusCode.UNAVAILABLE,
                           f"connect to {self.target} timed out") from e
        except OSError as e:
            raise RpcError(StatusCode.UNAVAILABLE,
                           f"connect to {self.target} failed: {e}") from e
        sock.setsockopt(socket.IPPROTO_TCP, socket.TCP_NODELAY, 1)
        return sock

    def _give_back(self, sock: socket.socket) -> None:
        with self._lock:
            if not self._closed:
                self._idle.append(sock)
                return
        sock.close()

    def call(self, method: str, payload, timeout: Optional[float],
             metadata=None) -> bytes:
        md = dict(metadata or ())
        token = md.get(_TOKEN_MD_KEY, "") or ""
        tp = md.get("traceparent", "") or ""
        timeout = 3600.0 if timeout is None else max(float(timeout), 0.001)
        deadline = time.monotonic() + timeout
        nbytes = payload.nbytes if isinstance(payload, memoryview) else len(payload)
        head = (_req_fix.pack(_method_id(self.service, method), timeout) + _vstr(token)
                + _vstr(tp))
        if len(head) + nbytes > MAX_MESSAGE_BYTES:
            raise RpcError(StatusCode.RESOURCE_EXHAUSTED,
                           f"request of {len(head) + nbytes} bytes exceeds "
                           f"{MAX_MESSAGE_BYTES}")
        sock = self._take(timeout)
        try:
            sock.settimeout(max(deadline - time.monotonic(), 0.001))
            try:
                _send_parts(sock, [_u32.pack(len(head) + nbytes), head, payload])
            except socket.timeout as e:
                raise RpcError(StatusCode.DEADLINE_EXCEEDED,
                               f"{method} to {self.target}: deadline passed "
                               "while sending") from e
            except OSError as e:
                # The request is incomplete: the server ran no handler.
                raise RpcError(StatusCode.UNAVAILABLE,
                               f"{method} to {self.target}: send failed: {e}") from e
            try:
                sock.settimeout(max(deadline - time.monotonic(), 0.001))
                (n,) = _u32.unpack(_recv_exact(sock, 4))
                if n > MAX_MESSAGE_BYTES:
                    raise RpcError(StatusCode.RESOURCE_EXHAUSTED,
                                   f"response of {n} bytes exceeds {MAX_MESSAGE_BYTES}")
                body = _recv_exact(sock, n)
            except socket.timeout as e:
                raise RpcError(StatusCode.DEADLINE_EXCEEDED,
                               f"{method} to {self.target}: deadline exceeded") from e
            except OSError as e:
                raise RpcError(StatusCode.ABORTED,
                               f"{method} to {self.target}: connection lost after "
                               f"the request was sent: {e}") from e
        except BaseException:
            sock.close()
            raise
        self._give_back(sock)
        status, dlen = _resp_fix.unpack_from(body, 0)
        pos = _resp_fix.size
        details = bytes(body[pos:pos + dlen]).decode("utf-8", "replace")
        if status != StatusCode.OK.value:
            try:
                code = StatusCode(status)
            except ValueError:
                code = StatusCode.UNKNOWN
            raise RpcError(code, details)
        return bytes(body[pos + dlen:])

    def close(self) -> None:
        with self._lock:
            self._closed = True
            idle, self._idle = self._idle, []
        for s in idle:
            s.close()


class WorkerClient:
    """Connection to one worker's Dist service. ``token=None`` reads
    STORM_TPU_CONTROL_TOKEN (the controller's export); a non-empty token
    rides every call.

    Calls ride a deadline-budgeted retry policy
    (:class:`storm_tpu_torch.resilience.RetryPolicy`): Control and Ack
    retry the broad transient set, Deliver UNAVAILABLE only (a Deliver
    that timed out may already be enqueued; it is left to the ledger's
    timeout replay). Fatal codes never retry. ``retry=None`` builds the
    default policy; an ``attempts=1`` policy makes calls one-shot."""

    def __init__(self, target: str, token: Optional[str] = None,
                 retry: Optional[RetryPolicy] = None) -> None:
        self.target = target
        if token is None:
            token = _env_token()
        self._md = ((_TOKEN_MD_KEY, token),) if token else None
        self._channel = _Channel(target)
        self.retry = RetryPolicy() if retry is None else retry

    def _call(self, method: str, payload, timeout, metadata=None) -> bytes:
        return self._channel.call(method, payload, timeout, metadata)

    def deliver(self, payload, timeout: float = 60.0,
                traceparent: Optional[str] = None) -> None:
        """``traceparent`` (the batch's first sampled tuple's) rides the
        request header, beside the frames' own per-tuple contexts."""
        md = self._md or ()
        if traceparent:
            md = md + (("traceparent", traceparent),)
        self.retry.call_sync(
            lambda t: self._call("Deliver", payload, t, md),
            op_timeout=timeout, codes=RETRYABLE_NARROW)

    def ack(self, payload, timeout: float = 60.0) -> None:
        self.retry.call_sync(
            lambda t: self._call("Ack", payload, t, self._md),
            op_timeout=timeout, codes=RETRYABLE_BROAD)

    def control(self, cmd: str, timeout: float = 120.0, **kwargs: Any) -> Dict:
        req = json.dumps({"cmd": cmd, **kwargs}).encode("utf-8")
        resp = json.loads(self.retry.call_sync(
            lambda t: self._call("Control", req, t, self._md),
            op_timeout=timeout, codes=RETRYABLE_BROAD))
        if resp.get("error"):
            raise RuntimeError(f"{self.target} {cmd}: {resp['error']}")
        return resp

    def probe(self, cmd: str = "ping", timeout: float = 3.0,
              **kwargs: Any) -> Dict:
        """One control call with no retry: a liveness check must answer
        "is it there now", not wait out the broad policy's backoff."""
        req = json.dumps({"cmd": cmd, **kwargs}).encode("utf-8")
        resp = json.loads(self._call("Control", req, timeout, self._md))
        if resp.get("error"):
            raise RuntimeError(f"{self.target} {cmd}: {resp['error']}")
        return resp

    def wait_ready(self, timeout: float = 30.0) -> None:
        """Ping until the worker answers. A worker that is up and refusing
        us (a wrong token: UNAUTHENTICATED) never becomes ready, so that
        fails at once; only connection-shaped failures keep polling."""
        deadline = time.monotonic() + timeout
        while True:
            try:
                resp = self.probe("ping", timeout=2.0)
                return resp
            except Exception as e:
                if is_fatal_rpc(e):
                    raise RuntimeError(
                        f"worker {self.target} rejected the handshake "
                        f"({_rpc_code(e)}): check the control token / "
                        "version skew") from e
                if time.monotonic() > deadline:
                    raise TimeoutError(f"worker {self.target} never became ready") from e
                time.sleep(0.1)

    def close(self) -> None:
        self._channel.close()


# ---- server ------------------------------------------------------------------


class _Abort(Exception):
    def __init__(self, code: StatusCode, details: str) -> None:
        super().__init__(details)
        self.code = code
        self.details = details


class ServerContext:
    """What a handler learns of its call: the header's metadata, the
    caller's address and the time left; ``abort`` ends the call with a
    status, as a gRPC context's does."""

    def __init__(self, metadata: Tup, peer: str, deadline: Optional[float]) -> None:
        self._md = metadata
        self._peer = peer
        self._deadline = deadline

    def invocation_metadata(self) -> Tup:
        return self._md

    def peer(self) -> str:
        return self._peer

    def time_remaining(self) -> Optional[float]:
        if self._deadline is None:
            return None
        return max(self._deadline - time.monotonic(), 0.0)

    def abort(self, code: StatusCode, details: str) -> None:
        raise _Abort(code, details)


class DistHandler:
    """Routes the Dist service's three methods to a worker's callbacks
    ``fn(request, context) -> bytes``.

    ``token=None`` reads STORM_TPU_CONTROL_TOKEN (exported by the spawning
    controller); with a non-empty token every method (Control and the
    Deliver/Ack data path) requires it, and a mismatch is refused
    UNAUTHENTICATED with a log line."""

    def __init__(self, deliver_fn, ack_fn, control_fn,
                 token: Optional[str] = None) -> None:
        if token is None:
            token = _env_token()
        if token:
            deliver_fn = self._guarded(deliver_fn, token, "Deliver")
            ack_fn = self._guarded(ack_fn, token, "Ack")
            control_fn = self._guarded(control_fn, token, "Control")
        self.name = SERVICE
        self._methods = {
            f"/{SERVICE}/Deliver": deliver_fn,
            f"/{SERVICE}/Ack": ack_fn,
            f"/{SERVICE}/Control": control_fn,
        }

    @staticmethod
    def _guarded(fn, token: str, method: str):
        def wrapped(request, context):
            md = dict(context.invocation_metadata() or ())
            got = md.get(_TOKEN_MD_KEY, "")
            if isinstance(got, str):
                got = got.encode("utf-8", "surrogateescape")
            if not hmac.compare_digest(got, token.encode("utf-8")):
                log.warning("rejected unauthenticated %s from %s",
                            method, context.peer())
                context.abort(StatusCode.UNAUTHENTICATED,
                              "missing or invalid control token")
            return fn(request, context)

        return wrapped

    def service(self, method: str) -> Optional[Callable]:
        return self._methods.get(f"/{SERVICE}/{method}")


class TransportServer:
    """The worker's listening socket: one thread per connection reads a
    complete request, runs the handler's method and writes its response
    (gRPC's server in storm_tpu). A handler may block (``Deliver`` waits
    for inbox room); only that connection waits. The handler serves one
    service: its ``name`` (a key of :data:`SERVICES`) and
    ``service(method) -> fn or None``."""

    def __init__(self, handler, port: int = 0,
                 host: str = "0.0.0.0") -> None:
        self._handler = handler
        self._sock = socket.socket(socket.AF_INET, socket.SOCK_STREAM)
        self._sock.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
        self._sock.bind((host, port))
        self._sock.listen(64)
        self.port = self._sock.getsockname()[1]
        self._conns: set = set()
        self._lock = threading.Lock()
        self._running = False
        self._accept_thread: Optional[threading.Thread] = None

    def start(self) -> None:
        self._running = True
        self._accept_thread = threading.Thread(target=self._accept_loop,
                                               name="dist-accept", daemon=True)
        self._accept_thread.start()

    def _accept_loop(self) -> None:
        while self._running:
            try:
                conn, addr = self._sock.accept()
            except OSError:
                return
            conn.setsockopt(socket.IPPROTO_TCP, socket.TCP_NODELAY, 1)
            with self._lock:
                if not self._running:
                    conn.close()
                    return
                self._conns.add(conn)
            threading.Thread(target=self._serve, args=(conn, f"{addr[0]}:{addr[1]}"),
                             name="dist-conn", daemon=True).start()

    def _serve(self, conn: socket.socket, peer: str) -> None:
        try:
            while self._running:
                try:
                    (n,) = _u32.unpack(_recv_exact(conn, 4))
                except OSError:
                    return  # the client closed its idle connection
                if n > MAX_MESSAGE_BYTES:
                    self._respond(conn, StatusCode.RESOURCE_EXHAUSTED,
                                  f"request of {n} bytes exceeds {MAX_MESSAGE_BYTES}")
                    return
                body = _recv_exact(conn, n)
                arrived = time.monotonic()
                method_id, timeout = _req_fix.unpack_from(body, 0)
                pos = _req_fix.size
                token, pos = _read_vstr(body, pos)
                tp, pos = _read_vstr(body, pos)
                payload = memoryview(body)[pos:]
                md = ((_TOKEN_MD_KEY, token),) + ((("traceparent", tp),) if tp else ())
                deadline = arrived + timeout if timeout > 0 else None
                ctx = ServerContext(md, peer, deadline)
                svc, method = _BY_ID.get(method_id, (None, None))
                fn = self._handler.service(method) if svc == self._handler.name else None
                if fn is None:
                    self._respond(conn, StatusCode.UNIMPLEMENTED,
                                  f"method /{svc}/{method} is not served here" if svc
                                  else f"unknown method id {method_id}")
                    continue
                try:
                    out = fn(payload, ctx)
                except _Abort as a:
                    self._respond(conn, a.code, a.details)
                    continue
                except Exception as e:
                    log.debug("%s handler failed", method, exc_info=True)
                    self._respond(conn, StatusCode.UNKNOWN, f"{type(e).__name__}: {e}")
                    continue
                if deadline is not None and time.monotonic() > deadline:
                    # The caller has given up on this call already.
                    self._respond(conn, StatusCode.DEADLINE_EXCEEDED,
                                  "deadline exceeded in the handler")
                    continue
                self._respond(conn, StatusCode.OK, "", out or b"")
        except OSError:
            return
        finally:
            with self._lock:
                self._conns.discard(conn)
            conn.close()

    @staticmethod
    def _respond(conn: socket.socket, code: StatusCode, details: str,
                 payload: bytes = b"") -> None:
        d = details.encode("utf-8", "replace")
        head = _resp_fix.pack(code.value, len(d)) + d
        _send_parts(conn, [_u32.pack(len(head) + len(payload)), head, payload])

    def stop(self) -> None:
        """Close the listening socket and every open connection."""
        with self._lock:
            self._running = False
            conns, self._conns = list(self._conns), set()
        try:
            self._sock.shutdown(socket.SHUT_RDWR)  # wakes the blocked accept()
        except OSError:
            pass
        self._sock.close()
        for c in conns:
            try:
                c.shutdown(socket.SHUT_RDWR)
            except OSError:
                pass
            c.close()
        if self._accept_thread is not None:
            self._accept_thread.join(timeout=5)
