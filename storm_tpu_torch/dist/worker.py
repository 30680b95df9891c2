"""Distributed worker process, ported from ``storm_tpu/dist/worker.py``:
hosts the executors of its assigned components; everything else is
reached over the transport (:mod:`.transport`, stdlib TCP where storm_tpu
uses gRPC).

The Storm-worker equivalent (the reference runs 8 worker processes,
MainTopology.java:25,66, and moves tuples between them with Netty):

- :class:`DistRuntime` extends the single-host ``TopologyRuntime``: local
  components get real executors; components placed on other workers get a
  ``TargetGroup`` of :class:`RemoteInbox` proxies, so ``OutputCollector``
  routing/grouping/anchoring code is byte-identical in both modes;
- :class:`PeerSender` batches tuple deliveries and ack ops per peer and
  ships them from a background task (network never blocks an executor);
- :class:`DistLedger` routes XOR acks: ids tagged with this worker's index
  apply to the local ledger, others are forwarded to their owner;
- run as ``python -m storm_tpu_torch.dist.worker --port P --index I
  [--device cpu]``; it prints one JSON ready-line ``{"ready": true,
  "port": ..., "index": ...}`` and the controller drives it over the
  Control RPC. The worker's engines run on ``--device``, the card unless
  the caller asks for the CPU; without a card it raises.

Control ops: ``ping``, ``state_report`` (pid, submits, wire, shm, and
once a topology is submitted its name, draining, each component's
parallelism and whether its spouts are active: what a reattaching
controller adopts a live worker by; it works before a submit),
``submit``, ``chaos``, ``start_bolts``, ``start_spouts``,
``parallelism``, ``rebalance``, ``component_stats``, ``seek``,
``profile`` (a ``torch.profiler`` capture of live traffic for
``seconds`` on a thread of its own, written as a Chrome trace into
``log_dir``), ``swap_model``, ``update_peer``, ``metrics`` (the
registry's snapshot and, beside it, each live engine's forwards and
kernel-launch tally and the process's eager kernel launches),
``utilization``, ``copies``, ``traces``, ``decode_sessions`` (this
worker's session stores and decode engines), ``health``,
``deactivate``, ``activate``, ``drain``, ``drain_worker``, ``kill`` and
``shutdown``; ``replay_kernels``, the port's own, traces one replay of
each engine bucket with ``torch.profiler`` beside the launches its
capture recorded. One profiler may be active in a process: ``profile``
and ``replay_kernels`` share one lock, and each refuses while the other
(or a second capture) holds it.
"""

from __future__ import annotations

import argparse
import asyncio
import functools
import json
import logging
import os
import sys
import threading
import time
from typing import Any, Dict, List, Optional

from storm_tpu_torch.config import Config, ResilienceConfig
from storm_tpu_torch.dist import shm as shm_lane
from storm_tpu_torch.dist import transport, wire
from storm_tpu_torch.dist.transport import DistHandler, TransportServer, WorkerClient
from storm_tpu_torch.resilience import (ChaosDrop, CircuitBreaker, RetryPolicy,
                                        StatusCode, TokenBucket, get_injector,
                                        install_chaos)
from storm_tpu_torch.resilience.retry import (RETRYABLE_BROAD, RETRYABLE_NARROW,
                                              is_retryable)
from storm_tpu_torch.runtime.acker import AckLedger
from storm_tpu_torch.runtime.cluster import TargetGroup, TopologyRuntime
from storm_tpu_torch.runtime.executor import BoltExecutor, SpoutExecutor, clone_component
from storm_tpu_torch.runtime.tuples import Tuple, owner_of, set_worker_tag

log = logging.getLogger("storm_tpu_torch.dist")


# ---- outbound ----------------------------------------------------------------


class PeerSender:
    """Per-peer outbound queue: batches tuples/acks, sends via a worker
    thread so the network never blocks the event loop. Backpressure is end-to-end,
    not local: the queue is unbounded (see __init__), volume is bounded by
    ``max_spout_pending`` on the root spouts, and the receiving side's
    `Deliver` RPC blocks until its executor inboxes accept the batch.

    Failure handling: each send rides the resilience retry
    policy (full-jitter backoff; Deliver retries UNAVAILABLE only — the
    pre-first-byte guarantee — Ack retries the broad set). Consecutive
    exhausted sends open this peer's :class:`CircuitBreaker`; while open
    the loop PARKS the batch (re-routing reroutable tuples to surviving
    replicas via the runtime hook) instead of dropping it, leaning on
    ``max_spout_pending`` for bounding. When the circuit closes again —
    the peer recovered — the first ``replay_window_s`` of tuples drain
    through a token bucket so the replay burst cannot re-flatten it."""

    #: soft byte cap per Deliver RPC, well under the transport's 64 MB limit
    MAX_BATCH_BYTES = 8 * 1024 * 1024
    MAX_BATCH_ITEMS = 512

    def __init__(self, addr: str, wire_format: str = "binary",
                 resilience: Optional[ResilienceConfig] = None,
                 shm_wire: bool = True,
                 shm_min_bytes: int = 65536) -> None:
        res = resilience if resilience is not None else ResilienceConfig()
        self.resilience = res
        self._retry = RetryPolicy(
            attempts=int(res.retry_attempts),
            base_s=res.retry_base_ms / 1e3,
            cap_s=res.retry_cap_ms / 1e3,
            deadline_s=res.retry_deadline_s,
        )
        # attempts=1 on the client: THIS sender owns the retry loop (its
        # backoff must sleep on the event loop, not a transport thread);
        # stacking the client's sync retries under it would square the
        # attempt count.
        self.client = WorkerClient(addr, retry=RetryPolicy(attempts=1))
        self.circuit = CircuitBreaker(
            failures=int(res.circuit_failures),
            reset_s=res.circuit_reset_s,
            on_open=self._circuit_opened,
            on_close=self._circuit_closed,
        )
        # Unbounded on purpose: acks must never lose to backpressure (a
        # dropped ack = timeout + replay), and tuple volume is already
        # bounded end-to-end by max_spout_pending on the root spouts plus
        # the blocking Deliver RPC on the receiving side.
        self.queue: asyncio.Queue = asyncio.Queue()
        self._task: Optional[asyncio.Task] = None
        # Wire negotiation state: the preference comes from
        # TopologyConfig.wire_format; whether THIS peer actually takes
        # binary frames is learned from its ping response ("wire" version)
        # on first flush and cached. None = not yet negotiated.
        self._wire_format = wire_format
        self._use_binary: Optional[bool] = None
        # Peer capability state from the same ping: integer wire version
        # (frames are stamped with min(ours, theirs) so record-frame
        # slots are decomposed for v1 peers) and the peer's shm host key
        # (the shared-memory lane engages only when it equals OURS —
        # same machine, same boot — and the batch clears shm_min_bytes).
        self._peer_wire: Optional[int] = None
        self._peer_shm: Optional[str] = None
        self._shm_wire = bool(shm_wire) and shm_lane.available()
        self._shm_min_bytes = int(shm_min_bytes)
        # Recovery pacing state (armed by begin_recovery_pacing).
        self._pacer: Optional[TokenBucket] = None
        self._pace_until = 0.0
        self._pace_rate_fn = None  # () -> tuples/s, set by the runtime
        # Re-route hook: async (component, task, tuple) -> bool, set by
        # the runtime; None = parking only.
        self._reroute = None
        # Observability hooks (None outside a runtime, e.g. unit tests).
        self._flight = None
        self._m: Dict[str, Any] = {}

    # ---- wiring (runtime) ------------------------------------------------

    def bind_obs(self, metrics, flight, peer_idx: int) -> None:
        """Register this sender's counters under the ``_transport``
        pseudo-component of the hosting runtime's registry."""
        self._flight = flight
        self._peer_idx = peer_idx
        self._m = {
            "retries": metrics.counter("_transport", "dist_send_retries"),
            "failures": metrics.counter("_transport", "dist_send_failures"),
            "opens": metrics.counter("_transport", "dist_circuit_opens"),
            "state": metrics.gauge("_transport",
                                   f"dist_circuit_open_w{peer_idx}"),
            "parked": metrics.counter("_transport", "dist_parked_batches"),
            "rerouted": metrics.counter("_transport", "dist_rerouted"),
            "shm": metrics.counter("_transport", "dist_shm_batches"),
            # The port's own: Deliver batches whose frame crossed the socket.
            "tcp": metrics.counter("_transport", "dist_tcp_batches"),
            "throttled": metrics.counter("_transport",
                                         "dist_replay_throttled"),
            "throttle_ms": metrics.histogram("_transport",
                                             "dist_replay_throttle_ms"),
        }
        # A replacement sender re-binds the same per-peer gauge: reset it,
        # or the dead predecessor's open-circuit 1 latches forever.
        self._m["state"].set(0)

    def set_reroute(self, fn) -> None:
        self._reroute = fn

    def begin_recovery_pacing(self, rate: float, window_s: float) -> None:
        """Route the next ``window_s`` of tuple sends through a token
        bucket at ``rate`` tuples/s (burst = 1 s worth)."""
        if rate <= 0 or window_s <= 0:
            return
        self._pacer = TokenBucket(rate, burst=rate)
        self._pace_until = time.monotonic() + window_s
        log.info("peer %s: pacing replays at %.1f tuples/s for %.1fs",
                 self.client.target, rate, window_s)

    # ---- circuit callbacks (worker loop / transport threads) -------------

    def _circuit_opened(self) -> None:
        if "state" in self._m:
            self._m["state"].set(1)
            self._m["opens"].inc()
        if self._flight is not None:
            self._flight.event("dist_circuit_open", peer=self.client.target,
                               opens=self.circuit.opens)
        log.warning("peer %s circuit OPEN (consecutive send failures); "
                    "parking/re-routing until the half-open probe",
                    self.client.target)

    def _circuit_closed(self) -> None:
        if "state" in self._m:
            self._m["state"].set(0)
        if self._flight is not None:
            self._flight.event("dist_circuit_close", peer=self.client.target)
        # The peer just came back: everything queued behind the open
        # circuit (plus the ledger's replays) is about to drain — pace it.
        rate_fn = self._pace_rate_fn
        rate = 0.0
        if rate_fn is not None:
            try:
                rate = float(rate_fn())
            except Exception:
                rate = 0.0
        self.begin_recovery_pacing(rate, self.resilience.replay_window_s)
        log.info("peer %s circuit closed (probe succeeded)",
                 self.client.target)

    def _note_retry(self, attempt: int, exc: BaseException) -> None:
        if "retries" in self._m:
            self._m["retries"].inc()

    def start(self) -> None:
        self._task = asyncio.get_event_loop().create_task(self._loop())

    async def put_tuple(self, component: str, task: int, t: Tuple) -> None:
        await self.queue.put(("t", component, task, t))

    def put_ack_nowait(self, op: str, root: int, edge: int) -> None:
        self.queue.put_nowait(("a", op, root, edge))

    @staticmethod
    def _approx_bytes(item) -> int:
        if item[0] == "a":
            return 48
        t = item[3]
        return 96 + sum(
            len(v) if isinstance(v, (str, bytes))
            else v.nbytes if hasattr(v, "nbytes")  # ndarray (binary wire)
            else 16
            for v in t.values)

    async def _loop(self) -> None:
        while True:
            item = await self.queue.get()
            items = [item]
            nbytes = self._approx_bytes(item)
            # Opportunistic batch, capped by count AND bytes so one RPC can
            # never exceed the transport's message limit (large records).
            while len(items) < self.MAX_BATCH_ITEMS and nbytes < self.MAX_BATCH_BYTES:
                try:
                    nxt = self.queue.get_nowait()
                except asyncio.QueueEmpty:
                    break
                items.append(nxt)
                nbytes += self._approx_bytes(nxt)
            tuples = [(c, i, t) for kind, c, i, t in
                      (x for x in items if x[0] == "t")]
            acks = [(op, r, e) for kind, op, r, e in
                    (x for x in items if x[0] == "a")]
            await self._flush(tuples, acks)

    async def _flush(self, tuples, acks) -> None:
        """Send one batch, parking (never silently dropping) while this
        peer's circuit is open. Only non-transient failures — encode bugs,
        auth rejects — abandon the batch to ledger-timeout replay."""
        while tuples or acks:
            if not self.circuit.allow():
                if tuples and self._reroute is not None:
                    kept = []
                    for c, i, t in tuples:
                        if await self._reroute(c, i, t):
                            if "rerouted" in self._m:
                                self._m["rerouted"].inc()
                        else:
                            kept.append((c, i, t))
                    tuples = kept
                    if not tuples and not acks:
                        return
                if "parked" in self._m:
                    self._m["parked"].inc()
                await asyncio.sleep(
                    min(max(self.circuit.wait_s(), 0.05), 0.5))
                continue
            try:
                binary = await self._negotiate()
                if acks:
                    enc_acks = (wire.encode_acks if binary
                                else transport.encode_acks)
                    await self._send(self.client.ack, enc_acks(acks),
                                     codes=RETRYABLE_BROAD)
                    acks = []
                if tuples:
                    await self._pace(len(tuples))
                    # First sampled tuple's context doubles as the call's
                    # traceparent header (per-tuple contexts travel in the
                    # frame/envelope itself).
                    tp = next((t.trace.traceparent() for _c, _i, t in tuples
                               if t.trace is not None), None)
                    deliver = functools.partial(self.client.deliver,
                                                traceparent=tp)
                    if binary and self._shm_eligible(tuples):
                        await self._deliver_shm(deliver, tuples)
                    else:
                        # Frames are stamped with the NEGOTIATED version
                        # (v2-only slots decomposed for v1 peers); an
                        # un-negotiated peer gets our version optimistically
                        # — same failure mode as the binary/JSON guess.
                        ver = min(wire.WIRE_VERSION,
                                  self._peer_wire if self._peer_wire
                                  is not None else wire.WIRE_VERSION)
                        enc_tuples = (
                            functools.partial(wire.encode_deliveries,
                                              version=ver)
                            if binary else transport.encode_deliveries)
                        await self._send(deliver, enc_tuples(tuples),
                                         codes=RETRYABLE_NARROW)
                        if "tcp" in self._m:
                            self._m["tcp"].inc()
                    tuples = []
                self.circuit.record_success()
                return
            except asyncio.CancelledError:
                raise
            except Exception as e:
                self.circuit.record_failure()
                if "failures" in self._m:
                    self._m["failures"].inc()
                if not is_retryable(e):
                    # Encode bug / auth reject / protocol error: retrying
                    # the same bytes cannot succeed. The affected trees
                    # hit the ledger timeout and replay from the spout
                    # (at-least-once, same as a lost Netty transfer in
                    # Storm).
                    log.warning("peer %s send failed (not retryable, "
                                "leaving to replay): %s",
                                self.client.target, e)
                    return
                log.warning("peer %s send failed: %s", self.client.target, e)
                await asyncio.sleep(self._retry.backoff(0))

    async def _deliver_shm(self, deliver, tuples) -> None:
        """Ship one batch through the shared-memory lane.

        The unsealed v2 frame is written part-by-part into a fresh
        segment (the lane's ONE copy — ``shm_transport``); only the tiny
        0xB9 header crosses the RPC. The receiver decodes synchronously
        inside Deliver, so the segment is closed+unlinked as soon as the
        send settles — success or permanent failure alike; per-attempt
        retries inside ``_send`` all happen while it is still alive.
        Failing to CREATE a segment (/dev/shm full, exhausted fds)
        disables the lane for this sender and falls back to TCP rather
        than wedging the peer."""
        parts, _flags = wire.encode_delivery_parts(tuples)
        try:
            seg, length = shm_lane.write_segment(parts)
        except Exception as e:
            log.warning("shm lane disabled for peer %s (%s); using TCP",
                        self.client.target, e)
            self._shm_wire = False
            await self._send(deliver, wire.encode_deliveries(tuples),
                             codes=RETRYABLE_NARROW)
            if "tcp" in self._m:
                self._m["tcp"].inc()
            return
        try:
            header = wire.encode_shm_header(seg.name, 0, length)
            await self._send(deliver, header, codes=RETRYABLE_NARROW)
            if "shm" in self._m:
                self._m["shm"].inc()
        finally:
            seg.close()
            try:
                seg.unlink()
            except OSError:  # pragma: no cover - already gone
                pass

    async def _pace(self, n: int) -> None:
        """Recovery-window pacing: wait out the token bucket before
        pushing ``n`` tuples at a freshly recovered peer."""
        pacer = self._pacer
        if pacer is None or time.monotonic() >= self._pace_until:
            return
        wait = pacer.take(n)
        if wait > 0:
            if "throttled" in self._m:
                self._m["throttled"].inc()
                self._m["throttle_ms"].observe(wait * 1e3)
            await asyncio.sleep(wait)

    async def _negotiate(self) -> bool:
        """Decide (once) whether this peer takes binary frames.

        ``wire_format="json"`` pins the fallback without any RPC. For
        "binary" we read the peer's ping response: a ``wire`` version >= 1
        means it decodes our frames; its absence means a pre-binary
        checkout, so this sender drops to the JSON envelope for the
        connection's lifetime. An unreachable peer leaves the decision
        uncached and optimistically tries binary — if the peer is down the
        send fails identically either way and the trees replay; once it
        answers pings the real answer is cached.
        """
        if self._use_binary is not None:
            return self._use_binary
        if self._wire_format != "binary":
            self._use_binary = False
            return False
        try:
            resp = await asyncio.to_thread(self.client.control, "ping", 5.0)
        except Exception:
            return True
        self._peer_wire = int(resp.get("wire", 0))
        self._peer_shm = resp.get("shm") or None
        self._use_binary = self._peer_wire >= 1
        if not self._use_binary:
            log.info("peer %s does not advertise the binary wire; "
                     "falling back to the JSON envelope", self.client.target)
        return self._use_binary

    def _shm_eligible(self, tuples) -> bool:
        """Shared-memory lane preconditions: both halves enabled, peer on
        the SAME host+boot (ping-advertised key equality — never inferred
        from the address), peer decodes v2 frames, and the batch is big
        enough that one segment setup beats the saved socket copies."""
        if not self._shm_wire or self._peer_shm is None:
            return False
        if (self._peer_wire or 0) < 2 or self._peer_shm != shm_lane.host_key():
            return False
        nbytes = sum(self._approx_bytes(("t", c, i, t))
                     for c, i, t in tuples)
        return nbytes >= self._shm_min_bytes

    async def _send(self, fn, payload: bytes, *, codes) -> None:
        """One RPC under the resilience retry policy. Chaos injection
        (latency, drops, corruption) applies PER ATTEMPT inside the
        retried callable, so an injected drop exercises the same backoff
        path a real outage would."""

        def attempt(timeout: float) -> None:
            inj = get_injector()
            d = inj.wire_delay_s()
            if d > 0:
                time.sleep(d)  # runs on a to_thread worker, not the loop
            if inj.should_drop():
                raise ChaosDrop(
                    f"chaos: dropped frame to {self.client.target}")
            bad = inj.corrupt(payload)
            fn(bad if bad is not None else payload, timeout=timeout)

        await self._retry.call_async(
            attempt, op_timeout=60.0, codes=codes,
            on_retry=self._note_retry)

    async def stop(self) -> None:
        if self._task:
            self._task.cancel()
            try:
                await self._task
            except (asyncio.CancelledError, Exception):
                pass
        self.client.close()


class RemoteInbox:
    """Queue look-alike for a remote executor's inbox."""

    maxsize = 0  # health/autoscale treat remote inboxes as opaque

    def __init__(self, sender: PeerSender, component: str, task: int) -> None:
        self._sender = sender
        self._component = component
        self._task = task

    async def put(self, t: Tuple) -> None:
        await self._sender.put_tuple(self._component, self._task, t)

    def put_nowait(self, t: Tuple) -> None:  # tick tuples never cross hosts
        raise RuntimeError("put_nowait on a remote inbox")

    def qsize(self) -> int:
        return 0


# ---- ack routing -------------------------------------------------------------


class DistLedger:
    """AckLedger facade routing ops by the id's owner tag."""

    def __init__(self, base: AckLedger, worker_idx: int,
                 senders: Dict[int, PeerSender]) -> None:
        self._base = base
        self._idx = worker_idx
        self._senders = senders

    # local-only surface used by the runtime
    @property
    def inflight(self) -> int:
        return self._base.inflight

    @property
    def acked(self) -> int:
        return self._base.acked

    @property
    def failed(self) -> int:
        return self._base.failed

    def init_root(self, *a, **kw) -> None:
        self._base.init_root(*a, **kw)

    def sweep(self) -> int:
        return self._base.sweep()

    # routed surface
    def xor(self, root_id: int, edge_id: int) -> None:
        owner = owner_of(root_id)
        if owner == self._idx or owner not in self._senders:
            self._base.xor(root_id, edge_id)
        else:
            self._senders[owner].put_ack_nowait("xor", root_id, edge_id)

    def anchor(self, root_id: int, edge_id: int) -> None:
        owner = owner_of(root_id)
        if owner == self._idx or owner not in self._senders:
            self._base.anchor(root_id, edge_id)
        else:
            self._senders[owner].put_ack_nowait("anc", root_id, edge_id)

    def ack_edge(self, root_id: int, edge_id: int) -> None:
        owner = owner_of(root_id)
        if owner == self._idx or owner not in self._senders:
            self._base.ack_edge(root_id, edge_id)
        else:
            self._senders[owner].put_ack_nowait("ake", root_id, edge_id)

    def outstanding(self, root_id: int):
        """Live-edge count — only answerable for roots this worker owns.

        Returns None for remote roots: the EOS sink treats None as
        "unknown tree shape" and falls back to immediate offset folding
        (safe only for 1:1 entry→sink-tuple trees; see
        TransactionalBrokerSink docs).
        """
        if owner_of(root_id) == self._idx:
            return self._base.outstanding(root_id)
        return None

    def watch(self, root_id: int, cb) -> bool:
        if owner_of(root_id) == self._idx:
            return self._base.watch(root_id, cb)
        return False

    def watch_live(self, root_id: int, cb) -> bool:
        if owner_of(root_id) == self._idx:
            return self._base.watch_live(root_id, cb)
        return False

    def fail_root(self, root_id: int) -> None:
        owner = owner_of(root_id)
        if owner == self._idx or owner not in self._senders:
            self._base.fail_root(root_id)
        else:
            self._senders[owner].put_ack_nowait("fail", root_id, 0)


# ---- the runtime -------------------------------------------------------------


class DistRuntime(TopologyRuntime):
    """TopologyRuntime hosting only the components placed on this worker."""

    def __init__(
        self,
        name: str,
        topology,
        config: Config,
        worker_idx: int,
        placement: Dict[str, int],
        peers: Dict[int, str],
    ) -> None:
        super().__init__(name, topology, config)
        self.worker_idx = worker_idx
        self.placement = placement
        set_worker_tag(worker_idx)
        self._wire_format = getattr(config.topology, "wire_format", "binary")
        self._shm_wire = bool(getattr(config.topology, "shm_wire", True))
        self._shm_min_bytes = int(
            getattr(config.topology, "shm_min_bytes", 65536))
        self.senders: Dict[int, PeerSender] = {
            idx: self._make_sender(idx, addr)
            for idx, addr in peers.items() if idx != worker_idx
        }
        self.ledger = DistLedger(
            AckLedger(timeout_s=config.topology.message_timeout_s),
            worker_idx,
            self.senders,
        )
        self._reroute_rr = 0  # round-robin cursor for reroute_tuple
        # Graceful-drain state (controller drain_worker / rolling
        # restarts): while set, _on_deliver rejects new batches
        # (UNAVAILABLE — senders retry/park; at-least-once covers the
        # gap) so the local flush can actually reach empty.
        self._draining = False
        self._draining_gauge = self.metrics.gauge(
            "_control", "worker_draining")
        self._draining_gauge.set(0)
        # Arm the process-wide chaos injector from [chaos] (no-op unless
        # enabled) so submit-recipe chaos reaches every worker.
        install_chaos(getattr(config, "chaos", None), flight=self.flight)
        # Data-plane copy ledger: attach at worker boot, not just in
        # operator/sink prepare — a spout-only worker still owes the
        # ingest rows (the amplification denominator) and the wire hops.
        from storm_tpu_torch.obs.copyledger import ensure_installed

        ensure_installed()

    def _make_sender(self, idx: int, addr: str) -> PeerSender:
        sender = PeerSender(addr, self._wire_format,
                            resilience=self.config.resilience,
                            shm_wire=self._shm_wire,
                            shm_min_bytes=self._shm_min_bytes)
        sender.bind_obs(self.metrics, self.flight, idx)
        sender.set_reroute(
            lambda c, i, t, _s=sender: self.reroute_tuple(c, i, t, _s))
        sender._pace_rate_fn = self._replay_rate
        return sender

    def _replay_rate(self) -> float:
        """Tuples/s budget for post-recovery replay pacing.

        ``resilience.replay_rate`` wins when set; otherwise the auto rate
        drains one full ``max_spout_pending`` window per
        ``replay_window_s``, clamped by the bottleneck verdict's leader
        capacity when the observatory has one — no point replaying faster
        than the topology's measured ceiling."""
        res = self.config.resilience
        if res.replay_rate > 0:
            return res.replay_rate
        pending = max(1, int(self.config.topology.max_spout_pending or 1))
        rate = pending / max(0.1, res.replay_window_s)
        verdict = getattr(getattr(self, "obs", None), "bottleneck", None)
        verdict = getattr(verdict, "last_verdict", None)
        if isinstance(verdict, dict):
            leader = verdict.get("leader")
            for row in verdict.get("ranked") or []:
                if row.get("component") == leader:
                    cap = float(row.get("capacity") or 0.0)
                    if cap > 0:
                        rate = min(rate, cap)
                    break
        return rate

    async def reroute_tuple(self, component: str, task: int, t: Tuple,
                            dead_sender: PeerSender) -> bool:
        """Try to land a tuple parked behind an open circuit on a SURVIVING
        task of the same component. Only legal when every subscription into
        the component is shuffle-family (LocalOrShuffle included): fields/
        all/direct groupings pin tuples to their chosen task, so those park
        instead. Returns True when re-delivered."""
        from storm_tpu_torch.runtime.groupings import ShuffleGrouping

        spec = self.topology.specs.get(component)
        group = self.groups.get(component)
        if spec is None or group is None:
            return False
        if not all(isinstance(sub.grouping, ShuffleGrouping)
                   for sub in spec.inputs):
            return False
        survivors = [
            inbox for inbox in group.inboxes
            if getattr(inbox, "_sender", None) is not dead_sender
        ]
        if not survivors:
            return False
        self._reroute_rr = (self._reroute_rr + 1) % len(survivors)
        await survivors[self._reroute_rr].put(t)
        return True

    def _local(self, component_id: str) -> bool:
        return self.placement.get(component_id, 0) == self.worker_idx

    def _make_executors(self) -> None:
        tcfg = self.config.topology
        for spec in self.topology.specs.values():
            group = TargetGroup(spec.component_id)
            self.groups[spec.component_id] = group
            if self._local(spec.component_id):
                if spec.is_spout:
                    self.spout_execs[spec.component_id] = [
                        SpoutExecutor(
                            self, spec.component_id, i, clone_component(spec.obj),
                            tcfg.max_spout_pending,
                        )
                        for i in range(spec.parallelism)
                    ]
                else:
                    execs = [
                        BoltExecutor(
                            self, spec.component_id, i, clone_component(spec.obj),
                            tcfg.inbox_capacity, tcfg.tick_interval_s,
                        )
                        for i in range(spec.parallelism)
                    ]
                    self.bolt_execs[spec.component_id] = execs
                    group.inboxes = [e.inbox for e in execs]
            elif not spec.is_spout:
                # Remote component: proxy inboxes so groupings see the full
                # task set and routing stays identical to single-host.
                sender = self.senders[self.placement[spec.component_id]]
                group.inboxes = [
                    RemoteInbox(sender, spec.component_id, i)
                    for i in range(spec.parallelism)
                ]
        for spec in self.topology.specs.values():
            for sub in spec.inputs:
                self.router.add(
                    sub.source, sub.stream, sub.grouping,
                    self.groups[spec.component_id],
                )

    async def replace_peer(self, idx: int, addr: str) -> None:
        """Point everything aimed at worker ``idx`` to its replacement at
        ``addr`` (the worker came back at a new port after a crash).

        Swaps the :class:`PeerSender` in place — the senders dict is shared
        with :class:`DistLedger`, so ack routing follows automatically — and
        repoints the proxy inboxes of every component placed on ``idx``.
        Tuples queued in the dead sender are dropped with it: they were lost
        in flight anyway, and the spout ledger's timeout replays their trees
        (at-least-once, same story as a worker crash under Storm)."""
        old = self.senders.get(idx)
        sender = self._make_sender(idx, addr)
        self.senders[idx] = sender
        sender.start()
        # The replacement is cold (fresh process, unwarmed engines): pace
        # the replay burst that is about to hit it, same as a circuit
        # close, and leave a flight-recorder breadcrumb for the bench.
        sender.begin_recovery_pacing(self._replay_rate(),
                                     self.config.resilience.replay_window_s)
        if self.flight is not None:
            self.flight.event("dist_peer_replaced", idx=idx, addr=addr)
        for spec in self.topology.specs.values():
            if spec.is_spout or self._local(spec.component_id):
                continue
            if self.placement.get(spec.component_id, 0) != idx:
                continue
            for inbox in self.groups[spec.component_id].inboxes:
                inbox._sender = sender
        if old is not None:
            await old.stop()

    async def resize_remote_group(self, component: str, parallelism: int) -> None:
        """Resize this worker's proxy-inbox view of a component hosted
        elsewhere, so groupings route over the component's new task count."""
        spec = self.topology.specs[component]
        if spec.is_spout:
            # Spouts are never delivery targets: their proxy view must stay
            # empty or deliver_threadsafe's unknown-target guard is defeated.
            spec.parallelism = parallelism
            return
        group = self.groups[component]
        sender = self.senders[self.placement[component]]
        cur = len(group.inboxes)
        if parallelism > cur:
            group.inboxes.extend(
                RemoteInbox(sender, component, i) for i in range(cur, parallelism)
            )
        else:
            del group.inboxes[parallelism:]
        self.router.reprepare(component)
        self.topology.specs[component].parallelism = parallelism
        self._pace_ring_handoff(component, sender)

    def _pace_ring_handoff(self, component: str, sender: PeerSender) -> None:
        """After a ring-grouped component resizes, ~1/N of its keys just
        moved to different tasks (RingFieldsGrouping diff-updated its
        ring in reprepare above). The moved keys' in-flight trees replay
        onto tasks with no warm state for them — pace that bounded
        handoff through the recovery token bucket, exactly like a
        peer-replacement replay, and leave evidence."""
        from storm_tpu_torch.dist.ring import RingFieldsGrouping

        spec = self.topology.specs.get(component)
        if spec is None:
            return
        frac = max((sub.grouping.last_remap_fraction
                    for sub in spec.inputs
                    if isinstance(sub.grouping, RingFieldsGrouping)),
                   default=0.0)
        if frac <= 0:
            return
        self.metrics.counter("_transport", "dist_ring_remapped").inc()
        sender.begin_recovery_pacing(
            self._replay_rate(), self.config.resilience.replay_window_s)
        if self.flight is not None:
            self.flight.event("ring_handoff", component=component,
                              remapped_fraction=round(frac, 4))

    # ---- graceful drain (controller drain_worker / rolling restart) ----------

    async def drain_for_restart(self, timeout_s: float = 30.0) -> Dict[str, Any]:
        """Per-worker graceful drain: stop intake -> flush inflight ->
        final state checkpoint -> ack. Unlike :meth:`drain` (cluster-wide,
        spouts everywhere stop first) this worker drains ALONE while its
        peers keep producing: new Deliver batches are rejected UNAVAILABLE
        (senders retry, then park behind their circuit — at-least-once
        replay covers whatever parks), local spouts deactivate, and the
        flush waits for local inboxes, outbound sender queues, and owned
        ledger trees to reach zero. The controller suppresses heartbeat
        death-declaration for the duration."""
        self._draining = True
        self._draining_gauge.set(1)
        if self.flight is not None:
            self.flight.event("worker_draining", worker=self.worker_idx)
        await self.deactivate()  # local spouts only; no-op on bolt workers
        flushed = await self._flush_for_restart(timeout_s)
        checkpoints = self._final_checkpoints()
        if self.flight is not None:
            self.flight.event("worker_drained", worker=self.worker_idx,
                              flushed=flushed, checkpoints=checkpoints)
        return {"ok": flushed, "flushed": flushed,
                "checkpoints": checkpoints}

    async def _flush_for_restart(self, timeout_s: float) -> bool:
        """Wait until this worker holds no work: bolt inboxes empty,
        outbound sender queues empty, and (on spout hosts) no inflight
        trees in the owned ledger. Bounded by ``timeout_s``."""

        def busy() -> bool:
            if self.ledger.inflight > 0:
                return True
            if any(e.inbox.qsize() > 0
                   for execs in self.bolt_execs.values() for e in execs):
                return True
            return any(s.queue.qsize() > 0 for s in self.senders.values())

        deadline = time.monotonic() + timeout_s
        settled = 0
        while time.monotonic() < deadline:
            if busy():
                settled = 0
                await asyncio.sleep(0.02)
                continue
            # An executor can be mid-execute with its sends not yet
            # queued: require two consecutive idle observations a tick
            # apart before declaring the flush complete.
            settled += 1
            if settled >= 2:
                return True
            await asyncio.sleep(0.05)
        return False

    def _final_checkpoints(self) -> int:
        """Final state checkpoint for every stateful bolt executor (runs
        on the loop thread; executors are idle post-flush). Dirty-flag
        short-circuiting inside _checkpoint keeps this cheap."""
        n = 0
        for execs in self.bolt_execs.values():
            for e in execs:
                if getattr(e, "_stateful", False):
                    e._checkpoint()
                    n += 1
        return n

    async def activate(self) -> None:
        # Re-opening intake on activate lets a drained-but-kept worker
        # return to service (drain drill / cancelled maintenance).
        self._draining = False
        self._draining_gauge.set(0)
        await super().activate()

    async def start_bolts(self) -> None:
        self._make_executors()
        for s in self.senders.values():
            s.start()
        for execs in self.bolt_execs.values():
            for e in execs:
                e.start()
        self._sweeper = asyncio.create_task(self._sweep_loop())

    async def start_spouts(self) -> None:
        for execs in self.spout_execs.values():
            for e in execs:
                e.start()

    async def start(self) -> None:  # single-phase convenience (tests)
        await self.start_bolts()
        await self.start_spouts()

    async def kill(self, wait_secs: float = 0.0) -> None:
        await super().kill(wait_secs)
        for s in self.senders.values():
            await s.stop()

    # ---- inbound (called from transport threads) -----------------------------

    def deliver_threadsafe(self, payload: bytes, loop: asyncio.AbstractEventLoop) -> None:
        try:
            deliveries = transport.decode_deliveries(payload)
        except wire.WireError as e:
            # Corrupted frame (CRC/structure): account it, then let the
            # call fail — the SENDER treats the resulting UNKNOWN status as
            # non-retryable (same bytes, same CRC), so the affected trees
            # time out and replay from the spout.
            self.metrics.counter("_transport", "dist_wire_errors").inc()
            if self.flight is not None:
                self.flight.event("wire_error", error=str(e),
                                  nbytes=len(payload), throttle_s=0.5)
            raise

        async def enqueue():
            for component, task, t in deliveries:
                group = self.groups.get(component)
                if group is None or task >= len(group.inboxes):
                    log.warning("delivery for unknown %s[%d] dropped", component, task)
                    continue
                await group.inboxes[task].put(t)

        # Block the RPC until enqueued: cross-host backpressure.
        asyncio.run_coroutine_threadsafe(enqueue(), loop).result(timeout=60)

    def acks_threadsafe(self, payload: bytes, loop: asyncio.AbstractEventLoop) -> None:
        ops = transport.decode_acks(payload)

        def apply():
            for op, root, edge in ops:
                if op == "anc":
                    self.ledger.anchor(root, edge)
                elif op == "ake":
                    self.ledger.ack_edge(root, edge)
                elif op == "xor":  # pre-refcount peers (upgrade all-at-once)
                    self.ledger.xor(root, edge)
                elif op == "fail":
                    self.ledger.fail_root(root)
                else:
                    # Unknown op from a NEWER peer: drop, don't guess —
                    # part of the envelope versioning contract
                    # (transport.decode_tuple). The tree times out and
                    # replays rather than mis-acking.
                    log.warning("unknown ack op %r dropped", op)

        # Ledger on_done callbacks touch spout executor state -> loop thread.
        loop.call_soon_threadsafe(apply)


# ---- the worker process ------------------------------------------------------

_BUILDERS = {
    "standard": "storm_tpu_torch.main:build_standard_topology",
    # Device-free framework-ceiling topology (NullEngine).
    "null": "storm_tpu_torch.main:build_null_engine_topology",
    "multi": "storm_tpu_torch.main:build_multi_model_topology",
}


def _resolve_builder(name: str):
    """A builder by its registered name or a ``module:function`` path;
    called ``builder(cfg, broker, device=...)``."""
    import importlib

    path = _BUILDERS.get(name, name)
    mod, _, fn = path.partition(":")
    return getattr(importlib.import_module(mod), fn)


def _engine_report() -> Dict[str, Any]:
    """Each live engine's model, identity, built buckets, forwards and
    kernel-launch tally (every forward a graph replay counts its capture's
    kernels), and the eager launches of each kernel wrapper in this
    process: what the ``metrics`` op reports beside the registry's
    snapshot. The same identity and buckets after a controller's reattach
    show that nothing was built or captured again. An auxiliary engine
    without graphs (the decode tier's) reports no bucket and no tally."""
    out: Dict[str, Any] = {"engines": [], "eager_launches": {}}
    if "storm_tpu_torch.infer.engine" not in sys.modules:
        return out
    from storm_tpu_torch.infer.engine import live_engines
    from storm_tpu_torch.ops import _build

    for eng in live_engines():
        cfg = getattr(eng, "model_cfg", None)
        out["engines"].append({
            "model": getattr(cfg, "name", None),
            "id": id(eng),
            "buckets": sorted(getattr(eng, "compiled_batches", ())),
            "weights": getattr(cfg, "weights", None),
            "dtype": getattr(cfg, "dtype", None),
            "forwards": int(getattr(eng, "forwards", 0)),
            "launch_tally": dict(eng.launch_tally()) if hasattr(eng, "launch_tally") else {},
        })
    out["eager_launches"] = dict(_build.launch_counts())
    return out


def _replay_report(model: Optional[str] = None) -> List[Dict[str, Any]]:
    """For each live engine (of ``model`` only, when given): one replay of
    each built bucket traced by the profiler (the kernels the card ran, by
    name) beside the launches its capture recorded, which every replay
    adds to the engine's tally. What the ``replay_kernels`` op reports."""
    out: List[Dict[str, Any]] = []
    if "storm_tpu_torch.infer.engine" not in sys.modules:
        return out
    from storm_tpu_torch.infer.engine import live_engines
    from storm_tpu_torch.infer.graphs import replay_kernel_names

    for eng in live_engines():
        name = getattr(getattr(eng, "model_cfg", None), "name", None)
        if (model is not None and name != model) or not hasattr(eng, "graph_for"):
            continue
        buckets = {}
        for padded in sorted(eng.compiled_batches):
            bucket = eng.graph_for(padded)
            buckets[str(padded)] = {"kernels": replay_kernel_names(bucket),
                                    "recorded": dict(bucket.launches)}
        out.append({"model": name, "buckets": buckets})
    return out


#: Held while ``torch.profiler`` runs in this process (a ``profile``
#: capture or a ``replay_kernels`` trace): CUPTI allows one active
#: profiler a process, so a second asks and is refused.
_PROFILER = threading.Lock()


class WorkerServer:
    """One worker process: the transport's server, an asyncio loop and one
    DistRuntime. ``device`` is where its engines run: the card (the
    default; raises without one) or ``"cpu"``."""

    def __init__(self, port: int, index: int, device: str = "cuda",
                 host: str = "0.0.0.0") -> None:
        from storm_tpu_torch.device import resolve_device

        self.device = str(resolve_device(device))
        self.index = index
        self.loop = asyncio.new_event_loop()
        self.rt: Optional[DistRuntime] = None
        # Topology builds since the process started: engines are built and
        # their graphs captured only at a submit or a swap, so a reattaching
        # controller reads this (``state_report``) to show that the workers
        # it adopted kept theirs.
        self._submits = 0
        self._broker = None
        self._profile_thread: Optional[threading.Thread] = None
        self._server = TransportServer(
            DistHandler(self._on_deliver, self._on_ack, self._on_control),
            port=port, host=host)
        self.port = self._server.port
        self._stop = threading.Event()

    # ---- RPC callbacks (transport threads) -----------------------------------

    def _on_deliver(self, request, context) -> bytes:
        rt = self.rt  # snapshot: a concurrent 'kill' may null the attribute
        if rt is None:
            context.abort(StatusCode.FAILED_PRECONDITION, "no topology")
        if rt._draining:
            # Stop intake (graceful drain): UNAVAILABLE is the one code
            # Deliver senders retry — they back off, circuit-open, and
            # park; the ledger replays whatever is still parked when the
            # replacement worker comes up. Acks stay accepted (the flush
            # needs them to complete inflight trees).
            context.abort(StatusCode.UNAVAILABLE, "worker draining")
        # The traceparent header (the batch's first sampled context):
        # adopting it stamps the trace's arrival on this worker before any
        # executor span.
        tracer = getattr(rt, "tracer", None)
        if tracer is not None and tracer.active:
            md = dict(context.invocation_metadata() or ())
            tctx = transport.TraceContext.from_traceparent(
                md.get("traceparent"))
            if tctx is not None:
                tracer.adopt(tctx)
        rt.deliver_threadsafe(request, self.loop)
        return b"{}"

    def _on_ack(self, request, context) -> bytes:
        rt = self.rt
        if rt is None:
            context.abort(StatusCode.FAILED_PRECONDITION, "no topology")
        rt.acks_threadsafe(request, self.loop)
        return b"{}"

    def _on_control(self, request, context) -> bytes:
        try:
            req = json.loads(bytes(request))
            out = self._control(req) or {}
            return json.dumps(out, default=str).encode("utf-8")
        except Exception as e:
            log.exception("control failed")
            return json.dumps({"error": f"{type(e).__name__}: {e}"}).encode("utf-8")

    def _run_on_loop(self, coro, timeout: float = 120.0):
        return asyncio.run_coroutine_threadsafe(coro, self.loop).result(timeout)

    def _control(self, req: Dict[str, Any]) -> Optional[Dict[str, Any]]:
        cmd = req["cmd"]
        if cmd == "ping":
            # "wire" advertises the binary frame version this worker
            # decodes; "shm" the shared-memory lane's host key, which a
            # sender must match before it uses the lane.
            resp = {"ok": True, "index": self.index,
                    "wire": wire.WIRE_VERSION, "device": self.device}
            rt = self.rt
            if shm_lane.available() and (
                    rt is None or getattr(rt, "_shm_wire", True)):
                resp["shm"] = shm_lane.host_key()
            return resp
        if cmd == "state_report":
            return self._state_report()
        if cmd == "submit":
            cfg = Config.from_dict(req["config"])
            from storm_tpu_torch.main import _make_broker

            self._broker = _make_broker(cfg)
            builder = _resolve_builder(req.get("builder", "standard"))
            topo = builder(cfg, self._broker, device=self.device)
            self.rt = DistRuntime(
                req["name"], topo, cfg, self.index,
                {k: int(v) for k, v in req["placement"].items()},
                {int(k): v for k, v in req["peers"].items()},
            )
            self._submits += 1
            return {"ok": True}
        if cmd == "chaos":
            # Live fault injection: set any subset of the injector's
            # knobs; the answer is always the whole knob and counter
            # snapshot, so a caller can read evidence without arming.
            inj = get_injector()
            if self.rt is not None:
                inj.bind_flight(self.rt.flight)
            knobs = {k: v for k, v in req.items() if k != "cmd"}
            if knobs:
                inj.configure(**knobs)
            return {"ok": True, "chaos": inj.snapshot()}
        if cmd == "shutdown":
            self._stop.set()
            return {"ok": True}
        if cmd == "replay_kernels":
            # The engine's tally counts each replay as its capture's
            # record; this traces one replay of each bucket to hold the
            # record to what the card ran. Call it on an idle topology
            # (after a drain): a replay writes the bucket's buffers.
            if not _PROFILER.acquire(blocking=False):
                raise RuntimeError("a profiler is already running in this worker")
            try:
                return {"index": self.index,
                        "engines": _replay_report(req.get("model"))}
            finally:
                _PROFILER.release()
        if cmd == "profile":
            return self._start_profile(req["log_dir"], float(req["seconds"]))
        if cmd == "decode_sessions":
            # Session sets are disjoint across workers (sticky routing), so
            # the controller adds the rows up.
            if "storm_tpu_torch.decode" not in sys.modules:
                return {"index": self.index,
                        "decode": {"stores": [], "engines": [],
                                   "sessions_live": 0, "tokens_emitted": 0}}
            from storm_tpu_torch.decode import decode_stats

            return {"index": self.index, "decode": decode_stats()}
        if self.rt is None:
            raise RuntimeError(f"{cmd}: no topology submitted")
        if cmd == "start_bolts":
            self._run_on_loop(self.rt.start_bolts())
            return {"ok": True}
        if cmd == "start_spouts":
            self._run_on_loop(self.rt.start_spouts())
            return {"ok": True}
        if cmd == "parallelism":
            return {"parallelism": self.rt.parallelism_of(req["component"])}
        if cmd == "rebalance":
            component = req["component"]
            new = int(req["parallelism"])
            prev = self.rt.parallelism_of(component)
            if self.rt._local(component):
                self._run_on_loop(self.rt.rebalance(component, new))
            else:
                self._run_on_loop(self.rt.resize_remote_group(component, new))
            return {"ok": True, "previous": prev}
        if cmd == "component_stats":
            return {"executors": self.rt.component_stats(req["component"])}
        if cmd == "seek":
            n = self._run_on_loop(self.rt.seek(req["component"], req["position"]))
            return {"ok": True, "instances": n}
        if cmd == "swap_model":
            import dataclasses as _dc

            # An engine's build and warm-up can far exceed the default
            # control timeout; the controller gives it 600 s.
            new_cfg = self._run_on_loop(
                self.rt.swap_model(req["component"], req["model"],
                                   tasks=req.get("tasks")),
                timeout=600.0,
            )
            return {"ok": True, "model": _dc.asdict(new_cfg)}
        if cmd == "update_peer":
            self._run_on_loop(
                self.rt.replace_peer(int(req["idx"]), req["addr"])
            )
            return {"ok": True}
        if cmd == "metrics":
            return {"metrics": self.rt.metrics.snapshot(), **_engine_report()}
        if cmd == "utilization":
            # Busy/wait/flush deltas since the last call with the same key
            # (the cursors live on the runtime) and the outbound queue
            # depths; the controller adds seconds across workers.
            from storm_tpu_torch.obs.capacity import utilization_snapshot

            return {"index": self.index,
                    "utilization": utilization_snapshot(
                        self.rt, key=str(req.get("key", "dist")))}
        if cmd == "copies":
            # Windowed copy-ledger deltas since the last call with the same
            # key; ``reset`` clears every hop, ``cumulative`` returns the
            # lifetime totals (a cursor cannot see a hop born mid-window).
            from storm_tpu_torch.obs import copyledger

            if req.get("reset"):
                copyledger.copy_ledger().reset()
                return {"index": self.index, "copies": {}}
            if req.get("cumulative"):
                return {"index": self.index,
                        "copies": copyledger.copy_ledger().snapshot()}
            return {"index": self.index,
                    "copies": copyledger.copy_snapshot(
                        self.rt, key=str(req.get("key", "dist")))}
        if cmd == "traces":
            # This worker's slice of the trace picture; the controller
            # merges the slices by trace id.
            n = int(req.get("n", 20))
            tracer = getattr(self.rt, "tracer", None)
            flight = getattr(self.rt, "flight", None)
            out: Dict[str, Any] = {"index": self.index}
            if tracer is not None:
                out["slowest"] = tracer.store.slowest(n)
                out["recent"] = tracer.store.recent(n)
                out["open"] = tracer.store.open_records(n)
                out["stats"] = tracer.store.stats()
            if flight is not None:
                out["flight"] = flight.tail(n)
            return out
        if cmd == "health":
            return {"health": self.rt.health()}
        if cmd == "deactivate":
            self._run_on_loop(self.rt.deactivate())
            return {"ok": True}
        if cmd == "activate":
            self._run_on_loop(self.rt.activate())
            return {"ok": True}
        if cmd == "drain":
            ok = self._run_on_loop(
                self.rt.drain(timeout_s=req.get("timeout_s", 30.0))
            )
            return {"ok": bool(ok)}
        if cmd == "drain_worker":
            t = float(req.get("timeout_s", 30.0))
            return self._run_on_loop(
                self.rt.drain_for_restart(timeout_s=t), timeout=t + 60.0)
        if cmd == "kill":
            self._run_on_loop(self.rt.kill(req.get("wait_secs", 0.0)))
            self.rt = None
            return {"ok": True}
        raise ValueError(f"unknown control cmd {cmd!r}")

    def _state_report(self) -> Dict[str, Any]:
        """The worker's self-description, before a submit too (an empty
        worker is adoptable): ``submits`` still 1 after a controller's
        restart shows that no engine was built again."""
        rep: Dict[str, Any] = {
            "ok": True, "index": self.index, "pid": os.getpid(),
            "submits": self._submits, "wire": wire.WIRE_VERSION,
            "device": self.device,
        }
        if shm_lane.available():
            rep["shm"] = shm_lane.host_key()
        rt = self.rt
        if rt is not None:
            rep["topology"] = rt.name
            rep["draining"] = bool(rt._draining)
            rep["parallelism"] = {cid: rt.parallelism_of(cid) for cid in rt.topology.specs}
            if rt.spout_execs:
                rep["active"] = any(e._active for execs in rt.spout_execs.values()
                                    for e in execs)
        return rep

    def _start_profile(self, log_dir: str, seconds: float) -> Dict[str, Any]:
        """A ``torch.profiler`` capture (host and card, every thread) of
        whatever this process runs for ``seconds``, on a thread of its own,
        written to ``<log_dir>/trace.json``; refused while a profiler runs
        here. Answers once the profiler has started (its start takes
        seconds on the card), so what the caller does next is in the
        window."""
        from storm_tpu_torch.runtime.tracing import device_trace

        if not _PROFILER.acquire(blocking=False):
            return {"error": "a profile capture is already running"}
        started = threading.Event()
        failed: List[BaseException] = []

        def capture() -> None:
            try:
                with device_trace(log_dir):
                    started.set()
                    time.sleep(seconds)
            except Exception as e:
                failed.append(e)
                log.exception("profile capture failed")
            finally:
                started.set()
                _PROFILER.release()

        try:
            self._profile_thread = threading.Thread(target=capture, name="profile-capture")
            self._profile_thread.start()
        except BaseException:
            _PROFILER.release()
            raise
        started.wait(timeout=120.0)
        if failed:
            return {"error": f"the profile capture failed to start: {failed[0]!r}"}
        return {"ok": True, "log_dir": log_dir, "seconds": seconds}

    # ---- lifecycle -----------------------------------------------------------

    def serve_forever(self) -> None:
        self._server.start()
        print(json.dumps({"ready": True, "port": self.port, "index": self.index}),
              flush=True)
        threading.Thread(target=self._wait_stop, daemon=True).start()
        try:
            self.loop.run_forever()
        finally:
            self._server.stop()
            # A capture in flight writes its whole trace before the exit.
            t = self._profile_thread
            if t is not None and t.is_alive():
                t.join(timeout=310)

    def _wait_stop(self) -> None:
        self._stop.wait()
        time.sleep(0.2)  # let the shutdown call's answer go out
        self.loop.call_soon_threadsafe(self.loop.stop)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m storm_tpu_torch.dist.worker",
        description="A dist worker process: serves the Deliver, Ack and "
                    "Control methods on --port and prints one JSON ready-line.")
    ap.add_argument("--port", type=int, default=0, help="0 = any free port")
    ap.add_argument("--index", type=int, required=True,
                    help="the worker's index (0..255), the top byte of its ids")
    ap.add_argument("--device", default="cuda",
                    help="where the engines run: cuda (the default) or cpu")
    ap.add_argument("--host", default="0.0.0.0", help="the address to listen on")
    ap.add_argument("--threads", type=int, default=0,
                    help="torch's intra-op threads (0 = its default)")
    args = ap.parse_args(argv)
    logging.basicConfig(level=logging.INFO)
    if args.threads > 0:
        import torch

        torch.set_num_threads(args.threads)
    WorkerServer(args.port, args.index, device=args.device, host=args.host).serve_forever()
    return 0


if __name__ == "__main__":
    sys.exit(main())
