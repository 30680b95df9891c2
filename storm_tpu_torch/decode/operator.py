"""DecodeBolt, copied from ``storm_tpu/decode/operator.py``: the stateful
decode operator, on the port's :class:`~storm_tpu_torch.runtime.state.
StatefulBolt` and its engine on the card.

One input tuple is one session request, ``{"session_id", "prompt",
"max_new_tokens"}``. The bolt answers with a stream, one anchored emit
per generated token ``(message, session_id, token_index)``, and acks the
request when the session completes, so a lost token fails the whole tree
and the spout replays the request, not a token.

Exactly-once across that replay is the ``committed`` watermark
(:mod:`storm_tpu_torch.decode.session`): a token is emitted, then
``committed`` advances and the session folds into bolt state through
``checkpoint_now()`` every ``commit_every`` tokens. A replayed request
emits exactly ``tokens[committed:]``, from the log where it has them
(greedy decode is deterministic) and recomputed otherwise, and never
re-emits below the watermark.

Sessions are sticky: the topology routes requests with
``ring_fields_grouping`` on ``session_id``. Draining a task in
``drain_mode="migrate"`` suspends live sessions at their next commit
boundary, folds token log, watermark and serialized KV into the final
checkpoint and fails the unacked requests; the replacement restores the
sessions (``restored="kv"``) and resumes without re-running prefill.

Every task of a process shares one engine, arena and continuous queue
(``continuous_for``), so prefill rows, steps and ``slot = -1`` classify
rows co-batch there. ``device``: where that engine runs (default
``cuda``; pass ``"cpu"`` for the CPU).
"""

from __future__ import annotations

import asyncio
import json
import time
from dataclasses import dataclass, field
from typing import Any, Dict, List, Optional, Set

import numpy as np

from storm_tpu_torch.config import BatchConfig, QosConfig
from storm_tpu_torch.infer.continuous import continuous_for
from storm_tpu_torch.models import chartiny as ct
from storm_tpu_torch.runtime.base import OutputCollector, Spout, TopologyContext
from storm_tpu_torch.runtime.state import KeyValueState, StatefulBolt
from storm_tpu_torch.runtime.tuples import Tuple, Values
from storm_tpu_torch.decode.engine import shared_decode_engine
from storm_tpu_torch.decode.session import (
    DecodeSession, SessionStore, state_kv_blob)

__all__ = ["DecodeConfig", "DecodeBolt", "SessionSpout", "InjectedFailure"]

_STATE_PREFIX = "sess:"


class InjectedFailure(RuntimeError):
    """Deterministic mid-stream failure (the exactly-once audit's knife)."""


class _Drained(RuntimeError):
    """Session suspended at a commit boundary for migration."""


@dataclass
class DecodeConfig:
    """Decode tier knobs."""

    arena_blocks: int = 32          # KV slots per engine replica
    max_seq: int = ct.MAX_SEQ       # arena sequence capacity
    max_new_tokens: int = 16        # default per-session budget
    commit_every: int = 1           # tokens per watermark checkpoint
    early_exit_threshold: Optional[float] = None  # cascade knob; None=off
    seed: int = 0                   # char_tiny weights seed
    migrate_kv: bool = True         # serialize KV into checkpoints
    drain_mode: str = "migrate"     # "migrate" | "complete"
    retain_done: int = 256          # done sessions kept for follow-up turns
    batch: BatchConfig = field(default_factory=lambda: BatchConfig(
        max_batch=32, max_wait_ms=2.0, buckets=(8, 32)))


class DecodeBolt(StatefulBolt):
    """KV-cache decode operator: one task owns the sessions the ring
    hashes to it, all tasks in a process share one engine + arena +
    continuous queue (prefill rows, per-token steps, and ``slot=-1``
    classify rows co-batch there)."""

    def __init__(self, cfg: Optional[DecodeConfig] = None,
                 qos: Optional[QosConfig] = None, device=None) -> None:
        self.cfg = cfg or DecodeConfig()
        self.qos = qos
        self.device = device
        # Test hook: raise InjectedFailure after N freshly-emitted tokens
        # (one-shot; at a commit boundary, so the audit window is closed).
        self.fail_after_tokens: Optional[int] = None

    def declare_output_fields(self):
        return {"default": ("message", "session_id", "token_index")}

    # ---- lifecycle -----------------------------------------------------------

    def prepare(self, context: TopologyContext,
                collector: OutputCollector) -> None:
        super().prepare(context, collector)
        c = self.cfg
        self.engine = shared_decode_engine(
            seed=c.seed, blocks=c.arena_blocks, max_seq=c.max_seq,
            early_exit_threshold=c.early_exit_threshold, device=self.device)
        self.engine.kv.on_evict = self._on_evict
        self.batcher = continuous_for(self.engine, c.batch, self.qos)
        self.sessions = SessionStore(context.component_id,
                                     context.task_index)
        self._tasks: Set[asyncio.Task] = set()
        self._locks: Dict[str, asyncio.Lock] = {}
        self._draining = False
        m, cid = context.metrics, context.component_id
        self.batcher.bind(m, cid, tracer=context.tracer,
                          flight=context.flight)
        self._m_ttft = m.histogram(cid, "decode_ttft_ms")
        self._m_token = m.histogram(cid, "decode_token_ms")
        self._m_tokens = m.counter(cid, "decode_tokens_emitted")
        self._m_sessions = m.counter(cid, "decode_sessions_started")
        self._m_evicted = m.counter(cid, "decode_sessions_evicted")
        self._m_migrated = m.counter(cid, "decode_sessions_migrated")
        self._m_early = m.counter(cid, "decode_early_exits")
        self._m_arena = m.gauge(cid, "kv_arena_occupancy")
        self._flight = context.flight

    def init_state(self, state: KeyValueState) -> None:
        """Restore checkpointed sessions (prepare has already run — the
        engine/arena exist). KV blobs land back in the arena so resumed
        sessions skip re-prefill entirely."""
        super().init_state(state)
        for key, snap in list(state.items()):
            if not key.startswith(_STATE_PREFIX):
                continue
            sess = DecodeSession.from_state(snap)
            if sess.done:
                self.sessions.put(sess)
                continue
            blob = state_kv_blob(snap)
            if blob is not None and self.cfg.migrate_kv:
                try:
                    self.engine.kv.restore(sess.session_id, blob)
                    sess.restored = "kv"
                except ValueError:
                    sess.restored = "log"  # dims drifted: warm re-prefill
            else:
                sess.restored = "log"
            self.sessions.put(sess)
            self.sessions.sessions_restored += 1
            if sess.restored == "kv":
                self._m_migrated.inc()
                if self._flight is not None:
                    self._flight.event(
                        "decode_session_migrated",
                        session=sess.session_id,
                        cached_rows=len(sess.context),
                        committed=sess.committed)

    # ---- request path --------------------------------------------------------

    async def execute(self, t: Tuple) -> None:
        req = self._parse(t)
        if req is None:
            self.collector.ack(t)  # unparseable: drop, don't wedge
            return
        task = asyncio.create_task(self._run_session(t, req))
        self._tasks.add(task)
        task.add_done_callback(self._tasks.discard)

    @staticmethod
    def _parse(t: Tuple) -> Optional[dict]:
        v = t.values[0] if len(t.values) else None
        if isinstance(v, (bytes, bytearray)):
            v = v.decode("utf-8", "replace")
        if isinstance(v, str):
            try:
                v = json.loads(v)
            except ValueError:
                return None
        if not isinstance(v, dict) or "session_id" not in v:
            return None
        return v

    async def _run_session(self, t: Tuple, req: dict) -> None:
        sid = str(req["session_id"])
        lock = self._locks.setdefault(sid, asyncio.Lock())
        t_arrive = time.perf_counter()
        async with lock:
            try:
                want = int(req.get("max_new_tokens",
                                   self.cfg.max_new_tokens))
                sess = self.sessions.get(sid)
                if sess is None:
                    prompt = [ct.BOS] + ct.encode_text(
                        str(req.get("prompt", "")))
                    budget = max(
                        0, min(want, self.cfg.max_seq - 1 - len(prompt)))
                    sess = self.sessions.get_or_create(sid, prompt, budget)
                    if not sess.restored:
                        self.sessions.sessions_cold += 1
                    self._m_sessions.inc()
                    if self._flight is not None:
                        self._flight.event(
                            "decode_session_started", session=sid,
                            prompt_len=len(sess.prompt),
                            max_new_tokens=sess.max_new_tokens,
                            restored=sess.restored or "fresh")
                elif sess.done:
                    # Follow-up turn on a finished session: extend the
                    # budget and resume on the retained KV prefix
                    # (multi-turn serving — no re-prefill unless the
                    # arena evicted the slot meanwhile). EOS-terminated
                    # and context-capacity-exhausted sessions stay done.
                    cap = self.cfg.max_seq - 1 - len(sess.prompt)
                    sess.max_new_tokens = min(
                        len(sess.tokens) + want, cap)
                    if (sess.max_new_tokens > len(sess.tokens)
                            and sess.tokens[-1:] != [ct.EOS]):
                        sess.done = False
                await self._generate(t, sess, t_arrive)
            except _Drained:
                # Suspended at a commit boundary: the final checkpoint
                # carries the session; fail -> the spout replays the
                # request to whoever holds the sessions next.
                self.collector.fail(t)
            except InjectedFailure:
                self.collector.fail(t)  # the audit's deterministic crash
            except Exception:
                import logging

                logging.getLogger("storm_tpu_torch.decode").exception(
                    "decode session %s failed; request will replay", sid)
                self.collector.fail(t)
            finally:
                self._m_arena.set(
                    self.engine.kv.occupancy()["utilization"])

    async def _generate(self, t: Tuple, sess: DecodeSession,
                        t_arrive: float) -> None:
        """Drive ``sess`` to completion: re-emit the uncommitted tail of
        the log first (replay), then generate. Acks the request tuple
        when the session is done."""
        emitted_fresh = 0
        last_logits: Optional[np.ndarray] = None
        while not sess.done:
            if self._draining and self.cfg.drain_mode == "migrate":
                raise _Drained(sess.session_id)
            if sess.committed < len(sess.tokens):
                # Replay tail: already generated by a previous attempt,
                # never committed. No compute — the log is the oracle.
                idx = sess.committed
                await self._commit(t, sess, sess.tokens[idx], idx,
                                   t_arrive)
                continue
            if (len(sess.tokens) >= sess.max_new_tokens
                    or (sess.tokens and sess.tokens[-1] == ct.EOS)):
                break
            if last_logits is None:
                last_logits = await self._ensure_prefix(sess)
            step_t0 = time.perf_counter()
            token = int(np.argmax(last_logits))
            idx = len(sess.tokens)
            sess.tokens.append(token)
            await self._commit(t, sess, token, idx, t_arrive)
            emitted_fresh += 1
            self._m_token.observe(
                (time.perf_counter() - step_t0) * 1e3)
            if (self.fail_after_tokens is not None
                    and emitted_fresh >= self.fail_after_tokens):
                self.fail_after_tokens = None  # one-shot
                raise InjectedFailure(
                    f"injected after {emitted_fresh} tokens of "
                    f"{sess.session_id}")
            if token == ct.EOS or len(sess.tokens) >= sess.max_new_tokens:
                break
            # Next step: feed the fresh token at the next position.
            slot = await self._ensure_slot(sess)
            pos = len(sess.context) - 1  # the fresh token's position
            self.engine.kv.pin(sess.session_id)
            try:
                sub = self.batcher.submit(
                    np.array([[slot, token, pos]], np.int64),
                    source=f"decode:{sess.session_id}")
                out = await asyncio.wrap_future(sub.future)
            finally:
                self.engine.kv.unpin(sess.session_id)
            last_logits = out[-1]
        sess.done = True
        # The KV slot is RETAINED: a follow-up turn resumes warm, and a
        # done session's slot is the cost-aware evictor's cheapest victim
        # once it goes idle. Explicit frees happen in _prune_done.
        self.state.put(_STATE_PREFIX + sess.session_id, sess.to_state())
        self.checkpoint_now()
        self._prune_done()
        self.collector.ack(t)

    async def _ensure_slot(self, sess: DecodeSession) -> int:
        """The session's slot, re-prefilling its context after an
        eviction (warm rebuild from the log: no token re-emitted)."""
        slot = self.engine.kv.slot_of(sess.session_id)
        if slot is not None and int(self.engine.kv.lens[slot]) >= len(
                sess.context) - 1:
            return slot
        await self._ensure_prefix(sess)
        return self.engine.kv.slot_of(sess.session_id)

    async def _ensure_prefix(self, sess: DecodeSession) -> np.ndarray:
        """Make the arena cover ``sess.context`` and return next-token
        logits. Fresh sessions prefill the whole prompt as ONE
        submission (co-batched); KV-restored sessions skip straight to a
        single last-token step; evicted/log-restored sessions rebuild
        warm."""
        ctx = sess.context
        slot = self.engine.kv.acquire(sess.session_id)
        have = int(self.engine.kv.lens[slot])
        # Always (re)feed at least the last token so the step returns
        # logits for the next position.
        start = min(have, len(ctx) - 1)
        rows = self.engine.prefill_rows(slot, ctx[start:], start=start)
        self.engine.kv.pin(sess.session_id)
        try:
            sub = self.batcher.submit(
                rows, source=f"decode:{sess.session_id}")
            out = await asyncio.wrap_future(sub.future)
        finally:
            self.engine.kv.unpin(sess.session_id)
        return out[-1]

    async def _commit(self, t: Tuple, sess: DecodeSession, token: int,
                      idx: int, t_arrive: float) -> None:
        """Emit one token anchored to the request, advance the watermark,
        and checkpoint at the commit cadence."""
        await self.collector.emit(
            Values([ct.decode_tokens([token]), sess.session_id, idx]),
            anchors=[t])
        if sess.ttft_ms is None:
            sess.ttft_ms = (time.perf_counter() - t_arrive) * 1e3
            self._m_ttft.observe(sess.ttft_ms)
        sess.committed = idx + 1
        self.sessions.tokens_emitted += 1
        self._m_tokens.inc()
        if sess.committed % max(1, self.cfg.commit_every) == 0:
            self.state.put(_STATE_PREFIX + sess.session_id,
                           sess.to_state())
            self.checkpoint_now()

    def _prune_done(self) -> None:
        """Bound the done-session retention set: oldest finished sessions
        give up their KV slot, store entry, and state key."""
        done = [s for s in self.sessions.all() if s.done]
        excess = len(done) - max(0, self.cfg.retain_done)
        if excess <= 0:
            return
        done.sort(key=lambda s: s.created)
        for s in done[:excess]:
            self.engine.kv.release(s.session_id)
            self.sessions.remove(s.session_id)
            self.state.delete(_STATE_PREFIX + s.session_id)
            self._locks.pop(s.session_id, None)

    # ---- eviction / checkpoint / drain ---------------------------------------

    def _on_evict(self, session_id: str, cached_len: int) -> None:
        self._m_evicted.inc()
        if self._flight is not None:
            self._flight.event("decode_session_evicted",
                               session=session_id,
                               cached_rows=cached_len)

    def pre_checkpoint(self) -> None:
        self._fold_sessions(include_kv=self.cfg.migrate_kv)

    def _fold_sessions(self, include_kv: bool) -> None:
        sessions = self.sessions.all()
        # One read of the arena for every live session's KV (storm_tpu
        # serializes each from its host arena in turn).
        blobs = self.engine.kv.serialize_many(
            [s.session_id for s in sessions if not s.done]) if include_kv else {}
        for sess in sessions:
            self.state.put(_STATE_PREFIX + sess.session_id,
                           sess.to_state(blobs.get(sess.session_id)))

    async def tick(self) -> None:
        occ = self.engine.kv.occupancy()
        self._m_arena.set(occ["utilization"])
        with self.engine._lock:
            early = self.engine.early_exits
        # counter semantics: publish the engine's monotone total
        delta = early - self._m_early.value
        if delta > 0:
            self._m_early.inc(int(delta))

    async def flush(self) -> None:
        """Drain: ``migrate`` suspends live sessions at their next commit
        boundary and folds token log + watermark + KV into the final
        checkpoint (the executor checkpoints right after flush);
        ``complete`` lets them run out."""
        if self.cfg.drain_mode == "migrate":
            self._draining = True
        if self._tasks:
            await asyncio.gather(*list(self._tasks),
                                 return_exceptions=True)
        self.batcher.flush()
        self._fold_sessions(include_kv=self.cfg.migrate_kv
                            and self.cfg.drain_mode == "migrate")

    def cleanup(self) -> None:
        self._draining = True


class SessionSpout(Spout):
    """Replayable request spout for decode tests and chip_smoke.py: one
    emitted tuple per session request, ``session_id`` as a first-class
    field so ``ring_fields_grouping`` can hash it. Failed requests
    replay up to ``max_replays`` times (at-least-once; the bolt's
    committed watermark makes the token stream exactly-once)."""

    def __init__(self, requests: List[dict], max_replays: int = 3) -> None:
        self.requests = list(requests)
        self.max_replays = max_replays

    def declare_output_fields(self):
        return {"default": ("message", "session_id")}

    def open(self, context: TopologyContext,
             collector: OutputCollector) -> None:
        super().open(context, collector)
        n = context.parallelism
        self.queue = [r for i, r in enumerate(self.requests)
                      if i % n == context.task_index]
        self.acked: List[str] = []
        self.failed: List[str] = []
        self._replays: Dict[str, int] = {}
        self._inflight: Dict[str, dict] = {}

    async def next_tuple(self) -> bool:
        if not self.queue:
            return False
        req = self.queue.pop(0)
        sid = str(req["session_id"])
        self._inflight[sid] = req
        await self.collector.emit(Values([req, sid]), msg_id=sid)
        return True

    def ack(self, msg_id: Any) -> None:
        self.acked.append(msg_id)
        self._inflight.pop(msg_id, None)

    def fail(self, msg_id: Any) -> None:
        self.failed.append(msg_id)
        req = self._inflight.get(msg_id)
        if req is None:
            return
        n = self._replays.get(msg_id, 0)
        if n < self.max_replays:
            self._replays[msg_id] = n + 1
            self.queue.append(req)
