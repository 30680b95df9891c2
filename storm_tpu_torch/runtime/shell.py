"""Multilang components, copied from ``storm_tpu/runtime/shell.py``:
Storm's ShellBolt and ShellSpout protocol on asyncio.

- messages are one JSON object followed by a line ``end``;
- handshake: the host sends ``{"conf", "context", "pidDir"}``, the child
  answers ``{"pid": N}``;
- tuples go down as ``{"id", "comp", "stream", "task", "tuple"}``; the
  child answers ``{"command": "emit"|"ack"|"fail"|"log", ...}``;
- heartbeats ride the ``__heartbeat__`` stream and the child answers
  ``{"command": "sync"}``; a wedged child fails its pending tuples and the
  next tuple starts a fresh one.

The Python child side is :mod:`storm_tpu_torch.multilang`; any language
can speak the same framing. ``execute`` ships the tuple and returns; a
reader task routes the child's acks, fails and emits back through the
collector, and emits anchor to the child's ``anchors`` ids.
"""

from __future__ import annotations

import asyncio
import json
import logging
import tempfile
import time
from typing import Any, Dict, List, Optional

from storm_tpu_torch.runtime.base import Bolt, OutputCollector, Spout, TopologyContext
from storm_tpu_torch.runtime.tuples import Tuple, Values, new_id

log = logging.getLogger("storm_tpu_torch.shell")


def _close_subprocess_transport(proc) -> None:
    """Best-effort close of an asyncio subprocess transport so its
    ``__del__`` never runs against a closed loop. Reaches into ``_transport``
    because :class:`asyncio.subprocess.Process` exposes no public close."""
    transport = getattr(proc, "_transport", None)
    if transport is not None:
        try:
            transport.close()
        except RuntimeError:
            pass  # loop already closed: nothing better is possible here


class _ShellProtocol:
    """Shared multilang framing: spawn + handshake, newline-JSON send, and
    end-terminated reads — one copy for bolt and spout hosts."""

    command: tuple
    _proc: Optional[asyncio.subprocess.Process]

    async def _send(self, obj: Dict[str, Any]) -> None:
        self._proc.stdin.write(json.dumps(obj).encode() + b"\nend\n")
        await self._proc.stdin.drain()

    async def _read_msg(self) -> Optional[Dict[str, Any]]:
        lines: List[bytes] = []
        while True:
            line = await self._proc.stdout.readline()
            if not line:
                return None  # child exited
            if line.strip() == b"end":
                break
            lines.append(line)
        try:
            return json.loads(b"".join(lines))
        except ValueError:
            raise RuntimeError(
                f"shell component sent non-JSON: {b''.join(lines)[:200]!r}")

    async def _spawn(self, conf: Dict[str, Any]) -> None:
        self._proc = await asyncio.create_subprocess_exec(
            *self.command,
            stdin=asyncio.subprocess.PIPE,
            stdout=asyncio.subprocess.PIPE,
        )
        ctx = self.context
        await self._send({
            "conf": conf,
            "pidDir": tempfile.gettempdir(),
            "context": {
                "componentid": ctx.component_id,
                "taskid": ctx.task_index,
                "parallelism": ctx.parallelism,
            },
        })
        hello = await self._read_msg()
        if hello is None or "pid" not in hello:
            raise RuntimeError(
                f"shell component {self.command} failed the handshake: {hello}")

    def _terminate(self) -> None:
        """Kill + asynchronously reap + close the transport.

        An unawaited child leaves the transport open (ResourceWarning);
        a transport still open when its loop closes raises "Event loop is
        closed" from ``BaseSubprocessTransport.__del__`` at gc time — so
        the transport is ALWAYS closed: immediately when the child has
        already exited, or from the reaper's done-callback (which still
        runs during loop shutdown's cancellation sweep) otherwise."""
        proc, self._proc = self._proc, None
        if proc is None:
            return
        if proc.returncode is None:
            try:
                proc.kill()
            except ProcessLookupError:
                pass
            try:
                loop = asyncio.get_event_loop()
                task = loop.create_task(proc.wait())
                task.add_done_callback(
                    lambda _t, p=proc: _close_subprocess_transport(p))
                self._reaper = task
                return
            except RuntimeError:
                pass  # no loop: interpreter shutdown; close directly
        _close_subprocess_transport(proc)


class ShellBolt(_ShellProtocol, Bolt):
    """Run a subprocess component over the multilang protocol.

    ``ShellBolt("python", "my_bolt.py")`` — the command is executed once
    per task; output fields default to ``("message",)`` unless
    ``output_fields`` says otherwise."""

    def __init__(self, *command: str,
                 output_fields: tuple = ("message",),
                 heartbeat_s: float = 10.0) -> None:
        if not command:
            raise ValueError("ShellBolt needs a command")
        self.command = tuple(command)
        self.output_fields = tuple(output_fields)
        self.heartbeat_s = heartbeat_s

    def clone(self) -> "ShellBolt":
        return ShellBolt(*self.command, output_fields=self.output_fields,
                         heartbeat_s=self.heartbeat_s)

    def declare_output_fields(self):
        return {"default": self.output_fields}

    def prepare(self, context: TopologyContext, collector: OutputCollector) -> None:
        super().prepare(context, collector)
        self._proc: Optional[asyncio.subprocess.Process] = None
        self._pending: Dict[str, Tuple] = {}
        self._reader_task: Optional[asyncio.Task] = None
        self._hb_task: Optional[asyncio.Task] = None
        self._last_reply = time.monotonic()

    # ---- protocol plumbing ---------------------------------------------------

    async def _start(self) -> None:
        ctx = self.context
        await self._spawn({"topology.name": getattr(ctx.config, "topology", None)
                           and ctx.config.topology.name})
        self._last_reply = time.monotonic()
        self._reader_task = asyncio.get_running_loop().create_task(self._reader())
        if self.heartbeat_s > 0:
            self._hb_task = asyncio.get_running_loop().create_task(
                self._heartbeats())

    def _child_gone(self) -> None:
        """Fail in-flight tuples and mark the child for respawn: the next
        execute() starts a fresh process (executor supervision only replaces
        bolts whose asyncio task dies, which a caught child crash is not)."""
        for t in list(self._pending.values()):
            self.collector.fail(t)
        self._pending.clear()
        self._terminate()

    async def _reader(self) -> None:
        try:
            while True:
                msg = await self._read_msg()
                if msg is None:
                    self._child_gone()  # child died -> tuples replay
                    return
                self._last_reply = time.monotonic()
                cmd = msg.get("command")
                if cmd == "ack":
                    t = self._pending.pop(str(msg.get("id")), None)
                    if t is not None:
                        self.collector.ack(t)
                elif cmd == "fail":
                    t = self._pending.pop(str(msg.get("id")), None)
                    if t is not None:
                        self.collector.fail(t)
                elif cmd == "emit":
                    anchors = [self._pending[str(a)]
                               for a in msg.get("anchors", [])
                               if str(a) in self._pending]
                    await self.collector.emit(
                        Values(list(msg.get("tuple", []))),
                        stream=msg.get("stream") or "default",
                        anchors=anchors,
                    )
                    if msg.get("need_task_ids", True):
                        # Storm replies with a bare JSON array of task ids
                        self._proc.stdin.write(b"[0]\nend\n")
                        await self._proc.stdin.drain()
                elif cmd == "log":
                    log.info("[%s/%s] %s", self.context.component_id,
                             self.context.task_index, msg.get("msg"))
                elif cmd == "sync":
                    pass  # heartbeat reply; _last_reply already bumped
                else:
                    log.warning("unknown shell command %r", cmd)
        except asyncio.CancelledError:
            raise
        except Exception as e:
            # framing corruption (stray child output) must be loud: report,
            # fail in-flight, respawn on next tuple — never a silent hang
            self.collector.report_error(e)
            self._child_gone()

    async def _heartbeats(self) -> None:
        while True:
            await asyncio.sleep(self.heartbeat_s)
            if time.monotonic() - self._last_reply > 2 * self.heartbeat_s:
                # wedged child: fail in-flight tuples; the next execute()
                # respawns a fresh process
                log.error("shell component %s unresponsive; failing %d tuples",
                          self.command, len(self._pending))
                self._child_gone()
                return
            try:
                await self._send({"id": new_id(), "comp": None,
                                  "stream": "__heartbeat__", "task": -1,
                                  "tuple": []})
            except (ConnectionError, BrokenPipeError):
                return

    # ---- bolt surface --------------------------------------------------------

    async def execute(self, t: Tuple) -> None:
        if self._proc is None or self._proc.returncode is not None:
            if self._hb_task is not None:
                self._hb_task.cancel()
            await self._start()
        tid = str(new_id())
        self._pending[tid] = t
        await self._send({
            "id": tid,
            "comp": t.source_component,
            "stream": t.stream,
            "task": t.source_task,
            "tuple": list(t.values),
        })

    async def flush(self) -> None:
        deadline = time.monotonic() + 10
        while self._pending and time.monotonic() < deadline:
            await asyncio.sleep(0.02)

    def cleanup(self) -> None:
        for task in (self._reader_task, self._hb_task):
            if task is not None:
                task.cancel()
        self._terminate()


class ShellSpout(_ShellProtocol, Spout):
    """Run a subprocess SOURCE over the multilang protocol (Storm's
    ShellSpout): the host sends ``{"command": "next"}`` / ``ack`` / ``fail``
    control messages; the child replies with zero or more ``emit`` commands
    followed by ``{"command": "sync"}``.

    Child emits carry their own ``id`` for at-least-once tracking; acks and
    fails are forwarded back into the child, which owns replay policy
    (exactly Storm's contract)."""

    def __init__(self, *command: str,
                 output_fields: tuple = ("message",),
                 drive_timeout_s: float = 30.0) -> None:
        if not command:
            raise ValueError("ShellSpout needs a command")
        self.command = tuple(command)
        self.output_fields = tuple(output_fields)
        self.drive_timeout_s = drive_timeout_s

    def clone(self) -> "ShellSpout":
        return ShellSpout(*self.command, output_fields=self.output_fields,
                          drive_timeout_s=self.drive_timeout_s)

    def declare_output_fields(self):
        return {"default": self.output_fields}

    def open(self, context: TopologyContext, collector: OutputCollector) -> None:
        super().open(context, collector)
        self._proc: Optional[asyncio.subprocess.Process] = None
        self._closed = False
        # next/ack/fail each do a full request->sync round trip on one
        # pipe; interleaving them would cross-read replies
        self._drive_lock = asyncio.Lock()

    async def _drive(self, command: Dict[str, Any], respawn: bool = True) -> int:
        """Send one control command; emit until the child syncs.

        A wedged child (no reply within drive_timeout_s), a dead pipe, or
        framing corruption kills the child and resets for respawn on the
        next drive — reported, never a silent desync. ``respawn=False``
        (ack/fail) never starts a fresh child: a new process has no record
        of the id being acked."""
        async with self._drive_lock:
            if self._closed:
                return 0
            try:
                return await self._drive_locked(command, respawn)
            except asyncio.CancelledError:
                raise
            except Exception as e:
                self.collector.report_error(e)
                self._terminate()
                return 0

    async def _drive_locked(self, command: Dict[str, Any],
                            respawn: bool) -> int:
        if self._proc is None or self._proc.returncode is not None:
            if not respawn:
                return 0
            await self._spawn({})
        # Timeouts bound the CHILD's replies only; collector.emit may wait
        # on downstream backpressure indefinitely, which is healthy.
        await asyncio.wait_for(self._send(command), self.drive_timeout_s)
        emitted = 0
        while True:
            msg = await asyncio.wait_for(self._read_msg(), self.drive_timeout_s)
            if msg is None:
                self._proc = None  # child died; respawn on next drive
                return emitted
            cmd = msg.get("command")
            if cmd == "sync":
                return emitted
            if cmd == "emit":
                await self.collector.emit(
                    Values(list(msg.get("tuple", []))),
                    stream=msg.get("stream") or "default",
                    msg_id=msg.get("id"),
                )
                emitted += 1
                if msg.get("need_task_ids", True):
                    self._proc.stdin.write(b"[0]\nend\n")
                    await self._proc.stdin.drain()
            elif cmd == "log":
                log.info("[%s/%s] %s", self.context.component_id,
                         self.context.task_index, msg.get("msg"))
            else:
                log.warning("unknown shell spout command %r", cmd)

    async def next_tuple(self) -> bool:
        return await self._drive({"command": "next"}) > 0

    def ack(self, msg_id: Any) -> None:
        self._bg(self._drive({"command": "ack", "id": msg_id}, respawn=False))

    def fail(self, msg_id: Any) -> None:
        self._bg(self._drive({"command": "fail", "id": msg_id}, respawn=False))

    def _bg(self, coro) -> None:
        # ack/fail are sync spout callbacks; the protocol round trip runs
        # as a task (strong ref kept: create_task results are weak)
        if not hasattr(self, "_bg_tasks"):
            self._bg_tasks = set()
        task = asyncio.get_event_loop().create_task(coro)
        self._bg_tasks.add(task)
        task.add_done_callback(self._bg_tasks.discard)

    def close(self) -> None:
        self._closed = True  # queued ack/fail drives must not respawn
        if hasattr(self, "_bg_tasks"):
            for task in list(self._bg_tasks):
                task.cancel()
        self._terminate()
