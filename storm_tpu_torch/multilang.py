"""The child side of the multilang protocol, copied from
``storm_tpu/multilang.py`` (Storm's ``storm.py``). Standard library only.

Import it inside a shell component's subprocess (the host side is
:class:`storm_tpu_torch.runtime.shell.ShellBolt`). Messages are JSON
objects, each followed by a line ``end``, on stdin and stdout. A bolt::

    from storm_tpu_torch.multilang import ShellComponent

    class Doubler(ShellComponent):
        def process(self, tup):
            self.emit([tup["tuple"][0] * 2], anchors=[tup["id"]])
            self.ack(tup["id"])

    Doubler().run()
"""

from __future__ import annotations

import json
import os
import sys
from typing import Any, Dict, List, Optional


class ShellComponent:
    """Base class: handshake on construction, ``run()`` loops forever."""

    def __init__(self) -> None:
        # Keep the REAL stdout for the protocol and point sys.stdout at
        # stderr, exactly like Storm's storm.py: a user print() in
        # process() must never corrupt the newline-JSON framing.
        self._out = sys.stdout
        sys.stdout = sys.stderr
        self.setup = self._read()  # {"conf", "context", "pidDir"}
        self.conf = self.setup.get("conf", {})
        self.context = self.setup.get("context", {})
        self._send({"pid": os.getpid()})

    # ---- framing -------------------------------------------------------------

    def _read(self) -> Dict[str, Any]:
        lines: List[str] = []
        while True:
            line = sys.stdin.readline()
            if not line:
                sys.exit(0)  # host closed stdin: clean shutdown
            if line.strip() == "end":
                break
            lines.append(line)
        return json.loads("".join(lines))

    def _send(self, obj: Dict[str, Any]) -> None:
        self._out.write(json.dumps(obj) + "\nend\n")
        self._out.flush()

    # ---- component surface ---------------------------------------------------

    def emit(self, values: List[Any], anchors: Optional[List[str]] = None,
             stream: Optional[str] = None, id: Optional[str] = None) -> None:
        msg: Dict[str, Any] = {
            "command": "emit",
            "tuple": list(values),
            "need_task_ids": False,  # we don't route; skip the reply round trip
        }
        if anchors:
            msg["anchors"] = list(anchors)
        if stream:
            msg["stream"] = stream
        if id is not None:
            msg["id"] = id  # spout emits: at-least-once tracking id
        self._send(msg)

    def ack(self, tuple_id: str) -> None:
        self._send({"command": "ack", "id": tuple_id})

    def fail(self, tuple_id: str) -> None:
        self._send({"command": "fail", "id": tuple_id})

    def log(self, msg: str) -> None:
        self._send({"command": "log", "msg": str(msg)})

    # ---- lifecycle -----------------------------------------------------------

    def process(self, tup: Dict[str, Any]) -> None:
        raise NotImplementedError

    def run(self) -> None:
        while True:
            tup = self._read()
            if isinstance(tup, list):
                continue  # bare task-ids reply to an emit (Storm framing)
            if tup.get("stream") == "__heartbeat__":
                self._send({"command": "sync"})
                continue
            self.process(tup)


class ShellSpoutComponent(ShellComponent):
    """Child-side SOURCE: override ``next`` (emit zero or more tuples with
    ids), ``on_ack``/``on_fail`` for replay policy. The host drives the
    next/ack/fail cycle; each cycle ends with the automatic ``sync``."""

    def next(self) -> None:
        raise NotImplementedError

    def on_ack(self, tuple_id: str) -> None:
        pass

    def on_fail(self, tuple_id: str) -> None:
        pass

    def run(self) -> None:
        while True:
            msg = self._read()
            if isinstance(msg, list):
                continue  # bare task-ids reply
            cmd = msg.get("command")
            if cmd == "next":
                self.next()
            elif cmd == "ack":
                self.on_ack(msg.get("id"))
            elif cmd == "fail":
                self.on_fail(msg.get("id"))
            self._send({"command": "sync"})
