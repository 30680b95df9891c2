"""Stateful bolts, copied from ``storm_tpu/runtime/state.py``: per-task
key-value state with checkpoint and restore (Storm's ``IStatefulBolt`` and
``KeyValueState``).

- One :class:`KeyValueState` per bolt task, owned by the executor's task,
  so a snapshot taken between tuples is consistent.
- Checkpoints every ``topology.checkpoint_interval_s`` and once more at a
  graceful stop; restore happens after ``prepare`` through
  ``init_state`` (Storm's prepare -> initState -> execute order).
- At-least-once: a crash between a state update and the next checkpoint
  replays tuples whose effects were checkpointed, so updates should be
  idempotent or tolerate overcount (the transactional layer,
  :mod:`.transactional`, makes them exact).
- Backends: :class:`MemoryStateBackend` (survives an executor's
  replacement by the supervisor) and :class:`FileStateBackend` (atomic
  JSON files, fsynced with their directory: survives the process).
- State is keyed per (component, task index) and is not migrated when a
  rebalance changes the parallelism.
"""

from __future__ import annotations

import json
import os
import tempfile
from typing import Any, Dict, Iterator, Optional, Tuple as Tup

from storm_tpu_torch.runtime.base import Bolt


class KeyValueState:
    """Dict-like state for one bolt task. Keys and values must be
    JSON-serializable when a :class:`FileStateBackend` is in play."""

    def __init__(self, data: Optional[Dict[str, Any]] = None) -> None:
        self._data: Dict[str, Any] = dict(data or {})
        self.dirty = False

    def get(self, key: str, default: Any = None) -> Any:
        return self._data.get(key, default)

    def put(self, key: str, value: Any) -> None:
        self._data[key] = value
        self.dirty = True

    def delete(self, key: str) -> None:
        if key in self._data:
            del self._data[key]
            self.dirty = True

    def items(self) -> Iterator[Tup[str, Any]]:
        return iter(self._data.items())

    def __len__(self) -> int:
        return len(self._data)

    def __contains__(self, key: str) -> bool:
        return key in self._data

    def snapshot(self) -> Dict[str, Any]:
        """Point-in-time copy (shallow: values are assumed replaced, not
        mutated in place — mutate-in-place values must be re-``put``)."""
        return dict(self._data)


class MemoryStateBackend:
    """Process-local store: state survives executor replacement (the
    supervisor's sweep) but not the process."""

    def __init__(self) -> None:
        self._store: Dict[Tup[str, int], Tup[int, Dict[str, Any]]] = {}

    def save(self, component: str, task: int, version: int,
             snapshot: Dict[str, Any]) -> None:
        self._store[(component, task)] = (version, dict(snapshot))

    def load(self, component: str, task: int) -> Optional[Tup[int, Dict[str, Any]]]:
        got = self._store.get((component, task))
        if got is None:
            return None
        version, snap = got
        return version, dict(snap)


class FileStateBackend:
    """Durable store: one JSON file per (component, task), written
    atomically (tmp + rename), so a crash mid-checkpoint leaves the
    previous checkpoint intact. Survives the process: a topology submitted
    again with the same ``state_dir`` restores it."""

    def __init__(self, state_dir: str) -> None:
        self.state_dir = state_dir
        os.makedirs(state_dir, exist_ok=True)

    def _path(self, component: str, task: int) -> str:
        safe = component.replace("/", "_")
        return os.path.join(self.state_dir, f"{safe}-{task}.json")

    def save(self, component: str, task: int, version: int,
             snapshot: Dict[str, Any]) -> None:
        path = self._path(component, task)
        fd, tmp = tempfile.mkstemp(dir=self.state_dir, suffix=".tmp")
        try:
            with os.fdopen(fd, "w") as f:
                json.dump({"version": version, "data": snapshot}, f)
                f.flush()
                os.fsync(f.fileno())
            os.replace(tmp, path)
            # fsync the directory too: os.replace makes the rename
            # atomic but not durable — a power cut after replace can
            # still lose the directory entry and resurrect the OLD
            # checkpoint (or none) on remount.
            dfd = os.open(self.state_dir, os.O_RDONLY)
            try:
                os.fsync(dfd)
            finally:
                os.close(dfd)
        except BaseException:
            try:
                os.unlink(tmp)
            except OSError:
                pass
            raise

    def load(self, component: str, task: int) -> Optional[Tup[int, Dict[str, Any]]]:
        path = self._path(component, task)
        try:
            with open(path) as f:
                blob = json.load(f)
        except FileNotFoundError:
            return None
        return int(blob["version"]), blob["data"]


def make_backend(state_dir: str):
    """Backend from config: ``topology.state_dir`` set -> durable files,
    empty -> in-memory."""
    return FileStateBackend(state_dir) if state_dir else MemoryStateBackend()


class StatefulBolt(Bolt):
    """Bolt with framework-managed state (Storm's ``IStatefulBolt``).

    Subclasses implement :meth:`init_state` (called once per task after
    ``prepare``, with restored state on a restart) and use ``self.state``
    in ``execute``. The executor checkpoints periodically and on graceful
    stop; :meth:`pre_checkpoint` runs immediately before each snapshot so
    bolts can fold transient aggregates into the state."""

    state: KeyValueState

    def init_state(self, state: KeyValueState) -> None:
        self.state = state

    def pre_checkpoint(self) -> None:
        """Hook: flush in-flight aggregates into ``self.state`` before the
        snapshot is taken."""

    def checkpoint_now(self) -> None:
        """Force an immediate state snapshot. Bound to the executor's
        checkpoint when running inside a topology; a no-op for bolts driven
        standalone (tests). Transactional bolts call this before acking."""
