"""Stream groupings, copied from ``storm_tpu/runtime/groupings.py``: how
an emitted tuple picks its downstream executor instances. The whole Storm
family: shuffle, local-or-shuffle, fields, all, global, partial key, none
and direct. Fields routing hashes the key with :func:`stable_hash`, so the
same key reaches the same task index in both packages and in every
process, whatever its hash salt.
"""

from __future__ import annotations

import random
import zlib
from typing import Sequence

from storm_tpu_torch.runtime.tuples import Tuple


def stable_hash(key: object) -> int:
    """Process-stable, value-based key hash (Python's ``hash()`` is
    salted per process). Primitives and containers of them are encoded
    canonically; anything else falls back to ``hash()``."""
    return zlib.crc32(_canonical(key))


def _canonical(v: object) -> bytes:
    if v is None or isinstance(v, (bool, int, float, str, bytes)):
        return f"{type(v).__name__}:{v!r};".encode("utf-8", "surrogatepass")
    if isinstance(v, (tuple, list)):
        return b"seq:" + b"".join(_canonical(x) for x in v) + b";"
    return f"obj:{hash(v)};".encode()


class Grouping:
    """Chooses target instance indices among ``n`` downstream executors."""

    def prepare(self, n: int) -> None:
        self.n = n

    def choose(self, t: Tuple) -> Sequence[int]:
        raise NotImplementedError


class ShuffleGrouping(Grouping):
    """Round-robin from a random start: uniform load, no key affinity."""

    def prepare(self, n: int) -> None:
        self.n = n
        self._i = random.randrange(n) if n else 0

    def choose(self, t: Tuple) -> Sequence[int]:
        self._i = (self._i + 1) % self.n
        return (self._i,)


class LocalOrShuffleGrouping(ShuffleGrouping):
    """In one process every task is local: shuffle."""


class FieldsGrouping(Grouping):
    """Hash partition on selected fields: same key -> same instance."""

    def __init__(self, *field_names: str) -> None:
        if not field_names:
            raise ValueError("fields grouping needs at least one field name")
        self.field_names = field_names

    def choose(self, t: Tuple) -> Sequence[int]:
        key = tuple(t.get(f) for f in self.field_names)
        return (stable_hash(key) % self.n,)


class AllGrouping(Grouping):
    """Broadcast to every instance."""

    def choose(self, t: Tuple) -> Sequence[int]:
        return range(self.n)


class GlobalGrouping(Grouping):
    """Everything to instance 0."""

    def choose(self, t: Tuple) -> Sequence[int]:
        return (0,)


class PartialKeyGrouping(Grouping):
    """Storm's ``partialKeyGrouping`` ("power of two choices"): each key
    hashes to two candidate instances and the less loaded one is chosen,
    so a skewed key spreads over two owners."""

    def __init__(self, *field_names: str) -> None:
        self.fields = field_names

    def prepare(self, n: int) -> None:
        super().prepare(n)
        self._load = [0] * n

    def choose(self, t: Tuple) -> Sequence[int]:
        key = tuple(t.get(f) for f in self.fields) if self.fields \
            else tuple(t.values)
        h = stable_hash(key)
        a = h % self.n
        b = (h >> 17) % self.n
        pick = a if self._load[a] <= self._load[b] else b
        self._load[pick] += 1
        return (pick,)


class NoneGrouping(ShuffleGrouping):
    """Storm's "none" grouping: don't care, which is shuffle."""


class DirectGrouping(Grouping):
    """The producer names the target instance with
    ``collector.emit_direct(task, ...)``."""

    def choose(self, t: Tuple) -> Sequence[int]:
        raise RuntimeError("direct grouping requires emit_direct(task, ...)")
