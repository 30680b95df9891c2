"""Tuples and ack identities, copied from ``storm_tpu/runtime/tuples.py``
(single-process: no worker tags). A tuple carries its record's trace
context and its source-log provenance (``origins``), which both follow
anchoring; tick tuples are the executor's timer.

Every tuple edge has a random 64-bit ``edge_id``; a tuple anchored to one
or more root (spout) tuples carries their ids in ``anchors``, Storm's
anchoring model, which the XOR ledger (:mod:`.acker`) completes.
"""

from __future__ import annotations

import os
import random
from dataclasses import dataclass
from functools import lru_cache
from typing import Any, FrozenSet, Optional, Sequence

# Ids only need uniqueness and uniform mixing for the XOR ledger; a
# process-seeded Mersenne Twister is far cheaper per call than urandom.
_rng = random.Random(int.from_bytes(os.urandom(16), "big"))
_randbits = _rng.getrandbits


def new_id() -> int:
    """Random non-zero 64-bit id (zero means 'complete' to the ledger)."""
    while True:
        v = _randbits(64)
        if v:
            return v


class Values(list):
    """An emitted value list, mirroring Storm's ``Values``."""


def merge_offsets(dst: dict, items) -> dict:
    """Max-wins merge of ``(key, offset)`` pairs into ``dst``: the one
    offset fold of the exactly-once chain (the union of origins, a
    transaction's staged offsets, the transactional sink's commit)."""
    for k, off in items:
        if off > dst.get(k, -1):
            dst[k] = off
    return dst


@lru_cache(maxsize=1024)
def _field_index(fields: tuple) -> dict:
    return {name: i for i, name in enumerate(fields)}


@dataclass
class Tuple:
    values: Sequence[Any]
    fields: Sequence[str]
    source_component: str
    source_task: int = 0
    stream: str = "default"
    edge_id: int = 0
    anchors: FrozenSet[int] = frozenset()
    # perf_counter timestamp when the root entered the topology; flows with
    # the tuple for end-to-end latency metrics.
    root_ts: float = 0.0
    # Source-log provenance: ``(topic, partition, next_offset)`` triples of
    # the ingest records this tuple derives from (next_offset = last
    # consumed + 1, the offset to commit). The spout stamps them and
    # anchored emits union them, so a transactional sink can commit the
    # consumed offsets inside its producer transaction.
    origins: FrozenSet[tuple] = frozenset()
    # The record's trace context (tracing.TraceContext); None unless the
    # record was sampled, so tracing off costs only the field.
    trace: Optional[Any] = None

    def __getitem__(self, i: int) -> Any:
        return self.values[i]

    def __len__(self) -> int:
        return len(self.values)

    _MISSING = object()

    def get(self, name: str, default: Any = _MISSING) -> Any:
        """Field access by declared name (Storm's ``getValueByField``);
        a ``default`` makes a missing field non-fatal."""
        idx = _field_index(tuple(self.fields)).get(name)
        if idx is None:
            if default is not Tuple._MISSING:
                return default
            raise KeyError(
                f"no field {name!r} in stream from {self.source_component} "
                f"(fields: {list(self.fields)})")
        return self.values[idx]

    def get_string(self, i: int) -> str:
        """Storm's ``tuple.getString(i)``."""
        return str(self.values[i])


class TickTuple(Tuple):
    """Periodic timer tuple (Storm's tick tuples): the executor's ticker
    puts one in a bolt's inbox every ``tick_interval_s``."""

    def __init__(self) -> None:
        super().__init__(values=(), fields=(), source_component="__system",
                         stream="__tick")


def is_tick(t: Tuple) -> bool:
    return t.stream == "__tick"
