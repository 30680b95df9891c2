"""Windowed stream joins, copied from ``storm_tpu/runtime/join.py``
(Storm's ``JoinBolt``), on :class:`~storm_tpu_torch.runtime.window.
WindowedBolt`:

- ``JoinBolt(on="user_id", streams=["orders", "payments"], ...)`` joins
  the named source components on equal values of the ``on`` field;
- ``how="inner"`` emits one output per key-matched combination;
  ``how="left"`` keeps unmatched tuples of the first stream, padding the
  others' fields with None;
- ``select`` names the output columns: ``"field"`` (the first stream that
  has it wins) or ``"stream.field"``.

Wire each input with ``fields_grouping(source, key)`` so one task sees
every tuple of a key, or run the join at parallelism 1::

    tb.set_bolt("join", JoinBolt(on="user", streams=["orders", "payments"],
                                 select=["user", "orders.amount",
                                         "payments.method"],
                                 window_count=32), parallelism=1) \\
        .fields_grouping("orders", "user").fields_grouping("payments", "user")
"""

from __future__ import annotations

from typing import Any, Dict, List, Optional, Sequence, Tuple as Tup

from storm_tpu_torch.runtime.tuples import Tuple, Values
from storm_tpu_torch.runtime.window import WindowedBolt


class JoinBolt(WindowedBolt):
    def __init__(
        self,
        on: str,
        streams: Sequence[str],
        select: Sequence[str],
        how: str = "inner",
        window_count: Optional[int] = None,
        slide_count: Optional[int] = None,
        window_s: Optional[float] = None,
        slide_s: Optional[float] = None,
    ) -> None:
        super().__init__(window_count=window_count, slide_count=slide_count,
                         window_s=window_s, slide_s=slide_s)
        if len(streams) < 2:
            raise ValueError("join needs at least two streams")
        if len(set(streams)) != len(streams):
            raise ValueError(f"duplicate stream in {list(streams)!r} "
                             "(a self-join would cross tuples with themselves)")
        if how not in ("inner", "left"):
            raise ValueError(f"how must be inner|left, got {how!r}")
        self.on = on
        self.streams = list(streams)
        self.how = how
        self.select = list(select)
        # "stream.field" -> (stream, field); "field" -> (None, field)
        self._selectors: List[Tup[Optional[str], str]] = []
        for col in self.select:
            src, dot, field = col.partition(".")
            if dot and src not in self.streams:
                # catch select typos at construction, not as eternal Nones
                raise ValueError(
                    f"select column {col!r} references unknown stream "
                    f"{src!r} (streams: {self.streams})")
            self._selectors.append((src, field) if dot else (None, col))

    def declare_output_fields(self):
        return {"default": tuple(c.replace(".", "_") for c in self.select)}

    # ---- the join ------------------------------------------------------------

    def _value(self, row: Dict[str, Optional[Tuple]], selector) -> Any:
        src, field = selector
        if src is not None:
            t = row.get(src)
            return t.get(field, None) if t is not None else None
        for stream in self.streams:  # first stream that has the field wins
            t = row.get(stream)
            if t is not None:
                v = t.get(field, _MISSING)
                if v is not _MISSING:
                    return v
        return None

    async def execute_window(self, tuples: List[Tuple]) -> None:
        # bucket: key -> stream -> [tuples]
        first = self.streams[0]
        by_key: Dict[Any, Dict[str, List[Tuple]]] = {}
        for t in tuples:
            src = t.source_component
            if src not in self.streams:
                continue  # unrelated input wired in; ignore
            key = t.get(self.on, None)
            if key is None and not (self.how == "left" and src == first):
                continue  # unkeyed rows can't match; left keeps first-stream rows
            by_key.setdefault(key, {}).setdefault(src, []).append(t)

        for key, per_stream in by_key.items():
            base_rows = per_stream.get(first, [])
            if not base_rows:
                continue  # inner AND left joins both need the first stream
            # build the per-key combinations stream by stream
            combos: List[Dict[str, Optional[Tuple]]] = [
                {first: t} for t in base_rows
            ]
            alive = True
            for stream in self.streams[1:]:
                matches = per_stream.get(stream, [])
                if not matches:
                    if self.how == "inner":
                        alive = False
                        break
                    for row in combos:
                        row[stream] = None
                    continue
                combos = [
                    {**row, stream: t} for row in combos for t in matches
                ]
            if not alive:
                continue
            for row in combos:
                anchors = [t for t in row.values() if t is not None]
                await self.collector.emit(
                    Values([self._value(row, sel) for sel in self._selectors]),
                    anchors=anchors,
                )


_MISSING = object()
