"""Consistent-hash ring, copied from ``storm_tpu/dist/ring.py``: routing
for keyed components whose task count changes.

``FieldsGrouping`` maps a key to ``stable_hash(key) % n``; a rebalance that
changes ``n`` remaps nearly every key. The ring places each member at
``vnodes`` pseudo-random points on a 32-bit circle and routes a key to the
first member clockwise of its hash, so adding or removing one member
remaps only the arcs it gains or loses, about 1/N of the keys. The decode
tier routes sessions on it (``ring_fields_grouping("session_id")``).

Keys hash with :func:`storm_tpu_torch.runtime.groupings.stable_hash` and
points with CRC32, so a key reaches the same task index in both packages
and in every process.
"""

from __future__ import annotations

import bisect
import zlib
from typing import Dict, Iterable, List, Sequence, Tuple

from storm_tpu_torch.runtime.groupings import Grouping, stable_hash
from storm_tpu_torch.runtime.tuples import Tuple as STuple

_SPACE = 1 << 32


def _point(member: object, replica: int) -> int:
    return zlib.crc32(f"ring:{member!r}:{replica}".encode("utf-8"))


class HashRing:
    """A consistent-hash ring over arbitrary hashable members.

    ``vnodes`` virtual points per member trade lookup-table size for
    balance: with 64 vnodes the largest member arc is typically within
    ~20% of fair share. Lookups are O(log(members * vnodes)).
    """

    def __init__(self, members: Iterable[object] = (),
                 vnodes: int = 64) -> None:
        if vnodes < 1:
            raise ValueError("vnodes must be >= 1")
        self.vnodes = vnodes
        self._points: List[int] = []       # sorted ring positions
        self._owners: List[object] = []    # owner per position
        self._members: Dict[object, List[int]] = {}
        for m in members:
            self.add(m)

    @property
    def members(self) -> Tuple[object, ...]:
        return tuple(self._members)

    def __len__(self) -> int:
        return len(self._members)

    def __contains__(self, member: object) -> bool:
        return member in self._members

    def add(self, member: object) -> None:
        if member in self._members:
            return
        pts = []
        for r in range(self.vnodes):
            p = _point(member, r)
            i = bisect.bisect(self._points, p)
            # collisions keep both entries; adjacent equal points are
            # deterministic because insertion order is member-sorted on
            # rebuild and stable within one ring instance
            self._points.insert(i, p)
            self._owners.insert(i, member)
            pts.append(p)
        self._members[member] = pts

    def remove(self, member: object) -> None:
        if member not in self._members:
            return
        for i in range(len(self._points) - 1, -1, -1):
            if self._owners[i] == member:
                del self._points[i]
                del self._owners[i]
        del self._members[member]

    def lookup(self, h: int) -> object:
        """Owner of hash ``h``: first point clockwise (wraparound)."""
        if not self._points:
            raise LookupError("ring is empty")
        i = bisect.bisect(self._points, h % _SPACE)
        if i == len(self._points):
            i = 0
        return self._owners[i]

    def lookup_key(self, key: object) -> object:
        return self.lookup(stable_hash(key))

    def moved_fraction(self, other: "HashRing",
                       samples: int = 4096) -> float:
        """Fraction of the keyspace that routes differently on ``other``.

        Sampled at evenly spaced ring positions — exact arc accounting
        is possible but the estimate is within ~1/sqrt(samples) and
        this is observability, not routing."""
        if not self._points or not other._points:
            return 1.0
        step = _SPACE // samples
        moved = sum(1 for h in range(0, _SPACE, step)
                    if self.lookup(h) != other.lookup(h))
        return moved / samples


class RingFieldsGrouping(Grouping):
    """Fields grouping with consistent-hash task selection.

    Same contract as :class:`~storm_tpu_torch.runtime.groupings.FieldsGrouping`
    (same key → same task) but ``prepare(n)`` diff-updates a task ring
    instead of rebinding ``% n``, so a rebalance remaps only ~1/n of the
    keys. ``last_remap_fraction`` records the measured remap share of
    the most recent ``prepare``.
    """

    def __init__(self, *field_names: str, vnodes: int = 64) -> None:
        if not field_names:
            raise ValueError("ring grouping needs at least one field name")
        self.field_names = field_names
        self.vnodes = vnodes
        self._ring: HashRing | None = None
        self.last_remap_fraction = 0.0
        self.remaps = 0  # prepare() calls that actually changed membership

    def prepare(self, n: int) -> None:
        self.n = n
        old = self._ring
        if old is not None and len(old) == n:
            return
        if old is None:
            self._ring = HashRing(range(n), vnodes=self.vnodes)
            self.last_remap_fraction = 0.0
            return
        # diff-update: grow adds members, shrink removes them; untouched
        # members keep their arcs, which is the whole point
        ring = HashRing(vnodes=self.vnodes)
        ring._points = list(old._points)
        ring._owners = list(old._owners)
        ring._members = {m: list(p) for m, p in old._members.items()}
        for t in range(len(old), n):
            ring.add(t)
        for t in range(n, len(old)):
            ring.remove(t)
        self.last_remap_fraction = old.moved_fraction(ring)
        self.remaps += 1
        self._ring = ring

    def choose(self, t: STuple) -> Sequence[int]:
        key = tuple(t.get(f) for f in self.field_names)
        return (self._ring.lookup(stable_hash(key)),)
