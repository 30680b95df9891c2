"""The port's consistent-hash ring (``storm_tpu_torch/dist/ring.py``)
against storm_tpu's on the CPU: the same key-to-task map for n = 1..8, the
same ``moved_fraction`` when a member is added or removed, the same
diff-updating ``prepare``, the same refusals, and the port's
``ring_fields_grouping`` declarer."""

from __future__ import annotations

import pytest

import storm_tpu.dist.ring as jax_ring
import storm_tpu.runtime.tuples as jax_tuples
import storm_tpu_torch.dist.ring as port_ring
import storm_tpu_torch.runtime.tuples as port_tuples

KEYS = [f"s{i}" for i in range(300)] + [i * 7919 for i in range(100)] + [("u", 3), None]


def _task_map(ring_mod, tuples_mod, n: int) -> list:
    g = ring_mod.RingFieldsGrouping("session_id")
    g.prepare(n)
    return [g.choose(tuples_mod.Tuple([k], ("session_id",), "spout"))[0] for k in KEYS]


@pytest.mark.parametrize("n", range(1, 9))
def test_same_key_to_task_map(n):
    got = _task_map(port_ring, port_tuples, n)
    assert got == _task_map(jax_ring, jax_tuples, n)
    assert set(got) == set(range(n))


@pytest.mark.parametrize("n,change", [(4, "add"), (5, "remove"), (1, "add"), (8, "remove")])
def test_same_moved_fraction(n, change):
    """A member added to or removed from n: the same moved share, and only
    the arcs of the changed member move."""
    fractions = []
    for mod in (jax_ring, port_ring):
        old, new = mod.HashRing(range(n)), mod.HashRing(range(n))
        if change == "add":
            new.add(n)
        else:
            new.remove(n - 1)
        fractions.append(old.moved_fraction(new))
        changed = n if change == "add" else n - 1
        for h in range(0, 1 << 32, (1 << 32) // 512):
            if old.lookup(h) != new.lookup(h):
                assert changed in (old.lookup(h), new.lookup(h))
    assert fractions[0] == fractions[1]
    if n > 1:
        assert 0.03 < fractions[1] < 0.5


def test_prepare_diff_updates_alike():
    """4 -> 5 -> 3 tasks: the same maps, remap fractions and remap counts;
    a same-size prepare is a no-op."""
    got = {}
    for name, mod, tmod in (("ref", jax_ring, jax_tuples), ("port", port_ring, port_tuples)):
        g = mod.RingFieldsGrouping("session_id")
        rows = []
        for n in (4, 5, 5, 3):
            g.prepare(n)
            rows.append(([g.choose(tmod.Tuple([k], ("session_id",), "s"))[0] for k in KEYS],
                         g.last_remap_fraction, g.remaps))
        got[name] = rows
    assert got["port"] == got["ref"]
    assert [r[2] for r in got["port"]] == [0, 1, 1, 2]


def test_lookup_balanced_and_stable_across_rings():
    ring, again = port_ring.HashRing(range(4)), port_ring.HashRing(range(4))
    owners = [ring.lookup_key(f"k{i}") for i in range(4000)]
    counts = [owners.count(m) for m in range(4)]
    assert min(counts) > 500 and max(counts) < 2000
    assert owners[:200] == [again.lookup_key(f"k{i}") for i in range(200)]
    assert ring.members == (0, 1, 2, 3) and len(ring) == 4 and 2 in ring


def test_refusals_alike():
    for mod in (jax_ring, port_ring):
        with pytest.raises(LookupError, match="ring is empty"):
            mod.HashRing().lookup(123)
        with pytest.raises(ValueError, match="vnodes"):
            mod.HashRing(vnodes=0)
        with pytest.raises(ValueError, match="at least one field"):
            mod.RingFieldsGrouping()


def test_declarer_wires_ring_grouping():
    from storm_tpu_torch.runtime import Bolt, Spout, TopologyBuilder

    class S(Spout):
        async def next_tuple(self):
            return False

    class B(Bolt):
        async def execute(self, t):
            pass

    tb = TopologyBuilder()
    tb.set_spout("spout", S())
    tb.set_bolt("bolt", B(), parallelism=3).ring_fields_grouping("spout", "user")
    sub = tb.build().specs["bolt"].inputs[0]
    assert isinstance(sub.grouping, port_ring.RingFieldsGrouping)
    assert sub.grouping.field_names == ("user",) and sub.stream == "default"
