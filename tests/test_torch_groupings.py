"""The port's stream groupings and topology builder
(``storm_tpu_torch/runtime/groupings.py``, ``topology.py``) against
storm_tpu's on the CPU, the behaviours of ``tests/test_runtime.py``:
every grouping picks the same tasks for the same tuples at parallelism 1,
3 and 4 (shuffle from the same random state); ``stable_hash`` gives the
same value for the same keys in both packages and in processes with
different hash salts; the builder refuses what storm_tpu's refuses and
takes every declarer it takes (``ring_fields_grouping`` aside); and
through a running topology fields and partial-key grouping map each key
to the same tasks in both packages.
"""

from __future__ import annotations

import os
import random
import subprocess
import sys

import numpy as np
import pytest

import storm_tpu.runtime.groupings as jax_groupings
import storm_tpu_torch.runtime.groupings as port_groupings
from tests.test_torch_runtime import IMPLS, ROOT, components, impl, one_hop  # noqa: F401


# ---- groupings ------------------------------------------------------------------

KEYS = ["user-42", 7, -3, 2.5, None, True, b"raw", ("user-42", 7), ["a", ("b", 1)],
        "ünïcode", 0, 10 ** 20]


def test_stable_hash_alike():
    for k in KEYS:
        assert port_groupings.stable_hash(k) == jax_groupings.stable_hash(k), k
        assert port_groupings._canonical(k) == jax_groupings._canonical(k), k


def test_stable_hash_alike_across_processes():
    """The same key hashes the same in processes with different salts, and
    as storm_tpu's does."""
    code = ("from storm_tpu_torch.runtime.groupings import stable_hash;"
            "print(stable_hash(('user-42', 7)))")
    outs = {subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                           env={**os.environ, "PYTHONPATH": ROOT, "PYTHONHASHSEED": str(seed)},
                           cwd=ROOT, timeout=60).stdout.strip()
            for seed in (1, 2)}
    assert outs == {str(jax_groupings.stable_hash(("user-42", 7)))}


GROUPINGS = {
    "shuffle": lambda G: G.ShuffleGrouping(),
    "local_or_shuffle": lambda G: G.LocalOrShuffleGrouping(),
    "none": lambda G: G.NoneGrouping(),
    "fields": lambda G: G.FieldsGrouping("user", "n"),
    "all": lambda G: G.AllGrouping(),
    "global": lambda G: G.GlobalGrouping(),
    "partial_key": lambda G: G.PartialKeyGrouping("user"),
    "partial_key_values": lambda G: G.PartialKeyGrouping(),
}


@pytest.mark.parametrize("kind", sorted(GROUPINGS))
def test_grouping_choices_alike(kind):
    rng = np.random.RandomState(5)
    rows = [(["hot", "u1", "u2", "u3"][rng.randint(4)] if rng.rand() < 0.5 else "hot",
             int(rng.randint(3))) for _ in range(60)]
    for n in (1, 3, 4):
        picks = {}
        for name, impl in IMPLS.items():
            g = GROUPINGS[kind](impl.groupings)
            random.seed(11)  # shuffle starts from the same random state
            g.prepare(n)
            picks[name] = [list(g.choose(impl.tuples.Tuple(values=list(r),
                                                           fields=("user", "n"),
                                                           source_component="s")))
                           for r in rows]
        assert picks["port"] == picks["storm_tpu"], n
        assert all(0 <= i < n for p in picks["port"] for i in p)


def test_direct_grouping_refuses_choose(impl):
    g = impl.groupings.DirectGrouping()
    g.prepare(2)
    with pytest.raises(RuntimeError, match="emit_direct"):
        g.choose(impl.tuples.Tuple(values=[1], fields=("message",), source_component="s"))


def test_fields_grouping_needs_a_field(impl):
    with pytest.raises(ValueError, match="at least one field"):
        impl.groupings.FieldsGrouping()


# ---- the builder -------------------------------------------------------------------

def _builder_errors(impl) -> list:
    c = components(impl)
    errs = []
    b = impl.runtime.TopologyBuilder()
    b.set_spout("s", c.ListSpout([]), 1)
    b.set_bolt("x", c.CaptureBolt(), 1).shuffle_grouping("nope")
    for fn in (b.build,
               lambda: b.set_spout("s", c.ListSpout([]), 1),
               lambda: b.set_bolt("__sys", c.CaptureBolt(), 1),
               lambda: b.set_bolt("zero", c.CaptureBolt(), 0)):
        with pytest.raises(ValueError) as e:
            fn()
        errs.append(str(e.value))
    b2 = impl.runtime.TopologyBuilder()
    b2.set_spout("s", c.ListSpout([]), 1)
    b2.set_bolt("a", c.PassBolt(), 1).shuffle_grouping("s").shuffle_grouping("b")
    b2.set_bolt("b", c.PassBolt(), 1).shuffle_grouping("a")
    with pytest.raises(ValueError) as e:
        b2.build()
    errs.append(str(e.value))
    return errs


def test_builder_validation_alike():
    assert _builder_errors(IMPLS["port"]) == _builder_errors(IMPLS["storm_tpu"])


def _declared(impl) -> dict:
    c = components(impl)
    G = impl.groupings
    b = impl.runtime.TopologyBuilder()
    b.set_spout("s", c.ListSpout([]), 1)
    (b.set_bolt("x", c.CaptureBolt(), 2)
     .shuffle_grouping("s").local_or_shuffle_grouping("s", stream="side")
     .fields_grouping("s", "message").all_grouping("s").global_grouping("s")
     .none_grouping("s").partial_key_grouping("s", "message").direct_grouping("s")
     .custom_grouping("s", G.GlobalGrouping()).set_cpu_load(50).set_memory_load(256))
    spec = b.build().specs["x"]
    return {"inputs": [(s.source, s.stream, type(s.grouping).__name__,
                        getattr(s.grouping, "field_names", getattr(s.grouping, "fields", None)))
                       for s in spec.inputs],
            "resources": spec.resources}


def test_every_declarer_alike():
    assert _declared(IMPLS["port"]) == _declared(IMPLS["storm_tpu"])


def _keyed_owners(impl, run, kind: str) -> dict:
    c = components(impl)
    items = (["hot"] * 36 + [f"k{i}" for i in range(4)] if kind == "partial"
             else [f"k{i % 4}" for i in range(40)])

    def declare(d):
        if kind == "partial":
            return d.partial_key_grouping("spout", "message")
        return d.fields_grouping("spout", "message")

    ok, _, _ = run(one_hop(impl, items, c.CaptureBolt(), parallelism=4, declare=declare))
    assert ok and len(c.seen) == 40
    owners: dict = {}
    for task, msg in c.seen:
        owners.setdefault(msg, set()).add(task)
    return owners


def test_fields_grouping_affinity_alike(run):
    got = {name: _keyed_owners(impl, run, "fields") for name, impl in IMPLS.items()}
    assert got["port"] == got["storm_tpu"]
    assert all(len(v) == 1 for v in got["port"].values())


def test_partial_key_grouping_alike(run):
    got = {name: _keyed_owners(impl, run, "partial") for name, impl in IMPLS.items()}
    assert got["port"] == got["storm_tpu"]
    assert all(len(v) <= 2 for v in got["port"].values())
    assert len(got["port"]["hot"]) == 2  # the skewed key used both its choices


def test_topology_context_repr_alike():
    import storm_tpu.runtime as jax_runtime
    import storm_tpu_torch.runtime as port_runtime

    args = ("inference-bolt", 2, 4, None)
    assert repr(port_runtime.TopologyContext(*args)) == \
        repr(jax_runtime.TopologyContext(*args)) == "<TopologyContext inference-bolt[2/4]>"
