"""The port's declarative topologies (``storm_tpu_torch/flux.py``)
against storm_tpu's on the CPU. The definitions name only the port's
classes; storm_tpu's copy of each is the same text with its class paths
mapped to storm_tpu's (and the port's ``device`` argument dropped). Both
build the same component ids, parallelism and groupings; the port's runs
end to end; the refusals match."""

from __future__ import annotations

import asyncio
import json
import tomllib

import numpy as np
import pytest

import storm_tpu.flux as jax_flux
import storm_tpu.connectors.memory as jax_memory
import storm_tpu_torch.flux as port_flux
from storm_tpu_torch.config import Config
from storm_tpu_torch.connectors.memory import MemoryBroker
from storm_tpu_torch.infer.engine import clear_engines
from storm_tpu_torch.runtime.cluster import AsyncLocalCluster
from storm_tpu_torch.runtime.groupings import DirectGrouping

TOML = """
[topology]
name = "flux-demo"

[[spouts]]
id = "kafka-spout"
class = "storm_tpu_torch.connectors.spout.BrokerSpout"
parallelism = 2
args = { broker = "$broker", topic = "input" }

[[bolts]]
id = "inference-bolt"
class = "storm_tpu_torch.infer.operator.InferenceBolt"
parallelism = 2
groupings = [ { source = "kafka-spout", type = "shuffle" } ]

[bolts.args]
warmup = false
device = "cpu"
model = { class = "storm_tpu_torch.config.ModelConfig", args = { name = "lenet5", num_classes = 10, input_shape = [28, 28, 1], dtype = "float32" } }
batch = { class = "storm_tpu_torch.config.BatchConfig", args = { max_batch = 8, max_wait_ms = 20, buckets = [8] } }

[[bolts]]
id = "kafka-bolt"
class = "storm_tpu_torch.connectors.sink.BrokerSink"
parallelism = 1
args = { broker = "$broker", topic = "output" }
groupings = [ { source = "inference-bolt", type = "shuffle" } ]

[[bolts]]
id = "dlq"
class = "storm_tpu_torch.connectors.sink.BrokerSink"
args = { broker = "$broker", topic = "dead-letter" }
groupings = [ { source = "inference-bolt", type = "shuffle", stream = "dead_letter" } ]

[[bolts]]
id = "by-key"
class = "storm_tpu_torch.connectors.sink.BrokerSink"
parallelism = 3
args = { broker = "$broker", topic = "keyed" }
groupings = [ { source = "inference-bolt", type = "fields", fields = ["message"] },
              { source = "kafka-spout", type = "global" },
              { source = "kafka-spout", type = "all", stream = "default" },
              { source = "inference-bolt", type = "local_or_shuffle", stream = "dead_letter" },
              { source = "kafka-spout", type = "direct" } ]
"""


def _reference(node):
    """The definition as storm_tpu reads it: storm_tpu's class paths, and
    no ``device`` (storm_tpu's operator has none)."""
    if isinstance(node, dict):
        return {k: ("storm_tpu." + v[len("storm_tpu_torch."):]
                    if k == "class" and v.startswith("storm_tpu_torch.") else _reference(v))
                for k, v in node.items() if k != "device"}
    if isinstance(node, list):
        return [_reference(v) for v in node]
    return node


def _shape(topo) -> dict:
    """Component ids, parallelism, spout or bolt, and each subscription's
    source, stream, grouping kind and fields."""
    return {cid: (spec.parallelism, spec.is_spout,
                  [(s.source, s.stream, type(s.grouping).__name__,
                    getattr(s.grouping, "fields", getattr(s.grouping, "field_names", None)))
                   for s in spec.inputs])
            for cid, spec in topo.specs.items()}


def test_same_toml_builds_the_same_topology(tmp_path):
    path = tmp_path / "topo.toml"
    path.write_text(TOML)
    port = port_flux.load_topology(str(path), resources={"broker": MemoryBroker()})
    ref = jax_flux.load_topology(_reference(tomllib.loads(TOML)),
                                 resources={"broker": jax_memory.MemoryBroker()})
    assert _shape(port) == _shape(ref)
    assert list(port.specs) == ["kafka-spout", "inference-bolt", "kafka-bolt", "dlq", "by-key"]
    assert port_flux.topology_name(str(path)) == jax_flux.topology_name(str(path)) == "flux-demo"
    bolt = port.specs["inference-bolt"].obj
    assert type(bolt).__module__ == "storm_tpu_torch.infer.operator" and bolt.device == "cpu"
    assert isinstance(port.specs["by-key"].inputs[-1].grouping, DirectGrouping)


def test_json_definition_builds_the_same_topology(tmp_path):
    spec = tomllib.loads(TOML)
    path = tmp_path / "topo.json"
    path.write_text(json.dumps(spec))
    got = [port_flux.load_topology(src, resources={"broker": MemoryBroker()})
           for src in (str(path), json.dumps(spec), spec)]
    ref = jax_flux.load_topology(json.dumps(_reference(spec)),
                                 resources={"broker": jax_memory.MemoryBroker()})
    assert all(_shape(t) == _shape(ref) for t in got)


def test_port_topology_runs(run, tmp_path):
    """The port's definition on its own cluster: five answers with ten
    classes each and the poison record on the dead-letter topic."""
    spec = tomllib.loads(TOML)
    spec["bolts"] = spec["bolts"][:3]  # without the "by-key" sink
    broker = MemoryBroker()
    topo = port_flux.load_topology(spec, resources={"broker": broker})

    async def go():
        cluster = AsyncLocalCluster()
        rt = await cluster.submit("flux", Config(), topo)
        try:
            rng = np.random.RandomState(0)
            for _ in range(5):
                broker.produce("input", json.dumps({"instances": rng.rand(1, 28, 28, 1).tolist()}))
            broker.produce("input", '{"instances": [[1],[2,3]]}')
            deadline = asyncio.get_running_loop().time() + 60
            while asyncio.get_running_loop().time() < deadline:
                if broker.topic_size("output") >= 5 and broker.topic_size("dead-letter") >= 1:
                    break
                await asyncio.sleep(0.05)
            await rt.drain(timeout_s=30)
            return broker.drain_topic("output"), broker.drain_topic("dead-letter")
        finally:
            await cluster.shutdown()

    try:
        outs, dlq = run(go(), timeout=120)
    finally:
        clear_engines()  # the next file on this worker counts live engines
    assert len(outs) == 5 and len(dlq) == 1
    assert [len(json.loads(r.value)["predictions"][0]) for r in outs] == [10] * 5


def test_resources_nesting_and_caller_injection():
    spec = {
        "resources": {
            "broker": {"class": "storm_tpu_torch.connectors.memory.MemoryBroker",
                       "args": {"default_partitions": 2}},
            "proto": {"class": "storm_tpu_torch.connectors.spout.BrokerSpout",
                      "args": {"broker": "$injected", "topic": "t"}}},
        "spouts": [{"id": "s", "class": "storm_tpu_torch.connectors.spout.BrokerSpout",
                    "args": {"broker": "$broker", "topic": "t"}}],
        "bolts": [{"id": "b", "class": "storm_tpu_torch.connectors.sink.BrokerSink",
                   "args_list": ["$broker", "o"],
                   "groupings": [{"source": "s", "type": "fields", "fields": ["message"]}]}],
    }
    injected = MemoryBroker()
    topo = port_flux.load_topology(spec, resources={"injected": injected})
    assert topo.specs["s"].obj.broker is topo.specs["b"].obj.broker
    assert topo.specs["s"].obj.broker.partitions_for("t") == 2
    mine = MemoryBroker()
    assert port_flux.load_topology(spec, resources={"broker": mine, "injected": injected}) \
        .specs["s"].obj.broker is mine


@pytest.mark.parametrize("case", ["no_spout", "unknown_resource", "import", "grouping",
                                  "no_id", "constructing", "fields", "prefix"])
def test_refusals_match(case):
    """Each malformed definition is refused by both packages with the same
    message (class paths aside)."""
    spout = {"id": "s", "class": "storm_tpu_torch.connectors.spout.BrokerSpout",
             "args": {"broker": "$broker", "topic": "t"}}
    sink = {"id": "b", "class": "storm_tpu_torch.connectors.sink.BrokerSink",
            "args": {"broker": "$broker", "topic": "o"}}
    res = {"broker": True}
    prefixes = None
    spec = {
        "no_spout": {"spouts": []},
        "unknown_resource": {"spouts": [spout]},
        "import": {"spouts": [{"id": "s", "class": "no.such.Thing"}]},
        "grouping": {"spouts": [spout], "bolts": [{**sink, "groupings": [
            {"source": "s", "type": "zigzag"}]}]},
        "no_id": {"spouts": [{"class": spout["class"]}]},
        "constructing": {"spouts": [{**spout, "args": {"bogus_kwarg": 1}}]},
        "fields": {"spouts": [spout], "bolts": [{**sink, "groupings": [
            {"source": "s", "type": "fields"}]}]},
        "prefix": {"spouts": [{**spout, "class": "os.system"}]},
    }[case]
    if case == "unknown_resource":
        res = {}
    if case == "prefix":
        prefixes = ("storm_tpu_torch.",)
    errors = []
    for mod, mem, conv, pre in (
            (port_flux, MemoryBroker, lambda s: s, prefixes),
            (jax_flux, jax_memory.MemoryBroker, _reference,
             prefixes and ("storm_tpu.",))):
        with pytest.raises(mod.FluxError) as ei:
            mod.load_topology(conv(spec), resources={k: mem() for k in res},
                              class_prefixes=pre)
        errors.append(str(ei.value).replace("storm_tpu_torch.", "storm_tpu."))
    assert errors[0] == errors[1]
