"""Declarative topologies, copied from ``storm_tpu/flux.py`` (Storm's
Flux): component classes, constructor arguments, parallelism and
groupings in TOML or JSON::

    [topology]
    name = "serve"

    [resources.broker]
    class = "storm_tpu_torch.connectors.memory.MemoryBroker"

    [[spouts]]
    id = "spout"
    class = "storm_tpu_torch.connectors.spout.BrokerSpout"
    parallelism = 2
    args = { broker = "$broker", topic = "input" }

    [[bolts]]
    id = "infer"
    class = "storm_tpu_torch.infer.operator.InferenceBolt"
    parallelism = 4
    groupings = [ { source = "spout", type = "shuffle" } ]

    [[bolts]]
    id = "sink"
    class = "storm_tpu_torch.connectors.sink.BrokerSink"
    args = { broker = "$broker", topic = "output" }
    groupings = [ { source = "infer", type = "fields", fields = ["message"] } ]

- ``class`` is a dotted import path, resolved as given; ``args_list`` and
  ``args`` feed the constructor. A string ``"$name"`` resolves from the
  ``resources`` section (built once, shared) or from the caller's
  ``resources=`` dict, which wins.
- nested ``{ class = ..., args = ... }`` tables construct nested objects
  (a ``ModelConfig`` inside an ``InferenceBolt``).
- grouping ``type``: shuffle | local_or_shuffle | fields (with
  ``fields``) | all | global | direct, and an optional ``stream``.

``load_topology(path_or_dict, resources=...)`` returns the built
:class:`~storm_tpu_torch.runtime.topology.Topology`.
"""

from __future__ import annotations

import importlib
import json
from typing import Any, Dict, Optional

from storm_tpu_torch.runtime.topology import Topology, TopologyBuilder

_GROUPINGS = {"shuffle", "local_or_shuffle", "fields", "all", "global", "direct"}


class FluxError(ValueError):
    """Malformed topology definition."""


def _import_class(path: str):
    module, _, name = path.rpartition(".")
    if not module:
        raise FluxError(f"class {path!r} must be a dotted import path")
    try:
        return getattr(importlib.import_module(module), name)
    except (ImportError, AttributeError) as e:
        raise FluxError(f"cannot import {path!r}: {e}") from e


def _build_value(value: Any, resources: Dict[str, Any]) -> Any:
    if isinstance(value, str) and value.startswith("$"):
        name = value[1:]
        if name not in resources:
            raise FluxError(f"unknown resource {value!r} "
                            f"(have: {sorted(resources)})")
        return resources[name]
    if isinstance(value, dict) and "class" in value:
        return _construct(value, resources)
    if isinstance(value, dict):
        return {k: _build_value(v, resources) for k, v in value.items()}
    if isinstance(value, list):
        return [_build_value(v, resources) for v in value]
    return value


def _construct(spec: Dict[str, Any], resources: Dict[str, Any]) -> Any:
    cls = _import_class(spec["class"])
    args = [_build_value(v, resources) for v in spec.get("args_list", [])]
    kwargs = {k: _build_value(v, resources)
              for k, v in spec.get("args", {}).items()}
    try:
        return cls(*args, **kwargs)
    except TypeError as e:
        raise FluxError(f"constructing {spec['class']}: {e}") from e


def _wire(declarer, groupings, component_id: str) -> None:
    for g in groupings or []:
        if "source" not in g:
            raise FluxError(f"{component_id}: grouping needs a source")
        gtype = g.get("type", "shuffle")
        if gtype not in _GROUPINGS:
            raise FluxError(
                f"{component_id}: unknown grouping type {gtype!r} "
                f"(one of {sorted(_GROUPINGS)})")
        stream = g.get("stream", "default")
        if gtype == "fields":
            fields = g.get("fields")
            if not fields:
                raise FluxError(f"{component_id}: fields grouping needs "
                                "a 'fields' list")
            declarer.fields_grouping(g["source"], *fields, stream=stream)
        elif gtype == "direct":
            from storm_tpu_torch.runtime import groupings as G

            declarer.grouping(g["source"], G.DirectGrouping(), stream=stream)
        else:
            getattr(declarer, f"{gtype}_grouping")(g["source"], stream=stream)


def validate_class_paths(spec: Dict[str, Any],
                         prefixes: "tuple[str, ...]") -> None:
    """Reject any ``class`` path outside the allowed module prefixes —
    required before constructing definitions from untrusted input: a
    dotted path is arbitrary code execution."""
    def walk(node):
        if isinstance(node, dict):
            cls = node.get("class")
            if isinstance(cls, str) and not cls.startswith(prefixes):
                raise FluxError(
                    f"class {cls!r} outside the allowed prefixes {prefixes}")
            for v in node.values():
                walk(v)
        elif isinstance(node, list):
            for v in node:
                walk(v)

    walk(spec)


def load_topology(source, resources: Optional[Dict[str, Any]] = None,
                  class_prefixes: "Optional[tuple[str, ...]]" = None) -> Topology:
    """Build a Topology from a definition.

    ``source`` is a dict, a path to a ``.toml``/``.json`` file, or a JSON
    string. Caller-passed ``resources`` override same-named entries in the
    definition's ``[resources]`` section. ``class_prefixes`` restricts
    every ``class`` path to the given module prefixes (pass it whenever the
    definition comes from an untrusted channel)."""
    spec = _load_spec(source)
    if class_prefixes is not None:
        validate_class_paths(spec, tuple(class_prefixes))
    # Caller resources seed the table first: definition resources may build
    # on them, and caller injection overrides same-named definition entries.
    res: Dict[str, Any] = dict(resources or {})
    for name, rspec in (spec.get("resources") or {}).items():
        if name in res:
            continue  # caller injection wins; skip constructing
        if not isinstance(rspec, dict) or "class" not in rspec:
            raise FluxError(f"resource {name!r} needs a 'class'")
        res[name] = _construct(rspec, res)

    tb = TopologyBuilder()
    spouts = spec.get("spouts") or []
    bolts = spec.get("bolts") or []
    if not spouts:
        raise FluxError("topology needs at least one spout")
    for s in spouts:
        _require(s, "spout")
        tb.set_spout(s["id"], _construct(s, res),
                     parallelism=int(s.get("parallelism", 1)))
    for b in bolts:
        _require(b, "bolt")
        declarer = tb.set_bolt(b["id"], _construct(b, res),
                               parallelism=int(b.get("parallelism", 1)))
        _wire(declarer, b.get("groupings"), b["id"])
    return tb.build()


def topology_name(source) -> str:
    return str(_load_spec(source).get("topology", {}).get("name", "flux-topology"))


def _require(spec: Dict[str, Any], kind: str) -> None:
    for key in ("id", "class"):
        if key not in spec:
            raise FluxError(f"every {kind} needs an {key!r}")


def _load_spec(source) -> Dict[str, Any]:
    if isinstance(source, dict):
        return source
    text = str(source)
    if text.lstrip().startswith("{"):
        return json.loads(text)
    if text.endswith(".json"):
        with open(text) as f:
            return json.load(f)
    if text.endswith(".toml"):
        import tomllib

        with open(text, "rb") as f:
            return tomllib.load(f)
    raise FluxError(f"can't load topology definition from {source!r} "
                    "(dict, JSON string, .json or .toml path)")
