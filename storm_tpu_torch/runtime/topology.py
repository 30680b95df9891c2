"""Topology DSL, copied from ``storm_tpu/runtime/topology.py`` with every
grouping declarer (``ring_fields_grouping`` takes the consistent-hash ring
of ``storm_tpu_torch/dist/ring.py``)::

    b = TopologyBuilder()
    b.set_spout("kafka-spout", spout, parallelism=2)
    b.set_bolt("inference-bolt", InferenceBolt(...), parallelism=4) \\
        .shuffle_grouping("kafka-spout")
    b.set_bolt("kafka-bolt", sink, parallelism=2) \\
        .shuffle_grouping("inference-bolt")
    topo = b.build()
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, List

from storm_tpu_torch.runtime import groupings as G
from storm_tpu_torch.runtime.base import Bolt, Spout


@dataclass
class Subscription:
    source: str
    stream: str
    grouping: G.Grouping


@dataclass
class ComponentSpec:
    component_id: str
    obj: object  # Spout or Bolt prototype (cloned per task)
    parallelism: int
    is_spout: bool
    inputs: List[Subscription] = field(default_factory=list)
    # Per-task resource hints for placement (Storm's setMemoryLoad and
    # setCPULoad).
    resources: dict = field(default_factory=dict)


class _Declarer:
    def __init__(self, spec: ComponentSpec) -> None:
        self._spec = spec

    def grouping(self, source: str, grouping: G.Grouping,
                 stream: str = "default") -> "_Declarer":
        self._spec.inputs.append(Subscription(source, stream, grouping))
        return self

    def shuffle_grouping(self, source: str, stream: str = "default") -> "_Declarer":
        return self.grouping(source, G.ShuffleGrouping(), stream)

    def local_or_shuffle_grouping(self, source: str,
                                  stream: str = "default") -> "_Declarer":
        return self.grouping(source, G.LocalOrShuffleGrouping(), stream)

    def fields_grouping(self, source: str, *fields: str,
                        stream: str = "default") -> "_Declarer":
        return self.grouping(source, G.FieldsGrouping(*fields), stream)

    def all_grouping(self, source: str, stream: str = "default") -> "_Declarer":
        return self.grouping(source, G.AllGrouping(), stream)

    def global_grouping(self, source: str, stream: str = "default") -> "_Declarer":
        return self.grouping(source, G.GlobalGrouping(), stream)

    def none_grouping(self, source: str, stream: str = "default") -> "_Declarer":
        return self.grouping(source, G.NoneGrouping(), stream)

    def partial_key_grouping(self, source: str, *fields: str,
                             stream: str = "default") -> "_Declarer":
        return self.grouping(source, G.PartialKeyGrouping(*fields), stream)

    def ring_fields_grouping(self, source: str, *fields: str,
                             stream: str = "default") -> "_Declarer":
        """Fields grouping over a consistent-hash ring
        (:class:`storm_tpu_torch.dist.ring.RingFieldsGrouping`): same key,
        same task, and a rebalance remaps about 1/N of the keys instead of
        nearly all of them."""
        from storm_tpu_torch.dist.ring import RingFieldsGrouping

        return self.grouping(source, RingFieldsGrouping(*fields), stream)

    def direct_grouping(self, source: str, stream: str = "default") -> "_Declarer":
        """Subscribe for ``collector.emit_direct(task, ...)`` deliveries."""
        return self.grouping(source, G.DirectGrouping(), stream)

    def custom_grouping(self, source: str, grouping: G.Grouping,
                        stream: str = "default") -> "_Declarer":
        """Storm's ``customGrouping``: any user Grouping subclass."""
        return self.grouping(source, grouping, stream)

    def set_memory_load(self, mb: float) -> "_Declarer":
        """Per-task memory hint (Storm's ``setMemoryLoad``)."""
        self._spec.resources["memory_mb"] = float(mb)
        return self

    def set_cpu_load(self, pct: float) -> "_Declarer":
        """Per-task CPU hint (Storm's ``setCPULoad``; 100 = one core)."""
        self._spec.resources["cpu"] = float(pct)
        return self


@dataclass
class Topology:
    specs: Dict[str, ComponentSpec]

    def validate(self) -> None:
        for spec in self.specs.values():
            if spec.is_spout and spec.inputs:
                raise ValueError(
                    f"spout {spec.component_id!r} cannot subscribe to streams")
            for sub in spec.inputs:
                if sub.source not in self.specs:
                    raise ValueError(
                        f"{spec.component_id} subscribes to unknown component "
                        f"{sub.source!r}")
        # Reject cycles: the ack model assumes a DAG.
        state: Dict[str, int] = {}

        def visit(cid: str) -> None:
            if state.get(cid) == 1:
                raise ValueError(f"topology has a cycle through {cid!r}")
            if state.get(cid) == 2:
                return
            state[cid] = 1
            for other in self.specs.values():
                if any(s.source == cid for s in other.inputs):
                    visit(other.component_id)
            state[cid] = 2

        for cid in self.specs:
            visit(cid)


class TopologyBuilder:
    def __init__(self) -> None:
        self._specs: Dict[str, ComponentSpec] = {}

    def _add(self, component_id: str, obj: object, parallelism: int,
             is_spout: bool) -> ComponentSpec:
        if component_id in self._specs:
            raise ValueError(f"duplicate component id {component_id!r}")
        if component_id.startswith("__"):
            raise ValueError("component ids starting with '__' are reserved")
        if parallelism < 1:
            raise ValueError("parallelism must be >= 1")
        spec = ComponentSpec(component_id, obj, parallelism, is_spout)
        self._specs[component_id] = spec
        return spec

    def set_spout(self, component_id: str, spout: Spout,
                  parallelism: int = 1) -> _Declarer:
        return _Declarer(self._add(component_id, spout, parallelism, True))

    def set_bolt(self, component_id: str, bolt: Bolt,
                 parallelism: int = 1) -> _Declarer:
        return _Declarer(self._add(component_id, bolt, parallelism, False))

    def build(self) -> Topology:
        topo = Topology(dict(self._specs))
        topo.validate()
        return topo
