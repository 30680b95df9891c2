from storm_tpu_torch.runtime.base import Bolt, OutputCollector, Spout, TopologyContext
from storm_tpu_torch.runtime.cluster import AsyncLocalCluster, LocalCluster
from storm_tpu_torch.runtime.state import (FileStateBackend, KeyValueState,
                                           MemoryStateBackend, StatefulBolt)
from storm_tpu_torch.runtime.topology import Topology, TopologyBuilder
from storm_tpu_torch.runtime.tuples import TickTuple, Tuple, Values

__all__ = ["AsyncLocalCluster", "Bolt", "FileStateBackend", "KeyValueState",
           "LocalCluster", "MemoryStateBackend", "OutputCollector", "Spout",
           "StatefulBolt", "TickTuple", "Topology", "TopologyBuilder",
           "TopologyContext", "Tuple", "Values"]
