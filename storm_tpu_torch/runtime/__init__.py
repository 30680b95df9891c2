from storm_tpu_torch.runtime.base import Bolt, OutputCollector, Spout, TopologyContext
from storm_tpu_torch.runtime.cluster import AsyncLocalCluster, LocalCluster
from storm_tpu_torch.runtime.event_time import EventTimeWindowBolt
from storm_tpu_torch.runtime.join import JoinBolt
from storm_tpu_torch.runtime.shell import ShellBolt, ShellSpout
from storm_tpu_torch.runtime.state import (FileStateBackend, KeyValueState,
                                           MemoryStateBackend, StatefulBolt)
from storm_tpu_torch.runtime.topology import Topology, TopologyBuilder
from storm_tpu_torch.runtime.tuples import TickTuple, Tuple, Values
from storm_tpu_torch.runtime.window import TumblingWindowBolt, WindowedBolt

__all__ = ["AsyncLocalCluster", "Bolt", "EventTimeWindowBolt", "FileStateBackend",
           "JoinBolt", "KeyValueState", "LocalCluster", "MemoryStateBackend",
           "OutputCollector", "ShellBolt", "ShellSpout", "Spout", "StatefulBolt",
           "TickTuple", "Topology", "TopologyBuilder", "TopologyContext",
           "TumblingWindowBolt", "Tuple", "Values", "WindowedBolt"]
