from storm_tpu_torch.runtime.base import Bolt, OutputCollector, Spout, TopologyContext
from storm_tpu_torch.runtime.cluster import AsyncLocalCluster, LocalCluster
from storm_tpu_torch.runtime.topology import Topology, TopologyBuilder
from storm_tpu_torch.runtime.tuples import Tuple, Values

__all__ = ["AsyncLocalCluster", "Bolt", "LocalCluster", "OutputCollector",
           "Spout", "Topology", "TopologyBuilder",
           "TopologyContext", "Tuple", "Values"]
