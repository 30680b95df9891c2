from storm_tpu_torch.connectors.memory import MemoryBroker, Record
from storm_tpu_torch.connectors.sink import BrokerSink
from storm_tpu_torch.connectors.spout import BrokerSpout

__all__ = ["BrokerSink", "BrokerSpout", "MemoryBroker", "Record"]
