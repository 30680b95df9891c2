from storm_tpu_torch.connectors.memory import MemoryBroker, MemoryTxn, Record
from storm_tpu_torch.connectors.sink import (BrokerSink, DefaultTopicSelector, MemoryProducer,
                                             Producer, TransactionalBrokerSink)
from storm_tpu_torch.connectors.spout import BrokerSpout

__all__ = ["BrokerSink", "BrokerSpout", "DefaultTopicSelector", "MemoryBroker",
           "MemoryProducer", "MemoryTxn", "Producer", "Record", "TransactionalBrokerSink"]
