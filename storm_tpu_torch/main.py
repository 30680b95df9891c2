"""The topology builders of ``storm_tpu/main.py`` (its CLI is not ported):
``build_standard_topology``, the reference DAG (one ingest spout, the
inference operator, an egress sink and a dead-letter sink, with the
topology config's parallelism and the spout's chunks, scheme and frames
taken from ``cfg.topology``), and ``build_null_engine_topology``, the
same DAG with a device-free :class:`NullEngine` in the inference slot.
Both sinks are transactional under ``cfg.sink.mode == "transactional"``
(``_make_sink``). ``_make_broker`` builds ``cfg.broker``: the memory
broker, or the Kafka wire broker that dist workers share. The topics
default to ``cfg.broker``'s, which is how a dist worker builds them.
"""

from __future__ import annotations

from typing import Optional

from storm_tpu_torch.config import Config


def _make_sink(cfg: Config, broker, topic: str):
    from storm_tpu_torch.connectors import BrokerSink, TransactionalBrokerSink

    if cfg.sink.mode == "transactional":
        return TransactionalBrokerSink(broker, topic, cfg.sink)
    return BrokerSink(broker, topic, cfg.sink)


def _make_broker(cfg: Config):
    """``cfg.broker`` as a broker object: ``kind="memory"`` an in-process
    :class:`MemoryBroker`, ``kind="kafka"`` the pure-Python wire client's
    :class:`KafkaWireBroker` at ``bootstrap``."""
    if cfg.broker.kind == "memory":
        from storm_tpu_torch.connectors import MemoryBroker

        return MemoryBroker(default_partitions=cfg.broker.partitions)
    if cfg.broker.kind == "kafka":
        from storm_tpu_torch.connectors.kafka_protocol import KafkaWireBroker

        return KafkaWireBroker(cfg.broker.bootstrap,
                               message_format=cfg.broker.message_format,
                               compression=cfg.broker.compression,
                               idempotent=cfg.broker.idempotent,
                               isolation=cfg.broker.isolation,
                               security=cfg.broker.security_dict())
    raise ValueError(f"unknown broker kind {cfg.broker.kind!r}")


def _build(cfg: Config, broker, bolt, input_topic, output_topic, dead_letter_topic):
    from storm_tpu_torch.connectors import BrokerSpout
    from storm_tpu_torch.runtime import TopologyBuilder

    qos = cfg.qos if cfg.qos.enabled else None
    topo = cfg.topology
    tb = TopologyBuilder()
    tb.set_spout("kafka-spout",
                 BrokerSpout(broker, input_topic or cfg.broker.input_topic, cfg.offsets,
                             chunk=topo.spout_chunk, scheme=topo.spout_scheme, qos=qos,
                             frames=topo.spout_frames),
                 parallelism=topo.spout_parallelism)
    tb.set_bolt("inference-bolt", bolt,
                parallelism=topo.inference_parallelism).shuffle_grouping("kafka-spout")
    tb.set_bolt("kafka-bolt", _make_sink(cfg, broker, output_topic or cfg.broker.output_topic),
                parallelism=topo.sink_parallelism).shuffle_grouping("inference-bolt")
    tb.set_bolt("dlq-bolt",
                _make_sink(cfg, broker, dead_letter_topic or cfg.broker.dead_letter_topic),
                parallelism=1).shuffle_grouping("inference-bolt", stream="dead_letter")
    return tb.build()


def build_standard_topology(cfg: Config, broker, *, input_topic: Optional[str] = None,
                            output_topic: Optional[str] = None,
                            dead_letter_topic: Optional[str] = None, device=None,
                            engine=None):
    """``broker``'s input topic -> ``kafka-spout`` -> ``inference-bolt``
    (``cfg.model`` and ``cfg.batch`` on ``device``, or ``engine``) ->
    ``kafka-bolt`` -> the output topic, and the operator's dead letters ->
    ``dlq-bolt`` -> the dead-letter topic; a topic not given is
    ``cfg.broker``'s. With ``cfg.qos`` enabled the spout classifies and
    admits records and the lane rides to the sink
    (``passthrough=("qos_lane",)``); with ``cfg.cascade`` enabled the
    operator serves through the cascade's tiers."""
    from storm_tpu_torch.infer import InferenceBolt

    qos = cfg.qos if cfg.qos.enabled else None
    cascade = cfg.cascade if cfg.cascade.enabled else None
    bolt = InferenceBolt(cfg.model, cfg.batch, device=device, engine=engine, qos=qos,
                         sharding=cfg.sharding,
                         cascade=cascade, passthrough=("qos_lane",) if qos else ())
    return _build(cfg, broker, bolt, input_topic, output_topic, dead_letter_topic)


def build_null_engine_topology(cfg: Config, broker, *, input_topic: Optional[str] = None,
                               output_topic: Optional[str] = None,
                               dead_letter_topic: Optional[str] = None, device=None):
    """The standard DAG with a :class:`NullEngine` in the inference slot:
    no device work, predictions a uniform distribution computed at once,
    so everything measured is the framework's cost (spout, routing,
    ledger, the inter-worker wire). ``device`` is accepted for the dist
    workers' builder call and unused."""
    from storm_tpu_torch.infer import InferenceBolt
    from storm_tpu_torch.infer.engine import NullEngine

    qos = cfg.qos if cfg.qos.enabled else None
    cascade = cfg.cascade if cfg.cascade.enabled else None
    engine = NullEngine(cfg.model.input_shape, cfg.model.num_classes)
    bolt = InferenceBolt(cfg.model, cfg.batch, engine=engine, warmup=False, qos=qos,
                         sharding=cfg.sharding,
                         cascade=cascade, passthrough=("qos_lane",) if qos else ())
    return _build(cfg, broker, bolt, input_topic, output_topic, dead_letter_topic)
