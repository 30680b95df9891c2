"""The standard topology builder, ``build_standard_topology`` of
``storm_tpu/main.py`` (its CLI is not ported): the reference DAG, one
ingest spout, the inference operator, an egress sink and a dead-letter
sink, with the topology config's parallelism and the spout's chunks,
scheme and frames taken from ``cfg.topology``. Both sinks are
transactional under ``cfg.sink.mode == "transactional"`` (``_make_sink``).
"""

from __future__ import annotations

from storm_tpu_torch.config import Config


def _make_sink(cfg: Config, broker, topic: str):
    from storm_tpu_torch.connectors import BrokerSink, TransactionalBrokerSink

    if cfg.sink.mode == "transactional":
        return TransactionalBrokerSink(broker, topic, cfg.sink)
    return BrokerSink(broker, topic, cfg.sink)


def build_standard_topology(cfg: Config, broker, *, input_topic: str = "input",
                            output_topic: str = "output",
                            dead_letter_topic: str = "dead-letter", device=None,
                            engine=None):
    """``broker``'s ``input_topic`` -> ``kafka-spout`` -> ``inference-bolt``
    (``cfg.model`` and ``cfg.batch`` on ``device``, or ``engine``) ->
    ``kafka-bolt`` -> ``output_topic``, and the operator's dead letters ->
    ``dlq-bolt`` -> ``dead_letter_topic``. With ``cfg.qos`` enabled the
    spout classifies and admits records and the lane rides to the sink
    (``passthrough=("qos_lane",)``); with ``cfg.cascade`` enabled the
    operator serves through the cascade's tiers."""
    from storm_tpu_torch.connectors import BrokerSpout
    from storm_tpu_torch.infer import InferenceBolt
    from storm_tpu_torch.runtime import TopologyBuilder

    qos = cfg.qos if cfg.qos.enabled else None
    cascade = cfg.cascade if cfg.cascade.enabled else None
    topo = cfg.topology
    tb = TopologyBuilder()
    tb.set_spout("kafka-spout",
                 BrokerSpout(broker, input_topic, cfg.offsets, chunk=topo.spout_chunk,
                             scheme=topo.spout_scheme, qos=qos, frames=topo.spout_frames),
                 parallelism=topo.spout_parallelism)
    tb.set_bolt("inference-bolt",
                InferenceBolt(cfg.model, cfg.batch, device=device, engine=engine, qos=qos,
                              cascade=cascade, passthrough=("qos_lane",) if qos else ()),
                parallelism=topo.inference_parallelism).shuffle_grouping("kafka-spout")
    tb.set_bolt("kafka-bolt", _make_sink(cfg, broker, output_topic),
                parallelism=topo.sink_parallelism).shuffle_grouping("inference-bolt")
    tb.set_bolt("dlq-bolt", _make_sink(cfg, broker, dead_letter_topic),
                parallelism=1).shuffle_grouping("inference-bolt", stream="dead_letter")
    return tb.build()
