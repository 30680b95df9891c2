"""RemoteInferenceBolt, the counterpart of ``storm_tpu/serve/remote_bolt.py``:
the inference operator with its engine behind an inference worker
(:mod:`storm_tpu_torch.serve.worker`) instead of in this process. The
streaming behaviour is :class:`~storm_tpu_torch.infer.InferenceBolt`'s
(micro-batching, deferred acks, dead letters, QoS lanes and passthrough);
only the forward crosses the wire, as one ``Predict`` a batch. The bolt's
engine has ``predict`` alone, which the operator serves serialized."""

from __future__ import annotations

from typing import Optional

from storm_tpu_torch.config import BatchConfig
from storm_tpu_torch.infer.operator import InferenceBolt
from storm_tpu_torch.runtime.base import OutputCollector, TopologyContext
from storm_tpu_torch.serve.client import InferenceClient


class _RemoteEngine:
    """The engine as the operator sees it: ``predict`` over the wire, the
    input shape from the worker's ``Info``."""

    def __init__(self, client: InferenceClient, input_shape: tuple) -> None:
        self.client = client
        self.input_shape = input_shape

    def predict(self, x):
        return self.client.predict(x)

    def warmup(self, buckets=None) -> None:
        pass  # the worker warmed its engine


class RemoteInferenceBolt(InferenceBolt):
    def __init__(self, target: str = "localhost:50051",
                 batch: Optional[BatchConfig] = None, warmup: bool = False,
                 qos=None, passthrough=()) -> None:
        super().__init__(batch=batch, warmup=warmup, qos=qos, passthrough=passthrough)
        self.target = target

    def clone(self) -> "RemoteInferenceBolt":
        return RemoteInferenceBolt(self.target, self.batch_cfg, self._warmup, self.qos,
                                   self.passthrough)

    def prewarm(self) -> None:
        pass  # no engine in this process

    def prepare(self, context: TopologyContext, collector: OutputCollector) -> None:
        self.client = InferenceClient(self.target)
        info = self.client.info()
        self._engine = _RemoteEngine(self.client, tuple(info["input_shape"]))
        super().prepare(context, collector)

    def cleanup(self) -> None:
        super().cleanup()
        self.client.close()
