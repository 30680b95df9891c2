"""The serving boundary: the Arrow tensor codec
(:mod:`storm_tpu_torch.serve.marshal`), the inference worker and its
client over the port's frames (:mod:`.worker`, :mod:`.client`), the
cross-caller batcher (:mod:`.batcher`) and the remote inference bolt
(:mod:`.remote_bolt`)."""

from storm_tpu_torch.serve.marshal import decode_tensor, encode_tensor
from storm_tpu_torch.serve.worker import InferenceWorker
from storm_tpu_torch.serve.client import InferenceClient

__all__ = ["InferenceClient", "InferenceWorker", "decode_tensor", "encode_tensor"]
