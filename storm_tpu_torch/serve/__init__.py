"""The serving boundary's marshalling: the Arrow tensor codec
(:mod:`storm_tpu_torch.serve.marshal`). storm_tpu's gRPC worker and
client (``storm_tpu/serve/worker.py``, ``client.py``) are not ported."""

from storm_tpu_torch.serve.marshal import decode_tensor, encode_tensor

__all__ = ["decode_tensor", "encode_tensor"]
