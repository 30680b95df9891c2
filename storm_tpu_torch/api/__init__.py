from storm_tpu_torch.api.schema import (
    DeadLetter, Instances, Predictions, SchemaError, decode_instances,
    decode_predictions, encode_predictions)

__all__ = ["DeadLetter", "Instances", "Predictions", "SchemaError",
           "decode_instances", "decode_predictions", "encode_predictions"]
