from storm_tpu_torch.api.schema import (
    DeadLetter, Instances, Overloaded, Predictions, SchemaError, decode_instances,
    decode_instances_reference, decode_predictions, encode_predictions,
    encode_predictions_reference)

__all__ = ["DeadLetter", "Instances", "Overloaded", "Predictions", "SchemaError",
           "decode_instances", "decode_instances_reference", "decode_predictions",
           "encode_predictions", "encode_predictions_reference"]
