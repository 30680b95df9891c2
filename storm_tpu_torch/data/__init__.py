"""Datasets the port serves and checks against: the handwritten digits."""

from storm_tpu_torch.data.digits import load_digits_nhwc

__all__ = ["load_digits_nhwc"]
