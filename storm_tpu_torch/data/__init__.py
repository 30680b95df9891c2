"""Datasets the port serves and checks against, the handwritten digits,
and the convergence trainer."""

from storm_tpu_torch.data.digits import load_digits_nhwc, train_to_convergence

__all__ = ["load_digits_nhwc", "train_to_convergence"]
