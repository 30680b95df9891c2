"""Parallel layers and training of the port. Only what one card runs so
far: the mixture-of-experts layer at one expert shard (``moe``) and the
training step (``train``)."""

from storm_tpu_torch.parallel.train import (
    Optimizer, adam_moments, adamw, make_train_step, train_one_step)

__all__ = ["Optimizer", "adam_moments", "adamw", "make_train_step", "train_one_step"]
