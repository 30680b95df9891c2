"""LeNet-5, the counterpart of ``storm_tpu/models/lenet.py``:
conv6@5x5 -> pool -> conv16@5x5 -> pool -> fc120 -> fc84 -> fc<classes>,
SAME convolutions with ReLU, VALID 2x2 max pools, no state.

The features flatten in NHWC order (h, w, c) before ``f1``, as the JAX
package's ``reshape`` does, so its trained ``f1`` weights carry across.
The three dense layers go through ``ops/layers.py``'s dense: with int8
weights (``int8_fused``) each runs the w8a16 kernel.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from storm_tpu_torch.models.common import Conv, Dense, conv_init, dense_init
from storm_tpu_torch.models.registry import ModelDef, register
from storm_tpu_torch.ops import layers as L


class LeNet5(nn.Module):
    def __init__(self, p: dict) -> None:
        super().__init__()
        self.c1, self.c2 = Conv(p["c1"]), Conv(p["c2"])
        self.f1, self.f2, self.out = Dense(p["f1"]), Dense(p["f2"]), Dense(p["out"])

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        """(B, H, W, C) in the compute dtype -> (B, num_classes) logits."""
        x = L.max_pool(F.relu(self.c1(x)))
        x = L.max_pool(F.relu(self.c2(x)))
        x = x.reshape(x.shape[0], -1)  # NHWC order; a copy, so contiguous
        x = F.relu(self.f1(x))
        x = F.relu(self.f2(x))
        return self.out(x)


@register("lenet5")
def build_lenet5(num_classes: int = 10, input_shape: tuple = (28, 28, 1)) -> ModelDef:
    h, w, c = input_shape
    flat = (h // 4) * (w // 4) * 16  # after two VALID 2x2 pools

    def init(rng: np.random.RandomState) -> tuple:
        params = {"c1": conv_init(rng, 5, 5, c, 6), "c2": conv_init(rng, 5, 5, 6, 16),
                  "f1": dense_init(rng, flat, 120), "f2": dense_init(rng, 120, 84),
                  "out": dense_init(rng, 84, num_classes)}
        return params, {}

    hyper = {"input_shape": tuple(input_shape), "num_classes": num_classes}
    return ModelDef("lenet5", tuple(input_shape), num_classes, init,
                    lambda params, _state: LeNet5(params), hyper)
