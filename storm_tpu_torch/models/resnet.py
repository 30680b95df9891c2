"""ResNet-20, the counterpart of ``storm_tpu/models/resnet.py:63-99``:
a conv-BN-ReLU stem, 3 stages of 3 basic blocks at widths 16, 32 and 64
(stride 2 on the first block of stages 1 and 2, a 1x1 conv-BN ``down``
projection where the width changes), global average pooling and a dense
head. BatchNorm runs in inference mode from the running statistics in the
state tree, which stay float32 in every weight mode.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from storm_tpu_torch.models.common import ConvBN, Dense, conv_bn_init, dense_init
from storm_tpu_torch.models.registry import ModelDef, register
from storm_tpu_torch.ops import layers as L

WIDTHS = (16, 32, 64)
BLOCKS_PER_STAGE = 3


class BasicBlock(nn.Module):
    def __init__(self, p: dict, s: dict, stride: int) -> None:
        super().__init__()
        self.a = ConvBN(p["a"], s["a"], stride)
        self.b = ConvBN(p["b"], s["b"], act=False)
        self.down = ConvBN(p["down"], s["down"], stride, act=False) if "down" in p else None

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        idn = x if self.down is None else self.down(x)
        return F.relu(self.b(self.a(x)) + idn)


class ResNet20(nn.Module):
    def __init__(self, p: dict, s: dict) -> None:
        super().__init__()
        self.stem = ConvBN(p["stem"], s["stem"])
        self.stages = nn.ModuleList(
            nn.ModuleList(BasicBlock(pb, sb, 2 if (si > 0 and bi == 0) else 1)
                          for bi, (pb, sb) in enumerate(zip(sp, ss)))
            for si, (sp, ss) in enumerate(zip(p["stages"], s["stages"])))
        self.head = Dense(p["head"])

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        """(B, H, W, C) in the compute dtype -> (B, num_classes) logits."""
        x = self.stem(x)
        for stage in self.stages:
            for block in stage:
                x = block(x)
        return self.head(L.global_avg_pool(x))


@register("resnet20")
def build_resnet20(num_classes: int = 10, input_shape: tuple = (32, 32, 3)) -> ModelDef:
    def init(rng: np.random.RandomState) -> tuple:
        p_stem, s_stem = conv_bn_init(rng, 3, 3, input_shape[2], WIDTHS[0])
        params = {"stem": p_stem, "stages": []}
        state = {"stem": s_stem, "stages": []}
        cin = WIDTHS[0]
        for w in WIDTHS:
            sp, ss = [], []
            for _ in range(BLOCKS_PER_STAGE):
                pa, sa = conv_bn_init(rng, 3, 3, cin, w)
                pb, sb = conv_bn_init(rng, 3, 3, w, w)
                p, s = {"a": pa, "b": pb}, {"a": sa, "b": sb}
                if cin != w:
                    p["down"], s["down"] = conv_bn_init(rng, 1, 1, cin, w)
                sp.append(p)
                ss.append(s)
                cin = w
            params["stages"].append(sp)
            state["stages"].append(ss)
        params["head"] = dense_init(rng, WIDTHS[-1], num_classes)
        return params, state

    hyper = {"input_shape": tuple(input_shape), "num_classes": num_classes}
    return ModelDef("resnet20", tuple(input_shape), num_classes, init, ResNet20, hyper)
