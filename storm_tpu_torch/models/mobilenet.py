"""MobileNetV2, the counterpart of ``storm_tpu/models/mobilenet.py``:
inverted residual bottlenecks (1x1 expand, 3x3 depthwise, 1x1 project,
each with inference BatchNorm; ReLU6 after the first two) over the
MobileNetV2 paper's stage table, a 1x1 conv-BN-ReLU6 head to 1280
channels, global average pooling and a dense classifier.

The CIFAR adaptation is kept: at inputs of 64 pixels or less the stem
and the first downsampling stage run at stride 1. One stride table,
computed once, serves the parameters' construction and the forward.
Depthwise and stride-2 convolutions pad by XLA's SAME rule (the extra
row and column at the end).
"""

from __future__ import annotations

import numpy as np
import torch
from torch import nn

from storm_tpu_torch.models.common import ConvBN, Dense, conv_bn_init, dense_init, ln_init, normal
from storm_tpu_torch.models.registry import ModelDef, register
from storm_tpu_torch.ops import layers as L

# (expansion t, out channels c, repeats n, stride s): the paper's table 2.
STAGES = [
    (1, 16, 1, 1),
    (6, 24, 2, 2),
    (6, 32, 3, 2),
    (6, 64, 4, 2),
    (6, 96, 3, 1),
    (6, 160, 3, 2),
    (6, 320, 1, 1),
]


def _round_c(c: float, divisor: int = 8) -> int:
    """The paper implementations' _make_divisible: round to the nearest
    multiple of 8, never rounding down by more than 10%."""
    new_c = max(divisor, int(c + divisor / 2) // divisor * divisor)
    if new_c < 0.9 * c:
        new_c += divisor
    return new_c


def block_strides(small_input: bool) -> list:
    """The stride of every inverted residual block, in order."""
    strides = []
    for si, (_t, _c, n, s0) in enumerate(STAGES):
        for b in range(n):
            stride = s0 if b == 0 else 1
            if small_input and si == 1 and b == 0:
                stride = 1
            strides.append(stride)
    return strides


def _dwbn_init(rng: np.random.RandomState, c: int) -> tuple:
    """(params, state) of a 3x3 depthwise conv-BN: He normal (kh, kw, 1, C)
    kernel over a fan-in of 9."""
    p = {"dw": {"w": normal(rng, (3, 3, 1, c), np.sqrt(2.0 / 9))}, "bn": ln_init(c)}
    s = {"bn": {"mean": np.zeros((c,), np.float32), "var": np.ones((c,), np.float32)}}
    return p, s


class InvertedResidual(nn.Module):
    def __init__(self, p: dict, s: dict, stride: int) -> None:
        super().__init__()
        self.expand = ConvBN(p["expand"], s["expand"], act=L.relu6) if "expand" in p else None
        self.dw = ConvBN(p["dw"], s["dw"], stride, act=L.relu6, conv="dw", depthwise=True)
        self.project = ConvBN(p["project"], s["project"], act=None)
        self.stride = stride

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = x if self.expand is None else self.expand(x)
        y = self.project(self.dw(y))
        if self.stride == 1 and x.shape[-1] == y.shape[-1]:
            y = y + x
        return y


class MobileNetV2(nn.Module):
    def __init__(self, p: dict, s: dict, *, stem_stride: int, strides: list) -> None:
        super().__init__()
        self.stem = ConvBN(p["stem"], s["stem"], stem_stride, act=L.relu6)
        self.blocks = nn.ModuleList(InvertedResidual(bp, bs, st)
                                    for bp, bs, st in zip(p["blocks"], s["blocks"], strides))
        self.head = ConvBN(p["head"], s["head"], act=L.relu6)
        self.fc = Dense(p["fc"])

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        """(B, H, W, C) in the compute dtype -> (B, num_classes) logits."""
        y = self.stem(x)
        for blk in self.blocks:
            y = blk(y)
        return self.fc(L.global_avg_pool(self.head(y)))


@register("mobilenetv2")
def build_mobilenetv2(num_classes: int = 1000, input_shape: tuple = (224, 224, 3),
                      width: float = 1.0) -> ModelDef:
    small_input = input_shape[0] <= 64  # CIFAR-style adaptation
    stem_stride = 1 if small_input else 2
    head_c = _round_c(1280 * max(1.0, width))
    strides = block_strides(small_input)

    def init(rng: np.random.RandomState) -> tuple:
        params, state = {}, {}
        cin = _round_c(32 * width)
        params["stem"], state["stem"] = conv_bn_init(rng, 3, 3, input_shape[-1], cin)
        blocks_p, blocks_s = [], []
        for t, c, n, _s0 in STAGES:
            cout = _round_c(c * width)
            for _ in range(n):
                cmid = cin * t
                bp, bs = {}, {}
                if t != 1:
                    bp["expand"], bs["expand"] = conv_bn_init(rng, 1, 1, cin, cmid)
                bp["dw"], bs["dw"] = _dwbn_init(rng, cmid)
                bp["project"], bs["project"] = conv_bn_init(rng, 1, 1, cmid, cout)
                blocks_p.append(bp)
                blocks_s.append(bs)
                cin = cout
        params["blocks"], state["blocks"] = blocks_p, blocks_s
        params["head"], state["head"] = conv_bn_init(rng, 1, 1, cin, head_c)
        params["fc"] = dense_init(rng, head_c, num_classes)
        return params, state

    hyper = {"input_shape": tuple(input_shape), "num_classes": num_classes, "width": width}
    return ModelDef("mobilenetv2", tuple(input_shape), num_classes, init,
                    lambda p, s: MobileNetV2(p, s, stem_stride=stem_stride, strides=strides),
                    hyper)
