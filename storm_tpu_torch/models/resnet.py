"""ResNets, the counterpart of ``storm_tpu/models/resnet.py``.

ResNet-20 (CIFAR): a conv-BN-ReLU stem, 3 stages of 3 basic blocks at
widths 16, 32 and 64 (stride 2 on the first block of stages 1 and 2, a 1x1
conv-BN ``down`` projection where the width changes), global average
pooling and a dense head.

ResNet-50 (ImageNet): a 7x7 stride-2 conv-BN-ReLU stem, a 3x3 stride-2 max
pool with XLA's VALID rule (no padding, unlike torchvision's), 4 stages of
3, 4, 6 and 3 bottleneck blocks (1x1, 3x3 carrying the stride, 1x1 at four
times the width; a 1x1 ``down`` projection where the width changes;
stride 2 on the first block of stages 1 to 3), global average pooling and
a dense head.

BatchNorm runs in inference mode from the running statistics in the state
tree, which stay float32 in every weight mode.
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
        self.b = ConvBN(p["b"], s["b"], act=None)
        self.down = ConvBN(p["down"], s["down"], stride, act=None) if "down" in p else None

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


# ---- ResNet-50 (ImageNet): bottleneck blocks [3, 4, 6, 3] -------------------

STAGE_BLOCKS_50 = (3, 4, 6, 3)
MIDS_50 = (64, 128, 256, 512)


class Bottleneck(nn.Module):
    def __init__(self, p: dict, s: dict, stride: int) -> None:
        super().__init__()
        self.a = ConvBN(p["a"], s["a"])
        self.b = ConvBN(p["b"], s["b"], stride)
        self.c = ConvBN(p["c"], s["c"], act=None)
        self.down = ConvBN(p["down"], s["down"], stride, act=None) if "down" in p else None

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        idn = x if self.down is None else self.down(x)
        return F.relu(self.c(self.b(self.a(x))) + idn)


class ResNet50(nn.Module):
    def __init__(self, p: dict, s: dict) -> None:
        super().__init__()
        self.stem = ConvBN(p["stem"], s["stem"], stride=2)
        self.stages = nn.ModuleList(
            nn.ModuleList(Bottleneck(pb, sb, 2 if (si > 0 and bi == 0) else 1)
                          for bi, (pb, sb) in enumerate(zip(sp, ss)))
            for si, (sp, ss) in enumerate(zip(p["stages"], s["stages"])))
        self.head = Dense(p["head"])

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        """(B, H, W, C) in the compute dtype -> (B, num_classes) logits."""
        x = self.stem(x)
        if x.shape[1] >= 3:
            x = L.max_pool(x, window=3, stride=2)
        for stage in self.stages:
            for block in stage:
                x = block(x)
        return self.head(L.global_avg_pool(x))


@register("resnet50")
def build_resnet50(num_classes: int = 1000, input_shape: tuple = (224, 224, 3)) -> ModelDef:
    def init(rng: np.random.RandomState) -> tuple:
        p_stem, s_stem = conv_bn_init(rng, 7, 7, input_shape[2], 64)
        params = {"stem": p_stem, "stages": []}
        state = {"stem": s_stem, "stages": []}
        cin = 64
        for mid, nb in zip(MIDS_50, STAGE_BLOCKS_50):
            cout = mid * 4
            sp, ss = [], []
            for _ in range(nb):
                pa, sa = conv_bn_init(rng, 1, 1, cin, mid)
                pb, sb = conv_bn_init(rng, 3, 3, mid, mid)
                pc, sc = conv_bn_init(rng, 1, 1, mid, cout)
                p, s = {"a": pa, "b": pb, "c": pc}, {"a": sa, "b": sb, "c": sc}
                if cin != cout:
                    p["down"], s["down"] = conv_bn_init(rng, 1, 1, cin, cout)
                sp.append(p)
                ss.append(s)
                cin = cout
            params["stages"].append(sp)
            state["stages"].append(ss)
        params["head"] = dense_init(rng, MIDS_50[-1] * 4, num_classes)
        return params, state

    hyper = {"input_shape": tuple(input_shape), "num_classes": num_classes}
    return ModelDef("resnet50", tuple(input_shape), num_classes, init, ResNet50, hyper)
