"""Modules and seeded numpy initializers shared by the model families.

Each module holds one layer's tensors as buffers and calls the functional
layer of ``storm_tpu_torch.ops.layers``. Serving builds a module once from
prepared tensors (``models/convert.py``); training builds one per step
from the parameter leaves that require grad (``convert.apply``), so the
buffers are those leaves, or differentiable views of them, and gradients
reach the leaves through every forward. In train mode (``module.train()``)
a :class:`ConvBN` normalizes with its batch's statistics and keeps the
updated running ones in ``new_state``. The initializers draw the JAX
package's distributions from a numpy ``RandomState`` and lay parameters
out as the JAX package does: dense ``w`` (in, out), convolution kernels
HWIO, BatchNorm running statistics in the state tree.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from storm_tpu_torch.ops import layers as L


class Dense(nn.Module):
    """``{"w": (in, out) float | {"__q": int8, "__s": f32}, "b"}``."""

    def __init__(self, p: dict) -> None:
        super().__init__()
        w = p["w"]
        self.quantized = isinstance(w, dict)
        if self.quantized:
            self.register_buffer("q", w["__q"])
            self.register_buffer("s", w["__s"])
        else:
            self.register_buffer("w", w)
        self.register_buffer("b", p["b"])

    def params(self) -> dict:
        w = {"__q": self.q, "__s": self.s} if self.quantized else self.w
        return {"w": w, "b": self.b}

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return L.dense(self.params(), x)


class LayerNorm(nn.Module):
    def __init__(self, p: dict) -> None:
        super().__init__()
        self.register_buffer("scale", p["scale"])
        self.register_buffer("bias", p["bias"])

    def params(self) -> dict:
        return {"scale": self.scale, "bias": self.bias}

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return L.layernorm(self.params(), x)


class Conv(nn.Module):
    """``{"w": (kh, kw, cin, cout) HWIO, "b"?}``, held OIHW for
    ``F.conv2d``; NHWC in and out, SAME padding by XLA's rule. With
    ``depthwise`` the kernel is (kh, kw, 1, C), one filter per channel."""

    def __init__(self, p: dict, stride: int = 1, depthwise: bool = False) -> None:
        super().__init__()
        self.stride = stride
        self.depthwise = depthwise
        self.register_buffer("w", p["w"].permute(3, 2, 0, 1).contiguous())
        self.has_bias = "b" in p
        if self.has_bias:
            self.register_buffer("b", p["b"])

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        p = {"w": self.w, "b": self.b} if self.has_bias else {"w": self.w}
        conv = L.depthwise_conv2d if self.depthwise else L.conv2d
        return conv(p, x, stride=self.stride, padding="same")


class ConvBN(nn.Module):
    """Bias-free convolution, BatchNorm, then ``act`` (ReLU by default;
    None for none): ``{"conv": {"w"}, "bn": {"scale", "bias"}}`` with
    state ``{"bn": {"mean", "var"}}`` (float32 in every mode). ``conv``
    names the convolution's key (MobileNetV2's depthwise convolutions sit
    under ``"dw"``, with ``depthwise``). In train mode the running
    statistics a forward computes are kept in ``new_state`` (``{"mean",
    "var"}``); every family names a ConvBN by the path of its state above
    ``"bn"`` (``stages.0.1.a`` holds ``state["stages"][0][1]["a"]``), which
    is how ``convert.apply`` gathers the new state tree."""

    def __init__(self, p: dict, s: dict, stride: int = 1, act=F.relu,
                 conv: str = "conv", depthwise: bool = False) -> None:
        super().__init__()
        self.conv = Conv(p[conv], stride, depthwise)
        self.act = act
        for name in ("scale", "bias"):
            self.register_buffer(name, p["bn"][name])
        for name in ("mean", "var"):
            self.register_buffer(name, s["bn"][name])
        self.new_state = None

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x, new_state = L.batchnorm({"scale": self.scale, "bias": self.bias},
                                   {"mean": self.mean, "var": self.var}, self.conv(x),
                                   train=self.training)
        if self.training:
            self.new_state = new_state
        return x if self.act is None else self.act(x)


# ---- seeded numpy initializers (the JAX package's distributions) ----------


def normal(rng: np.random.RandomState, shape, std) -> np.ndarray:
    return (rng.standard_normal(shape) * std).astype(np.float32)


def trunc_normal(rng: np.random.RandomState, shape, std=0.02) -> np.ndarray:
    x = rng.standard_normal(shape)
    bad = np.abs(x) > 2.0
    while bad.any():
        x[bad] = rng.standard_normal(int(bad.sum()))
        bad = np.abs(x) > 2.0
    return (x * std).astype(np.float32)


def dense_init(rng: np.random.RandomState, n_in: int, n_out: int) -> dict:
    """LeCun normal weights, zero bias."""
    return {"w": normal(rng, (n_in, n_out), np.sqrt(1.0 / n_in)),
            "b": np.zeros((n_out,), np.float32)}


def ln_init(dim: int) -> dict:
    return {"scale": np.ones((dim,), np.float32),
            "bias": np.zeros((dim,), np.float32)}


def conv_init(rng: np.random.RandomState, kh: int, kw: int, cin: int, cout: int,
              bias: bool = True) -> dict:
    """He normal HWIO kernel, zero bias."""
    p = {"w": normal(rng, (kh, kw, cin, cout), np.sqrt(2.0 / (kh * kw * cin)))}
    if bias:
        p["b"] = np.zeros((cout,), np.float32)
    return p


def conv_bn_init(rng: np.random.RandomState, kh: int, kw: int, cin: int,
                 cout: int) -> tuple:
    """(params, state) of a :class:`ConvBN`: BatchNorm scale 1, bias 0,
    running mean 0, variance 1."""
    p = {"conv": conv_init(rng, kh, kw, cin, cout, bias=False), "bn": ln_init(cout)}
    s = {"bn": {"mean": np.zeros((cout,), np.float32),
                "var": np.ones((cout,), np.float32)}}
    return p, s
