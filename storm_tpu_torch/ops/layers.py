"""Functional layers over parameter dicts, the counterpart of
``storm_tpu/ops/layers.py``: NHWC activations, dense weights stored
(in, out), convolution weights stored OIHW (converted from the JAX
package's HWIO when weights are carried across, see
``storm_tpu_torch.models.convert``).

Dense and convolution here are plain PyTorch, as the JAX package leaves
them to XLA; a dense layer whose weight is int8 (``{"__q", "__s"}``) runs
the w8a16 kernel instead.
"""

from __future__ import annotations

from typing import Tuple, Union

import torch
import torch.nn.functional as F

from storm_tpu_torch.ops.quant_matmul import qdense


def dense(p: dict, x: torch.Tensor) -> torch.Tensor:
    """``x @ w + b``: accumulated in f32, cast to x.dtype, then the bias
    added in x.dtype."""
    w = p["w"]
    if isinstance(w, dict):
        return qdense(p, x)
    return torch.matmul(x.float(), w.float()).to(x.dtype) + p["b"]


def conv2d(p: dict, x: torch.Tensor, stride: Union[int, Tuple[int, int]] = 1,
           padding: str = "valid") -> torch.Tensor:
    """NHWC input x OIHW weight -> NHWC output, in x.dtype; the bias is
    added after the cast. ``padding`` as in ``F.conv2d`` ("valid", or
    "same" at stride 1)."""
    out = F.conv2d(x.permute(0, 3, 1, 2), p["w"].to(x.dtype), stride=stride,
                   padding=padding)
    out = out.permute(0, 2, 3, 1)
    if "b" in p:
        out = out + p["b"].to(x.dtype)
    return out


def layernorm(p: dict, x: torch.Tensor, eps: float = 1e-6) -> torch.Tensor:
    """LayerNorm over the last axis, statistics in f32, cast back."""
    xf = x.float()
    mean = xf.mean(dim=-1, keepdim=True)
    var = (xf - mean).square().mean(dim=-1, keepdim=True)
    y = (xf - mean) * torch.rsqrt(var + eps)
    return (y * p["scale"].float() + p["bias"].float()).to(x.dtype)


def gelu(x: torch.Tensor) -> torch.Tensor:
    """``jax.nn.gelu``'s default: the tanh approximation (PyTorch's own
    default is the exact erf form)."""
    return F.gelu(x, approximate="tanh")
