"""Functional layers over parameter dicts, the counterpart of
``storm_tpu/ops/layers.py``: NHWC activations, dense weights stored
(in, out), convolution weights stored OIHW (converted from the JAX
package's HWIO when weights are carried across, see
``storm_tpu_torch.models.common.Conv``).

Dense, convolution, pooling and the norms here are PyTorch library calls,
as the JAX package leaves them to XLA outside any Pallas kernel; a dense
layer whose weight is int8 (``{"__q", "__s"}``) runs the w8a16 kernel
instead.
"""

from __future__ import annotations

from typing import Tuple, Union

import torch
import torch.nn.functional as F

from storm_tpu_torch.ops.quant_matmul import qdense


def dense(p: dict, x: torch.Tensor) -> torch.Tensor:
    """``x @ w + b``: accumulated in f32, cast to x.dtype, then the bias
    added in x.dtype (``jnp.dot(..., preferred_element_type=float32)``).

    On a CUDA tensor that is one GEMM in x.dtype, which cuBLAS accumulates
    in f32 for bf16 as long as
    ``torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction``
    is False (its default True lets split-K reduce partial sums in bf16;
    ``device.set_numeric_flags`` sets it False whenever an entry point
    resolves a CUDA device). On the CPU the
    operands are cast to f32 first: its bf16 GEMM is not shown to
    accumulate in f32."""
    w = p["w"]
    if isinstance(w, dict):
        return qdense(p, x)
    if x.is_cuda and w.dtype == x.dtype:
        return torch.matmul(x, w) + p["b"]
    return torch.matmul(x.float(), w.float()).to(x.dtype) + p["b"]


def same_padding(size: int, k: int, stride: int) -> Tuple[int, int]:
    """XLA's SAME rule for one spatial axis: ``ceil(size / stride)``
    outputs, the total padding split with the extra row or column at the
    end (at stride 2, k = 3 on an even size that is (0, 1))."""
    total = max((-(-size // stride) - 1) * stride + k - size, 0)
    return total // 2, total - total // 2


def conv2d(p: dict, x: torch.Tensor, stride: Union[int, Tuple[int, int]] = 1,
           padding: str = "same", groups: int = 1) -> torch.Tensor:
    """NHWC input x OIHW weight -> NHWC output, computed in x.dtype; the
    bias is added in x.dtype. ``padding`` is "same" (XLA's rule,
    :func:`same_padding`) or "valid"; ``groups`` as ``F.conv2d``'s (XLA's
    ``feature_group_count``)."""
    sh, sw = (stride, stride) if isinstance(stride, int) else stride
    w = p["w"].to(x.dtype)
    xc = x.permute(0, 3, 1, 2)
    pad: Tuple[int, int] = (0, 0)
    if padding.lower() == "same":
        top, bottom = same_padding(x.shape[1], w.shape[2], sh)
        left, right = same_padding(x.shape[2], w.shape[3], sw)
        if (top, left) == (bottom, right):
            pad = (top, left)
        else:
            xc = F.pad(xc, (left, right, top, bottom))
    elif padding.lower() != "valid":
        raise ValueError(f"padding must be 'same' or 'valid', got {padding!r}")
    out = F.conv2d(xc, w, stride=(sh, sw), padding=pad, groups=groups).permute(0, 2, 3, 1)
    if "b" in p:
        out = out + p["b"].to(x.dtype)
    return out


def depthwise_conv2d(p: dict, x: torch.Tensor, stride: Union[int, Tuple[int, int]] = 1,
                     padding: str = "same") -> torch.Tensor:
    """NHWC depthwise convolution: one (kh, kw) filter per channel, the
    weight OIHW (C, 1, kh, kw) (the JAX package's HWIO (kh, kw, 1, C)
    transposed), ``groups`` = C."""
    return conv2d(p, x, stride=stride, padding=padding, groups=x.shape[-1])


def max_pool(x: torch.Tensor, window: int = 2, stride: int = 2) -> torch.Tensor:
    """Max pooling over H and W of an NHWC tensor with XLA's VALID rule
    (no padding, ``floor((size - window) / stride) + 1`` outputs)."""
    return F.max_pool2d(x.permute(0, 3, 1, 2), window, stride).permute(0, 2, 3, 1)


def global_avg_pool(x: torch.Tensor) -> torch.Tensor:
    """(B, H, W, C) -> (B, C): the mean over H and W, accumulated in f32
    and cast back to x.dtype."""
    return x.float().mean(dim=(1, 2)).to(x.dtype)


def batchnorm(p: dict, s: dict, x: torch.Tensor, train: bool = False,
              momentum: float = 0.9, eps: float = 1e-5) -> Tuple[torch.Tensor, dict]:
    """BatchNorm over the channel (last) axis, ``storm_tpu/ops/layers.py``'s
    ``batchnorm``: returns ``(y, new_state)``. Inference normalizes with
    the running statistics ``s`` (f32 ``mean``, ``var``) and returns ``s``;
    ``train`` normalizes with the batch's f32 mean and biased variance
    over every axis but the last, and returns ``momentum * old + (1 -
    momentum) * batch`` for both statistics (detached: running statistics
    carry no gradient). ``F.batch_norm`` differs on both counts (an
    unbiased running variance, momentum on the new value). Computed in
    f32 with ``p``'s ``scale`` and ``bias``, cast to x.dtype."""
    if train:
        axes = tuple(range(x.dim() - 1))
        xf = x.float()
        mean = xf.mean(dim=axes)
        var = (xf - mean).square().mean(dim=axes)
        new_s = {"mean": momentum * s["mean"] + (1 - momentum) * mean.detach(),
                 "var": momentum * s["var"] + (1 - momentum) * var.detach()}
    else:
        mean, var = s["mean"], s["var"]
        new_s = s
    inv = torch.rsqrt(var + eps) * p["scale"].float()
    y = (x.float() - mean) * inv + p["bias"].float()
    return y.to(x.dtype), new_s


def layernorm(p: dict, x: torch.Tensor, eps: float = 1e-6) -> torch.Tensor:
    """LayerNorm over the last axis, statistics in f32, cast back."""
    xf = x.float()
    mean = xf.mean(dim=-1, keepdim=True)
    var = (xf - mean).square().mean(dim=-1, keepdim=True)
    y = (xf - mean) * torch.rsqrt(var + eps)
    return (y * p["scale"].float() + p["bias"].float()).to(x.dtype)


def relu6(x: torch.Tensor) -> torch.Tensor:
    """min(max(x, 0), 6): MobileNet's activation, ``jnp.clip``'s gradient
    included: half the gradient at exactly 0 and at exactly 6, as
    ``maximum`` and ``minimum`` split a tie (``torch.clamp`` passes all
    of it). A BatchNorm in train mode over a channel that is constant
    across the batch gives exactly 0 there."""
    return torch.minimum(torch.maximum(x, x.new_zeros(())), x.new_full((), 6.0))


def gelu(x: torch.Tensor) -> torch.Tensor:
    """``jax.nn.gelu``'s default: the tanh approximation (PyTorch's own
    default is the exact erf form)."""
    return F.gelu(x, approximate="tanh")
