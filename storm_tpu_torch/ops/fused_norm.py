"""Fused residual add + LayerNorm: ``y = x + branch; out = LN(y)``.

The counterpart of ``storm_tpu/ops/fused_norm.py``. On a CUDA tensor it
runs the hand-written kernel ``csrc/fused_norm.cu`` (always: the TPU's
opt-in switch has no counterpart here); on a CPU tensor it runs
:func:`fused_add_layernorm_reference`, the kernel's arithmetic in plain
PyTorch. Inference only: the TPU path's custom VJP for training is not
ported.
"""

from __future__ import annotations

from typing import Tuple

import torch

from storm_tpu_torch.ops._build import KERNELS, check_cuda, dtype_code, route

_KERNEL = KERNELS["residual_layernorm"]
# Widest row the kernel keeps in shared memory (48 KB of f32).
MAX_DIM = 12288


def fused_add_layernorm_reference(x2: torch.Tensor, r2: torch.Tensor,
                                  g: torch.Tensor, b: torch.Tensor,
                                  eps: float) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain version over (rows, d): the sum and its statistics in f32
    (two-pass mean and variance), both outputs cast to the input dtype."""
    y = x2.float() + r2.float()
    mean = y.mean(dim=-1, keepdim=True)
    var = (y - mean).square().mean(dim=-1, keepdim=True)
    normed = (y - mean) * torch.rsqrt(var + eps) * g.float() + b.float()
    return y.to(x2.dtype), normed.to(x2.dtype)


def fused_add_layernorm(x2: torch.Tensor, r2: torch.Tensor, g: torch.Tensor,
                        b: torch.Tensor, eps: float = 1e-6
                        ) -> Tuple[torch.Tensor, torch.Tensor]:
    """``(x2 + r2, LN_{g,b}(x2 + r2))`` over (rows, d) inputs of one dtype;
    g and b are read as f32."""
    if x2.dim() != 2 or x2.shape != r2.shape or x2.dtype != r2.dtype:
        raise ValueError(f"x and r must be 2-D of one shape and dtype, got "
                         f"{tuple(x2.shape)} {x2.dtype} and "
                         f"{tuple(r2.shape)} {r2.dtype}")
    rows, d = x2.shape
    if g.shape != (d,) or b.shape != (d,):
        raise ValueError(f"scale and bias must be ({d},)")
    if not route("residual_layernorm", x2, r2, g, b):
        return fused_add_layernorm_reference(x2, r2, g, b, eps)
    if d > MAX_DIM:
        raise ValueError(f"residual_layernorm kernel takes d <= {MAX_DIM}, got {d}")
    g32 = g.float().contiguous()
    b32 = b.float().contiguous()
    dev = check_cuda("residual_layernorm", x2, r2, g32, b32)
    code = dtype_code(x2)
    y = torch.empty_like(x2)
    out = torch.empty_like(x2)
    if rows:
        _KERNEL.launch(dev, code, x2, r2, g32, b32, y, out, rows, d, float(eps))
    return y, out


def residual_layernorm(p: dict, branch: torch.Tensor, x: torch.Tensor,
                       eps: float = 1e-6) -> Tuple[torch.Tensor, torch.Tensor]:
    """``y = x + branch; out = LayerNorm_p(y)``; returns ``(y, out)`` so
    the caller keeps the residual stream. ``p`` is ``{"scale", "bias"}``.
    As in the TPU kernel, the kernel's ``x`` is the branch and its ``r``
    the residual stream."""
    d = x.shape[-1]
    y, out = fused_add_layernorm(branch.reshape(-1, d), x.reshape(-1, d),
                                 p["scale"], p["bias"], eps)
    return y.reshape(x.shape), out.reshape(x.shape)
