"""Flash attention (non-causal) over (B, H, S, D) inputs.

The counterpart of ``storm_tpu/ops/flash_attention.py``. On a CUDA tensor
it runs one of two hand-written kernels, chosen by :func:`kernel_variant`,
for every sequence length (the TPU's S >= 1024 dispatch threshold was
measured on a TPU and does not carry over): bfloat16 goes to the
tensor-core kernel ``csrc/flash_attention_sm90.cu``, float32 to the
CUDA-core kernel ``csrc/flash_attention.cu``. On a CPU tensor it runs
:func:`flash_attention_reference`, the kernels' arithmetic in plain
PyTorch: f32 scores, f32 softmax, probabilities cast to v's dtype before
the product with v.

The kernels are built for the head dims of ``HEAD_DIMS``; any other
``D <= 128`` is taken as the TPU kernel takes it (it pads D to its
128-lane tile, ``storm_tpu/ops/flash_attention.py:113-135``):
:func:`pad_head_dim` zero-pads q, k and v along D to the next entry of
``HEAD_DIMS``, the scale stays that of the true D, and the output is
sliced back to D. Zero columns change neither q k^T nor the kept columns
of p v. The padding runs on both devices, so the CPU path is the card's
arithmetic. ``D > 128`` raises.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch
import torch.nn.functional as F

from storm_tpu_torch.ops._build import KERNELS, check_cuda, dtype_code, route

F32_VARIANT = "flash_attention"
SM90_VARIANT = "flash_attention_sm90"
HEAD_DIMS = (16, 32, 64, 128)


def padded_head_dim(d: int) -> int:
    """The kernels' head dim that serves a head dim of ``d``: the smallest
    entry of HEAD_DIMS at least ``d``; above the largest it raises."""
    for h in HEAD_DIMS:
        if d <= h:
            return h
    raise ValueError(f"flash_attention kernels take head dims up to {HEAD_DIMS[-1]}, "
                     f"got D = {d}")


def pad_head_dim(q: torch.Tensor, k: torch.Tensor,
                 v: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """q, k and v zero-padded along D (the last axis) to
    :func:`padded_head_dim`; returned as they are where D is a kernel's."""
    d = q.shape[-1]
    extra = padded_head_dim(d) - d
    if not extra:
        return q, k, v
    return tuple(F.pad(t, (0, extra)) for t in (q, k, v))


def kernel_variant(dtype: torch.dtype, d: int) -> str:
    """The CUDA kernel for (dtype, head dim d): bfloat16 -> the tensor-core
    kernel, float32 -> the f32 kernel; a head dim above 128 or another
    dtype raises."""
    padded_head_dim(d)
    if dtype == torch.bfloat16:
        return SM90_VARIANT
    if dtype == torch.float32:
        return F32_VARIANT
    raise TypeError(f"flash_attention kernels take float32 or bfloat16, got {dtype}")


def flash_attention_reference(q: torch.Tensor, k: torch.Tensor,
                              v: torch.Tensor,
                              scale: Optional[float] = None) -> torch.Tensor:
    """Plain softmax(q k^T * scale) v with f32 scores and accumulation,
    normalized after the product as the kernel does."""
    if scale is None:
        scale = q.shape[-1] ** -0.5
    scores = torch.matmul(q.float(), k.float().transpose(-1, -2)) * scale
    p = torch.exp(scores - scores.amax(dim=-1, keepdim=True))
    l = p.sum(dim=-1, keepdim=True)
    acc = torch.matmul(p.to(v.dtype).float(), v.float())
    return (acc / l).to(q.dtype)


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                    scale: Optional[float] = None,
                    variant: Optional[str] = None) -> torch.Tensor:
    """softmax(q k^T * scale) v for (B, H, S, D) inputs of one dtype, any
    D up to 128 (``scale`` defaults to D ** -0.5 of the true D).
    ``variant`` names the CUDA kernel to launch instead of the one
    :func:`kernel_variant` picks (for timing one against the other)."""
    if q.dim() != 4 or q.shape != k.shape or q.shape != v.shape:
        raise ValueError(f"q, k, v must share one (B, H, S, D) shape, got "
                         f"{tuple(q.shape)} {tuple(k.shape)} {tuple(v.shape)}")
    if not q.dtype == k.dtype == v.dtype:
        raise ValueError("q, k, v must share one dtype")
    b, h, s, d = q.shape
    if scale is None:
        scale = d ** -0.5
    cuda = route("flash_attention", q, k, v)
    name = (variant or kernel_variant(q.dtype, d)) if cuda else None
    qp, kp, vp = pad_head_dim(q, k, v)
    if not cuda:
        return _unpad(flash_attention_reference(qp, kp, vp, scale), d)
    dev = check_cuda("flash_attention", qp, kp, vp)
    if name not in (SM90_VARIANT, F32_VARIANT):
        raise ValueError(f"unknown flash_attention variant {name!r}")
    if name == SM90_VARIANT:
        if q.dtype != torch.bfloat16:
            raise TypeError(f"{SM90_VARIANT} takes bfloat16, got {q.dtype}")
        if any(t.data_ptr() % 16 for t in (qp, kp, vp)):
            raise ValueError(f"{SM90_VARIANT} needs 16-byte aligned q, k, v")
    dp = qp.shape[-1]
    out = torch.empty_like(qp)
    if b * h * s and name == SM90_VARIANT:
        KERNELS[name].launch(dev, qp, kp, vp, out, b * h, s, dp, float(scale))
    elif b * h * s:
        KERNELS[name].launch(dev, dtype_code(qp), qp, kp, vp, out, b * h, s, dp,
                             float(scale))
    return _unpad(out, d)


def _unpad(out: torch.Tensor, d: int) -> torch.Tensor:
    """The output's first ``d`` columns (a view where D was padded)."""
    return out if out.shape[-1] == d else out[..., :d]
