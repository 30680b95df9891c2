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
"""

from __future__ import annotations

from typing import Optional

import torch

from storm_tpu_torch.ops._build import KERNELS, check_cuda, dtype_code, route

F32_VARIANT = "flash_attention"
SM90_VARIANT = "flash_attention_sm90"
HEAD_DIMS = (16, 32, 64, 128)


def kernel_variant(dtype: torch.dtype, d: int) -> str:
    """The CUDA kernel for (dtype, head dim d): bfloat16 -> the tensor-core
    kernel, float32 -> the f32 kernel; a head dim outside HEAD_DIMS or
    another dtype raises."""
    if d not in HEAD_DIMS:
        raise ValueError(f"flash_attention kernels take D in {HEAD_DIMS}, got {d}")
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
    """softmax(q k^T * scale) v for (B, H, S, D) inputs of one dtype.
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
    if not route("flash_attention", q, k, v):
        return flash_attention_reference(q, k, v, scale)
    dev = check_cuda("flash_attention", q, k, v)
    name = variant or kernel_variant(q.dtype, d)
    if name not in (SM90_VARIANT, F32_VARIANT):
        raise ValueError(f"unknown flash_attention variant {name!r}")
    if name == SM90_VARIANT:
        if q.dtype != torch.bfloat16:
            raise TypeError(f"{SM90_VARIANT} takes bfloat16, got {q.dtype}")
        if any(t.data_ptr() % 16 for t in (q, k, v)):
            raise ValueError(f"{SM90_VARIANT} needs 16-byte aligned q, k, v")
    out = torch.empty_like(q)
    if b * h * s and name == SM90_VARIANT:
        KERNELS[name].launch(dev, q, k, v, out, b * h, s, d, float(scale))
    elif b * h * s:
        KERNELS[name].launch(dev, dtype_code(q), q, k, v, out, b * h, s, d, float(scale))
    return out
