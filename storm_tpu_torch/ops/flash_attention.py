"""Flash attention (non-causal) over (B, H, S, D) inputs.

The counterpart of ``storm_tpu/ops/flash_attention.py``. On a CUDA tensor
it runs the hand-written kernel ``csrc/flash_attention.cu`` for every
sequence length (the TPU's S >= 1024 dispatch threshold was measured on a
TPU and does not carry over); on a CPU tensor it runs
:func:`flash_attention_reference`, the kernel's arithmetic in plain
PyTorch: f32 scores, f32 softmax, probabilities cast to v's dtype before
the product with v.
"""

from __future__ import annotations

from typing import Optional

import torch

from storm_tpu_torch.ops._build import KERNELS, check_cuda, dtype_code, route

_KERNEL = KERNELS["flash_attention"]
HEAD_DIMS = (16, 32, 64, 128)


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
                    scale: Optional[float] = None) -> torch.Tensor:
    """softmax(q k^T * scale) v for (B, H, S, D) inputs of one dtype."""
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
    if d not in HEAD_DIMS:
        raise ValueError(f"flash_attention kernel takes D in {HEAD_DIMS}, got {d}")
    dev = check_cuda("flash_attention", q, k, v)
    code = dtype_code(q)
    out = torch.empty_like(q)
    if b * h * s:
        _KERNEL.launch(dev, code, q, k, v, out, b * h, s, d, float(scale))
    return out
