"""Multi-head attention over the flash-attention kernel.

The counterpart of ``storm_tpu/ops/attention.py``. ``scaled_dot_attention``
runs :func:`storm_tpu_torch.ops.flash_attention.flash_attention` for every
sequence length: on a CUDA tensor that is the hand-written kernel, on a CPU
tensor its plain version. :func:`attention_reference` is the plain
textbook form, kept for comparisons.
"""

from __future__ import annotations

from typing import Optional

import torch

from storm_tpu_torch.ops.flash_attention import flash_attention
from storm_tpu_torch.ops.layers import dense


def attention_reference(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                        scale: Optional[float] = None) -> torch.Tensor:
    """Plain softmax(q k^T / sqrt(d)) v over (B, H, S, D), f32 softmax."""
    if scale is None:
        scale = q.shape[-1] ** -0.5
    scores = torch.matmul(q, k.transpose(-1, -2)).float() * scale
    probs = torch.softmax(scores, dim=-1)
    return torch.matmul(probs.to(v.dtype), v)


def scaled_dot_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                         scale: Optional[float] = None) -> torch.Tensor:
    return flash_attention(q, k, v, scale=scale)


def multi_head_attention(p: dict, x: torch.Tensor, num_heads: int) -> torch.Tensor:
    """Self-attention over (B, S, C) activations; ``p`` holds the q, k, v
    and o dense layers. Heads split as ``reshape(b, s, h, d)`` then
    ``(0, 2, 1, 3)``, made contiguous for the kernel, and merge back."""
    b, s, c = x.shape
    d = c // num_heads

    def split(y: torch.Tensor) -> torch.Tensor:
        return y.reshape(b, s, num_heads, d).transpose(1, 2).contiguous()

    q = split(dense(p["q"], x))
    k = split(dense(p["k"], x))
    v = split(dense(p["v"], x))
    out = scaled_dot_attention(q, k, v)
    out = out.transpose(1, 2).reshape(b, s, c)
    return dense(p["o"], out)
