"""Ring attention: exact attention over a sequence split across the ranks
of one mesh axis, the counterpart of
``storm_tpu/parallel/ring_attention.py:36-103``.

Each rank holds its shard of the queries, keys and values, (B, H, S / n,
D). It attends its queries to the KV shard it holds, carrying the online
softmax's running max ``m``, denominator ``l`` and unnormalized
accumulator ``acc``; the KV shards then rotate one hop around the ring
(``collectives.ring_shift``, rank i to rank i + 1), n - 1 hops, so every
query sees every key, and the carry normalizes to the exact softmax.
storm_tpu's arithmetic: scores in f32, the probabilities cast to v's
dtype before P·V, ``acc / l`` cast back at the end, and the same order of
merges. storm_tpu has no kernel here, so the block products are
``torch.matmul`` (f32 operands cast back on the CPU, whose bf16 GEMM is
not shown to accumulate in f32, as ``ops/layers.py:dense``).

Non-causal, as storm_tpu's. Differentiable: the gradient of each
rotated shard goes back around the ring to the rank that holds it
(``ring_shift``'s backward), so each rank's k and v get what every rank's
queries owe them, the gradient of the sum of the ranks' losses.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch

from storm_tpu_torch.parallel.collectives import ring_shift


def _mm(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """``a @ b`` in a.dtype, accumulated in f32."""
    if a.is_cuda:
        return torch.matmul(a, b)
    return torch.matmul(a.float(), b.float()).to(a.dtype)


def _partial_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                       scale: float) -> Tuple[torch.Tensor, ...]:
    """Blockwise attention with online-softmax statistics: q (B, H, Sq, D),
    k and v (B, H, Sk, D) -> (acc (B, H, Sq, D) f32 unnormalized, m and l
    (B, H, Sq) f32)."""
    s = _mm(q, k.transpose(-1, -2)).float() * scale
    m = s.amax(dim=-1)
    p = torch.exp(s - m[..., None])
    l = p.sum(dim=-1)
    acc = _mm(p.to(v.dtype), v).float()
    return acc, m, l


def _merge(m, l, acc, m_j, l_j, acc_j):
    m_new = torch.maximum(m, m_j)
    a = torch.exp(m - m_new)
    b = torch.exp(m_j - m_new)
    return m_new, l * a + l_j * b, acc * a[..., None] + acc_j * b[..., None]


def ring_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, mesh,
                   seq_axis: str = "seq", scale: Optional[float] = None) -> torch.Tensor:
    """softmax(q k^T * scale) v for this rank's query shard against the
    whole sequence, whose KV shards the ranks of ``seq_axis`` hold in
    order: q, k and v are this rank's (B, H, S / n, D) shards, and so is
    the result."""
    if scale is None:
        scale = q.shape[-1] ** -0.5
    n = mesh.shape[seq_axis]
    acc, m, l = _partial_attention(q, k, v, scale)
    for _ in range(n - 1):
        # Rotate the KV shards one hop around the ring.
        k = ring_shift(k, mesh, seq_axis)
        v = ring_shift(v, mesh, seq_axis)
        acc_j, m_j, l_j = _partial_attention(q, k, v, scale)
        m, l, acc = _merge(m, l, acc, m_j, l_j, acc_j)
    return (acc / l[..., None]).to(q.dtype)
