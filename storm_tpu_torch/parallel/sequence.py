"""Sequence parallelism: encoder blocks over a sequence split across the
ranks of one mesh axis, the counterpart of
``storm_tpu/parallel/sequence.py``.

LayerNorm, the q/k/v and output projections and the MLP act on each token
alone, so they run on this rank's shard of the sequence with no
communication (each dense layer at S / n rows: under ``int8_fused`` the
w8a16 kernel); the one cross-token op, attention, runs on the ring
(:func:`~storm_tpu_torch.parallel.ring_attention.ring_attention`). The
full (S, D) activation is never gathered on one rank. The block follows
storm_tpu's ``seq_parallel_block`` exactly: plain LayerNorms (no fused
residual norm) and the ring (no flash kernel), as storm_tpu's
``apply_sp`` calls neither.

Differentiable through the ring: each rank's loss on its shard of the
output is a part of the whole sequence's, and the gradient of the sum of
the parts reaches each rank's shard of the input; the blocks' parameters,
which every rank holds whole, get the whole gradient as the sum of the
ranks' (``collectives.all_reduce_grads(..., mean=False)`` over the axis).
"""

from __future__ import annotations

import torch

from storm_tpu_torch.ops import layers as L
from storm_tpu_torch.parallel.ring_attention import ring_attention
from storm_tpu_torch.parallel.sharding import shard_array


def seq_sharding(mesh, seq_axis: str = "seq") -> tuple:
    """(B, S, D) activations with S split over ``seq_axis``."""
    return (None, seq_axis, None)


def shard_sequence(mesh, x, seq_axis: str = "seq"):
    """This rank's shard of the sequence (axis 1) of ``x``; raises when
    the sequence does not divide over the axis."""
    return shard_array(mesh, x, seq_sharding(mesh, seq_axis))


def seq_parallel_mha(p: dict, x: torch.Tensor, num_heads: int, mesh,
                     seq_axis: str = "seq") -> torch.Tensor:
    """Self-attention over this rank's (B, S / n, C) shard: local
    projections, mixing on the ring."""
    b, s, c = x.shape
    d = c // num_heads

    def split(y: torch.Tensor) -> torch.Tensor:
        return y.reshape(b, s, num_heads, d).transpose(1, 2).contiguous()

    q = split(L.dense(p["q"], x))
    k = split(L.dense(p["k"], x))
    v = split(L.dense(p["v"], x))
    out = ring_attention(q, k, v, mesh, seq_axis=seq_axis)
    out = out.transpose(1, 2).reshape(b, s, c)
    return L.dense(p["o"], out)


def seq_parallel_block(p: dict, x: torch.Tensor, num_heads: int, mesh,
                       seq_axis: str = "seq") -> torch.Tensor:
    """The pre-LN encoder block (the ViT block's parameters) with
    sequence-parallel attention."""
    x = x + seq_parallel_mha(p["attn"], L.layernorm(p["ln1"], x), num_heads, mesh,
                             seq_axis)
    h = L.gelu(L.dense(p["mlp_in"], L.layernorm(p["ln2"], x)))
    return x + L.dense(p["mlp_out"], h)


def seq_parallel_encoder(blocks: list, x: torch.Tensor, num_heads: int, mesh,
                         seq_axis: str = "seq") -> torch.Tensor:
    """A stack of blocks over this rank's shard ``x`` of the sequence
    (:func:`shard_sequence` of the whole); returns this rank's shard."""
    for p in blocks:
        x = seq_parallel_block(p, x, num_heads, mesh, seq_axis)
    return x
