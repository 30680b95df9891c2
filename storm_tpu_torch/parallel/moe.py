"""The mixture-of-experts MLP at one expert shard, the counterpart of
``storm_tpu/parallel/moe.py:65-144`` (``moe_layer``, ``moe_block``).

Top-1 routing through a learned gate, capacity-bounded as in GShard and
Switch: each expert takes at most ``ceil(tokens / E * capacity_factor)``
tokens, counted over every token of the batch the forward is given (a
padded bucket's zero rows included, so the capacity, and which real
tokens overflow, depends on the bucket, as in storm_tpu); the padded rows
come last in the queue order, so they never displace a real token. An
overflowed token's MoE output is 0 and it passes through the residual.

The routing is the dense one-hot formulation of storm_tpu, which keeps
every shape static and never reads a value back to the host (no
``.item()``, no ``nonzero``, no boolean indexing), so a CUDA graph
captures the layer as it captures the rest of the forward. Routing,
dispatch and combine run in f32; the experts' two matmuls run in the
activation dtype, accumulated in f32. The router's argmax takes the first
expert on a tie, as ``jnp.argmax`` does.

Sharding the experts over devices (``shard_moe_params``, the ``expert``
mesh axis) and the training-time load-balancing loss are not ported: at
inference storm_tpu discards that loss.
"""

from __future__ import annotations

import math
from typing import Tuple

import torch

from storm_tpu_torch.ops import layers as L
from storm_tpu_torch.ops.attention import multi_head_attention


def _matmul(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """``a @ b`` in a.dtype, accumulated in f32 (``layers.dense``'s rule:
    one GEMM in the activation dtype on a CUDA tensor, f32 operands cast
    back on the CPU)."""
    b = b.to(a.dtype)
    if a.is_cuda:
        return torch.matmul(a, b)
    return torch.matmul(a.float(), b.float()).to(a.dtype)


def moe_routing(gate: torch.Tensor, tokens: torch.Tensor, n_experts: int,
                capacity_factor: float = 1.25) -> Tuple[torch.Tensor, ...]:
    """Top-1 routing of ``tokens`` (N, dim): ``(probs (N, E) f32, expert
    (N,) int64, keep (N, E) f32, pos (N, E) f32, cap)`` — each token's
    chosen expert, whether it fits that expert's capacity (``keep`` one-hot
    or all zero), and its place in the expert's queue."""
    n = tokens.shape[0]
    cap = max(1, math.ceil(n / n_experts * capacity_factor))
    logits = _matmul(tokens, gate).float()
    probs = torch.softmax(logits, dim=-1)
    expert = torch.argmax(probs, dim=-1)
    experts = torch.arange(n_experts, device=tokens.device)
    onehot = (expert[:, None] == experts).float()
    pos = (torch.cumsum(onehot, dim=0) - 1.0) * onehot
    keep = onehot * (pos < cap).float()
    return probs, expert, keep, pos, cap


def moe_layer(p: dict, x: torch.Tensor, capacity_factor: float = 1.25) -> torch.Tensor:
    """Top-1 MoE MLP over the tokens of ``x`` (..., dim): ``p`` holds
    ``gate`` (dim, E), ``w_in`` (E, dim, mlp), ``b_in`` (E, mlp),
    ``w_out`` (E, mlp, dim), ``b_out`` (E, dim). Returns x's shape and
    dtype; an overflowed token's row is 0."""
    shape = x.shape
    dim = shape[-1]
    tokens = x.reshape(-1, dim)
    n = tokens.shape[0]
    e = p["w_in"].shape[0]
    probs, _expert, keep, pos, cap = moe_routing(p["gate"], tokens, e, capacity_factor)
    # A token's slot in its expert's queue, one-hot over the capacity; an
    # overflowed token's slot (>= cap) matches no column.
    slot = pos.sum(dim=-1)
    pos_cap = (slot[:, None] == torch.arange(cap, device=x.device)).float()  # (N, C)
    dispatch = keep[:, :, None] * pos_cap[:, None, :]  # (N, E, C)
    gate_val = (probs * keep).sum(dim=-1)  # (N,)
    combine = dispatch * gate_val[:, None, None]  # (N, E, C)

    # "nec,nd->ecd": every expert's queue of tokens, in f32, then cast.
    xe = (dispatch.reshape(n, e * cap).t() @ tokens.float()).reshape(e, cap, dim)
    xe = xe.to(tokens.dtype)
    h = L.gelu(_matmul(xe, p["w_in"]) + p["b_in"].to(xe.dtype)[:, None, :])
    ye = _matmul(h, p["w_out"]) + p["b_out"].to(h.dtype)[:, None, :]  # (E, C, dim)
    # "nec,ecd->nd": each token's expert output, weighted by its gate.
    y = combine.reshape(n, e * cap) @ ye.float().reshape(e * cap, dim)
    return y.to(x.dtype).reshape(shape)


def moe_block(p: dict, x: torch.Tensor, num_heads: int,
              capacity_factor: float = 1.25) -> torch.Tensor:
    """A pre-LN transformer block whose MLP is the MoE layer, (B, S, D) ->
    (B, S, D): ``x + MHA(LN1(x))``, then ``+ MoE(LN2(.))``. Both norms
    are plain LayerNorms, as in storm_tpu (no fused residual norm)."""
    x = x + multi_head_attention(p["attn"], L.layernorm(p["ln1"], x), num_heads)
    return x + moe_layer(p["moe"], L.layernorm(p["ln2"], x), capacity_factor)
