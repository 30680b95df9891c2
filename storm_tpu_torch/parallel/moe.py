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

``moe_layer`` also returns the Switch load-balancing loss, as storm_tpu's
does; a serving forward passes ``aux_loss_weight=None`` and skips it
(storm_tpu's compiled forward drops the unused value too), so a CUDA graph
holds the layer's kernels alone.

Expert parallelism (``storm_tpu/parallel/moe.py:46-63``, serving): the
expert tensors are split on their leading axis over the ``expert`` mesh
axis (:func:`moe_param_specs`, :func:`shard_moe_params`), each rank
holding a contiguous block of E / ep experts, the gate whole. Given an
:class:`ExpertShard`, the layer routes as the one-shard layer does, over
every token of the batch: the gate on this rank's tokens, the capacity
from the whole batch's token count, and each token's place in its
expert's queue counted in the batch's order, which on a (data, expert)
mesh adds the tokens the data ranks before this one sent to each expert
(one all-gather of E counts over the data axis; storm_tpu's GSPMD program
sees the whole batch). Its local experts then run their queues, and the
partial combine (each token's row is its own expert's output times its
gate, or 0) is summed over the expert axis with one all-reduce: exactly
the one-shard combine, each row a single nonzero term.
"""

from __future__ import annotations

import math
from typing import Optional, Tuple

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


MOE_KEYS = ("gate", "w_in", "b_in", "w_out", "b_out")


def moe_param_specs(expert_axis: str = "expert") -> dict:
    """Specs matching ``moe_init`` (``parallel/sharding.py``'s tuples):
    the experts split on their leading axis, the gate whole."""
    return {"gate": (), "w_in": (expert_axis,), "b_in": (expert_axis,),
            "w_out": (expert_axis,), "b_out": (expert_axis,)}


def shard_moe_params(mesh, params: dict, expert_axis: str = "expert") -> dict:
    """This rank's shard of one MoE layer's parameters."""
    from storm_tpu_torch.parallel.sharding import shard_array

    specs = moe_param_specs(expert_axis)
    return {k: shard_array(mesh, v, specs[k]) for k, v in params.items()}


class ExpertShard:
    """Where a rank's experts sit on a (data, expert) mesh: the expert
    axis's ranks hold the experts in contiguous blocks, the data axis's
    split the batch's rows. :meth:`prior_counts` and :meth:`combine` are
    the layer's two collectives."""

    def __init__(self, mesh, expert_axis: str = "expert", data_axis: str = "data") -> None:
        self.mesh = mesh
        self.expert_axis = expert_axis
        self.data_axis = data_axis
        self.dp = mesh.shape[data_axis]

    def first_expert(self, local_experts: int) -> int:
        return self.mesh.coord(self.expert_axis) * local_experts

    def prior_counts(self, counts: torch.Tensor) -> torch.Tensor:
        """(E,) tokens the data ranks before this one routed to each
        expert (0 with one data rank)."""
        from storm_tpu_torch.parallel.collectives import all_gather

        if self.dp == 1:
            return torch.zeros_like(counts)
        every = all_gather(counts[None], self.mesh, self.data_axis)  # (dp, E)
        return every[:self.mesh.coord(self.data_axis)].sum(dim=0)

    def enter(self, t: torch.Tensor) -> torch.Tensor:
        """``t`` (the same on every expert rank) as this rank's experts
        take it: Megatron's *f* over the expert axis, so a backward sums
        what each rank's experts owe it."""
        from storm_tpu_torch.parallel.collectives import copy_to_axis

        return copy_to_axis(t, self.mesh, self.expert_axis)

    def combine(self, y: torch.Tensor) -> torch.Tensor:
        """The partial combines summed over the expert axis (*g*: the
        gradient passes through)."""
        from storm_tpu_torch.parallel.collectives import reduce_from_axis

        return reduce_from_axis(y, self.mesh, self.expert_axis)

    def batch_sum(self, t: torch.Tensor) -> torch.Tensor:
        """``t`` summed over the data axis, its gradient summed too (the
        load-balancing loss's statistics are the whole batch's)."""
        from storm_tpu_torch.parallel.collectives import sum_over_axis

        return sum_over_axis(t, self.mesh, self.data_axis)


def moe_routing(gate: torch.Tensor, tokens: torch.Tensor, n_experts: int,
                capacity_factor: float = 1.25, shard: Optional[ExpertShard] = None
                ) -> Tuple[torch.Tensor, ...]:
    """Top-1 routing of ``tokens`` (N, dim): ``(probs (N, E) f32, expert
    (N,) int64, keep (N, E) f32, pos (N, E) f32, cap)`` — each token's
    chosen expert, whether it fits that expert's capacity (``keep`` one-hot
    or all zero), and its place in the expert's queue. With ``shard`` the
    tokens are this data rank's, the capacity the whole batch's and the
    places counted after the earlier data ranks' tokens."""
    n = tokens.shape[0]
    dp = shard.dp if shard is not None else 1
    cap = max(1, math.ceil(n * dp / n_experts * capacity_factor))
    logits = _matmul(tokens, gate).float()
    probs = torch.softmax(logits, dim=-1)
    expert = torch.argmax(probs, dim=-1)
    experts = torch.arange(n_experts, device=tokens.device)
    onehot = (expert[:, None] == experts).float()
    queue = torch.cumsum(onehot, dim=0)
    if shard is not None:
        queue = queue + shard.prior_counts(onehot.sum(dim=0))
    pos = (queue - 1.0) * onehot
    keep = onehot * (pos < cap).float()
    return probs, expert, keep, pos, cap


def moe_layer(p: dict, x: torch.Tensor, capacity_factor: float = 1.25,
              aux_loss_weight: Optional[float] = 1e-2, shard: Optional[ExpertShard] = None
              ) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
    """Top-1 MoE MLP over the tokens of ``x`` (..., dim): ``p`` holds
    ``gate`` (dim, E), ``w_in`` (E, dim, mlp), ``b_in`` (E, mlp),
    ``w_out`` (E, mlp, dim), ``b_out`` (E, dim). Returns ``(y, aux)``: y
    of x's shape and dtype, an overflowed token's row 0; ``aux`` the
    Switch load-balancing loss (E times the sum over experts of the
    fraction of tokens routed there times the mean gate probability),
    times ``aux_loss_weight``, in f32; None when the weight is None.

    With ``shard`` (expert parallelism) ``p`` holds this rank's block of
    experts and ``x`` this data rank's tokens; the result is the one-shard
    layer's on those tokens, and ``aux`` the whole batch's loss (its
    token fractions and mean probabilities summed over the data axis).
    Differentiable: the tokens and gate values enter the rank's experts
    through *f* and leave through *g* (:class:`ExpertShard`), so every
    expert rank's gradient of the tokens, the gate and what came before
    is the whole one."""
    shape = x.shape
    dim = shape[-1]
    tokens = x.reshape(-1, dim)
    n = tokens.shape[0]
    e = p["gate"].shape[-1]
    probs, expert, keep, pos, cap = moe_routing(p["gate"], tokens, e, capacity_factor,
                                                shard)
    # This rank's experts (all of them at one shard).
    el = p["w_in"].shape[0]
    lo = shard.first_expert(el) if shard is not None else 0
    keep_l = keep[:, lo:lo + el]
    # A token's slot in its expert's queue, one-hot over the capacity; an
    # overflowed token's slot (>= cap) matches no column.
    slot = pos.sum(dim=-1)
    pos_cap = (slot[:, None] == torch.arange(cap, device=x.device)).float()  # (N, C)
    dispatch = keep_l[:, :, None] * pos_cap[:, None, :]  # (N, E, C)
    gate_val = (probs * keep).sum(dim=-1)  # (N,)
    expert_in = tokens
    if shard is not None:
        gate_val, expert_in = shard.enter(gate_val), shard.enter(tokens)
    combine = dispatch * gate_val[:, None, None]  # (N, E, C)

    # "nec,nd->ecd": every expert's queue of tokens, in f32, then cast.
    xe = (dispatch.reshape(n, el * cap).t() @ expert_in.float()).reshape(el, cap, dim)
    xe = xe.to(tokens.dtype)
    h = L.gelu(_matmul(xe, p["w_in"]) + p["b_in"].to(xe.dtype)[:, None, :])
    ye = _matmul(h, p["w_out"]) + p["b_out"].to(h.dtype)[:, None, :]  # (E, C, dim)
    # "nec,ecd->nd": each token's expert output, weighted by its gate.
    y = combine.reshape(n, el * cap) @ ye.float().reshape(el * cap, dim)
    if shard is not None:
        y = shard.combine(y)
    aux = None
    if aux_loss_weight is not None:
        onehot = (expert[:, None] == torch.arange(e, device=x.device)).float()
        if shard is None:
            frac, mean_prob = onehot.mean(dim=0), probs.mean(dim=0)
        else:
            total = shard.batch_sum(torch.cat([onehot.sum(dim=0), probs.sum(dim=0)]))
            frac, mean_prob = total[:e] / (n * shard.dp), total[e:] / (n * shard.dp)
        aux = aux_loss_weight * e * (frac * mean_prob).sum()
    return y.to(x.dtype).reshape(shape), aux


def moe_block(p: dict, x: torch.Tensor, num_heads: int, capacity_factor: float = 1.25,
              aux_loss_weight: Optional[float] = 1e-2, shard: Optional[ExpertShard] = None
              ) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
    """A pre-LN transformer block whose MLP is the MoE layer, (B, S, D) ->
    ((B, S, D), aux): ``x + MHA(LN1(x))``, then ``+ MoE(LN2(.))``. Both
    norms are plain LayerNorms, as in storm_tpu (no fused residual norm)."""
    x = x + multi_head_attention(p["attn"], L.layernorm(p["ln1"], x), num_heads)
    h, aux = moe_layer(p["moe"], L.layernorm(p["ln2"], x), capacity_factor, aux_loss_weight,
                       shard)
    return x + h, aux
