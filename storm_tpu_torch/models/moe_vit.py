"""MoE-ViT, the counterpart of ``storm_tpu/models/moe_vit.py``: the ViT of
``models/vit.py`` whose odd blocks (1, 3, ...) carry a top-1
mixture-of-experts MLP in place of the dense one (the Switch
placement), served at one expert shard (``storm_tpu_torch.parallel.moe``).

At inference the router still runs, capacity-overflowed tokens pass
through the residual, and the load-balancing loss is not computed; in
train mode each MoE block keeps its loss in ``aux_loss``, which
``convert.apply`` sums into the state's ``"moe_aux_loss"``. The
even blocks are the ViT block (flash attention, the fused residual norm,
w8a16 dense layers under ``int8_fused``); a MoE block runs flash attention
and its four attention projections through w8a16, and its experts (3-D
weights, not under a ``"w"`` key) as plain batched matmuls in every mode.
"""

from __future__ import annotations

import numpy as np
import torch
from torch import nn

from storm_tpu_torch.models.common import LayerNorm, dense_init, ln_init, normal
from storm_tpu_torch.models.registry import ModelDef, register
from storm_tpu_torch.models.vit import Block, MultiHeadAttention, ViT, vit_init
from storm_tpu_torch.parallel.moe import moe_block

MOE_KEYS = ("gate", "w_in", "b_in", "w_out", "b_out")
# storm_tpu's moe_layer default: the Switch load-balancing loss's weight.
AUX_LOSS_WEIGHT = 1e-2


class MoEBlock(nn.Module):
    """``x + MHA(LN1(x))``, then ``+ MoE(LN2(.))``
    (``storm_tpu_torch.parallel.moe.moe_block``)."""

    def __init__(self, p: dict, num_heads: int, capacity_factor: float) -> None:
        super().__init__()
        self.num_heads = num_heads
        self.capacity_factor = capacity_factor
        self.ln1 = LayerNorm(p["ln1"])
        self.attn = MultiHeadAttention(p["attn"], num_heads)
        self.ln2 = LayerNorm(p["ln2"])
        for k in MOE_KEYS:
            self.register_buffer(k, p["moe"][k])
        self.aux_loss = None

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        p = {"ln1": self.ln1.params(), "ln2": self.ln2.params(),
             "attn": {n: getattr(self.attn, n).params() for n in "qkvo"},
             "moe": {k: getattr(self, k) for k in MOE_KEYS}}
        x, aux = moe_block(p, x, self.num_heads, self.capacity_factor,
                           AUX_LOSS_WEIGHT if self.training else None)
        if self.training:
            self.aux_loss = aux
        return x


def moe_init(rng: np.random.RandomState, dim: int, mlp_dim: int, n_experts: int) -> dict:
    """storm_tpu's ``moe_init`` distributions: gate and w_in normal over
    sqrt(dim), w_out over sqrt(mlp_dim), zero biases."""
    return {
        "gate": normal(rng, (dim, n_experts), 1.0 / np.sqrt(dim)),
        "w_in": normal(rng, (n_experts, dim, mlp_dim), 1.0 / np.sqrt(dim)),
        "b_in": np.zeros((n_experts, mlp_dim), np.float32),
        "w_out": normal(rng, (n_experts, mlp_dim, dim), 1.0 / np.sqrt(mlp_dim)),
        "b_out": np.zeros((n_experts, dim), np.float32),
    }


def build_moe_vit(name: str, num_classes: int, input_shape: tuple, patch: int,
                  dim: int, depth: int, num_heads: int, mlp_dim: int, n_experts: int,
                  capacity_factor: float = 1.25) -> ModelDef:
    h, w, _c = input_shape
    if h % patch or w % patch:
        raise ValueError(f"input {h}x{w} not divisible by patch size {patch}")
    hyper = {"num_heads": num_heads, "dim": dim, "depth": depth, "mlp_dim": mlp_dim,
             "patch": patch, "n_experts": n_experts, "capacity_factor": capacity_factor,
             "input_shape": tuple(input_shape), "num_classes": num_classes}

    def moe_block_init(rng: np.random.RandomState) -> dict:
        return {"ln1": ln_init(dim),
                "attn": {n: dense_init(rng, dim, dim) for n in "qkvo"},
                "ln2": ln_init(dim),
                "moe": moe_init(rng, dim, mlp_dim, n_experts)}

    def init(rng: np.random.RandomState) -> tuple:
        # Odd blocks are MoE (the Switch placement).
        return vit_init(rng, input_shape, patch, dim, depth, mlp_dim, num_classes,
                        block_init=lambda i: moe_block_init(rng) if i % 2 == 1 else None), {}

    def block(p: dict, heads: int) -> nn.Module:
        return MoEBlock(p, heads, capacity_factor) if "moe" in p else Block(p, heads)

    return ModelDef(name, tuple(input_shape), num_classes, init,
                    lambda params, _state: ViT(params, block=block, **hyper), hyper)


@register("moe_vit_tiny")
def build_moe_vit_tiny(num_classes: int = 10, input_shape: tuple = (32, 32, 3)) -> ModelDef:
    """Small MoE-ViT: 4 blocks (2 dense + 2 MoE x 4 experts); the digits
    checkpoint's model."""
    return build_moe_vit("moe_vit_tiny", num_classes, input_shape, patch=8, dim=64,
                         depth=4, num_heads=4, mlp_dim=128, n_experts=4)


@register("moe_vit_b16")
def build_moe_vit_b16(num_classes: int = 1000,
                      input_shape: tuple = (224, 224, 3)) -> ModelDef:
    """ViT-B/16 with 8-expert MoE MLPs in every other block."""
    return build_moe_vit("moe_vit_b16", num_classes, input_shape, patch=16, dim=768,
                         depth=12, num_heads=12, mlp_dim=3072, n_experts=8)
