"""ViT-B/16 and its toy sibling vit_tiny, the counterpart of
``storm_tpu/models/vit.py``.

NHWC input; 16x16 patch embedding as a strided VALID convolution, tokens in
(h, w) row-major order; CLS token prepended and position embedding added in
the compute dtype; pre-LN blocks whose second LayerNorm is fused with the
residual add; classification from token 0 after the final LayerNorm.
Dense layers whose weights are int8 run the w8a16 kernel, attention runs
the flash kernel and the fused norm its kernel (on CUDA tensors).

Under Megatron tensor parallelism (``parallel/sharding.py``) a rank's
block holds the column-parallel q, k, v and mlp_in shards and the
row-parallel o and mlp_out ones: its attention runs H / tp heads through
the flash kernel, and the row-parallel outputs are summed over the model
axis before the residual (``ops/layers.py:dense``), the bias added once
after the sum. For training, Megatron's *f* (``collectives.copy_to_axis``)
enters each column-parallel region once: on LN1's output, which feeds q, k
and v, and on ``n2``, which feeds mlp_in; the row-parallel sums are *g*.
"""

from __future__ import annotations

import numpy as np
import torch
from torch import nn

from storm_tpu_torch.models.common import (
    Dense, LayerNorm, dense_init, ln_init, normal, trunc_normal)
from storm_tpu_torch.models.registry import ModelDef, register
from storm_tpu_torch.ops import layers as L
from storm_tpu_torch.ops.attention import multi_head_attention
from storm_tpu_torch.ops.fused_norm import residual_layernorm


class MultiHeadAttention(nn.Module):
    """``copy``: None, or under tensor parallelism Megatron's *f* over the
    model axis (``parallel/sharding.py:attach_tp``), applied once to the
    input that feeds q, k and v."""

    def __init__(self, p: dict, num_heads: int) -> None:
        super().__init__()
        self.num_heads = num_heads
        self.q, self.k, self.v, self.o = (Dense(p[n]) for n in "qkvo")
        self.copy = None

    def params(self) -> dict:
        p = {n: getattr(self, n).params() for n in "qkvo"}
        if self.copy is not None:
            p["copy"] = self.copy
        return p

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return multi_head_attention(self.params(), x, self.num_heads)


class Block(nn.Module):
    """Pre-LN encoder block: ``attn = MHA(LN1(x))``; ``y, n2 =
    residual_layernorm(ln2, attn, x)``; ``y + mlp_out(gelu(mlp_in(n2)))``.
    ``copy``: None, or under tensor parallelism the *f* applied to ``n2``,
    the input of the column-parallel mlp_in (the attention's own is
    ``attn.copy``)."""

    def __init__(self, p: dict, num_heads: int) -> None:
        super().__init__()
        self.ln1 = LayerNorm(p["ln1"])
        self.attn = MultiHeadAttention(p["attn"], num_heads)
        self.ln2 = LayerNorm(p["ln2"])
        self.mlp_in = Dense(p["mlp_in"])
        self.mlp_out = Dense(p["mlp_out"])
        self.copy = None

    def params(self) -> dict:
        """The block's parameter dict (storm_tpu's block layout)."""
        return {"ln1": self.ln1.params(), "ln2": self.ln2.params(),
                "attn": {n: getattr(self.attn, n).params() for n in "qkvo"},
                "mlp_in": self.mlp_in.params(), "mlp_out": self.mlp_out.params()}

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        # Under tensor parallelism attn and the MLP's output are reduced
        # over the model axis inside their row-parallel dense layers, so
        # the fused norm runs at full width on every rank.
        attn = self.attn(self.ln1(x))
        y, n2 = residual_layernorm(self.ln2.params(), attn, x)
        if self.copy is not None:
            n2 = self.copy(n2)
        return y + self.mlp_out(L.gelu(self.mlp_in(n2)))


class ViT(nn.Module):
    """``block(params, num_heads)`` builds each encoder block (the MoE-ViT
    passes its own, which builds MoE blocks where the parameters hold
    one)."""

    def __init__(self, p: dict, *, patch: int, dim: int, num_heads: int,
                 input_shape: tuple, block=Block, **_hyper) -> None:
        super().__init__()
        h, w, _c = input_shape
        self.patch = patch
        self.dim = dim
        self.n_patches = (h // patch) * (w // patch)
        # HWIO (the JAX layout) -> OIHW for F.conv2d.
        self.register_buffer("embed_w", p["embed"]["w"].permute(3, 2, 0, 1).contiguous())
        self.register_buffer("embed_b", p["embed"]["b"])
        self.register_buffer("cls", p["cls"])
        self.register_buffer("pos", p["pos"])
        self.blocks = nn.ModuleList(block(bp, num_heads) for bp in p["blocks"])
        self.ln = LayerNorm(p["ln"])
        self.head = Dense(p["head"])

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        """(B, H, W, C) in the compute dtype -> (B, num_classes) logits."""
        b = x.shape[0]
        tok = L.conv2d({"w": self.embed_w, "b": self.embed_b}, x,
                       stride=self.patch, padding="valid")
        tok = tok.reshape(b, self.n_patches, self.dim)
        cls = self.cls.to(tok.dtype).expand(b, 1, self.dim)
        tok = torch.cat([cls, tok], dim=1) + self.pos.to(tok.dtype)
        for blk in self.blocks:
            tok = blk(tok)
        tok = self.ln(tok)
        return self.head(tok[:, 0].contiguous())


def vit_init(rng: np.random.RandomState, input_shape: tuple, patch: int, dim: int,
             depth: int, mlp_dim: int, num_classes: int, block_init=None) -> dict:
    """Seeded parameters of a ViT in the JAX layout. ``block_init(i)``
    may return block i's parameters (the MoE-ViT's MoE blocks); None
    makes the dense block."""
    h, w, c = input_shape
    seq = (h // patch) * (w // patch) + 1  # + CLS
    fan_in = patch * patch * c
    params = {
        "embed": {"w": normal(rng, (patch, patch, c, dim), np.sqrt(2.0 / fan_in)),
                  "b": np.zeros((dim,), np.float32)},
        "cls": np.zeros((1, 1, dim), np.float32),
        "pos": trunc_normal(rng, (1, seq, dim)),
        "blocks": [],
    }
    for i in range(depth):
        bp = block_init(i) if block_init is not None else None
        params["blocks"].append(bp if bp is not None else {
            "ln1": ln_init(dim),
            "attn": {n: dense_init(rng, dim, dim) for n in "qkvo"},
            "ln2": ln_init(dim),
            "mlp_in": dense_init(rng, dim, mlp_dim),
            "mlp_out": dense_init(rng, mlp_dim, dim)})
    params["ln"] = ln_init(dim)
    params["head"] = dense_init(rng, dim, num_classes)
    return params


def build_vit(name: str, num_classes: int, input_shape: tuple, patch: int,
              dim: int, depth: int, num_heads: int, mlp_dim: int) -> ModelDef:
    h, w, _c = input_shape
    if h % patch or w % patch:
        raise ValueError(f"input {h}x{w} not divisible by patch size {patch}")
    hyper = {"num_heads": num_heads, "dim": dim, "depth": depth,
             "mlp_dim": mlp_dim, "patch": patch,
             "input_shape": tuple(input_shape), "num_classes": num_classes}

    def init(rng: np.random.RandomState) -> tuple:
        return vit_init(rng, input_shape, patch, dim, depth, mlp_dim, num_classes), {}

    return ModelDef(name, tuple(input_shape), num_classes, init,
                    lambda params, _state: ViT(params, **hyper), hyper)


@register("vit_b16")
def build_vit_b16(num_classes: int = 1000, input_shape: tuple = (224, 224, 3)) -> ModelDef:
    return build_vit("vit_b16", num_classes, input_shape, patch=16, dim=768,
                     depth=12, num_heads=12, mlp_dim=3072)


@register("vit_tiny")
def build_vit_tiny(num_classes: int = 10, input_shape: tuple = (32, 32, 3)) -> ModelDef:
    """Small ViT (same code path as vit_b16, toy size): the digits
    checkpoint's model and the tests'."""
    return build_vit("vit_tiny", num_classes, input_shape, patch=8, dim=64,
                     depth=2, num_heads=4, mlp_dim=128)
