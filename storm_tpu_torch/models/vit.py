"""ViT-B/16 and its toy sibling vit_tiny, the counterpart of
``storm_tpu/models/vit.py``.

NHWC input; 16x16 patch embedding as a strided VALID convolution, tokens in
(h, w) row-major order; CLS token prepended and position embedding added in
the compute dtype; pre-LN blocks whose second LayerNorm is fused with the
residual add; classification from token 0 after the final LayerNorm.
Dense layers whose weights are int8 run the w8a16 kernel, attention runs
the flash kernel and the fused norm its kernel (on CUDA tensors).
"""

from __future__ import annotations

import numpy as np
import torch
from torch import nn

from storm_tpu_torch.models.registry import ModelDef, register
from storm_tpu_torch.ops import layers as L
from storm_tpu_torch.ops.attention import multi_head_attention
from storm_tpu_torch.ops.fused_norm import residual_layernorm


class Dense(nn.Module):
    """``{"w": (in, out) float | {"__q": int8, "__s": f32}, "b"}``."""

    def __init__(self, p: dict) -> None:
        super().__init__()
        w = p["w"]
        self.quantized = isinstance(w, dict)
        if self.quantized:
            self.register_buffer("q", w["__q"])
            self.register_buffer("s", w["__s"])
        else:
            self.register_buffer("w", w)
        self.register_buffer("b", p["b"])

    def params(self) -> dict:
        w = {"__q": self.q, "__s": self.s} if self.quantized else self.w
        return {"w": w, "b": self.b}

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return L.dense(self.params(), x)


class LayerNorm(nn.Module):
    def __init__(self, p: dict) -> None:
        super().__init__()
        self.register_buffer("scale", p["scale"])
        self.register_buffer("bias", p["bias"])

    def params(self) -> dict:
        return {"scale": self.scale, "bias": self.bias}

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return L.layernorm(self.params(), x)


class MultiHeadAttention(nn.Module):
    def __init__(self, p: dict, num_heads: int) -> None:
        super().__init__()
        self.num_heads = num_heads
        self.q, self.k, self.v, self.o = (Dense(p[n]) for n in "qkvo")

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        p = {n: getattr(self, n).params() for n in "qkvo"}
        return multi_head_attention(p, x, self.num_heads)


class Block(nn.Module):
    """Pre-LN encoder block: ``attn = MHA(LN1(x))``; ``y, n2 =
    residual_layernorm(ln2, attn, x)``; ``y + mlp_out(gelu(mlp_in(n2)))``."""

    def __init__(self, p: dict, num_heads: int) -> None:
        super().__init__()
        self.ln1 = LayerNorm(p["ln1"])
        self.attn = MultiHeadAttention(p["attn"], num_heads)
        self.ln2 = LayerNorm(p["ln2"])
        self.mlp_in = Dense(p["mlp_in"])
        self.mlp_out = Dense(p["mlp_out"])

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        attn = self.attn(self.ln1(x))
        y, n2 = residual_layernorm(self.ln2.params(), attn, x)
        return y + self.mlp_out(L.gelu(self.mlp_in(n2)))


class ViT(nn.Module):
    def __init__(self, p: dict, *, patch: int, dim: int, num_heads: int,
                 input_shape: tuple, **_hyper) -> None:
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
        self.blocks = nn.ModuleList(Block(bp, num_heads) for bp in p["blocks"])
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


# ---- seeded numpy initializers (the JAX package's distributions) ----------


def _normal(rng, shape, std):
    return (rng.standard_normal(shape) * std).astype(np.float32)


def _trunc_normal(rng, shape, std=0.02):
    x = rng.standard_normal(shape)
    bad = np.abs(x) > 2.0
    while bad.any():
        x[bad] = rng.standard_normal(int(bad.sum()))
        bad = np.abs(x) > 2.0
    return (x * std).astype(np.float32)


def _dense(rng, n_in, n_out):
    return {"w": _normal(rng, (n_in, n_out), np.sqrt(1.0 / n_in)),
            "b": np.zeros((n_out,), np.float32)}


def _ln(dim):
    return {"scale": np.ones((dim,), np.float32),
            "bias": np.zeros((dim,), np.float32)}


def build_vit(name: str, num_classes: int, input_shape: tuple, patch: int,
              dim: int, depth: int, num_heads: int, mlp_dim: int) -> ModelDef:
    h, w, c = input_shape
    if h % patch or w % patch:
        raise ValueError(f"input {h}x{w} not divisible by patch size {patch}")
    seq = (h // patch) * (w // patch) + 1  # + CLS
    hyper = {"num_heads": num_heads, "dim": dim, "depth": depth,
             "mlp_dim": mlp_dim, "patch": patch,
             "input_shape": tuple(input_shape), "num_classes": num_classes}

    def init(rng: np.random.RandomState) -> dict:
        fan_in = patch * patch * c
        return {
            "embed": {"w": _normal(rng, (patch, patch, c, dim), np.sqrt(2.0 / fan_in)),
                      "b": np.zeros((dim,), np.float32)},
            "cls": np.zeros((1, 1, dim), np.float32),
            "pos": _trunc_normal(rng, (1, seq, dim)),
            "blocks": [
                {"ln1": _ln(dim),
                 "attn": {n: _dense(rng, dim, dim) for n in "qkvo"},
                 "ln2": _ln(dim),
                 "mlp_in": _dense(rng, dim, mlp_dim),
                 "mlp_out": _dense(rng, mlp_dim, dim)}
                for _ in range(depth)
            ],
            "ln": _ln(dim),
            "head": _dense(rng, dim, num_classes),
        }

    return ModelDef(name, tuple(input_shape), num_classes, init,
                    lambda tree: ViT(tree, **hyper), hyper)


@register("vit_b16")
def build_vit_b16(num_classes: int = 1000, input_shape: tuple = (224, 224, 3)) -> ModelDef:
    return build_vit("vit_b16", num_classes, input_shape, patch=16, dim=768,
                     depth=12, num_heads=12, mlp_dim=3072)


@register("vit_tiny")
def build_vit_tiny(num_classes: int = 10, input_shape: tuple = (32, 32, 3)) -> ModelDef:
    """Small ViT for tests (same code path as vit_b16, toy size)."""
    return build_vit("vit_tiny", num_classes, input_shape, patch=8, dim=64,
                     depth=2, num_heads=4, mlp_dim=128)
