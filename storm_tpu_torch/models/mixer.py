"""MLP-Mixer, the counterpart of ``storm_tpu/models/mixer.py``: a patch
stem (a strided VALID convolution), blocks of token mixing (LayerNorm,
then an MLP over the token axis of the transposed activation) and channel
mixing (an MLP over the channels), a final LayerNorm, the mean over
tokens and a dense head. Stateless.

The token-mixing residual add and the channel LayerNorm run as one fused
residual norm (``residual_layernorm``, the fused-norm kernel on the
card), at the model's width (512 for ``mixer_s16``, 64 for
``mixer_tiny``). Under ``int8_fused`` the token MLP's dense layers run
the w8a16 kernel with the token count as a contraction or output width
(196 for ``mixer_s16``).
"""

from __future__ import annotations

import numpy as np
import torch
from torch import nn

from storm_tpu_torch.models.common import Dense, LayerNorm, conv_init, dense_init, ln_init
from storm_tpu_torch.models.registry import ModelDef, register
from storm_tpu_torch.ops import layers as L
from storm_tpu_torch.ops.fused_norm import residual_layernorm


class MLP(nn.Module):
    """``fc2(gelu(fc1(x)))``."""

    def __init__(self, p: dict) -> None:
        super().__init__()
        self.fc1 = Dense(p["fc1"])
        self.fc2 = Dense(p["fc2"])

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.fc2(L.gelu(self.fc1(x)))


class MixerBlock(nn.Module):
    def __init__(self, p: dict) -> None:
        super().__init__()
        self.ln1 = LayerNorm(p["ln1"])
        self.token = MLP(p["token"])
        self.ln2 = LayerNorm(p["ln2"])
        self.channel = MLP(p["channel"])

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        # Token mixing: LN, (B, T, C) -> (B, C, T), the MLP over T, back.
        y = self.token(self.ln1(x).transpose(1, 2)).transpose(1, 2)
        x, n2 = residual_layernorm(self.ln2.params(), y, x)
        return x + self.channel(n2)


class Mixer(nn.Module):
    def __init__(self, p: dict, *, patch: int, **_hyper) -> None:
        super().__init__()
        self.patch = patch
        # HWIO (the JAX layout) -> OIHW for F.conv2d.
        self.register_buffer("stem_w", p["stem"]["w"].permute(3, 2, 0, 1).contiguous())
        self.register_buffer("stem_b", p["stem"]["b"])
        self.blocks = nn.ModuleList(MixerBlock(bp) for bp in p["blocks"])
        self.ln = LayerNorm(p["ln"])
        self.head = Dense(p["head"])

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        """(B, H, W, C) in the compute dtype -> (B, num_classes) logits."""
        y = L.conv2d({"w": self.stem_w, "b": self.stem_b}, x, stride=self.patch,
                     padding="valid")
        y = y.reshape(y.shape[0], -1, y.shape[-1])  # (B, T, C)
        for blk in self.blocks:
            y = blk(y)
        y = self.ln(y)
        # The mean over tokens, accumulated in f32 (jnp.mean's upcast).
        y = y.float().mean(dim=1).to(y.dtype)
        return self.head(y)


def _build_mixer(name: str, num_classes: int, input_shape: tuple, patch: int, dim: int,
                 depth: int, token_mlp: int, channel_mlp: int) -> ModelDef:
    h, w, c = input_shape
    if h % patch or w % patch:
        raise ValueError(f"input {h}x{w} not divisible by patch {patch}")
    n_tokens = (h // patch) * (w // patch)
    hyper = {"patch": patch, "dim": dim, "depth": depth, "token_mlp": token_mlp,
             "channel_mlp": channel_mlp, "input_shape": tuple(input_shape),
             "num_classes": num_classes}

    def mlp_init(rng: np.random.RandomState, d: int, hidden: int) -> dict:
        return {"fc1": dense_init(rng, d, hidden), "fc2": dense_init(rng, hidden, d)}

    def init(rng: np.random.RandomState) -> tuple:
        params = {
            "stem": conv_init(rng, patch, patch, c, dim),
            "blocks": [{"ln1": ln_init(dim), "token": mlp_init(rng, n_tokens, token_mlp),
                        "ln2": ln_init(dim), "channel": mlp_init(rng, dim, channel_mlp)}
                       for _ in range(depth)],
            "ln": ln_init(dim),
            "head": dense_init(rng, dim, num_classes),
        }
        return params, {}

    return ModelDef(name, tuple(input_shape), num_classes, init,
                    lambda params, _state: Mixer(params, **hyper), hyper)


@register("mixer_s16")
def build_mixer_s16(num_classes: int = 1000, input_shape: tuple = (224, 224, 3)) -> ModelDef:
    """Mixer-S/16: patch 16, dim 512, depth 8, token MLP 256, channel MLP
    2048."""
    return _build_mixer("mixer_s16", num_classes, input_shape, patch=16, dim=512,
                        depth=8, token_mlp=256, channel_mlp=2048)


@register("mixer_tiny")
def build_mixer_tiny(num_classes: int = 10, input_shape: tuple = (32, 32, 3)) -> ModelDef:
    return _build_mixer("mixer_tiny", num_classes, input_shape, patch=4, dim=64,
                        depth=4, token_mlp=32, channel_mlp=128)
