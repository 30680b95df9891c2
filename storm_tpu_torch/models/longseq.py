"""Long-sequence encoders, the counterpart of ``storm_tpu/models/longseq.py``:
``longseq_encoder`` (S = 2048) and its test-sized sibling ``longseq_tiny``.

An instance is a pre-embedded sequence of shape (seq, features), rank 2
(not an HWC image): a dense embedding to the model width plus a learned
position embedding, added in the compute dtype; the pre-LN encoder blocks
of ``models/vit.py`` (flash attention, the fused residual + LayerNorm, the
MLP); the final LayerNorm; the mean over the sequence; a dense head. On
the card every block runs the flash kernel at S = seq and the fused norm
at the model width, and under ``int8_fused`` each dense layer (the
embedding and head included) the w8a16 kernel. Stateless.

storm_tpu's ``apply_sp`` (the sequence-parallel forward on the ring
attention of ``parallel/sequence.py``) is not ported: it waits for the
parallel paths.
"""

from __future__ import annotations

import numpy as np
import torch
from torch import nn

from storm_tpu_torch.models.common import Dense, LayerNorm, dense_init, ln_init, normal
from storm_tpu_torch.models.registry import ModelDef, register
from storm_tpu_torch.models.vit import Block


class LongSeq(nn.Module):
    def __init__(self, p: dict, *, num_heads: int, **_hyper) -> None:
        super().__init__()
        self.embed = Dense(p["embed"])
        self.register_buffer("pos", p["pos"])
        self.blocks = nn.ModuleList(Block(bp, num_heads) for bp in p["blocks"])
        self.ln = LayerNorm(p["ln"])
        self.head = Dense(p["head"])

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        """(B, S, F) in the compute dtype -> (B, num_classes) logits."""
        h = self.embed(x) + self.pos.to(x.dtype)
        for blk in self.blocks:
            h = blk(h)
        h = self.ln(h)
        # The mean over the sequence, accumulated in f32 (jnp.mean's upcast).
        h = h.float().mean(dim=1).to(h.dtype)
        return self.head(h)


def build_longseq(name: str, num_classes: int, input_shape: tuple, dim: int,
                  depth: int, num_heads: int, mlp_dim: int) -> ModelDef:
    if len(input_shape) != 2:
        raise ValueError(
            f"{name} expects per-instance shape (seq, features); got {input_shape}")
    seq, d_in = input_shape
    hyper = {"num_heads": num_heads, "dim": dim, "depth": depth, "mlp_dim": mlp_dim,
             "input_shape": tuple(input_shape), "num_classes": num_classes}

    def init(rng: np.random.RandomState) -> tuple:
        params = {
            "embed": dense_init(rng, d_in, dim),
            "pos": normal(rng, (1, seq, dim), 0.02),
            "blocks": [{"ln1": ln_init(dim),
                        "attn": {n: dense_init(rng, dim, dim) for n in "qkvo"},
                        "ln2": ln_init(dim),
                        "mlp_in": dense_init(rng, dim, mlp_dim),
                        "mlp_out": dense_init(rng, mlp_dim, dim)}
                       for _ in range(depth)],
            "ln": ln_init(dim),
            "head": dense_init(rng, dim, num_classes),
        }
        return params, {}

    return ModelDef(name, tuple(input_shape), num_classes, init,
                    lambda params, _state: LongSeq(params, **hyper), hyper)


@register("longseq_encoder")
def build_longseq_encoder(num_classes: int = 10, input_shape: tuple = (2048, 64),
                          dim: int = 256, depth: int = 4, num_heads: int = 2,
                          mlp_dim: int = 1024) -> ModelDef:
    """S = 2048 sequences of 64 features, width 256, 2 heads of 128."""
    return build_longseq("longseq_encoder", num_classes, input_shape, dim, depth,
                         num_heads, mlp_dim)


@register("longseq_tiny")
def build_longseq_tiny(num_classes: int = 10, input_shape: tuple = (64, 16),
                       dim: int = 32, depth: int = 2, num_heads: int = 4,
                       mlp_dim: int = 64) -> ModelDef:
    """The test size of the same code: 4 heads of 8."""
    return build_longseq("longseq_tiny", num_classes, input_shape, dim, depth,
                         num_heads, mlp_dim)
