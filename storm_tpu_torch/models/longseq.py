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

``apply_sp`` (``LongSeq.forward_sp``) is storm_tpu's sequence-parallel
forward (``storm_tpu/models/longseq.py:66-78``): this rank's shard of the
sequence through the embedding and its slice of the position embedding,
the encoder of ``parallel/sequence.py`` (plain LayerNorms and ring
attention, no flash kernel and no fused norm, as storm_tpu's), the final
LayerNorm, the sequence mean as a sum over the shard reduced over the
sequence axis (GSPMD inserts that reduce in storm_tpu), and the head on
every rank. Under ``int8_fused`` each dense layer still runs the w8a16
kernel, at S / sp rows.
"""

from __future__ import annotations

import numpy as np
import torch
from torch import nn

from storm_tpu_torch.models.common import Dense, LayerNorm, dense_init, ln_init, normal
from storm_tpu_torch.models.registry import ModelDef, register
from storm_tpu_torch.models.vit import Block
from storm_tpu_torch.parallel.collectives import all_reduce
from storm_tpu_torch.parallel.sequence import seq_parallel_encoder


class LongSeq(nn.Module):
    def __init__(self, p: dict, *, num_heads: int, **_hyper) -> None:
        super().__init__()
        self.num_heads = num_heads
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

    def forward_sp(self, x: torch.Tensor, mesh, seq_axis: str = "seq") -> torch.Tensor:
        """This rank's (B, S / sp, F) shard of the sequence (the ranks of
        ``seq_axis`` hold it in order) -> the (B, num_classes) logits, the
        same on every rank of the axis."""
        n, i = mesh.shape[seq_axis], mesh.coord(seq_axis)
        s = x.shape[1]
        h = self.embed(x) + self.pos[:, i * s:(i + 1) * s].to(x.dtype)
        h = seq_parallel_encoder([blk.params() for blk in self.blocks], h, self.num_heads,
                                 mesh, seq_axis)
        h = self.ln(h)
        # The mean over the whole sequence in f32: the shard's sum, summed
        # over the axis.
        h = (all_reduce(h.float().sum(dim=1), mesh, seq_axis) / (s * n)).to(h.dtype)
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

    def apply_sp(params, state, x: torch.Tensor, mesh, seq_axis: str = "seq",
                 train: bool = False):
        """storm_tpu's ``apply_sp``: ``(logits, state)`` of the module built
        from the tensor trees, on this rank's shard ``x`` of the sequence
        (:meth:`LongSeq.forward_sp`)."""
        if train:
            raise NotImplementedError("sequence-parallel training is not ported")
        return LongSeq(params, **hyper).forward_sp(x, mesh, seq_axis), state

    return ModelDef(name, tuple(input_shape), num_classes, init,
                    lambda params, _state: LongSeq(params, **hyper), hyper,
                    apply_sp=apply_sp)


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
