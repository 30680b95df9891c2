"""char_tiny, the counterpart of ``storm_tpu/models/chartiny.py``: a tiny
character-level decoder-only transformer for the decode tier
(``storm_tpu_torch/decode/``).

Two layers, two heads, d = 32, d_ff = 64, a 98-token vocabulary and a
192-position table. :func:`build_params` is numpy (``default_rng``), so a
seed gives the same bytes as storm_tpu's; :func:`storm_tpu_torch.models.
convert.chartiny_params` puts them on a device. The per-layer pieces
below are torch and shared by the decode engine's step and by
:func:`stateless_logits`, so both run one definition of the math.

The registry entry ``char_tiny`` is the stateless single-token classify
view of the same weights: ``(B, 1)`` token ids -> ``(B, VOCAB)`` logits,
each row attending only to itself at position 0 (the decode engine's
``slot = -1`` rows).

Vocabulary: 0 = BOS, 1 = EOS, 2..97 = printable ASCII 32..127.
"""

from __future__ import annotations

import math
from typing import Dict, List

import numpy as np
import torch
from torch import nn

from storm_tpu_torch.models.registry import ModelDef, register

VOCAB = 98
BOS, EOS = 0, 1
D_MODEL = 32
N_HEADS = 2
N_LAYERS = 2
D_FF = 64
MAX_SEQ = 192  # positional table length; arenas may cap lower

_CHAR0 = 32  # token 2 is chr(32)


def encode_text(text: str) -> List[int]:
    """Chars -> token ids (callers prepend BOS). Out-of-range chars clamp
    to '?'."""
    out = []
    for ch in text:
        o = ord(ch)
        if not _CHAR0 <= o < _CHAR0 + (VOCAB - 2):
            o = ord("?")
        out.append(o - _CHAR0 + 2)
    return out


def decode_tokens(tokens) -> str:
    """Token ids -> chars; BOS and EOS render as ''."""
    return "".join(chr(int(t) - 2 + _CHAR0) for t in tokens
                   if int(t) not in (BOS, EOS) and 2 <= int(t) < VOCAB)


def build_params(seed: int = 0) -> Dict[str, np.ndarray]:
    """Seeded float32 numpy parameters, byte-identical to storm_tpu's for
    the same seed."""
    rng = np.random.default_rng(int(seed))

    def w(*shape, scale=0.08):
        return (rng.standard_normal(shape) * scale).astype(np.float32)

    params: Dict[str, np.ndarray] = {
        "embed": w(VOCAB, D_MODEL),
        "pos": w(MAX_SEQ, D_MODEL, scale=0.02),
        "lnf_g": np.ones(D_MODEL, np.float32),
        "lnf_b": np.zeros(D_MODEL, np.float32),
    }
    for layer in range(N_LAYERS):
        p = f"l{layer}_"
        params[p + "ln1_g"] = np.ones(D_MODEL, np.float32)
        params[p + "ln1_b"] = np.zeros(D_MODEL, np.float32)
        params[p + "wq"] = w(D_MODEL, D_MODEL)
        params[p + "wk"] = w(D_MODEL, D_MODEL)
        params[p + "wv"] = w(D_MODEL, D_MODEL)
        params[p + "wo"] = w(D_MODEL, D_MODEL)
        params[p + "ln2_g"] = np.ones(D_MODEL, np.float32)
        params[p + "ln2_b"] = np.zeros(D_MODEL, np.float32)
        params[p + "w1"] = w(D_MODEL, D_FF)
        params[p + "b1"] = np.zeros(D_FF, np.float32)
        params[p + "w2"] = w(D_FF, D_MODEL)
        params[p + "b2"] = np.zeros(D_MODEL, np.float32)
    return params


# ---- the per-layer pieces (tensors; params from convert.chartiny_params) ----


def layer_norm(x: torch.Tensor, g: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """numpy's ``(x - mean) / sqrt(var + 1e-5) * g + b`` (biased variance)."""
    mu = x.mean(dim=-1, keepdim=True)
    var = ((x - mu) ** 2).mean(dim=-1, keepdim=True)
    return (x - mu) / torch.sqrt(var + 1e-5) * g + b


def qkv(params: dict, layer: int, x: torch.Tensor):
    """Pre-norm projections for one layer: x (B, D) -> q, k, v (B, D)."""
    p = f"l{layer}_"
    a = layer_norm(x, params[p + "ln1_g"], params[p + "ln1_b"])
    return a @ params[p + "wq"], a @ params[p + "wk"], a @ params[p + "wv"]


def attn_out(params: dict, layer: int, x: torch.Tensor, q: torch.Tensor,
             keys: torch.Tensor, vals: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
    """Masked multi-head attention plus the residual for one layer. ``q``
    (B, D); ``keys``/``vals`` (B, T, D), each row's prefix; ``mask`` (B, T)
    True where position j is attendable for row i."""
    b, t, _ = keys.shape
    hd = D_MODEL // N_HEADS
    qh = q.reshape(b, N_HEADS, hd)
    kh = keys.reshape(b, t, N_HEADS, hd)
    vh = vals.reshape(b, t, N_HEADS, hd)
    scores = torch.einsum("bhd,bthd->bht", qh, kh) / math.sqrt(hd)
    scores = torch.where(mask[:, None, :], scores, scores.new_tensor(-1e30))
    scores = scores - scores.amax(dim=-1, keepdim=True)
    w = torch.exp(scores)
    w = w / w.sum(dim=-1, keepdim=True)
    out = torch.einsum("bht,bthd->bhd", w, vh).reshape(b, D_MODEL)
    return x + out @ params[f"l{layer}_wo"]


def mlp_out(params: dict, layer: int, x: torch.Tensor) -> torch.Tensor:
    p = f"l{layer}_"
    a = layer_norm(x, params[p + "ln2_g"], params[p + "ln2_b"])
    h = torch.relu(a @ params[p + "w1"] + params[p + "b1"])
    return x + h @ params[p + "w2"] + params[p + "b2"]


def logits_head(params: dict, x: torch.Tensor) -> torch.Tensor:
    """Final norm and the tied-embedding head: (B, D) -> (B, VOCAB)."""
    return layer_norm(x, params["lnf_g"], params["lnf_b"]) @ params["embed"].T


def stateless_logits(params: dict, tokens: torch.Tensor) -> torch.Tensor:
    """Next-char logits for single tokens with no prefix: each row attends
    only to itself at position 0."""
    tokens = tokens.reshape(-1).long()
    x = params["embed"][tokens] + params["pos"][0]
    mask = torch.ones((x.shape[0], 1), dtype=torch.bool, device=x.device)
    for layer in range(N_LAYERS):
        q, k, v = qkv(params, layer, x)
        x = attn_out(params, layer, x, q, k[:, None, :], v[:, None, :], mask)
        x = mlp_out(params, layer, x)
    return logits_head(params, x)


class CharTinyClassify(nn.Module):
    """The classify view as a module: ``(B, 1)`` token ids (any dtype;
    floats truncate) -> ``(B, VOCAB)`` logits."""

    def __init__(self, params: dict) -> None:
        super().__init__()
        self.params = nn.ParameterDict(
            {k: nn.Parameter(v, requires_grad=False) for k, v in params.items()})

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        tokens = x.reshape(x.shape[0], -1)[:, 0].long()
        return stateless_logits(dict(self.params.items()), tokens)


@register("char_tiny")
def char_tiny(num_classes: int = VOCAB, input_shape: tuple = (1,), **_ignored) -> ModelDef:
    """Registry entry: the stateless next-char classify view. ``init``
    reads the seed back from the legacy ``RandomState`` that
    :func:`storm_tpu_torch.models.convert.init_params` seeds (its first
    key word is the seed), so ``init_params(model, seed)`` equals
    ``build_params(seed)`` as in storm_tpu's entry."""

    def init(rng: np.random.RandomState) -> tuple:
        return build_params(int(rng.get_state()[1][0])), {}

    hyper = {"d_model": D_MODEL, "n_heads": N_HEADS, "n_layers": N_LAYERS, "vocab": VOCAB,
             "input_shape": tuple(input_shape), "num_classes": int(num_classes)}
    return ModelDef("char_tiny", tuple(input_shape), int(num_classes), init,
                    lambda params, _state: CharTinyClassify(params), hyper)
