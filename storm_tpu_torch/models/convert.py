"""Parameters: seeded initialization, weight-only int8 quantization,
carrying the JAX package's parameter trees across, and the functional
forward that training differentiates (:func:`apply`).

Trees are nested dicts and lists with array leaves, laid out as the JAX
package lays them out: dense ``w`` is (in, out), convolution kernels are
HWIO (the module transposes them to OIHW). :func:`quantize_params` is the
numpy copy of ``storm_tpu/infer/engine.py:quantize_params`` and produces
bit-identical ``{"__q", "__s"}`` leaves; :func:`dequantize_params` and
:func:`prepare_params` follow the same file's serving preparation
(``engine.py:75-95`` and ``:537-551``), done once at load where the JAX
package does it inside its jitted forward. BatchNorm state stays float32
in every mode.
"""

from __future__ import annotations

from typing import Any, Callable, Optional

import numpy as np
import torch
from torch import nn

from storm_tpu_torch.device import resolve_device
from storm_tpu_torch.models.registry import ModelDef


def _map(fn: Callable[[Any, tuple], Any], tree, path: tuple = ()):
    """Apply ``fn(leaf, path)`` to every leaf; a ``{"__q", "__s"}`` dict
    is one leaf. ``path`` holds the dict keys and list indices above it."""
    if isinstance(tree, dict) and "__q" not in tree:
        return {k: _map(fn, v, path + (k,)) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_map(fn, v, path + (i,)) for i, v in enumerate(tree))
    return fn(tree, path)


def _is_qleaf(x) -> bool:
    return isinstance(x, dict) and "__q" in x


def init_params(model: ModelDef, seed: int = 0):
    """Seeded float32 numpy ``(params, state)`` for ``model`` (JAX layout)."""
    return model.init(np.random.RandomState(seed))


def quantize_params(params, min_ndim: int = 2):
    """Float tree -> the same tree with every float leaf of rank >=
    ``min_ndim`` replaced by ``{"__q": int8, "__s": f32}``: symmetric
    per-output-channel (last axis) scales, ``np.rint``, clip at +-127.
    That covers dense weights and also the CLS token, the position
    embedding and the patch-embedding kernel."""
    def quant(leaf, _path):
        leaf = np.asarray(leaf)
        if leaf.ndim < min_ndim or leaf.dtype.kind not in "fV":
            return leaf  # V: bfloat16 shows as void-kind
        w = np.asarray(leaf, np.float32)
        axes = tuple(range(w.ndim - 1))
        scale = np.max(np.abs(w), axis=axes) / 127.0
        scale = np.maximum(scale, 1e-12).astype(np.float32)
        q = np.clip(np.rint(w / scale), -127, 127).astype(np.int8)
        return {"__q": q, "__s": scale}

    return _map(quant, params)


def _tensor(a, dtype=None) -> torch.Tensor:
    t = torch.from_numpy(np.array(a, copy=True))
    return t if dtype is None else t.to(dtype)


def dequantize_params(qparams, dtype: torch.dtype, keep_dense: bool = False):
    """Numpy tree from :func:`quantize_params` -> tree of tensors.
    Quantized leaves become ``q.to(dtype) * s.to(dtype)``, except, with
    ``keep_dense``, 2-D leaves under a ``"w"`` key (dense weights), which
    stay ``{"__q": int8, "__s": f32}`` for the w8a16 kernel. Float leaves
    are converted as they are."""
    def deq(leaf, path):
        if not _is_qleaf(leaf):
            return _tensor(leaf)
        q, s = _tensor(leaf["__q"]), _tensor(leaf["__s"])
        if keep_dense and q.dim() == 2 and path and path[-1] == "w":
            return {"__q": q, "__s": s}
        return q.to(dtype) * s.to(dtype)

    return _map(deq, qparams)


def prepare_params(params, weights: str, dtype: torch.dtype, shard=None):
    """Numpy float32 tree (JAX layout) -> the tensor tree a module is
    built from, for ``weights`` (``shard``, if given, maps the numpy tree
    to this rank's shard of it after quantization and before anything
    becomes a tensor: ``parallel/sharding.py``):

    - "float": every leaf cast to the compute dtype;
    - "int8": every float leaf of rank >= 2 (dense and convolution
      weights, the CLS token, the position embedding) quantized and
      dequantized once, here, as ``q.to(dtype) * s.to(dtype)``; the rest
      (biases, norm parameters) cast to the compute dtype;
    - "int8_fused": the same, except that dense weights (2-D leaves under
      a ``"w"`` key) stay ``{"__q": int8, "__s": f32}`` for the w8a16
      kernel."""
    if weights not in ("float", "int8", "int8_fused"):
        raise ValueError(f"weights must be float|int8|int8_fused, got {weights!r}")

    shard = shard or (lambda tree: tree)
    f32 = _map(lambda leaf, _p: np.asarray(leaf, np.float32), params)
    if weights == "float":
        return _map(lambda leaf, _p: _tensor(leaf, dtype), shard(f32))
    tree = dequantize_params(shard(quantize_params(f32)), dtype,
                             keep_dense=weights == "int8_fused")
    return _map(lambda t, _p: t if _is_qleaf(t) else t.to(dtype), tree)


def prepared_nbytes(tree, weights: str, dtype: torch.dtype) -> int:
    """The bytes :func:`prepare_params` makes of ``tree`` (its numpy tree
    as ``shard`` receives it: quantized unless ``weights`` is "float"),
    counted without building a tensor."""
    size = torch.empty((), dtype=dtype).element_size()
    keep_dense = weights == "int8_fused"
    total = 0

    def count(leaf, path):
        nonlocal total
        if not _is_qleaf(leaf):
            total += np.asarray(leaf).size * size
        elif keep_dense and leaf["__q"].ndim == 2 and path and path[-1] == "w":
            total += leaf["__q"].size + leaf["__s"].size * 4
        else:
            total += leaf["__q"].size * size

    _map(count, tree)
    return total


def prepare_state(state):
    """Numpy state tree -> float32 tensors, whatever the compute dtype
    (BatchNorm statistics are never cast, ``engine.py:537-538``)."""
    return _map(lambda leaf, _p: _tensor(np.asarray(leaf, np.float32)), state or {})


def from_jax_params(params, model: ModelDef, state=None, *, weights: str = "float",
                    dtype: torch.dtype = torch.float32,
                    device=None, shard=None) -> nn.Module:
    """Build ``model``'s module from numpy ``params`` and ``state`` trees
    in the JAX layout (``jax.tree.map(np.asarray, ...)`` of storm_tpu's,
    or :func:`storm_tpu_torch.models.registry.load_checkpoint`'s) on
    ``device`` (default ``cuda``; pass ``"cpu"`` for the CPU); with
    ``shard``, from this rank's shard of them (:func:`prepare_params`)."""
    dev = resolve_device(device)
    module = model.make(prepare_params(params, weights, dtype, shard), prepare_state(state))
    return module.eval().to(dev)


def tree_leaves(tree) -> list:
    """The leaves of ``tree`` in the order :func:`_map` visits them."""
    leaves: list = []
    _map(lambda leaf, _path: leaves.append(leaf), tree)
    return leaves


def trainable_params(params, device=None):
    """Numpy float tree (JAX layout) -> the same tree of float32 leaf
    tensors on ``device`` (default ``cuda``; pass ``"cpu"`` for the CPU)
    that require grad: what :func:`apply` differentiates and an optimizer
    updates in place."""
    dev = resolve_device(device)
    return _map(lambda leaf, _p: _tensor(np.asarray(leaf, np.float32)).to(dev)
                .requires_grad_(), params)


def state_tensors(state, device=None):
    """Numpy state tree -> float32 tensors on ``device`` (default ``cuda``)."""
    dev = resolve_device(device)
    return _map(lambda t, _p: t.to(dev), prepare_state(state))


def host_tree(tree):
    """Tree of tensors -> the same tree of numpy copies (what a snapshot
    keeps: the optimizer updates the leaves in place)."""
    return _map(lambda t, _p: t.detach().cpu().numpy().copy(), tree)


def apply(model: ModelDef, params, state, x: torch.Tensor, train: bool = False,
          attach: Optional[Callable[[nn.Module], Any]] = None):
    """``(logits, new_state)`` of ``model`` on ``x``: the counterpart of
    storm_tpu's ``ModelDef.apply(params, state, x, train)``. ``params``
    and ``state`` are tensor trees in the JAX layout (e.g. from
    :func:`trainable_params`); the module is built from them for this
    call, so the logits are differentiable in every leaf. With ``train``
    BatchNorm normalizes with the batch's statistics and ``new_state`` holds
    the updated running ones, and a MoE-ViT adds its load-balancing loss
    under ``"moe_aux_loss"`` (storm_tpu's training surface); otherwise
    ``state`` is returned as it is. ``attach(module)``, if given, runs on
    the module before the forward (a sharded step's collectives:
    ``parallel/train.py``)."""
    module = model.make(params, state or {})
    if attach is not None:
        attach(module)
    module.train(train)
    logits = module(x)
    if not train:
        return logits, state

    def updated(leaf, path):
        if len(path) < 2 or path[-2] != "bn":
            return leaf  # e.g. the last step's moe_aux_loss, replaced below
        return module.get_submodule(".".join(map(str, path[:-2]))).new_state[path[-1]]

    new_state = _map(updated, state or {})
    aux = [m.aux_loss for m in module.modules() if getattr(m, "aux_loss", None) is not None]
    if aux:
        new_state = {**new_state, "moe_aux_loss": sum(aux[1:], aux[0])}
    return logits, new_state


def chartiny_params(params, device=None) -> dict:
    """char_tiny's numpy parameter dict
    (:func:`storm_tpu_torch.models.chartiny.build_params`) -> float32
    tensors on ``device`` (default ``cuda``; pass ``"cpu"`` for the CPU),
    the form the decode engine and ``chartiny``'s pieces compute with."""
    dev = resolve_device(device)
    return {k: _tensor(np.asarray(v, np.float32)).to(dev) for k, v in params.items()}
