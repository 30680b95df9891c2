"""Placement of a batch and of parameters on a mesh of ranks, the
counterpart of ``storm_tpu/parallel/sharding.py``.

storm_tpu annotates where arrays live (``NamedSharding``) and lets XLA
insert the collectives. The port gives each rank its own shard: a spec is
a tuple with one entry a dimension, the mesh axis that dimension is split
over or None (``PartitionSpec``'s meaning; ``()`` is replicated), and
:func:`shard_array` cuts this rank's block of it, a contiguous copy (of a
leaf that requires grad, a new leaf that requires grad). Everything here
works on numpy arrays and torch tensors alike, on the parameter trees in
the JAX layout (nested dicts and lists), quantized leaves ``{"__q",
"__s"}`` included.

Quantize first, then shard, as storm_tpu's engine does
(``storm_tpu/infer/engine.py:527-553``): the int8 scales are per output
column over the whole K, so a row-parallel shard keeps every column's
scale and a column-parallel shard slices the scales with its columns
(storm_tpu replicates the scales and lets GSPMD broadcast them; a rank
of the port holds the ones its columns use). :func:`attach_tp` then gives
a module built from a TP shard its collectives (the row-parallel sums and,
for a gradient, the column-parallel inputs' *f*); a float tree of
trainable leaves is sharded as a numpy one is (shard the numpy tree, then
make the leaves: ``parallel/train.py``), and :func:`gather_params_tp`
puts the ranks' shards back together.
"""

from __future__ import annotations

import functools
from typing import Any, Callable

import numpy as np
import torch

# Megatron's split of a transformer block (storm_tpu's parameter names).
COLUMN_KEYS = ("q", "k", "v", "mlp_in")
ROW_KEYS = ("o", "mlp_out")


def batch_sharding(mesh, data_axis: str = "data") -> tuple:
    """Axis 0 (the batch) over ``data_axis``; every other dimension whole."""
    return (data_axis,)


def replicated(mesh) -> tuple:
    return ()


def shard_array(mesh, x, spec: tuple):
    """This rank's block of ``x`` under ``spec``: each dimension named by
    an axis is cut into ``mesh.shape[axis]`` equal blocks and the one at
    this rank's index kept (a contiguous copy)."""
    index = []
    for dim, axis in enumerate(spec):
        if axis is None:
            index.append(slice(None))
            continue
        n, i = mesh.shape[axis], mesh.coord(axis)
        size = x.shape[dim]
        if size % n:
            raise ValueError(f"dimension {dim} of size {size} does not divide over the "
                             f"{n} ranks of mesh axis {axis!r}")
        step = size // n
        index.append(slice(i * step, (i + 1) * step))
    if not any(a is not None for a in spec):
        return x
    block = x[tuple(index)]
    if isinstance(block, torch.Tensor):
        # A trainable leaf's block is a trainable leaf of its own.
        out = block.detach().clone(memory_format=torch.contiguous_format)
        return out.requires_grad_(x.requires_grad)
    return np.array(block, copy=True)


def shard_batch(mesh, x, data_axis: str = "data"):
    """This rank's rows of the batch ``x``."""
    return shard_array(mesh, x, batch_sharding(mesh, data_axis))


def _walk(fn: Callable[[tuple, Any], Any], tree, path: tuple = ()):
    """``fn(path, leaf)`` over every array leaf; a quantized leaf is a dict
    like any other, so its ``__q`` and ``__s`` have paths of their own
    (as in storm_tpu's flattened trees)."""
    if isinstance(tree, dict):
        return {k: _walk(fn, v, path + (k,)) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_walk(fn, v, path + (i,)) for i, v in enumerate(tree))
    return fn(path, tree)


def _tp_spec(path: tuple, leaf, model_axis: str) -> tuple:
    col = any(k in COLUMN_KEYS for k in path)
    row = any(k in ROW_KEYS for k in path)
    last = path[-1] if path else None
    ndim = getattr(leaf, "ndim", 0)
    if ndim == 2 and col:
        return (None, model_axis)
    if ndim == 2 and row:
        return (model_axis, None)
    if ndim == 1 and col and last in ("b", "__s"):
        return (model_axis,)
    return ()


def tp_param_specs(params: Any, model_axis: str = "model") -> Any:
    """The spec tree of Megatron tensor parallelism (storm_tpu's rule):
    the kernels of q, k, v and mlp_in column-parallel (their output dim
    over ``model_axis``), of o and mlp_out row-parallel (their input dim),
    the column-parallel biases and, of a quantized tree, the column-
    parallel scales split with their columns; everything else replicated."""
    return _walk(lambda path, leaf: _tp_spec(path, leaf, model_axis), params)


def shard_params_tp(mesh, params: Any, model_axis: str = "model") -> Any:
    """This rank's shard of ``params`` under :func:`tp_param_specs`. With a
    model axis of one rank it is ``params`` itself."""
    return _walk(lambda path, leaf: shard_array(mesh, leaf, _tp_spec(path, leaf, model_axis)),
                 params)


def _expert_keys() -> set:
    """The MoE parameters split over the experts (one source of truth:
    ``moe_param_specs``)."""
    from storm_tpu_torch.parallel.moe import moe_param_specs

    return {k for k, spec in moe_param_specs().items() if spec}


def _ep_spec(path: tuple, expert_axis: str) -> tuple:
    # The expert key anywhere in the path: int8 quantization puts the
    # arrays one level below it ({"__q", "__s"}); the int8 values keep the
    # leading expert dim and split, the per-column scales (shared by every
    # expert) stay whole.
    keys = _expert_keys()
    if "moe" in path and any(k in keys for k in path) and path[-1] != "__s":
        return (expert_axis,)
    return ()


def expert_dims(params: Any) -> list:
    """The leading (expert) dims of a float tree's MoE expert tensors."""
    keys = _expert_keys()
    dims = []
    _walk(lambda path, leaf: dims.append(int(leaf.shape[0]))
          if "moe" in path and path[-1] in keys else None, params)
    return dims


def shard_params_ep(mesh, params: Any, expert_axis: str = "expert") -> Any:
    """Expert parallelism for serving: every MoE expert tensor (``moe``'s
    ``w_in``, ``b_in``, ``w_out``, ``b_out``, leading axis the experts)
    split on that axis over ``expert_axis`` (this rank's contiguous block
    of E / ep experts); the gate and everything else whole."""
    return _walk(lambda path, leaf: shard_array(mesh, leaf, _ep_spec(path, expert_axis)),
                 params)


def row_parallel_paths(params: Any) -> set:
    """Dotted paths of the row-parallel dense layers of a parameter tree
    (``blocks.0.attn.o``): the module paths :func:`attach_tp` must find."""
    found = set()

    def visit(tree, path: tuple) -> None:
        if isinstance(tree, dict):
            if "w" in tree and any(k in ROW_KEYS for k in path):
                found.add(".".join(map(str, path)))
                return
            for k, v in tree.items():
                visit(v, path + (k,))
        elif isinstance(tree, (list, tuple)):
            for i, v in enumerate(tree):
                visit(v, path + (i,))

    visit(params, ())
    return found


def attach_tp(module: torch.nn.Module, mesh, params: Any,
              model_axis: str = "model") -> torch.nn.Module:
    """Give a module built from a TP shard of ``params`` its collectives
    over ``model_axis``: each row-parallel ``Dense`` its sum (Megatron's
    *g*, ``collectives.reduce_from_axis``), and each module with a
    ``copy`` slot (the attention, whose input feeds the column-parallel
    q, k and v, and the ViT block, whose ``n2`` feeds mlp_in) Megatron's
    *f* (``collectives.copy_to_axis``), so a backward sums the gradient
    of every column-parallel input over the axis. The row-parallel
    modules are found by the parameters' rule applied to their own paths,
    and must be exactly the row-parallel layers of ``params``: a family
    whose modules do not mirror its parameter paths is refused."""
    from storm_tpu_torch.models.common import Dense
    from storm_tpu_torch.models.vit import Block, MultiHeadAttention
    from storm_tpu_torch.parallel.collectives import copy_to_axis, reduce_from_axis

    reduce = functools.partial(reduce_from_axis, mesh=mesh, axis=model_axis)
    copy = functools.partial(copy_to_axis, mesh=mesh, axis=model_axis)
    attached = set()
    for name, m in module.named_modules():
        if isinstance(m, Dense) and any(k in ROW_KEYS for k in name.split(".")):
            m.reduce = reduce
            attached.add(name)
        elif isinstance(m, (MultiHeadAttention, Block)):
            m.copy = copy
    want = row_parallel_paths(params)
    if attached != want:
        raise ValueError(f"tensor parallelism: the row-parallel modules {sorted(attached)} "
                         f"are not the row-parallel parameters {sorted(want)}")
    return module


def gather_params_tp(mesh, params: Any, model_axis: str = "model") -> Any:
    """The whole tree from this rank's TP shard of it (parameters or their
    gradients, tensors): each split leaf all-gathered over ``model_axis``
    along its split dimension, each replicated leaf as it is. A collective
    call (every rank of the model axis, in one order); for tests and for
    checkpoints. With a model axis of one it is ``params`` itself."""
    from storm_tpu_torch.parallel.collectives import all_gather

    def join(path, leaf):
        spec = _tp_spec(path, leaf, model_axis)
        if leaf is None or model_axis not in spec:
            return leaf
        return all_gather(leaf.detach().contiguous(), mesh, model_axis,
                          dim=spec.index(model_axis))

    return _walk(join, params)


def replicated_leaves(params: Any, model_axis: str = "model") -> Any:
    """The tree's leaves that :func:`tp_param_specs` keeps whole (the
    norms, the embedding, the head, the row-parallel biases), as a tree
    of booleans."""
    return _walk(lambda path, leaf: model_axis not in _tp_spec(path, leaf, model_axis),
                 params)
