"""Pipeline parallelism: GPipe microbatch pipelining over a mesh axis, the
counterpart of ``storm_tpu/parallel/pipeline.py``.

The blocks of a model are grouped into ``n_stages`` stages, stacked on a
leading axis (:func:`split_blocks`: leaves of shape (n_stages,
blocks_per_stage, ...)); the rank at index s of the ``stage`` axis holds
stage s (its leaves (1, blocks_per_stage, ...), ``shard_array`` of the
stack over the axis). :func:`pipeline_apply` runs storm_tpu's schedule:
``n_micro + n_stages - 1`` steps; at step t stage s computes microbatch
t - s and hands its activation one hop on with ``collectives.ppermute``;
the last stage collects the outputs, and a closing sum over the axis
(the other stages add zeros) makes them every stage's, as storm_tpu's
``psum`` does. A stage computes nothing in its fill and drain bubbles
(storm_tpu's scan computes on zeros there); every rank still makes every
step's ``ppermute``, so the ranks stay in step.

storm_tpu differentiates its ``scan`` of ``ppermute`` with ``jax.grad``.
Here the schedule's backward is written out, the same on every rank:
:func:`pipeline_apply` is one autograd function whose forward keeps each
microbatch's graph on its stage, and whose backward walks the
microbatches in reverse, ``n_micro + n_stages - 1`` steps again: stage s
backpropagates microbatch m from the gradient of its output (the last
stage: the gradient of the pipeline's output; the others: what stage s +
1 sent back with ``ppermute(shift=-1)``), accumulates its parameters'
gradients, and sends the gradient of its input back. No ``ppermute`` runs
inside autograd's own traversal. The pipeline's output is the same on
every stage and so is the loss computed from it, so the gradient of the
input (stage 0's alone) is summed over the axis, Megatron's *f*: every
stage gets the whole gradient of what came before the pipeline.

:func:`init_pp_training` is storm_tpu's pipelined ViT training: the
blocks stage-parallel, the embedding and the head replicated, the batch
over a data axis; the stage runs the port's ``Block`` modules, so the
fused-norm and flash kernels launch inside each stage on the card.
"""

from __future__ import annotations

from typing import Any, Callable, Optional

import numpy as np
import torch
import torch.nn.functional as F

from storm_tpu_torch.device import resolve_device
from storm_tpu_torch.models.convert import _map, init_params, trainable_params, tree_leaves
from storm_tpu_torch.models.registry import ModelDef
from storm_tpu_torch.parallel import collectives
from storm_tpu_torch.parallel.sharding import shard_array


def stack_stages(per_stage: list) -> Any:
    """Stack a list of identical trees (one a stage; numpy arrays or
    tensors) along a new leading axis, the axis split over the ``stage``
    mesh axis."""
    first = per_stage[0]
    if isinstance(first, dict):
        return {k: stack_stages([t[k] for t in per_stage]) for k in first}
    if isinstance(first, (list, tuple)):
        return type(first)(stack_stages([t[i] for t in per_stage]) for i in range(len(first)))
    if isinstance(first, torch.Tensor):
        return torch.stack(per_stage)
    return np.stack([np.asarray(t) for t in per_stage])


def split_blocks(blocks: list, n_stages: int) -> Any:
    """Group a model's block list into stage-stacked parameters with
    leaves of shape (n_stages, blocks_per_stage, ...)."""
    if len(blocks) % n_stages:
        raise ValueError(f"{len(blocks)} blocks not divisible into {n_stages} stages")
    bps = len(blocks) // n_stages
    return stack_stages([stack_stages(blocks[s * bps:(s + 1) * bps]) for s in range(n_stages)])


def _flatten(tree) -> tuple:
    leaves = tree_leaves(tree)
    it = iter(range(len(leaves)))
    skeleton = _map(lambda _leaf, _p: next(it), tree)
    return leaves, skeleton


def _rebuild(skeleton, leaves: list):
    return _map(lambda i, _p: leaves[i], skeleton)


class _Schedule:
    """What the pipeline's autograd function needs beside its tensors."""

    def __init__(self, mesh, stage_fn, skeleton, stage_axis: str, grad: bool) -> None:
        self.mesh, self.stage_fn, self.skeleton, self.axis = mesh, stage_fn, skeleton, stage_axis
        self.n_stages = mesh.shape[stage_axis]
        self.stage = mesh.coord(stage_axis)
        # Whether the caller differentiates: each microbatch's graph is
        # then kept on its stage for the backward.
        self.grad = grad


class _Pipeline(torch.autograd.Function):
    @staticmethod
    def forward(ctx, sched: _Schedule, x_micro, *leaves):
        n_micro, s, n = x_micro.shape[0], sched.stage, sched.n_stages
        # Leaves of this stage's own graphs: their gradients are summed over
        # the microbatches in backward and returned as the leaves'.
        own = [t.detach().requires_grad_(t.requires_grad and sched.grad) for t in leaves]
        with torch.set_grad_enabled(sched.grad):
            local = _rebuild(sched.skeleton, [t[0] for t in own])
        ins, outs = [None] * n_micro, [None] * n_micro
        zeros = torch.zeros_like(x_micro[0])
        recv = None
        for t in range(n_micro + n - 1):
            m = t - s
            send = zeros
            if 0 <= m < n_micro:
                a = (x_micro[m] if s == 0 else recv).detach().requires_grad_(sched.grad)
                with torch.set_grad_enabled(sched.grad):
                    out = sched.stage_fn(local, a)
                if out.shape != a.shape:
                    raise ValueError(f"stage_fn must keep the activation's shape "
                                     f"{tuple(a.shape)}, gave {tuple(out.shape)}")
                ins[m], outs[m] = a, out
                send = out.detach()
            if t < n_micro + n - 2:
                recv = collectives.ppermute(send, sched.mesh, sched.axis, 1)
        last = torch.stack([o.detach() for o in outs]) if s == n - 1 else \
            torch.zeros_like(x_micro)
        ctx.sched, ctx.own, ctx.ins, ctx.outs = sched, own, ins, outs
        ctx.x_grad = x_micro.requires_grad and sched.grad
        return collectives.all_reduce(last, sched.mesh, sched.axis)

    @staticmethod
    def backward(ctx, grad_out):
        sched, own, ins, outs = ctx.sched, ctx.own, ctx.ins, ctx.outs
        n_micro, s, n = len(ins), sched.stage, sched.n_stages
        wanted = [t for t in own if t.requires_grad]
        grads = [None] * len(wanted)
        grad_x = torch.zeros_like(grad_out)
        zeros = torch.zeros_like(grad_out[0])
        recv = None
        for u in range(n_micro + n - 1):
            m = n_micro - 1 - u + (n - 1 - s)
            send = zeros
            if 0 <= m < n_micro:
                g = grad_out[m] if s == n - 1 else recv
                got = torch.autograd.grad(outs[m], [ins[m], *wanted], g, allow_unused=True)
                grads = [a if b is None else (b if a is None else a + b)
                         for a, b in zip(grads, got[1:])]
                send = zeros if got[0] is None else got[0]
                if s == 0:
                    grad_x[m] = send
                ins[m] = outs[m] = None  # this microbatch's graph is done
            if u < n_micro + n - 2:
                recv = collectives.ppermute(send.contiguous(), sched.mesh, sched.axis, -1)
        if ctx.x_grad:
            grad_x = collectives.all_reduce(grad_x, sched.mesh, sched.axis)
        it = iter(grads)
        leaf_grads = [next(it) if t.requires_grad else None for t in own]
        return (None, grad_x if ctx.x_grad else None, *leaf_grads)


def pipeline_apply(mesh, stage_fn: Callable[[Any, torch.Tensor], torch.Tensor],
                   stage_params: Any, x_micro: torch.Tensor, stage_axis: str = "stage",
                   data_axis: Optional[str] = "data") -> torch.Tensor:
    """Run ``x_micro`` (n_micro, mb, ...) through the staged pipeline.

    ``stage_params``: this rank's stage, leaves (1, blocks_per_stage, ...)
    (storm_tpu's stacked layout, cut over ``stage_axis``);
    ``stage_fn(local_params, act) -> act`` gets them without the leading
    axis and must keep the activation's shape. ``x_micro`` is the same on
    every rank of the stage axis; its batch axis (1) holds this rank's
    rows of ``data_axis`` (storm_tpu's ``P(None, data)``; the rows are
    split by the caller, as every sharded input of the port is). Returns
    the pipeline's output in microbatch layout, x_micro's shape, the same
    on every stage. Differentiable in ``x_micro`` and in the stage's
    leaves (the module docstring's schedule). A collective call on every
    rank of the stage axis; fewer microbatches than stages is refused, as
    storm_tpu refuses it."""
    n_stages = mesh.shape[stage_axis]
    n_micro = x_micro.shape[0]
    if n_micro < n_stages:
        raise ValueError(f"n_micro={n_micro} < n_stages={n_stages}: bubbles would dominate")
    leaves, skeleton = _flatten(stage_params)
    grad = torch.is_grad_enabled() and (x_micro.requires_grad
                                        or any(t.requires_grad for t in leaves))
    return _Pipeline.apply(_Schedule(mesh, stage_fn, skeleton, stage_axis, grad), x_micro,
                           *leaves)


# ---- pipelined ViT training ------------------------------------------------------


def default_heads(model: ModelDef, params) -> int:
    """The heads of the pipelined ViT when the caller names none: the
    model's own (``hyper["num_heads"]``). storm_tpu reads a ``num_heads``
    attribute its ``ModelDef`` does not have and falls back to dim // 64
    (``storm_tpu/parallel/pipeline.py:156-160``), 1 head for vit_tiny's
    4 (ROADMAP C20); the port falls back to that rule only for a model
    without the record."""
    heads = model.hyper.get("num_heads")
    if heads is None:
        heads = max(1, params["blocks"][0]["attn"]["q"]["w"].shape[0] // 64)
    return int(heads)


def init_pp_training(model: ModelDef, mesh, n_micro: int = 4, num_heads: Optional[int] = None,
                     seed: int = 0, learning_rate: float = 1e-3, stage_axis: str = "stage",
                     data_axis: Optional[str] = "data", device=None,
                     init: Optional[tuple] = None):
    """Pipeline-parallel training of a ViT (a homogeneous block list) on
    this rank of ``mesh``: the blocks stage-parallel over ``stage_axis``,
    the embedding, CLS, position embedding, final LayerNorm and head
    (``rest``) replicated, the batch over ``data_axis``. Returns
    ``(train_step, (rest, stages), opt_state)``; ``train_step(ps,
    opt_state, x, y) -> (ps, opt_state, loss)`` takes the global batch
    (the same on every rank), keeps this rank's rows of each microbatch
    (storm_tpu's layout: ``x.reshape(n_micro, B / n_micro, ...)`` split on
    axis 1), and returns the global batch's mean loss, the same on every
    rank. Its gradients: the stage's from the pipeline's backward; every
    stage rank's ``rest`` the same (stage rank 0's, bit for bit,
    ``collectives.replicate_grads``); then all of them averaged over the
    data axis. The optimizer is AdamW with optax's defaults
    (``parallel.train.adamw``) over this rank's leaves; ``init`` as in
    ``init_sharded_training``; ``device`` defaults to ``cuda``."""
    from storm_tpu_torch.models.vit import Block
    from storm_tpu_torch.ops import layers as L
    from storm_tpu_torch.parallel.train import adamw

    dev = resolve_device(device)
    n_stages = mesh.shape[stage_axis]
    params, _ = init if init is not None else init_params(model, seed)
    if "blocks" not in params:
        raise ValueError(f"model {model.name!r} has no block list to pipeline")
    heads = num_heads or default_heads(model, params)
    f32 = _map(lambda leaf, _p: np.asarray(leaf, np.float32), params)
    stages = _map(lambda leaf, _p: shard_array(mesh, leaf, (stage_axis,)),
                  split_blocks(f32["blocks"], n_stages))
    rest = {k: v for k, v in f32.items() if k != "blocks"}
    ps = (trainable_params(rest, dev), trainable_params(stages, dev))
    opt_state = adamw(learning_rate)(ps)
    dp = mesh.shape[data_axis] if data_axis and data_axis in mesh.shape else 1
    rest_leaves = len(tree_leaves(ps[0]))

    def stage_fn(local, act):
        bps = tree_leaves(local)[0].shape[0]
        for i in range(bps):
            act = Block(_map(lambda leaf, _p: leaf[i], local), heads)(act)
        return act

    def forward(rest, stages, x):
        b = x.shape[0]
        patch, dim = rest["embed"]["w"].shape[0], rest["embed"]["w"].shape[-1]
        w = rest["embed"]["w"].permute(3, 2, 0, 1)  # HWIO -> OIHW
        tok = L.conv2d({"w": w, "b": rest["embed"]["b"]}, x, stride=patch, padding="valid")
        tok = tok.reshape(b, -1, dim)
        cls = rest["cls"].to(tok.dtype).expand(b, 1, dim)
        tok = torch.cat([cls, tok], dim=1) + rest["pos"].to(tok.dtype)
        s, d = tok.shape[1], tok.shape[2]
        micro = tok.reshape(n_micro, b // n_micro, s, d)
        out = pipeline_apply(mesh, stage_fn, stages, micro, stage_axis, data_axis)
        tok = L.layernorm(rest["ln"], out.reshape(b, s, d))
        return L.dense(rest["head"], tok[:, 0].contiguous())

    def local_rows(a, dtype):
        a = torch.as_tensor(np.asarray(a), dtype=dtype)
        b = a.shape[0]
        if b % n_micro or (b // n_micro) % dp:
            raise ValueError(f"batch {b} not divisible by n_micro={n_micro} x {dp} data ranks")
        a = a.reshape(n_micro, b // n_micro, *a.shape[1:])
        if dp > 1:
            a = shard_array(mesh, a, (None, data_axis))
        return a.reshape(-1, *a.shape[2:]).to(dev)

    def train_step(ps, opt_state, x, y):
        x, y = local_rows(x, torch.float32), local_rows(y, torch.int64)
        opt_state.zero_grad(set_to_none=True)
        loss = F.cross_entropy(forward(ps[0], ps[1], x).float(), y)
        loss.backward()
        grads = [p.grad for p in tree_leaves(ps)]
        collectives.replicate_grads(grads[:rest_leaves], mesh, stage_axis)
        # Every stage computed the loss from the same output: stage 0's,
        # bit for bit, on every rank (the others add zeros).
        loss = collectives.all_reduce(loss.detach() * float(mesh.coord(stage_axis) == 0),
                                      mesh, stage_axis)
        if dp > 1:
            collectives.all_reduce_grads(grads, mesh, data_axis, mean=True)
            loss = collectives.all_reduce(loss, mesh, data_axis) / dp
        opt_state.step()
        return ps, opt_state, loss

    train_step.device = dev
    train_step.heads = heads
    return train_step, ps, opt_state
