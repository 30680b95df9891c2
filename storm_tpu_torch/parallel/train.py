"""The training step, the counterpart of ``storm_tpu/parallel/train.py``
(``make_train_step``, ``init_sharded_training``, ``train_one_step``).

storm_tpu jits ``value_and_grad`` of the mean softmax cross-entropy over
``model.apply(..., train=True)`` and applies ``optax.adamw``. The port runs
the same step eagerly (no CUDA graph, no ``torch.compile``):

- parameters are the JAX-layout tree of float32 leaf tensors that require
  grad (``models.convert.trainable_params``); the module is built from
  them each step (``ModelDef.apply``), so the loss reaches every leaf,
  through the fused-norm and flash kernels' autograd functions on the
  card;
- the loss is ``F.cross_entropy`` of float32 logits against integer
  labels, its mean (``softmax_cross_entropy_with_integer_labels(...)
  .mean()``);
- the optimizer is ``torch.optim.AdamW`` with optax's ``adamw`` defaults
  (betas 0.9 and 0.999, eps 1e-8, weight decay 1e-4 on every leaf, no
  mask; PyTorch's own default decay is 1e-2), which updates the leaves in
  place; its per-leaf ``exp_avg`` and ``exp_avg_sq`` are optax's ``mu``
  and ``nu`` (:func:`adam_moments`);
- a MoE-ViT's ``moe_aux_loss`` stays in the returned state and is not
  added to the loss, as in storm_tpu (ROADMAP C15).

The sharded step (:func:`init_sharded_training`) runs on a (data, model)
mesh of ranks (``parallel/mesh.py``), each rank one process. storm_tpu
leaves the collectives to GSPMD; here they are explicit:

- a rank holds its Megatron shard of the parameters
  (``sharding.shard_params_tp``) and the optimizer state of its leaves;
  each step's module gets Megatron's *g* on its row-parallel layers and
  *f* on its column-parallel inputs (``sharding.attach_tp``), so its
  backward gives every leaf of the shard its whole gradient;
- the batch's rows are split over the data axis (``train_one_step``);
  each rank's loss is the mean over its rows, and the gradients are
  averaged over the data axis in one flattened buffer
  (``collectives.all_reduce_grads``), which makes the update that of the
  global batch's mean loss, storm_tpu's; the returned loss is that mean;
- BatchNorm in train mode takes the global batch's statistics (its sum
  over the data axis, ``ops.layers.batchnorm``), so the running state
  updates as storm_tpu's and is the same on every rank;
- the leaves every model rank holds whole get model rank 0's gradient,
  bit for bit (``collectives.replicate_grads``), so no replica drifts.
"""

from __future__ import annotations

import functools
from typing import Callable, Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from storm_tpu_torch.device import resolve_device
from storm_tpu_torch.models.convert import (
    _map, host_tree, init_params, state_tensors, trainable_params, tree_leaves)
from storm_tpu_torch.models.registry import ModelDef
from storm_tpu_torch.parallel import collectives, sharding

# optax.adamw's defaults (b1, b2, eps, weight_decay).
ADAMW_BETAS = (0.9, 0.999)
ADAMW_EPS = 1e-8
ADAMW_WEIGHT_DECAY = 1e-4


# An optimizer, in the place of an optax GradientTransformation: called
# with a parameter tree, it returns the optimizer state for it, a
# ``torch.optim.Optimizer`` over the tree's leaves in tree order.
Optimizer = Callable[[object], torch.optim.Optimizer]


def adamw(learning_rate: float = 1e-3) -> Optimizer:
    """``optax.adamw(learning_rate)`` as ``torch.optim.AdamW``."""
    return lambda params: torch.optim.AdamW(
        tree_leaves(params), lr=learning_rate, betas=ADAMW_BETAS, eps=ADAMW_EPS,
        weight_decay=ADAMW_WEIGHT_DECAY)


def make_train_step(model: ModelDef, optimizer: Optional[Optimizer] = None,
                    learning_rate: float = 1e-3, device=None) -> Tuple[Callable, Optimizer]:
    """``(train_step, optimizer)``: ``opt_state = optimizer(params)``, then
    ``train_step(params, opt_state, state, x, y) -> (params, opt_state,
    new_state, loss)`` on ``device``
    (default ``cuda``, raising without a card; pass ``"cpu"`` for the
    CPU). ``x`` and ``y`` (numpy arrays or tensors) are moved there;
    ``params`` are updated in place and returned, ``new_state`` and
    ``loss`` are detached. ``optimizer`` defaults to :func:`adamw`."""
    dev = resolve_device(device)
    opt = optimizer or adamw(learning_rate)
    return _step(model, opt, dev, None), opt


def _attach(mesh, data_axis: str, model_axis: str, params):
    """What a sharded step's module gets before its forward: the TP
    collectives, and each BatchNorm's sum over the data axis."""
    from storm_tpu_torch.models.common import ConvBN

    def attach(module) -> None:
        if mesh.shape[model_axis] > 1:
            sharding.attach_tp(module, mesh, params, model_axis)
        if mesh.shape[data_axis] > 1:
            batch_sum = functools.partial(collectives.sum_over_axis, mesh=mesh, axis=data_axis)
            for m in module.modules():
                if isinstance(m, ConvBN):
                    m.batch_sum = batch_sum

    return attach


def _step(model: ModelDef, opt: Optimizer, dev: torch.device, mesh) -> Callable:
    """The train step on one device (``mesh`` None) or on this rank of
    ``mesh`` (its rows of the batch given)."""
    if mesh is not None:
        data_axis, model_axis = mesh.axis_names
        dp = mesh.shape[data_axis]
    replicated = None

    def apply(params, state, x, train: bool = False):
        x = torch.as_tensor(x, dtype=torch.float32, device=dev)
        attach = None if mesh is None else _attach(mesh, data_axis, model_axis, params)
        return model.apply(params, state, x, train=train, attach=attach)

    def train_step(params, opt_state: torch.optim.Optimizer, state, x, y):
        nonlocal replicated
        y = torch.as_tensor(y, device=dev).long()
        opt_state.zero_grad(set_to_none=True)
        logits, new_state = apply(params, state, x, train=True)
        loss = F.cross_entropy(logits.float(), y)
        loss.backward()
        if mesh is not None:
            leaves = tree_leaves(params)
            grads = [p.grad for p in leaves]
            if replicated is None:
                replicated = tree_leaves(sharding.replicated_leaves(params, model_axis))
            collectives.replicate_grads([g for g, r in zip(grads, replicated) if r], mesh,
                                        model_axis)
            collectives.all_reduce_grads(grads, mesh, data_axis, mean=True)
            loss = collectives.all_reduce(loss.detach().clone(), mesh, data_axis) / dp
        opt_state.step()
        return params, opt_state, _map(lambda t, _p: t.detach(), new_state), loss.detach()

    train_step.device = dev
    train_step.mesh = mesh
    train_step.apply = apply
    return train_step


def init_sharded_training(model: ModelDef, mesh, seed: int = 0,
                          optimizer: Optional[Optimizer] = None, learning_rate: float = 1e-3,
                          device=None, init: Optional[tuple] = None):
    """``(train_step, params, opt_state, state)`` for this rank of the
    (data, model) ``mesh`` (``parallel.mesh.make_mesh``; a collective call
    when the mesh has more than one rank): ``params`` this rank's Megatron
    shard of the tree, trainable leaves on ``device`` (default ``cuda``,
    raising without a card; pass ``"cpu"`` for the CPU); ``opt_state`` the
    optimizer (default :func:`adamw`) over them; ``state`` replicated.
    ``init`` is the starting ``(params, state)`` (numpy trees in the JAX
    layout, e.g. storm_tpu's ``init_params(model, 0)`` as
    ``checkpoints_torch/<model>_init.npz`` holds it), by default the port's
    seeded ``init_params(model, seed)``. Run a step with
    :func:`train_one_step`; ``train_step.apply(params, state, x)`` is the
    sharded forward (an evaluation's)."""
    dev = resolve_device(device)
    data_axis, model_axis = mesh.axis_names
    tp = mesh.shape[model_axis]
    heads = model.hyper.get("num_heads")
    if tp > 1 and heads and heads % tp:
        raise ValueError(f"{heads} heads do not divide over a model axis of {tp}")
    if mesh.shape[data_axis] > 1 and "n_experts" in model.hyper:
        raise NotImplementedError(
            f"{model.name!r} over a data axis of {mesh.shape[data_axis]}: its routing's "
            f"capacity and load-balancing loss are the global batch's, which the port's "
            f"data-parallel step does not gather")
    params0, state0 = init if init is not None else init_params(model, seed)
    params0 = _map(lambda leaf, _p: np.asarray(leaf, np.float32), params0)
    if tp > 1:
        params0 = sharding.shard_params_tp(mesh, params0, model_axis)
    params = trainable_params(params0, dev)
    opt = optimizer or adamw(learning_rate)
    return _step(model, opt, dev, mesh), params, opt(params), state_tensors(state0, dev)


def train_one_step(train_step: Callable, mesh, params, opt_state, state, x: np.ndarray,
                   y: np.ndarray):
    """Run the step on the global batch ``x``, ``y`` (the same on every
    rank): this rank keeps its rows of the mesh's data axis
    (``sharding.shard_batch``), which the step places on its device. A
    step of :func:`make_train_step` runs on one rank only."""
    if getattr(train_step, "mesh", None) is None:
        if mesh.size > 1:
            raise ValueError(f"a make_train_step step runs on one rank, the mesh has "
                             f"{mesh.size}; init_sharded_training makes the mesh's step")
        return train_step(params, opt_state, state, x, y)
    data_axis = mesh.axis_names[0]
    return train_step(params, opt_state, state, sharding.shard_batch(mesh, x, data_axis),
                      sharding.shard_batch(mesh, y, data_axis))


def adam_moments(params, opt_state: torch.optim.Optimizer) -> Tuple[dict, dict]:
    """``(mu, nu)``: numpy trees of AdamW's first and second moments in
    ``params``' layout, optax's ``ScaleByAdamState.mu`` and ``.nu``."""
    def moment(key: str):
        return host_tree(_map(lambda leaf, _p: opt_state.state[leaf][key], params))

    return moment("exp_avg"), moment("exp_avg_sq")
