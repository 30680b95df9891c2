"""The training step, the counterpart of ``storm_tpu/parallel/train.py``
(``make_train_step``, ``train_one_step``) on one device.

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

The dp x tp mesh of ``init_sharded_training`` waits for the parallel
paths.
"""

from __future__ import annotations

from typing import Callable, Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from storm_tpu_torch.device import resolve_device
from storm_tpu_torch.models.convert import _map, host_tree, tree_leaves
from storm_tpu_torch.models.registry import ModelDef

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

    def train_step(params, opt_state: torch.optim.Optimizer, state, x, y):
        x = torch.as_tensor(x, dtype=torch.float32, device=dev)
        y = torch.as_tensor(y, device=dev).long()
        opt_state.zero_grad(set_to_none=True)
        logits, new_state = model.apply(params, state, x, train=True)
        loss = F.cross_entropy(logits.float(), y)
        loss.backward()
        opt_state.step()
        return params, opt_state, _map(lambda t, _p: t.detach(), new_state), loss.detach()

    train_step.device = dev
    return train_step, opt


def train_one_step(train_step: Callable, params, opt_state, state, x: np.ndarray,
                   y: np.ndarray):
    """Run the step on one (x, y) batch, which the step places on its
    device (storm_tpu's places it on the mesh, which waits for the
    parallel paths)."""
    return train_step(params, opt_state, state, x, y)


def adam_moments(params, opt_state: torch.optim.Optimizer) -> Tuple[dict, dict]:
    """``(mu, nu)``: numpy trees of AdamW's first and second moments in
    ``params``' layout, optax's ``ScaleByAdamState.mu`` and ``.nu``."""
    def moment(key: str):
        return host_tree(_map(lambda leaf, _p: opt_state.state[leaf][key], params))

    return moment("exp_avg"), moment("exp_avg_sq")
