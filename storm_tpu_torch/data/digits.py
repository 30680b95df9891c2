"""The handwritten digits and the convergence trainer, the counterpart of
``storm_tpu/data/digits.py`` (:func:`load_digits_nhwc`,
:func:`train_to_convergence`).

The JAX package reads scikit-learn's bundled digits set (1797 real 8x8
scans, values 0..16). The port reads the same images from
``checkpoints_torch/digits.npz``, written by ``export_torch_checkpoints.py``
(uint8 images and int32 labels in scikit-learn's order), and prepares them
exactly as the JAX package does, so both give the same arrays bit for bit.

The trainer is storm_tpu's loop over the port's
:func:`storm_tpu_torch.parallel.train.make_train_step`, on the card unless
the caller passes ``device="cpu"``.
"""

from __future__ import annotations

import logging
from typing import Optional, Tuple

import numpy as np
import torch

from storm_tpu_torch.models.convert import (
    host_tree, init_params, state_tensors, trainable_params)
from storm_tpu_torch.models.registry import CHECKPOINTS, ModelDef
from storm_tpu_torch.parallel.train import make_train_step, train_one_step

log = logging.getLogger("storm_tpu_torch.data")
# Rows of one evaluation forward, as storm_tpu evaluates.
EVAL_SLICE = 512


def load_digits_nhwc(
    input_shape: Tuple[int, int, int] = (32, 32, 1),
    test_fraction: float = 0.25,
    seed: int = 0,
) -> Tuple[np.ndarray, np.ndarray, np.ndarray, np.ndarray]:
    """(x_train, y_train, x_test, y_test): float32 NHWC in [0, 1], int32
    labels. Each 8x8 image is upscaled by pixel replication to the nearest
    multiple of 8 <= (H, W), zero-padded to (H, W) and its channel
    replicated C times; rows are shuffled by
    ``np.random.default_rng(seed).permutation`` and the first
    ``int(n * test_fraction)`` form the test split."""
    h, w, c = input_shape
    with np.load(CHECKPOINTS / "digits.npz") as f:
        imgs = f["images"].astype(np.float32) / 16.0  # (N, 8, 8) in [0, 1]
        labels = f["labels"].astype(np.int32)

    kh, kw = max(1, h // 8), max(1, w // 8)
    imgs = np.repeat(np.repeat(imgs, kh, axis=1), kw, axis=2)
    ph, pw = h - imgs.shape[1], w - imgs.shape[2]
    if ph or pw:
        imgs = np.pad(imgs, ((0, 0), (ph // 2, ph - ph // 2), (pw // 2, pw - pw // 2)))
    x = np.repeat(imgs[..., None], c, axis=-1)  # (N, H, W, C)

    order = np.random.default_rng(seed).permutation(len(x))
    x, labels = x[order], labels[order]
    n_test = int(len(x) * test_fraction)
    return x[n_test:], labels[n_test:], x[:n_test], labels[:n_test]


def train_to_convergence(
    model: ModelDef,
    x_train: np.ndarray,
    y_train: np.ndarray,
    x_val: Optional[np.ndarray] = None,
    y_val: Optional[np.ndarray] = None,
    batch_size: int = 128,
    max_epochs: int = 60,
    learning_rate: float = 1e-3,
    patience: int = 8,
    seed: int = 0,
    device=None,
    init: Optional[tuple] = None,
):
    """Train ``model`` until the held-out accuracy stops improving;
    returns ``(params, state, history)`` with numpy trees in the JAX layout
    (ready for :func:`storm_tpu_torch.models.registry.save_checkpoint`)
    and one ``{"epoch", "loss", "val_acc"}`` a epoch.

    storm_tpu's loop: each epoch ``default_rng(seed)``'s next permutation
    of the rows, the last partial batch dropped; the held-out accuracy in
    forwards of EVAL_SLICE rows; a new best when it beats the best by
    more than 1e-4, a stop after ``patience`` epochs without one; the best
    epoch's snapshot returned (the last epoch's without ``x_val``), its
    state only what ``model.init`` declares (no ``moe_aux_loss``).
    ``init`` is the starting ``(params, state)`` (numpy trees), by default
    the port's seeded ``init_params(model, seed)``; ``device`` defaults to
    ``cuda`` (pass ``"cpu"`` for the CPU)."""
    train_step, opt = make_train_step(model, learning_rate=learning_rate, device=device)
    dev = train_step.device
    params0, state0 = init if init is not None else init_params(model, seed)
    params = trainable_params(params0, dev)
    state = state_tensors(state0, dev)
    opt_state = opt(params)

    def accuracy(params, state, x, y) -> float:
        preds = []
        with torch.no_grad():
            for i in range(0, len(x), EVAL_SLICE):
                xb = torch.as_tensor(np.asarray(x[i:i + EVAL_SLICE], np.float32), device=dev)
                logits, _ = model.apply(params, state, xb, train=False)
                preds.append(logits.argmax(-1).cpu().numpy())
        return float((np.concatenate(preds) == y).mean())

    def persistable(st):
        return {k: v for k, v in st.items() if k in state0}

    rng = np.random.default_rng(seed)
    history = []
    best_acc, best_snapshot, stale = -1.0, None, 0
    n = len(x_train)
    for epoch in range(max_epochs):
        order = rng.permutation(n)
        losses = []
        for i in range(0, n - batch_size + 1, batch_size):
            idx = order[i:i + batch_size]
            params, opt_state, state, loss = train_one_step(
                train_step, params, opt_state, state, x_train[idx], y_train[idx])
            losses.append(float(loss))
        val_acc = (accuracy(params, state, x_val, y_val)
                   if x_val is not None else float("nan"))
        history.append({"epoch": epoch, "loss": float(np.mean(losses)), "val_acc": val_acc})
        log.info("epoch %d loss %.4f val_acc %.4f", epoch, history[-1]["loss"], val_acc)
        if x_val is None:
            continue
        if val_acc > best_acc + 1e-4:
            best_acc, stale = val_acc, 0
            best_snapshot = (host_tree(params), host_tree(persistable(state)))
        else:
            stale += 1
            if stale >= patience:
                break
    if best_snapshot is not None:
        return best_snapshot[0], best_snapshot[1], history
    return host_tree(params), host_tree(persistable(state)), history
