"""The handwritten digits, the counterpart of ``storm_tpu/data/digits.py``'s
:func:`load_digits_nhwc`.

The JAX package reads scikit-learn's bundled digits set (1797 real 8x8
scans, values 0..16). The port reads the same images from
``checkpoints_torch/digits.npz``, written by ``export_torch_checkpoints.py``
(uint8 images and int32 labels in scikit-learn's order), and prepares them
exactly as the JAX package does, so both give the same arrays bit for bit.
"""

from __future__ import annotations

from typing import Tuple

import numpy as np

from storm_tpu_torch.models.registry import CHECKPOINTS


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
