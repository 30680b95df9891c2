"""Model registry: name -> model function, the counterpart of
``storm_tpu/models/registry.py`` for the families the port serves
(``vit_b16`` and ``vit_tiny``).

A :class:`ModelDef` carries a family's hyperparameters, a seeded numpy
initializer producing parameters in the JAX package's layout, and the
constructor of its ``nn.Module``. :func:`build_model` puts the three
together on a device.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Callable, Dict, Optional

import numpy as np
import torch
from torch import nn

from storm_tpu_torch.device import resolve_device


@dataclass(frozen=True)
class ModelDef:
    """A model family instance.

    ``init(rng)`` returns a parameter tree of float32 numpy arrays laid
    out as the JAX package lays it out (so JAX parameters carry across
    unchanged); ``make(tree)`` builds the module from a tree of tensors
    prepared by :func:`storm_tpu_torch.models.convert.prepare_params`.
    ``hyper`` holds the hyperparameters that parameter shapes cannot
    recover (``num_heads`` above all)."""

    name: str
    input_shape: tuple  # per-instance (H, W, C)
    num_classes: int
    init: Callable[[np.random.RandomState], Any]
    make: Callable[[Any], nn.Module]
    hyper: Dict[str, Any]


_BUILDERS: Dict[str, Callable[..., ModelDef]] = {}


def register(name: str) -> Callable:
    def deco(fn: Callable[..., ModelDef]) -> Callable[..., ModelDef]:
        _BUILDERS[name] = fn
        return fn

    return deco


def _load_builtin() -> None:
    from storm_tpu_torch.models import vit  # noqa: F401  (registers)


def registry_names() -> list:
    _load_builtin()
    return sorted(_BUILDERS)


def model_def(name: str, **kwargs) -> ModelDef:
    """The :class:`ModelDef` of a registered family (``num_classes``,
    ``input_shape`` and family knobs as keyword arguments)."""
    _load_builtin()
    if name not in _BUILDERS:
        raise KeyError(f"unknown model {name!r}; available: {registry_names()}")
    return _BUILDERS[name](**kwargs)


def build_model(name: str, *, device: Optional[str] = None, params=None,
                seed: int = 0, weights: str = "float",
                dtype: torch.dtype = torch.bfloat16, **kwargs) -> nn.Module:
    """Build a registered model on ``device`` (default ``cuda``; pass
    ``"cpu"`` for the CPU). ``params`` is a numpy tree in the JAX layout
    (e.g. carried from storm_tpu); None initializes from ``seed``.
    ``weights`` is "float" or "int8_fused"; ``dtype`` the compute dtype."""
    from storm_tpu_torch.models.convert import from_jax_params, init_params

    dev = resolve_device(device)
    md = model_def(name, **kwargs)
    tree = init_params(md, seed) if params is None else params
    return from_jax_params(tree, md, weights=weights, dtype=dtype, device=dev)
