"""Model registry: name -> model function, the counterpart of
``storm_tpu/models/registry.py`` for the single-device families the port
serves (``vit_b16``, ``vit_tiny``, ``moe_vit_b16``, ``moe_vit_tiny``,
``mixer_s16``, ``mixer_tiny``, ``mobilenetv2``, ``lenet5``, ``resnet20``,
``resnet50``, ``longseq_encoder``, ``longseq_tiny`` and ``char_tiny``), and
the loading of exported checkpoints.

A :class:`ModelDef` carries a family's hyperparameters, a seeded numpy
initializer producing parameters and state in the JAX package's layout,
and the constructor of its ``nn.Module``. :func:`build_model` puts the
three together on a device. :func:`load_checkpoint` reads a checkpoint
that ``export_torch_checkpoints.py`` wrote from the JAX package's orbax
directories, and :func:`check_checkpoint` refuses one that does not fit
the model.
"""

from __future__ import annotations

import json
from dataclasses import dataclass
from pathlib import Path
from typing import Any, Callable, Dict, Optional, Tuple

import numpy as np
import torch
from torch import nn

from storm_tpu_torch.device import resolve_device

# Exported checkpoints live here, one ``<tag>.npz`` per orbax directory
# ``checkpoints/<tag>`` of the JAX package.
CHECKPOINTS = Path(__file__).resolve().parents[2] / "checkpoints_torch"


@dataclass(frozen=True)
class ModelDef:
    """A model family instance.

    ``init(rng)`` returns ``(params, state)``, trees of float32 numpy
    arrays laid out as the JAX package lays them out (so JAX parameters
    carry across unchanged); ``state`` holds BatchNorm running statistics
    and is ``{}`` for stateless families. ``make(params, state)`` builds
    the module from trees of tensors prepared by
    :func:`storm_tpu_torch.models.convert.prepare_params` and
    ``prepare_state``. ``hyper`` holds the input shape, the class count
    and the hyperparameters that parameter shapes cannot recover
    (``num_heads`` above all), checked against a checkpoint's record."""

    name: str
    input_shape: tuple  # per-instance: (H, W, C), or (seq, features) for longseq
    num_classes: int
    init: Callable[[np.random.RandomState], Tuple[Any, Any]]
    make: Callable[[Any, Any], nn.Module]
    hyper: Dict[str, Any]

    def apply(self, params, state, x: torch.Tensor, train: bool = False):
        """``(logits, new_state)``: :func:`storm_tpu_torch.models.convert.apply`."""
        from storm_tpu_torch.models.convert import apply

        return apply(self, params, state, x, train)


_BUILDERS: Dict[str, Callable[..., ModelDef]] = {}


def register(name: str) -> Callable:
    def deco(fn: Callable[..., ModelDef]) -> Callable[..., ModelDef]:
        _BUILDERS[name] = fn
        return fn

    return deco


def _load_builtin() -> None:
    from storm_tpu_torch.models import (  # noqa: F401  (registers)
        chartiny, lenet, longseq, mixer, mobilenet, moe_vit, resnet, vit)


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
                state=None, seed: int = 0, weights: str = "float",
                dtype: torch.dtype = torch.bfloat16, **kwargs) -> nn.Module:
    """Build a registered model on ``device`` (default ``cuda``; pass
    ``"cpu"`` for the CPU). ``params`` and ``state`` are numpy trees in the
    JAX layout (e.g. from :func:`load_checkpoint`); ``params`` None
    initializes both from ``seed``. ``weights`` is "float", "int8" or
    "int8_fused"; ``dtype`` the compute dtype."""
    from storm_tpu_torch.models.convert import from_jax_params, init_params

    dev = resolve_device(device)
    md = model_def(name, **kwargs)
    if params is None:
        params, state = init_params(md, seed)
    return from_jax_params(params, md, state, weights=weights, dtype=dtype, device=dev)


# ---- exported checkpoints ----------------------------------------------------


def checkpoint_path(checkpoint: str) -> Path:
    """The ``.npz`` file a ``ModelConfig.checkpoint`` names: either a path
    ending in ``.npz``, as given, or the JAX package's orbax directory
    spelled ``checkpoints/<tag>`` (relative), which maps to
    ``checkpoints_torch/<tag>.npz`` of this repository. Any other name is
    refused: the port reads no orbax directory, and
    ``export_torch_checkpoints.py`` exports one to ``.npz``."""
    p = Path(checkpoint)
    if p.suffix == ".npz":
        path = p
    elif not p.is_absolute() and len(p.parts) == 2 and p.parts[0] == "checkpoints":
        path = CHECKPOINTS / f"{p.parts[1]}.npz"
    else:
        raise ValueError(
            f"checkpoint {checkpoint!r} is neither a .npz file nor "
            "checkpoints/<tag>; export an orbax checkpoint with "
            "export_torch_checkpoints.py and name the .npz it writes")
    if not path.exists():
        raise FileNotFoundError(
            f"no exported checkpoint at {path} for {checkpoint!r}; "
            "export_torch_checkpoints.py writes checkpoints_torch/ from the "
            "JAX package's orbax checkpoints")
    return path.resolve()


def _flatten(tree, prefix: str) -> Dict[str, np.ndarray]:
    """``{"params/a/0/b": f32 array}``: the inverse of :func:`_unflatten`."""
    if isinstance(tree, dict):
        items = tree.items()
    elif isinstance(tree, (list, tuple)):
        items = ((str(i), v) for i, v in enumerate(tree))
    else:
        return {prefix: np.asarray(tree, np.float32)}
    out: Dict[str, np.ndarray] = {}
    for k, v in items:
        out.update(_flatten(v, f"{prefix}/{k}"))
    return out


def save_checkpoint(path, params, state, model: ModelDef) -> Path:
    """Write ``params`` and ``state`` (numpy trees in the JAX layout, e.g.
    from ``train_to_convergence``) to the ``.npz`` file ``path`` in the
    layout ``export_torch_checkpoints.py`` writes: float32 leaves keyed by
    tree path and ``__meta__`` with the model's name, input shape, class
    count and hyperparameters, so :func:`load_checkpoint`,
    :func:`check_checkpoint` and ``ModelConfig.from_checkpoint`` read it.
    Written to a private name, then renamed. Returns the path."""
    path = Path(path)
    if path.suffix != ".npz":
        raise ValueError(f"a checkpoint is a .npz file, got {str(path)!r}")
    meta = {"model": model.name, "input_shape": list(model.input_shape),
            "num_classes": model.num_classes,
            "hyper": json.loads(json.dumps({"model": model.name, **model.hyper})),
            "source": str(path)}
    arrays = {**_flatten(params, "params"), **_flatten(state or {}, "state")}
    path.parent.mkdir(parents=True, exist_ok=True)
    tmp = path.with_name(f".{path.name}.tmp.npz")
    np.savez_compressed(tmp, __meta__=np.array(json.dumps(meta)), **arrays)
    tmp.replace(path)
    return path


def checkpoint_meta(checkpoint: str) -> Dict[str, Any]:
    """The record an export keeps beside the arrays: model name, input
    shape, class count, hyperparameters and source directory."""
    with np.load(checkpoint_path(checkpoint)) as f:
        return json.loads(str(f["__meta__"]))


def _unflatten(flat: Dict[str, np.ndarray]):
    """``{"a/0/b": x}`` -> ``{"a": [{"b": x}]}``: '/'-separated tree paths,
    all-digit components being list indices."""
    root: Dict[str, Any] = {}
    for key, arr in flat.items():
        node = root
        *parents, leaf = key.split("/")
        for part in parents:
            node = node.setdefault(part, {})
        node[leaf] = arr

    def listify(node):
        if not isinstance(node, dict):
            return node
        node = {k: listify(v) for k, v in node.items()}
        if node and all(k.isdigit() for k in node):
            return [node[str(i)] for i in range(len(node))]
        return node

    return listify(root)


def load_checkpoint(checkpoint: str) -> Tuple[Any, Any, Dict[str, Any]]:
    """``(params, state, meta)`` of an exported checkpoint (see
    :func:`checkpoint_path`): float32 numpy trees in the JAX layout, and
    the record of what was exported (model, input shape, class count,
    hyperparameters, source directory)."""
    with np.load(checkpoint_path(checkpoint)) as f:
        meta = json.loads(str(f["__meta__"]))
        flat = {k: f[k] for k in f.files if k != "__meta__"}
    tree = _unflatten(flat)
    return tree.get("params", {}), tree.get("state", {}), meta


def _canon(v):
    # JSON gives lists where the model has tuples.
    return list(v) if isinstance(v, tuple) else v


def _shapes(tree, prefix: str = "") -> Dict[str, tuple]:
    if isinstance(tree, dict):
        items = tree.items()
    elif isinstance(tree, (list, tuple)):
        items = ((str(i), v) for i, v in enumerate(tree))
    else:
        return {prefix: tuple(np.shape(tree))}
    out: Dict[str, tuple] = {}
    for k, v in items:
        out.update(_shapes(v, f"{prefix}/{k}" if prefix else str(k)))
    return out


def check_checkpoint(model: ModelDef, params, state, meta: Dict[str, Any],
                     checkpoint: str) -> None:
    """Refuse a checkpoint that does not fit ``model``, the counterpart of
    ``storm_tpu/models/registry.py:_check_hyper`` and of orbax's restore
    against the model's own tree: the recorded model name, input shape,
    class count and hyperparameters (``num_heads`` cannot be seen in the
    parameter shapes) must equal the model's, and every parameter and
    state array must be there with the model's shape. The error names
    each disagreement."""
    recorded = {"model": meta.get("model"), "input_shape": meta.get("input_shape"),
                "num_classes": meta.get("num_classes"), **(meta.get("hyper") or {})}
    ours = {"model": model.name, **model.hyper}
    mismatches = {k: (recorded[k], v) for k, v in ours.items()
                  if recorded.get(k) is not None and _canon(recorded[k]) != _canon(v)}
    if mismatches:
        detail = ", ".join(f"{k}: checkpoint={s!r} model={m!r}"
                           for k, (s, m) in sorted(mismatches.items()))
        raise ValueError(
            f"checkpoint {checkpoint!r} was saved with different "
            f"hyperparameters than model {model.name!r} ({detail}); build the "
            "model with the checkpoint's (ModelConfig.input_shape, "
            "num_classes, extra)")
    want_p, want_s = model.init(np.random.RandomState(0))
    want = {**_shapes({"params": want_p}), **_shapes({"state": want_s})}
    got = {**_shapes({"params": params}), **_shapes({"state": state})}
    bad = sorted(k for k in want.keys() | got.keys() if want.get(k) != got.get(k))
    if bad:
        detail = ", ".join(f"{k}: checkpoint={got.get(k)} model={want.get(k)}"
                           for k in bad[:5])
        raise ValueError(f"checkpoint {checkpoint!r} does not fit model "
                         f"{model.name!r}: {len(bad)} arrays differ ({detail})")
