#!/usr/bin/env python
"""Export the trained digits checkpoints for the PyTorch port.

    JAX_PLATFORMS=cpu python export_torch_checkpoints.py

The port (``storm_tpu_torch``) runs where neither JAX, orbax nor
scikit-learn is installed, so it cannot read the orbax checkpoints under
``checkpoints/`` or the digits dataset. This script runs once on a host
that has all three and writes plain numpy files the port reads:

- ``<tag>.npz`` per checkpoint tag: every leaf of ``params`` and
  ``state`` as ``storm_tpu.models.registry.load_or_init`` restores it, in
  float32, keyed by its tree path (``params/stages/1/0/a/conv/w``,
  ``state/stem/bn/mean``; an all-digit component is a list index), plus
  ``__meta__``, a JSON string with the model name, input shape, class
  count, the hyper sidecar's contents (where the directory has one) and
  the source directory;
- ``<model>_init.npz`` for the four digits models (lenet5 at 32x32x1,
  resnet20, vit_tiny and moe_vit_tiny at 32x32x3): storm_tpu's
  ``init_params(model, 0)``, the parameters ``train_to_convergence``
  starts from, in the same layout, so the port trains on the card from
  storm_tpu's own start;
- ``digits.npz``: scikit-learn's 1797 raw 8x8 digit images as uint8
  (0..16) and their labels, in scikit-learn's order;
- ``reference_predictions.npz``: storm_tpu's ``InferenceEngine``
  probabilities on the 449 held-out rows for each tag and mode (bf16,
  int8, int8_fused, uint8_wire, and the engine in float32), in slices of
  64 with ``BatchConfig(max_batch=64, buckets=(64,))`` as
  ``accuracy_harness.engine_accuracy`` runs them, under ``<tag>/<mode>``,
  with the accuracy under ``<tag>/<mode>/acc``; the float32 forward's
  accuracy (``accuracy_harness.train_or_load``'s) under ``<tag>/float/acc``.

It prints each pair's accuracy, flagging any that differs from
``ACCURACY_r04.json``, and how far each bf16 mode's probabilities lie from
the float32 engine's (max |dp| over the 449 rows): the distance bf16
rounding alone puts between two results of the JAX package.
This is not part of the port: it is the one place that reads orbax.
"""

from __future__ import annotations

import json
import os
import sys

import numpy as np

REPO = os.path.dirname(os.path.abspath(__file__))
OUT = os.path.join(REPO, "checkpoints_torch")
sys.path.insert(0, REPO)

# tag -> (registry name, input shape): accuracy_harness.MODEL_SPECS, and its
# CASCADE_SHAPE for the 3-channel lenet5 of the cascade tier.
TAGS = {
    "lenet5_digits": ("lenet5", (32, 32, 1)),
    "lenet5_rgb_digits": ("lenet5", (32, 32, 3)),
    "resnet20_digits": ("resnet20", (32, 32, 3)),
    "vit_tiny_digits": ("vit_tiny", (32, 32, 3)),
    "moe_vit_tiny_digits": ("moe_vit_tiny", (32, 32, 3)),
}
# The single-device serving modes of accuracy_harness.MODEL_SPECS (bfloat16
# compute), and the float32 engine the tests hold the port's float32 to.
MODES = ("bf16", "int8", "int8_fused", "uint8_wire", "float32")
# <model>_init.npz: storm_tpu's init_params(model, 0) of accuracy_harness's
# four trained models (MODEL_SPECS), at their input shapes.
INIT_MODELS = {"lenet5": (32, 32, 1), "resnet20": (32, 32, 3), "vit_tiny": (32, 32, 3),
               "moe_vit_tiny": (32, 32, 3)}
NUM_CLASSES = 10
SLICE = 64


def _path_key(path) -> str:
    parts = []
    for k in path:
        parts.append(str(k.key) if hasattr(k, "key") else str(k.idx))
    return "/".join(parts)


def flatten(params, state) -> dict:
    """``{"params/...": f32 array, "state/...": f32 array}``."""
    import jax

    leaves = jax.tree_util.tree_flatten_with_path({"params": params, "state": state})[0]
    return {_path_key(p): np.asarray(v, np.float32) for p, v in leaves}


def restore(tag: str):
    """(params, state, model) of ``checkpoints/<tag>`` through storm_tpu."""
    from storm_tpu.models.registry import build_model, load_or_init

    name, shape = TAGS[tag]
    model = build_model(name, num_classes=NUM_CLASSES, input_shape=shape)
    params, state = load_or_init(model, os.path.join(REPO, "checkpoints", tag))
    return params, state, model


def meta_of(tag: str) -> dict:
    name, shape = TAGS[tag]
    src = os.path.join("checkpoints", tag)
    sidecar = os.path.join(REPO, src, "storm_tpu_hyper.json")
    hyper = None
    if os.path.exists(sidecar):
        with open(sidecar) as f:
            hyper = json.load(f)
    return {"model": name, "input_shape": list(shape), "num_classes": NUM_CLASSES,
            "hyper": hyper, "source": src}


def export_init(name: str, shape: tuple) -> None:
    """``<name>_init.npz``: storm_tpu's ``init_params(model, 0)``, with the
    ``__meta__`` its ``save_checkpoint`` sidecar would record."""
    from storm_tpu.models.registry import build_model, init_params

    model = build_model(name, num_classes=NUM_CLASSES, input_shape=shape)
    params, state = init_params(model, 0)
    arrays = flatten(params, state)
    hyper = {"model": name, **model.hyper} if model.hyper is not None else None
    meta = {"model": name, "input_shape": list(shape), "num_classes": NUM_CLASSES,
            "hyper": json.loads(json.dumps(hyper)), "source": "init_params(model, 0)"}
    np.savez_compressed(os.path.join(OUT, f"{name}_init.npz"),
                        __meta__=np.array(json.dumps(meta)), **arrays)
    print(f"{name}_init: {len(arrays)} arrays, "
          f"{sum(a.size for a in arrays.values())} floats", flush=True)


def mode_config(mode: str, tag: str):
    from storm_tpu.config import ModelConfig

    name, shape = TAGS[tag]
    kw = {"uint8_wire": {"transfer_dtype": "uint8"}, "int8": {"weights": "int8"},
          "int8_fused": {"weights": "int8_fused"}, "bf16": {},
          "float32": {"dtype": "float32"}}[mode]
    return ModelConfig(name=name, checkpoint=os.path.join(REPO, "checkpoints", tag),
                       input_shape=shape, num_classes=NUM_CLASSES, **kw)


def engine_predictions(model_cfg, x_te: np.ndarray) -> np.ndarray:
    from storm_tpu.config import BatchConfig, ShardingConfig
    from storm_tpu.infer.engine import InferenceEngine

    eng = InferenceEngine(model_cfg, ShardingConfig(data_parallel=1),
                          BatchConfig(max_batch=SLICE, buckets=(SLICE,)))
    return np.concatenate([np.asarray(eng.predict(x_te[i:i + SLICE].astype(np.float32)),
                                      np.float32)
                           for i in range(0, len(x_te), SLICE)])


def float_accuracy(params, state, model, x_te, y_te) -> float:
    import jax
    import jax.numpy as jnp

    @jax.jit
    def fwd(x):
        return model.apply(params, state, x, train=False)[0]

    preds = np.concatenate([np.asarray(fwd(jnp.asarray(x_te[i:i + 128])))
                            for i in range(0, len(x_te), 128)])
    return float((preds.argmax(-1) == y_te).mean())


def published_accuracies() -> dict:
    path = os.path.join(REPO, "ACCURACY_r04.json")
    with open(path) as f:
        doc = json.load(f)
    out = {}
    for r in doc["results"]:
        out[(f"{r['model']}_digits", r["mode"])] = r["acc_engine_device"]
        out[(f"{r['model']}_digits", "float")] = r["acc_float_device"]
    return out


def main() -> int:
    os.makedirs(OUT, exist_ok=True)

    from sklearn.datasets import load_digits

    from storm_tpu.data import load_digits_nhwc

    d = load_digits()
    np.savez_compressed(os.path.join(OUT, "digits.npz"),
                        images=d.images.astype(np.uint8), labels=d.target.astype(np.int32))

    published = published_accuracies()
    refs = {}
    for tag in TAGS:
        params, state, model = restore(tag)
        arrays = flatten(params, state)
        meta = meta_of(tag)
        np.savez_compressed(os.path.join(OUT, f"{tag}.npz"),
                            __meta__=np.array(json.dumps(meta)), **arrays)
        print(f"{tag}: {len(arrays)} arrays, "
              f"{sum(a.size for a in arrays.values())} floats", flush=True)
        _, _, x_te, y_te = load_digits_nhwc(tuple(meta["input_shape"]), seed=0)
        accs = {"float": float_accuracy(params, state, model, x_te, y_te)}
        refs[f"{tag}/float/acc"] = np.float64(accs["float"])
        for mode in MODES:
            probs = engine_predictions(mode_config(mode, tag), x_te)
            accs[mode] = float((probs.argmax(-1) == y_te).mean())
            refs[f"{tag}/{mode}"] = probs
            refs[f"{tag}/{mode}/acc"] = np.float64(accs[mode])
        for mode, acc in accs.items():
            want = published.get((tag, mode))
            flag = ""
            if want is not None and round(acc, 4) != round(want, 4):
                flag = f"  DIFFERS from ACCURACY_r04.json ({want:.4f})"
            if mode not in ("float", "float32"):
                dp = np.abs(refs[f"{tag}/{mode}"] - refs[f"{tag}/float32"]).max()
                flag = f"; max |dp| from float32 {dp:.4f}" + flag
            print(f"  {tag} {mode:10s} accuracy {acc:.4f}{flag}", flush=True)
    np.savez_compressed(os.path.join(OUT, "reference_predictions.npz"), **refs)
    for name, shape in INIT_MODELS.items():
        export_init(name, shape)
    return 0


if __name__ == "__main__":
    sys.exit(main())
