"""The port's CNN layers and the trained digits models against the JAX
package on the CPU.

Layers: conv2d (SAME at stride 1 and 2, k = 1, 3, 5), max_pool,
global_avg_pool and inference batchnorm against ``storm_tpu/ops/layers.py``
on seeded numpy inputs; float32 within 1e-5, bfloat16 within 1e-2 (both
relative to the largest |value|, at least 1).

Models: lenet5, resnet20 and vit_tiny from their exported checkpoints
(``checkpoints_torch/``) against storm_tpu's ``InferenceEngine`` on the
first 64 held-out rows, one batch of 64 as ``accuracy_harness`` runs it.
The JAX side is the engine's own output, recorded in
``checkpoints_torch/reference_predictions.npz`` by
``export_torch_checkpoints.py`` (``tests/test_torch_checkpoints.py`` holds
the record to a live engine); for int8_fused it is run live here, with its
w8a16 Pallas kernel in interpret mode, as on the TPU: the engine's CPU
fallback dequantizes the weights to bf16 before the product, where the
kernel (and the port's) scales the f32 accumulator.

Tolerances on the probabilities: float32 1e-5. The bfloat16 modes 1e-2,
except four cells with a bound of their own (``BOUND``): there the port's
distance from the recorded JAX result exceeds 1e-2 (XLA's fused CPU
program keeps bf16 intermediates and the dequantized int8 weights in f32,
where the port rounds each op's output as storm_tpu's model code
declares), and the bound is 1.25 times that distance, rounded up to
0.005, and below the JAX engine's own bf16-to-float32 distance on those
rows wherever that is above 0.02, so a port computing in float32 fails.
Every bfloat16 mode must also lie at least 1e-3 from the float32 result.
Rows whose top-2 JAX margin exceeds 0.02 must keep their argmax.
"""

import functools
import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import storm_tpu.ops.platform as jax_platform
import storm_tpu.ops.quant_matmul as jax_quant_matmul
from storm_tpu.config import BatchConfig as JaxBatchConfig
from storm_tpu.config import ModelConfig as JaxModelConfig
from storm_tpu.config import ShardingConfig
from storm_tpu.infer.engine import InferenceEngine as JaxEngine
from storm_tpu.ops import layers as JL
from storm_tpu_torch.config import BatchConfig, ModelConfig
from storm_tpu_torch.data import load_digits_nhwc
from storm_tpu_torch.infer.engine import InferenceEngine
from storm_tpu_torch.ops import layers as L
from tests.test_torch_checkpoints import abstract_init  # noqa: F401  (fixture)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
REFERENCE = os.path.join(ROOT, "checkpoints_torch", "reference_predictions.npz")
MODES = {"float32": {"dtype": "float32"}, "bf16": {}, "int8": {"weights": "int8"},
         "int8_fused": {"weights": "int8_fused"},
         "uint8_wire": {"transfer_dtype": "uint8"}}
ROWS = 64
MARGIN = 0.02
# The cells whose port-to-JAX distance (max |dp| on the 64 rows, CPU)
# exceeds 1e-2: resnet20 int8 0.0319, int8_fused 0.0280; vit_tiny bf16
# 0.0147, uint8_wire 0.0223. JAX's own bf16-to-float32 distance on those
# rows: 0.1167, 0.1140, 0.0230, 0.0246.
BOUND = {("resnet20_digits", "int8"): 0.04, ("resnet20_digits", "int8_fused"): 0.035,
         ("vit_tiny_digits", "bf16"): 0.02, ("vit_tiny_digits", "uint8_wire"): 0.03}


def _dtypes(name):
    return ((jnp.float32, torch.float32, 1e-5) if name == "float32"
            else (jnp.bfloat16, torch.bfloat16, 1e-2))


def _close(got: torch.Tensor, want, tol: float) -> None:
    want = np.asarray(want, np.float32)
    got = got.float().numpy()
    assert got.shape == want.shape
    assert np.abs(got - want).max() <= tol * max(1.0, np.abs(want).max())


# ---- layers -------------------------------------------------------------------


@pytest.mark.parametrize("size,k,stride", [(32, 3, 2), (16, 3, 2), (32, 3, 1),
                                           (15, 5, 2), (8, 1, 2), (7, 4, 3)])
def test_same_padding_is_xla_rule(size, k, stride):
    assert L.same_padding(size, k, stride) == tuple(
        jax.lax.padtype_to_pads((size,), (k,), (stride,), "SAME")[0])


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("k", [1, 3, 5])
@pytest.mark.parametrize("stride", [1, 2])
def test_conv2d_same(stride, k, dtype):
    jd, td, tol = _dtypes(dtype)
    rng = np.random.RandomState(10 * k + stride)
    x = rng.rand(2, 16, 15, 3).astype(np.float32)  # odd width: asymmetric pads
    w = (rng.randn(k, k, 3, 8) * 0.3).astype(np.float32)
    b = rng.randn(8).astype(np.float32)
    want = JL.conv2d({"w": jnp.asarray(w, jd), "b": jnp.asarray(b, jd)},
                     jnp.asarray(x, jd), stride=stride, padding="SAME")
    got = L.conv2d({"w": torch.from_numpy(w).permute(3, 2, 0, 1).to(td),
                    "b": torch.from_numpy(b).to(td)},
                   torch.from_numpy(x).to(td), stride=stride, padding="same")
    assert got.dtype == td
    _close(got, want, tol)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_pools(dtype):
    jd, td, tol = _dtypes(dtype)
    x = np.random.RandomState(1).randn(2, 9, 8, 4).astype(np.float32)  # odd H: VALID
    got = L.max_pool(torch.from_numpy(x).to(td))
    assert got.shape == (2, 4, 4, 4) and got.dtype == td
    _close(got, JL.max_pool(jnp.asarray(x, jd)), tol)
    got = L.global_avg_pool(torch.from_numpy(x).to(td))
    assert got.shape == (2, 4) and got.dtype == td
    _close(got, JL.global_avg_pool(jnp.asarray(x, jd)), tol)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_batchnorm_inference(dtype):
    jd, td, tol = _dtypes(dtype)
    rng = np.random.RandomState(2)
    x = rng.randn(3, 5, 5, 16).astype(np.float32) * 2
    scale, bias = rng.randn(16).astype(np.float32), rng.randn(16).astype(np.float32)
    mean, var = rng.randn(16).astype(np.float32), rng.rand(16).astype(np.float32) + 0.1
    want, _ = JL.batchnorm({"scale": jnp.asarray(scale, jd), "bias": jnp.asarray(bias, jd)},
                           {"mean": jnp.asarray(mean), "var": jnp.asarray(var)},
                           jnp.asarray(x, jd), train=False)
    state = {"mean": torch.from_numpy(mean), "var": torch.from_numpy(var)}
    got, new_state = L.batchnorm({"scale": torch.from_numpy(scale).to(td),
                                  "bias": torch.from_numpy(bias).to(td)},
                                 state, torch.from_numpy(x).to(td))
    assert got.dtype == td and new_state is state
    _close(got, want, tol)


# ---- whole models from the exported checkpoints --------------------------------


@pytest.fixture(scope="module")
def reference():
    with np.load(REFERENCE) as f:
        return {k: f[k] for k in f.files}


def _config(tag: str, mode: str) -> ModelConfig:
    return ModelConfig.from_checkpoint(f"checkpoints/{tag}", **MODES[mode])


def _port(tag: str, mode: str, x: np.ndarray) -> np.ndarray:
    eng = InferenceEngine(_config(tag, mode), BatchConfig(max_batch=ROWS, buckets=(ROWS,)),
                          device="cpu")
    return eng.predict(x)


def _jax_engine(tag: str, mode: str) -> JaxEngine:
    """storm_tpu's engine on ``checkpoints/<tag>`` in ``mode``."""
    cfg = _config(tag, mode)
    jcfg = JaxModelConfig(name=cfg.name, checkpoint=os.path.join(ROOT, "checkpoints", tag),
                          input_shape=cfg.input_shape, num_classes=cfg.num_classes,
                          **MODES[mode])
    return JaxEngine(jcfg, ShardingConfig(data_parallel=1),
                     JaxBatchConfig(max_batch=ROWS, buckets=(ROWS,)))


def _jax_kernel_path(tag: str, x: np.ndarray, monkeypatch) -> np.ndarray:
    """storm_tpu's engine in int8_fused with ``qdense`` on its Pallas
    w8a16 kernel, in interpret mode on the CPU."""
    monkeypatch.setattr(jax_platform, "use_pallas", lambda: True)
    monkeypatch.setattr(jax_quant_matmul, "w8a16_matmul",
                        functools.partial(jax_quant_matmul.w8a16_matmul, interpret=True))
    return np.asarray(_jax_engine(tag, "int8_fused").predict(x), np.float32)


TAGS = ("lenet5_digits", "resnet20_digits", "vit_tiny_digits")
CELLS = [(t, m) for t in ("lenet5_digits", "resnet20_digits") for m in MODES] + [
    ("vit_tiny_digits", "bf16"), ("vit_tiny_digits", "uint8_wire")]


@pytest.mark.parametrize("tag,mode", CELLS)
def test_model_matches_storm_tpu(tag, mode, reference, monkeypatch, abstract_init):
    x = load_digits_nhwc(_config(tag, mode).input_shape)[2][:ROWS]
    got = _port(tag, mode, x)
    if mode == "int8_fused":
        want = _jax_kernel_path(tag, x, monkeypatch)
    else:
        want = reference[f"{tag}/{mode}"][:ROWS]
    assert got.shape == (ROWS, 10) and got.dtype == np.float32
    np.testing.assert_allclose(got.sum(-1), 1.0, atol=1e-3)
    diff = np.abs(got - want).max()
    if mode == "float32":
        assert diff <= 1e-5
        return
    assert diff <= BOUND.get((tag, mode), 1e-2), diff
    assert np.abs(got - reference[f"{tag}/float32"][:ROWS]).max() >= 1e-3
    top2 = np.sort(want, axis=-1)[:, -2:]
    gated = top2[:, 1] - top2[:, 0] > MARGIN
    assert gated.sum() >= ROWS // 2
    assert (got.argmax(-1) == want.argmax(-1))[gated].all()


@pytest.mark.parametrize("tag", TAGS)
def test_float32_accuracy_equals_published(tag):
    """All 449 held-out rows in float32: the accuracy ACCURACY_r04.json
    records for the JAX package's float32 forward."""
    cfg = _config(tag, "float32")
    _, _, x, y = load_digits_nhwc(cfg.input_shape)
    probs = np.concatenate([_port(tag, "float32", x[i:i + ROWS])
                            for i in range(0, len(x), ROWS)])
    with open(os.path.join(ROOT, "ACCURACY_r04.json")) as f:
        published = {r["model"]: r["acc_float_device"] for r in json.load(f)["results"]}
    assert len(y) == 449
    assert round(float((probs.argmax(-1) == y).mean()), 4) == published[cfg.name]


def test_vit_tiny_int8_tie_is_storm_tpus_own_arithmetic(reference, abstract_init):
    """Held-out row 140, vit_tiny_digits in int8: the recorded JAX
    prediction gives class 6 by a margin of 0.036, but storm_tpu's own
    forward compiled without XLA's excess precision (each bf16 value
    rounded as the model code declares, where the CPU compiler otherwise
    keeps fused intermediates in f32) ties classes 5 and 6 exactly, and so
    does the port; the two agree in argmax on every row of the batch.
    chip_smoke.py counts such a row as a tie, not a flip."""
    x = load_digits_nhwc(_config("vit_tiny_digits", "int8").input_shape)[2][128:192]
    eng = _jax_engine("vit_tiny_digits", "int8")
    xd = jnp.asarray(x, eng.dtype)
    exact = eng._fwd.lower(eng.params, eng.state, xd).compile(
        compiler_options={"xla_allow_excess_precision": False})
    want = np.asarray(exact(eng.params, eng.state, xd), np.float32)
    got = _port("vit_tiny_digits", "int8", x)
    recorded = reference["vit_tiny_digits/int8"][140]
    assert np.array_equal(np.asarray(eng.predict(x), np.float32)[140 - 128], recorded)
    assert recorded.argmax() == 6 and np.sort(recorded)[-1] - np.sort(recorded)[-2] > MARGIN
    for p in (want[140 - 128], got[140 - 128]):
        assert p[5] == p[6] == p.max()
    assert (got.argmax(-1) == want.argmax(-1)).all()
