"""The port's ViT and engine against the JAX package's on the CPU.

vit_tiny parameters come from storm_tpu's own initializer and are carried
across with ``from_jax_params``; the port's engine (``device="cpu"``) and
storm_tpu's ``InferenceEngine`` then classify the same numpy batch.

Tolerances on the output probabilities: 1e-5 in float32. 1e-2 in bfloat16,
because the two sides round at different places: storm_tpu's CPU ``qdense``
dequantizes ``q * s`` in bf16 before the product
(storm_tpu/ops/quant_matmul.py:130-132), while the port, like the TPU
kernel, scales the f32 accumulator; likewise its CPU attention and residual
add round their intermediates to bf16 where the kernels keep f32.
"""

import jax
import numpy as np
import pytest
import torch

from storm_tpu.config import BatchConfig as JaxBatchConfig
from storm_tpu.config import ModelConfig as JaxModelConfig
from storm_tpu.config import ShardingConfig
from storm_tpu.infer.engine import InferenceEngine as JaxEngine
from storm_tpu.infer.engine import quantize_params as jax_quantize_params
from storm_tpu.models.registry import build_model as jax_build_model
from storm_tpu.models.registry import init_params as jax_init_params
from storm_tpu_torch.config import BatchConfig, ModelConfig
from storm_tpu_torch.infer.engine import InferenceEngine, clear_engines, shared_engine
from storm_tpu_torch.models import build_model, model_def
from storm_tpu_torch.models.convert import from_jax_params, quantize_params

SHAPE = (32, 32, 3)


@pytest.fixture(scope="module")
def jax_params():
    model = jax_build_model("vit_tiny", num_classes=10, input_shape=SHAPE)
    params, _ = jax_init_params(model, seed=0)
    return jax.tree.map(np.asarray, params)


@pytest.mark.parametrize("dtype,weights,tol", [
    ("float32", "float", 1e-5),
    ("float32", "int8_fused", 1e-5),
    ("bfloat16", "int8_fused", 1e-2),
])
def test_engine_matches_storm_tpu(jax_params, dtype, weights, tol):
    x = np.random.RandomState(0).rand(5, *SHAPE).astype(np.float32)
    jcfg = JaxModelConfig(name="vit_tiny", dtype=dtype, num_classes=10,
                          input_shape=SHAPE, weights=weights)
    want = JaxEngine(jcfg, ShardingConfig(data_parallel=1),
                     JaxBatchConfig(max_batch=8, buckets=(8,))).predict(x)
    cfg = ModelConfig(name="vit_tiny", dtype=dtype, num_classes=10,
                      input_shape=SHAPE, weights=weights)
    got = InferenceEngine(cfg, BatchConfig(max_batch=8, buckets=(8,)),
                          device="cpu", params=jax_params).predict(x)
    assert got.shape == (5, 10) and got.dtype == np.float32
    np.testing.assert_allclose(got.sum(-1), 1.0, atol=1e-5)
    assert np.abs(got - np.asarray(want, np.float32)).max() <= tol


def test_quantize_params_bit_identical(jax_params):
    ours = quantize_params(jax_params)
    theirs = jax.tree.map(np.asarray, jax_quantize_params(jax_params))
    flat_o = jax.tree_util.tree_flatten_with_path(ours)[0]
    flat_t = jax.tree_util.tree_flatten_with_path(theirs)[0]
    assert [p for p, _ in flat_o] == [p for p, _ in flat_t]
    for (path, a), (_, b) in zip(flat_o, flat_t):
        assert a.dtype == b.dtype and np.array_equal(a, b), path
    # every >=2-D float leaf is quantized: cls, pos and the conv kernel too
    for key in ("cls", "pos"):
        assert set(ours[key]) == {"__q", "__s"}
    assert ours["embed"]["w"]["__q"].shape == (8, 8, 3, 64)


def test_int8_fused_keeps_only_dense_weights_int8(jax_params):
    md = model_def("vit_tiny")
    m = from_jax_params(jax_params, md, weights="int8_fused", dtype=torch.bfloat16,
                        device="cpu")
    ints = {k for k, v in m.state_dict().items() if v.dtype == torch.int8}
    # 4 projections + 2 MLP per block, 2 blocks, and the head
    assert len(ints) == 4 * 2 + 2 * 2 + 1
    assert all(k.endswith(".q") for k in ints)
    assert m.embed_w.dtype == m.pos.dtype == m.cls.dtype == torch.bfloat16
    assert m.embed_w.shape == (64, 3, 8, 8)  # HWIO -> OIHW
    assert m.head.s.dtype == torch.float32


def test_unported_configurations_raise():
    """The three configurations that once raised (int8 weights, the uint8
    wire, a checkpoint) now build on the CPU and serve; an unknown weight
    mode or wire dtype still raises."""
    x = np.random.RandomState(3).rand(2, *SHAPE).astype(np.float32)
    for kw in ({"weights": "int8"}, {"transfer_dtype": "uint8"},
               {"checkpoint": "checkpoints/vit_tiny_digits"}):
        cfg = ModelConfig(name="vit_tiny", input_shape=SHAPE, num_classes=10, **kw)
        out = InferenceEngine(cfg, BatchConfig(max_batch=4, buckets=(4,)),
                              device="cpu").predict(x)
        assert out.shape == (2, 10) and np.isfinite(out).all()
    m = build_model("vit_tiny", device="cpu", weights="int8")
    assert not any(v.dtype == torch.int8 for v in m.state_dict().values())
    with pytest.raises(ValueError, match="weights"):
        ModelConfig(name="vit_tiny", weights="int4")
    with pytest.raises(ValueError, match="transfer_dtype"):
        ModelConfig(name="vit_tiny", transfer_dtype="fp8")
    with pytest.raises(ValueError, match="weights"):
        build_model("vit_tiny", device="cpu", weights="int4")


def test_shared_engine_is_one_copy_per_model():
    clear_engines()
    cfg = ModelConfig(name="vit_tiny", dtype="float32", num_classes=10,
                      input_shape=SHAPE, weights="int8_fused")
    bc = BatchConfig(max_batch=4, buckets=(4,))
    a = shared_engine(cfg, bc, device="cpu")
    assert shared_engine(cfg, bc, device="cpu") is a
    assert shared_engine(ModelConfig(name="vit_tiny", dtype="float32", num_classes=10,
                                     input_shape=SHAPE), bc, device="cpu") is not a
    # zero-row padding to the bucket, results sliced to the real rows
    out = a.predict(np.zeros((3, *SHAPE), np.float32))
    assert out.shape == (3, 10) and a.forwards == 1
    clear_engines()


def test_defaults_name_a_registered_model_on_the_card(jax_params):
    """ModelConfig() names the flagship the port registers, so a default
    InferenceBolt can build its engine; the model builders, like every
    entry point, run on cuda unless the caller asks for the CPU."""
    cfg = ModelConfig()
    md = model_def(cfg.name, num_classes=cfg.num_classes,
                   input_shape=tuple(cfg.input_shape))
    assert (cfg.name, md.input_shape, cfg.num_classes) == ("vit_b16", (224, 224, 3), 1000)
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present; chip_smoke.py builds on it")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        from_jax_params(jax_params, model_def("vit_tiny"), weights="int8_fused")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        build_model("vit_tiny")
