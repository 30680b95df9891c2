"""The rest of the single-device zoo against storm_tpu on the CPU:
``mixer_tiny``, ``mobilenetv2`` at 32x32 and ``resnet50`` at 32x32 (the
MoE-ViT has its own file, ``tests/test_torch_moe.py``).

The parameters come from the port's seeded numpy initializer, whose tree
must equal storm_tpu's ``init`` in every path, shape and dtype
(``jax.eval_shape``); storm_tpu's own initializer takes 4-11 s to compile
on the CPU for these families (the MoE-ViT's tests use it). Both packages
then serve the same numbers: the parameters are carried across with
``from_jax_params``, and storm_tpu runs its model function under its
engine's parameter preparation (the compute-dtype cast, or
``quantize_params`` then ``dequantize_params`` with ``keep_dense`` for
``int8_fused``) on the same seeded batch.

Tolerances on the logits, relative to the largest |logit|: float32 1e-5;
bfloat16 ``BF16_BOUND`` per family, 1.25 times the largest distance
measured on these inputs (mixer 0.0078, mobilenetv2 0.040, resnet50
0.017) rounded up to 0.005; storm_tpu's own bf16-to-float32 distances
on them are 0.0046-0.020, 0.031-0.062 and 0.012-0.045. Every bf16 result
must also lie at least 1e-3 from the port's float32 one (a port computing
in float32 fails), and keep the argmax on rows whose margin exceeds
twice the bound. Then the layers the CNNs add (depthwise
convolution, 3x3/2 VALID max pooling, ReLU6), each family's kernel calls
per forward, and the w8a16 wrapper on the mixer's transposed tokens.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import storm_tpu.models.registry as jax_registry
from storm_tpu.infer.engine import _is_qleaf
from storm_tpu.infer.engine import dequantize_params as jax_dequantize_params
from storm_tpu.infer.engine import quantize_params as jax_quantize_params
from storm_tpu.ops import layers as JL
from storm_tpu_torch.models import model_def
from storm_tpu_torch.models.convert import from_jax_params
from storm_tpu_torch.models.mixer import _build_mixer
from storm_tpu_torch.models.moe_vit import build_moe_vit
from storm_tpu_torch.ops import attention, fused_norm, quant_matmul
from storm_tpu_torch.ops import layers as L

SHAPE = (32, 32, 3)
FAMILIES = ("mixer_tiny", "mobilenetv2", "resnet50")
WEIGHTS = (("float32", "float"), ("bfloat16", "float"), ("bfloat16", "int8"),
           ("bfloat16", "int8_fused"))
BF16_BOUND = {"mixer_tiny": 0.01, "mobilenetv2": 0.05, "resnet50": 0.025}
DTYPES = {"float32": (jnp.float32, torch.float32), "bfloat16": (jnp.bfloat16, torch.bfloat16)}


@functools.lru_cache(maxsize=None)
def family(name: str):
    """(storm_tpu's model, the port's ModelDef, numpy params, state)."""
    jm = jax_registry.build_model(name, num_classes=10, input_shape=SHAPE)
    md = model_def(name, num_classes=10, input_shape=SHAPE)
    params, state = md.init(np.random.RandomState(0))
    return jm, md, params, state


def jax_logits(jm, params, state, x: np.ndarray, dtype, weights: str,
               exact: bool = False) -> np.ndarray:
    """storm_tpu's forward under its engine's parameter preparation
    (storm_tpu/infer/engine.py: the cast, or quantize_params and, inside
    the jitted forward, dequantize_params). ``exact`` compiles it without
    XLA's CPU excess precision: each bf16 value rounded as the model code
    declares."""
    if weights == "float":
        p = jax.tree.map(lambda a: a.astype(dtype) if a.dtype == jnp.float32 else a,
                         params)
        fwd = jax.jit(lambda p, s, x: jm.apply(p, s, x)[0])
    else:
        p = jax.tree.map(lambda a: a if _is_qleaf(a) else (
            a.astype(dtype) if a.dtype == jnp.float32 else a),
            jax_quantize_params(params), is_leaf=_is_qleaf)
        fwd = jax.jit(lambda q, s, x: jm.apply(jax_dequantize_params(
            q, dtype, keep_dense=weights == "int8_fused"), s, x)[0])
    xd = jnp.asarray(x, dtype)
    if exact:
        fwd = fwd.lower(p, state, xd).compile(
            compiler_options={"xla_allow_excess_precision": False})
    return np.asarray(fwd(p, state, xd), np.float32)


def port_logits(md, params, state, x: np.ndarray, dtype, weights: str) -> np.ndarray:
    model = from_jax_params(params, md, state, weights=weights, dtype=dtype, device="cpu")
    with torch.inference_mode():
        out = model(torch.from_numpy(x).to(dtype))
    assert out.dtype == dtype and out.shape == (x.shape[0], 10)
    return out.float().numpy()


def _x() -> np.ndarray:
    return np.random.RandomState(0).rand(6, *SHAPE).astype(np.float32)


# Every mode for the mixer; for the CNNs, whose int8 and int8_fused differ
# only in the head's product, int8_fused.
CASES = [("mixer_tiny", w) for w in WEIGHTS] + [
    (f, w) for f in FAMILIES[1:] for w in WEIGHTS if w[1] != "int8"]


@pytest.mark.parametrize("name,weights", CASES, ids=lambda v: v if isinstance(v, str)
                         else "-".join(v))
def test_family_matches_storm_tpu(name, weights):
    jm, md, params, state = family(name)
    dname, mode = weights
    jd, td = DTYPES[dname]
    x = _x()
    got = port_logits(md, params, state, x, td, mode)
    want = jax_logits(jm, params, state, x, jd, mode)
    scale = float(np.abs(want).max())
    rel = float(np.abs(got - want).max()) / scale
    if dname == "float32":
        assert rel <= 1e-5, rel
        return
    bound = BF16_BOUND[name]
    assert rel <= bound, rel
    f32 = port_logits(md, params, state, x, torch.float32, "float")
    assert np.abs(got - f32).max() / np.abs(f32).max() >= 1e-3  # bf16 really ran
    top2 = np.sort(want, axis=-1)[:, -2:]
    decided = top2[:, 1] - top2[:, 0] > 2 * bound * scale
    assert (got.argmax(-1) == want.argmax(-1))[decided].all()


def test_parameter_trees_equal_storm_tpus():
    """The port's initializers lay parameters and state out as storm_tpu's
    do: the same paths, shapes and dtypes."""
    for name in FAMILIES:
        jm, md, _, _ = family(name)
        theirs = jax.eval_shape(jm.init, jax.random.PRNGKey(0))
        ours = md.init(np.random.RandomState(0))
        spec = lambda t: jax.tree.map(lambda a: (tuple(a.shape), str(a.dtype)), t)  # noqa: E731
        assert jax.tree_util.tree_structure(ours) == jax.tree_util.tree_structure(theirs)
        assert spec(ours) == spec(theirs), name


def test_mobilenetv2_keeps_the_cifar_adaptation():
    from storm_tpu_torch.models.mobilenet import _round_c, block_strides

    assert block_strides(True)[:4] == [1, 1, 1, 2] and block_strides(False)[:4] == [1, 2, 1, 2]
    assert len(block_strides(True)) == 17
    assert [_round_c(c) for c in (32, 1280, 24 * 0.75, 3)] == [32, 1280, 24, 8]
    big = model_def("mobilenetv2", num_classes=10, input_shape=(224, 224, 3))
    params, state = big.init(np.random.RandomState(0))
    model = from_jax_params(params, big, state, device="cpu")
    assert model.stem.conv.stride == 2 and model.blocks[1].stride == 2
    with torch.inference_mode():
        assert model(torch.zeros(1, 224, 224, 3)).shape == (1, 10)


# ---- kernel calls per forward ---------------------------------------------------


def _kernel_calls(md, dtype=torch.bfloat16) -> dict:
    """Calls of the three kernel wrappers in one int8_fused forward on the
    CPU (where each runs its plain version): what the card launches."""
    calls = {"w8a16": 0, "flash": 0, "norm": 0}

    def counting(key, fn):
        def wrapped(*a, **k):
            calls[key] += 1
            return fn(*a, **k)
        return wrapped

    params, state = md.init(np.random.RandomState(0))
    model = from_jax_params(params, md, state, weights="int8_fused", dtype=dtype,
                            device="cpu")
    x = torch.from_numpy(np.random.RandomState(1).rand(2, *md.input_shape)
                         .astype(np.float32)).to(dtype)
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(quant_matmul, "w8a16_matmul",
                   counting("w8a16", quant_matmul.w8a16_matmul))
        mp.setattr(attention, "flash_attention", counting("flash", attention.flash_attention))
        mp.setattr(fused_norm, "fused_add_layernorm",
                   counting("norm", fused_norm.fused_add_layernorm))
        with torch.inference_mode():
            out = model(x)
    assert torch.isfinite(out.float()).all()
    return calls


def test_kernel_calls_per_forward():
    """moe_vit_b16's layout (depth 12, MoE in every other block) at a
    narrow width: 6 dense blocks x 6 dense layers + 6 MoE blocks x 4
    projections + the head = 61 w8a16, 12 flash, 6 fused norms (dense
    blocks only); mixer_s16's (depth 8): 4 dense layers a block + the head
    = 33 w8a16, 8 fused norms; the CNNs only their head."""
    moe = build_moe_vit("moe_narrow", 10, SHAPE, patch=8, dim=32, depth=12,
                        num_heads=2, mlp_dim=64, n_experts=8)
    assert _kernel_calls(moe) == {"w8a16": 61, "flash": 12, "norm": 6}
    mixer = _build_mixer("mixer_narrow", 10, SHAPE, patch=8, dim=32, depth=8,
                         token_mlp=16, channel_mlp=64)
    assert _kernel_calls(mixer) == {"w8a16": 33, "flash": 0, "norm": 8}
    for name in ("mobilenetv2", "resnet50"):
        assert _kernel_calls(family(name)[1]) == {"w8a16": 1, "flash": 0, "norm": 0}, name
    assert _kernel_calls(model_def("moe_vit_tiny")) == {"w8a16": 21, "flash": 4, "norm": 2}
    assert _kernel_calls(model_def("mixer_tiny")) == {"w8a16": 17, "flash": 0, "norm": 4}


def test_w8a16_takes_the_mixers_transposed_tokens():
    """The mixer's token MLP hands the w8a16 wrapper a transposed,
    non-contiguous activation with K = 196: the result equals the product
    of the dense copy."""
    rng = np.random.RandomState(7)
    x = torch.from_numpy(rng.randn(2, 196, 32).astype(np.float32)).transpose(1, 2)
    assert not x.is_contiguous()
    q = torch.from_numpy(rng.randint(-127, 128, (196, 64)).astype(np.int8))
    s = torch.from_numpy((rng.rand(64) * 1e-2).astype(np.float32))
    got = quant_matmul.w8a16_matmul(x, q, s)
    want = quant_matmul.w8a16_matmul_reference(x.contiguous(), q, s)
    assert got.shape == (2, 32, 64) and torch.equal(got, want)


# ---- the layers MobileNetV2 and ResNet-50 add -------------------------------------


def _close(got: torch.Tensor, want, tol: float) -> None:
    want = np.asarray(want, np.float32)
    assert got.shape == want.shape
    assert np.abs(got.float().numpy() - want).max() <= tol * max(1.0, np.abs(want).max())


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("stride,size", [(1, 16), (2, 16), (2, 15)])
def test_depthwise_conv2d_same(stride, size, dtype):
    jd, td = DTYPES[dtype]
    tol = 1e-5 if dtype == "float32" else 1e-2
    rng = np.random.RandomState(stride + size)
    x = rng.rand(2, size, size, 8).astype(np.float32)
    w = (rng.randn(3, 3, 1, 8) * 0.4).astype(np.float32)
    want = JL.depthwise_conv2d({"w": jnp.asarray(w, jd)}, jnp.asarray(x, jd), stride=stride)
    got = L.depthwise_conv2d({"w": torch.from_numpy(w).permute(3, 2, 0, 1).to(td)},
                             torch.from_numpy(x).to(td), stride=stride)
    assert got.dtype == td
    _close(got, want, tol)


@pytest.mark.parametrize("size", [16, 15, 112])
def test_max_pool_3x3_stride_2_is_valid(size):
    x = np.random.RandomState(size).randn(2, size, size, 4).astype(np.float32)
    want = JL.max_pool(jnp.asarray(x), window=3, stride=2)
    got = L.max_pool(torch.from_numpy(x), window=3, stride=2)
    assert got.shape[1] == (size - 3) // 2 + 1
    _close(got, want, 0.0)


def test_relu6():
    x = np.linspace(-3, 9, 25, dtype=np.float32)
    _close(L.relu6(torch.from_numpy(x)), JL.relu6(jnp.asarray(x)), 0.0)
