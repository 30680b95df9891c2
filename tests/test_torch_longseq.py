"""The long-sequence encoders against storm_tpu on the CPU, and the flash
wrapper's head-dim padding.

``longseq_tiny`` (64 x 16, dim 32, 4 heads of 8) and ``longseq_encoder``
cut to S = 256 and two blocks through ``ModelConfig.extra`` (width 256, 2
heads of 128, as at S = 2048), with the port's seeded parameters carried
across by ``from_jax_params``; storm_tpu runs its model function under its
engine's parameter preparation (``tests/test_torch_zoo.py``'s
``jax_logits``). Tolerances on the logits, relative to the largest
|logit|: float32 1e-5; bfloat16 ``int8_fused`` ``BF16_BOUND``, 1.25 times
the largest distance measured on these inputs (longseq_tiny 0.0078,
longseq_encoder 0.0035) rounded up to 0.005, and each bf16 result at
least 1e-3 from the port's float32 one (a port computing in float32
fails).

Then the flash wrapper at head dims the kernels are not built for
(D = 8, 24, 48): the inputs zero-padded by ``pad_head_dim``, the plain
version at the true D's scale and the output sliced back, against
storm_tpu's Pallas kernel in interpret mode (which pads D to its 128-lane
tile), within 1e-5 in float32 and 1e-2 in bfloat16 (``tests/test_torch_ops.py``'s
bounds). Last, a rank-2 instance (seq, features) through the codec, the
engine's split-phase ring and its serial path.
"""

import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import storm_tpu.models.registry as jax_registry
from storm_tpu.ops.flash_attention import flash_attention as jax_flash_attention
from storm_tpu_torch.api.schema import decode_instances
from storm_tpu_torch.config import BatchConfig, ModelConfig
from storm_tpu_torch.infer.engine import InferenceEngine
from storm_tpu_torch.models import model_def
from storm_tpu_torch.models.convert import from_jax_params
from storm_tpu_torch.ops import flash_attention as fa
from tests.test_torch_zoo import DTYPES, jax_logits, port_logits

CONFIGS = {
    "longseq_tiny": {},
    "longseq_encoder": {"input_shape": (256, 64), "depth": 2},
}
BF16_BOUND = {"longseq_tiny": 0.01, "longseq_encoder": 0.005}
MODES = (("float32", "float"), ("bfloat16", "int8_fused"))


def _family(name: str):
    kw = CONFIGS[name]
    jm = jax_registry.build_model(name, num_classes=10, **kw)
    md = model_def(name, num_classes=10, **kw)
    params, state = md.init(np.random.RandomState(0))
    return jm, md, params, state


def _x(md, n: int = 4) -> np.ndarray:
    return np.random.RandomState(1).randn(n, *md.input_shape).astype(np.float32)


@pytest.mark.parametrize("name", sorted(CONFIGS))
def test_parameter_tree_equals_storm_tpus(name):
    jm, md, params, state = _family(name)
    theirs = jax.eval_shape(jm.init, jax.random.PRNGKey(0))
    spec = lambda t: jax.tree.map(lambda a: (tuple(a.shape), str(a.dtype)), t)  # noqa: E731
    assert spec((params, state)) == spec(theirs)
    assert md.hyper["num_heads"] * {"longseq_tiny": 8, "longseq_encoder": 128}[name] \
        == md.hyper["dim"]


@pytest.mark.parametrize("name", sorted(CONFIGS))
@pytest.mark.parametrize("mode", MODES, ids="-".join)
def test_longseq_matches_storm_tpu(name, mode):
    jm, md, params, state = _family(name)
    dname, weights = mode
    jd, td = DTYPES[dname]
    x = _x(md)
    got = port_logits(md, params, state, x, td, weights)
    want = jax_logits(jm, params, state, x, jd, weights)
    rel = float(np.abs(got - want).max()) / float(np.abs(want).max())
    if dname == "float32":
        assert rel <= 1e-5, rel
        return
    assert rel <= BF16_BOUND[name], rel
    f32 = port_logits(md, params, state, x, torch.float32, "float")
    assert np.abs(got - f32).max() / np.abs(f32).max() >= 1e-3  # bf16 really ran


def test_longseq_refuses_an_image_shape():
    with pytest.raises(ValueError, match="seq, features"):
        model_def("longseq_tiny", input_shape=(8, 8, 3))


# ---- the flash wrapper's head-dim padding -------------------------------------


@pytest.mark.parametrize("dtype,tol", [("float32", 1e-5), ("bfloat16", 1e-2)])
@pytest.mark.parametrize("d", [8, 24, 48])
def test_flash_padding_matches_pallas_interpret(d, dtype, tol):
    jdt, tdt = DTYPES[dtype]
    shape = (2, 2, 40, d)  # a ragged key tile too
    rng = np.random.RandomState(d)
    q, k, v = (rng.randn(*shape).astype(np.float32) for _ in range(3))
    want = np.asarray(jax_flash_attention(*(jnp.asarray(a, jdt) for a in (q, k, v)),
                                          interpret=True).astype(jnp.float32))
    qt, kt, vt = (torch.from_numpy(a).to(tdt) for a in (q, k, v))
    padded = fa.pad_head_dim(qt, kt, vt)
    assert all(t.shape[-1] == fa.padded_head_dim(d) > d for t in padded)
    assert all(not t[..., d:].any() for t in padded)
    helper = fa.flash_attention_reference(*padded, scale=d ** -0.5)[..., :d]
    wrapper = fa.flash_attention(qt, kt, vt)
    assert wrapper.shape == shape and wrapper.dtype == tdt
    assert torch.equal(wrapper, helper)
    scale = np.abs(want).max()
    assert np.abs(wrapper.float().numpy() - want).max() / scale <= tol


def test_flash_head_dims_above_128_raise():
    t = torch.zeros(1, 1, 8, 136)
    with pytest.raises(ValueError, match="up to 128"):
        fa.flash_attention(t, t, t)
    assert fa.padded_head_dim(128) == 128 and fa.padded_head_dim(1) == 16


# ---- a rank-2 instance through the codec and the engine --------------------------


@pytest.mark.parametrize("transfer", [None, "uint8"])
def test_rank2_instance_through_codec_and_engine(transfer):
    cfg = ModelConfig(name="longseq_tiny", dtype="float32", num_classes=10,
                      input_shape=(64, 16), transfer_dtype=transfer)
    eng = InferenceEngine(cfg, BatchConfig(max_batch=8, buckets=(8,)), device="cpu")
    assert eng.input_shape == (64, 16)
    x = _x(eng.model_def, 3)
    records = [decode_instances(json.dumps({"instances": x[i:i + 1].tolist()})).data
               for i in range(3)]
    assert all(r.shape == (1, 64, 16) and r.dtype == np.float32 for r in records)
    np.testing.assert_array_equal(np.concatenate(records), x)
    handle = eng.dispatch(records)
    got = handle.future.result(timeout=30)
    assert got.shape == (3, 10) and handle.padded == 8
    np.testing.assert_array_equal(got, eng.predict_eager(x))
    if transfer is None:
        params, state = eng.model_def.init(np.random.RandomState(0))
        model = from_jax_params(params, eng.model_def, state, device="cpu")
        with torch.inference_mode():
            probs = model(torch.from_numpy(x)).softmax(-1).numpy()
        np.testing.assert_allclose(got, probs, rtol=0, atol=1e-6)
    assert np.allclose(got.sum(-1), 1.0, atol=1e-5)
