"""The port's MoE layer and MoE-ViT against storm_tpu's on the CPU.

- ``moe_vit_tiny`` with storm_tpu's trained parameters (the exported
  checkpoint; its tree is storm_tpu's ``init`` tree), in float32 and in
  bfloat16 with float, int8 and int8_fused weights: the logits of the two
  model functions on 6 held-out digits padded to 8 rows (storm_tpu under
  its engine's parameter preparation, ``tests/test_torch_zoo.py``; in
  bfloat16 compiled without XLA's excess precision, its declared
  arithmetic). Relative to the largest |logit|: float32 1e-5; bfloat16
  2e-2 on at least 7 of the 8 rows (measured: every row <= 0.0069 in
  float and int8 weights; int8_fused 7 rows <= 0.006 and one at 0.17,
  where storm_tpu's CPU path dequantizes the weights to bf16 before the
  product and a token of that row changes expert: storm_tpu's own
  bf16-to-float32 distance on this batch is 0.14-0.18), the argmax equal
  on every row, and each bf16 result at least 1e-3 from the port's
  float32 one.
- The MoE layer: routing identical to storm_tpu's in float32 (chosen
  expert, queue position, capacity drops) at a padded bucket whose zero
  rows count toward the capacity; in bfloat16 the share of tokens routed
  differently is bounded (5 %) and the outputs held within 3e-2 on the
  tokens routed alike. A small ``build_moe_vit`` at capacity factor 1.0
  in float32, through both packages' model functions.
- Quantization of the MoE tree bit-identical to storm_tpu's, with one
  scale per output column shared across experts, and only the dense
  ``"w"`` weights left int8 by int8_fused.
- The exported ``moe_vit_tiny_digits`` on the first 64 held-out rows:
  float32 within 1e-5 of storm_tpu's recorded engine output; bf16 and
  int8 within 2e-2 of storm_tpu's engine compiled without XLA's excess
  precision (its declared arithmetic: measured 0.012 and 0.0098; the
  recorded output, with excess precision, is 0.13 and 0.29 away from it
  on a row where a token changes expert); int8_fused and the uint8 wire,
  whose JAX CPU paths round differently again, at least 90 % of the rows
  within 2e-2 of the record. Every mode keeps the recorded argmax on rows
  whose top-2 margin exceeds 0.02.
"""

import functools
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import storm_tpu.models.registry as jax_registry
import storm_tpu.parallel.moe as jax_moe
from storm_tpu.config import BatchConfig as JaxBatchConfig
from storm_tpu.config import ModelConfig as JaxModelConfig
from storm_tpu.config import ShardingConfig
from storm_tpu.infer.engine import InferenceEngine as JaxEngine
from storm_tpu.infer.engine import quantize_params as jax_quantize_params
from storm_tpu.models.moe_vit import build_moe_vit as jax_build_moe_vit
from storm_tpu_torch.config import BatchConfig, ModelConfig
from storm_tpu_torch.data import load_digits_nhwc
from storm_tpu_torch.infer.engine import InferenceEngine
from storm_tpu_torch.models import model_def
from storm_tpu_torch.models.convert import from_jax_params, quantize_params
from storm_tpu_torch.models.moe_vit import build_moe_vit, moe_init
from storm_tpu_torch.models.registry import load_checkpoint
from storm_tpu_torch.parallel.moe import moe_layer, moe_routing
from tests.test_torch_checkpoints import abstract_init  # noqa: F401  (fixture)
from tests.test_torch_zoo import DTYPES, WEIGHTS, jax_logits, port_logits

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SHAPE = (32, 32, 3)
TAG = "moe_vit_tiny_digits"
MODES = {"float32": {"dtype": "float32"}, "bf16": {}, "int8": {"weights": "int8"},
         "int8_fused": {"weights": "int8_fused"}, "uint8_wire": {"transfer_dtype": "uint8"}}


@functools.lru_cache(maxsize=None)
def moe_vit_tiny():
    """(storm_tpu's model, the port's ModelDef, storm_tpu's trained
    parameters: the export of ``checkpoints/moe_vit_tiny_digits``, whose
    tree must be storm_tpu's ``init`` tree)."""
    jm = jax_registry.build_model("moe_vit_tiny", num_classes=10, input_shape=SHAPE)
    params, _, _ = load_checkpoint(f"checkpoints/{TAG}")
    spec = lambda t: jax.tree.map(lambda a: (tuple(a.shape), str(a.dtype)), t)  # noqa: E731
    assert spec(params) == spec(jax.eval_shape(jm.init, jax.random.PRNGKey(0))[0])
    return jm, model_def("moe_vit_tiny"), params


@pytest.mark.parametrize("weights", WEIGHTS, ids=lambda w: "-".join(w))
def test_moe_vit_tiny_matches_storm_tpu(weights):
    jm, md, params = moe_vit_tiny()
    dname, mode = weights
    jd, td = DTYPES[dname]
    x = np.zeros((8, *SHAPE), np.float32)  # 6 held-out digits padded to a bucket of 8
    x[:6] = load_digits_nhwc(SHAPE)[2][:6]
    got = port_logits(md, params, {}, x, td, mode)
    if dname == "float32":
        want = jax_logits(jm, params, {}, x, jd, mode)
        assert np.abs(got - want).max() <= 1e-5 * np.abs(want).max()
        return
    want = jax_logits(jm, params, {}, x, jd, mode, exact=True)
    row = np.abs(got - want).max(-1) / np.abs(want).max()
    assert (row <= 2e-2).sum() >= 7, row  # one row may hold a token at a routing tie
    assert (got.argmax(-1) == want.argmax(-1)).all()
    f32 = port_logits(md, params, {}, x, torch.float32, "float")
    assert np.abs(got - f32).max() / np.abs(f32).max() >= 1e-3


# ---- the MoE layer --------------------------------------------------------------


def _moe_params(seed: int):
    """A MoE layer's parameters (dim 32, mlp 64, 4 experts) in storm_tpu's
    layout and distributions (the port's ``moe_init``), for both sides."""
    p = moe_init(np.random.RandomState(seed), 32, 64, 4)
    return ({k: jnp.asarray(v) for k, v in p.items()},
            {k: torch.from_numpy(v) for k, v in p.items()})


@functools.partial(jax.jit, static_argnums=(2,))
def _jax_routing_jit(p, tokens, capacity_factor):
    """storm_tpu's routing, as ``moe_layer`` computes it
    (storm_tpu/parallel/moe.py:80-91)."""
    n, e = tokens.shape[0], p["w_in"].shape[0]
    cap = max(1, int(np.ceil(n / e * capacity_factor)))
    logits = (tokens @ p["gate"].astype(tokens.dtype)).astype(jnp.float32)
    probs = jax.nn.softmax(logits, axis=-1)
    expert = jnp.argmax(probs, axis=-1)
    onehot = jax.nn.one_hot(expert, e, dtype=jnp.float32)
    pos = (jnp.cumsum(onehot, axis=0) - 1.0) * onehot
    keep = onehot * (pos < cap)
    return expert, keep, pos


def _jax_routing(p, tokens, capacity_factor):
    n, e = tokens.shape[0], p["w_in"].shape[0]
    cap = max(1, int(np.ceil(n / e * capacity_factor)))
    return (*map(np.asarray, _jax_routing_jit(p, tokens, capacity_factor)), cap)


_jax_moe_layer = jax.jit(lambda p, x, cf: jax_moe.moe_layer(p, x, capacity_factor=cf)[0],
                         static_argnums=(2,))


@pytest.mark.parametrize("capacity_factor", [1.25, 0.5])
def test_moe_routing_identical_in_float32_at_a_padded_bucket(capacity_factor):
    """40 real tokens and 24 zero rows (a padded bucket): the capacity
    counts all 64, the zero rows come last in every queue and never
    displace a real token, and overflowed tokens (capacity 0.5 drops
    many) give exactly 0 on both sides."""
    p, tp = _moe_params(1)
    rng = np.random.RandomState(2)
    tokens = np.concatenate([rng.randn(40, 32), np.zeros((24, 32))]).astype(np.float32)
    expert, keep, pos, cap = _jax_routing(p, jnp.asarray(tokens), capacity_factor)
    _probs, t_expert, t_keep, t_pos, t_cap = moe_routing(
        tp["gate"], torch.from_numpy(tokens), 4, capacity_factor)
    assert t_cap == cap == int(np.ceil(64 / 4 * capacity_factor))
    assert np.array_equal(t_expert.numpy(), expert)
    assert np.array_equal(t_keep.numpy(), keep)
    assert np.array_equal(t_pos.numpy(), pos)
    want = np.asarray(_jax_moe_layer(p, jnp.asarray(tokens), capacity_factor))
    got = moe_layer(tp, torch.from_numpy(tokens), capacity_factor)[0].numpy()
    np.testing.assert_allclose(got, want, atol=1e-5, rtol=1e-5)
    dropped = keep.sum(-1) == 0
    assert np.array_equal((got == 0).all(-1), (want == 0).all(-1))
    assert (got[dropped] == 0).all()
    if capacity_factor < 1:
        assert dropped[:40].any()  # real tokens overflowed
    # A zero row never takes a slot a real token wanted: every real token
    # kept at the padded bucket is kept without the padding too.
    alone = _jax_routing(p, jnp.asarray(tokens[:40]), capacity_factor * 64 / 40)[1]
    assert (keep[:40] <= alone).all()


def test_moe_bf16_routes_alike_and_outputs_within_bound():
    """bfloat16: near-ties between experts may break differently, so the
    share of tokens routed differently is bounded (<= 5 %), and the
    output within 3e-2 of storm_tpu's on the tokens routed alike."""
    p, tp = _moe_params(3)
    tokens = np.random.RandomState(4).randn(256, 32).astype(np.float32)
    xb = jnp.asarray(tokens, jnp.bfloat16)
    expert, keep, _pos, _cap = _jax_routing(p, xb, 1.25)
    tb = torch.from_numpy(tokens).to(torch.bfloat16)
    tpb = {k: v.to(torch.bfloat16) for k, v in tp.items()}
    _probs, t_expert, t_keep, _tpos, _tcap = moe_routing(tpb["gate"], tb, 4, 1.25)
    assert (t_expert.numpy() != expert).mean() <= 0.05
    want = np.asarray(_jax_moe_layer(jax.tree.map(lambda a: a.astype(jnp.bfloat16), p),
                                     xb, 1.25), np.float32)
    got = moe_layer(tpb, tb)[0].float().numpy()
    alike = (t_keep.numpy() == keep).all(-1)
    assert alike.mean() >= 0.9
    assert np.abs(got - want)[alike].max() <= 3e-2 * np.abs(want).max()


def test_small_moe_vit_matches_storm_tpu_in_float32():
    """A small ``build_moe_vit`` (patch 4, dim 32, depth 2, 4 experts,
    capacity 1.0), 3 real rows in a padded batch of 8, through both
    packages' model functions, on the port's seeded parameters (whose tree
    must equal storm_tpu's)."""
    kw = dict(num_classes=5, input_shape=(16, 16, 3), patch=4, dim=32, depth=2,
              num_heads=2, mlp_dim=64, n_experts=4, capacity_factor=1.0)
    jm = jax_build_moe_vit("moe_small", **kw)
    md = build_moe_vit("moe_small", **kw)
    params, state = md.init(np.random.RandomState(5))
    spec = lambda t: jax.tree.map(lambda a: (tuple(a.shape), str(a.dtype)), t)  # noqa: E731
    assert spec(params) == spec(jax.eval_shape(jm.init, jax.random.PRNGKey(5))[0])
    x = np.zeros((8, 16, 16, 3), np.float32)
    x[:3] = np.random.RandomState(6).rand(3, 16, 16, 3)
    want = np.asarray(jax.jit(jm.apply)(params, state, jnp.asarray(x))[0])
    model = from_jax_params(params, md, device="cpu")
    with torch.inference_mode():
        got = model(torch.from_numpy(x)).numpy()
    np.testing.assert_allclose(got, want, atol=1e-4, rtol=1e-4)


def test_moe_quantization_matches_storm_tpu():
    """quantize_params on the MoE tree: bit-identical leaves, the 3-D
    expert weights with one scale per output column shared across
    experts; int8_fused keeps only the "w" dense weights int8 (the gate
    and the expert tensors dequantized)."""
    _, md, params = moe_vit_tiny()
    ours = quantize_params(params)
    theirs = jax.tree.map(np.asarray, jax_quantize_params(params))
    flat_o = jax.tree_util.tree_flatten_with_path(ours)[0]
    flat_t = jax.tree_util.tree_flatten_with_path(theirs)[0]
    assert [p for p, _ in flat_o] == [p for p, _ in flat_t]
    for (path, a), (_, b) in zip(flat_o, flat_t):
        assert a.dtype == b.dtype and np.array_equal(a, b), path
    moe = ours["blocks"][1]["moe"]
    assert set(moe) == {"gate", "w_in", "b_in", "w_out", "b_out"}
    assert moe["w_in"]["__q"].shape == (4, 64, 128) and moe["w_in"]["__s"].shape == (128,)
    assert moe["b_in"]["__s"].shape == (128,)
    m = from_jax_params(params, md, weights="int8_fused", dtype=torch.bfloat16, device="cpu")
    ints = {k for k, v in m.state_dict().items() if v.dtype == torch.int8}
    # 2 dense blocks x 6 dense layers, 2 MoE blocks x 4 projections, the head
    assert len(ints) == 2 * 6 + 2 * 4 + 1 and all(k.endswith(".q") for k in ints)
    assert m.blocks[1].w_in.dtype == m.blocks[1].gate.dtype == torch.bfloat16


# ---- the exported checkpoint ------------------------------------------------------


@pytest.fixture(scope="module")
def reference():
    with np.load(os.path.join(ROOT, "checkpoints_torch", "reference_predictions.npz")) as f:
        return {k: f[k] for k in f.files if k.startswith(TAG + "/")}


def _declared_arithmetic(mode: str, x: np.ndarray) -> np.ndarray:
    """storm_tpu's engine on the checkpoint, its forward compiled without
    XLA's CPU excess precision (each bf16 value rounded as the model code
    declares)."""
    eng = JaxEngine(JaxModelConfig(name="moe_vit_tiny", checkpoint=os.path.join(
        ROOT, "checkpoints", TAG), input_shape=SHAPE, num_classes=10, **MODES[mode]),
        ShardingConfig(data_parallel=1), JaxBatchConfig(max_batch=64, buckets=(64,)))
    xd = jnp.asarray(x, eng.dtype)
    exact = eng._fwd.lower(eng.params, eng.state, xd).compile(
        compiler_options={"xla_allow_excess_precision": False})
    return np.asarray(exact(eng.params, eng.state, xd), np.float32)


@pytest.mark.parametrize("mode", list(MODES))
def test_moe_vit_tiny_digits_matches_storm_tpu(mode, reference, abstract_init):
    cfg = ModelConfig.from_checkpoint(f"checkpoints/{TAG}", **MODES[mode])
    x = load_digits_nhwc(cfg.input_shape)[2][:64]
    got = InferenceEngine(cfg, BatchConfig(max_batch=64, buckets=(64,)),
                          device="cpu").predict(x)
    want = reference[f"{TAG}/{mode}"][:64]
    row = np.abs(got - want).max(-1)
    if mode == "float32":
        assert row.max() <= 1e-5
    elif mode in ("bf16", "int8"):
        assert np.abs(got - _declared_arithmetic(mode, x)).max() <= 2e-2
    else:
        assert (row <= 2e-2).mean() >= 0.9, row
    top2 = np.sort(want, axis=-1)[:, -2:]
    decided = top2[:, 1] - top2[:, 0] > 0.02
    assert decided.sum() >= 32
    assert (got.argmax(-1) == want.argmax(-1))[decided].all()
