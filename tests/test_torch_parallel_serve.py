"""The port's parallel serving paths in a gloo world of four CPU processes,
held against storm_tpu's sharded engines on the 8 CPU devices of
``tests/conftest.py``, on the same parameters and inputs.

A module fixture spawns the world once (``parallel.launch.spawn_ranks``,
every rank joined with a deadline and killed in its ``finally``); each
rank (``tests/torch_parallel_worker.py``, which imports no JAX) runs every
case in one order. storm_tpu's engines get the port's numpy parameters
(its ``load_or_init`` patched to return them: the digits checkpoints as
``checkpoints_torch/`` holds them, bit-identical to the orbax restore, and
seeded trees for longseq_tiny), so both packages compute on one tree.

- ``ring_attention`` at 2 and 4 shards against storm_tpu's, and the
  exact attention: 1e-6 (storm_tpu's own test holds its ring to 2e-5);
- ``seq_parallel_encoder`` at dp2 x sp2 against storm_tpu's at the same
  mesh: 1e-5 (storm_tpu's test: 2e-4), and longseq_tiny's engine at
  dp2 x sp2: storm_tpu's SP test tolerances (atol 3e-5, rtol 1e-4,
  ``tests/test_parallel.py:223``);
- vit_tiny (the digits checkpoint) at dp2 x tp2 in float32 (atol 2e-5,
  rtol 1e-4, ``:174``) and with int8 weights (atol 1e-4, rtol 1e-3, as
  storm_tpu's int8 TP test), and at dp4;
- moe_vit_tiny (its checkpoint) at ep4 and dp2 x ep2, against storm_tpu's
  engine at the same mesh and against the port's unsharded engine
  (storm_tpu's EP tolerances, atol 3e-5, rtol 1e-4);
- every rank's predictions, as the port's JSON codec encodes them,
  byte-identical across ranks;
- one digits accuracy row: vit_tiny_digits bf16 at dp2 x tp2 on the 449
  held-out rows, within ``accuracy_harness.EPSILON["tp2"]`` of
  ``ACCURACY_r04.json``'s tp2 row;
- tp2's per-rank parameter bytes (``tests/test_parallel.py:140-144``).
"""

import json
import os
import threading

import jax
import numpy as np
import pytest
from jax.sharding import Mesh as JaxMesh

import accuracy_harness
import storm_tpu.infer.engine as jax_engine
from storm_tpu.config import BatchConfig as JaxBatchConfig
from storm_tpu.config import ModelConfig as JaxModelConfig
from storm_tpu.config import ShardingConfig as JaxShardingConfig
from storm_tpu.ops.attention import attention_reference
from storm_tpu.parallel.mesh import make_mesh as jax_make_mesh
from storm_tpu.parallel.ring_attention import ring_attention as jax_ring_attention
from storm_tpu.parallel.sequence import seq_parallel_encoder as jax_seq_parallel_encoder
from storm_tpu_torch.config import BatchConfig, ModelConfig
from storm_tpu_torch.data import load_digits_nhwc
from storm_tpu_torch.infer.engine import InferenceEngine
from storm_tpu_torch.models import model_def
from storm_tpu_torch.models.common import dense_init, ln_init
from storm_tpu_torch.models.convert import init_params
from storm_tpu_torch.models.registry import load_checkpoint
from storm_tpu_torch.parallel.launch import spawn_ranks

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
WORLD = 4
SHAPE = (32, 32, 3)
BATCH = dict(max_batch=8, buckets=(8,))
ACC_BATCH = dict(max_batch=64, buckets=(64,))

VIT = dict(name="vit_tiny", checkpoint="checkpoints/vit_tiny_digits", input_shape=SHAPE,
           num_classes=10, dtype="float32")
MOE = dict(name="moe_vit_tiny", checkpoint="checkpoints/moe_vit_tiny_digits",
           input_shape=SHAPE, num_classes=10, dtype="float32")
LONGSEQ = dict(name="longseq_tiny", input_shape=(64, 16), num_classes=10, dtype="float32",
               seed=3)
# id -> (model, sharding): every engine case of the world.
ENGINES = {
    "vit_dp4": (VIT, dict(data_parallel=4)),
    "vit_dp2_tp2": (VIT, dict(data_parallel=2, tensor_parallel=2)),
    "vit_dp2_tp2_int8": (dict(VIT, weights="int8"), dict(data_parallel=2, tensor_parallel=2)),
    "moe_ep4": (MOE, dict(data_parallel=1, expert_parallel=4)),
    "moe_dp2_ep2": (MOE, dict(data_parallel=2, expert_parallel=2)),
    "longseq_dp2_sp2": (LONGSEQ, dict(data_parallel=2, sequence_parallel=2)),
}
TOL = {"vit_dp4": (2e-5, 1e-4), "vit_dp2_tp2": (2e-5, 1e-4),
       "vit_dp2_tp2_int8": (1e-4, 1e-3), "moe_ep4": (3e-5, 1e-4),
       "moe_dp2_ep2": (3e-5, 1e-4), "longseq_dp2_sp2": (3e-5, 1e-4)}


def _x(shape, seed: int) -> np.ndarray:
    return np.random.RandomState(seed).rand(8, *shape).astype(np.float32)


def _params(model: dict):
    """The numpy (params, state) both packages serve: an exported
    checkpoint, or the port's seeded initializer."""
    if model.get("checkpoint"):
        params, state, _ = load_checkpoint(model["checkpoint"])
        return params, state
    md = model_def(model["name"], num_classes=model["num_classes"],
                   input_shape=tuple(model["input_shape"]))
    return init_params(md, model["seed"])


def _jax_engine(model: dict, sharding: dict, batch: dict, monkeypatch):
    params, state = _params(model)
    monkeypatch.setattr(jax_engine, "load_or_init", lambda *a, **k: (params, state))
    cfg = {k: v for k, v in model.items() if k != "checkpoint"}
    return jax_engine.InferenceEngine(JaxModelConfig(**cfg), JaxShardingConfig(**sharding),
                                      JaxBatchConfig(**batch))


def _cases():
    rng = np.random.RandomState(0)
    qkv = {n: [rng.standard_normal((1, 2, 16 * n, 32)).astype(np.float32)
               for _ in range(3)] for n in (2, 4)}
    dim, heads = 32, 4
    # storm_tpu's block layout (models/vit.py:_block_init), seeded in numpy.
    blocks = [{"ln1": ln_init(dim), "attn": {n: dense_init(rng, dim, dim) for n in "qkvo"},
               "ln2": ln_init(dim), "mlp_in": dense_init(rng, dim, 2 * dim),
               "mlp_out": dense_init(rng, 2 * dim, dim)} for _ in range(2)]
    for b in blocks:  # nonzero biases and norm parameters
        for leaf in (b["ln1"]["bias"], b["ln2"]["scale"], b["attn"]["q"]["b"],
                     b["mlp_out"]["b"]):
            leaf += rng.standard_normal(leaf.shape).astype(np.float32) * 0.1
    xs = rng.standard_normal((2, 16, dim)).astype(np.float32)
    cases = [dict(kind="ring", id=f"ring{n}", shards=n, qkv=qkv[n]) for n in (2, 4)]
    cases.append(dict(kind="seq_encoder", id="seq_encoder", dp=2, sp=2, blocks=blocks,
                      heads=heads, x=xs))
    for cid, (model, sharding) in ENGINES.items():
        shape = model["input_shape"]
        params, state = (_params(model) if not model.get("checkpoint") else (None, None))
        case = dict(kind="engine", id=cid, model=model, sharding=sharding, batch=BATCH,
                    x=_x(shape, 1))
        if params is not None:
            case.update(params=params, state=state)
        cases.append(case)
    x_te = load_digits_nhwc(SHAPE, seed=0)[2]
    cases.append(dict(kind="accuracy", id="acc_vit_tp2",
                      model=dict(VIT, dtype="bfloat16"),
                      sharding=dict(data_parallel=2, tensor_parallel=2), batch=ACC_BATCH,
                      x=x_te))
    return cases, qkv, blocks, xs


@pytest.fixture(scope="module")
def world():
    """The world's results (one dict a rank) and storm_tpu's: its ring and
    encoder on one thread and its engines on this one, while the ranks
    run."""
    cases, qkv, blocks, xs = _cases()
    out, ref = {}, {}

    def ranks():
        try:
            out["ranks"] = spawn_ranks("tests.torch_parallel_worker:run", WORLD,
                                       {"cases": cases}, timeout_s=90,
                                       env={"OMP_NUM_THREADS": "1"})
        except BaseException as e:  # noqa: BLE001 - reported by the tests
            out["error"] = e

    def rings():
        try:
            devs = jax.devices()
            for n in (2, 4):
                q, k, v = qkv[n]
                ref[f"ring{n}"] = (np.asarray(jax_ring_attention(
                    q, k, v, jax_make_mesh(n, 1, devices=devs[:n]))),
                    np.asarray(attention_reference(q, k, v)))
            mesh = JaxMesh(np.array(devs[:4]).reshape(2, 2), ("data", "seq"))
            ref["seq_encoder"] = np.asarray(
                jax_seq_parallel_encoder(blocks, xs, 4, mesh, "seq"))
        except BaseException as e:  # noqa: BLE001 - reported by the tests
            out["ring_error"] = e

    threads = [threading.Thread(target=f, daemon=True) for f in (ranks, rings)]
    for t in threads:
        t.start()
    try:
        with pytest.MonkeyPatch.context() as mp:
            for cid, (model, sharding) in ENGINES.items():
                x = _x(model["input_shape"], 1)
                ref[cid] = _jax_engine(model, sharding, BATCH, mp).predict(x)
    finally:
        for t in threads:
            t.join(timeout=120)
    for key in ("error", "ring_error"):
        if key in out:
            raise out[key]
    assert "ranks" in out, "the rank processes did not finish"
    return {"ranks": out["ranks"], "ref": ref}


@pytest.mark.parametrize("n", [2, 4])
def test_ring_attention_matches_storm_tpu(world, n):
    got = world["ranks"][0][f"ring{n}"]
    want, exact = world["ref"][f"ring{n}"]
    np.testing.assert_allclose(got, want, atol=1e-6)
    np.testing.assert_allclose(got, exact, atol=1e-6)
    for r in world["ranks"][1:]:
        assert np.array_equal(r[f"ring{n}"], got)


def test_seq_parallel_encoder_matches_storm_tpu(world):
    got = world["ranks"][0]["seq_encoder"]
    np.testing.assert_allclose(got, world["ref"]["seq_encoder"], rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("cid", sorted(ENGINES))
def test_sharded_engine_matches_storm_tpu(world, cid):
    res = world["ranks"][0][cid]
    want = world["ref"][cid]
    atol, rtol = TOL[cid]
    assert res["preds"].shape == want.shape == (8, 10)
    np.testing.assert_allclose(res["preds"], want, atol=atol, rtol=rtol)
    np.testing.assert_allclose(res["preds"].sum(-1), np.ones(8), atol=1e-5)
    sharding = ENGINES[cid][1]
    axis2 = ("seq" if sharding.get("sequence_parallel", 1) > 1 else
             "expert" if sharding.get("expert_parallel", 1) > 1 else "model")
    size2 = max(sharding.get(k, 1) for k in
                ("tensor_parallel", "sequence_parallel", "expert_parallel"))
    assert res["mesh"] == {"data": sharding["data_parallel"], axis2: size2}
    # storm_tpu's multi-process contract: the serialized predict.
    assert res["pipeline_depth"] == 0 and res["forwards"] == 1


@pytest.mark.parametrize("cid", sorted(ENGINES))
def test_every_rank_encodes_the_same_bytes(world, cid):
    wires = [r[cid]["wire"] for r in world["ranks"]]
    assert len(set(wires)) == 1, cid


def test_expert_parallel_matches_the_unsharded_engine(world):
    """Against the port's one-rank engine (storm_tpu's sharded engines are
    held above)."""
    want = InferenceEngine(ModelConfig(**MOE), BatchConfig(**BATCH), device="cpu").predict(
        _x(SHAPE, 1))
    for cid in ("moe_ep4", "moe_dp2_ep2"):
        np.testing.assert_allclose(world["ranks"][0][cid]["preds"], want, atol=3e-5,
                                   rtol=1e-4)
        assert world["ranks"][0][cid]["ep"] == ENGINES[cid][1]["expert_parallel"]


def test_tp2_parameter_bytes_per_rank(world):
    one = InferenceEngine(ModelConfig(**VIT), BatchConfig(**BATCH), device="cpu")
    total = one.param_bytes_per_device()
    for r in world["ranks"]:
        res = r["vit_dp2_tp2"]
        assert res["tp"] == 2 and res["param_bytes"] == total
        per = res["param_bytes_per_device"]
        assert 0.9 * total / 2 <= per < 0.75 * total, (per, total)
    # Under EP each rank holds half (ep2) or a quarter (ep4) of the experts.
    moe = [r["moe_ep4"]["param_bytes_per_device"] for r in world["ranks"]]
    assert len(set(moe)) == 1 and moe[0] < world["ranks"][0]["moe_dp2_ep2"][
        "param_bytes_per_device"] < world["ranks"][0]["moe_ep4"]["param_bytes"]


def test_digits_accuracy_row_vit_tiny_tp2(world):
    _, _, _, y_te = load_digits_nhwc(SHAPE, seed=0)
    with open(os.path.join(ROOT, "ACCURACY_r04.json")) as f:
        rows = json.load(f)["results"]
    row = next(r for r in rows if (r["model"], r["mode"]) == ("vit_tiny", "tp2"))
    preds = [r["acc_vit_tp2"] for r in world["ranks"]]
    assert all(np.array_equal(p, preds[0]) for p in preds[1:])
    assert preds[0].shape == (len(y_te), 10) == (row["n_test"], 10)
    acc = float((preds[0].argmax(-1) == y_te).mean())
    assert abs(acc - row["acc_float_device"]) <= accuracy_harness.EPSILON["tp2"], acc
