"""The exported checkpoints and the serving modes around them, on the CPU.

- ``checkpoints_torch/<tag>.npz`` holds exactly what orbax restores through
  ``storm_tpu.models.registry.load_or_init``;
- the port's digits equal ``storm_tpu.data.load_digits_nhwc`` bit for bit;
- the recorded JAX predictions equal a live ``InferenceEngine``'s;
- the uint8 wire's bytes and the int8-mode dequantized weights equal the
  JAX engine's bit for bit;
- a checkpoint whose hyperparameters or input shape disagree with the
  model is refused, naming the field;
- a checkpoint streams through spout -> InferenceBolt -> sink in the
  ordering-deterministic configuration of ``accuracy_harness.e2e_run``.
"""

import asyncio
import json
import os

import jax
import numpy as np
import pytest
import torch

import accuracy_harness
import storm_tpu.models.registry as jax_registry
from storm_tpu.config import BatchConfig as JaxBatchConfig
from storm_tpu.config import ModelConfig as JaxModelConfig
from storm_tpu.config import ShardingConfig
from storm_tpu.data import load_digits_nhwc as jax_load_digits
from storm_tpu.infer.engine import InferenceEngine as JaxEngine
from storm_tpu.infer.engine import dequantize_params as jax_dequantize
from storm_tpu.infer.engine import quantize_params as jax_quantize
from storm_tpu_torch.api.schema import decode_predictions
from storm_tpu_torch.config import (
    BatchConfig, Config, ModelConfig, OffsetsConfig, SinkConfig)
from storm_tpu_torch.connectors import BrokerSink, BrokerSpout, MemoryBroker
from storm_tpu_torch.data import load_digits_nhwc
from storm_tpu_torch.infer import InferenceBolt
from storm_tpu_torch.infer.engine import (
    InferenceEngine, clear_engines, quantize_wire, shared_engine)
from storm_tpu_torch.models import build_model, model_def
from storm_tpu_torch.models.convert import prepare_params
from storm_tpu_torch.models.registry import (
    check_checkpoint, checkpoint_meta, checkpoint_path, load_checkpoint)
from storm_tpu_torch.models.vit import build_vit
from storm_tpu_torch.runtime import AsyncLocalCluster, TopologyBuilder

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TAGS = ("lenet5_digits", "lenet5_rgb_digits", "resnet20_digits", "vit_tiny_digits")


@pytest.fixture
def abstract_init(monkeypatch):
    """Give orbax's restore in ``load_or_init`` the model's tree as shapes
    (``jax.eval_shape``) instead of seeded arrays: the restored values are
    the checkpoint's either way, and eager initialization takes seconds."""
    monkeypatch.setattr(jax_registry, "init_params",
                        lambda model, seed=0: jax.eval_shape(
                            model.init, jax.random.PRNGKey(seed)))


def _flat(tree) -> dict:
    leaves = jax.tree_util.tree_flatten_with_path(tree)[0]
    return {"/".join(str(getattr(k, "key", getattr(k, "idx", k))) for k in path):
            np.asarray(v) for path, v in leaves}


@pytest.mark.parametrize("tag", TAGS)
def test_exported_arrays_equal_orbax_restore(tag, abstract_init):
    meta = checkpoint_meta(f"checkpoints/{tag}")
    model = jax_registry.build_model(meta["model"], num_classes=meta["num_classes"],
                                     input_shape=tuple(meta["input_shape"]))
    params, state = jax_registry.load_or_init(model, os.path.join(ROOT, "checkpoints", tag))
    want = _flat({"params": params, "state": state})
    with np.load(os.path.join(ROOT, "checkpoints_torch", f"{tag}.npz")) as f:
        got = {k: f[k] for k in f.files if k != "__meta__"}
    assert sorted(got) == sorted(want)
    for k, v in want.items():
        assert got[k].dtype == np.float32 and np.array_equal(got[k], v), k
    # the accuracy harness trains and serves each tag at these shapes
    shape = (accuracy_harness.CASCADE_SHAPE if tag == "lenet5_rgb_digits"
             else accuracy_harness.MODEL_SPECS[meta["model"]]["input_shape"])
    assert (f"{meta['model']}_digits", tuple(meta["input_shape"]), meta["num_classes"]) == (
        tag.replace("_rgb", ""), shape, 10)
    sidecar = os.path.join(ROOT, "checkpoints", tag, "storm_tpu_hyper.json")
    if os.path.exists(sidecar):
        with open(sidecar) as f:
            assert meta["hyper"] == json.load(f)
    # the port's loader rebuilds the same trees (lists where JAX has lists)
    p, s, _ = load_checkpoint(f"checkpoints/{tag}")
    assert sorted(_flat({"params": p, "state": s})) == sorted(want)


@pytest.mark.parametrize("shape", [(32, 32, 1), (32, 32, 3)])
def test_digits_bit_identical(shape):
    for ours, theirs in zip(load_digits_nhwc(shape), jax_load_digits(shape)):
        assert ours.dtype == theirs.dtype and np.array_equal(ours, theirs)


def test_uint8_wire_and_recorded_predictions(abstract_init):
    """Live JAX engine, lenet5 in uint8_wire: its recorded predictions on
    the first 64 test rows are reproduced, and the bytes it ships (real
    rows' range, padding quantized too) equal :func:`quantize_wire`'s."""
    cfg = JaxModelConfig(name="lenet5", input_shape=(32, 32, 1), num_classes=10,
                         checkpoint=os.path.join(ROOT, "checkpoints", "lenet5_digits"),
                         transfer_dtype="uint8")
    eng = JaxEngine(cfg, ShardingConfig(data_parallel=1),
                    JaxBatchConfig(max_batch=64, buckets=(64,)))
    wire = []
    fwd_q = eng._fwd_q

    def spy(params, state, xq, scale, offset):
        # a copy: the engine may hand jax its pooled host buffer, reused
        # by the next batch
        wire.append((np.array(xq, copy=True), np.float32(scale), np.float32(offset)))
        return fwd_q(params, state, xq, scale, offset)

    eng._fwd_q = spy
    x = load_digits_nhwc((32, 32, 1))[2][:64]
    with np.load(os.path.join(ROOT, "checkpoints_torch", "reference_predictions.npz")) as f:
        recorded = f["lenet5_digits/uint8_wire"][:64]
    assert np.array_equal(np.asarray(eng.predict(x), np.float32), recorded)
    dim = x[:50] * np.linspace(0.5, 0.9, 50, dtype=np.float32)[:, None, None, None]
    eng.predict(dim)  # 50 rows, padded to 64
    assert len(wire) == 2
    for (xq, scale, offset), rows in zip(wire, (x, dim)):
        n = len(rows)
        padded = np.concatenate([rows, np.zeros((64 - n, 32, 32, 1), np.float32)])
        ours, our_scale, our_offset = quantize_wire(padded, n)
        assert ours.dtype == np.uint8 and np.array_equal(ours, xq)
        assert (our_scale, our_offset) == (scale, offset)


@pytest.mark.parametrize("tag", ["lenet5_digits", "resnet20_digits", "vit_tiny_digits"])
def test_int8_dequantized_weights_bit_identical(tag):
    """weights="int8" in bf16: every quantized leaf as the JAX engine's
    ``dequantize_params`` computes it, every other leaf cast as the engine
    casts it (storm_tpu/infer/engine.py:545-551)."""
    params, _, _ = load_checkpoint(f"checkpoints/{tag}")
    bf16 = jax.numpy.bfloat16
    qtree = jax.tree.map(lambda leaf: leaf if isinstance(leaf, dict) else leaf.astype(bf16),
                         jax_quantize(params), is_leaf=lambda leaf: isinstance(leaf, dict)
                         and "__q" in leaf)
    want = _flat(jax_dequantize(qtree, bf16))
    ours = prepare_params(params, "int8", torch.bfloat16)
    got = _flat(jax.tree.map(lambda t: t.float().numpy(), ours))
    assert sorted(got) == sorted(want)
    for k, v in want.items():
        assert np.array_equal(got[k], np.asarray(v, np.float32)), k
    # int8_fused: dense weights stay int8, with the JAX package's bytes
    fused = _flat(jax.tree.map(lambda t: t.numpy() if t.dtype == torch.int8 else t.float().numpy(),
                               prepare_params(params, "int8_fused", torch.bfloat16)))
    qleaves = _flat(jax_quantize(params))
    ints = {k for k, v in fused.items() if v.dtype == np.int8}
    assert ints and all(k.endswith("w/__q") for k in ints)
    for k in ints:
        assert np.array_equal(fused[k], qleaves[k])
        assert np.array_equal(fused[k[:-1] + "s"], qleaves[k[:-1] + "s"])


def test_state_stays_float32_and_layouts():
    m = build_model("resnet20", device="cpu", weights="int8_fused", dtype=torch.bfloat16,
                    input_shape=(32, 32, 3), num_classes=10,
                    params=load_checkpoint("checkpoints/resnet20_digits")[0],
                    state=load_checkpoint("checkpoints/resnet20_digits")[1])
    sd = m.state_dict()
    assert {k for k, v in sd.items() if v.dtype == torch.int8} == {"head.q"}
    assert all(sd[k].dtype == torch.float32 for k in sd if k.endswith((".mean", ".var")))
    assert sd["stem.conv.w"].dtype == torch.bfloat16 and sd["stem.conv.w"].shape == (16, 3, 3, 3)
    assert sd["stages.1.0.down.conv.w"].shape == (32, 16, 1, 1)


def test_checkpoint_names(monkeypatch):
    """A .npz path as given, or the orbax tag spelled checkpoints/<tag>;
    any other directory (an absolute one included, which could hold a
    different export of the same tag) is refused."""
    want = os.path.join(ROOT, "checkpoints_torch", "vit_tiny_digits.npz")
    monkeypatch.chdir(ROOT)
    for name in ("checkpoints/vit_tiny_digits", "checkpoints/vit_tiny_digits/",
                 "checkpoints_torch/vit_tiny_digits.npz", want):
        assert str(checkpoint_path(name)) == want
    for name in (os.path.join(ROOT, "checkpoints", "vit_tiny_digits"),
                 "/data/retrained/vit_tiny_digits", "vit_tiny_digits",
                 "other/checkpoints/vit_tiny_digits"):
        with pytest.raises(ValueError, match="export_torch_checkpoints"):
            checkpoint_path(name)
    for name in ("checkpoints/no_such_digits", "no_such_digits.npz"):
        with pytest.raises(FileNotFoundError, match="export_torch_checkpoints"):
            checkpoint_path(name)


def test_mismatched_num_heads_is_refused():
    """Attention projections are dim x dim for any head count, so only the
    recorded hyperparameters can tell a 2-head model from the 4-head
    checkpoint."""
    params, state, meta = load_checkpoint("checkpoints/vit_tiny_digits")
    two_heads = build_vit("vit_tiny", 10, (32, 32, 3), patch=8, dim=64, depth=2,
                          num_heads=2, mlp_dim=128)
    with pytest.raises(ValueError, match="num_heads: checkpoint=4 model=2"):
        check_checkpoint(two_heads, params, state, meta, "checkpoints/vit_tiny_digits")
    check_checkpoint(model_def("vit_tiny"), params, state, meta, "vit_tiny_digits")


@pytest.mark.parametrize("kw,field", [
    ({"name": "vit_tiny", "input_shape": (32, 32, 1)}, "input_shape"),
    ({"name": "lenet5", "checkpoint": "checkpoints/resnet20_digits"}, "model"),
    ({"name": "lenet5", "num_classes": 100}, "num_classes"),
])
def test_mismatched_checkpoint_is_refused(kw, field):
    cfg = dict(checkpoint="checkpoints/lenet5_rgb_digits", input_shape=(32, 32, 3),
               num_classes=10)
    cfg.update(kw)
    with pytest.raises(ValueError, match=f"{field}: checkpoint="):
        InferenceEngine(ModelConfig(**cfg), device="cpu")


def test_shared_engine_keys_on_checkpoint_and_wire():
    clear_engines()
    base = dict(name="lenet5", input_shape=(32, 32, 3), num_classes=10)
    bc = BatchConfig(max_batch=8, buckets=(8,))
    a = shared_engine(ModelConfig(checkpoint="checkpoints/lenet5_rgb_digits", **base),
                      bc, device="cpu")
    b = shared_engine(ModelConfig(checkpoint="checkpoints/lenet5_rgb_digits",
                                  transfer_dtype="uint8", **base), bc, device="cpu")
    c = shared_engine(ModelConfig(**base), bc, device="cpu")  # seeded weights
    assert len({id(a), id(b), id(c)}) == 3
    assert a is shared_engine(ModelConfig(checkpoint="checkpoints/lenet5_rgb_digits",
                                          **base), bc, device="cpu")
    clear_engines()


async def _stream(model_cfg, batch_cfg, x):
    """One partition, parallelism 1/1/1, max_inflight 1, sync sink: the
    ordering-deterministic configuration, one image per record."""
    broker = MemoryBroker(default_partitions=1)
    tb = TopologyBuilder()
    tb.set_spout("kafka-spout", BrokerSpout(
        broker, "input", OffsetsConfig(policy="earliest", max_behind=None)))
    tb.set_bolt("inference-bolt", InferenceBolt(model_cfg, batch_cfg, device="cpu")) \
        .shuffle_grouping("kafka-spout")
    tb.set_bolt("kafka-bolt", BrokerSink(broker, "output", SinkConfig(mode="sync"))) \
        .shuffle_grouping("inference-bolt")
    cluster = AsyncLocalCluster()
    rt = await cluster.submit("accuracy", Config(), tb.build())
    for img in x:
        broker.produce("input", json.dumps({"instances": [img.tolist()]}), partition=0)
    deadline = asyncio.get_running_loop().time() + 60
    while broker.topic_size("output") < len(x):
        assert asyncio.get_running_loop().time() < deadline, "records stuck"
        await asyncio.sleep(0.02)
    await rt.drain(timeout_s=30)
    outs = broker.drain_topic("output")
    await cluster.shutdown()
    return np.concatenate([decode_predictions(r.value).data for r in outs])


def test_checkpoint_streams_in_order(run):
    """lenet5_digits over the uint8 wire: every streamed row equals the
    engine's direct prediction of the same image within accuracy_harness's
    uint8 TRANSPORT_TOL (batches form differently, and the wire's range is
    per batch), the argmax agrees, and accuracy matches."""
    clear_engines()
    model_cfg = ModelConfig.from_checkpoint("checkpoints/lenet5_digits", dtype="float32",
                                            transfer_dtype="uint8")
    batch_cfg = BatchConfig(max_batch=32, max_wait_ms=5.0, buckets=(8, 32), max_inflight=1)
    _, _, x, y = load_digits_nhwc(model_cfg.input_shape)
    x, y = x[:48], y[:48]
    outs = run(_stream(model_cfg, batch_cfg, x), timeout=90)
    direct = InferenceEngine(model_cfg, BatchConfig(max_batch=64, buckets=(64,)),
                             device="cpu").predict(x)
    assert outs.shape == (48, 10)
    assert np.abs(outs - direct).max(axis=1).max() <= 0.15
    assert (outs.argmax(-1) == direct.argmax(-1)).all()
    assert (outs.argmax(-1) == y).mean() == (direct.argmax(-1) == y).mean()
    clear_engines()
