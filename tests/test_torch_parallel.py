"""The port's parallel serving pieces in one process (no process group),
against storm_tpu's where it has the same function: ``ShardingConfig``,
the mesh and its checks, the TP and EP specs and shards of float and
quantized trees, the engine's checks, ``shared_engine``'s key, the
default path's rule (a world of one makes no process group and keeps its
graphs), the row-parallel f32 partials of the w8a16 kernel's wrapper, and
the expert-parallel MoE layer with its collectives played by the test
(every shard of a (data, expert) mesh in turn, summed as the all-reduce
sums, against the one-shard layer and storm_tpu's). The four-process
world is ``tests/test_torch_parallel_serve.py``.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.distributed as dist

import storm_tpu.parallel.moe as jax_moe
from storm_tpu.config import ShardingConfig as JaxShardingConfig
from storm_tpu.infer.engine import quantize_params as jax_quantize_params
from storm_tpu.parallel.sharding import tp_param_specs as jax_tp_param_specs
from storm_tpu_torch.config import BatchConfig, Config, ModelConfig, ShardingConfig
from storm_tpu_torch.infer import InferenceBolt
from storm_tpu_torch.infer.engine import InferenceEngine, clear_engines, shared_engine
from storm_tpu_torch.models import model_def
from storm_tpu_torch.models.common import Dense
from storm_tpu_torch.models.convert import from_jax_params, init_params, quantize_params
from storm_tpu_torch.models.moe_vit import moe_init
from storm_tpu_torch.ops import layers as L
from storm_tpu_torch.ops import quant_matmul as qm
from storm_tpu_torch.parallel import collectives
from storm_tpu_torch.parallel.mesh import Mesh, make_mesh
from storm_tpu_torch.parallel.moe import ExpertShard, moe_layer, moe_param_specs, \
    shard_moe_params
from storm_tpu_torch.parallel.sharding import (
    attach_tp, row_parallel_paths, shard_array, shard_batch, shard_params_ep, shard_params_tp,
    tp_param_specs)
from tests.test_torch_kernel_dispatch import VIT_MATMULS, launches  # noqa: F401  (fixture)

SHAPE = (32, 32, 3)
BATCH = BatchConfig(max_batch=8, buckets=(8,))


def _vit_tiny():
    md = model_def("vit_tiny", num_classes=10, input_shape=SHAPE)
    return md, init_params(md, 7)[0]


def _mesh(dp: int, n: int, axis: str, rank: int) -> Mesh:
    """A (dp, n) mesh seen from ``rank``, without groups."""
    return Mesh(np.arange(dp * n).reshape(dp, n), ("data", axis), rank=rank)


def _leaves(tree, path=()):
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from _leaves(v, path + (k,))
    elif isinstance(tree, list):  # a spec is a tuple, and a leaf
        for i, v in enumerate(tree):
            yield from _leaves(v, path + (i,))
    else:
        yield path, tree


def test_sharding_config_is_storm_tpus_and_rides_config():
    assert [(f.name, f.default) for f in dataclasses.fields(ShardingConfig)] == [
        (f.name, f.default) for f in dataclasses.fields(JaxShardingConfig)]
    cfg = Config.from_dict({"sharding": {"data_parallel": 2, "tensor_parallel": 2,
                                         "axis_names": ["data", "model"]}})
    assert (cfg.sharding.data_parallel, cfg.sharding.tensor_parallel) == (2, 2)
    assert cfg.sharding.axis_names == ("data", "model")
    assert Config.from_dict(cfg.to_dict()).sharding == cfg.sharding
    with pytest.raises(KeyError):
        Config.from_dict({"sharding": {"pipeline_parallel": 2}})


def test_make_mesh_world_of_one_and_storm_tpus_checks():
    assert not dist.is_initialized()
    m = make_mesh(device="cpu")
    assert m.shape == {"data": 1, "model": 1} and m.size == 1 and m.rank == 0
    assert m.group("data") is None and m.group("model") is None
    t = torch.arange(4.0)
    assert collectives.all_reduce(t, m, "model") is t
    assert collectives.all_gather(t, m, "data") is t
    assert collectives.ppermute(t, m, "model") is t
    # storm_tpu's checks, over eight ranks
    with pytest.raises(ValueError, match="must divide"):
        make_mesh(8, 3, ranks=range(8), device="cpu")
    with pytest.raises(ValueError, match="exceeds"):
        make_mesh(8, 2, ranks=range(8), device="cpu")
    # more than one rank without a process group raises; nothing was made
    for args in [(2, 1), (4, 2), (0, 2)]:
        with pytest.raises(RuntimeError, match="init_process_group"):
            make_mesh(*args, device="cpu")
    assert not dist.is_initialized()


def test_mesh_coordinates_lines_and_groups():
    m = Mesh(np.array([[0, 1], [2, 3]]), ("data", "model"), rank=3, device="cpu")
    assert m.shape == {"data": 2, "model": 2}
    assert (m.coord("data"), m.coord("model")) == (1, 1)
    assert m.line("data") == [1, 3] and m.line("model") == [2, 3]
    with pytest.raises(RuntimeError, match="no process group"):
        m.group("model")
    with pytest.raises(ValueError, match="not in the mesh"):
        Mesh(np.array([[0, 1]]), rank=5)
    x = np.arange(24).reshape(4, 6)
    assert np.array_equal(shard_batch(m, x), x[2:])
    assert np.array_equal(shard_array(m, x, (None, "model")), x[:, 3:])
    with pytest.raises(ValueError, match="does not divide"):
        shard_array(m, np.zeros((3, 2)), ("data", None))


def test_tp_specs_match_storm_tpus_on_a_float_tree():
    _, params = _vit_tiny()
    want = dict(_leaves(jax.tree.map(tuple, jax_tp_param_specs(params),
                                     is_leaf=lambda s: isinstance(s, jax.sharding.PartitionSpec))))
    got = dict(_leaves(tp_param_specs(params)))
    assert got.keys() == want.keys()
    assert got == want
    assert got[("blocks", 0, "attn", "q", "w")] == (None, "model")
    assert got[("blocks", 0, "mlp_out", "w")] == ("model", None)
    assert got[("blocks", 0, "mlp_in", "b")] == ("model",)
    assert got[("blocks", 0, "attn", "o", "b")] == ()


def test_quantize_then_shard_keeps_the_whole_k_scales():
    """Column-parallel shards slice the int8 columns and their scales,
    row-parallel ones their rows and keep every scale; the shards
    reassemble storm_tpu's quantized tree bit for bit."""
    _, params = _vit_tiny()
    q = quantize_params(params)
    jq = jax.tree.map(np.asarray, jax_quantize_params(jax.tree.map(jnp.asarray, params)))
    shards = [shard_params_tp(_mesh(2, 2, "model", r), q) for r in (0, 1)]
    specs = dict(_leaves(tp_param_specs(q)))
    assert specs[("blocks", 1, "attn", "k", "w", "__s")] == ("model",)
    assert specs[("blocks", 1, "mlp_out", "w", "__s")] == ()
    for path, want in _leaves(jq):
        parts = [dict(_leaves(s))[path] for s in shards]
        spec = specs[path]
        if spec == ():
            assert all(np.array_equal(p, want) for p in parts), path
        else:
            axis = spec.index("model")
            assert np.array_equal(np.concatenate(parts, axis=axis), want), path
            assert parts[0].shape[axis] * 2 == want.shape[axis]
    # the model axis of one rank changes nothing
    one = shard_params_tp(Mesh(np.array([[0]])), q)
    assert all(np.array_equal(a, b) for (_, a), (_, b) in zip(_leaves(one), _leaves(q)))


def test_expert_shards_and_storm_tpus_specs():
    rng = np.random.RandomState(0)
    p = moe_init(rng, 16, 32, 8)
    assert moe_param_specs() == {k: tuple(v) for k, v in jax_moe.moe_param_specs().items()}
    parts = [shard_moe_params(_mesh(2, 4, "expert", r), p) for r in range(4)]
    for k in ("w_in", "b_in", "w_out", "b_out"):
        assert np.array_equal(np.concatenate([s[k] for s in parts]), p[k])
        assert parts[1][k].shape[0] == 2
    assert all(np.array_equal(s["gate"], p["gate"]) for s in parts)
    # in a quantized model tree: the int8 experts split, the scales whole
    tree = quantize_params({"blocks": [{"moe": p, "ln": {"scale": np.ones(16, np.float32)}}]})
    sh = shard_params_ep(_mesh(1, 4, "expert", 3), tree)["blocks"][0]["moe"]
    assert sh["w_in"]["__q"].shape == (2, 16, 32) and sh["w_in"]["__s"].shape == (32,)
    assert np.array_equal(sh["w_in"]["__q"], tree["blocks"][0]["moe"]["w_in"]["__q"][6:])
    assert np.array_equal(sh["gate"]["__q"], tree["blocks"][0]["moe"]["gate"]["__q"])


class _PlayedShard(ExpertShard):
    """The layer's two collectives played in one process: the counts of
    the earlier data ranks given, the combine kept for the test to sum."""

    def __init__(self, mesh, prior):
        super().__init__(mesh)
        self._prior = prior

    def prior_counts(self, counts):
        return self._prior

    def combine(self, y):
        return y


@pytest.mark.parametrize("dp,ep,cf", [(1, 4, 1.25), (2, 2, 1.25), (2, 4, 0.5)])
def test_expert_parallel_layer_is_the_one_shard_layer(dp, ep, cf):
    """Every (data, expert) shard of the layer, its prior counts those of
    the data ranks before it and its partial combines summed (the
    all-reduce), equals the one-shard layer on the whole batch, routing
    and capacity drops included (cf 0.5 drops tokens), and storm_tpu's."""
    rng = np.random.RandomState(1)
    p = moe_init(rng, 16, 32, 8)
    x = rng.standard_normal((4, 6, 16)).astype(np.float32)
    full, _ = moe_layer({k: torch.from_numpy(v) for k, v in p.items()}, torch.from_numpy(x),
                        cf, None)
    jy, _ = jax_moe.moe_layer(jax.tree.map(jnp.asarray, p), jnp.asarray(x), cf)
    np.testing.assert_allclose(full.numpy(), np.asarray(jy), rtol=2e-5, atol=2e-5)
    rows = np.split(x, dp)
    routed = [torch.from_numpy(r.reshape(-1, 16)) @ torch.from_numpy(p["gate"]) for r in rows]
    counts = [torch.nn.functional.one_hot(g.argmax(-1), 8).float().sum(0) for g in routed]
    got = []
    for d in range(dp):
        prior = sum(counts[:d], torch.zeros(8))
        y = 0
        for e in range(ep):
            mesh = _mesh(dp, ep, "expert", d * ep + e)
            shard = {k: torch.from_numpy(v) for k, v in shard_moe_params(mesh, p).items()}
            part, aux = moe_layer(shard, torch.from_numpy(rows[d]), cf, None,
                                  _PlayedShard(mesh, prior))
            assert aux is None
            y = y + part
        got.append(y)
    np.testing.assert_allclose(torch.cat(got).numpy(), full.numpy(), rtol=0, atol=1e-6)
    # The load-balancing loss at one shard of a one-rank mesh is the
    # one-shard layer's (its sums over the data axis are the identity).
    pt = {k: torch.from_numpy(v) for k, v in p.items()}
    _, aux_full = moe_layer(pt, torch.from_numpy(x), cf, 1e-2)
    _, aux_one = moe_layer(pt, torch.from_numpy(x), cf, 1e-2,
                           _PlayedShard(_mesh(1, 1, "expert", 0), torch.zeros(8)))
    np.testing.assert_allclose(float(aux_one), float(aux_full), rtol=1e-6)


def test_row_parallel_partials_sum_to_the_dense_layer():
    """A row-parallel dense layer: each rank's slice of the rows, its f32
    partial (the w8a16 wrapper's f32 output, or an f32 product), summed
    as the all-reduce sums, then cast and the bias added once."""
    rng = np.random.RandomState(2)
    x = torch.from_numpy(rng.standard_normal((6, 64)).astype(np.float32)).bfloat16()
    w = rng.standard_normal((64, 24)).astype(np.float32) * 0.1
    b = torch.from_numpy(rng.standard_normal(24).astype(np.float32)).bfloat16()
    qt = quantize_params({"w": w})["w"]
    for weights in ("float", "int8_fused"):
        full = {"w": {"__q": torch.from_numpy(qt["__q"]), "__s": torch.from_numpy(qt["__s"])}
                if weights != "float" else torch.from_numpy(w).bfloat16(), "b": b}
        want = L.dense(full, x)
        shards, partials = [], []
        for r in range(2):
            mesh = _mesh(1, 2, "model", r)
            wr = shard_params_tp(mesh, {"mlp_out": {"w": qt if weights != "float" else w}})
            wr = wr["mlp_out"]["w"]
            wr = ({"__q": torch.from_numpy(wr["__q"]), "__s": torch.from_numpy(wr["__s"])}
                  if weights != "float" else torch.from_numpy(wr).bfloat16())
            shards.append(wr)
            partials.append(L.dense_partial(wr, x[:, 32 * r:32 * (r + 1)]))
        assert all(t.dtype == torch.float32 for t in partials)
        # rank 0's layer: its partial, plus rank 1's as the all-reduce adds it
        got = L.dense({"w": shards[0], "b": b, "reduce": lambda t: t + partials[1]},
                      x[:, :32])
        assert got.dtype == torch.bfloat16
        np.testing.assert_allclose(got.float().numpy(), want.float().numpy(), rtol=1e-2,
                                   atol=1e-2)
        exact = (partials[0] + partials[1]).bfloat16() + b
        assert torch.equal(got, exact)


def test_w8a16_f32_output_on_the_card_branch(launches):  # noqa: F811
    m, k, n = VIT_MATMULS["mlp_out"]
    k //= 2  # a tp2 row-parallel shard
    x = torch.zeros(m, k, dtype=torch.bfloat16)
    q = torch.zeros(k, n, dtype=torch.int8)
    out = qm.w8a16_matmul(x, q, torch.ones(n), out_dtype=torch.float32)
    assert out.dtype == torch.float32 and out.shape == (m, n)
    assert [c[0] for c in launches] == ["w8a16_matmul_sm90"]
    assert launches[0][1][-1] == 2 | qm.SM90_OUT_F32
    with pytest.raises(TypeError):
        qm.w8a16_matmul(x.float(), q, torch.ones(n), out_dtype=torch.bfloat16)
    ref = qm.w8a16_matmul_reference(torch.ones(2, k, dtype=torch.bfloat16),
                                    torch.ones(k, n, dtype=torch.int8), torch.ones(n) / 3,
                                    torch.float32)
    assert ref.dtype == torch.float32 and torch.allclose(ref, torch.full((2, n), k / 3))


def test_attach_tp_wires_exactly_the_row_parallel_layers(monkeypatch):
    md, params = _vit_tiny()
    q = quantize_params(params)
    module = from_jax_params(params, md, weights="int8_fused", device="cpu",
                             shard=lambda t: shard_params_tp(_mesh(1, 2, "model", 0), t))
    assert module.blocks[0].attn.q.q.shape == (64, 32)
    seen = []
    monkeypatch.setattr(collectives, "all_reduce",
                        lambda t, mesh, axis: seen.append((t.shape, axis)) or t)
    attach_tp(module, None, q)
    names = {n for n, m in module.named_modules() if isinstance(m, Dense) and m.reduce}
    assert names == row_parallel_paths(params) == {
        "blocks.0.attn.o", "blocks.0.mlp_out", "blocks.1.attn.o", "blocks.1.mlp_out"}
    with torch.inference_mode():
        module(torch.zeros(2, *SHAPE))
    assert seen == [((2, 17, 64), "model")] * 4  # f32 partials at full width
    # a module whose paths do not mirror its parameters is refused
    bad = from_jax_params(params, md, device="cpu")
    bad.blocks[0].attn.o, bad.blocks[0].attn.q = bad.blocks[0].attn.q, bad.blocks[0].attn.o
    with pytest.raises(ValueError):
        attach_tp(bad, None, {"blocks": [{"attn": {"o": {"w": 0}, "p": {"w": 0}}}]})


def _engine(name: str, sharding: ShardingConfig, mesh=None, **model):
    shape = (64, 16) if name.startswith("longseq") else SHAPE
    mc = ModelConfig(name=name, input_shape=model.pop("input_shape", shape), num_classes=10,
                     dtype="float32", **model)
    return InferenceEngine(mc, BATCH, device="cpu", sharding_cfg=sharding, mesh=mesh)


def test_engine_refuses_storm_tpus_misconfigurations():
    with pytest.raises(ValueError, match="mutually exclusive"):
        _engine("longseq_tiny", ShardingConfig(2, 2, 2))
    with pytest.raises(ValueError, match="mutually exclusive"):
        _engine("moe_vit_tiny", ShardingConfig(2, 2, expert_parallel=2))
    with pytest.raises(ValueError, match="apply_sp"):
        _engine("lenet5", ShardingConfig(2, sequence_parallel=4), input_shape=(28, 28, 1))
    with pytest.raises(ValueError, match="not divisible"):
        _engine("longseq_tiny", ShardingConfig(1, sequence_parallel=4), input_shape=(63, 16))
    ep4 = _mesh(1, 4, "expert", 0)
    with pytest.raises(ValueError, match="no MoE params"):
        _engine("resnet20", ShardingConfig(1, expert_parallel=4), mesh=ep4)
    with pytest.raises(ValueError, match="not divisible"):
        _engine("moe_vit_tiny", ShardingConfig(1, expert_parallel=8),
                mesh=_mesh(1, 8, "expert", 0))
    with pytest.raises(ValueError, match="heads"):
        _engine("vit_tiny", ShardingConfig(1, 3), mesh=_mesh(1, 3, "model", 0))
    # a multi-rank mesh without a process group raises, and makes none
    for sh in (ShardingConfig(data_parallel=2), ShardingConfig(1, 2),
               ShardingConfig(2, sequence_parallel=2)):
        with pytest.raises(RuntimeError, match="init_process_group"):
            _engine("longseq_tiny", sh)
    assert not dist.is_initialized()


def test_default_path_makes_no_process_group_and_keeps_its_graphs():
    eng = _engine("vit_tiny", ShardingConfig())
    assert not dist.is_initialized()
    assert (eng.mesh.size, eng.tp, eng.sp, eng.ep, eng.multirank) == (1, 1, 1, 1, False)
    assert eng.pipeline_depth == 2 and eng.ring_capacity == 2
    eng.predict(np.zeros((3, *SHAPE), np.float32))
    bucket = eng.graph_for(8)
    assert bucket.capture and eng.pad_batch(3) == 8
    assert eng.param_bytes() == eng.param_bytes_per_device()
    assert not dist.is_initialized()


def test_shared_engine_key_carries_the_sharding():
    clear_engines()
    try:
        mc = ModelConfig(name="lenet5", input_shape=(28, 28, 1), num_classes=10,
                         dtype="float32")
        a = shared_engine(mc, BATCH, device="cpu")
        assert shared_engine(mc, BATCH, device="cpu", sharding_cfg=ShardingConfig()) is a
        b = shared_engine(mc, BATCH, device="cpu", sharding_cfg=ShardingConfig(0))
        assert b is not a and b.mesh.size == 1
        bolt = InferenceBolt(mc, BATCH, device="cpu", sharding=ShardingConfig(0))
        assert bolt.clone().sharding_cfg == ShardingConfig(0)
        assert bolt._shared_engine() is b
        assert InferenceBolt(mc, BATCH, device="cpu")._shared_engine() is a
    finally:
        clear_engines()


def test_sequence_parallel_forward_on_one_rank_is_the_dense_forward():
    """``apply_sp`` on a seq axis of one rank (plain norms, the ring of one
    shard) against the dense forward (the fused norm, flash) in float32."""
    md = model_def("longseq_tiny", num_classes=10, input_shape=(64, 16))
    params, state = init_params(md, 3)
    module = from_jax_params(params, md, state, device="cpu")
    x = torch.from_numpy(np.random.RandomState(4).rand(2, 64, 16).astype(np.float32))
    mesh = Mesh(np.array([[0]]), ("data", "seq"), device="cpu")
    with torch.inference_mode():
        want = module(x)
        got = module.forward_sp(x, mesh)
        tensors = {n: b for n, b in module.named_buffers()}
        assert tensors  # the module holds the prepared tensors
    np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=1e-5, atol=1e-5)
    assert md.apply_sp is not None and model_def("vit_tiny").apply_sp is None
