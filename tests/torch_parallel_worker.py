"""Rank half of ``tests/test_torch_parallel_serve.py``: the function each
of a gloo world's four CPU processes runs (``storm_tpu_torch.parallel.
launch.spawn_ranks``). It imports the port alone (no JAX), runs every
case it is given in one order on every rank (the multi-process contract),
and returns each case's result; the test holds them against storm_tpu's
sharded engines on the same parameters and inputs.

Cases (``kind``):

- ``ring``: storm_tpu-shaped (B, H, S, D) q, k, v; a (4 / n, n) mesh of
  ("data", "seq"); this rank's sequence shard through ``ring_attention``,
  the shards gathered over the seq axis;
- ``seq_encoder``: ``seq_parallel_encoder`` over numpy block parameters
  at dp x sp, the rows and the sequence gathered back;
- ``engine``: an ``InferenceEngine`` with a ``ShardingConfig``, one batch
  through the port's JSON codec (decode, ``predict``, encode);
- ``accuracy``: an ``InferenceEngine`` over held-out digits in slices.
"""

from __future__ import annotations

import json

import numpy as np
import torch

from storm_tpu_torch.api.schema import decode_instances, decode_predictions, encode_predictions
from storm_tpu_torch.config import BatchConfig, ModelConfig, ShardingConfig
from storm_tpu_torch.infer.engine import InferenceEngine
from storm_tpu_torch.models.convert import prepare_params
from storm_tpu_torch.parallel.collectives import all_gather
from storm_tpu_torch.parallel.mesh import make_mesh
from storm_tpu_torch.parallel.ring_attention import ring_attention
from storm_tpu_torch.parallel.sequence import seq_parallel_encoder, shard_sequence
from storm_tpu_torch.parallel.sharding import shard_array, shard_batch


def _ring(case: dict, world: int) -> np.ndarray:
    n = case["shards"]
    mesh = make_mesh(world // n, n, ("data", "seq"), device="cpu")
    spec = (None, None, "seq", None)
    q, k, v = (torch.from_numpy(shard_array(mesh, a, spec)) for a in case["qkv"])
    out = ring_attention(q, k, v, mesh, seq_axis="seq")
    return all_gather(out, mesh, "seq", dim=2).numpy()


def _seq_encoder(case: dict, world: int) -> np.ndarray:
    dp, sp = case["dp"], case["sp"]
    mesh = make_mesh(dp, sp, ("data", "seq"), device="cpu")
    blocks = prepare_params(case["blocks"], "float", torch.float32)
    x = torch.from_numpy(shard_sequence(mesh, shard_batch(mesh, case["x"]), "seq"))
    y = seq_parallel_encoder(blocks, x, case["heads"], mesh, seq_axis="seq")
    y = all_gather(y, mesh, "seq", dim=1)
    return all_gather(y, mesh, "data", dim=0).numpy()


def _engine(case: dict) -> dict:
    eng = InferenceEngine(ModelConfig(**case["model"]), BatchConfig(**case["batch"]),
                          device="cpu", params=case.get("params"), state=case.get("state"),
                          sharding_cfg=ShardingConfig(**case["sharding"]))
    inst = decode_instances(json.dumps({"instances": case["x"].tolist()}))
    preds = eng.predict(inst.data)
    wire = encode_predictions(preds)
    assert np.allclose(decode_predictions(wire).data, preds, atol=1e-6)
    return {"preds": preds, "wire": wire, "tp": eng.tp, "sp": eng.sp, "ep": eng.ep,
            "mesh": dict(eng.mesh.shape), "pipeline_depth": eng.pipeline_depth,
            "param_bytes": eng.param_bytes(),
            "param_bytes_per_device": eng.param_bytes_per_device(),
            "forwards": eng.forwards, "tally": eng.launch_tally()}


def _accuracy(case: dict) -> np.ndarray:
    eng = InferenceEngine(ModelConfig(**case["model"]), BatchConfig(**case["batch"]),
                          device="cpu", sharding_cfg=ShardingConfig(**case["sharding"]))
    x, step = case["x"], case["batch"]["max_batch"]
    return np.concatenate([eng.predict(x[i:i + step]) for i in range(0, len(x), step)])


def run(rank: int, world: int, cases: list) -> dict:
    torch.manual_seed(0)
    torch.set_num_threads(1)
    out = {}
    for case in cases:
        kind = case["kind"]
        if kind == "ring":
            out[case["id"]] = _ring(case, world)
        elif kind == "seq_encoder":
            out[case["id"]] = _seq_encoder(case, world)
        elif kind == "engine":
            out[case["id"]] = _engine(case)
        elif kind == "accuracy":
            out[case["id"]] = _accuracy(case)
        else:
            raise ValueError(f"unknown case kind {kind!r}")
    return out
