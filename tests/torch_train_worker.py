"""Rank half of ``tests/test_torch_train_parallel.py``: the function each
of a gloo world's four CPU processes runs
(``storm_tpu_torch.parallel.launch.spawn_ranks``), the counterpart of
``tests/mh_train_worker.py``. It imports the port alone (no JAX), runs
every case it is given in one order on every rank (the multi-process
contract), and returns each case's result as numpy; the test holds them
against storm_tpu and against the port's one-rank step.

Cases (``kind``):

- ``sharded``: ``init_sharded_training`` on a (dp, tp) mesh and
  ``train_one_step`` over the given global batches: each step's loss, step
  1's gradients (the TP shards gathered, ``gather_params_tp``) and state,
  this rank's leaves and the state after the last step;
- ``pp``: ``init_pp_training`` on a (data, stage) mesh: each step's loss,
  step 1's gradients (``rest``, and the stages gathered over the stage
  axis in storm_tpu's stacked layout), this rank's leaves after the last;
- ``pipeline``: ``pipeline_apply`` of numpy blocks over a (data, stage)
  mesh, the output gathered over the data axis; with fewer microbatches
  than stages, the refusal's message;
- ``seq_grad``: the gradient of the sum of squares of
  ``seq_parallel_encoder``'s output, the blocks' summed over the ranks
  and the input's gathered;
- ``moe_grad``: the gradient of storm_tpu's ``test_moe_block_trains`` loss
  through ``moe_block`` at an expert shard of a (data, expert) mesh, each
  data rank adding its part of the loss;
- ``collectives``: each differentiable collective's backward in the world;
- ``converge``: ``train_to_convergence(..., mesh=)`` at dp x tp.
"""

from __future__ import annotations

import numpy as np
import torch

from storm_tpu_torch.data import train_to_convergence
from storm_tpu_torch.models import model_def
from storm_tpu_torch.models.convert import _map, host_tree, trainable_params
from storm_tpu_torch.models.vit import Block, build_vit
from storm_tpu_torch.parallel import collectives as C
from storm_tpu_torch.parallel.mesh import make_mesh
from storm_tpu_torch.parallel.moe import ExpertShard, moe_block, shard_moe_params
from storm_tpu_torch.parallel.pipeline import init_pp_training, pipeline_apply, split_blocks
from storm_tpu_torch.parallel.sequence import seq_parallel_encoder, shard_sequence
from storm_tpu_torch.parallel.sharding import gather_params_tp, shard_array, shard_batch
from storm_tpu_torch.parallel.train import init_sharded_training, train_one_step


def model(spec: dict):
    """The port's model of ``spec``: a registered family, or (``depth``
    given) a vit_tiny-wide ViT of that depth."""
    if "depth" in spec:
        return build_vit(spec["name"], 10, (32, 32, 3), patch=8, dim=64, depth=spec["depth"],
                         num_heads=4, mlp_dim=128)
    return model_def(spec["name"], **spec.get("kw", {}))


def _sharded(case: dict) -> dict:
    mesh = make_mesh(case["dp"], case["tp"], device="cpu")
    step, params, opt_state, state = init_sharded_training(
        model(case["model"]), mesh, learning_rate=case.get("lr", 1e-3), device="cpu",
        init=case["init"])
    out = {"losses": []}
    for i, (x, y) in enumerate(case["batches"]):
        params, opt_state, state, loss = train_one_step(step, mesh, params, opt_state, state,
                                                        x, y)
        out["losses"].append(float(loss))
        if i == 0:
            grads = _map(lambda p, _path: p.grad, params)
            out["grads"] = host_tree(gather_params_tp(mesh, grads))
            out["state1"] = host_tree(state)
    out["params"] = host_tree(params)
    out["state"] = host_tree(state)
    return out


def _pp(case: dict) -> dict:
    mesh = make_mesh(case["dp"], case["stages"], ("data", "stage"), device="cpu")
    step, ps, opt_state = init_pp_training(
        model(case["model"]), mesh, n_micro=case["n_micro"], num_heads=case.get("heads"),
        learning_rate=case.get("lr", 1e-3), device="cpu", init=(case["init"], {}))
    out = {"losses": [], "heads": step.heads}
    for i, (x, y) in enumerate(case["batches"]):
        ps, opt_state, loss = step(ps, opt_state, x, y)
        out["losses"].append(float(loss))
        if i == 0:
            rest, stages = _map(lambda p, _path: p.grad, ps)
            stages = _map(lambda g, _path: C.all_gather(g, mesh, "stage"), stages)
            out["grads"] = (host_tree(rest), host_tree(stages))
    out["params"] = host_tree(ps)
    return out


def _pipeline(case: dict) -> dict:
    mesh = make_mesh(case["dp"], case["stages"], ("data", "stage"), device="cpu")
    heads = case["heads"]
    blocks = _map(lambda a, _p: torch.from_numpy(np.asarray(a, np.float32)), case["blocks"])
    stages = _map(lambda a, _p: shard_array(mesh, a, ("stage",)),
                  split_blocks(blocks, case["stages"]))

    def stage_fn(local, act):
        for i in range(len(local["ln1"]["scale"])):
            act = Block(_map(lambda leaf, _p: leaf[i], local), heads)(act)
        return act

    x = torch.from_numpy(shard_array(mesh, case["x"], (None, "data")))
    try:
        with torch.no_grad():
            y = pipeline_apply(mesh, stage_fn, stages, x)
    except ValueError as e:
        return {"refused": str(e)}
    return {"y": C.all_gather(y, mesh, "data", dim=1).numpy()}


def _seq_grad(case: dict) -> dict:
    mesh = make_mesh(case["dp"], case["sp"], ("data", "seq"), device="cpu")
    blocks = trainable_params(case["blocks"], "cpu")
    x = torch.from_numpy(shard_sequence(mesh, shard_batch(mesh, case["x"]), "seq"))
    x.requires_grad_()
    y = seq_parallel_encoder(blocks, x, case["heads"], mesh, seq_axis="seq")
    (y ** 2).sum().backward()
    grads = _map(lambda p, _path: p.grad, blocks)
    flat = []
    _map(lambda g, _path: flat.append(g), grads)
    for axis in ("seq", "data"):
        C.all_reduce_grads(flat, mesh, axis, mean=False)
    gx = C.all_gather(C.all_gather(x.grad, mesh, "seq", dim=1), mesh, "data", dim=0)
    return {"blocks": host_tree(grads), "x": gx.numpy()}


def _moe_grad(case: dict) -> dict:
    dp, ep = case["dp"], case["ep"]
    mesh = make_mesh(dp, ep, ("data", "expert"), device="cpu")
    p = dict(case["params"])
    p["moe"] = shard_moe_params(mesh, p["moe"])
    p = trainable_params(p, "cpu")
    x = torch.from_numpy(shard_batch(mesh, case["x"]))
    y, aux = moe_block(p, x, case["heads"], case["cf"], 1e-2,
                       ExpertShard(mesh, "expert", "data"))
    # Each data rank's part of storm_tpu's loss, sum(y ** 2) * 1e-3 + aux.
    ((y ** 2).sum() * 1e-3 + aux / dp).backward()
    grads = _map(lambda t, _path: t.grad, p)
    flat = []
    _map(lambda g, _path: flat.append(g), grads)
    C.all_reduce_grads(flat, mesh, "data", mean=False)
    grads["moe"] = {k: (g if k == "gate" else C.all_gather(g, mesh, "expert"))
                    for k, g in grads["moe"].items()}
    return {"grads": host_tree(grads), "aux": float(aux)}


def _collectives(rank: int) -> dict:
    """Each collective's forward and gradient on a (2, 2) mesh (ranks
    [[0, 1], [2, 3]]): over the model axis (the replicated convention) or
    the data axis (partitioned), this rank's loss ``(rank + 1)`` times the
    sum of the output; and on a mesh of one, the identity."""
    mesh = make_mesh(2, 2, device="cpu")
    base = torch.arange(6.0).reshape(2, 3)
    out = {}
    for name, fn, axis in [("copy_to_axis", C.copy_to_axis, "model"),
                           ("reduce_from_axis", C.reduce_from_axis, "model"),
                           ("gather_from_axis", C.gather_from_axis, "model"),
                           ("sum_over_axis", C.sum_over_axis, "data"),
                           ("ring_shift", C.ring_shift, "data")]:
        t = (base * (rank + 1)).requires_grad_()
        y = fn(t, mesh, axis)
        ((rank + 1) * y.sum()).backward()
        out[name] = (y.detach().numpy(), t.grad.numpy())
    grads = [base * (rank + 1), torch.full((4,), float(rank))]
    C.all_reduce_grads(grads, mesh, "data", mean=True)
    out["all_reduce_grads"] = [g.numpy() for g in grads]
    rep = [base * (rank + 1)]
    C.replicate_grads(rep, mesh, "model")
    out["replicate_grads"] = rep[0].numpy()
    one = make_mesh(1, 1, device="cpu")
    t = base.clone().requires_grad_()
    ys = [C.copy_to_axis(t, one, "model"), C.reduce_from_axis(t, one, "model"),
          C.sum_over_axis(t, one, "data"), C.gather_from_axis(t, one, "model"),
          C.ring_shift(t, one, "data")]
    out["axis_of_one"] = all(y is t for y in ys)
    return out


def _converge(case: dict) -> dict:
    mesh = make_mesh(case["dp"], case["tp"], device="cpu")
    params, state, hist = train_to_convergence(
        model(case["model"]), *case["data"], device="cpu", init=case["init"], mesh=mesh,
        **case["args"])
    return {"params": params, "state": state, "history": hist}


def run(rank: int, world: int, cases: list) -> dict:
    torch.manual_seed(0)
    torch.set_num_threads(1)
    kinds = {"sharded": _sharded, "pp": _pp, "pipeline": _pipeline, "seq_grad": _seq_grad,
             "moe_grad": _moe_grad, "converge": _converge}
    out = {}
    for case in cases:
        if case["kind"] == "collectives":
            out[case["id"]] = _collectives(rank)
        else:
            out[case["id"]] = kinds[case["kind"]](case)
    return out
