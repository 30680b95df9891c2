"""The port's sharded training in a gloo world of four CPU processes, held
against storm_tpu's on the 8 CPU devices of ``tests/conftest.py`` and
against the port's one-rank step, on the same parameters and batches.

A module fixture spawns the world once (:func:`run_world`:
``parallel.launch.spawn_ranks``, every rank joined with a deadline and
killed in its ``finally``); each rank (``tests/torch_train_worker.py``,
which imports no JAX) runs every case in one order, while this process
computes storm_tpu's references and the port's one-rank ones. Both
packages start from one numpy tree: vit_tiny's is storm_tpu's
``init_params(model, 0)`` as ``checkpoints_torch/vit_tiny_init.npz``
holds it, and storm_tpu's ``init_sharded_training`` is handed it through
its model's ``init`` (:func:`jax_model`), which spares seconds of its
eager initialization.

- ``init_sharded_training`` + ``train_one_step`` on vit_tiny at dp4,
  dp2 x tp2 and tp4: the losses of 3 AdamW steps (optax's defaults)
  against storm_tpu's on a mesh of the same shape, within 1e-4 relative
  (storm_tpu's own bound, ``tests/test_parallel.py:65``); step 1's
  gradients against the port's one-rank step, leaf by leaf, within
  GRAD_TOL of the leaf's gradient norm (the attention key biases, whose
  gradient is zero in exact arithmetic, within GRAD_TOL of the whole
  gradient's norm); after step 3 every leaf a rank holds byte-identical
  to the leaf the other ranks of its data line hold, and every replicated
  leaf to its model line's;
- each differentiable collective's forward and backward in the world, and
  on an axis of one in this process;
- ``train_to_convergence(mesh=)`` at dp4 (resnet20) and dp2 x tp2
  (vit_tiny) against the port's one-rank run;
- a world of one, the (data, stage) mesh, the card rule, and C20
  (``init_pp_training``'s default heads).

storm_tpu compiles each sharded step for seconds on the CPU, so the
pipeline's comparisons are in ``tests/test_torch_train_pipeline.py`` and
BatchNorm's, sequence and expert parallelism's in
``tests/test_torch_train_bn_sp_ep.py``, each file under 30 s alone.
"""

import concurrent.futures
import dataclasses
import functools
import threading

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from storm_tpu.models.registry import build_model as jax_build_model
from storm_tpu.parallel.mesh import make_mesh as jax_make_mesh
from storm_tpu.parallel.train import init_sharded_training as jax_init_sharded_training
from storm_tpu.parallel.train import train_one_step as jax_train_one_step
from storm_tpu_torch.data import load_digits_nhwc, train_to_convergence
from storm_tpu_torch.models import model_def
from storm_tpu_torch.models.convert import _map, host_tree, state_tensors, trainable_params
from storm_tpu_torch.models.registry import CHECKPOINTS, load_checkpoint
from storm_tpu_torch.parallel import collectives as C
from storm_tpu_torch.parallel.launch import spawn_ranks
from storm_tpu_torch.parallel.mesh import Mesh, make_mesh
from storm_tpu_torch.parallel.pipeline import default_heads, init_pp_training
from storm_tpu_torch.parallel.sharding import replicated_leaves
from storm_tpu_torch.parallel.train import (
    init_sharded_training, make_train_step, train_one_step)
from tests import torch_train_worker as worker

WORLD = 4
GRAD_TOL = 1e-4
LOSS_RTOL = 1e-4
# (label, dp, tp) of the dp x tp step.
SHARDED = [("dp4", 4, 1), ("dp2xtp2", 2, 2), ("tp4", 1, 4)]
RESNET = {"name": "resnet20", "kw": {"input_shape": (16, 16, 3)}}
CONVERGE = [("resnet20 dp4", RESNET, 4, 1), ("vit_tiny dp2xtp2", {"name": "vit_tiny"}, 2, 2)]
CONVERGE_ARGS = {"batch_size": 64, "max_epochs": 1, "patience": 8, "seed": 0}
# train_to_convergence's one epoch is 4 AdamW steps at optax's eps 1e-8,
# where an element whose gradient is near rounding level steps by up to
# the learning rate in a direction rounding sets (tests/test_torch_train_init.py):
# the snapshot is held within 4 learning rates, and the BatchNorm state
# the last step's statistics computed from it within 2e-3. Step 1's
# gradients agree within 3e-6 relative (tests/test_torch_train_bn_sp_ep.py);
# after the 4 steps resnet20 dp4 read 1.4e-3 on the snapshot, 4.0e-4 on
# the state and 7.1e-6 on the epoch's loss, and the same run with
# BatchNorm on each rank's rows alone 7.9e-3, 0.19 and 3.7e-3.
SNAPSHOT_TOL = 4e-3
STATE_TOL = 2e-3


# ---- helpers shared with the pipeline's and BN/SP/EP's files ----------------------


def items(tree, prefix=()):
    """``(path, leaf)`` of a tree of dicts, lists and tuples."""
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from items(v, prefix + (k,))
    elif isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            yield from items(v, prefix + (i,))
    else:
        yield prefix, tree


def flat_np(tree) -> dict:
    return {p: np.asarray(v.detach() if isinstance(v, torch.Tensor) else v, np.float32)
            for p, v in items(tree)}


def grads_close(got, want, what: str) -> None:
    """Leaf by leaf: |got - want| / |want| within GRAD_TOL (2-norms); a key
    bias, zero in exact arithmetic, against the whole gradient's norm."""
    g, w = flat_np(got), flat_np(want)
    assert g.keys() == w.keys(), (what, sorted(map(str, g.keys() ^ w.keys()))[:4])
    total = np.sqrt(sum(float(np.square(a).sum()) for a in w.values()))
    for k in w:
        scale = total if k[-2:] == ("k", "b") else float(np.linalg.norm(w[k]))
        err = float(np.linalg.norm(g[k] - w[k])) / scale
        assert err <= GRAD_TOL, (what, k, err)


def losses_close(got: list, want: list, what: str) -> None:
    assert len(got) == len(want) == 3, (what, got, want)
    for g, w in zip(got, want):
        assert abs(g - w) <= LOSS_RTOL * abs(w), (what, got, want)


def batches(shape, n: int = 3, rows: int = 8, seed: int = 1) -> list:
    rng = np.random.RandomState(seed)
    return [(rng.rand(rows, *shape).astype(np.float32),
             rng.randint(0, 10, rows).astype(np.int32)) for _ in range(n)]


def jax_model(jm, params, state=None):
    """storm_tpu's model whose ``init`` returns the given numpy trees (as
    JAX arrays), whatever its key: storm_tpu's training entry points then
    start from the port's numbers without an eager init."""
    tree = (jax.tree.map(jnp.asarray, params), jax.tree.map(jnp.asarray, state or {}))
    return dataclasses.replace(jm, init=lambda _rng: tree)


def one_rank(md, init, bs) -> dict:
    """The port's one-rank step (make_train_step): losses, step 1's grads."""
    step, opt = make_train_step(md, device="cpu")
    params = trainable_params(init[0], "cpu")
    opt_state, state, out = opt(params), state_tensors(init[1], "cpu"), {"losses": []}
    for i, (x, y) in enumerate(bs):
        params, opt_state, state, loss = step(params, opt_state, state, x, y)
        out["losses"].append(float(loss))
        if i == 0:
            out["grads"] = host_tree(_map(lambda p, _path: p.grad, params))
    return out


def run_world(cases: list, here) -> dict:
    """The ranks' results (one dict a rank) and ``here()``'s, computed in
    this process while the ranks run."""
    out = {}

    def ranks():
        try:
            out["ranks"] = spawn_ranks("tests.torch_train_worker:run", WORLD,
                                       {"cases": cases}, timeout_s=150,
                                       env={"OMP_NUM_THREADS": "1"})
        except BaseException as e:  # noqa: BLE001 - reported by the tests
            out["error"] = e

    thread = threading.Thread(target=ranks, daemon=True)
    thread.start()
    try:
        mine = here()
    finally:
        thread.join(timeout=180)
    if "error" in out:
        raise out["error"]
    assert "ranks" in out, "the rank processes did not finish"
    return {"ranks": out["ranks"], **mine}


def in_threads(jobs: dict) -> dict:
    """``{key: job()}``, the jobs (storm_tpu's references, which spend
    their time in XLA's compiler) run in threads of their own."""
    with concurrent.futures.ThreadPoolExecutor(len(jobs)) as pool:
        futures = {k: pool.submit(job) for k, job in jobs.items()}
        return {k: f.result() for k, f in futures.items()}


def line_replicas(ranks: list, label: str, key, shape: tuple, axis: int,
                  keep=lambda path: True) -> None:
    """The leaves (``keep``) of ``ranks[r][label][key]`` byte-identical
    across each line along mesh axis ``axis`` of the (dp, n) grid of ranks
    ``shape``."""
    grid = np.arange(WORLD).reshape(shape)
    for line in (grid.T if axis == 0 else grid):
        first = flat_np(ranks[line[0]][label][key])
        for r in line[1:]:
            other = flat_np(ranks[r][label][key])
            assert first.keys() == other.keys()
            assert all(np.array_equal(first[k], other[k]) for k in first if keep(k)), (label, r)


# ---- the world -------------------------------------------------------------------


def _digits(shape) -> tuple:
    x_tr, y_tr, x_te, y_te = load_digits_nhwc(shape)
    return x_tr[:256], y_tr[:256], x_te[:128], y_te[:128]


@pytest.fixture(scope="module")
def world():
    vit = load_checkpoint(str(CHECKPOINTS / "vit_tiny_init.npz"))[:2]
    res_md = worker.model(RESNET)
    res = res_md.init(np.random.RandomState(0))
    bs = batches((32, 32, 3))
    data = {"resnet20 dp4": (res_md, res, _digits((16, 16, 3))),
            "vit_tiny dp2xtp2": (model_def("vit_tiny"), vit, _digits((32, 32, 3)))}
    cases = [dict(kind="collectives", id="collectives")]
    cases += [dict(kind="sharded", id=label, model={"name": "vit_tiny"}, init=vit, dp=dp,
                   tp=tp, batches=bs) for label, dp, tp in SHARDED]
    cases += [dict(kind="converge", id=label, model=spec, dp=dp, tp=tp, init=data[label][1],
                   data=data[label][2], args=CONVERGE_ARGS) for label, spec, dp, tp in CONVERGE]

    jvit = jax_model(jax_build_model("vit_tiny"), *vit)

    def storm_tpu_losses(dp: int, tp: int) -> list:
        mesh = jax_make_mesh(dp, tp, devices=jax.devices()[:dp * tp])
        step, params, opt_state, state = jax_init_sharded_training(jvit, mesh, seed=0)
        losses = []
        for x, y in bs:
            params, opt_state, state, loss = jax_train_one_step(step, mesh, params, opt_state,
                                                                state, x, y)
            losses.append(float(loss))
        return losses

    def here():
        ref = in_threads({label: functools.partial(storm_tpu_losses, dp, tp)
                          for label, dp, tp in SHARDED})
        one = {"vit_tiny": one_rank(model_def("vit_tiny"), vit, bs)}
        for label, (md, init, digits) in data.items():
            one[label] = train_to_convergence(md, *digits, device="cpu", init=init,
                                              **CONVERGE_ARGS)
        return {"ref": ref, "one": one, "vit": vit}

    return run_world(cases, here)


# ---- the collectives -----------------------------------------------------------


COLLECTIVES = ["copy_to_axis", "reduce_from_axis", "gather_from_axis", "sum_over_axis",
               "ring_shift", "all_reduce_grads", "replicate_grads"]


@pytest.mark.parametrize("name", COLLECTIVES)
def test_collective_and_its_backward_in_the_world(world, name):
    """On the (2, 2) mesh [[0, 1], [2, 3]], each rank's tensor is
    ``base * (rank + 1)`` and its loss ``(rank + 1) * sum(output)``."""
    base = np.arange(6.0, dtype=np.float32).reshape(2, 3)
    w = {r: r + 1.0 for r in range(WORLD)}
    for rank, res in enumerate(world["ranks"]):
        got = res["collectives"][name]
        model_line = [rank - rank % 2, rank - rank % 2 + 1]  # the same data index
        data_line = [rank % 2, rank % 2 + 2]  # the same model index
        if name == "copy_to_axis":  # f: identity; the gradient summed over the line
            want = (base * w[rank], np.full_like(base, sum(w[r] for r in model_line)))
        elif name == "reduce_from_axis":  # g: the sum; the gradient as it is
            want = (base * sum(w[r] for r in model_line), np.full_like(base, w[rank]))
        elif name == "gather_from_axis":  # the line's tensors; this rank's slice back
            want = (np.concatenate([base * w[r] for r in model_line]),
                    np.full_like(base, w[rank]))
        elif name == "sum_over_axis":  # the sum; every rank's loss's gradient summed
            want = (base * sum(w[r] for r in data_line),
                    np.full_like(base, sum(w[r] for r in data_line)))
        elif name == "ring_shift":  # from the rank behind; the gradient sent back
            other = data_line[1 - data_line.index(rank)]
            want = (base * w[other], np.full_like(base, w[other]))
        elif name == "all_reduce_grads":
            want = (base * np.mean([w[r] for r in data_line]),
                    np.full(4, np.mean([float(r) for r in data_line]), np.float32))
        else:  # replicate_grads: model rank 0's, bit for bit
            want = (base * w[model_line[0]],)
            got = (got,)
        assert len(got) == len(want)
        for g, e in zip(got, want):
            np.testing.assert_array_equal(g, e)
        assert res["collectives"]["axis_of_one"]


def test_collectives_on_an_axis_of_one_in_one_process():
    """No process group: over an axis of one rank each differentiable
    collective is the identity, and autograd passes the gradient through."""
    mesh = make_mesh(1, 1, device="cpu")
    t = torch.arange(6.0).reshape(2, 3).requires_grad_()
    y = t
    for fn in (C.copy_to_axis, C.reduce_from_axis, C.sum_over_axis, C.gather_from_axis,
               C.ring_shift):
        y = fn(y, mesh, "model")
    assert y is t
    (3 * y).sum().backward()
    assert torch.equal(t.grad, torch.full((2, 3), 3.0))
    g = [torch.ones(3)]
    assert C.all_reduce_grads(g, mesh, "data") is g and torch.equal(g[0], torch.ones(3))
    assert C.replicate_grads(g, mesh, "model") is g and torch.equal(g[0], torch.ones(3))


# ---- the dp x tp step -----------------------------------------------------------


@pytest.mark.parametrize("label", [s[0] for s in SHARDED])
def test_sharded_step_losses_match_storm_tpu(world, label):
    for r in world["ranks"]:
        losses_close(r[label]["losses"], world["ref"][label], label)
        assert r[label]["losses"] == world["ranks"][0][label]["losses"]


@pytest.mark.parametrize("label,dp,tp", SHARDED)
def test_sharded_step_gradients_and_replicas(world, label, dp, tp):
    """Step 1's gradients, gathered, against the one-rank step's; after
    step 3 each rank's leaves equal those of its data line bit for bit
    (the same shard), and its replicated leaves those of its model line."""
    ranks = world["ranks"]
    for r in ranks:
        grads_close(r[label]["grads"], world["one"]["vit_tiny"]["grads"], label)
    line_replicas(ranks, label, "params", (dp, tp), 0)
    whole = {k for k, rep in items(replicated_leaves(world["vit"][0])) if rep}
    assert len(whole) == 20  # embed (2), cls, pos, ln (2), head (2); 2 x (ln1, ln2, o.b, mlp_out.b)
    line_replicas(ranks, label, "params", (dp, tp), 1, keep=lambda k: k in whole)


# ---- train_to_convergence over a mesh ----------------------------------------------


@pytest.mark.parametrize("label", [c[0] for c in CONVERGE])
def test_train_to_convergence_over_a_mesh_is_the_one_rank_run(world, label):
    """One epoch of 4 steps on 256 digits rows, evaluated on 128: the
    epoch's mean loss within 1e-4 relative of the one-rank run's, the
    held-out accuracy equal, the snapshot (whole, the same on every rank)
    within SNAPSHOT_TOL and its BatchNorm state within STATE_TOL."""
    want_p, want_s, want_h = world["one"][label]
    for r in world["ranks"]:
        got = r[label]
        assert [h["epoch"] for h in got["history"]] == [h["epoch"] for h in want_h] == [0]
        for g, w in zip(got["history"], want_h):
            assert abs(g["loss"] - w["loss"]) <= LOSS_RTOL * w["loss"], (g, w)
            assert g["val_acc"] == w["val_acc"], (g, w)
        gp, wp = flat_np(got["params"]), flat_np(want_p)
        assert gp.keys() == wp.keys()
        for k in wp:
            assert np.abs(gp[k] - wp[k]).max() <= SNAPSHOT_TOL, (label, k)
        gs, ws = flat_np(got["state"]), flat_np(want_s)
        assert gs.keys() == ws.keys()
        for k in ws:
            assert np.abs(gs[k] - ws[k]).max() <= STATE_TOL, (label, k)
    line_replicas(world["ranks"], label, "params", (WORLD, 1), 0)
    line_replicas(world["ranks"], label, "state", (WORLD, 1), 0)


# ---- meshes, the one-rank rule, the card, C20 -------------------------------------


def test_a_data_stage_mesh_and_a_world_of_one():
    """``make_mesh(..., axis_names=("data", "stage"))`` lays a stage axis
    as the model axis is laid; a world of one takes the one-device step
    exactly (the same losses, bit for bit), and a one-device step refuses
    a mesh of more ranks."""
    m = Mesh(np.arange(4).reshape(2, 2), ("data", "stage"), rank=3)
    assert m.shape == {"data": 2, "stage": 2} and m.coord("stage") == 1
    assert m.line("stage") == [2, 3] and m.line("data") == [1, 3]
    one = make_mesh(1, 1, ("data", "stage"), device="cpu")
    assert one.shape == {"data": 1, "stage": 1} and one.group("stage") is None
    md = model_def("lenet5")
    init = md.init(np.random.RandomState(0))
    bs = batches((28, 28, 1), 3, rows=4)
    mesh = make_mesh(1, 1, device="cpu")
    step, params, opt_state, state = init_sharded_training(md, mesh, device="cpu", init=init)
    ref = one_rank(md, init, bs)
    for (x, y), want in zip(bs, ref["losses"]):
        params, opt_state, state, loss = train_one_step(step, mesh, params, opt_state, state,
                                                        x, y)
        assert float(loss) == want
    step1, _ = make_train_step(md, device="cpu")
    with pytest.raises(ValueError, match="one rank"):
        train_one_step(step1, Mesh(np.arange(2).reshape(2, 1)), params, opt_state, state,
                       *bs[0])


def test_sharded_entry_points_run_on_the_card_unless_asked():
    if torch.cuda.is_available():
        pytest.skip("a card is visible")
    md = model_def("vit_tiny")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        init_sharded_training(md, Mesh(np.array([[0]]), ("data", "model")))
    with pytest.raises(RuntimeError, match="no CUDA device"):
        init_pp_training(md, Mesh(np.array([[0]]), ("data", "stage")), n_micro=1)


def test_pp_default_heads_are_the_models_not_dim_over_64():
    """C20: storm_tpu's ``init_pp_training`` reads ``model.num_heads``,
    which its ModelDef does not have, and falls back to dim // 64: 1 head
    for vit_tiny's 4. The port takes ``hyper["num_heads"]`` (its own
    fallback only without one); storm_tpu's tests, and the port's against
    them, pass ``num_heads``."""
    jm = jax_build_model("vit_tiny")
    assert getattr(jm, "num_heads", None) is None and jm.hyper["num_heads"] == 4
    md = model_def("vit_tiny")
    params = md.init(np.random.RandomState(0))[0]
    assert params["blocks"][0]["attn"]["q"]["w"].shape[0] // 64 == 1  # storm_tpu's
    assert default_heads(md, params) == 4
    assert default_heads(model_def("vit_b16"), {}) == 12
    assert default_heads(dataclasses.replace(md, hyper={}), params) == 1
    mesh = make_mesh(1, 1, ("data", "stage"), device="cpu")
    step, (_rest, stages), _ = init_pp_training(md, mesh, n_micro=2, device="cpu")
    assert step.heads == 4 and stages["attn"]["q"]["w"].shape == (1, 2, 64, 64)
