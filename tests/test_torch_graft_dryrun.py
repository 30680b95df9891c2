"""The port's ``dryrun_multichip`` (``__graft_entry_torch__.py``) against
storm_tpu's (``__graft_entry__.py``) on the CPU:
``dryrun_multichip(4, device="cpu")`` on four gloo ranks (each joined with
a deadline by ``parallel.launch.spawn_ranks``): its dp2 x tp2 first loss
against storm_tpu's ``init_sharded_training(model, mesh, seed=0)`` plus
``train_one_step`` on a 2 x 2 mesh of this process's CPU devices, on the
same x and y, within 1e-5 relative; the pp, sp and ep dry runs and the
serving dry run in storm_tpu's four meshes, with its batch policy and
parallelism, led from rank 0; and the dry run's start,
``checkpoints_torch/vit_tiny_init.npz``, held to storm_tpu's seed-0 init.

The ranks and storm_tpu's sharded step (seconds of XLA compile) run in
threads started by the first test and joined with a timeout."""

from __future__ import annotations

import concurrent.futures

import jax
import numpy as np
import pytest

import __graft_entry_torch__ as graft
from storm_tpu.models.registry import build_model as jax_build_model
from storm_tpu.parallel.mesh import make_mesh as jax_make_mesh
from storm_tpu.parallel.train import init_sharded_training as jax_init_sharded_training
from storm_tpu.parallel.train import train_one_step as jax_train_one_step
from storm_tpu_torch.models.registry import load_checkpoint

LOSS_RTOL = 1e-5
WORLD = 4
JOIN_S = 180.0


def _storm_first_loss() -> float:
    mesh = jax_make_mesh(2, 2, devices=jax.devices()[:WORLD])
    model = jax_build_model("vit_tiny", num_classes=10, input_shape=(32, 32, 3))
    step, params, opt_state, state = jax_init_sharded_training(model, mesh, seed=0)
    x, y = graft.dp_tp_batch(2)
    _p, _o, _s, loss = jax_train_one_step(step, mesh, params, opt_state, state, x, y)
    return float(loss)


@pytest.fixture(scope="module")
def background():
    """The dry run's ranks and storm_tpu's sharded step, started at once,
    joined (with a timeout) at the module's end."""
    pool = concurrent.futures.ThreadPoolExecutor(2)
    futures = {"dryrun": pool.submit(graft.dryrun_multichip, WORLD, "cpu", 150.0),
               "storm_loss": pool.submit(_storm_first_loss)}
    yield futures
    concurrent.futures.wait(futures.values(), timeout=JOIN_S)
    pool.shutdown(wait=False, cancel_futures=True)
    assert all(f.done() for f in futures.values()), "a background job outlived its join"


def test_dryrun_first_loss_matches_storm_tpu(background):
    res = background["dryrun"].result(timeout=JOIN_S)
    want = background["storm_loss"].result(timeout=JOIN_S)
    assert res["mesh"] == (2, 2)
    assert abs(res["train_losses"][0] - want) <= LOSS_RTOL * abs(want), \
        (res["train_losses"], want)
    assert np.isfinite(res["train_losses"][1])


def test_dryrun_runs_storm_tpus_dry_runs(background):
    res = background["dryrun"].result(timeout=JOIN_S)
    assert all(np.isfinite(res[k]) for k in ("pp_loss", "sp_loss", "ep_loss"))
    assert list(res["serving"]) == ["dp=4", "dp=2 x tp=2", "dp=1 x sp=4", "dp=1 x ep=4"]
    meshes = {k: v["mesh"] for k, v in res["serving"].items()}
    assert meshes == {"dp=4": {"data": 4, "model": 1}, "dp=2 x tp=2": {"data": 2, "model": 2},
                      "dp=1 x sp=4": {"data": 1, "seq": 4},
                      "dp=1 x ep=4": {"data": 1, "expert": 4}}
    for label, s in res["serving"].items():
        assert s["preds"].shape[0] == graft.SERVE_RECORDS, label
        np.testing.assert_allclose(s["preds"].sum(-1), 1.0, atol=1e-5)
        # at least two batches of at most 8; the followers ran each (the
        # dry run holds their counts to the leader's)
        assert 2 <= s["led"] <= graft.SERVE_RECORDS, label
        if label.endswith("ep=4"):
            assert s["ref_err"] is None
        else:
            assert s["ref_err"] <= graft.SERVE_REF_TOL, label
    assert res["lines"][:3] == [
        f"dryrun pp ok: mesh=(2x2 stage) loss={res['pp_loss']:.4f}",
        f"dryrun sp ok: seq sharded 4-way, loss={res['sp_loss']:.4f}",
        f"dryrun ep ok: 8 experts over 4-way expert axis, loss={res['ep_loss']:.4f}"]


def test_vit_tiny_init_is_storm_tpus():
    """``checkpoints_torch/vit_tiny_init.npz``, the dry run's start, is the
    init that ``init_sharded_training(model, mesh, seed=0)`` draws:
    ``model.init(PRNGKey(0))``."""
    model = jax_build_model("vit_tiny", num_classes=10, input_shape=(32, 32, 3))
    want, _ = model.init(jax.random.PRNGKey(0))
    params, state, meta = load_checkpoint(graft.INIT)
    assert meta["model"] == "vit_tiny" and state == {}
    wl = jax.tree_util.tree_flatten_with_path(want)[0]
    gl = dict((jax.tree_util.keystr(p), v) for p, v in
              jax.tree_util.tree_flatten_with_path(params)[0])
    assert len(wl) == len(gl)
    for p, v in wl:
        assert np.array_equal(gl[jax.tree_util.keystr(p)], np.asarray(v)), p
