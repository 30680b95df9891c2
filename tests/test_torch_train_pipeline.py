"""The port's pipeline parallelism in a gloo world of four CPU processes
(``tests/torch_train_worker.py``, through ``test_torch_train_parallel``'s
``run_world``), held against storm_tpu's on the 8 CPU devices of
``tests/conftest.py``, on the same parameters and batches:

- ``pipeline_apply`` of four encoder blocks at dp2 x pp2 and pp4 against
  storm_tpu's (atol 2e-4, ``tests/test_parallel_pp_sp_ep.py:57``), and
  its refusal of fewer microbatches than stages;
- ``init_pp_training`` on a vit_tiny of depth 4 at pp4 (n_micro 4) and
  dp2 x pp2 (n_micro 2), heads given as storm_tpu's test gives them: the
  losses of 3 AdamW steps against storm_tpu's (1e-4 relative), step 1's
  gradients against ``jax.grad`` of storm_tpu's unpipelined
  ``model.apply`` loss and against the port's one-rank step (GRAD_TOL,
  leaf by leaf), and after step 3 ``rest`` the same on every rank and each
  stage on its data line, bit for bit.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
from jax.sharding import Mesh as JaxMesh

from storm_tpu.models.vit import _block as jax_vit_block
from storm_tpu.models.vit import build_vit as jax_build_vit
from storm_tpu.parallel.pipeline import init_pp_training as jax_init_pp_training
from storm_tpu.parallel.pipeline import pipeline_apply as jax_pipeline_apply
from storm_tpu.parallel.pipeline import split_blocks as jax_split_blocks
from storm_tpu_torch.models.common import dense_init, ln_init
from storm_tpu_torch.models.convert import _map
from tests import torch_train_worker as worker
from tests.test_torch_train_parallel import (
    WORLD, batches, flat_np, grads_close, in_threads, jax_model, line_replicas, losses_close,
    one_rank, run_world)

# (label, dp, stages, n_micro)
PIPELINED = [("pp4", 1, 4, 4), ("dp2xpp2", 2, 2, 2)]
VIT4 = {"name": "vit_tiny", "depth": 4}


def _blocks(rng, n: int, dim: int, mlp: int) -> list:
    """storm_tpu's block layout, seeded in numpy, with nonzero biases and
    norm parameters."""
    blocks = [{"ln1": ln_init(dim), "attn": {k: dense_init(rng, dim, dim) for k in "qkvo"},
               "ln2": ln_init(dim), "mlp_in": dense_init(rng, dim, mlp),
               "mlp_out": dense_init(rng, mlp, dim)} for _ in range(n)]
    for b in blocks:
        for leaf in (b["ln1"]["bias"], b["ln2"]["scale"], b["attn"]["q"]["b"],
                     b["mlp_out"]["b"]):
            leaf += rng.standard_normal(leaf.shape).astype(np.float32) * 0.1
    return blocks


@pytest.fixture(scope="module")
def world():
    md = worker.model(VIT4)
    vit4 = md.init(np.random.RandomState(0))[0]
    bs = batches((32, 32, 3))
    rng = np.random.RandomState(2)
    blocks = _blocks(rng, 4, 32, 64)
    x_micro = rng.standard_normal((4, 4, 6, 32)).astype(np.float32)
    cases = [dict(kind="pp", id=label, model=VIT4, init=vit4, dp=dp, stages=s, n_micro=nm,
                  heads=4, batches=bs) for label, dp, s, nm in PIPELINED]
    cases += [dict(kind="pipeline", id=f"pipeline {label}", blocks=blocks, x=x_micro, dp=dp,
                   stages=s, heads=4) for label, dp, s, _ in PIPELINED]
    cases.append(dict(kind="pipeline", id="refusal", blocks=blocks, x=x_micro[:2], dp=1,
                      stages=4, heads=4))

    jvit4 = jax_model(jax_build_vit("vit_tiny", 10, (32, 32, 3), 8, 64, 4, 4, 128), vit4)
    devs = jax.devices()

    def stage_fn(local, act):
        out, _ = jax.lax.scan(lambda h, pb: (jax_vit_block(pb, h, 4), None), act, local)
        return out

    def storm_tpu_pp(dp: int, s: int, nm: int) -> tuple:
        """storm_tpu's losses of 3 pipelined steps and its pipeline_apply."""
        mesh = JaxMesh(np.array(devs[:dp * s]).reshape(dp, s), ("data", "stage"))
        step, ps, opt_state = jax_init_pp_training(jvit4, mesh, n_micro=nm, num_heads=4)
        losses = []
        for x, y in bs:
            ps, opt_state, loss = step(ps, opt_state, jnp.asarray(x), jnp.asarray(y))
            losses.append(float(loss))
        y = jax.jit(lambda st, xm: jax_pipeline_apply(mesh, stage_fn, st, xm))(
            jax_split_blocks(blocks, s), x_micro)
        return losses, np.asarray(y)

    def storm_tpu_grads():
        def loss(params, x, y):
            logits, _ = jvit4.apply(params, {}, x)
            return optax.softmax_cross_entropy_with_integer_labels(logits, y).mean()

        x, y = bs[0]
        return jax.tree.map(np.asarray, jax.jit(jax.grad(loss))(
            jax.tree.map(jnp.asarray, vit4), jnp.asarray(x), jnp.asarray(y)))

    def here():
        jobs = {label: functools.partial(storm_tpu_pp, dp, s, nm)
                for label, dp, s, nm in PIPELINED}
        ref = in_threads({**jobs, "grads": storm_tpu_grads})
        return {"ref": ref, "one": one_rank(md, (vit4, {}), bs)}

    return run_world(cases, here)


@pytest.mark.parametrize("label", [p[0] for p in PIPELINED])
def test_pipeline_apply_matches_storm_tpu(world, label):
    want = world["ref"][label][1]
    for r in world["ranks"]:
        np.testing.assert_allclose(r[f"pipeline {label}"]["y"], want, rtol=2e-4, atol=2e-4)


def test_pipeline_refuses_fewer_microbatches_than_stages(world):
    for r in world["ranks"]:
        assert "n_micro=2 < n_stages=4" in r["refusal"]["refused"]


@pytest.mark.parametrize("label", [p[0] for p in PIPELINED])
def test_pp_training_losses_match_storm_tpu(world, label):
    for r in world["ranks"]:
        losses_close(r[label]["losses"], world["ref"][label][0], label)
        assert r[label]["losses"] == world["ranks"][0][label]["losses"]
        assert r[label]["heads"] == 4


@pytest.mark.parametrize("label,dp,stages", [p[:3] for p in PIPELINED])
def test_pp_gradients_match_jax_grad_and_replicas(world, label, dp, stages):
    """Step 1's gradients: ``rest`` and every block (the stages gathered,
    unstacked) against ``jax.grad`` of storm_tpu's unpipelined loss and the
    port's one-rank step. After step 3 ``rest`` is the same on every rank,
    and each stage the same on its data line."""
    bps = 4 // stages
    for r in world["ranks"]:
        rest, stacked = r[label]["grads"]
        blocks = [_map(lambda a, _p, b=b: a[b // bps, b % bps], stacked) for b in range(4)]
        got = dict(rest, blocks=blocks)
        grads_close(got, world["ref"]["grads"], label)
        grads_close(got, world["one"]["grads"], label)
    ranks = world["ranks"]
    first = flat_np(ranks[0][label]["params"][0])
    for r in ranks[1:]:
        other = flat_np(r[label]["params"][0])
        assert all(np.array_equal(first[k], other[k]) for k in first), label
    line_replicas(ranks, label, "params", (dp, stages), 0)
    assert WORLD == dp * stages
