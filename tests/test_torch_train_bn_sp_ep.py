"""BatchNorm over the global batch, and the gradients of sequence and
expert parallelism, in a gloo world of four CPU processes
(``tests/torch_train_worker.py``, through ``test_torch_train_parallel``'s
``run_world``), held against storm_tpu's on the 8 CPU devices of
``tests/conftest.py``, on the same parameters and inputs:

- resnet20 at 16x16 through ``init_sharded_training`` at dp4 (two rows a
  rank; BatchNorm's statistics the global batch's, summed over the data
  axis): the losses of 3 AdamW steps against storm_tpu's dp4 step (1e-4
  relative), the running statistics after step 1 against storm_tpu's
  (1e-5), step 1's gradients against the port's one-rank step (GRAD_TOL,
  leaf by leaf), and every leaf and statistic the same on every rank, bit
  for bit;
- the gradient of ``sum(y ** 2)`` through ``seq_parallel_encoder`` at
  dp2 x sp2 (the ring's ``ring_shift`` backward) against ``jax.grad`` of
  storm_tpu's at the same mesh (storm_tpu's ``test_seq_parallel_grad_flows``),
  the blocks' leaf by leaf within GRAD_TOL and the input's elementwise;
- the gradient of ``sum(y ** 2) * 1e-3 + aux`` through the expert-parallel
  ``moe_block`` at dp2 x ep2 (*f* into the experts, *g* out, the
  load-balancing loss's statistics summed over the data axis) against
  ``jax.grad`` of storm_tpu's at the same mesh (storm_tpu's
  ``test_moe_block_trains``), leaf by leaf within GRAD_TOL.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
from jax.sharding import Mesh as JaxMesh
from jax.sharding import NamedSharding, PartitionSpec as P

from storm_tpu.models.registry import build_model as jax_build_model
from storm_tpu.parallel.mesh import make_mesh as jax_make_mesh
from storm_tpu.parallel.moe import moe_block as jax_moe_block
from storm_tpu.parallel.moe import shard_moe_params as jax_shard_moe_params
from storm_tpu.parallel.sequence import seq_parallel_encoder as jax_seq_parallel_encoder
from storm_tpu.parallel.train import init_sharded_training as jax_init_sharded_training
from storm_tpu.parallel.train import train_one_step as jax_train_one_step
from storm_tpu_torch.models.common import dense_init, ln_init
from storm_tpu_torch.models.moe_vit import moe_init
from tests import torch_train_worker as worker
from tests.test_torch_train_parallel import (
    WORLD, batches, flat_np, grads_close, in_threads, jax_model, line_replicas, losses_close,
    one_rank, run_world)
from tests.test_torch_train_pipeline import _blocks

RESNET = {"name": "resnet20", "kw": {"input_shape": (16, 16, 3)}}


@pytest.fixture(scope="module")
def world():
    res = worker.model(RESNET).init(np.random.RandomState(0))
    bs = batches((16, 16, 3))
    rng = np.random.RandomState(3)
    seq_blocks = _blocks(rng, 2, 16, 32)
    seq_x = rng.standard_normal((2, 8, 16)).astype(np.float32)
    moe_p = {"ln1": ln_init(16), "attn": {k: dense_init(rng, 16, 16) for k in "qkvo"},
             "ln2": ln_init(16), "moe": moe_init(rng, 16, 32, 4)}
    moe_x = rng.standard_normal((8, 6, 16)).astype(np.float32)
    cases = [dict(kind="sharded", id="resnet20 dp4", model=RESNET, init=res, dp=4, tp=1,
                  batches=bs),
             dict(kind="seq_grad", id="seq", blocks=seq_blocks, x=seq_x, heads=2, dp=2, sp=2),
             dict(kind="moe_grad", id="moe", params=moe_p, x=moe_x, heads=2, cf=1.25, dp=2,
                  ep=2)]

    devs = jax.devices()

    def storm_tpu_resnet() -> tuple:
        """storm_tpu's losses of 3 dp4 steps and its state after step 1."""
        jres = jax_model(jax_build_model("resnet20", input_shape=(16, 16, 3)), *res)
        mesh = jax_make_mesh(4, 1, devices=devs[:4])
        step, params, opt_state, state = jax_init_sharded_training(jres, mesh, seed=0)
        losses, states = [], []
        for x, y in bs:
            params, opt_state, state, loss = jax_train_one_step(step, mesh, params, opt_state,
                                                                state, x, y)
            losses.append(float(loss))
            states.append(jax.tree.map(np.asarray, state))
        return losses, states[0]

    def storm_tpu_seq():
        mesh = JaxMesh(np.array(devs[:4]).reshape(2, 2), ("data", "seq"))

        def loss(blocks, x):
            return jnp.sum(jax_seq_parallel_encoder(blocks, x, 2, mesh, "seq") ** 2)

        return jax.tree.map(np.asarray, jax.jit(jax.grad(loss, argnums=(0, 1)))(
            jax.tree.map(jnp.asarray, seq_blocks), jnp.asarray(seq_x)))

    def storm_tpu_moe():
        mesh = JaxMesh(np.array(devs[:4]).reshape(2, 2), ("data", "expert"))
        p = jax.tree.map(jnp.asarray, moe_p)
        p["moe"] = jax_shard_moe_params(mesh, p["moe"])
        xs = jax.device_put(jnp.asarray(moe_x), NamedSharding(mesh, P("data", None, None)))

        def loss(p, x):
            y, aux = jax_moe_block(p, x, 2)
            return jnp.sum(y ** 2) * 1e-3 + aux

        return jax.tree.map(np.asarray, jax.jit(jax.grad(loss))(p, xs))

    def here():
        ref = in_threads({"resnet20 dp4": storm_tpu_resnet, "seq": storm_tpu_seq,
                          "moe": storm_tpu_moe})
        return {"ref": ref, "one": one_rank(worker.model(RESNET), res, bs)}

    return run_world(cases, here)


def test_resnet20_dp4_batchnorm_takes_the_global_batch(world):
    """The losses of 3 steps against storm_tpu's dp4 step; the running
    statistics after step 1 (the global batch's, from the one starting
    point) against storm_tpu's, and step 1's gradients against the port's
    one-rank step; every leaf and statistic the same on every rank."""
    want_losses, want_state = world["ref"]["resnet20 dp4"]
    for r in world["ranks"]:
        got = r["resnet20 dp4"]
        losses_close(got["losses"], want_losses, "resnet20 dp4")
        s, ws = flat_np(got["state1"]), flat_np(want_state)
        assert s.keys() == ws.keys() and ws
        for k in ws:
            np.testing.assert_allclose(s[k], ws[k], atol=1e-5, rtol=1e-5, err_msg=str(k))
        grads_close(got["grads"], world["one"]["grads"], "resnet20 dp4")
    for key in ("state", "params"):
        line_replicas(world["ranks"], "resnet20 dp4", key, (WORLD, 1), 0)


def test_seq_parallel_gradients_match_storm_tpu(world):
    want_blocks, want_x = world["ref"]["seq"]
    for r in world["ranks"]:
        grads_close(r["seq"]["blocks"], want_blocks, "seq blocks")
        np.testing.assert_allclose(r["seq"]["x"], want_x, rtol=1e-4, atol=1e-5)


def test_expert_parallel_moe_gradients_match_storm_tpu(world):
    for r in world["ranks"]:
        got = r["moe"]["grads"]
        grads_close(got, world["ref"]["moe"], "moe")
        assert got["moe"]["w_in"].shape == (4, 16, 32)
        assert float(np.abs(got["moe"]["w_in"]).sum()) > 0
