"""The port's graft entry points, the twin of ``__graft_entry__.py``.

- :func:`entry`: one forward step on the flagship (ViT-B/16, 1000
  classes, 224x224x3) and its example arguments: ``fwd(params, x)`` is the
  f32 softmax of the forward, ``params`` the port's seeded
  ``init_params(model, 0)`` as a tree of tensors in the JAX layout (so a
  tree carried from storm_tpu runs the same forward), ``x`` zeros of
  shape (8, 224, 224, 3). On the card the forward launches the flash and
  fused-norm kernels (float32: ``flash_attention``; bfloat16 params and
  input: ``flash_attention_sm90``; both dtypes ``residual_layernorm_sm90``,
  12 each).
- :func:`dryrun_multichip`: what storm_tpu's runs on an n-device mesh, on
  ``n`` rank processes of one process group (``parallel.launch.
  spawn_ranks``, gloo: on the card every rank on ``cuda:0``, since NCCL
  refuses two ranks on one GPU): the dp x tp train step (two steps, from
  storm_tpu's vit_tiny init, ``checkpoints_torch/vit_tiny_init.npz``, the
  ``init_params(model, 0)`` that its ``init_sharded_training(model, mesh,
  seed=0)`` draws), the pp, sp and ep dry runs, and the serving dry run
  through spout -> ``InferenceBolt`` -> sink in storm_tpu's four meshes,
  with its batch policy and parallelism, each with its ack ledger closed:
  the topology runs on the mesh's leader, whose engine is led, and the
  other ranks follow it (``infer/engine.py``).

Both run on ``cuda`` unless the caller passes ``device="cpu"``, and raise
without a card.

    python3 __graft_entry_torch__.py [--n 4] [--device cpu]

runs ``entry()`` and ``dryrun_multichip(n)`` and prints what each checked.
"""

from __future__ import annotations

import os
import sys

import numpy as np

REPO = os.path.dirname(os.path.abspath(__file__))
INIT = os.path.join(REPO, "checkpoints_torch", "vit_tiny_init.npz")
ENTRY_BATCH = 8


def entry(device=None):
    """``(fwd, (params, x))`` for ViT-B/16 on ``device`` (default
    ``cuda``)."""
    import torch

    from storm_tpu_torch.device import resolve_device
    from storm_tpu_torch.models import model_def
    from storm_tpu_torch.models.convert import init_params

    dev = resolve_device(device)
    model = model_def("vit_b16", num_classes=1000, input_shape=(224, 224, 3))
    params, state = init_params(model, seed=0)

    def fwd(params, x):
        x = torch.as_tensor(x, device=dev)
        with torch.no_grad():
            logits, _ = model.apply(params, state, x)
        return torch.softmax(logits.float(), dim=-1)

    x = np.zeros((ENTRY_BATCH, 224, 224, 3), np.float32)
    return fwd, (params_on(params, dev), x)


def params_on(params, device):
    """A numpy parameter tree (JAX layout; the port's or carried from
    storm_tpu) as float32 tensors on ``device``."""
    import torch

    from storm_tpu_torch.models.convert import _map

    return _map(lambda a, _p: torch.from_numpy(np.array(a, np.float32)).to(device), params)


def dryrun_multichip(n_devices: int, device=None, timeout_s: float = 900.0) -> dict:
    """storm_tpu's dry run on ``n_devices`` ranks; returns rank 0's
    readings (``train_losses``, ``pp_loss``, ``sp_loss``, ``ep_loss``,
    ``serving``) after holding every rank's losses to agree and every
    follower to have run each batch the leader led."""
    from storm_tpu_torch.device import resolve_device
    from storm_tpu_torch.parallel.launch import spawn_ranks

    dev = resolve_device(device)
    ranks = spawn_ranks("__graft_entry_torch__:_rank", n_devices,
                        {"device": dev.type}, backend="gloo", timeout_s=timeout_s,
                        collective_timeout_s=min(300.0, timeout_s))
    first = ranks[0]
    for r, res in enumerate(ranks[1:], 1):
        if res["train_losses"] != first["train_losses"]:
            raise AssertionError(f"rank {r}'s losses {res['train_losses']} differ from rank "
                                 f"0's {first['train_losses']}")
        for label, s in res["serving"].items():
            led = first["serving"][label]["led"]
            if s["followed"] != led:
                raise AssertionError(f"serving {label}: rank {r} followed {s['followed']} "
                                     f"of the leader's {led} batches")
    dp, tp = first["mesh"]
    print(f"dryrun_multichip ok: mesh=({dp}x{tp}) loss={first['train_losses'][0]:.4f}"
          f"->{first['train_losses'][1]:.4f}")
    for line in first["lines"]:
        print(line)
    return first


def _rank(rank: int, world: int, device: str) -> dict:
    """One rank's dry run (``spawn_ranks`` calls it on every rank, in one
    order: the multi-process contract)."""
    import torch

    torch.manual_seed(0)
    if device == "cpu":
        torch.set_num_threads(1)
    dev = torch.device("cuda:0" if device == "cuda" else "cpu")
    out = {"lines": []}
    out.update(_dryrun_dp_tp(world, dev))
    for step in (_dryrun_pp, _dryrun_sp, _dryrun_ep):
        label, line, loss = step(world, dev)
        out[f"{label}_loss"] = loss
        out["lines"].append(line)
    out["serving"] = _dryrun_serving(world, dev, out["lines"])
    return out


def _vit_tiny():
    from storm_tpu_torch.models import model_def
    from storm_tpu_torch.models.registry import load_checkpoint

    model = model_def("vit_tiny", num_classes=10, input_shape=(32, 32, 3))
    params, state, meta = load_checkpoint(INIT)
    if meta.get("model") != "vit_tiny" or list(meta.get("input_shape", [])) != [32, 32, 3]:
        raise ValueError(f"{INIT} holds {meta}, not vit_tiny at 32x32x3")
    return model, params, state


def _dryrun_dp_tp(world: int, dev) -> dict:
    """storm_tpu's ``dryrun_multichip`` step: vit_tiny on a (dp, tp) mesh,
    the batch over the data axis, two full forward + backward + AdamW
    steps (the second on the updated parameters)."""
    from storm_tpu_torch.parallel.mesh import make_mesh
    from storm_tpu_torch.parallel.train import init_sharded_training, train_one_step

    tp = 2 if world % 2 == 0 else 1
    dp = world // tp
    mesh = make_mesh(dp, tp, device=dev)
    model, params0, state0 = _vit_tiny()
    step, params, opt_state, state = init_sharded_training(model, mesh, device=dev,
                                                           init=(params0, state0))
    x, y = dp_tp_batch(dp)
    losses = []
    for _ in range(2):
        params, opt_state, state, loss = train_one_step(step, mesh, params, opt_state, state,
                                                        x, y)
        losses.append(float(loss))
        if not np.isfinite(losses[-1]):
            raise AssertionError(f"non-finite loss {losses[-1]}")
    return {"mesh": (dp, tp), "train_losses": losses}


def dp_tp_batch(dp: int):
    """storm_tpu's dry-run batch: ``2 * dp`` rows from ``RandomState(0)``."""
    rng = np.random.RandomState(0)
    x = rng.rand(2 * dp, 32, 32, 3).astype(np.float32)
    y = rng.randint(0, 10, size=(2 * dp,))
    return x, y


def _dryrun_pp(world: int, dev):
    """Pipeline parallelism: vit_tiny's 2 blocks as 2 stages on a (data,
    stage) mesh, a full step through the GPipe schedule."""
    from storm_tpu_torch.parallel.mesh import make_mesh
    from storm_tpu_torch.parallel.pipeline import init_pp_training

    if world % 2:
        return "pp", "dryrun pp skipped: need an even device count", None
    n_stages, dp, n_micro = 2, world // 2, 2
    mesh = make_mesh(dp, n_stages, ("data", "stage"), device=dev)
    model, params0, _state = _vit_tiny()
    step, ps, opt_state = init_pp_training(model, mesh, n_micro=n_micro, num_heads=4,
                                           device=dev, init=(params0, {}))
    rng = np.random.RandomState(0)
    batch = n_micro * dp
    x = rng.rand(batch, 32, 32, 3).astype(np.float32)
    y = rng.randint(0, 10, size=(batch,))
    ps, opt_state, loss = step(ps, opt_state, x, y)
    loss = float(loss)
    if not np.isfinite(loss):
        raise AssertionError(f"pp non-finite loss {loss}")
    return "pp", f"dryrun pp ok: mesh=({dp}x{n_stages} stage) loss={loss:.4f}", loss


def _block_params(rng, dim: int, mlp: int) -> dict:
    """One pre-LN encoder block's parameters (storm_tpu's ``_block_init``
    layout) from ``rng``."""
    from storm_tpu_torch.models.common import dense_init, ln_init

    return {"ln1": ln_init(dim), "attn": {n: dense_init(rng, dim, dim) for n in "qkvo"},
            "ln2": ln_init(dim), "mlp_in": dense_init(rng, dim, mlp),
            "mlp_out": dense_init(rng, mlp, dim)}


def _dryrun_sp(world: int, dev):
    """Sequence parallelism: two encoder blocks with the sequence split
    over every rank, ring attention, the gradient through the ring."""
    import torch

    from storm_tpu_torch.models.convert import tree_leaves, trainable_params
    from storm_tpu_torch.parallel import collectives as C
    from storm_tpu_torch.parallel.mesh import make_mesh
    from storm_tpu_torch.parallel.sequence import seq_parallel_encoder, shard_sequence

    sp, dim, heads = world, 32, 4
    mesh = make_mesh(1, sp, ("data", "seq"), device=dev)
    rng = np.random.RandomState(7)
    blocks = trainable_params([_block_params(rng, dim, 64) for _ in range(2)], dev)
    xg = rng.standard_normal((2, 4 * sp, dim)).astype(np.float32)
    x = torch.from_numpy(shard_sequence(mesh, xg, "seq")).to(dev)
    y = seq_parallel_encoder(blocks, x, heads, mesh, seq_axis="seq")
    part = (y ** 2).sum() / xg.size  # this rank's part of the mean
    part.backward()
    grads = [p.grad for p in tree_leaves(blocks)]
    C.all_reduce_grads(grads, mesh, "seq", mean=False)
    loss = float(C.all_reduce(part.detach().clone(), mesh, "seq"))
    gsum = float(sum(g.abs().sum() for g in grads))
    if not (np.isfinite(loss) and np.isfinite(gsum) and gsum > 0):
        raise AssertionError(f"sp loss {loss}, gradient sum {gsum}")
    return "sp", f"dryrun sp ok: seq sharded {sp}-way, loss={loss:.4f}", loss


def _dryrun_ep(world: int, dev):
    """Expert parallelism: a MoE transformer block with its experts split
    over the expert axis of a (data, expert) mesh."""
    import torch

    from storm_tpu_torch.models.common import dense_init, ln_init
    from storm_tpu_torch.models.convert import tree_leaves, trainable_params
    from storm_tpu_torch.models.moe_vit import moe_init
    from storm_tpu_torch.parallel import collectives as C
    from storm_tpu_torch.parallel.mesh import make_mesh
    from storm_tpu_torch.parallel.moe import ExpertShard, moe_block, shard_moe_params
    from storm_tpu_torch.parallel.sharding import shard_batch

    if world % 2:
        return "ep", "dryrun ep skipped: need an even device count", None
    ep, dp = (4, world // 4) if world % 4 == 0 else (2, world // 2)
    mesh = make_mesh(dp, ep, ("data", "expert"), device=dev)
    dim, heads = 32, 4
    rng = np.random.RandomState(0)
    p = {"ln1": ln_init(dim), "attn": {n: dense_init(rng, dim, dim) for n in "qkvo"},
         "ln2": ln_init(dim), "moe": moe_init(rng, dim, 64, n_experts=ep * 2)}
    p["moe"] = shard_moe_params(mesh, p["moe"])
    p = trainable_params(p, dev)
    xg = rng.standard_normal((2 * dp, 6, dim)).astype(np.float32)
    x = torch.from_numpy(shard_batch(mesh, xg)).to(dev)
    y, aux = moe_block(p, x, heads, shard=ExpertShard(mesh, "expert", "data"))
    # this data rank's part of storm_tpu's loss, mean(y ** 2) + aux
    part = (y ** 2).sum() / xg.size + aux / dp
    part.backward()
    C.all_reduce_grads([t.grad for t in tree_leaves(p)], mesh, "data", mean=False)
    loss = float(C.all_reduce(part.detach().clone(), mesh, "data"))
    gsum = float(p["moe"]["w_in"].grad.abs().sum())
    if not (np.isfinite(loss) and np.isfinite(gsum) and gsum > 0):
        raise AssertionError(f"ep loss {loss}, expert gradient sum {gsum}")
    return "ep", (f"dryrun ep ok: {ep * 2} experts over {ep}-way expert axis, "
                  f"loss={loss:.4f}"), loss


SERVE_RECORDS = 12
# storm_tpu's serving dry run (``__graft_entry__.py:155-167``): its batch
# policy, two partitions, two spout and two inference tasks.
SERVE_BATCH = dict(max_batch=8, max_wait_ms=20, buckets=(8,))
SERVE_PARTITIONS = 2
SERVE_TASKS = 2
# Each record's probabilities against the one-rank engine's forward of
# the same records (max |dp|, f32 on both sides): dp, tp and sp compute a
# row as one rank does, but for the order of a sum.
SERVE_REF_TOL = 1e-4


def serving_meshes(world: int) -> list:
    """storm_tpu's four serving meshes (``__graft_entry__.py:119-153``):
    ``(label, ModelConfig kwargs, ShardingConfig kwargs)``."""
    meshes = [(f"dp={world}", dict(name="lenet5", dtype="float32", num_classes=10,
                                   input_shape=(28, 28, 1)), dict(data_parallel=0))]
    if world % 2 == 0:
        axis2 = 4 if world % 4 == 0 else 2
        dp2 = world // axis2
        meshes += [
            (f"dp={world // 2} x tp=2", dict(name="vit_tiny", dtype="float32",
                                             num_classes=10, input_shape=(32, 32, 3)),
             dict(data_parallel=world // 2, tensor_parallel=2)),
            (f"dp={dp2} x sp={axis2}", dict(name="longseq_tiny", dtype="float32",
                                            num_classes=10, input_shape=(64, 16)),
             dict(data_parallel=dp2, sequence_parallel=axis2)),
            (f"dp={dp2} x ep={axis2}", dict(name="moe_vit_tiny", dtype="float32",
                                            num_classes=10, input_shape=(32, 32, 3)),
             dict(data_parallel=dp2, expert_parallel=axis2)),
        ]
    return meshes


def _dryrun_serving(world: int, dev, lines: list) -> dict:
    """The product path on the mesh: broker JSON -> spout ->
    ``InferenceBolt`` on a sharded engine -> sink, once per mesh, with
    storm_tpu's batch policy and parallelism. The topology runs on the
    mesh's leader, whose engine is led; every other rank follows it
    (``infer/engine.py``: ranks that each batch their own records on
    timers would combine one batch's shards with another's). Each mesh:
    every record answered, finite, its ledger closed; under tp the weights
    split; the records' answers those of the one-rank engine within
    ``SERVE_REF_TOL``, but under ep, whose expert capacity counts the whole
    batch's tokens, so that a row's answer depends on the batch the
    timers put it in. A follower returns the batches it followed."""
    import asyncio

    from storm_tpu_torch.config import BatchConfig, ModelConfig, ShardingConfig
    from storm_tpu_torch.infer.engine import clear_engines, shared_engine

    results = {}
    for label, model_kw, sharding_kw in serving_meshes(world):
        mcfg, scfg = ModelConfig(**model_kw), ShardingConfig(**sharding_kw)
        batch_cfg = BatchConfig(**SERVE_BATCH)
        engine = shared_engine(mcfg, batch_cfg, device=str(dev), sharding_cfg=scfg)
        if engine.mesh.rank != engine.mesh.leader:
            results[label] = {"followed": engine.follow()}
            clear_engines()
            continue
        engine.lead()
        try:
            res = asyncio.run(_serve_one(label, mcfg, scfg, batch_cfg, engine, dev))
        finally:
            engine.release_followers()
        results[label] = res
        ref = (f"within {res['ref_err']:.1e} of the one-rank engine"
               if res["ref_err"] is not None else "ep: no one-rank reference")
        lines.append(f"dryrun serving ok: {label} mesh={res['mesh']} "
                     f"{len(res['preds'])} predictions in {res['led']} led batches, "
                     f"{ref}, ledger closed")
        clear_engines()
    return results


async def _serve_one(label: str, mcfg, scfg, batch_cfg, engine, dev) -> dict:
    import asyncio
    import json

    from storm_tpu_torch.api.schema import decode_predictions
    from storm_tpu_torch.config import Config, OffsetsConfig
    from storm_tpu_torch.connectors import BrokerSink, BrokerSpout, MemoryBroker
    from storm_tpu_torch.infer import InferenceBolt
    from storm_tpu_torch.infer.engine import InferenceEngine
    from storm_tpu_torch.runtime import AsyncLocalCluster, TopologyBuilder

    broker = MemoryBroker(default_partitions=SERVE_PARTITIONS)
    cfg = Config()
    tb = TopologyBuilder()
    tb.set_spout("spout", BrokerSpout(
        broker, "in", OffsetsConfig(policy="earliest", max_behind=None)),
        parallelism=SERVE_TASKS)
    tb.set_bolt("infer", InferenceBolt(mcfg, batch_cfg, device=str(dev), warmup=False,
                                       sharding=scfg), parallelism=SERVE_TASKS) \
        .shuffle_grouping("spout")
    tb.set_bolt("sink", BrokerSink(broker, "out", cfg.sink), parallelism=2) \
        .shuffle_grouping("infer")
    cluster = AsyncLocalCluster()
    rt = await cluster.submit("serve-dryrun", cfg, tb.build())
    rng = np.random.RandomState(0)
    xs = rng.rand(SERVE_RECORDS, 1, *mcfg.input_shape).astype(np.float32)
    try:
        for x in xs:
            broker.produce("in", json.dumps({"instances": x.tolist()}))
        deadline = asyncio.get_running_loop().time() + 240
        while broker.topic_size("out") < SERVE_RECORDS:
            if asyncio.get_running_loop().time() > deadline:
                raise AssertionError(f"{label}: {broker.topic_size('out')}/{SERVE_RECORDS} "
                                     f"out after 240 s")
            await asyncio.sleep(0.05)
        await rt.drain(timeout_s=30)
        snap = rt.metrics.snapshot()
    finally:
        await cluster.shutdown()
    outs = broker.drain_topic("out")
    if len(outs) != SERVE_RECORDS:
        raise AssertionError(f"{label}: {len(outs)}/{SERVE_RECORDS} out")
    preds = np.concatenate([decode_predictions(r.value).data for r in outs])
    if preds.shape != (SERVE_RECORDS, mcfg.num_classes) or not np.isfinite(preds).all():
        raise AssertionError(f"{label}: predictions {preds.shape}")
    acked = snap["spout"]["tree_acked"]
    if acked != SERVE_RECORDS:
        raise AssertionError(f"{label}: ledger not closed ({acked}/{SERVE_RECORDS})")
    if scfg.tensor_parallel > 1 and not (
            engine.tp == scfg.tensor_parallel
            and engine.param_bytes_per_device() < engine.param_bytes()):
        raise AssertionError(f"{label}: tp params not sharded")
    ref_err = None
    if scfg.expert_parallel <= 1:
        # The sinks write the records in any order: each output against
        # its nearest record's reference row, and each record answered.
        want = InferenceEngine(mcfg, batch_cfg, device=dev).predict(xs[:, 0])
        gap = np.abs(preds[:, None] - want[None]).max(-1)
        ref_err = float(max(gap.min(1).max(), gap.min(0).max()))
        if ref_err > SERVE_REF_TOL:
            raise AssertionError(f"{label}: predictions {ref_err} from the one-rank "
                                 f"engine's (bound {SERVE_REF_TOL})")
    return {"mesh": dict(engine.mesh.shape), "preds": preds, "led": engine.led,
            "forwards": engine.forwards, "tally": engine.launch_tally(), "ref_err": ref_err}


def main(argv=None) -> int:
    import argparse

    ap = argparse.ArgumentParser(description="entry() and dryrun_multichip(n) of the port")
    ap.add_argument("--n", type=int, default=4, help="ranks of the dry run")
    ap.add_argument("--device", choices=["cuda", "cpu"], help="default cuda")
    args = ap.parse_args(argv)
    sys.path.insert(0, REPO)
    import torch

    fwd, (params, x) = entry(args.device)
    probs = fwd(params, x)
    sums = probs.sum(dim=-1)
    if not torch.allclose(sums, torch.ones_like(sums), atol=1e-5):
        raise AssertionError(f"entry(): rows sum to {sums.tolist()}")
    print(f"entry ok: ViT-B/16 probabilities {tuple(probs.shape)} on {probs.device}")
    dryrun_multichip(args.n, args.device)
    return 0


if __name__ == "__main__":
    sys.exit(main())
