"""A multi-rank engine's batches in one order on every rank, in a gloo
world of two CPU processes (``tests/torch_leader_worker.py``), against the
one-rank engine's forward of the same batches.

Two dispatches that race for a multi-rank engine's lock (a task's
``max_inflight`` of 2, two tasks, timer-driven batches) may take it in
another order on each rank, and the ranks then combine one batch's shards
with another's. The lockstep case forces that order and shows the wrong
rows; the led engine (``InferenceEngine.lead`` / ``follow``) takes any
number of threads on its leader and answers every batch as the one-rank
engine does, and ``InferenceBolt`` refuses an engine that is not led."""

from __future__ import annotations

import numpy as np
import pytest

from storm_tpu_torch.config import BatchConfig, ModelConfig
from storm_tpu_torch.infer.engine import InferenceEngine
from storm_tpu_torch.parallel.launch import spawn_ranks
from tests import torch_leader_worker as worker

ATOL = 1e-6  # f32 on the CPU: each row as one rank computes it


@pytest.fixture(scope="module")
def world():
    ranks = spawn_ranks("tests.torch_leader_worker:run", 2, timeout_s=120,
                        env={"OMP_NUM_THREADS": "1"})
    one = InferenceEngine(ModelConfig(**worker.MODEL), BatchConfig(**worker.BATCH),
                          device="cpu")
    ref = [one.predict(x) for x in worker.batches(worker.LED_BATCHES)]
    return ranks, ref


def test_lockstep_ranks_out_of_order_combine_two_batches(world):
    ranks, ref = world
    got = ranks[0]["lockstep"][0]  # rank 0's first batch beside rank 1's second
    np.testing.assert_allclose(got[:2], ref[0][:2], atol=ATOL)  # its own shard
    assert np.abs(got[2] - ref[0][2]).max() > 1e-3  # a row of the other batch
    np.testing.assert_allclose(got[2], ref[1][2], atol=ATOL)


@pytest.mark.parametrize("i", range(worker.LED_BATCHES))
def test_led_engine_answers_each_batch_as_one_rank(world, i):
    ranks, ref = world
    np.testing.assert_allclose(ranks[0]["led"][i], ref[i], atol=ATOL)


def test_followers_ran_every_led_batch(world):
    ranks, _ = world
    assert ranks[0]["led_count"] == ranks[1]["followed"] == worker.LED_BATCHES


def test_released_engine_is_lockstep_again(world):
    ranks, ref = world
    for r in ranks:
        np.testing.assert_allclose(r["after"], ref[0], atol=ATOL)


@pytest.mark.parametrize("rank,what,says", [
    (0, "follow", "only a multi-rank engine's other ranks follow"),
    (1, "lead", "rank 1 is not the mesh's leader"),
    (0, "bolt", "is not led"),
    (1, "bolt", "is not led"),
])
def test_roles_refused(world, rank, what, says):
    ranks, _ = world
    assert says in ranks[rank]["refused"][what]


def test_one_rank_engine_has_no_followers():
    eng = InferenceEngine(ModelConfig(**worker.MODEL), BatchConfig(**worker.BATCH),
                          device="cpu")
    with pytest.raises(ValueError, match="no followers"):
        eng.lead()
    with pytest.raises(ValueError, match="follow"):
        eng.follow()
