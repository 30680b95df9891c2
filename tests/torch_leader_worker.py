"""Rank half of ``tests/test_torch_serve_leader.py``: the function each of
a gloo world's two CPU processes runs (``storm_tpu_torch.parallel.launch.
spawn_ranks``) on one lenet5 engine at data_parallel=2. It imports the
port alone (no JAX) and returns what each step gave:

- ``lockstep``: the two ranks run the same two batches in opposite
  orders, the order two dispatches racing for the engine's lock can take
  on two ranks;
- ``led`` / ``followed``: the leader's engine is led and four threads feed
  it ``LED_BATCHES`` batches at once, while the other rank follows;
- ``after``: once the followers are released, one batch in lockstep;
- ``refused``: what the engine and ``InferenceBolt`` refuse.
"""

from __future__ import annotations

import sys
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import torch

from storm_tpu_torch.config import BatchConfig, ModelConfig, ShardingConfig
from storm_tpu_torch.infer import InferenceBolt
from storm_tpu_torch.infer.engine import InferenceEngine

MODEL = dict(name="lenet5", dtype="float32", num_classes=10, input_shape=(28, 28, 1))
BATCH = dict(max_batch=4, buckets=(4,))
ROWS = 3
LED_BATCHES = 16


def batches(n: int) -> np.ndarray:
    """``n`` seeded batches of ``ROWS`` rows."""
    return np.random.RandomState(0).rand(n, ROWS, 28, 28, 1).astype(np.float32)


def _refusal(fn) -> str:
    try:
        fn()
    except ValueError as e:
        return str(e)
    return ""


def run(rank: int, world: int) -> dict:
    torch.set_num_threads(1)
    mc, bc = ModelConfig(**MODEL), BatchConfig(**BATCH)
    sharding = ShardingConfig(data_parallel=2)
    eng = InferenceEngine(mc, bc, device="cpu", sharding_cfg=sharding)
    a, b = batches(2)
    out = {"lockstep": [eng.predict(x) for x in ((a, b) if rank == 0 else (b, a))]}
    if rank == 0:
        out["refused"] = {"follow": _refusal(eng.follow)}
        eng.lead()
        interval = sys.getswitchinterval()
        sys.setswitchinterval(1e-5)  # the feeding threads interleave often
        try:
            with ThreadPoolExecutor(4) as pool:
                out["led"] = list(pool.map(eng.predict, batches(LED_BATCHES)))
        finally:
            sys.setswitchinterval(interval)
        eng.release_followers()
        out["led_count"] = eng.led
    else:
        out["refused"] = {"lead": _refusal(eng.lead)}
        out["followed"] = eng.follow()
    out["after"] = eng.predict(a)
    # A topology's task on an engine that is not led (every rank builds
    # the shared engine: its mesh is a collective call).
    bolt = InferenceBolt(mc, bc, device="cpu", warmup=False, sharding=sharding)
    out["refused"]["bolt"] = _refusal(bolt._shared_engine)
    return out
