"""Two faults of the port against its own contract, repaired, on the CPU.

- The numeric flags: resolving a CUDA device (every entry point does)
  turns off TF32 and bf16 reduced-precision reductions, so an engine in
  any process computes the arithmetic ``chip_smoke.py`` holds to the
  plain versions. Here no card exists: ``torch.cuda.is_available`` is
  made to report one, each entry point runs until it first touches the
  card (and fails there), and the flags must be off by then.
- The quarantine hand-over: two ``InferenceBolt`` tasks share one engine;
  the chaos injector's hang trips the watchdog until the engine is
  quarantined, and both tasks must end on the one replacement engine,
  with every record through.
"""

import asyncio
import gc
import json
import threading

import numpy as np
import pytest
import torch

from storm_tpu_torch.config import BatchConfig, Config, ModelConfig, OffsetsConfig, SinkConfig
from storm_tpu_torch.connectors import BrokerSink, BrokerSpout, MemoryBroker
from storm_tpu_torch.device import resolve_device, set_numeric_flags
from storm_tpu_torch.infer import InferenceBolt
from storm_tpu_torch.infer.engine import InferenceEngine, clear_engines, shared_engine
from storm_tpu_torch.models import build_model
from storm_tpu_torch.resilience import get_injector
from storm_tpu_torch.runtime import AsyncLocalCluster, TopologyBuilder

FLAGS = (
    (torch.backends.cuda.matmul, "allow_tf32"),
    (torch.backends.cudnn, "allow_tf32"),
    (torch.backends.cuda.matmul, "allow_bf16_reduced_precision_reduction"),
)
SHAPE = (28, 28, 1)
MODEL = ModelConfig(name="lenet5", dtype="float32", num_classes=10, input_shape=SHAPE)


@pytest.fixture
def permissive_flags(monkeypatch):
    """Every flag True (PyTorch's defaults for two of them), restored
    after the test; ``torch.cuda.is_available`` reports a card."""
    saved = [getattr(obj, name) for obj, name in FLAGS]
    for obj, name in FLAGS:
        setattr(obj, name, True)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    yield
    for (obj, name), value in zip(FLAGS, saved):
        setattr(obj, name, value)


def _flags() -> list:
    return [getattr(obj, name) for obj, name in FLAGS]


def _entry_points():
    batch = BatchConfig(max_batch=4, buckets=(4,))
    return {
        "resolve_device": lambda: resolve_device(None),
        "build_model": lambda: build_model("lenet5", input_shape=SHAPE, num_classes=10),
        "InferenceEngine": lambda: InferenceEngine(MODEL, batch, device="cuda"),
        "shared_engine": lambda: shared_engine(MODEL, batch),
        "InferenceBolt": lambda: InferenceBolt(MODEL, batch).prewarm(),
    }


@pytest.mark.parametrize("entry", sorted(_entry_points()))
def test_cuda_entry_points_set_the_numeric_flags(entry, permissive_flags):
    assert _flags() == [True, True, True]
    try:
        _entry_points()[entry]()
    except (RuntimeError, AssertionError):
        pass  # this build of torch has no CUDA: the first touch of the card fails
    finally:
        clear_engines()
    assert _flags() == [False, False, False]


def test_cpu_leaves_the_flags_alone(permissive_flags):
    assert resolve_device("cpu").type == "cpu"
    build_model("lenet5", device="cpu", input_shape=SHAPE, num_classes=10)
    assert _flags() == [True, True, True]
    set_numeric_flags()
    assert _flags() == [False, False, False]


# ---- C2: both tasks get the replacement engine --------------------------------


async def _serve_through_quarantine(n: int):
    batch = BatchConfig(max_batch=8, max_wait_ms=5.0, buckets=(8,), max_inflight=1,
                        watchdog_ms=100.0, watchdog_trips=2)
    broker = MemoryBroker(default_partitions=1)
    tb = TopologyBuilder()
    tb.set_spout("spout", BrokerSpout(
        broker, "in", OffsetsConfig(policy="earliest", max_behind=None)))
    tb.set_bolt("infer", InferenceBolt(MODEL, batch, device="cpu"),
                parallelism=2).shuffle_grouping("spout")
    tb.set_bolt("sink", BrokerSink(broker, "out", SinkConfig(mode="sync"))) \
        .shuffle_grouping("infer")
    cluster = AsyncLocalCluster()
    rt = await cluster.submit("quarantine", Config(), tb.build())
    tasks = [e.bolt for e in rt.bolt_execs["infer"]]
    first = tasks[0].engine
    assert tasks[1].engine is first  # one engine for both tasks
    inj = get_injector()
    inj.configure(engine_hang_ms=600.0, engine_hang_next=2)
    try:
        x = np.random.RandomState(0).rand(n, *SHAPE).astype(np.float32)
        for img in x:
            broker.produce("in", json.dumps({"instances": [img.tolist()]}))
        loop = asyncio.get_running_loop()
        deadline = loop.time() + 60
        while broker.topic_size("out") < n or not all(
                t.engine is not first for t in tasks):
            assert loop.time() < deadline, "records or the swap stuck"
            await asyncio.sleep(0.02)
        await rt.drain(timeout_s=30)
    finally:
        inj.configure(engine_hang_ms=0.0, engine_hang_next=0)
    snap = rt.metrics.snapshot()
    engines = [t.engine for t in tasks]
    await cluster.shutdown()
    return first, engines, snap, broker.topic_size("out")


def test_every_task_sharing_a_quarantined_engine_gets_the_replacement(run):
    clear_engines()
    n = 48
    try:
        first, engines, snap, out = run(_serve_through_quarantine(n), timeout=90)
        replacers = [t for t in threading.enumerate() if t.name == "engine-replace"]
        for t in replacers:
            t.join(10)
        assert not any(t.is_alive() for t in replacers)
    finally:
        clear_engines()
    assert first.quarantined
    assert engines[0] is engines[1] and engines[0] is not first
    assert not engines[0].quarantined
    assert snap["infer"]["watchdog_trips"] >= 2
    assert snap["infer"]["engine_quarantined"] == 0
    assert snap["spout"]["tree_acked"] == n  # no record lost
    assert out >= n  # replays may repeat a record, never drop one


def test_quarantine_fanout_reaches_every_task_once():
    """The hook tells each listening task once per quarantine, and holds
    the tasks weakly."""
    from storm_tpu_torch.infer.operator import _QuarantineFanout, _listen_for_quarantine

    class Task:
        def __init__(self):
            self.calls = []

        def _engine_quarantined(self, trips):
            self.calls.append(trips)

    class Engine:
        on_quarantine = None

    eng, a, b = Engine(), Task(), Task()
    _listen_for_quarantine(eng, a)
    _listen_for_quarantine(eng, b)
    _listen_for_quarantine(eng, a)  # a task listens once
    assert isinstance(eng.on_quarantine, _QuarantineFanout)
    eng.on_quarantine(2)
    assert a.calls == [2] and b.calls == [2]
    del b
    gc.collect()
    eng.on_quarantine(3)  # a task that is gone is not kept alive by the hook
    assert a.calls == [2, 3] and len(eng.on_quarantine._tasks) == 1
