"""The port's copy ledger (``storm_tpu_torch/obs/copyledger.py``) against
storm_tpu's on the CPU: the same ``record`` sequence gives the same
snapshot, windows and prune; and a lenet5 topology run by both packages
ledgers the same stages with the same bytes and copies per record, except
where the port moves bytes otherwise than storm_tpu, which is asserted as
that difference:

- ``d2h``: the port copies the padded result from the card into a pooled
  pinned buffer, then the real rows into a fresh array (two copies,
  ``(padded + n) * K * 4`` bytes a batch); storm_tpu copies the padded
  result once into a fresh array (``padded * K * 4``);
- ``json_encode`` and ``sink_encode`` carry the prediction text, whose
  length follows the floats each package computed: each equals that
  package's own output bytes, and the copies match.
"""

from __future__ import annotations

import asyncio
import gc
import json
import time
from types import SimpleNamespace

import numpy as np
import pytest

import storm_tpu.config as jax_config
import storm_tpu.connectors as jax_connectors
import storm_tpu.infer as jax_infer
import storm_tpu.infer.engine as jax_engine
import storm_tpu.obs.copyledger as jax_ledger
import storm_tpu.runtime as jax_runtime
import storm_tpu.runtime.cluster as jax_cluster
import storm_tpu_torch.config as port_config
import storm_tpu_torch.connectors as port_connectors
import storm_tpu_torch.infer as port_infer
import storm_tpu_torch.obs.copyledger as port_ledger
import storm_tpu_torch.runtime as port_runtime
import storm_tpu_torch.runtime.cluster as port_cluster
from storm_tpu_torch.infer.engine import clear_engines

SHAPE = (28, 28, 1)
CLASSES = 10
IMPLS = {
    "storm_tpu": SimpleNamespace(name="storm_tpu", ledger=jax_ledger, config=jax_config,
                                 connectors=jax_connectors, runtime=jax_runtime,
                                 cluster=jax_cluster),
    "port": SimpleNamespace(name="port", ledger=port_ledger, config=port_config,
                            connectors=port_connectors, runtime=port_runtime,
                            cluster=port_cluster),
}
STAGES = ["spout_ingest", "spout_scheme", "json_decode", "tuple_route", "staging", "h2d",
          "d2h", "json_encode", "sink_encode"]


def _sequence(ledger_mod):
    led = ledger_mod.CopyLedger()
    rng = np.random.RandomState(5)
    out = {"first": led.windowed("w")}
    for i in range(60):
        stage = ledger_mod.STAGE_ORDER[rng.randint(len(ledger_mod.STAGE_ORDER))]
        led.record(stage, int(rng.randint(0, 5000)), copies=int(rng.randint(0, 3)),
                   allocs=int(rng.randint(0, 2)), records=int(rng.randint(1, 9)),
                   engine=("-", "lenet5", "spout", "gone")[rng.randint(4)])
        if i == 30:
            out["mid"] = led.snapshot()
    win = led.windowed("w")
    win.pop("dt_s")
    out["window"] = win
    out["snapshot"] = led.snapshot()
    out["keys"] = led.window_keys()
    out["pruned"] = led.prune({"lenet5", "spout"})
    out["after_prune"] = led.snapshot()
    out["dropped_window"] = led.drop_window("w")
    out["keys_after"] = led.window_keys()
    return out


def test_same_records_give_the_same_tree():
    assert _sequence(jax_ledger) == _sequence(port_ledger)
    tree = _sequence(port_ledger)["snapshot"]
    assert list(tree["stages"]) == [s for s in port_ledger.STAGE_ORDER if s in tree["stages"]]


def test_module_record_is_free_when_detached_and_never_raises():
    port_ledger.set_enabled(False)
    try:
        assert not port_ledger.active()
        before = port_ledger.copy_ledger().snapshot()
        port_ledger.record("h2d", 100)
        assert port_ledger.copy_ledger().snapshot() == before
    finally:
        port_ledger.set_enabled(True)
    assert port_ledger.active()
    port_ledger.record("h2d", "not a size")  # swallowed, as in storm_tpu
    jax_ledger.record("h2d", "not a size")


def test_copy_snapshot_prunes_retired_hops():
    led = port_ledger.copy_ledger()
    led.reset()
    rt = SimpleNamespace(spout_execs={"spout": []}, bolt_execs={"sink": []})
    port_ledger.record("spout_ingest", 10, copies=0, engine="spout")
    port_ledger.record("h2d", 10, engine="retired-engine")
    assert port_ledger.copy_snapshot(rt, "t")["stages"] == {}  # primes
    port_ledger.record("spout_ingest", 10, copies=0, engine="spout")
    tree = port_ledger.copy_snapshot(rt, "t")
    assert list(tree["stages"]) == ["spout_ingest"]
    assert ("h2d", "retired-engine") not in led.hop_keys()
    led.drop_window("t")
    led.reset()


def clear_engine_caches() -> None:
    """Empty both packages' engine caches, so the next serve builds and
    warms its engine cold in each. storm_tpu's ``warmup`` skips a bucket
    its cached engine already compiled (``storm_tpu/infer/engine.py:688``),
    so an engine another test left warm ledgers, profiles and traces no
    warm-up batch where the port's fresh one does."""
    clear_engines()
    with jax_engine._ENGINES_LOCK:
        jax_engine._ENGINES.clear()
    # Collect the dropped engines here, where no registry lock is held
    # (storm_tpu's finalizer under its queue registry's lock, ROADMAP C3).
    gc.collect()


def settled_snapshot(ledger_mod, timeout_s: float = 10.0) -> dict:
    """The ledger's tree once every batch's ``d2h`` row has landed (as many
    ``d2h`` calls as ``h2d`` calls), or as it stands after ``timeout_s``.
    storm_tpu's fetch thread records a batch's ``d2h`` row after the
    batch's future resolves, so a snapshot taken the moment the last
    output arrives can miss that batch's row on a loaded machine."""
    deadline = time.monotonic() + timeout_s
    while True:
        tree = ledger_mod.copy_ledger().snapshot()
        st = tree["stages"]
        if st.get("d2h", {}).get("calls", 0) >= st.get("h2d", {}).get("calls", 0) \
                or time.monotonic() > deadline:
            return tree
        time.sleep(0.01)


def _payload(i):
    x = np.random.RandomState(i).rand(1, *SHAPE).astype(np.float32)
    return json.dumps({"instances": x.tolist()})


async def _serve(impl, n, batch):
    """lenet5 through 1 spout -> 1 InferenceBolt -> 1 sink, one record a
    batch (every batch pads alike in both packages)."""
    model = impl.config.ModelConfig(name="lenet5", dtype="float32", num_classes=CLASSES,
                                    input_shape=SHAPE)
    if impl.name == "storm_tpu":
        bolt = jax_infer.InferenceBolt(model, batch, jax_config.ShardingConfig(data_parallel=1))
    else:
        bolt = port_infer.InferenceBolt(model, batch, device="cpu")
    cfg = impl.config.Config()
    c = impl.connectors
    broker = c.MemoryBroker(default_partitions=1)
    tb = impl.runtime.TopologyBuilder()
    tb.set_spout("kafka-spout", c.BrokerSpout(
        broker, "input", impl.config.OffsetsConfig(policy="earliest", max_behind=None)))
    tb.set_bolt("inference-bolt", bolt).shuffle_grouping("kafka-spout")
    tb.set_bolt("kafka-bolt", c.BrokerSink(broker, "output", cfg.sink)) \
        .shuffle_grouping("inference-bolt")
    impl.ledger.copy_ledger().reset()
    cluster = impl.cluster.AsyncLocalCluster()
    rt = await cluster.submit("ledgered", cfg, tb.build())
    payloads = [_payload(i) for i in range(n)]
    for p in payloads:
        broker.produce("input", p)
    deadline = asyncio.get_running_loop().time() + 60
    while broker.topic_size("output") < n:
        assert asyncio.get_running_loop().time() < deadline, "records stuck"
        await asyncio.sleep(0.01)
    await rt.drain(timeout_s=30)
    outs = broker.drain_topic("output")
    await cluster.shutdown()
    tree = settled_snapshot(impl.ledger)
    impl.ledger.copy_ledger().reset()
    return tree, payloads, outs


@pytest.mark.parametrize("max_batch", [1, 4])
def test_lenet5_topology_ledgers_alike(run, max_batch):
    n = 8
    trees, outs = {}, {}
    for name, impl in IMPLS.items():
        clear_engine_caches()
        batch = impl.config.BatchConfig(max_batch=max_batch, buckets=(max_batch,),
                                        max_wait_ms=10_000 if max_batch > 1 else 5,
                                        max_inflight=1)
        trees[name], payloads, outs[name] = run(_serve(impl, n, batch), timeout=120)
    jax_st, port_st = trees["storm_tpu"]["stages"], trees["port"]["stages"]
    assert list(jax_st) == list(port_st) == STAGES
    # warm-up: one batch of max_batch zero rows through each engine
    warm = max_batch
    for stage in STAGES:
        j, p = jax_st[stage], port_st[stage]
        if stage == "d2h":
            # the documented difference: the real rows copied again
            assert p["copies"] == 2 * j["copies"] and p["allocs"] == j["allocs"]
            assert p["bytes"] == j["bytes"] + (n + warm) * CLASSES * 4
            continue
        assert (p["copies"], p["allocs"], p["records"], p["calls"]) == \
            (j["copies"], j["allocs"], j["records"], j["calls"]), stage
        if stage in ("json_encode", "sink_encode"):
            # each package's own prediction text
            for name, tree in trees.items():
                text = sum(len(r.value) for r in outs[name])
                assert tree["stages"][stage]["bytes"] == text, (name, stage)
            continue
        assert p["bytes"] == j["bytes"], stage
    assert port_st["spout_ingest"]["bytes"] == sum(len(p) for p in payloads)
    assert port_st["json_decode"]["bytes"] == n * int(np.prod(SHAPE)) * 4
    # one record a batch of max_batch rows padded (the warm-up's and the
    # stream's): staging and h2d move the padded buffer once each
    assert port_st["h2d"]["copies"] == port_st["staging"]["copies"] == \
        port_st["d2h"]["calls"]
