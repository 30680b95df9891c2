"""The port's stateful bolts (``storm_tpu_torch/runtime/state.py`` and the
executor's checkpoints) against storm_tpu's on the CPU, the behaviours of
``tests/test_state.py``: ``KeyValueState``, both backends' round trips
(the files one package writes read back by the other), the directory
fsync after ``os.replace``, restore after a chaos-crashed task is
replaced by the supervisor, durable state across a topology restart,
the checkpoint counter, and no state machinery for a plain bolt. Each
scenario runs in both packages on the same words and must end in the
same counts.
"""

from __future__ import annotations

import asyncio
import os
from types import SimpleNamespace

import pytest

import storm_tpu.runtime.state as jax_state
import storm_tpu_torch.runtime.state as port_state
from tests.test_torch_runtime import IMPLS, components

STATES = {"storm_tpu": jax_state, "port": port_state}


@pytest.fixture(params=sorted(IMPLS))
def impl(request):
    return SimpleNamespace(**vars(IMPLS[request.param]), state=STATES[request.param])


def _count_bolt(impl):
    class CountBolt(impl.runtime.StatefulBolt):
        """Word count: the canonical stateful operator."""

        async def execute(self, t):
            key = t.get("message")
            self.state.put(key, self.state.get(key, 0) + 1)
            self.collector.ack(t)

    return CountBolt


def test_kv_state_basics(impl):
    s = impl.state.KeyValueState()
    assert not s.dirty
    s.put("a", 1)
    s.put("b", {"nested": [1, 2]})
    assert s.dirty and s.get("a") == 1 and s.get("missing", 42) == 42
    assert "b" in s and len(s) == 2 and sorted(k for k, _ in s.items()) == ["a", "b"]
    snap = s.snapshot()
    s.delete("a")
    s.delete("never")
    assert "a" not in s and snap["a"] == 1
    restored = impl.state.KeyValueState(snap)
    assert restored.get("a") == 1 and not restored.dirty


def test_memory_backend_roundtrip(impl):
    b = impl.state.MemoryStateBackend()
    assert b.load("c", 0) is None
    b.save("c", 0, 3, {"k": 1})
    assert b.load("c", 0) == (3, {"k": 1})
    b.save("c", 1, 1, {"other": True})
    assert b.load("c", 0) == (3, {"k": 1})  # tasks isolated
    got = b.load("c", 0)
    got[1]["k"] = 99
    assert b.load("c", 0) == (3, {"k": 1})  # a load is a copy
    assert isinstance(impl.state.make_backend(""), impl.state.MemoryStateBackend)


def test_file_backends_read_each_other(tmp_path):
    """The port's checkpoint files are storm_tpu's: each package reads what
    the other wrote, and no temporary file is left behind."""
    for writer, reader, sub in ((port_state, jax_state, "a"), (jax_state, port_state, "b")):
        d = tmp_path / sub
        w = writer.make_backend(str(d))
        assert isinstance(w, writer.FileStateBackend)
        assert w.load("count-bolt", 2) is None
        w.save("count-bolt", 2, 1, {"x": [1, 2, 3]})
        w.save("count/bolt", 2, 2, {"x": [1, 2, 3, 4]})
        r = reader.FileStateBackend(str(d))
        assert r.load("count/bolt", 2) == (2, {"x": [1, 2, 3, 4]})
        assert r.load("count-bolt", 2) == (1, {"x": [1, 2, 3]})
        assert sorted(os.listdir(d)) == ["count-bolt-2.json", "count_bolt-2.json"]
        assert open(d / "count-bolt-2.json").read() == \
            '{"version": 1, "data": {"x": [1, 2, 3]}}'


def test_file_backend_fsyncs_directory(impl, tmp_path, monkeypatch):
    """``save`` fsyncs the state directory after ``os.replace``: the
    rename is atomic but not durable."""
    synced, order = set(), []
    real_fsync, real_replace = os.fsync, os.replace

    def spy_fsync(fd):
        synced.add(os.fstat(fd).st_ino)
        order.append(("fsync", os.fstat(fd).st_ino))
        real_fsync(fd)

    def spy_replace(a, b):
        order.append(("replace", None))
        real_replace(a, b)

    monkeypatch.setattr(os, "fsync", spy_fsync)
    monkeypatch.setattr(os, "replace", spy_replace)
    b = impl.state.FileStateBackend(str(tmp_path))
    b.save("count-bolt", 0, 1, {"k": 1})
    d = tmp_path.stat().st_ino
    assert d in synced
    assert order.index(("replace", None)) < order.index(("fsync", d))


def test_failed_save_leaves_the_previous_checkpoint(impl, tmp_path):
    b = impl.state.FileStateBackend(str(tmp_path))
    b.save("c", 0, 1, {"k": 1})
    with pytest.raises(TypeError):
        b.save("c", 0, 2, {"k": object()})  # not JSON
    assert b.load("c", 0) == (1, {"k": 1})
    assert [p.name for p in tmp_path.iterdir()] == ["c-0.json"]


def _config(impl, **topo):
    cfg = impl.config.Config()
    cfg.topology.message_timeout_s = topo.pop("message_timeout_s", 1.0)
    cfg.topology.checkpoint_interval_s = topo.pop("checkpoint_interval_s", 0.05)
    for k, v in topo.items():
        setattr(cfg.topology, k, v)
    return cfg


def _supervised_restore(impl, run) -> dict:
    """Crash the stateful bolt's task: the supervisor replaces it, the
    replacement restores the last checkpoint, the in-flight tuple replays;
    counts end at least exact (at-least-once)."""
    items = ["a", "b", "a", "c", "a", "b"]

    async def scenario():
        c = components(impl)
        builder = impl.runtime.TopologyBuilder()
        builder.set_spout("spout", c.ListSpout(items, replay_on_fail=True), 1)
        builder.set_bolt("count", _count_bolt(impl)(), 1).shuffle_grouping("spout")
        cluster = impl.cluster.AsyncLocalCluster()
        rt = await cluster.submit("stateful", _config(impl), builder.build())
        try:
            for _ in range(400):
                sp = rt.spout_execs["spout"][0].spout
                if len(sp.acked) >= len(items) and \
                        rt.metrics.snapshot().get("count", {}).get("checkpoints", 0) >= 1:
                    break
                await asyncio.sleep(0.02)
            version, first = rt.state_backend.load("count", 0)
            impl.chaos.ChaosMonkey(rt).crash_bolt("count", 0)
            rt.spout_execs["spout"][0].spout.queue.extend(["c", "b"])
            for _ in range(400):
                got = rt.state_backend.load("count", 0)
                if got and got[1].get("c", 0) >= 2 and got[1].get("b", 0) >= 3:
                    break
                await asyncio.sleep(0.02)
            version2, final = rt.state_backend.load("count", 0)
            restarts = rt.metrics.snapshot()["count"]["executor_restarts"]
            return {"first": first, "final": final, "grew": version2 > version,
                    "restarts": restarts}
        finally:
            await cluster.shutdown()

    return run(scenario(), timeout=60)


def test_restore_after_a_supervised_crash_alike(run):
    got = {name: _supervised_restore(impl, run) for name, impl in IMPLS.items()}
    assert got["port"]["first"] == got["storm_tpu"]["first"] == {"a": 3, "b": 2, "c": 1}
    for name, g in got.items():
        f = g["final"]
        assert g["grew"] and g["restarts"] == 1, name
        assert f["a"] >= 3 and f["b"] >= 3 and f["c"] >= 2, name


def _durable(impl, run, state_dir: str) -> dict:
    cfg = _config(impl, checkpoint_interval_s=30.0)  # only the final checkpoint
    cfg.topology.state_dir = state_dir

    async def run_once(items):
        c = components(impl)
        builder = impl.runtime.TopologyBuilder()
        builder.set_spout("spout", c.ListSpout(items), 1)
        builder.set_bolt("count", _count_bolt(impl)(), 1).shuffle_grouping("spout")
        cluster = impl.cluster.AsyncLocalCluster()
        rt = await cluster.submit("durable", cfg, builder.build())
        for _ in range(400):
            if len(rt.spout_execs["spout"][0].spout.acked) >= len(items):
                break
            await asyncio.sleep(0.02)
        await cluster.kill("durable", wait_secs=5.0)  # graceful: checkpoints
        return rt.metrics.snapshot()["count"]["checkpoints"]

    async def scenario():
        return [await run_once(["x", "y", "x"]), await run_once(["y", "z"])]

    ckpts = run(scenario(), timeout=60)
    _, counts = STATES[impl.name].FileStateBackend(state_dir).load("count", 0)
    return {"counts": counts, "checkpoints": ckpts}


def test_durable_state_across_a_restart_alike(run, tmp_path):
    got = {name: _durable(impl, run, str(tmp_path / name)) for name, impl in IMPLS.items()}
    assert got["port"] == got["storm_tpu"] == {"counts": {"x": 2, "y": 2, "z": 1},
                                               "checkpoints": [1, 1]}


def test_plain_bolt_untouched(impl, run):
    async def scenario():
        c = components(impl)
        builder = impl.runtime.TopologyBuilder()
        builder.set_spout("spout", c.ListSpout(["m"]), 1)
        builder.set_bolt("cap", c.CaptureBolt(), 1).shuffle_grouping("spout")
        cluster = impl.cluster.AsyncLocalCluster()
        rt = await cluster.submit("plain", _config(impl), builder.build())
        try:
            for _ in range(200):
                if c.seen:
                    break
                await asyncio.sleep(0.02)
            await asyncio.sleep(0.1)  # two checkpoint intervals
            return rt.state_backend.load("cap", 0), rt.metrics.snapshot().get("cap", {})
        finally:
            await cluster.shutdown()

    loaded, snap = run(scenario(), timeout=30)
    assert loaded is None and "checkpoints" not in snap


def test_pre_checkpoint_and_standalone_checkpoint_now(impl):
    """``pre_checkpoint`` folds a transient aggregate in before the
    snapshot; ``checkpoint_now`` is a no-op outside a topology."""
    class Agg(impl.runtime.StatefulBolt):
        pending = 0

        def pre_checkpoint(self):
            self.state.put("total", self.state.get("total", 0) + self.pending)
            self.pending = 0

    bolt = Agg()
    bolt.init_state(impl.state.KeyValueState())
    bolt.checkpoint_now()
    bolt.pending = 5
    bolt.pre_checkpoint()
    assert bolt.state.get("total") == 5 and bolt.state.dirty
