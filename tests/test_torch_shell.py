"""The port's multilang bridge (``storm_tpu_torch/runtime/shell.py`` and
``storm_tpu_torch/multilang.py``) against storm_tpu's on the CPU: the same
exchanges through each package's ShellBolt, with a child written on the
port's ``multilang`` and with one written on storm_tpu's (the framing is
the same, so each host speaks to either child); a dead child fails its
pending tuples and the next tuple starts a fresh one; a wedged child
fails its pending tuples at the heartbeat; the ShellSpout's acks reach
the child."""

from __future__ import annotations

import asyncio
import pathlib
import sys
import textwrap
from types import SimpleNamespace

import pytest

import storm_tpu.config as jax_config
import storm_tpu.runtime as jax_runtime
import storm_tpu.runtime.cluster as jax_cluster
import storm_tpu_torch.config as port_config
import storm_tpu_torch.runtime as port_runtime
import storm_tpu_torch.runtime.cluster as port_cluster

REPO = str(pathlib.Path(__file__).resolve().parents[1])

IMPLS = {
    "storm_tpu": SimpleNamespace(name="storm_tpu", config=jax_config, runtime=jax_runtime,
                                 cluster=jax_cluster, multilang="storm_tpu.multilang"),
    "port": SimpleNamespace(name="port", config=port_config, runtime=port_runtime,
                            cluster=port_cluster, multilang="storm_tpu_torch.multilang"),
}
# (host package, child's multilang package)
PAIRS = [("port", "port"), ("port", "storm_tpu"), ("storm_tpu", "port"),
         ("storm_tpu", "storm_tpu")]


def _child(tmp_path, child: str, body: str, name: str = "component.py") -> str:
    lines = textwrap.dedent(body).strip().splitlines()
    script = tmp_path / name
    script.write_text(
        "import sys\n"
        f"sys.path.insert(0, {REPO!r})\n"
        f"from {IMPLS[child].multilang} import ShellComponent\n\n"
        "class C(ShellComponent):\n"
        "    def process(self, tup):\n"
        + "\n".join("        " + line for line in lines)
        + "\n\nC().run()\n")
    return str(script)


def _classes(impl):
    rt = impl.runtime

    class ListSpout(rt.Spout):
        def __init__(self, items, replay_on_fail=False):
            self.items, self.replay_on_fail = list(items), replay_on_fail

        def open(self, context, collector):
            super().open(context, collector)
            self.queue = list(self.items)
            self.acked, self.failed = [], []

        async def next_tuple(self):
            if not self.queue:
                return False
            item = self.queue.pop(0)
            await self.collector.emit(rt.Values([item]), msg_id=item)
            return True

        def ack(self, msg_id):
            self.acked.append(msg_id)

        def fail(self, msg_id):
            self.failed.append(msg_id)
            if self.replay_on_fail:
                self.replay_on_fail = False
                self.queue.append(msg_id)

    class Collect(rt.Bolt):
        got = []

        async def execute(self, t):
            Collect.got.append(t.values[0])
            self.collector.ack(t)

    return ListSpout, Collect


async def _run_shell(impl, script, items, heartbeat_s=10.0, replay=False, settle_s=30.0):
    ListSpout, Collect = _classes(impl)
    tb = impl.runtime.TopologyBuilder()
    tb.set_spout("s", ListSpout(items, replay_on_fail=replay), 1)
    tb.set_bolt("shell", impl.runtime.ShellBolt(sys.executable, script,
                                                heartbeat_s=heartbeat_s), 1) \
        .shuffle_grouping("s")
    tb.set_bolt("collect", Collect(), 1).shuffle_grouping("shell")
    cfg = impl.config.Config()
    cfg.topology.message_timeout_s = 300.0
    cluster = impl.cluster.AsyncLocalCluster()
    rt = await cluster.submit("shell", cfg, tb.build())
    try:
        live = rt.spout_execs["s"][0].spout
        deadline = asyncio.get_running_loop().time() + settle_s
        while asyncio.get_running_loop().time() < deadline:
            if len(live.acked) + (0 if replay else len(live.failed)) >= len(items):
                break
            await asyncio.sleep(0.02)
        return sorted(Collect.got, key=repr), sorted(live.acked, key=repr), \
            sorted(live.failed, key=repr)
    finally:
        await cluster.shutdown()


EXCHANGE = """
print("debugging", tup["tuple"][0])  # goes to stderr, not the framing
if tup["tuple"][0] == 2:
    self.fail(tup["id"])
else:
    self.log("saw %s" % tup["tuple"][0])
    self.emit([tup["tuple"][0] * 2], anchors=[tup["id"]])
    self.ack(tup["id"])
"""


@pytest.mark.parametrize("host,child", PAIRS)
def test_same_exchanges(run, tmp_path, host, child):
    """Emits anchored to their input, acks, fails, logs and a user print,
    in every pairing of host and child package."""
    got = run(_run_shell(IMPLS[host], _child(tmp_path, child, EXCHANGE), [1, 2, 3, 4]),
              timeout=60)
    assert got == ([2, 6, 8], [1, 3, 4], [2])


def test_child_death_and_respawn_alike(run, tmp_path):
    """A child that exits fails every pending tuple; the replay goes to a
    fresh child, which processes it, in both packages."""
    got = {}
    for name, impl in IMPLS.items():
        marker = tmp_path / f"died_once_{name}"
        script = _child(tmp_path, name, f"""
            import os
            if tup["tuple"][0] == "die":
                os._exit(1)
            if tup["tuple"][0] == "boom" and not os.path.exists({str(marker)!r}):
                open({str(marker)!r}, "w").close()
                os._exit(1)
            if tup["tuple"][0] != "a":
                self.emit([tup["tuple"][0]], anchors=[tup["id"]])
                self.ack(tup["id"])
            """, f"{name}_death.py")
        died = run(_run_shell(impl, script, ["a", "die"]), timeout=60)
        respawned = run(_run_shell(impl, script, ["boom"], replay=True), timeout=60)
        got[name] = died, respawned
    assert got["port"] == got["storm_tpu"]
    died, respawned = got["port"]
    assert died == ([], [], ["a", "die"]) and respawned == (["boom"], ["boom"], ["boom"])


def test_wedged_child_fails_pending_tuples(run, tmp_path):
    """A child that stops answering (heartbeats included) fails its
    pending tuples after two heartbeat periods, in both packages."""
    got = {}
    for name, impl in IMPLS.items():
        script = _child(tmp_path, name, """
            import time
            time.sleep(3600)
            """, f"{name}_wedged.py")
        got[name] = run(_run_shell(impl, script, ["w1", "w2"], heartbeat_s=0.2, settle_s=20.0),
                        timeout=60)
    assert got["port"] == got["storm_tpu"] == ([], [], ["w1", "w2"])


def test_shell_spout_emits_and_forwards_acks(run, tmp_path):
    """The port's ShellSpout drives a port child: every emit arrives and
    every ack reaches the child's ``on_ack``."""
    ack_file = tmp_path / "acks.txt"
    script = tmp_path / "spout.py"
    script.write_text(
        "import sys\n"
        f"sys.path.insert(0, {REPO!r})\n"
        "from storm_tpu_torch.multilang import ShellSpoutComponent\n\n"
        "class S(ShellSpoutComponent):\n"
        "    items = ['a', 'b', 'c']\n\n"
        "    def next(self):\n"
        "        if self.items:\n"
        "            item = self.items.pop(0)\n"
        "            self.emit([item], id=item)\n\n"
        "    def on_ack(self, tid):\n"
        f"        with open({str(ack_file)!r}, 'a') as f:\n"
        "            f.write(tid + chr(10))\n\n"
        "S().run()\n")
    _, Collect = _classes(IMPLS["port"])

    async def go():
        tb = port_runtime.TopologyBuilder()
        tb.set_spout("src", port_runtime.ShellSpout(sys.executable, str(script)), 1)
        tb.set_bolt("collect", Collect(), 1).shuffle_grouping("src")
        cfg = port_config.Config()
        cfg.topology.message_timeout_s = 300.0
        cluster = port_cluster.AsyncLocalCluster()
        await cluster.submit("sspout", cfg, tb.build())
        try:
            deadline = asyncio.get_running_loop().time() + 30
            while asyncio.get_running_loop().time() < deadline:
                if ack_file.exists() and len(ack_file.read_text().split()) >= 3:
                    break
                await asyncio.sleep(0.05)
            return sorted(Collect.got), sorted(ack_file.read_text().split())
        finally:
            await cluster.shutdown()

    assert run(go(), timeout=60) == (["a", "b", "c"], ["a", "b", "c"])


def test_component_validation():
    for impl in IMPLS.values():
        for cls in (impl.runtime.ShellBolt, impl.runtime.ShellSpout):
            with pytest.raises(ValueError, match="needs a command"):
                cls()
    bolt = port_runtime.ShellBolt("python", "x.py", output_fields=("a", "b"), heartbeat_s=2.0)
    clone = bolt.clone()
    assert clone.command == ("python", "x.py") and clone.declare_output_fields() == \
        {"default": ("a", "b")} and clone.heartbeat_s == 2.0
