"""The port's durable dist control plane on the CPU (after
``tests/test_dist.py``'s reattach and drain tests): the controller's
journal, reattach without a rebuild, the rolling restart, and the
``state_report``, ``profile`` and ``decode_sessions`` control ops.

- A journal-backed ``DistCluster(2, device="cpu")`` over the port's Kafka
  stub serves 12 seeded digits records (lenet5 float32, spout on w0,
  inference and sinks on w1, the ``resume`` policy); then ``abandon()``
  (the controller dies, the workers serve on) and a rebalance of
  ``inference-bolt`` 2 -> 1 journaled but never applied. A fresh
  ``DistCluster`` on the same journal reattaches: ``reattached`` True, the
  pids unchanged, each worker's ``submits`` still 1 (no engine built
  again), the missed rebalance reconciled. 12 more records are each
  answered once, every prediction within 1e-5 of storm_tpu's engine
  forward of its record (the bound of ``tests/test_torch_dist.py``).
  Then ``rolling_restart`` under the heartbeat monitor while 12 more
  records arrive: every worker drained and replaced, the monitor never
  recovering one, every record answered, the reconciled parallelism kept.
- A controller whose journaled workers are all gone spawns a fresh mesh
  and resets the journal; the journal keys ride ``Config``'s dict.
- ``state_report`` before a submit; ``decode_sessions``' empty shape
  before the decode tier is imported and its rows after (after
  ``tests/test_decode.py``), merged by ``DistCluster.decode_sessions``;
  ``profile`` writes a trace file and refuses a second capture, and
  ``replay_kernels`` while it runs.

Worker processes get one intra-op thread each and bind port 0; every
cluster and stub is shut down in a ``finally``.
"""

import json
import os
import sys
import threading
import time

import numpy as np
import pytest

from storm_tpu_torch.api.schema import decode_predictions
from storm_tpu_torch.config import Config, OffsetsConfig
from storm_tpu_torch.connectors.kafka_protocol import KafkaWireBroker
from storm_tpu_torch.connectors.kafka_stub import KafkaStubBroker
from storm_tpu_torch.dist import DistCluster, transport, worker
from storm_tpu_torch.dist.controller import _kill_worker_pid, _worker_alive
from tests.test_torch_checkpoints import abstract_init  # noqa: F401  (fixture)
from tests.test_torch_dist import (WORKER_ENV, _dist_config, _log_ends, _outputs, _ref_groups,
                                   _storm_tpu_forward)

PLACEMENT = {"kafka-spout": 0, "inference-bolt": 1, "kafka-bolt": 1, "dlq-bolt": 1}
TOL = 1e-5


def _wait_rows(stub, base: dict, n: int, timeout: float = 90.0) -> np.ndarray:
    deadline = time.time() + timeout
    while time.time() < deadline:
        outs = _outputs(stub, "output", base)
        if sum(decode_predictions(v).data.shape[0] for v in outs) >= n:
            break
        time.sleep(0.1)
    outs = _outputs(stub, "output", base)
    if not outs:
        return np.zeros((0, 10), np.float32)
    return np.concatenate([decode_predictions(v).data for v in outs])


def _counts(rows: np.ndarray, ref: np.ndarray) -> tuple:
    """Served rows held to storm_tpu's forwards: each within TOL of one;
    returns (rows per group of forwards, records per group)."""
    err = np.abs(rows[:, None] - ref[None]).max(-1)
    assert err.min(1).max() < TOL, err.min(1).max()
    groups = _ref_groups(ref, TOL)
    return (np.bincount(groups[err.argmin(1)], minlength=len(ref)),
            np.bincount(groups, minlength=len(ref)))


def test_reattach_without_a_rebuild_then_a_rolling_restart(tmp_path, abstract_init):
    from storm_tpu_torch.data import load_digits_nhwc

    xs = load_digits_nhwc((32, 32, 1))[2][:36]
    ref = _storm_tpu_forward(xs)
    stub = KafkaStubBroker(partitions=2)
    producer = KafkaWireBroker(f"127.0.0.1:{stub.port}")
    jdir = str(tmp_path / "journal")
    cfg = _dist_config(f"127.0.0.1:{stub.port}", timeout_s=10.0)
    cfg.offsets = OffsetsConfig(policy="resume", group_id="ctl", max_behind=None)
    kw = dict(device="cpu", env=WORKER_ENV, worker_threads=1, journal_dir=jdir)
    clusters = []
    pids: dict = {}

    def produce(rows):
        for x in rows:
            producer.produce("input", json.dumps({"instances": x[None].tolist()}).encode())

    try:
        cluster = DistCluster(2, **kw)
        clusters.append(cluster)
        assert not cluster.reattached  # an empty journal: a fresh mesh
        cluster.submit("ctl", cfg, placement=PLACEMENT)
        pids = dict(cluster._pids)
        base = _log_ends(stub, "output")
        produce(xs[:12])
        got, want = _counts(_wait_rows(stub, base, 12), ref[:12])
        assert (got == want).all()

        # The controller dies between journaling a rebalance and applying it.
        cluster._jappend("rebalance", component="inference-bolt", parallelism=1)
        cluster.abandon()
        assert all(_worker_alive(pid, i) for i, pid in pids.items())

        t0 = time.perf_counter()
        cluster = DistCluster(2, **kw)
        clusters.append(cluster)
        reattach_s = time.perf_counter() - t0
        assert cluster.reattached and reattach_s < 30
        reports = cluster.state_reports()
        assert {i: r["pid"] for i, r in reports.items()} == pids
        assert all(r["submits"] == 1 for r in reports.values()), "reattach rebuilt a worker"
        assert reports[1]["parallelism"]["inference-bolt"] == 1
        assert all(r["topology"] == "ctl" and not r["draining"] for r in reports.values())
        ev = [e for e in cluster.flight.tail(50) if e["kind"] == "dist_reattached"]
        assert ev and ev[0]["survivors"] == [0, 1] and ev[0]["dead"] == []
        assert ev[0]["reconciled"] == ["inference-bolt"]
        assert cluster.ctrl_metrics.snapshot()["controller"]["dist_journal_replayed"] >= 3

        base = _log_ends(stub, "output")
        produce(xs[12:24])
        got, want = _counts(_wait_rows(stub, base, 12), ref[12:24])
        assert (got == want).all(), "the adopted mesh answered a record twice or not at all"
        rep = cluster.clients[1].control("metrics")
        assert [e["model"] for e in rep["engines"]] == ["lenet5"]

        # A rolling restart under the monitor, records arriving meanwhile.
        cluster.start_monitor(interval_s=0.3, misses=2)
        base = _log_ends(stub, "output")
        feeder = threading.Thread(
            target=lambda: [produce(xs[i:i + 1]) or time.sleep(0.2) for i in range(24, 36)],
            daemon=True)
        feeder.start()
        rows = cluster.rolling_restart(drain_timeout_s=20.0, settle_s=0.5)
        feeder.join(timeout=30)
        assert not feeder.is_alive()
        cluster.stop_monitor()
        assert [r["worker"] for r in rows] == [0, 1]
        assert all(r["drained"] and r["new_pid"] != r["old_pid"] for r in rows), rows
        assert all(r["resubmit_s"] > 0 for r in rows)
        assert cluster._draining == set()
        kinds = [e["kind"] for e in cluster.flight.tail(200)]
        assert kinds.count("dist_worker_restarted") == 2 and "dist_worker_draining" in kinds
        assert "dist_worker_recovered" not in kinds  # the monitor held off
        got, want = _counts(_wait_rows(stub, base, 12), ref[24:])
        assert (got >= want).all(), "the rolling restart lost a record"
        reports = cluster.state_reports()
        assert reports[1]["parallelism"]["inference-bolt"] == 1
        assert all(r["submits"] == 1 for r in reports.values())  # fresh processes
        stats = cluster.journal_stats()
        assert stats["appends"] >= 2  # a peer_update per restarted worker
        cluster.kill()
    finally:
        producer.close()
        for c in clusters[1:]:
            c.shutdown()
        if len(clusters) == 1:
            clusters[0].shutdown()
        for i, pid in pids.items():  # workers abandoned and never adopted
            _kill_worker_pid(pid, i)
        stub.close()


def test_no_survivor_spawns_a_fresh_mesh(tmp_path):
    jdir = str(tmp_path / "journal")
    kw = dict(device="cpu", env=WORKER_ENV, worker_threads=1, journal_dir=jdir)
    cluster = DistCluster(1, **kw)
    try:
        old = dict(cluster._pids)
        cluster._jappend("submit", name="gone", config=Config().to_dict(), builder="standard",
                         placement={"kafka-spout": 0})
    finally:
        cluster.shutdown()
    assert not _worker_alive(old[0], 0)
    cluster = DistCluster(1, **kw)
    try:
        assert not cluster.reattached
        assert cluster._pids[0] != old[0]
        assert cluster.state_reports()[0]["submits"] == 0
    finally:
        cluster.shutdown()
    from storm_tpu_torch.dist.journal import ControllerJournal

    st = ControllerJournal(jdir).load()
    assert st.recipe is None and st.pids == {0: cluster._pids[0]}


def test_journal_keys_ride_the_config():
    import storm_tpu.config as jax_config

    d = {"control": {"journal_dir": "/var/lib/ctl", "journal_snapshot_every": 8,
                     "reattach": False}}
    cfg = Config.from_dict(d)
    assert (cfg.control.journal_dir, cfg.control.journal_snapshot_every,
            cfg.control.reattach) == ("/var/lib/ctl", 8, False)
    assert Config.from_dict(cfg.to_dict()).control == cfg.control
    jax = jax_config.Config.from_dict(d).to_dict()
    assert Config.from_dict({"control": jax["control"]}).control == cfg.control
    for bad in ({"journal_snapshot_every": 0}, {"journal_snapshot_every": -1}):
        with pytest.raises(ValueError):
            Config.from_dict({"control": bad})
        with pytest.raises(ValueError):
            jax_config.Config.from_dict({"control": bad})


def test_worker_alive_is_not_fooled_by_other_pids():
    assert not _worker_alive(os.getpid(), 0)  # a live process, not a worker
    import subprocess

    p = subprocess.Popen([sys.executable, "-c", "pass"])
    p.wait()
    assert not _worker_alive(p.pid, 0)


# ---- the control ops on an in-process worker --------------------------------------------


@pytest.fixture
def in_process_worker():
    ws = worker.WorkerServer(0, 3, device="cpu", host="127.0.0.1")
    runner = threading.Thread(target=ws.serve_forever, daemon=True)
    runner.start()
    client = transport.WorkerClient(f"127.0.0.1:{ws.port}", token="")
    try:
        client.wait_ready(timeout=30)
        yield ws, client
    finally:
        try:
            client.probe("shutdown", timeout=30)
        finally:
            client.close()
            runner.join(timeout=15)


def test_state_report_before_submit(in_process_worker):
    ws, client = in_process_worker
    rep = client.control("state_report")
    assert rep["ok"] and rep["index"] == 3 and rep["pid"] == os.getpid()
    assert rep["submits"] == 0 and rep["device"] == "cpu"
    assert rep["wire"] == client.control("ping")["wire"]
    assert "topology" not in rep and "parallelism" not in rep
    with pytest.raises(RuntimeError, match="no topology"):
        client.control("seek", component="kafka-spout", position="earliest")


def test_decode_sessions_arm(in_process_worker, monkeypatch, run):
    """Empty-shaped before the decode tier is imported (storm_tpu's arm's
    shape), the process's session stores after a request is served, and
    merged by the controller."""
    from tests.test_torch_decode import IMPLS as DEC, _close, _drive, _mk_bolt, _req

    ws, client = in_process_worker
    saved = {k: v for k, v in sys.modules.items() if k.startswith("storm_tpu_torch.decode")}
    for k in saved:
        monkeypatch.delitem(sys.modules, k)
    empty = client.control("decode_sessions")
    assert empty == {"index": 3, "decode": {"stores": [], "engines": [],
                                            "sessions_live": 0, "tokens_emitted": 0}}
    for k, v in saved.items():
        monkeypatch.setitem(sys.modules, k, v)

    async def serve():
        bolt, _ = _mk_bolt(DEC["port"], seed=24)
        await _drive(bolt, _req(DEC["port"], "s1", n=2))
        return bolt

    bolt = run(serve(), timeout=60)
    try:
        out = client.control("decode_sessions")
        assert out["index"] == 3
        assert out["decode"]["tokens_emitted"] >= 2 and out["decode"]["stores"]
        cluster = DistCluster(0, device="cpu")
        cluster.clients = [client, client]
        merged = cluster.decode_sessions()
        assert merged["merged"]["tokens_emitted"] == 2 * out["decode"]["tokens_emitted"]
        assert [r["worker"] for r in merged["merged"]["stores"]] == \
            [0] * len(out["decode"]["stores"]) + [1] * len(out["decode"]["stores"])
        cluster.clients = []
        cluster.shutdown()
    finally:
        _close(bolt)


def test_profile_writes_a_trace_and_refuses_a_second(in_process_worker, tmp_path):
    ws, client = in_process_worker
    log_dir = str(tmp_path / "prof")
    assert client.control("profile", log_dir=log_dir, seconds=1.0)["ok"]
    with pytest.raises(RuntimeError, match="already running"):
        client.control("profile", log_dir=str(tmp_path / "second"), seconds=0.1)
    with pytest.raises(RuntimeError, match="a profiler is already running"):
        client.control("replay_kernels")
    ws._profile_thread.join(timeout=60)
    assert not ws._profile_thread.is_alive()
    with open(os.path.join(log_dir, "trace.json")) as f:
        assert "traceEvents" in json.load(f)
    assert worker._PROFILER.acquire(blocking=False)  # released with the capture
    worker._PROFILER.release()
    assert client.control("profile", log_dir=str(tmp_path / "again"), seconds=0.1)["ok"]
    ws._profile_thread.join(timeout=60)
    assert not os.path.exists(str(tmp_path / "second"))
