"""The port's distributed runtime (``storm_tpu_torch/dist``) on the CPU.

- worker tags: ids carry their worker in the top byte in both packages,
  and the port's ``DistLedger`` routes every op as storm_tpu's does;
- the stdlib transport keeps gRPC's contract: a wrong token is
  UNAUTHENTICATED (and ``wait_ready`` fails at once), a closed port is
  UNAVAILABLE and retried, a passed deadline is DEADLINE_EXCEEDED and a
  Deliver is not sent again after it, a multi-megabyte payload arrives
  whole, and ``Deliver`` blocks while the receiving inbox is full;
- the shared-memory lane carries a frame between two processes;
- ``DistCluster(3, device="cpu")`` over the port's Kafka stub: lenet5
  float32 on its digits checkpoint, placement spout w0, inference w1,
  sinks w2, 12 seeded records and 1 poison: every prediction within 1e-5
  of storm_tpu's engine forward of the same instance (the bound of
  ``tests/test_torch_drpc.py``), the poison dead-lettered, each record
  answered exactly once on the clean run (records whose answers lie
  within twice the bound of each other counted as one group); then one-shot frame corruption
  on w0's outbound frames: the receiver counts the bad checksums and the
  trees replay with no record lost;
- ``submit`` refuses a config whose control token is not the one the
  workers were started with; storm_tpu's journal keys ride the config;
- the ``null`` builder serves through one in-process worker, answering
  storm_tpu's ``NullEngine`` distribution; ``replay_kernels`` refuses a
  worker on the CPU;
- without a card, the default device raises (the controller and the
  worker's ``-m`` entry alike).

Worker processes get one intra-op thread each and bind port 0; every
cluster and stub is shut down in a ``finally``.
"""

import asyncio
import json
import os
import socket
import subprocess
import sys
import threading
import time

import numpy as np
import pytest

import storm_tpu.dist.worker as jax_worker
import storm_tpu.runtime.tuples as jax_tuples
from storm_tpu_torch.api.schema import decode_predictions
from storm_tpu_torch.config import BatchConfig, Config, ModelConfig, OffsetsConfig
from storm_tpu_torch.connectors.kafka_protocol import KafkaWireBroker
from storm_tpu_torch.connectors.kafka_stub import KafkaStubBroker
from storm_tpu_torch.dist import DistCluster, transport, wire, worker
from storm_tpu_torch.resilience import RetryPolicy, RpcError, StatusCode
from storm_tpu_torch.runtime import tuples
from storm_tpu_torch.runtime.acker import AckLedger
from storm_tpu_torch.runtime.tuples import Tuple
from tests.test_torch_checkpoints import abstract_init  # noqa: F401  (fixture)
from tests.test_torch_codec import storm_tpu_native  # noqa: F401 (module fixture)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
WORKER_ENV = {"OMP_NUM_THREADS": "1", "MKL_NUM_THREADS": "1"}
CHECKPOINT = "checkpoints/lenet5_digits"
PLACEMENT = {"kafka-spout": 0, "inference-bolt": 1, "kafka-bolt": 2, "dlq-bolt": 2}
POISON = b'{"instances": [[1.0, 2.0], [3.0]]}'


# ---- worker tags and ack routing --------------------------------------------------


def test_worker_tags_mark_every_id():
    try:
        for idx in (0, 1, 7, 255):
            tuples.set_worker_tag(idx)
            jax_tuples.set_worker_tag(idx)
            ids = [tuples.new_id() for _ in range(200)]
            assert {tuples.owner_of(i) for i in ids} == {idx}
            assert all(0 < i < 2**64 for i in ids)
            assert {jax_tuples.owner_of(i) for i in ids} == {idx}
            assert tuples.owner_of(jax_tuples.new_id()) == idx
        with pytest.raises(ValueError):
            tuples.set_worker_tag(256)
    finally:
        tuples.set_worker_tag(0)
        jax_tuples.set_worker_tag(0)


class _Sender:
    def __init__(self):
        self.ops = []

    def put_ack_nowait(self, op, root, edge):
        self.ops.append((op, root, edge))


def test_dist_ledger_routes_like_storm_tpus():
    from storm_tpu.runtime.acker import AckLedger as JaxAckLedger

    runs = []
    for mod, ledger_cls in ((worker, AckLedger), (jax_worker, JaxAckLedger)):
        senders = {0: _Sender(), 2: _Sender()}
        done = []
        led = mod.DistLedger(ledger_cls(timeout_s=5.0), 1, senders)
        local, remote, unknown = (1 << 56) | 11, (2 << 56) | 22, (9 << 56) | 33
        led.init_root(local, "m1", lambda msg, ok, ts: done.append((msg, ok)), 0.0)
        led.anchor(local, 5)
        led.anchor(remote, 6)
        led.ack_edge(remote, 6)
        led.xor(remote, 7)
        led.fail_root((0 << 56) | 44)
        led.xor(unknown, 8)  # no sender for worker 9: applied locally
        led.ack_edge(local, 5)
        runs.append(({k: s.ops for k, s in senders.items()}, led.inflight, led.outstanding(remote),
                     done, led.watch(remote, lambda ok: None)))
    assert runs[0] == runs[1]
    assert runs[0][0][2] == [("anc", (2 << 56) | 22, 6), ("ake", (2 << 56) | 22, 6),
                             ("xor", (2 << 56) | 22, 7)]
    assert runs[0][0][0] == [("fail", 44, 0)]
    assert runs[0][3] == [("m1", True)] and runs[0][1] == 0


# ---- the transport ------------------------------------------------------------------


def _server(deliver=None, ack=None, control=None, token=""):
    handler = transport.DistHandler(
        deliver or (lambda req, ctx: b"{}"), ack or (lambda req, ctx: b"{}"),
        control or (lambda req, ctx: json.dumps({"ok": True, "n": len(req)}).encode()),
        token=token)
    srv = transport.TransportServer(handler, port=0, host="127.0.0.1")
    srv.start()
    return srv


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def test_wrong_token_is_unauthenticated():
    calls = []
    srv = _server(control=lambda req, ctx: calls.append(1) or b'{"ok": true}', token="s3cret")
    try:
        target = f"127.0.0.1:{srv.port}"
        assert transport.WorkerClient(target, token="s3cret").control("ping") == {"ok": True}
        bad = transport.WorkerClient(target, token="wrong", retry=RetryPolicy(attempts=4))
        with pytest.raises(RpcError) as ei:
            bad.control("ping")
        assert ei.value.code() is StatusCode.UNAUTHENTICATED
        with pytest.raises(RpcError):
            transport.WorkerClient(target, token="").deliver(b"[]")
        t0 = time.monotonic()
        with pytest.raises(RuntimeError, match="rejected the handshake"):
            bad.wait_ready(timeout=20)
        assert time.monotonic() - t0 < 2.0
        assert calls == [1]  # the handler never ran for a wrong token
    finally:
        srv.stop()


def test_closed_port_is_unavailable_and_retried():
    port = _free_port()
    client = transport.WorkerClient(f"127.0.0.1:{port}", token="")
    retries, servers = [], []

    def on_retry(attempt, exc):
        retries.append(exc.code())
        if attempt == 1:  # the worker comes up between attempts
            handler = transport.DistHandler(lambda r, c: b"{}", lambda r, c: b"{}",
                                            lambda r, c: b'{"ok": true}', token="")
            srv = transport.TransportServer(handler, port=port, host="127.0.0.1")
            srv.start()
            servers.append(srv)

    pol = RetryPolicy(attempts=4, base_s=0.01, cap_s=0.02)
    try:
        out = pol.call_sync(lambda t: client._call("Control", b'{"cmd": "ping"}', t),
                            op_timeout=5.0, codes=transport.RETRYABLE_NARROW,
                            on_retry=on_retry)
        assert json.loads(out) == {"ok": True}
        assert retries == [StatusCode.UNAVAILABLE, StatusCode.UNAVAILABLE]
    finally:
        client.close()
        for s in servers:
            s.stop()


def test_deadline_and_large_payload():
    calls, sizes = [], []

    def slow(req, ctx):
        calls.append(ctx.time_remaining())
        time.sleep(0.6)
        return b"{}"

    def control(req, ctx):
        sizes.append(len(req))
        return bytes(req[:16])

    srv = _server(deliver=slow, control=control)
    try:
        client = transport.WorkerClient(f"127.0.0.1:{srv.port}", token="",
                                        retry=RetryPolicy(attempts=3, base_s=0.01))
        with pytest.raises(RpcError) as ei:
            client.deliver(b"\xb7" + b"x" * 100, timeout=0.2)
        assert ei.value.code() is StatusCode.DEADLINE_EXCEEDED
        assert len(calls) == 1 and 0 < calls[0] <= 0.2  # not sent again
        big = np.random.RandomState(0).bytes(8 * 1024 * 1024 + 13)
        out = client._call("Control", big, 30.0)
        assert out == big[:16] and sizes == [len(big)]
        time.sleep(0.5)
        assert client._call("Control", b"abc", 5.0) == b"abc"  # the connection survived
    finally:
        srv.stop()


GATE = threading.Event()


def gate_topology(cfg, broker, device=None):
    """A bolt that holds its first tuple until ``GATE`` is set."""
    from storm_tpu_torch.runtime import Bolt, Spout, TopologyBuilder

    class Idle(Spout):
        def declare_output_fields(self):
            return {"default": ("message",)}

        async def next_tuple(self):
            return False

    class Gate(Bolt):
        def declare_output_fields(self):
            return {"default": ("message",)}

        async def execute(self, t):
            await asyncio.to_thread(GATE.wait, 30)
            self.collector.ack(t)

    tb = TopologyBuilder()
    tb.set_spout("src", Idle())
    tb.set_bolt("gate", Gate()).shuffle_grouping("src")
    return tb.build()


def test_deliver_blocks_on_a_full_inbox():
    import importlib

    # The worker resolves its builder by module path: hold the gate of the
    # module it imports, whatever name pytest imported this file under.
    gate = importlib.import_module("tests.test_torch_dist").GATE
    gate.clear()
    ws = worker.WorkerServer(0, 1, device="cpu", host="127.0.0.1")
    runner = threading.Thread(target=ws.serve_forever, daemon=True)
    runner.start()
    client = transport.WorkerClient(f"127.0.0.1:{ws.port}", token="")
    try:
        client.wait_ready(timeout=10)
        cfg = Config()
        cfg.topology.inbox_capacity = 1
        client.control("submit", name="gate", config=cfg.to_dict(),
                       placement={"src": 0, "gate": 1},
                       peers={0: "127.0.0.1:1", 1: f"127.0.0.1:{ws.port}"},
                       builder="tests.test_torch_dist:gate_topology")
        client.control("start_bolts")

        def frame(i):
            t = Tuple(values=[f"m{i}"], fields=("message",), source_component="src",
                      edge_id=i + 1, root_ts=time.perf_counter())
            return wire.encode_deliveries([("gate", 0, t)])

        client.deliver(frame(0))  # taken by the executor, which holds it
        time.sleep(0.2)
        client.deliver(frame(1))  # waits in the inbox (capacity 1)
        done = threading.Event()
        threading.Thread(target=lambda: (client.deliver(frame(2)), done.set()),
                         daemon=True).start()
        assert not done.wait(0.8)  # the third Deliver blocks: the inbox is full
        gate.set()
        assert done.wait(10)
        client.control("kill")
    finally:
        gate.set()
        try:
            client.probe("shutdown", timeout=5)
        finally:
            client.close()
            runner.join(timeout=10)


# ---- the shared-memory lane -------------------------------------------------------

_SHM_CHILD = """
import sys
sys.path.insert(0, {root!r})
import numpy as np
from storm_tpu_torch.dist import shm, wire
from storm_tpu_torch.runtime.frames import RecordFrame
from storm_tpu_torch.runtime.tuples import Tuple
recs = [np.random.RandomState(i).bytes(50000) for i in range(3)]
t = Tuple(values=[RecordFrame(recs), "tag"], fields=("message", "k"), source_component="s",
          edge_id=9, anchors=frozenset([5]), origins=frozenset([("in", 0, 3)]),
          root_ts=0.0)
parts, _ = wire.encode_delivery_parts([("bolt", 2, t)], now=1.0)
seg, n = shm.write_segment(parts)
print(wire.encode_shm_header(seg.name, 0, n).hex(), flush=True)
sys.stdin.readline()
seg.close()
seg.unlink()
print("unlinked", flush=True)
"""


def test_shm_lane_between_two_processes():
    child = subprocess.Popen([sys.executable, "-c", _SHM_CHILD.format(root=ROOT)],
                             stdin=subprocess.PIPE, stdout=subprocess.PIPE,
                             stderr=subprocess.PIPE, text=True)
    try:
        header = bytes.fromhex(child.stdout.readline().strip())
        assert header[0] == wire.SHM_MAGIC
        [(comp, task, t)] = transport.decode_deliveries(header)
        frame = t.values[0]
        assert (comp, task, t.values[1], t.edge_id) == ("bolt", 2, "tag", 9)
        assert [bytes(r) for r in frame] == [np.random.RandomState(i).bytes(50000)
                                             for i in range(3)]
        assert t.anchors == frozenset([5]) and t.origins == frozenset([("in", 0, 3)])
        del frame, t
        out, err = child.communicate("go\n", timeout=20)
        assert child.returncode == 0 and "unlinked" in out
        assert "leaked" not in err, err
        bad = bytearray(header)
        bad[-6] ^= 1
        with pytest.raises(wire.WireError):
            transport.decode_deliveries(bytes(bad))
    finally:
        if child.poll() is None:
            child.kill()
            child.wait(timeout=10)


# ---- DistCluster over the port's stub ------------------------------------------------


def _dist_config(bootstrap: str, timeout_s: float) -> Config:
    cfg = Config()
    cfg.model = ModelConfig.from_checkpoint(CHECKPOINT, dtype="float32")
    cfg.batch = BatchConfig(max_batch=4, buckets=(4,), max_wait_ms=20)
    cfg.offsets = OffsetsConfig(policy="earliest", max_behind=None)
    cfg.broker.kind, cfg.broker.bootstrap = "kafka", bootstrap
    cfg.topology.spout_parallelism = 1
    cfg.topology.inference_parallelism = 2
    cfg.topology.sink_parallelism = 1
    cfg.topology.message_timeout_s = timeout_s
    cfg.topology.shm_min_bytes = 1  # small lenet5 batches still take the lane
    return cfg


def _storm_tpu_forward(x: np.ndarray) -> np.ndarray:
    from storm_tpu.config import BatchConfig as JBatch
    from storm_tpu.config import ModelConfig as JModel
    from storm_tpu.config import ShardingConfig
    from storm_tpu.infer.engine import InferenceEngine

    model = JModel(name="lenet5", dtype="float32", num_classes=10, input_shape=(32, 32, 1),
                   checkpoint=os.path.join(ROOT, "checkpoints", "lenet5_digits"))
    eng = InferenceEngine(model, ShardingConfig(data_parallel=1),
                          JBatch(max_batch=16, buckets=(16,)))
    return eng.predict(x)


def _ref_groups(ref: np.ndarray, tol: float) -> np.ndarray:
    """A label for each reference row, shared by rows within ``2 * tol`` of
    each other (transitively): a served row within ``tol`` of one row of a
    group cannot be told from the group's other rows, and its nearest row
    lies in that group."""
    near = np.abs(ref[:, None] - ref[None]).max(-1) <= 2 * tol
    labels = np.arange(len(ref))
    while True:
        new = np.where(near, labels[None, :], len(ref)).min(1)
        if (new == labels).all():
            return labels
        labels = new


def _outputs(stub, topic: str, since=None) -> list:
    """The topic's values, partition by partition; ``since`` (a previous
    call's ``_log_ends``) keeps only what came after."""
    with stub._lock:
        logs = [stub._logs.get((topic, p), []) for p in range(stub.partitions)]
        return [v for p, log in enumerate(logs)
                for _k, v, _ts in log[(since or {}).get(p, 0):]]


def _log_ends(stub, topic: str) -> dict:
    with stub._lock:
        return {p: len(stub._logs.get((topic, p), [])) for p in range(stub.partitions)}


def test_dist_cluster_serves_lenet5_like_storm_tpu(abstract_init):
    from storm_tpu_torch.data import load_digits_nhwc

    xs = load_digits_nhwc((32, 32, 1))[2][:12]
    ref = _storm_tpu_forward(xs)
    stub = KafkaStubBroker(partitions=2)
    cluster = None
    producer = KafkaWireBroker(f"127.0.0.1:{stub.port}")
    try:
        cfg = _dist_config(f"127.0.0.1:{stub.port}", timeout_s=6.0)
        cfg.control.auth_token = "dist-test-token"
        cluster = DistCluster(3, device="cpu", env=WORKER_ENV, worker_threads=1,
                              auth_token=cfg.control.resolve_token())
        assert cluster.submit("dist", cfg, placement=PLACEMENT) == PLACEMENT
        for x in xs:
            producer.produce("input", json.dumps({"instances": x[None].tolist()}).encode())
        producer.produce("input", POISON)
        deadline = time.time() + 60
        while time.time() < deadline and (stub.topic_size("output") < 12
                                           or stub.topic_size("dead-letter") < 1):
            time.sleep(0.1)
        assert cluster.drain(timeout_s=20)
        time.sleep(0.3)
        snap = cluster.metrics()
        outs, dlq = _outputs(stub, "output"), _outputs(stub, "dead-letter")
        assert len(outs) == 12 and len(dlq) == 1  # exactly once on the clean run
        assert json.loads(dlq[0])["stage"] == "decode"
        assert snap["kafka-spout"].get("tree_failed", 0) == 0
        assert snap["kafka-spout"]["tree_acked"] == 13
        preds = np.concatenate([decode_predictions(v).data for v in outs])
        assert np.isfinite(preds).all()
        np.testing.assert_allclose(preds.sum(-1), 1.0, atol=1e-5)
        err = np.abs(preds[:, None] - ref[None]).max(-1)
        assert err.min(1).max() < 1e-5
        # Each instance answered once, as far as the bound tells its answer
        # from the others' (same-class digits answer within 2e-5).
        groups = _ref_groups(ref, 1e-5)
        assert (np.bincount(groups[err.argmin(1)], minlength=12)
                == np.bincount(groups, minlength=12)).all()
        assert snap["_transport"]["dist_shm_batches"] > 0
        assert snap["inference-bolt"]["dead_lettered"] == 1
        rep = cluster.clients[1].control("metrics")
        assert [e["model"] for e in rep["engines"]] == ["lenet5"]
        assert rep["engines"][0]["forwards"] >= 3
        with pytest.raises(RuntimeError, match="on the card only"):
            cluster.clients[1].control("replay_kernels")
        util = cluster.utilization()
        assert util["components"] == {}  # the first call primes the cursors
        assert set(cluster.health()) == {0, 1, 2}
        assert "ready" not in cluster.worker_logs(1)

        # Frame corruption on w0's outbound frames: replay, never loss.
        base = _log_ends(stub, "output")
        cluster.activate()  # the drain above deactivated the spout
        cluster.clients[0].control("chaos", corrupt_next=2)
        for x in xs[:6]:
            producer.produce("input", json.dumps({"instances": x[None].tolist()}).encode())
        deadline = time.time() + 60
        while time.time() < deadline and len(_outputs(stub, "output", base)) < 6:
            time.sleep(0.2)
        new = np.concatenate([decode_predictions(v).data
                              for v in _outputs(stub, "output", base)])
        err = np.abs(new[:, None] - ref[None, :6]).max(-1)
        assert err.min(1).max() < 1e-5
        groups = _ref_groups(ref[:6], 1e-5)
        # every record came out
        assert (np.bincount(groups[err.argmin(1)], minlength=6)
                >= np.bincount(groups, minlength=6)).all()
        chaos = cluster.clients[0].control("chaos")["chaos"]
        assert chaos["corrupt_next"] == 0 and chaos["counts"]["frame_corruption"] == 2
        w1 = cluster.clients[1].control("metrics")["metrics"]
        assert w1["_transport"]["dist_wire_errors"] >= 1
        kinds = {e["kind"] for e in cluster.clients[1].control("traces", n=50)["flight"]}
        assert "wire_error" in kinds
        cluster.kill()
    finally:
        producer.close()
        if cluster is not None:
            cluster.shutdown()
        stub.close()


def test_submit_holds_the_config_to_the_workers_token(monkeypatch):
    """A config's control token must be the one the workers were started
    with; storm_tpu's journal keys ride the config's dict."""
    monkeypatch.delenv("STORM_TPU_CONTROL_TOKEN", raising=False)
    cluster = DistCluster(0, device="cpu", auth_token="started-with")
    try:
        cfg = Config()
        cfg.control.auth_token = "another"
        with pytest.raises(ValueError, match="auth_token=cfg.control.resolve_token"):
            cluster.submit("t", cfg, placement={"kafka-spout": 0})
        monkeypatch.setenv("STORM_TPU_CONTROL_TOKEN", "from-env")
        cfg.control.auth_token = ""  # the env fallback names another token too
        with pytest.raises(ValueError, match="auth_token=cfg.control.resolve_token"):
            cluster.submit("t", cfg, placement={"kafka-spout": 0})
        monkeypatch.setenv("DIST_TEST_TOKEN", "started-with")
        cfg.control.auth_token = "env:DIST_TEST_TOKEN"
        # Past the token check: the placement names a worker this empty
        # cluster does not have.
        with pytest.raises(ValueError, match="unknown workers"):
            cluster.submit("t", cfg, placement={"kafka-spout": 0})
    finally:
        cluster.shutdown()
    for key, value in (("journal_dir", "/j"), ("journal_snapshot_every", 3), ("reattach", False)):
        cfg = Config.from_dict({"control": {key: value}})
        assert getattr(cfg.control, key) == value
        assert Config.from_dict(cfg.to_dict()).control == cfg.control


def test_null_engine_builder_serves_through_a_worker():
    """The ``null`` builder (a NullEngine in the inference slot) on one
    in-process worker over the port's stub: every record answered with
    the uniform distribution, as storm_tpu's NullEngine answers."""
    from storm_tpu.infer.engine import NullEngine as JaxNullEngine

    from storm_tpu_torch.infer.engine import live_engines

    # Engines an earlier test left cached in this process are not this
    # worker's: the metrics op reports every live engine of the process.
    before = {id(e) for e in live_engines()}
    stub = KafkaStubBroker(partitions=2)
    producer = KafkaWireBroker(f"127.0.0.1:{stub.port}")
    ws = worker.WorkerServer(0, 0, device="cpu", host="127.0.0.1")
    runner = threading.Thread(target=ws.serve_forever, daemon=True)
    runner.start()
    client = transport.WorkerClient(f"127.0.0.1:{ws.port}", token="")
    try:
        client.wait_ready(timeout=30)
        # No fault is injected here: a message timeout well above a loaded
        # box's hiccups keeps a slow tree from replaying into a duplicate.
        cfg = _dist_config(f"127.0.0.1:{stub.port}", timeout_s=30.0)
        client.control("submit", name="null", config=cfg.to_dict(),
                       placement={c: 0 for c in PLACEMENT},
                       peers={0: f"127.0.0.1:{ws.port}"}, builder="null")
        client.control("start_bolts")
        client.control("start_spouts")
        xs = np.random.RandomState(0).rand(5, 32, 32, 1).astype(np.float32)
        for x in xs:
            producer.produce("input", json.dumps({"instances": x[None].tolist()}).encode())
        deadline = time.time() + 60
        while time.time() < deadline and stub.topic_size("output") < len(xs):
            time.sleep(0.05)
        outs = _outputs(stub, "output")
        assert len(outs) == len(xs), (len(outs), client.control("metrics")["metrics"])
        preds = np.concatenate([decode_predictions(v).data for v in outs])
        want = JaxNullEngine(cfg.model.input_shape, cfg.model.num_classes).predict(xs)
        assert preds.shape == (len(xs), 10)
        np.testing.assert_allclose(preds, np.asarray(want), atol=1e-7)
        built = [e for e in client.control("metrics")["engines"] if e["id"] not in before]
        assert built == []  # no model engine was built
        client.control("kill")
    finally:
        try:
            client.probe("shutdown", timeout=30)
        finally:
            client.close()
            runner.join(timeout=10)
            producer.close()
            stub.close()


def test_default_device_needs_a_card():
    import torch

    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device is valid here")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        DistCluster(1)
    out = subprocess.run([sys.executable, "-m", "storm_tpu_torch.dist.worker", "--index", "0"],
                         capture_output=True, text=True, timeout=60, cwd=ROOT)
    assert out.returncode != 0 and "no CUDA device" in out.stderr
    assert "ready" not in out.stdout
