"""The port's UI over the dist runtime (``storm_tpu_torch/dist/ui.py``)
against storm_tpu's: ``DistMetrics``, the Prometheus facade over the
controller's merged snapshot, renders storm_tpu's text for the same
snapshot; ``DistRuntimeView`` merges per-worker health as storm_tpu's
does; a worker's ``metrics`` op reports beside a decode engine (it
failed on one, which broke the dist UI's routes after a decode mesh); and
one status-and-admin run over two CPU worker processes: the
status routes, merged metrics, a rebalance, deactivate/activate, the
worker log tail, the merged utilization, copy and plan views, and a
``profile`` capture routed to a worker."""

from __future__ import annotations

import asyncio
import json
import os
import time
import urllib.error
import urllib.request

import numpy as np
import pytest

import storm_tpu.dist.ui as jax_dist_ui
import storm_tpu.runtime.metrics as jax_metrics
import storm_tpu_torch.dist.ui as port_dist_ui
import storm_tpu_torch.runtime.metrics as port_metrics
from storm_tpu_torch.config import BatchConfig, Config, ModelConfig, OffsetsConfig
from storm_tpu_torch.connectors.kafka_protocol import KafkaWireBroker
from storm_tpu_torch.connectors.kafka_stub import KafkaStubBroker
from storm_tpu_torch.dist import DistCluster

WORKER_ENV = {"OMP_NUM_THREADS": "1", "MKL_NUM_THREADS": "1"}

SNAPSHOTS = {
    "mixed": {"infer": {"instances_inferred": 42, "queue_fill": 0.5, "healthy": True,
                        "device_ms": {"count": 3, "sum": 27.0, "mean": 9.0, "p50": 8.0,
                                      "p90": 11.0, "p95": 12.0, "p99": 12.0, "max": 12.5}},
              "sink": {"delivered": 7, "e2e_latency_ms": {"count": 0, "sum": 0.0,
                                                          "mean": None}}},
    "no_sum": {"w": {"h": {"count": 4, "mean": 2.5, "p50": 2.0}}},
    "escapes": {'odd"comp\\x': {"n": 1, "g": float("nan")}},
}


class FakeDist:
    def __init__(self, snap, health=None, placement=None):
        self._snap = snap
        self._health = health or {}
        self._placement = placement or {}
        self.activated = True
        self.calls = 0

    def metrics(self):
        self.calls += 1
        return self._snap

    def health(self):
        return self._health


@pytest.mark.parametrize("case", sorted(SNAPSHOTS))
def test_dist_metrics_prometheus_text_equals_storm_tpu(case):
    snap = SNAPSHOTS[case]
    got_dist, want_dist = FakeDist(snap), FakeDist(snap)
    got = port_metrics.prometheus_text({"dist-topo": port_dist_ui.DistMetrics(got_dist)})
    want = jax_metrics.prometheus_text({"dist-topo": jax_dist_ui.DistMetrics(want_dist)})
    assert got == want
    # one worker fan-out a scrape, however many families it reads
    assert got_dist.calls == want_dist.calls == 1
    if case == "mixed":
        assert ('storm_tpu_instances_inferred_total{topology="dist-topo",component="infer"} 42'
                in got)
        assert 'storm_tpu_device_ms_sum{topology="dist-topo",component="infer"} 27.0' in got


def test_runtime_view_merges_health_like_storm_tpu():
    health = {0: {"inflight_trees": 2, "components": {
                  "kafka-spout": {"tasks": 1, "alive": 1}, "inference-bolt": {"tasks": 0}}},
              1: {"inflight_trees": 3, "components": {
                  "inference-bolt": {"tasks": 4, "alive": 4}}}}
    placement = {"kafka-spout": 0, "inference-bolt": 1}
    got = port_dist_ui.DistRuntimeView(FakeDist({}, health, placement), "t")
    want = jax_dist_ui.DistRuntimeView(FakeDist({}, health, placement), "t")
    assert got.health() == want.health()
    assert got.health()["components"]["inference-bolt"]["tasks"] == 4
    assert got.health()["inflight_trees"] == 5 and got.is_active()
    cv = port_dist_ui.DistClusterView(FakeDist({}), "t")
    assert list(cv.runtimes) == ["t"] and cv.runtime("t").name == "t"


def test_metrics_op_reports_beside_a_decode_engine():
    """A worker that has hosted the decode tier keeps a decode engine among
    its live engines (an auxiliary one, without graphs): the ``metrics``
    op, which the dist UI's routes read through ``DistCluster.metrics``,
    reports it with no bucket and no tally instead of failing, and
    ``replay_kernels`` passes over it."""
    import gc

    from storm_tpu_torch.decode import engine as dec
    from storm_tpu_torch.dist import worker

    dec._reset_engines()
    gc.collect()
    eng = dec.shared_decode_engine(blocks=2, max_seq=8, device="cpu")
    try:
        rows = [r for r in worker._engine_report()["engines"] if r["id"] == id(eng)]
        assert rows == [{"model": "char_tiny", "id": id(eng), "buckets": [], "weights": None,
                         "dtype": None, "forwards": 0, "launch_tally": {}}]
        # of char_tiny's engines only: an engine another test left in the
        # process's cache with a bucket built on the CPU cannot be traced
        assert worker._replay_report("char_tiny") == []
    finally:
        dec._reset_engines()
        del eng
        gc.collect()


def _http(port, method, path, body=None, timeout=30):
    req = urllib.request.Request(
        f"http://127.0.0.1:{port}{path}", method=method,
        data=json.dumps(body).encode() if body is not None else None,
        headers={"Authorization": "Bearer dist-ui-tok"})
    try:
        with urllib.request.urlopen(req, timeout=timeout) as r:
            raw = r.read()
            status = r.status
    except urllib.error.HTTPError as e:
        raw, status = e.read(), e.code
    try:
        return status, json.loads(raw)
    except ValueError:
        return status, raw.decode()


def test_dist_ui_status_admin_and_profile_over_two_workers(run, tmp_path):
    stub = KafkaStubBroker(partitions=2)
    cluster = None
    producer = KafkaWireBroker(f"127.0.0.1:{stub.port}")
    try:
        cfg = Config()
        cfg.model = ModelConfig(name="lenet5", dtype="float32", num_classes=10,
                                input_shape=(28, 28, 1))
        cfg.batch = BatchConfig(max_batch=4, buckets=(4,), max_wait_ms=20)
        cfg.offsets = OffsetsConfig(policy="earliest", max_behind=None)
        cfg.broker.kind, cfg.broker.bootstrap = "kafka", f"127.0.0.1:{stub.port}"
        cfg.topology.spout_parallelism = 1
        cfg.topology.inference_parallelism = 2
        cfg.topology.sink_parallelism = 1
        cfg.control.auth_token = "dist-ui-tok"
        cluster = DistCluster(2, device="cpu", env=WORKER_ENV, worker_threads=1,
                              auth_token=cfg.control.resolve_token())
        cluster.submit("dist-ui", cfg, placement={"kafka-spout": 0, "kafka-bolt": 0,
                                                  "dlq-bolt": 0, "inference-bolt": 1})
        rng = np.random.RandomState(0)
        for _ in range(6):
            producer.produce("input", json.dumps(
                {"instances": rng.rand(1, 28, 28, 1).tolist()}).encode())

        async def with_ui():
            ui = await port_dist_ui.start_dist_ui(cluster, "dist-ui", port=0,
                                                  auth_token="dist-ui-tok")
            loop = asyncio.get_running_loop()

            def get(method, path, body=None):
                return loop.run_in_executor(None, _http, ui.port, method, path, body)

            out = {}
            try:
                st, summary = await get("GET", "/api/v1/cluster/summary")
                out["summary"] = (st, summary["topologies"])
                deadline = loop.time() + 60
                while loop.time() < deadline:
                    st, met = await get("GET", "/api/v1/topology/dist-ui/metrics")
                    if met.get("inference-bolt", {}).get("instances_inferred", 0) >= 6:
                        break
                    await asyncio.sleep(0.2)
                out["inferred"] = met["inference-bolt"]["instances_inferred"]
                st, comp = await get("GET", "/api/v1/topology/dist-ui/component/inference-bolt")
                out["executed"] = (st, sum(r["executed"] for r in comp["executors"]))
                st, _ = await get("POST", "/api/v1/topology/dist-ui/rebalance",
                                  {"component": "inference-bolt", "parallelism": 3})
                st2, topo = await get("GET", "/api/v1/topology/dist-ui")
                out["rebalance"] = (st, st2, topo["components"]["inference-bolt"]["tasks"])
                st, r = await get("POST", "/api/v1/topology/dist-ui/deactivate")
                st2, topo = await get("GET", "/api/v1/topology/dist-ui")
                st3, _ = await get("POST", "/api/v1/topology/dist-ui/activate")
                out["lifecycle"] = (st, r["status"], topo["status"], st3)
                st, logs = await get("GET", "/api/v1/topology/dist-ui/logs?worker=0")
                st2, _ = await get("GET", "/api/v1/topology/dist-ui/logs?worker=99")
                out["logs"] = (st, isinstance(logs["log"], str), st2)
                for route in ("bottleneck", "copies", "plan", "graph"):
                    st, body = await get("GET", f"/api/v1/topology/dist-ui/{route}")
                    out[route] = (st, sorted(body))
                st, text = await get("GET", "/metrics")
                out["prometheus"] = (st, "storm_tpu_instances_inferred_total{topology="
                                     '"dist-ui",component="inference-bolt"}' in text)
                d = str(tmp_path / "trace")
                st, r = await get("POST", "/api/v1/topology/dist-ui/profile",
                                  {"log_dir": d, "seconds": 0.3, "worker": 1})
                st2, _ = await get("POST", "/api/v1/topology/dist-ui/profile",
                                   {"log_dir": d, "seconds": 0.3, "worker": 99})
                deadline = time.time() + 30
                while time.time() < deadline and not os.path.exists(
                        os.path.join(d, "trace.json")):
                    await asyncio.sleep(0.1)
                out["profile"] = (st, r.get("status"), r.get("worker"), st2,
                                  os.path.exists(os.path.join(d, "trace.json")))
            finally:
                await ui.stop()
            return out

        out = run(with_ui(), timeout=150)
    finally:
        if cluster is not None:
            cluster.shutdown()
        producer.close()
        stub.close()
    assert out["summary"] == (200, ["dist-ui"]) and out["inferred"] >= 6
    assert out["executed"][0] == 200 and out["executed"][1] >= 6
    assert out["rebalance"] == (200, 200, 3)
    assert out["lifecycle"] == (200, "INACTIVE", "INACTIVE", 200)
    assert out["logs"] == (200, True, 404)
    assert out["bottleneck"] == (200, ["bottleneck", "topology", "utilization", "workers"])
    assert out["copies"] == (200, ["copies", "topology", "workers"])
    assert out["plan"] == (200, ["coverage", "note", "topology", "utilization", "workers"])
    assert out["graph"][0] == 404  # the controller holds no topology object
    assert out["prometheus"] == (200, True)
    assert out["profile"] == (200, "capturing", 1, 404, True)
