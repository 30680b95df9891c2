"""The port's Storm UI HTTP API (``storm_tpu_torch/runtime/ui.py``) against
storm_tpu's on the CPU: twin runtimes, one per package, the same request
to each, the same status code and the same JSON keys, for every route
``tests/test_ui.py`` covers, the bearer token, malformed requests, remote
submit and DRPC over HTTP."""

from __future__ import annotations

import asyncio
import json
from types import SimpleNamespace

import numpy as np
import pytest

import storm_tpu.config as jax_config
import storm_tpu.connectors as jax_connectors
import storm_tpu.infer as jax_infer
import storm_tpu.runtime as jax_runtime
import storm_tpu.runtime.cluster as jax_cluster
import storm_tpu.runtime.drpc as jax_drpc
import storm_tpu.runtime.ui as jax_ui
import storm_tpu_torch.config as port_config
import storm_tpu_torch.connectors as port_connectors
import storm_tpu_torch.infer as port_infer
import storm_tpu_torch.runtime as port_runtime
import storm_tpu_torch.runtime.cluster as port_cluster
import storm_tpu_torch.runtime.drpc as port_drpc
import storm_tpu_torch.runtime.ui as port_ui
from tests.test_torch_drpc import _echo_topology

IMPLS = {
    "storm_tpu": SimpleNamespace(name="storm_tpu", config=jax_config, runtime=jax_runtime,
                                 cluster=jax_cluster, ui=jax_ui, drpc=jax_drpc,
                                 connectors=jax_connectors, infer=jax_infer, pkg="storm_tpu",
                                 bolt_kw={}),
    "port": SimpleNamespace(name="port", config=port_config, runtime=port_runtime,
                            cluster=port_cluster, ui=port_ui, drpc=port_drpc,
                            connectors=port_connectors, infer=port_infer,
                            pkg="storm_tpu_torch", bolt_kw={"device": "cpu"}),
}


async def _raw(port, data: bytes):
    reader, writer = await asyncio.open_connection("127.0.0.1", port)
    writer.write(data)
    await writer.drain()
    raw = await reader.read()
    writer.close()
    head, _, body = raw.partition(b"\r\n\r\n")
    return int(head.split()[1]), body


async def _http(port, method, path, body=None, headers=None):
    payload = json.dumps(body).encode() if body is not None else b""
    extra = "".join(f"{k}: {v}\r\n" for k, v in (headers or {}).items())
    st, raw = await _raw(port, (
        f"{method} {path} HTTP/1.1\r\nHost: localhost\r\n{extra}"
        f"Content-Length: {len(payload)}\r\nConnection: close\r\n\r\n").encode() + payload)
    try:
        return st, json.loads(raw)
    except ValueError:
        return st, raw.decode()


def _shape(st, out):
    """What must agree between the packages: the status and the keys."""
    return st, sorted(out) if isinstance(out, dict) else type(out).__name__


def _components(impl):
    rt = impl.runtime

    class Trickle(rt.Spout):
        def open(self, context, collector):
            super().open(context, collector)
            self.n = 0

        async def next_tuple(self):
            await asyncio.sleep(0.01)
            await self.collector.emit(rt.Values([self.n]), msg_id=self.n)
            self.n += 1
            return True

        def ack(self, msg_id):
            pass

        def fail(self, msg_id):
            pass

    class Echo(rt.Bolt):
        async def execute(self, t):
            await self.collector.emit(rt.Values([t.get("message")]), anchors=[t])
            self.collector.ack(t)

    return Trickle, Echo


async def _with_ui(impl, body, token="", topo=None, name="demo", ui_kw=None):
    Trickle, Echo = _components(impl)
    if topo is None:
        tb = impl.runtime.TopologyBuilder()
        tb.set_spout("spout", Trickle(), parallelism=1)
        tb.set_bolt("echo", Echo(), parallelism=2).shuffle_grouping("spout")
        topo = tb.build()
    cluster = impl.cluster.AsyncLocalCluster()
    await cluster.submit(name, impl.config.Config(), topo)
    ui = await impl.ui.UIServer(cluster, port=0, auth_token=token, **(ui_kw or {})).start()
    try:
        return await body(ui, cluster)
    finally:
        await ui.stop()
        await cluster.shutdown()


def _twin(run, body, timeout=90, **kw):
    got = {n: run(_with_ui(impl, lambda ui, c, impl=impl: body(impl, ui, c), **kw),
                  timeout=timeout)
           for n, impl in IMPLS.items()}
    assert got["port"] == got["storm_tpu"], got
    return got["port"]


READS = ["/healthz", "/api/v1/cluster/summary", "/api/v1/topology/summary",
         "/api/v1/topology/demo", "/api/v1/topology/demo/metrics",
         "/api/v1/topology/demo/errors", "/api/v1/topology/demo/graph",
         "/api/v1/topology/demo/logs", "/api/v1/topology/demo/traces?n=5",
         "/api/v1/topology/demo/flight", "/api/v1/topology/demo/traces?n=0",
         "/api/v1/topology/demo/qos", "/api/v1/topology/demo/cascade",
         "/api/v1/topology/demo/profile", "/api/v1/topology/demo/bottleneck",
         "/api/v1/topology/demo/copies", "/api/v1/topology/demo/plan",
         "/api/v1/topology/demo/plan?rate=x", "/api/v1/topology/demo/scorecard",
         "/api/v1/topology/nope", "/api/v1/bogus"]


def test_read_routes_agree(run):
    async def body(impl, ui, cluster):
        await asyncio.sleep(0.3)
        out = [_shape(*await _http(ui.port, "GET", p)) for p in READS]
        st, text = await _http(ui.port, "GET", "/metrics")
        families = sorted({ln.split()[2] for ln in text.splitlines()
                           if ln.startswith("# TYPE") and "echo" not in ln})
        return out, st, "storm_tpu_executed_total" in text, bool(families)

    out, st, has_executed, has_families = _twin(run, body)
    assert dict(zip(READS, [s for s, _ in out])) == {
        **dict.fromkeys(READS, 200), "/api/v1/topology/demo/logs": 404,
        "/api/v1/topology/demo/traces?n=0": 400, "/api/v1/topology/demo/bottleneck": 404,
        "/api/v1/topology/demo/plan?rate=x": 400,
        "/api/v1/topology/demo/scorecard": 404, "/api/v1/topology/nope": 404,
        "/api/v1/bogus": 404}
    assert st == 200 and has_executed and has_families


def test_graph_and_component_rows_agree(run):
    async def body(impl, ui, cluster):
        await asyncio.sleep(0.3)
        st, g = await _http(ui.port, "GET", "/api/v1/topology/demo/graph")
        rows = []
        for cid in ("echo", "spout", "zzz"):
            s, out = await _http(ui.port, "GET", f"/api/v1/topology/demo/component/{cid}")
            rows.append((s, sorted(out["executors"][0]) if s == 200 else None,
                         len(out.get("executors", ()))))
        return st, g, rows

    st, g, rows = _twin(run, body)
    assert st == 200 and g["components"]["echo"] == {
        "type": "bolt", "parallelism": 2, "streams": {"default": ["message"]}}
    assert [(s, n) for s, _, n in rows] == [(200, 2), (200, 1), (404, 0)]


def test_admin_actions_agree(run):
    async def body(impl, ui, cluster):
        p = ui.port
        seq = [("POST", "/api/v1/topology/demo/deactivate", None),
               ("GET", "/api/v1/topology/demo", None),
               ("POST", "/api/v1/topology/demo/activate", None),
               ("GET", "/api/v1/topology/demo/activate", None),
               ("POST", "/api/v1/topology/demo/rebalance",
                {"component": "echo", "parallelism": 3}),
               ("POST", "/api/v1/topology/demo/rebalance", {"component": "echo"}),
               ("POST", "/api/v1/topology/demo/rebalance",
                {"component": "nope", "parallelism": 2}),
               ("POST", "/api/v1/topology/demo/rebalance",
                {"component": "echo", "parallelism": "x"}),
               ("POST", "/api/v1/topology/demo/drain", {"timeout_s": 5}),
               ("POST", "/api/v1/topology/demo/nothing", None),
               ("POST", "/api/v1/topology/demo/scorecard", None),
               ("POST", "/api/v1/topology/demo/kill", {"wait_secs": "x"}),
               ("POST", "/api/v1/topology/demo/kill", None)]
        out, par = [], None
        for method, path, b in seq:
            if path.endswith("/kill") and par is None:
                par = cluster.runtime("demo").parallelism_of("echo")
            st, r = await _http(p, method, path, b)
            out.append((st, r.get("status"), r.get("parallelism"), r.get("drained")))
        await asyncio.sleep(0.2)
        st, _ = await _http(p, "POST", "/api/v1/topology/demo/kill")
        return out, par, st, "demo" in cluster.runtimes

    out, par, st2, alive = _twin(run, body)
    assert [o[0] for o in out] == [200, 200, 200, 405, 200, 400, 404, 400, 200, 404, 405,
                                   400, 200]
    assert out[1][1] == "INACTIVE" and out[8][3] is True and par == 3
    assert st2 in (200, 404) and not alive


def test_malformed_requests_agree(run):
    async def body(impl, ui, cluster):
        p = ui.port
        bad_json = b"this is { not json"
        return [
            (await _raw(p, b"NONSENSE\r\n\r\n"))[0],
            (await _http(p, "POST", "/api/v1/topology/demo/rebalance"))[0],
            (await _raw(p, b"POST /api/v1/topology/demo/rebalance HTTP/1.1\r\n"
                        b"Content-Length: %d\r\n\r\n%s" % (len(bad_json), bad_json)))[0],
            (await _raw(p, b"POST /api/v1/topology/demo/kill HTTP/1.1\r\n"
                        b"Content-Length: -1\r\n\r\n"))[0],
            (await _raw(p, b"POST /api/v1/topology/demo/kill HTTP/1.1\r\n"
                        b"Content-Length: 99999999999\r\n\r\n"))[0],
            (await _raw(p, b"POST /api/v1/topology/demo/kill HTTP/1.1\r\n"
                        b"Content-Length: 2\r\n\r\n[]"))[0],
        ]

    assert _twin(run, body) == [400, 400, 400, 400, 413, 400]


def test_bearer_token_on_mutating_routes_only(run):
    async def body(impl, ui, cluster):
        p = ui.port
        seq = [("GET", "/healthz", {}), ("GET", "/api/v1/topology/demo", {}),
               ("POST", "/api/v1/topology/demo/deactivate", {}),
               ("POST", "/api/v1/topology/demo/deactivate", {"Authorization": "Bearer no"}),
               ("POST", "/api/v1/topology/demo/deactivate", {"Authorization": "Basic tok"}),
               ("POST", "/api/v1/topology/submit", {}),
               ("GET", "/api/v1/topology/demo", {}),
               ("POST", "/api/v1/topology/demo/deactivate",
                {"Authorization": "Bearer s3cret-tok"}),
               ("GET", "/api/v1/topology/demo", {}),
               ("POST", "/api/v1/drpc/nothing", {})]
        out = []
        for method, path, h in seq:
            st, r = await _http(p, method, path, {"args": "x"}, headers=h)
            out.append((st, r.get("status") if isinstance(r, dict) else None))
        return out

    out = _twin(run, body, token="s3cret-tok")
    assert out == [(200, "ok"), (200, "ACTIVE"), (401, None), (401, None), (401, None),
                   (401, None), (200, "ACTIVE"), (200, "INACTIVE"), (200, "INACTIVE"),
                   (404, None)]


def test_scorecard_route_serves_an_attached_matrix(run):
    async def body(impl, ui, cluster):
        st0, _ = await _http(ui.port, "GET", "/api/v1/topology/demo/scorecard")
        cluster.runtime("demo").scorecard = {"seed": 16, "cells": [{"ok": True}]}
        st1, r = await _http(ui.port, "GET", "/api/v1/topology/demo/scorecard")
        return st0, st1, r

    assert _twin(run, body) == (404, 200, {"topology": "demo", "seed": 16,
                                           "cells": [{"ok": True}]})


def test_seek_action_agrees(run):
    def topo(impl):
        broker = impl.connectors.MemoryBroker()
        for i in range(5):
            broker.produce("t", json.dumps({"i": i}))
        _, Echo = _components(impl)
        tb = impl.runtime.TopologyBuilder()
        tb.set_spout("s", impl.connectors.BrokerSpout(
            broker, "t", impl.config.OffsetsConfig(policy="earliest")), 1)
        tb.set_bolt("e", Echo(), 1).shuffle_grouping("s")
        return tb.build()

    async def body(ui):
        out = []
        for comp, pos in (("s", "earliest"), ("s", "-3"), ("s", "sideways"), ("zz", "latest"),
                          ("", "latest")):
            st, r = await _http(ui.port, "POST", "/api/v1/topology/sk/seek",
                                {"component": comp, "position": pos})
            out.append((st, r.get("position"), r.get("instances")))
        return out

    got = {n: run(_with_ui(impl, lambda ui, c: body(ui), topo=topo(impl), name="sk"),
                  timeout=60) for n, impl in IMPLS.items()}
    assert got["port"] == got["storm_tpu"] == [
        (200, "earliest", 1), (200, -3, 1), (400, None, None), (404, None, None),
        (400, None, None)]


def test_profile_capture_agrees(run, tmp_path):
    async def body(impl, ui, cluster):
        d = str(tmp_path / impl.name)
        out = [(await _http(ui.port, "POST", "/api/v1/topology/demo/profile",
                            {"log_dir": d, "seconds": 0.3}))[0],
               (await _http(ui.port, "POST", "/api/v1/topology/demo/profile",
                            {"log_dir": d, "seconds": 0.3}))[0]]
        await asyncio.wait_for(ui._profile_task, timeout=60)
        for b in ({"log_dir": "", "seconds": 1}, {"log_dir": d, "seconds": 301},
                  {"log_dir": d, "seconds": "x"}):
            out.append((await _http(ui.port, "POST", "/api/v1/topology/demo/profile", b))[0])
        return out

    assert _twin(run, body, timeout=120) == [200, 409, 400, 400, 400]
    import os

    assert os.path.exists(tmp_path / "port" / "trace.json")


def test_swap_model_action_agrees(run):
    def topo(impl):
        _, Echo = _components(impl)
        rt = impl.runtime

        class OneShot(rt.Spout):
            def open(self, context, collector):
                super().open(context, collector)
                self.sent = False

            async def next_tuple(self):
                if self.sent:
                    return False
                self.sent = True
                await self.collector.emit(rt.Values([json.dumps(
                    {"instances": np.zeros((1, 28, 28, 1)).tolist()})]), msg_id=1)
                return True

        tb = rt.TopologyBuilder()
        tb.set_spout("spout", OneShot(), 1)
        tb.set_bolt("infer", impl.infer.InferenceBolt(
            impl.config.ModelConfig(name="lenet5", input_shape=(28, 28, 1), num_classes=10,
                                    dtype="float32", seed=0),
            impl.config.BatchConfig(max_batch=4, max_wait_ms=5, buckets=(4,)),
            **impl.bolt_kw), 1).shuffle_grouping("spout")
        return tb.build()

    async def body(ui, cluster):
        out = []
        for b in ({"component": "infer", "model": {"seed": 7}},
                  {"component": "nope", "model": {"seed": 1}},
                  {"component": "infer", "model": {}},
                  {"component": "infer", "model": {"weights": "bogus"}},
                  {"component": "infer", "model": {"seed": 3}, "tasks": "x"},
                  {"component": "infer", "model": {"seed": 8}, "tasks": [0]}):
            st, r = await _http(ui.port, "POST", "/api/v1/topology/demo/swap_model", b)
            out.append((st, (r.get("model") or {}).get("seed"), r.get("tasks")))
        return out, cluster.runtime("demo").bolt_execs["infer"][0].bolt.model_cfg.seed

    got = {n: run(_with_ui(impl, body, topo=topo(impl)), timeout=120)
           for n, impl in IMPLS.items()}
    assert got["port"] == got["storm_tpu"] == (
        [(200, 7, None), (404, None, None), (400, None, None), (400, None, None),
         (400, None, None), (200, 8, [0])], 8)


def test_remote_submit_agrees(run):
    async def body(impl, ui, cluster):
        _, Echo = _components(impl)
        definition = {"spouts": [{"id": "s", "class": f"{impl.pkg}.connectors.BrokerSpout",
                                  "args": {"broker": "$broker", "topic": "in"}}],
                      "bolts": [{"id": "b", "class": f"{impl.pkg}.connectors.BrokerSink",
                                 "args": {"broker": "$broker", "topic": "out"},
                                 "groupings": [{"source": "s", "type": "shuffle"}]}]}
        evil = {"spouts": [{"id": "s", "class": "os.system", "args": {}}]}
        h = {"X-Storm-Tpu-Submit": "1"}
        out = []
        for b, hh in (({"name": "t2", "definition": definition}, {}),
                      ({"name": "t2", "definition": definition}, h),
                      ({"name": "t2", "definition": definition}, h),
                      ({"name": "t3", "definition": evil}, h),
                      ({"name": "t4"}, h)):
            st, r = await _http(ui.port, "POST", "/api/v1/topology/submit", b, headers=hh)
            out.append((st, r.get("status"), r.get("components")))
        st, _ = await _http(ui.port, "GET", "/api/v1/topology/submit")
        return out, st, sorted(cluster.runtimes)

    got = {n: run(_with_ui(impl, lambda ui, c, impl=impl: body(impl, ui, c),
                           ui_kw={"resources": {"broker": impl.connectors.MemoryBroker()}}),
                  timeout=60) for n, impl in IMPLS.items()}
    assert got["port"] == got["storm_tpu"] == (
        [(403, None, None), (200, "SUBMITTED", ["b", "s"]), (400, None, None),
         (400, None, None), (400, None, None)], 405, ["demo", "t2"])
    no_resources = _twin(run, lambda impl, ui, c: _http(
        ui.port, "POST", "/api/v1/topology/submit", {"name": "x", "definition": {}},
        headers={"X-Storm-Tpu-Submit": "1"}))
    assert no_resources[0] == 404


def test_drpc_over_http_agrees(run):
    async def body(impl, ui, server):
        out = []
        for method, path, b in (("POST", "/api/v1/drpc/upper", {"args": "hello"}),
                                ("POST", "/api/v1/drpc/unknown", {"args": "x"}),
                                ("POST", "/api/v1/drpc/upper", {"args": 3}),
                                ("POST", "/api/v1/drpc/upper?timeout_s=0", {"args": "x"}),
                                ("GET", "/api/v1/drpc/upper", None)):
            st, r = await _http(ui.port, method, path, b)
            out.append((st, r.get("result")))
        return out

    got = {}
    for n, impl in IMPLS.items():
        server = impl.drpc.DRPCServer()
        got[n] = run(_with_ui(impl, lambda ui, c, impl=impl, s=server: body(impl, ui, s),
                              topo=_echo_topology(impl, server), name="drpc",
                              ui_kw={"drpc": server}, token="tok"), timeout=60)
    assert got["port"] == got["storm_tpu"] == [
        (200, "HELLO"), (404, None), (400, None), (400, None), (405, None)]


@pytest.mark.parametrize("route", ["profile", "bottleneck", "copies", "plan"])
def test_observatory_routes_agree(run, route):
    """With an Observatory and a plan corrector attached, the cost-model
    routes answer with storm_tpu's keys."""
    async def body(impl, ui, cluster):
        from importlib import import_module

        obs_mod = import_module(f"{impl.pkg}.obs")
        plan_mod = import_module(f"{impl.pkg}.plan")
        rt = cluster.runtime("demo")
        obs = obs_mod.Observatory(rt, impl.config.ObsConfig(enabled=True), sink_components=())
        obs.corrector = plan_mod.PlanCorrector(rt, impl.config.PlanConfig(enabled=True),
                                               attributor=obs.bottleneck, burn=obs.burn)
        obs.step()
        await asyncio.sleep(0.2)
        obs.step()
        st, r = await _http(ui.port, "GET", f"/api/v1/topology/demo/{route}")
        st2, r2 = await _http(ui.port, "GET", f"/api/v1/topology/demo/{route}?rate=100&slo_ms=500")
        return _shape(st, r), _shape(st2, r2)

    (st, _), _ = _twin(run, body)
    assert st == 200
