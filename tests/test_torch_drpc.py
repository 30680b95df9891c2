"""The port's DRPC (``storm_tpu_torch/runtime/drpc.py``) against
storm_tpu's on the CPU: the echo round trip, the timeout, the unknown
function and a failed tree behave alike; ``drpc_inference_topology``
serves lenet5 on its digits checkpoint within 1e-5 of storm_tpu call by
call, and a poison call fails with the schema error instead of timing
out, in both packages."""

from __future__ import annotations

import asyncio
import json
import os
from types import SimpleNamespace

import numpy as np
import pytest

import storm_tpu.config as jax_config
import storm_tpu.runtime as jax_runtime
import storm_tpu.runtime.cluster as jax_cluster
import storm_tpu.runtime.drpc as jax_drpc
import storm_tpu_torch.config as port_config
import storm_tpu_torch.runtime as port_runtime
import storm_tpu_torch.runtime.cluster as port_cluster
import storm_tpu_torch.runtime.drpc as port_drpc
from tests.test_torch_checkpoints import abstract_init  # noqa: F401  (fixture)
from tests.test_torch_copyledger import clear_engine_caches

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

IMPLS = {
    "storm_tpu": SimpleNamespace(name="storm_tpu", config=jax_config, runtime=jax_runtime,
                                 cluster=jax_cluster, drpc=jax_drpc),
    "port": SimpleNamespace(name="port", config=port_config, runtime=port_runtime,
                            cluster=port_cluster, drpc=port_drpc),
}


@pytest.fixture(params=sorted(IMPLS))
def impl(request):
    return IMPLS[request.param]


def _echo_topology(impl, server, behaviour="upper"):
    rt = impl.runtime

    class Work(rt.Bolt):
        def declare_output_fields(self):
            return {"default": ("message", "request_id")}

        async def execute(self, t):
            if behaviour == "boom":
                raise RuntimeError("boom")
            if behaviour == "upper":
                await self.collector.emit(rt.Values([t.get("message").upper(),
                                                     t.get("request_id")]), anchors=[t])
            self.collector.ack(t)

    tb = rt.TopologyBuilder()
    tb.set_spout("drpc-spout", impl.drpc.DRPCSpout(server, "upper"), parallelism=1)
    tb.set_bolt("work", Work(), parallelism=2).shuffle_grouping("drpc-spout")
    tb.set_bolt("return", impl.drpc.ReturnResultsBolt(server), parallelism=1) \
        .shuffle_grouping("work")
    return tb.build()


async def _with_topology(impl, topo, server, body, cfg=None):
    cluster = impl.cluster.AsyncLocalCluster()
    await cluster.submit("drpc", cfg or impl.config.Config(), topo)
    try:
        return await body(server)
    finally:
        await cluster.shutdown()


def test_roundtrip_and_unknown_function(run, impl):
    async def body(server):
        results = await asyncio.gather(*(server.execute("upper", f"hello-{i}")
                                         for i in range(8)))
        with pytest.raises(impl.drpc.DRPCUnknownFunction, match="registered: \\['upper'\\]"):
            await server.execute("unknown-fn", "x", timeout_s=5.0)
        return results, server.inflight, sorted(server._queues)

    server = impl.drpc.DRPCServer()
    results, inflight, queues = run(_with_topology(impl, _echo_topology(impl, server), server,
                                                   body), timeout=60)
    assert results == [f"HELLO-{i}" for i in range(8)] and inflight == 0 and queues == ["upper"]


def test_timeout_and_failed_tree(run, impl):
    """A topology that never answers times the call out; a bolt that raises
    fails it with DRPCError once its tree fails."""
    async def silent(server):
        with pytest.raises(impl.drpc.DRPCTimeout, match="gave no result in 0.3s"):
            await server.execute("upper", "x", timeout_s=0.3)
        return server.inflight

    server = impl.drpc.DRPCServer()
    assert run(_with_topology(impl, _echo_topology(impl, server, "swallow"), server, silent),
               timeout=60) == 0

    async def boom(server):
        with pytest.raises(impl.drpc.DRPCError, match="request failed in topology"):
            await server.execute("upper", "x", timeout_s=10.0)
        return server.inflight

    cfg = impl.config.Config()
    cfg.topology.message_timeout_s = 1.0
    server = impl.drpc.DRPCServer()
    assert run(_with_topology(impl, _echo_topology(impl, server, "boom"), server, boom, cfg),
               timeout=60) == 0


def test_fail_all_and_results_routing(impl):
    async def go():
        server = impl.drpc.DRPCServer()
        server.queue_for("f")
        calls = [asyncio.ensure_future(server.execute("f", str(i), timeout_s=5)) for i in range(3)]
        await asyncio.sleep(0.01)
        q = server.queue_for("f")
        rids = [q.get_nowait()[1] for _ in range(3)]
        server.result(rids[0], "zero")
        server.fail(rids[1], "bad input")
        server.fail_all("topology killed")
        out = await asyncio.gather(*calls, return_exceptions=True)
        return [o if isinstance(o, str) else (type(o).__name__, str(o)) for o in out]

    assert asyncio.run(go()) == ["zero", ("DRPCError", "bad input"),
                                 ("DRPCError", "topology killed")]


def _lenet5(impl, server):
    batch = impl.config.BatchConfig(max_batch=4, max_wait_ms=10, buckets=(4,))
    if impl.name == "storm_tpu":
        model = impl.config.ModelConfig(name="lenet5", dtype="float32", num_classes=10,
                                        input_shape=(32, 32, 1),
                                        checkpoint=os.path.join(ROOT, "checkpoints",
                                                                "lenet5_digits"))
        return impl.drpc.drpc_inference_topology(server, model, batch,
                                                 impl.config.ShardingConfig(data_parallel=1))
    model = impl.config.ModelConfig.from_checkpoint("checkpoints/lenet5_digits",
                                                    dtype="float32")
    return impl.drpc.drpc_inference_topology(server, model, batch, device="cpu")


def test_inference_topology_matches_storm_tpu(run, abstract_init):
    """Twelve concurrent calls on lenet5's digits checkpoint: each answer
    within 1e-5 of storm_tpu's answer to the same call; the poison call
    fails with the same schema error in both, not with a timeout."""
    from storm_tpu_torch.data import load_digits_nhwc

    xs = load_digits_nhwc((32, 32, 1))[2][:12]
    poison = '{"instances": [[1,2],[3]]}'

    async def serve(impl):
        server = impl.drpc.DRPCServer()
        topo = _lenet5(impl, server)

        async def body(server):
            outs = await asyncio.gather(*(
                server.execute("predict", json.dumps({"instances": x[None].tolist()}),
                               timeout_s=60) for x in xs))
            with pytest.raises(impl.drpc.DRPCError) as ei:
                await server.execute("predict", poison, timeout_s=60)
            return np.array([json.loads(o)["predictions"][0] for o in outs]), str(ei.value)

        return await _with_topology(impl, topo, server, body)

    got = {}
    for name, impl in IMPLS.items():
        clear_engine_caches()
        got[name] = run(serve(impl), timeout=120)
    clear_engine_caches()
    (port, port_err), (ref, ref_err) = got["port"], got["storm_tpu"]
    assert port.shape == ref.shape == (12, 10)
    np.testing.assert_allclose(port, ref, rtol=0, atol=1e-5)
    assert (port.argmax(1) == ref.argmax(1)).all()
    assert port_err == ref_err and "timeout" not in port_err.lower() and port_err


def test_inference_topology_wiring():
    """The port's wiring: spout -> InferenceBolt (request ids passed
    through) -> return bolts on the default and dead-letter streams, and
    the bolt on the caller's device."""
    server = port_drpc.DRPCServer()
    topo = port_drpc.drpc_inference_topology(server, port_config.ModelConfig(name="lenet5"),
                                             device="cpu", infer_parallelism=3)
    specs = topo.specs
    assert list(specs) == ["drpc-spout", "inference-bolt", "drpc-return", "drpc-error"]
    bolt = specs["inference-bolt"].obj
    assert bolt.device == "cpu" and bolt.passthrough == ("request_id",)
    assert specs["inference-bolt"].parallelism == 3
    assert [(s.source, s.stream) for s in specs["drpc-error"].inputs] == \
        [("inference-bolt", "dead_letter")]
    assert specs["drpc-spout"].obj.clone().server is server
