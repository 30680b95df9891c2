"""The port's metrics surface (``storm_tpu_torch/runtime/metrics.py``)
against storm_tpu's on the CPU, the behaviours of
``tests/test_metrics_export.py``: ``prometheus_text`` renders the same
registry contents byte for byte as storm_tpu's (counters, integer-valued
gauges kept gauges, histograms with the p90 and max lines, the trace-id
exemplar that tracks the latest sampled point and goes at ``reset``,
label escaping, several topologies, one ``# TYPE`` line a family);
``Histogram.reset`` and ``mean``; ``drop_windows``; the callback and
JSON-lines consumers receive periodic snapshots and the last one at
kill; a failing consumer kills nothing; an unknown metric name warns
once; the port's generated name registry is up to date.
"""

from __future__ import annotations

import asyncio
import json
import logging
import time

import pytest

import storm_tpu.runtime.metrics as jax_metrics
import storm_tpu_torch.runtime.metric_names as port_names
import storm_tpu_torch.runtime.metric_registry as port_registry
import storm_tpu_torch.runtime.metrics as port_metrics
from tests.test_torch_runtime import IMPLS, components

METRICS = {"storm_tpu": jax_metrics, "port": port_metrics}


def _fill(m, monkeypatch) -> dict:
    """The same registry contents through each package's API."""
    monkeypatch.setattr(time, "time", lambda: 1_700_000_000.123456)
    demo, other = m.MetricsRegistry(), m.MetricsRegistry()
    demo.counter("bolt", "executed").inc(5)
    demo.counter('we"ird\\c', "executed").inc(1)
    demo.gauge("bolt", "inbox_depth").set(3)
    demo.gauge("bolt", "execute_rate").set(3.5)
    demo.gauge("obs", "ring_inflight_lenet5").set(float("nan"))
    h = demo.histogram("sink", "e2e_latency_ms")
    for v in range(1, 101):
        h.observe(float(v))
    h.observe(12.0, trace_id="ab" * 16)
    h.observe(9.0)  # an unsampled point keeps the exemplar
    demo.histogram("bolt", "execute_ms").observe(3.0)
    demo.histogram("bolt", "decode_ms")  # empty
    other.counter("bolt", "executed").inc(2)
    other.histogram("sink", "e2e_latency_ms").observe(1.0, trace_id='q"\n')
    return {'topo"1\\x': demo, "b-other\n": other}


def test_prometheus_text_byte_for_byte(monkeypatch):
    texts = {name: m.prometheus_text(_fill(m, monkeypatch)) for name, m in METRICS.items()}
    assert texts["port"] == texts["storm_tpu"]
    text = texts["port"]
    assert 'storm_tpu_executed_total{topology="topo\\"1\\\\x",component="bolt"} 5' in text
    assert 'component="we\\"ird\\\\c"' in text and 'topology="b-other\\n"' in text
    assert 'storm_tpu_inbox_depth{topology="topo\\"1\\\\x",component="bolt"} 3.0' in text
    assert "inbox_depth_total" not in text
    count = next(line for line in text.splitlines()
                 if line.startswith('storm_tpu_e2e_latency_ms_count{topology="topo'))
    assert count.endswith(f' # {{trace_id="{"ab" * 16}"}} 12.0 1700000000.123')
    assert 'storm_tpu_e2e_latency_ms_max{topology="topo\\"1\\\\x",component="sink"} 100.0' \
        in text
    assert all("# {" not in line for line in text.splitlines() if "execute_ms" in line)
    assert text.count("# TYPE storm_tpu_executed_total counter") == 1
    assert "storm_tpu_ring_inflight_lenet5" in text and " NaN" in text


def test_exemplar_tracks_latest_and_reset(monkeypatch):
    out = {}
    for name, m in METRICS.items():
        reg = m.MetricsRegistry()
        h = reg.histogram("sink", "e2e_latency_ms")
        h.observe(5.0, trace_id="aa" * 16)
        h.observe(7.0, trace_id="bb" * 16)
        h.observe(9.0)
        first = m.prometheus_text({"demo": reg})
        mean = h.mean
        h.reset()
        out[name] = (first.count("aa" * 16), first.count("bb" * 16), mean,
                     m.prometheus_text({"demo": reg}), h.count, h.mean != h.mean,
                     h.window("k"), h.percentile(50) != h.percentile(50))
    assert out["port"] == out["storm_tpu"]
    assert out["port"][:3] == (0, 1, 7.0) and "# {" not in out["port"][3]


def test_drop_windows_alike():
    out = {}
    for name, m in METRICS.items():
        reg = m.MetricsRegistry()
        a, b = reg.histogram("x", "e2e_latency_ms"), reg.histogram("y", "execute_ms")
        a.window("cell")
        b.window("cell")
        b.window("other")
        out[name] = (reg.drop_windows("cell"), a.window_keys(), b.window_keys(),
                     reg.drop_windows("cell"))
    assert out["port"] == out["storm_tpu"] == (2, (), ("other",), 0)


def test_unknown_name_warns_once(caplog):
    port_metrics._unknown_warned.discard("ackd_typo")
    reg = port_metrics.MetricsRegistry()
    with caplog.at_level(logging.WARNING, logger="storm_tpu_torch.metrics"):
        reg.counter("c", "ackd_typo")
        reg.counter("d", "ackd_typo")
        reg.gauge("c", "inbox_depth")
        reg.histogram("c", "e2e_latency_ms_gold")  # a pattern's name
    warned = [r for r in caplog.records if r.name == "storm_tpu_torch.metrics"]
    assert len(warned) == 1 and "ackd_typo" in warned[0].getMessage()


def test_metric_registry_is_fresh():
    """``metric_names.py`` is what the generator makes of the package now:
    regenerate with ``python -m storm_tpu_torch.runtime.metric_registry``."""
    names, patterns = port_registry.collect()
    assert set(port_names.METRIC_NAMES) == names
    assert set(port_names.METRIC_PATTERNS) == patterns
    with open(port_registry.TARGET, encoding="utf-8") as fh:
        assert fh.read() == port_registry.render(names, patterns)
    for n in ("executor_restarts", "execute_rate", "ack_rate", "txn_commits",
              "txn_aborts", "txn_offsets_deferred", "checkpoints", "produce_ms",
              "capacity", "busy_frac"):
        assert port_names.is_known(n), n


def _topology(impl):
    c = components(impl)

    class Trickle(impl.runtime.Spout):
        async def next_tuple(self):
            await asyncio.sleep(0.005)
            await self.collector.emit(c.Values(["x"]), msg_id=time.monotonic())
            return True

    tb = impl.runtime.TopologyBuilder()
    tb.set_spout("spout", Trickle(), parallelism=1)
    tb.set_bolt("echo", c.PassBolt(), parallelism=2).shuffle_grouping("spout")
    return tb.build()


@pytest.fixture(params=sorted(IMPLS))
def impl(request):
    return IMPLS[request.param]


def test_callback_consumer_receives_snapshots(impl, run):
    m = METRICS[impl.name]

    async def go():
        got, closed = [], []

        class Closing(m.CallbackConsumer):
            def close(self):
                closed.append(True)

        cluster = impl.cluster.AsyncLocalCluster()
        rt = await cluster.submit("m", impl.config.Config(), _topology(impl))
        rt.add_metrics_consumer(Closing(lambda topo, ts, snap: got.append((topo, ts, snap))),
                                interval_s=0.1)
        await asyncio.sleep(0.35)
        periodic = len(got)
        await cluster.shutdown()
        return got, periodic, closed

    got, periodic, closed = run(go(), timeout=60)
    assert periodic >= 2 and len(got) == periodic + 1  # the last at kill
    topo, ts, snap = got[-1]
    assert topo == "m" and abs(ts - time.time()) < 60 and snap["echo"]["executed"] > 0
    assert closed == [True]


def test_jsonlines_consumer_writes_file(impl, run, tmp_path):
    m = METRICS[impl.name]
    path = str(tmp_path / "metrics.jsonl")

    async def go():
        cluster = impl.cluster.AsyncLocalCluster()
        rt = await cluster.submit("m", impl.config.Config(), _topology(impl))
        consumer = m.JsonLinesConsumer(path)
        rt.add_metrics_consumer(consumer, interval_s=0.1)
        await asyncio.sleep(0.35)
        await cluster.shutdown()
        return consumer._fh.closed

    assert run(go(), timeout=60)
    lines = [json.loads(line) for line in open(path)]
    assert len(lines) >= 3 and lines[-1]["topology"] == "m"
    assert "echo" in lines[-1]["metrics"]
    assert lines[-1]["metrics"]["echo"]["execute_ms"]["count"] > 0


def test_failing_consumer_does_not_kill_topology(impl, run):
    m = METRICS[impl.name]

    async def go():
        def boom(topo, ts, snap):
            raise RuntimeError("consumer bug")

        cluster = impl.cluster.AsyncLocalCluster()
        rt = await cluster.submit("m", impl.config.Config(), _topology(impl))
        rt.add_metrics_consumer(m.CallbackConsumer(boom), interval_s=0.05)
        await asyncio.sleep(0.3)
        executed = rt.metrics.snapshot()["echo"]["executed"]
        alive = rt.health()["components"]["echo"]["alive"]
        await cluster.shutdown()  # the last handle raises too: logged, not raised
        return executed, alive

    executed, alive = run(go(), timeout=60)
    assert executed > 0 and alive == 2


def test_base_consumer_is_abstract():
    for m in METRICS.values():
        with pytest.raises(NotImplementedError):
            m.MetricsConsumer().handle("t", 0.0, {})
        m.MetricsConsumer().close()
