"""The port's SLO planner (``storm_tpu_torch/plan/``) and autoscaler
(``runtime/autoscale.py``) against storm_tpu's on the CPU: ``solve`` and
the cost model on ``PROFILE_r11.json`` give storm_tpu's dicts, plans
validate onto the port's ``Config``, and the corrector and autoscaler
cases of ``tests/test_plan.py`` and ``tests/test_autoscale.py`` run on
both packages (an ``impl`` fixture) with the same decisions."""

from __future__ import annotations

import asyncio
import json
import os
from types import SimpleNamespace

import pytest

import storm_tpu.config as jax_config
import storm_tpu.plan as jax_plan
import storm_tpu.runtime as jax_runtime
import storm_tpu.runtime.autoscale as jax_autoscale
import storm_tpu.runtime.cluster as jax_cluster
import storm_tpu.runtime.metrics as jax_metrics
import storm_tpu_torch.config as port_config
import storm_tpu_torch.plan as port_plan
import storm_tpu_torch.runtime as port_runtime
import storm_tpu_torch.runtime.autoscale as port_autoscale
import storm_tpu_torch.runtime.cluster as port_cluster
import storm_tpu_torch.runtime.metrics as port_metrics

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

IMPLS = {
    "storm_tpu": SimpleNamespace(config=jax_config, plan=jax_plan, runtime=jax_runtime,
                                 autoscale=jax_autoscale, cluster=jax_cluster,
                                 metrics=jax_metrics),
    "port": SimpleNamespace(config=port_config, plan=port_plan, runtime=port_runtime,
                            autoscale=port_autoscale, cluster=port_cluster,
                            metrics=port_metrics),
}


@pytest.fixture(params=sorted(IMPLS))
def impl(request):
    return IMPLS[request.param]


@pytest.fixture(scope="module")
def snap():
    with open(os.path.join(ROOT, "PROFILE_r11.json")) as fh:
        return port_plan.unwrap_snapshot(json.load(fh))


# ---- the offline half -------------------------------------------------------------


@pytest.mark.parametrize("target,engine", [((600.0, 250.0), "lenet5"), ((600.0, 250.0), None),
                                           ((50000.0, 50.0), "resnet20"),
                                           ((100.0, 2000.0), None)])
def test_solve_equals_storm_tpu(snap, target, engine):
    got = port_plan.solve(snap, port_plan.Target(*target), engine=engine)
    want = jax_plan.solve(snap, jax_plan.Target(*target), engine=engine)
    assert got.to_dict() == want.to_dict()
    if got.feasible:
        assert got.plan.validate()
        cfg = port_config.Config()
        cfg.apply_overrides(got.plan.override_args())
        assert cfg.topology.inference_parallelism == got.plan.parallelism
        assert cfg.batch.bucket_for(1) == got.plan.bucket
        assert cfg.batch.max_wait_ms == pytest.approx(got.plan.deadline_ms)
    else:
        assert got.binding_stage in got.why


def test_cost_model_equals_storm_tpu(snap):
    pm, jm = port_plan.CostModel(snap), jax_plan.CostModel(snap)
    assert pm.coverage() == jm.coverage()
    t = (600.0, 1000.0)
    for bucket in (16, 40, 64, 128):
        for cont in (True, False):
            kw = dict(engine="lenet5", bucket=bucket, deadline_ms=25.0, parallelism=3,
                      continuous=cont)
            assert pm.evaluate(port_plan.Candidate(**kw), port_plan.Target(*t)) == \
                jm.evaluate(jax_plan.Candidate(**kw), jax_plan.Target(*t))
        assert pm.stage_ms("lenet5", bucket, "compute_ms") == \
            jm.stage_ms("lenet5", bucket, "compute_ms")


def test_cold_snapshot_refused_alike():
    cold = {"engines": {"m": {"buckets": {"64": {"stages": {"device_ms": {
        "count": 2, "mean": 5.0, "p95": 6.0}}}}, "compiles": {}}}}
    got = port_plan.solve(cold, port_plan.Target(100.0, 100.0), engine="m", min_samples=8)
    want = jax_plan.solve(cold, jax_plan.Target(100.0, 100.0), engine="m", min_samples=8)
    assert got.to_dict() == want.to_dict() and not got.feasible
    assert got.coverage["m"]["buckets"]["64"]["status"] == "cold"


def test_plan_config_equals_storm_tpu():
    import dataclasses

    assert dataclasses.asdict(port_config.PlanConfig()) == \
        dataclasses.asdict(jax_config.PlanConfig())
    with pytest.raises(ValueError):
        port_config.PlanConfig(headroom=0.0)
    assert port_autoscale.ACCEL_MAX_PARALLELISM == jax_autoscale.ACCEL_MAX_PARALLELISM == 3
    assert port_autoscale.CPU_MAX_PARALLELISM == jax_autoscale.CPU_MAX_PARALLELISM


# ---- the corrector ----------------------------------------------------------------


class FlightLog:
    def __init__(self):
        self.events = []

    def event(self, name, **kw):
        self.events.append((name, kw))


class Rig:
    """A runtime for the corrector: a parallelism ledger, a rebalance
    recorder, a real metrics registry and a flight capture."""

    def __init__(self, impl, par=None):
        self.par = dict(par or {"inference-bolt": 1, "resize-bolt": 1})
        self.calls = []
        self.metrics = impl.metrics.MetricsRegistry()
        self.flight = FlightLog()

    def parallelism_of(self, c):
        return self.par.get(c, 1)

    async def rebalance(self, c, n):
        self.calls.append((c, n))
        self.par[c] = n


def _step(c):
    return asyncio.run(c.step())


def _mk(impl, rig, leader="resize-bolt", tripped=True, **cfg):
    attributor = SimpleNamespace(last_verdict={
        "leader": leader, "ranked": [{"component": leader, "score": 0.93}]})
    burn = SimpleNamespace(tripped=tripped)
    return impl.plan.PlanCorrector(rig, impl.config.PlanConfig(enabled=True, **cfg),
                                   attributor=attributor, burn=burn), burn


def test_corrector_moves_only_the_named_limiter(impl):
    rig = Rig(impl)
    c, _ = _mk(impl, rig, hot_steps=2, hold_steps=0)
    assert _step(c) is None
    assert _step(c) == ("resize-bolt", 2)
    assert rig.calls == [("resize-bolt", 2)] and rig.par["inference-bolt"] == 1
    assert [(e, kw["action"]) for e, kw in rig.flight.events] == [("plan_correction", "up")]
    assert rig.metrics.counter("plan", "plan_corrections").value == 1


def test_corrector_holds_then_pins_at_cap(impl):
    rig = Rig(impl)
    c, _ = _mk(impl, rig, hot_steps=2, hold_steps=3)
    steps = [_step(c) for _ in range(7)]
    assert steps == [None, ("resize-bolt", 2), None, None, None, None, ("resize-bolt", 3)]
    rig = Rig(impl, par={"inference-bolt": impl.autoscale.ACCEL_MAX_PARALLELISM})
    c, _ = _mk(impl, rig, leader="inference-bolt", hot_steps=1, hold_steps=0)
    assert _step(c) is None and rig.calls == []
    assert [kw["action"] for _, kw in rig.flight.events] == ["pinned"]
    assert c.cap_for("resize-bolt") == impl.autoscale.CPU_MAX_PARALLELISM
    assert _mk(impl, Rig(impl), max_parallelism=2)[0].cap_for("resize-bolt") == 2


def test_corrector_reverts_after_calm_and_disabled_is_inert(impl):
    rig = Rig(impl)
    c, burn = _mk(impl, rig, hot_steps=1, hold_steps=0, calm_steps=2)
    assert _step(c) == ("resize-bolt", 2)
    burn.tripped = False
    assert [_step(c) for _ in range(4)] == [None, ("resize-bolt", 1), None, None]
    assert c.snapshot()["outstanding"] == {}
    rig = Rig(impl)
    c, _ = _mk(impl, rig, correct=False, hot_steps=1)
    assert not c.enabled and _step(c) is None and rig.calls == []
    assert rig.metrics.gauge("plan", "plan_active").value == 0


# ---- the autoscaler ---------------------------------------------------------------


def _runtime_of(impl):
    rt_mod = impl.runtime

    class Idle(rt_mod.Bolt):
        async def execute(self, t):
            self.collector.ack(t)

    class Quiet(rt_mod.Spout):
        async def next_tuple(self):
            return False

    async def mk():
        cluster = impl.cluster.AsyncLocalCluster()
        tb = rt_mod.TopologyBuilder()
        tb.set_spout("s", Quiet(), 1)
        tb.set_bolt("inference-bolt", Idle(), 2).shuffle_grouping("s")
        tb.set_bolt("kafka-bolt", Idle(), 1).shuffle_grouping("inference-bolt")
        rt = await cluster.submit("t", impl.config.Config(), tb.build())
        return cluster, rt

    return mk


def _scale(run, impl, policy, latency_ms, steps, attach=None):
    """``steps`` autoscaler steps over a topology whose sink saw
    ``latency_ms``: the step results, the final parallelism and the
    ``autoscale_decision`` directions."""
    async def go():
        cluster, rt = await _runtime_of(impl)()
        scaler = impl.autoscale.Autoscaler(rt, impl.autoscale.AutoscalePolicy(**policy))
        if attach:
            attach(scaler)
        hist = rt.metrics.histogram("kafka-bolt", "e2e_latency_ms")
        for _ in range(50):
            hist.observe(latency_ms)
        out = [await scaler.step() for _ in range(steps)]
        par = rt.parallelism_of("inference-bolt")
        kinds = [e.get("direction") for e in rt.flight.tail(50)
                 if e.get("kind") == "autoscale_decision"]
        await cluster.shutdown()
        return out, par, kinds, scaler.decisions

    return run(go(), timeout=30)


def test_default_cap_resolves_by_component_kind(impl):
    P = impl.autoscale.AutoscalePolicy
    assert P().max_parallelism == impl.autoscale.ACCEL_MAX_PARALLELISM
    assert P(component="mnist-inference").max_parallelism == 3
    assert P(component="parser-bolt").max_parallelism == 16
    assert P(component="inference-bolt", max_parallelism=8).max_parallelism == 8


@pytest.mark.parametrize("case", ["up", "down", "bounds"])
def test_autoscaler_cases_agree(run, case):
    policy, latency, steps = {
        "up": (dict(high_ms=100, max_parallelism=4), 500.0, 2),
        "down": (dict(low_ms=50, min_parallelism=1, cooldown=2), 5.0, 2),
        "bounds": (dict(high_ms=10, max_parallelism=2, min_parallelism=2), 500.0, 4),
    }[case]
    got = _scale(run, IMPLS["port"], policy, latency, steps)
    assert got == _scale(run, IMPLS["storm_tpu"], policy, latency, steps)
    assert got[:2] == {"up": ([None, 3], 3), "down": ([None, 1], 1),
                       "bounds": ([None] * 4, 2)}[case]


def test_autoscaler_defers_to_corrector_and_shedder_alike(run):
    def corrector(s):
        s.corrector = SimpleNamespace(enabled=True)

    def shedder(s):
        s.shedder = SimpleNamespace(level=0)

    pol = dict(high_ms=100, max_parallelism=4)
    for attach, want in ((corrector, ([None, None], 2, ["defer_plan"])),
                         (shedder, ([None, None, 3], 3, ["defer", "up"]))):
        got = _scale(run, IMPLS["port"], pol, 500.0, len(want[0]), attach)
        assert got == _scale(run, IMPLS["storm_tpu"], pol, 500.0, len(want[0]), attach)
        assert got[:3] == want


def test_autoscaler_scales_the_named_bottleneck_alike(run):
    """The attributor names the policy component at capacity: a hot
    signal even at a calm p50, recorded with the decision."""
    def attach(s):
        s.bottleneck = SimpleNamespace(
            cfg=SimpleNamespace(capacity_hot=0.8),
            last_verdict={"leader": "inference-bolt",
                          "ranked": [{"component": "inference-bolt", "capacity": 0.95}]})

    pol = dict(high_ms=1000, max_parallelism=4)
    got = _scale(run, IMPLS["port"], pol, 5.0, 2, attach)
    assert got == _scale(run, IMPLS["storm_tpu"], pol, 5.0, 2, attach)
    assert got[:3] == ([None, 3], 3, ["up"]) and got[3] == [("up", 2, 3)]


def test_observatory_steps_the_corrector(run):
    """``obs.corrector`` is stepped by the Observatory loop after each step
    and appears in its snapshot (the /plan route serves it)."""
    from storm_tpu_torch.config import ObsConfig
    from storm_tpu_torch.obs import Observatory

    async def go():
        cluster, rt = await _runtime_of(IMPLS["port"])()
        obs = Observatory(rt, ObsConfig(enabled=True, interval_s=0.02))
        corr = port_plan.PlanCorrector(rt, port_config.PlanConfig(enabled=True),
                                       attributor=obs.bottleneck, burn=obs.burn)
        obs.corrector = corr
        obs.start()
        await asyncio.sleep(0.3)
        await obs.stop()
        snap = obs.snapshot()
        await cluster.shutdown()
        return snap, corr.snapshot()

    snap, corr = run(go(), timeout=30)
    assert snap["corrector"]["enabled"] is True and snap["corrector"]["corrections"] == []
    # calm steps counted: the loop stepped it
    assert corr["calm"] >= 3
