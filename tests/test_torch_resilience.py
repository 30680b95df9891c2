"""The port's resilience primitives (``storm_tpu_torch/resilience``) side by
side with storm_tpu's, on the CPU: the retry policy's backoff sequence
under one seeded ``random``, its attempts and outcome per status code
(the port's own ``StatusCode``/``RpcError`` against gRPC's), the circuit
breaker's transitions and the token bucket's waits under one fake clock,
the chaos injector's seeded decisions, and storm_tpu's gRPC codes mapped
to the port's by name."""

import asyncio
import random

import grpc
import pytest

import storm_tpu.resilience as jr
from storm_tpu.config import ChaosConfig as JaxChaosConfig
from storm_tpu.config import ResilienceConfig as JaxResilienceConfig
from storm_tpu_torch import resilience as pr
from storm_tpu_torch.config import ChaosConfig, Config, ResilienceConfig


class _GrpcError(grpc.RpcError):
    def __init__(self, code):
        self._code = code

    def code(self):
        return self._code


def _errors(name: str):
    """The same failure in both packages' clothes."""
    if name in ("ConnectionError", "OSError", "ValueError"):
        exc = {"ConnectionError": ConnectionError, "OSError": OSError,
               "ValueError": ValueError}[name]("boom")
        return exc, exc
    return _GrpcError(getattr(grpc.StatusCode, name)), pr.RpcError(pr.StatusCode[name], "x")


def test_status_codes_match_grpc_by_name():
    for code in grpc.StatusCode:
        mine = pr.StatusCode[code.name]
        assert mine.value == code.value[0]
    for attr in ("RETRYABLE_BROAD", "RETRYABLE_NARROW", "FATAL_CODES"):
        assert ({c.name for c in getattr(pr, attr)}
                == {c.name for c in getattr(jr, attr)}), attr


@pytest.mark.parametrize("seed", [0, 7, 12345])
def test_backoff_sequence_under_one_seeded_random(seed):
    mine = pr.RetryPolicy(attempts=9, base_s=0.05, cap_s=2.0, _rng=random.Random(seed))
    theirs = jr.RetryPolicy(attempts=9, base_s=0.05, cap_s=2.0, _rng=random.Random(seed))
    assert [mine.backoff(n) for n in range(10)] == [theirs.backoff(n) for n in range(10)]


@pytest.mark.parametrize("name", ["UNAVAILABLE", "DEADLINE_EXCEEDED", "ABORTED",
                                  "RESOURCE_EXHAUSTED", "UNAUTHENTICATED", "UNKNOWN",
                                  "INVALID_ARGUMENT", "ConnectionError", "OSError",
                                  "ValueError"])
def test_retry_classification_and_attempts(name):
    """Each package's policy, failing every attempt with the same code:
    the same number of attempts under the broad and the narrow sets, the
    same error raised, the same retry callbacks, and fatal-ness alike."""
    jexc, pexc = _errors(name)
    for codes_name in ("RETRYABLE_BROAD", "RETRYABLE_NARROW"):
        counts = []
        for pkg, exc in ((jr, jexc), (pr, pexc)):
            calls, retried = [], []

            def fn(timeout, exc=exc, calls=calls):
                calls.append(timeout)
                raise exc

            pol = pkg.RetryPolicy(attempts=4, base_s=1e-4, cap_s=1e-3, deadline_s=5.0,
                                  _rng=random.Random(1))
            with pytest.raises(type(exc)):
                pol.call_sync(fn, op_timeout=2.0, codes=getattr(pkg, codes_name),
                              on_retry=lambda a, e, r=retried: r.append(a))
            counts.append((len(calls), retried))
        assert counts[0] == counts[1], codes_name
    assert jr.is_fatal_rpc(jexc) == pr.is_fatal_rpc(pexc)
    assert jr.is_retryable(jexc) == pr.is_retryable(pexc)


def test_retry_succeeds_after_transient_failures_async():
    for pkg, exc in ((jr, _errors("UNAVAILABLE")[0]), (pr, _errors("UNAVAILABLE")[1])):
        left = [2]

        def fn(timeout, left=left, exc=exc):
            if left[0]:
                left[0] -= 1
                raise exc
            return "ok"

        pol = pkg.RetryPolicy(attempts=4, base_s=1e-4, cap_s=1e-3, _rng=random.Random(2))
        assert asyncio.run(pol.call_async(fn, op_timeout=1.0)) == "ok"
        assert left == [0]


class _Clock:
    def __init__(self):
        self.t = 100.0

    def __call__(self):
        return self.t


def test_circuit_transitions_under_a_fake_clock():
    script = ["f", "f", "allow", "f", "allow", "tick:1", "allow", "tick:2.5", "allow",
              "allow", "f", "allow", "tick:3", "allow", "s", "allow", "f", "f", "f", "allow"]
    trails = []
    for pkg in (jr, pr):
        clock, events = _Clock(), []
        cb = pkg.CircuitBreaker(failures=3, reset_s=3.0, clock=clock,
                                on_open=lambda e=events: e.append("open"),
                                on_close=lambda e=events: e.append("close"))
        trail = []
        for step in script:
            if step == "f":
                cb.record_failure()
            elif step == "s":
                cb.record_success()
            elif step.startswith("tick:"):
                clock.t += float(step[5:])
            else:
                trail.append(cb.allow())
            trail.append((cb.state, round(cb.wait_s(), 6)))
        trails.append((trail, events, cb.opens))
    assert trails[0] == trails[1]
    assert trails[1][2] == 3


def test_token_bucket_under_a_fake_clock():
    waits = []
    for pkg in (jr, pr):
        clock = _Clock()
        tb = pkg.TokenBucket(rate=10.0, burst=5.0, clock=clock)
        seq = []
        for n, dt in [(3, 0), (3, 0), (1, 0.05), (4, 0.5), (0.5, 2.0), (8, 0)]:
            clock.t += dt
            seq.append(round(tb.take(n), 9))
        tb.set_rate(40.0)
        clock.t += 0.1
        seq.append(round(tb.take(2), 9))
        waits.append((seq, tb.waits, round(tb.waited_s, 9)))
    assert waits[0] == waits[1]
    assert waits[1][1] > 0


def test_chaos_injector_decides_alike_under_one_seed():
    outs = []
    for pkg in (jr, pr):
        inj = pkg.ChaosInjector(seed=5)
        inj.configure(wire_drop_pct=0.3, corrupt_pct=0.25, wire_latency_ms=2.0,
                      wire_jitter_ms=3.0, corrupt_next=1)
        seq = []
        for i in range(40):
            seq.append((inj.should_drop(), inj.corrupt(bytes(range(i % 7 + 1, 30))),
                        round(inj.wire_delay_s(), 9)))
        inj.configure(engine_hang_ms=50, engine_hang_next=2)
        seq.append([inj.engine_hang_s() for _ in range(3)])
        snap = inj.snapshot()
        outs.append((seq, snap))
    assert outs[0] == outs[1]
    with pytest.raises(ValueError):
        pr.get_injector().configure(no_such_knob=1)


def test_install_chaos_and_config_sections_match():
    assert ResilienceConfig().__dict__ == JaxResilienceConfig().__dict__
    # storm_tpu's drill timers ride the dist-run command, ported with it:
    # a config naming one loads and is validated as storm_tpu's is.
    drills = ("kill_worker_s", "kill_controller_s")
    assert ChaosConfig().__dict__ == JaxChaosConfig().__dict__
    for k in drills:
        assert getattr(Config.from_dict({"chaos": {k: 1.5}}).chaos, k) == 1.5
        with pytest.raises(ValueError, match=k):
            Config.from_dict({"chaos": {k: -1.0}})
    assert pr.install_chaos(ChaosConfig()) is None
    inj = pr.install_chaos(ChaosConfig(enabled=True, corrupt_pct=0.5, wire_drop_pct=0.1))
    try:
        assert inj is pr.get_injector()
        assert inj.snapshot()["corrupt_pct"] == 0.5
    finally:
        inj.configure(corrupt_pct=0.0, wire_drop_pct=0.0)
    for bad in (dict(retry_attempts=0), dict(circuit_reset_s=-1)):
        with pytest.raises(ValueError):
            ResilienceConfig(**bad)
    with pytest.raises(ValueError):
        ChaosConfig(corrupt_pct=2.0)
    cfg = Config.from_dict({"resilience": {"retry_attempts": 7}, "chaos": {"seed": 3}})
    assert (cfg.resilience.retry_attempts, cfg.chaos.seed) == (7, 3)
    assert isinstance(pr.ChaosDrop("x"), ConnectionError) and pr.is_retryable(pr.ChaosDrop("x"))
