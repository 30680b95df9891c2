"""The port's load generator (``storm_tpu_torch/loadgen``) against
storm_tpu's on the CPU, side by side: the trace file is a data format the
two packages share, so the same spec and seed give the same bytes, a file
saved by either loads in the other, and replay paces alike in virtual
time; the same bad specs are refused; the scorecard's gates and table are
storm_tpu's; the fleet matrix's pure helpers (targets, trace specs, the
warm-up payload interleave, the shed count, the scenarios' payloads) give
equal results; and the 12 cells of ``SCORECARD_r16.json`` regenerate with
their recorded event counts and ``stats()``. (Their recorded ``sha256``s
are stale in both packages: ``TraceSpec`` gained its ``decode_*`` fields
after that run, and the header hashes every field.)
"""

from __future__ import annotations

import itertools
import json
import os
from dataclasses import asdict
from types import SimpleNamespace

import pytest

import storm_tpu.loadgen as jax_loadgen
import storm_tpu.loadgen.fleet as jax_fleet
import storm_tpu.loadgen.scorecard as jax_scorecard
import storm_tpu_torch.loadgen as port_loadgen
import storm_tpu_torch.loadgen.fleet as port_fleet
import storm_tpu_torch.loadgen.scorecard as port_scorecard

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PATTERNS = ("heavy_tail", "diurnal", "flash_crowd", "decode_sessions")
TUPLE_FIELDS = ("lanes", "lane_mix", "gold_lane_mix", "shapes", "shape_mix")


def _spec(pkg, **kw):
    base = dict(seed=7, pattern="heavy_tail", duration_s=5.0, base_rate=300.0, tenants=200)
    base.update(kw)
    return pkg.TraceSpec(**base)


def _r16_cells() -> list:
    with open(os.path.join(ROOT, "SCORECARD_r16.json")) as f:
        return json.load(f)["cells"]


# ---- the trace file ------------------------------------------------------------


@pytest.mark.parametrize("pattern,seed", list(itertools.product(PATTERNS, (16, 23))))
def test_same_spec_and_seed_give_storm_tpus_bytes(pattern, seed):
    kw = dict(pattern=pattern, seed=seed, duration_s=8.0)
    got = port_loadgen.generate(_spec(port_loadgen, **kw))
    want = jax_loadgen.generate(_spec(jax_loadgen, **kw))
    assert got.to_bytes() == want.to_bytes()
    assert got.sha256() == want.sha256() and got.rows == want.rows and len(got) > 0
    assert list(got.events()) == [tuple(e) for e in want.events()]
    assert got.stats() == want.stats()


@pytest.mark.parametrize("writer", ["storm_tpu", "port"])
def test_a_file_saved_by_either_package_loads_in_the_other(writer, tmp_path):
    pkgs = {"storm_tpu": jax_loadgen, "port": port_loadgen}
    reader = pkgs["port" if writer == "storm_tpu" else "storm_tpu"]
    trace = pkgs[writer].generate(_spec(pkgs[writer], pattern="flash_crowd", seed=3))
    path = trace.save(str(tmp_path / "t.trace"))
    back = reader.load_trace(path)
    assert back.rows == trace.rows and asdict(back.spec) == asdict(trace.spec)
    assert back.to_bytes() == trace.to_bytes()
    with open(path, "wb") as fh:
        fh.write(b'{"other_trace": 1}\n')
    for pkg in pkgs.values():
        with pytest.raises(ValueError, match="not a storm_tpu trace"):
            pkg.load_trace(path)


def _virtual_replay(pkg, trace, **kw) -> list:
    now = [0.0]
    seen = []

    def sleep(dt):
        now[0] += dt

    n = pkg.replay(trace, lambda ev: seen.append((round(now[0], 9), tuple(ev))),
                   clock=lambda: now[0], sleep=sleep, **kw)
    assert n == len(seen)
    return seen


@pytest.mark.parametrize("speed", [1.0, 4.0])
def test_replay_paces_alike_on_a_virtual_clock(speed):
    traces = {p: p.generate(_spec(p, seed=11, duration_s=2.0)) for p in
              (jax_loadgen, port_loadgen)}
    got = _virtual_replay(port_loadgen, traces[port_loadgen], speed=speed)
    assert got == _virtual_replay(jax_loadgen, traces[jax_loadgen], speed=speed)
    assert len(got) == len(traces[port_loadgen])
    # each event is emitted once its scheduled time / speed has come
    assert all(t >= ev[0] / 1e6 / speed - 1e-9 for t, ev in got)
    assert got[-1][0] <= traces[port_loadgen].rows[-1][0] / 1e6 / speed + 0.05
    # stop() is polled between events: stop after 10
    cut = {}
    for pkg, tr in traces.items():
        polled = []
        cut[pkg] = _virtual_replay(pkg, tr, speed=speed,
                                   stop=lambda p=polled: p.append(1) or len(p) > 10)
    assert cut[port_loadgen] == cut[jax_loadgen] == got[:10]


BAD_SPECS = [
    # tests/test_loadgen.py's three refusals
    dict(pattern="square_wave"),
    dict(lane_mix=(0.5, 0.5, 0.5)),
    dict(flash_lane="vip"),
    # and validate()'s other branches
    dict(shape_mix=(1.0,)),
    dict(decode_burst_mult=0.5),
    dict(decode_burst_frac=1.0),
    dict(decode_period_s=0.0),
    dict(tenants=0),
]


@pytest.mark.parametrize("bad", BAD_SPECS, ids=[next(iter(b)) + str(i)
                                                 for i, b in enumerate(BAD_SPECS)])
def test_bad_specs_raise_what_storm_tpu_raises(bad):
    errors = []
    for pkg in (jax_loadgen, port_loadgen):
        with pytest.raises(Exception) as e:
            pkg.generate(_spec(pkg, **bad))
        errors.append((type(e.value), str(e.value)))
    assert errors[0] == errors[1] and errors[0][0] is ValueError


# ---- the scorecard -------------------------------------------------------------


def test_score_cell_matches_over_a_grid():
    scores = [dict(lane_p99_ms={"high": p99} if p99 is not None else {}, goodput_frac=g,
                   shed_frac=s, burn_peak=b, burn_tripped=t, tokens_per_s=tok,
                   ttft_p99_ms=ttft)
              for p99, g, s, b, t, tok, ttft in itertools.product(
                  (None, 40.0, 900.0), (None, 0.2, 0.9), (None, 0.0, 0.3), (None, 0.5, 3.0),
                  (False, True), (None, 50.0), (None, 700.0))]
    targets = [dict(), dict(p99_ms=400.0, min_goodput_frac=0.8, max_shed_frac=0.05,
                            forbid_burn_trip=True),
               dict(p99_ms=600.0, min_goodput_frac=0.75, max_shed_frac=0.10),
               dict(p99_ms=1200.0, min_goodput_frac=0.3, expect_shed=True,
                    expect_burn_trip=True, max_burn=2.0),
               dict(min_tokens_s=40.0, ttft_p99_ms=800.0, max_shed_frac=0.1,
                    protected_lane="normal")]
    n = 0
    for t in targets:
        tp, tj = port_scorecard.CellTargets(**t), jax_scorecard.CellTargets(**t)
        assert port_scorecard.targets_dict(tp) == jax_scorecard.targets_dict(tj)
        for s in scores:
            assert port_scorecard.score_cell(s, tp) == jax_scorecard.score_cell(s, tj)
            n += 1
    assert n == len(targets) * len(scores) > 1000


def test_render_table_gives_storm_tpus_text():
    with open(os.path.join(ROOT, "SCORECARD_r16.json")) as f:
        card = json.load(f)
    got = port_scorecard.render_table(card)
    assert got == jax_scorecard.render_table(card)
    assert got.endswith("12/12 cells pass · seed 16")
    partial = {"cells": card["cells"][:2] + [{"scenario": "decode", "scores": {}}],
               "in_progress": True}
    assert port_scorecard.render_table(partial) == jax_scorecard.render_table(partial)


# ---- the fleet matrix's helpers -------------------------------------------------


@pytest.mark.parametrize("pattern", PATTERNS)
def test_trace_spec_and_targets_match(pattern):
    for seed, hold, cap in ((16, 8.0, 1234.5), (23, 24.0, 207.0)):
        got = port_fleet._trace_spec(pattern, seed, hold, cap)
        assert asdict(got) == asdict(jax_fleet._trace_spec(pattern, seed, hold, cap))
        for slo in (400.0, 600.0):
            if pattern != "decode_sessions":
                assert asdict(port_fleet._targets_for(pattern, slo)) == \
                    asdict(jax_fleet._targets_for(pattern, slo))
            else:
                assert asdict(port_fleet._DecodeScenario().targets(pattern, slo, got)) == \
                    asdict(jax_fleet._DecodeScenario().targets(pattern, slo, got))


def test_mixed_payload_and_scenario_payloads_match():
    """The warm-up/probe interleave picks the same payload per index, over
    scenarios whose payload tables are byte-equal (the cascade's digits
    included: the port reads the same images from its own file)."""
    pairs = {"classify": (port_fleet._StandardScenario("classify", False),
                          jax_fleet._StandardScenario("classify", False)),
             "serve_path": (port_fleet._ServeScenario(), jax_fleet._ServeScenario()),
             "decode": (port_fleet._DecodeScenario(), jax_fleet._DecodeScenario()),
             "cascade": (port_fleet._CascadeScenario(), jax_fleet._CascadeScenario())}
    for sc in pairs["cascade"]:
        sc.setup()
    for name, (p, j) in pairs.items():
        assert p.payloads == j.payloads, name
        spec = port_fleet._trace_spec("decode_sessions" if name == "decode" else "heavy_tail",
                                      0, 8.0, 1.0)
        assert [port_fleet._mixed_payload(p, spec, i) for i in range(300)] == \
            [jax_fleet._mixed_payload(j, spec, i) for i in range(300)], name
    fake = SimpleNamespace(payloads={"a": [b"a0", b"a1"], "b": [b"b0"]})
    spec = jax_loadgen.TraceSpec(shapes=("a", "b"), shape_mix=(0.25, 0.75))
    assert [port_fleet._mixed_payload(fake, spec, i) for i in range(50)] == \
        [jax_fleet._mixed_payload(fake, spec, i) for i in range(50)]


def test_shed_total_matches():
    snaps = [{}, {"qos": {"shed_lane_high": 3, "shed_lane_best_effort": 40, "shed_t00001": 43,
                          "shed_level": 2, "shed_decisions": 5,
                          "shed_lane_hist": {"count": 9}},
                  "inference-bolt": {"shed_rejected": 7}},
             {"qos": {"shed_lane_normal": None}, "inference-bolt": {"shed_rejected": None}}]
    got = [port_fleet._shed_total(s) for s in snaps]
    assert got == [jax_fleet._shed_total(s) for s in snaps] == [0, 50, 0]


def test_recorded_r16_cells_regenerate():
    """Each of the 12 cells' recorded spec gives its recorded event count
    and ``stats()`` in the port, as in storm_tpu; the recorded hashes are
    stale in both (the spec gained fields after that run)."""
    cells = _r16_cells()
    assert len(cells) == 12
    stale = 0
    for c in cells:
        sd = dict(c["trace"]["spec"])
        for k in TUPLE_FIELDS:
            sd[k] = tuple(sd[k])
        got = port_loadgen.generate(port_loadgen.TraceSpec(**sd))
        want = jax_loadgen.generate(jax_loadgen.TraceSpec(**sd))
        assert len(got) == c["trace"]["events"] and got.stats() == c["trace"]["stats"]
        assert got.sha256() == want.sha256()
        stale += got.sha256() != c["trace"]["sha256"]
    assert stale == 12


def test_chip_smoke_trace_hashes_are_storm_tpus():
    """``chip_smoke.py`` holds the port's traces on the card to these
    constants; they are storm_tpu's hashes of the same specs."""
    import chip_smoke

    assert set(chip_smoke.P21_TRACE_SHA) == set(PATTERNS)
    for pattern, sha in chip_smoke.P21_TRACE_SHA.items():
        spec = jax_loadgen.TraceSpec(pattern=pattern, **chip_smoke.P21_TRACE_SPEC)
        assert jax_loadgen.generate(spec).sha256() == sha
