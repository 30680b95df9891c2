"""The port's fleet matrix (``storm_tpu_torch/loadgen/fleet.py``) run on
the CPU (``device="cpu"``): a classify cell under heavy-tail traffic
scored with storm_tpu's keys (those of a cell of ``SCORECARD_r16.json``),
its named cursors dropped and the ``/scorecard`` route answering 200
while the cell's topology runs; the decode cell's topology and scoring
under session arrivals, and the whole decode cell through ``run_fleet``
with a fixed capacity and a shorter warm-up; the cascade's refusal when a tier checkpoint is
missing; the card as the default device; and the capacity probe's steps on scripted
topologies. storm_tpu's ``run_fleet`` is not run here: it compiles on
JAX, and its continuous scenario can meet ROADMAP C3.
"""

from __future__ import annotations

import gc
import json
import os
import time

import pytest
import torch

from storm_tpu_torch.loadgen import fleet
from storm_tpu_torch.loadgen.scorecard import score_cell

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _r16_cell() -> dict:
    with open(os.path.join(ROOT, "SCORECARD_r16.json")) as f:
        return json.load(f)["cells"][0]


def _quiet(msg: str) -> None:
    pass


def test_classify_cell_has_storm_tpus_keys_and_hygiene():
    card = fleet.run_fleet(hold_s=2.0, scenarios=("classify",), patterns=("heavy_tail",),
                           device="cpu", log=_quiet)
    assert card["device"] == "cpu" and card["cells_total"] == 1 and card["skipped"] == []
    cell, ref = card["cells"][0], _r16_cell()
    assert (cell["scenario"], cell["pattern"]) == ("classify", "heavy_tail")
    assert set(cell) == set(ref)
    # storm_tpu's scores gained ``hold_elapsed_s`` after r16 (with the decode axes)
    assert set(cell["scores"]) == set(ref["scores"]) | {"hold_elapsed_s"}
    assert set(cell["trace"]) == set(ref["trace"]) and set(cell["flight"]) == set(ref["flight"])
    assert set(cell["gates"]) == set(ref["gates"])
    assert cell["targets"] == fleet.targets_dict(fleet._targets_for("heavy_tail", 400.0))
    s = cell["scores"]
    assert s["offered"] == cell["trace"]["events"] > 0 and s["delivered"] > 0
    assert 1.5 < cell["hold_elapsed_s"] < 3.0
    assert cell["flight"]["scenario_phase"] >= 3
    # the trace regenerates from its recorded spec
    spec = fleet.TraceSpec(**{k: tuple(v) if isinstance(v, list) else v
                              for k, v in cell["trace"]["spec"].items()})
    assert fleet.generate(spec).sha256() == cell["trace"]["sha256"]
    ev = card["evidence"]
    assert ev["scenario_phase_flight_events"] is True
    assert ev["scorecard_route"] == {"status": 200, "cells": 1, "in_progress": True}
    hyg = ev["cursor_hygiene"]
    assert "cell-classify-heavy_tail" in hyg["hist_cursors_before"]
    assert "cell-classify-heavy_tail" not in hyg["hist_cursors_after"]
    assert hyg["hist_cursors_dropped"] >= 1 and hyg["capacity_cursor_dropped"] is True
    (eng,) = card["engines"]["classify"]
    assert (eng["model"], eng["dtype"], eng["buckets"]) == ("lenet5", "bfloat16", [64, 256])
    assert eng["forwards"] > 0 and eng["launch_tally"] == {}


def test_cascade_names_a_missing_tier_checkpoint(tmp_path):
    sc = fleet._CascadeScenario()
    assert sc.available() is None
    assert all(p.endswith("_digits.npz") and os.path.isfile(p) for p in sc.ckpts.values())
    missing = str(tmp_path / "vit_tiny_digits.npz")
    sc.ckpts["vit_tiny"] = missing
    reason = sc.available()
    assert reason.startswith("missing tier checkpoints") and missing in reason


def test_run_fleet_defaults_to_the_card():
    if torch.cuda.is_available():
        pytest.skip("a card is visible: run_fleet() would run the matrix on it")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        fleet.run_fleet()
    with pytest.raises(RuntimeError, match="no CUDA device"):
        fleet.main(["--fleet-scenarios", "classify", "--stage-seconds", "1"])


def _served(capacity: float, overdriven: float = 1.0, first: float = 1.0):
    """A topology's open-loop step: it delivers the offered rate up to
    ``capacity``, ``overdriven`` x capacity when offered more than 1.5x
    it, and ``first`` x its reading on the first step (a stall)."""
    calls = []

    def step(rate: float, dur: float) -> tuple:
        calls.append((rate, dur))
        delivered = min(rate, capacity) * (overdriven if rate > 1.5 * capacity else 1.0)
        return delivered * (first if len(calls) == 1 else 1.0), rate
    return step, calls


@pytest.mark.parametrize("capacity, overdriven, first, want, steps", [
    (600.0, 1.0, 1.0, 600.0, 5),    # kept up, then behind at every step
    (300.0, 1.0, 1.0, 300.0, 5),    # 0.9x the burst bound saturates: storm_tpu's step, checked
    (560.0, 0.8, 1.0, 560.0, 5),    # the raised step collapses; 1.25x the first's 500 saturates
    (1400.0, 1.0, 0.9, 1400.0, 5),  # a stalled first step read as behind
    (1e6, 1.0, 1.0, 8000.0, 5),     # never saturated: the last offered rate
])
def test_probe_keeps_the_best_delivery(capacity, overdriven, first, want, steps):
    step, calls = _served(capacity, overdriven, first)
    assert fleet._saturated_rate(step, 500.0) == pytest.approx(want)
    assert len(calls) == steps and calls[0] == (500.0, 6.0)
    assert all(dur == fleet._RAISED_S for _, dur in calls[1:])


def test_decode_cell_through_run_fleet(monkeypatch):
    """The decode cell as ``run_fleet`` runs it: warm-up, the hold's
    session replay, drain, flight harvest, scoring and cursor hygiene.
    Two cuts keep it short on this host: the probe returns a fixed 4
    sessions/s, and the warm-up offers 16 sessions at once and 2 paced
    where a cell offers 192 and 64. 16 sessions fit the 64-block arena;
    192 do not, and on this host that thrash (ROADMAP C26) takes minutes."""
    monkeypatch.setattr(fleet, "_WARM_BURST", 16)
    monkeypatch.setattr(fleet, "_WARM_PACED", 2)
    monkeypatch.setattr(fleet._DecodeScenario, "probe",
                        lambda self, cluster, slo_ms, log: 4.0)
    card = fleet.run_fleet(hold_s=2.0, scenarios=("decode",), device="cpu", log=_quiet)
    assert card["cells_total"] == 1 and card["skipped"] == [] and card["engines"] == {"decode": []}
    cell, ref = card["cells"][0], _r16_cell()
    assert (cell["scenario"], cell["pattern"], cell["cap1_msg_s"]) == \
        ("decode", "decode_sessions", 4.0)
    assert set(cell) == set(ref) and set(cell["flight"]) == set(ref["flight"])
    assert set(cell["scores"]) == set(ref["scores"]) | {
        "hold_elapsed_s", "tokens_per_s", "ttft_p99_ms", "sessions_started", "kv_arena"}
    assert set(cell["gates"]) == {"tokens_per_s", "ttft_p99_ms", "shed_frac"}
    assert cell["trace"]["spec"]["pattern"] == "decode_sessions"
    assert cell["trace"]["spec"]["base_rate"] == 0.5 * 4.0
    s = cell["scores"]
    assert s["offered"] == cell["trace"]["events"] > 0
    # one delivery is one token: at least one a session, at most 24 (s8's)
    assert s["offered"] <= s["delivered"] and s["tokens_per_s"] > 0
    assert s["sessions_started"] >= 16 and s["ttft_p99_ms"] > 0
    assert s["kv_arena"]["slots_total"] == 64
    assert cell["flight"]["scenario_phase"] >= 3
    ev = card["evidence"]
    assert ev["scorecard_route"] == {"status": 200, "cells": 1, "in_progress": True}
    hyg = ev["cursor_hygiene"]
    assert "cell-decode-decode_sessions" in hyg["hist_cursors_before"]
    assert "cell-decode-decode_sessions" not in hyg["hist_cursors_after"]
    assert hyg["hist_cursors_dropped"] >= 1 and hyg["capacity_cursor_dropped"] is True


def test_decode_cell_scoring_on_a_live_decode_topology():
    """The decode cell's topology (``_DecodeScenario.build``) on the CPU:
    a ``decode_sessions`` trace's first sessions produced as a cell
    produces them (the scenario's payload pool, the ``tenant:lane`` key),
    every request's tree acked with its tokens at the sink, then the cell's
    decode axes (``extra_scores``: tokens/s, TTFT p99 from the bolt's
    histogram, sessions and the arena from ``decode_stats``) graded
    against its targets."""
    from storm_tpu_torch.runtime.cluster import LocalCluster

    from storm_tpu_torch.decode import decode_stats

    (sc,) = fleet._make_scenarios(["decode"], "cpu")
    fleet._clear_engines()
    gc.collect()  # the stores of topologies gone before this one
    started = sum(r["sessions_started"] for r in decode_stats()["stores"])
    broker, cfg, topo = sc.build(400.0)
    spec = fleet._trace_spec("decode_sessions", 16, 2.0, 8.0)
    events = list(fleet.generate(spec).events())[:12]
    used = {shape: 0 for shape in sc.payloads}
    cluster = LocalCluster()
    name = "fleet-decode-cpu"
    try:
        cluster.submit_topology(name, cfg, topo)
        for ev in events:
            broker.produce(cfg.broker.input_topic, sc.payloads[ev.shape][used[ev.shape]],
                           key=ev.key())
            used[ev.shape] += 1
        deadline = time.time() + 90
        while cluster.metrics(name).get("kafka-spout", {}).get("tree_acked", 0) < len(events):
            assert time.time() < deadline, cluster.metrics(name).get("kafka-spout")
            time.sleep(0.05)
        snap = cluster.metrics(name)
        delivered = int(snap["kafka-bolt"]["delivered"])
        assert delivered == broker.topic_size(cfg.broker.output_topic)
        assert len(events) <= delivered <= sum(sc.TOKENS[ev.shape] for ev in events)
        scores = {"hold_elapsed_s": 2.0, "delivered": delivered,
                  "slo_breaches": int(snap["kafka-bolt"].get("slo_breaches", 0)),
                  "shed_frac": 0.0}
        extra = sc.extra_scores(cluster._cluster.runtime(name), snap, scores)
    finally:
        cluster.kill_topology(name, wait_secs=1)
        cluster.shutdown()
        fleet._clear_engines()
    assert extra["tokens_per_s"] == round((delivered - scores["slo_breaches"]) / 2.0, 1)
    assert extra["sessions_started"] - started == len(events)
    assert extra["ttft_p99_ms"] > 0 and extra["kv_arena"]["slots_total"] == 64
    graded = score_cell({**scores, **extra}, sc.targets("decode_sessions", 400.0, spec))
    assert set(graded["gates"]) == {"tokens_per_s", "ttft_p99_ms", "shed_frac"}
    assert graded["gates"]["tokens_per_s"]["target"] == \
        f">= {round(0.4 * spec.base_rate * sc._mean_tokens(), 1)}"
