"""Scenario-matrix scorecard: per-cell targets, scoring, rendering, the
counterpart of ``storm_tpu/loadgen/scorecard.py`` (the same gates and the
same table text).

One cell = one (scenario, traffic pattern) pair from the fleet matrix
(:mod:`storm_tpu_torch.loadgen.fleet`). Each cell is scored on the four fleet
health axes — goodput, per-lane p99, SLO burn, shed fraction — read off
the observability surfaces the runtime already exposes (per-lane sink
histograms, the SLO-burn tracker, the bottleneck verdict). Targets are
*declared per cell*: a steady heavy-tail cell must deliver within SLO
with negligible shedding, while a flash-crowd cell passes precisely
when the protection machinery engages (shed up, burn tripped, protected
lane held) — behavior a uniformly paced bench can never exhibit.
"""

from __future__ import annotations

from dataclasses import asdict, dataclass
from typing import Dict, List, Optional

__all__ = ["CellTargets", "score_cell", "render_table"]


@dataclass(frozen=True)
class CellTargets:
    """Declared pass criteria for one scorecard cell. ``None`` disables
    a gate; booleans flip a gate from "must not happen" to "must"."""

    #: Protected lane whose p99 is gated.
    protected_lane: str = "high"
    #: Upper bound on the protected lane's e2e p99 (ms).
    p99_ms: Optional[float] = None
    #: Lower bound on goodput (within-SLO deliveries) as a fraction of
    #: *offered* records.
    min_goodput_frac: Optional[float] = None
    #: Upper bound on shed fraction of offered records.
    max_shed_frac: Optional[float] = None
    #: Upper bound on the peak fast-window burn rate.
    max_burn: Optional[float] = None
    #: Overload cells: shedding MUST engage / burn MUST trip.
    expect_shed: bool = False
    expect_burn_trip: bool = False
    #: Steady cells: the burn alarm must NOT trip.
    forbid_burn_trip: bool = False
    #: Decode cells: lower bound on delivered tokens/s goodput.
    min_tokens_s: Optional[float] = None
    #: Decode cells: upper bound on session time-to-first-token p99 (ms).
    ttft_p99_ms: Optional[float] = None


def score_cell(scores: Dict[str, object], targets: CellTargets) -> dict:
    """Evaluate one cell's measured ``scores`` against its ``targets``.

    Returns ``{"gates": {name: {"ok", "measured", "target"}}, "ok"}``;
    ``ok`` is the AND over the applicable gates. Expected keys in
    ``scores``: ``lane_p99_ms`` (dict), ``goodput_frac``, ``shed_frac``,
    ``burn_peak``, ``burn_tripped``; decode cells add ``tokens_per_s``
    and ``ttft_p99_ms``.
    """
    gates: Dict[str, dict] = {}

    def gate(name: str, ok: bool, measured, target) -> None:
        gates[name] = {"ok": bool(ok), "measured": measured,
                       "target": target}

    if targets.p99_ms is not None:
        p99 = (scores.get("lane_p99_ms") or {}).get(targets.protected_lane)
        gate(f"p99_{targets.protected_lane}_ms",
             p99 is not None and p99 <= targets.p99_ms,
             p99, f"<= {targets.p99_ms}")
    if targets.min_goodput_frac is not None:
        g = scores.get("goodput_frac")
        gate("goodput_frac", g is not None and g >= targets.min_goodput_frac,
             g, f">= {targets.min_goodput_frac}")
    if targets.max_shed_frac is not None:
        s = scores.get("shed_frac")
        gate("shed_frac", s is not None and s <= targets.max_shed_frac,
             s, f"<= {targets.max_shed_frac}")
    if targets.max_burn is not None:
        b = scores.get("burn_peak")
        gate("burn_peak", b is not None and b <= targets.max_burn,
             b, f"<= {targets.max_burn}")
    if targets.expect_shed:
        s = scores.get("shed_frac") or 0.0
        gate("shed_engaged", s > 0.0, s, "> 0")
    if targets.expect_burn_trip:
        t = bool(scores.get("burn_tripped"))
        gate("burn_tripped", t, t, "True")
    if targets.forbid_burn_trip:
        t = bool(scores.get("burn_tripped"))
        gate("burn_not_tripped", not t, t, "False")
    if targets.min_tokens_s is not None:
        v = scores.get("tokens_per_s")
        gate("tokens_per_s", v is not None and v >= targets.min_tokens_s,
             v, f">= {targets.min_tokens_s}")
    if targets.ttft_p99_ms is not None:
        v = scores.get("ttft_p99_ms")
        gate("ttft_p99_ms", v is not None and v <= targets.ttft_p99_ms,
             v, f"<= {targets.ttft_p99_ms}")
    return {"gates": gates, "ok": all(g["ok"] for g in gates.values())}


def _fmt(v, nd=1) -> str:
    if v is None:
        return "-"
    if isinstance(v, bool):
        return "yes" if v else "no"
    if isinstance(v, float):
        return f"{v:.{nd}f}"
    return str(v)


def render_table(scorecard: dict) -> str:
    """ASCII matrix for the ``main scorecard`` CLI: one row per
    cell, the four score axes, and the pass/fail verdict."""
    cells: List[dict] = scorecard.get("cells", [])
    hdr = ["scenario", "pattern", "offered/s", "goodput/s", "good%",
           "p99(hi)ms", "burn", "shed%", "verdict", "pass"]
    rows = [hdr]
    for c in cells:
        s = c.get("scores", {})
        lane_p99 = (s.get("lane_p99_ms") or {})
        verdict = (c.get("bottleneck") or {}).get("leader") or "-"
        rows.append([
            c.get("scenario", "?"),
            c.get("pattern", "?"),
            _fmt(s.get("offered_rate_per_s")),
            _fmt(s.get("goodput_per_s")),
            _fmt(100.0 * s["goodput_frac"]
                 if s.get("goodput_frac") is not None else None),
            _fmt(lane_p99.get("high")),
            _fmt(s.get("burn_peak"), 2)
            + ("!" if s.get("burn_tripped") else ""),
            _fmt(100.0 * s["shed_frac"]
                 if s.get("shed_frac") is not None else None),
            verdict,
            "PASS" if c.get("ok") else "FAIL",
        ])
    widths = [max(len(r[i]) for r in rows) for i in range(len(hdr))]
    out = []
    for i, r in enumerate(rows):
        out.append("  ".join(v.ljust(w) for v, w in zip(r, widths)).rstrip())
        if i == 0:
            out.append("  ".join("-" * w for w in widths))
    n_ok = sum(1 for c in cells if c.get("ok"))
    out.append("")
    out.append(f"{n_ok}/{len(cells)} cells pass"
               + (f" · seed {scorecard.get('seed')}"
                  if scorecard.get("seed") is not None else ""))
    return "\n".join(out)


def targets_dict(t: CellTargets) -> dict:
    return asdict(t)
