"""Cascade policy, copied from ``storm_tpu/cascade/policy.py``: the tier
configuration and the confidence math.

A confidence-gated model cascade routes every record through an ordered
list of model tiers, cheapest first. A row is accepted at the first tier
whose prediction it can trust, and only the uncertain residue escalates
to the next tier, so the flagship sees a fraction of the traffic.

Trust is an *uncertainty* test: a metric maps a softmax row to a score in
[0, 1] (0 = certain), and a row accepts at tier *i* when its score is
strictly below ``thresholds[i]``. ``threshold = 0`` escalates everything
to the flagship; ``threshold = 1`` accepts everything at tier 0.

Metrics (``p`` a softmax row over K classes, optionally re-tempered):

* ``max_softmax``: ``1 - max(p)``
* ``margin``: ``1 - (top1(p) - top2(p))``
* ``entropy``: ``H(p) / log(K)``

``temperature`` re-calibrates the probabilities before scoring
(``softmax(log p / T)``); :func:`fit_temperature` fits it.

Import-light on purpose (stdlib and numpy only): ``Config`` embeds
:class:`CascadeConfig`, so nothing here may import the config, engine or
runtime layers.
"""

from __future__ import annotations

import math
from dataclasses import dataclass, field
from typing import Optional

import numpy as np

CONFIDENCE_METRICS = ("max_softmax", "margin", "entropy")


@dataclass
class CascadeConfig:
    """Confidence-gated model cascade for the inference operator.

    Off by default: ``enabled=False`` leaves the single-engine operator
    untouched. ``Config.cascade`` on the top-level :class:`Config`.
    """

    enabled: bool = False
    # Model registry names, cheapest tier first. A record enters at tier 0
    # and escalates until a tier accepts it; the last tier always accepts.
    # The ordering claim is auditable at runtime: the router's
    # ``inventory()`` carries each tier's measured cost per row from the
    # cost profiler (storm_tpu_torch/obs/profile.py).
    tiers: tuple = ()
    # Per-tier checkpoint dirs aligned with ``tiers``. "" = inherit the
    # operator's model checkpoint when the tier name matches its model,
    # else random init. Empty tuple = apply that rule to every tier.
    checkpoints: tuple = ()
    # Per-tier uncertainty thresholds for every NON-final tier (the last
    # tier always accepts, so len == len(tiers) - 1). A record accepts at
    # tier i when its uncertainty < thresholds[i]; see the module
    # docstring for the 0/1 identities.
    thresholds: tuple = ()
    # Uncertainty metric: max_softmax | margin | entropy.
    metric: str = "max_softmax"
    # Softmax re-calibration temperature applied before scoring (> 0;
    # 1.0 = raw probabilities). Fit with fit_temperature.
    temperature: float = 1.0
    # Per-QoS-lane threshold overrides: {"lane": (t0, t1, ...)} with the
    # same length as ``thresholds``. A latency-critical lane can run a
    # looser tier-0 gate (accept more, escalate less) than best-effort.
    lane_thresholds: dict = field(default_factory=dict)
    # Escalation-budget cap: the fraction of records allowed PAST tier 0
    # over a sliding window of ``budget_window`` decisions. When the
    # budget is exhausted, records accept at tier 0 regardless of
    # uncertainty (bounded flagship load under confidence collapse).
    # 1.0 = uncapped, 0.0 = never escalate (tier-0-only).
    escalation_budget: float = 1.0
    budget_window: int = 512
    # QoS coupling: each raised shed level multiplies the remaining
    # escalation strictness by this factor — effective threshold moves
    # toward 1 (accept-everything) as ``1 - (1 - t) * shed_tighten**level``
    # — and shed-ELIGIBLE lanes pin to tier 0 outright (no escalation).
    shed_tighten: float = 0.5
    # Degrade-compat mode (synthesized from qos.degrade_model): normal
    # traffic enters at the LAST tier (the flagship serves it directly)
    # and only shed-eligible records enter pinned at tier 0. A regular
    # cascade enters everything at tier 0.
    shed_only: bool = False

    def __post_init__(self) -> None:
        self.tiers = tuple(str(t) for t in self.tiers)
        self.checkpoints = tuple(str(c) for c in self.checkpoints)
        self.thresholds = tuple(float(t) for t in self.thresholds)
        self.lane_thresholds = {
            str(k): tuple(float(x) for x in v)
            for k, v in dict(self.lane_thresholds).items()}
        if not self.enabled:
            return
        if len(self.tiers) < 2:
            raise ValueError(
                "cascade.tiers needs >= 2 models (cheapest first); a "
                "single-model 'cascade' is just the plain operator")
        if self.checkpoints and len(self.checkpoints) != len(self.tiers):
            raise ValueError(
                f"cascade.checkpoints has {len(self.checkpoints)} entries "
                f"for {len(self.tiers)} tiers")
        if len(self.thresholds) != len(self.tiers) - 1:
            raise ValueError(
                f"cascade.thresholds needs one entry per non-final tier "
                f"({len(self.tiers) - 1}), got {len(self.thresholds)}")
        for t in self.thresholds:
            if not 0.0 <= t <= 1.0:
                raise ValueError(
                    f"cascade thresholds are uncertainty bounds in [0, 1], "
                    f"got {t!r}")
        if self.metric not in CONFIDENCE_METRICS:
            raise ValueError(
                f"cascade.metric must be one of {CONFIDENCE_METRICS}, "
                f"got {self.metric!r}")
        if float(self.temperature) <= 0.0:
            raise ValueError(
                f"cascade.temperature must be > 0, got {self.temperature!r}")
        if not 0.0 <= float(self.escalation_budget) <= 1.0:
            raise ValueError(
                "cascade.escalation_budget is a fraction in [0, 1], "
                f"got {self.escalation_budget!r}")
        if int(self.budget_window) < 1:
            raise ValueError(
                f"cascade.budget_window must be >= 1, got {self.budget_window!r}")
        if not 0.0 <= float(self.shed_tighten) <= 1.0:
            raise ValueError(
                f"cascade.shed_tighten must be in [0, 1], got {self.shed_tighten!r}")
        for lane, thr in self.lane_thresholds.items():
            if len(thr) != len(self.thresholds):
                raise ValueError(
                    f"cascade.lane_thresholds[{lane!r}] has {len(thr)} "
                    f"entries, expected {len(self.thresholds)}")
            for t in thr:
                if not 0.0 <= t <= 1.0:
                    raise ValueError(
                        f"cascade.lane_thresholds[{lane!r}] values must be "
                        f"in [0, 1], got {t!r}")

    # ---- routing policy ------------------------------------------------------

    @property
    def last_tier(self) -> int:
        return len(self.tiers) - 1

    def entry_tier(self, lane: Optional[str], shed_level: int, qos) -> int:
        """Which tier a fresh record enters at. Regular cascades start
        everything at tier 0; degrade-compat (``shed_only``) sends normal
        traffic straight to the flagship and only shed-eligible records
        into tier 0."""
        if not self.shed_only:
            return 0
        if shed_level > 0 and qos is not None \
                and qos.shed_eligible(lane, shed_level):
            return 0
        return self.last_tier

    def pinned(self, lane: Optional[str], shed_level: int, qos) -> bool:
        """Shed pins eligible lanes to their current tier: the record
        accepts where it is instead of escalating (the cascade IS the
        degrade path)."""
        return (shed_level > 0 and qos is not None
                and qos.shed_eligible(lane, shed_level))

    def threshold_for(self, tier: int, lane: Optional[str],
                      shed_level: int) -> float:
        """Effective uncertainty threshold for ``tier``: the per-lane
        override when one exists, widened toward accept-everything by the
        shed level (each level scales the remaining strictness ``1 - t``
        by ``shed_tighten``)."""
        base = self.lane_thresholds.get(lane, self.thresholds)[tier]
        if shed_level > 0:
            base = 1.0 - (1.0 - base) * (self.shed_tighten ** int(shed_level))
        return base


def uncertainty(probs: np.ndarray, metric: str = "max_softmax",
                temperature: float = 1.0) -> np.ndarray:
    """Per-row uncertainty scores in [0, 1] for a (n, K) batch of softmax
    probabilities (0 = certain). Shared by the router's accept/escalate
    split and offline threshold sweeps: one definition, so an
    offline-tuned threshold means the same thing online."""
    p = np.asarray(probs, dtype=np.float64)
    if p.ndim == 1:
        p = p[None, :]
    p = np.clip(p, 1e-12, None)
    p = p / p.sum(axis=-1, keepdims=True)
    if temperature != 1.0:
        # Re-temper in log space: softmax(log p / T). T > 1 flattens the
        # over-confident converged distribution so scores discriminate.
        logp = np.log(p) / float(temperature)
        logp -= logp.max(axis=-1, keepdims=True)
        p = np.exp(logp)
        p = p / p.sum(axis=-1, keepdims=True)
    if metric == "max_softmax":
        return 1.0 - p.max(axis=-1)
    if metric == "margin":
        top2 = np.partition(p, -2, axis=-1)[..., -2:]
        return 1.0 - (top2[..., 1] - top2[..., 0])
    if metric == "entropy":
        k = p.shape[-1]
        if k < 2:
            return np.zeros(p.shape[0])
        h = -(p * np.log(p)).sum(axis=-1)
        return h / math.log(k)
    raise ValueError(f"unknown cascade metric {metric!r}")


def fit_temperature(probs: np.ndarray, labels: np.ndarray,
                    grid=None) -> dict:
    """Grid-fit a calibration temperature minimizing NLL of ``labels``
    under re-tempered ``probs`` (softmax(log p / T)) — the classic
    single-parameter post-hoc calibration. Returns the fit plus per-T
    NLL, so a caller sees the curve, not just the argmin."""
    if grid is None:
        grid = (0.5, 0.75, 1.0, 1.25, 1.5, 2.0, 2.5, 3.0, 4.0)
    p = np.clip(np.asarray(probs, np.float64), 1e-12, None)
    p = p / p.sum(axis=-1, keepdims=True)
    logp = np.log(p)
    rows = np.arange(len(labels))
    curve = []
    for t in grid:
        z = logp / float(t)
        z -= z.max(axis=-1, keepdims=True)
        q = np.exp(z)
        q = q / q.sum(axis=-1, keepdims=True)
        nll = float(-np.log(np.clip(q[rows, labels], 1e-12, None)).mean())
        curve.append({"temperature": float(t), "nll": round(nll, 5)})
    best = min(curve, key=lambda r: r["nll"])
    return {"temperature": best["temperature"], "nll": best["nll"],
            "curve": curve}
