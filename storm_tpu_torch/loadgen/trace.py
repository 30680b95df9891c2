"""Seeded, replayable workload traces, the counterpart of
``storm_tpu/loadgen/trace.py``: heavy-tailed tenant populations, diurnal
rate waves, flash crowds and decode-session arrival waves.

A :class:`TraceSpec` plus a seed fully determines a trace:

- arrivals are a non-homogeneous Poisson process, generated by thinning
  against the pattern's rate profile with one ``PCG64(seed)`` stream;
- each accepted arrival draws a tenant (Zipf-popularity over
  ``spec.tenants``, the top ``gold_frac`` ranks are "gold" tier and
  biased toward the high lane), a QoS lane, and a record shape;
- event times are stored as **integer microseconds** and serialized as
  compact JSON arrays — no float formatting in the event stream, so the
  same spec + seed produces a byte-identical file on any host.

The file is a data format shared with storm_tpu: the same header key
(``storm_tpu_trace``) and version, the same draws in the same order, so
the same spec and seed give the same bytes in either package, and a trace
saved by one loads in the other (``tests/test_torch_loadgen.py``).

``replay`` paces a callback along the recorded schedule with an
injectable clock/sleep, so tests replay in virtual time and the fleet
fleet matrix replays against the wall clock.
"""

from __future__ import annotations

import hashlib
import json
import math
from dataclasses import asdict, dataclass, field, replace
from typing import Callable, List, NamedTuple, Optional, Tuple

import numpy as np

__all__ = ["TraceSpec", "TraceEvent", "Trace", "generate", "load_trace",
           "replay", "PATTERNS"]

#: Traffic patterns the generator knows how to shape.
PATTERNS = ("heavy_tail", "diurnal", "flash_crowd", "decode_sessions")

_FORMAT_VERSION = 1


@dataclass(frozen=True)
class TraceSpec:
    """Everything that determines a trace besides randomness: pattern,
    rates, populations, mixes. ``seed`` + spec -> byte-identical trace."""

    seed: int = 0
    pattern: str = "heavy_tail"
    duration_s: float = 30.0
    #: Mean arrivals/s where the pattern's rate profile == 1.0. The fleet
    #: matrix sets this per host from a capacity probe, so the *spec* in
    #: the artifact records the actual offered rate.
    base_rate: float = 100.0
    #: Tenant population; popularity is Zipf(zipf_s) over rank.
    tenants: int = 1000
    zipf_s: float = 1.1
    #: Top-ranked fraction of tenants on the "gold" tier (lane bias).
    gold_frac: float = 0.02
    lanes: Tuple[str, ...] = ("high", "normal", "best_effort")
    lane_mix: Tuple[float, ...] = (0.15, 0.5, 0.35)
    gold_lane_mix: Tuple[float, ...] = (0.7, 0.25, 0.05)
    #: Record shapes: instances-per-message variants the payload table
    #: maps to concrete bodies (mixed sizes exercise bucket padding).
    shapes: Tuple[str, ...] = ("s1", "s8")
    shape_mix: Tuple[float, ...] = (0.7, 0.3)
    # diurnal: rate = 1 + amp * sin(2*pi*t/period - pi/2) — starts at the
    # trough, peaks mid-trace.
    diurnal_period_s: float = 30.0
    diurnal_amp: float = 0.6
    # flash crowd: at flash_at_frac*duration the rate ramps to flash_mult
    # over flash_ramp_s, holds flash_hold_s, ramps back down. The excess
    # arrivals concentrate on flash_tenants hot tenants in flash_lane.
    flash_at_frac: float = 0.35
    flash_ramp_s: float = 1.0
    flash_hold_s: float = 6.0
    flash_mult: float = 3.0
    flash_tenants: int = 3
    flash_lane: str = "best_effort"
    # decode_sessions: SESSION arrivals, not record arrivals — each event
    # opens a multi-token decode session whose length class rides the
    # shape axis (the fleet scenario maps shapes to max_new_tokens, so
    # the shape_mix IS the ragged-length distribution). Admission comes
    # in square waves: ``decode_burst_frac`` of every
    # ``decode_period_s`` runs at ``decode_burst_mult`` x base_rate —
    # waves of new sessions landing on top of still-running long ones is
    # what stresses KV arena occupancy and eviction.
    decode_period_s: float = 8.0
    decode_burst_mult: float = 2.5
    decode_burst_frac: float = 0.35
    #: Generation safety valve, not a shaping knob.
    max_events: int = 2_000_000

    def profile(self, t: float) -> float:
        """Rate multiplier at time ``t`` (1.0 = base_rate)."""
        if self.pattern == "diurnal":
            return 1.0 + self.diurnal_amp * math.sin(
                2.0 * math.pi * t / self.diurnal_period_s - math.pi / 2.0)
        if self.pattern == "flash_crowd":
            t0 = self.flash_at_frac * self.duration_s
            ramp, hold, mult = (self.flash_ramp_s, self.flash_hold_s,
                                self.flash_mult)
            if t < t0 or t > t0 + 2 * ramp + hold:
                return 1.0
            if t < t0 + ramp:
                return 1.0 + (mult - 1.0) * (t - t0) / ramp
            if t < t0 + ramp + hold:
                return mult
            return mult - (mult - 1.0) * (t - t0 - ramp - hold) / ramp
        if self.pattern == "decode_sessions":
            phase = (t % self.decode_period_s) / self.decode_period_s
            return (self.decode_burst_mult
                    if phase < self.decode_burst_frac else 1.0)
        return 1.0  # heavy_tail: constant rate, skew lives in the tenants

    def max_profile(self) -> float:
        if self.pattern == "diurnal":
            return 1.0 + self.diurnal_amp
        if self.pattern == "flash_crowd":
            return self.flash_mult
        if self.pattern == "decode_sessions":
            return self.decode_burst_mult
        return 1.0

    def validate(self) -> None:
        if self.pattern not in PATTERNS:
            raise ValueError(f"unknown pattern {self.pattern!r}; "
                             f"one of {PATTERNS}")
        for mix, ref, what in ((self.lane_mix, self.lanes, "lane_mix"),
                               (self.gold_lane_mix, self.lanes,
                                "gold_lane_mix"),
                               (self.shape_mix, self.shapes, "shape_mix")):
            if len(mix) != len(ref):
                raise ValueError(f"{what} length {len(mix)} != {len(ref)}")
            if abs(sum(mix) - 1.0) > 1e-6:
                raise ValueError(f"{what} must sum to 1.0, got {sum(mix)}")
        if self.flash_lane not in self.lanes:
            raise ValueError(f"flash_lane {self.flash_lane!r} not in lanes")
        if self.decode_burst_mult < 1.0:
            raise ValueError("decode_burst_mult must be >= 1.0")
        if not 0.0 < self.decode_burst_frac < 1.0:
            raise ValueError("decode_burst_frac must be in (0, 1)")
        if self.decode_period_s <= 0:
            raise ValueError("decode_period_s must be positive")
        if self.tenants < 1 or self.base_rate <= 0 or self.duration_s <= 0:
            raise ValueError("tenants/base_rate/duration_s must be positive")


class TraceEvent(NamedTuple):
    """One arrival. ``t_us`` is offset-from-trace-start in integer µs."""

    t_us: int
    tenant: str
    lane: str
    shape: str

    @property
    def t_s(self) -> float:
        return self.t_us / 1e6

    def key(self) -> bytes:
        """Broker record key in the admission controller's
        ``tenant:lane`` declared-lane format (``qos/admission.py``)."""
        return f"{self.tenant}:{self.lane}".encode()


def _tenant_name(idx: int) -> str:
    return f"t{idx:05d}"


@dataclass
class Trace:
    """A generated (or loaded) trace: spec + the event schedule."""

    spec: TraceSpec
    #: rows of (t_us, tenant_idx, lane_idx, shape_idx)
    rows: List[Tuple[int, int, int, int]] = field(default_factory=list)

    def __len__(self) -> int:
        return len(self.rows)

    def events(self):
        lanes, shapes = self.spec.lanes, self.spec.shapes
        for t_us, ti, li, si in self.rows:
            yield TraceEvent(t_us, _tenant_name(ti), lanes[li], shapes[si])

    # -- serialization -----------------------------------------------------
    # Header line: {"storm_tpu_trace": 1, "spec": {...}} with sorted keys;
    # then one compact JSON int-array per event. Integer event times mean
    # the byte stream has no float formatting to drift.

    def to_bytes(self) -> bytes:
        header = json.dumps(
            {"storm_tpu_trace": _FORMAT_VERSION, "spec": asdict(self.spec)},
            sort_keys=True, separators=(",", ":"))
        lines = [header]
        lines.extend(
            f"[{t},{ti},{li},{si}]" for t, ti, li, si in self.rows)
        return ("\n".join(lines) + "\n").encode()

    def sha256(self) -> str:
        return hashlib.sha256(self.to_bytes()).hexdigest()

    def save(self, path: str) -> str:
        with open(path, "wb") as fh:
            fh.write(self.to_bytes())
        return path

    # -- summaries ---------------------------------------------------------

    def stats(self) -> dict:
        """Shape summary for artifacts/logs: offered totals per lane and
        shape, top-tenant concentration, realized mean rate."""
        lane_counts = {l: 0 for l in self.spec.lanes}
        shape_counts = {s: 0 for s in self.spec.shapes}
        tenant_counts: dict = {}
        for _, ti, li, si in self.rows:
            lane_counts[self.spec.lanes[li]] += 1
            shape_counts[self.spec.shapes[si]] += 1
            tenant_counts[ti] = tenant_counts.get(ti, 0) + 1
        n = len(self.rows)
        top = sorted(tenant_counts.values(), reverse=True)[:10]
        return {
            "events": n,
            "duration_s": self.spec.duration_s,
            "mean_rate_per_s": round(n / self.spec.duration_s, 2),
            "lanes": lane_counts,
            "shapes": shape_counts,
            "distinct_tenants": len(tenant_counts),
            "top10_tenant_share": round(sum(top) / n, 4) if n else 0.0,
        }


def _cdf(weights) -> np.ndarray:
    w = np.asarray(weights, dtype=np.float64)
    c = np.cumsum(w / w.sum())
    c[-1] = 1.0  # guard against fp undershoot at the tail
    return c


def generate(spec: TraceSpec) -> Trace:
    """Generate the trace ``spec`` + ``spec.seed`` determine.

    Thinning: candidate arrivals come from a homogeneous Poisson process
    at the profile's max rate; each is kept with probability
    ``profile(t)/max_profile``. One generator stream drives everything
    (arrival gaps, accept/reject, tenant/lane/shape draws) in a fixed
    per-event order, so the schedule is reproducible by construction.
    """
    spec.validate()
    rng = np.random.Generator(np.random.PCG64(spec.seed))

    ranks = np.arange(1, spec.tenants + 1, dtype=np.float64)
    tenant_cdf = _cdf(ranks ** (-spec.zipf_s))
    n_gold = max(1, math.ceil(spec.gold_frac * spec.tenants))
    lane_cdf = _cdf(spec.lane_mix)
    gold_lane_cdf = _cdf(spec.gold_lane_mix)
    shape_cdf = _cdf(spec.shape_mix)
    flash_lane_idx = spec.lanes.index(spec.flash_lane)
    is_flash = spec.pattern == "flash_crowd"

    lam_max = spec.base_rate * spec.max_profile()
    rows: List[Tuple[int, int, int, int]] = []
    t = 0.0
    while True:
        t += rng.exponential(1.0 / lam_max)
        if t >= spec.duration_s or len(rows) >= spec.max_events:
            break
        prof = spec.profile(t)
        if rng.random() * spec.max_profile() >= prof:
            continue  # thinned
        # During a flash the *excess* arrivals are the crowd: a few hot
        # tenants hammering one lane, which is what trips shed/burn in a
        # way a uniformly-paced overload never shows.
        crowd = is_flash and prof > 1.0 and rng.random() < (prof - 1.0) / prof
        if crowd:
            ti = int(rng.integers(0, min(spec.flash_tenants, spec.tenants)))
            li = flash_lane_idx
        else:
            ti = int(np.searchsorted(tenant_cdf, rng.random(), side="right"))
            cdf = gold_lane_cdf if ti < n_gold else lane_cdf
            li = int(np.searchsorted(cdf, rng.random(), side="right"))
        si = int(np.searchsorted(shape_cdf, rng.random(), side="right"))
        rows.append((int(round(t * 1e6)), ti, li, si))
    return Trace(spec=spec, rows=rows)


def load_trace(path: str) -> Trace:
    """Load a trace file written by :meth:`Trace.save`."""
    with open(path, "rb") as fh:
        data = fh.read()
    lines = data.decode().splitlines()
    if not lines:
        raise ValueError(f"{path}: empty trace file")
    header = json.loads(lines[0])
    if header.get("storm_tpu_trace") != _FORMAT_VERSION:
        raise ValueError(f"{path}: not a storm_tpu trace (v{_FORMAT_VERSION})")
    sd = header["spec"]
    for k in ("lanes", "lane_mix", "gold_lane_mix", "shapes", "shape_mix"):
        sd[k] = tuple(sd[k])
    spec = TraceSpec(**sd)
    rows = [tuple(json.loads(ln)) for ln in lines[1:] if ln]
    return Trace(spec=spec, rows=rows)


def replay(trace: Trace,
           emit: Callable[[TraceEvent], None],
           *,
           speed: float = 1.0,
           clock: Callable[[], float] = None,
           sleep: Callable[[float], None] = None,
           stop: Optional[Callable[[], bool]] = None,
           max_sleep_s: float = 0.05) -> int:
    """Pace ``emit(event)`` along the recorded schedule.

    ``speed`` > 1 compresses time. ``clock``/``sleep`` are injectable so
    tests replay in virtual time (round-trip equality is asserted without
    a single real sleep); ``stop()`` is polled between events so a caller
    can abort a cell early. Returns how many events were emitted.
    """
    import time as _time
    clock = clock or _time.monotonic
    sleep = sleep or _time.sleep
    start = clock()
    n = 0
    for ev in trace.events():
        if stop is not None and stop():
            break
        target = start + ev.t_us / 1e6 / speed
        while True:
            now = clock()
            if now >= target:
                break
            sleep(min(max_sleep_s, target - now))
        emit(ev)
        n += 1
    return n


def spec_with(spec: TraceSpec, **overrides) -> TraceSpec:
    """Convenience: a copy of ``spec`` with fields replaced (the fleet
    matrix stamps per-host ``base_rate`` into a shared pattern spec)."""
    return replace(spec, **overrides)
