"""Typed configuration, copied from ``storm_tpu/config.py`` for the fields
the port reads: model, batching, spout offsets, sink delivery, topology
knobs, QoS and the sink's SLO, with their validation."""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass, field
from typing import Optional


@dataclass
class BatchConfig:
    """Micro-batching policy for the inference operator: dispatch when
    ``max_batch`` instances wait or the oldest has waited ``max_wait_ms``;
    pad to the smallest of ``buckets`` that fits. The engine's fields
    (``pipeline_depth`` to ``watchdog_trips``) are storm_tpu's, and so are
    ``continuous`` and ``starvation_rounds``; its ``frame_egress`` belongs
    to record frames, which the port does not have yet."""

    max_batch: int = 256
    max_wait_ms: float = 5.0
    # Padding buckets (ascending); the final entry must equal max_batch.
    buckets: tuple = (8, 32, 128, 256)
    # Batches in flight per operator instance.
    max_inflight: int = 2
    # Work-conserving dispatch: flush the pending batch whenever an
    # in-flight slot is free instead of waiting out max_wait_ms (the
    # deadline still bounds the wait under load).
    eager: bool = False
    # Split-phase engine: batches allowed inside the ENGINE between
    # dispatch (stage -> host-to-device copy -> graph replay) and fetch
    # (the device-to-host copy waited on by the engine's fetch thread), so
    # batch N+1's copy to the card overlaps batch N's compute. 0 restores
    # the serialized predict. Bounds batches per shared engine across all
    # operator tasks (``max_inflight`` bounds them per task).
    pipeline_depth: int = 2
    # Pinned host staging buffers per (shape, dtype); each in-flight batch
    # holds its buffers from dispatch until its fetch completes.
    # 0 = pipeline_depth + 1, so a dispatch never waits on a recycling fetch.
    staging_pool: int = 0
    # Per-batch deadline on the fetch side: a batch whose result is not
    # ready this many ms after launch fails alone (EngineWatchdogTimeout)
    # and releases its ring slot and staging buffers. 0 = off.
    watchdog_ms: float = 0.0
    # Consecutive watchdog trips that quarantine the engine (it leaves the
    # shared-engine cache and refuses dispatches). 0 = never.
    watchdog_trips: int = 3
    # Per-engine continuous batching (infer/continuous.py): batch formation
    # moves out of the operator tasks into one slot-level queue per shared
    # engine; every task co-batches there, and a dispatcher thread refills
    # a ring slot the moment it frees. False keeps the per-task batchers.
    continuous: bool = False
    # The continuous queue's fairness bound: a tenant:lane key passed over
    # this many batch formations is served first in the next one.
    starvation_rounds: int = 4

    def __post_init__(self) -> None:
        if int(self.max_batch) < 1:
            raise ValueError(f"batch.max_batch must be >= 1, got {self.max_batch!r}")
        if int(self.max_inflight) < 1:
            raise ValueError(
                f"batch.max_inflight must be >= 1, got {self.max_inflight!r}")
        if float(self.watchdog_ms) < 0:
            raise ValueError(
                f"batch.watchdog_ms must be >= 0, got {self.watchdog_ms!r}")
        if int(self.watchdog_trips) < 0:
            raise ValueError(
                f"batch.watchdog_trips must be >= 0, got {self.watchdog_trips!r}")
        if int(self.pipeline_depth) < 0:
            raise ValueError(
                f"batch.pipeline_depth must be >= 0, got {self.pipeline_depth!r}")
        if int(self.staging_pool) < 0:
            raise ValueError(
                f"batch.staging_pool must be >= 0, got {self.staging_pool!r}")
        self.buckets = tuple(sorted(set(int(b) for b in self.buckets)))
        if not self.buckets:
            self.buckets = (self.max_batch,)
        if self.buckets[-1] != self.max_batch:
            self.buckets = tuple(b for b in self.buckets if b < self.max_batch) + (
                self.max_batch,)

    def bucket_for(self, n: int) -> int:
        for b in self.buckets:
            if n <= b:
                return b
        return self.buckets[-1]


@dataclass
class ModelConfig:
    """Which model an inference operator runs, and how."""

    # Key into storm_tpu_torch.models.registry. The default is the
    # flagship the port serves (the JAX package defaults to lenet5).
    name: str = "vit_b16"
    # An exported checkpoint: a path ending in ".npz", or the JAX package's
    # orbax directory spelled "checkpoints/<tag>", which names
    # "checkpoints_torch/<tag>.npz" (written by export_torch_checkpoints.py);
    # any other directory is refused. None initializes from ``seed``.
    checkpoint: Optional[str] = None
    dtype: str = "bfloat16"  # compute dtype
    num_classes: int = 1000
    input_shape: tuple = (224, 224, 3)  # per-instance HWC, or (seq, features)
    seed: int = 0
    # Extra keyword arguments for the registry's model function.
    extra: dict = dataclasses.field(default_factory=dict)
    # 'float' keeps params in the compute dtype; 'int8' quantizes every
    # weight (per-output-channel scales) and dequantizes it once at load;
    # 'int8_fused' keeps dense weights int8 for the w8a16 kernel.
    weights: str = "float"
    # Wire dtype of the host->device transfer; None ships the compute
    # dtype, 'uint8' affine-quantized bytes with a per-batch range.
    transfer_dtype: Optional[str] = None

    def __post_init__(self) -> None:
        if self.transfer_dtype not in (None, "uint8"):
            raise ValueError(f"unsupported transfer_dtype {self.transfer_dtype!r}")
        if self.weights not in ("float", "int8", "int8_fused"):
            raise ValueError(
                f"model.weights must be float|int8|int8_fused, got {self.weights!r}")

    @classmethod
    def from_checkpoint(cls, checkpoint: str, **fields) -> "ModelConfig":
        """The config serving an exported checkpoint: ``name``,
        ``input_shape`` and ``num_classes`` as its export recorded them,
        every other field from ``fields``."""
        from storm_tpu_torch.models.registry import checkpoint_meta

        meta = checkpoint_meta(checkpoint)
        return cls(name=meta["model"], checkpoint=checkpoint,
                   input_shape=tuple(meta["input_shape"]),
                   num_classes=meta["num_classes"], **fields)


@dataclass
class OffsetsConfig:
    """Stream-position policy for the ingest spout. 'latest' with
    ``max_behind=0`` is the freshness-over-completeness default (start at
    the log end, drop backlog); 'resume' commits offsets on ack and
    resumes; 'earliest' replays the log."""

    policy: str = "latest"  # 'latest' | 'earliest' | 'resume'
    max_behind: Optional[int] = 0  # drop records more than N behind; None = unbounded
    group_id: Optional[str] = None  # None = fresh random group per run

    def __post_init__(self) -> None:
        if self.policy not in ("latest", "earliest", "resume"):
            raise ValueError(f"unknown offsets policy {self.policy!r}")


@dataclass
class SinkConfig:
    """Producer-side delivery policy: async-with-callback, sync, or
    fire-and-forget."""

    mode: str = "async"  # 'async' | 'sync' | 'fire_and_forget'

    def __post_init__(self) -> None:
        if self.mode not in ("async", "sync", "fire_and_forget"):
            raise ValueError(f"unknown sink mode {self.mode!r}")


@dataclass
class TopologyConfig:
    """Topology-level knobs: parallelism and runtime policies."""

    spout_parallelism: int = 2
    inference_parallelism: int = 4
    sink_parallelism: int = 2
    max_spout_pending: int = 2048  # in-flight roots per spout instance
    message_timeout_s: float = 30.0  # at-least-once replay timeout
    inbox_capacity: int = 4096  # bounded executor queues (backpressure)


@dataclass
class TracingConfig:
    """The part of storm_tpu's tracing config the port reads: the sink's
    SLO (its ``slo_breaches`` counter, which the shed controller reads).
    Sampled traces and the flight recorder are not ported yet."""

    # e2e latency above which the sink counts an SLO breach (0 = off).
    slo_ms: float = 0.0


@dataclass
class QosConfig:
    """Admission control and QoS: per-tenant token buckets at the spout
    edge, weighted priority lanes with earliest-deadline-first batch
    formation in the inference operator, and a load-shedding controller
    that rejects best-effort traffic while the topology is overloaded.

    Off by default. A record's tenant and lane ride on its broker key,
    ``tenant:lane`` (both optional): ``b"gold:high"`` is tenant *gold* in
    lane *high*, ``b"gold"`` tenant *gold* in ``default_lane``, and a
    key-less record is tenant = its topic, lane = ``default_lane``.
    """

    enabled: bool = False
    # Priority lanes, highest first; keys naming an unknown lane (or none)
    # fall into ``default_lane``.
    lanes: tuple = ("high", "normal", "best_effort")
    default_lane: str = "normal"
    # Per-lane deadlines (ms after broker append), aligned with ``lanes``:
    # batch formation is earliest-deadline-first over them.
    lane_deadline_ms: tuple = (50.0, 200.0, 1000.0)
    # Token-bucket admission at the spout edge: records/s per tenant
    # (0 = unlimited), split evenly across spout tasks; ``tenant_rates``
    # overrides the default per tenant.
    tenant_rate: float = 0.0
    tenant_burst_s: float = 1.0  # bucket depth, in seconds of rate
    tenant_rates: dict = field(default_factory=dict)
    # The shed controller: cadence, signal thresholds, hysteresis.
    # ``shed_hot_steps`` consecutive hot intervals (any signal above its
    # threshold) raise the level by one, ``shed_calm_steps`` calm ones
    # (every signal below half its threshold) lower it. Level N sheds the
    # N lowest-priority lanes; the top lane never sheds.
    shed_interval_s: float = 1.0
    shed_inbox_frac: float = 0.5   # inference inbox occupancy fraction
    shed_wait_ms: float = 0.0      # batch-wait p95 threshold (0 = off)
    shed_breach_rate: float = 1.0  # sink SLO breaches/s (needs tracing.slo_ms)
    shed_hot_steps: int = 2
    shed_calm_steps: int = 5
    # storm_tpu routes shed lanes to this cheaper model through a cascade;
    # the cascade is not ported, so a non-empty value is refused by the
    # inference operator. "" rejects with a typed ``overloaded`` record.
    degrade_model: str = ""

    def __post_init__(self) -> None:
        self.lanes = tuple(str(lane) for lane in self.lanes)
        self.lane_deadline_ms = tuple(float(x) for x in self.lane_deadline_ms)
        if not self.lanes or len(set(self.lanes)) != len(self.lanes):
            raise ValueError("qos.lanes must be non-empty and unique")
        if len(self.lane_deadline_ms) != len(self.lanes):
            raise ValueError(
                f"qos.lane_deadline_ms has {len(self.lane_deadline_ms)} "
                f"entries for {len(self.lanes)} lanes")
        if self.default_lane not in self.lanes:
            raise ValueError(
                f"qos.default_lane {self.default_lane!r} not in qos.lanes")
        if self.shed_interval_s <= 0:
            raise ValueError("qos.shed_interval_s must be > 0")
        if self.shed_hot_steps < 1 or self.shed_calm_steps < 1:
            raise ValueError("qos shed hot/calm steps must be >= 1")

    # ---- lane helpers (one definition shared by spout, operator, shedder) ----

    def lane_index(self, lane: Optional[str]) -> int:
        """Priority index of ``lane`` (0 = highest); an unknown lane gets
        the default lane's."""
        try:
            return self.lanes.index(lane)
        except ValueError:
            return self.lanes.index(self.default_lane)

    def deadline_for(self, lane: Optional[str]) -> float:
        return self.lane_deadline_ms[self.lane_index(lane)]

    @property
    def max_shed_level(self) -> int:
        """Highest useful shed level: every lane but the top one shed."""
        return len(self.lanes) - 1

    def shed_eligible(self, lane: Optional[str], level: int) -> bool:
        """Does shed ``level`` drop ``lane``? Level N sheds the N
        lowest-priority lanes; the top lane never sheds."""
        if level <= 0:
            return False
        shed_from = len(self.lanes) - min(int(level), self.max_shed_level)
        return self.lane_index(lane) >= shed_from

    def rate_for(self, tenant: str) -> float:
        return float(self.tenant_rates.get(tenant, self.tenant_rate))


@dataclass
class Config:
    topology: TopologyConfig = field(default_factory=TopologyConfig)
    model: ModelConfig = field(default_factory=ModelConfig)
    batch: BatchConfig = field(default_factory=BatchConfig)
    offsets: OffsetsConfig = field(default_factory=OffsetsConfig)
    sink: SinkConfig = field(default_factory=SinkConfig)
    tracing: TracingConfig = field(default_factory=TracingConfig)
    qos: QosConfig = field(default_factory=QosConfig)
