"""Typed configuration, copied from ``storm_tpu/config.py`` for the fields
the port reads: model, batching, spout offsets, sink delivery, topology
knobs, QoS, the sink's SLO, the observatory and the cascade, with their
validation."""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass, field
from typing import Optional

from storm_tpu_torch.cascade.policy import CascadeConfig


@dataclass
class BatchConfig:
    """Micro-batching policy for the inference operator: dispatch when
    ``max_batch`` instances wait or the oldest has waited ``max_wait_ms``;
    pad to the smallest of ``buckets`` that fits. The engine's fields
    (``pipeline_depth`` to ``watchdog_trips``) are storm_tpu's, and so are
    ``continuous``, ``starvation_rounds`` and ``frame_egress``."""

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
    # Frame egress: the records of one RecordFrame leave as ONE
    # predictions payload per dispatched batch (one encode, one emit, one
    # output message). False keeps one output message per record for frame
    # ingress too, with the zero-copy ingress and view decode unchanged.
    frame_egress: bool = True

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
    resumes; 'earliest' replays the log; 'txn' resolves positions from
    the committed offsets like 'resume' but never commits on ack: the
    transactional sink commits the consumed offsets inside its producer
    transaction (exactly-once), and the spout delivers one entry per
    partition at a time. The group protocol (``group_protocol``) waits for
    the Kafka wire broker and is not a field here."""

    policy: str = "latest"  # 'latest' | 'earliest' | 'resume' | 'txn'
    max_behind: Optional[int] = 0  # drop records more than N behind; None = unbounded
    group_id: Optional[str] = None  # None = fresh random group per run

    def __post_init__(self) -> None:
        if self.policy not in ("latest", "earliest", "resume", "txn"):
            raise ValueError(f"unknown offsets policy {self.policy!r}")
        if self.policy == "txn" and not self.group_id:
            raise ValueError(
                "offsets.policy='txn' requires an explicit group_id — the "
                "transactional sink commits offsets to it, and a restart "
                "must resume from the SAME group to be exactly-once")
        if self.policy == "txn" and self.max_behind is not None:
            raise ValueError(
                "offsets.policy='txn' requires max_behind=None — dropping "
                "stale records under a freshness clamp contradicts the "
                "exactly-once contract (set it explicitly)")


@dataclass
class SinkConfig:
    """Producer-side delivery policy: async-with-callback, sync,
    fire-and-forget, or transactional (exactly-once egress: tuples buffer
    into one broker transaction per micro-batch of ``txn_batch`` tuples or
    ``txn_ms`` milliseconds, and ack only after its commit)."""

    mode: str = "async"  # 'async' | 'sync' | 'fire_and_forget' | 'transactional'
    txn_batch: int = 64
    txn_ms: float = 100.0
    # The consumer group to commit the consumed offsets to inside the
    # producer transaction: the spout's offsets.group_id, with
    # offsets.policy='txn'. None = egress-only transactions.
    offsets_group: Optional[str] = None

    def __post_init__(self) -> None:
        if self.mode not in ("async", "sync", "fire_and_forget", "transactional"):
            raise ValueError(f"unknown sink mode {self.mode!r}")


@dataclass
class TopologyConfig:
    """Topology-level knobs: parallelism, the spout's chunks, scheme and
    frames, and runtime policies. The spout refuses an unknown scheme,
    and frames without ``scheme="raw"``, as storm_tpu's does."""

    # The topology's name; the transactional sink's stable transactional
    # id is ``<name>-<component>-<task>``.
    name: str = "inference-topology"
    spout_parallelism: int = 2
    inference_parallelism: int = 4
    sink_parallelism: int = 2
    max_spout_pending: int = 2048  # in-flight roots per spout instance
    # Records per emitted spout tuple: 1 is one record a tuple; N > 1
    # emits up to N consecutive records of one fetch as ONE tuple (one
    # ledger entry and one executor hop per chunk); failure and replay
    # granularity becomes the chunk.
    spout_chunk: int = 1
    # Tuple-value scheme: "string" decodes each record to str; "raw"
    # emits the broker bytes untouched (the parser reads bytes, and an
    # Arrow tensor record must stay bytes).
    spout_scheme: str = "string"
    # With scheme "raw" and spout_chunk > 1, each chunk rides as ONE
    # RecordFrame tuple value (runtime/frames.py): routing moves one
    # reference instead of N payloads, and egress coalesces to one
    # predictions payload per frame and batch (BatchConfig.frame_egress).
    spout_frames: bool = False
    message_timeout_s: float = 30.0  # at-least-once replay timeout
    inbox_capacity: int = 4096  # bounded executor queues (backpressure)
    tick_interval_s: float = 0.0  # 0 = no tick tuples
    checkpoint_interval_s: float = 5.0  # stateful-bolt checkpoint cadence
    state_dir: str = ""  # durable bolt-state dir; "" = in-memory backend


@dataclass
class TracingConfig:
    """Per-record tracing and the flight recorder (runtime/tracing.py),
    ``storm_tpu/config.py``'s ``TracingConfig``. Off by default:
    ``sample_rate=0`` keeps the hot path free of trace contexts."""

    # Fraction of root tuples that carry a TraceContext (0 = off, 1 = all).
    sample_rate: float = 0.0
    # Finished traces kept in the in-process ring.
    store_capacity: int = 256
    # e2e latency above which the sink counts an SLO breach (its
    # ``slo_breaches`` counter, which the shed controller reads) and
    # records a ``slo_breach`` flight event (0 = off).
    slo_ms: float = 0.0
    # JSONL flight-recorder file ("" = the in-memory ring only).
    flight_path: str = ""
    # In-memory flight-recorder ring size (events).
    flight_capacity: int = 512
    # Rotation: flight_path -> .1 -> ... past this size, at most
    # flight_max_files generations kept.
    flight_max_bytes: int = 4 * 1024 * 1024
    flight_max_files: int = 3

    def __post_init__(self) -> None:
        if not 0.0 <= float(self.sample_rate) <= 1.0:
            raise ValueError(
                f"tracing.sample_rate must be in [0, 1], got {self.sample_rate!r}")


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
    # Shed lanes are served by this cheaper model instead of rejected: the
    # inference operator synthesizes a two-tier shed-only cascade (this
    # model, then its own). "" rejects with a typed ``overloaded`` record.
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
class ObsConfig:
    """The observatory (``storm_tpu_torch/obs/``). The cost profile itself
    is always on; ``enabled`` gates the *control loop*: the Observatory
    task that steps the burn tracker, publishes occupancy gauges, steps
    the bottleneck attribution and runs the regression sentinel. The burn
    tracker needs ``tracing.slo_ms`` set: without it the sink never counts
    breaches and burn stays 0.
    """

    enabled: bool = False
    # Observatory step cadence (burn tracker + occupancy gauges).
    interval_s: float = 1.0
    # SLO objective: fraction of delivered records inside tracing.slo_ms.
    # The error budget is 1 - slo_objective.
    slo_objective: float = 0.99
    # Multi-window burn: both windows must exceed burn_threshold to trip
    # (fast reacts, slow de-flaps). Burn 1.0 = spending budget exactly.
    burn_fast_window_s: float = 60.0
    burn_slow_window_s: float = 600.0
    burn_threshold: float = 1.0
    # Regression sentinel: compare live stage costs against this
    # PROFILE_*.json snapshot ("" = sentinel off); flag a (engine,
    # bucket, stage) cell when live mean > regression_factor x baseline,
    # once it has at least min_samples live observations.
    baseline_path: str = ""
    regression_factor: float = 1.5
    sentinel_interval_s: float = 10.0
    min_samples: int = 20
    # Bottleneck attribution (obs/bottleneck.py): a component counts as
    # "at capacity" above capacity_hot busy-fraction of the wallclock
    # window;
    # an edge is "growing" above lag_growth_eps rows/s; a saturated but
    # no-longer-growing inbox still attributes above lag_depth_hot
    # queued records; no leader is named below bottleneck_min_score
    # (an idle topology has no bottleneck).
    capacity_hot: float = 0.8
    lag_growth_eps: float = 1.0
    lag_depth_hot: int = 64
    bottleneck_min_score: float = 0.4
    # Copy ledger (obs/copyledger.py): a ``copy_amplification_high``
    # flight event fires when the windowed amplification ratio (bytes
    # moved / bytes ingested) exceeds this ceiling; 0 disables the
    # check. De-flapped: the event re-arms only after the ratio falls
    # back under 80% of the ceiling.
    copy_amp_ceiling: float = 32.0

    def __post_init__(self) -> None:
        if self.interval_s <= 0 or self.sentinel_interval_s <= 0:
            raise ValueError("obs intervals must be > 0")
        if not 0.0 < float(self.capacity_hot) <= 1.0:
            raise ValueError(
                f"obs.capacity_hot must be in (0, 1], got "
                f"{self.capacity_hot!r}")
        if self.lag_growth_eps < 0 or self.lag_depth_hot < 0:
            raise ValueError("obs lag thresholds must be >= 0")
        if self.bottleneck_min_score < 0:
            raise ValueError("obs.bottleneck_min_score must be >= 0")
        if not 0.0 < float(self.slo_objective) < 1.0:
            raise ValueError(
                f"obs.slo_objective must be in (0, 1), got "
                f"{self.slo_objective!r}")
        if (self.burn_fast_window_s <= 0
                or self.burn_slow_window_s < self.burn_fast_window_s):
            raise ValueError(
                "need 0 < obs.burn_fast_window_s <= obs.burn_slow_window_s")
        if self.regression_factor <= 1.0:
            raise ValueError("obs.regression_factor must be > 1")
        if self.copy_amp_ceiling < 0:
            raise ValueError("obs.copy_amp_ceiling must be >= 0")


@dataclass
class Config:
    topology: TopologyConfig = field(default_factory=TopologyConfig)
    model: ModelConfig = field(default_factory=ModelConfig)
    batch: BatchConfig = field(default_factory=BatchConfig)
    offsets: OffsetsConfig = field(default_factory=OffsetsConfig)
    sink: SinkConfig = field(default_factory=SinkConfig)
    tracing: TracingConfig = field(default_factory=TracingConfig)
    qos: QosConfig = field(default_factory=QosConfig)
    obs: ObsConfig = field(default_factory=ObsConfig)
    cascade: CascadeConfig = field(default_factory=CascadeConfig)
