"""Typed configuration, copied from ``storm_tpu/config.py`` for the fields
the port reads: model, batching, the engine's sharding over ranks, spout
offsets, sink delivery, topology knobs, the broker, the control plane's
token and journal, resilience and chaos, QoS, the sink's SLO, the
observatory, the planner, the cascade and the ``[[pipelines]]`` of a
multi-model topology, with their validation. ``Config.load`` reads a TOML
or JSON file and ``Config.apply_overrides`` the CLI's
``--set section.key=value``, as storm_tpu's do.

``Config.to_dict`` and ``Config.from_dict`` carry a config through the
dist controller's submit recipe to its workers; a section or key the
dataclasses do not have is refused. A ``topology.spout_scheme`` set after
construction (or named in a dict) is pinned: the dist runtime's default
of the raw scheme with record frames (:func:`apply_dist_defaults`) then
leaves it alone."""

from __future__ import annotations

import dataclasses
import json
import os
from dataclasses import dataclass, field
from pathlib import Path
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
    # Persistent directory of the CUDA kernels' shared libraries. A
    # restarted daemon loads the kernels built by an earlier process
    # instead of running nvcc again (the reference pays model load on every
    # worker start, InferenceBolt.java:44-62; here kernel builds are the
    # analogous cold-start cost). A CUDA graph lives for one process, so
    # bucket captures are not cached. "" keeps the default directory
    # (storm_tpu_torch/ops/_build.py).
    compile_cache_dir: str = ""

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
class ShardingConfig:
    """How an inference engine's work maps onto a mesh of ranks
    (``storm_tpu_torch.parallel.mesh``): one process a rank, all of them in
    one ``torch.distributed`` process group that the caller initializes.

    ``data_parallel`` shards the batch axis over ranks (0 = every rank left
    once the second axis is sized). At most one of the other three sizes
    the mesh's second axis: ``tensor_parallel`` shards the attention and
    MLP weights Megatron-style, ``sequence_parallel`` the sequence axis of
    a model with ``apply_sp`` (ring attention), ``expert_parallel`` the
    experts of a MoE family. The default is one rank, no process group."""

    data_parallel: int = 1
    tensor_parallel: int = 1
    sequence_parallel: int = 1
    expert_parallel: int = 1
    axis_names: tuple = ("data", "model")


@dataclass
class OffsetsConfig:
    """Stream-position policy for the ingest spout. 'latest' with
    ``max_behind=0`` is the freshness-over-completeness default (start at
    the log end, drop backlog); 'resume' commits offsets on ack and
    resumes; 'earliest' replays the log; 'txn' resolves positions from
    the committed offsets like 'resume' but never commits on ack: the
    transactional sink commits the consumed offsets inside its producer
    transaction (exactly-once), and the spout delivers one entry per
    partition at a time. ``group_protocol=True`` takes the partitions from
    Kafka consumer-group coordination (JoinGroup/SyncGroup) instead of the
    task index, so the spout's tasks share them with any consumer of the
    group; it needs an explicit ``group_id`` and a wire-protocol broker,
    and is refused with 'txn' (v0 TxnOffsetCommit carries no generation,
    so a revoked partition's offsets could regress the group)."""

    policy: str = "latest"  # 'latest' | 'earliest' | 'resume' | 'txn'
    max_behind: Optional[int] = 0  # drop records more than N behind; None = unbounded
    group_id: Optional[str] = None  # None = fresh random group per run
    group_protocol: bool = False

    def __post_init__(self) -> None:
        if self.group_protocol and not self.group_id:
            # every task would otherwise mint its own group and be
            # assigned every partition: N-fold duplicate consumption
            raise ValueError(
                "offsets.group_protocol requires an explicit group_id "
                "(tasks must share one group to split partitions)")
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
        if self.policy == "txn" and self.group_protocol:
            raise ValueError(
                "offsets.policy='txn' requires group_protocol=False: "
                "v0-era TxnOffsetCommit has no rebalance fencing, so a "
                "revoked partition's in-flight offsets could regress the "
                "group position (use static partition assignment)")


@dataclass
class SinkConfig:
    """Producer-side delivery policy: async-with-callback, sync,
    fire-and-forget, or transactional (exactly-once egress: tuples buffer
    into one broker transaction per micro-batch of ``txn_batch`` tuples or
    ``txn_ms`` milliseconds, and ack only after its commit)."""

    mode: str = "async"  # 'async' | 'sync' | 'fire_and_forget' | 'transactional'
    # storm_tpu's producer acks (its reference's acks=1); declared there and
    # read nowhere, carried so that its config files load here.
    acks: int = 1
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
    # Inter-worker tuple wire of the dist runtime: "binary" = the
    # length-prefixed checksummed frames of dist/wire.py (bytes and arrays
    # cross without re-encoding), with a fall back per peer to JSON for a
    # worker that does not advertise the binary version; "json" = the JSON
    # envelope everywhere (it pins the string scheme).
    wire_format: str = "binary"
    # Shared-memory delivery lane between dist workers on one host (the
    # same host key, learned from the peer's ping): a delivery batch of at
    # least shm_min_bytes is written once into a shared-memory segment and
    # only a small checksummed header crosses the socket.
    shm_wire: bool = True
    shm_min_bytes: int = 65536
    # Per-task resource hints for the dist controller's resource-aware
    # placement (Storm's RAS): {"component-id": {"memory_mb": N, "cpu": pct}}.
    component_resources: dict = field(default_factory=dict)

    def __post_init__(self) -> None:
        if self.wire_format not in ("binary", "json"):
            raise ValueError(
                f"unknown wire_format {self.wire_format!r} "
                "(expected 'binary' or 'json')")
        self.__dict__.setdefault("_scheme_pinned", False)
        self.__dict__["_ready"] = True

    def __setattr__(self, name, value) -> None:
        # A scheme chosen after construction is the user's: the dist
        # default must not overwrite it.
        if name == "spout_scheme" and self.__dict__.get("_ready"):
            self.__dict__["_scheme_pinned"] = True
        object.__setattr__(self, name, value)


def apply_dist_defaults(cfg: "Config") -> "Config":
    """The dist runtime's record plane, storm_tpu's ``dist-run`` default:
    with the binary wire and no pinned scheme, the spout emits raw bytes
    and carries a chunk as one record frame. The JSON wire keeps the
    string scheme (raw bytes cannot cross it)."""
    topo = cfg.topology
    if not topo.__dict__.get("_scheme_pinned") and topo.wire_format != "json":
        object.__setattr__(topo, "spout_scheme", "raw")
        topo.spout_frames = True
    return cfg


@dataclass
class BrokerConfig:
    """Where records come from and go to: the in-process memory broker,
    or a Kafka broker over the wire protocol (``kind="kafka"``,
    ``bootstrap="host:port"``), which is how dist workers share a log."""

    kind: str = "memory"  # 'memory' | 'kafka'
    bootstrap: str = ""  # host:port list for kind='kafka'
    input_topic: str = "input"
    output_topic: str = "output"
    dead_letter_topic: str = "dead-letter"
    partitions: int = 4  # partitions for memory broker topics
    # 'v1' = 0.11-era message sets; 'v2' = KIP-98 record batches (CRC32C).
    message_format: str = "v1"
    # KIP-98 idempotent produce (message_format='v2' only).
    idempotent: bool = False
    # Egress codec for kind='kafka' (None = uncompressed); gzip, snappy or
    # lz4, message_format='v2' only. Ingest decodes all three regardless.
    compression: Optional[str] = None
    # Consumer isolation: 'read_committed' fetches with Fetch v4 and drops
    # aborted transactions' records.
    isolation: str = "read_uncommitted"
    security_protocol: str = "PLAINTEXT"  # | SSL | SASL_PLAINTEXT | SASL_SSL
    sasl_mechanism: str = "PLAIN"  # | SCRAM-SHA-256 | SCRAM-SHA-512
    sasl_username: str = ""
    sasl_password: str = ""
    ssl_cafile: str = ""
    ssl_check_hostname: bool = True
    ssl_verify: bool = True

    def security_dict(self) -> Optional[dict]:
        """The wire client's ``security`` parameter, or None for PLAINTEXT."""
        if self.security_protocol == "PLAINTEXT":
            return None
        return {
            "protocol": self.security_protocol,
            "sasl_mechanism": self.sasl_mechanism,
            "sasl_username": self.sasl_username,
            "sasl_password": self.sasl_password,
            "ssl_cafile": self.ssl_cafile or None,
            "ssl_check_hostname": self.ssl_check_hostname,
            "ssl_verify": self.ssl_verify,
        }

    def __post_init__(self) -> None:
        if self.kind not in ("memory", "kafka"):
            raise ValueError(f"broker.kind must be memory|kafka, got {self.kind!r}")
        if self.idempotent and self.message_format != "v2":
            raise ValueError(
                "broker.idempotent requires broker.message_format='v2'")
        if self.message_format not in ("v1", "v2"):
            raise ValueError(
                f"broker.message_format must be v1|v2, got {self.message_format!r}")
        if self.compression is not None:
            if self.compression not in ("gzip", "snappy", "lz4"):
                raise ValueError(
                    f"broker.compression must be gzip|snappy|lz4, "
                    f"got {self.compression!r}")
            if self.message_format != "v2":
                raise ValueError(
                    "broker.compression requires broker.message_format='v2'")
        if self.isolation not in ("read_uncommitted", "read_committed"):
            raise ValueError(
                f"broker.isolation must be read_uncommitted|read_committed, "
                f"got {self.isolation!r}")
        if self.security_protocol not in (
                "PLAINTEXT", "SSL", "SASL_PLAINTEXT", "SASL_SSL"):
            raise ValueError(
                "broker.security_protocol must be PLAINTEXT|SSL|"
                f"SASL_PLAINTEXT|SASL_SSL, got {self.security_protocol!r}")
        # Imported here: the connectors import this module at load.
        from storm_tpu_torch.connectors.kafka_protocol import SASL_MECHANISMS

        if self.sasl_mechanism not in SASL_MECHANISMS:
            raise ValueError(
                "broker.sasl_mechanism must be one of "
                f"{'|'.join(SASL_MECHANISMS)}, got {self.sasl_mechanism!r}")
        if (self.security_protocol.startswith("SASL")
                and not self.sasl_username):
            raise ValueError(
                "broker.security_protocol=SASL_* requires sasl_username "
                "(mechanism PLAIN)")


#: The env var the dist controller exports its control-plane token through
#: to its workers, and that every client falls back to.
CONTROL_TOKEN_ENV = "STORM_TPU_CONTROL_TOKEN"


def env_control_token() -> str:
    """The one read of the token's env fallback, shared by the dist plane's
    server and clients."""
    return os.environ.get(CONTROL_TOKEN_ENV, "")


@dataclass
class ControlConfig:
    """Control-plane authentication: ``auth_token`` is a shared secret that
    every dist RPC must carry (mismatches are refused UNAUTHENTICATED and
    logged); ``"env:NAME"`` reads it from the environment variable NAME;
    ``""`` falls back to $STORM_TPU_CONTROL_TOKEN, and disables auth only
    when that is unset too. A ``DistCluster`` starts its workers with its
    own token (``DistCluster(auth_token=cfg.control.resolve_token())``),
    and its ``submit`` refuses a config whose token resolves to another.

    ``journal_dir`` arms the controller's write-ahead journal
    (:mod:`storm_tpu_torch.dist.journal`; "" = none: a restarted
    controller rebuilds every worker); ``journal_snapshot_every`` compacts
    it after that many appends; ``reattach`` lets a controller started on
    a journal adopt the live workers instead of rebuilding them."""

    auth_token: str = ""
    journal_dir: str = ""
    journal_snapshot_every: int = 64
    reattach: bool = True

    def __post_init__(self) -> None:
        if int(self.journal_snapshot_every) < 1:
            raise ValueError("control.journal_snapshot_every must be >= 1")

    def resolve_token(self) -> str:
        t = self.auth_token
        if t.startswith("env:"):
            name = t[4:]
            val = os.environ.get(name, "")
            if not val:
                raise ValueError(
                    f"control.auth_token says {t!r} but ${name} is unset/empty")
            return val
        return t or env_control_token()


@dataclass
class ResilienceConfig:
    """Transport retry, circuit breaker and replay pacing knobs: the
    deadline-budgeted retry policy around dist RPCs, the per-peer circuit
    breaker of the sender, and the token bucket that paces the replay
    drained at a recovered peer (:mod:`storm_tpu_torch.resilience`)."""

    retry_attempts: int = 4
    retry_base_ms: float = 50.0
    retry_cap_ms: float = 2000.0
    # Total wall-clock budget across all attempts of one logical send.
    retry_deadline_s: float = 30.0
    circuit_failures: int = 5
    circuit_reset_s: float = 3.0
    # Tuples/s pushed at a recovered peer during the pacing window;
    # 0 = max_spout_pending over the window.
    replay_rate: float = 0.0
    replay_window_s: float = 10.0

    def __post_init__(self) -> None:
        if int(self.retry_attempts) < 1:
            raise ValueError("resilience.retry_attempts must be >= 1, got "
                             f"{self.retry_attempts!r}")
        for name in ("retry_base_ms", "retry_cap_ms", "retry_deadline_s",
                     "circuit_reset_s", "replay_rate", "replay_window_s"):
            if float(getattr(self, name)) < 0:
                raise ValueError(
                    f"resilience.{name} must be >= 0, got "
                    f"{getattr(self, name)!r}")
        if int(self.circuit_failures) < 1:
            raise ValueError("resilience.circuit_failures must be >= 1, "
                             f"got {self.circuit_failures!r}")


@dataclass
class ChaosConfig:
    """Dist fault injection for drills. It rides the submit recipe, so
    arming it on the controller arms every worker's injector
    (:mod:`storm_tpu_torch.resilience.chaos`). Never for production.
    The drill timers ``kill_worker_s`` and ``kill_controller_s`` are read
    by ``main.py dist-run``."""

    enabled: bool = False
    seed: int = 0
    wire_latency_ms: float = 0.0
    wire_jitter_ms: float = 0.0
    # Fraction of outbound send attempts dropped (raised as ChaosDrop).
    wire_drop_pct: float = 0.0
    # Fraction of outbound frames with one byte flipped.
    corrupt_pct: float = 0.0
    engine_hang_ms: float = 0.0
    # dist-run drills: SIGKILL a random worker (never the first) every this
    # many seconds, recovered by the heartbeat monitor (0 = off); and this
    # many seconds into the run, abandon the controller and build a fresh
    # one from the journal, which reattaches (0 = off; needs
    # control.journal_dir).
    kill_worker_s: float = 0.0
    kill_controller_s: float = 0.0

    def __post_init__(self) -> None:
        for name in ("wire_drop_pct", "corrupt_pct"):
            v = float(getattr(self, name))
            if not 0.0 <= v <= 1.0:
                raise ValueError(
                    f"chaos.{name} must be in [0, 1], got {v!r}")
        for name in ("wire_latency_ms", "wire_jitter_ms", "engine_hang_ms",
                     "kill_worker_s", "kill_controller_s"):
            if float(getattr(self, name)) < 0:
                raise ValueError(
                    f"chaos.{name} must be >= 0, got "
                    f"{getattr(self, name)!r}")


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
class PlanConfig:
    """The SLO planner (``storm_tpu_torch/plan/``). The offline solve
    (``main.py plan``) needs no config; this section sets the online half:
    when ``enabled``, the ``run`` daemon attaches a
    :class:`~storm_tpu_torch.plan.corrector.PlanCorrector` to the
    Observatory loop, which moves only the named limiter's parallelism, and
    the autoscaler defers its scale-up to it. The defaults are storm_tpu's
    (``overhead_ms`` among them, a TPU-era figure not measured on the
    card)."""

    enabled: bool = False
    # Offline solve targets (logged and served; never applied by itself).
    rate_rows_s: float = 0.0
    slo_p99_ms: float = 0.0
    # Highest predicted device utilization a feasible candidate may run at.
    headroom: float = 0.8
    # Horizon over which a cold shape's build cost is amortized.
    horizon_s: float = 600.0
    # Framework floor added to every predicted e2e p99.
    overhead_ms: float = 15.0
    # Charged for a cold shape with no recorded build.
    default_compile_ms: float = 500.0
    # An (engine, bucket) curve with fewer device samples is "cold".
    min_samples: int = 8
    # ---- the online corrector ----
    correct: bool = True
    hot_steps: int = 2
    calm_steps: int = 6
    hold_steps: int = 3
    # Parallelism bound of a correction; 0 = per kind
    # (runtime.autoscale.ACCEL_MAX_PARALLELISM / CPU_MAX_PARALLELISM).
    max_parallelism: int = 0

    def __post_init__(self) -> None:
        if not 0.0 < float(self.headroom) <= 1.0:
            raise ValueError(
                f"plan.headroom must be in (0, 1], got {self.headroom!r}")
        if self.rate_rows_s < 0 or self.slo_p99_ms < 0:
            raise ValueError("plan targets must be >= 0")
        if self.horizon_s <= 0:
            raise ValueError("plan.horizon_s must be > 0")
        if self.overhead_ms < 0 or self.default_compile_ms < 0:
            raise ValueError("plan cost floors must be >= 0")
        if min(self.hot_steps, self.calm_steps) < 1 or self.hold_steps < 0:
            raise ValueError(
                "need plan.hot_steps/calm_steps >= 1 and hold_steps >= 0")
        if self.min_samples < 1:
            raise ValueError("plan.min_samples must be >= 1")
        if self.max_parallelism < 0:
            raise ValueError("plan.max_parallelism must be >= 0 (0 = auto)")


@dataclass
class PipelineConfig:
    """One spout -> inference -> sink chain of a multi-model topology
    (``main.build_multi_model_topology``): its own model, batching,
    sharding, offsets and topics, in one process beside the others."""

    name: str = "pipeline"
    model: ModelConfig = field(default_factory=ModelConfig)
    batch: BatchConfig = field(default_factory=BatchConfig)
    sharding: ShardingConfig = field(default_factory=ShardingConfig)
    offsets: OffsetsConfig = field(default_factory=OffsetsConfig)
    input_topic: str = "input"
    output_topic: str = "output"
    dead_letter_topic: str = "dead-letter"
    # Records a spout tuple; 0 = topology.spout_chunk.
    spout_chunk: int = 0
    # "" = topology.spout_scheme.
    spout_scheme: str = ""
    spout_parallelism: int = 1
    inference_parallelism: int = 1
    sink_parallelism: int = 1

    @classmethod
    def from_dict(cls, d: dict) -> "PipelineConfig":
        p = cls()
        for k, v in d.items():
            if not hasattr(p, k):
                raise KeyError(f"unknown pipeline key {k!r}")
            cur = getattr(p, k)
            if dataclasses.is_dataclass(cur) and isinstance(v, dict):
                _apply_section(cur, v)
            else:
                setattr(p, k, v)
        return p


@dataclass
class Config:
    topology: TopologyConfig = field(default_factory=TopologyConfig)
    model: ModelConfig = field(default_factory=ModelConfig)
    batch: BatchConfig = field(default_factory=BatchConfig)
    sharding: ShardingConfig = field(default_factory=ShardingConfig)
    offsets: OffsetsConfig = field(default_factory=OffsetsConfig)
    sink: SinkConfig = field(default_factory=SinkConfig)
    tracing: TracingConfig = field(default_factory=TracingConfig)
    qos: QosConfig = field(default_factory=QosConfig)
    obs: ObsConfig = field(default_factory=ObsConfig)
    plan: PlanConfig = field(default_factory=PlanConfig)
    cascade: CascadeConfig = field(default_factory=CascadeConfig)
    broker: BrokerConfig = field(default_factory=BrokerConfig)
    control: ControlConfig = field(default_factory=ControlConfig)
    resilience: ResilienceConfig = field(default_factory=ResilienceConfig)
    chaos: ChaosConfig = field(default_factory=ChaosConfig)
    # Non-empty: ``run`` builds one chain per entry (TOML [[pipelines]]).
    pipelines: list = field(default_factory=list)

    @classmethod
    def from_dict(cls, d: dict) -> "Config":
        cfg = cls()
        cfg.apply_dict(d)
        return cfg

    def apply_dict(self, d: dict) -> None:
        for section, values in d.items():
            if not hasattr(self, section):
                raise KeyError(f"unknown config section {section!r}")
            if section == "pipelines":
                if not isinstance(values, list):
                    raise TypeError("config section 'pipelines' must be a list of tables")
                self.pipelines = [v if isinstance(v, PipelineConfig)
                                  else PipelineConfig.from_dict(v) for v in values]
                continue
            if not isinstance(values, dict):
                raise TypeError(f"config section {section!r} must be a table/dict")
            _apply_section(getattr(self, section), values)

    @classmethod
    def load(cls, path) -> "Config":
        """A TOML or JSON (by the ``.json`` suffix) config file."""
        path = Path(path)
        text = path.read_text()
        if path.suffix == ".json":
            return cls.from_dict(json.loads(text))
        import tomllib

        return cls.from_dict(tomllib.loads(text))

    def apply_overrides(self, overrides: list) -> None:
        """``section.key=value`` overrides (``--set``); a value is JSON
        where it parses as JSON, else the bare string."""
        patch: dict = {}
        for item in overrides:
            key, sep, raw = item.partition("=")
            if not sep:
                raise ValueError(f"override must be section.key=value: {item!r}")
            section, _, k = key.partition(".")
            try:
                val = json.loads(raw)
            except json.JSONDecodeError:
                val = raw
            patch.setdefault(section, {})[k] = val
        self.apply_dict(patch)

    def to_dict(self) -> dict:
        return dataclasses.asdict(self)


def _apply_section(target, values: dict) -> None:
    """Apply key -> value onto a config dataclass, lists becoming tuples
    where the field is a tuple, then validate again."""
    for k, v in values.items():
        if not hasattr(target, k):
            raise KeyError(f"unknown config key {k!r} for {type(target).__name__}")
        if isinstance(getattr(target, k), tuple) and isinstance(v, list):
            v = tuple(v)
        setattr(target, k, v)
        if k == "spout_scheme" and isinstance(target, TopologyConfig):
            target._scheme_pinned = True
    if hasattr(target, "__post_init__"):
        target.__post_init__()
