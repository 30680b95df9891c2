"""Typed configuration, copied from ``storm_tpu/config.py`` for the fields
the port reads: model, batching, spout offsets, sink delivery and
topology knobs, with their validation."""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass, field
from typing import Optional


@dataclass
class BatchConfig:
    """Micro-batching policy for the inference operator: dispatch when
    ``max_batch`` instances wait or the oldest has waited ``max_wait_ms``;
    pad to the smallest of ``buckets`` that fits."""

    max_batch: int = 256
    max_wait_ms: float = 5.0
    # Padding buckets (ascending); the final entry must equal max_batch.
    buckets: tuple = (8, 32, 128, 256)
    # Batches in flight per operator instance.
    max_inflight: int = 2

    def __post_init__(self) -> None:
        if int(self.max_batch) < 1:
            raise ValueError(f"batch.max_batch must be >= 1, got {self.max_batch!r}")
        if int(self.max_inflight) < 1:
            raise ValueError(
                f"batch.max_inflight must be >= 1, got {self.max_inflight!r}")
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
    input_shape: tuple = (224, 224, 3)  # per-instance HWC
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
class Config:
    topology: TopologyConfig = field(default_factory=TopologyConfig)
    model: ModelConfig = field(default_factory=ModelConfig)
    batch: BatchConfig = field(default_factory=BatchConfig)
    offsets: OffsetsConfig = field(default_factory=OffsetsConfig)
    sink: SinkConfig = field(default_factory=SinkConfig)
