#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (storm_tpu_torch) end to end on one CUDA card.

    python3 chip_smoke.py          # from the root of a checkout

Phases, each raising on failure (the script then exits non-zero and prints
no result):

1. environment: the card's name and power limit, torch and CUDA versions;
   the package resolves the card (as every entry point does), which must
   turn TF32 and bf16 reduced-precision reductions off: this script
   asserts those flags and never sets them;
2. build: every hand-written kernel from ``storm_tpu_torch/csrc`` (one
   ``nvcc`` per source, in parallel);
3. kernel parity: each kernel against its plain PyTorch version on the
   card, at the cases and tolerances of ``storm_tpu/ops/parity_checks.py``,
   at the same ragged shapes in bf16, and at the ViT-B/16 shapes (batch 8);
   at Mixer-S/16's token-MLP shapes (K or N = 196, a transposed view)
   and its width 512; every kernel has two variants, its first version and its redesign for
   Hopper (``*_sm90``: w8a16 and flash attention on tensor cores for
   bfloat16, the first versions serving float32; the fused norm for both
   dtypes, its first version launched only by name), and every case checks
   which one it launched. Then each kernel variant, its plain version and
   a one-call PyTorch yardstick are timed with CUDA events over one
   forward's worth of calls at the ViT-B/16 shapes, and w8a16 and the
   fused norm at Mixer-S/16's;
4. forward parity: ViT-B/16 ``int8_fused`` with seeded weights, kernel path
   against plain path, in float32 (TF32 off) and bfloat16: logits within a
   relative bound, argmax identical (in bfloat16 on every row whose top-2
   margin exceeds ``ARGMAX_ULPS`` ulps);
5. main path: MemoryBroker -> 2x BrokerSpout -> 4x InferenceBolt -> 2x
   BrokerSink (+ dead-letter sink) serving ViT-B/16 bf16 ``int8_fused``
   through the default engine (pipeline depth 2, one CUDA graph per
   bucket), records decoded and encoded by the native codec: 16 records
   and 1 poison record, every output record byte-identical to the native
   encoding of the engine's direct forward of the batch it was served in;
   the bolt's decode_ms and encode_ms, and the codec against the Python
   reference on the same records, printed, then (information only) the
   path's e2e latency with the Python codec in the bolt and with the
   native one, in turns. The engine's launch tally
   (each replay counts its graph's kernels as its capture recorded them,
   the warm-up's eager forward its own) must be exactly forwards x 73
   w8a16, x 12 flash, x 12 fused norm on the ``*_sm90`` kernels and 0 on
   the first versions; the wrappers' own counters, zeroed just before,
   must show the warm-up's eager launches of those three and none of the
   others; one replay of each graph under ``torch.profiler`` must run the
   kernels its capture recorded;
6. trained checkpoints: the five digits checkpoints exported to
   ``checkpoints_torch/`` (lenet5, its 3-channel twin, resnet20, vit_tiny,
   moe_vit_tiny)
   in the modes bf16, int8, int8_fused and uint8_wire. The three kernels
   at this slice's shapes against their plain versions, and timed; each
   (checkpoint, mode) through ``InferenceEngine`` on the 449 held-out
   rows, in slices of 64 as the JAX reference was taken, its accuracy
   within ``accuracy_harness``'s EPSILON of the JAX engine's and its
   argmax equal on every row whose JAX top-2 margin exceeds 0.02, and its
   forward timed at B = 64; then three streaming passes (lenet5
   int8_fused, vit_tiny bf16, resnet20 uint8_wire) through spout ->
   InferenceBolt -> sink in the harness's ordering-deterministic
   configuration, each held positionally against the engine's direct
   predictions and to the accuracy at the output topic, with the kernels'
   launches per forward held as in phase 5;
7. the split-phase engine: (a) each graph's replay bit-identical to the
   same engine's eager forward (ViT-B/16 at B = 8; lenet5, resnet20 and
   vit_tiny in bf16 and on the uint8 wire at buckets 8 and 32, a scale of
   its own per batch); (b) 64 ViT-B/16 batches dispatched from two threads
   at depth 2, each bit-identical to its own serial forward, the staging
   pool within its limit; (c) information only, in turns (depth 0, 2, 2,
   0): batches a second through ``dispatch``, the substages' medians, the
   card's busy and idle share under the profiler, the forward by replay
   against eager, the graph build's peak bytes; (d) the watchdog at 50 ms
   failing a batch held 200 ms alone, two holds quarantining the engine
   and ``shared_engine`` replacing it, and a lenet5 1/1/1 topology
   swapping the replacement in with every record through after replay;
   (e) a batch larger than ``max_batch`` capturing its own graph once;
8. moe_vit_b16 bf16 ``int8_fused`` (seeded) served as in phase 5, its
   launch tally exactly forwards x 61 w8a16, x 12 flash, x 6 fused norm;
   then on the same engine the kernel path against the plain path, a
   graph replay bit-identical to eager, the forward by replay timed with
   our kernels' share from one profiled replay; 8b: mixer_s16,
   mobilenetv2 and resnet50 at 224x224x3 the same way engine-direct at
   B = 8 (33 w8a16 + 8 fused norms, and 1 w8a16, per forward);
9. longseq_encoder (S = 2048, width 256, 2 heads of 128, bf16
   ``int8_fused``, seeded; phase 3 also holds the flash wrapper at head
   dims 8, 24, 48 and 96 and the fused norm's d = 256 plans against their
   plain versions, and times the three kernels at its shapes): (a)
   engine-direct at B = 8 and 32, launch tally exactly forwards x 26
   w8a16, x 4 flash, x 4 fused norm (a profiled replay of each bucket),
   kernel path against plain path, replays bit-identical to eager, the
   forward by replay with our kernels' share; longseq_tiny (D = 8) the
   same way; (b) served through 2/4/2 with QoS (three lanes, two tenants)
   and continuous batching: every output byte-identical to the native
   encoding of the direct forward of its batch, the poison record
   dead-lettered, per-lane e2e histograms, a batch that merged tasks;
   then the real LoadShedController tripped by the burst (best-effort
   records answered Overloaded and acked, every high record served, none
   lost), then the burst with continuous batching off and on, in turns;
10. observe and swap: (a) the main path of phase 5 with every record
   traced (``tracing.sample_rate=1``), the flight recorder on a file, the
   copy ledger and the profile store attached, the launch counts zeroed
   just before and read just after: every delivered record's trace holds
   ``ingress``, ``execute``, ``queue_wait``, ``device_execute`` and
   ``egress`` in that order of start; the records of a batch share one
   device span linked to exactly their ``queue_wait`` spans, whose
   substages fit in it; each trace lasts the sink's e2e ms, and the e2e
   histogram's exemplar names a stored trace; the flight file holds
   ``batch_formed`` and one ``graph_capture`` per bucket captured; the
   ledger's ``h2d`` bytes are the padded batches' from the shapes; the
   profile store counts the batches dispatched and one build per bucket,
   and nothing regressed against its own snapshot; ``device_trace`` of a
   replay names the three kernels; (b) information only, the same burst
   with tracing and the ledger off, on, on, off; (c) phase 9b's shed turn
   with the flight recorder, the controller held to level 1:
   ``shed_decision`` events with the controller's signals, ``shed_reject``
   events and Overloaded records of the best-effort lane alone, a
   ``qos_shed`` span on each; (d) ``lenet5_rgb_digits`` bf16
   ``int8_fused`` through 1/4/1 in four waves of the 449 held-out rows,
   with a canary swap of task 0 to ``vit_tiny_digits``, the promotion and
   the rollback between them, with ``continuous`` off and on: every output
   the bytes of the direct forward of its batch by the engine that served
   it, none lost or duplicated, the poison record dead-lettered, the
   waves served by lenet5, both, vit_tiny (with ``continuous=True`` the
   ROADMAP C7 check), lenet5, within the transport bound of the model's
   direct forward and on the JAX reference's argmax where it is decided,
   the descriptors of ``component_stats``, the rollback building nothing,
   each engine's launch tally;
11. the binary record plane, ViT-B/16 bf16 ``int8_fused`` through
   ``storm_tpu_torch.main.build_standard_topology`` (2/4/2, ``max_batch``
   8, bucket 8, ``max_wait_ms`` 50) with the topology's ``spout_chunk``,
   ``spout_scheme`` and ``spout_frames``: 64 seeded (1, 224, 224, 3)
   float32 records as Arrow tensor messages (the port's ``encode_tensor``),
   one JSON record of the same shape and one poison (a truncated tensor
   message). (a) raw scheme, chunks of 8 as record frames, frame egress:
   every record's prediction exactly once, each output payload the bytes
   of the rows of one (frame, batch) of the engine's direct forward of
   that batch, the poison dead-lettered, no replay; the ledger's
   ``json_decode`` and ``marshal_decode`` rows at zero bytes for the
   tensor records, ``batch_route`` once per frame, ``sink_encode`` only
   for the dead letter; (b) the same with ``frame_egress=False``: one
   output a record; (c) the same records as JSON, string scheme, chunks
   of 8 as lists; (d) phase 9b's longseq_encoder records as tensor
   messages with its QoS lanes, chunks of 8 in frames, continuous
   batching on (and off, coalesced): every chunk lane-homogeneous, every
   record answered once, none lost. Each turn's launch tally exactly
   forwards x the model's per-forward launches; records/s, e2e p50 per
   record and per output message, the bolt's ``decode_ms`` and the
   decodes' share of the burst, the substages and the ledger's
   amplification printed beside phase 5's JSON turn;
12. the cascade and the Observatory: (a) the three digits tiers
   (vit_tiny_digits -> lenet5_rgb_digits -> resnet20_digits) in float32
   through ``build_standard_topology`` (2/4/2, buckets 8 and 32) at the
   operating point of ``ACCURACY_CASCADE_r09.json`` (max softmax, T =
   1.25, thresholds 0.02 and 0.1) on its 224 served rows (the odd
   held-out rows, one a record) and a poison record: every record answered
   once, the poison dead-lettered, each row served at the tier the
   reference picks from the JAX engine's predictions per tier
   (``reference_predictions.npz``) but for rows within a stated band of a
   threshold (printed apart), the router's counters the reference's up to
   those rows, each output its serving tier's forward of its batch,
   accuracy within 0.005 of the published 0.9955 and of the reference's,
   each tier's launch tally its forwards x its launches per forward; the
   served fractions, records/s, e2e p50 and the tiers' measured cost
   printed; (b) the same in bf16 ``int8_fused`` against the JAX
   ``int8_fused`` predictions; (c) ``qos.degrade_model="lenet5"`` on a
   resnet20_digits flagship, phase 9b's lanes, the shed controller tripped
   by the burst and held at level 1: degraded best-effort records served
   by tier 0, every high-lane record by resnet20, ``shed_degrade`` events,
   no Overloaded answer and none lost; (d) first (information only)
   records/s and e2e p50 of phase 5's main path (64 JSON records + 1
   poison) with the Observatory off, on, on, off; then the Observatory on
   that path, its SLO half the least e2e p50 of phase 5 and of those turns
   and the shed controller reading its burn, wired as storm_tpu's main.py
   wires them: capacity rows for every component and a leader of the
   topology at every step with traffic, the ViT engine's occupancy at its
   ring depth, ``copies_amplification`` the windows' and the windows
   summing to the ledger, fast burn above 0 and every ``shed_decision``
   with ``burn_rate`` above 0, the sentinel silent against the run's own
   profile and one regression per (engine, bucket, stage) cell with
   ``min_samples`` against it at 1/4;
13. the Storm runtime's core and exactly-once delivery on phase 5's path
   (ViT-B/16 bf16 ``int8_fused``, JSON records + 1 poison): (a) through
   ``build_standard_topology`` at 2/4/2, records in rounds, the inference
   bolt rebalanced 4 -> 8 while a round is in flight, then 8 -> 2, the
   spouts deactivated while a round waits in the topic, then activated:
   every record answered once (each output the native encoding of a row of
   the engine's direct forward of a batch it ran), the poison
   dead-lettered, no failed or timed-out tree, no engine built or warmed
   again (the live engines and the graphs unchanged, no eager launch),
   every grown task on the one engine and executing, nothing emitted while
   deactivated, every task alive; then one burst of 256 records (the 80
   distinct ones cycled) at inference parallelism 2, 4, 8, 8, 4, 2 in turn,
   each answered once: records/s, e2e p50, the decodes' share of the wall
   and the card's idle share under the profiler printed; (b) the same path
   with one inference task crashed by the runtime chaos monkey mid-stream
   and a JSON-lines and a callback metrics consumer attached:
   ``executor_restarts`` 1 and one ``executor_restart`` event, every record
   answered at least once (duplicates printed), no engine rebuilt, both
   consumers' snapshots (the last at kill) with ``execute_rate`` and
   ``ack_rate`` above 0; (c) soak_harness.py's audited topology with the
   ViT-B/16 bolt: a ``txn`` spout in chunks of 16 -> 4 inference tasks and
   an echo bolt -> one transactional sink committing the spout's offsets.
   Without faults, (a)'s burst through it and through its at-least-once
   twin (the ``earliest`` policy, the async sink) in turns, each audited:
   the cost of exactly-once in records/s and the predictions' e2e p50,
   beside (a)'s windows at parallelism 4. Then with one inference task
   crashed and one commit failed mid-stream: every record's echo hash
   committed exactly once, the predictions exactly the good records, each a
   row of a forward the engine ran, the offsets at the log ends,
   ``txn_aborts`` and ``txn_commits`` at least 1, one restart; every turn's
   launch tally its forwards x (73, 12, 12);
14. the decode tier and DRPC: (a) char_tiny's decode engine on the card
   against the port's own CPU run of it: 64 seeded sessions (prompts of
   8-40 characters, 48 greedy tokens each, co-batched every step with 16
   classify rows): greedy tokens identical, every step's logits and the
   arena within 1e-5, the classify rows within 1e-5 of ``stateless_logits``;
   (b) the same sessions through ``SessionSpout`` -> 2 ``DecodeBolt``s on
   ``ring_fields_grouping("session_id")`` -> a capture bolt, 16 classify
   rows submitted to the same continuous queue meanwhile: every request
   acked, the tasks' sessions disjoint and both tasks used, each session's
   token indices gapless and its tokens (a)'s, the classify rows the
   view's; tokens/s, TTFT p50 and p99, token p50, rows a step and the
   card's idle share printed; (c) 32 sessions on an arena of 8 blocks, at
   most 8 requests in flight: evictions above 0, every request acked, every
   stream gapless with no token re-emitted;
   (d) a graceful kill mid-generation with the file state backend and the
   same topology again: every live session restored ``"kv"``, none cold,
   the streams gapless and free of duplicates, ``kv_migrate`` rows in the
   copy ledger; ``decode_stats`` in the Observatory's snapshot; (e)
   ``drpc_inference_topology`` with ViT-B/16 bf16 ``int8_fused`` (2
   inference tasks, bucket 8): 64 concurrent calls, each answer a row of
   the engine's direct forward of a batch it ran, one poison call failed
   with the schema error and not a timeout, the launch tally exactly
   forwards x (73, 12, 12); call p50 and p99 printed. The decode tier runs
   plain torch ops: no kernel of ours, as storm_tpu's decode calls no
   Pallas kernel;
15. training on the card: (a) ViT-B/16 at full width in float32 (TF32
   off), seeded, one seeded batch of 8, three AdamW steps through
   ``parallel.train.make_train_step``, once with the kernels and once with
   the plain versions (``plain_kernels``): each step's loss within 1e-4
   relative, step 1's gradients within 1e-4 by the global norm of their
   difference, every leaf with a gradient and every one but the attention
   key biases (zero in exact arithmetic) a nonzero one, the wrappers'
   launches exactly 12 fused norms and 12 f32 flash attentions a step on
   the kernel path and none on the plain one; step ms (and the median of
   5 more steps) and peak bytes printed, and the two kernels timed in
   float32 over one step's forward's worth of calls against their plain
   versions and one library call; (b) lenet5, resnet20, vit_tiny and
   moe_vit_tiny trained to convergence by ``data.train_to_convergence``
   with accuracy_harness.py's settings (seed 0, at most 60 epochs, batch
   128, lr 1e-3, patience 8) from storm_tpu's own initial parameters
   (``checkpoints_torch/<model>_init.npz``): each snapshot's held-out accuracy on the 449 rows within
   0.02 of ``ACCURACY_r04.json``'s ``acc_float_device``; epochs, the best
   epoch and wall seconds printed; (c) (b)'s resnet20 written with
   ``save_checkpoint`` and served back in float32 through spout ->
   InferenceBolt -> sink with a dead-letter sink (the 449 rows and one
   poison record): every output a row of the engine's direct forward of a
   batch it ran, each row answered once, the poison dead-lettered, the
   accuracy at the output topic (b)'s within one row. Training runs
   eagerly: no CUDA graph, no ``torch.compile``;
16. the ``{"kernels": [...]}`` line, then the card line, then the last line
   ``{"ok": true, "device": {...}}``.

Needs a CUDA card (exits 2 without one) and the repository beside it
(exits 3 without ``storm_tpu_torch``).
"""

from __future__ import annotations

import asyncio
import contextlib
import json
import math
import os
import subprocess
import sys
import time
import traceback
from unittest import mock

import numpy as np

# Published peaks of one H100 SXM (NVIDIA data sheet, dense, at 700 W):
# the bounds are stated against these, beside the card's power limit.
PEAK_BYTES_S = 3.35e12
PEAK_BF16_FLOPS = 989e12
PEAK_F32_FLOPS = 67e12  # outside the tensor cores

B = 8  # ViT-B/16 batch of the timed shapes and of the main path's bucket
SEQ, DIM, HEADS, HDIM, MLP, CLASSES, DEPTH = 197, 768, 12, 64, 3072, 1000, 12
M = B * SEQ
# Mixer-S/16 at 224x224: 196 tokens of width 512, token MLP 256, depth 8.
MIXER_TOKENS, MIXER_DIM, MIXER_TOKEN_MLP, MIXER_DEPTH = 196, 512, 256, 8
# bf16 forward parity: rows whose plain-path top-2 margin exceeds this many
# bf16 ulps of the largest |logit| must keep their argmax.
ARGMAX_ULPS = 4


def log(*a) -> None:
    print(*a, flush=True)


def nvidia_smi() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60)
    return out.stdout.strip().splitlines()[0] if out.stdout.strip() else "unknown"


def numeric_flags(torch) -> dict:
    return {"cuda.matmul.allow_tf32": torch.backends.cuda.matmul.allow_tf32,
            "cudnn.allow_tf32": torch.backends.cudnn.allow_tf32,
            "cuda.matmul.allow_bf16_reduced_precision_reduction":
                torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction}


def assert_numeric_flags(torch, when: str) -> None:
    """The arithmetic the gates hold is the package's own: every entry
    point, resolving the card, turns TF32 and bf16 reduced-precision
    reductions off (``storm_tpu_torch.device.set_numeric_flags``); this
    script never sets them."""
    flags = numeric_flags(torch)
    if any(flags.values()):
        raise AssertionError(f"{when}: numeric flags {flags}, the package must turn "
                             f"all three off")
    log(f"  numeric flags {when}: all off {sorted(flags)}")


def rel_err(got, want) -> float:
    d = (got.float() - want.float()).abs().max().item()
    scale = want.float().abs().max().item()
    return d / scale if scale else d


def abs_err(got, want) -> float:
    return (got.float() - want.float()).abs().max().item()


def check(rows: list, kernel: str, case: str, err: float, tol: float,
          metric: str) -> None:
    ok = err <= tol
    rows.append({"kernel": kernel, "case": case, "metric": metric,
                 "err": err, "tol": tol, "pass": ok})
    log(f"  parity {kernel:20s} {case:34s} {metric} {err:.3e} <= {tol:.0e} "
        f"{'ok' if ok else 'FAIL'}")


def time_ms(torch, fn, reps: int = 20) -> float:
    """Device ms of one ``fn()``: warmed up on a side stream, captured once
    in a CUDA graph and replayed ``reps`` times between CUDA events, so the
    host's per-launch overhead stays out of the number."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        fn()
    graph.replay()
    torch.cuda.synchronize()
    t0 = torch.cuda.Event(enable_timing=True)
    t1 = torch.cuda.Event(enable_timing=True)
    t0.record()
    for _ in range(reps):
        graph.replay()
    t1.record()
    torch.cuda.synchronize()
    ms = t0.elapsed_time(t1) / reps
    del graph
    return ms


def eager_ms(torch, fn, reps: int = 5) -> float:
    """Wall ms of one eager ``fn()`` ending in a synchronize: what a caller
    sees, host launch overhead included."""
    fn()
    torch.cuda.synchronize()
    t = time.perf_counter()
    for _ in range(reps):
        fn()
    torch.cuda.synchronize()
    return (time.perf_counter() - t) * 1e3 / reps


@contextlib.contextmanager
def plain_kernels():
    """Route the three kernel wrappers to their plain versions (CUDA
    tensors included) at the points where the model calls them: the
    reference side of the forward-parity phase, and nothing else."""
    from storm_tpu_torch.ops import attention, fused_norm, quant_matmul
    from storm_tpu_torch.ops.flash_attention import flash_attention_reference

    def norm_plain(x2, r2, g, b, eps=1e-6, variant=None):
        return fused_norm.fused_add_layernorm_reference(x2, r2, g, b, eps)

    with contextlib.ExitStack() as st:
        st.enter_context(mock.patch.object(
            quant_matmul, "w8a16_matmul", quant_matmul.w8a16_matmul_reference))
        st.enter_context(mock.patch.object(fused_norm, "fused_add_layernorm", norm_plain))
        st.enter_context(mock.patch.object(
            attention, "flash_attention", flash_attention_reference))
        yield


# ---- phase 3: kernels -------------------------------------------------------


def parity_cases(torch, rows: list) -> dict:
    """parity_checks.py's cases and tolerances, the same ragged shapes in
    bf16, then the ViT-B/16 shapes. Each case also checks which variant of
    the kernel it launched: w8a16 and flash f32 cases the f32 kernels, bf16
    cases the tensor-core (sm90) kernels; every fused norm case the sm90
    kernel. Returns max |kernel - plain| per kernel variant at the ViT-B/16
    shapes (the first versions run there on the same bf16 inputs by naming
    them)."""
    from storm_tpu_torch.ops import _build
    from storm_tpu_torch.ops.flash_attention import (
        flash_attention, flash_attention_reference)
    from storm_tpu_torch.ops.fused_norm import (
        fused_add_layernorm, fused_add_layernorm_reference, norm_plan)
    from storm_tpu_torch.ops.quant_matmul import w8a16_matmul, w8a16_matmul_reference

    g = torch.Generator(device="cuda").manual_seed(0)
    f32, bf16 = torch.float32, torch.bfloat16

    def randn(*shape, dtype=f32):
        return torch.randn(*shape, device="cuda", generator=g).to(dtype)

    def quantized(k, n):
        w = torch.randn(k, n, device="cuda", generator=g)
        s = (w.abs().amax(dim=0) / 127.0).clamp_min(1e-12)
        q = torch.clamp(torch.round(w / s), -127, 127).to(torch.int8)
        return q, s

    def launched(fn, variant):
        """fn(), holding that it launched ``variant`` and nothing else."""
        before = _build.launch_counts()
        out = fn()
        diff = {k: v - before[k] for k, v in _build.launch_counts().items() if v != before[k]}
        if diff != {variant: 1}:
            raise AssertionError(f"expected one launch of {variant}, got {diff}")
        return out

    # Flash attention. The reference sees the same (possibly bf16-rounded)
    # inputs upcast to f32; the f32 tolerance is parity_checks' @highest
    # bound (the f32 kernel multiplies in full f32), bf16 allows one output
    # rounding step.
    for case, shape, dt in [("S2048", (1, 2, 2048, 64), f32),
                            ("S2048_bf16", (1, 2, 2048, 64), bf16),
                            ("S4096_multiblock", (1, 1, 4096, 128), f32),
                            ("S600_padded", (1, 1, 600, 64), f32),
                            ("S600_padded_bf16", (1, 1, 600, 64), bf16),
                            ("S197_D16_bf16", (2, 2, 197, 16), bf16),
                            ("S100_D32_bf16", (1, 2, 100, 32), bf16),
                            ("S4096_D128_bf16", (1, 1, 4096, 128), bf16)]:
        q, k, v = randn(*shape, dtype=dt), randn(*shape, dtype=dt), randn(*shape, dtype=dt)
        want = flash_attention_reference(q.float(), k.float(), v.float())
        variant = "flash_attention_sm90" if dt == bf16 else "flash_attention"
        got = launched(lambda: flash_attention(q, k, v), variant)
        check(rows, variant, case, rel_err(got, want), 1e-2 if dt == bf16 else 1e-5, "rel")
    # Fused residual + LayerNorm, every case on the sm90 kernel: f32
    # (absolute, both outputs), bf16 at each width with a plan of its own
    # (64, 512, 768) and a ragged one (100, element loads), an offset view
    # (element loads at 768) and bf16 g and b as the model passes them
    # (bf16: one rounding step of the output, relative).
    norm = "residual_layernorm_sm90"

    def norm_case(case, x, r, gg, bb, tol_y, tol_o, metric):
        wy, wo = fused_add_layernorm_reference(x, r, gg, bb, 1e-6)
        y, o = launched(lambda: fused_add_layernorm(x, r, gg, bb), norm)
        err = abs_err if metric == "abs" else rel_err
        check(rows, norm + ".y", case, err(y, wy), tol_y, metric)
        check(rows, norm + ".ln", case, err(o, wo), tol_o, metric)

    for rows_n, d in [(6, 64), (300, 100), (1024, 768)]:
        norm_case(f"{rows_n}x{d}", randn(rows_n, d), randn(rows_n, d), randn(d), randn(d),
                  1e-5, 1e-4, "abs")
    for rows_n, d in [(6, 64), (300, 100), (40, 512), (MIXER_TOKENS * B, MIXER_DIM),
                      (1024, 768)]:
        norm_case(f"{rows_n}x{d}_bf16", randn(rows_n, d, dtype=bf16),
                  randn(rows_n, d, dtype=bf16), randn(d), randn(d), 1e-2, 1e-2, "rel")
    x = randn(300 * 768 + 1, dtype=bf16)[1:].view(300, 768)
    r = randn(300, 768, dtype=bf16)
    if norm_plan(768, bf16, x.data_ptr(), r.data_ptr())[2] != 0:
        raise AssertionError("an offset view must take the element load mode")
    norm_case("300x768_bf16_offset_view", x, r, randn(768), randn(768), 1e-2, 1e-2, "rel")
    norm_case("1024x768_bf16_bf16_g_b", randn(1024, 768, dtype=bf16),
              randn(1024, 768, dtype=bf16), randn(768, dtype=bf16),
              randn(768, dtype=bf16), 1e-2, 1e-2, "rel")
    # w8a16: ragged M, N, K, the multi-tile K loop, 3-D tokens; each shape
    # in f32 (the f32 kernel) and in bf16 (the tensor-core kernel, whose
    # element, 8-byte and 16-byte load modes these shapes cover).
    for case, xshape, k, n in [
            ("4x64@64x128", (4, 64), 64, 128),
            ("5x100@100x70_padded", (5, 100), 100, 70),
            ("2x9x48@48x200_tokens", (2, 9, 48), 48, 200),
            ("1x700@700x10_multichunk", (1, 700), 700, 10),
            ("64x768@768x3072", (64, 768), 768, 3072),
            # beyond parity_checks: many tiles with unaligned loads
            ("2100x100@100x4100_bigtile", (2100, 100), 100, 4100),
            # the mixers' token MLPs: K or N the token count (element loads)
            ("mixer_s16_token_fc1 4096x196@196x256", (B * MIXER_DIM, 196), 196, 256),
            ("mixer_s16_token_fc2 4096x256@256x196", (B * MIXER_DIM, 256), 256, 196),
            ("mixer_tiny_token_fc1 512x64@64x32", (8 * 64, 64), 64, 32)]:
        for dt in (f32, bf16):
            x = randn(*xshape, dtype=dt)
            q, s = quantized(k, n)
            want = w8a16_matmul_reference(x.float(), q, s)
            variant = "w8a16_matmul_sm90" if dt == bf16 else "w8a16_matmul"
            got = launched(lambda: w8a16_matmul(x, q, s), variant)
            check(rows, variant, case + ("_bf16" if dt == bf16 else ""),
                  rel_err(got, want), 2e-2 if dt == bf16 else 1e-5, "rel")

    # The mixer's token MLP reads a transposed, non-contiguous activation:
    # the wrapper copies it once, then launches.
    xt = randn(B, MIXER_TOKENS, MIXER_DIM, dtype=bf16).transpose(1, 2)
    q, s = quantized(MIXER_TOKENS, 256)
    got = launched(lambda: w8a16_matmul(xt, q, s), "w8a16_matmul_sm90")
    check(rows, "w8a16_matmul_sm90", "mixer_s16 token fc1, transposed view",
          rel_err(got, w8a16_matmul_reference(xt.contiguous().float(), q, s)), 2e-2, "rel")

    # The ViT-B/16 shapes (bf16, batch 8), each variant against the plain
    # version on the same bf16 inputs; bf16 tolerances: one rounding step
    # of the output.
    errs = {}
    mm = {"w8a16_matmul_sm90": [], "w8a16_matmul": []}
    for name, (m, k, n) in [("qkvo", (M, DIM, DIM)), ("mlp_in", (M, DIM, MLP)),
                            ("mlp_out", (M, MLP, DIM)), ("head", (B, DIM, CLASSES))]:
        x = randn(m, k, dtype=bf16)
        q, s = quantized(k, n)
        want = w8a16_matmul_reference(x, q, s)
        for variant in mm:
            got = launched(lambda: w8a16_matmul(x, q, s, variant=variant), variant)
            check(rows, variant, f"vit_b16 {name} {m}x{k}@{k}x{n}",
                  rel_err(got, want), 2e-2, "rel")
            mm[variant].append(abs_err(got, want))
    errs.update({v: max(e) for v, e in mm.items()})
    x, r, gg, bb = randn(M, DIM, dtype=bf16), randn(M, DIM, dtype=bf16), randn(DIM), randn(DIM)
    wy, wo = fused_add_layernorm_reference(x, r, gg, bb, 1e-6)
    for variant in ("residual_layernorm_sm90", "residual_layernorm"):
        y, o = launched(lambda: fused_add_layernorm(x, r, gg, bb, variant=variant), variant)
        check(rows, variant + ".y", f"vit_b16 {M}x{DIM} bf16", rel_err(y, wy), 1e-2, "rel")
        check(rows, variant + ".ln", f"vit_b16 {M}x{DIM} bf16", rel_err(o, wo), 1e-2, "rel")
        errs[variant] = max(abs_err(y, wy), abs_err(o, wo))
    q, k, v = (randn(B, HEADS, SEQ, HDIM, dtype=bf16) for _ in range(3))
    want = flash_attention_reference(q, k, v)
    for variant in ("flash_attention_sm90", "flash_attention"):
        got = launched(lambda: flash_attention(q, k, v, variant=variant), variant)
        check(rows, variant, f"vit_b16 {B}x{HEADS}x{SEQ}x{HDIM} bf16",
              rel_err(got, want), 1e-2, "rel")
        errs[variant] = abs_err(got, want)
    torch.cuda.synchronize()
    return errs


def bound_ms(nbytes: float, flops: float, peak_flops: float) -> tuple:
    tb, tf = nbytes / PEAK_BYTES_S * 1e3, flops / peak_flops * 1e3
    return (tb, "bytes") if tb >= tf else (tf, "operations")


def time_kernels(torch) -> dict:
    """Kernel, plain version and one-call PyTorch yardstick over one
    ViT-B/16 forward's worth of calls (batch 8, bf16), each layer with
    its own tensors so the weights stream from device memory as in the
    model (85 MB of int8 weights exceed the 50 MB L2)."""
    import torch.nn.functional as F

    from storm_tpu_torch.ops.flash_attention import (
        flash_attention, flash_attention_reference)
    from storm_tpu_torch.ops.fused_norm import (
        fused_add_layernorm, fused_add_layernorm_reference)
    from storm_tpu_torch.ops.quant_matmul import w8a16_matmul, w8a16_matmul_reference

    g = torch.Generator(device="cuda").manual_seed(1)
    bf16 = torch.bfloat16

    def randn(*shape, dtype=bf16):
        return torch.randn(*shape, device="cuda", generator=g).to(dtype)

    out = {}
    # w8a16: 4 projections + mlp_in + mlp_out per layer, and the head.
    shapes = [(M, DIM, DIM)] * 4 + [(M, DIM, MLP), (M, MLP, DIM)]
    calls = []
    xs = {DIM: randn(M, DIM), MLP: randn(M, MLP)}
    for _ in range(DEPTH):
        for m, k, n in shapes:
            q = torch.randint(-127, 128, (k, n), device="cuda", generator=g,
                              dtype=torch.int8)
            calls.append((xs[k], q, torch.rand(n, device="cuda", generator=g) * 1e-2))
    calls.append((randn(B, DIM), torch.randint(-127, 128, (DIM, CLASSES), device="cuda",
                                               generator=g, dtype=torch.int8),
                  torch.rand(CLASSES, device="cuda", generator=g) * 1e-2))
    wdq = [q.to(bf16) for _, q, _ in calls]  # yardstick: dequantized in advance
    nbytes = flops = 0.0
    bms = 0.0
    for x, q, s in calls:
        m, k = x.shape
        n = q.shape[1]
        b_ = m * k * 2 + k * n + n * 4 + m * n * 2
        f_ = 2.0 * m * n * k
        bms += max(b_ / PEAK_BYTES_S, f_ / PEAK_BF16_FLOPS) * 1e3
        nbytes += b_
        flops += f_
    # The tensor-core variant is what the wrapper picks for bf16; the f32
    # variant (the first version) runs the same bf16 calls by name.
    common = {
        "plain_ms": time_ms(torch, lambda: [w8a16_matmul_reference(*c) for c in calls]),
        "library_ms": time_ms(torch, lambda: [torch.matmul(c[0], w) * c[2]
                                             for c, w in zip(calls, wdq)]),
        "bound_ms": bms, "bound_by": bound_ms(nbytes, flops, PEAK_BF16_FLOPS)[1],
        "calls": len(calls)}
    for variant in ("w8a16_matmul_sm90", "w8a16_matmul"):
        out[variant] = {
            "ms": time_ms(torch, lambda: [w8a16_matmul(*c, variant=variant) for c in calls]),
            "eager_ms": eager_ms(torch, lambda: [w8a16_matmul(*c, variant=variant)
                                                 for c in calls]),
            **common}

    # Fused norm: one (B*197, 768) call per layer, with f32 g and b, and
    # as the model makes it, with bf16 g and b (model_ms, model_eager_ms:
    # the first version's wrapper casts those to f32 first, the sm90 kernel
    # reads them as they are).
    ncalls = [(randn(M, DIM), randn(M, DIM), torch.randn(DIM, device="cuda", generator=g),
               torch.randn(DIM, device="cuda", generator=g)) for _ in range(DEPTH)]
    # F.layer_norm takes its weight and bias in the input's dtype.
    lcalls = [(x, r, w.to(bf16), b.to(bf16)) for x, r, w, b in ncalls]
    b_ = 4 * M * DIM * 2 + 2 * DIM * 4
    f_ = 10.0 * M * DIM
    bm, by = bound_ms(b_, f_, PEAK_F32_FLOPS)
    common = {
        "plain_ms": time_ms(torch, lambda: [fused_add_layernorm_reference(*c, 1e-6)
                                           for c in ncalls]),
        # Two calls (the add, then the norm): PyTorch has no fused one.
        "library_ms": time_ms(torch, lambda: [F.layer_norm(x + r, (DIM,), w, b, 1e-6)
                                             for x, r, w, b in lcalls]),
        "bound_ms": bm * DEPTH, "bound_by": by, "calls": DEPTH}
    for variant in ("residual_layernorm_sm90", "residual_layernorm"):
        out[variant] = {
            "ms": time_ms(torch, lambda: [fused_add_layernorm(*c, variant=variant)
                                          for c in ncalls]),
            "eager_ms": eager_ms(torch, lambda: [fused_add_layernorm(*c, variant=variant)
                                                 for c in ncalls]),
            "model_ms": time_ms(torch, lambda: [fused_add_layernorm(*c, variant=variant)
                                                for c in lcalls]),
            "model_eager_ms": eager_ms(torch, lambda: [fused_add_layernorm(*c, variant=variant)
                                                       for c in lcalls]),
            **common}

    # Flash attention: one (8, 12, 197, 64) call per layer.
    acalls = [tuple(randn(B, HEADS, SEQ, HDIM) for _ in range(3)) for _ in range(DEPTH)]
    b_ = 4 * B * HEADS * SEQ * HDIM * 2
    f_ = 4.0 * B * HEADS * SEQ * SEQ * HDIM
    bm, by = bound_ms(b_, f_, PEAK_BF16_FLOPS)
    common = {
        "plain_ms": time_ms(torch, lambda: [flash_attention_reference(*c) for c in acalls]),
        "library_ms": time_ms(torch, lambda: [F.scaled_dot_product_attention(*c)
                                             for c in acalls]),
        "bound_ms": bm * DEPTH, "bound_by": by, "calls": DEPTH}
    for variant in ("flash_attention_sm90", "flash_attention"):
        out[variant] = {
            "ms": time_ms(torch, lambda: [flash_attention(*c, variant=variant)
                                          for c in acalls]),
            "eager_ms": eager_ms(torch, lambda: [flash_attention(*c, variant=variant)
                                                 for c in acalls]),
            **common}
    torch.cuda.synchronize()
    for name, t in out.items():
        log(f"  time {name:21s} per forward ({t['calls']} calls, CUDA graph): kernel "
            f"{t['ms']:.4f} ms, plain {t['plain_ms']:.4f} ms, library "
            f"{t['library_ms']:.4f} ms, bound {t['bound_ms']:.4f} ms ({t['bound_by']}); "
            f"kernel eager, host included {t['eager_ms']:.4f} ms")
        if "model_ms" in t:
            log(f"  time {name:21s} with bf16 g and b, as the model calls it: kernel "
                f"{t['model_ms']:.4f} ms (CUDA graph), {t['model_eager_ms']:.4f} ms eager")
    return out


def mixer_times(torch) -> dict:
    """The kernels at Mixer-S/16's shapes (bf16, B = 8), one forward's
    worth of calls each: w8a16 over the 8 token MLPs (M = 8 x 512 = 4096;
    fc1 K = 196, N = 256; fc2 K = 256, N = 196: element loads) and the
    fused norm over the 8 token-mixing residuals (1568 x 512, bf16 g and
    b), against the plain version and the one-call library yardstick."""
    import torch.nn.functional as F

    from storm_tpu_torch.ops.fused_norm import (
        fused_add_layernorm, fused_add_layernorm_reference)
    from storm_tpu_torch.ops.quant_matmul import w8a16_matmul, w8a16_matmul_reference

    g = torch.Generator(device="cuda").manual_seed(5)
    bf16 = torch.bfloat16

    def randn(*shape, dtype=bf16):
        return torch.randn(*shape, device="cuda", generator=g).to(dtype)

    m = B * MIXER_DIM
    calls = []
    for _ in range(MIXER_DEPTH):
        for k, n in ((MIXER_TOKENS, MIXER_TOKEN_MLP), (MIXER_TOKEN_MLP, MIXER_TOKENS)):
            calls.append((randn(m, k), torch.randint(-127, 128, (k, n), device="cuda",
                                                     generator=g, dtype=torch.int8),
                          torch.rand(n, device="cuda", generator=g) * 1e-2))
    wdq = [q.to(bf16) for _, q, _ in calls]
    bm, by = calls_bound([(tensor_bytes(x, q, s) + x.shape[0] * q.shape[1] * 2,
                           2.0 * x.shape[0] * q.shape[0] * q.shape[1]) for x, q, s in calls],
                         PEAK_BF16_FLOPS)
    out = {"w8a16_matmul_sm90": {
        "shapes": "mixer_s16 B=8 token MLP: 8 x (4096x196@196x256, 4096x256@256x196)",
        "ms": time_ms(torch, lambda: [w8a16_matmul(*c) for c in calls]),
        "plain_ms": time_ms(torch, lambda: [w8a16_matmul_reference(*c) for c in calls]),
        "library_ms": time_ms(torch, lambda: [torch.matmul(c[0], w) * c[2]
                                             for c, w in zip(calls, wdq)]),
        "bound_ms": bm, "bound_by": by, "calls": len(calls)}}
    rows_n = B * MIXER_TOKENS
    norms = [(randn(rows_n, MIXER_DIM), randn(rows_n, MIXER_DIM), randn(MIXER_DIM),
              randn(MIXER_DIM)) for _ in range(MIXER_DEPTH)]
    bm, by = calls_bound([(tensor_bytes(x, r, gg, bb, x, x), 10.0 * x.numel())
                          for x, r, gg, bb in norms], PEAK_F32_FLOPS)
    out["residual_layernorm_sm90"] = {
        "shapes": f"mixer_s16 B=8: 8 x ({rows_n}, {MIXER_DIM}), bf16 g and b",
        "ms": time_ms(torch, lambda: [fused_add_layernorm(*c) for c in norms]),
        "plain_ms": time_ms(torch, lambda: [fused_add_layernorm_reference(*c, 1e-6)
                                           for c in norms]),
        "library_ms": time_ms(torch, lambda: [F.layer_norm(x + r, (MIXER_DIM,), w, b, 1e-6)
                                             for x, r, w, b in norms]),
        "bound_ms": bm, "bound_by": by, "calls": len(norms)}
    torch.cuda.synchronize()
    for name, t in out.items():
        log(f"  time {name:21s} per forward at {t['shapes']} ({t['calls']} calls, CUDA "
            f"graph): kernel {t['ms']:.4f} ms, plain {t['plain_ms']:.4f} ms, library "
            f"{t['library_ms']:.4f} ms, bound {t['bound_ms']:.4f} ms ({t['bound_by']})")
    return out


# longseq_encoder (phase 3's timing at its shapes, phase 9): S = 2048
# sequences of 64 features, width 256, 2 heads of 128, depth 4, MLP 1024,
# 10 classes; batch policy max_batch 32, buckets (8, 32).
LS_SEQ, LS_FEAT, LS_DIM, LS_HEADS, LS_DEPTH, LS_MLP, LS_CLASSES = 2048, 64, 256, 2, 4, 1024, 10
LS_HDIM = LS_DIM // LS_HEADS
# Launches per forward (bf16 int8_fused), from the code: each of the 4
# blocks runs 6 w8a16 dense layers (q, k, v, o, mlp_in, mlp_out), one flash
# attention and one fused norm; the embedding and the head one w8a16 each.
# longseq_tiny: 2 blocks of the same, at width 32 (4 heads of D = 8).
LS_LAUNCHES = {"w8a16_matmul_sm90": 26, "flash_attention_sm90": 4,
               "residual_layernorm_sm90": 4}
LS_TINY_LAUNCHES = {"w8a16_matmul_sm90": 14, "flash_attention_sm90": 2,
                    "residual_layernorm_sm90": 2}


def longseq_kernel_cases(torch, rows: list) -> None:
    """The flash wrapper at head dims the kernels are not built for (D =
    8, 24, 48, 96: zero-padded to the next one, the true D's scale, sliced
    back; storm_tpu's kernel takes every D up to 128), in bf16 and f32,
    and the fused norm's d = 256 plans, each against its plain version.
    D > 128 must raise."""
    from storm_tpu_torch.ops import _build
    from storm_tpu_torch.ops.flash_attention import (
        flash_attention, flash_attention_reference)
    from storm_tpu_torch.ops.fused_norm import (
        NORM_PLANS, fused_add_layernorm, fused_add_layernorm_reference, norm_plan)

    g = torch.Generator(device="cuda").manual_seed(3)
    f32, bf16 = torch.float32, torch.bfloat16

    def randn(*shape, dtype=f32):
        return torch.randn(*shape, device="cuda", generator=g).to(dtype)

    def launched(fn, variant):
        before = _build.launch_counts()
        out = fn()
        diff = {k: v - before[k] for k, v in _build.launch_counts().items() if v != before[k]}
        if diff != {variant: 1}:
            raise AssertionError(f"expected one launch of {variant}, got {diff}")
        return out

    for d in (8, 24, 48, 96):
        for dt in (bf16, f32):
            shape = (2, 2, 300, d)
            q, k, v = (randn(*shape, dtype=dt) for _ in range(3))
            want = flash_attention_reference(q.float(), k.float(), v.float())
            variant = "flash_attention_sm90" if dt == bf16 else "flash_attention"
            got = launched(lambda: flash_attention(q, k, v), variant)
            if got.shape != shape:
                raise AssertionError(f"flash at D = {d}: output {tuple(got.shape)}")
            check(rows, variant, f"2x2x300x{d}_padded" + ("_bf16" if dt == bf16 else ""),
                  rel_err(got, want), 1e-2 if dt == bf16 else 1e-5, "rel")
    t = torch.zeros(1, 1, 8, 160, device="cuda", dtype=bf16)
    try:
        flash_attention(t, t, t)
    except ValueError as e:
        log(f"  flash at D = 160 raises: {e}")
    else:
        raise AssertionError("flash attention at D = 160 must raise")
    norm = "residual_layernorm_sm90"
    m = 8 * LS_SEQ
    for dt, tol, metric in ((bf16, 1e-2, "rel"), (f32, 1e-4, "abs")):
        x, r = randn(m, LS_DIM, dtype=dt), randn(m, LS_DIM, dtype=dt)
        gg, bb = randn(LS_DIM, dtype=dt), randn(LS_DIM, dtype=dt)
        plan = norm_plan(LS_DIM, dt, x.data_ptr(), r.data_ptr())
        if plan[:2] != NORM_PLANS[(dt, LS_DIM)] or plan[2] != 1:
            raise AssertionError(f"d = 256 {dt}: plan {plan}")
        wy, wo = fused_add_layernorm_reference(x, r, gg, bb, 1e-6)
        y, o = launched(lambda: fused_add_layernorm(x, r, gg, bb), norm)
        err = abs_err if metric == "abs" else rel_err
        name = str(dt).replace("torch.", "")
        check(rows, norm + ".y", f"longseq {m}x{LS_DIM} {name} plan {plan[:2]}",
              err(y, wy), 1e-2 if dt == bf16 else 1e-5, metric)
        check(rows, norm + ".ln", f"longseq {m}x{LS_DIM} {name} plan {plan[:2]}",
              err(o, wo), tol, metric)
    torch.cuda.synchronize()


def longseq_times(torch) -> dict:
    """The three kernels over one longseq_encoder forward's worth of calls
    at B = 8 (bf16, CUDA-graph replay): flash attention 4 x (8, 2, 2048,
    128) against ``scaled_dot_product_attention``; w8a16 over the 26 dense
    layers (embed 16384x64@64x256, per block 4 x 16384x256@256x256,
    16384x256@256x1024, 16384x1024@1024x256, head 8x256@256x10) against
    ``matmul`` + scale; the fused norm 4 x (16384, 256), bf16 g and b,
    against add + ``layer_norm``; each beside its plain version and its
    bound. The norm also on the runtime-d plan, for the d = 256 plan's
    gain. Returns kernel name -> times."""
    import torch.nn.functional as F

    from storm_tpu_torch.ops import fused_norm
    from storm_tpu_torch.ops.flash_attention import (
        flash_attention, flash_attention_reference)
    from storm_tpu_torch.ops.quant_matmul import w8a16_matmul, w8a16_matmul_reference

    g = torch.Generator(device="cuda").manual_seed(4)
    bf16 = torch.bfloat16

    def randn(*shape, dtype=bf16):
        return torch.randn(*shape, device="cuda", generator=g).to(dtype)

    def qweight(k, n):
        return (torch.randint(-127, 128, (k, n), device="cuda", generator=g, dtype=torch.int8),
                torch.rand(n, device="cuda", generator=g) * 1e-2)

    m = B * LS_SEQ
    out = {}
    acalls = [tuple(randn(B, LS_HEADS, LS_SEQ, LS_HDIM) for _ in range(3))
              for _ in range(LS_DEPTH)]
    bm, by = calls_bound([(tensor_bytes(q, k, v, q), 4.0 * B * LS_HEADS * LS_SEQ ** 2 * LS_HDIM)
                          for q, k, v in acalls], PEAK_BF16_FLOPS)
    out["flash_attention_sm90"] = {
        "shapes": f"{LS_DEPTH} x ({B}, {LS_HEADS}, {LS_SEQ}, {LS_HDIM})",
        "ms": time_ms(torch, lambda: [flash_attention(*c) for c in acalls]),
        "plain_ms": time_ms(torch, lambda: [flash_attention_reference(*c) for c in acalls]),
        "library_ms": time_ms(torch, lambda: [F.scaled_dot_product_attention(*c)
                                             for c in acalls]),
        "bound_ms": bm, "bound_by": by, "calls": len(acalls)}
    xs = {LS_FEAT: randn(m, LS_FEAT), LS_DIM: randn(m, LS_DIM), LS_MLP: randn(m, LS_MLP)}
    shapes = [(LS_FEAT, LS_DIM)]
    for _ in range(LS_DEPTH):
        shapes += [(LS_DIM, LS_DIM)] * 4 + [(LS_DIM, LS_MLP), (LS_MLP, LS_DIM)]
    mcalls = [(xs[k], *qweight(k, n)) for k, n in shapes]
    mcalls.append((randn(B, LS_DIM), *qweight(LS_DIM, LS_CLASSES)))
    wdq = [q.to(bf16) for _, q, _ in mcalls]
    bm, by = calls_bound([(tensor_bytes(x, q, s) + x.shape[0] * q.shape[1] * 2,
                           2.0 * x.shape[0] * q.shape[0] * q.shape[1]) for x, q, s in mcalls],
                         PEAK_BF16_FLOPS)
    out["w8a16_matmul_sm90"] = {
        "shapes": "embed 16384x64@64x256, 4 x (4 x 16384x256@256x256, 16384x256@256x1024, "
                  "16384x1024@1024x256), head 8x256@256x10",
        "ms": time_ms(torch, lambda: [w8a16_matmul(*c) for c in mcalls]),
        "plain_ms": time_ms(torch, lambda: [w8a16_matmul_reference(*c) for c in mcalls]),
        "library_ms": time_ms(torch, lambda: [torch.matmul(c[0], w) * c[2]
                                             for c, w in zip(mcalls, wdq)]),
        "bound_ms": bm, "bound_by": by, "calls": len(mcalls)}
    norms = [(randn(m, LS_DIM), randn(m, LS_DIM), randn(LS_DIM), randn(LS_DIM))
             for _ in range(LS_DEPTH)]
    bm, by = calls_bound([(tensor_bytes(x, r, gg, bb, x, x), 10.0 * x.numel())
                          for x, r, gg, bb in norms], PEAK_F32_FLOPS)
    vec = fused_norm.VEC[bf16]
    runtime_plan = (32 * max(1, -(-LS_DIM // (32 * fused_norm.RUNTIME_VECTORS[bf16] * vec))),
                    fused_norm.RUNTIME_VECTORS[bf16], 1, 1)
    with mock.patch.object(fused_norm, "norm_plan", lambda *a: runtime_plan):
        runtime_ms = time_ms(torch, lambda: [fused_norm.fused_add_layernorm(*c) for c in norms])
    out["residual_layernorm_sm90"] = {
        "shapes": f"{LS_DEPTH} x ({m}, {LS_DIM}), bf16 g and b, plan "
                  f"{fused_norm.NORM_PLANS[(bf16, LS_DIM)]}",
        "ms": time_ms(torch, lambda: [fused_norm.fused_add_layernorm(*c) for c in norms]),
        "runtime_plan_ms": runtime_ms, "runtime_plan": runtime_plan[:2],
        "plain_ms": time_ms(torch, lambda: [fused_norm.fused_add_layernorm_reference(*c, 1e-6)
                                           for c in norms]),
        "library_ms": time_ms(torch, lambda: [F.layer_norm(x + r, (LS_DIM,), w, b, 1e-6)
                                             for x, r, w, b in norms]),
        "bound_ms": bm, "bound_by": by, "calls": len(norms)}
    torch.cuda.synchronize()
    for name, t in out.items():
        log(f"  time {name:21s} per longseq_encoder forward at B={B}, {t['shapes']} "
            f"({t['calls']} calls, CUDA graph): kernel {t['ms']:.4f} ms, plain "
            f"{t['plain_ms']:.4f} ms, library {t['library_ms']:.4f} ms, bound "
            f"{t['bound_ms']:.4f} ms ({t['bound_by']})")
    t = out["residual_layernorm_sm90"]
    log(f"  time residual_layernorm_sm90 at {m}x{LS_DIM} bf16: d = 256 plan "
        f"{fused_norm.NORM_PLANS[(bf16, LS_DIM)]} {t['ms']:.4f} ms against the runtime-d plan "
        f"{t['runtime_plan']} {t['runtime_plan_ms']:.4f} ms")
    return out


# ---- phase 4: forward parity --------------------------------------------------


def kernel_vs_plain(torch, model, x, tol: float, label: str):
    """``model(x)`` with the kernels against the same forward on their
    plain versions: the logits within ``tol`` of the largest |logit|, and
    the argmax identical. In float32 on every row; in bfloat16 on every
    row whose top-2 margin on the plain path exceeds ARGMAX_ULPS bf16 ulps
    of the batch's largest |logit|: with seeded random weights the top two
    of 1000 logits can lie within one ulp, where the two paths' bf16
    rounding alone may flip them, but a row above the threshold flips only
    if a kernel moves its logits by ARGMAX_ULPS / 2 ulps or more, a fault
    well inside the relative bound. At least one row must be above the
    threshold. Returns (got, want) as float32."""
    with torch.inference_mode():
        got = model(x).float()
        with plain_kernels():
            want = model(x).float()
    torch.cuda.synchronize()
    err = rel_err(got, want)
    agree = got.argmax(-1) == want.argmax(-1)
    top2 = want.topk(2, dim=-1).values
    margin = top2[:, 0] - top2[:, 1]
    if x.dtype == torch.float32:
        gated = torch.ones_like(agree)
    else:
        peak = want.abs().max().item()
        ulp = torch.finfo(torch.bfloat16).eps * 2.0 ** math.floor(math.log2(peak))
        gated = margin > ARGMAX_ULPS * ulp
        log(f"  bf16 argmax gate: top-2 margin > {ARGMAX_ULPS} ulps = "
            f"{ARGMAX_ULPS * ulp:.4f} (max |logit| {peak:.4f})")
    log(f"  forward {label} B={x.shape[0]}: max|dlogit|/max|logit| {err:.3e} (tol "
        f"{tol:.0e}); argmax identical on {int((agree & gated).sum())}/{int(gated.sum())} "
        f"gated rows ({int(agree.sum())}/{x.shape[0]} of all rows)")
    for i in torch.nonzero(~agree).flatten().tolist():
        log(f"    row {i}{' (gated)' if gated[i] else ''}: plain path's top-2 "
            f"margin {margin[i].item():.4f}, max |dlogit| in the row "
            f"{(got[i] - want[i]).abs().max().item():.4f}")
    if not (err <= tol and bool(torch.isfinite(got).all())):
        raise AssertionError(f"forward parity {label}: {err} > {tol}")
    if not bool(gated.any()):
        raise AssertionError(f"forward parity {label}: no row above the argmax gate")
    if not bool(agree[gated].all()):
        raise AssertionError(f"forward parity {label}: argmax differs on a gated row")
    return got, want


def forward_parity(torch) -> dict:
    """ViT-B/16 int8_fused on one batch of 8, kernel path against plain
    path (``kernel_vs_plain``) in float32 (TF32 off) and bfloat16; then
    both paths timed eagerly in bfloat16."""
    from storm_tpu_torch.models import build_model

    x_np = np.random.RandomState(7).rand(B, 224, 224, 3).astype(np.float32)
    fwd_ms = {}
    for dtype, tol in [(torch.float32, 1e-4), (torch.bfloat16, 5e-2)]:
        model = build_model("vit_b16", device="cuda", weights="int8_fused",
                            dtype=dtype, seed=0)
        x = torch.from_numpy(x_np).to(dtype).cuda()
        name = str(dtype).replace("torch.", "")
        kernel_vs_plain(torch, model, x, tol, f"vit_b16 int8_fused {name}")
        if dtype == torch.bfloat16:
            with torch.inference_mode():
                fwd_ms["kernels"] = eager_ms(torch, lambda: model(x))
                with plain_kernels():
                    fwd_ms["plain"] = eager_ms(torch, lambda: model(x))
        del model
    log(f"  forward vit_b16 int8_fused bfloat16 B={B}, eager, host overhead included: "
        f"kernel path {fwd_ms['kernels']:.3f} ms, plain path {fwd_ms['plain']:.3f} ms")
    return fwd_ms


# ---- phase 5: the main path ---------------------------------------------------


async def serve(model_cfg, n_good: int = 16, tracing=None, inspect=None):
    """``model_cfg`` through MemoryBroker -> 2x BrokerSpout -> 4x
    InferenceBolt -> 2x BrokerSink (+ dead-letter sink) on the default
    engine: ``n_good`` seeded 224x224x3 records and one ragged poison
    record. The shared engine's ``dispatch`` is wrapped to keep a copy of
    every batch it is given, so each output can be held to the engine's
    direct forward of the very batch it was served in. ``tracing``: the
    config's TracingConfig; ``inspect(rt)``, called before the topology
    stops, returns the result's ``"inspected"``."""
    from storm_tpu_torch.config import BatchConfig, Config, OffsetsConfig
    from storm_tpu_torch.connectors import BrokerSink, BrokerSpout, MemoryBroker
    from storm_tpu_torch.infer import InferenceBolt
    from storm_tpu_torch.runtime import AsyncLocalCluster, TopologyBuilder

    cfg = Config()
    if tracing is not None:
        cfg.tracing = tracing
    batch_cfg = BatchConfig(max_batch=B, buckets=(B,), max_wait_ms=50.0)
    broker = MemoryBroker(default_partitions=2)
    tb = TopologyBuilder()
    tb.set_spout("kafka-spout", BrokerSpout(
        broker, "input", OffsetsConfig(policy="earliest", max_behind=None)),
        parallelism=cfg.topology.spout_parallelism)
    tb.set_bolt("inference-bolt", InferenceBolt(model_cfg, batch_cfg, device="cuda"),
                parallelism=cfg.topology.inference_parallelism).shuffle_grouping("kafka-spout")
    tb.set_bolt("kafka-bolt", BrokerSink(broker, "output", cfg.sink),
                parallelism=cfg.topology.sink_parallelism).shuffle_grouping("inference-bolt")
    tb.set_bolt("dlq-bolt", BrokerSink(broker, "dead-letter", cfg.sink)) \
        .shuffle_grouping("inference-bolt", stream="dead_letter")

    rng = np.random.RandomState(11)
    inputs = rng.rand(n_good, 224, 224, 3).astype(np.float32)
    payloads = [json.dumps({"instances": inputs[i: i + 1].tolist()}) for i in range(n_good)]

    cluster = AsyncLocalCluster()
    rt = await cluster.submit("chip-smoke", cfg, tb.build())  # builds + warms the engine
    engine = rt.bolt_execs["inference-bolt"][0].bolt.engine
    batches = []
    dispatch = engine.dispatch

    def recording_dispatch(parts):
        batches.append(np.concatenate([np.array(p, copy=True) for p in parts]))
        return dispatch(parts)

    engine.dispatch = recording_dispatch
    t0 = time.perf_counter()
    for i, p in enumerate(payloads):
        broker.produce("input", p)
        if i == n_good // 2:
            broker.produce("input", '{"instances": [[1.0, 2.0], [3.0]]}')  # ragged
    deadline = time.monotonic() + 300
    while broker.topic_size("output") + broker.topic_size("dead-letter") < n_good + 1:
        if time.monotonic() > deadline:
            raise TimeoutError("served path: records did not all come out in 300 s")
        await asyncio.sleep(0.01)
    wall = time.perf_counter() - t0
    await rt.drain(timeout_s=60)
    del engine.dispatch
    snap = rt.metrics.snapshot()
    errors = list(rt.errors)
    outs, dlq = broker.drain_topic("output"), broker.drain_topic("dead-letter")
    inspected = inspect(rt) if inspect is not None else None
    await cluster.shutdown()
    return {"inputs": inputs, "payloads": payloads, "outs": outs, "dlq": dlq, "snap": snap,
            "errors": errors, "wall": wall, "batch_cfg": batch_cfg, "batches": batches,
            "inspected": inspected}


# The CUDA function of each kernel variant, as the profiler names it.
KERNEL_FUNCS = {"w8a16_matmul_sm90": "w8a16_sm90_kernel<", "w8a16_matmul": "w8a16_kernel<",
                "residual_layernorm_sm90": "residual_layernorm_sm90_kernel<",
                "residual_layernorm": "residual_layernorm_kernel<",
                "flash_attention_sm90": "flash_sm90_kernel<", "flash_attention": "flash_kernel<"}


def profiled_kernels(torch, fn) -> tuple:
    """Kernels the card ran in ``fn()`` under ``torch.profiler``: counts by
    variant and of all CUDA kernels, and their device ms alike. The
    profiler can miss the first kernels it records on a stream (one to
    three of a replay's, seen on the card late in this script): ``fn()``
    runs once to warm it, then a spin kernel, then ``fn()`` again, and only
    what the card ran after the spin is counted. A trace that lost the spin
    kernel itself (seen once on the card, in phase 8b) is taken again, up
    to three times."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    for attempt in range(3):
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            fn()
            torch.cuda.synchronize()
            torch.cuda._sleep(100_000)
            torch.cuda.synchronize()
            fn()
            torch.cuda.synchronize()
        kernels = sorted((ev for ev in prof.events() if ev.device_type == DeviceType.CUDA
                          and "Memcpy" not in ev.name and "Memset" not in ev.name),
                         key=lambda ev: ev.time_range.start)
        spins = [i for i, ev in enumerate(kernels) if "spin_kernel" in ev.name]
        if spins:
            break
        log(f"  the profiler recorded no separating spin kernel (trace {attempt + 1} of 3)")
    else:
        raise AssertionError("the profiler recorded no separating spin kernel in 3 traces")
    counts = dict.fromkeys(KERNEL_FUNCS, 0)
    counts["all"] = 0
    ms = dict.fromkeys(counts, 0.0)
    for ev in kernels[spins[-1] + 1:]:
        t = (ev.time_range.end - ev.time_range.start) / 1e3
        for name in ["all"] + [n for n, f in KERNEL_FUNCS.items() if f in ev.name]:
            counts[name] += 1
            ms[name] += t
    return counts, ms


def check_tally(torch, engine, per_forward: dict, wrapper_counts: dict, path: str) -> dict:
    """The engine's launch tally over one served path: every variant
    exactly ``per_forward`` (0 when absent) times the engine's forwards,
    and each kernel of the path launched eagerly by its wrapper during the
    path's warm-up (the other variants 0 times; ``wrapper_counts=None``
    skips this for a path that warms several engines); then one replay of each of
    the engine's graphs under the profiler must show the kernels its
    capture recorded (the tally's unit)."""
    tally, forwards = engine.launch_tally(), engine.forwards
    for name in KERNEL_FUNCS:
        want = per_forward.get(name, 0) * forwards
        if tally.get(name, 0) != want:
            raise AssertionError(f"{path}: {name} tallied {tally.get(name, 0)} launches for "
                                 f"{forwards} forwards (want {want})")
        if wrapper_counts is None:
            continue  # several engines warmed on the path: the caller checks the union
        if (wrapper_counts[name] > 0) != (per_forward.get(name, 0) > 0):
            raise AssertionError(f"{path}: {name} launched {wrapper_counts[name]} times "
                                 f"eagerly by its wrapper")
    for padded in sorted(engine.compiled_batches):
        bucket = engine.graph_for(padded)
        seen, _ = profiled_kernels(torch, bucket.replay)
        recorded = {n: bucket.launches.get(n, 0) for n in KERNEL_FUNCS}
        if {n: seen[n] for n in KERNEL_FUNCS} != recorded:
            raise AssertionError(f"{path}: bucket {padded}'s replay ran {seen}, its capture "
                                 f"recorded {recorded}")
        log(f"  {path}: one replay of bucket {padded} under the profiler ran "
            f"{seen['all']} kernels, ours {({n: c for n, c in seen.items() if c and n != 'all'})}"
            f" = the capture's record")
    return {n: tally.get(n, 0) for n in KERNEL_FUNCS}


def codec_times(payloads: list, preds: np.ndarray) -> dict:
    """Host ms per record of the native codec and of the pure-Python
    reference, in this process: the decode of every served payload, the
    encode of every (1, 1000) prediction (medians)."""
    from storm_tpu_torch.api import schema

    out = {}
    for name, fn, args in (
            ("decode_native_ms", schema.decode_instances, payloads),
            ("decode_python_ms", schema.decode_instances_reference, payloads),
            ("encode_native_ms", schema.encode_predictions, [p[None] for p in preds]),
            ("encode_python_ms", schema.encode_predictions_reference,
             [p[None] for p in preds])):
        ts = []
        for a in args:
            t = time.perf_counter()
            fn(a)
            ts.append((time.perf_counter() - t) * 1e3)
        out[name] = float(np.median(ts))
    return out


def served_path(torch, model_cfg, per_forward: dict, label: str) -> dict:
    """``model_cfg`` through the 2/4/2 topology (``serve``), with the launch
    counts zeroed just before and read just after, then its gates: the
    engine's launch tally exactly forwards x ``per_forward``; 16 finite
    predictions summing to 1 +- 1e-3 and the poison record dead-lettered;
    every output record byte-identical to ``encode_predictions`` (the
    native writer) of the engine's direct forward of the batch it was
    served in; the numeric flags the package set. Prints the e2e latency,
    records/s, the substages and the codec's spans."""
    from storm_tpu_torch.api.schema import decode_predictions
    from storm_tpu_torch.infer.engine import clear_engines, shared_engine
    from storm_tpu_torch.native import format_predictions
    from storm_tpu_torch.ops import _build

    clear_engines()
    _build.reset_launch_counts()
    r = asyncio.run(serve(model_cfg))
    wrapper_counts = _build.launch_counts()
    engine = shared_engine(model_cfg, r["batch_cfg"], device="cuda")
    assert_numeric_flags(torch, f"{label}, engine built")
    forwards = engine.forwards
    launches = check_tally(torch, engine, per_forward, wrapper_counts, label)
    inputs, outs, dlq, snap = r["inputs"], r["outs"], r["dlq"], r["snap"]
    if r["errors"]:
        raise AssertionError(f"{label} reported errors: {r['errors'][:3]}")
    if len(outs) != len(inputs) or len(dlq) != 1:
        raise AssertionError(f"{label}: {len(outs)} predictions, {len(dlq)} dead letters")
    dl = json.loads(dlq[0].value)
    if dl["stage"] != "decode" or snap["inference-bolt"]["dead_lettered"] != 1:
        raise AssertionError(f"dead letter wrong: {dl}")
    preds = np.concatenate([decode_predictions(rec.value).data for rec in outs])
    if preds.shape != (len(inputs), CLASSES) or not np.isfinite(preds).all():
        raise AssertionError(f"predictions shape {preds.shape} or non-finite")
    sums = preds.sum(axis=1)
    if np.abs(sums - 1).max() > 1e-3:
        raise AssertionError(f"probabilities sum to {sums.min()}..{sums.max()}")
    # Each served batch again through the same engine: the records it
    # emitted must be exactly the native writer's bytes of these rows.
    want = []
    direct = []
    for batch in r["batches"]:
        rows = engine.predict(batch)
        direct.append(rows)
        want += [format_predictions(row[None]) for row in rows]
    got = [rec.value.decode() if isinstance(rec.value, bytes) else rec.value for rec in outs]
    if sorted(got) != sorted(want):
        missing = len(set(got) - set(want))
        raise AssertionError(f"{label}: {missing} of {len(got)} output records are not the "
                             f"bytes of the engine's direct forward of their batch")
    direct = np.concatenate(direct)
    match = np.abs(preds[:, None, :] - direct[None, :, :]).max(axis=2).min(axis=1)
    infer = snap["inference-bolt"]
    e2e = snap["kafka-bolt"]["e2e_latency_ms"]
    codec = codec_times(r["payloads"], preds)
    res = {"launches": launches, "forwards": forwards, "e2e_p50_ms": e2e["p50"],
           "e2e_p99_ms": e2e["p99"], "records_per_s": len(inputs) / r["wall"],
           "decode_ms_p50": infer["decode_ms"]["p50"], "encode_ms_p50": infer["encode_ms"]["p50"],
           "batches": [len(b) for b in r["batches"]], **codec}
    log(f"  {label}: {len(outs)} predictions + {len(dlq)} dead letter in "
        f"{len(r['batches'])} batches {res['batches']}, every record byte-identical to the "
        f"native encoding of the engine's direct forward of its batch (max |dp| to it "
        f"{match.max():.1e}); {forwards} forwards (warm-up included: one eager, the rest "
        f"graph replays), launch tally {launches}, eager launches by the wrappers "
        f"{wrapper_counts}")
    log(f"  {label} on {nvidia_smi()}: e2e p50 {e2e['p50']:.3f} ms, p99 "
        f"{e2e['p99']:.3f} ms, {res['records_per_s']:.3f} records/s over {r['wall']:.3f} s; "
        f"batch sizes {infer['batch_size']['mean']:.2f} mean; weights on card "
        f"{engine.param_bytes() / 1e6:.3f} MB")
    sub = {k: infer[k]["p50"] for k in ("h2d_ms", "compute_ms", "d2h_ms")}
    log(f"  {label} substages p50: {sub}; graph build peak "
        f"{engine.graph_pool_bytes / 1e6:.3f} MB")
    log(f"  {label} codec per 150,528-float record: bolt decode_ms p50 "
        f"{res['decode_ms_p50']:.3f}, encode_ms p50 {res['encode_ms_p50']:.4f}; in this "
        f"process, medians over the same records: decode native {codec['decode_native_ms']:.3f}"
        f" ms against the Python reference {codec['decode_python_ms']:.3f} ms, encode "
        f"native {codec['encode_native_ms']:.4f} ms against {codec['encode_python_ms']:.4f} ms")
    res["engine"] = engine
    return res


def codec_turns(model_cfg) -> list:
    """Information only: the main path's e2e latency with the Python
    reference codec in the bolt (the port before the native one) and with
    the native codec, in turns (python, native, native, python), on the
    engine the gated run left warm."""
    from storm_tpu_torch.api import schema
    from storm_tpu_torch.infer import operator

    turns = []
    for codec in ("python", "native", "native", "python"):
        with contextlib.ExitStack() as st:
            if codec == "python":
                st.enter_context(mock.patch.object(
                    operator, "decode_instances", schema.decode_instances_reference))
                st.enter_context(mock.patch.object(
                    operator, "encode_predictions", schema.encode_predictions_reference))
            r = asyncio.run(serve(model_cfg))
        if len(r["outs"]) != len(r["inputs"]) or r["errors"]:
            raise AssertionError(f"codec turn {codec}: {len(r['outs'])} outputs, "
                                 f"errors {r['errors'][:3]}")
        e2e = r["snap"]["kafka-bolt"]["e2e_latency_ms"]
        infer = r["snap"]["inference-bolt"]
        turns.append({"codec": codec, "e2e_p50_ms": e2e["p50"],
                      "records_per_s": len(r["inputs"]) / r["wall"],
                      "decode_ms_p50": infer["decode_ms"]["p50"],
                      "encode_ms_p50": infer["encode_ms"]["p50"]})
        log(f"  codec turn {codec:6s}: e2e p50 {e2e['p50']:.3f} ms, "
            f"{turns[-1]['records_per_s']:.3f} records/s, bolt decode_ms p50 "
            f"{infer['decode_ms']['p50']:.3f}, encode_ms p50 {infer['encode_ms']['p50']:.4f}")
    return turns


def main_path(torch) -> dict:
    res = served_path(torch, vit_b16_config(), {
        "w8a16_matmul_sm90": 73, "residual_layernorm_sm90": 12,
        "flash_attention_sm90": 12}, "main path")
    del res["engine"]
    res["codec_turns"] = codec_turns(vit_b16_config())
    return res


# ---- phase 6: trained checkpoints ------------------------------------------------

# The exported checkpoints; each records its model, input shape and class
# count (ModelConfig.from_checkpoint).
DIGITS = ("lenet5_digits", "lenet5_rgb_digits", "resnet20_digits", "vit_tiny_digits",
          "moe_vit_tiny_digits")
DIGITS_MODES = {"bf16": {}, "int8": {"weights": "int8"},
                "int8_fused": {"weights": "int8_fused"},
                "uint8_wire": {"transfer_dtype": "uint8"}}
# accuracy_harness.py's bounds: |acc - JAX acc| per mode, and the
# transport proof (L-inf per row against the same mode's engine-direct
# predictions; the share of rows within it; the share with equal argmax).
EPSILON = {"bf16": 0.01, "uint8_wire": 0.02, "int8": 0.02, "int8_fused": 0.02}
TRANSPORT_TOL = {"bf16": 0.05, "uint8_wire": 0.15, "int8": 0.05, "int8_fused": 0.05}
MIN_ROW_MATCH, MIN_ARGMAX_AGREE = 0.90, 0.97
MARGIN = 0.02  # JAX top-2 probability margin above which the argmax must agree
SLICE = 64  # the reference's batch: BatchConfig(max_batch=64, buckets=(64,))
# (checkpoint, mode, kernel launches per forward): lenet5's three dense
# layers run w8a16; vit_tiny's 2 blocks run one flash attention and one
# fused residual + LayerNorm each (its other LayerNorms, ln1 and the final
# one, are plain); resnet20 runs no kernel of the port.
STREAMS = [("lenet5_digits", "int8_fused", {"w8a16_matmul_sm90": 3}),
           ("vit_tiny_digits", "bf16", {"flash_attention_sm90": 2,
                                        "residual_layernorm_sm90": 2}),
           ("resnet20_digits", "uint8_wire", {})]


def digits_config(tag: str, mode: str):
    from storm_tpu_torch.config import ModelConfig

    return ModelConfig.from_checkpoint(f"checkpoints/{tag}", dtype="bfloat16",
                                       **DIGITS_MODES[mode])


def tensor_bytes(*tensors) -> int:
    return sum(t.numel() * t.element_size() for t in tensors)


def calls_bound(work: list, peak_flops: float) -> tuple:
    """The bound of a sequence of calls, each given as (bytes, operations):
    the sum of each call's own bound; "bytes" or "operations" by which of
    the two totals takes longer."""
    ms = sum(bound_ms(b, f, peak_flops)[0] for b, f in work)
    return ms, bound_ms(sum(b for b, _ in work), sum(f for _, f in work), peak_flops)[1]


def digits_kernels(torch, rows: list) -> dict:
    """The three kernels at this slice's shapes (bf16, B = 64): w8a16 at
    lenet5's (1024, 120), (120, 84), (84, 10) and vit_tiny's dense shapes,
    flash attention at (64, 4, 17, 16), the fused norm at (17 * 64, 64),
    each against its plain version; then one forward's worth of each
    (lenet5's 3 w8a16 calls, vit_tiny's 2 flash and 2 norm calls) timed
    against the plain version and the library call."""
    import torch.nn.functional as F

    from storm_tpu_torch.ops.flash_attention import (
        flash_attention, flash_attention_reference)
    from storm_tpu_torch.ops.fused_norm import (
        fused_add_layernorm, fused_add_layernorm_reference)
    from storm_tpu_torch.ops.quant_matmul import w8a16_matmul, w8a16_matmul_reference

    g = torch.Generator(device="cuda").manual_seed(6)
    bf16 = torch.bfloat16

    def randn(*shape, dtype=bf16):
        return torch.randn(*shape, device="cuda", generator=g).to(dtype)

    def quantized(k, n):
        w = torch.randn(k, n, device="cuda", generator=g)
        s = (w.abs().amax(dim=0) / 127.0).clamp_min(1e-12)
        return torch.clamp(torch.round(w / s), -127, 127).to(torch.int8), s

    tokens = SLICE * 17
    lenet = [(SLICE, 1024, 120), (SLICE, 120, 84), (SLICE, 84, 10)]
    vit = [(tokens, 64, 64), (tokens, 64, 128), (tokens, 128, 64), (SLICE, 64, 10)]
    mm = [(randn(m, k), *quantized(k, n)) for m, k, n in lenet + vit]
    for (x, q, s), (m, k, n) in zip(mm, lenet + vit):
        got = w8a16_matmul(x, q, s)
        check(rows, "w8a16_matmul_sm90", f"digits {m}x{k}@{k}x{n}_bf16",
              rel_err(got, w8a16_matmul_reference(x, q, s)), 2e-2, "rel")
    att = [tuple(randn(SLICE, 4, 17, 16) for _ in range(3)) for _ in range(2)]
    for q, k, v in att:
        check(rows, "flash_attention_sm90", "digits 64x4x17x16_bf16",
              rel_err(flash_attention(q, k, v), flash_attention_reference(q, k, v)),
              1e-2, "rel")
    norms = [(randn(tokens, 64), randn(tokens, 64), randn(64), randn(64)) for _ in range(2)]
    for x, r, gg, bb in norms:
        y, o = fused_add_layernorm(x, r, gg, bb)
        wy, wo = fused_add_layernorm_reference(x, r, gg, bb, 1e-6)
        check(rows, "residual_layernorm_sm90.y", f"digits {tokens}x64_bf16",
              rel_err(y, wy), 1e-2, "rel")
        check(rows, "residual_layernorm_sm90.ln", f"digits {tokens}x64_bf16",
              rel_err(o, wo), 1e-2, "rel")
    torch.cuda.synchronize()

    out = {}
    calls = mm[:3]  # one lenet5 forward
    # each input read once, the (M, N) bf16 output written once
    bm, by = calls_bound([(tensor_bytes(x, q, s) + x.shape[0] * q.shape[1] * x.element_size(),
                           2.0 * x.shape[0] * q.shape[0] * q.shape[1]) for x, q, s in calls],
                         PEAK_BF16_FLOPS)
    wdq = [q.to(bf16) for _, q, _ in calls]
    out["w8a16_matmul_sm90"] = {
        "shapes": "lenet5 B=64: 64x1024@1024x120, 64x120@120x84, 64x84@84x10",
        "ms": time_ms(torch, lambda: [w8a16_matmul(*c) for c in calls]),
        "plain_ms": time_ms(torch, lambda: [w8a16_matmul_reference(*c) for c in calls]),
        "library_ms": time_ms(torch, lambda: [torch.matmul(c[0], w) * c[2]
                                             for c, w in zip(calls, wdq)]),
        "bound_ms": bm, "bound_by": by, "calls": len(calls)}
    # q, k, v read once, an output of q's size written once
    bm, by = calls_bound([(tensor_bytes(q, k, v, q), 4.0 * q.shape[0] * q.shape[1]
                           * q.shape[2] * k.shape[2] * q.shape[3]) for q, k, v in att],
                         PEAK_BF16_FLOPS)
    out["flash_attention_sm90"] = {
        "shapes": "vit_tiny B=64: 2 x (64, 4, 17, 16)",
        "ms": time_ms(torch, lambda: [flash_attention(*c) for c in att]),
        "plain_ms": time_ms(torch, lambda: [flash_attention_reference(*c) for c in att]),
        "library_ms": time_ms(torch, lambda: [F.scaled_dot_product_attention(*c)
                                             for c in att]),
        "bound_ms": bm, "bound_by": by, "calls": len(att)}
    lnorms = [(x, r, w.to(bf16), b.to(bf16)) for x, r, w, b in norms]
    # x, r, g, b read once in their own dtypes, y and out (x's size) written once
    bm, by = calls_bound([(tensor_bytes(x, r, gg, bb, x, x), 10.0 * x.numel())
                          for x, r, gg, bb in norms], PEAK_F32_FLOPS)
    out["residual_layernorm_sm90"] = {
        "shapes": "vit_tiny B=64: 2 x (1088, 64)",
        "ms": time_ms(torch, lambda: [fused_add_layernorm(*c) for c in norms]),
        "plain_ms": time_ms(torch, lambda: [fused_add_layernorm_reference(*c, 1e-6)
                                           for c in norms]),
        "library_ms": time_ms(torch, lambda: [F.layer_norm(x + r, (64,), w, b, 1e-6)
                                             for x, r, w, b in lnorms]),
        "bound_ms": bm, "bound_by": by, "calls": len(norms)}
    for name, t in out.items():
        log(f"  time {name:21s} per forward at {t['shapes']} ({t['calls']} calls, CUDA "
            f"graph): kernel {t['ms']:.4f} ms, plain {t['plain_ms']:.4f} ms, library "
            f"{t['library_ms']:.4f} ms, bound {t['bound_ms']:.4f} ms ({t['bound_by']})")
    return out


def digits_engine_direct(torch, ref: dict, card: str) -> dict:
    """Every (checkpoint, mode) through InferenceEngine on the card: the
    449 held-out rows in slices of 64 against the JAX engine's recorded
    predictions, gated on accuracy and on argmax where JAX is decided;
    then the forward at B = 64 by CUDA-graph replay (the uint8 wire's
    on-card dequantization included).

    A decided row whose argmax differs is a flip, and fails the cell,
    unless the port's two largest probabilities are exactly equal and
    one of them is JAX's class: such a tie is counted and printed on its
    own, with its rows. The recorded predictions come from XLA on the
    CPU, which keeps fused bf16 intermediates in f32; storm_tpu's forward
    compiled without that excess precision ties such a row exactly as
    the port does (tests/test_torch_cnn.py)."""
    from storm_tpu_torch.config import BatchConfig
    from storm_tpu_torch.data import load_digits_nhwc
    from storm_tpu_torch.infer.engine import InferenceEngine, quantize_wire

    results = {}
    for tag in DIGITS:
        for mode in DIGITS_MODES:
            cfg = digits_config(tag, mode)
            _, _, x, y = load_digits_nhwc(cfg.input_shape)
            eng = InferenceEngine(cfg, BatchConfig(max_batch=SLICE, buckets=(SLICE,)),
                                  device="cuda")
            preds = np.concatenate([eng.predict(x[i:i + SLICE])
                                    for i in range(0, len(x), SLICE)])
            want, want_acc = ref[f"{tag}/{mode}"], float(ref[f"{tag}/{mode}/acc"])
            acc = float((preds.argmax(-1) == y).mean())
            top2 = np.sort(want, axis=-1)[:, -2:]
            decided = top2[:, 1] - top2[:, 0] > MARGIN
            agree = preds.argmax(-1) == want.argmax(-1)
            tied = preds[np.arange(len(y)), want.argmax(-1)] == preds.max(-1)
            ties = np.flatnonzero(~agree & tied & decided)
            flips = int((~agree & ~tied & decided).sum())
            others = int((~agree & ~decided).sum())
            dp = float(np.abs(preds - want).max())
            xd = torch.from_numpy(np.ascontiguousarray(x[:SLICE])).cuda()
            with torch.inference_mode():
                if eng.wire_uint8:
                    xq, scale, lo = quantize_wire(x[:SLICE])
                    xq = torch.from_numpy(xq).cuda()
                    ms = time_ms(torch, lambda: eng.model(
                        (xq.float() * float(scale) + float(lo)).to(eng.dtype)))
                else:
                    xd = xd.to(eng.dtype)
                    ms = time_ms(torch, lambda: eng.model(xd))
            results[(tag, mode)] = {"acc": acc, "ref_acc": want_acc, "flips": flips,
                                    "ties": ties.tolist(), "other_flips": others,
                                    "max_dp": dp, "ms": ms, "preds": preds, "y": y, "x": x}
            log(f"  {tag:18s} {mode:10s} accuracy {acc:.4f} (JAX {want_acc:.4f}, "
                f"epsilon {EPSILON[mode]}); on {int(decided.sum())} rows with JAX margin "
                f"> {MARGIN}: argmax flips {flips}, exact ties {len(ties)}"
                + "".join(f" (row {i}: port {preds[i].max():.6f} twice, JAX "
                          f"{np.sort(want[i])[-1]:.6f} / {np.sort(want[i])[-2]:.6f})"
                          for i in ties)
                + f"; flips {others} on the other {int((~decided).sum())}; max |dp| "
                f"{dp:.4f}; forward B={SLICE} {ms:.4f} ms (CUDA graph) on {card}")
            if abs(acc - want_acc) > EPSILON[mode]:
                raise AssertionError(f"{tag} {mode}: accuracy {acc} vs JAX {want_acc}")
            if flips:
                raise AssertionError(f"{tag} {mode}: {flips} argmax flips on decided rows")
            del eng
    return results


async def stream_digits(model_cfg, x: np.ndarray):
    """accuracy_harness.e2e_run's ordering-deterministic configuration:
    one partition, parallelism 1/1/1, max_inflight 1, a sync sink, one
    image per record."""
    from storm_tpu_torch.api.schema import decode_predictions
    from storm_tpu_torch.config import BatchConfig, Config, OffsetsConfig, SinkConfig
    from storm_tpu_torch.connectors import BrokerSink, BrokerSpout, MemoryBroker
    from storm_tpu_torch.infer import InferenceBolt
    from storm_tpu_torch.runtime import AsyncLocalCluster, TopologyBuilder

    batch_cfg = BatchConfig(max_batch=32, max_wait_ms=5.0, buckets=(8, 32), max_inflight=1)
    broker = MemoryBroker(default_partitions=1)
    tb = TopologyBuilder()
    tb.set_spout("kafka-spout", BrokerSpout(
        broker, "input", OffsetsConfig(policy="earliest", max_behind=None)))
    tb.set_bolt("inference-bolt", InferenceBolt(model_cfg, batch_cfg, device="cuda")) \
        .shuffle_grouping("kafka-spout")
    tb.set_bolt("kafka-bolt", BrokerSink(broker, "output", SinkConfig(mode="sync"))) \
        .shuffle_grouping("inference-bolt")
    cluster = AsyncLocalCluster()
    rt = await cluster.submit("accuracy", Config(), tb.build())
    t0 = time.perf_counter()
    for img in x:
        broker.produce("input", json.dumps({"instances": [img.tolist()]}), partition=0)
    deadline = time.monotonic() + 300
    while broker.topic_size("output") < len(x):
        if time.monotonic() > deadline:
            raise TimeoutError(f"stream: {broker.topic_size('output')}/{len(x)} out in 300 s")
        await asyncio.sleep(0.01)
    wall = time.perf_counter() - t0
    await rt.drain(timeout_s=60)
    errors = list(rt.errors)
    outs = broker.drain_topic("output")
    await cluster.shutdown()
    if errors:
        raise AssertionError(f"stream reported errors: {errors[:3]}")
    return np.concatenate([decode_predictions(r.value).data for r in outs]), batch_cfg, wall


def digits_streams(torch, direct: dict, ref: dict) -> dict:
    """The three streaming passes, each a main path of its own: launch
    counts zeroed just before and read just after, held to the kernels'
    launches per forward of that model (and 0 for every other variant)."""
    from storm_tpu_torch.infer.engine import clear_engines, shared_engine
    from storm_tpu_torch.ops import _build

    launches = {}
    for tag, mode, per_forward in STREAMS:
        d = direct[(tag, mode)]
        model_cfg = digits_config(tag, mode)
        clear_engines()
        _build.reset_launch_counts()
        outs, batch_cfg, wall = asyncio.run(stream_digits(model_cfg, d["x"]))
        wrapper_counts = _build.launch_counts()
        engine = shared_engine(model_cfg, batch_cfg, device="cuda")
        forwards = engine.forwards
        n = len(d["y"])
        if outs.shape != (n, 10):
            raise AssertionError(f"stream {tag} {mode}: outputs {outs.shape}")
        row_diff = np.abs(outs - d["preds"]).max(axis=1)
        row_match = float((row_diff <= TRANSPORT_TOL[mode]).mean())
        argmax_agree = float((outs.argmax(-1) == d["preds"].argmax(-1)).mean())
        acc = float((outs.argmax(-1) == d["y"]).mean())
        want_acc = float(ref[f"{tag}/{mode}/acc"])
        log(f"  stream {tag} {mode}: {n} records in {wall:.3f} s, {forwards} forwards "
            f"(warmup included); rows within {TRANSPORT_TOL[mode]} of engine-direct "
            f"{row_match:.4f} (>= {MIN_ROW_MATCH}), argmax agree {argmax_agree:.4f} "
            f"(>= {MIN_ARGMAX_AGREE}), max row diff {row_diff.max():.4f}; accuracy at the "
            f"output topic {acc:.4f} (JAX {want_acc:.4f}); eager launches by the wrappers "
            f"{wrapper_counts}")
        if row_match < MIN_ROW_MATCH or argmax_agree < MIN_ARGMAX_AGREE:
            raise AssertionError(f"stream {tag} {mode}: transport proof failed")
        if abs(acc - want_acc) > EPSILON[mode]:
            raise AssertionError(f"stream {tag} {mode}: accuracy {acc} vs JAX {want_acc}")
        counts = check_tally(torch, engine, per_forward, wrapper_counts,
                             f"stream {tag} {mode}")
        log(f"  stream {tag} {mode}: launch tally {counts} for {forwards} forwards")
        launches[f"{tag} {mode}"] = counts
    return launches


def trained_checkpoints(torch, rows: list, card: str) -> dict:
    from storm_tpu_torch.models.registry import CHECKPOINTS

    with np.load(CHECKPOINTS / "reference_predictions.npz") as f:
        ref = {k: f[k] for k in f.files}
    times = digits_kernels(torch, rows)
    failed = [r for r in rows if not r["pass"]]
    if failed:
        raise AssertionError(f"kernel parity failed at the digits shapes: {failed}")
    direct = digits_engine_direct(torch, ref, card)
    ties = {f"{t} {m}": r["ties"] for (t, m), r in direct.items() if r["ties"]}
    log(f"  engine-direct: {len(direct)} cells, argmax flips on decided rows "
        f"{sum(r['flips'] for r in direct.values())}, exact ties on decided rows "
        f"{sum(map(len, ties.values()))} {ties}")
    launches = digits_streams(torch, direct, ref)
    return {"times": times, "launches": launches}


# ---- phase 7: the split-phase engine ----------------------------------------------

# (c)'s bursts: batches per burst at each size.
BURSTS = {"vit_b16 B=8": 60, "vit_tiny B=64": 200}
DIGITS_BUCKETS = (8, 32)


def vit_b16_config():
    from storm_tpu_torch.config import ModelConfig

    return ModelConfig(name="vit_b16", dtype="bfloat16", weights="int8_fused",
                       num_classes=CLASSES, input_shape=(224, 224, 3))


def graph_parity(torch, engines: dict) -> dict:
    """(a) Each engine's replayed forward (``predict``, through the ring
    and the bucket's graph) against its eager forward of the same bucket
    (``predict_eager``) on the same seeded inputs: bit-identical, or, if a
    library call computes otherwise under capture, within phase 4's bf16
    bound with the argmax kept. The digits engines take batches of 8, 32,
    5 and 20 rows (buckets 8 and 32, padded and full), each batch with its
    own range, so the uint8 wire's scale differs from batch to batch."""
    rng = np.random.RandomState(21)
    out = {}
    for name, eng in engines.items():
        if name.startswith("vit_b16"):
            xs = [rng.rand(B, *eng.input_shape).astype(np.float32)]
        else:
            xs = [(rng.rand(n, *eng.input_shape) * (1 + k) - 0.5 * k).astype(np.float32)
                  for k, n in enumerate((8, 32, 5, 20))]
        identical, worst = True, 0.0
        for x in xs:
            got, want = eng.predict(x), eng.predict_eager(x)
            if np.array_equal(got, want):
                continue
            identical = False
            err = float(np.abs(got - want).max() / np.abs(want).max())
            worst = max(worst, err)
            if err > 5e-2 or not (got.argmax(-1) == want.argmax(-1)).all():
                raise AssertionError(f"graph parity {name}: replay differs from eager by "
                                     f"{err} (relative) or in argmax")
        out[name] = {"bit_identical": identical, "max_rel_err": worst,
                     "buckets": sorted(eng.compiled_batches)}
        log(f"  (a) graph parity {name:28s} buckets {sorted(eng.compiled_batches)}: replay "
            + ("bit-identical to eager" if identical else
               f"NOT bit-identical to eager, max rel err {worst:.3e} (within 5e-2)"))
    return out


def ring_integrity(eng) -> dict:
    """(b) 64 ViT-B/16 batches of 1..8 distinct seeded rows (all padded to
    bucket 8), each first through ``predict`` alone, then all dispatched
    back to back at depth 2 from two threads: every result bit-identical
    to its own serial one (a static-buffer race would mix batches), and
    the staging pool within its limit per key."""
    import threading

    rng = np.random.RandomState(22)
    batches = [rng.rand(1 + i % B, *eng.input_shape).astype(np.float32) for i in range(64)]
    serial = [eng.predict(x) for x in batches]
    handles = [None] * len(batches)

    def feed(first: int) -> None:
        for i in range(first, len(batches), 2):
            handles[i] = eng.dispatch((batches[i],))

    threads = [threading.Thread(target=feed, args=(t,)) for t in range(2)]
    t0 = time.perf_counter()
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=120)
    if any(t.is_alive() for t in threads):
        raise AssertionError("ring integrity: a dispatching thread did not finish in 120 s")
    bad = [i for i, h in enumerate(handles)
           if not np.array_equal(h.future.result(120), serial[i])]
    wall = time.perf_counter() - t0
    for _ in range(100):  # the fetch thread releases just after resolving
        stats = eng.staging_stats()
        if not stats["in_use"]:
            break
        time.sleep(0.01)
    keys = 2  # the bf16 input (8, 224, 224, 3) and the f32 output (8, 1000)
    log(f"  (b) ring integrity: {len(batches)} batches from 2 threads in {wall:.3f} s at "
        f"depth {eng.pipeline_depth}, {len(batches) - len(bad)} bit-identical to their "
        f"serial forwards; staging {stats}")
    if bad:
        raise AssertionError(f"ring integrity: batches {bad} differ from their serial forwards")
    if stats["allocated"] > keys * stats["limit"] or stats["in_use"]:
        raise AssertionError(f"ring integrity: staging pool {stats} over its limit per key")
    return {"batches": len(batches), "wall_s": wall, "staging": stats}


@contextlib.contextmanager
def card_busy(torch):
    """The block under ``torch.profiler``; the dict it yields gets, on
    exit, the block's wall time and the share of it the card was busy (the
    union of every device activity's interval: kernels, copies, sets) and
    busy with kernels alone. Device activity only: recording every host op
    too would slow the host it measures."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    res: dict = {}
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        yield res
        torch.cuda.synchronize()
        wall_us = (time.perf_counter() - t0) * 1e6

    def union(spans):
        total, end = 0.0, -math.inf
        for s, e in sorted(spans):
            if e > end:
                total += e - max(s, end)
                end = e
        return total

    dev = [(ev.time_range.start, ev.time_range.end, ev.name) for ev in prof.events()
           if ev.device_type == DeviceType.CUDA]
    busy = union([(s, e) for s, e, _ in dev])
    kern = union([(s, e) for s, e, n in dev if "Memcpy" not in n and "Memset" not in n])
    res.update({"wall_ms": wall_us / 1e3, "busy_share": busy / wall_us,
                "idle_share": 1 - busy / wall_us, "kernel_share": kern / wall_us})


def device_busy(torch, fn) -> dict:
    """``fn()`` under ``card_busy``."""
    with card_busy(torch) as res:
        fn()
    return res


def burst(eng, xs) -> dict:
    """``xs`` through ``dispatch`` back to back from one thread, then every
    result: batches a second, and the substages' medians (the serialized
    path, depth 0, times no substages: None)."""
    t0 = time.perf_counter()
    handles = [eng.dispatch((x,)) for x in xs]
    for h in handles:
        h.future.result(120)
    wall = time.perf_counter() - t0
    med = {k: float(np.median([h.timings[k] for h in handles])) if eng.pipeline_depth
           else None for k in ("h2d_ms", "compute_ms", "d2h_ms")}
    return {"batches_per_s": len(xs) / wall, **med}


def timings(torch, engines: dict, card: str) -> dict:
    """(c) Information only. Per size, a depth-0 and a depth-2 engine in
    turns (0, 2, 2, 0) over the same distinct seeded batches; then one
    profiled burst each for the card's busy and idle share; the forward by
    graph replay (device time) against eager (wall, host included); the
    graph build's peak bytes."""
    from storm_tpu_torch.infer.graphs import eager_ms, replay_ms

    rng = np.random.RandomState(23)
    out = {}
    for size, (e0, e2, rows) in engines.items():
        xs = [rng.rand(rows, *e2.input_shape).astype(np.float32) for _ in range(BURSTS[size])]
        for e in (e0, e2):
            burst(e, xs[:10])  # first use of the pools and the pinned buffers
        turns = [(d, burst(e, xs)) for d, e in ((0, e0), (2, e2), (2, e2), (0, e0))]
        prof = {d: device_busy(torch, lambda e=e: burst(e, xs[:20]))
                for d, e in ((0, e0), (2, e2))}
        bucket = e2.graph_for(rows)
        res = {"turns": [{"depth": d, **t} for d, t in turns], "profiled": prof,
               "replay_ms": replay_ms(bucket), "eager_ms": eager_ms(bucket),
               "graph_build_peak_bytes": e2.graph_pool_bytes}
        out[size] = res
        for d, t in turns:
            log(f"  (c) {size} depth {d}: {t['batches_per_s']:.3f} batches/s"
                + (f"; medians h2d {t['h2d_ms']:.4f} ms, compute {t['compute_ms']:.4f} ms, "
                   f"d2h {t['d2h_ms']:.4f} ms" if d else ""))
        for d, p in prof.items():
            log(f"  (c) {size} depth {d}, 20 batches under the profiler: {p['wall_ms']:.3f} "
                f"ms, card busy {p['busy_share']:.4f} (kernels {p['kernel_share']:.4f}), "
                f"idle {p['idle_share']:.4f}")
        log(f"  (c) {size}: forward by graph replay {res['replay_ms']:.4f} ms (device), eager "
            f"{res['eager_ms']:.4f} ms (wall, host included); graph build peak "
            f"{res['graph_build_peak_bytes'] / 1e6:.3f} MB; on {card}")
    return out


async def stream_quarantine(model_cfg, batch_cfg, x: np.ndarray, inj):
    """The lenet5 1/1/1 topology with two held batches: the watchdog fails
    them, the second trip quarantines the engine, the operator swaps in a
    replacement, and the spout's replays carry every record through."""
    from storm_tpu_torch.config import Config, OffsetsConfig, SinkConfig
    from storm_tpu_torch.connectors import BrokerSink, BrokerSpout, MemoryBroker
    from storm_tpu_torch.infer import InferenceBolt
    from storm_tpu_torch.runtime import AsyncLocalCluster, TopologyBuilder

    broker = MemoryBroker(default_partitions=1)
    tb = TopologyBuilder()
    tb.set_spout("kafka-spout", BrokerSpout(
        broker, "input", OffsetsConfig(policy="earliest", max_behind=None)))
    tb.set_bolt("inference-bolt", InferenceBolt(model_cfg, batch_cfg, device="cuda")) \
        .shuffle_grouping("kafka-spout")
    tb.set_bolt("kafka-bolt", BrokerSink(broker, "output", SinkConfig(mode="sync"))) \
        .shuffle_grouping("inference-bolt")
    cluster = AsyncLocalCluster()
    rt = await cluster.submit("quarantine", Config(), tb.build())
    bolt = rt.bolt_execs["inference-bolt"][0].bolt
    first = bolt.engine
    inj.configure(engine_hang_ms=200.0, engine_hang_next=2)
    for img in x:
        broker.produce("input", json.dumps({"instances": [img.tolist()]}), partition=0)
    deadline = time.monotonic() + 120
    while broker.topic_size("output") < len(x):
        if time.monotonic() > deadline:
            raise TimeoutError(f"quarantine stream: {broker.topic_size('output')}/{len(x)} "
                               f"out in 120 s")
        await asyncio.sleep(0.01)
    await rt.drain(timeout_s=60)
    snap = rt.metrics.snapshot()
    errors = list(rt.errors)
    outs = broker.drain_topic("output")
    await cluster.shutdown()
    return first, bolt.engine, snap, errors, outs


def watchdog_quarantine(torch) -> dict:
    """(d) watchdog_ms=50 with the chaos injector holding batches 200 ms."""
    import logging

    from storm_tpu_torch.api.schema import decode_predictions
    from storm_tpu_torch.config import BatchConfig
    from storm_tpu_torch.data import load_digits_nhwc
    from storm_tpu_torch.infer.engine import (EngineQuarantined, EngineWatchdogTimeout,
                                              clear_engines, live_engines, shared_engine)
    from storm_tpu_torch.resilience import get_injector

    cfg = digits_config("lenet5_digits", "int8_fused")
    bcfg = BatchConfig(max_batch=32, max_wait_ms=5.0, buckets=DIGITS_BUCKETS, max_inflight=1,
                       watchdog_ms=50.0, watchdog_trips=2)
    x = load_digits_nhwc(cfg.input_shape)[2][:128]
    inj = get_injector()

    def trips(eng, n: int) -> None:
        inj.configure(engine_hang_ms=200.0, engine_hang_next=n)
        for _ in range(n):
            try:
                eng.dispatch((x[:8],)).future.result(10)
            except EngineWatchdogTimeout:
                continue
            raise AssertionError("a held batch did not trip the watchdog")

    def settled(eng) -> dict:
        # The fetch thread releases a batch's slot and buffers just after
        # resolving its future.
        for _ in range(100):
            stats = eng.staging_stats()
            if eng.ring_inflight == 0 and stats["in_use"] == 0:
                return stats
            time.sleep(0.01)
        raise AssertionError(f"ring {eng.ring_inflight} or staging {eng.staging_stats()} "
                             f"not released")

    clear_engines()
    eng = shared_engine(cfg, bcfg, device="cuda")
    eng.warmup()
    trips(eng, 1)
    if eng.dispatch((x[:8],)).future.result(10).shape != (8, 10) or eng.quarantined:
        raise AssertionError("the batch after a trip did not succeed")
    stats = settled(eng)
    log(f"  (d) one held batch failed with EngineWatchdogTimeout, the next succeeded; "
        f"ring in flight {eng.ring_inflight}, staging {stats}")
    trips(eng, 2)
    for _ in range(200):  # the fetch thread quarantines just after the future fails
        if eng.quarantined and not any(e is eng for e in live_engines()):
            break
        time.sleep(0.01)
    if not eng.quarantined:
        raise AssertionError("two consecutive trips did not quarantine the engine")
    try:
        eng.dispatch((x[:8],))
    except EngineQuarantined:
        pass
    else:
        raise AssertionError("a quarantined engine accepted a dispatch")
    if any(e is eng for e in live_engines()):
        raise AssertionError("the quarantined engine is still in the cache")
    fresh = shared_engine(cfg, bcfg, device="cuda")
    if fresh is eng or fresh.quarantined or fresh.predict(x[:8]).shape != (8, 10):
        raise AssertionError("shared_engine did not build a working replacement")
    settled(eng)
    log("  (d) two held batches quarantined the engine: dispatch raises EngineQuarantined, "
        "it left the cache, shared_engine built a replacement that serves")

    clear_engines()
    quiet = logging.getLogger("storm_tpu_torch.cluster")
    level = quiet.level
    quiet.setLevel(logging.CRITICAL)  # one ERROR line a failed batch, by design
    try:
        first, final, snap, errors, outs = asyncio.run(stream_quarantine(cfg, bcfg, x, inj))
    finally:
        quiet.setLevel(level)
        inj.configure(engine_hang_ms=0.0, engine_hang_next=0)
    preds = np.concatenate([decode_predictions(r.value).data for r in outs])
    direct = np.concatenate([final.predict(x[i:i + 32]) for i in range(0, len(x), 32)])
    nearest = np.abs(preds[:, None, :] - direct[None, :, :]).max(axis=2).min(axis=1)
    kinds = {}
    for _, _, e in errors:
        kinds[type(e).__name__] = kinds.get(type(e).__name__, 0) + 1
    spout, infer = snap["kafka-spout"], snap["inference-bolt"]
    dups = len(outs) - len(x)
    log(f"  (d) 1/1/1 lenet5 stream of {len(x)} records with 2 held batches: "
        f"{len(outs)} predictions out ({dups} duplicates), spout acked "
        f"{spout.get('tree_acked', 0)}, failed {spout.get('tree_failed', 0)} (replayed); "
        f"errors {kinds}; watchdog_trips {infer.get('watchdog_trips', 0)}, "
        f"engine_quarantined {infer.get('engine_quarantined')}; replacement swapped in "
        f"{final is not first}; max distance of an output to its nearest direct "
        f"prediction {nearest.max():.2e}")
    if final is first or final.quarantined or not first.quarantined:
        raise AssertionError("the operator did not swap a replacement in")
    if spout.get("tree_acked", 0) != len(x) or dups < 0:
        raise AssertionError(f"records lost: {spout.get('tree_acked', 0)} acked, "
                             f"{len(outs)} out of {len(x)}")
    if infer.get("watchdog_trips", 0) != 2 or infer.get("engine_quarantined") != 0:
        raise AssertionError(f"operator metrics wrong: {infer}")
    if nearest.max() > TRANSPORT_TOL["int8_fused"]:
        raise AssertionError(f"an output matches no direct prediction: {nearest.max()}")
    return {"records": len(x), "out": len(outs), "duplicates": dups,
            "replayed": spout.get("tree_failed", 0), "errors": kinds}


def cold_bucket(eng) -> dict:
    """(e) A batch larger than max_batch captures a graph of its own once,
    and on_compile fires once for it."""
    compiles = []
    eng.on_compile = lambda padded, ms: compiles.append((padded, ms))
    rows = eng.batch_cfg.max_batch + 8
    rng = np.random.RandomState(24)
    x1, x2 = (rng.rand(rows, *eng.input_shape).astype(np.float32) for _ in range(2))
    got = [eng.predict(x1), eng.predict(x2)]
    bucket = eng.graph_for(rows)
    log(f"  (e) cold bucket: {rows} rows > max_batch {eng.batch_cfg.max_batch}: on_compile "
        f"fired {[(p, round(ms, 3)) for p, ms in compiles]}; {bucket.replays} replays of "
        f"its graph; replay equal to eager "
        f"{np.array_equal(got[0], eng.predict_eager(x1))}")
    if [p for p, _ in compiles] != [rows] or bucket.replays != 2 or bucket.graph is None:
        raise AssertionError(f"cold bucket: compiles {compiles}, replays {bucket.replays}")
    if not np.array_equal(got[0], eng.predict_eager(x1)):
        raise AssertionError("cold bucket: replay differs from eager")
    return {"rows": rows, "capture_ms": compiles[0][1]}


def split_phase(torch, card: str) -> dict:
    from storm_tpu_torch.config import BatchConfig
    from storm_tpu_torch.infer.engine import InferenceEngine, clear_engines

    clear_engines()
    vit = vit_b16_config()
    engines = {"vit_b16 bf16 int8_fused": InferenceEngine(
        vit, BatchConfig(max_batch=B, buckets=(B,)), device="cuda")}
    for tag in ("lenet5_digits", "resnet20_digits", "vit_tiny_digits"):
        for mode in ("bf16", "uint8_wire"):
            engines[f"{tag} {mode}"] = InferenceEngine(
                digits_config(tag, mode), BatchConfig(max_batch=32, buckets=DIGITS_BUCKETS),
                device="cuda")
    parity = graph_parity(torch, engines)
    vit2 = engines["vit_b16 bf16 int8_fused"]
    ring = ring_integrity(vit2)
    tiny = digits_config("vit_tiny_digits", "bf16")
    sized = {
        "vit_b16 B=8": (InferenceEngine(vit, BatchConfig(max_batch=B, buckets=(B,),
                                                         pipeline_depth=0), device="cuda"),
                        vit2, B),
        "vit_tiny B=64": tuple(InferenceEngine(tiny, BatchConfig(
            max_batch=SLICE, buckets=(SLICE,), pipeline_depth=d), device="cuda")
            for d in (0, 2)) + (SLICE,)}
    for e0, e2, rows in sized.values():
        e0.warmup()
        e2.warmup()
    times = timings(torch, sized, card)
    cold = cold_bucket(engines["vit_tiny_digits bf16"])
    watchdog = watchdog_quarantine(torch)
    return {"parity": parity, "ring": ring, "timings": times, "watchdog": watchdog,
            "cold_bucket": cold}


# ---- phase 8: the MoE-ViT-B/16 path, and the other families at full width ----------

# Launches per forward of each new family (bf16 int8_fused), from the code:
# moe_vit_b16's 6 dense blocks run 6 w8a16 dense layers, one flash
# attention and one fused norm each, its 6 MoE blocks 4 w8a16 projections
# and one flash attention (the experts are batched matmuls, their LayerNorms
# plain), and the head one w8a16; mixer_s16's 8 blocks run 4 w8a16 dense
# layers and one fused norm each, plus the head; the CNNs only their head.
FAMILY_LAUNCHES = {
    "moe_vit_b16": {"w8a16_matmul_sm90": 61, "flash_attention_sm90": 12,
                    "residual_layernorm_sm90": 6},
    "mixer_s16": {"w8a16_matmul_sm90": 33, "residual_layernorm_sm90": 8},
    "mobilenetv2": {"w8a16_matmul_sm90": 1},
    "resnet50": {"w8a16_matmul_sm90": 1},
}


def family_config(name: str):
    from storm_tpu_torch.config import ModelConfig

    return ModelConfig(name=name, dtype="bfloat16", weights="int8_fused",
                       num_classes=CLASSES, input_shape=(224, 224, 3))


def replay_equals_eager(engine, x: np.ndarray, label: str) -> None:
    got, want = engine.predict(x), engine.predict_eager(x)
    if not np.array_equal(got, want):
        raise AssertionError(f"{label}: graph replay differs from eager by "
                             f"{np.abs(got - want).max()}")
    log(f"  {label}: graph replay bit-identical to the same engine's eager forward")


def forward_times(torch, engine, label: str, card: str, padded: int = B) -> dict:
    from storm_tpu_torch.infer.graphs import eager_ms as graph_eager_ms
    from storm_tpu_torch.infer.graphs import replay_ms

    bucket = engine.graph_for(padded)
    t = {"replay_ms": replay_ms(bucket), "eager_ms": graph_eager_ms(bucket)}
    counts, t["profiled_ms"] = profiled_kernels(torch, bucket.replay)
    ours = {n: round(v, 4) for n, v in t["profiled_ms"].items() if n in KERNEL_FUNCS and v}
    log(f"  {label} B={padded}: forward by graph replay {t['replay_ms']:.4f} ms (device), eager "
        f"{t['eager_ms']:.4f} ms (wall, host included); one profiled replay: "
        f"{counts['all']} kernels, {t['profiled_ms']['all']:.4f} ms of kernel time, "
        f"ours {ours} ({sum(ours.values()):.4f} ms); on {card}")
    return t


def moe_path(torch, card: str) -> dict:
    """Phase 8: moe_vit_b16 bf16 int8_fused, seeded, served through the
    2/4/2 topology with the native codec (``served_path``, its exact launch
    tally), then, on the same engine: the kernel path against the plain
    path, a graph replay against the eager forward, the forward's time."""
    res = served_path(torch, family_config("moe_vit_b16"), FAMILY_LAUNCHES["moe_vit_b16"],
                      "moe_vit_b16 path")
    engine = res.pop("engine")
    x = np.random.RandomState(8).rand(B, 224, 224, 3).astype(np.float32)
    kernel_vs_plain(torch, engine.model, torch.from_numpy(x).to(torch.bfloat16).cuda(),
                    5e-2, "moe_vit_b16 int8_fused bfloat16")
    replay_equals_eager(engine, x, "moe_vit_b16")
    res["times"] = forward_times(torch, engine, "moe_vit_b16", card)
    return res


def full_width_families(torch, card: str) -> dict:
    """Phase 8b: mixer_s16, mobilenetv2 and resnet50 at 224x224x3, bf16
    int8_fused, seeded, engine-direct at B = 8: the launch tally of the
    warm-up and three forwards (counts zeroed just before building), the
    kernel path against the plain path, a replay against eager, and the
    forward by replay timed."""
    from storm_tpu_torch.config import BatchConfig
    from storm_tpu_torch.infer.engine import InferenceEngine, clear_engines
    from storm_tpu_torch.ops import _build

    out = {}
    rng = np.random.RandomState(9)
    for name in ("mixer_s16", "mobilenetv2", "resnet50"):
        clear_engines()
        _build.reset_launch_counts()
        engine = InferenceEngine(family_config(name), BatchConfig(max_batch=B, buckets=(B,)),
                                 device="cuda")
        engine.warmup()
        x = rng.rand(B, 224, 224, 3).astype(np.float32)
        for _ in range(3):
            probs = engine.predict(x)
        if probs.shape != (B, CLASSES) or not np.isfinite(probs).all() or \
                np.abs(probs.sum(-1) - 1).max() > 1e-3:
            raise AssertionError(f"{name}: predictions {probs.shape} not finite "
                                 f"probabilities")
        launches = check_tally(torch, engine, FAMILY_LAUNCHES[name], _build.launch_counts(),
                               name)
        log(f"  {name}: launch tally {launches} for {engine.forwards} forwards")
        kernel_vs_plain(torch, engine.model, torch.from_numpy(x).to(torch.bfloat16).cuda(),
                        5e-2, f"{name} int8_fused bfloat16")
        replay_equals_eager(engine, x, name)
        out[name] = {"launches": launches, "forwards": engine.forwards,
                     "times": forward_times(torch, engine, name, card)}
        del engine
    return out


# ---- phase 9: longseq_encoder at S = 2048, engine-direct and served with QoS ------

# The served burst: records spread over the three lanes and two tenants.
LS_RECORDS = 48
LS_TENANTS = ("gold", "free")
LS_LANES = ("high", "normal", "best_effort")


def longseq_config(name: str = "longseq_encoder"):
    from storm_tpu_torch.config import ModelConfig

    shape = (LS_SEQ, LS_FEAT) if name == "longseq_encoder" else (64, 16)
    return ModelConfig(name=name, dtype="bfloat16", weights="int8_fused",
                       num_classes=LS_CLASSES, input_shape=shape)


def longseq_batch(**kw):
    """The zoo's batch policy for longseq (max_batch 32, buckets 8 and 32)."""
    from storm_tpu_torch.config import BatchConfig

    return BatchConfig(max_batch=32, buckets=(8, 32), **kw)


def longseq_engine_direct(torch, card: str) -> dict:
    """Phase 9a: longseq_encoder bf16 int8_fused (seeded) engine-direct at
    B = 8 and 32: the launch tally of the warm-up and two forwards of each
    (26 / 4 / 4 per forward, counts zeroed just before building, checked
    by a profiled replay of each bucket), the kernel path against the
    plain path, each replay bit-identical to eager, the forward by replay
    with our kernels' share. Then longseq_tiny (4 heads of D = 8) the same
    way at B = 8, and in float32 kernel path against plain path."""
    from storm_tpu_torch.config import BatchConfig
    from storm_tpu_torch.infer.engine import InferenceEngine, clear_engines
    from storm_tpu_torch.models import build_model
    from storm_tpu_torch.ops import _build

    clear_engines()
    _build.reset_launch_counts()
    engine = InferenceEngine(longseq_config(), longseq_batch(), device="cuda")
    engine.warmup()
    rng = np.random.RandomState(12)
    xs = {b: rng.randn(b, LS_SEQ, LS_FEAT).astype(np.float32) for b in (8, 32)}
    for b, x in xs.items():
        for _ in range(2):
            probs = engine.predict(x)
        if probs.shape != (b, LS_CLASSES) or not np.isfinite(probs).all() or \
                np.abs(probs.sum(-1) - 1).max() > 1e-3:
            raise AssertionError(f"longseq_encoder B={b}: predictions not finite probabilities")
    launches = check_tally(torch, engine, LS_LAUNCHES, _build.launch_counts(),
                           "longseq_encoder")
    log(f"  longseq_encoder: launch tally {launches} for {engine.forwards} forwards")
    out = {"launches": launches, "forwards": engine.forwards, "times": {}, "parity": {}}
    for b, x in xs.items():
        got, want = kernel_vs_plain(torch, engine.model, torch.from_numpy(x).to(
            torch.bfloat16).cuda(), 5e-2, f"longseq_encoder int8_fused bfloat16 B={b}")
        out["parity"][b] = {"rel": rel_err(got, want),
                            "argmax_equal": int((got.argmax(-1) == want.argmax(-1)).sum())}
        replay_equals_eager(engine, x, f"longseq_encoder B={b}")
        out["times"][b] = forward_times(torch, engine, "longseq_encoder", card, padded=b)
    del engine
    clear_engines()
    _build.reset_launch_counts()
    tiny = InferenceEngine(longseq_config("longseq_tiny"),
                           BatchConfig(max_batch=B, buckets=(B,)), device="cuda")
    tiny.warmup()
    x = rng.randn(B, 64, 16).astype(np.float32)
    for _ in range(2):
        tiny.predict(x)
    out["tiny_launches"] = check_tally(torch, tiny, LS_TINY_LAUNCHES, _build.launch_counts(),
                                       "longseq_tiny")
    out["tiny_forwards"] = tiny.forwards
    kernel_vs_plain(torch, tiny.model, torch.from_numpy(x).to(torch.bfloat16).cuda(), 5e-2,
                    "longseq_tiny int8_fused bfloat16 (D = 8)")
    replay_equals_eager(tiny, x, "longseq_tiny")
    model = build_model("longseq_tiny", device="cuda", weights="int8_fused",
                        dtype=torch.float32, seed=0)
    kernel_vs_plain(torch, model, torch.from_numpy(x).cuda(), 1e-4,
                    "longseq_tiny int8_fused float32 (D = 8)")
    del tiny, model
    clear_engines()
    return out


def longseq_records(n: int = LS_RECORDS) -> list:
    """``(key, payload, lane)`` of ``n`` seeded (1, 2048, 64) records,
    keyed ``tenant:lane`` round the lanes and tenants (values to 3
    decimals: shorter JSON, the same floats on both sides)."""
    rng = np.random.RandomState(13)
    out = []
    for i in range(n):
        x = np.round(rng.randn(1, LS_SEQ, LS_FEAT), 3)
        lane, tenant = LS_LANES[i % 3], LS_TENANTS[(i // 3) % 2]
        out.append((f"{tenant}:{lane}".encode(), json.dumps({"instances": x.tolist()}), lane))
    return out


async def serve_longseq(records: list, continuous: bool = True, shed=None, tracing=None,
                        max_level=None, inspect=None) -> dict:
    """longseq_encoder through MemoryBroker -> 2x BrokerSpout -> 4x
    InferenceBolt -> 2x BrokerSink (+ dead-letter sink), QoS on at the
    spout and the bolt (the lane passed through to the sink), the given
    batching mode, and one ragged poison record (key ``gold:high``) after
    the first half; records wait at most 100 ms for a batch (a task
    decodes its inbox's records back to back on the event loop, so on an
    idle card a shorter wait ships each task's records alone). With
    ``shed`` (a QosConfig of low thresholds) a
    LoadShedController is wired as storm_tpu's main.py wires it, each
    bolt task's inbox holds 8 tuples and the sink's SLO is 50 ms, so the
    burst trips it. The engine's dispatch is wrapped to keep every batch
    it is given. Each run starts from a fresh queue registry (a queue's
    metrics bind to the first topology that uses it). ``tracing``,
    ``max_level`` (the controller's highest level) and ``inspect(rt)`` as
    in ``serve``."""
    from storm_tpu_torch.config import Config, OffsetsConfig, QosConfig
    from storm_tpu_torch.connectors import BrokerSink, BrokerSpout, MemoryBroker
    from storm_tpu_torch.infer import InferenceBolt
    from storm_tpu_torch.infer.continuous import _reset_registry
    from storm_tpu_torch.qos import LoadShedController, ShedPolicy
    from storm_tpu_torch.runtime import AsyncLocalCluster, TopologyBuilder

    _reset_registry()
    qos = shed or QosConfig(enabled=True)
    cfg = Config()
    if tracing is not None:
        cfg.tracing = tracing
    if shed is not None:
        cfg.topology.inbox_capacity = 8
        cfg.tracing.slo_ms = 50.0
    broker = MemoryBroker(default_partitions=2)
    tb = TopologyBuilder()
    tb.set_spout("kafka-spout", BrokerSpout(
        broker, "input", OffsetsConfig(policy="earliest", max_behind=None), qos=qos),
        parallelism=cfg.topology.spout_parallelism)
    tb.set_bolt("inference-bolt", InferenceBolt(
        longseq_config(), longseq_batch(max_wait_ms=100.0, continuous=continuous),
        device="cuda", passthrough=("qos_lane",), qos=qos),
        parallelism=cfg.topology.inference_parallelism).shuffle_grouping("kafka-spout")
    tb.set_bolt("kafka-bolt", BrokerSink(broker, "output", cfg.sink),
                parallelism=cfg.topology.sink_parallelism).shuffle_grouping("inference-bolt")
    tb.set_bolt("dlq-bolt", BrokerSink(broker, "dead-letter", cfg.sink)) \
        .shuffle_grouping("inference-bolt", stream="dead_letter")
    cluster = AsyncLocalCluster()
    rt = await cluster.submit("chip-smoke-longseq", cfg, tb.build())
    engine = rt.bolt_execs["inference-bolt"][0].bolt.engine
    batches = []
    dispatch = engine.dispatch

    def recording_dispatch(parts):
        batches.append(np.concatenate([np.array(p, copy=True) for p in parts]))
        return dispatch(parts)

    engine.dispatch = recording_dispatch
    shedder = None
    if shed is not None:
        policy = ShedPolicy.from_qos(shed, "inference-bolt", "kafka-bolt")
        if max_level is not None:
            policy.max_level = max_level
        shedder = LoadShedController(rt, policy).start()
    spouts = [e.spout for e in rt.spout_execs["kafka-spout"]]
    t0 = time.perf_counter()
    for i, (key, payload, _lane) in enumerate(records):
        broker.produce("input", payload, key=key)
        if i == len(records) // 2:
            broker.produce("input", '{"instances": [[1.0, 2.0], [3.0]]}', key=b"gold:high")
    total = len(records) + 1
    deadline = time.monotonic() + 300
    while (broker.topic_size("output") + broker.topic_size("dead-letter")
           + sum(s.dropped for s in spouts)) < total:
        if time.monotonic() > deadline:
            raise TimeoutError("longseq served path: records did not all come out in 300 s")
        await asyncio.sleep(0.005)
    wall = time.perf_counter() - t0
    await rt.drain(timeout_s=60)
    decisions = []
    if shedder is not None:
        await shedder.stop()
        decisions = list(shedder.decisions)
    del engine.dispatch
    snap = rt.metrics.snapshot()
    errors = list(rt.errors)
    dropped = sum(s.dropped for s in spouts)
    outs, dlq = broker.drain_topic("output"), broker.drain_topic("dead-letter")
    inspected = inspect(rt) if inspect is not None else None
    await cluster.shutdown()
    _reset_registry()
    return {"outs": outs, "dlq": dlq, "snap": snap, "errors": errors, "wall": wall,
            "batches": batches, "decisions": decisions, "dropped": dropped,
            "inspected": inspected}


def longseq_served(torch, card: str) -> dict:
    """Phase 9b: longseq_encoder served through 2/4/2 with QoS (three lanes,
    two tenants) and continuous batching, native codec. Gates: every good
    record a prediction, each output record byte-identical to the native
    encoding of the engine's direct forward of the batch it rode in; the
    poison record dead-lettered; the per-lane e2e histograms; a batch
    that merged tasks (``coalesced_sources`` above the batch count); the
    launch tally 26 / 4 / 4 per forward. Then the shed turn: the real
    LoadShedController trips on the burst; its level rises; best-effort
    records come back Overloaded and acked; every high record is served;
    no record lost (predictions + Overloaded + dead letters + dropped at
    the spout's admission = produced). Then, information only, the same
    burst with continuous off and on in turns."""
    from storm_tpu_torch.api.schema import decode_predictions
    from storm_tpu_torch.config import QosConfig
    from storm_tpu_torch.infer.engine import clear_engines, shared_engine
    from storm_tpu_torch.native import format_predictions
    from storm_tpu_torch.ops import _build

    records = longseq_records()
    n = len(records)
    clear_engines()
    _build.reset_launch_counts()
    r = asyncio.run(serve_longseq(records))
    wrapper_counts = _build.launch_counts()
    engine = shared_engine(longseq_config(), longseq_batch(), device="cuda")
    assert_numeric_flags(torch, "longseq served path, engine built")
    forwards = engine.forwards
    launches = check_tally(torch, engine, LS_LAUNCHES, wrapper_counts, "longseq served path")
    outs, dlq, snap = r["outs"], r["dlq"], r["snap"]
    if r["errors"]:
        raise AssertionError(f"longseq served path reported errors: {r['errors'][:3]}")
    if len(outs) != n or len(dlq) != 1 or snap["inference-bolt"]["dead_lettered"] != 1:
        raise AssertionError(f"longseq served path: {len(outs)} outputs, {len(dlq)} dead "
                             f"letters for {n} records and one poison")
    preds = np.concatenate([decode_predictions(rec.value).data for rec in outs])
    if preds.shape != (n, LS_CLASSES) or not np.isfinite(preds).all() or \
            np.abs(preds.sum(1) - 1).max() > 1e-3:
        raise AssertionError(f"longseq predictions {preds.shape} not finite probabilities")
    want = []
    for batch in r["batches"]:
        want += [format_predictions(row[None]) for row in engine.predict(batch)]
    got = [rec.value.decode() if isinstance(rec.value, bytes) else rec.value for rec in outs]
    if sorted(got) != sorted(want):
        raise AssertionError(f"longseq served path: {len(set(got) - set(want))} of "
                             f"{len(got)} records are not the bytes of the engine's direct "
                             f"forward of their batch")
    sink, infer = snap["kafka-bolt"], snap["inference-bolt"]
    lanes = {ln: sink.get(f"e2e_latency_ms_{ln}", {}).get("count", 0) for ln in LS_LANES}
    if lanes != {ln: n // 3 for ln in LS_LANES}:
        raise AssertionError(f"per-lane e2e histograms {lanes}")
    n_batches = infer["batch_fill"]["count"]
    if infer["coalesced_sources"] <= n_batches:
        raise AssertionError(f"no batch merged tasks: {infer['coalesced_sources']} sources "
                             f"over {n_batches} batches")
    e2e = sink["e2e_latency_ms"]
    res = {"launches": launches, "forwards": forwards, "e2e_p50_ms": e2e["p50"],
           "e2e_p99_ms": e2e["p99"], "records_per_s": n / r["wall"],
           "batches": [len(b) for b in r["batches"]],
           "coalesced_sources": infer["coalesced_sources"], "batch_count": n_batches,
           "batch_fill_p50": infer["batch_fill"]["p50"],
           "e2e_p50_by_lane": {ln: sink[f"e2e_latency_ms_{ln}"]["p50"] for ln in LS_LANES},
           "decode_ms_p50": infer["decode_ms"]["p50"]}
    log(f"  longseq served (QoS, continuous): {n} predictions + 1 dead letter in "
        f"{len(r['batches'])} batches {res['batches']}, every record byte-identical to the "
        f"native encoding of the engine's direct forward of its batch; "
        f"{infer['coalesced_sources']} sources over {n_batches} batches; per-lane e2e "
        f"counts {lanes}; launch tally {launches} for {forwards} forwards")
    log(f"  longseq served on {card}: e2e p50 {e2e['p50']:.3f} ms, p99 {e2e['p99']:.3f} ms, "
        f"{res['records_per_s']:.3f} records/s; p50 by lane {res['e2e_p50_by_lane']}; "
        f"batch_fill p50 {res['batch_fill_p50']:.3f}; bolt decode_ms p50 "
        f"{res['decode_ms_p50']:.3f}")

    # The shed turn.
    shed_qos = QosConfig(enabled=True, shed_interval_s=0.02, shed_inbox_frac=0.25,
                         shed_breach_rate=1.0, shed_hot_steps=1, shed_calm_steps=1000)
    s = asyncio.run(serve_longseq(records, shed=shed_qos))
    if s["errors"]:
        raise AssertionError(f"shed turn reported errors: {s['errors'][:3]}")
    msgs = [json.loads(rec.value) for rec in s["outs"]]
    over = [m for m in msgs if m.get("overloaded")]
    served = [m for m in msgs if "predictions" in m]
    snap = s["snap"]
    ups = [d for d in s["decisions"] if d[0] == "shed"]
    if not ups:
        raise AssertionError(f"shed turn: the controller never raised its level "
                             f"({s['decisions']})")
    if not any(m["lane"] == "best_effort" for m in over):
        raise AssertionError(f"shed turn: no best-effort record came back Overloaded "
                             f"({len(over)} Overloaded, {s['dropped']} dropped at the spout)")
    if any(m["lane"] == "high" for m in over) or \
            snap["kafka-bolt"].get("e2e_latency_ms_high", {}).get("count") != n // 3 or \
            snap.get("qos", {}).get("shed_lane_high", 0):
        raise AssertionError("shed turn: a high record was not served")
    if len(served) + len(over) + len(s["dlq"]) + s["dropped"] != n + 1 or len(s["dlq"]) != 1:
        raise AssertionError(f"shed turn lost records: {len(served)} predictions, "
                             f"{len(over)} Overloaded, {len(s['dlq'])} dead letters, "
                             f"{s['dropped']} dropped at admission, of {n + 1}")
    infer, spout = snap["inference-bolt"], snap["kafka-spout"]
    if infer.get("shed_rejected", 0) != len(over) or spout.get("tree_failed", 0) or \
            spout["tree_acked"] != n + 1 - s["dropped"]:
        raise AssertionError(f"shed turn: Overloaded records not acked once each "
                             f"(shed_rejected {infer.get('shed_rejected')}, spout {spout})")
    res["shed"] = {"decisions": s["decisions"], "predictions": len(served),
                   "overloaded": len(over), "overloaded_lanes": sorted({m["lane"] for m in over}),
                   "dropped_at_spout": s["dropped"], "dead_letters": len(s["dlq"]),
                   "qos": snap.get("qos", {})}
    log(f"  shed turn: decisions {s['decisions']}; {len(served)} predictions, {len(over)} "
        f"Overloaded (lanes {res['shed']['overloaded_lanes']}, acked), {s['dropped']} dropped "
        f"at the spout's admission, 1 dead letter: all {n + 1} records accounted for; every "
        f"high record served")

    # Information only: the burst with continuous batching off and on, in turns.
    turns = []
    for cont in (False, True, True, False):
        t = asyncio.run(serve_longseq(records, continuous=cont))
        if len(t["outs"]) != n or t["errors"]:
            raise AssertionError(f"continuous={cont} turn: {len(t['outs'])} outputs, errors "
                                 f"{t['errors'][:3]}")
        sink, infer = t["snap"]["kafka-bolt"], t["snap"]["inference-bolt"]
        turns.append({"continuous": cont, "e2e_p50_ms": sink["e2e_latency_ms"]["p50"],
                      "records_per_s": n / t["wall"],
                      "batch_fill_p50": infer["batch_fill"]["p50"],
                      "batches": len(t["batches"])})
        log(f"  turn continuous={str(cont):5s}: e2e p50 {turns[-1]['e2e_p50_ms']:.3f} ms, "
            f"{turns[-1]['records_per_s']:.3f} records/s, batch_fill p50 "
            f"{turns[-1]['batch_fill_p50']:.3f} over {turns[-1]['batches']} batches")
    res["turns"] = turns
    del engine
    clear_engines()
    return res


# ---- phase 10: observe and swap -------------------------------------------------

VIT_B16_LAUNCHES = {"w8a16_matmul_sm90": 73, "residual_layernorm_sm90": 12,
                    "flash_attention_sm90": 12}
# Launches per forward of the swap's models (bf16 int8_fused): lenet5's three
# dense layers; vit_tiny's 2 blocks run six dense layers, one flash attention
# and one fused norm each, and its head one more dense layer.
SWAP_LAUNCHES = {"lenet5": {"w8a16_matmul_sm90": 3},
                 "vit_tiny": {"w8a16_matmul_sm90": 13, "flash_attention_sm90": 2,
                              "residual_layernorm_sm90": 2}}
SWAP_TAGS = {"lenet5": "lenet5_rgb_digits", "vit_tiny": "vit_tiny_digits"}
TO_VIT = {"checkpoint": "checkpoints/vit_tiny_digits", "name": "vit_tiny"}
TO_LENET = {"checkpoint": "checkpoints/lenet5_rgb_digits", "name": "lenet5"}
WAVES = 4
# Every span of a delivered record's trace, by first start.
TRACE_ORDER = ["ingress", "execute", "queue_wait", "device_execute", "egress"]


@contextlib.contextmanager
def counted_dispatch(keep_batches: bool = False):
    """Counts every ``InferenceEngine.dispatch`` by (profile key, padded
    bucket), warm-ups included; with ``keep_batches`` also keeps (engine,
    rows) of every batch that is not a warm-up's zeros."""
    from collections import Counter

    from storm_tpu_torch.infer.engine import InferenceEngine

    counts, batches = Counter(), []
    original = InferenceEngine.dispatch

    def counting(self, parts):
        n = sum(int(p.shape[0]) for p in parts)
        counts[(self.profile_key, self.pad_batch(n))] += 1
        if keep_batches:
            x = np.concatenate([np.array(p, copy=True) for p in parts])
            if x.any():
                batches.append((self, x))
        return original(self, parts)

    with mock.patch.object(InferenceEngine, "dispatch", counting):
        yield counts, batches


def read_jsonl(path: str) -> list:
    with open(path) as fh:
        return [json.loads(line) for line in fh]


def traced_main_path(torch, card: str, tmp: str) -> dict:
    """10 (a): the main path (as phase 5) with every record traced, the
    flight recorder on a file, the copy ledger and the profile store
    attached; the launch counts zeroed just before and read just after."""
    from storm_tpu_torch.config import TracingConfig
    from storm_tpu_torch.infer.engine import clear_engines, shared_engine
    from storm_tpu_torch.obs import copyledger, profile_store
    from storm_tpu_torch.ops import _build
    from storm_tpu_torch.runtime.tracing import device_trace

    model_cfg = vit_b16_config()
    flight_path = os.path.join(tmp, "flight.jsonl")
    tracing = TracingConfig(sample_rate=1.0, slo_ms=1000.0, flight_path=flight_path)
    clear_engines()
    copyledger.set_enabled(True)
    copyledger.copy_ledger().reset()
    profile_store().reset()

    def inspect(rt):
        e2e = rt.metrics.histogram("kafka-bolt", "e2e_latency_ms")
        ex = e2e.exemplar
        return {"traces": rt.tracer.store.recent(200), "stats": rt.tracer.store.stats(),
                "e2e": e2e.values().tolist(),
                "exemplar_stored": ex is not None and rt.tracer.store.get(ex[0]) is not None}

    _build.reset_launch_counts()
    with counted_dispatch() as (dispatched, _):
        r = asyncio.run(serve(model_cfg, tracing=tracing, inspect=inspect))
    wrapper_counts = _build.launch_counts()
    ledger = copyledger.copy_ledger().snapshot()
    profile = profile_store().snapshot()
    engine = shared_engine(model_cfg, r["batch_cfg"], device="cuda")
    launches = check_tally(torch, engine, VIT_B16_LAUNCHES, wrapper_counts,
                           "traced main path")
    if r["errors"] or len(r["outs"]) != len(r["inputs"]) or len(r["dlq"]) != 1:
        raise AssertionError(f"traced main path: {len(r['outs'])} outputs, {len(r['dlq'])} "
                             f"dead letters, errors {r['errors'][:3]}")
    ins = r["inspected"]
    traces = ins["traces"]
    delivered = [t for t in traces if any(s["name"] == "egress" and
                                          s["component"] == "kafka-bolt" for s in t["spans"])]
    if len(delivered) != len(r["outs"]) or ins["stats"]["open"]:
        raise AssertionError(f"traced main path: {len(delivered)} finished traces for "
                             f"{len(r['outs'])} records, store {ins['stats']}")
    groups = {}
    for t in delivered:
        spans = sorted(t["spans"], key=lambda s: s["offset_ms"])
        firsts = []
        for s in spans:
            if s["name"] not in firsts:
                firsts.append(s["name"])
        if firsts != TRACE_ORDER:
            raise AssertionError(f"trace {t['trace_id']}: spans {firsts}")
        (dev,), (qw,) = ([s for s in spans if s["name"] == n]
                         for n in ("device_execute", "queue_wait"))
        if dev["parent_id"] != qw["span_id"]:
            raise AssertionError(f"trace {t['trace_id']}: device span not under its queue_wait")
        groups.setdefault(dev["span_id"], []).append((dev, qw))
    for sid, members in groups.items():
        qws = {qw["span_id"] for _, qw in members}
        if any(set(dev["links"]) != qws for dev, _ in members):
            raise AssertionError(f"device span {sid}: links are not its members' queue_waits")
        dev = members[0][0]
        sub = sum(dev["attrs"][k] for k in ("h2d_ms", "compute_ms", "d2h_ms"))
        if sub > dev["duration_ms"] + 2e-3:  # each of the four rounded to 1e-3
            raise AssertionError(f"device span {sid}: substages {sub} ms over its "
                                 f"{dev['duration_ms']} ms")
    if len(groups) != len(r["batches"]):
        raise AssertionError(f"{len(groups)} device spans for {len(r['batches'])} batches")
    durations = sorted(t["duration_ms"] for t in delivered)
    if durations != sorted(round(v, 3) for v in ins["e2e"]) or not ins["exemplar_stored"]:
        raise AssertionError("trace durations are not the sink's e2e ms, or the e2e "
                             "histogram's exemplar names no stored trace")
    events = read_jsonl(flight_path)
    captures = [ev for ev in events if ev["kind"] == "graph_capture"]
    if not any(ev["kind"] == "batch_formed" for ev in events) or \
            sorted(ev["batch_shape"] for ev in captures) != sorted(engine.compiled_batches):
        raise AssertionError(f"flight file: {[ev['kind'] for ev in events]}, buckets "
                             f"captured {sorted(engine.compiled_batches)}")
    stages = ledger["stages"]
    want = ["spout_ingest", "spout_scheme", "json_decode", "tuple_route", "staging", "h2d",
            "d2h", "json_encode", "sink_encode"]
    if any(s not in stages for s in want):
        raise AssertionError(f"copy ledger stages {list(stages)}")
    # h2d: per batch the padded buffer of the wire dtype (bf16), from the shapes
    per_batch = {p: p * 224 * 224 * 3 * 2 for (_, p) in dispatched}
    h2d_want = sum(n * per_batch[p] for (_, p), n in dispatched.items())
    if stages["h2d"]["calls"] != sum(dispatched.values()) or stages["h2d"]["bytes"] != h2d_want:
        raise AssertionError(f"h2d row {stages['h2d']} against {dict(dispatched)} batches "
                             f"({h2d_want} bytes)")
    eng_prof = profile["engines"][engine.profile_key]
    got = {int(p): row["batches"] for p, row in eng_prof["buckets"].items()}
    if got != {p: n for (k, p), n in dispatched.items() if k == engine.profile_key} or \
            {int(p): c["count"] for p, c in eng_prof["compiles"].items()} != \
            {p: 1 for p in engine.compiled_batches}:
        raise AssertionError(f"profile store {got}, compiles {eng_prof['compiles']}, "
                             f"dispatched {dict(dispatched)}")
    profile_store().load_baseline(profile)
    regressions = profile_store().regressions(min_samples=1)
    if regressions:
        raise AssertionError(f"regressions against the store's own snapshot: {regressions}")
    bucket = engine.graph_for(B)
    trace_dir = os.path.join(tmp, "device_trace")
    with device_trace(trace_dir):
        for _ in range(3):
            bucket.replay()
    with open(os.path.join(trace_dir, "trace.json")) as fh:
        text = fh.read()
    named = {n: KERNEL_FUNCS[n] in text for n in VIT_B16_LAUNCHES}
    if not all(named.values()):
        raise AssertionError(f"device trace names {named}")
    e2e = r["snap"]["kafka-bolt"]["e2e_latency_ms"]
    # Each record's e2e cut at its spans' edges: broker append -> its
    # decode's start (the spout, the hop and the inbox behind the other
    # records' decodes), its decode (the inference bolt's execute), the
    # batcher (queue_wait), the device round trip as the event loop sees
    # it (device_execute), and the rest (encode, emit, the sink).
    cuts = []
    for t in delivered:
        sp = {(s["name"], s["component"]): s for s in t["spans"]}
        ex, qw = sp[("execute", "inference-bolt")], sp[("queue_wait", "inference-bolt")]
        dev = sp[("device_execute", "inference-bolt")]
        end = dev["offset_ms"] + dev["duration_ms"]
        cuts.append({"before_decode": ex["offset_ms"], "decode": ex["duration_ms"],
                     "queue_wait": qw["duration_ms"], "device_execute": dev["duration_ms"],
                     "after_device": t["duration_ms"] - end})
    breakdown = {k: float(np.median([c[k] for c in cuts])) for k in cuts[0]}
    decode_sum = sum(c["decode"] for c in cuts)
    res = {"launches": launches, "forwards": engine.forwards, "batches": len(groups),
           "e2e_p50_ms": e2e["p50"], "records_per_s": len(r["inputs"]) / r["wall"],
           "flight_events": len(events), "captures": len(captures),
           "ledger": {s: (stages[s]["bytes_per_record"], stages[s]["copies_per_record"])
                      for s in want},
           "copy_amplification": ledger["copy_amplification"],
           "breakdown_p50_ms": breakdown, "trace_ms_p50": float(np.median(durations)),
           "decodes_ms": decode_sum, "burst_ms": r["wall"] * 1e3}
    log(f"  traced main path on {card}: {len(delivered)} finished traces in span order "
        f"{TRACE_ORDER}, {len(groups)} device spans each linked to its members' queue_waits, "
        f"substages within each; durations = the sink's e2e ms; {len(events)} flight events "
        f"({len(captures)} graph_capture for buckets {sorted(engine.compiled_batches)}); "
        f"profile {got} batches = dispatches; device trace names {sorted(named)}; launch "
        f"tally {launches} for {engine.forwards} forwards")
    log(f"  traced main path: e2e p50 {res['e2e_p50_ms']:.3f} ms, "
        f"{res['records_per_s']:.3f} records/s; per record p50 (ms): "
        f"{({k: round(v, 3) for k, v in breakdown.items()})}, whole trace "
        f"{res['trace_ms_p50']:.3f}; the burst's decodes, serial on the event loop, "
        f"{decode_sum:.3f} ms of its {res['burst_ms']:.3f} ms")
    log(f"  copy ledger per record (bytes, copies): {res['ledger']}; amplification "
        f"{ledger['copy_amplification']}")
    return res


def overhead_turns(card: str) -> list:
    """10 (b), information only: the main path's burst with tracing off and
    the copy ledger detached, then on and attached, on, off."""
    from storm_tpu_torch.config import TracingConfig
    from storm_tpu_torch.obs import copyledger

    turns = []
    for on in (False, True, True, False):
        copyledger.set_enabled(on)
        r = asyncio.run(serve(vit_b16_config(),
                              tracing=TracingConfig(sample_rate=1.0 if on else 0.0)))
        if len(r["outs"]) != len(r["inputs"]) or r["errors"]:
            raise AssertionError(f"overhead turn {on}: {len(r['outs'])} outputs, errors "
                                 f"{r['errors'][:3]}")
        e2e = r["snap"]["kafka-bolt"]["e2e_latency_ms"]
        turns.append({"traced_and_ledger": on, "e2e_p50_ms": e2e["p50"],
                      "records_per_s": len(r["inputs"]) / r["wall"]})
        log(f"  overhead turn tracing+ledger {'on ' if on else 'off'}: e2e p50 "
            f"{e2e['p50']:.3f} ms, {turns[-1]['records_per_s']:.3f} records/s on {card}")
    copyledger.set_enabled(True)
    return turns


def shed_with_recorder(card: str, tmp: str) -> dict:
    """10 (c): phase 9b's shed turn, every record traced and the flight
    recorder on a file, the controller held to level 1 (best effort
    only): ``shed_decision`` events carry the controller's signals,
    ``shed_reject`` events name the best-effort lane alone, and every
    Overloaded record's trace holds its ``qos_shed`` span."""
    from storm_tpu_torch.config import QosConfig, TracingConfig
    from storm_tpu_torch.infer.engine import clear_engines

    records = longseq_records()
    n = len(records)
    path = os.path.join(tmp, "shed_flight.jsonl")
    shed_qos = QosConfig(enabled=True, shed_interval_s=0.02, shed_inbox_frac=0.25,
                         shed_breach_rate=1.0, shed_hot_steps=1, shed_calm_steps=1000)
    s = asyncio.run(serve_longseq(
        records, shed=shed_qos, tracing=TracingConfig(sample_rate=1.0, flight_path=path),
        max_level=1, inspect=lambda rt: rt.tracer.store.recent(500)))
    clear_engines()
    if s["errors"]:
        raise AssertionError(f"shed turn with recorder: errors {s['errors'][:3]}")
    msgs = [json.loads(rec.value) for rec in s["outs"]]
    over = [m for m in msgs if m.get("overloaded")]
    served = [m for m in msgs if "predictions" in m]
    if len(served) + len(over) + len(s["dlq"]) + s["dropped"] != n + 1:
        raise AssertionError(f"shed turn with recorder lost records: {len(served)}, "
                             f"{len(over)}, {len(s['dlq'])}, {s['dropped']} of {n + 1}")
    events = read_jsonl(path)
    decisions = [ev for ev in events if ev["kind"] == "shed_decision"]
    rejects = [ev for ev in events if ev["kind"] == "shed_reject"]
    signals = {"direction", "level", "inbox_frac", "wait_p95_ms", "breach_rate", "burn_rate"}
    if not decisions or any(not signals <= set(ev) for ev in decisions):
        raise AssertionError(f"shed_decision events {decisions}")
    if not over or {m["lane"] for m in over} != {"best_effort"} or not rejects or \
            {ev["lane"] for ev in rejects} != {"best_effort"}:
        raise AssertionError(f"Overloaded lanes {sorted({m['lane'] for m in over})}, "
                             f"shed_reject events {rejects}")
    shed_spans = [sp for t in s["inspected"] for sp in t["spans"] if sp["name"] == "qos_shed"]
    if len(shed_spans) != len(over) or any(sp["attrs"]["lane"] != "best_effort"
                                           for sp in shed_spans):
        raise AssertionError(f"{len(shed_spans)} qos_shed spans for {len(over)} Overloaded")
    res = {"decisions": s["decisions"], "shed_decision_events": len(decisions),
           "shed_reject_events": len(rejects), "overloaded": len(over),
           "predictions": len(served), "dropped_at_spout": s["dropped"]}
    log(f"  shed turn with the recorder on {card}: {len(decisions)} shed_decision events "
        f"(first {({k: decisions[0][k] for k in sorted(signals)})}), {len(rejects)} "
        f"shed_reject (best_effort), {len(over)} Overloaded records each with a qos_shed "
        f"span, {len(served)} predictions, {s['dropped']} dropped at the spout")
    return res


async def serve_swap(continuous: bool, waves: list, card: str) -> dict:
    """10 (d): lenet5_rgb_digits bf16 ``int8_fused`` through 1 spout -> 4
    InferenceBolts -> 1 sink (+ dead-letter sink), a wave at a time:
    wave A, the canary swap of task 0 to vit_tiny_digits, wave B, the
    promotion, wave C, the rollback, wave D. One poison record rides in
    wave A."""
    from storm_tpu_torch.config import BatchConfig, Config, OffsetsConfig
    from storm_tpu_torch.connectors import BrokerSink, BrokerSpout, MemoryBroker
    from storm_tpu_torch.infer import InferenceBolt
    from storm_tpu_torch.obs import profile_store
    from storm_tpu_torch.runtime import AsyncLocalCluster, TopologyBuilder

    cfg = Config()
    batch_cfg = BatchConfig(max_batch=32, buckets=(8, 32), max_wait_ms=5.0,
                            continuous=continuous)
    broker = MemoryBroker(default_partitions=1)
    tb = TopologyBuilder()
    tb.set_spout("kafka-spout", BrokerSpout(
        broker, "input", OffsetsConfig(policy="earliest", max_behind=None)))
    tb.set_bolt("infer", InferenceBolt(digits_config("lenet5_rgb_digits", "int8_fused"),
                                       batch_cfg, device="cuda"),
                parallelism=4).shuffle_grouping("kafka-spout")
    tb.set_bolt("kafka-bolt", BrokerSink(broker, "output", cfg.sink)).shuffle_grouping("infer")
    tb.set_bolt("dlq-bolt", BrokerSink(broker, "dead-letter", cfg.sink)) \
        .shuffle_grouping("infer", stream="dead_letter")
    cluster = AsyncLocalCluster()
    rt = await cluster.submit("chip-smoke-swap", cfg, tb.build())
    lenet = rt.bolt_execs["infer"][0].bolt.engine
    outs, out = [], {}

    async def wave(x, poison=False):
        start = broker.topic_size("output")
        for i, row in enumerate(x):
            broker.produce("input", json.dumps({"instances": [row.tolist()]}))
            if poison and i == len(x) // 2:
                broker.produce("input", '{"instances": [[1.0, 2.0], [3.0]]}')
        deadline = time.monotonic() + 120
        while broker.topic_size("output") < start + len(x):
            if time.monotonic() > deadline:
                raise TimeoutError(f"swap wave: {broker.topic_size('output') - start} of "
                                   f"{len(x)} out in 120 s")
            await asyncio.sleep(0.005)
        await rt.drain(timeout_s=60)
        outs.append([r.value.decode() if isinstance(r.value, bytes) else r.value
                     for r in broker.drain_topic("output")[start:]])

    def models():
        return [row["model"] for row in rt.component_stats("infer")]

    def built(engine):
        prof = profile_store().snapshot()["engines"].get(engine.profile_key, {})
        return (sorted(engine.compiled_batches), prof.get("compiles"),
                sum(ev["kind"] == "graph_capture" for ev in rt.flight.tail(1000)))

    out["models"] = {"start": models()}
    await wave(waves[0], poison=True)
    t0 = time.perf_counter()
    await rt.swap_model("infer", TO_VIT, tasks=[0])
    out["canary_ms"] = (time.perf_counter() - t0) * 1e3
    out["models"]["canary"] = models()
    await wave(waves[1])
    t0 = time.perf_counter()
    await rt.swap_model("infer", TO_VIT)
    out["promote_ms"] = (time.perf_counter() - t0) * 1e3
    out["models"]["promoted"] = models()
    vit = rt.bolt_execs["infer"][0].bolt.engine
    await wave(waves[2])
    before = built(lenet)
    t0 = time.perf_counter()
    await rt.swap_model("infer", TO_LENET)
    out["rollback_ms"] = (time.perf_counter() - t0) * 1e3
    out["models"]["rolled_back"] = models()
    out["rollback_same_engine"] = all(e.bolt.engine is lenet for e in rt.bolt_execs["infer"])
    out["rollback_built_nothing"] = built(lenet) == before
    await wave(waves[3])
    out["dlq"] = broker.drain_topic("dead-letter")
    out["errors"] = list(rt.errors)
    out["spout"] = rt.metrics.snapshot()["kafka-spout"]
    await cluster.shutdown()
    out.update(outs=outs, engines={"lenet5": lenet, "vit_tiny": vit})
    return out


def canary_swap(torch, card: str) -> dict:
    """10 (d), both ``continuous`` settings. Gates: no record lost or
    duplicated (every output byte-identical to the native encoding of the
    direct forward, by the engine that served it, of the batch it rode
    in, each wave's rows matched once), the poison record dead-lettered;
    waves A and D served by lenet5, wave C by vit_tiny (under
    ``continuous=True`` the C7 check), wave B by both; every output within
    the transport bound of its model's direct forward of its row; on rows
    whose JAX top-2 margin exceeds MARGIN, the argmax of the JAX
    reference of the model that served the row; the canary's descriptors;
    the rollback building nothing; each engine's launch tally."""
    from storm_tpu_torch.data import load_digits_nhwc
    from storm_tpu_torch.infer.continuous import _reset_registry
    from storm_tpu_torch.infer.engine import clear_engines
    from storm_tpu_torch.models.registry import CHECKPOINTS
    from storm_tpu_torch.native import format_predictions
    from storm_tpu_torch.ops import _build

    _, _, x, _ = load_digits_nhwc((32, 32, 3))
    rows_of = {}
    for i, row in enumerate(x):
        rows_of.setdefault(row.tobytes(), []).append(i)
    bounds = np.linspace(0, len(x), WAVES + 1).astype(int)
    waves = [x[a:b] for a, b in zip(bounds[:-1], bounds[1:])]
    with np.load(CHECKPOINTS / "reference_predictions.npz") as f:
        ref = {m: f[f"{tag}/int8_fused"] for m, tag in SWAP_TAGS.items()}
    results = {}
    for continuous in (False, True):
        clear_engines()
        _reset_registry()
        _build.reset_launch_counts()
        with counted_dispatch(keep_batches=True) as (_, batches):
            r = asyncio.run(serve_swap(continuous, waves, card))
        wrapper_counts = _build.launch_counts()
        _reset_registry()
        label = f"swap continuous={continuous}"
        if r["errors"] or len(r["dlq"]) != 1 or r["spout"].get("tree_failed", 0) or \
                r["spout"]["tree_acked"] != len(x) + 1:
            raise AssertionError(f"{label}: errors {r['errors'][:3]}, {len(r['dlq'])} dead "
                                 f"letters, spout {r['spout']}")
        engines = r["engines"]
        name_of = {id(e): m for m, e in engines.items()}
        # every served batch again through the engine that served it
        expect = {}
        for eng, xb in batches:
            for row, pred in zip(xb, eng.predict(xb)):
                expect.setdefault(format_predictions(pred[None]), []).append(
                    (name_of[id(eng)], row.tobytes(), pred))
        direct = {m: np.concatenate([e.predict(x[i:i + 32]) for i in range(0, len(x), 32)])
                  for m, e in engines.items()}
        served_by, max_dp, flips = [], 0.0, 0
        for w, (xw, got) in enumerate(zip(waves, r["outs"])):
            if len(got) != len(xw):
                raise AssertionError(f"{label} wave {w}: {len(got)} outputs for {len(xw)}")
            left = {}
            for row in xw:
                left[row.tobytes()] = left.get(row.tobytes(), 0) + 1
            who = []
            for text in got:
                hits = [h for h in expect.get(text, ()) if left.get(h[1], 0) > 0]
                if not hits:
                    raise AssertionError(f"{label} wave {w}: an output is not the bytes of "
                                         f"the direct forward of a row of this wave left "
                                         f"unserved (lost, duplicated or not its batch's)")
                model, key, pred = hits[0]
                expect[text].remove(hits[0])
                left[key] -= 1
                i = rows_of[key][0]
                max_dp = max(max_dp, float(np.abs(pred - direct[model][i]).max()))
                want = ref[model][i]
                top2 = np.sort(want)[-2:]
                if top2[1] - top2[0] > MARGIN and pred.argmax() != want.argmax() and \
                        pred[want.argmax()] != pred.max():
                    flips += 1
                who.append(model)
            served_by.append(who)
        if max_dp > TRANSPORT_TOL["int8_fused"] or flips:
            raise AssertionError(f"{label}: max |dp| to the direct forward {max_dp}, "
                                 f"{flips} argmax flips on decided rows")
        kinds = [sorted(set(w)) for w in served_by]
        n_vit_b = served_by[1].count("vit_tiny")
        if kinds[0] != ["lenet5"] or kinds[2] != ["vit_tiny"] or kinds[3] != ["lenet5"] or \
                not 0 < n_vit_b < len(served_by[1]):
            raise AssertionError(f"{label}: waves served by {kinds}, vit_tiny served "
                                 f"{n_vit_b} of wave B")
        lenet_d = "lenet5:checkpoints/lenet5_rgb_digits:int8_fused"
        vit_d = "vit_tiny:checkpoints/vit_tiny_digits:int8_fused"
        if r["models"] != {"start": [lenet_d] * 4, "canary": [vit_d] + [lenet_d] * 3,
                           "promoted": [vit_d] * 4, "rolled_back": [lenet_d] * 4}:
            raise AssertionError(f"{label}: descriptors {r['models']}")
        if not (r["rollback_same_engine"] and r["rollback_built_nothing"]):
            raise AssertionError(f"{label}: the rollback built an engine or a bucket")
        tally = {}
        for model, eng in engines.items():
            t, fw = eng.launch_tally(), eng.forwards
            want = {k: SWAP_LAUNCHES[model].get(k, 0) * fw for k in KERNEL_FUNCS}
            if {k: t.get(k, 0) for k in KERNEL_FUNCS} != want:
                raise AssertionError(f"{label}: {model} tally {t} for {fw} forwards")
            tally[model] = {"forwards": fw, **{k: v for k, v in want.items() if v}}
        used = set(SWAP_LAUNCHES["lenet5"]) | set(SWAP_LAUNCHES["vit_tiny"])
        if any((wrapper_counts[k] > 0) != (k in used) for k in KERNEL_FUNCS):
            raise AssertionError(f"{label}: eager launches by the wrappers {wrapper_counts}")
        results[continuous] = {
            "canary_ms": r["canary_ms"], "promote_ms": r["promote_ms"],
            "rollback_ms": r["rollback_ms"], "vit_tiny_in_wave_b": n_vit_b,
            "wave_sizes": [len(w) for w in waves], "max_dp": max_dp, "tally": tally}
        log(f"  {label} on {card}: {len(x)} rows in {WAVES} waves, each output the bytes "
            f"of its batch's direct forward; waves served by {kinds} (vit_tiny {n_vit_b} of "
            f"{len(served_by[1])} in the canary wave); max |dp| to the model's direct "
            f"forward {max_dp:.4f}; 0 argmax flips on decided rows; canary swap "
            f"{r['canary_ms']:.3f} ms, promotion {r['promote_ms']:.3f} ms, rollback "
            f"{r['rollback_ms']:.3f} ms (same engine, nothing built); tally {tally}")
    clear_engines()
    return results


def observe_and_swap(torch, card: str) -> dict:
    import tempfile

    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory() as tmp:
        res = {"traced": traced_main_path(torch, card, tmp),
               "overhead_turns": overhead_turns(card),
               "shed": shed_with_recorder(card, tmp),
               "swap": canary_swap(torch, card)}
    res["wall_s"] = time.perf_counter() - t0
    log(f"  phase 10 took {res['wall_s']:.1f} s")
    return res


# ---- phase 11: the binary record plane -------------------------------------------

# ViT-B/16 launches per forward (bf16 int8_fused), as phase 5 holds them.
VIT_LAUNCHES = {"w8a16_matmul_sm90": 73, "residual_layernorm_sm90": 12,
                "flash_attention_sm90": 12}
RP_RECORDS = 64   # seeded (1, 224, 224, 3) float32 tensor records a turn
RP_JSON_AT = 20   # where the one JSON record rides among them
RP_POISON_AT = 40
RP_CHUNK = 8
RP_SHAPE = (224, 224, 3)


def record_plane_stream(json_only: bool = False) -> dict:
    """The record plane's stream in produce order: 65 seeded (1, 224, 224,
    3) float32 records, 64 of them Arrow tensor messages written by the
    port's ``encode_tensor`` and one (the 21st) ``{"instances": ...}``
    JSON, and a poison record (a tensor message cut short: 0xFF-led,
    truncated) at position 40. ``json_only``: every record JSON, the
    poison ragged JSON. ``which[k]`` is payload k's row of ``inputs``
    (None for the poison)."""
    from storm_tpu_torch.serve.marshal import encode_tensor

    rng = np.random.RandomState(21)
    inputs = rng.rand(RP_RECORDS + 1, *RP_SHAPE).astype(np.float32)
    payloads = []
    for i, x in enumerate(inputs):
        if json_only or i == RP_JSON_AT:
            payloads.append(json.dumps({"instances": x[None].tolist()}).encode())
        else:
            payloads.append(encode_tensor(x[None]))
    which = list(range(len(inputs)))
    poison = (b'{"instances": [[1.0, 2.0], [3.0]]}' if json_only
              else encode_tensor(inputs[:1])[:4096])
    payloads.insert(RP_POISON_AT, poison)
    which.insert(RP_POISON_AT, None)
    return {"inputs": inputs, "payloads": payloads, "which": which}


def longseq_plane_stream() -> tuple:
    """Phase 9b's 48 longseq records (same seed, keys ``tenant:lane``) as
    float32 Arrow tensor messages, and a truncated tensor message keyed
    ``gold:high`` after the first half: (stream, keys)."""
    from storm_tpu_torch.serve.marshal import encode_tensor

    records = longseq_records()
    inputs = np.concatenate([np.asarray(json.loads(p)["instances"], np.float32)
                             for _, p, _ in records])
    payloads = [encode_tensor(x[None]) for x in inputs]
    keys = [k for k, _, _ in records]
    which = list(range(len(inputs)))
    at = len(inputs) // 2 + 1
    payloads.insert(at, encode_tensor(inputs[:1])[:4096])
    keys.insert(at, b"gold:high")
    which.insert(at, None)
    return {"inputs": inputs, "payloads": payloads, "which": which}, keys


def _rows_of(value) -> int:
    from storm_tpu_torch.api.schema import decode_predictions

    return decode_predictions(value).data.shape[0]


async def serve_record_plane(model_cfg, batch_cfg, stream: dict, *, chunk: int, scheme: str,
                             frames: bool, qos=None, keys=None) -> dict:
    """``stream`` through ``build_standard_topology`` (2 spouts / 4
    inference bolts / 2 sinks and the dead-letter sink, on the card) with
    the topology's ``spout_chunk``, ``spout_scheme`` and ``spout_frames``
    set: the user's way in. The engine's dispatch is wrapped to keep a
    copy of every batch; the copy ledger is reset once the engine is warm;
    the lanes of every chunk the spouts emit are recorded. Waits until
    every good record's row and the dead letter are out."""
    from storm_tpu_torch.config import Config, OffsetsConfig
    from storm_tpu_torch.connectors import MemoryBroker
    from storm_tpu_torch.connectors.spout import BrokerSpout
    from storm_tpu_torch.main import build_standard_topology
    from storm_tpu_torch.obs import copyledger
    from storm_tpu_torch.runtime import AsyncLocalCluster

    cfg = Config()
    cfg.model, cfg.batch = model_cfg, batch_cfg
    cfg.offsets = OffsetsConfig(policy="earliest", max_behind=None)
    cfg.topology.spout_chunk, cfg.topology.spout_scheme = chunk, scheme
    cfg.topology.spout_frames = frames
    if qos is not None:
        cfg.qos = qos
    broker = MemoryBroker(default_partitions=2)
    groups = []
    emit_chunk = BrokerSpout._emit_chunk

    async def recording_emit_chunk(self, records):
        groups.append(sorted({self._lane_of(r) for r in records}) if self.qos else None)
        await emit_chunk(self, records)

    BrokerSpout._emit_chunk = recording_emit_chunk
    cluster = AsyncLocalCluster()
    try:
        rt = await cluster.submit("chip-smoke-record-plane", cfg,
                                  build_standard_topology(cfg, broker, device="cuda"))
        engine = rt.bolt_execs["inference-bolt"][0].bolt.engine
        batches = []
        dispatch = engine.dispatch

        def recording_dispatch(parts):
            batches.append(np.concatenate([np.array(p, copy=True) for p in parts]))
            return dispatch(parts)

        engine.dispatch = recording_dispatch
        copyledger.copy_ledger().reset()
        n_good = sum(w is not None for w in stream["which"])
        t0 = time.perf_counter()
        for i, p in enumerate(stream["payloads"]):
            broker.produce("input", p, key=keys[i] if keys else None)
        rows, cursor = 0, {}
        deadline = time.monotonic() + 300
        while rows < n_good or broker.topic_size("dead-letter") < 1:
            if time.monotonic() > deadline:
                raise TimeoutError(f"record plane: {rows} of {n_good} rows out in 300 s")
            await asyncio.sleep(0.005)
            for p in range(broker.partitions_for("output")):
                new = broker.fetch("output", p, cursor.get(p, 0), 1 << 20)
                cursor[p] = cursor.get(p, 0) + len(new)
                rows += sum(_rows_of(rec.value) for rec in new)
        wall = time.perf_counter() - t0
        await rt.drain(timeout_s=60)
        del engine.dispatch
        snap = rt.metrics.snapshot()
        errors = list(rt.errors)
        tree = copyledger.copy_ledger().snapshot()
        outs, dlq = broker.drain_topic("output"), broker.drain_topic("dead-letter")
        ins = broker.drain_topic("input")
    finally:
        BrokerSpout._emit_chunk = emit_chunk
        await cluster.shutdown()
    return {"outs": outs, "dlq": dlq, "ins": ins, "snap": snap, "errors": errors,
            "wall": wall, "batches": batches, "tree": tree, "groups": groups}


def check_record_plane(r: dict, engine, stream: dict, label: str, coalesce: bool,
                       chunk: int = RP_CHUNK, lanes: bool = False) -> dict:
    """The gates of one record-plane turn. Every batch the engine was given
    holds each good record's row exactly once (rows matched to records by
    their bytes: no record replayed); every output payload is, byte for
    byte, the native encoding of a run of rows of the engine's direct
    forward of one batch: one row (``coalesce`` False) or the rows of one
    frame (with ``coalesce``: the records of one chunk, by partition,
    offset // chunk and, under QoS, lane); together they answer each good
    record exactly once. The poison is dead-lettered, no tree failed.
    Returns the turn's numbers: e2e per record (its own append to its
    payload's) and per output message (the sink's clock: the chunk's
    oldest append), records/s, the bolt's decode_ms and the decodes'
    share of the burst, the substages, the ledger's amplification."""
    from storm_tpu_torch.native import format_predictions

    inputs, which = stream["inputs"], stream["which"]
    snap, infer, spout = r["snap"], r["snap"]["inference-bolt"], r["snap"]["kafka-spout"]
    if r["errors"]:
        raise AssertionError(f"{label} reported errors: {r['errors'][:3]}")
    if len(r["dlq"]) != 1 or infer["dead_lettered"] != 1:
        raise AssertionError(f"{label}: {len(r['dlq'])} dead letters")
    dl = json.loads(r["dlq"][0].value)
    if dl["stage"] != "decode":
        raise AssertionError(f"{label}: dead letter {dl['error']!r}")
    if spout.get("tree_failed", 0):
        raise AssertionError(f"{label}: {spout['tree_failed']} trees failed (a replay)")
    index = {inputs[i].tobytes(): i for i in range(len(inputs))}
    direct, owner = [], []
    for b in r["batches"]:
        direct.append(engine.predict(b))
        try:
            owner.append([index[row.tobytes()] for row in b])
        except KeyError:
            raise AssertionError(f"{label}: a batch row is no record's input") from None
    if sorted(i for o in owner for i in o) != list(range(len(inputs))):
        raise AssertionError(f"{label}: the batches did not hold each record once")
    runs = {}
    for k, rows in enumerate(direct):
        for i in range(len(rows)):
            for j in (range(i + 1, len(rows) + 1) if coalesce else (i + 1,)):
                runs.setdefault(format_predictions(rows[i:j]), []).append((k, i, j))
    # Each record's partition, offset and append time, from the input topic.
    slot = {p: w for p, w in zip(stream["payloads"], stream["which"]) if w is not None}
    origin = {slot[rec.value]: rec for rec in r["ins"] if rec.value in slot}

    def frame_of(i):
        rec = origin[i]
        lane = rec.key.decode().split(":")[1] if lanes else None
        return rec.partition, rec.offset // chunk, lane

    used, per_record, per_message = set(), [], []
    for rec in r["outs"]:
        text = rec.value.decode() if isinstance(rec.value, bytes) else rec.value
        cands = [c for c in runs.get(text, ())
                 if not any((c[0], x) in used for x in range(c[1], c[2]))]
        if not cands:
            raise AssertionError(f"{label}: an output is not the bytes of "
                                 f"{'a run of rows' if coalesce else 'a row'} of the engine's "
                                 f"direct forward of its batch")
        k, i, j = cands[0]
        used.update((k, x) for x in range(i, j))
        members = [owner[k][x] for x in range(i, j)]
        if coalesce and len({frame_of(m) for m in members}) != 1:
            raise AssertionError(f"{label}: an output payload mixes frames")
        per_record += [(rec.timestamp - origin[m].timestamp) * 1e3 for m in members]
        per_message.append((rec.timestamp - min(origin[m].timestamp for m in members)) * 1e3)
    if len(used) != len(inputs):
        raise AssertionError(f"{label}: {len(used)} of {len(inputs)} records answered")
    tree = r["tree"]
    res = {"records": len(inputs), "outputs": len(r["outs"]), "batches": len(r["batches"]),
           "roots": spout["tree_acked"], "records_per_s": len(inputs) / r["wall"],
           "e2e_p50_ms_per_record": float(np.median(per_record)),
           "e2e_p50_ms_per_message": float(np.median(per_message)),
           "sink_e2e_p50_ms": snap["kafka-bolt"]["e2e_latency_ms"]["p50"],
           "decode_ms_p50": infer["decode_ms"]["p50"],
           "decode_share": infer["decode_ms"]["sum"] / (r["wall"] * 1e3),
           "substages_p50": {s: infer[s]["p50"] for s in ("h2d_ms", "compute_ms", "d2h_ms")},
           "amplification": tree["copy_amplification"],
           "ledger": {s: {k: v[k] for k in ("calls", "bytes", "copies", "records")}
                      for s, v in tree["stages"].items()}}
    return res


def log_turn(label: str, res: dict, card: str) -> None:
    log(f"  {label} on {card}: {res['records_per_s']:.3f} records/s; e2e p50 "
        f"{res['e2e_p50_ms_per_record']:.3f} ms per record, "
        f"{res['e2e_p50_ms_per_message']:.3f} ms per output message (sink "
        f"{res['sink_e2e_p50_ms']:.3f}); {res['outputs']} outputs over {res['batches']} "
        f"batches, {res['roots']} roots; bolt decode_ms p50 {res['decode_ms_p50']:.4f}, "
        f"decodes {100 * res['decode_share']:.1f} % of the burst; substages p50 "
        f"{res['substages_p50']}; ledger amplification {res['amplification']}")


def check_tally_delta(engine, before: dict, forwards_before: int, per_forward: dict,
                      wrapper_counts: dict, path: str) -> dict:
    """A later turn on a warm engine: its launches are exactly its forwards
    x ``per_forward`` (every forward a graph replay: no eager launch)."""
    tally, n = engine.launch_tally(), engine.forwards - forwards_before
    delta = {k: tally.get(k, 0) - before.get(k, 0) for k in KERNEL_FUNCS}
    want = {k: per_forward.get(k, 0) * n for k in KERNEL_FUNCS}
    if delta != want or any(wrapper_counts.values()) or n <= 0:
        raise AssertionError(f"{path}: launches {delta} for {n} forwards (want {want}), "
                             f"eager {wrapper_counts}")
    return {k: delta[k] for k in KERNEL_FUNCS}


def record_plane(torch, card: str, served: dict) -> dict:
    """Phase 11: the binary record plane on the card (see the module
    docstring), each turn's launch counts zeroed just before and read just
    after."""
    from storm_tpu_torch.config import BatchConfig, QosConfig
    from storm_tpu_torch.infer.continuous import _reset_registry
    from storm_tpu_torch.infer.engine import clear_engines, shared_engine
    from storm_tpu_torch.ops import _build

    out = {"launches": {}, "turns": {}}
    model = vit_b16_config()
    tensors = record_plane_stream()

    def batch(egress: bool):
        return BatchConfig(max_batch=B, buckets=(B,), max_wait_ms=50.0, frame_egress=egress)

    # (a) tensor records in frames, frame egress on: the path this slice adds.
    clear_engines()
    _build.reset_launch_counts()
    r = asyncio.run(serve_record_plane(model, batch(True), tensors, chunk=RP_CHUNK,
                                       scheme="raw", frames=True))
    engine = shared_engine(model, batch(True), device="cuda")
    out["launches"]["a"] = check_tally(torch, engine, VIT_LAUNCHES, _build.launch_counts(),
                                       "record plane (a)")
    res = check_record_plane(r, engine, tensors, "record plane (a)", coalesce=True)
    st = r["tree"]["stages"]
    n_good = len(tensors["inputs"])
    if not res["outputs"] < n_good:
        raise AssertionError(f"record plane (a): {res['outputs']} outputs for {n_good} "
                             f"records: frame egress did not coalesce")
    if (st["json_decode"]["records"], st["json_decode"]["bytes"]) != (n_good, int(np.prod(RP_SHAPE)) * 4) \
            or st["marshal_decode"]["bytes"] != 0 or st["marshal_decode"]["copies"] != 0 \
            or st["marshal_decode"]["records"] != RP_RECORDS:
        raise AssertionError(f"record plane (a): decode rows {st['json_decode']}, "
                             f"{st['marshal_decode']}: a tensor record was copied")
    if st["batch_route"]["calls"] != res["roots"] or st["batch_route"]["bytes"] != 0 \
            or st["batch_route"]["records"] != n_good + 1:
        raise AssertionError(f"record plane (a): batch_route {st['batch_route']} for "
                             f"{res['roots']} frames")
    sink_rows = st.get("sink_encode", {}).get("engines", {})
    if set(sink_rows) != {"dlq-bolt"} or sink_rows["dlq-bolt"]["calls"] != 1:
        raise AssertionError(f"record plane (a): sink_encode rows {sink_rows}: predictions "
                             f"re-encoded by the sink")
    if st["json_encode"]["calls"] != res["outputs"] or st["json_encode"]["records"] != n_good:
        raise AssertionError(f"record plane (a): json_encode {st['json_encode']}")
    out["turns"]["a"] = res
    log(f"  record plane (a) raw + frames + frame egress: {n_good} records + 1 poison, "
        f"{res['outputs']} output payloads, each the bytes of one (frame, batch) run of its "
        f"batch's direct forward; every record once, the poison dead-lettered, no replay; "
        f"ledger: json_decode {st['json_decode']['bytes']:.0f} bytes over "
        f"{st['json_decode']['records']} records, marshal_decode 0 bytes over "
        f"{st['marshal_decode']['records']}, batch_route {st['batch_route']['calls']} calls = "
        f"{res['roots']} frames, sink_encode only the dead letter; launch tally "
        f"{out['launches']['a']}")
    log_turn("record plane (a)", res, card)

    # (b) the same stream, one output per record.
    for name, stream, kw in (
            ("b", tensors, dict(scheme="raw", frames=True, egress=False)),
            ("c", record_plane_stream(json_only=True),
             dict(scheme="string", frames=False, egress=True))):
        before, fw = engine.launch_tally(), engine.forwards
        _build.reset_launch_counts()
        r = asyncio.run(serve_record_plane(model, batch(kw["egress"]), stream, chunk=RP_CHUNK,
                                           scheme=kw["scheme"], frames=kw["frames"]))
        out["launches"][name] = check_tally_delta(engine, before, fw, VIT_LAUNCHES,
                                                  _build.launch_counts(),
                                                  f"record plane ({name})")
        res = check_record_plane(r, engine, stream, f"record plane ({name})", coalesce=False)
        if res["outputs"] != n_good:
            raise AssertionError(f"record plane ({name}): {res['outputs']} outputs for "
                                 f"{n_good} records")
        st = r["tree"]["stages"]
        if name == "c" and (st["spout_scheme"]["records"] != n_good + 1
                            or st["sink_encode"]["calls"] != n_good + 1):
            raise AssertionError(f"record plane (c): string-scheme rows {st['spout_scheme']}, "
                                 f"{st['sink_encode']}")
        out["turns"][name] = res
        log(f"  record plane ({name}) {kw}: {n_good} outputs, one a record, each the bytes of "
            f"its row of its batch's direct forward; launches {out['launches'][name]}")
        log_turn(f"record plane ({name})", res, card)
    del engine
    clear_engines()

    # (d) longseq_encoder with phase 9b's QoS lanes, chunks of 8 in frames.
    ls_stream, keys = longseq_plane_stream()
    for name, cont in (("d", True), ("d2", False)):
        _reset_registry()
        clear_engines()
        _build.reset_launch_counts()
        r = asyncio.run(serve_record_plane(
            longseq_config(), longseq_batch(max_wait_ms=100.0, continuous=cont), ls_stream,
            chunk=RP_CHUNK, scheme="raw", frames=True, qos=QosConfig(enabled=True), keys=keys))
        engine = shared_engine(longseq_config(), longseq_batch(), device="cuda")
        out["launches"][name] = check_tally(torch, engine, LS_LAUNCHES, _build.launch_counts(),
                                            f"record plane ({name})")
        label = f"record plane ({name}) longseq QoS, continuous={cont}"
        res = check_record_plane(r, engine, ls_stream, label, coalesce=not cont, lanes=True)
        if any(g is None or len(g) != 1 for g in r["groups"]) or \
                len(r["groups"]) != res["roots"]:
            raise AssertionError(f"{label}: chunks not lane-homogeneous: {r['groups']}")
        n = len(ls_stream["inputs"])
        lanes = {ln: r["snap"]["kafka-bolt"].get(f"e2e_latency_ms_{ln}", {}).get("count", 0)
                 for ln in LS_LANES}
        if cont and lanes != {ln: n // 3 for ln in LS_LANES}:
            raise AssertionError(f"{label}: per-lane outputs {lanes}")
        res["lane_outputs"] = lanes
        out["turns"][name] = res
        log(f"  {label}: {n} records + 1 poison in {len(r['groups'])} lane-homogeneous chunks, "
            f"{res['outputs']} outputs (per lane {lanes}), every record once, none lost; "
            f"launch tally {out['launches'][name]}")
        log_turn(label, res, card)
        del engine
        clear_engines()
    _reset_registry()

    log(f"  beside phase 5's JSON turn on {card} (16 records, string scheme, no chunks): "
        f"{served['records_per_s']:.3f} records/s, e2e p50 {served['e2e_p50_ms']:.3f} ms, "
        f"decode_ms p50 {served['decode_ms_p50']:.3f}")
    for name, res in out["turns"].items():
        log(f"    turn {name:2s}: {res['records_per_s']:.3f} records/s, e2e p50 "
            f"{res['e2e_p50_ms_per_record']:.3f} ms a record / "
            f"{res['e2e_p50_ms_per_message']:.3f} ms a message, decode_ms p50 "
            f"{res['decode_ms_p50']:.4f}, decodes {100 * res['decode_share']:.1f} %, "
            f"amplification {res['amplification']}")
    return out


# ---- phase 12: the cascade and the Observatory --------------------------------------

# The published operating point (ACCURACY_CASCADE_r09.json): tiers cheapest
# first, the max-softmax metric re-tempered at T = 1.25, and the accuracy
# its 224 served rows reached (the flagship's), held within EPSILON.
CASCADE_TAGS = ("vit_tiny_digits", "lenet5_rgb_digits", "resnet20_digits")
CASCADE_TIERS = ("vit_tiny", "lenet5", "resnet20")
CASCADE_THRESHOLDS, CASCADE_TEMPERATURE = (0.02, 0.1), 1.25
CASCADE_ACC, CASCADE_EPSILON = 0.9955, 0.005
CASCADE_ARTIFACT = "ACCURACY_CASCADE_r09.json"
# Kernel launches per forward of each tier (the digits modes of phase 6):
# in float32 vit_tiny's 2 blocks run the f32 flash kernel and the fused
# norm; in bf16 int8_fused its 13 dense layers, lenet5's 3 and resnet20's
# head run w8a16 too.
CASCADE_LAUNCHES = {
    "float32": {"vit_tiny": {"flash_attention": 2, "residual_layernorm_sm90": 2},
                "lenet5": {}, "resnet20": {}},
    "int8_fused": {"vit_tiny": {"w8a16_matmul_sm90": 13, "flash_attention_sm90": 2,
                                "residual_layernorm_sm90": 2},
                   "lenet5": {"w8a16_matmul_sm90": 3}, "resnet20": {"w8a16_matmul_sm90": 1}}}
# A served row's output against its tier's direct forward of the batch it
# rode in (re-run on the same engine, so equal up to nothing in practice).
CASCADE_TRANSPORT = {"float32": 1e-5, "int8_fused": 1e-3}
# Rows whose reference uncertainty lies within this of a threshold are
# printed apart and may serve at the neighbouring tier: float32's band is
# fixed; bf16 int8_fused's is the largest |u_port - u_JAX| of the tier
# engines' direct forwards on these rows (the port's bf16 rounds each
# op's output, XLA on the CPU keeps f32 intermediates), at least 1e-3.
CASCADE_F32_BAND, CASCADE_BAND_CAP = 1e-3, 0.05
CASCADE_BATCH = dict(max_batch=32, buckets=(8, 32), max_wait_ms=20.0)
OBS_RECORDS = 64
OBS_ROUNDS, OBS_GAP_S = 4, 0.2  # the burst in rounds, for the ledger's windows
DEGRADE_RECORDS = 672
DEGRADE_LANES, DEGRADE_TENANTS = ("high", "normal", "best_effort"), ("gold", "free")


def cascade_model(tag: str, mode: str):
    from storm_tpu_torch.config import ModelConfig

    if mode == "float32":
        return ModelConfig.from_checkpoint(f"checkpoints/{tag}", dtype="float32")
    return digits_config(tag, mode)


def cascade_config():
    from storm_tpu_torch.cascade import CascadeConfig

    return CascadeConfig(enabled=True, tiers=CASCADE_TIERS,
                         checkpoints=tuple(f"checkpoints/{t}" for t in CASCADE_TAGS),
                         metric="max_softmax", thresholds=CASCADE_THRESHOLDS,
                         temperature=CASCADE_TEMPERATURE)


def cascade_tiers(u0: np.ndarray, u1: np.ndarray) -> np.ndarray:
    return np.where(u0 < CASCADE_THRESHOLDS[0], 0, np.where(u1 < CASCADE_THRESHOLDS[1], 1, 2))


def wire_control(rt, cfg, infer_id: str = "inference-bolt", sink_id: str = "kafka-bolt"):
    """The shed controller and the Observatory wired as storm_tpu's
    ``main.py`` wires them: a controller when QoS is on, an Observatory
    when ``cfg.obs`` is on, and the controller reads its burn tracker."""
    from storm_tpu_torch.obs import Observatory
    from storm_tpu_torch.qos import LoadShedController, ShedPolicy

    shedders = []
    if cfg.qos.enabled:
        shedders = [LoadShedController(rt, ShedPolicy.from_qos(cfg.qos, infer_id,
                                                                sink_id)).start()]
    observatory = None
    if cfg.obs.enabled:
        observatory = Observatory(rt, cfg.obs, sink_components=(sink_id,)).start()
        for shedder in shedders:
            shedder.burn = observatory.burn
    return shedders, observatory


async def serve_standard(cfg, payloads: list, keys=None, n_out: int = None, hold_level=None,
                         before_traffic=None, inspect=None, rounds: int = 1,
                         gap_s: float = 0.0) -> dict:
    """``payloads`` through ``build_standard_topology`` (2/4/2 and the
    dead-letter sink, on the card), the control loops wired as
    storm_tpu's main.py wires them; ``hold_level`` caps the shed
    controller's level (phase 10 (c)'s way). Waits until ``n_out``
    records are out of the output topic, the dead-letter topic and the
    spouts' drops together. ``before_traffic(rt, observatory)`` and
    ``inspect(rt, observatory)`` run around the burst; ``rounds`` splits
    it into that many bursts ``gap_s`` apart (the copy ledger's windows
    start per hop at a step's first read: a spout fetches a burst at once,
    so only a later burst's ingest lands in a window)."""
    from storm_tpu_torch.connectors import MemoryBroker
    from storm_tpu_torch.main import build_standard_topology
    from storm_tpu_torch.runtime import AsyncLocalCluster

    broker = MemoryBroker(default_partitions=2)
    cluster = AsyncLocalCluster()
    rt = await cluster.submit("chip-smoke-phase12", cfg,
                              build_standard_topology(cfg, broker, device="cuda"))
    shedders, observatory = wire_control(rt, cfg)
    if hold_level is not None:
        for shedder in shedders:
            shedder.policy.max_level = hold_level
    pre = before_traffic(rt, observatory) if before_traffic is not None else None
    spouts = [e.spout for e in rt.spout_execs["kafka-spout"]]
    n_out = len(payloads) if n_out is None else n_out
    t0 = time.perf_counter()
    per = -(-len(payloads) // rounds)
    for i, p in enumerate(payloads):
        if i and i % per == 0:
            await asyncio.sleep(gap_s)
        broker.produce("input", p, key=keys[i] if keys else None)
    deadline = time.monotonic() + 300
    while (broker.topic_size("output") + broker.topic_size("dead-letter")
           + sum(s.dropped for s in spouts)) < n_out:
        if time.monotonic() > deadline:
            raise TimeoutError(f"phase 12: {broker.topic_size('output')} of {n_out} out in 300 s")
        await asyncio.sleep(0.005)
    wall = time.perf_counter() - t0
    await rt.drain(timeout_s=60)
    for shedder in shedders:
        await shedder.stop()
    if observatory is not None:
        await observatory.stop()
    inspected = inspect(rt, observatory) if inspect is not None else None
    out = {"outs": broker.drain_topic("output"), "dlq": broker.drain_topic("dead-letter"),
           "snap": rt.metrics.snapshot(), "errors": list(rt.errors), "wall": wall,
           "dropped": sum(s.dropped for s in spouts), "flight": rt.flight.tail(10_000),
           "decisions": [d for s in shedders for d in s.decisions], "pre": pre,
           "inspected": inspected, "inventory": None}
    router = rt.bolt_execs["inference-bolt"][0].bolt._router
    if router is not None:
        out["inventory"] = router.inventory()
    await cluster.shutdown()
    return out


def row_index(x: np.ndarray) -> dict:
    """Each row's bytes -> its indices in ``x``."""
    index = {}
    for i, row in enumerate(x):
        index.setdefault(row.tobytes(), []).append(i)
    return index


def tiers_served(batches: list, engines: list, index: dict, n: int) -> tuple:
    """From the batches each tier engine was given: the highest tier each
    row reached (the tier that answered it) and, per row, that tier's
    direct forward of the very batch it rode in (re-run on the engine)."""
    served = np.full(n, -1)
    direct = np.full((n, 10), np.nan, np.float32)
    for engine, x in batches:
        tier = next(i for i, e in enumerate(engines) if e is engine)
        rows = engine.predict(x)
        for row, pred in zip(x, rows):
            for i in index[row.tobytes()]:
                if tier >= served[i]:
                    served[i], direct[i] = tier, pred
    return served, direct


def cascade_at_point(torch, mode: str, ref: dict, card: str) -> dict:
    """12 (a) (float32) and (b) (bf16 int8_fused): the three digits tiers
    through ``build_standard_topology`` at the published operating point,
    the 224 odd held-out rows one a record and one poison, the launch
    counts zeroed just before and read just after."""
    from storm_tpu_torch.api.schema import decode_predictions
    from storm_tpu_torch.cascade import uncertainty
    from storm_tpu_torch.config import BatchConfig, Config, OffsetsConfig
    from storm_tpu_torch.data import load_digits_nhwc
    from storm_tpu_torch.infer.engine import clear_engines, shared_engine
    from storm_tpu_torch.infer.graphs import replay_ms
    from storm_tpu_torch.obs import profile_store
    from storm_tpu_torch.ops import _build

    label = f"cascade {mode}"
    _, _, x, y = load_digits_nhwc((32, 32, 3))
    rows = np.arange(1, len(x), 2)
    xs, ys, n = x[rows], y[rows], len(rows)
    # the reference: storm_tpu's engine's predictions per tier on these rows
    refp = [ref[f"{t}/{mode}"][rows] for t in CASCADE_TAGS]
    ref_u = [uncertainty(p, "max_softmax", CASCADE_TEMPERATURE) for p in refp[:2]]
    ref_tier = cascade_tiers(*ref_u)
    ref_out = np.stack([refp[t][i] for i, t in enumerate(ref_tier)])
    ref_acc = float((ref_out.argmax(-1) == ys).mean())
    cfg = Config()
    cfg.model = cascade_model(CASCADE_TAGS[-1], mode)
    cfg.batch = BatchConfig(**CASCADE_BATCH)
    cfg.offsets = OffsetsConfig(policy="earliest", max_behind=None)
    cfg.cascade = cascade_config()
    payloads = [json.dumps({"instances": [row.tolist()]}) for row in xs]
    payloads.insert(n // 2, '{"instances": [[1.0, 2.0], [3.0]]}')
    clear_engines()
    profile_store().reset()  # the tiers' cost, this mode's alone
    _build.reset_launch_counts()
    with counted_dispatch(keep_batches=True) as (_, batches):
        r = asyncio.run(serve_standard(cfg, payloads))
    wrapper_counts = _build.launch_counts()
    engines = [shared_engine(cascade_model(t, mode), cfg.batch, device="cuda")
               for t in CASCADE_TAGS]
    if r["errors"]:
        raise AssertionError(f"{label}: errors {r['errors'][:3]}")
    launches, tallies = dict.fromkeys(KERNEL_FUNCS, 0), {}
    for name, engine in zip(CASCADE_TIERS, engines):
        per = CASCADE_LAUNCHES[mode][name]
        tallies[name] = check_tally(torch, engine, per, None, f"{label} tier {name}")
        for k, v in tallies[name].items():
            launches[k] += v
    used = {k for per in CASCADE_LAUNCHES[mode].values() for k in per}
    if {k for k, v in wrapper_counts.items() if v} != used:
        raise AssertionError(f"{label}: eager launches {wrapper_counts}, want {sorted(used)}")
    forwards = {name: e.forwards for name, e in zip(CASCADE_TIERS, engines)}
    # every record answered once, the poison dead-lettered
    if len(r["outs"]) != n or len(r["dlq"]) != 1:
        raise AssertionError(f"{label}: {len(r['outs'])} outputs, {len(r['dlq'])} dead letters")
    served, direct = tiers_served(batches, engines, row_index(xs), n)
    if (served < 0).any():
        raise AssertionError(f"{label}: rows {np.flatnonzero(served < 0)} never dispatched")
    # each output is its row's serving tier's forward of the batch it rode
    # in: matched greedily, a row at most once
    outs = np.stack([decode_predictions(rec.value).data[0] for rec in r["outs"]])
    taken, matched, worst = np.zeros(n, bool), [], 0.0
    for pred in outs:
        err = np.abs(direct - pred).max(axis=1)
        err[taken] = np.inf
        i = int(np.argmin(err))
        if err[i] > CASCADE_TRANSPORT[mode]:
            raise AssertionError(f"{label}: an output is {err[i]:.2e} from every row's "
                                 f"serving tier's forward")
        taken[i], worst = True, max(worst, float(err[i]))
        matched.append(i)
    # the near-threshold band: float32 fixed, bf16 from the tiers' distance
    dev = []
    for t in range(2):
        p = np.concatenate([engines[t].predict(xs[i:i + 32]) for i in range(0, n, 32)])
        dev.append(float(np.abs(uncertainty(p, "max_softmax", CASCADE_TEMPERATURE)
                                - ref_u[t]).max()))
    band = CASCADE_F32_BAND if mode == "float32" else max(CASCADE_F32_BAND, *dev)
    if band > CASCADE_BAND_CAP:
        raise AssertionError(f"{label}: the port's uncertainty is {band:.4f} from JAX's")
    near = (np.abs(ref_u[0] - CASCADE_THRESHOLDS[0]) < band) | \
        ((ref_tier > 0) & (np.abs(ref_u[1] - CASCADE_THRESHOLDS[1]) < band))
    differ = np.flatnonzero(served != ref_tier)
    if (~near[differ]).any():
        bad = differ[~near[differ]]
        raise AssertionError(f"{label}: rows {bad.tolist()} served at tiers "
                             f"{served[bad].tolist()}, the reference's {ref_tier[bad].tolist()}")
    infer = r["snap"]["inference-bolt"]
    counters = [infer.get(f"cascade_accepted_tier{t}", 0) for t in range(3)]
    ref_counts = np.bincount(ref_tier, minlength=3).tolist()
    ref_esc = int((ref_tier >= 1).sum() + (ref_tier == 2).sum())
    # the router's counters: exactly the tiers that served, and the
    # reference's up to the near-threshold rows that served elsewhere
    esc = int((served >= 1).sum() + (served == 2).sum())
    slack = len(differ)
    if counters != np.bincount(served, minlength=3).tolist() or \
            infer.get("cascade_escalations", 0) != esc or \
            any(abs(c - w) > slack for c, w in zip(counters, ref_counts)) or \
            abs(esc - ref_esc) > 2 * slack:
        raise AssertionError(f"{label}: counters {counters}, escalations "
                             f"{infer.get('cascade_escalations')}; served {esc}; reference "
                             f"{ref_counts}, {ref_esc} (+-{slack} near-threshold rows)")
    # accuracy at the output topic: each output's row is the one it matched
    acc = float((outs.argmax(-1) == ys[matched]).mean())
    if abs(acc - CASCADE_ACC) > CASCADE_EPSILON or abs(acc - ref_acc) > CASCADE_EPSILON:
        raise AssertionError(f"{label}: accuracy {acc:.4f} (published {CASCADE_ACC}, "
                             f"reference {ref_acc:.4f}, epsilon {CASCADE_EPSILON})")
    fracs = [float(c) for c in np.bincount(served, minlength=3) / n]
    e2e = r["snap"]["kafka-bolt"]["e2e_latency_ms"]
    # each tier's cost two ways: the profile's per-row device ms under the
    # burst (the router's inventory), and its forward alone by graph replay
    cost = {row["model"]: row["cost"] for row in r["inventory"]}
    replay = {name: replay_ms(e.graph_for(CASCADE_BATCH["max_batch"]))
              for name, e in zip(CASCADE_TIERS, engines)}
    res = {"rows": n, "served_fracs": fracs, "ref_fracs": [c / n for c in ref_counts],
           "counters": counters, "escalations": infer.get("cascade_escalations", 0),
           "ref_escalations": ref_esc, "accuracy": acc, "ref_accuracy": ref_acc,
           "band": band, "u_deviation": dev, "transport_max": worst,
           "near_rows": np.flatnonzero(near).tolist(),
           "differ_rows": differ.tolist(), "records_per_s": (n + 1) / r["wall"],
           "e2e_p50_ms": e2e["p50"], "e2e_p99_ms": e2e["p99"], "cost": cost,
           "replay_ms_b32": replay,
           "forwards": forwards, "tallies": tallies, "launches": launches}
    log(f"  {label}: {n} records + 1 poison through 2/4/2, every record answered once, the "
        f"poison dead-lettered; served tier fractions {[round(f, 4) for f in fracs]} "
        f"(reference {[round(c / n, 4) for c in ref_counts]}); counters {counters}, "
        f"escalations {res['escalations']} (reference {ref_counts}, {ref_esc}); "
        f"accuracy {acc:.4f} (reference {ref_acc:.4f}, published {CASCADE_ACC})")
    log(f"  {label}: outputs within {worst:.1e} of their serving tier's forward of their "
        f"batch; the tiers' |u_port - u_JAX| max {[f'{d:.2e}' for d in dev]}; "
        f"near-threshold band {band:.2e}: {int(near.sum())} rows "
        f"{np.flatnonzero(near).tolist()}, of them served at another tier than the "
        f"reference's: {differ.tolist()} (port tiers {served[differ].tolist()}, reference "
        f"{ref_tier[differ].tolist()})")
    log(f"  {label} on {card}: {res['records_per_s']:.3f} records/s, e2e p50 "
        f"{e2e['p50']:.3f} ms, p99 {e2e['p99']:.3f} ms; per-tier cost (inventory) {cost}; "
        f"forward by graph replay at B=32 {({k: round(v, 4) for k, v in replay.items()})} ms; "
        f"forwards {forwards}; launch tallies {tallies}")
    clear_engines()
    return res


def degrade_turn(torch, card: str) -> dict:
    """12 (c): ``qos.degrade_model="lenet5"`` on a resnet20_digits bf16
    ``int8_fused`` flagship (the degrade tier seeded, as storm_tpu builds
    it), phase 9b's lanes and tenants on 672 distinct training rows, the
    shed controller tripped by the burst and held at level 1 (phase 10
    (c)'s way)."""
    import dataclasses

    from storm_tpu_torch.api.schema import decode_predictions
    from storm_tpu_torch.config import BatchConfig, Config, OffsetsConfig, QosConfig
    from storm_tpu_torch.data import load_digits_nhwc
    from storm_tpu_torch.infer.engine import clear_engines, shared_engine
    from storm_tpu_torch.ops import _build

    label = "degrade"
    # distinct training rows: a burst long enough for the controller's
    # 10 ms steps to see the inboxes full
    xtr = load_digits_nhwc((32, 32, 3))[0]
    _, first = np.unique(xtr.reshape(len(xtr), -1), axis=0, return_index=True)
    xs = xtr[np.sort(first)[:DEGRADE_RECORDS]]
    n = len(xs)
    lanes = [DEGRADE_LANES[i % 3] for i in range(n)]
    keys = [f"{DEGRADE_TENANTS[(i // 3) % 2]}:{lanes[i]}".encode() for i in range(n)]
    cfg = Config()
    cfg.model = cascade_model("resnet20_digits", "int8_fused")
    cfg.batch = BatchConfig(**CASCADE_BATCH)
    cfg.offsets = OffsetsConfig(policy="earliest", max_behind=None)
    cfg.qos = QosConfig(enabled=True, degrade_model="lenet5", shed_interval_s=0.01,
                        shed_inbox_frac=0.25, shed_breach_rate=1.0, shed_hot_steps=1,
                        shed_calm_steps=1000)
    cfg.topology.inbox_capacity = 8
    cfg.tracing.slo_ms = 50.0
    payloads = [json.dumps({"instances": [row.tolist()]}) for row in xs]
    clear_engines()
    _build.reset_launch_counts()
    with counted_dispatch(keep_batches=True) as (_, batches):
        r = asyncio.run(serve_standard(cfg, payloads, keys=keys, hold_level=1))
    engines = [shared_engine(dataclasses.replace(cfg.model, name="lenet5", checkpoint=None),
                             cfg.batch, device="cuda"),
               shared_engine(cfg.model, cfg.batch, device="cuda")]
    tallies = {"lenet5": check_tally(torch, engines[0], {"w8a16_matmul_sm90": 3}, None,
                                     f"{label} tier lenet5"),
               "resnet20": check_tally(torch, engines[1], {"w8a16_matmul_sm90": 1}, None,
                                       f"{label} tier resnet20")}
    if r["errors"]:
        raise AssertionError(f"{label}: errors {r['errors'][:3]}")
    msgs = [json.loads(rec.value) for rec in r["outs"]]
    over = [m for m in msgs if m.get("overloaded")]
    if over or len(msgs) + len(r["dlq"]) + r["dropped"] != n:
        raise AssertionError(f"{label}: {len(over)} Overloaded, {len(msgs)} outputs, "
                             f"{len(r['dlq'])} dead letters, {r['dropped']} dropped of {n}")
    served, direct = tiers_served(batches, engines, row_index(xs), n)
    infer = r["snap"]["inference-bolt"]
    degraded = infer.get("shed_degraded", 0)
    events = [ev for ev in r["flight"] if ev["kind"] == "shed_degrade"]
    tier0 = np.flatnonzero(served == 0)
    by_lane = {ln: np.bincount(served[[i for i in range(n) if lanes[i] == ln and served[i] >= 0]],
                               minlength=2).tolist() for ln in DEGRADE_LANES}
    if not degraded or len(tier0) != degraded or {lanes[i] for i in tier0} != {"best_effort"}:
        raise AssertionError(f"{label}: {degraded} degraded, tier 0 served {len(tier0)} rows "
                             f"of lanes {sorted({lanes[i] for i in tier0})}")
    if any(served[i] != 1 for i in range(n) if lanes[i] == "high"):
        raise AssertionError(f"{label}: a high-lane record was not served by resnet20")
    if not events or not r["decisions"]:
        raise AssertionError(f"{label}: shed_degrade events {len(events)}, decisions "
                             f"{r['decisions']}")
    outs = np.stack([decode_predictions(m_rec.value).data[0] for m_rec in r["outs"]])
    served_rows = np.flatnonzero(served >= 0)
    err = np.abs(direct[served_rows][None, :, :] - outs[:, None, :]).max(axis=2).min(axis=1)
    if err.max() > CASCADE_TRANSPORT["int8_fused"]:
        raise AssertionError(f"{label}: an output {err.max():.2e} from its tier's forward")
    launches = {k: tallies["lenet5"].get(k, 0) + tallies["resnet20"].get(k, 0)
                for k in KERNEL_FUNCS}
    res = {"degraded": degraded, "served_by_lane": by_lane, "shed_degrade_events": len(events),
           "decisions": r["decisions"], "dropped": r["dropped"], "outputs": len(msgs),
           "tallies": tallies, "launches": launches}
    log(f"  {label} on {card}: {len(msgs)} predictions, {r['dropped']} dropped at the spout, "
        f"no Overloaded, none lost; controller {r['decisions']}; {degraded} best-effort "
        f"records degraded to tier 0 (lenet5), {len(events)} shed_degrade events; served "
        f"(tier 0, tier 1) by lane {by_lane}; launch tallies {tallies}")
    clear_engines()
    return res


def obs_payloads() -> list:
    rng = np.random.RandomState(31)
    payloads = [json.dumps({"instances": np.round(rng.rand(1, *LIFE_SHAPE), 3).tolist()})
                for _ in range(OBS_RECORDS)]
    payloads.insert(OBS_RECORDS // 2, '{"instances": [[1.0, 2.0], [3.0]]}')
    return payloads


def observed_config(slo_ms: float, obs: bool):
    from storm_tpu_torch.config import BatchConfig, Config, ObsConfig, OffsetsConfig, QosConfig

    cfg = Config()
    cfg.model = vit_b16_config()
    cfg.batch = BatchConfig(max_batch=B, buckets=(B,), max_wait_ms=50.0)
    cfg.offsets = OffsetsConfig(policy="earliest", max_behind=None)
    cfg.tracing.slo_ms = slo_ms
    # Every record in the top lane, which never sheds; only the burn
    # tracker can make the controller hot.
    cfg.qos = QosConfig(enabled=True, default_lane="high", shed_interval_s=0.1,
                        shed_inbox_frac=2.0, shed_breach_rate=1e9, shed_hot_steps=1,
                        shed_calm_steps=1000)
    cfg.obs = ObsConfig(enabled=obs, interval_s=0.05, burn_fast_window_s=1.0,
                        burn_slow_window_s=5.0, min_samples=4)
    return cfg


def observed_main_path(torch, card: str, served: dict) -> dict:
    """12 (d): the Observatory on phase 5's main path (ViT-B/16 bf16
    ``int8_fused``, 2/4/2, 64 JSON records + 1 poison), its SLO below
    phase 5's e2e p50 and this path's own, the shed controller reading
    its burn."""
    import copy as copy_mod

    from storm_tpu_torch.infer.engine import clear_engines, shared_engine
    from storm_tpu_torch.obs import copyledger, profile_store
    from storm_tpu_torch.ops import _build

    label = "observed main path"
    payloads = obs_payloads()
    # Information only: records/s and e2e p50 of this path with the
    # Observatory off, on, on, off, the SLO half phase 5's e2e p50.
    turns = []
    for on in (False, True, True, False):
        t = asyncio.run(serve_standard(observed_config(0.5 * served["e2e_p50_ms"], obs=on),
                                       payloads, rounds=OBS_ROUNDS, gap_s=OBS_GAP_S))
        if t["errors"] or len(t["outs"]) != OBS_RECORDS:
            raise AssertionError(f"{label} turn obs={on}: {len(t['outs'])} outputs")
        e = t["snap"]["kafka-bolt"]["e2e_latency_ms"]
        turns.append({"obs": on, "records_per_s": OBS_RECORDS / t["wall"],
                      "e2e_p50_ms": e["p50"]})
        log(f"  {label} turn, Observatory {'on ' if on else 'off'}: "
            f"{turns[-1]['records_per_s']:.3f} records/s, e2e p50 {e['p50']:.3f} ms")
    # The gated run's SLO: half the least e2e p50 of phase 5 and of these
    # turns, so that at least the slower half of its records breach it
    # however fast the host runs this time. (Half phase 5's p50 alone sat
    # near this path's own p50, 4 rounds of 16 records against one burst
    # of 16, and some runs saw no breach.)
    slo_ms = 0.5 * min([served["e2e_p50_ms"]] + [t["e2e_p50_ms"] for t in turns])
    cfg = observed_config(slo_ms, obs=True)
    components = {"kafka-spout", "inference-bolt", "kafka-bolt", "dlq-bolt"}
    steps = []

    def before(rt, obs):
        ledger = copyledger.copy_ledger()
        ledger.reset()
        ledger.windowed("obs")  # the observatory's window starts here
        profile_store().reset()
        step = obs.step

        def recording_step():
            step()
            busy = sum(row["busy_s"] for row in obs.capacity.last.values())
            steps.append({"capacity": copy_mod.deepcopy(obs.capacity.last),
                          "verdict": copy_mod.deepcopy(obs.bottleneck.last_verdict),
                          "window": copy_mod.deepcopy(obs.last_copies),
                          "gauge": rt.metrics.gauge("obs", "copies_amplification").value,
                          "fast_burn": obs.burn.fast_burn, "busy": busy,
                          "occupancy": obs.occupancy()})

        obs.step = recording_step

    def inspect(rt, obs):
        obs.step()  # one more window, the burst's last rows landed
        cumulative = copyledger.copy_ledger().snapshot()
        base = profile_store().snapshot()
        obs.profile.load_baseline(base)
        same = obs.sentinel_check()
        scaled = copy_mod.deepcopy(base)
        cells = 0
        for eng in scaled["engines"].values():
            for row in eng["buckets"].values():
                for st in row["stages"].values():
                    if st.get("mean"):
                        cells += st["count"] >= obs.cfg.min_samples
                        st["mean"] = st["mean"] / 4
        counter0 = rt.metrics.counter("obs", "profile_regressions").value
        obs.profile.load_baseline(scaled)
        regs = obs.sentinel_check()
        counter = rt.metrics.counter("obs", "profile_regressions").value - counter0
        obs.profile._baseline = None
        return {"cumulative": cumulative, "same": same, "regs": regs, "cells": cells,
                "counter": counter, "flight": rt.flight.tail(10_000),
                "snapshot": obs.snapshot()}

    clear_engines()
    _build.reset_launch_counts()
    r = asyncio.run(serve_standard(cfg, payloads, before_traffic=before, inspect=inspect,
                                   rounds=OBS_ROUNDS, gap_s=OBS_GAP_S))
    wrapper_counts = _build.launch_counts()
    engine = shared_engine(cfg.model, cfg.batch, device="cuda")
    launches = check_tally(torch, engine, VIT_LAUNCHES, wrapper_counts, label)
    ins = r["inspected"]
    if r["errors"] or len(r["outs"]) != OBS_RECORDS or len(r["dlq"]) != 1:
        raise AssertionError(f"{label}: {len(r['outs'])} outputs, {len(r['dlq'])} dead "
                             f"letters, errors {r['errors'][:3]}")
    busy_steps = [s for s in steps if s["busy"] > 0]
    if not busy_steps:
        raise AssertionError(f"{label}: no step saw traffic ({len(steps)} steps)")
    for s in busy_steps:
        if set(s["capacity"]) != components:
            raise AssertionError(f"{label}: capacity rows {sorted(s['capacity'])}")
        leader = s["verdict"].get("leader")
        if leader is not None and leader not in components:
            raise AssertionError(f"{label}: leader {leader}")
    occ = [row for row in steps[-1]["occupancy"] if row["engine"] == engine.profile_key]
    if not occ or any(row["ring_capacity"] != engine.pipeline_depth for row in occ):
        raise AssertionError(f"{label}: occupancy {steps[-1]['occupancy']}")
    # the gauge is the amplification of the ledger's window the step read,
    # which is its moved bytes over its ingested bytes
    amps = []
    for s in steps:
        w = s["window"]
        amp = w.get("copy_amplification")
        if s["gauge"] != (amp if amp is not None else 0.0):
            raise AssertionError(f"{label}: copies_amplification {s['gauge']} for the "
                                 f"window's {amp}")
        stages = w.get("stages", {})
        ingest = stages.get("spout_ingest", {}).get("bytes", 0.0)
        if ingest > 0:
            moved = sum(row["bytes"] for st, row in stages.items() if st != "spout_ingest")
            if amp != round(moved / ingest, 3):
                raise AssertionError(f"{label}: window amplification {amp}, its bytes "
                                     f"{moved} / {ingest}")
            amps.append(amp)
    if not amps or max(amps) <= 0:
        raise AssertionError(f"{label}: no window saw the ledger's traffic ({len(steps)} steps)")
    max_burn = max(s["fast_burn"] for s in steps)
    decisions = [ev for ev in ins["flight"] if ev["kind"] == "shed_decision"]
    if max_burn <= 0 or not decisions or any(ev["burn_rate"] <= 0 for ev in decisions):
        raise AssertionError(f"{label}: fast burn {max_burn}, decisions {decisions}")
    regs_ev = [ev for ev in ins["flight"] if ev["kind"] == "profile_regression"]
    if ins["same"] or len(ins["regs"]) != ins["cells"] or ins["counter"] != ins["cells"] \
            or not ins["cells"] or not regs_ev:
        raise AssertionError(f"{label}: sentinel {ins['same']} against its own profile; "
                             f"{len(ins['regs'])} regressions, counter {ins['counter']}, "
                             f"{ins['cells']} cells, {len(regs_ev)} events at 1/4")
    leaders = [s["verdict"].get("leader") for s in busy_steps]
    # the step whose leading score was highest: its verdict and critical path
    verdict = max(busy_steps, key=lambda s: max((r["score"] for r in s["verdict"]["ranked"]),
                                                default=0))["verdict"]
    top = verdict["ranked"][0]
    e2e = r["snap"]["kafka-bolt"]["e2e_latency_ms"]
    res = {"steps": len(steps), "busy_steps": len(busy_steps), "leaders": leaders,
           "top": {k: top[k] for k in ("component", "score", "capacity", "reasons")},
           "max_fast_burn": max_burn, "shed_decisions": len(decisions),
           "regressions": len(ins["regs"]), "regression_events": len(regs_ev),
           "amplification": ins["cumulative"]["copy_amplification"],
           "window_amplifications": amps, "slo_ms": slo_ms,
           "records_per_s": OBS_RECORDS / r["wall"], "e2e_p50_ms": e2e["p50"],
           "critical_path": verdict.get("critical_path"), "launches": launches}
    log(f"  {label}: {OBS_RECORDS} records + 1 poison, {len(steps)} observatory steps "
        f"({len(busy_steps)} with traffic), capacity rows for {sorted(components)} on each; "
        f"leaders {sorted(set(leaders), key=str)}; strongest {res['top']}; fast burn up to "
        f"{max_burn:.3f} (SLO {slo_ms:.3f} ms), {len(decisions)} shed_decision events all with "
        f"burn_rate > 0; copies_amplification = each window's ({len(amps)} windows with "
        f"ingest, up to {max(amps)}; the run's {res['amplification']}); sentinel: none against its own "
        f"profile, {len(ins['regs'])} at 1/4 = the {ins['cells']} cells with >= "
        f"{cfg.obs.min_samples} samples ({len(regs_ev)} events, the rest throttled); "
        f"launch tally {launches}")
    log(f"  {label} on {card}: {res['records_per_s']:.3f} records/s, e2e p50 "
        f"{e2e['p50']:.3f} ms; critical path {verdict.get('critical_path')}")
    res["turns"] = turns
    clear_engines()
    return res


def cascade_and_observatory(torch, card: str, served: dict) -> dict:
    """Phase 12, each part's launch counts zeroed just before and read
    just after it."""
    from storm_tpu_torch.infer.continuous import _reset_registry
    from storm_tpu_torch.models.registry import CHECKPOINTS

    with np.load(CHECKPOINTS / "reference_predictions.npz") as f:
        ref = {k: f[k] for k in f.files}
    with open(os.path.join(os.path.dirname(os.path.abspath(__file__)), CASCADE_ARTIFACT)) as fh:
        art = json.load(fh)
    if (tuple(art["thresholds"]), art["temperature"], art["metric"]) != \
            (CASCADE_THRESHOLDS, CASCADE_TEMPERATURE, "max_softmax") or \
            art["eval"]["cascade"]["acc_e2e"] != CASCADE_ACC:
        raise AssertionError(f"{CASCADE_ARTIFACT} names another operating point")
    t0 = time.perf_counter()
    out = {"a": cascade_at_point(torch, "float32", ref, card)}
    counters = art["eval"]["cascade"]["router_counters"]
    if art["eval"]["n"] != out["a"]["rows"] or \
            [counters[f"cascade_accepted_tier{t}"] for t in range(3)] != \
            [round(f * out["a"]["rows"]) for f in out["a"]["ref_fracs"]]:
        raise AssertionError(f"{CASCADE_ARTIFACT}'s served rows are not these: {art['eval']}")
    out["b"] = cascade_at_point(torch, "int8_fused", ref, card)
    _reset_registry()
    out["c"] = degrade_turn(torch, card)
    out["d"] = observed_main_path(torch, card, served)
    out["wall_s"] = time.perf_counter() - t0
    log(f"  phase 12 took {out['wall_s']:.1f} s")
    return out


# ---- phase 13: the Storm runtime's core and exactly-once delivery ---------------------

LIFE_SHAPE = (224, 224, 3)  # a record's instance, ViT-B/16's input
LIFE_ROUND = 16  # records a gated round in 13 (a)
LIFE_RECORDS = 5 * LIFE_ROUND  # distinct JSON records, shared by (a), (b) and (c)
LIFE_BURST = 256  # records a measured window: the distinct records cycled
LIFE_PARALLELISMS = (2, 4, 8, 8, 4, 2)  # 13 (a)'s measured windows, in turn
EOS_GROUP, EOS_CHUNK, EOS_PARTITIONS = "chip-smoke-eos", 16, 2
POISON = '{"instances": [[1.0, 2.0], [3.0]]}'


def life_payloads() -> tuple:
    """LIFE_RECORDS seeded 224x224x3 JSON records and each one's input as
    the bolt decodes it (the port's native codec), by its bytes."""
    from storm_tpu_torch.api.schema import decode_instances

    rng = np.random.RandomState(13)
    payloads = [json.dumps({"instances": np.round(rng.rand(1, *LIFE_SHAPE), 3).tolist()})
                for _ in range(LIFE_RECORDS)]
    keys = [decode_instances(p).data[0].tobytes() for p in payloads]
    return payloads, keys


def life_burst(payloads: list) -> tuple:
    """The measured windows' burst: LIFE_BURST records, ``payloads``
    cycled, and how many times each of ``payloads`` is in it."""
    burst = [payloads[i % len(payloads)] for i in range(LIFE_BURST)]
    return burst, [len(range(i, LIFE_BURST, len(payloads))) for i in range(len(payloads))]


def life_config(timeout_s: float = 30.0):
    """Phase 5's main path as a Config: ViT-B/16 bf16 int8_fused, 2/4/2."""
    from storm_tpu_torch.config import BatchConfig, Config, OffsetsConfig

    cfg = Config()
    cfg.model = vit_b16_config()
    cfg.batch = BatchConfig(max_batch=B, buckets=(B,), max_wait_ms=50.0)
    cfg.offsets = OffsetsConfig(policy="earliest", max_behind=None)
    cfg.topology.message_timeout_s = timeout_s
    return cfg


def output_index(engine, batches: list) -> dict:
    """Each output the engine's direct forward of ``batches`` would give
    (the native encoding of a row), with the inputs of the rows giving it."""
    from storm_tpu_torch.native import format_predictions

    by_output: dict = {}
    for batch in batches:
        for x, row in zip(batch, engine.predict(batch)):
            by_output.setdefault(format_predictions(row[None]), set()).add(x.tobytes())
    return by_output


def answers(index: dict, outs: list, keys: list, label: str) -> list:
    """Each output record's input: every output must be in ``index`` (a
    row of a forward the engine ran); returns how many times each of
    ``keys`` was answered."""
    position = {k: i for i, k in enumerate(keys)}
    counts = [0] * len(keys)
    for rec in outs:
        v = rec.value.decode() if isinstance(rec.value, bytes) else rec.value
        found = index.get(v)
        if not found:
            raise AssertionError(f"{label}: an output is not a row of a forward the engine ran")
        for k in found:
            if k in position:
                counts[position[k]] += 1
    return counts


def engine_state(engine) -> dict:
    """What a rebuild or a second warm-up would change: the live engines,
    the engine's graphs (by identity) and its built buckets."""
    from storm_tpu_torch.infer.engine import live_engines

    return {"engines": sorted(id(e) for e in live_engines()),
            "graphs": {b: id(g) for b, g in engine._buckets.items()}}


def recording(engine, batches: list):
    """Wrap ``engine.dispatch`` to keep a copy of every batch it is given."""
    dispatch = engine.dispatch

    def record(parts):
        batches.append(np.concatenate([np.array(p, copy=True) for p in parts]))
        return dispatch(parts)

    engine.dispatch = record


async def out_count(broker, n: int, label: str, timeout_s: float = 120.0) -> None:
    deadline = time.monotonic() + timeout_s
    while broker.topic_size("output") + broker.topic_size("dead-letter") < n:
        if time.monotonic() > deadline:
            raise TimeoutError(f"{label}: {broker.topic_size('output')} outputs of {n} "
                               f"in {timeout_s} s")
        await asyncio.sleep(0.005)


async def measured_window(torch, rt, broker, records: list, done, e2e, label: str) -> dict:
    """One burst under the profiler: ``records`` appended at once to
    "input", timed until ``done()`` holds. Records/s, the p50 of the sink
    histogram ``e2e`` over the burst, the share of the wall the inference
    bolt's decodes held the one event loop, and the card's idle share."""
    decode = rt.metrics.histogram("inference-bolt", "decode_ms")
    e2e.reset()
    decode.reset()
    with card_busy(torch) as card:
        t0 = time.perf_counter()
        for p in records:
            broker.produce("input", p)
        deadline = time.monotonic() + 120
        while not done():
            if time.monotonic() > deadline:
                raise TimeoutError(f"{label}: a burst of {len(records)} records not done "
                                   f"in 120 s")
            await asyncio.sleep(0.002)
        wall = time.perf_counter() - t0
    return {"records": len(records), "wall_s": wall, "records_per_s": len(records) / wall,
            "e2e_p50_ms": e2e.percentile(50),
            "decode_share": decode.snapshot()["sum"] / (wall * 1e3),
            "idle_share": card["idle_share"]}


async def rebalance_turn(torch, payloads: list) -> dict:
    """13 (a): phase 5's main path through ``build_standard_topology`` at
    2/4/2. The gated part: records in rounds, one at inference parallelism
    4, one with the rebalance 4 -> 8 under way, one at 8, then 8 -> 2 and
    one at 2; then the spouts deactivated while a round waits in the
    topic, and activated. Then the measured windows: the same burst at
    each of LIFE_PARALLELISMS in turn, rebalanced between windows."""
    from storm_tpu_torch.connectors import MemoryBroker
    from storm_tpu_torch.main import build_standard_topology
    from storm_tpu_torch.ops import _build
    from storm_tpu_torch.runtime import AsyncLocalCluster

    cfg = life_config()
    broker = MemoryBroker(default_partitions=2)
    cluster = AsyncLocalCluster()
    rt = await cluster.submit("chip-smoke-phase13a", cfg,
                              build_standard_topology(cfg, broker, device="cuda"))
    infer = rt.bolt_execs["inference-bolt"]
    engine = infer[0].bolt.engine
    before = engine_state(engine)
    batches: list = []
    recording(engine, batches)
    _build.reset_launch_counts()
    tally0, forwards0 = engine.launch_tally(), engine.forwards
    e2e = rt.metrics.histogram("kafka-bolt", "e2e_latency_ms")
    spout_emitted = [rt.metrics.counter("kafka-spout", "emitted")]
    rounds, out = [], {"sent": 0}

    async def round_(recs: list, label: str, during=None) -> None:
        e2e.reset()
        t0 = time.perf_counter()
        for p in recs:
            broker.produce("input", p)
        if during is not None:
            await during()
        out["sent"] += len(recs)
        await out_count(broker, out["sent"], f"13 (a) {label}")
        rounds.append({"round": label, "parallelism": rt.parallelism_of("inference-bolt"),
                       "records": len(recs), "records_per_s": len(recs) / (time.perf_counter() - t0),
                       "e2e_p50_ms": e2e.percentile(50)})

    grown = {}

    async def grow() -> None:
        await rt.rebalance("inference-bolt", 8)
        execs = rt.bolt_execs["inference-bolt"]
        grown["shared"] = [e.bolt.engine is engine for e in execs]
        grown["executed"] = [e.n_executed for e in execs]

    chunks = [payloads[i * LIFE_ROUND:(i + 1) * LIFE_ROUND] for i in range(5)]
    chunks[0] = chunks[0][:LIFE_ROUND // 2] + [POISON] + chunks[0][LIFE_ROUND // 2:]
    await round_(chunks[0], "at 4")
    await round_(chunks[1], "4 -> 8", during=grow)
    await round_(chunks[2], "at 8")
    executed8 = [e.n_executed for e in rt.bolt_execs["inference-bolt"]]
    await rt.rebalance("inference-bolt", 2)
    await round_(chunks[3], "at 2")
    await rt.deactivate()
    emitted, sizes = spout_emitted[0].value, broker.topic_size("output")
    for p in chunks[4]:
        broker.produce("input", p)
    await asyncio.sleep(0.5)
    paused = (spout_emitted[0].value - emitted, broker.topic_size("output") - sizes)
    await rt.activate()
    out["sent"] += len(chunks[4])
    await out_count(broker, out["sent"], "13 (a) after activate")
    gated_outs, dlq = broker.drain_topic("output"), broker.drain_topic("dead-letter")
    snap, flight = rt.metrics.snapshot(), rt.flight.tail(10_000)

    burst, _ = life_burst(payloads)
    windows = []
    for n in LIFE_PARALLELISMS:
        if rt.parallelism_of("inference-bolt") != n:
            await rt.rebalance("inference-bolt", n)
        target = broker.topic_size("output") + len(burst)
        w = await measured_window(torch, rt, broker, burst,
                                  lambda t=target: broker.topic_size("output") >= t, e2e,
                                  f"13 (a) window at {n}")
        windows.append({"parallelism": n, **w})
    await rt.drain(timeout_s=60)
    del engine.dispatch
    seen = {(r.partition, r.offset) for r in gated_outs}
    res = {"rounds": rounds, "windows": windows, "grown": grown, "executed8": executed8,
           "paused": paused, "health": rt.health(), "snap": snap,
           "errors": list(rt.errors), "flight": flight, "outs": gated_outs, "dlq": dlq,
           "window_outs": [r for r in broker.drain_topic("output")
                           if (r.partition, r.offset) not in seen],
           "window_dlq": broker.topic_size("dead-letter") - len(dlq),
           "window_failed": rt.metrics.snapshot()["kafka-spout"].get("tree_failed", 0),
           "window_timeouts": sum(ev["kind"] == "tree_timeout"
                                  for ev in rt.flight.tail(10_000)),
           "batches": batches, "engine": engine, "before": before,
           "after": engine_state(engine), "tally0": tally0, "forwards0": forwards0,
           "wrapper_counts": _build.launch_counts()}
    await cluster.shutdown()
    return res


async def supervision_turn(payloads: list, tmp: str) -> dict:
    """13 (b): the same path, records in two halves, one inference task
    crashed by the chaos monkey between them; a JSON-lines and a callback
    metrics consumer attached."""
    from storm_tpu_torch.connectors import MemoryBroker
    from storm_tpu_torch.main import build_standard_topology
    from storm_tpu_torch.ops import _build
    from storm_tpu_torch.runtime import AsyncLocalCluster
    from storm_tpu_torch.runtime.chaos import ChaosMonkey
    from storm_tpu_torch.runtime.metrics import CallbackConsumer, JsonLinesConsumer

    cfg = life_config(timeout_s=3.0)
    broker = MemoryBroker(default_partitions=2)
    cluster = AsyncLocalCluster()
    rt = await cluster.submit("chip-smoke-phase13b", cfg,
                              build_standard_topology(cfg, broker, device="cuda"))
    engine = rt.bolt_execs["inference-bolt"][0].bolt.engine
    before = engine_state(engine)
    snaps: list = []
    path = os.path.join(tmp, "phase13b-metrics.jsonl")
    rt.add_metrics_consumer(JsonLinesConsumer(path), interval_s=0.25)
    rt.add_metrics_consumer(CallbackConsumer(lambda topo, ts, snap: snaps.append(snap)),
                            interval_s=0.25)
    batches: list = []
    recording(engine, batches)
    _build.reset_launch_counts()
    tally0, forwards0 = engine.launch_tally(), engine.forwards
    half = len(payloads) // 2
    t0 = time.perf_counter()
    for p in payloads[:half]:
        broker.produce("input", p)
    await out_count(broker, half // 2, "13 (b) first half")
    ChaosMonkey(rt, seed=13).crash_bolt("inference-bolt", 1)
    for p in payloads[half:]:
        broker.produce("input", p)
    answered = set()
    deadline = time.monotonic() + 120
    while len(answered) < len(payloads) or \
            not rt.metrics.counter("inference-bolt", "executor_restarts").value:
        if time.monotonic() > deadline:
            raise TimeoutError(f"13 (b): {len(answered)} of {len(payloads)} answered")
        answered = {r.value for r in broker.drain_topic("output")}
        await asyncio.sleep(0.05)
    wall = time.perf_counter() - t0
    await rt.drain(timeout_s=60)
    del engine.dispatch
    res = {"snap": rt.metrics.snapshot(), "errors": list(rt.errors),
           "flight": rt.flight.tail(10_000), "outs": broker.drain_topic("output"),
           "health": rt.health(), "batches": batches, "before": before,
           "tally0": tally0, "forwards0": forwards0, "wall": wall}
    await cluster.shutdown()  # the consumers' last snapshot
    res.update({"after": engine_state(engine), "wrapper_counts": _build.launch_counts(),
                "consumer_snaps": snaps, "jsonl": read_jsonl(path), "engine": engine})
    return res


async def exactly_once_turn(torch, records: list, eos: bool = True,
                            faults: bool = False) -> dict:
    """13 (c): soak_harness.py's audited topology with the ViT-B/16 bolt:
    a spout in chunks of 16 -> 4 inference tasks and an echo bolt (sha256
    of each record) -> one sink, the dead-letter sink beside it. With
    ``eos``, the spout's ``txn`` policy and the transactional sink
    committing the spout's offsets; without, its at-least-once twin (the
    ``earliest`` policy and the async sink). With ``faults``, one
    inference task crashed by the chaos monkey and one commit failed, both
    mid-stream; without, ``records`` are a measured window. The sink times
    its predictions alone in ``e2e_latency_ms_predictions``."""
    import hashlib

    from storm_tpu_torch.config import OffsetsConfig, SinkConfig
    from storm_tpu_torch.connectors import (BrokerSink, BrokerSpout, MemoryBroker,
                                            MemoryTxn, TransactionalBrokerSink)
    from storm_tpu_torch.infer import InferenceBolt
    from storm_tpu_torch.ops import _build
    from storm_tpu_torch.runtime import AsyncLocalCluster, Bolt, TopologyBuilder, Values
    from storm_tpu_torch.runtime.chaos import ChaosMonkey

    class EchoBolt(Bolt):
        """The identity lane: each record's content hash, anchored to its
        prediction's tree, so the sink commits both or neither."""

        async def execute(self, t):
            m = t.get("message")
            for rec in (m if isinstance(m, list) else [m]):
                h = hashlib.sha256(rec.encode()).hexdigest()[:24]
                await self.collector.emit(Values([f"h:{h}"]), anchors=[t])
            self.collector.ack(t)

    def timed(base):
        class Timed(base):
            """``base`` timing its predictions apart: its
            ``e2e_latency_ms`` pools them with the echoes."""

            def prepare(self, context, collector):
                super().prepare(context, collector)
                self._m_pred = context.metrics.histogram(context.component_id,
                                                         "e2e_latency_ms_predictions")

            def _ack_delivered(self, t, t0=None):
                m = t.get("message")
                if t.root_ts and not (isinstance(m, str) and m.startswith("h:")):
                    self._m_pred.observe((time.perf_counter() - t.root_ts) * 1e3)
                super()._ack_delivered(t, t0)

        return Timed

    cfg = life_config(timeout_s=3.0 if faults else 30.0)
    broker = MemoryBroker(default_partitions=EOS_PARTITIONS)
    tb = TopologyBuilder()
    policy = "txn" if eos else "earliest"
    tb.set_spout("kafka-spout", BrokerSpout(
        broker, "input", OffsetsConfig(policy=policy, group_id=EOS_GROUP, max_behind=None),
        chunk=EOS_CHUNK), parallelism=1)
    tb.set_bolt("inference-bolt", InferenceBolt(cfg.model, cfg.batch, device="cuda"),
                parallelism=4).shuffle_grouping("kafka-spout")
    tb.set_bolt("echo", EchoBolt(), parallelism=1).shuffle_grouping("kafka-spout")
    sink = (timed(TransactionalBrokerSink)(broker, "output", SinkConfig(
        mode="transactional", txn_batch=64, txn_ms=100.0, offsets_group=EOS_GROUP))
            if eos else timed(BrokerSink)(broker, "output", cfg.sink))
    tb.set_bolt("kafka-bolt", sink, parallelism=1) \
        .shuffle_grouping("inference-bolt").shuffle_grouping("echo")
    tb.set_bolt("dlq-bolt", BrokerSink(broker, "dead-letter", cfg.sink)) \
        .shuffle_grouping("inference-bolt", stream="dead_letter")
    commit = MemoryTxn.commit
    commits = {"n": 0, "failed": 0}

    def flaky_commit(txn):
        commits["n"] += 1
        if faults and commits["n"] == 2:  # the second transaction aborts
            commits["failed"] += 1
            raise RuntimeError("chip smoke: injected commit failure")
        commit(txn)

    def committed() -> dict:
        return {p: broker.committed(EOS_GROUP, "input", p) for p in range(EOS_PARTITIONS)}

    def ends() -> dict:
        return {p: broker.latest_offset("input", p) for p in range(EOS_PARTITIONS)}

    cluster = AsyncLocalCluster()
    name = f"chip-smoke-phase13c-{'eos' if eos else 'plain'}{'-faults' if faults else ''}"
    with mock.patch.object(MemoryTxn, "commit", flaky_commit):
        rt = await cluster.submit(name, cfg, tb.build())
        engine = rt.bolt_execs["inference-bolt"][0].bolt.engine
        before = engine_state(engine)
        batches: list = []
        recording(engine, batches)
        _build.reset_launch_counts()
        tally0, forwards0 = engine.launch_tally(), engine.forwards
        crashed, window = None, None
        if faults:
            t0 = time.perf_counter()
            for p in records:
                broker.produce("input", p)
            # The crash, once the first transaction committed: the task the
            # spout's shuffle sends its next entry to.
            deadline = time.monotonic() + 180
            while committed() != ends():
                if time.monotonic() > deadline:
                    raise TimeoutError(f"13 (c): committed {committed()} of {ends()}")
                if crashed is None and commits["n"] > commits["failed"]:
                    grouping = next(g for g, group in rt.router.subscriptions("kafka-spout",
                                                                              "default")
                                    if group.component_id == "inference-bolt")
                    crashed = (grouping._i + 1) % grouping.n
                    ChaosMonkey(rt, seed=13).crash_bolt("inference-bolt", crashed)
                await asyncio.sleep(0.001)
            wall = time.perf_counter() - t0
        else:
            n_out = 2 * len(records)  # a prediction and an echo a record
            window = await measured_window(
                torch, rt, broker, records,
                lambda: broker.topic_size("output") >= n_out and
                (not eos or committed() == ends()),
                rt.metrics.histogram("kafka-bolt", "e2e_latency_ms_predictions"), name)
            wall = window["wall_s"]
        await rt.drain(timeout_s=60)
        del engine.dispatch
        res = {"snap": rt.metrics.snapshot(), "errors": list(rt.errors),
               "flight": rt.flight.tail(10_000), "outs": broker.drain_topic("output"),
               "dlq": broker.drain_topic("dead-letter"), "batches": batches,
               "committed": committed(), "ends": ends(), "before": before,
               "after": engine_state(engine), "tally0": tally0, "forwards0": forwards0,
               "wrapper_counts": _build.launch_counts(), "wall": wall, "window": window,
               "crashed": crashed, "commits": dict(commits), "engine": engine}
        await cluster.shutdown()
    return res


def check_no_rebuild(r: dict, label: str) -> None:
    if r["after"] != r["before"]:
        raise AssertionError(f"{label}: the engines or graphs changed: {r['before']} -> "
                             f"{r['after']}")


def log_window(label: str, w: dict, card: str) -> None:
    log(f"  {label} on {card}: {w['records']} records in {w['wall_s']:.3f} s, "
        f"{w['records_per_s']:.3f} records/s, e2e p50 {w['e2e_p50_ms']:.3f} ms, decodes "
        f"{100 * w['decode_share']:.1f} % of the wall, card idle {100 * w['idle_share']:.1f} %")


def runtime_and_exactly_once(torch, card: str) -> dict:
    """Phase 13 (see the module docstring), each turn's launch counts
    zeroed just before its traffic and read just after."""
    import hashlib
    import tempfile
    from collections import Counter

    from storm_tpu_torch.infer.engine import clear_engines

    t_phase = time.perf_counter()
    payloads, keys = life_payloads()
    burst, per_burst = life_burst(payloads)
    clear_engines()
    out = {}

    # (a) rebalance under traffic, then the measured windows
    label = "13 (a) rebalance"
    a = asyncio.run(rebalance_turn(torch, payloads))
    engine = a["engine"]
    check_no_rebuild(a, label)
    out["a_launches"] = check_tally_delta(engine, a["tally0"], a["forwards0"], VIT_LAUNCHES,
                                          a["wrapper_counts"], label)
    index = output_index(engine, a["batches"])
    counts = answers(index, a["outs"], keys, label)
    infer, spout = a["snap"]["inference-bolt"], a["snap"]["kafka-spout"]
    timeouts = [ev for ev in a["flight"] if ev["kind"] == "tree_timeout"]
    if a["errors"] or counts != [1] * len(keys) or len(a["outs"]) != len(keys) \
            or len(a["dlq"]) != 1 or spout.get("tree_failed", 0) or timeouts \
            or infer["dead_lettered"] != 1:
        raise AssertionError(f"{label}: answers per record {Counter(counts)}, "
                             f"{len(a['outs'])} outputs, {len(a['dlq'])} dead letters, "
                             f"{spout.get('tree_failed', 0)} failed trees, {len(timeouts)} "
                             f"timeouts, errors {a['errors'][:3]}")
    if a["grown"]["shared"] != [True] * 8:
        raise AssertionError(f"{label}: the grown tasks' engines {a['grown']['shared']}")
    idle = [i for i, (n0, n1) in enumerate(zip(a["grown"]["executed"], a["executed8"]))
            if n1 <= n0]
    if idle:
        raise AssertionError(f"{label}: tasks {idle} executed nothing after the grow")
    if a["paused"] != (0, 0):
        raise AssertionError(f"{label}: deactivated spouts emitted {a['paused'][0]} tuples "
                             f"and {a['paused'][1]} records came out")
    health = a["health"]["components"]
    if any(v["alive"] != v["tasks"] for v in health.values()) or \
            health["inference-bolt"]["tasks"] != 2:
        raise AssertionError(f"{label}: health {health}")
    windows = a["windows"]
    counts = answers(index, a["window_outs"], keys, f"{label}, windows")
    if counts != [len(windows) * c for c in per_burst] or a["window_dlq"] or \
            a["window_failed"] or a["window_timeouts"]:
        raise AssertionError(f"{label}, windows: answers per record {Counter(counts)}, "
                             f"{a['window_dlq']} dead letters, {a['window_failed']} failed "
                             f"trees, {a['window_timeouts']} timeouts")
    rounds = a["rounds"]
    for rd in rounds:
        log(f"  {label}, gated round {rd['round']:7s} (inference parallelism "
            f"{rd['parallelism']}) on {card}: {rd['records']} records, "
            f"{rd['records_per_s']:.3f} records/s, e2e p50 {rd['e2e_p50_ms']:.3f} ms "
            f"(too few records to rank the parallelisms)")
    for w in windows:
        log_window(f"{label}, window at inference parallelism {w['parallelism']}", w, card)
    log(f"  {label}: {len(keys)} records each answered once + the poison dead-lettered "
        f"across 4 -> 8 -> 2, none emitted while deactivated; no engine built or warmed "
        f"again (graphs {sorted(a['after']['graphs'])}), the 8 tasks on one engine, each "
        f"executing after the grow; {len(windows)} windows of {LIFE_BURST} records, each "
        f"answered once; launches {out['a_launches']}")
    out["a"] = {"rounds": rounds, "windows": windows, "health": health,
                "launches": out["a_launches"]}

    # (b) supervision, with the metrics consumers
    label = "13 (b) supervision"
    with tempfile.TemporaryDirectory() as tmp:
        b = asyncio.run(supervision_turn(payloads[:32], tmp))
    check_no_rebuild(b, label)
    if b["engine"] is not engine:
        raise AssertionError(f"{label}: served by another engine than (a)'s")
    out["b_launches"] = check_tally_delta(engine, b["tally0"], b["forwards0"], VIT_LAUNCHES,
                                          b["wrapper_counts"], label)
    counts = answers(output_index(engine, b["batches"]), b["outs"], keys[:32], label)
    restarts = b["snap"]["inference-bolt"].get("executor_restarts", 0)
    events = [ev for ev in b["flight"] if ev["kind"] == "executor_restart"]
    if b["errors"] or min(counts) < 1 or restarts != 1 or len(events) != 1 or \
            events[0]["component"] != "inference-bolt":
        raise AssertionError(f"{label}: answers {Counter(counts)}, restarts {restarts}, "
                             f"events {events}, errors {b['errors'][:3]}")
    snaps, lines = b["consumer_snaps"], b["jsonl"]
    rated = [s for s in snaps if s.get("inference-bolt", {}).get("execute_rate", 0) > 0
             and s.get("kafka-spout", {}).get("ack_rate", 0) > 0]
    final = snaps[-1] if snaps else {}
    # the two pumps tick apart: one may have fired once more at the kill
    if len(snaps) < 2 or abs(len(lines) - len(snaps)) > 1 or not rated or \
            final.get("inference-bolt", {}).get("executor_restarts") != 1 or \
            lines[-1]["metrics"]["kafka-bolt"]["delivered"] != final["kafka-bolt"]["delivered"]:
        raise AssertionError(f"{label}: consumers got {len(snaps)} / {len(lines)} snapshots, "
                             f"{len(rated)} with execute_rate and ack_rate above 0")
    if any(v["alive"] != v["tasks"] for v in b["health"]["components"].values()):
        raise AssertionError(f"{label}: health {b['health']}")
    dupes = sum(c - 1 for c in counts)
    log(f"  {label} on {card}: one task crashed by the chaos monkey, executor_restarts 1, "
        f"one executor_restart event ({events[0]['error']}); every record answered, "
        f"{dupes} duplicates; {len(b['outs'])} outputs in {b['wall']:.3f} s; no engine "
        f"rebuilt; consumers: {len(snaps)} snapshots each (the last at kill), "
        f"{len(rated)} with execute_rate and ack_rate above 0; launches {out['b_launches']}")
    out["b"] = {"duplicates": dupes, "snapshots": len(snaps), "rated": len(rated),
                "launches": out["b_launches"], "wall_s": b["wall"]}

    # (c) exactly-once on the main path: (a)'s burst through the
    # transactional topology and its at-least-once twin in turns (measured
    # and audited, no fault), then the transactional one with both faults
    want = Counter(hashlib.sha256(p.encode()).hexdigest()[:24] for p in burst)
    twins = []
    for eos in (True, False, False, True):
        label = f"13 (c) {'exactly-once' if eos else 'at-least-once twin'}, no fault"
        c = asyncio.run(exactly_once_turn(torch, burst, eos=eos))
        check_no_rebuild(c, label)
        if c["engine"] is not engine:
            raise AssertionError(f"{label}: served by another engine than (a)'s")
        launches = check_tally_delta(engine, c["tally0"], c["forwards0"], VIT_LAUNCHES,
                                     c["wrapper_counts"], label)
        echoes = Counter(r.value.decode()[2:] for r in c["outs"] if r.value.startswith(b"h:"))
        preds = [r for r in c["outs"] if not r.value.startswith(b"h:")]
        counts = answers(output_index(engine, c["batches"]), preds, keys, label)
        sink, spout = c["snap"]["kafka-bolt"], c["snap"]["kafka-spout"]
        if echoes != want or counts != per_burst or len(preds) != len(burst) or \
                c["errors"] or c["dlq"] or spout.get("tree_failed", 0) or \
                (eos and (c["committed"] != c["ends"] or sink.get("txn_aborts", 0))):
            raise AssertionError(f"{label}: {len(c['outs'])} outputs, echoes exact "
                                 f"{echoes == want}, answers {Counter(counts)}, committed "
                                 f"{c['committed']} of {c['ends']}, aborts "
                                 f"{sink.get('txn_aborts', 0)}, errors {c['errors'][:3]}")
        twins.append({"exactly_once": eos, **c["window"], "launches": launches,
                      "txn_commits": sink.get("txn_commits", 0)})
        log_window(label, c["window"], card)
    out["c0_launches"] = twins[0]["launches"]
    out["c_plain_launches"] = twins[1]["launches"]

    label = "13 (c) exactly-once, faults"
    records = payloads[:32] + [POISON] + payloads[32:64]
    c = asyncio.run(exactly_once_turn(torch, records, faults=True))
    check_no_rebuild(c, label)
    if c["engine"] is not engine:
        raise AssertionError(f"{label}: served by another engine than (a)'s")
    out["c_launches"] = check_tally_delta(engine, c["tally0"], c["forwards0"], VIT_LAUNCHES,
                                          c["wrapper_counts"], label)
    values = [r.value.decode() for r in c["outs"]]
    echoes = Counter(v[2:] for v in values if v.startswith("h:"))
    want = Counter(hashlib.sha256(p.encode()).hexdigest()[:24] for p in records)
    missing, duplicated = sum((want - echoes).values()), sum((echoes - want).values())
    preds = [r for r in c["outs"] if not r.value.startswith(b"h:")]
    counts = answers(output_index(engine, c["batches"]), preds, keys[:64], label)
    sink = c["snap"]["kafka-bolt"]
    restarts = c["snap"]["inference-bolt"].get("executor_restarts", 0)
    if c["errors"] and any(not str(e).startswith("chip smoke: injected")
                           for _, _, e in c["errors"]):
        raise AssertionError(f"{label}: errors {c['errors'][:3]}")
    if missing or duplicated or counts != [1] * 64 or len(preds) != 64 or \
            c["committed"] != c["ends"] or sink["txn_aborts"] < 1 or \
            sink["txn_commits"] < 1 or restarts != 1 or c["commits"]["failed"] != 1 or \
            not c["dlq"]:
        raise AssertionError(f"{label}: echo_missing {missing}, echo_duplicated "
                             f"{duplicated}, answers {Counter(counts)}, {len(preds)} "
                             f"predictions, committed {c['committed']} of {c['ends']}, "
                             f"aborts {sink['txn_aborts']}, commits {sink['txn_commits']}, "
                             f"restarts {restarts}, {len(c['dlq'])} dead letters")
    pred_e2e = c["snap"]["kafka-bolt"]["e2e_latency_ms_predictions"]
    res_c = {"records_per_s": 64 / c["wall"], "e2e_p50_ms": pred_e2e["p50"],
             "txn_commits": sink["txn_commits"], "txn_aborts": sink["txn_aborts"],
             "deferred": sink.get("txn_offsets_deferred", 0), "crashed_task": c["crashed"],
             "launches": out["c_launches"]}
    log(f"  {label}: 65 echo hashes each committed once (echo_missing 0, echo_duplicated 0), "
        f"64 predictions each a row of a forward the engine ran, the poison dead-lettered "
        f"({len(c['dlq'])} dead letters: that sink is at-least-once), "
        f"committed offsets {c['committed']} = the log ends, despite task {c['crashed']}'s "
        f"crash (executor_restarts 1) and one failed commit (txn_aborts "
        f"{sink['txn_aborts']}, txn_commits {sink['txn_commits']}, "
        f"{res_c['deferred']} deferrals); {res_c['records_per_s']:.3f} records/s, "
        f"predictions' e2e p50 {pred_e2e['p50']:.3f} ms with the faults (one tree waits "
        f"out the 3 s message timeout); launches {out['c_launches']}")

    def med(rows: list, key: str) -> float:
        return float(np.median([r[key] for r in rows]))

    at4 = [w for w in windows if w["parallelism"] == 4]
    cost = {kind: {k: med(rows, k) for k in ("records_per_s", "e2e_p50_ms", "decode_share",
                                               "idle_share")}
            for kind, rows in (("a_at_4", at4),
                               ("exactly_once", [t for t in twins if t["exactly_once"]]),
                               ("at_least_once", [t for t in twins if not t["exactly_once"]]))}
    log(f"  13 (c) the cost of exactly-once on {card}, medians of two windows of the same "
        f"{LIFE_BURST} records each: exactly-once {cost['exactly_once']['records_per_s']:.3f} "
        f"records/s, predictions' e2e p50 {cost['exactly_once']['e2e_p50_ms']:.3f} ms; its "
        f"at-least-once twin {cost['at_least_once']['records_per_s']:.3f} records/s, "
        f"{cost['at_least_once']['e2e_p50_ms']:.3f} ms; (a) at inference parallelism 4 "
        f"(chunks of 1, no echo bolt) {cost['a_at_4']['records_per_s']:.3f} records/s, "
        f"{cost['a_at_4']['e2e_p50_ms']:.3f} ms")
    out["c"] = res_c
    out["c_twins"] = twins
    out["cost_of_exactly_once"] = cost
    clear_engines()
    out["wall_s"] = time.perf_counter() - t_phase
    log(f"  phase 13 took {out['wall_s']:.1f} s")
    return out



# ---- phase 14: the decode tier and DRPC ------------------------------------------

DEC_SESSIONS = 64     # 14 (a) and (b): sessions, prompts of 8-40 characters
DEC_TOKENS = 48       # each session's token budget
DEC_SEED = 14         # char_tiny's weights and the prompts
DEC_CLASSIFY = 16     # classify rows beside each step of (a), and in (b)
DEC_EVICT = (8, 32)   # 14 (c): arena blocks, sessions
DEC_MIGRATE = 8       # 14 (d): sessions, each with a budget of 120 tokens
DRPC_CALLS = 64       # 14 (e): concurrent calls


def dec_prompts(n: int = DEC_SESSIONS, seed: int = DEC_SEED) -> list:
    """``n`` seeded printable prompts of 8 to 40 characters."""
    rng = np.random.RandomState(seed)
    return ["".join(chr(c) for c in rng.randint(32, 127, size=rng.randint(8, 41)))
            for _ in range(n)]


def greedy_sessions(eng, prompts: list, tokens: int, classify: np.ndarray) -> dict:
    """Engine-direct greedy decode as the decode bolt runs a session: a
    prefill of [BOS] + the prompt, then one step a token, until EOS or
    ``tokens`` tokens. All sessions co-batch in every step, with the
    ``classify`` tokens as slot = -1 rows beside them. Returns the tokens,
    every step's logits and the classify rows' logits of every step."""
    from storm_tpu_torch.decode import STATELESS
    from storm_tpu_torch.models import chartiny as ct

    ctx = [[ct.BOS] + ct.encode_text(p) for p in prompts]
    slots = [eng.kv.acquire(f"s{i}") for i in range(len(prompts))]
    cls = np.stack([np.full(len(classify), STATELESS), classify,
                    np.zeros(len(classify), np.int64)], 1)
    rows = np.concatenate([eng.prefill_rows(s, c) for s, c in zip(slots, ctx)] + [cls])
    ends = np.cumsum([len(c) for c in ctx]) - 1
    live = list(range(len(prompts)))
    out = {"tokens": [[] for _ in prompts], "logits": [], "classify": [], "steps": 0,
           "rows": 0, "step_ms": [], "prefill_rows": len(rows)}
    t0 = time.perf_counter()
    while live:
        t = time.perf_counter()
        lg = eng.predict(rows)
        out["step_ms"].append((time.perf_counter() - t) * 1e3)
        out["steps"] += 1
        out["rows"] += len(rows)
        out["logits"].append(lg)
        out["classify"].append(lg[len(rows) - len(classify):])
        nxt = []
        for j, i in enumerate(live):
            tok = int(np.argmax(lg[ends[j]]))
            out["tokens"][i].append(tok)
            if tok != ct.EOS and len(out["tokens"][i]) < tokens:
                nxt.append(i)
        live = nxt
        rows = np.concatenate(
            [np.array([[slots[i], out["tokens"][i][-1], len(ctx[i]) + len(out["tokens"][i]) - 1]
                       for i in live], np.int64).reshape(-1, 3), cls])
        ends = np.arange(len(live))
    out["wall_s"] = time.perf_counter() - t0
    # A checkpoint's fold of every session's KV: one read of the arena
    # against one a session (storm_tpu's fold, from its host arena).
    sids = [f"s{i}" for i in range(len(prompts))]
    for _ in range(2):  # the second pass is timed
        t = time.perf_counter()
        one_by_one = {sid: eng.kv.serialize(sid) for sid in sids}
        out["fold_each_ms"] = (time.perf_counter() - t) * 1e3
        t = time.perf_counter()
        many = eng.kv.serialize_many(sids)
        out["fold_many_ms"] = (time.perf_counter() - t) * 1e3
    if many != one_by_one:
        raise AssertionError("serialize_many's blobs differ from serialize's")
    out["arena"] = eng.kv.arena.cpu().numpy()
    out["lens"] = eng.kv.lens.copy()
    return out


def decode_engine_direct(torch, device: str, card: str) -> dict:
    """14 (a): the same sessions through a DecodeEngine on ``device`` and on
    the CPU: greedy tokens identical, every step's logits and the arena
    within 1e-5, the classify rows the classify view's logits."""
    from storm_tpu_torch.decode.engine import DecodeEngine
    from storm_tpu_torch.models import chartiny as ct
    from storm_tpu_torch.models.convert import chartiny_params

    prompts = dec_prompts()
    classify = np.random.RandomState(DEC_SEED + 1).randint(0, ct.VOCAB, DEC_CLASSIFY)
    runs = {}
    for dev in (device, "cpu"):
        eng = DecodeEngine(seed=DEC_SEED, blocks=DEC_SESSIONS, max_seq=ct.MAX_SEQ, device=dev)
        runs[dev] = greedy_sessions(eng, prompts, DEC_TOKENS, classify)
    card_run, cpu_run = runs[device], runs["cpu"]
    label = "14 (a) decode engine-direct"
    if card_run["tokens"] != cpu_run["tokens"]:
        bad = [i for i, (a, b) in enumerate(zip(card_run["tokens"], cpu_run["tokens"])) if a != b]
        raise AssertionError(f"{label}: greedy tokens differ from the CPU run's in sessions "
                             f"{bad[:8]}")
    logit_err = max(float(np.abs(a - b).max())
                    for a, b in zip(card_run["logits"], cpu_run["logits"]))
    arena_err = float(np.abs(card_run["arena"] - cpu_run["arena"]).max())
    params = chartiny_params(ct.build_params(DEC_SEED), device)
    view = ct.stateless_logits(params, torch.as_tensor(classify, device=device)).cpu().numpy()
    cls_err = max(float(np.abs(c - view).max()) for c in card_run["classify"])
    if logit_err > 1e-5 or arena_err > 1e-5 or cls_err > 1e-5 or \
            (card_run["lens"] != cpu_run["lens"]).any():
        raise AssertionError(f"{label}: logits {logit_err:.3g}, arena {arena_err:.3g}, "
                             f"classify rows {cls_err:.3g} from the CPU run and the view "
                             f"(tolerance 1e-5)")
    n_tok = sum(len(t) for t in card_run["tokens"])
    res = {"sessions": len(prompts), "tokens": n_tok, "steps": card_run["steps"],
           "rows": card_run["rows"], "max_abs_err_logits": logit_err,
           "max_abs_err_arena": arena_err, "max_abs_err_classify": cls_err,
           "tokens_per_s": n_tok / card_run["wall_s"],
           "cpu_tokens_per_s": n_tok / cpu_run["wall_s"]}
    for name, r in (("card", card_run), ("cpu", cpu_run)):
        res[f"{name}_prefill_ms"] = r["step_ms"][0]
        res[f"{name}_step_p50_ms"] = float(np.median(r["step_ms"][1:]))
        res[f"{name}_fold_each_ms"] = r["fold_each_ms"]
        res[f"{name}_fold_many_ms"] = r["fold_many_ms"]
    log(f"  {label} on {card}: {len(prompts)} sessions, {n_tok} greedy tokens identical to "
        f"the CPU run's; logits within {logit_err:.3g}, arena within {arena_err:.3g}, "
        f"classify rows within {cls_err:.3g} of the classify view (tolerance 1e-5); "
        f"{card_run['steps']} steps of {card_run['rows'] / card_run['steps']:.1f} rows, "
        f"{res['tokens_per_s']:.3f} tokens/s on the card, {res['cpu_tokens_per_s']:.3f} on the "
        f"CPU; the prefill step ({card_run['prefill_rows']} rows) "
        f"{res['card_prefill_ms']:.3f} ms on the card, {res['cpu_prefill_ms']:.3f} on "
        f"the CPU; a later step's p50 {res['card_step_p50_ms']:.3f} ms on the card, "
        f"{res['cpu_step_p50_ms']:.3f} on the CPU; folding the {len(prompts)} sessions' KV "
        f"one by one {res['card_fold_each_ms']:.3f} ms on the card "
        f"({res['cpu_fold_each_ms']:.3f} on the CPU), in one read "
        f"{res['card_fold_many_ms']:.3f} ms ({res['cpu_fold_many_ms']:.3f}), the same blobs")
    return res, card_run["tokens"]


class _Capture:
    """Every token a capture bolt saw: (session_id, token_index, message)."""
    seen: list = []


def timed_calls(obj, name: str) -> list:
    """Wrap ``obj.name`` (an instance attribute shadows the method) to
    append each call's milliseconds to the returned list."""
    fn, ms = getattr(obj, name), []

    def timed(*a, **k):
        t = time.perf_counter()
        try:
            return fn(*a, **k)
        finally:
            ms.append((time.perf_counter() - t) * 1e3)

    setattr(obj, name, timed)
    return ms


def decode_topology(prompts: list, tokens: int, cfg, device: str, tasks: int = 2):
    """SessionSpout (one request a prompt) -> ``tasks`` DecodeBolts on the
    ring grouping -> a capture bolt appending each token to
    ``_Capture.seen``."""
    from storm_tpu_torch.decode import DecodeBolt, SessionSpout
    from storm_tpu_torch.runtime import Bolt, TopologyBuilder

    class Capture(Bolt):
        async def execute(self, t):
            _Capture.seen.append((t.get("session_id"), t.get("token_index"),
                                  t.get("message")))
            self.collector.ack(t)

    reqs = [{"session_id": f"s{i}", "prompt": p, "max_new_tokens": tokens}
            for i, p in enumerate(prompts)]
    tb = TopologyBuilder()
    tb.set_spout("requests", SessionSpout(reqs), 1)
    tb.set_bolt("decode-bolt", DecodeBolt(cfg, device=device), tasks) \
        .ring_fields_grouping("requests", "session_id")
    tb.set_bolt("capture", Capture(), 1).shuffle_grouping("decode-bolt")
    return tb.build(), reqs


def dec_streams(label: str, sessions: list) -> dict:
    """Each session's tokens as the capture bolt saw them, checked gapless
    and free of duplicates."""
    streams = {}
    for sid in sessions:
        seen = sorted((i, m) for s, i, m in _Capture.seen if s == sid)
        idxs = [i for i, _ in seen]
        if idxs != list(range(len(idxs))) or not idxs:
            raise AssertionError(f"{label}: session {sid}'s indices are not gapless and "
                                 f"unique: {idxs[:12]}")
        # Every token is one character but EOS, which can only end a stream.
        streams[sid] = (len(idxs), "".join(m for _, m in seen))
    return streams


async def wait_acked(rt, n: int, label: str, timeout_s: float = 120.0):
    sp = rt.spout_execs["requests"][0].spout
    deadline = time.monotonic() + timeout_s
    while len(set(sp.acked)) < n:
        if time.monotonic() > deadline:
            raise TimeoutError(f"{label}: {len(set(sp.acked))} of {n} requests acked in "
                               f"{timeout_s} s")
        await asyncio.sleep(0.01)
    return sp


async def decode_served_turn(torch, device: str, direct_tokens: list) -> dict:
    """14 (b): the 64 sessions through SessionSpout -> 2 DecodeBolts on the
    ring grouping -> a capture bolt, classify rows submitted to the same
    queue meanwhile."""
    from storm_tpu_torch.config import Config
    from storm_tpu_torch.decode import STATELESS, DecodeConfig
    from storm_tpu_torch.decode.engine import _reset_engines
    from storm_tpu_torch.models import chartiny as ct
    from storm_tpu_torch.models.convert import chartiny_params
    from storm_tpu_torch.runtime import AsyncLocalCluster

    _reset_engines()
    _Capture.seen = []
    prompts = dec_prompts()
    dcfg = DecodeConfig(seed=DEC_SEED, arena_blocks=DEC_SESSIONS, max_new_tokens=DEC_TOKENS)
    topo, reqs = decode_topology(prompts, DEC_TOKENS, dcfg, device)
    cfg = Config()
    cfg.topology.message_timeout_s = 120.0
    cluster = AsyncLocalCluster()
    classify = np.random.RandomState(DEC_SEED + 2).randint(0, ct.VOCAB, DEC_CLASSIFY)
    with card_busy(torch) as busy:
        t0 = time.perf_counter()
        rt = await cluster.submit("chip-smoke-phase14b", cfg, topo)
        try:
            bolts = [e.bolt for e in rt.bolt_execs["decode-bolt"]]
            engine = bolts[0].engine
            predict_ms = timed_calls(engine, "predict")
            serialize_ms = timed_calls(engine.kv, "serialize_many")
            stats0 = engine.stats()
            subs = []
            sp = rt.spout_execs["requests"][0].spout
            while len(set(sp.acked)) < len(reqs):
                if len(subs) < DEC_CLASSIFY and _Capture.seen:
                    # a classify row rides the decode queue among the steps
                    k = len(subs)
                    subs.append(bolts[0].batcher.submit(
                        np.array([[STATELESS, classify[k], 0]], np.int64), source="classify"))
                await asyncio.sleep(0.002)
                if time.perf_counter() - t0 > 300:
                    raise TimeoutError(f"14 (b): {len(set(sp.acked))} of {len(reqs)} acked")
            wall = time.perf_counter() - t0
            got = np.concatenate([await asyncio.wrap_future(s.future) for s in subs])
            stats1 = engine.stats()
            owners: dict = {}
            for b in bolts:
                for s in b.sessions.all():
                    if s.session_id in owners:
                        raise AssertionError(f"14 (b): session {s.session_id} on two tasks")
                    owners[s.session_id] = b.sessions.task_index
            snap = rt.metrics.snapshot()["decode-bolt"]
            res = {"acked": len(set(sp.acked)), "failed": list(sp.failed), "owners": owners,
                   "wall": wall, "stats0": stats0, "stats1": stats1, "snap": snap,
                   "classify": got,
                   "errors": list(rt.errors), "predict_ms": list(predict_ms),
                   "serialize_ms": list(serialize_ms)}
            del engine.predict, engine.kv.serialize_many
        finally:
            await cluster.shutdown()
    params = chartiny_params(ct.build_params(DEC_SEED), device)
    view = ct.stateless_logits(params, torch.as_tensor(classify[:len(got)],
                                                       device=device)).cpu().numpy()
    res["classify_err"] = float(np.abs(got - view).max()) if len(got) else None
    res["idle_share"] = busy["idle_share"]
    res["direct"] = {f"s{i}": (len(t), ct.decode_tokens(t)) for i, t in enumerate(direct_tokens)}
    return res


async def decode_evict_turn(device: str) -> dict:
    """14 (c): 32 sessions on an arena of 8 blocks, one task, at most 8
    requests in flight."""
    from storm_tpu_torch.config import Config
    from storm_tpu_torch.decode import DecodeConfig
    from storm_tpu_torch.decode.engine import _reset_engines
    from storm_tpu_torch.runtime import AsyncLocalCluster

    _reset_engines()
    _Capture.seen = []
    blocks, n = DEC_EVICT
    prompts = dec_prompts(n, DEC_SEED + 3)
    dcfg = DecodeConfig(seed=DEC_SEED, arena_blocks=blocks, max_new_tokens=24)
    topo, reqs = decode_topology(prompts, 24, dcfg, device, tasks=1)
    cfg = Config()
    cfg.topology.message_timeout_s = 120.0
    # At most as many sessions in flight as blocks: a slot is always free
    # or evictable (a finished session's, or an idle one's), never all
    # pinned at once.
    cfg.topology.max_spout_pending = blocks
    cluster = AsyncLocalCluster()
    rt = await cluster.submit("chip-smoke-phase14c", cfg, topo)
    try:
        t0 = time.perf_counter()
        sp = await wait_acked(rt, len(reqs), "14 (c)")
        bolt = rt.bolt_execs["decode-bolt"][0].bolt
        return {"wall": time.perf_counter() - t0, "evictions": bolt.engine.kv.evictions,
                "evicted": rt.metrics.counter("decode-bolt", "decode_sessions_evicted").value,
                "replays": len(sp.failed), "sessions": [r["session_id"] for r in reqs],
                "errors": list(rt.errors)}
    finally:
        await cluster.shutdown()


async def decode_migrate_turn(device: str, tmp: str) -> dict:
    """14 (d): a graceful kill mid-generation with the file state backend,
    then the same topology again."""
    from storm_tpu_torch.config import Config
    from storm_tpu_torch.decode import DecodeConfig
    from storm_tpu_torch.decode.engine import _reset_engines
    from storm_tpu_torch.obs import copyledger
    from storm_tpu_torch.runtime import AsyncLocalCluster

    _reset_engines()
    _Capture.seen = []
    ledger = copyledger.ensure_installed()
    ledger.reset()
    prompts = dec_prompts(DEC_MIGRATE, DEC_SEED + 4)
    dcfg = DecodeConfig(seed=DEC_SEED, arena_blocks=16, drain_mode="migrate",
                        max_new_tokens=120)
    cfg = Config()
    cfg.topology.message_timeout_s = 120.0
    cfg.topology.checkpoint_interval_s = 30.0
    cfg.topology.state_dir = tmp
    cluster = AsyncLocalCluster()
    topo, reqs = decode_topology(prompts, 120, dcfg, device, tasks=1)
    await cluster.submit("chip-smoke-phase14d", cfg, topo)
    deadline = time.monotonic() + 120
    while len({s for s, _, _ in _Capture.seen}) < len(reqs) or \
            len(_Capture.seen) < 4 * len(reqs):
        if time.monotonic() > deadline:
            raise TimeoutError("14 (d): the sessions did not all start streaming")
        await asyncio.sleep(0.002)
    await cluster.kill("chip-smoke-phase14d", wait_secs=0.2)
    before = len(_Capture.seen)
    topo, reqs = decode_topology(prompts, 120, dcfg, device, tasks=1)
    rt = await cluster.submit("chip-smoke-phase14d", cfg, topo)
    try:
        await wait_acked(rt, len(reqs), "14 (d) after the restart")
        bolt = rt.bolt_execs["decode-bolt"][0].bolt
        sessions = bolt.sessions.all()
        return {"before": before, "after": len(_Capture.seen),
                "restored": {s.session_id: s.restored for s in sessions},
                "done_before": sum(1 for s in sessions if not s.restored),
                "cold": bolt.sessions.sessions_cold,
                "migrate": ledger.snapshot()["stages"].get("kv_migrate", {}),
                "sessions": [r["session_id"] for r in reqs], "errors": list(rt.errors)}
    finally:
        await cluster.shutdown()


async def drpc_turn(device: str, payloads: list) -> dict:
    """14 (e): DRPC_CALLS concurrent calls and one poison call through
    ``drpc_inference_topology`` with ViT-B/16 bf16 int8_fused."""
    from storm_tpu_torch.config import BatchConfig, Config
    from storm_tpu_torch.ops import _build
    from storm_tpu_torch.runtime import AsyncLocalCluster
    from storm_tpu_torch.runtime.drpc import DRPCError, DRPCServer, drpc_inference_topology

    server = DRPCServer()
    topo = drpc_inference_topology(server, vit_b16_config(),
                                   BatchConfig(max_batch=B, buckets=(B,), max_wait_ms=50.0),
                                   device=device, infer_parallelism=2)
    cluster = AsyncLocalCluster()
    rt = await cluster.submit("chip-smoke-phase14e", Config(), topo)
    try:
        engine = rt.bolt_execs["inference-bolt"][0].bolt.engine
        before = engine_state(engine)
        batches: list = []
        recording(engine, batches)
        _build.reset_launch_counts()
        tally0, forwards0 = engine.launch_tally(), engine.forwards

        async def call(p):
            t = time.perf_counter()
            out = await server.execute("predict", p, timeout_s=120)
            return out, (time.perf_counter() - t) * 1e3

        t0 = time.perf_counter()
        got = await asyncio.gather(*(call(p) for p in payloads))
        wall = time.perf_counter() - t0
        t = time.perf_counter()
        try:
            await server.execute("predict", POISON, timeout_s=60)
            poison = None
        except DRPCError as e:
            poison = (type(e).__name__, str(e), time.perf_counter() - t)
        del engine.dispatch
        return {"outs": [o for o, _ in got], "ms": [m for _, m in got], "wall": wall,
                "forwards": engine.forwards - forwards0,
                "poison": poison, "engine": engine, "before": before,
                "after": engine_state(engine), "batches": batches, "tally0": tally0,
                "forwards0": forwards0, "wrapper_counts": _build.launch_counts(),
                "inflight": server.inflight, "errors": list(rt.errors)}
    finally:
        await cluster.shutdown()


def decode_and_drpc(torch, card: str, device: str = "cuda") -> dict:
    """Phase 14 (see the module docstring)."""
    import tempfile
    from types import SimpleNamespace

    from storm_tpu_torch.decode import decode_stats
    from storm_tpu_torch.decode.engine import _reset_engines
    from storm_tpu_torch.infer.engine import clear_engines

    t_phase = time.perf_counter()
    out = {}
    out["a"], direct_tokens = decode_engine_direct(torch, device, card)

    label = "14 (b) decode served"
    b = asyncio.run(decode_served_turn(torch, device, direct_tokens))
    streams = dec_streams(label, [f"s{i}" for i in range(DEC_SESSIONS)])
    if b["acked"] != DEC_SESSIONS or b["failed"] or b["errors"] or streams != b["direct"]:
        bad = [s for s in streams if streams[s] != b["direct"][s]]
        raise AssertionError(f"{label}: {b['acked']} acked, failed {b['failed'][:4]}, errors "
                             f"{b['errors'][:2]}, sessions unlike (a)'s {bad[:8]}")
    if len(set(b["owners"].values())) != 2 or len(b["owners"]) != DEC_SESSIONS:
        raise AssertionError(f"{label}: owners {sorted(set(b['owners'].values()))} for "
                             f"{len(b['owners'])} sessions")
    if not len(b["classify"]) or b["classify_err"] > 1e-5:
        raise AssertionError(f"{label}: {len(b['classify'])} classify rows, within "
                             f"{b['classify_err']} of the classify view")
    s0, s1 = b["stats0"], b["stats1"]
    steps = s1["steps"] - s0["steps"]
    rows = s1["rows_decode"] + s1["rows_classify"] - s0["rows_decode"] - s0["rows_classify"]
    n_tok = len(_Capture.seen)
    ttft, tok = b["snap"]["decode_ttft_ms"], b["snap"]["decode_token_ms"]
    pm, sm = np.array(b["predict_ms"]), np.array(b["serialize_ms"])
    host = {"predict_calls": len(pm), "predict_p50_ms": float(np.median(pm)),
            "predict_share": float(pm.sum()) / (b["wall"] * 1e3),
            "serialize_calls": len(sm), "serialize_p50_ms": float(np.median(sm)) if len(sm) else 0.0,
            "serialize_share": float(sm.sum()) / (b["wall"] * 1e3)}
    out["b"] = {"sessions": DEC_SESSIONS, "tokens": n_tok, "wall_s": b["wall"], **host,
                "tokens_per_s": n_tok / b["wall"], "ttft_p50_ms": ttft["p50"],
                "ttft_p99_ms": ttft["p99"], "token_p50_ms": tok["p50"],
                "rows_per_step": rows / max(steps, 1), "steps": steps,
                "classify_rows": len(b["classify"]), "classify_err": b["classify_err"],
                "idle_share": b["idle_share"],
                "tasks": sorted(set(b["owners"].values()))}
    log(f"  {label} on {card}: {DEC_SESSIONS} sessions acked over 2 tasks (owners disjoint), "
        f"{n_tok} tokens, each session's stream gapless and equal to (a)'s; "
        f"{len(b['classify'])} classify rows on the same queue within {b['classify_err']:.3g} "
        f"of the view; {out['b']['tokens_per_s']:.3f} tokens/s, TTFT p50 "
        f"{ttft['p50']:.3f} ms p99 {ttft['p99']:.3f} ms, token p50 {tok['p50']:.4f} ms, "
        f"{out['b']['rows_per_step']:.2f} rows a step over {steps} steps, card idle "
        f"{100 * b['idle_share']:.1f} % (the first submit included); {host['predict_calls']} "
        f"steps p50 {host['predict_p50_ms']:.3f} ms, {100 * host['predict_share']:.1f} % of "
        f"the wall; {host['serialize_calls']} KV folds (the checkpoint a token serializes every "
        f"live session of its task, one read of the arena) p50 {host['serialize_p50_ms']:.3f} ms, "
        f"{100 * host['serialize_share']:.1f} % of the wall")

    label = "14 (c) eviction"
    c = asyncio.run(decode_evict_turn(device))
    dec_streams(label, c["sessions"])
    if c["evictions"] <= 0 or c["errors"]:
        raise AssertionError(f"{label}: {c['evictions']} evictions, errors {c['errors'][:2]}")
    out["c"] = {k: c[k] for k in ("evictions", "evicted", "replays", "wall")}
    log(f"  {label} on {card}: {DEC_EVICT[1]} sessions on {DEC_EVICT[0]} blocks, "
        f"{c['evictions']} evictions, {c['replays']} requests replayed, every stream gapless "
        f"with no token re-emitted, in {c['wall']:.3f} s")

    label = "14 (d) rolling restart"
    with tempfile.TemporaryDirectory() as tmp:
        d = asyncio.run(decode_migrate_turn(device, tmp))
    dec_streams(label, d["sessions"])
    live = {s: r for s, r in d["restored"].items() if r}
    if d["cold"] or not live or any(r != "kv" for r in live.values()) or \
            d["after"] <= d["before"] or not d["migrate"] or \
            d["migrate"]["calls"] < 2 * len(live) or d["errors"]:
        raise AssertionError(f"{label}: restored {d['restored']}, cold {d['cold']}, "
                             f"{d['before']} -> {d['after']} tokens, kv_migrate "
                             f"{d['migrate']}, errors {d['errors'][:2]}")
    out["d"] = {"restored_kv": len(live), "finished_before_kill": d["done_before"],
                "kv_migrate_calls": d["migrate"]["calls"],
                "kv_migrate_bytes": d["migrate"]["bytes"],
                "tokens_before": d["before"], "tokens_after": d["after"]}
    log(f"  {label} on {card}: killed mid-generation after {d['before']} tokens; "
        f"{len(live)} live sessions restored \"kv\" (none cold, "
        f"{d['done_before']} had finished), every stream gapless and free of duplicates "
        f"over {d['after']} tokens; kv_migrate {d['migrate']['calls']} rows, "
        f"{d['migrate']['bytes']} bytes")

    stats = decode_stats()
    from storm_tpu_torch.obs import Observatory
    from storm_tpu_torch.runtime.metrics import MetricsRegistry

    snap = Observatory(SimpleNamespace(metrics=MetricsRegistry(), flight=None)).snapshot()
    if snap["decode"]["tokens_emitted"] != stats["tokens_emitted"] or not stats["engines"]:
        raise AssertionError(f"14: decode_snapshot {snap['decode']} against {stats}")
    _reset_engines()

    label = "14 (e) DRPC"
    clear_engines()
    payloads, keys = life_payloads()
    e = asyncio.run(drpc_turn(device, payloads[:DRPC_CALLS]))
    check_no_rebuild(e, label)
    out["e_launches"] = check_tally_delta(e["engine"], e["tally0"], e["forwards0"],
                                          VIT_LAUNCHES, e["wrapper_counts"], label)
    recs = [SimpleNamespace(value=o) for o in e["outs"]]
    counts = answers(output_index(e["engine"], e["batches"]), recs, keys[:DRPC_CALLS], label)
    poison = e["poison"]
    if counts != [1] * DRPC_CALLS or poison is None or poison[0] != "DRPCError" or \
            "timeout" in poison[1].lower() or e["inflight"] or e["errors"]:
        raise AssertionError(f"{label}: answers {counts}, poison {poison}, inflight "
                             f"{e['inflight']}, errors {e['errors'][:2]}")
    ms = np.array(e["ms"])
    out["e"] = {"calls": DRPC_CALLS, "wall_s": e["wall"], "calls_per_s": DRPC_CALLS / e["wall"],
                "call_p50_ms": float(np.percentile(ms, 50)),
                "call_p99_ms": float(np.percentile(ms, 99)),
                "forwards": e["forwards"],
                "poison_s": poison[2], "launches": out["e_launches"]}
    log(f"  {label} on {card}: {DRPC_CALLS} concurrent calls, each answer a row of a forward "
        f"the engine ran, over {out['e']['forwards']} forwards; call p50 "
        f"{out['e']['call_p50_ms']:.3f} ms p99 {out['e']['call_p99_ms']:.3f} ms, "
        f"{out['e']['calls_per_s']:.3f} calls/s; the poison call failed in "
        f"{poison[2]:.3f} s with the schema error ({poison[1][:60]}); launches "
        f"{out['e_launches']}")
    clear_engines()
    out["wall_s"] = time.perf_counter() - t_phase
    log(f"  phase 14 took {out['wall_s']:.1f} s")
    return out


# ---- phase 15: training on the card -------------------------------------------------

TRAIN_SEED = 15
TRAIN_STEPS = 3
# Steps timed after the gated ones, their median printed (information only).
TIMED_STEPS = 5
# Each step's loss, kernel path against plain path, relative; step 1's
# gradients by the global norm of their difference over the plain path's.
TRAIN_LOSS_TOL = TRAIN_GRAD_TOL = 1e-4
# Launches per ViT-B/16 float32 train step: the forward's fused norms and
# f32 flash attention, nothing else (no backward kernel, float weights).
TRAIN_STEP_LAUNCHES = {"residual_layernorm_sm90": 12, "flash_attention": 12}
# accuracy_harness.py's digits training (MODEL_SPECS), from storm_tpu's
# init_params exported to checkpoints_torch/<model>_init.npz.
DIGITS_TRAIN = (("lenet5", (32, 32, 1)), ("resnet20", (32, 32, 3)),
                ("vit_tiny", (32, 32, 3)), ("moe_vit_tiny", (32, 32, 3)))
DIGITS_TRAIN_ARGS = {"batch_size": 128, "max_epochs": 60, "learning_rate": 1e-3,
                     "patience": 8, "seed": 0}
TRAIN_ACC_BOUND = 0.02  # held-out accuracy against ACCURACY_r04.json's
ACCURACY_ARTIFACT = "ACCURACY_r04.json"


def leaf_paths(tree) -> list:
    from storm_tpu_torch.models.convert import _map

    paths: list = []
    _map(lambda _leaf, path: paths.append(path), tree)
    return paths


def vit_train_steps(torch, card: str) -> dict:
    """(a) ViT-B/16 at full width in float32, seeded, one seeded batch of
    B, TRAIN_STEPS AdamW steps through ``make_train_step``, once with the
    kernels and once with the plain versions (``plain_kernels``), both on
    the card."""
    from storm_tpu_torch.models.convert import init_params, trainable_params, tree_leaves
    from storm_tpu_torch.models.registry import model_def
    from storm_tpu_torch.ops import _build
    from storm_tpu_torch.parallel.train import make_train_step

    md = model_def("vit_b16")
    params0, _ = init_params(md, TRAIN_SEED)
    rng = np.random.RandomState(TRAIN_SEED)
    x = rng.rand(B, *md.input_shape).astype(np.float32)
    y = rng.randint(0, md.num_classes, B).astype(np.int32)
    paths = leaf_paths(params0)
    runs = {}
    for label in ("kernels", "plain"):
        params = trainable_params(params0, "cuda")
        step, opt = make_train_step(md, device="cuda")
        opt_state = opt(params)
        losses, ms, counts, grads = [], [], [], None
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        base = torch.cuda.memory_allocated()
        with plain_kernels() if label == "plain" else contextlib.nullcontext():
            for i in range(TRAIN_STEPS):
                torch.cuda.synchronize()
                _build.reset_launch_counts()
                t = time.perf_counter()
                params, opt_state, _state, loss = step(params, opt_state, {}, x, y)
                losses.append(float(loss))  # waits for the optimizer's kernels too
                ms.append((time.perf_counter() - t) * 1e3)
                counts.append(_build.launch_counts())
                if i == 0:
                    grads = [None if p.grad is None else p.grad.detach().clone()
                             for p in tree_leaves(params)]
            timed = []
            for _ in range(TIMED_STEPS):
                torch.cuda.synchronize()
                t = time.perf_counter()
                params, opt_state, _state, loss = step(params, opt_state, {}, x, y)
                float(loss)
                timed.append((time.perf_counter() - t) * 1e3)
        runs[label] = {"losses": losses, "ms": ms, "counts": counts, "grads": grads,
                       "step_ms": float(np.median(timed)),
                       "peak_bytes": torch.cuda.max_memory_allocated() - base}
        del params, opt_state, step, opt
        torch.cuda.empty_cache()
    k, p = runs["kernels"], runs["plain"]
    loss_err = max(abs(a - b) / abs(b) for a, b in zip(k["losses"], p["losses"]))
    missing = [paths[i] for i, g in enumerate(k["grads"]) if g is None]
    if missing:
        raise AssertionError(f"phase 15a: leaves with no gradient on the kernel path: "
                             f"{missing[:6]}")
    # The attention key biases' gradients are zero in exact arithmetic (the
    # softmax ignores a constant added to every score of a row): rounding
    # noise, printed; every other leaf must have a nonzero gradient.
    key_bias = [i for i, pth in enumerate(paths) if pth[-2:] == ("k", "b")]
    zero = [paths[i] for i, g in enumerate(k["grads"])
            if i not in key_bias and not bool(g.abs().max() > 0)]
    if zero:
        raise AssertionError(f"phase 15a: leaves with an all-zero gradient: {zero[:6]}")
    diff = math.sqrt(sum(float((a - b).double().square().sum())
                         for a, b in zip(k["grads"], p["grads"])))
    norm = math.sqrt(sum(float(b.double().square().sum()) for b in p["grads"]))
    grad_err = diff / norm
    key_bias_max = max(float(k["grads"][i].abs().max()) for i in key_bias)
    want = {n: TRAIN_STEP_LAUNCHES.get(n, 0) for n in _build.KERNELS}
    for label, run in runs.items():
        for i, c in enumerate(run["counts"]):
            expect = want if label == "kernels" else {n: 0 for n in _build.KERNELS}
            if c != expect:
                raise AssertionError(f"phase 15a {label} step {i + 1}: launches {c}, "
                                     f"want {expect}")
    log(f"  (a) vit_b16 float32 B={B}, {TRAIN_STEPS} AdamW steps: losses kernels "
        f"{k['losses']} plain {p['losses']}, max rel diff {loss_err:.3e} (<= "
        f"{TRAIN_LOSS_TOL:.0e}); step 1 gradients: |g_k - g_p| / |g_p| {grad_err:.3e} (<= "
        f"{TRAIN_GRAD_TOL:.0e}), {len(paths)} leaves all with a gradient, nonzero but for "
        f"the {len(key_bias)} key biases (largest |g| {key_bias_max:.3e}); launches a step "
        f"{k['counts'][0]}; step ms kernels {[round(v, 3) for v in k['ms']]} plain "
        f"{[round(v, 3) for v in p['ms']]}, median of {TIMED_STEPS} more: kernels "
        f"{k['step_ms']:.3f} plain {p['step_ms']:.3f}; peak bytes above the phase's start, kernels "
        f"{k['peak_bytes']} plain {p['peak_bytes']} ({card})")
    if not all(map(math.isfinite, k["losses"] + p["losses"])):
        raise AssertionError("phase 15a: a loss is not finite")
    if loss_err > TRAIN_LOSS_TOL or grad_err > TRAIN_GRAD_TOL:
        raise AssertionError(f"phase 15a: kernel path against plain path: losses "
                             f"{loss_err}, gradients {grad_err}")
    return {"losses": {"kernels": k["losses"], "plain": p["losses"]}, "loss_err": loss_err,
            "grad_err": grad_err, "key_bias_max_grad": key_bias_max,
            "step_ms": {"kernels": k["ms"], "plain": p["ms"]},
            "median_step_ms": {"kernels": k["step_ms"], "plain": p["step_ms"]},
            "peak_bytes": {"kernels": k["peak_bytes"], "plain": p["peak_bytes"]},
            "launches_per_step": k["counts"][0]}


def train_kernel_times(torch) -> dict:
    """The two kernels a ViT-B/16 float32 train step launches, over one
    step's forward's worth of calls at its shapes in float32 (TF32 off):
    the kernel, its plain version and one library call (``F.layer_norm``
    after the add; ``scaled_dot_product_attention``), by graph replay, and
    the bound at the f32 peak outside the tensor cores."""
    import torch.nn.functional as F

    from storm_tpu_torch.ops.flash_attention import (
        flash_attention, flash_attention_reference)
    from storm_tpu_torch.ops.fused_norm import (
        fused_add_layernorm, fused_add_layernorm_reference)

    g = torch.Generator(device="cuda").manual_seed(TRAIN_SEED)

    def randn(*shape):
        return torch.randn(*shape, device="cuda", generator=g)

    ncalls = [(randn(M, DIM), randn(M, DIM), randn(DIM), randn(DIM)) for _ in range(DEPTH)]
    bm, by = bound_ms(4 * M * DIM * 4 + 2 * DIM * 4, 10.0 * M * DIM, PEAK_F32_FLOPS)
    out = {"residual_layernorm_sm90": {
        "ms": time_ms(torch, lambda: [fused_add_layernorm(*c) for c in ncalls]),
        "plain_ms": time_ms(torch, lambda: [fused_add_layernorm_reference(*c, 1e-6)
                                           for c in ncalls]),
        "library_ms": time_ms(torch, lambda: [F.layer_norm(x + r, (DIM,), w, b, 1e-6)
                                             for x, r, w, b in ncalls]),
        "bound_ms": bm * DEPTH, "bound_by": by, "calls": DEPTH}}
    acalls = [tuple(randn(B, HEADS, SEQ, HDIM) for _ in range(3)) for _ in range(DEPTH)]
    bm, by = bound_ms(4 * B * HEADS * SEQ * HDIM * 4, 4.0 * B * HEADS * SEQ * SEQ * HDIM,
                      PEAK_F32_FLOPS)
    out["flash_attention"] = {
        "ms": time_ms(torch, lambda: [flash_attention(*c) for c in acalls]),
        "plain_ms": time_ms(torch, lambda: [flash_attention_reference(*c) for c in acalls]),
        "library_ms": time_ms(torch, lambda: [F.scaled_dot_product_attention(*c)
                                             for c in acalls]),
        "bound_ms": bm * DEPTH, "bound_by": by, "calls": DEPTH}
    for name, t in out.items():
        log(f"  (a) {name} float32, one ViT-B/16 train step's forward ({t['calls']} calls): "
            f"{t['ms']:.4f} ms, plain {t['plain_ms']:.4f}, library {t['library_ms']:.4f}, "
            f"bound {t['bound_ms']:.4f} ({t['bound_by']})")
    return out


def published_float_accuracy() -> dict:
    with open(os.path.join(os.path.dirname(os.path.abspath(__file__)),
                           ACCURACY_ARTIFACT)) as fh:
        doc = json.load(fh)
    return {r["model"]: r["acc_float_device"] for r in doc["results"]}


def float_accuracy(torch, params, state, md, x: np.ndarray, y: np.ndarray) -> float:
    """Held-out accuracy of a float32 module built from numpy trees, in
    forwards of 512 rows on the card."""
    from storm_tpu_torch.models.convert import from_jax_params

    model = from_jax_params(params, md, state, dtype=torch.float32, device="cuda")
    preds = []
    with torch.no_grad():
        for i in range(0, len(x), 512):
            preds.append(model(torch.from_numpy(x[i:i + 512]).cuda()).argmax(-1).cpu().numpy())
    return float((np.concatenate(preds) == y).mean())


def digits_training(torch, card: str) -> dict:
    """(b) the four digits models to convergence from storm_tpu's own
    initial parameters, with accuracy_harness.py's settings."""
    from storm_tpu_torch.data import load_digits_nhwc, train_to_convergence
    from storm_tpu_torch.models.registry import CHECKPOINTS, load_checkpoint, model_def
    from storm_tpu_torch.ops import _build

    published = published_float_accuracy()
    out = {}
    for name, shape in DIGITS_TRAIN:
        params0, state0, meta = load_checkpoint(str(CHECKPOINTS / f"{name}_init.npz"))
        md = model_def(name, input_shape=shape)
        if meta["model"] != name or tuple(meta["input_shape"]) != shape:
            raise AssertionError(f"phase 15b: {name}_init.npz holds {meta}")
        x_tr, y_tr, x_te, y_te = load_digits_nhwc(shape, seed=0)
        _build.reset_launch_counts()
        t = time.perf_counter()
        params, state, hist = train_to_convergence(
            md, x_tr, y_tr, x_te, y_te, device="cuda", init=(params0, state0),
            **DIGITS_TRAIN_ARGS)
        wall = time.perf_counter() - t
        counts = _build.launch_counts()
        acc = float_accuracy(torch, params, state, md, x_te, y_te)
        best = max(hist, key=lambda h: h["val_acc"])
        want = published[name]
        log(f"  (b) {name}: {len(hist)} epochs in {wall:.3f} s, best epoch {best['epoch']} "
            f"(val acc {best['val_acc']:.4f}, loss {best['loss']:.4f}); held-out accuracy "
            f"of the snapshot {acc:.4f}, ACCURACY_r04.json {want:.4f} (bound "
            f"{TRAIN_ACC_BOUND}); last epoch loss {hist[-1]['loss']:.4f}; eager launches "
            f"{ {n: c for n, c in counts.items() if c} } ({card})")
        if abs(acc - best["val_acc"]) > 1e-9:
            raise AssertionError(f"phase 15b {name}: snapshot accuracy {acc} is not the best "
                                 f"epoch's {best['val_acc']}")
        if abs(acc - want) > TRAIN_ACC_BOUND:
            raise AssertionError(f"phase 15b {name}: accuracy {acc} against {want}; "
                                 f"history {hist}")
        out[name] = {"epochs": len(hist), "best_epoch": best["epoch"], "wall_s": wall,
                     "accuracy": acc, "published": want, "launches": counts,
                     "history": hist, "params": params, "state": state, "md": md,
                     "x_te": x_te, "y_te": y_te}
    return out


async def stream_trained(model_cfg, x: np.ndarray):
    """``stream_digits``' ordering-deterministic topology (one partition,
    1/1/1, max_inflight 1, a sync sink) with a dead-letter sink, the rows
    and one poison record; each batch the engine is given recorded."""
    from storm_tpu_torch.config import BatchConfig, Config, OffsetsConfig, SinkConfig
    from storm_tpu_torch.connectors import BrokerSink, BrokerSpout, MemoryBroker
    from storm_tpu_torch.infer import InferenceBolt
    from storm_tpu_torch.runtime import AsyncLocalCluster, TopologyBuilder

    batch_cfg = BatchConfig(max_batch=32, max_wait_ms=5.0, buckets=(8, 32), max_inflight=1)
    broker = MemoryBroker(default_partitions=1)
    tb = TopologyBuilder()
    tb.set_spout("kafka-spout", BrokerSpout(
        broker, "input", OffsetsConfig(policy="earliest", max_behind=None)))
    tb.set_bolt("inference-bolt", InferenceBolt(model_cfg, batch_cfg, device="cuda")) \
        .shuffle_grouping("kafka-spout")
    tb.set_bolt("kafka-bolt", BrokerSink(broker, "output", SinkConfig(mode="sync"))) \
        .shuffle_grouping("inference-bolt")
    tb.set_bolt("dlq-bolt", BrokerSink(broker, "dead-letter", SinkConfig(mode="sync"))) \
        .shuffle_grouping("inference-bolt", stream="dead_letter")
    cluster = AsyncLocalCluster()
    rt = await cluster.submit("trained", Config(), tb.build())
    engine = rt.bolt_execs["inference-bolt"][0].bolt.engine
    batches = []
    dispatch = engine.dispatch

    def recording_dispatch(parts):
        batches.append(np.concatenate([np.array(p, copy=True) for p in parts]))
        return dispatch(parts)

    engine.dispatch = recording_dispatch
    t0 = time.perf_counter()
    for i, img in enumerate(x):
        broker.produce("input", json.dumps({"instances": [img.tolist()]}), partition=0)
        if i == len(x) // 2:
            broker.produce("input", '{"instances": [[1.0, 2.0], [3.0]]}', partition=0)
    deadline = time.monotonic() + 300
    while broker.topic_size("output") + broker.topic_size("dead-letter") < len(x) + 1:
        if time.monotonic() > deadline:
            raise TimeoutError("phase 15c: records did not all come out in 300 s")
        await asyncio.sleep(0.01)
    wall = time.perf_counter() - t0
    await rt.drain(timeout_s=60)
    del engine.dispatch
    snap = rt.metrics.snapshot()
    errors = list(rt.errors)
    outs, dlq = broker.drain_topic("output"), broker.drain_topic("dead-letter")
    await cluster.shutdown()
    if errors:
        raise AssertionError(f"phase 15c: the topology reported errors: {errors[:3]}")
    return engine, batches, outs, dlq, snap, wall


def serve_trained(torch, trained: dict, card: str, tmp: str) -> dict:
    """(c) (b)'s resnet20 written with ``save_checkpoint`` and served back
    in float32: every output a row of the engine's direct forward of a
    batch it ran, each row answered once, in order, the poison
    dead-lettered, the accuracy (b)'s within one row."""
    from storm_tpu_torch.api.schema import decode_predictions
    from storm_tpu_torch.config import ModelConfig
    from storm_tpu_torch.infer.engine import clear_engines
    from storm_tpu_torch.models.registry import save_checkpoint

    r = trained["resnet20"]
    path = save_checkpoint(os.path.join(tmp, "resnet20_card_trained.npz"), r["params"],
                           r["state"], r["md"])
    cfg = ModelConfig.from_checkpoint(str(path), dtype="float32")
    x, y = r["x_te"], r["y_te"]
    clear_engines()
    engine, batches, outs, dlq, snap, wall = asyncio.run(stream_trained(cfg, x))
    counts = answers(output_index(engine, [b for b in batches if b.any()]), outs,
                     [row.tobytes() for row in x.astype(np.float32)], "phase 15c")
    if len(outs) != len(x) or counts != [1] * len(x):
        raise AssertionError(f"phase 15c: {len(outs)} outputs for {len(x)} rows, answered "
                             f"{sorted(set(counts))} times")
    if len(dlq) != 1 or snap["inference-bolt"]["dead_lettered"] != 1:
        raise AssertionError(f"phase 15c: {len(dlq)} dead letters")
    preds = np.concatenate([decode_predictions(o.value).data for o in outs])
    if not np.isfinite(preds).all() or np.abs(preds.sum(-1) - 1).max() > 1e-3:
        raise AssertionError("phase 15c: predictions are not finite distributions")
    acc = float((preds.argmax(-1) == y).mean())
    log(f"  (c) resnet20 trained on the card -> save_checkpoint -> spout -> InferenceBolt "
        f"-> sink, float32: {len(outs)} outputs in {wall:.3f} s, each a row of the engine's "
        f"direct forward of its batch, in order, 1 dead letter; accuracy at the output topic "
        f"{acc:.4f}, (b) {r['accuracy']:.4f} ({card})")
    if abs(acc - r["accuracy"]) > 1.0 / len(x) + 1e-12:
        raise AssertionError(f"phase 15c: served accuracy {acc} against (b)'s {r['accuracy']}")
    clear_engines()
    return {"outputs": len(outs), "accuracy": acc, "trained_accuracy": r["accuracy"],
            "wall_s": wall}


def training(torch, card: str) -> dict:
    import tempfile

    t = time.perf_counter()
    a = vit_train_steps(torch, card)
    a["times"] = train_kernel_times(torch)
    b = digits_training(torch, card)
    with tempfile.TemporaryDirectory() as tmp:
        c = serve_trained(torch, b, card, tmp)
    keep = ("epochs", "best_epoch", "wall_s", "accuracy", "published", "launches")
    return {"a": a, "b": {m: {k: r[k] for k in keep} for m, r in b.items()}, "c": c,
            "wall_s": time.perf_counter() - t}


def run() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device (torch.cuda.is_available() is false)",
              file=sys.stderr)
        return 2
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    try:
        from storm_tpu_torch.ops import _build
    except ImportError as e:
        print(f"chip_smoke: the storm_tpu_torch package is not beside this "
              f"script ({e})", file=sys.stderr)
        return 3
    from storm_tpu_torch.device import resolve_device

    card = nvidia_smi()
    log(f"[1] environment: {card}; torch {torch.__version__}, CUDA "
        f"{torch.version.cuda}, python {sys.version.split()[0]}")
    # The package resolves the card as every entry point does; that sets
    # its arithmetic (no TF32, f32 accumulation of bf16 GEMMs) before the
    # kernel phases compare anything.
    log(f"  numeric flags before the package resolves the card: {numeric_flags(torch)}")
    resolve_device("cuda")
    assert_numeric_flags(torch, "after storm_tpu_torch.device.resolve_device")
    t = time.perf_counter()
    libs = _build.build_all()
    log(f"[2] built {len(libs)} kernels in {time.perf_counter() - t:.1f} s")
    for k in _build.KERNELS.values():
        entry = ""
        for line in k.build_log().splitlines():
            if "Compiling entry function" in line:
                entry = line.split("'")[1] if "'" in line else line.strip()
            elif "registers" in line or "spill" in line and " 0 bytes spill" not in line:
                log(f"  ptxas {k.name} {entry}: {line.strip()}")

    log("[3] kernel parity on the card")
    rows = []
    errs = parity_cases(torch, rows)
    failed = [r for r in rows if not r["pass"]]
    if failed:
        raise AssertionError(f"kernel parity failed: {failed}")
    longseq_kernel_cases(torch, rows)
    failed = [r for r in rows if not r["pass"]]
    if failed:
        raise AssertionError(f"kernel parity failed: {failed}")
    times = time_kernels(torch)
    mixer = mixer_times(torch)
    longseq = longseq_times(torch)

    log("[4] forward parity, ViT-B/16 int8_fused")
    forward_parity(torch)

    log("[5] main path: 2x spout -> 4x InferenceBolt -> 2x sink, ViT-B/16 bf16 int8_fused")
    served = main_path(torch)

    log("[6] trained checkpoints: lenet5, lenet5_rgb, resnet20, vit_tiny on the digits")
    digits = trained_checkpoints(torch, rows, card)

    log("[7] the split-phase engine: graph parity, ring integrity, timings, watchdog, "
        "cold bucket")
    split = split_phase(torch, card)
    log(json.dumps({"split_phase": split, "card": card}))

    log("[8] moe_vit_b16 path: 2x spout -> 4x InferenceBolt -> 2x sink, bf16 int8_fused")
    moe = moe_path(torch, card)
    log("[8b] mixer_s16, mobilenetv2, resnet50 at 224x224x3, bf16 int8_fused, B=8")
    families = full_width_families(torch, card)
    log(json.dumps({"served": {"vit_b16": served, "moe_vit_b16": moe},
                    "families": families, "card": card}, default=float))

    log("[9a] longseq_encoder at S = 2048, bf16 int8_fused, engine-direct at B = 8 and 32; "
        "longseq_tiny (D = 8)")
    ls_direct = longseq_engine_direct(torch, card)
    log("[9b] longseq_encoder served: 2x spout -> 4x InferenceBolt -> 2x sink, QoS lanes, "
        "continuous batching, shedding")
    ls_served = longseq_served(torch, card)
    log(json.dumps({"longseq": {"engine_direct": ls_direct, "served": ls_served},
                    "card": card}, default=float))

    log("[10] observe and swap: the traced main path, the overhead turns, the shed turn "
        "with the flight recorder, the canary swap and rollback")
    observed = observe_and_swap(torch, card)
    log(json.dumps({"observe_and_swap": observed, "card": card}, default=float))

    log("[11] the binary record plane: Arrow tensor records, chunked spouts, record "
        "frames and frame egress, ViT-B/16 and longseq_encoder")
    plane = record_plane(torch, card, served)
    log(json.dumps({"record_plane": plane, "card": card}, default=float))

    log("[12] the cascade at its published operating point (float32, bf16 int8_fused), the "
        "degrade cascade, and the Observatory on the main path")
    phase12 = cascade_and_observatory(torch, card, served)
    log(json.dumps({"cascade_and_observatory": phase12, "card": card}, default=float))

    log("[13] the Storm runtime's core and exactly-once delivery, ViT-B/16 bf16 int8_fused: "
        "rebalance under traffic, supervision, the transactional sink")
    phase13 = runtime_and_exactly_once(torch, card)
    log(json.dumps({"runtime_and_exactly_once": phase13, "card": card}, default=float))

    log("[14] the decode tier (char_tiny, engine-direct and served on the ring grouping, "
        "eviction, a rolling restart) and DRPC into ViT-B/16 bf16 int8_fused")
    phase14 = decode_and_drpc(torch, card)
    log(json.dumps({"decode_and_drpc": phase14, "card": card}, default=float))

    log("[15] training on the card: ViT-B/16 float32 steps (kernels against plain), the "
        "digits models to convergence, a card-trained resnet20 served back")
    phase15 = training(torch, card)
    log(json.dumps({"training": phase15, "card": card}, default=float))

    log("[16] the kernels")

    replaces = {
        "w8a16_matmul_sm90": ("storm_tpu_torch/csrc/w8a16_matmul_sm90.cu",
                              "storm_tpu/ops/quant_matmul.py:42", "tensor cores, bf16"),
        "w8a16_matmul": ("storm_tpu_torch/csrc/w8a16_matmul.cu",
                         "storm_tpu/ops/quant_matmul.py:42", "f32 FMAs, f32 inputs"),
        "residual_layernorm_sm90": ("storm_tpu_torch/csrc/fused_norm_sm90.cu",
                                    "storm_tpu/ops/fused_norm.py:40",
                                    "register-resident rows, 16-byte loads"),
        "residual_layernorm": ("storm_tpu_torch/csrc/fused_norm.cu",
                               "storm_tpu/ops/fused_norm.py:40",
                               "one block per row, first version"),
        "flash_attention_sm90": ("storm_tpu_torch/csrc/flash_attention_sm90.cu",
                                 "storm_tpu/ops/flash_attention.py:40", "tensor cores, bf16"),
        "flash_attention": ("storm_tpu_torch/csrc/flash_attention.cu",
                            "storm_tpu/ops/flash_attention.py:40", "f32 FMAs, f32 inputs")}
    kernels = []
    for name, (src, tpu, variant) in replaces.items():
        t = times[name]
        paths = {"vit_b16 int8_fused (main path)": served["launches"][name],
                 "moe_vit_b16 int8_fused (phase 8)": moe["launches"][name]}
        paths.update({f"{p} int8_fused (phase 8b)": f["launches"][name]
                      for p, f in families.items()})
        paths.update({p: c[name] for p, c in digits["launches"].items()})
        paths.update({
            "longseq_encoder int8_fused B=8 and 32 (phase 9a)": ls_direct["launches"][name],
            "longseq_tiny int8_fused (phase 9a)": ls_direct["tiny_launches"][name],
            "longseq_encoder served, QoS + continuous (phase 9b)":
                ls_served["launches"][name],
            "vit_b16 int8_fused traced (phase 10a)": observed["traced"]["launches"][name]})
        paths.update({f"{m} int8_fused swap, continuous={c} (phase 10d)":
                      sw["tally"][m].get(name, 0)
                      for c, sw in observed["swap"].items() for m in sw["tally"]})
        paths.update({f"vit_b16 int8_fused record plane ({t}) (phase 11)":
                      plane["launches"][t][name] for t in ("a", "b", "c")})
        paths.update({f"longseq_encoder int8_fused record plane ({t}) (phase 11)":
                      plane["launches"][t][name] for t in ("d", "d2")})
        paths.update({
            "digits cascade float32 (phase 12a)": phase12["a"]["launches"][name],
            "digits cascade int8_fused (phase 12b)": phase12["b"]["launches"][name],
            "degrade cascade int8_fused (phase 12c)": phase12["c"]["launches"][name],
            "vit_b16 int8_fused observed (phase 12d)": phase12["d"]["launches"][name],
            "vit_b16 int8_fused rebalance 4 -> 8 -> 2 (phase 13a)": phase13["a_launches"][name],
            "vit_b16 int8_fused supervision (phase 13b)": phase13["b_launches"][name],
            "vit_b16 int8_fused exactly-once, no fault (phase 13c)":
                phase13["c0_launches"][name],
            "vit_b16 int8_fused at-least-once twin, no fault (phase 13c)":
                phase13["c_plain_launches"][name],
            "vit_b16 int8_fused exactly-once, faults (phase 13c)": phase13["c_launches"][name],
            "vit_b16 int8_fused DRPC (phase 14e)": phase14["e_launches"][name],
            "vit_b16 float32 train step (phase 15a)":
                phase15["a"]["launches_per_step"][name]})
        paths.update({f"{m} train to convergence, float32 (phase 15b)": r["launches"][name]
                      for m, r in phase15["b"].items()})
        entry = {
            "name": name, "route": "cuda", "source": src, "replaces": tpu,
            "variant": variant, "parity": "pass", "launches": served["launches"][name],
            "launches_by_path": paths, "max_abs_err": errs[name],
            "ms": t["ms"], "plain_ms": t["plain_ms"], "bound_ms": t["bound_ms"],
            "bound_by": t["bound_by"], "library_ms": t["library_ms"]}
        if name in digits["times"]:
            entry["digits"] = digits["times"][name]
        if name in mixer:
            entry["mixer_s16"] = mixer[name]
        if name in longseq:
            entry["longseq_encoder"] = longseq[name]
        if name in phase15["a"]["times"]:
            entry["vit_b16_train_float32"] = phase15["a"]["times"][name]
        kernels.append(entry)
    log(json.dumps({"kernels": kernels}))
    log(card)
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    try:
        code = run()
    except Exception:
        traceback.print_exc()
        code = 1
    sys.exit(code)
