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
10. the ``{"kernels": [...]}`` line, then the card line, then the last line
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


async def serve(model_cfg, n_good: int = 16):
    """``model_cfg`` through MemoryBroker -> 2x BrokerSpout -> 4x
    InferenceBolt -> 2x BrokerSink (+ dead-letter sink) on the default
    engine: ``n_good`` seeded 224x224x3 records and one ragged poison
    record. The shared engine's ``dispatch`` is wrapped to keep a copy of
    every batch it is given, so each output can be held to the engine's
    direct forward of the very batch it was served in."""
    from storm_tpu_torch.config import BatchConfig, Config, OffsetsConfig
    from storm_tpu_torch.connectors import BrokerSink, BrokerSpout, MemoryBroker
    from storm_tpu_torch.infer import InferenceBolt
    from storm_tpu_torch.runtime import AsyncLocalCluster, TopologyBuilder

    cfg = Config()
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
    await cluster.shutdown()
    return {"inputs": inputs, "payloads": payloads, "outs": outs, "dlq": dlq, "snap": snap,
            "errors": errors, "wall": wall, "batch_cfg": batch_cfg, "batches": batches}


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
    what the card ran after the spin is counted."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

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
    if not spins:
        raise AssertionError("the profiler recorded no separating spin kernel")
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
    path's warm-up (the other variants 0 times); then one replay of each of
    the engine's graphs under the profiler must show the kernels its
    capture recorded (the tally's unit)."""
    tally, forwards = engine.launch_tally(), engine.forwards
    for name in KERNEL_FUNCS:
        want = per_forward.get(name, 0) * forwards
        if tally.get(name, 0) != want:
            raise AssertionError(f"{path}: {name} tallied {tally.get(name, 0)} launches for "
                                 f"{forwards} forwards (want {want})")
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


def device_busy(torch, fn) -> dict:
    """``fn()`` under ``torch.profiler``: the wall time, and the share of
    it the card was busy (the union of every device activity's interval:
    kernels, copies, sets) and busy with kernels alone. Device activity
    only: recording every host op too would slow the host it measures."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
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
    return {"wall_ms": wall_us / 1e3, "busy_share": busy / wall_us,
            "idle_share": 1 - busy / wall_us, "kernel_share": kern / wall_us}


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


async def serve_longseq(records: list, continuous: bool = True, shed=None) -> dict:
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
    metrics bind to the first topology that uses it)."""
    from storm_tpu_torch.config import Config, OffsetsConfig, QosConfig
    from storm_tpu_torch.connectors import BrokerSink, BrokerSpout, MemoryBroker
    from storm_tpu_torch.infer import InferenceBolt
    from storm_tpu_torch.infer.continuous import _reset_registry
    from storm_tpu_torch.qos import LoadShedController, ShedPolicy
    from storm_tpu_torch.runtime import AsyncLocalCluster, TopologyBuilder

    _reset_registry()
    qos = shed or QosConfig(enabled=True)
    cfg = Config()
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
        shedder = LoadShedController(rt, ShedPolicy.from_qos(
            shed, "inference-bolt", "kafka-bolt")).start()
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
    await cluster.shutdown()
    _reset_registry()
    return {"outs": outs, "dlq": dlq, "snap": snap, "errors": errors, "wall": wall,
            "batches": batches, "decisions": decisions, "dropped": dropped}


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
                ls_served["launches"][name]})
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
