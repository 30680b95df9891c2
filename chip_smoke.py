#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (storm_tpu_torch) end to end on one CUDA card.

    python3 chip_smoke.py          # from the root of a checkout

Phases, each raising on failure (the script then exits non-zero and prints
no result):

1. environment: the card's name and power limit, torch and CUDA versions;
2. build: every hand-written kernel from ``storm_tpu_torch/csrc`` (one
   ``nvcc`` per source, in parallel);
3. kernel parity: each kernel against its plain PyTorch version on the
   card, at the cases and tolerances of ``storm_tpu/ops/parity_checks.py``,
   at the same ragged shapes in bf16, and at the ViT-B/16 shapes (batch 8);
   every kernel has two variants, its first version and its redesign for
   Hopper (``*_sm90``: w8a16 and flash attention on tensor cores for
   bfloat16, the first versions serving float32; the fused norm for both
   dtypes, its first version launched only by name), and every case checks
   which one it launched. Then each kernel variant, its plain version and
   a one-call PyTorch yardstick are timed with CUDA events over one
   forward's worth of calls at the ViT-B/16 shapes;
4. forward parity: ViT-B/16 ``int8_fused`` with seeded weights, kernel path
   against plain path, in float32 (TF32 off) and bfloat16: logits within a
   relative bound, argmax identical (in bfloat16 on every row whose top-2
   margin exceeds ``ARGMAX_ULPS`` ulps);
5. main path: MemoryBroker -> 2x BrokerSpout -> 4x InferenceBolt -> 2x
   BrokerSink (+ dead-letter sink) serving ViT-B/16 bf16 ``int8_fused``:
   16 records and 1 poison record; the kernels' launch counters, zeroed
   just before, must show every batch went through the three ``*_sm90``
   kernels and the first versions launched 0 times;
6. trained checkpoints: the four digits checkpoints exported to
   ``checkpoints_torch/`` (lenet5, its 3-channel twin, resnet20, vit_tiny)
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
   launches per forward counted;
7. the ``{"kernels": [...]}`` line, then the card line, then the last line
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
    # relaxed: the flash wrapper sets its kernel's shared-memory attribute
    # on every launch, a call the default capture mode refuses.
    with torch.cuda.graph(graph, capture_error_mode="relaxed"):
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
    for rows_n, d in [(6, 64), (300, 100), (40, 512), (1024, 768)]:
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
            ("2100x100@100x4100_bigtile", (2100, 100), 100, 4100)]:
        for dt in (f32, bf16):
            x = randn(*xshape, dtype=dt)
            q, s = quantized(k, n)
            want = w8a16_matmul_reference(x.float(), q, s)
            variant = "w8a16_matmul_sm90" if dt == bf16 else "w8a16_matmul"
            got = launched(lambda: w8a16_matmul(x, q, s), variant)
            check(rows, variant, case + ("_bf16" if dt == bf16 else ""),
                  rel_err(got, want), 2e-2 if dt == bf16 else 1e-5, "rel")

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


# ---- phase 4: forward parity --------------------------------------------------


def forward_parity(torch) -> dict:
    """Kernel path against plain path on one batch of 8, the logits held
    to a relative bound, and the argmax held to agree. In float32 it must
    agree on every row. In bfloat16 it must agree on every row whose top-2
    margin on the plain path exceeds ARGMAX_ULPS bf16 ulps of the batch's
    largest |logit|: with seeded random weights the top two of 1000 logits
    can lie within one ulp, where the two paths' bf16 rounding alone may
    flip them, but a row above the threshold flips only if a kernel moves
    its logits by ARGMAX_ULPS / 2 ulps or more, a fault well inside the
    relative bound. At least one row must be above the threshold."""
    from storm_tpu_torch.models import build_model

    x_np = np.random.RandomState(7).rand(B, 224, 224, 3).astype(np.float32)
    fwd_ms = {}
    for dtype, tol in [(torch.float32, 1e-4), (torch.bfloat16, 5e-2)]:
        model = build_model("vit_b16", device="cuda", weights="int8_fused",
                            dtype=dtype, seed=0)
        x = torch.from_numpy(x_np).to(dtype).cuda()
        with torch.inference_mode():
            got = model(x).float()
            with plain_kernels():
                want = model(x).float()
            if dtype == torch.bfloat16:
                fwd_ms["kernels"] = eager_ms(torch, lambda: model(x))
                with plain_kernels():
                    fwd_ms["plain"] = eager_ms(torch, lambda: model(x))
        torch.cuda.synchronize()
        err = rel_err(got, want)
        name = str(dtype).replace("torch.", "")
        agree = got.argmax(-1) == want.argmax(-1)
        top2 = want.topk(2, dim=-1).values
        margin = top2[:, 0] - top2[:, 1]
        if dtype == torch.float32:
            gated = torch.ones_like(agree)
        else:
            peak = want.abs().max().item()
            ulp = torch.finfo(torch.bfloat16).eps * 2.0 ** math.floor(math.log2(peak))
            gated = margin > ARGMAX_ULPS * ulp
            log(f"  bf16 argmax gate: top-2 margin > {ARGMAX_ULPS} ulps = "
                f"{ARGMAX_ULPS * ulp:.4f} (max |logit| {peak:.4f})")
        log(f"  forward vit_b16 int8_fused {name} B={B}: max|dlogit|/max|logit| "
            f"{err:.3e} (tol {tol:.0e}); argmax identical on "
            f"{int((agree & gated).sum())}/{int(gated.sum())} gated rows "
            f"({int(agree.sum())}/{B} of all rows)")
        for i in torch.nonzero(~agree).flatten().tolist():
            log(f"    row {i}{' (gated)' if gated[i] else ''}: plain path's top-2 "
                f"margin {margin[i].item():.4f}, max |dlogit| in the row "
                f"{(got[i] - want[i]).abs().max().item():.4f}")
        if not (err <= tol and bool(torch.isfinite(got).all())):
            raise AssertionError(f"forward parity {name}: {err} > {tol}")
        if not bool(gated.any()):
            raise AssertionError(f"forward parity {name}: no row above the argmax gate")
        if not bool(agree[gated].all()):
            raise AssertionError(f"forward parity {name}: argmax differs on a gated row")
        del model
    log(f"  forward vit_b16 int8_fused bfloat16 B={B}, eager, host overhead included: "
        f"kernel path {fwd_ms['kernels']:.3f} ms, plain path {fwd_ms['plain']:.3f} ms")
    return fwd_ms


# ---- phase 5: the main path ---------------------------------------------------


async def serve(n_good: int = 16):
    from storm_tpu_torch.config import BatchConfig, Config, ModelConfig, OffsetsConfig
    from storm_tpu_torch.connectors import BrokerSink, BrokerSpout, MemoryBroker
    from storm_tpu_torch.infer import InferenceBolt
    from storm_tpu_torch.runtime import AsyncLocalCluster, TopologyBuilder

    cfg = Config()
    model_cfg = ModelConfig(name="vit_b16", dtype="bfloat16", weights="int8_fused",
                            num_classes=CLASSES, input_shape=(224, 224, 3))
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
    t0 = time.perf_counter()
    for i, p in enumerate(payloads):
        broker.produce("input", p)
        if i == n_good // 2:
            broker.produce("input", '{"instances": [[1.0, 2.0], [3.0]]}')  # ragged
    deadline = time.monotonic() + 300
    while broker.topic_size("output") + broker.topic_size("dead-letter") < n_good + 1:
        if time.monotonic() > deadline:
            raise TimeoutError("main path: records did not all come out in 300 s")
        await asyncio.sleep(0.01)
    wall = time.perf_counter() - t0
    await rt.drain(timeout_s=60)
    snap = rt.metrics.snapshot()
    errors = list(rt.errors)
    outs, dlq = broker.drain_topic("output"), broker.drain_topic("dead-letter")
    await cluster.shutdown()
    return inputs, outs, dlq, snap, errors, wall, model_cfg, batch_cfg


def main_path(torch) -> dict:
    from storm_tpu_torch.api.schema import decode_predictions
    from storm_tpu_torch.infer.engine import shared_engine
    from storm_tpu_torch.ops import _build

    _build.reset_launch_counts()
    inputs, outs, dlq, snap, errors, wall, model_cfg, batch_cfg = asyncio.run(serve())
    launches = _build.launch_counts()
    engine = shared_engine(model_cfg, batch_cfg, device="cuda")
    batches = engine.forwards
    if errors:
        raise AssertionError(f"main path reported errors: {errors[:3]}")
    if len(outs) != len(inputs) or len(dlq) != 1:
        raise AssertionError(f"main path: {len(outs)} predictions, {len(dlq)} dead letters")
    dl = json.loads(dlq[0].value)
    if dl["stage"] != "decode" or snap["inference-bolt"]["dead_lettered"] != 1:
        raise AssertionError(f"dead letter wrong: {dl}")
    preds = np.concatenate([decode_predictions(r.value).data for r in outs])
    if preds.shape != (len(inputs), CLASSES) or not np.isfinite(preds).all():
        raise AssertionError(f"predictions shape {preds.shape} or non-finite")
    sums = preds.sum(axis=1)
    if np.abs(sums - 1).max() > 1e-3:
        raise AssertionError(f"probabilities sum to {sums.min()}..{sums.max()}")
    # The streamed outputs against the same engine's direct forward of
    # the same inputs, in batches of the same padded shape: routing,
    # batching, splitting and encoding must not alter a prediction
    # beyond the wire's 7-decimal rounding.
    direct = np.concatenate([engine.predict(inputs[i: i + B])
                             for i in range(0, len(inputs), B)])
    match = np.abs(preds[:, None, :] - direct[None, :, :]).max(axis=2).min(axis=1)
    if match.max() > 1e-4:
        raise AssertionError(f"a streamed prediction matches no direct one: {match.max()}")
    # Every forward in bf16 goes through the sm90 variants; the first
    # versions must not launch at all while the topology serves.
    per_forward = {"w8a16_matmul_sm90": 73, "residual_layernorm_sm90": 12,
                   "flash_attention_sm90": 12, "w8a16_matmul": 0, "residual_layernorm": 0,
                   "flash_attention": 0}
    for name, n in per_forward.items():
        if (n == 0 and launches[name] != 0) or (
                n and (launches[name] < batches * n or launches[name] == 0)):
            raise AssertionError(
                f"{name}: {launches[name]} launches for {batches} forwards "
                f"(need {'0' if n == 0 else f'>= {batches * n}'})")
    e2e = snap["kafka-bolt"]["e2e_latency_ms"]
    log(f"  main path: {len(outs)} predictions + {len(dlq)} dead letter, "
        f"{batches} forwards (warmup included), launches {launches}")
    log(f"  main path on {nvidia_smi()}: e2e p50 {e2e['p50']:.3f} ms, p99 "
        f"{e2e['p99']:.3f} ms, {len(inputs) / wall:.3f} records/s over {wall:.3f} s; batch sizes "
        f"{snap['inference-bolt']['batch_size']['mean']:.2f} mean; weights on card "
        f"{engine.param_bytes() / 1e6:.3f} MB")
    return {"launches": launches, "batches": batches, "e2e_p50_ms": e2e["p50"],
            "records_per_s": len(inputs) / wall}


# ---- phase 6: trained checkpoints ------------------------------------------------

# The exported checkpoints; each records its model, input shape and class
# count (ModelConfig.from_checkpoint).
DIGITS = ("lenet5_digits", "lenet5_rgb_digits", "resnet20_digits", "vit_tiny_digits")
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
    from storm_tpu_torch.infer.engine import shared_engine
    from storm_tpu_torch.ops import _build

    launches = {}
    for tag, mode, per_forward in STREAMS:
        d = direct[(tag, mode)]
        model_cfg = digits_config(tag, mode)
        _build.reset_launch_counts()
        outs, batch_cfg, wall = asyncio.run(stream_digits(model_cfg, d["x"]))
        counts = _build.launch_counts()
        forwards = shared_engine(model_cfg, batch_cfg, device="cuda").forwards
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
            f"output topic {acc:.4f} (JAX {want_acc:.4f}); launches {counts}")
        if row_match < MIN_ROW_MATCH or argmax_agree < MIN_ARGMAX_AGREE:
            raise AssertionError(f"stream {tag} {mode}: transport proof failed")
        if abs(acc - want_acc) > EPSILON[mode]:
            raise AssertionError(f"stream {tag} {mode}: accuracy {acc} vs JAX {want_acc}")
        for name, got in counts.items():
            want = per_forward.get(name, 0) * forwards
            if got != want:
                raise AssertionError(f"stream {tag} {mode}: {name} launched {got} times "
                                     f"for {forwards} forwards (want {want})")
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
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    card = nvidia_smi()

    log(f"[1] environment: {card}; torch {torch.__version__}, CUDA "
        f"{torch.version.cuda}, python {sys.version.split()[0]}")
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
    times = time_kernels(torch)

    log("[4] forward parity, ViT-B/16 int8_fused")
    forward_parity(torch)

    log("[5] main path: 2x spout -> 4x InferenceBolt -> 2x sink, ViT-B/16 bf16 int8_fused")
    served = main_path(torch)

    log("[6] trained checkpoints: lenet5, lenet5_rgb, resnet20, vit_tiny on the digits")
    digits = trained_checkpoints(torch, rows, card)

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
        paths = {"vit_b16 int8_fused (main path)": served["launches"][name]}
        paths.update({p: c[name] for p, c in digits["launches"].items()})
        entry = {
            "name": name, "route": "cuda", "source": src, "replaces": tpu,
            "variant": variant, "parity": "pass", "launches": served["launches"][name],
            "launches_by_path": paths, "max_abs_err": errs[name],
            "ms": t["ms"], "plain_ms": t["plain_ms"], "bound_ms": t["bound_ms"],
            "bound_by": t["bound_by"], "library_ms": t["library_ms"]}
        if name in digits["times"]:
            entry["digits"] = digits["times"][name]
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
