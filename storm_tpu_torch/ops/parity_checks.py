"""Kernel parity checks: every CUDA kernel against its plain PyTorch
version, the twin of ``storm_tpu/ops/parity_checks.py``.

storm_tpu's module proves its Pallas kernels compiled for the TPU against
their jnp references. Here each hand-written kernel runs on the card and
is held against an f32 reference: its plain version on the same card, on
the same (dtype-rounded) inputs upcast to float32, with TF32 off (the
package's numeric flags, ``device.set_numeric_flags``). On the CPU the
wrappers take their plain versions, so the same rows check the plain
versions against themselves and the reference arithmetic.

Consumers, which so never check different things:

- ``cuda_kernel_parity.py`` (repository root): writes the JSON artifact;
- ``chip_smoke.py`` phase 3: :func:`run_all`, :func:`parity_cases` and
  :func:`longseq_kernel_cases`, then its own timings;
- ``tests/test_torch_parity_checks.py``: the case table against
  storm_tpu's on the CPU.

:func:`run_all` has storm_tpu's cases, shapes, dtypes, tolerance kinds
and bounds (``storm_tpu/ops/parity_checks.py:68-73``, ``:112``,
``:144-150``) and its row fields (``_row``). Divergences: the inputs come
from ``np.random.RandomState`` seeds, since ``jax.random`` is not
available (storm_tpu's fused norm and w8a16 cases already draw from
``RandomState(0)``, and do so here alike; its flash cases draw
``jax.random.PRNGKey(i)``, here ``RandomState(i)``). storm_tpu certifies
each float32 flash and w8a16 case twice, ``@highest`` (1e-5) and
``@default`` (the TPU's bf16 multiply, 5e-3); the kernels here multiply in
f32, so both rows hold the one output, each to its bound. On the card each
case also checks which kernel variant it launched; on the CPU, that it
launched none.

:func:`parity_cases` and :func:`longseq_kernel_cases` are the cases beyond
storm_tpu's that the served paths need: the same ragged shapes in bf16,
the ViT-B/16, Mixer, longseq and sharded-rank shapes, each kernel's first
version by name, and the head dims the kernels are not built for.

:func:`plain_kernels` routes the three wrappers to their plain versions,
CUDA tensors included: the reference side of a kernels-against-plain
comparison (``chip_smoke.py``, ``bench_device_torch.py --ab``). Nothing on
the serving path calls it.
"""

from __future__ import annotations

import contextlib
import math
from typing import Callable, Dict, List, Optional
from unittest import mock

import numpy as np
import torch

from storm_tpu_torch.device import resolve_device
from storm_tpu_torch.models.convert import quantize_params
from storm_tpu_torch.ops import _build
from storm_tpu_torch.ops.flash_attention import flash_attention, flash_attention_reference
from storm_tpu_torch.ops.fused_norm import (
    NORM_PLANS, fused_add_layernorm, fused_add_layernorm_reference, norm_plan)
from storm_tpu_torch.ops.quant_matmul import w8a16_matmul, w8a16_matmul_reference

# storm_tpu's cases: (case, shape, dtype). Flash: (B, H, S, D); w8a16:
# (x shape, K, N).
FLASH_CASES = [
    ("S2048", (1, 2, 2048, 64), "float32"),
    ("S2048_bf16", (1, 2, 2048, 64), "bfloat16"),
    ("S4096_multiblock", (1, 1, 4096, 128), "float32"),
    ("S600_padded", (1, 1, 600, 64), "float32"),
]
NORM_CASES = [(6, 64), (300, 100), (1024, 768)]
W8A16_CASES = [
    ("4x64@64x128", (4, 64), 64, 128, "float32"),
    ("5x100@100x70_padded", (5, 100), 100, 70, "float32"),
    ("2x9x48@48x200_tokens", (2, 9, 48), 48, 200, "float32"),
    ("1x700@700x10_multichunk", (1, 700), 700, 10, "float32"),
    ("64x768@768x3072_bf16", (64, 768), 768, 3072, "bfloat16"),
]
# Bounds: (rel @highest, rel @default f32, rel @default bf16) and the norm's
# absolute (y, ln).
FLASH_TOL = (1e-5, 5e-3, 1e-2)
W8A16_TOL = (1e-5, 5e-3, 2e-2)
NORM_TOL = (1e-5, 1e-4)
EPS = 1e-6

DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}

# The served shapes of parity_cases: ViT-B/16 at batch 8, Mixer-S/16 at
# 224x224 (196 tokens of width 512), longseq_encoder (S = 2048 of 64
# features, width 256, 2 heads of 128, MLP 1024, 10 classes).
B = 8
SEQ, DIM, HEADS, HDIM, MLP, CLASSES = 197, 768, 12, 64, 3072, 1000
M = B * SEQ
MIXER_TOKENS, MIXER_DIM = 196, 512
LS_SEQ, LS_FEAT, LS_DIM, LS_HEADS, LS_MLP, LS_CLASSES = 2048, 64, 256, 2, 1024, 10


def _row(kernel: str, case: str, dtype: str, got: torch.Tensor, want: torch.Tensor,
         rel_tol: Optional[float] = None, abs_tol: Optional[float] = None) -> dict:
    """storm_tpu's error row: relative to the reference's largest magnitude
    (``rel_tol``) or absolute (``abs_tol``), measured in float32."""
    d = (got.float() - want.float()).abs().max().item()
    scale = want.float().abs().max().item()
    rel = d / scale if scale else d
    if rel_tol is not None:
        ok, tol, metric = rel <= rel_tol, rel_tol, "rel"
    else:
        ok, tol, metric = d <= abs_tol, abs_tol, "abs"
    return {"kernel": kernel, "case": case, "dtype": dtype,
            "max_abs_err": round(d, 8), "max_rel_err": round(rel, 8),
            "metric": metric, "tol": tol, "pass": bool(ok)}


def _launched(fn: Callable, variant: str, device: torch.device):
    """``fn()``, holding that it launched ``variant`` once and nothing else
    (on the CPU: that it launched nothing, the plain version)."""
    before = _build.launch_counts()
    out = fn()
    diff = {k: v - before[k] for k, v in _build.launch_counts().items() if v != before[k]}
    want = {variant: 1} if device.type == "cuda" else {}
    if diff != want:
        raise AssertionError(f"expected launches {want}, got {diff}")
    return out


def _tensor(a: np.ndarray, dtype: torch.dtype, device: torch.device) -> torch.Tensor:
    return torch.from_numpy(np.ascontiguousarray(a, np.float32)).to(device).to(dtype)


def flash_inputs(shape: tuple, seed: int) -> np.ndarray:
    """One of a flash case's q, k, v (seeds 0, 1, 2): float32 normals."""
    return np.random.RandomState(seed).standard_normal(shape).astype(np.float32)


def check_flash_attention(device=None) -> List[dict]:
    """Flash attention against its plain version in f32: the long-context
    shape (S = 2048), the same in bf16 (the serving dtype), S = 4096 at
    D = 128, and a ragged S = 600. bf16's bound is one output rounding
    step; the kernels carry f32 throughout."""
    dev = resolve_device(device)
    rows = []
    for case, shape, dt in FLASH_CASES:
        q, k, v = (_tensor(flash_inputs(shape, i), DTYPES[dt], dev) for i in range(3))
        want = flash_attention_reference(q.float(), k.float(), v.float())
        variant = "flash_attention_sm90" if dt == "bfloat16" else "flash_attention"
        got = _launched(lambda: flash_attention(q, k, v), variant, dev)
        if dt == "float32":
            rows.append(_row("flash_attention", f"{case}@highest", dt, got, want,
                             rel_tol=FLASH_TOL[0]))
        rows.append(_row("flash_attention", f"{case}@default", dt, got, want,
                         rel_tol=FLASH_TOL[2] if dt == "bfloat16" else FLASH_TOL[1]))
    return rows


def norm_inputs() -> List[tuple]:
    """storm_tpu's fused-norm inputs in its order: for each case, x, r
    (rows, d), g, b (d,) from one ``RandomState(0)``."""
    rng = np.random.RandomState(0)
    out = []
    for rows_n, d in NORM_CASES:
        out.append(tuple(rng.randn(*s).astype(np.float32)
                         for s in ((rows_n, d), (rows_n, d), (d,), (d,))))
    return out


def check_fused_norm(device=None) -> List[dict]:
    """The fused residual add + LayerNorm against its plain version: lane
    padding (d = 100), many rows, and the ViT width; both outputs."""
    dev = resolve_device(device)
    rows = []
    for (rows_n, d), arrays in zip(NORM_CASES, norm_inputs()):
        x, r, g, b = (_tensor(a, torch.float32, dev) for a in arrays)
        wy, wo = fused_add_layernorm_reference(x, r, g, b, EPS)
        gy, go = _launched(lambda: fused_add_layernorm(x, r, g, b, EPS),
                           "residual_layernorm_sm90", dev)
        rows.append(_row("fused_norm.y", f"{rows_n}x{d}", "float32", gy, wy,
                         abs_tol=NORM_TOL[0]))
        rows.append(_row("fused_norm.ln", f"{rows_n}x{d}", "float32", go, wo,
                         abs_tol=NORM_TOL[1]))
    return rows


def w8a16_inputs() -> List[tuple]:
    """storm_tpu's w8a16 inputs in its order: for each case, x and the
    quantized w (``quantize_params``, bit-identical to storm_tpu's) from
    one ``RandomState(0)``: ``(x, q, s)`` as numpy."""
    rng = np.random.RandomState(0)
    out = []
    for _case, xshape, k, n, _dt in W8A16_CASES:
        x = rng.randn(*xshape).astype(np.float32)
        w = rng.randn(k, n).astype(np.float32)
        qw = quantize_params({"w": w})["w"]
        out.append((x, qw["__q"], qw["__s"]))
    return out


def check_w8a16(device=None) -> List[dict]:
    """The w8a16 kernels against the plain version (f32 product of the
    int8 weights, scale on the accumulator): ragged M, N and K, K in
    several tiles, 3-D tokens, and bf16 at ViT's MLP shape."""
    dev = resolve_device(device)
    rows = []
    for (case, _xs, _k, _n, dt), (xa, qa, sa) in zip(W8A16_CASES, w8a16_inputs()):
        x = _tensor(xa, DTYPES[dt], dev)
        q = torch.from_numpy(qa).to(dev)
        s = torch.from_numpy(sa).to(dev)
        want = w8a16_matmul_reference(x.float(), q, s)
        variant = "w8a16_matmul_sm90" if dt == "bfloat16" else "w8a16_matmul"
        got = _launched(lambda: w8a16_matmul(x, q, s), variant, dev)
        if dt == "float32":
            rows.append(_row("w8a16_matmul", f"{case}@highest", dt, got, want,
                             rel_tol=W8A16_TOL[0]))
        rows.append(_row("w8a16_matmul", f"{case}@default", dt, got, want,
                         rel_tol=W8A16_TOL[2] if dt == "bfloat16" else W8A16_TOL[1]))
    return rows


def run_all(device=None) -> List[dict]:
    """storm_tpu's ``run_all``: every kernel's rows, on ``device``
    (default ``cuda``, raising without a card; ``"cpu"`` runs the plain
    versions)."""
    dev = resolve_device(device)
    rows = check_flash_attention(dev) + check_fused_norm(dev) + check_w8a16(dev)
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
    return rows


# ---- beyond storm_tpu's cases --------------------------------------------------------


def _check(rows: list, kernel: str, case: str, dtype: torch.dtype, got, want,
           tol: float, metric: str) -> None:
    rows.append(_row(kernel, case, str(dtype).replace("torch.", ""), got, want,
                     **({"rel_tol": tol} if metric == "rel" else {"abs_tol": tol})))


def _abs_err(got, want) -> float:
    return (got.float() - want.float()).abs().max().item()


def parity_cases(rows: list, device=None) -> Dict[str, float]:
    """The served paths' cases, appended to ``rows``: storm_tpu's ragged
    shapes in bf16, the shapes of phase 18's ranks and phase 20's training
    steps, Mixer's token MLP (a transposed view), then the ViT-B/16 shapes
    (bf16, batch 8) on each kernel's two variants. Every case checks which
    variant it launched: w8a16 and flash f32 cases the f32 kernels, bf16
    cases the tensor-core (sm90) kernels; every fused norm case the sm90
    kernel. Returns max |kernel - plain| per kernel variant at the
    ViT-B/16 shapes."""
    dev = resolve_device(device)
    g = torch.Generator(device=dev).manual_seed(0)
    f32, bf16 = torch.float32, torch.bfloat16

    def randn(*shape, dtype=f32):
        return torch.randn(*shape, device=dev, generator=g).to(dtype)

    def quantized(k, n):
        w = torch.randn(k, n, device=dev, generator=g)
        s = (w.abs().amax(dim=0) / 127.0).clamp_min(1e-12)
        q = torch.clamp(torch.round(w / s), -127, 127).to(torch.int8)
        return q, s

    def launched(fn, variant):
        return _launched(fn, variant, dev)

    def check(kernel, case, dtype, got, want, tol, metric="rel"):
        _check(rows, kernel, case, dtype, got, want, tol, metric)

    # Flash attention in bf16 at storm_tpu's ragged shape and at head dims
    # 16, 32 and 128; the bound is one output rounding step.
    for case, shape in [("S600_padded_bf16", (1, 1, 600, 64)),
                        ("S197_D16_bf16", (2, 2, 197, 16)),
                        ("S100_D32_bf16", (1, 2, 100, 32)),
                        ("S4096_D128_bf16", (1, 1, 4096, 128))]:
        q, k, v = (randn(*shape, dtype=bf16) for _ in range(3))
        want = flash_attention_reference(q.float(), k.float(), v.float())
        got = launched(lambda: flash_attention(q, k, v), "flash_attention_sm90")
        check("flash_attention_sm90", case, bf16, got, want, 1e-2)
    # The fused norm in bf16 at each width with a plan of its own (64, 512,
    # 768) and a ragged one (100, element loads), an offset view (element
    # loads at 768) and bf16 g and b as the model passes them (bf16: one
    # rounding step of the output, relative).
    norm = "residual_layernorm_sm90"

    def norm_case(case, x, r, gg, bb, tol_y, tol_o, metric):
        wy, wo = fused_add_layernorm_reference(x, r, gg, bb, EPS)
        y, o = launched(lambda: fused_add_layernorm(x, r, gg, bb), norm)
        check(norm + ".y", case, x.dtype, y, wy, tol_y, metric)
        check(norm + ".ln", case, x.dtype, o, wo, tol_o, metric)

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
    # w8a16 in bf16 (the tensor-core kernel, whose element, 8-byte and
    # 16-byte load modes these shapes cover) at storm_tpu's ragged shapes,
    # and beyond them: many tiles with unaligned loads, and the mixers'
    # token MLPs (K or N the token count: element loads), in f32 and bf16.
    for case, xshape, k, n, dts in [
            ("4x64@64x128", (4, 64), 64, 128, (bf16,)),
            ("5x100@100x70_padded", (5, 100), 100, 70, (bf16,)),
            ("2x9x48@48x200_tokens", (2, 9, 48), 48, 200, (bf16,)),
            ("1x700@700x10_multichunk", (1, 700), 700, 10, (bf16,)),
            ("64x768@768x3072", (64, 768), 768, 3072, (f32,)),
            ("2100x100@100x4100_bigtile", (2100, 100), 100, 4100, (f32, bf16)),
            ("mixer_s16_token_fc1 4096x196@196x256", (B * MIXER_DIM, 196), 196, 256,
             (f32, bf16)),
            ("mixer_s16_token_fc2 4096x256@256x196", (B * MIXER_DIM, 256), 256, 196,
             (f32, bf16)),
            ("mixer_tiny_token_fc1 512x64@64x32", (8 * 64, 64), 64, 32, (f32, bf16))]:
        for dt in dts:
            x = randn(*xshape, dtype=dt)
            q, s = quantized(k, n)
            want = w8a16_matmul_reference(x.float(), q, s)
            variant = "w8a16_matmul_sm90" if dt == bf16 else "w8a16_matmul"
            got = launched(lambda: w8a16_matmul(x, q, s), variant)
            check(variant, case + ("_bf16" if dt == bf16 else ""), dt, got, want,
                  2e-2 if dt == bf16 else 1e-5)

    # Tensor parallelism's row-parallel partials (phase 18): the tensor-core
    # kernel's f32 epilogue, at ViT-B/16's o and mlp_out shards (dp2 x tp2:
    # 4 of the 8 rows, K / 2; tp4: every row, K / 4) and a ragged shape (an
    # odd N: no f32 pairs), against the plain version's f32 output. The
    # products are exact in f32 either way; only the sum's order differs.
    for case, (m, k, n) in [("vit_b16 tp2 o", (4 * SEQ, DIM // 2, DIM)),
                            ("vit_b16 tp2 mlp_out", (4 * SEQ, MLP // 2, DIM)),
                            ("vit_b16 tp4 o", (M, DIM // 4, DIM)),
                            ("vit_b16 tp4 mlp_out", (M, MLP // 4, DIM)),
                            ("ragged", (5, 100, 71))]:
        x = randn(m, k, dtype=bf16)
        q, s = quantized(k, n)
        want = w8a16_matmul_reference(x, q, s, f32)
        got = launched(lambda: w8a16_matmul(x, q, s, out_dtype=f32), "w8a16_matmul_sm90")
        if got.dtype != f32:
            raise AssertionError(f"f32 out {case}: the kernel wrote {got.dtype}")
        check("w8a16_matmul_sm90", f"f32 out {case} {m}x{k}@{k}x{n}", bf16, got, want, 1e-5)

    # Phase 18's sharded shapes on the bf16 kernels: ViT-B/16's layers at
    # the rows of one data rank (dp4: 2 records, dp2: 4; moe_vit_b16's
    # dense layers at dp2 x ep2 too), its column-parallel q, k, v and
    # mlp_in shards (N / tp), and longseq_encoder's layers at a sequence
    # rank's S / sp rows (dp2 x sp2: 4 x 1024, sp4: 8 x 512; one launch
    # shape) and its head; the fused norm with the model's bf16 g and b at
    # a data rank's rows and at all 8 records (tp, ep4). Phase 18 holds
    # every rank's launches to the signatures phase 3 checked.
    for case, xshape, k, n in [
            ("vit_b16 dp4 qkvo", (2 * SEQ, DIM), DIM, DIM),
            ("vit_b16 dp4 mlp_in", (2 * SEQ, DIM), DIM, MLP),
            ("vit_b16 dp4 mlp_out", (2 * SEQ, MLP), MLP, DIM),
            ("vit_b16 dp4 head", (2, DIM), DIM, CLASSES),
            ("vit_b16 dp2 qkvo", (4 * SEQ, DIM), DIM, DIM),
            ("vit_b16 dp2 mlp_in", (4 * SEQ, DIM), DIM, MLP),
            ("vit_b16 dp2 mlp_out", (4 * SEQ, MLP), MLP, DIM),
            ("vit_b16 dp2 head", (4, DIM), DIM, CLASSES),
            ("vit_b16 dp2xtp2 qkv", (4 * SEQ, DIM), DIM, DIM // 2),
            ("vit_b16 dp2xtp2 mlp_in", (4 * SEQ, DIM), DIM, MLP // 2),
            ("vit_b16 tp4 qkv", (M, DIM), DIM, DIM // 4),
            ("vit_b16 tp4 mlp_in", (M, DIM), DIM, MLP // 4),
            ("longseq sp embed", (4, LS_SEQ // 2, LS_FEAT), LS_FEAT, LS_DIM),
            ("longseq sp qkvo", (8, LS_SEQ // 4, LS_DIM), LS_DIM, LS_DIM),
            ("longseq sp mlp_in", (4, LS_SEQ // 2, LS_DIM), LS_DIM, LS_MLP),
            ("longseq sp mlp_out", (8, LS_SEQ // 4, LS_MLP), LS_MLP, LS_DIM),
            ("longseq dp2 head", (4, LS_DIM), LS_DIM, LS_CLASSES),
            ("longseq head", (8, LS_DIM), LS_DIM, LS_CLASSES)]:
        x = randn(*xshape, dtype=bf16)
        q, s = quantized(k, n)
        got = launched(lambda: w8a16_matmul(x, q, s), "w8a16_matmul_sm90")
        check("w8a16_matmul_sm90", f"{case} {math.prod(xshape[:-1])}x{k}@{k}x{n}", bf16,
              got, w8a16_matmul_reference(x, q, s), 2e-2)
    for case, shape in [("vit_b16 dp4", (2, HEADS, SEQ, HDIM)),
                        ("vit_b16 dp2xtp2", (4, HEADS // 2, SEQ, HDIM)),
                        ("vit_b16 tp4", (B, HEADS // 4, SEQ, HDIM)),
                        ("moe_vit_b16 dp2xep2", (4, HEADS, SEQ, HDIM))]:
        q, k, v = (randn(*shape, dtype=bf16) for _ in range(3))
        got = launched(lambda: flash_attention(q, k, v), "flash_attention_sm90")
        check("flash_attention_sm90", f"{case} {'x'.join(map(str, shape))} bf16", bf16,
              got, flash_attention_reference(q, k, v), 1e-2)
    for case, rows_n in [("vit_b16 dp4", 2 * SEQ), ("vit_b16 dp2", 4 * SEQ),
                         ("vit_b16 every row", M)]:
        norm_case(f"{case} {rows_n}x{DIM} bf16_bf16_g_b", randn(rows_n, DIM, dtype=bf16),
                  randn(rows_n, DIM, dtype=bf16), randn(DIM, dtype=bf16),
                  randn(DIM, dtype=bf16), 1e-2, 1e-2, "rel")

    # Phase 20's training shapes in float32 (the trainable leaves): the f32
    # flash kernel at a rank's (rows, heads) of 197 x 64 (dp4 and a pipeline
    # microbatch (2, 12), dp2 x tp2 (4, 6), tp4 (8, 3), the one-rank step
    # (8, 12)), and the fused norm with f32 g and b at a rank's rows (dp4 and
    # a microbatch 394, dp2 x tp2 788, tp4 and the one-rank step 1576).
    for case, shape in [("dp4 and a microbatch", (2, HEADS, SEQ, HDIM)),
                        ("dp2xtp2", (4, HEADS // 2, SEQ, HDIM)),
                        ("tp4", (B, HEADS // 4, SEQ, HDIM)),
                        ("one rank", (B, HEADS, SEQ, HDIM))]:
        q, k, v = (randn(*shape) for _ in range(3))
        got = launched(lambda: flash_attention(q, k, v), "flash_attention")
        check("flash_attention", f"vit_b16 train {case} {'x'.join(map(str, shape))} f32",
              f32, got, flash_attention_reference(q, k, v), 1e-5)
    for case, rows_n in [("dp4 and a microbatch", 2 * SEQ), ("dp2xtp2", 4 * SEQ),
                         ("tp4 and one rank", M)]:
        norm_case(f"vit_b16 train {case} {rows_n}x{DIM} f32", randn(rows_n, DIM),
                  randn(rows_n, DIM), randn(DIM), randn(DIM), 1e-5, 1e-4, "abs")

    # The mixer's token MLP reads a transposed, non-contiguous activation:
    # the wrapper copies it once, then launches.
    xt = randn(B, MIXER_TOKENS, MIXER_DIM, dtype=bf16).transpose(1, 2)
    q, s = quantized(MIXER_TOKENS, 256)
    got = launched(lambda: w8a16_matmul(xt, q, s), "w8a16_matmul_sm90")
    check("w8a16_matmul_sm90", "mixer_s16 token fc1, transposed view", bf16, got,
          w8a16_matmul_reference(xt.contiguous().float(), q, s), 2e-2)

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
            check(variant, f"vit_b16 {name} {m}x{k}@{k}x{n}", bf16, got, want, 2e-2)
            mm[variant].append(_abs_err(got, want))
    errs.update({v: max(e) for v, e in mm.items()})
    x, r, gg, bb = randn(M, DIM, dtype=bf16), randn(M, DIM, dtype=bf16), randn(DIM), randn(DIM)
    wy, wo = fused_add_layernorm_reference(x, r, gg, bb, EPS)
    for variant in ("residual_layernorm_sm90", "residual_layernorm"):
        y, o = launched(lambda: fused_add_layernorm(x, r, gg, bb, variant=variant), variant)
        check(variant + ".y", f"vit_b16 {M}x{DIM} bf16", bf16, y, wy, 1e-2)
        check(variant + ".ln", f"vit_b16 {M}x{DIM} bf16", bf16, o, wo, 1e-2)
        errs[variant] = max(_abs_err(y, wy), _abs_err(o, wo))
    q, k, v = (randn(B, HEADS, SEQ, HDIM, dtype=bf16) for _ in range(3))
    want = flash_attention_reference(q, k, v)
    for variant in ("flash_attention_sm90", "flash_attention"):
        got = launched(lambda: flash_attention(q, k, v, variant=variant), variant)
        check(variant, f"vit_b16 {B}x{HEADS}x{SEQ}x{HDIM} bf16", bf16, got, want, 1e-2)
        errs[variant] = _abs_err(got, want)
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
    return errs


def longseq_kernel_cases(rows: list, device=None) -> None:
    """The flash wrapper at head dims the kernels are not built for (D =
    8, 24, 48, 96: zero-padded to the next one, the true D's scale, sliced
    back; storm_tpu's kernel takes every D up to 128), in bf16 and f32,
    and the fused norm's d = 256 plans (longseq_encoder at B = 8), each
    against its plain version, appended to ``rows``. D > 128 must
    raise."""
    dev = resolve_device(device)
    g = torch.Generator(device=dev).manual_seed(3)
    f32, bf16 = torch.float32, torch.bfloat16

    def randn(*shape, dtype=f32):
        return torch.randn(*shape, device=dev, generator=g).to(dtype)

    for d in (8, 24, 48, 96):
        for dt in (bf16, f32):
            shape = (2, 2, 300, d)
            q, k, v = (randn(*shape, dtype=dt) for _ in range(3))
            want = flash_attention_reference(q.float(), k.float(), v.float())
            variant = "flash_attention_sm90" if dt == bf16 else "flash_attention"
            got = _launched(lambda: flash_attention(q, k, v), variant, dev)
            if got.shape != shape:
                raise AssertionError(f"flash at D = {d}: output {tuple(got.shape)}")
            _check(rows, variant, f"2x2x300x{d}_padded" + ("_bf16" if dt == bf16 else ""),
                   dt, got, want, 1e-2 if dt == bf16 else 1e-5, "rel")
    t = torch.zeros(1, 1, 8, 160, device=dev, dtype=bf16)
    try:
        flash_attention(t, t, t)
    except ValueError:
        pass
    else:
        raise AssertionError("flash attention at D = 160 must raise")
    norm = "residual_layernorm_sm90"
    m = B * LS_SEQ
    for dt, tol, metric in ((bf16, 1e-2, "rel"), (f32, 1e-4, "abs")):
        x, r = randn(m, LS_DIM, dtype=dt), randn(m, LS_DIM, dtype=dt)
        gg, bb = randn(LS_DIM, dtype=dt), randn(LS_DIM, dtype=dt)
        plan = norm_plan(LS_DIM, dt, x.data_ptr(), r.data_ptr())
        if plan[:2] != NORM_PLANS[(dt, LS_DIM)] or plan[2] != 1:
            raise AssertionError(f"d = 256 {dt}: plan {plan}")
        wy, wo = fused_add_layernorm_reference(x, r, gg, bb, EPS)
        y, o = _launched(lambda: fused_add_layernorm(x, r, gg, bb), norm, dev)
        name = f"longseq {m}x{LS_DIM} {str(dt).replace('torch.', '')} plan {plan[:2]}"
        _check(rows, norm + ".y", name, dt, y, wy, 1e-2 if dt == bf16 else 1e-5, metric)
        _check(rows, norm + ".ln", name, dt, o, wo, tol, metric)
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


@contextlib.contextmanager
def plain_kernels():
    """Route the three kernel wrappers to their plain versions (CUDA
    tensors included) at the points where the models call them, for the
    block: the reference side of a kernels-against-plain comparison."""
    from storm_tpu_torch.ops import attention, fused_norm, quant_matmul

    def norm_plain(x2, r2, g, b, eps=EPS, variant=None):
        return fused_norm.fused_add_layernorm_reference(x2, r2, g, b, eps)

    with contextlib.ExitStack() as st:
        st.enter_context(mock.patch.object(
            quant_matmul, "w8a16_matmul", quant_matmul.w8a16_matmul_reference))
        st.enter_context(mock.patch.object(fused_norm, "fused_add_layernorm", norm_plain))
        st.enter_context(mock.patch.object(
            attention, "flash_attention", flash_attention_reference))
        yield
