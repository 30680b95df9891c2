#!/usr/bin/env python3
"""Device-resident performance bench of the port on one CUDA card: images
per second, MFU and the roofline per model, the kernels against the plain
route, the measured HBM bandwidth, and the attention sweep. The twin of
``bench_device.py``, with its modes and its row fields.

Per config: one engine (``InferenceEngine``, bucket = the config's batch),
its bucket's CUDA graph (``infer/graphs.py`` ``BucketForward``) replayed on
a batch already on the card, timed with CUDA events: a warm-up, then the
median of several windows of replays. No host transfer in the loop.

Where ``bench_device.py`` does not carry over:

- peaks: the published H100 SXM figures (989 TFLOP/s bf16, 67 TFLOP/s f32
  outside the tensor cores, 3.35 TB/s), not v5e's; MFU is against the
  peak of the config's compute dtype;
- timing: graph replay between CUDA events, not a chained ``fori_loop``;
- FLOPs and bytes: there is no XLA ``cost_analysis``, and
  ``FlopCounterMode`` does not see the hand-written kernels (they launch
  through ctypes). So one forward runs on the plain route (the three
  wrappers on their plain versions, ``ops.parity_checks.plain_kernels``)
  on the meta device at the same shapes, and :class:`CostCounter` counts
  what XLA's cost analysis counts: 2·M·N·K a matrix product, the valid
  taps of a convolution, one a pointwise op's element (casts included,
  transcendentals not), the reduced elements of a reduction. So the
  count is the same whichever implementation runs. Bytes are the
  parameters plus every op's inputs and outputs on that route: an upper
  bound of what the card must move (``hbm_gbytes_upper_bound``), so a
  row's ``bound``, ``roofline_ms`` and ``pct_of_roofline`` are those of
  the compute roofline alone; ``--measured-roofline`` reckons the bytes
  from the measured bandwidth;
- ``--ab``: the kernels against the plain route on the same engine and
  the same data, the plain route captured in a graph of its own under
  ``plain_kernels`` (no environment switch);
- ``--attn-sweep``: the flash kernel against
  ``torch.nn.functional.scaled_dot_product_attention`` (the library
  yardstick; the port never calls it) and the plain version.

    python3 bench_device_torch.py                       # every config
    python3 bench_device_torch.py --config vit_b16 --ab
    python3 bench_device_torch.py --measured-roofline --config vit_b16
    python3 bench_device_torch.py --attn-sweep
    python3 bench_device_torch.py --config vit_b16 --ab --hbm-bw --attn-sweep

One JSON value on stdout, everything else on stderr; every row carries the
card's name and power limit (``card``). Without a card it exits 2: a
device bench has no CPU mode (its FLOP count runs in the CPU tests,
``tests/test_torch_bench_device.py``).
"""

from __future__ import annotations

import argparse
import copy
import json
import os
import statistics
import sys
from collections import Counter
from typing import Callable, Dict, Optional, Sequence

import numpy as np

from storm_tpu_torch.device import (PEAK_BF16_FLOPS, PEAK_F32_FLOPS, PEAK_HBM_BYTES_PER_S,
                                    card_line)

REPO = os.path.dirname(os.path.abspath(__file__))


CONFIGS = {
    "lenet5": dict(model="lenet5", input_shape=(28, 28, 1), num_classes=10, batch=512),
    "resnet20": dict(model="resnet20", input_shape=(32, 32, 3), num_classes=10, batch=512),
    "mobilenetv2": dict(model="mobilenetv2", input_shape=(32, 32, 3), num_classes=10,
                        batch=512),
    "mixer_tiny": dict(model="mixer_tiny", input_shape=(32, 32, 3), num_classes=10,
                       batch=512),
    "resnet50": dict(model="resnet50", input_shape=(224, 224, 3), num_classes=1000,
                     batch=64),
    "vit_b16": dict(model="vit_b16", input_shape=(224, 224, 3), num_classes=1000, batch=64),
    "longseq_encoder": dict(model="longseq_encoder", input_shape=(2048, 64), num_classes=10,
                            batch=8),
}
ATTN_SEQS = (128, 256, 512, 1024, 2048, 4096)
ATTN_SHAPE = (4, 8, 64)  # b, h, d of the sweep, bf16
WINDOWS = 5  # timed windows a reading; the median is reported


def log(msg: str) -> None:
    print(msg, file=sys.stderr, flush=True)


def peak_flops(dtype: str) -> float:
    return PEAK_BF16_FLOPS if dtype == "bfloat16" else PEAK_F32_FLOPS


# ---- the plain route's cost ---------------------------------------------------------

# Ops that move no data and compute nothing (views and aliases).
_VIEWS = {"view", "_unsafe_view", "reshape", "expand", "transpose", "permute", "t", "select",
          "slice", "unsqueeze", "squeeze", "alias", "detach", "as_strided", "unbind", "split",
          "split_with_sizes", "lift_fresh"}
# Elementwise ops XLA counts as transcendentals, not flops.
_TRANSCENDENTAL = {"exp", "exp2", "expm1", "log", "log1p", "log2", "tanh", "rsqrt", "sqrt",
                   "erf", "sigmoid", "sin", "cos"}
_REDUCTIONS = {"sum", "mean", "amax", "amin", "var", "var_mean", "prod"}


def _conv_taps(x_shape, w_shape, out_shape, stride, padding, dilation) -> int:
    """Input taps a convolution reads inside the input, summed over its
    output positions (XLA's count: padding contributes nothing)."""
    taps = 1
    for d in range(2, len(x_shape)):
        size, k = x_shape[d], w_shape[d]
        s, p, dl = stride[d - 2], padding[d - 2], dilation[d - 2]
        taps *= sum(1 for o in range(out_shape[d]) for j in range(k)
                    if 0 <= o * s - p + j * dl < size)
    return taps


def op_flops(func, args: Sequence, out) -> int:
    """XLA's cost-analysis count of one aten op: 2·M·N·K a product (+ M·N
    for a bias), the valid taps of a convolution, the input's elements for
    a reduction, four an element for a softmax (max, subtract, sum,
    divide), eight for the tanh GELU, the window for max pooling, an
    integer power's multiplies, one an element for a cast and for any
    other pointwise op; none for a transcendental or a view."""
    import torch

    name = func.overloadpacket.__name__
    outs = [t for t in (out if isinstance(out, (tuple, list)) else [out])
            if isinstance(t, torch.Tensor)]
    n = outs[0].numel() if outs else 0
    if name in ("mm", "bmm"):
        a, b = args[0], args[1]
        return 2 * a.shape[:-1].numel() * a.shape[-1] * b.shape[-1]
    if name in ("addmm", "baddbmm"):
        a, b = args[1], args[2]
        return 2 * a.shape[:-1].numel() * a.shape[-1] * b.shape[-1] + n
    if name == "convolution":
        x, w, bias, stride, padding, dilation = args[:6]
        groups = args[8]
        flops = 2 * x.shape[0] * w.shape[0] * (x.shape[1] // groups) * _conv_taps(
            x.shape, w.shape, outs[0].shape, stride, padding, dilation)
        return flops + (n if bias is not None else 0)
    if name in ("_softmax", "_log_softmax"):
        return 4 * n
    if name == "gelu":
        return 8 * n
    if name == "max_pool2d_with_indices":
        return n * int(np.prod(args[1]))
    if name == "pow" and isinstance(args[1], (int, float)):
        return n * max(1, int(args[1]) - 1) if float(args[1]).is_integer() else 0
    if name in _REDUCTIONS:
        return args[0].numel()
    if name == "_to_copy":
        return n if outs and outs[0].dtype != args[0].dtype else 0
    if name in _TRANSCENDENTAL or name in _VIEWS:
        return 0
    return n if torch.Tag.pointwise in func.tags else 0


class CostCounter:
    """A dispatch mode that counts one forward's FLOPs (:func:`op_flops` of
    every aten op) and the bytes of every op's inputs and outputs (views
    excluded)."""

    def __init__(self) -> None:
        self.flops = 0
        self.op_bytes = 0
        self.ops: Counter = Counter()

    def __enter__(self):
        import torch
        from torch.utils._python_dispatch import TorchDispatchMode
        from torch.utils._pytree import tree_leaves

        counter = self

        class _Mode(TorchDispatchMode):
            def __torch_dispatch__(self, func, types, args=(), kwargs=None):
                out = func(*args, **(kwargs or {}))
                name = func.overloadpacket.__name__
                f = op_flops(func, args, out)
                counter.flops += f
                counter.ops[name] += f
                if name not in _VIEWS:
                    counter.op_bytes += sum(
                        t.numel() * t.element_size()
                        for t in tree_leaves((args, kwargs or {}, out))
                        if isinstance(t, torch.Tensor))
                return out

        self._mode = _Mode()
        self._mode.__enter__()
        return self

    def __exit__(self, *exc):
        return self._mode.__exit__(*exc)


def plain_route_cost(model, dtype, batch: int, input_shape: tuple) -> dict:
    """``{"flops", "bytes"}`` of one forward of ``model`` (any device; it
    is copied to the meta device) at ``batch`` on the plain route, the f32
    softmax included as the engine runs it. ``bytes`` is the upper bound:
    the parameters plus every op's inputs and outputs."""
    import torch

    from storm_tpu_torch.ops.parity_checks import plain_kernels

    param_bytes = sum(b.numel() * b.element_size() for b in model.buffers())
    meta = copy.deepcopy(model).to("meta")
    x = torch.zeros((batch, *input_shape), dtype=dtype, device="meta")
    # no_grad, not inference_mode: composite ops (conv2d, matmul) must
    # decompose to the aten ops the counter knows.
    with plain_kernels(), torch.no_grad(), CostCounter() as c:
        meta(x).float().softmax(dim=-1)
    return {"flops": float(c.flops), "bytes": float(param_bytes + c.op_bytes),
            "ops": dict(c.ops)}


# ---- rows -------------------------------------------------------------------------


def config_label(name: str, weights: str) -> str:
    return name if weights == "float" else f"{name}+{weights}"


def make_row(config: str, batch: int, per_step: float, flops: float, hbm_bytes: float,
             peak: float = PEAK_BF16_FLOPS) -> dict:
    """bench_device.py's row (``bench_config``) from one step's seconds and
    its FLOPs and bytes, against ``peak`` FLOP/s. The roofline is the
    compute one alone: the counted bytes are an upper bound (the measured
    roofline finds them above what the card moves), so they stand in
    ``hbm_gbytes_upper_bound`` and decide no ``bound``."""
    imgs = batch / per_step
    achieved = flops / per_step if flops else 0.0
    row = {
        "config": config,
        "batch": batch,
        "step_ms": round(per_step * 1e3, 3),
        "images_per_sec": round(imgs, 1),
        "gflops_per_fwd": round(flops / 1e9, 2),
        "achieved_tflops": round(achieved / 1e12, 2),
        "mfu_pct": round(100 * achieved / peak, 1),
    }
    if flops:
        t_compute = flops / peak
        row.update({
            "bound": "compute",
            "roofline_ms": round(t_compute * 1e3, 3),
            "pct_of_roofline": round(100 * t_compute / per_step, 1),
        })
    if hbm_bytes:
        row["hbm_gbytes_upper_bound"] = round(hbm_bytes / 1e9, 4)
    return row


def roofline_row(config: str, pts: Dict[int, dict], bw_meas: float) -> dict:
    """bench_device.py's ``measured_roofline`` row from its two points
    ``pts[b] = {"t", "cost_bytes", "param_bytes"}`` at B / 2 and B: the
    step's batch-constant and per-sample parts in time and in counted
    bytes, and the bound at the measured bandwidth."""
    Bh, B = sorted(pts)
    tB, tH = pts[B]["t"], pts[Bh]["t"]
    cB, cH = pts[B]["cost_bytes"], pts[Bh]["cost_bytes"]
    t_scale = (tB - tH) / (B - Bh)
    t_const = max(tB - t_scale * B, 0.0)
    A_cost = (cB - cH) / (B - Bh)
    W_cost = max(cB - A_cost * B, 0.0)
    A_time = t_scale * bw_meas
    param_b = pts[B]["param_bytes"]
    A_corr = min(A_cost, A_time)
    bound = (param_b + A_corr * B) / bw_meas
    pct = 100 * bound / tB
    overstate = A_cost / A_time if A_time > 0 else float("inf")
    row = {
        "config": config,
        "batches": [Bh, B],
        "step_ms": [round(tH * 1e3, 3), round(tB * 1e3, 3)],
        "cost_bytes_gb": [round(cH / 1e9, 4), round(cB / 1e9, 4)],
        "bw_measured_gb_s": round(bw_meas / 1e9, 1),
        "param_bytes_gb": round(param_b / 1e9, 4),
        "per_sample_cost_bytes_mb": round(A_cost / 1e6, 3),
        "per_sample_time_equiv_bytes_mb": round(A_time / 1e6, 3),
        "cost_per_sample_overstatement_x": round(overstate, 2),
        "const_time_ms": round(t_const * 1e3, 3),
        "const_time_equiv_bytes_gb": round(t_const * bw_meas / 1e9, 4),
        "cost_const_bytes_gb": round(W_cost / 1e9, 4),
        "measured_bound_ms": round(bound * 1e3, 3),
        "pct_of_measured_bound": round(pct, 1),
    }
    row["conclusion"] = (
        (f"counted bytes overstate per-sample traffic {overstate:.2f}x "
         if overstate > 1.05 else
         "counted per-sample bytes are consistent with measured time; ")
        + (f"constant step cost {t_const * 1e3:.2f} ms vs "
           f"{param_b / bw_meas * 1e3:.2f} ms of unavoidable weight "
           f"reload -> {(t_const - param_b / bw_meas) * 1e3:.2f} ms fixed "
           "overhead beyond weights")
        + f"; {pct:.0f}% of the corrected (measured-BW) bound at B={B}")
    return row


# ---- timing on the card -------------------------------------------------------------


def median_ms(window: Callable[[], float], windows: int = WINDOWS) -> float:
    return statistics.median(window() for _ in range(windows))


def graph_ms(fn: Callable, iters: int, windows: int = WINDOWS) -> float:
    """Device ms of one ``fn()``: warmed up on a side stream, captured once
    in a CUDA graph, replayed ``iters`` times a window between CUDA
    events; the median of ``windows`` windows."""
    import torch

    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        fn()
    for _ in range(3):
        graph.replay()
    torch.cuda.synchronize()

    def window() -> float:
        t0 = torch.cuda.Event(enable_timing=True)
        t1 = torch.cuda.Event(enable_timing=True)
        t0.record()
        for _ in range(iters):
            graph.replay()
        t1.record()
        t1.synchronize()
        return t0.elapsed_time(t1) / iters

    ms = median_ms(window, windows)
    del graph
    return ms


def build_engine(cfg: dict, weights: str = "float"):
    """The engine the serving path builds for ``cfg`` (one bucket, the
    config's batch) on the card, seeded weights, bfloat16 compute (as
    ``bench_device.py``'s)."""
    from storm_tpu_torch.config import BatchConfig, ModelConfig
    from storm_tpu_torch.infer.engine import InferenceEngine

    return InferenceEngine(
        ModelConfig(name=cfg["model"], dtype="bfloat16", input_shape=tuple(cfg["input_shape"]),
                    num_classes=cfg["num_classes"], weights=weights),
        BatchConfig(max_batch=cfg["batch"], buckets=(cfg["batch"],)), device="cuda")


def staged_bucket(eng, batch: int, plain: bool = False):
    """The engine's bucket of ``batch`` rows with a seeded batch in its
    static input; with ``plain``, a bucket of its own on the same engine
    (its forward, streams and graph pool) captured on the plain route."""
    import torch

    from storm_tpu_torch.infer.graphs import BucketForward
    from storm_tpu_torch.ops.parity_checks import plain_kernels

    if plain:
        bucket = BucketForward(eng._forward, batch, eng.input_shape, eng.wire_dtype,
                               eng.num_classes, eng.device, 1, wire=eng.wire_uint8,
                               streams=eng._streams, pool=eng._graph_pool)
        with plain_kernels():
            bucket.build()
        if bucket.launches:
            raise AssertionError(f"the plain route's graph launched {bucket.launches}")
    else:
        bucket = eng.graph_for(batch)
    x = np.random.RandomState(0).rand(batch, *eng.input_shape).astype(np.float32)
    bucket.static_in.copy_(torch.from_numpy(x).to(eng.wire_dtype))
    return bucket


def replay_step(bucket, iters: int) -> float:
    """Seconds of one replay of ``bucket``'s graph: warm-up, then the
    median of the windows."""
    from storm_tpu_torch.infer.graphs import replay_ms

    bucket.replay(3)
    return median_ms(lambda: replay_ms(bucket, iters)) / 1e3


def bench_config(name: str, iters: int, weights: str = "float", batch: int = 0,
                 card: str = "") -> dict:
    cfg = dict(CONFIGS[name])
    if batch:
        cfg["batch"] = batch
    eng = build_engine(cfg, weights)
    bucket = staged_bucket(eng, cfg["batch"])
    per_step = replay_step(bucket, iters)
    cost = plain_route_cost(eng.model, eng.dtype, cfg["batch"], eng.input_shape)
    row = make_row(config_label(name, weights), cfg["batch"], per_step, cost["flops"],
                   cost["bytes"], peak_flops(eng.model_cfg.dtype))
    row.update({"launches_per_fwd": dict(bucket.launches),
                "bytes_are": "upper bound: parameters plus every op's inputs and outputs "
                             "on the plain route", "card": card})
    log(f"{row['config']:>22}: {row['step_ms']:8.3f} ms/step  "
        f"{row['images_per_sec']:>9.0f} img/s  {row['achieved_tflops']:6.2f} TFLOP/s  "
        f"MFU {row['mfu_pct']:4.1f}%"
        + (f"  [{row['pct_of_roofline']:.0f}% of the compute roofline]"
           if "bound" in row else "") + f"  ({card})")
    return row


def measure_hbm_bw(iters: int = 20) -> float:
    """Achievable device-memory bandwidth (bytes/s): an in-place scale of a
    1 GiB f32 buffer reads and writes all of it; CUDA events over
    ``iters`` scales a window, the median of the windows."""
    import torch

    n = 1 << 28  # f32 elements -> 1 GiB
    x = torch.ones(n, dtype=torch.float32, device="cuda")
    ms = graph_ms(lambda: x.mul_(1.0000001), iters)
    del x
    bw = 2 * n * 4 / (ms / 1e3)
    log(f"measured HBM bandwidth: {bw / 1e9:.0f} GB/s "
        f"({100 * bw / PEAK_HBM_BYTES_PER_S:.0f}% of the 3350 GB/s published peak)")
    return bw


def measured_roofline(name: str, iters: int, bw_meas: float, weights: str = "float",
                      card: str = "") -> dict:
    """bench_device.py's two-point batch sweep at B / 2 and B (see
    :func:`roofline_row`), with the port's counted bytes (an upper bound)
    in place of XLA's."""
    cfg = dict(CONFIGS[name])
    B = cfg["batch"]
    pts = {}
    for b in (max(1, B // 2), B):
        c = dict(cfg, batch=b)
        eng = build_engine(c, weights)
        t = replay_step(staged_bucket(eng, b), iters)
        cost = plain_route_cost(eng.model, eng.dtype, b, eng.input_shape)
        pts[b] = dict(t=t, cost_bytes=cost["bytes"], param_bytes=eng.param_bytes())
        log(f"  {name} B={b}: {t * 1e3:.3f} ms/step, counted bytes "
            f"{cost['bytes'] / 1e9:.3f} GB")
        del eng
    row = roofline_row(config_label(name, weights), pts, bw_meas)
    row["card"] = card
    log(f"  => {row['conclusion']} ({card})")
    return row


def bench_ab(name: str, iters: int, weights: str = "float", card: str = "") -> list:
    """The kernels against the plain route: one engine, one batch, the
    kernels' graph and the plain route's graph, each replayed."""
    cfg = dict(CONFIGS[name])
    eng = build_engine(cfg, weights)
    cost = plain_route_cost(eng.model, eng.dtype, cfg["batch"], eng.input_shape)
    rows = []
    for mode, plain in (("kernels", False), ("plain", True)):
        bucket = staged_bucket(eng, cfg["batch"], plain=plain)
        row = make_row(config_label(name, weights), cfg["batch"], replay_step(bucket, iters),
                       cost["flops"], cost["bytes"], peak_flops(eng.model_cfg.dtype))
        row.update({"kernels": mode, "launches_per_fwd": dict(bucket.launches),
                    "card": card})
        rows.append(row)
    a, b = rows
    if not a["launches_per_fwd"]:
        raise AssertionError(f"{name}'s graph launched no kernel of ours: no A/B to make")
    speedup = b["step_ms"] / a["step_ms"] if a["step_ms"] else float("nan")
    a["vs_plain_speedup"] = round(speedup, 3)
    log(f"  A/B {a['config']}: kernels {a['step_ms']} ms vs plain {b['step_ms']} ms "
        f"-> {speedup:.2f}x ({card})")
    return rows


def attn_sweep(iters: int, seqs: Sequence[int] = ATTN_SEQS, card: str = "") -> list:
    """The flash kernel against the library's
    ``scaled_dot_product_attention`` and the plain version at (4, 8, S, 64)
    bf16, each beside the bound (its bytes or operations at the published
    peaks)."""
    import torch
    import torch.nn.functional as F

    from storm_tpu_torch.ops.flash_attention import (
        flash_attention, flash_attention_reference)

    b, h, d = ATTN_SHAPE
    rows = []
    g = torch.Generator(device="cuda").manual_seed(0)
    for s in seqs:
        q, k, v = (torch.randn(b, h, s, d, device="cuda", generator=g).to(torch.bfloat16)
                   for _ in range(3))
        ms = {"flash": graph_ms(lambda: flash_attention(q, k, v), iters),
              "library": graph_ms(lambda: F.scaled_dot_product_attention(q, k, v), iters),
              "plain": graph_ms(lambda: flash_attention_reference(q, k, v), iters)}
        nbytes = 4 * b * h * s * d * 2
        flops = 4.0 * b * h * s * s * d
        bound = max(nbytes / PEAK_HBM_BYTES_PER_S, flops / PEAK_BF16_FLOPS) * 1e3
        row = {"metric": "attention_flash_vs_library", "seq": s,
               "flash_ms": round(ms["flash"], 4), "library_ms": round(ms["library"], 4),
               "plain_ms": round(ms["plain"], 4), "bound_ms": round(bound, 4),
               "flash_speedup": round(ms["library"] / ms["flash"], 3), "card": card}
        log(f"  attn S={s:5d}: flash {row['flash_ms']:8.4f} ms  library "
            f"{row['library_ms']:8.4f} ms  plain {row['plain_ms']:8.4f} ms  bound "
            f"{row['bound_ms']:.4f} ms  flash is {row['flash_speedup']:.2f}x ({card})")
        rows.append(row)
    return rows


def main(argv: Optional[Sequence[str]] = None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--config", default="", choices=[""] + sorted(CONFIGS))
    ap.add_argument("--iters", type=int, default=30, help="replays a timed window")
    ap.add_argument("--batch", type=int, default=0,
                    help="override the config's device batch size")
    ap.add_argument("--ab", action="store_true",
                    help="the kernels against the plain route for the kernel-bearing configs")
    ap.add_argument("--attn-sweep", action="store_true",
                    help="flash against the library's attention across sequence lengths "
                         "(alone: the sweep's rows only; with --ab or --config, after them)")
    ap.add_argument("--seqs", default="",
                    help="comma-separated sequence lengths of the sweep (default "
                         + ",".join(map(str, ATTN_SEQS)) + ")")
    ap.add_argument("--weights", default="float", choices=["float", "int8", "int8_fused"])
    ap.add_argument("--measured-roofline", action="store_true",
                    help="two-point batch sweep + measured HBM bandwidth (default configs "
                         "vit_b16 and longseq_encoder)")
    ap.add_argument("--hbm-bw", action="store_true",
                    help="measure the HBM bandwidth first (a row of its own)")
    args = ap.parse_args(argv)

    import torch

    if not torch.cuda.is_available():
        log("ERROR: the device bench needs a CUDA card (torch.cuda.is_available() is "
            "false); its FLOP count runs on the CPU in tests/test_torch_bench_device.py")
        return 2
    sys.path.insert(0, REPO)
    from storm_tpu_torch.device import resolve_device
    from storm_tpu_torch.ops import _build

    resolve_device("cuda")  # the package's arithmetic: TF32 off
    _build.build_all()
    card = card_line()
    log(f"device: {torch.cuda.get_device_name(0)} ({card}), torch {torch.__version__}, "
        f"CUDA {torch.version.cuda}")
    if args.measured_roofline:
        bw = measure_hbm_bw()
        names = [args.config] if args.config else ["vit_b16", "longseq_encoder"]
        rows = [measured_roofline(n, args.iters, bw, weights=args.weights, card=card)
                for n in names]
        print(json.dumps({"bw_measured_gb_s": round(bw / 1e9, 1), "card": card,
                          "rows": rows}))
        return 0
    results = []
    if args.hbm_bw:
        results.append({"metric": "hbm_bandwidth",
                        "bw_measured_gb_s": round(measure_hbm_bw() / 1e9, 1), "card": card})
    if args.ab:
        ab_names = [args.config] if args.config else ["vit_b16", "mixer_tiny"]
        for n in ab_names:
            results.extend(bench_ab(n, args.iters, weights=args.weights, card=card))
        if not args.config:
            # the w8a16 kernel rides the int8_fused path on vit_b16
            for w in ("int8", "int8_fused"):
                results.append(bench_config("vit_b16", args.iters, weights=w, card=card))
    elif args.config or not (args.attn_sweep or args.hbm_bw):
        names = [args.config] if args.config else list(CONFIGS)
        for n in names:
            results.append(bench_config(n, args.iters, weights=args.weights,
                                        batch=args.batch, card=card))
    if args.attn_sweep:
        seqs = [int(s) for s in args.seqs.split(",")] if args.seqs else ATTN_SEQS
        results.extend(attn_sweep(max(args.iters // 3, 5), seqs, card))
    print(json.dumps(results))
    return 0


if __name__ == "__main__":
    sys.exit(main())
