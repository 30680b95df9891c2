#!/usr/bin/env python3
"""Time the tensor-core w8a16 kernel of storm_tpu_torch at every block shape
it is built for, on the ViT-B/16 products, against the one the wrapper
picks and a bf16 cuBLAS product; and the sm90 fused residual + LayerNorm
kernel at every launch plan it can take at ViT-B/16's width.

    python3 kernel_sweep.py            # both sweeps; one CUDA card
    python3 kernel_sweep.py norm       # only the fused norm's (or: w8a16)

Run from the root of a checkout. For each body product of a ViT-B/16
forward at batch 8 (M = 1576 tokens: the four 768 x 768 projections of
every layer, 48 calls; the MLP's 768 -> 3072 and 3072 -> 768, 12 calls
each), every (warpgroups, token tile) of ``csrc/w8a16_matmul_sm90.cu`` is
launched on the same inputs,
checked against the plain version, and timed by CUDA-graph replay of one
forward's calls, each with its own weights.

The fused norm runs at 1576 x 768 bf16 with bf16 g and b (the model's
call), 12 calls a forward, each with its own tensors, for every rows per
block x lanes per row: 32 lanes (one warp) and 16 lanes (half a warp) on
their fixed instantiations, and 32, 96 and 192 lanes on the runtime-d one,
one row to a block. Each plan is checked against the plain version first.
The plan the wrapper picks (``fused_norm.norm_plan``) is then timed on
fresh tensors at B = 1, 8 and 32 (197, 1576 and 6304 rows: batch 8 again,
and the other batch sizes a bucket may hold), beside the byte bound, the
two-call library yardstick (add, then ``layer_norm``) and a one-kernel
copy of the same bytes (``torch.cat`` of x and r: 2 reads and 2 writes of
the row data, no arithmetic), the floor a single launch of this size
reaches on the card.

The last line is a JSON object of the times in ms per forward. Exits 2
without a card.
"""

from __future__ import annotations

import json
import os
import sys

from storm_tpu_torch.device import PEAK_HBM_BYTES_PER_S, card_line

SHAPES = [("qkvo", 768, 768, 48), ("mlp_in", 768, 3072, 12), ("mlp_out", 3072, 768, 12)]
M = 8 * 197
DIM, DEPTH = 768, 12
# (lanes per row, vectors per lane, rows per block) of the fused norm's
# sweep at d = 768 bf16; vectors 6 with lanes a multiple of 32 is the
# runtime-d instantiation.
NORM_SWEEP = ([(32, 3, rpb) for rpb in (1, 2, 4, 8)]
              + [(16, 6, rpb) for rpb in (2, 4, 8, 16)]
              + [(lanes, 6, 1) for lanes in (32, 96, 192)])


def time_ms(torch, fn, reps: int = 20) -> float:
    """Device ms of one fn(), by CUDA-graph replay between CUDA events."""
    fn()
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        fn()
    graph.replay()
    torch.cuda.synchronize()
    t0, t1 = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    t0.record()
    for _ in range(reps):
        graph.replay()
    t1.record()
    torch.cuda.synchronize()
    return t0.elapsed_time(t1) / reps


def w8a16_sweep(torch, card: str) -> dict:
    from storm_tpu_torch.ops import _build
    from storm_tpu_torch.ops.quant_matmul import (
        SM90_TILE_M, sm90_tile, w8a16_matmul_reference)

    kernel = _build.KERNELS["w8a16_matmul_sm90"]
    dev = torch.device("cuda")
    g = torch.Generator(device="cuda").manual_seed(0)
    configs = [(wg, t) for wg in (1, 2) for t in SM90_TILE_M]
    result = {"ms_per_forward": {}, "picked": {}, "cublas_bf16_ms": {}}
    for name, k, n, calls in SHAPES:
        x = torch.randn(M, k, device="cuda", generator=g).to(torch.bfloat16)
        ws = [(torch.randint(-127, 128, (k, n), device="cuda", generator=g,
                             dtype=torch.int8),
               torch.rand(n, device="cuda", generator=g) * 1e-2) for _ in range(calls)]
        outs = [torch.empty(M, n, dtype=torch.bfloat16, device="cuda") for _ in range(calls)]
        want = w8a16_matmul_reference(x, *ws[0]).float()
        times = {}
        for wg, tile_m in configs:
            def run(wg=wg, tile_m=tile_m):
                for (q, s), o in zip(ws, outs):
                    kernel.launch(dev, x, q, s, o, M, n, k, wg, tile_m, 2)
            run()
            err = ((outs[0].float() - want).abs().max() / want.abs().max()).item()
            if not err <= 2e-2:
                raise AssertionError(f"{name} ({wg}, {tile_m}): rel err {err}")
            times[f"{wg}x{tile_m}"] = time_ms(torch, run)
        wd = [q.to(torch.bfloat16) for q, _ in ws]
        result["cublas_bf16_ms"][name] = time_ms(torch, lambda: [torch.matmul(x, w) for w in wd])
        result["ms_per_forward"][name] = times
        result["picked"][name] = "{}x{}".format(*sm90_tile(M, n))
        flops = 2.0 * M * k * n * calls
        print(f"{name} ({calls} x {M}x{k}@{k}x{n}), ms per forward, on {card}: " + ", ".join(
            f"{c} {t:.4f} ({flops / t / 1e9:.0f} TFLOP/s)" for c, t in times.items())
            + f"; picked {result['picked'][name]}; cuBLAS bf16 "
            f"{result['cublas_bf16_ms'][name]:.4f}", flush=True)
    return result


def norm_sweep(torch, card: str) -> dict:
    import torch.nn.functional as F

    from storm_tpu_torch.ops import _build
    from storm_tpu_torch.ops.fused_norm import fused_add_layernorm_reference, norm_plan

    kernel = _build.KERNELS["residual_layernorm_sm90"]
    dev = torch.device("cuda")
    g = torch.Generator(device="cuda").manual_seed(0)
    bf16 = torch.bfloat16
    code = _build.DTYPE_CODES[bf16]

    def forward_calls(rows):
        """One forward's calls: DEPTH sets of (x, r, g, b, y, out)."""
        return [tuple(torch.randn(*shape, device="cuda", generator=g).to(bf16)
                      for shape in ((rows, DIM), (rows, DIM), (DIM,), (DIM,)))
                + (torch.empty(rows, DIM, dtype=bf16, device="cuda"),
                   torch.empty(rows, DIM, dtype=bf16, device="cuda"))
                for _ in range(DEPTH)]

    def run(calls, rows, lanes, vectors, mode, rpb):
        for x, r, gw, bw, y, o in calls:
            kernel.launch(dev, code, code, x, r, gw, bw, y, o, rows, DIM, 1e-6,
                          lanes, vectors, mode, rpb)

    def check(calls, plan):
        x, r, gw, bw, y, o = calls[0]
        wy, wo = fused_add_layernorm_reference(x, r, gw, bw, 1e-6)
        for got, want in ((y, wy), (o, wo)):
            err = ((got.float() - want.float()).abs().max() / want.float().abs().max()).item()
            if not err <= 1e-2:
                raise AssertionError(f"fused norm plan {plan}: rel err {err}")

    def bound_ms(rows):
        """x and r read, y and out written, bf16 g and b read, per forward."""
        return DEPTH * (4 * rows * DIM * 2 + 2 * DIM * 2) / PEAK_HBM_BYTES_PER_S * 1e3

    calls = forward_calls(M)
    times = {}
    for lanes, vectors, rpb in NORM_SWEEP:
        plan = (lanes, vectors, 1, rpb)
        run(calls, M, *plan)
        check(calls, plan)
        times[f"{lanes}x{vectors}/{rpb}"] = time_ms(torch, lambda: run(calls, M, *plan))
    picked = norm_plan(DIM, bf16, calls[0][0].data_ptr(), calls[0][1].data_ptr())
    print(f"fused norm {DEPTH} x ({M}x{DIM} bf16), ms per forward by lanes x vectors / "
          f"rows per block, on {card}: " + ", ".join(f"{c} {t:.4f}" for c, t in times.items())
          + f"; picked {picked}; byte bound {bound_ms(M):.4f}", flush=True)
    result = {"ms_per_forward": times, "picked": list(picked), "bound_ms": bound_ms(M),
              "batches": {}}
    for batch in (1, 8, 32):
        rows = batch * 197
        calls = forward_calls(rows)
        cats = [torch.empty(2 * rows, DIM, dtype=bf16, device="cuda") for _ in calls]
        plan = norm_plan(DIM, bf16, calls[0][0].data_ptr(), calls[0][1].data_ptr())
        run(calls, rows, *plan)
        check(calls, plan)
        t = {"rows": rows, "ms": time_ms(torch, lambda: run(calls, rows, *plan)),
             "library_ms": time_ms(torch, lambda: [F.layer_norm(x + r, (DIM,), gw, bw, 1e-6)
                                                  for x, r, gw, bw, _, _ in calls]),
             "copy_ms": time_ms(torch, lambda: [torch.cat((x, r), out=c)
                                               for (x, r, _, _, _, _), c in zip(calls, cats)]),
             "bound_ms": bound_ms(rows)}
        result["batches"][str(batch)] = t
        print(f"fused norm picked plan {plan}, B = {batch} ({rows} rows), ms per forward on "
              f"{card}: kernel {t['ms']:.4f}, library (add, layer_norm) "
              f"{t['library_ms']:.4f}, copy of the same bytes (cat) {t['copy_ms']:.4f}, "
              f"byte bound {t['bound_ms']:.4f}", flush=True)
    return result


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("kernel_sweep: no CUDA device", file=sys.stderr)
        return 2
    which = sys.argv[1:] or ["w8a16", "norm"]
    if not set(which) <= {"w8a16", "norm"}:
        print(f"kernel_sweep: unknown sweep {which}; choose w8a16, norm", file=sys.stderr)
        return 2
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    card = card_line()
    result = {"card": card}
    if "w8a16" in which:
        result.update(w8a16_sweep(torch, card))
    if "norm" in which:
        result["norm"] = norm_sweep(torch, card)
    print(json.dumps(result))
    return 0


if __name__ == "__main__":
    sys.exit(main())
