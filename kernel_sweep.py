#!/usr/bin/env python3
"""Time the tensor-core w8a16 kernel of storm_tpu_torch at every block shape
it is built for, on the ViT-B/16 products, against the one the wrapper
picks and a bf16 cuBLAS product.

    python3 kernel_sweep.py        # from the root of a checkout, one CUDA card

For each body product of a ViT-B/16 forward at batch 8 (M = 1576 tokens:
the four 768 x 768 projections of every layer, 48 calls; the MLP's
768 -> 3072 and 3072 -> 768, 12 calls each), every (warpgroups, token
tile) of ``csrc/w8a16_matmul_sm90.cu`` is launched on the same inputs,
checked against the plain version, and timed by CUDA-graph replay of one
forward's calls, each with its own weights. The last line is a JSON
object of the times in ms per forward. Exits 2 without a card.
"""

from __future__ import annotations

import json
import os
import subprocess
import sys

SHAPES = [("qkvo", 768, 768, 48), ("mlp_in", 768, 3072, 12), ("mlp_out", 3072, 768, 12)]
M = 8 * 197


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


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("kernel_sweep: no CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    from storm_tpu_torch.ops import _build
    from storm_tpu_torch.ops.quant_matmul import (
        SM90_TILE_M, sm90_tile, w8a16_matmul_reference)

    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True).stdout.strip()
    kernel = _build.KERNELS["w8a16_matmul_sm90"]
    dev = torch.device("cuda")
    g = torch.Generator(device="cuda").manual_seed(0)
    configs = [(wg, t) for wg in (1, 2) for t in SM90_TILE_M]
    result = {"card": card, "ms_per_forward": {}, "picked": {}, "cublas_bf16_ms": {}}
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
    print(json.dumps(result))
    return 0


if __name__ == "__main__":
    sys.exit(main())
