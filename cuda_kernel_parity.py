#!/usr/bin/env python3
"""Run every CUDA kernel's parity check on the card and write the artifact:
the twin of ``tpu_kernel_parity.py``.

The CPU tests (``tests/test_torch_ops.py``, ``tests/test_torch_parity_checks.py``)
hold the plain versions against storm_tpu's kernels; this runner holds
the hand-written kernels, built from ``storm_tpu_torch/csrc`` and run on
the card, against their plain versions in f32 on the same card
(``storm_tpu_torch/ops/parity_checks.py``: storm_tpu's cases, then the
served paths' cases beyond them, each checking which kernel variant it
launched), and writes one JSON object with every row.

    python3 cuda_kernel_parity.py                   # on the card
    python3 cuda_kernel_parity.py --out -           # the artifact on stdout
    python3 cuda_kernel_parity.py --device cpu      # the plain versions on the CPU

The default output is ``build/KERNEL_CUDA.json`` (git-ignored). Without a
card the runner refuses with exit 2 unless ``--device cpu`` is given, which
runs storm_tpu's cases through the plain versions and records
``"compiled": false``. Exit 0 only when every case passes.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

from storm_tpu_torch.device import card_line

REPO = os.path.dirname(os.path.abspath(__file__))
DEFAULT_OUT = os.path.join("build", "KERNEL_CUDA.json")


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--out", default=DEFAULT_OUT,
                    help="artifact path (relative to the repository root), or - for stdout")
    ap.add_argument("--device", default="cuda", choices=["cuda", "cpu"],
                    help="cpu runs the plain versions (no kernel is compiled)")
    args = ap.parse_args(argv)

    import torch

    if args.device == "cuda" and not torch.cuda.is_available():
        print("ERROR: the kernel parity run needs a CUDA card (torch.cuda.is_available() "
              "is false). Use --device cpu to run the plain versions.", file=sys.stderr)
        return 2
    sys.path.insert(0, REPO)
    from storm_tpu_torch.ops import parity_checks

    t0 = time.time()
    if args.device == "cuda":
        from storm_tpu_torch.ops import _build

        _build.build_all()  # one nvcc per source, in parallel
    rows = parity_checks.run_all(args.device)
    if args.device == "cuda":
        parity_checks.parity_cases(rows, args.device)
        parity_checks.longseq_kernel_cases(rows, args.device)
    artifact = {
        "platform": "gpu" if args.device == "cuda" else "cpu",
        "device_kind": torch.cuda.get_device_name(0) if args.device == "cuda" else "cpu",
        "power_limit": card_line().split(",")[-1].strip() if args.device == "cuda" else None,
        "compiled": args.device == "cuda",
        "note": "max_abs_err and max_rel_err are measured in f32 against the plain "
                "PyTorch version on the same device and the same (dtype-rounded) inputs, "
                "TF32 off; storm_tpu's cases first, then the served paths' cases beyond "
                "them (card only)",
        "all_pass": all(r["pass"] for r in rows),
        "wall_s": round(time.time() - t0, 1),
        "results": rows,
    }
    out = json.dumps(artifact, indent=1)
    if args.out == "-":
        print(out)
    else:
        path = os.path.join(REPO, args.out)
        os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
        with open(path, "w") as f:
            f.write(out + "\n")
        print(f"wrote {args.out}: all_pass={artifact['all_pass']} "
              f"({len(rows)} cases, {artifact['wall_s']}s)")
    for r in rows:
        err = r["max_rel_err"] if r["metric"] == "rel" else r["max_abs_err"]
        print(f"  {'PASS' if r['pass'] else 'FAIL'} {r['kernel']:26s} {r['case']:44s} "
              f"{r['dtype']:8s} {r['metric']}_err={err:.2e} tol={r['tol']:.0e}",
              file=sys.stderr if args.out == "-" else sys.stdout)
    return 0 if artifact["all_pass"] else 1


if __name__ == "__main__":
    sys.exit(main())
