#!/usr/bin/env python3
"""The fleet's capacity probe against a variant of it, in turns on one
serve_path worker, on the card unless ``--device cpu`` is given::

    python3 fleet_probe_ab.py                          # 2 rounds on the card
    python3 fleet_probe_ab.py --rounds 1 --out -

``probe`` is ``storm_tpu_torch.loadgen.fleet``'s probe as it stands
(``_probe_capacity``: a closed-loop burst, then ``_saturated_rate``'s five
open-loop steps). ``climb`` was tried as a repair of a probe that read
serve_path's capacity below what its flash cell then served, and was kept
out (ROADMAP C25); it stays here so that the comparison can be run again:
1.25x the rate after a step that keeps up and the best delivery so far
after one that falls behind, every step on a drained topology, ending at
the second step behind.

Each round runs every variant once, in the order given. A row is a probe's
cap1 in msg/s, its steps' lines and its wall seconds. The JSON goes to
``--out`` (default ``build/fleet_probe_ab.json``, git-ignored; ``-`` for
stdout) with the card's name and power limit. Without a card the script
refuses with exit 2 unless ``--device cpu`` is given.
"""

from __future__ import annotations

import argparse
import contextlib
import json
import os
import sys
import time

REPO = os.path.dirname(os.path.abspath(__file__))
DEFAULT_OUT = os.path.join("build", "fleet_probe_ab.json")
SLO_MS = 400.0  # run_fleet's default


@contextlib.contextmanager
def climb(sc):
    """``fleet._saturated_rate`` climbs 1.25x a step from drained steps."""
    from storm_tpu_torch.loadgen import fleet

    saturated, open_loop = fleet._saturated_rate, fleet._open_loop
    base: dict = {}

    def drained_open_loop(broker, input_topic, output_topic, *rest):
        if not base:  # the first step follows the burst, which has drained
            base.update(i=broker.topic_size(input_topic),
                        o=broker.topic_size(output_topic))
        fleet._await_topic(broker, output_topic,
                           base["o"] + broker.topic_size(input_topic) - base["i"],
                           "climb")
        return open_loop(broker, input_topic, output_topic, *rest)

    def climbing(step, rate):
        base.clear()
        best, behind, dur = 0.0, 0, 6.0
        for _ in range(fleet._PROBE_STEPS):
            delivered, offered = step(rate, dur)
            best = max(best, delivered)
            if delivered < fleet._SATURATED * offered:
                behind += 1
                if behind == 2:
                    break
                rate = best
            else:
                rate *= 1.25
            dur = fleet._RAISED_S
        return best

    fleet._saturated_rate, fleet._open_loop = climbing, drained_open_loop
    try:
        yield
    finally:
        fleet._saturated_rate, fleet._open_loop = saturated, open_loop


VARIANTS = {"probe": lambda sc: contextlib.nullcontext(), "climb": climb}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--rounds", type=int, default=2)
    ap.add_argument("--variants", default="probe,climb",
                    help="comma-separated, run in this order each round")
    ap.add_argument("--device", default="cuda", choices=["cuda", "cpu"])
    ap.add_argument("--out", default=DEFAULT_OUT,
                    help="JSON path (relative to the repository root), or - for stdout")
    args = ap.parse_args(argv)
    names = args.variants.split(",")
    unknown = [n for n in names if n not in VARIANTS]
    if unknown:
        ap.error(f"unknown variants {unknown}; known {sorted(VARIANTS)}")

    import torch

    if args.device == "cuda" and not torch.cuda.is_available():
        print("ERROR: the probe comparison needs a CUDA card (torch.cuda.is_available() "
              "is false). Use --device cpu to run it on the CPU.", file=sys.stderr)
        return 2
    sys.path.insert(0, REPO)
    from storm_tpu_torch.device import card_line, resolve_device
    from storm_tpu_torch.loadgen import fleet
    from storm_tpu_torch.runtime.cluster import LocalCluster

    device = str(resolve_device(args.device))
    card = card_line() if args.device == "cuda" else "cpu"
    rows = []
    cluster = LocalCluster()
    try:
        fleet._clear_engines()
        sc = fleet._make_scenarios(("serve_path",), device)[0]
        sc.setup()
        try:
            for rnd in range(args.rounds):
                for name in names:
                    lines: list = []
                    t0 = time.perf_counter()
                    with VARIANTS[name](sc):
                        cap = sc.probe(cluster, SLO_MS, lines.append)
                    row = {"round": rnd, "variant": name, "cap1_msg_s": round(cap, 1),
                           "wall_s": round(time.perf_counter() - t0, 1), "steps": lines}
                    rows.append(row)
                    print(f"round {rnd} {name:11s} cap1 {row['cap1_msg_s']:8.1f} msg/s in "
                          f"{row['wall_s']:5.1f} s on {card}", file=sys.stderr, flush=True)
        finally:
            sc.teardown()
            fleet._clear_engines()
    finally:
        cluster.shutdown()
    out = json.dumps({"scenario": "serve_path", "device": device, "card": card,
                      "slo_ms": SLO_MS, "rows": rows}, indent=1)
    if args.out == "-":
        print(out)
    else:
        path = os.path.join(REPO, args.out)
        os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
        with open(path, "w") as f:
            f.write(out + "\n")
        print(f"wrote {args.out}: {len(rows)} probes")
    return 0


if __name__ == "__main__":
    sys.exit(main())
