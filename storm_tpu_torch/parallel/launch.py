"""A world of rank processes on one host: the launcher of the port's
multi-rank serving (``chip_smoke.py``, the tests).

:func:`spawn_ranks` starts ``world`` fresh interpreters (``python -m
storm_tpu_torch.parallel.launch``, never a fork: CUDA does not survive
one), each of which initializes the default process group itself (TCP
rendezvous on ``127.0.0.1``, its world size and rank, the backend given),
calls ``target(rank, world, **kwargs)`` (a ``module:function`` path the
ranks import; the repository is on their path) and writes its return
value, pickled, beside its log. Every rank is joined with a deadline; a
rank that fails or outlives it fails the call, and every process still
running is killed in a ``finally``. Collectives time out after
``collective_timeout_s``, so a rank whose peer died raises instead of
waiting.
"""

from __future__ import annotations

import argparse
import datetime
import importlib
import os
import pickle
import socket
import subprocess
import sys
import tempfile
import time
from pathlib import Path
from typing import Dict, List, Optional

ROOT = Path(__file__).resolve().parents[2]


def free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _tail(path: Path, n: int = 4000) -> str:
    try:
        return path.read_text(errors="replace")[-n:]
    except OSError:
        return ""


def spawn_ranks(target: str, world: int, kwargs: Optional[dict] = None, *,
                backend: str = "gloo", timeout_s: float = 120.0,
                collective_timeout_s: float = 60.0,
                env: Optional[Dict[str, str]] = None) -> List[object]:
    """Run ``target(rank, world, **kwargs)`` in ``world`` rank processes;
    returns their results in rank order. Raises with every failed rank's
    log tail when one exits non-zero or the deadline passes first."""
    tmp = tempfile.TemporaryDirectory(prefix="storm-ranks-")
    work = Path(tmp.name)
    with open(work / "kwargs.pkl", "wb") as f:
        pickle.dump(kwargs or {}, f)
    penv = dict(os.environ)
    penv.update(env or {})
    penv["PYTHONPATH"] = os.pathsep.join(
        [str(ROOT)] + [p for p in penv.get("PYTHONPATH", "").split(os.pathsep) if p])
    init = f"tcp://127.0.0.1:{free_port()}"
    procs: List[subprocess.Popen] = []
    logs = []
    try:
        for rank in range(world):
            log = open(work / f"rank{rank}.log", "w")
            logs.append(log)
            procs.append(subprocess.Popen(
                [sys.executable, "-m", "storm_tpu_torch.parallel.launch", "--rank",
                 str(rank), "--world", str(world), "--init", init, "--backend", backend,
                 "--target", target, "--dir", str(work),
                 "--collective-timeout", str(collective_timeout_s)],
                stdout=log, stderr=subprocess.STDOUT, env=penv, cwd=str(ROOT)))
        # Poll every rank: the first failure ends the world at once (its
        # peers would wait in a collective until their timeout).
        deadline = time.monotonic() + timeout_s
        failed = []
        while True:
            codes = [p.poll() for p in procs]
            failed = [(r, f"exit {c}") for r, c in enumerate(codes) if c not in (None, 0)]
            if failed or all(c == 0 for c in codes):
                break
            if time.monotonic() > deadline:
                failed = [(r, f"still running after {timeout_s:g} s")
                          for r, c in enumerate(codes) if c is None]
                break
            time.sleep(0.05)
        if failed:
            for p in procs:
                if p.poll() is None:
                    p.kill()
            for p in procs:
                p.wait(timeout=30)
            raise RuntimeError("rank processes failed: " + "; ".join(
                f"rank {r}: {why}\n{_tail(work / f'rank{r}.log')}" for r, why in failed))
        results = []
        for rank in range(world):
            with open(work / f"rank{rank}.pkl", "rb") as f:
                results.append(pickle.load(f))
        return results
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait(timeout=30)
        for log in logs:
            log.close()
        tmp.cleanup()


def _resolve(target: str):
    module, _, name = target.partition(":")
    return getattr(importlib.import_module(module), name)


def _main(argv=None) -> int:
    ap = argparse.ArgumentParser(description="one rank of spawn_ranks' world")
    ap.add_argument("--rank", type=int, required=True)
    ap.add_argument("--world", type=int, required=True)
    ap.add_argument("--init", required=True)
    ap.add_argument("--backend", default="gloo")
    ap.add_argument("--target", required=True)
    ap.add_argument("--dir", required=True)
    ap.add_argument("--collective-timeout", type=float, default=60.0)
    a = ap.parse_args(argv)
    import torch.distributed as dist

    work = Path(a.dir)
    with open(work / "kwargs.pkl", "rb") as f:
        kwargs = pickle.load(f)
    dist.init_process_group(a.backend, init_method=a.init, world_size=a.world, rank=a.rank,
                            timeout=datetime.timedelta(seconds=a.collective_timeout))
    try:
        result = _resolve(a.target)(a.rank, a.world, **kwargs)
        with open(work / f"rank{a.rank}.pkl.tmp", "wb") as f:
            pickle.dump(result, f)
        os.replace(work / f"rank{a.rank}.pkl.tmp", work / f"rank{a.rank}.pkl")
    finally:
        dist.destroy_process_group()
    return 0


if __name__ == "__main__":
    sys.exit(_main())
