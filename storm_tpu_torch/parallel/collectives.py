"""Collectives over one axis of a mesh: the port's counterpart of what XLA
inserts from storm_tpu's sharding annotations (the psum of a row-parallel
matmul, the all-gather of a batch's rows, the ``lax.ppermute`` of ring
attention, the reduce of a sequence mean and of an expert combine).

Each takes this rank's tensor, the :class:`~storm_tpu_torch.parallel.mesh.Mesh`
and an axis name, and runs over the process group of this rank's line
along that axis; over an axis of one rank it is the identity.

The backend is the process group's, the caller's explicit choice. On one
card the ranks share ``cuda:0``, where NCCL refuses a second rank, so they
run gloo; gloo takes CUDA tensors in some collectives only.
:data:`GLOO_CUDA` lists those that the card showed to take them
(``python -m storm_tpu_torch.parallel.collectives`` finds out, in a world
of two processes on one card); every other collective of a gloo group on
a CUDA tensor is staged here, explicitly: copied to pinned host memory,
run there, copied back. Under NCCL, or on CPU tensors, nothing is staged.

:func:`collective_stats` counts the calls and their wall seconds (the
share of a forward spent in collectives); with :func:`set_sync_timing`
on, each call first waits for the card, so a call's time is its own.
"""

from __future__ import annotations

import threading
import time
from typing import List

import torch
import torch.distributed as dist

# The collectives that gloo runs on CUDA tensors itself (its own staging
# through host memory included), as the card showed (module docstring).
GLOO_CUDA = frozenset({"all_reduce", "all_gather"})
KINDS = ("all_reduce", "all_gather", "ppermute")

_STATS_LOCK = threading.Lock()
_STATS = {"calls": 0, "seconds": 0.0, "staged": 0}
_SYNC = False


def set_sync_timing(on: bool) -> None:
    """With ``on``, each collective on a CUDA tensor synchronizes its
    device before its clock starts."""
    global _SYNC
    _SYNC = bool(on)


def collective_stats() -> dict:
    with _STATS_LOCK:
        return dict(_STATS)


def reset_collective_stats() -> None:
    with _STATS_LOCK:
        _STATS.update(calls=0, seconds=0.0, staged=0)


def staged(kind: str, t: torch.Tensor, group) -> bool:
    """Whether ``kind`` on ``t`` over ``group`` goes through pinned host
    memory here: a CUDA tensor, a gloo group, a collective gloo does not
    take on the card."""
    return t.is_cuda and dist.get_backend(group) == "gloo" and kind not in GLOO_CUDA


def _host(t: torch.Tensor) -> torch.Tensor:
    h = torch.empty(t.shape, dtype=t.dtype, pin_memory=True)
    h.copy_(t)
    return h


class _Timed:
    def __init__(self, t: torch.Tensor, stage: bool) -> None:
        self.t, self.stage = t, stage

    def __enter__(self):
        if _SYNC and self.t.is_cuda:
            torch.cuda.synchronize(self.t.device)
        self.t0 = time.perf_counter()
        return self

    def __exit__(self, *exc):
        dt = time.perf_counter() - self.t0
        with _STATS_LOCK:
            _STATS["calls"] += 1
            _STATS["seconds"] += dt
            _STATS["staged"] += int(self.stage)


def all_reduce(t: torch.Tensor, mesh, axis: str) -> torch.Tensor:
    """The sum of ``t`` over the ranks of ``axis``, in place; returns
    ``t``."""
    group = mesh.group(axis)
    if group is None:
        return t
    stage = staged("all_reduce", t, group)
    with _Timed(t, stage):
        buf = _host(t) if stage else t
        dist.all_reduce(buf, op=dist.ReduceOp.SUM, group=group)
        if stage:
            t.copy_(buf)
    return t


def all_gather(t: torch.Tensor, mesh, axis: str, dim: int = 0) -> torch.Tensor:
    """The ranks' ``t`` of ``axis``, concatenated along ``dim`` in the
    axis's order (every rank's ``t`` of one shape)."""
    group = mesh.group(axis)
    if group is None:
        return t
    stage = staged("all_gather", t, group)
    with _Timed(t, stage):
        src = _host(t) if stage else t.contiguous()
        parts: List[torch.Tensor] = [torch.empty_like(src) for _ in range(mesh.shape[axis])]
        dist.all_gather(parts, src, group=group)
        out = torch.cat(parts, dim=dim)
        if stage:
            out = out.to(t.device)
    return out


def ppermute(t: torch.Tensor, mesh, axis: str, shift: int = 1) -> torch.Tensor:
    """``lax.ppermute`` around the ring of ``axis``: this rank's ``t`` goes
    to the rank ``shift`` ahead, and the result is what the rank
    ``shift`` behind sent (one point-to-point pair a call)."""
    group = mesh.group(axis)
    if group is None:
        return t
    line = mesh.line(axis)
    n, i = len(line), mesh.coord(axis)
    stage = staged("ppermute", t, group)
    with _Timed(t, stage):
        src = _host(t) if stage else t.contiguous()
        out = torch.empty_like(src)
        works = dist.batch_isend_irecv([
            dist.P2POp(dist.isend, src, line[(i + shift) % n], group),
            dist.P2POp(dist.irecv, out, line[(i - shift) % n], group)])
        for w in works:
            w.wait()
        if stage:
            out = out.to(t.device)
    return out


# ---- the probe: which gloo collectives take CUDA tensors on this card ------------


def _probe_rank(kind: str, rank: int, init: str) -> dict:
    """One rank of a world of two on ``cuda:0``: ``kind`` on CUDA tensors
    handed to gloo as they are (no staging), its result checked."""
    import datetime

    dist.init_process_group("gloo", init_method=init, world_size=2, rank=rank,
                            timeout=datetime.timedelta(seconds=30))
    dev = torch.device("cuda", 0)
    try:
        t = torch.full((1024,), float(rank + 1), device=dev)
        if kind == "all_reduce":
            dist.all_reduce(t)
            ok = bool((t == 3.0).all())
        elif kind == "all_gather":
            parts = [torch.empty_like(t) for _ in range(2)]
            dist.all_gather(parts, t)
            ok = all(bool((p == i + 1.0).all()) for i, p in enumerate(parts))
        elif kind == "ppermute":
            out = torch.empty_like(t)
            works = [dist.isend(t, 1 - rank), dist.irecv(out, 1 - rank)]
            for w in works:
                w.wait()
            ok = bool((out == 2.0 - rank).all())
        else:
            raise ValueError(kind)
        return {"ok": ok}
    finally:
        dist.destroy_process_group()


def probe(timeout_s: float = 120.0) -> dict:
    """For each of :data:`KINDS`, a world of two processes on ``cuda:0``
    over gloo tries it on CUDA tensors: ``"native"`` when both ranks get
    the right answer, else what went wrong (an exception, a wrong value,
    a crash). Every process is joined with a deadline and killed after."""
    import json
    import subprocess
    import sys

    from storm_tpu_torch.parallel.launch import ROOT, free_port

    procs = {}
    try:
        for kind in KINDS:
            init = f"tcp://127.0.0.1:{free_port()}"
            procs[kind] = [subprocess.Popen(
                [sys.executable, "-m", "storm_tpu_torch.parallel.collectives", "--probe-rank",
                 kind, str(r), init], stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                text=True, cwd=str(ROOT)) for r in range(2)]
        found = {}
        deadline = time.monotonic() + timeout_s
        for kind, ps in procs.items():
            outs = []
            for p in ps:
                try:
                    out, err = p.communicate(timeout=max(1.0, deadline - time.monotonic()))
                except subprocess.TimeoutExpired:
                    outs.append("hung")
                    continue
                lines = out.strip().splitlines()
                if p.returncode != 0 or not lines:
                    tail = (err.strip().splitlines() or ["?"])[-1]
                    outs.append(f"exit {p.returncode}: {tail[-200:]}")
                else:
                    res = json.loads(lines[-1])
                    outs.append("native" if res.get("ok") else f"wrong: {res}")
            found[kind] = "native" if outs == ["native", "native"] else "; ".join(outs)
        return found
    finally:
        for ps in procs.values():
            for p in ps:
                if p.poll() is None:
                    p.kill()
                    p.wait(timeout=30)


if __name__ == "__main__":
    import json
    import sys

    if len(sys.argv) > 1 and sys.argv[1] == "--probe-rank":
        kind, rank, init = sys.argv[2], int(sys.argv[3]), sys.argv[4]
        try:
            print(json.dumps(_probe_rank(kind, rank, init)), flush=True)
        except Exception as e:  # noqa: BLE001 - the probe reports what failed
            print(json.dumps({"ok": False, "error": f"{type(e).__name__}: {e}"[:300]}),
                  flush=True)
    else:
        print(json.dumps({"gloo_cuda": probe(), "staged_here": sorted(
            k for k in KINDS if k not in GLOO_CUDA)}), flush=True)
