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

Training differentiates through the collectives (``torch.autograd.Function``
each; a backward's collective counts in :func:`collective_stats` like any
other). Two conventions of the gradient, by what the loss is on an axis:

- *replicated*: every rank of the axis computes the same loss (the model
  axis of Megatron tensor parallelism, a pipeline's stage axis, the
  expert axis). :func:`copy_to_axis` (Megatron's *f*: identity forward,
  the gradient summed over the axis in backward) enters a region whose
  ranks each compute part of a result; :func:`reduce_from_axis` (*g*:
  sum forward, identity backward) leaves it; :func:`gather_from_axis`
  concatenates the ranks' parts, its backward this rank's slice;
- *partitioned*: each rank's loss is a part of the total (the data axis,
  and a sequence axis whose shards each sum their own part).
  :func:`sum_over_axis` (sum forward, the gradient summed in backward: a
  global statistic such as BatchNorm's over the data axis),
  :func:`ring_shift` (``ppermute`` with ``ppermute(-shift)`` of the gradient
  as its backward), and :func:`all_reduce_grads` (the parameters'
  gradients summed, or averaged, over the axis in one flattened buffer,
  after the backward). :func:`replicate_grads` gives every rank of a
  replicated-loss axis one rank's gradients of its replicated leaves.

Every rank of an axis must call its collectives in one order; a backward
runs its collectives in autograd's order, which is the same on ranks that
built the same graph. The in-place :func:`all_reduce`, :func:`all_gather`,
:func:`ppermute` and :func:`broadcast` (over every rank of the mesh, from
its leader: a led engine's batches) are not differentiable; serving calls
them where it needs no gradient.
"""

from __future__ import annotations

import threading
import time
from typing import List, Optional

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


def broadcast(t: torch.Tensor, mesh) -> torch.Tensor:
    """The mesh leader's ``t`` on every rank of the mesh, in place (over
    ``mesh.whole``); returns ``t``. A host tensor under NCCL goes through
    the mesh's device."""
    group = mesh.whole
    if group is None:
        return t
    via_device = not t.is_cuda and dist.get_backend(group) == "nccl"
    stage = staged("broadcast", t, group)
    with _Timed(t, stage):
        buf = t.to(mesh.device) if via_device else (_host(t) if stage else t)
        dist.broadcast(buf, src=mesh.leader, group=group)
        if buf is not t:
            t.copy_(buf)
    return t


# ---- differentiable collectives -------------------------------------------------


class _CopyToAxis(torch.autograd.Function):
    @staticmethod
    def forward(ctx, t, mesh, axis):
        ctx.mesh, ctx.axis = mesh, axis
        return t.view_as(t)

    @staticmethod
    def backward(ctx, g):
        return all_reduce(g.contiguous().clone(), ctx.mesh, ctx.axis), None, None


class _ReduceFromAxis(torch.autograd.Function):
    @staticmethod
    def forward(ctx, t, mesh, axis):
        return all_reduce(t.contiguous().clone(), mesh, axis)

    @staticmethod
    def backward(ctx, g):
        return g, None, None


class _SumOverAxis(torch.autograd.Function):
    @staticmethod
    def forward(ctx, t, mesh, axis):
        ctx.mesh, ctx.axis = mesh, axis
        return all_reduce(t.contiguous().clone(), mesh, axis)

    @staticmethod
    def backward(ctx, g):
        return all_reduce(g.contiguous().clone(), ctx.mesh, ctx.axis), None, None


class _GatherFromAxis(torch.autograd.Function):
    @staticmethod
    def forward(ctx, t, mesh, axis, dim):
        ctx.mesh, ctx.axis, ctx.dim, ctx.size = mesh, axis, dim, t.shape[dim]
        return all_gather(t, mesh, axis, dim)

    @staticmethod
    def backward(ctx, g):
        i = ctx.mesh.coord(ctx.axis)
        return g.narrow(ctx.dim, i * ctx.size, ctx.size), None, None, None


class _Shift(torch.autograd.Function):
    @staticmethod
    def forward(ctx, t, mesh, axis, shift):
        ctx.mesh, ctx.axis, ctx.shift = mesh, axis, shift
        return ppermute(t, mesh, axis, shift)

    @staticmethod
    def backward(ctx, g):
        return ppermute(g.contiguous(), ctx.mesh, ctx.axis, -ctx.shift), None, None, None


def _one(mesh, axis: str) -> bool:
    """Whether ``axis`` has one rank (or is not in the mesh): its
    collectives are the identity."""
    return mesh is not None and mesh.shape.get(axis, 1) == 1


def copy_to_axis(t: torch.Tensor, mesh, axis: str) -> torch.Tensor:
    """Megatron's *f*: ``t`` as it is, its gradient summed over ``axis``
    in backward (the entry of a region whose ranks each use part of the
    parameters on the same ``t``). The identity over an axis of one."""
    return t if _one(mesh, axis) else _CopyToAxis.apply(t, mesh, axis)


def reduce_from_axis(t: torch.Tensor, mesh, axis: str) -> torch.Tensor:
    """Megatron's *g*: the sum of the ranks' ``t`` over ``axis`` (a new
    tensor), the gradient passed through as it is in backward (every
    rank's loss is the same, so each partial sum gets all of it)."""
    return t if _one(mesh, axis) else _ReduceFromAxis.apply(t, mesh, axis)


def sum_over_axis(t: torch.Tensor, mesh, axis: str) -> torch.Tensor:
    """The sum of the ranks' ``t`` over an axis whose ranks' losses add up
    to the total (the data axis): the gradient is summed over ``axis`` in
    backward, so each rank's ``t`` gets what every rank's loss owes it."""
    return t if _one(mesh, axis) else _SumOverAxis.apply(t, mesh, axis)


def gather_from_axis(t: torch.Tensor, mesh, axis: str, dim: int = 0) -> torch.Tensor:
    """:func:`all_gather` with a gradient: the ranks' ``t`` concatenated
    along ``dim``; backward keeps this rank's slice of the gradient (every
    rank computes the same loss from the gathered whole)."""
    return t if _one(mesh, axis) else _GatherFromAxis.apply(t, mesh, axis, dim)


def ring_shift(t: torch.Tensor, mesh, axis: str, shift: int = 1) -> torch.Tensor:
    """:func:`ppermute` with a gradient: the gradient of what this rank
    received goes back to the rank that sent it (``ppermute(-shift)``)."""
    return t if _one(mesh, axis) else _Shift.apply(t, mesh, axis, shift)


def all_reduce_grads(tensors: List[Optional[torch.Tensor]], mesh, axis: str,
                     mean: bool = True) -> List[Optional[torch.Tensor]]:
    """Sum ``tensors`` (gradients; None is skipped) over ``axis`` in place,
    through one flattened buffer per dtype and device (one collective,
    not one a leaf), and divide by the axis's size with ``mean``. Every
    rank of the axis passes tensors of the same shapes in the same order.
    Returns ``tensors``."""
    group = None if _one(mesh, axis) else mesh.group(axis)
    if group is None:
        return tensors
    n = mesh.shape[axis]
    buckets: dict = {}
    for t in tensors:
        if t is not None:
            buckets.setdefault((t.dtype, t.device), []).append(t)
    for ts in buckets.values():
        flat = torch.cat([t.reshape(-1) for t in ts])
        all_reduce(flat, mesh, axis)
        if mean:
            flat.div_(n)
        offset = 0
        for t in ts:
            t.copy_(flat[offset:offset + t.numel()].view_as(t))
            offset += t.numel()
    return tensors


def replicate_grads(tensors: List[Optional[torch.Tensor]], mesh, axis: str,
                    src: int = 0) -> List[Optional[torch.Tensor]]:
    """Make every rank's ``tensors`` (the gradients of leaves replicated
    over ``axis``, which every rank of it computed alike) those of the
    rank at index ``src`` of the axis, bit for bit: the other ranks
    contribute zeros to one :func:`all_reduce_grads` sum. A guard against
    replicas drifting apart through kernels whose summation order is not
    fixed. Returns ``tensors``."""
    if _one(mesh, axis):
        return tensors
    if mesh.coord(axis) != src:
        for t in tensors:
            if t is not None:
                t.zero_()
    return all_reduce_grads(tensors, mesh, axis, mean=False)


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
