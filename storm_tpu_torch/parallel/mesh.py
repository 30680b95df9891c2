"""A mesh of ranks, the counterpart of ``storm_tpu/parallel/mesh.py``.

storm_tpu lays one ``jax.sharding.Mesh`` over a slice's chips and lets XLA
insert the collectives its sharding annotations imply. The port's unit is
a rank: one process with one device, all ranks in one
``torch.distributed`` process group that the caller initializes
(``init_process_group`` with its address, world size and rank). A
:class:`Mesh` is a (data, axis2) grid of those ranks with one process
group per line of each axis, made by ``torch.distributed.new_group``;
``parallel/collectives.py`` runs the collectives over them.

This is a mesh of its own, not ``torch.distributed.device_mesh``:
``init_device_mesh("cuda", ...)`` picks NCCL and one device per rank,
which does not fit ranks that share one card (NCCL refuses two ranks on
one GPU, so they talk over gloo), and the serving engine needs no more
than a grid, its groups and this rank's place in it. Each rank's device
is the caller's (``device``); the groups take the default group's
backend, so a world initialized with ``backend="nccl"`` runs unchanged.

A mesh of one rank needs no process group and makes none: the default
``ShardingConfig()`` engine is a world of one whether or not a group
exists. A mesh of more ranks raises when no process group is initialized.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Sequence

import numpy as np
import torch
import torch.distributed as dist

from storm_tpu_torch.device import resolve_device


class Mesh:
    """A grid of global ranks, ``ranks[i, j]`` at data index i and index j
    of the second axis, seen from one rank (``rank``, the calling
    process's unless given). ``shape`` maps each axis name to its size,
    as storm_tpu's ``mesh.shape`` does. ``groups`` maps an axis to the
    process group of this rank's line along it (None for an axis of size
    1, whose collectives are the identity); a mesh built without them
    (tests, describing another rank's shard) places parameters but runs no
    collective. ``whole``: the process group of every rank of the mesh
    (None for a mesh of one), over which its ``leader``, the rank at
    ``ranks[0, 0]``, broadcasts."""

    def __init__(self, ranks, axis_names: Sequence[str] = ("data", "model"), *,
                 rank: Optional[int] = None, device=None,
                 groups: Optional[Dict[str, object]] = None, whole=None) -> None:
        self.ranks = np.asarray(ranks, dtype=np.int64).reshape(len(ranks), -1)
        if len(axis_names) != 2:
            raise ValueError(f"a mesh has two axes, got names {tuple(axis_names)}")
        self.axis_names = tuple(axis_names)
        self.shape = dict(zip(self.axis_names, self.ranks.shape))
        self.size = int(self.ranks.size)
        if rank is None:
            rank = dist.get_rank() if dist.is_initialized() else int(self.ranks.flat[0])
        self.rank = int(rank)
        where = np.argwhere(self.ranks == self.rank)
        if len(where) != 1:
            raise ValueError(f"rank {self.rank} is not in the mesh {self.ranks.tolist()}")
        self._coords = dict(zip(self.axis_names, (int(c) for c in where[0])))
        self.device = torch.device(device) if device is not None else None
        self._groups = dict(groups or {})
        self.whole = whole
        self.leader = int(self.ranks.flat[0])

    def coord(self, axis: str) -> int:
        """This rank's index along ``axis``."""
        return self._coords[axis]

    def line(self, axis: str) -> List[int]:
        """The global ranks of this rank's line along ``axis``, in order."""
        i, j = self._coords[self.axis_names[0]], self._coords[self.axis_names[1]]
        line = self.ranks[:, j] if axis == self.axis_names[0] else self.ranks[i, :]
        return [int(r) for r in line]

    def group(self, axis: str):
        """The process group of this rank's line along ``axis``; None when
        the axis has one rank. Raises when the axis has more but the mesh
        was built without groups."""
        if self.shape[axis] == 1:
            return None
        if axis not in self._groups:
            raise RuntimeError(f"mesh axis {axis!r} has no process group (a mesh built "
                               f"without groups places parameters only)")
        return self._groups[axis]

    def __repr__(self) -> str:
        return (f"Mesh({self.shape}, rank={self.rank} at {self._coords}, "
                f"device={self.device})")


_NO_GROUP = ("a mesh of {} x {} ranks needs a process group: call "
             "torch.distributed.init_process_group first (a world of one is "
             "ShardingConfig())")


def _world_ranks() -> List[int]:
    if dist.is_initialized():
        return list(range(dist.get_world_size()))
    return [0]


def make_mesh(data_parallel: int = 0, tensor_parallel: int = 1,
              axis_names: Sequence[str] = ("data", "model"),
              ranks: Optional[Sequence[int]] = None, *, device=None) -> Mesh:
    """Build a (data, axis2) mesh over ``ranks`` (default: every rank of
    the process group, or this process alone without one), ``axis2`` of
    size ``tensor_parallel``. ``data_parallel=0`` means every remaining
    rank. storm_tpu's checks: the second axis divides the ranks and dp x
    axis2 does not exceed them; ranks past dp x axis2 are left out (they
    create the groups with the others, as ``new_group`` requires, and may
    not use the mesh). ``device``: this rank's device (default ``cuda``;
    pass ``"cpu"`` for the CPU).

    A mesh of more than one rank is a collective call, made by every rank
    of the world in the same order, and raises when no process group is
    initialized; a mesh of one makes no group."""
    dev = resolve_device(device)
    if tensor_parallel < 1:
        raise ValueError(f"tensor_parallel={tensor_parallel} must be >= 1")
    if ranks is None:
        if max(int(data_parallel), 1) * tensor_parallel > 1 and not dist.is_initialized():
            raise RuntimeError(_NO_GROUP.format(data_parallel or "all", tensor_parallel))
        ranks = _world_ranks()
        if data_parallel == 1 and tensor_parallel == 1:
            # One rank: this process alone, whatever the world.
            ranks = [dist.get_rank()] if dist.is_initialized() else [0]
    ranks = [int(r) for r in ranks]
    n = len(ranks)
    if n % tensor_parallel:
        raise ValueError(f"tensor_parallel={tensor_parallel} must divide rank count {n}")
    if data_parallel <= 0:
        data_parallel = n // tensor_parallel
    if data_parallel * tensor_parallel > n:
        raise ValueError(f"dp*tp = {data_parallel}*{tensor_parallel} exceeds {n} ranks")
    grid = np.array(ranks[:data_parallel * tensor_parallel]).reshape(
        data_parallel, tensor_parallel)
    groups, whole = {}, None
    if grid.size > 1:
        if not dist.is_initialized():
            raise RuntimeError(_NO_GROUP.format(data_parallel, tensor_parallel))
        me = dist.get_rank()
        # Every rank creates every group, in one order (new_group's rule).
        for axis, lines in ((axis_names[0], grid.T), (axis_names[1], grid)):
            if len(lines[0]) == 1:
                continue
            for line in lines:
                g = dist.new_group([int(r) for r in line])
                if me in line:
                    groups[axis] = g
        whole = dist.new_group([int(r) for r in grid.flat])
        if me not in grid:
            raise ValueError(f"rank {me} is not in the {data_parallel} x "
                             f"{tensor_parallel} mesh of ranks {grid.tolist()}")
    return Mesh(grid, axis_names, device=dev, groups=groups, whole=whole)


def default_mesh(device=None) -> Mesh:
    """Every rank on the data axis (pure DP)."""
    return make_mesh(device=device)
