"""The port's graft entry point ``entry()`` (``__graft_entry_torch__.py``)
against storm_tpu's (``__graft_entry__.py``) on the CPU: the port's ViT-B/16
forward, given storm_tpu's ``entry()`` parameters carried across by the
port's converter, against storm_tpu's ``fwd`` at B = 2 (seeded inputs),
within 1e-4 absolute on the float32 probabilities; its arguments laid out
as storm_tpu's; both entry points refusing without a card. The dry run's
comparisons are in ``tests/test_torch_graft_dryrun.py``: together the two
took 24-26 s alone, above a file's 25 s budget.

The port's ``entry()`` (seconds of seeded numpy initialization) runs in a
thread while storm_tpu's builds its parameters, joined with a timeout."""

from __future__ import annotations

import concurrent.futures

import jax
import numpy as np
import pytest
import torch

import __graft_entry__ as jax_graft
import __graft_entry_torch__ as graft

PROB_ATOL = 1e-4
JOIN_S = 180.0


def test_entry_matches_storm_tpu():
    with concurrent.futures.ThreadPoolExecutor(1) as pool:
        port = pool.submit(graft.entry, "cpu")
        jfwd, (jparams, jx) = jax_graft.entry()
        fwd, (params, x) = port.result(timeout=JOIN_S)
    assert x.shape == jx.shape == (8, 224, 224, 3) and not x.any()
    jleaves = jax.tree_util.tree_flatten_with_path(jparams)[0]
    pleaves = {jax.tree_util.keystr(p): v for p, v in
               jax.tree_util.tree_flatten_with_path(params)[0]}
    assert {jax.tree_util.keystr(p): tuple(v.shape) for p, v in jleaves} == \
        {k: tuple(v.shape) for k, v in pleaves.items()}
    assert all(v.device.type == "cpu" and v.dtype == torch.float32 for v in pleaves.values())
    xs = np.random.RandomState(0).rand(2, 224, 224, 3).astype(np.float32)
    want = np.asarray(jfwd(jparams, xs))
    got = fwd(graft.params_on(jax.tree.map(np.asarray, jparams), "cpu"), xs)
    assert got.dtype == torch.float32 and got.shape == (2, 1000)
    assert np.abs(got.numpy() - want).max() <= PROB_ATOL


def test_without_a_card_both_refuse():
    assert not torch.cuda.is_available()
    with pytest.raises(RuntimeError, match="no CUDA device"):
        graft.entry()
    with pytest.raises(RuntimeError, match="no CUDA device"):
        graft.dryrun_multichip(4)
