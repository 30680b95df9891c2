"""The kernel parity runner's case table (``storm_tpu_torch/ops/
parity_checks.py``, ``cuda_kernel_parity.py``) against storm_tpu's
(``storm_tpu/ops/parity_checks.py``, ``tpu_kernel_parity.py``) on the CPU.

storm_tpu's checks run as its own tests run its kernels on the CPU: its
three Pallas kernels are swapped for its plain references (interpret mode
at S = 4096 takes minutes), which records the shape and dtype of each case
it checks; its rows then give the case names, dtypes, tolerance kinds and
bounds the port's rows must have. On the CPU the port's wrappers run
their plain versions, so ``run_all(device="cpu")`` holds the plain
versions' arithmetic, and, case by case on the same numpy inputs, the
port's plain versions are held to storm_tpu's references within the
module's bounds. The cases beyond storm_tpu's need the card (they check
which kernel variant launched); of them ``longseq_kernel_cases`` runs here
too, where each case checks that nothing launched."""

from __future__ import annotations

import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import cuda_kernel_parity
from storm_tpu.infer.engine import quantize_params as jax_quantize_params
from storm_tpu.ops import flash_attention as jax_flash
from storm_tpu.ops import fused_norm as jax_norm
from storm_tpu.ops import parity_checks as jax_checks
from storm_tpu.ops import quant_matmul as jax_qmm
from storm_tpu.ops.attention import attention_reference
from storm_tpu_torch.ops import _build, parity_checks
from storm_tpu_torch.ops import attention, fused_norm, quant_matmul
from storm_tpu_torch.ops.flash_attention import flash_attention_reference
from storm_tpu_torch.ops.fused_norm import fused_add_layernorm_reference
from storm_tpu_torch.ops.quant_matmul import w8a16_matmul_reference

ROW_KEYS = ("kernel", "case", "dtype", "metric", "tol")


@pytest.fixture(scope="module")
def storm_rows():
    """storm_tpu's ``run_all`` with its kernels swapped for its references:
    its rows, and the (kind, shape, dtype) of each kernel call it made."""
    calls = []

    def flash(q, k, v, interpret=False):
        calls.append(("flash", tuple(q.shape), jnp.dtype(q.dtype).name))
        return attention_reference(q, k, v)

    def norm(x, r, g, b, eps=1e-6, interpret=False):
        calls.append(("norm", tuple(x.shape), jnp.dtype(x.dtype).name))
        return jax_norm._reference(x, r, g, b, eps)

    def qmm(x, q, s, interpret=False):
        calls.append(("w8a16", (tuple(x.shape), *q.shape), jnp.dtype(x.dtype).name))
        return jnp.matmul(x.astype(jnp.float32), q.astype(jnp.float32) * s).astype(x.dtype)

    mp = pytest.MonkeyPatch()
    mp.setattr(jax_flash, "flash_attention", flash)
    mp.setattr(jax_norm, "_fused_fwd_pallas", norm)
    mp.setattr(jax_qmm, "w8a16_matmul", qmm)
    try:
        rows = jax_checks.run_all(interpret=True)
    finally:
        mp.undo()
    return rows, calls


@pytest.fixture(scope="module")
def port_rows():
    before = _build.launch_counts()
    rows = parity_checks.run_all("cpu")
    assert _build.launch_counts() == before  # the plain versions, no kernel
    return rows


def test_case_table_is_storm_tpus(storm_rows, port_rows):
    """Case names, dtypes, tolerance kinds and bounds row by row, and the
    shapes and dtypes of the calls behind them."""
    rows, calls = storm_rows
    assert [tuple(r[k] for k in ROW_KEYS) for r in port_rows] == \
        [tuple(r[k] for k in ROW_KEYS) for r in rows]
    assert set(port_rows[0]) == set(rows[0])  # storm_tpu's row fields
    flash = [c for c in calls if c[0] == "flash"]
    # storm_tpu calls each f32 flash case's kernel twice (@highest, @default)
    assert sorted(set(flash)) == sorted({("flash", s, d) for _c, s, d in
                                         parity_checks.FLASH_CASES})
    assert [c[1] for c in calls if c[0] == "norm"] == parity_checks.NORM_CASES
    w8 = []
    for c in calls:
        if c[0] == "w8a16" and c not in w8:
            w8.append(c)
    assert w8 == [("w8a16", (xs, k, n), dt)
                  for _c, xs, k, n, dt in parity_checks.W8A16_CASES]


def test_port_rows_pass_on_the_cpu(port_rows):
    assert len(port_rows) == 22
    assert all(r["pass"] for r in port_rows), [r for r in port_rows if not r["pass"]]


def test_inputs_are_storm_tpus_where_it_draws_from_numpy():
    """storm_tpu's fused-norm and w8a16 inputs come from ``RandomState(0)``:
    the port draws the same numbers, and quantizes w to the same bytes."""
    rng = np.random.RandomState(0)
    for arrays, (rows_n, d) in zip(parity_checks.norm_inputs(), parity_checks.NORM_CASES):
        want = [np.asarray(jnp.asarray(rng.randn(*s), jnp.float32))
                for s in ((rows_n, d), (rows_n, d), (d,), (d,))]
        assert all(np.array_equal(a, w) for a, w in zip(arrays, want))
    rng = np.random.RandomState(0)
    for (x, q, s), (_c, xs, k, n, _dt) in zip(parity_checks.w8a16_inputs(),
                                              parity_checks.W8A16_CASES):
        assert np.array_equal(x, np.asarray(jnp.asarray(rng.randn(*xs), jnp.float32)))
        qw = jax_quantize_params({"w": jnp.asarray(rng.randn(k, n), jnp.float32)})["w"]
        assert np.array_equal(q, np.asarray(qw["__q"]))
        assert np.array_equal(s, np.asarray(qw["__s"]))


def _f32_ref(fn, *arrays):
    with jax.default_matmul_precision("highest"):
        return np.asarray(fn(*(jnp.asarray(a) for a in arrays)), np.float32)


def _rel(got: np.ndarray, want: np.ndarray) -> float:
    return float(np.abs(got - want).max() / np.abs(want).max())


@pytest.mark.parametrize("case", ["S2048", "S2048_bf16", "S600_padded"])
def test_flash_plain_matches_storm_tpus_reference(case):
    _c, shape, dt = next(c for c in parity_checks.FLASH_CASES if c[0] == case)
    dtype = parity_checks.DTYPES[dt]
    q, k, v = (torch.from_numpy(parity_checks.flash_inputs(shape, i)).to(dtype)
               for i in range(3))
    got = flash_attention_reference(q, k, v).float().numpy()
    want = _f32_ref(attention_reference, *(t.float().numpy() for t in (q, k, v)))
    tol = parity_checks.FLASH_TOL[2] if dt == "bfloat16" else parity_checks.FLASH_TOL[0]
    assert _rel(got, want) <= tol


@pytest.mark.parametrize("index", range(len(parity_checks.NORM_CASES)))
def test_fused_norm_plain_matches_storm_tpus_reference(index):
    arrays = parity_checks.norm_inputs()[index]
    gy, go = fused_add_layernorm_reference(*(torch.from_numpy(a) for a in arrays),
                                           parity_checks.EPS)
    wy, wo = (np.asarray(t) for t in jax_norm._reference(
        *(jnp.asarray(a) for a in arrays), parity_checks.EPS))
    assert np.abs(gy.numpy() - wy).max() <= parity_checks.NORM_TOL[0]
    assert np.abs(go.numpy() - wo).max() <= parity_checks.NORM_TOL[1]


@pytest.mark.parametrize("index", range(len(parity_checks.W8A16_CASES)))
def test_w8a16_plain_matches_dequantize_then_dot(index):
    _c, _xs, _k, _n, dt = parity_checks.W8A16_CASES[index]
    x, q, s = parity_checks.w8a16_inputs()[index]
    xt = torch.from_numpy(x).to(parity_checks.DTYPES[dt])
    got = w8a16_matmul_reference(xt, torch.from_numpy(q), torch.from_numpy(s)).float().numpy()
    want = _f32_ref(lambda a, b, c: jnp.matmul(a, b.astype(jnp.float32) * c),
                    xt.float().numpy(), q, s)
    tol = parity_checks.W8A16_TOL[2] if dt == "bfloat16" else parity_checks.W8A16_TOL[0]
    assert _rel(got, want) <= tol


def test_longseq_cases_on_the_cpu():
    """The head dims the kernels are not built for and the d = 256 plans:
    on the CPU the plain versions, no launch, and D = 160 refused."""
    rows = []
    before = _build.launch_counts()
    parity_checks.longseq_kernel_cases(rows, "cpu")
    assert _build.launch_counts() == before
    assert len(rows) == 12 and all(r["pass"] for r in rows)
    assert set(rows[0]) == set(parity_checks._row("k", "c", "float32", torch.ones(1),
                                                  torch.ones(1), rel_tol=1.0))


def test_a_case_that_launches_is_refused_on_the_cpu():
    """``_launched`` holds the variant: on the CPU any launch fails the
    case, on the card anything but one launch of the named variant."""
    kernel = _build.KERNELS["flash_attention"]

    def launches():
        kernel.launches += 1

    try:
        with pytest.raises(AssertionError, match="expected launches"):
            parity_checks._launched(launches, "flash_attention", torch.device("cpu"))
    finally:
        kernel.launches -= 1


def test_plain_kernels_routes_the_wrappers():
    wrappers = (quant_matmul.w8a16_matmul, fused_norm.fused_add_layernorm,
                attention.flash_attention)
    with parity_checks.plain_kernels():
        assert quant_matmul.w8a16_matmul is w8a16_matmul_reference
        assert attention.flash_attention is flash_attention_reference
        x = torch.randn(3, 8)
        y, o = fused_norm.fused_add_layernorm(x, x, torch.ones(8), torch.zeros(8))
        wy, wo = fused_add_layernorm_reference(x, x, torch.ones(8), torch.zeros(8), 1e-6)
        assert torch.equal(y, wy) and torch.equal(o, wo)
    assert (quant_matmul.w8a16_matmul, fused_norm.fused_add_layernorm,
            attention.flash_attention) == wrappers


def test_runner_writes_the_artifact_on_the_cpu(tmp_path, capsys):
    out = tmp_path / "parity.json"
    assert cuda_kernel_parity.main(["--device", "cpu", "--out", str(out)]) == 0
    art = json.loads(out.read_text())
    assert art["platform"] == "cpu" and art["compiled"] is False
    assert art["device_kind"] == "cpu" and art["power_limit"] is None
    assert art["all_pass"] is True and len(art["results"]) == 22
    assert set(art) >= {"note", "wall_s", "results"}
    assert "PASS flash_attention" in capsys.readouterr().out


def test_runner_refuses_without_a_card(capsys):
    """No card here: without ``--device cpu`` the runner exits 2 and
    writes nothing."""
    assert not torch.cuda.is_available()
    assert cuda_kernel_parity.main(["--out", "-"]) == 2
    captured = capsys.readouterr()
    assert "needs a CUDA card" in captured.err and captured.out == ""
    assert cuda_kernel_parity.DEFAULT_OUT.startswith("build")
