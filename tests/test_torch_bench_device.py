"""The device bench's twin (``bench_device_torch.py``) against
``bench_device.py`` on the CPU: its configs, its FLOP count of the plain
route against XLA's ``cost_analysis()`` of storm_tpu's jitted forward, and
its rows' arithmetic against storm_tpu's given the same timings.

The gap found, at B = 8 (the port's count over XLA's): in float32 lenet5
+0.22 % (9,893,328 against 9,871,440) and vit_tiny +0.11 % (23,128,376
against 23,102,496); the conventions match (2·M·N·K a product, a
convolution's valid taps, one a pointwise element or cast, none a
transcendental, a reduction's input elements). In bfloat16 XLA's CPU
backend adds casts around every bf16 op it computes in f32 (1.77 M cast
elements for vit_tiny against the port's 0.54 M), so its count runs 3.5 %
(lenet5) and 5.3 % (vit_tiny) above the port's: a property of XLA's CPU
compiler, not of the model, so the 5 % bound is held in float32."""

from __future__ import annotations

import jax
import numpy as np
import pytest
import torch

import bench_device
import bench_device_torch as bd
from storm_tpu.config import BatchConfig, ModelConfig, ShardingConfig
from storm_tpu.infer.engine import InferenceEngine
from storm_tpu_torch.models import build_model

FLOP_TOL = 0.05


@pytest.mark.parametrize("name,shape", [("lenet5", (28, 28, 1)), ("vit_tiny", (32, 32, 3))])
def test_flops_match_xla_cost_analysis(name, shape):
    """storm_tpu's jitted forward on one device (``bench_device.build_fwd``
    spreads the batch over every device, and XLA then counts one
    device's share), counted by ``bench_device.cost_of``."""
    eng = InferenceEngine(ModelConfig(name=name, dtype="float32", input_shape=shape,
                                      num_classes=10),
                          ShardingConfig(data_parallel=1), BatchConfig(max_batch=8, buckets=(8,)))
    xd = jax.device_put(np.zeros((8, *shape), np.float32), eng._x_sharding)
    xla_flops, _ = bench_device.cost_of(eng, xd)
    model = build_model(name, device="cpu", dtype=torch.float32, num_classes=10,
                        input_shape=shape)
    cost = bd.plain_route_cost(model, torch.float32, 8, shape)
    assert xla_flops > 0
    assert abs(cost["flops"] - xla_flops) <= FLOP_TOL * xla_flops, (cost["flops"], xla_flops)
    params = sum(b.numel() * b.element_size() for b in model.buffers())
    assert cost["bytes"] > params  # the upper bound: parameters plus every op's I/O


@pytest.mark.parametrize("stride,padding,kernel", [(1, "SAME", 5), (2, "SAME", 3),
                                                   (1, "VALID", 5), (2, "VALID", 4)])
def test_convolution_counts_valid_taps_as_xla_does(stride, padding, kernel):
    """One convolution: the counter's taps inside the input against XLA's
    count of the same convolution (its padding contributes nothing)."""
    x = np.zeros((2, 13, 11, 3), np.float32)
    w = np.zeros((kernel, kernel, 3, 4), np.float32)
    f = jax.jit(lambda a, b: jax.lax.conv_general_dilated(
        a, b, (stride, stride), padding, dimension_numbers=("NHWC", "HWIO", "NHWC")))
    cost = f.lower(x, w).compile().cost_analysis()
    cost = cost[0] if isinstance(cost, (list, tuple)) else cost
    pad = [((kernel - 1) // 2 if padding == "SAME" else 0)] * 2
    out = torch.nn.functional.conv2d(torch.zeros(2, 3, 13, 11), torch.zeros(4, 3, kernel, kernel),
                                     stride=stride, padding=pad)
    if padding == "SAME":
        # XLA's SAME pads (k - 1) // 2 before and the rest after: the
        # same output size here (odd k, or an even k with stride 2's
        # output rounding) is asserted, not assumed
        assert out.shape[2:] == tuple(-(-d // stride) for d in (13, 11))
    counter = bd.CostCounter()
    with torch.no_grad(), counter:
        torch.nn.functional.conv2d(torch.zeros(2, 3, 13, 11, device="meta"),
                                   torch.zeros(4, 3, kernel, kernel, device="meta"),
                                   stride=stride, padding=pad)
    assert counter.flops == cost["flops"]


def test_configs_are_storm_tpus():
    assert bd.CONFIGS == bench_device.CONFIGS


def _storm_row(monkeypatch, per_step, flops, hbm, batch):
    monkeypatch.setattr(bench_device, "build_fwd", lambda cfg, weights="float": (None, None))
    monkeypatch.setattr(bench_device, "timed_device_loop", lambda eng, xd, iters=30: per_step)
    monkeypatch.setattr(bench_device, "cost_of", lambda eng, xd: (flops, hbm))
    return bench_device.bench_config("vit_b16", 30, batch=batch)


@pytest.mark.parametrize("per_step,flops,hbm,batch", [
    (0.0123, 1.1e12, 2.3e9, 64),    # compute-bound
    (0.0021, 3.4e10, 9.9e9, 8),     # memory-bound
    (0.5, 0.0, 0.0, 512),           # no count: the first fields only
])
def test_row_is_storm_tpus_arithmetic(monkeypatch, per_step, flops, hbm, batch):
    """storm_tpu's fields and arithmetic, but for the roofline: the port's
    counted bytes are an upper bound, so its roofline is the compute one
    and the bytes stand in a field that says so."""
    want = _storm_row(monkeypatch, per_step, flops, hbm, batch)
    got = bd.make_row("vit_b16", batch, per_step, flops, hbm, bench_device.PEAK_BF16_FLOPS)
    shared = ("config", "batch", "step_ms", "images_per_sec", "gflops_per_fwd",
              "achieved_tflops", "mfu_pct")
    assert {k: got[k] for k in shared} == {k: want[k] for k in shared}
    if flops:
        t = flops / bench_device.PEAK_BF16_FLOPS
        assert (got["bound"], got["roofline_ms"], got["pct_of_roofline"]) == (
            "compute", round(t * 1e3, 3), round(100 * t / per_step, 1))
        assert got["hbm_gbytes_upper_bound"] == want["hbm_gbytes_per_fwd"]
        assert set(got) == set(shared) | {"bound", "roofline_ms", "pct_of_roofline",
                                          "hbm_gbytes_upper_bound"}
    else:
        assert got == want


def test_row_uses_the_cards_peaks():
    row = bd.make_row("vit_b16", 64, 0.02, 2e12, 1e10)
    assert row["mfu_pct"] == round(100 * 2e12 / 0.02 / 989e12, 1)
    assert row["roofline_ms"] == round(2e12 / 989e12 * 1e3, 3)  # the compute roofline
    f32 = bd.make_row("vit_b16", 64, 0.02, 2e12, 1e10, bd.peak_flops("float32"))
    assert f32["mfu_pct"] == round(100 * 2e12 / 0.02 / 67e12, 1)


def test_measured_roofline_is_storm_tpus_arithmetic(monkeypatch):
    pts = {32: dict(t=0.0061, cost_bytes=3.1e9, param_bytes=1.7e8),
           64: dict(t=0.0113, cost_bytes=5.9e9, param_bytes=1.7e8)}

    class Eng:
        def __init__(self, b):
            self.b = b

        def param_bytes(self):
            return pts[self.b]["param_bytes"]

    monkeypatch.setattr(bench_device, "build_fwd",
                        lambda cfg, weights="float": (Eng(cfg["batch"]), cfg["batch"]))
    monkeypatch.setattr(bench_device, "timed_device_loop",
                        lambda eng, xd, iters=30: pts[xd]["t"])
    monkeypatch.setattr(bench_device, "cost_of", lambda eng, xd: (1.0, pts[xd]["cost_bytes"]))
    want = bench_device.measured_roofline("vit_b16", 30, 2.9e12)
    got = bd.roofline_row("vit_b16", pts, 2.9e12)
    assert {k: v for k, v in got.items() if k != "conclusion"} == \
        {k: v for k, v in want.items() if k != "conclusion"}


def test_the_bench_refuses_without_a_card(capsys):
    assert not torch.cuda.is_available()
    assert bd.main(["--config", "vit_b16"]) == 2
    assert "needs a CUDA card" in capsys.readouterr().err
