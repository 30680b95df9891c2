"""The port's kernel modules (storm_tpu_torch.ops) against the JAX package's
Pallas kernels, run as storm_tpu's own tests run them on the CPU (the
Pallas interpreter). On CPU tensors the port's wrappers take their plain
PyTorch versions, so these tests hold the kernels' arithmetic to the TPU
kernels'; the CUDA kernels themselves are held to the same plain versions
on the card by chip_smoke.py.

Inputs are made from a numpy seed and handed to both sides. Tolerances:
relative to the reference's largest magnitude for the products (f32: 1e-5;
bf16: one rounding step of the output, 1e-2 for attention and 2e-2 for the
matmul, as ops/parity_checks.py states them), absolute for the norm (1e-5
on the residual sum, 1e-4 on the normed output).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from storm_tpu.infer.engine import quantize_params as jax_quantize_params
from storm_tpu.ops.flash_attention import flash_attention as jax_flash_attention
from storm_tpu.ops.fused_norm import _fused_fwd_pallas
from storm_tpu.ops.quant_matmul import w8a16_matmul as jax_w8a16_matmul
from storm_tpu_torch.device import resolve_device
from storm_tpu_torch.ops.attention import attention_reference, multi_head_attention
from storm_tpu_torch.ops.flash_attention import flash_attention
from storm_tpu_torch.ops.fused_norm import fused_add_layernorm, residual_layernorm
from storm_tpu_torch.ops.quant_matmul import w8a16_matmul

DTYPES = {"float32": (jnp.float32, torch.float32),
          "bfloat16": (jnp.bfloat16, torch.bfloat16)}


def _rel(got: np.ndarray, want: np.ndarray) -> float:
    return float(np.abs(got - want).max() / np.abs(want).max())


def _np32(a) -> np.ndarray:
    if isinstance(a, torch.Tensor):
        return a.float().numpy()
    return np.asarray(jnp.asarray(a).astype(jnp.float32))


@pytest.mark.parametrize("shape,dtype,tol", [
    ((1, 2, 128, 64), "float32", 1e-5),
    ((2, 2, 197, 16), "float32", 1e-5),   # padded S, D = 16 (vit_tiny)
    ((1, 2, 197, 64), "bfloat16", 1e-2),  # the ViT-B/16 sequence
    # bf16 at the shapes chip_smoke.py runs the tensor-core kernel at:
    ((1, 1, 600, 64), "bfloat16", 1e-2),   # S600 padded, several key tiles
    ((2, 2, 197, 16), "bfloat16", 1e-2),   # D = 16
    ((1, 2, 100, 32), "bfloat16", 1e-2),   # D = 32, one ragged key tile
    ((1, 1, 130, 128), "bfloat16", 1e-2),  # D = 128 (chip_smoke.py: at S = 4096)
])
def test_flash_attention_matches_pallas_interpret(shape, dtype, tol):
    jdt, tdt = DTYPES[dtype]
    rng = np.random.RandomState(0)
    q, k, v = (rng.randn(*shape).astype(np.float32) for _ in range(3))
    want = jax_flash_attention(*(jnp.asarray(a, jdt) for a in (q, k, v)),
                               interpret=True)
    got = flash_attention(*(torch.from_numpy(a).to(tdt) for a in (q, k, v)))
    assert got.dtype == tdt and got.shape == shape
    assert _rel(_np32(got), _np32(want)) <= tol


def test_flash_plain_version_matches_textbook_attention():
    rng = np.random.RandomState(1)
    q, k, v = (torch.from_numpy(rng.randn(2, 3, 50, 32).astype(np.float32))
               for _ in range(3))
    assert _rel(flash_attention(q, k, v).numpy(),
                attention_reference(q, k, v).numpy()) <= 1e-5


@pytest.mark.parametrize("rows,d", [(6, 64), (300, 100), (5, 768)])
def test_fused_norm_matches_pallas_interpret(rows, d):
    rng = np.random.RandomState(0)
    x, r = rng.randn(rows, d).astype(np.float32), rng.randn(rows, d).astype(np.float32)
    g, b = rng.randn(d).astype(np.float32), rng.randn(d).astype(np.float32)
    wy, wo = _fused_fwd_pallas(*(jnp.asarray(a) for a in (x, r, g, b)),
                               eps=1e-6, interpret=True)
    gy, go = fused_add_layernorm(*(torch.from_numpy(a) for a in (x, r, g, b)))
    np.testing.assert_allclose(gy.numpy(), np.asarray(wy), rtol=0, atol=1e-5)
    np.testing.assert_allclose(go.numpy(), np.asarray(wo), rtol=0, atol=1e-4)


def test_residual_layernorm_keeps_the_residual_stream():
    """``residual_layernorm(p, branch, x)`` returns (x + branch, LN(x +
    branch)) in x's shape, the argument order of the TPU module."""
    rng = np.random.RandomState(2)
    x, br = (torch.from_numpy(rng.randn(2, 5, 16).astype(np.float32)) for _ in range(2))
    p = {"scale": torch.ones(16), "bias": torch.zeros(16)}
    y, out = residual_layernorm(p, br, x)
    assert y.shape == out.shape == x.shape
    torch.testing.assert_close(y, x + br, rtol=0, atol=0)
    torch.testing.assert_close(out.mean(-1), torch.zeros(2, 5), rtol=0, atol=1e-5)


@pytest.mark.parametrize("xshape,k,n,dtype,tol", [
    ((4, 64), 64, 128, "float32", 1e-5),       # exact tiles
    ((5, 100), 100, 70, "float32", 1e-5),      # every axis ragged
    ((2, 9, 48), 48, 200, "float32", 1e-5),    # 3-D token activations
    ((1, 700), 700, 10, "float32", 1e-5),      # K over several chunks
    ((64, 768), 768, 3072, "bfloat16", 2e-2),  # the serving dtype
    # bf16 at the ragged shapes chip_smoke.py runs the tensor-core kernel at:
    ((5, 100), 100, 70, "bfloat16", 2e-2),     # element loads (mode 0)
    ((2, 9, 48), 48, 200, "bfloat16", 2e-2),   # 8-byte weight copies (mode 1)
    ((1, 700), 700, 10, "bfloat16", 2e-2),     # K over several tiles, N < 16
    ((8, 768), 768, 1000, "bfloat16", 2e-2),   # the ViT-B/16 head
])
def test_w8a16_matmul_matches_pallas_interpret(xshape, k, n, dtype, tol):
    jdt, tdt = DTYPES[dtype]
    rng = np.random.RandomState(0)
    x = rng.randn(*xshape).astype(np.float32)
    qleaf = jax_quantize_params({"w": rng.randn(k, n).astype(np.float32)})["w"]
    q, s = np.asarray(qleaf["__q"]), np.asarray(qleaf["__s"])
    want = jax_w8a16_matmul(jnp.asarray(x, jdt), jnp.asarray(q), jnp.asarray(s),
                            interpret=True)
    got = w8a16_matmul(torch.from_numpy(x).to(tdt), torch.from_numpy(q),
                       torch.from_numpy(s))
    assert got.dtype == tdt and got.shape == (*xshape[:-1], n)
    assert _rel(_np32(got), _np32(want)) <= tol


def test_multi_head_attention_shapes():
    rng = np.random.RandomState(3)

    def dense(c):
        return {"w": torch.from_numpy(rng.randn(c, c).astype(np.float32) / 8),
                "b": torch.zeros(c)}

    p = {n: dense(32) for n in "qkvo"}
    x = torch.from_numpy(rng.randn(2, 10, 32).astype(np.float32))
    assert multi_head_attention(p, x, 4).shape == (2, 10, 32)


def test_wrappers_refuse_tensors_off_cpu_and_cuda():
    x = torch.empty(4, 8, device="meta")
    q = torch.empty(8, 3, dtype=torch.int8, device="meta")
    s = torch.empty(3, device="meta")
    with pytest.raises(ValueError, match="CPU or all on one CUDA"):
        w8a16_matmul(x, q, s)
    with pytest.raises(ValueError, match="CPU or all on one CUDA"):
        w8a16_matmul(torch.zeros(4, 8), q, s)  # mixed devices
    with pytest.raises(ValueError, match="cuda or cpu"):
        resolve_device("meta")


def test_cuda_tensor_without_a_card_raises():
    """On a machine with no card, a CUDA tensor reaches the kernel path
    (never the plain version) and raises there: no kernel can be built or
    launched. Fake CUDA tensors stand in, as no real one can exist here."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present; chip_smoke.py covers the kernels")
    from torch._subclasses.fake_tensor import FakeTensorMode

    with pytest.raises(RuntimeError, match="no CUDA device"):
        resolve_device()
    with FakeTensorMode():
        x = torch.empty(4, 8, device="cuda")
        q = torch.empty(8, 3, dtype=torch.int8, device="cuda")
        s = torch.empty(3, device="cuda")
        qq, kk, vv = (torch.empty(1, 2, 5, 16, device="cuda") for _ in range(3))
        g = torch.empty(8, device="cuda")
        for call in (lambda: w8a16_matmul(x, q, s),
                     lambda: flash_attention(qq, kk, vv),
                     lambda: fused_add_layernorm(x, x, g, g)):
            with pytest.raises(RuntimeError):
                call()
