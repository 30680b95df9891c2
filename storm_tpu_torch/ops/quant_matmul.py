"""w8a16 dequant-matmul: ``x (..., K) @ (q (K, N) int8 * s (N,))``.

The counterpart of ``storm_tpu/ops/quant_matmul.py``. On a CUDA tensor the
product runs in the hand-written kernel ``csrc/w8a16_matmul.cu``, which
reads the weights as int8, accumulates in f32 and scales the accumulator
per output channel; on a CPU tensor it runs :func:`w8a16_matmul_reference`,
the same arithmetic in plain PyTorch. Any other device raises.
"""

from __future__ import annotations

import torch

from storm_tpu_torch.ops._build import KERNELS, check_cuda, dtype_code, route

_KERNEL = KERNELS["w8a16_matmul"]


def w8a16_matmul_reference(x: torch.Tensor, q: torch.Tensor,
                           s: torch.Tensor) -> torch.Tensor:
    """Plain version: f32 product of the int8 weights, times the f32
    scale on the accumulator, cast to x.dtype."""
    acc = torch.matmul(x.float(), q.float())
    return (acc * s.float()).to(x.dtype)


def _check(x: torch.Tensor, q: torch.Tensor, s: torch.Tensor) -> None:
    if q.dtype != torch.int8 or q.dim() != 2:
        raise TypeError(f"q must be a 2-D int8 tensor, got {q.dtype} {tuple(q.shape)}")
    k, n = q.shape
    if x.shape[-1] != k:
        raise ValueError(f"contraction mismatch: x K={x.shape[-1]}, q K={k}")
    if s.shape != (n,) or s.dtype != torch.float32:
        raise ValueError(f"s must be float32 of shape ({n},), got "
                         f"{s.dtype} {tuple(s.shape)}")


def w8a16_matmul(x: torch.Tensor, q: torch.Tensor,
                 s: torch.Tensor) -> torch.Tensor:
    """``(x @ q) * s`` in x.dtype; leading dims of x flatten to M."""
    _check(x, q, s)
    if not route("w8a16_matmul", x, q, s):
        return w8a16_matmul_reference(x, q, s)
    dev = check_cuda("w8a16_matmul", x, q, s)
    code = dtype_code(x)
    k, n = q.shape
    x2 = x.reshape(-1, k)
    m = x2.shape[0]
    out = torch.empty((m, n), dtype=x.dtype, device=dev)
    if m:
        _KERNEL.launch(dev, code, x2, q, s, out, m, n, k)
    return out.reshape(*x.shape[:-1], n)


def qdense(p: dict, x: torch.Tensor) -> torch.Tensor:
    """Dense layer over quantized weights ``{"w": {"__q", "__s"}, "b"}``
    (the ``quantize_params`` leaf format); the bias is added after the
    cast, in x.dtype."""
    w = p["w"]
    return w8a16_matmul(x, w["__q"], w["__s"]) + p["b"]
