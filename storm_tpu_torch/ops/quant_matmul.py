"""w8a16 dequant-matmul: ``x (..., K) @ (q (K, N) int8 * s (N,))``.

The counterpart of ``storm_tpu/ops/quant_matmul.py``. On a CUDA tensor the
product runs in one of two hand-written kernels, chosen by
:func:`kernel_variant`: bfloat16 activations (the serving path) go to the
tensor-core kernel ``csrc/w8a16_matmul_sm90.cu``, float32 activations to
the CUDA-core kernel ``csrc/w8a16_matmul.cu`` (on this card the tensor
cores multiply f32 only as TF32, which would break f32 parity). Both read
the weights as int8, accumulate in f32 and scale the accumulator per
output channel. On a CPU tensor it runs :func:`w8a16_matmul_reference`,
the same arithmetic in plain PyTorch. Any other device raises.

Not differentiable on the card: int8 weights are a serving mode, and the
kernels write their output outside autograd. Under grad mode a CUDA
input that requires grad is refused (a ``pallas_call`` under ``jax.grad``
fails too), never answered with an output cut from the graph.
"""

from __future__ import annotations

from typing import Optional

import torch

from storm_tpu_torch.ops._build import KERNELS, check_cuda, dtype_code, route

F32_VARIANT = "w8a16_matmul"
SM90_VARIANT = "w8a16_matmul_sm90"
# A block of the tensor-core kernel: 64 output channels (columns of out)
# per warpgroup, by a tile of tokens (rows of out).
SM90_TILE_M = (64, 128, 160)
SM_COUNT = 132  # streaming multiprocessors of an H100 SXM


def kernel_variant(dtype: torch.dtype) -> str:
    """The CUDA kernel that serves activations of ``dtype``: bfloat16 ->
    the tensor-core kernel (every shape), float32 -> the f32 kernel."""
    if dtype == torch.bfloat16:
        return SM90_VARIANT
    if dtype == torch.float32:
        return F32_VARIANT
    raise TypeError(f"w8a16_matmul kernels take float32 or bfloat16, got {dtype}")


def sm90_tile(m: int, n: int) -> tuple:
    """(warpgroups, tokens) of a tensor-core block for an (m, n) output.

    The kernel's time goes to feeding its tensor cores (blocks re-read x
    once per block column and q once per block row from L2), not to
    their rate, so blocks are as large as the grid allows: the token
    tile from SM90_TILE_M that pads m least (the larger on a tie), and
    two warpgroups (128 channels) where the grid of such blocks still
    gives every SM one, else one (64). At ViT-B/16's M = 1576 that is
    160 tokens (1600 rows): 1 warpgroup for N = 768 (120 blocks), 2 for
    N = 3072 (240 blocks)."""
    tile_m = min(SM90_TILE_M, key=lambda t: (-(-m // t) * t, -t))
    rows = -(-m // tile_m)
    wg = 2 if rows * -(-n // 128) >= SM_COUNT else 1
    return wg, tile_m


# Bit 2 of the tensor-core kernel's mode argument: an f32 output.
SM90_OUT_F32 = 4


def sm90_load_mode(k: int, n: int, x_ptr: int, q_ptr: int) -> int:
    """How the tensor-core kernel copies its tiles: 2 = x by TMA and q in
    16-byte asynchronous copies, 1 = x by TMA and q in 8-byte copies (the
    ViT head: 1000-byte int8 rows are only 8-byte aligned), 0 = element
    loads (any ragged shape; TMA needs x's rows 16-byte aligned)."""
    if k % 8 == 0 and x_ptr % 16 == 0:
        if n % 16 == 0 and q_ptr % 16 == 0:
            return 2
        if n % 8 == 0 and q_ptr % 8 == 0:
            return 1
    return 0


def w8a16_matmul_reference(x: torch.Tensor, q: torch.Tensor, s: torch.Tensor,
                           out_dtype: Optional[torch.dtype] = None) -> torch.Tensor:
    """Plain version: f32 product of the int8 weights, times the f32
    scale on the accumulator, cast to ``out_dtype`` (default x.dtype)."""
    acc = torch.matmul(x.float(), q.float())
    return (acc * s.float()).to(out_dtype or x.dtype)


def _check(x: torch.Tensor, q: torch.Tensor, s: torch.Tensor) -> None:
    if q.dtype != torch.int8 or q.dim() != 2:
        raise TypeError(f"q must be a 2-D int8 tensor, got {q.dtype} {tuple(q.shape)}")
    k, n = q.shape
    if x.shape[-1] != k:
        raise ValueError(f"contraction mismatch: x K={x.shape[-1]}, q K={k}")
    if s.shape != (n,) or s.dtype != torch.float32:
        raise ValueError(f"s must be float32 of shape ({n},), got "
                         f"{s.dtype} {tuple(s.shape)}")


def w8a16_matmul(x: torch.Tensor, q: torch.Tensor, s: torch.Tensor,
                 variant: Optional[str] = None,
                 out_dtype: Optional[torch.dtype] = None) -> torch.Tensor:
    """``(x @ q) * s`` in x.dtype; leading dims of x flatten to M.
    ``variant`` names the CUDA kernel to launch instead of the one
    :func:`kernel_variant` picks (for timing one against the other).
    ``out_dtype=torch.float32`` keeps the scaled f32 accumulator
    unrounded (a row-parallel partial product, summed across ranks
    before it is cast): the tensor-core kernel's f32 epilogue for bf16
    activations, the f32 kernel's own output for f32 ones."""
    _check(x, q, s)
    out_dtype = out_dtype or x.dtype
    if out_dtype not in (x.dtype, torch.float32):
        raise TypeError(f"w8a16_matmul writes x.dtype or float32, not {out_dtype}")
    if not route("w8a16_matmul", x, q, s):
        return w8a16_matmul_reference(x, q, s, out_dtype)
    if torch.is_grad_enabled() and any(t.requires_grad for t in (x, s)):
        raise RuntimeError(
            "w8a16_matmul has no gradient on the card: int8 weights serve, they "
            "do not train (train float weights, or run under torch.no_grad())")
    # The kernels read x as dense (M, K) rows: a strided view (the
    # mixer's transposed tokens) is copied once, never read with wrong
    # strides.
    x = x.contiguous()
    dev = check_cuda("w8a16_matmul", x, q, s)
    name = variant or kernel_variant(x.dtype)
    if name not in (SM90_VARIANT, F32_VARIANT):
        raise ValueError(f"unknown w8a16_matmul variant {name!r}")
    if name == SM90_VARIANT and x.dtype != torch.bfloat16:
        raise TypeError(f"{SM90_VARIANT} takes bfloat16, got {x.dtype}")
    if name == F32_VARIANT and out_dtype != x.dtype:
        raise TypeError(f"{F32_VARIANT} writes x.dtype ({x.dtype}), not {out_dtype}")
    k, n = q.shape
    x2 = x.reshape(-1, k)
    m = x2.shape[0]
    out = torch.empty((m, n), dtype=out_dtype, device=dev)
    if m and name == SM90_VARIANT:
        f32 = SM90_OUT_F32 if out_dtype == torch.float32 else 0
        KERNELS[name].launch(dev, x2, q, s, out, m, n, k, *sm90_tile(m, n),
                             sm90_load_mode(k, n, x2.data_ptr(), q.data_ptr()) | f32)
    elif m:
        KERNELS[name].launch(dev, dtype_code(x), x2, q, s, out, m, n, k)
    return out.reshape(*x.shape[:-1], n)


def qdense(p: dict, x: torch.Tensor) -> torch.Tensor:
    """Dense layer over quantized weights ``{"w": {"__q", "__s"}, "b"}``
    (the ``quantize_params`` leaf format); the bias is added after the
    cast, in x.dtype."""
    w = p["w"]
    return w8a16_matmul(x, w["__q"], w["__s"]) + p["b"]
