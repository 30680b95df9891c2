"""Fused residual add + LayerNorm: ``y = x + branch; out = LN(y)``.

The counterpart of ``storm_tpu/ops/fused_norm.py``. On a CUDA tensor it
runs the hand-written kernel ``csrc/fused_norm_sm90.cu`` (always: the
TPU's opt-in switch has no counterpart here), one launch per call, with
the launch plan of :func:`norm_plan`; the first version,
``csrc/fused_norm.cu``, runs only when named (for timing one against the
other). On a CPU tensor it runs :func:`fused_add_layernorm_reference`, the
kernels' arithmetic in plain PyTorch.

Training: :func:`residual_layernorm` goes through an autograd function,
the counterpart of the TPU path's ``jax.custom_vjp`` (``_fused``). Its
forward is :func:`fused_add_layernorm` (the kernel on a CUDA tensor),
whose outputs the kernel writes outside autograd; its backward is
autograd of :func:`fused_add_layernorm_reference`, recomputed from the
saved inputs, as ``_fused_bwd`` is ``jax.vjp`` of the unfused reference.
There is no backward kernel, as the TPU path has none.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch

from storm_tpu_torch.ops._build import KERNELS, check_cuda, dtype_code, route

SM90_VARIANT = "residual_layernorm_sm90"
FIRST_VARIANT = "residual_layernorm"
# Widest row either kernel takes: the first version keeps the row in 48 KB
# of shared memory, the sm90 kernel's runtime-d plan in 256 lanes.
MAX_DIM = 12288
# Elements in one 16-byte vector, the sm90 kernel's unit of load and store.
VEC = {torch.bfloat16: 8, torch.float32: 4}
# (lanes per row, vectors per lane) of the sm90 kernel's instantiations for
# the widths the model zoo normalises (vit_b16 and moe_vit_b16 768,
# mixer_s16 512, longseq_encoder 256, vit_tiny and mixer_tiny 64): one
# warp or part of one per row, the row exactly covered. Mirrored in
# csrc/fused_norm_sm90.cu.
NORM_PLANS = {
    (torch.bfloat16, 768): (32, 3), (torch.bfloat16, 512): (32, 2),
    (torch.bfloat16, 256): (32, 1), (torch.bfloat16, 64): (8, 1),
    (torch.float32, 768): (32, 6), (torch.float32, 512): (32, 4),
    (torch.float32, 256): (32, 2), (torch.float32, 64): (16, 1),
}
# Vectors per lane of the runtime-d instantiation, which takes every other
# width: 48 elements a lane, in as many whole warps as the row needs (one
# block per row; up to 1536 columns in one warp, MAX_DIM in 8 warps).
RUNTIME_VECTORS = {torch.bfloat16: 6, torch.float32: 12}
# Threads of a block of the zoo plans: rows per block = THREADS // lanes.
THREADS = 128


def norm_plan(d: int, dtype: torch.dtype, x_ptr: int, r_ptr: int) -> tuple:
    """``(lanes_per_row, vectors_per_lane, load_mode, rows_per_block)`` of
    the sm90 kernel for rows of ``d`` elements of ``dtype``.

    A zoo width takes its instantiation from NORM_PLANS, THREADS // lanes
    rows to a block; any other width the runtime-d one, in the fewest
    whole warps that hold the row, one row to a block. load_mode 1 moves
    16-byte vectors, which needs d a multiple of the vector and x and r
    16-byte aligned (the kernel allocates y and out itself); 0 moves one
    element at a time (a ragged width, an offset view)."""
    vec = VEC[dtype]
    plan = NORM_PLANS.get((dtype, d))
    if plan is not None:
        lanes, vectors = plan
        rows_per_block = THREADS // lanes
    else:
        vectors = RUNTIME_VECTORS[dtype]
        lanes = 32 * max(1, -(-d // (32 * vectors * vec)))
        rows_per_block = 1
    mode = int(d % vec == 0 and x_ptr % 16 == 0 and r_ptr % 16 == 0)
    return lanes, vectors, mode, rows_per_block


def fused_add_layernorm_reference(x2: torch.Tensor, r2: torch.Tensor,
                                  g: torch.Tensor, b: torch.Tensor,
                                  eps: float) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain version over (rows, d): the sum and its statistics in f32
    (two-pass mean and variance), both outputs cast to the input dtype."""
    y = x2.float() + r2.float()
    mean = y.mean(dim=-1, keepdim=True)
    var = (y - mean).square().mean(dim=-1, keepdim=True)
    normed = (y - mean) * torch.rsqrt(var + eps) * g.float() + b.float()
    return y.to(x2.dtype), normed.to(x2.dtype)


def fused_add_layernorm(x2: torch.Tensor, r2: torch.Tensor, g: torch.Tensor,
                        b: torch.Tensor, eps: float = 1e-6,
                        variant: Optional[str] = None
                        ) -> Tuple[torch.Tensor, torch.Tensor]:
    """``(x2 + r2, LN_{g,b}(x2 + r2))`` over (rows, d) inputs of one dtype;
    g and b, of one dtype (bf16 or f32) and contiguous, go to the kernel as
    they are. ``variant`` names the first version (``residual_layernorm``,
    which reads g and b as f32) instead of the sm90 kernel."""
    if x2.dim() != 2 or x2.shape != r2.shape or x2.dtype != r2.dtype:
        raise ValueError(f"x and r must be 2-D of one shape and dtype, got "
                         f"{tuple(x2.shape)} {x2.dtype} and "
                         f"{tuple(r2.shape)} {r2.dtype}")
    rows, d = x2.shape
    if g.shape != (d,) or b.shape != (d,):
        raise ValueError(f"scale and bias must be ({d},)")
    if g.dtype != b.dtype:
        raise TypeError(f"scale and bias must be of one dtype, got {g.dtype} and {b.dtype}")
    if not route(FIRST_VARIANT, x2, r2, g, b):
        return fused_add_layernorm_reference(x2, r2, g, b, eps)
    name = variant or SM90_VARIANT
    if name not in (SM90_VARIANT, FIRST_VARIANT):
        raise ValueError(f"unknown fused norm variant {name!r}")
    if d > MAX_DIM:
        raise ValueError(f"{name} kernel takes d <= {MAX_DIM}, got {d}")
    # The kernels read dense rows of d elements: a strided view is copied
    # once, never read with wrong strides.
    x2, r2 = x2.contiguous(), r2.contiguous()
    dev = check_cuda(name, x2, r2, g, b)
    code = dtype_code(x2)
    y = torch.empty_like(x2)
    out = torch.empty_like(x2)
    if rows and name == SM90_VARIANT:
        KERNELS[name].launch(dev, code, dtype_code(g), x2, r2, g, b, y, out, rows, d,
                             float(eps), *norm_plan(d, x2.dtype, x2.data_ptr(),
                                                    r2.data_ptr()))
    elif rows:
        KERNELS[name].launch(dev, code, x2, r2, g.float(), b.float(), y, out, rows, d,
                             float(eps))
    return y, out


class FusedAddLayerNorm(torch.autograd.Function):
    """:func:`fused_add_layernorm` with the gradient of its plain version:
    gradients reach x, r, scale and bias."""

    @staticmethod
    def forward(ctx, x2, r2, g, b, eps):
        ctx.save_for_backward(x2, r2, g, b)
        ctx.eps = eps
        return fused_add_layernorm(x2, r2, g, b, eps)

    @staticmethod
    def backward(ctx, dy, dout):
        inputs = [t.detach().requires_grad_(need)
                  for t, need in zip(ctx.saved_tensors, ctx.needs_input_grad)]
        wanted = [t for t in inputs if t.requires_grad]
        with torch.enable_grad():
            outs = fused_add_layernorm_reference(*inputs, ctx.eps)
            grads = iter(torch.autograd.grad(outs, wanted, (dy, dout)))
        return (*(next(grads) if t.requires_grad else None for t in inputs), None)


def residual_layernorm(p: dict, branch: torch.Tensor, x: torch.Tensor,
                       eps: float = 1e-6) -> Tuple[torch.Tensor, torch.Tensor]:
    """``y = x + branch; out = LayerNorm_p(y)``; returns ``(y, out)`` so
    the caller keeps the residual stream. ``p`` is ``{"scale", "bias"}``.
    As in the TPU kernel, the kernel's ``x`` is the branch and its ``r``
    the residual stream. Differentiable (:class:`FusedAddLayerNorm`)."""
    d = x.shape[-1]
    y, out = FusedAddLayerNorm.apply(branch.reshape(-1, d), x.reshape(-1, d),
                                     p["scale"], p["bias"], eps)
    return y.reshape(x.shape), out.reshape(x.shape)
