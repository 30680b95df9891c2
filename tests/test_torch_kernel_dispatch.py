"""Which CUDA kernel each wrapper of storm_tpu_torch.ops launches, and the
premises the Hopper kernels rest on, checked on the CPU.

The kernels themselves only run on the card (chip_smoke.py holds each
against its plain version there). Here the wrappers' dispatch runs for
real up to the launch, which is recorded instead of made: every bf16
ViT-B/16 shape must reach a tensor-core kernel (``*_sm90``) and every f32
call the f32 kernel, with the tile and load plan the kernel expects; every
fused norm reaches ``residual_layernorm_sm90`` in one launch, with the plan
of ``norm_plan``.
"""

import re

import numpy as np
import pytest
import torch
from torch.utils._python_dispatch import TorchDispatchMode

from storm_tpu_torch.ops import _build, flash_attention as fa, fused_norm as fn, quant_matmul as qm

SM = qm.SM_COUNT
M = 8 * 197  # ViT-B/16 tokens at batch 8
VIT_MATMULS = {  # name: (M, K, N)
    "qkvo": (M, 768, 768),
    "mlp_in": (M, 768, 3072),
    "mlp_out": (M, 3072, 768),
    "head": (8, 768, 1000),
}


@pytest.fixture
def launches(monkeypatch):
    """Run the wrappers' CUDA branch on CPU tensors and record each launch
    as (kernel name, arguments) instead of making it."""
    calls = []
    for mod in (qm, fa, fn):
        monkeypatch.setattr(mod, "route", lambda name, *t: True)
        monkeypatch.setattr(mod, "check_cuda", lambda name, *t: t[0].device)
    for name, kernel in _build.KERNELS.items():
        monkeypatch.setattr(kernel, "launch",
                            lambda dev, *args, _n=name: calls.append((_n, args)))
    return calls


@pytest.mark.parametrize("name", sorted(VIT_MATMULS))
def test_w8a16_bf16_vit_shapes_launch_the_tensor_core_kernel(launches, name):
    m, k, n = VIT_MATMULS[name]
    x = torch.zeros(m, k, dtype=torch.bfloat16)
    q = torch.zeros(k, n, dtype=torch.int8)
    s = torch.ones(n)
    assert qm.w8a16_matmul(x, q, s).shape == (m, n)
    assert [c[0] for c in launches] == ["w8a16_matmul_sm90"]
    args = launches[0][1]
    assert args[4:7] == (m, n, k)
    wg, tile_m, mode = args[7:]
    assert (wg, tile_m) == qm.sm90_tile(m, n)
    # The body's rows are 16-byte aligned; the head's 1000 int8 columns
    # only 8-byte aligned, so its weights take 8-byte copies.
    assert mode == (1 if name == "head" else 2)


@pytest.mark.parametrize("name", sorted(VIT_MATMULS))
def test_w8a16_f32_launches_the_f32_kernel(launches, name):
    m, k, n = VIT_MATMULS[name]
    qm.w8a16_matmul(torch.zeros(m, k), torch.zeros(k, n, dtype=torch.int8), torch.ones(n))
    assert [c[0] for c in launches] == ["w8a16_matmul"]
    assert launches[0][1][0] == _build.DTYPE_CODES[torch.float32]


@pytest.mark.parametrize("dtype,variant", [(torch.bfloat16, "flash_attention_sm90"),
                                           (torch.float32, "flash_attention")])
def test_flash_vit_shape_launches_by_dtype(launches, dtype, variant):
    q, k, v = (torch.zeros(8, 12, 197, 64, dtype=dtype) for _ in range(3))
    assert fa.flash_attention(q, k, v).shape == (8, 12, 197, 64)
    assert [c[0] for c in launches] == [variant]
    assert launches[0][1][-4:-1] == (8 * 12, 197, 64)


@pytest.mark.parametrize("dtype,variant", [(torch.bfloat16, "flash_attention_sm90"),
                                           (torch.float32, "flash_attention")])
@pytest.mark.parametrize("d,padded", [(8, 16), (24, 32), (48, 64), (96, 128), (128, 128)])
def test_flash_any_head_dim_launches_at_the_padded_dim(launches, dtype, variant, d, padded):
    """A head dim the kernels are not built for runs zero-padded to the
    next one, with the scale of the true D, and comes back at D."""
    q, k, v = (torch.zeros(2, 4, 64, d, dtype=dtype) for _ in range(3))
    out = fa.flash_attention(q, k, v)
    assert out.shape == (2, 4, 64, d) and out.dtype == dtype
    assert [c[0] for c in launches] == [variant]
    args = launches[0][1]
    assert args[-4:-1] == (2 * 4, 64, padded)
    assert args[-1] == pytest.approx(d ** -0.5)
    assert all(t.shape[-1] == padded for t in args if isinstance(t, torch.Tensor))


def test_shapes_and_types_no_kernel_takes_raise(launches):
    with pytest.raises(ValueError, match="head dims up to 128"):
        fa.flash_attention(*(torch.zeros(1, 2, 8, 160, dtype=torch.bfloat16)
                             for _ in range(3)))
    with pytest.raises(TypeError, match="float32 or bfloat16"):
        fa.flash_attention(*(torch.zeros(1, 2, 8, 64, dtype=torch.float16)
                             for _ in range(3)))
    with pytest.raises(TypeError, match="float32 or bfloat16"):
        qm.w8a16_matmul(torch.zeros(4, 8, dtype=torch.float16),
                        torch.zeros(8, 3, dtype=torch.int8), torch.ones(3))
    with pytest.raises(TypeError, match="takes bfloat16"):
        qm.w8a16_matmul(torch.zeros(4, 8), torch.zeros(8, 3, dtype=torch.int8),
                        torch.ones(3), variant=qm.SM90_VARIANT)
    assert launches == []


def test_load_mode_follows_alignment():
    """Ragged K (100, 700) cannot take 16-byte copies of x: the kernel then
    loads element by element (mode 0) rather than refusing the shape; N a
    multiple of 8 but not 16 (200, the head's 1000) copies q 8 bytes at a
    time (mode 1)."""
    for k, n, mode in [(100, 70, 0), (700, 10, 0), (100, 4100, 0), (768, 70, 0),
                       (48, 200, 1), (768, 1000, 1), (64, 128, 2), (3072, 768, 2)]:
        assert qm.sm90_load_mode(k, n, 0, 0) == mode, (k, n)
    assert qm.sm90_load_mode(768, 768, 8, 0) == 0  # x not 16-byte aligned
    assert qm.sm90_load_mode(768, 768, 0, 8) == 1  # q only 8-byte aligned


@pytest.mark.parametrize("name", sorted(VIT_MATMULS))
def test_tile_chooser_at_vit_shapes(name):
    """What sm90_tile promises: the token tile pads M least (1576 rows in
    10 tiles of 160, 1.5% padding; the head's 8 rows in one of 64), and
    the grid stays one wave of at most one block per SM for the N = 768
    products while using at least 90% of the 132 SMs (120 blocks); the
    N = 3072 product takes 128-channel blocks, 240 of them."""
    m, _, n = VIT_MATMULS[name]
    wg, tile_m = qm.sm90_tile(m, n)
    pad = -(-m // tile_m) * tile_m
    assert all(pad <= -(-m // t) * t for t in qm.SM90_TILE_M)
    blocks = -(-m // tile_m) * -(-n // (64 * wg))
    if name == "head":
        assert (wg, tile_m, blocks) == (1, 64, 16)
    elif n == 768:
        assert (wg, tile_m) == (1, 160) and 0.9 * SM <= blocks <= SM
    else:
        assert (wg, tile_m, blocks) == (2, 160, 240)


def test_int8_weights_are_exact_in_bf16():
    q = torch.arange(-127, 128, dtype=torch.int8)
    assert q.numel() == 255
    assert torch.equal(q.to(torch.bfloat16).to(torch.int8), q)
    assert torch.equal(q.to(torch.bfloat16).double(), q.double())


def test_kernel_int8_to_bf16_bit_trick_is_exact():
    """The conversion in csrc/w8a16_matmul_sm90.cu (int8_pair_to_bf16x2):
    bf16 bits 0x4300 | (b & 0x7f) minus bf16 bits 0x4300 | (b & 0x80) is
    the int8 value of byte b, for all 256 bytes, with one bf16 subtraction."""
    b = np.arange(256, dtype=np.uint16)
    mag = torch.from_numpy(((b & 0x7F) | 0x4300).astype(np.int16)).view(torch.bfloat16)
    sgn = torch.from_numpy(((b & 0x80) | 0x4300).astype(np.int16)).view(torch.bfloat16)
    got = mag - sgn
    assert got.dtype == torch.bfloat16
    want = torch.from_numpy(b.astype(np.uint8).view(np.int8).astype(np.float64))
    assert torch.equal(got.double(), want)


def test_bf16_products_are_exact_in_f32():
    """Every int8 weight times bf16 activations spread over many binades:
    the f32 product equals the f64 product, so the tensor cores' f32 sums
    differ from the plain version only in their order."""
    rng = np.random.RandomState(0)
    acts = torch.from_numpy((rng.randn(4096) * 2.0 ** rng.randint(-20, 20, 4096))
                            .astype(np.float32)).to(torch.bfloat16)
    w = torch.arange(-127, 128, dtype=torch.int8).to(torch.bfloat16)
    a2 = torch.cat([acts, acts.flip(0)[:255]])
    prod32 = a2[:, None].float() * torch.cat([w, acts[:255]])[None, :].float()
    prod64 = a2[:, None].double() * torch.cat([w, acts[:255]])[None, :].double()
    assert torch.equal(prod32.double(), prod64)


# ---- fused residual + LayerNorm ---------------------------------------------

NORM_WIDTHS = (64, 100, 256, 512, 768, 3072)
NORM_SOURCE = _build.CSRC / "fused_norm_sm90.cu"


def _norm_args(rows, d, dtype, param_dtype=torch.float32):
    x, r = torch.zeros(rows, d, dtype=dtype), torch.zeros(rows, d, dtype=dtype)
    return x, r, torch.ones(d, dtype=param_dtype), torch.zeros(d, dtype=param_dtype)


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("d", NORM_WIDTHS)
def test_fused_norm_launches_the_sm90_kernel_with_its_plan(launches, d, dtype):
    x, r, g, b = _norm_args(197, d, dtype)
    y, out = fn.fused_add_layernorm(x, r, g, b)
    assert y.shape == out.shape == (197, d) and y.dtype == out.dtype == dtype
    assert [c[0] for c in launches] == ["residual_layernorm_sm90"]
    args = launches[0][1]
    assert args[:2] == (_build.DTYPE_CODES[dtype], _build.DTYPE_CODES[torch.float32])
    assert args[8:11] == (197, d, 1e-6)
    plan = fn.norm_plan(d, dtype, x.data_ptr(), r.data_ptr())
    assert args[11:] == plan
    lanes, vectors, mode, rows_per_block = plan
    # Rows of the zoo take one warp or part of one; 16-byte vectors where
    # d is a whole number of them (all but bf16 100: 200-byte rows; CPU
    # allocations are 16-byte aligned).
    assert mode == (0 if (d, dtype) == (100, torch.bfloat16) else 1)
    if d in (64, 256, 512, 768):
        assert (lanes, vectors) == fn.NORM_PLANS[(dtype, d)]
        assert lanes <= 32 and lanes * vectors * fn.VEC[dtype] == d
        assert rows_per_block > 1
    else:
        assert vectors == fn.RUNTIME_VECTORS[dtype] and rows_per_block == 1
        assert lanes == (32 if d == 100 else 64)  # 3072: two warps of 1536


def test_fused_norm_offset_view_takes_element_loads(launches):
    """A contiguous view that starts one element into its storage is not
    16-byte aligned: the same kernel moves it one element at a time."""
    buf = torch.zeros(8 * 768 + 1, dtype=torch.bfloat16)
    x = buf[1:].view(8, 768)
    assert x.is_contiguous() and x.data_ptr() % 16
    r, g, b = torch.zeros(8, 768, dtype=torch.bfloat16), torch.ones(768), torch.zeros(768)
    fn.fused_add_layernorm(x, r, g, b)
    lanes, vectors, mode, _ = launches[0][1][11:]
    assert (lanes, vectors, mode) == (32, 3, 0)
    assert fn.norm_plan(768, torch.bfloat16, 0, 2)[2] == 0  # r misaligned alone


def test_fused_norm_first_version_launches_only_when_named(launches):
    x, r, g, b = _norm_args(16, 768, torch.bfloat16)
    fn.fused_add_layernorm(x, r, g, b)
    fn.residual_layernorm({"scale": g, "bias": b}, x.view(2, 8, 768), r.view(2, 8, 768))
    fn.fused_add_layernorm(x, r, g, b, variant="residual_layernorm")
    assert [c[0] for c in launches] == ["residual_layernorm_sm90"] * 2 + ["residual_layernorm"]
    assert launches[2][1][0] == _build.DTYPE_CODES[torch.bfloat16]
    with pytest.raises(ValueError, match="unknown fused norm variant"):
        fn.fused_add_layernorm(x, r, g, b, variant="layer_norm")


def test_fused_norm_refuses_what_no_kernel_takes(launches):
    with pytest.raises(ValueError, match=f"d <= {fn.MAX_DIM}"):
        fn.fused_add_layernorm(*_norm_args(2, fn.MAX_DIM + 8, torch.bfloat16))
    x, r, g, _ = _norm_args(4, 768, torch.bfloat16)
    with pytest.raises(TypeError, match="one dtype"):
        fn.fused_add_layernorm(x, r, g, torch.zeros(768, dtype=torch.bfloat16))
    with pytest.raises(TypeError, match="float32 or bfloat16"):
        fn.fused_add_layernorm(*_norm_args(4, 768, torch.float16))
    assert launches == []


class _Ops(TorchDispatchMode):
    def __init__(self):
        super().__init__()
        self.names = []

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        self.names.append(func.__name__)
        return func(*args, **(kwargs or {}))


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_fused_norm_one_launch_on_the_callers_own_scale_and_bias(launches, dtype):
    """The model's g and b are bf16: the kernel receives those very
    tensors, in their own dtype, and the wrapper runs no operation but
    the two output allocations, so one call is one launch."""
    x, r, g, b = _norm_args(1576, 768, torch.bfloat16, param_dtype=dtype)
    with _Ops() as ops:
        fn.fused_add_layernorm(x, r, g, b)
    assert [c[0] for c in launches] == ["residual_layernorm_sm90"]
    args = launches[0][1]
    assert args[1] == _build.DTYPE_CODES[dtype]
    assert args[4] is g and args[5] is b
    assert args[4].data_ptr() == g.data_ptr() and args[5].data_ptr() == b.data_ptr()
    assert all(name.startswith("empty_like") for name in ops.names), ops.names
    assert len(ops.names) == 2


def _source_instantiations():
    """(dtype, lanes, vectors) of each fixed instantiation in the kernel's
    C entry, and vectors per lane of each runtime-d one."""
    text = NORM_SOURCE.read_text()
    entry = text[text.index('extern "C" int residual_layernorm_sm90'):]
    bf16, f32 = entry.split("dtype == DTYPE_F32")
    fixed, runtime = set(), {}
    for dtype, part in ((torch.bfloat16, bf16), (torch.float32, f32)):
        for lanes, vectors in re.findall(r"lanes == (\d+) && vectors == (\d+)", part):
            fixed.add((dtype, int(lanes), int(vectors)))
        (vectors,) = re.findall(r"lanes % 32 == 0 && vectors == (\d+)", part)
        runtime[dtype] = int(vectors)
    return fixed, runtime


def test_norm_plans_mirror_the_kernel_source():
    fixed, runtime = _source_instantiations()
    assert runtime == fn.RUNTIME_VECTORS
    for (dtype, d), (lanes, vectors) in fn.NORM_PLANS.items():
        assert (dtype, lanes, vectors) in fixed, (dtype, d)


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_norm_plan_is_one_the_kernel_takes_at_every_width(dtype):
    """What the C entry checks before it launches, for every d up to
    MAX_DIM: whole warps of at most 256 threads, lanes * vectors covering
    the row, one row per block on the runtime-d plan, a one-warp row up to
    1536 columns (no barrier), and vector loads only on whole vectors."""
    fixed, runtime = _source_instantiations()
    vec = fn.VEC[dtype]
    for d in range(1, fn.MAX_DIM + 1):
        lanes, vectors, mode, rows_per_block = fn.norm_plan(d, dtype, 0, 0)
        threads = lanes * rows_per_block
        assert threads % 32 == 0 and 32 <= threads <= 256, d
        assert lanes * vectors * vec >= d, d
        assert (dtype, lanes, vectors) in fixed or (
            lanes % 32 == 0 and vectors == runtime[dtype] and rows_per_block == 1), d
        assert (lanes <= 32) == (d <= 32 * vectors * vec or d in (64, 256, 512, 768)), d
        assert mode == int(d % vec == 0), d
