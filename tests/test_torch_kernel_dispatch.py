"""Which CUDA kernel each wrapper of storm_tpu_torch.ops launches, and the
premises the tensor-core kernels rest on, checked on the CPU.

The kernels themselves only run on the card (chip_smoke.py holds each
against its plain version there). Here the wrappers' dispatch runs for
real up to the launch, which is recorded instead of made: every bf16
ViT-B/16 shape must reach a tensor-core kernel (``*_sm90``) and every f32
call the f32 kernel, with the tile and load plan the kernel expects.
"""

import numpy as np
import pytest
import torch

from storm_tpu_torch.ops import _build, flash_attention as fa, quant_matmul as qm

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
    for mod in (qm, fa):
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


def test_shapes_and_types_no_kernel_takes_raise(launches):
    with pytest.raises(ValueError, match="D in"):
        fa.flash_attention(*(torch.zeros(1, 2, 8, 48, dtype=torch.bfloat16)
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
