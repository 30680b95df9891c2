"""Device resolution, the counterpart of ``storm_tpu/ops/platform.py``.

Every entry point of the port runs on the CUDA card unless its caller asks
for the CPU. There is no fallback: without a card, a caller that did not
ask for the CPU gets an error, never a silent CPU run. Resolving a CUDA
device also fixes the process's matmul arithmetic (:func:`set_numeric_flags`).
"""

from __future__ import annotations

import subprocess
from typing import Optional, Union

import torch

# Published peaks of one H100 SXM at 700 W (NVIDIA's data sheet, dense):
# the root scripts' bounds are stated against these, beside the card's
# name and power limit (card_line).
PEAK_BF16_FLOPS = 989e12
PEAK_F32_FLOPS = 67e12  # outside the tensor cores
PEAK_HBM_BYTES_PER_S = 3.35e12


def card_line() -> str:
    """``name, power limit`` of the card, as ``nvidia-smi --query-gpu=
    name,power.limit --format=csv,noheader`` reports them."""
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60)
    lines = out.stdout.strip().splitlines()
    return lines[0] if lines else "unknown"


def set_numeric_flags() -> None:
    """The arithmetic storm_tpu declares (``jnp.dot(...,
    preferred_element_type=float32)``): no TF32 in float32 matmuls and
    convolutions, and bf16 GEMMs that accumulate in f32 — PyTorch's
    default lets cuBLAS reduce split-K partial sums in bf16, which
    ``ops/layers.py:dense`` must not get. Process-wide flags, set on
    every resolution of a CUDA device so that no entry point computes
    with other arithmetic than the one its tests hold."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction = False


def resolve_device(device: Optional[Union[str, torch.device]] = None) -> torch.device:
    """``None`` -> ``cuda`` (raises when no card is visible); ``"cpu"`` or a
    ``cuda[:n]`` device as given. Any other device type is refused. A CUDA
    device sets :func:`set_numeric_flags`."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cpu":
        return dev
    if dev.type != "cuda":
        raise ValueError(f"storm_tpu_torch runs on cuda or cpu, not {dev.type!r}")
    if not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device is available; pass device='cpu' to run the plain "
            "PyTorch versions on the CPU")
    set_numeric_flags()
    return dev
