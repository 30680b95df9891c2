"""Device resolution, the counterpart of ``storm_tpu/ops/platform.py``.

Every entry point of the port runs on the CUDA card unless its caller asks
for the CPU. There is no fallback: without a card, a caller that did not
ask for the CPU gets an error, never a silent CPU run.
"""

from __future__ import annotations

from typing import Optional, Union

import torch


def resolve_device(device: Optional[Union[str, torch.device]] = None) -> torch.device:
    """``None`` -> ``cuda`` (raises when no card is visible); ``"cpu"`` or a
    ``cuda[:n]`` device as given. Any other device type is refused."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cpu":
        return dev
    if dev.type != "cuda":
        raise ValueError(f"storm_tpu_torch runs on cuda or cpu, not {dev.type!r}")
    if not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device is available; pass device='cpu' to run the plain "
            "PyTorch versions on the CPU")
    return dev
