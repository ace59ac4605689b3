"""Device resolution (counterpart of
``tensorflowdistributedlearning_tpu/utils/devices.py``).

Entry points run on CUDA unless the caller asks for the CPU. With
``device=None`` and no CUDA they raise: the port never falls back to the CPU
without a word.
"""

from __future__ import annotations

from typing import Union

import torch

DeviceLike = Union[str, torch.device, None]


def resolve_device(device: DeviceLike = None) -> torch.device:
    """``None`` means ``cuda`` (and raises without a CUDA device); anything
    else is taken as given, and a CUDA device that does not exist raises."""
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError(
                "no CUDA device: the port runs on the GPU by default; pass "
                "device='cpu' to run the plain PyTorch versions on the CPU"
            )
        return torch.device("cuda")
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(f"device {device} requested but CUDA is not available")
    return device

