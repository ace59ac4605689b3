"""Device resolution (counterpart of
``tensorflowdistributedlearning_tpu/utils/devices.py``).

Entry points run on CUDA unless the caller asks for the CPU. With
``device=None`` and no CUDA they raise: the port never falls back to the CPU
without a word. Under a process group ``None`` is the rank's own GPU.
"""

from __future__ import annotations

from typing import List, Optional, Union

import torch

from tensorflowdistributedlearning_tpu_torch.parallel import collectives, multihost

DeviceLike = Union[str, torch.device, None]


def resolve_device(device: DeviceLike = None) -> torch.device:
    """``None`` means ``cuda`` (and raises without a CUDA device), the rank's
    ``cuda:{LOCAL_RANK}`` under a process group; anything else is taken as
    given, and a CUDA device that does not exist raises."""
    if device is None:
        if collectives.is_initialized():
            return multihost.local_device()
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



def get_available_devices(platform: Optional[str] = None) -> List[str]:
    """Device name strings, ``['CUDA:0', ...]`` for the cards this process
    sees and ``['CPU:0']`` for the host, the JAX package's
    ``get_available_devices`` form (``{PLATFORM}:{id}``). ``platform``
    (``'cuda'``/``'gpu'`` or ``'cpu'``) filters; without it the cards come
    first and the CPU only when there is no card, as JAX lists its default
    backend's devices."""
    cuda = [f"CUDA:{i}" for i in range(torch.cuda.device_count())] if torch.cuda.is_available() else []
    if platform is None:
        return cuda or ["CPU:0"]
    platform = platform.lower()
    if platform in ("cuda", "gpu"):
        return cuda
    if platform == "cpu":
        return ["CPU:0"]
    raise ValueError(f"unknown platform {platform!r}: 'cuda' (or 'gpu') or 'cpu'")
