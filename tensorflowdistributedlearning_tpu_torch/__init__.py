"""PyTorch + CUDA port of ``tensorflowdistributedlearning_tpu`` for NVIDIA
Hopper (H100). The JAX package stays the reference; this package mirrors its
layout module for module and never imports it (or JAX). Entry points run on
CUDA unless the caller passes ``device="cpu"``; the hand-written kernels
(``csrc/``, ``ops/kernels.py``) run on CUDA tensors and their plain PyTorch
versions on CPU tensors."""

from tensorflowdistributedlearning_tpu_torch.config import ModelConfig

__all__ = ["ModelConfig"]
