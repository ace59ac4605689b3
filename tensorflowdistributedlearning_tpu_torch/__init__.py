"""PyTorch + CUDA port of ``tensorflowdistributedlearning_tpu`` for NVIDIA
Hopper (H100). The JAX package stays the reference; this package mirrors its
layout module for module and never imports it (or JAX). Entry points run on
CUDA unless the caller passes ``device="cpu"``; the hand-written kernels
(``csrc/``, ``ops/kernels.py``) run on CUDA tensors and their plain PyTorch
versions on CPU tensors."""

import importlib.util as _ilu

from tensorflowdistributedlearning_tpu_torch.config import ModelConfig, TrainConfig

__version__ = "0.1.0"


def __getattr__(name):
    # lazy, as in the JAX package: the trainer pulls in the model and data
    # stack
    if name == "Model" and _ilu.find_spec("tensorflowdistributedlearning_tpu_torch.train.trainer"):
        from tensorflowdistributedlearning_tpu_torch.train.trainer import Model

        return Model
    raise AttributeError(name)


__all__ = ["ModelConfig", "TrainConfig", "__version__"]
