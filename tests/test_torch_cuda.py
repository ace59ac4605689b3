"""The port's CUDA kernels against their plain PyTorch versions, on the card.

Every test here is marked ``cuda`` and skips with a reason where there is no
NVIDIA GPU (as on a CPU-only test box). The file imports no JAX, so it runs
on a GPU machine without the JAX package's test setup:

    python -m pytest --noconftest -p no:cacheprovider -m cuda tests/test_torch_cuda.py
"""

from __future__ import annotations

import pytest
import torch

from tensorflowdistributedlearning_tpu_torch.ops import kernels as tk


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernels are built by nvcc and run only on the card")
    tk.reset_launch_counts()
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("rate", [1, 2, 4, 8])
def test_cuda_depthwise_kernel_matches_plain(cuda_device, rate):
    torch.backends.cudnn.allow_tf32 = False
    g = torch.Generator(device=cuda_device).manual_seed(rate)
    x = torch.randn(4, 13, 13, 256, device=cuda_device, generator=g)
    w = torch.randn(3, 3, 256, device=cuda_device, generator=g)
    got = tk.depthwise_conv2d(x, w, rate)
    torch.cuda.synchronize()
    assert tk.launch_counts()["depthwise_conv2d"] == 1
    torch.testing.assert_close(got, tk.depthwise_conv2d_plain(x, w, rate), atol=1e-5, rtol=0)


@pytest.mark.cuda
@pytest.mark.parametrize("act", ["none", "relu", "relu6", "sigmoid", "gelu"])
def test_cuda_bn_act_kernel_matches_plain(cuda_device, act):
    g = torch.Generator(device=cuda_device).manual_seed(0)
    x = torch.randn(2, 26, 26, 128, device=cuda_device, generator=g)
    r = torch.randn_like(x)
    vecs = [torch.rand(128, device=cuda_device, generator=g) + 0.5 for _ in range(4)]
    for res in (None, r):
        got = tk.fused_bn_act(x, *vecs, act=act, residual=res)
        want = tk.fused_bn_act_plain(x, *vecs, act=act, residual=res)
        torch.testing.assert_close(got, want, rtol=1e-6, atol=1e-6)


@pytest.mark.cuda
def test_cuda_sigmoid_mask_kernel_is_bitwise(cuda_device):
    x = torch.linspace(-110, 110, 1 << 20, device=cuda_device).reshape(16, 256, 256, 1)
    p, m = tk.fused_sigmoid_mask(x, 0.5)
    pp, mp = tk.fused_sigmoid_mask_plain(x, 0.5)
    assert torch.equal(p.view(torch.int32), pp.view(torch.int32))
    assert torch.equal(m, mp)


@pytest.mark.cuda
def test_cuda_wrappers_reject_what_the_kernels_do_not_take(cuda_device):
    x = torch.zeros(1, 4, 4, 8, device=cuda_device, dtype=torch.float64)
    with pytest.raises(TypeError, match="float32"):
        tk.depthwise_conv2d(x, torch.zeros(3, 3, 8, device=cuda_device, dtype=torch.float64))
    nc = torch.zeros(1, 8, 4, 4, device=cuda_device).permute(0, 2, 3, 1)
    with pytest.raises(ValueError, match="contiguous"):
        tk.bn_act_folded(nc, torch.ones(8, device=cuda_device), torch.zeros(8, device=cuda_device))


@pytest.mark.cuda
def test_cuda_model_forward_goes_through_the_kernels(cuda_device):
    from unittest import mock

    from tensorflowdistributedlearning_tpu_torch.config import ModelConfig
    from tensorflowdistributedlearning_tpu_torch.models import build_model
    from tensorflowdistributedlearning_tpu_torch.train.serving import make_serving_fn

    torch.backends.cudnn.allow_tf32 = False
    cfg = ModelConfig(n_blocks=(1, 1, 1), width_multiplier=0.25, base_depth=32, input_shape=(33, 33),
                      use_pallas_depthwise=True)
    model = build_model(cfg, cuda_device, generator=torch.Generator().manual_seed(0))
    x = torch.randn(4, 33, 33, 2, generator=torch.Generator().manual_seed(1))
    out = make_serving_fn(model, cuda_device)(x)
    torch.cuda.synchronize()
    # root 4 + 6 units x 3 + ASPP 6 + decoder 1 BN+act sites at n_blocks=(1,1,1)
    assert tk.launch_counts() == {"depthwise_conv2d": 3, "fused_bn_act": 29, "fused_sigmoid_mask": 1}
    plain = {"depthwise_conv2d": tk.depthwise_conv2d_plain, "bn_act_folded": tk.bn_act_folded_plain,
             "fused_sigmoid_mask": tk.fused_sigmoid_mask_plain}
    with mock.patch.multiple(tk, **plain):
        ref = make_serving_fn(model, cuda_device)(x)
    torch.testing.assert_close(out["probabilities"], ref["probabilities"], atol=1e-5, rtol=0)
    assert torch.equal(out["mask"], (out["probabilities"] > 0.5).float())
