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
    assert tk.launch_counts() == {**{n: 0 for n in tk.LAUNCHES}, "depthwise_conv2d": 3, "fused_bn_act": 29,
                                  "fused_sigmoid_mask": 1}
    plain = {"depthwise_conv2d": tk.depthwise_conv2d_plain, "bn_act_folded": tk.bn_act_folded_plain,
             "fused_sigmoid_mask": tk.fused_sigmoid_mask_plain}
    with mock.patch.multiple(tk, **plain):
        ref = make_serving_fn(model, cuda_device)(x)
    torch.testing.assert_close(out["probabilities"], ref["probabilities"], atol=1e-5, rtol=0)
    assert torch.equal(out["mask"], (out["probabilities"] > 0.5).float())


@pytest.mark.cuda
@pytest.mark.parametrize("shape,k,rate", [((4, 13, 13, 256), 3, 2), ((4, 13, 13, 256), 3, 8), ((1, 17, 23, 72), 5, 3),
                                          ((2, 9, 7, 40), 7, 1)])
def test_cuda_depthwise_backward_kernels_match_plain(cuda_device, shape, k, rate):
    torch.backends.cudnn.allow_tf32 = False
    g = torch.Generator(device=cuda_device).manual_seed(k * 10 + rate)
    x = torch.randn(*shape, device=cuda_device, generator=g)
    w = torch.randn(k, k, shape[-1], device=cuda_device, generator=g)
    gy = torch.randn(*shape, device=cuda_device, generator=g)
    dx = tk.depthwise_conv2d_dx(gy, w, rate)
    dw = tk.depthwise_conv2d_dw(x, gy, (k, k), rate)
    torch.cuda.synchronize()
    assert tk.launch_counts()["depthwise_conv2d_dx"] == 1 and tk.launch_counts()["depthwise_conv2d_dw"] == 1
    pdx, pdw = tk.depthwise_conv2d_backward_plain(x, w, gy, rate)
    torch.testing.assert_close(dx, pdx, atol=1e-5, rtol=0)
    # dw sums B*H*W products per entry in another order than the plain version
    torch.testing.assert_close(dw, pdw, rtol=1e-4, atol=1e-4 * float(pdw.abs().max()))
    assert torch.equal(dw, tk.depthwise_conv2d_dw(x, gy, (k, k), rate))  # no atomics: bitwise repeatable


@pytest.mark.cuda
def test_cuda_depthwise_autograd_goes_through_the_kernels(cuda_device):
    g = torch.Generator(device=cuda_device).manual_seed(5)
    x = torch.randn(2, 13, 13, 64, device=cuda_device, generator=g, requires_grad=True)
    w = torch.randn(3, 3, 64, device=cuda_device, generator=g, requires_grad=True)
    (tk.depthwise_conv2d(x, w, 4) ** 2).sum().backward()
    torch.cuda.synchronize()
    assert tk.launch_counts() == {**{n: 0 for n in tk.LAUNCHES}, "depthwise_conv2d": 1,
                                  "depthwise_conv2d_dx": 1, "depthwise_conv2d_dw": 1, "depthwise_conv2d_dw_band": 1}
    xp, wp = x.detach().clone().requires_grad_(True), w.detach().clone().requires_grad_(True)
    (tk.depthwise_conv2d_plain(xp, wp, 4) ** 2).sum().backward()
    torch.testing.assert_close(x.grad, xp.grad, atol=1e-4, rtol=1e-5)
    torch.testing.assert_close(w.grad, wp.grad, rtol=1e-4, atol=1e-4 * float(wp.grad.abs().max()))


@pytest.mark.cuda
def test_cuda_bn_act_kernel_refuses_gradients(cuda_device):
    x = torch.randn(1, 4, 4, 8, device=cuda_device, requires_grad=True)
    with pytest.raises(RuntimeError, match="inference-only"):
        tk.bn_act_folded(x, torch.ones(8, device=cuda_device), torch.zeros(8, device=cuda_device))
    with torch.no_grad():
        tk.bn_act_folded(x, torch.ones(8, device=cuda_device), torch.zeros(8, device=cuda_device))


@pytest.mark.cuda
@pytest.mark.parametrize("shape,causal", [((4, 196, 6, 64), False), ((2, 197, 3, 64), True), ((1, 300, 2, 32), True),
                                          ((2, 130, 2, 128), False), ((1, 1, 1, 16), False)])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_cuda_flash_attention_kernel_matches_plain(cuda_device, shape, causal, dtype):
    from tensorflowdistributedlearning_tpu_torch.ops import flash_attention as fa

    b, t, h, d = shape
    g = torch.Generator(device=cuda_device).manual_seed(t + d)
    qkv = torch.randn(b, t, 3, h, d, device=cuda_device, generator=g).to(dtype)
    q, k, v = qkv[:, :, 0], qkv[:, :, 1], qkv[:, :, 2]  # strided views, read in place
    got = fa.flash_attention(q, k, v, causal=causal)
    torch.cuda.synchronize()
    assert tk.launch_counts()["flash_attention"] == 1 and got.dtype == dtype and got.is_contiguous()
    # the dtype picks the arm: bf16 through the tensor cores, float32 on the CUDA cores
    assert tk.launch_counts()["flash_attention_tc"] == int(dtype == torch.bfloat16)
    want = fa.flash_attention_plain(q, k, v, causal=causal)
    if dtype == torch.float32:
        torch.testing.assert_close(got, want, rtol=2e-5, atol=2e-6)
    else:  # each rounds its float32 result to bf16: one bf16 step beyond the float32 tolerance
        gf, wf = got.float(), want.float()
        step = torch.ldexp(torch.ones_like(gf), torch.frexp(torch.maximum(gf.abs(), wf.abs()))[1] - 8)
        assert bool(((gf - wf).abs() <= step + 2e-5 * wf.abs() + 2e-6).all())


@pytest.mark.cuda
def test_cuda_flash_attention_refuses_gradients_and_odd_head_widths(cuda_device):
    """Inputs that need a gradient go through the kernel (the backward is
    ``flash_attention_backward``); head widths no kernel takes raise."""
    from tensorflowdistributedlearning_tpu_torch.ops import flash_attention as fa

    q = torch.randn(1, 8, 2, 64, device=cuda_device, requires_grad=True)
    fa.flash_attention(q, q, q).sum().backward()
    assert tk.launch_counts()["flash_attention"] == 1 and q.grad is not None
    tk.reset_launch_counts()
    # 24 is no multiple of 16 and 144 is past 128: no kernel takes them, in either dtype
    for d in (24, 144):
        for dtype in (torch.float32, torch.bfloat16):
            odd = torch.randn(1, 8, 2, d, device=cuda_device).to(dtype)
            with pytest.raises(ValueError, match="head widths"):
                fa.flash_attention(odd, odd, odd)
    assert tk.launch_counts()["flash_attention"] == 0


@pytest.mark.cuda
@pytest.mark.parametrize("shape,dtype", [((4, 196, 6, 64), torch.bfloat16), ((2, 196, 6, 64), torch.float32),
                                         ((2, 65, 3, 32), torch.bfloat16)])
@pytest.mark.parametrize("causal", [False, True])
def test_cuda_flash_attention_backward_is_the_plain_arms(cuda_device, shape, dtype, causal):
    """The kernel's autograd arm: one forward launch, and gradients bit for
    bit ``flash_attention_backward`` on the same inputs (the CPU arm's
    backward), reaching the qkv tensor through its strided views; within
    the forward's tolerance of autograd through the plain forward."""
    from tensorflowdistributedlearning_tpu_torch.ops import flash_attention as fa

    b, t, h, d = shape
    g = torch.Generator(device=cuda_device).manual_seed(t + h)
    qkv = torch.randn(b, t, 3, h, d, device=cuda_device, generator=g).to(dtype).requires_grad_(True)
    cot = torch.randn(b, t, h, d, device=cuda_device, generator=g).to(dtype)
    out = fa.flash_attention(qkv[:, :, 0], qkv[:, :, 1], qkv[:, :, 2], causal=causal)
    out.backward(cot)
    torch.cuda.synchronize()
    assert tk.launch_counts()["flash_attention"] == 1
    assert tk.launch_counts()["flash_attention_tc"] == int(dtype == torch.bfloat16)
    q, k, v = (qkv.detach()[:, :, j] for j in range(3))
    want = fa.flash_attention_backward(q, k, v, cot, causal=causal)
    for j, w in enumerate(want):
        assert qkv.grad[:, :, j].dtype == dtype and torch.equal(qkv.grad[:, :, j], w), "qkv"[j]
    ref = qkv.detach().float().requires_grad_(True)
    fa.flash_attention_plain(ref[:, :, 0], ref[:, :, 1], ref[:, :, 2], causal=causal).backward(cot.float())
    scale = float(ref.grad.abs().max())
    tol = (2e-5 if dtype == torch.float32 else 2e-2) * scale
    assert float((qkv.grad.float() - ref.grad).abs().max()) <= tol


@pytest.mark.cuda
def test_cuda_quant_linear_is_bitwise_plain(cuda_device):
    from tensorflowdistributedlearning_tpu_torch.ops import quant_kernels as qk

    g = torch.Generator(device=cuda_device).manual_seed(3)
    x = torch.randn(4, 196, 384, device=cuda_device, generator=g).to(torch.bfloat16)
    wk = torch.randint(-127, 128, (1152, 384), device=cuda_device, generator=g, dtype=torch.int8)
    ws = torch.rand(1152, device=cuda_device, generator=g) * 1e-2 + 1e-3
    bias = torch.randn(1152, device=cuda_device, generator=g)
    got = qk.QuantLinear(wk, ws, bias)(x)
    torch.cuda.synchronize()
    assert tk.launch_counts()["int8_matmul"] == 1 and got.shape == (4, 196, 1152) and got.dtype == torch.bfloat16
    assert torch.equal(got, qk.int8_matmul_plain(x, wk.t(), ws, bias=bias, out_dtype=torch.bfloat16))


@pytest.mark.cuda
def test_cuda_flash_attention_tc_copies_unaligned_inputs(cuda_device):
    """The tensor-core kernel copies 16 bytes at a time: a view whose base is
    not 16-byte aligned is copied first, and the result is the same."""
    from tensorflowdistributedlearning_tpu_torch.ops import flash_attention as fa

    g = torch.Generator(device=cuda_device).manual_seed(11)
    shape = (2, 37, 3, 64)
    n = 2 * 37 * 3 * 64
    buf = torch.randn(3 * n + 1, device=cuda_device, generator=g).to(torch.bfloat16)
    q, k, v = (buf[1 + i * n:1 + (i + 1) * n].view(shape) for i in range(3))
    assert q.data_ptr() % 16 != 0
    got = fa.flash_attention(q, k, v, causal=True)
    want = fa.flash_attention(*(x.clone() for x in (q, k, v)), causal=True)
    torch.cuda.synchronize()
    assert tk.launch_counts()["flash_attention_tc"] == 2 and torch.equal(got, want)


@pytest.mark.cuda
@pytest.mark.parametrize("mkn", [(12544, 384, 1152), (12544, 1536, 384), (64, 384, 1000), (300, 70, 24), (37, 33, 5)],
                         ids=lambda s: "x".join(map(str, s)))
def test_cuda_int8_matmul_routes_are_bitwise_plain(cuda_device, mkn):
    """K % 16 == 0 goes through the TMA + wgmma GEMM, other K through the
    conv kernel; both equal the plain version bit for bit."""
    from tensorflowdistributedlearning_tpu_torch.ops import quant_kernels as qk

    m, k, n = mkn
    g = torch.Generator(device=cuda_device).manual_seed(m + k + n)
    x = torch.randn(m, k, device=cuda_device, generator=g).to(torch.bfloat16)
    wk = torch.randint(-127, 128, (n, k), device=cuda_device, generator=g, dtype=torch.int8)
    ws = torch.rand(n, device=cuda_device, generator=g) * 1e-2 + 1e-3
    bias = torch.randn(n, device=cuda_device, generator=g)
    for act, out_dtype in (("none", torch.bfloat16), ("relu", torch.float32)):
        got = qk.int8_matmul_nk(x, wk, ws, bias=bias, act=act, out_dtype=out_dtype)
        torch.cuda.synchronize()
        assert torch.equal(got, qk.int8_matmul_plain(x, wk.t(), ws, bias=bias, act=act, out_dtype=out_dtype))
    gemm = 2 if qk.matmul_route(k) == "gemm" else 0
    assert tk.launch_counts()["int8_matmul"] == 2 and tk.launch_counts()["int8_matmul_gemm"] == gemm


# -- the tiled depthwise kernel against the earlier one, bit for bit -------------------

# (x shape, side, rate): the ASPP calls of the train and serve paths, then a
# sweep: C = 72 and C = 6 (not a multiple of 4), 5x5 at rate 3, 7x7, B = 1,
# H = W = 1, and a rate whose halo no tile can stage
DEPTHWISE_SWEEP = [((8, 13, 13, 1024), 3, 2), ((8, 13, 13, 1024), 3, 4), ((8, 13, 13, 1024), 3, 8),
                   ((2, 17, 23, 72), 3, 1), ((3, 9, 11, 6), 3, 2), ((1, 17, 23, 72), 5, 3), ((2, 9, 7, 40), 7, 1),
                   ((1, 13, 13, 64), 3, 4), ((2, 1, 1, 8), 3, 1), ((1, 40, 40, 256), 7, 12)]


@pytest.mark.cuda
@pytest.mark.parametrize("shape,k,rate", DEPTHWISE_SWEEP)
@pytest.mark.parametrize("flip", [False, True], ids=["fwd", "dx"])
def test_cuda_depthwise_tiled_kernel_is_bitwise_the_earlier_kernel(cuda_device, shape, k, rate, flip):
    """Both sum one fmaf chain from 0 in tap order (i, j) over the taps
    inside the image (for dx over the flipped indices), so they agree bit
    for bit; and both stay within 1e-5 of the plain version."""
    torch.backends.cudnn.allow_tf32 = False
    g = torch.Generator(device=cuda_device).manual_seed(sum(shape) + k + rate)
    x = torch.randn(*shape, device=cuda_device, generator=g)
    w = torch.randn(k, k, shape[-1], device=cuda_device, generator=g)
    got = tk.depthwise_conv2d_dx(x, w, rate) if flip else tk.depthwise_conv2d_forward(x, w, rate)
    earlier = tk._earlier_depthwise(x, w, rate, flip)
    torch.cuda.synchronize()
    assert torch.equal(got, earlier)
    want = tk._dx_plain(x, w, rate) if flip else tk.depthwise_conv2d_plain(x, w, rate)
    torch.testing.assert_close(got, want, atol=1e-5, rtol=0)


@pytest.mark.cuda
def test_cuda_depthwise_dx_is_one_launch_without_a_flip_copy(cuda_device):
    g = torch.Generator(device=cuda_device).manual_seed(11)
    gy = torch.randn(4, 13, 13, 256, device=cuda_device, generator=g)
    w = torch.randn(3, 3, 256, device=cuda_device, generator=g)
    tk.depthwise_conv2d_dx(gy, w, 2)  # built and loaded
    torch.cuda.synchronize()
    tk.reset_launch_counts()
    before = torch.cuda.memory_stats()["allocation.all.allocated"]
    dx = tk.depthwise_conv2d_dx(gy, w, 2)
    torch.cuda.synchronize()
    # one allocation: the output; the flip is an index in the kernel
    assert torch.cuda.memory_stats()["allocation.all.allocated"] - before == 1
    assert tk.launch_counts() == {**{n: 0 for n in tk.LAUNCHES}, "depthwise_conv2d_dx": 1}
    assert dx.shape == gy.shape


# -- the float32 attention arm (csrc/flash_attention_f32.cu) -----------------------------


@pytest.mark.cuda
@pytest.mark.parametrize("t", [1, 63, 65, 196, 257])
@pytest.mark.parametrize("causal", [False, True], ids=["full", "causal"])
def test_cuda_flash_attention_f32_sweep(cuda_device, t, causal):
    """Strided views of one qkv tensor, their contiguous copies and an
    unaligned base (copied to an aligned tensor first) against the plain
    version at the JAX tolerance, its absolute part scaled to max|v|."""
    from tensorflowdistributedlearning_tpu_torch.ops import flash_attention as fa

    b, h, d = 2, 3, 64
    g = torch.Generator(device=cuda_device).manual_seed(t * 2 + causal)
    qkv = 2 * torch.randn(b, t, 3, h, d, device=cuda_device, generator=g)
    flat = torch.randn(b * t * h * d + 1, device=cuda_device, generator=g)
    unaligned = flat[1:].view(b, t, h, d)
    assert unaligned.data_ptr() % 16 != 0
    cases = [(qkv[:, :, 0], qkv[:, :, 1], qkv[:, :, 2]), tuple(qkv[:, :, j].contiguous() for j in range(3)),
             (unaligned, qkv[:, :, 1], qkv[:, :, 2])]
    for q, k, v in cases:
        got = fa.flash_attention(q, k, v, causal=causal)
        want = fa.flash_attention_plain(q, k, v, causal=causal)
        atol = 2e-6 * max(1.0, float(v.abs().max()))
        torch.testing.assert_close(got, want, rtol=2e-5, atol=atol)
    torch.cuda.synchronize()
    assert tk.launch_counts()["flash_attention"] == 3 and tk.launch_counts()["flash_attention_tc"] == 0


@pytest.mark.cuda
@pytest.mark.parametrize("d", [48, 80, 96, 112])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_cuda_flash_attention_newly_admitted_head_widths(cuda_device, d, dtype):
    from tensorflowdistributedlearning_tpu_torch.ops import flash_attention as fa

    assert d in fa.KERNEL_HEAD_DIMS[dtype]
    g = torch.Generator(device=cuda_device).manual_seed(d)
    qkv = torch.randn(2, 150, 3, 2, d, device=cuda_device, generator=g).to(dtype)
    q, k, v = qkv[:, :, 0], qkv[:, :, 1], qkv[:, :, 2]
    for causal in (False, True):
        got = fa.flash_attention(q, k, v, causal=causal)
        want = fa.flash_attention_plain(q, k, v, causal=causal)
        atol = 2e-6 * max(1.0, float(v.float().abs().max()))
        if dtype == torch.float32:
            torch.testing.assert_close(got, want, rtol=2e-5, atol=atol)
        else:  # one bf16 step beyond the float32 tolerance
            gf, wf = got.float(), want.float()
            step = torch.ldexp(torch.ones_like(gf), torch.frexp(torch.maximum(gf.abs(), wf.abs()))[1] - 8)
            assert bool(((gf - wf).abs() <= step + 2e-5 * wf.abs() + atol).all())
    torch.cuda.synchronize()
    assert tk.launch_counts()["flash_attention"] == 2
    assert tk.launch_counts()["flash_attention_tc"] == (2 if dtype == torch.bfloat16 else 0)


# -- int8_conv2d's routes: the 1x1 GEMM, the im2col implicit GEMM, int8_conv.cu ---------

# (B, H, W, Cin, Cout, side, padding): the path's shapes at a small batch and
# a sweep of every route's edges (Cin 64/128/512 at 3x3, Cout 1 and 70, 5x5
# with asymmetric explicit pads, B = 1, M never a multiple of 128, 51x51 and
# 13x13, a 1x1 with Cin 48 and one with Cin 5)
INT8_CONV_SWEEP = [
    (2, 51, 51, 64, 128, 3, "SAME"), (2, 26, 26, 128, 512, 1, "SAME"), (2, 13, 13, 256, 256, 3, "SAME"),
    (2, 26, 26, 512, 1, 3, "SAME"), (1, 13, 13, 2048, 512, 1, "SAME"), (2, 13, 13, 128, 70, 3, "SAME"),
    (1, 51, 51, 64, 64, 3, "SAME"), (3, 11, 13, 64, 70, 5, ((2, 0), (1, 3))), (2, 6, 5, 32, 72, 3, ((0, 2), (3, 0))),
    (1, 17, 23, 48, 40, 1, "SAME"), (1, 9, 7, 5, 24, 1, "SAME"), (2, 9, 7, 5, 1, 5, "SAME"),
    (2, 7, 9, 96, 33, 1, ((1, 0), (0, 2))), (1, 3, 4, 64, 130, 7, "SAME"),
]


@pytest.mark.cuda
@pytest.mark.parametrize("case", INT8_CONV_SWEEP, ids=lambda c: "-".join(map(str, c[:6])) + f"-{c[6]}")
def test_cuda_int8_conv_routes_are_bitwise_plain_and_the_earlier_kernel(cuda_device, case):
    """Every route sums the same integers exactly and ends in the same
    epilogue: the kernel conv_route picks, the earlier kernel
    (int8_conv.cu) and the plain version agree bit for bit."""
    from tensorflowdistributedlearning_tpu_torch.ops import quant_kernels as qk

    b, h, w, cin, cout, k, padding = case
    g = torch.Generator(device=cuda_device).manual_seed(sum(case[:6]))
    x = (2 * torch.randn(b, h, w, cin, device=cuda_device, generator=g)).to(torch.bfloat16)
    wq = torch.randint(-127, 128, (k, k, cin, cout), device=cuda_device, generator=g, dtype=torch.int8)
    ws = torch.rand(cout, device=cuda_device, generator=g) * 1e-2 + 1e-3
    bias = torch.randn(cout, device=cuda_device, generator=g)
    pads = qk._pads_or_raise(padding, wq)
    route = qk.conv_route(k, k, cin, pads)
    xq, xs = qk.quantize_activations(x)
    for act, out_dtype, bb in (("none", torch.bfloat16, None), ("relu", torch.float32, bias)):
        got = qk.int8_conv2d(x, wq, ws, padding=padding, bias=bb, act=act, out_dtype=out_dtype)
        want = qk.int8_conv2d_plain(x, wq, ws, padding=padding, bias=bb, act=act, out_dtype=out_dtype)
        earlier = torch.empty_like(want)
        qk._earlier_int8_conv(xq, xs, qk._hwio_to_ohwi(wq), ws, bb, earlier, pads, act)
        torch.cuda.synchronize()
        assert torch.equal(got, want) and torch.equal(earlier, want), route
    counts = tk.launch_counts()
    assert counts["int8_conv2d"] == 2
    assert counts["int8_conv2d_gemm"] == (2 if route == "gemm" else 0)
    assert counts["int8_conv2d_tc"] == (2 if route == "tc" else 0)


@pytest.mark.cuda
def test_cuda_int8_compute_forward_takes_43_gemm_and_9_im2col_launches(cuda_device, tmp_path):
    """A full-width int8-compute forward: 52 int8_conv2d launches, the 43
    1x1 convs through int8_gemm.cu and the 9 k x k through int8_conv_tc.cu,
    the answer bit for bit the forward with the plain int8 conv."""
    from unittest import mock

    from tensorflowdistributedlearning_tpu_torch.config import ModelConfig
    from tensorflowdistributedlearning_tpu_torch.models import build_model
    from tensorflowdistributedlearning_tpu_torch.ops import quant_kernels as qk
    from tensorflowdistributedlearning_tpu_torch.train import serving

    cfg = ModelConfig(use_pallas_depthwise=True)
    model = build_model(cfg, "cpu", generator=torch.Generator().manual_seed(0)).eval()
    serving.export_serving_artifact(model, cfg, str(tmp_path), serving_dtype="int8-compute")
    qmodel = serving.load_model(str(tmp_path), cuda_device)
    x = torch.randn(2, 101, 101, 2, generator=torch.Generator().manual_seed(1))
    serve = serving.make_serving_fn(qmodel, cuda_device, act_dtype=torch.bfloat16)
    tk.reset_launch_counts()
    out = serve(x)
    torch.cuda.synchronize()
    counts = tk.launch_counts()
    assert (counts["int8_conv2d"], counts["int8_conv2d_gemm"], counts["int8_conv2d_tc"]) == (52, 43, 9)
    with mock.patch.object(qk, "int8_conv2d_ohwi", qk.int8_conv2d_ohwi_plain):
        ref = serving.make_serving_fn(qmodel, cuda_device, act_dtype=torch.bfloat16)(x)
    assert torch.equal(out["probabilities"], ref["probabilities"])


# -- fused_bn_act's row kernels against the earlier kernels, bit for bit -------------------

# the 11 BN input shapes of a bucket-64 segmenter forward, C = 33 (the scalar
# arm) and a base 4 bytes past a 16-byte boundary (the scalar arm)
BN_PATH_SHAPES = [(64, 51, 51, 64), (64, 51, 51, 128), (64, 26, 26, 128), (64, 26, 26, 512), (64, 13, 13, 128),
                  (64, 13, 13, 512), (64, 13, 13, 256), (64, 13, 13, 1024), (64, 13, 13, 2048), (64, 1, 1, 256),
                  (64, 26, 26, 256)]


@pytest.mark.cuda
@pytest.mark.parametrize("act", ["none", "relu", "relu6", "sigmoid", "gelu"])
def test_cuda_bn_act_row_kernels_are_bitwise_the_earlier_kernels(cuda_device, act):
    g = torch.Generator(device=cuda_device).manual_seed(len(act))
    for shape, offset in [(s, 0) for s in BN_PATH_SHAPES] + [((3, 7, 5, 33), 0), ((2, 13, 13, 256), 1)]:
        c, n = shape[-1], 1
        for d in shape:
            n *= d
        x = (3 * torch.randn(n + offset, device=cuda_device, generator=g))[offset:].view(shape)
        r = torch.randn(n + offset, device=cuda_device, generator=g)[offset:].view(shape)
        m, b = torch.rand(c, device=cuda_device, generator=g) + 0.5, torch.randn(c, device=cuda_device, generator=g)
        assert tk.bn_act_vectorized(c, x, r) == (offset == 0 and c % 4 == 0)
        for res in (None, r):
            assert torch.equal(tk.bn_act_folded(x, m, b, act, res), tk._earlier_bn_act(x, m, b, act, res)), shape
        mean, mul, bias = (torch.randn(c, device=cuda_device, generator=g).to(torch.bfloat16).float() for _ in range(3))
        for xx in (x, x.to(torch.bfloat16) if offset == 0 else
                   (3 * torch.randn(n + 1, device=cuda_device, generator=g)).to(torch.bfloat16)[1:].view(shape)):
            got = tk.bn_act_unfolded(xx, mean, mul, bias, act)
            assert torch.equal(got, tk._earlier_bn_act_unfolded(xx, mean, mul, bias, act)), (shape, xx.dtype)
    torch.cuda.synchronize()
    assert tk.launch_counts()["fused_bn_act"] == 26 and tk.launch_counts()["fused_bn_act_bf16"] == 26


# -- the dw band kernel and the float4 sigmoid-mask kernel --------------------------------

# (x shape, (kh, kw), rate, route): the ASPP calls at a smaller batch, then the
# smoke's dw sweep: C = 6 and 33 and a base 4 bytes off take the earlier tile
# kernel; H = W = 1, 7x7 at rate 3, 1x3, 3x1, 5x5 at rate 3, a halo larger than
# the image and B = 1 at 101x101x64 the band kernel
DW_SWEEP = [((8, 13, 13, 1024), (3, 3), 2, "band"), ((8, 13, 13, 1024), (3, 3), 8, "band"),
            ((3, 9, 11, 6), (3, 3), 2, "tile"), ((2, 9, 11, 33), (3, 3), 1, "tile"), ((2, 9, 11, 16), (3, 3), 2, "offset"),
            ((2, 1, 1, 8), (3, 3), 1, "band"), ((2, 15, 17, 40), (7, 7), 3, "band"), ((2, 13, 13, 64), (1, 3), 2, "band"),
            ((2, 13, 13, 64), (3, 1), 2, "band"), ((1, 17, 23, 72), (5, 5), 3, "band"), ((2, 5, 6, 16), (5, 5), 4, "band"),
            ((1, 101, 101, 64), (3, 3), 1, "band")]


@pytest.mark.cuda
@pytest.mark.parametrize("shape,k,rate,route", DW_SWEEP)
def test_cuda_dw_routes_match_plain_and_repeat_bitwise(cuda_device, shape, k, rate, route):
    """dw to rtol 1e-4 + 1e-4·max|dw| of the plain version (each entry sums
    B·H·W products in another order), bitwise equal across two launches, one
    launch each, on the stated route; the earlier kernel to the same bound."""
    g = torch.Generator(device=cuda_device).manual_seed(sum(shape) + rate)
    n = 1
    for d in shape:
        n *= d
    offset = int(route == "offset")
    x = torch.randn(n + offset, device=cuda_device, generator=g)[offset:].view(shape)
    gy = torch.randn(*shape, device=cuda_device, generator=g)
    plan = tk.dw_route(x, gy, k, rate)
    assert (plan is not None) == (route == "band")
    dw = tk.depthwise_conv2d_dw(x, gy, k, rate)
    torch.cuda.synchronize()
    assert tk.launch_counts()["depthwise_conv2d_dw"] == 1
    assert tk.launch_counts()["depthwise_conv2d_dw_band"] == int(route == "band")
    assert torch.equal(dw, tk.depthwise_conv2d_dw(x, gy, k, rate))
    want = tk._dw_plain(x, gy, *k, rate)
    bound = 1e-4 * float(want.abs().max())
    torch.testing.assert_close(dw, want, rtol=1e-4, atol=bound)
    torch.testing.assert_close(tk._earlier_depthwise_dw(x, gy, k, rate), want, rtol=1e-4, atol=bound)
    if shape[0] == 1 and shape[1] == 101:
        assert plan.blocks >= tk.H100_SMS


@pytest.mark.cuda
@pytest.mark.parametrize("case", ["path", "odd-count", "unaligned"])
def test_cuda_sigmoid_mask_float4_kernel_is_bitwise_plain(cuda_device, case):
    g = torch.Generator(device=cuda_device).manual_seed(3)
    logits = 4 * torch.randn(64, 101, 101, 1, device=cuda_device, generator=g)
    x = {"path": logits, "odd-count": torch.linspace(-30, 30, (1 << 20) + 3, device=cuda_device),
         "unaligned": logits.flatten()[1:]}[case]
    assert tk.sigmoid_mask_vectorized(x) == (case != "unaligned")
    pp, mp = tk.fused_sigmoid_mask_plain(x, 0.5)
    for p, m in (tk.fused_sigmoid_mask(x, 0.5), tk._earlier_fused_sigmoid_mask(x, 0.5)):
        assert torch.equal(p.view(torch.int32), pp.view(torch.int32))
        assert torch.equal(m, mp)
    torch.cuda.synchronize()
    assert tk.launch_counts()["fused_sigmoid_mask"] == 1


# -- the fused_bias_act vector arm ---------------------------------------------------------

# (shape, element offset of the base, vector arm): the ViT MLP hidden shape and
# one vector a row take the vector arm; C = 33 and a base one element off the
# earlier kernel
BIAS_ACT_CASES = [((12544, 1536), 0, True), ((4099, 8), 0, True), ((2, 3, 5, 48), 0, True), ((3, 7, 5, 33), 0, False),
                  ((37, 64), 1, False)]


@pytest.mark.cuda
@pytest.mark.parametrize("shape,offset,vector", BIAS_ACT_CASES, ids=lambda c: str(c))
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
def test_cuda_bias_act_vector_arm_is_bitwise_the_earlier_kernel(cuda_device, shape, offset, vector, dtype):
    g = torch.Generator(device=cuda_device).manual_seed(sum(shape) + offset)
    n = 1
    for d in shape:
        n *= d
    x = (3 * torch.randn(n + offset, device=cuda_device, generator=g)).to(dtype)[offset:].view(shape)
    bias = torch.randn(shape[-1], device=cuda_device, generator=g)
    assert (tk.bias_act_route(x, torch.empty_like(x)) is not None) == vector
    for act in tk.ACTIVATIONS:
        for b in (bias, None):
            got = tk.fused_bias_act(x, b, act)
            old = tk._earlier_fused_bias_act(x, b, act)
            view = torch.int16 if dtype == torch.bfloat16 else torch.int32
            assert torch.equal(got.view(view), old.view(view)), (act, b is None)
    torch.cuda.synchronize()
    assert tk.launch_counts()["fused_bias_act"] == 2 * len(tk.ACTIVATIONS)


# -- the data-parallel step over NCCL, a world of one rank ---------------------------------


@pytest.fixture(scope="module")
def nccl_world_one(tmp_path_factory):
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: NCCL reduces CUDA tensors only")
    from tensorflowdistributedlearning_tpu_torch.parallel import multihost

    multihost.initialize(f"file://{tmp_path_factory.mktemp('nccl')}/store", 1, 0, backend="nccl", timeout=120)
    try:
        yield torch.device("cuda", torch.cuda.current_device())
    finally:
        multihost.shutdown()


@pytest.mark.cuda
def test_cuda_world_one_nccl_step_is_the_single_device_step(nccl_world_one):
    # the mean over one rank divides by 1: under PyTorch's deterministic
    # algorithms (cuDNN's defaults add in a run-dependent order) three
    # data-parallel steps, kernels on and sync BN on, are bit for bit three
    # single-device steps
    import numpy as np

    from tensorflowdistributedlearning_tpu_torch.config import ModelConfig, TrainConfig
    from tensorflowdistributedlearning_tpu_torch.data import synthetic
    from tensorflowdistributedlearning_tpu_torch.train import step as step_lib
    from tensorflowdistributedlearning_tpu_torch.train.state import create_train_state

    torch.backends.cudnn.allow_tf32 = False
    cfg = ModelConfig(n_blocks=(1, 1, 1), input_shape=(33, 33), base_depth=16, width_multiplier=0.25,
                      use_pallas_depthwise=True)
    states = [create_train_state(cfg, TrainConfig(sync_batch_norm=sync), nccl_world_one,
                                 generator=torch.Generator().manual_seed(0)) for sync in (True, False)]
    steps = [step_lib.make_train_step(step_lib.SegmentationTask(), data_parallel=dp) for dp in (True, False)]
    rng = np.random.default_rng(0)
    tk.reset_launch_counts()
    saved = torch.are_deterministic_algorithms_enabled(), torch.backends.cudnn.deterministic
    torch.use_deterministic_algorithms(True)
    torch.backends.cudnn.deterministic = True
    try:
        for _ in range(3):
            b = synthetic.synthetic_segmentation_batch(rng, 8, (33, 33))
            batch = {k: torch.from_numpy(b[k]).to(nccl_world_one) for k in ("images", "labels")}
            losses = [step_lib.compute_metrics(step(state, batch)[1])["loss"] for step, state in zip(steps, states)]
            assert losses[0] == losses[1]
    finally:
        torch.use_deterministic_algorithms(saved[0])
        torch.backends.cudnn.deterministic = saved[1]
    assert tk.launch_counts()["depthwise_conv2d_dw"] == 2 * 3 * 3
    for (name, a), b in zip(states[0].model.state_dict().items(), states[1].model.state_dict().values()):
        assert torch.equal(a, b), name


@pytest.mark.cuda
def test_cuda_pmean_backward_matches_cpu(nccl_world_one):
    from tensorflowdistributedlearning_tpu_torch.parallel import collectives

    g = torch.Generator().manual_seed(3)
    x, w = torch.randn(2, 7, generator=g), torch.randn(2, 7, generator=g)
    grads = []
    for device in (nccl_world_one, torch.device("cpu")):
        xd = x.to(device).requires_grad_(True)
        y = collectives.pmean(xd) if device.type == "cuda" else xd.clone()  # CPU: the mean over one rank
        (y * w.to(device)).sum().backward()
        grads.append(xd.grad.cpu())
        assert torch.equal(y.detach().cpu(), x)
    assert torch.equal(grads[0], grads[1])


# -- the bf16-activation arms (bf16-compute models) ------------------------------------------


def _bf16_steps(a: torch.Tensor, b: torch.Tensor, atol: float = 1e-6) -> int:
    """Largest distance in bf16 steps between two bf16 tensors (their bit
    patterns as ordered integers), 0 where the two are within ``atol``:
    near zero a bf16 step is far below float32's noise on unit-scale
    inputs (sigmoid and gelu of large negative values)."""

    def ordered(t):
        bits = t.contiguous().view(torch.int16).to(torch.int32)
        return torch.where(bits < 0, -(bits & 0x7FFF), bits)

    steps = (ordered(a) - ordered(b)).abs()
    return int(torch.where((a.float() - b.float()).abs() <= atol, 0, steps).max())


def _bf16_view(shape, offset, device, g, scale=1.0):
    n = 1
    for d in shape:
        n *= d
    return (scale * torch.randn(n + offset, device=device, generator=g)).to(torch.bfloat16)[offset:].view(shape)


# (x shape, k, rate, base offset in elements): the ASPP calls of tgs_salt_bf16
# at batch 64, odd channel counts (the one-channel arm) and a base 2 and 4
# bytes off an 8-byte boundary
BF16_DW_CASES = [((64, 13, 13, 1024), 3, 2, 0), ((64, 13, 13, 1024), 3, 8, 0), ((3, 9, 11, 6), 3, 2, 0),
                 ((2, 9, 11, 33), 3, 1, 0), ((2, 9, 11, 16), 3, 2, 1), ((2, 9, 11, 16), 3, 2, 2),
                 ((1, 17, 23, 72), 5, 3, 0), ((1, 40, 40, 256), 7, 12, 0)]


@pytest.mark.cuda
@pytest.mark.parametrize("shape,k,rate,offset", BF16_DW_CASES)
def test_cuda_depthwise_bf16_arms_match_plain(cuda_device, shape, k, rate, offset):
    """The bf16 forward, dx and dw against the plain versions on the card:
    within one bf16 step (float32 sums in another order, then one
    rounding); dw bitwise repeatable."""
    g = torch.Generator(device=cuda_device).manual_seed(sum(shape) + offset)
    x, gout = _bf16_view(shape, offset, cuda_device, g), _bf16_view(shape, offset, cuda_device, g)
    w = (0.4 * torch.randn(k, k, shape[-1], device=cuda_device, generator=g)).to(torch.bfloat16)
    fwd = tk.depthwise_conv2d_forward(x, w, rate)
    dx = tk.depthwise_conv2d_dx(gout, w, rate)
    dw = tk.depthwise_conv2d_dw(x, gout, (k, k), rate)
    assert fwd.dtype == dx.dtype == dw.dtype == torch.bfloat16
    pdx, pdw = tk.depthwise_conv2d_backward_plain(x, w, gout, rate)
    assert _bf16_steps(fwd, tk.depthwise_conv2d_plain(x, w, rate)) <= 1
    assert _bf16_steps(dx, pdx) <= 1
    assert _bf16_steps(dw, pdw) <= 1
    assert torch.equal(dw, tk.depthwise_conv2d_dw(x, gout, (k, k), rate))
    torch.cuda.synchronize()
    c = tk.launch_counts()
    assert (c["depthwise_conv2d_bf16"], c["depthwise_conv2d_dx_bf16"], c["depthwise_conv2d_dw_bf16"]) == (1, 1, 2)


@pytest.mark.cuda
@pytest.mark.parametrize("act", ["none", "relu", "relu6", "sigmoid", "gelu"])
def test_cuda_bn_act_bf16_arm_matches_plain(cuda_device, act):
    """The bf16-activation row kernel against the plain version on the
    card: bit for bit for the piecewise-linear activations (the same
    rounded float32 operations, then one rounding to bf16), within one bf16
    step for sigmoid and gelu (libm); its vector and scalar arms agree bit
    for bit."""
    g = torch.Generator(device=cuda_device).manual_seed(len(act))
    shapes = [((64, 51, 51, 128), 0), ((64, 13, 13, 256), 0), ((3, 7, 5, 33), 0), ((2, 13, 13, 256), 1),
              ((2, 13, 13, 12), 0)]
    for shape, offset in shapes:
        c = shape[-1]
        x, r = _bf16_view(shape, offset, cuda_device, g, 3.0), _bf16_view(shape, offset, cuda_device, g)
        m, b = torch.rand(c, device=cuda_device, generator=g) + 0.5, torch.randn(c, device=cuda_device, generator=g)
        assert tk.bn_act_vectorized_bf16(c, x, m, b, r) == (offset == 0 and c % 8 == 0)
        for res in (None, r):
            got = tk.bn_act_folded(x, m, b, act, res)
            want = tk.bn_act_folded_plain(x, m, b, act, res)
            assert got.dtype == torch.bfloat16
            if act in ("none", "relu", "relu6"):
                assert torch.equal(got, want), shape
            else:
                assert _bf16_steps(got, want) <= 1, shape
            if offset == 0 and c % 8 == 0:  # the scalar arm on a copy one element off
                xs = _bf16_view(shape, 1, cuda_device, g)
                xs.copy_(x)
                rs = None if res is None else _bf16_view(shape, 1, cuda_device, g).copy_(res)
                assert torch.equal(tk.bn_act_folded(xs, m, b, act, rs), got), shape
    torch.cuda.synchronize()
    assert tk.launch_counts()["fused_bn_act_bf16_act"] == 2 * len(shapes) + 2 * 2


@pytest.mark.cuda
def test_cuda_bf16_tensors_never_take_the_plain_arms(cuda_device):
    """A CUDA bf16 tensor launches the kernel or raises: the plain versions
    patched to fail are never reached, and a dtype the kernels do not take
    (float16) raises."""
    from unittest import mock

    def boom(*args, **kwargs):
        raise AssertionError("a CUDA tensor took the plain version")

    g = torch.Generator(device=cuda_device).manual_seed(3)
    x = _bf16_view((2, 9, 9, 16), 0, cuda_device, g)
    w = _bf16_view((3, 3, 16), 0, cuda_device, g)
    m, b = torch.ones(16, device=cuda_device), torch.zeros(16, device=cuda_device)
    with mock.patch.multiple(tk, depthwise_conv2d_plain=boom, _dx_plain=boom, _dw_plain=boom,
                             bn_act_folded_plain=boom):
        out = tk.depthwise_conv2d(x.requires_grad_(), w.requires_grad_(), 2)
        out.float().sum().backward()
        with torch.no_grad():
            tk.bn_act_folded(out.detach(), m, b, "relu")
    torch.cuda.synchronize()
    c = tk.launch_counts()
    assert (c["depthwise_conv2d_bf16"], c["depthwise_conv2d_dx_bf16"], c["depthwise_conv2d_dw_bf16"],
            c["fused_bn_act_bf16_act"]) == (1, 1, 1, 1)
    with pytest.raises(TypeError, match="float32 or bfloat16"):
        tk.depthwise_conv2d_forward(x.detach().half(), w.detach().half(), 1)
    with pytest.raises(TypeError, match="float32 or bfloat16"):
        tk.bn_act_folded(x.detach().half(), m, b, "relu")
