"""The port's kernel module against the JAX package's Pallas kernels.

On the CPU each wrapper of ``tensorflowdistributedlearning_tpu_torch.ops.kernels``
takes its plain PyTorch version; those are held against the JAX functions run
as the JAX tests run them (Pallas in interpret mode). The CUDA kernels
themselves run only on the card: ``tests/test_torch_cuda.py`` holds them
against the plain versions there.
"""

from __future__ import annotations

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tensorflowdistributedlearning_tpu.ops import pallas_kernels as jk
from tensorflowdistributedlearning_tpu_torch.ops import _build
from tensorflowdistributedlearning_tpu_torch.ops import kernels as tk

ATOL = 1e-5


@pytest.fixture(autouse=True)
def _zero_counts():
    tk.reset_launch_counts()
    yield


def _bn_vectors(rng, c):
    return (
        rng.uniform(0.5, 1.5, c).astype(np.float32),
        rng.normal(0, 0.3, c).astype(np.float32),
        rng.normal(0, 0.3, c).astype(np.float32),
        rng.uniform(0.5, 1.5, c).astype(np.float32),
    )


# -- depthwise -------------------------------------------------------------------


@pytest.mark.parametrize(
    "shape,k,rate",
    [((2, 13, 13, 16), 3, 1), ((2, 13, 13, 16), 3, 2), ((1, 13, 13, 8), 3, 4), ((1, 13, 13, 8), 3, 8),
     ((2, 9, 11, 5), 5, 1), ((1, 7, 6, 3), 3, 3)],
)
def test_depthwise_plain_matches_jax(shape, k, rate):
    rng = np.random.default_rng(0)
    x = rng.normal(size=shape).astype(np.float32)
    w = rng.normal(size=(k, k, shape[-1])).astype(np.float32)
    want = np.asarray(jk.depthwise_conv2d(jnp.asarray(x), jnp.asarray(w), rate, interpret=True))
    got = tk.depthwise_conv2d(torch.from_numpy(x), torch.from_numpy(w), rate)
    assert got.shape == shape
    np.testing.assert_allclose(got.numpy(), want, atol=ATOL, rtol=0)
    assert tk.launch_counts()["depthwise_conv2d"] == 0  # CPU tensors take the plain version


def test_depthwise_rejects_bad_filters():
    x = torch.zeros(1, 4, 4, 8)
    with pytest.raises(ValueError, match="odd kernel"):
        tk.depthwise_conv2d(x, torch.zeros(2, 2, 8))
    with pytest.raises(ValueError, match="channel mismatch"):
        tk.depthwise_conv2d(x, torch.zeros(3, 3, 4))


# -- fused BN + act --------------------------------------------------------------


@pytest.mark.parametrize("act", ["none", "relu", "relu6", "sigmoid", "gelu"])
@pytest.mark.parametrize("with_residual", [False, True])
def test_bn_act_plain_matches_jax(act, with_residual):
    rng = np.random.default_rng(1)
    x = (3 * rng.normal(size=(2, 5, 7, 24))).astype(np.float32)
    r = rng.normal(size=x.shape).astype(np.float32) if with_residual else None
    vecs = _bn_vectors(rng, 24)
    want = np.asarray(
        jk.fused_bn_act(
            jnp.asarray(x), *map(jnp.asarray, vecs), act=act,
            residual=None if r is None else jnp.asarray(r), interpret=True,
        )
    )
    got = tk.fused_bn_act(
        torch.from_numpy(x), *map(torch.from_numpy, vecs), act=act,
        residual=None if r is None else torch.from_numpy(r),
    )
    np.testing.assert_allclose(got.numpy(), want, atol=ATOL, rtol=0)
    assert tk.launch_counts()["fused_bn_act"] == 0


def test_bn_act_folded_is_the_fold_plus_the_body():
    rng = np.random.default_rng(2)
    x = torch.from_numpy(rng.normal(size=(1, 3, 3, 6)).astype(np.float32))
    vecs = [torch.from_numpy(v) for v in _bn_vectors(rng, 6)]
    m, b = tk.fold_bn(*vecs, 1e-3)
    torch.testing.assert_close(tk.bn_act_folded(x, m, b, "relu"), tk.fused_bn_act(x, *vecs, eps=1e-3, act="relu"))
    # the fold is the JAX package's _fold_bn
    jm, jb = jk._fold_bn(*map(jnp.asarray, (v.numpy() for v in vecs)), 1e-3)
    np.testing.assert_allclose(m.numpy(), np.asarray(jm), rtol=1e-6, atol=1e-7)
    np.testing.assert_allclose(b.numpy(), np.asarray(jb), rtol=1e-6, atol=1e-7)


@pytest.mark.parametrize(
    "kwargs,match",
    [({"act": "swiglu"}, "act"), ({"residual": torch.zeros(1, 4, 4, 2)}, "residual")],
)
def test_bn_act_rejects_bad_arguments(kwargs, match):
    x = torch.zeros(1, 4, 4, 4)
    v = torch.ones(4)
    with pytest.raises(ValueError, match=match):
        tk.fused_bn_act(x, v, v, v, v, **kwargs)


def test_bn_act_rejects_mismatched_vectors():
    with pytest.raises(ValueError, match=r"must be \[4\]"):
        tk.bn_act_folded(torch.zeros(1, 2, 2, 4), torch.ones(3), torch.ones(4))


# -- sigmoid mask ------------------------------------------------------------------


def _ulp_distance(a: np.ndarray, b: np.ndarray) -> np.ndarray:
    ia = a.view(np.int32).astype(np.int64)
    ib = b.view(np.int32).astype(np.int64)
    return np.abs(ia - ib)


def test_sigmoid_mask_plain_matches_jax():
    rng = np.random.default_rng(3)
    x = (4 * rng.normal(size=(3, 21, 21, 1))).astype(np.float32)
    x.flat[:6] = [0.0, 1e-8, -1e-8, 30.0, -30.0, 100.0]
    jp, jm = jk.fused_sigmoid_mask(jnp.asarray(x), 0.5, interpret=True)
    tp, tm = tk.fused_sigmoid_mask(torch.from_numpy(x), 0.5)
    jp, jm = np.asarray(jp), np.asarray(jm)
    assert tp.dtype == torch.float32 and tm.dtype == torch.float32
    # XLA:CPU's logistic is not torch's sigmoid: they differ by up to 2 ulp
    # on this input (e.g. x = -0.2208), so the probabilities are held to 2 ulp
    assert _ulp_distance(tp.numpy(), jp).max() <= 2
    away = np.abs(jp - 0.5) >= 1e-6
    np.testing.assert_array_equal(tm.numpy()[away], jm[away])
    assert tk.launch_counts()["fused_sigmoid_mask"] == 0


def test_sigmoid_mask_plain_is_the_unfused_head():
    x = torch.linspace(-20, 20, 4001).reshape(1, 4001, 1, 1)
    p, m = tk.fused_sigmoid_mask(x, 0.3)
    assert torch.equal(p, torch.sigmoid(x))
    assert torch.equal(m, (torch.sigmoid(x) > 0.3).float())


# -- the dw band kernel's plan (csrc/depthwise_dw.cu), on the CPU ---------------------

# (B, H, W, C), (kh, kw), rate: the train path's ASPP calls and the smoke's dw sweep
DW_BAND_CASES = [
    ((64, 13, 13, 1024), (3, 3), 2), ((64, 13, 13, 1024), (3, 3), 4), ((64, 13, 13, 1024), (3, 3), 8),
    ((2, 1, 1, 8), (3, 3), 1), ((2, 15, 17, 40), (7, 7), 3), ((2, 13, 13, 64), (1, 3), 2),
    ((2, 13, 13, 64), (3, 1), 2), ((1, 17, 23, 72), (5, 5), 3), ((2, 5, 6, 16), (5, 5), 4),
    ((1, 101, 101, 64), (3, 3), 1),
]


def _dw_blocks(plan, b, h, c):
    """Each block's (images, rows, channels) ranges, by the kernel's own
    index math: blockIdx.x = group * bands + band, blockIdx.y = slice."""
    for tile in range(plan.tiles):
        group, band = divmod(tile, plan.bands)
        b0, y0 = group * plan.images, band * plan.band_rows
        for s in range(plan.slices):
            c0 = s * plan.channels
            yield (range(b0, min(b, b0 + plan.images)), range(y0, min(h, y0 + plan.band_rows)),
                   range(c0, min(c, c0 + plan.channels)))


@pytest.mark.parametrize("shape,k,rate", DW_BAND_CASES)
def test_dw_plan_covers_every_image_row_and_channel_once(shape, k, rate):
    b, h, w, c = shape
    plan = tk.dw_plan(b, h, w, c, *k, rate, aligned=True)
    assert plan is not None
    cover = np.zeros((b, h, c), np.int32)
    for images, rows, channels in _dw_blocks(plan, b, h, c):
        assert len(images) and len(rows) and len(channels)  # no block is idle
        cover[images.start:images.stop, rows.start:rows.stop, channels.start:channels.stop] += 1
    assert (cover == 1).all()
    assert plan.blocks == plan.groups * plan.bands * plan.slices
    assert plan.channels in tk.DW_BAND_CHANNELS and plan.stages in (1, 2)


@pytest.mark.parametrize("shape,k,rate", DW_BAND_CASES)
def test_dw_plan_stages_each_band_and_its_halo_in_shared_memory(shape, k, rate):
    b, h, w, c = shape
    kh, kw = k
    plan = tk.dw_plan(b, h, w, c, kh, kw, rate, aligned=True)
    ph = rate * (kh - 1) // 2
    for band in range(plan.bands):
        y0 = band * plan.band_rows
        y1 = min(h, y0 + plan.band_rows)
        x_rows = min(h, y1 + ph) - max(0, y0 - ph)  # the band's x rows with its halo, clipped to the image
        staged = plan.stages * (x_rows + (y1 - y0)) * w * plan.channels * 4
        assert staged <= plan.smem_bytes <= tk.H100_SMEM_BLOCK
    assert plan.smem_bytes == tk.dw_band_smem(h, w, kh, kw, rate, plan.channels, plan.band_rows, plan.stages)
    assert plan.smem_bytes >= 4 * tk.DW_BAND_WARPS * kh * kw * plan.channels  # the warps' tap sums


def test_dw_plan_fills_the_sms():
    # B = 1 on a large image: bands split the rows until the grid covers the SMs
    plan = tk.dw_plan(1, 101, 101, 64, 3, 3, 1, aligned=True)
    assert plan.blocks >= tk.H100_SMS and plan.bands > 1
    # the train path: one image a band, eight images a block, one wave of what the SMs hold
    plan = tk.dw_plan(64, 13, 13, 1024, 3, 3, 2, aligned=True)
    assert (plan.channels, plan.band_rows, plan.images, plan.stages) == (32, 13, 8, 2)
    assert tk.H100_SMS <= plan.blocks <= tk.H100_SMS * (tk.H100_SMEM_SM // (plan.smem_bytes + 1024))


@pytest.mark.parametrize(
    "shape,k,rate,aligned",
    [((3, 9, 11, 6), (3, 3), 2, True), ((2, 9, 11, 33), (3, 3), 1, True), ((2, 9, 11, 16), (3, 3), 2, False),
     ((64, 13, 13, 1024), (3, 3), 2, False), ((1, 8, 8192, 4), (3, 3), 1, True), ((0, 13, 13, 8), (3, 3), 1, True)],
    ids=["c6", "c33", "unaligned", "path-unaligned", "band-too-wide", "empty"],
)
def test_dw_plan_leaves_the_rest_to_the_earlier_kernel(shape, k, rate, aligned):
    assert tk.dw_plan(*shape, *k, rate, aligned=aligned) is None


def test_dw_route_reads_alignment_from_the_bases():
    x = torch.zeros(2 * 9 * 11 * 16 + 1)
    g = torch.zeros(2, 9, 11, 16)
    assert tk.dw_route(x[:-1].view(2, 9, 11, 16), g, (3, 3), 2) is not None
    assert tk.dw_route(x[1:].view(2, 9, 11, 16), g, (3, 3), 2) is None


def _dw_band_emulated(x, g, kh, kw, rate, plan):
    """dw by the band kernel's walk, in float64: per block, per image, per
    tap the rectangle of output pixels whose tap lies in the image, walked
    by each pixel lane with the kernel's incremented offsets (o, kx) and no
    bounds test; asserts that the lanes visit each pixel of it once."""
    b, h, w, c = x.shape
    lanes = tk.DW_BAND_THREADS // (plan.channels // 4)
    ph, pw = rate * (kh - 1) // 2, rate * (kw - 1) // 2
    dw = np.zeros((kh * kw, c))
    for images, rows, channels in _dw_blocks(plan, b, h, c):
        y0, y1 = rows.start, rows.stop
        ry0, ry1 = max(0, y0 - ph), min(h, y1 + ph)
        for bi in images:
            xs = x[bi, ry0:ry1, :, channels.start:channels.stop].reshape(-1, len(channels))  # staged x rows
            gs = g[bi, y0:y1, :, channels.start:channels.stop].reshape(-1, len(channels))  # staged g band
            for i in range(kh):
                dy = i * rate - ph
                ylo = max(y0, -dy)
                ny = min(y1, h - dy) - ylo
                for j in range(kw):
                    dx = j * rate - pw
                    xlo = max(0, -dx)
                    nx = min(w, w - dx) - xlo
                    n = ny * nx if ny > 0 and nx > 0 else 0
                    seen = []
                    for lane in range(min(lanes, n)):
                        sr, sk = lanes // nx, lanes % nx
                        kx = lane % nx
                        o = (ylo - y0 + lane // nx) * w + xlo + kx
                        xo = (y0 - ry0 + dy) * w + dx
                        for _ in range(lane, n, lanes):
                            seen.append(o)
                            dw[i * kw + j, channels.start:channels.stop] += gs[o] * xs[o + xo]
                            o, kx = o + sr * w + sk, kx + sk
                            if kx >= nx:
                                kx, o = kx - nx, o + w - nx
                    want = [(y - y0) * w + xx for y in range(ylo, ylo + max(ny, 0)) for xx in range(xlo, xlo + nx)]
                    assert sorted(seen) == (want if n else [])
    return dw.reshape(kh, kw, c)


@pytest.mark.parametrize(
    "shape,k,rate,plan_args",
    [((2, 13, 13, 8), (3, 3), 8, None), ((2, 13, 13, 8), (3, 3), 2, None), ((1, 9, 11, 12), (1, 3), 2, None),
     ((2, 5, 6, 16), (5, 5), 4, None), ((3, 13, 13, 40), (3, 3), 2, (32, 13, 2)), ((3, 13, 13, 40), (3, 3), 8, (16, 5, 3)),
     ((5, 17, 23, 72), (5, 5), 3, (32, 4, 2)), ((2, 9, 7, 8), (7, 7), 1, (8, 3, 1))],
)
def test_dw_band_walk_matches_the_plain_dw(shape, k, rate, plan_args):
    # the planner's own plans, and forced ones with several rows a band and
    # several images a block (channels, band_rows, images)
    b, h, w, c = shape
    kh, kw = k
    if plan_args is None:
        plan = tk.dw_plan(b, h, w, c, kh, kw, rate, aligned=True)
    else:
        cs, rows, images = plan_args
        groups = -(-b // images)
        plan = tk.DwPlan(cs, -(-c // cs), rows, -(-h // rows), images, groups, 2,
                         tk.dw_band_smem(h, w, kh, kw, rate, cs, rows, 2))
    rng = np.random.default_rng(sum(shape) + rate)
    x, g = rng.normal(size=shape), rng.normal(size=shape)
    got = _dw_band_emulated(x, g, kh, kw, rate, plan)
    want = tk._dw_plain(torch.from_numpy(x), torch.from_numpy(g), kh, kw, rate).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-12, atol=1e-12)  # float64 both: the same sums in another order


def test_sigmoid_mask_arm_is_chosen_from_the_bases():
    x = torch.zeros(4 * 1001 + 1)
    assert tk.sigmoid_mask_vectorized(x[:-1])
    assert tk.sigmoid_mask_vectorized(x[:4001])  # n % 4 != 0 stays on the float4 arm (scalar tail)
    assert not tk.sigmoid_mask_vectorized(x[1:])
    assert not tk.sigmoid_mask_vectorized(x[:-1], x[1:])


# -- dispatch: the tensor's device picks the arm -------------------------------------


@pytest.mark.parametrize(
    "call",
    [
        lambda d: tk.depthwise_conv2d(torch.zeros(1, 4, 4, 2, device=d), torch.zeros(3, 3, 2, device=d)),
        lambda d: tk.bn_act_folded(torch.zeros(1, 4, 4, 2, device=d), torch.ones(2, device=d), torch.zeros(2, device=d)),
        lambda d: tk.fused_sigmoid_mask(torch.zeros(1, 4, 4, 1, device=d), 0.5),
        lambda d: tk.depthwise_conv2d_dx(torch.zeros(1, 4, 4, 2, device=d), torch.zeros(3, 3, 2, device=d)),
        lambda d: tk.depthwise_conv2d_dw(torch.zeros(1, 4, 4, 2, device=d), torch.zeros(1, 4, 4, 2, device=d), (3, 3)),
        lambda d: tk._earlier_depthwise_dw(torch.zeros(1, 4, 4, 4, device=d), torch.zeros(1, 4, 4, 4, device=d), (3, 3)),
        lambda d: tk._earlier_fused_sigmoid_mask(torch.zeros(1, 4, 4, 1, device=d), 0.5),
    ],
    ids=["depthwise", "bn_act", "sigmoid_mask", "depthwise_dx", "depthwise_dw", "depthwise_dw_earlier",
         "sigmoid_mask_earlier"],
)
def test_non_cpu_tensors_never_take_the_plain_version(call):
    # a tensor that is neither on the CPU nor on CUDA: no plain fallback
    with pytest.raises(ValueError, match="CUDA"):
        call("meta")
    assert sum(tk.launch_counts().values()) == 0


def test_build_knows_every_kernel_source():
    names = set(_build.sources())
    assert names == {"depthwise", "depthwise_dw", "bn_act", "bias_act", "sigmoid_mask", "int8_conv",
                     "int8_gemm", "int8_conv_tc", "flash_attention", "flash_attention_tc", "flash_attention_f32"}
    # every source has its ctypes bindings, and every binding its source
    assert names == {lib for lib, _ in tk._signatures.values()}
    for name in names:
        path = _build.library_path(name)
        assert path.startswith(_build.BUILD_DIR) and path.endswith(".so")
    assert "sm_90a" in " ".join(_build.NVCC_FLAGS)
    assert "--use_fast_math" not in _build.NVCC_FLAGS


def test_sources_carry_their_notes():
    import os

    for name, path in _build.sources().items():
        with open(path) as f:
            text = f.read()
        assert "Replaces: tensorflowdistributedlearning_tpu/ops/" in text, name
        assert "What bounds it on an H100" in text, name
        assert 'extern "C" int tfdl_' in text, name
        assert os.path.basename(path).endswith(".cu")
