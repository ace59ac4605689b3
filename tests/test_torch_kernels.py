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


# -- dispatch: the tensor's device picks the arm -------------------------------------


@pytest.mark.parametrize(
    "call",
    [
        lambda d: tk.depthwise_conv2d(torch.zeros(1, 4, 4, 2, device=d), torch.zeros(3, 3, 2, device=d)),
        lambda d: tk.bn_act_folded(torch.zeros(1, 4, 4, 2, device=d), torch.ones(2, device=d), torch.zeros(2, device=d)),
        lambda d: tk.fused_sigmoid_mask(torch.zeros(1, 4, 4, 1, device=d), 0.5),
    ],
    ids=["depthwise", "bn_act", "sigmoid_mask"],
)
def test_non_cpu_tensors_never_take_the_plain_version(call):
    # a tensor that is neither on the CPU nor on CUDA: no plain fallback
    with pytest.raises(ValueError, match="CUDA"):
        call("meta")
    assert sum(tk.launch_counts().values()) == 0


def test_build_knows_every_kernel_source():
    names = set(_build.sources())
    assert names == {"depthwise", "bn_act", "sigmoid_mask"}
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
        assert "Replaces: tensorflowdistributedlearning_tpu/ops/pallas_kernels.py" in text, name
        assert "What bounds it on an H100" in text, name
        assert 'extern "C" int tfdl_' in text, name
        assert os.path.basename(path).endswith(".cu")
