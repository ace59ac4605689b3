"""The port's attention (``ops/flash_attention.py``) against the JAX
package's, on the CPU.

On a CPU tensor ``flash_attention`` takes its plain version, so these tests
hold the plain version (the oracle the CUDA kernel is held to on the card)
against the JAX kernel run in the Pallas interpreter (``interpret=True``,
the kernel body itself) and against ``attention_reference``. Inputs come
from numpy seeds. Tolerances:

- float32: rtol 2e-5, atol 2e-6, the JAX package's own kernel-vs-oracle
  tolerance (``tests/test_flash_attention.py``): the sums run in another
  order;
- bfloat16 inputs: both sides compute in float32 and round the output once
  to bf16, so they agree within one bf16 step (rtol 2**-7, atol 1e-6).

The JAX oracles are compiled in this process: the suite's persistent
compilation cache (the root ``conftest.py``) holds XLA:CPU executables
written on other hosts, which the loader warns were built for other
machine features. A run that loaded the kernel's executable from it held
the plain version 2.6e-5 from the kernel, where an in-process compile of
the same inputs agrees within 3e-7 (``_fresh_jax_compiles``).
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tensorflowdistributedlearning_tpu.ops.flash_attention import flash_attention as jflash
from tensorflowdistributedlearning_tpu.parallel.ring_attention import attention_reference
from tensorflowdistributedlearning_tpu_torch.ops import flash_attention as fa
from tensorflowdistributedlearning_tpu_torch.ops import kernels
from tests.test_torch_dp_worker import one_torch_thread  # noqa: F401 (autouse)


RTOL, ATOL = 2e-5, 2e-6
BF16_STEP = 2.0 ** -7


@pytest.fixture(autouse=True, scope="module")
def _fresh_jax_compiles():
    """For this module: no executable from the persistent compilation cache,
    and none from an earlier module's in-memory cache; the setting is
    restored after."""
    was = jax.config.jax_enable_compilation_cache
    jax.config.update("jax_enable_compilation_cache", False)
    jax.clear_caches()
    try:
        yield
    finally:
        jax.clear_caches()
        jax.config.update("jax_enable_compilation_cache", was)


def _qkv(seed, b=2, t=64, h=2, d=16):
    rng = np.random.default_rng(seed)
    return tuple(rng.normal(0, 1, (b, t, h, d)).astype(np.float32) for _ in range(3))


def _port(q, k, v, causal, dtype=torch.float32):
    return fa.flash_attention(*(torch.from_numpy(a).to(dtype) for a in (q, k, v)), causal=causal)


@pytest.mark.parametrize("causal", [False, True], ids=["full", "causal"])
@pytest.mark.parametrize("shape", [(2, 64, 2, 16), (1, 300, 1, 8), (3, 37, 2, 32), (1, 1, 1, 16), (2, 40, 2, 48),
                                   (1, 33, 2, 80)],
                         ids=["t64", "ragged300", "odd37", "t1", "d48", "d80"])
def test_plain_matches_jax_kernel_and_reference(causal, shape):
    b, t, h, d = shape
    q, k, v = _qkv(sum(shape) + causal, b, t, h, d)
    got = _port(q, k, v, causal).numpy()
    kernel = np.asarray(jflash(*(jnp.asarray(a) for a in (q, k, v)), causal=causal, interpret=True))
    ref = np.asarray(attention_reference(*(jnp.asarray(a) for a in (q, k, v)), causal=causal))
    assert got.shape == shape and got.dtype == np.float32
    np.testing.assert_allclose(got, kernel, rtol=RTOL, atol=ATOL)
    np.testing.assert_allclose(got, ref, rtol=RTOL, atol=ATOL)


@pytest.mark.parametrize("causal", [False, True], ids=["full", "causal"])
def test_bf16_inputs_within_one_bf16_step(causal):
    q, k, v = _qkv(4, t=40)
    qb, kb, vb = (jnp.asarray(a).astype(jnp.bfloat16) for a in (q, k, v))
    got = _port(q, k, v, causal, torch.bfloat16)
    assert got.dtype == torch.bfloat16
    want = jflash(qb, kb, vb, causal=causal, interpret=True)
    assert want.dtype == jnp.bfloat16
    np.testing.assert_allclose(got.float().numpy(), np.asarray(want, np.float32), rtol=BF16_STEP, atol=1e-6)
    ref = attention_reference(qb, kb, vb, causal=causal)
    np.testing.assert_allclose(got.float().numpy(), np.asarray(ref, np.float32), rtol=BF16_STEP, atol=1e-6)


def test_strided_views_of_one_qkv_tensor():
    """The ViT hands the kernel slices of its qkv projection: the plain arm
    gives the same result on the views as on contiguous copies."""
    rng = np.random.default_rng(7)
    qkv = torch.from_numpy(rng.normal(size=(2, 50, 3, 4, 16)).astype(np.float32))
    q, k, v = qkv[:, :, 0], qkv[:, :, 1], qkv[:, :, 2]
    assert not q.is_contiguous()
    got = fa.flash_attention(q, k, v)
    want = fa.flash_attention(q.contiguous(), k.contiguous(), v.contiguous())
    assert torch.equal(got, want)


def test_cpu_tensors_launch_nothing_and_mask_is_jax_value():
    kernels.reset_launch_counts()
    q, k, v = (torch.from_numpy(a) for a in _qkv(9, t=8))
    fa.flash_attention(q, k, v, causal=True)
    assert kernels.launch_counts()["flash_attention"] == 0
    assert fa.MASK_VALUE == -1e30


def test_rejects_mismatched_inputs():
    q = torch.zeros(1, 4, 2, 8)
    with pytest.raises(ValueError, match="one \\[B, T, H, D\\] shape"):
        fa.flash_attention(q, torch.zeros(1, 5, 2, 8), q)
    with pytest.raises(TypeError, match="dtypes differ"):
        fa.flash_attention(q, q.to(torch.bfloat16), q)


# -- the tensor-core kernel's arithmetic (csrc/flash_attention_tc.cu), emulated --

KEY_TILE = 64  # keys per K/V tile of the kernel


def attention_atol(v: torch.Tensor) -> float:
    """The float32 absolute tolerance scaled to the values, as the card's
    checks scale it: the output is a convex combination of v's rows."""
    return ATOL * max(1.0, v.float().abs().max().item())


def within_one_bf16_step(got: torch.Tensor, want: torch.Tensor, atol: float) -> bool:
    """The card's bf16 check: two bf16 results of one float32 computation
    may differ by the float32 tolerance (rtol 2e-5, ``atol``) plus one bf16
    step at the larger magnitude."""
    g, w = got.float(), want.float()
    _, e = torch.frexp(torch.maximum(g.abs(), w.abs()))
    step = torch.ldexp(torch.ones_like(g), (e - 8).clamp_min(-133))
    return bool(((g - w).abs() <= step + RTOL * w.abs() + atol).all())


def split_bf16(p: torch.Tensor, terms: int):
    """p as ``terms`` bf16 values (held in float32), each the bf16 rounding
    of what the terms before it leave: hi = bf16(p), mid = bf16(p - hi), ..."""
    parts, rest = [], p
    for _ in range(terms):
        part = rest.to(torch.bfloat16).float()
        parts.append(part)
        rest = rest - part
    return parts


def tensor_core_emulation(q, k, v, causal: bool, terms: int = 3) -> torch.Tensor:
    """The kernel's arithmetic on bf16 ``[B, T, H, D]`` inputs: Q.K^T of bf16
    values with float32 sums (each product is exact in float32), times the
    scale in float32; the online softmax over 64-key tiles in float32 (mask
    -1e30 above the diagonal, -inf past T); P.V as the sum over the bf16
    terms of p (:func:`split_bf16`; the kernel takes three, smallest first)
    of term.V, in float32; the row sum l from the unsplit p; the output
    rounded once to bf16."""
    b, t, h, d = q.shape
    qf, kf, vf = (x.float().permute(0, 2, 1, 3) for x in (q, k, v))  # [B, H, T, D]
    m = torch.full((b, h, t, 1), -torch.inf)
    l = torch.zeros((b, h, t, 1))
    o = torch.zeros((b, h, t, d))
    rows = torch.arange(t).view(t, 1)
    for k0 in range(0, t, KEY_TILE):
        kt, vt = kf[:, :, k0:k0 + KEY_TILE], vf[:, :, k0:k0 + KEY_TILE]
        s = (qf @ kt.transpose(-1, -2)) * (1.0 / d ** 0.5)
        if causal:
            keys = torch.arange(k0, k0 + kt.shape[2]).view(1, -1)
            s = torch.where(keys > rows, torch.full_like(s, fa.MASK_VALUE), s)
        m_new = torch.maximum(m, s.amax(-1, keepdim=True))
        alpha = torch.exp(m - m_new)
        p = torch.exp(s - m_new)
        l = l * alpha + p.sum(-1, keepdim=True)
        pv = torch.zeros_like(o)
        for part in reversed(split_bf16(p, terms)):
            pv = pv + part @ vt
        o = o * alpha + pv
        m = m_new
    out = o / l.clamp_min(1e-30)
    return out.permute(0, 2, 1, 3).to(torch.bfloat16)


def _bf16_qkv(seed: int, t: int, d: int, scale: float, b: int = 1, h: int = 2):
    rng = np.random.default_rng(seed)
    return tuple(torch.from_numpy((scale * rng.normal(size=(b, t, h, d))).astype(np.float32)).to(torch.bfloat16)
                 for _ in range(3))


@pytest.mark.parametrize("scale", [1.0, 2.0, 4.0], ids=["x1", "x2", "x4"])
@pytest.mark.parametrize("causal", [False, True], ids=["full", "causal"])
@pytest.mark.parametrize("d", [16, 64, 128])
@pytest.mark.parametrize("t", [1, 17, 196, 197])
def test_tensor_core_arithmetic_meets_the_bf16_contract(t, d, causal, scale):
    """The tensor-core kernel's arithmetic, emulated here, is held to what
    the card holds the kernel to: one bf16 step beyond the float32
    tolerance of the JAX kernel (interpreted) and of the plain version."""
    q, k, v = _bf16_qkv(1000 * t + d + int(scale), t, d, scale)
    got = tensor_core_emulation(q, k, v, causal)
    want_plain = fa.flash_attention_plain(q, k, v, causal=causal)
    jq = tuple(jnp.asarray(x.float().numpy()).astype(jnp.bfloat16) for x in (q, k, v))
    want_jax = torch.from_numpy(np.asarray(jflash(*jq, causal=causal, interpret=True), np.float32))
    atol = attention_atol(v)
    assert got.dtype == torch.bfloat16 and got.shape == q.shape
    assert within_one_bf16_step(got, want_plain, atol)
    assert within_one_bf16_step(got, want_jax.to(torch.bfloat16), atol)


@pytest.mark.parametrize("terms", [2, 3])
def test_split_p_meets_the_contract_where_one_rounding_misses_it(terms):
    """Why the kernel splits p: rounding p to bf16 once before P.V, the
    usual tensor-core design, lands more than one bf16 step beyond the
    float32 tolerance at the ViT's head width; two bf16 terms meet it, and
    three (the kernel's) hold p to float32 precision."""
    q, k, v = _bf16_qkv(5, 196, 64, 4.0, b=2, h=6)
    want = fa.flash_attention_plain(q, k, v)
    assert within_one_bf16_step(tensor_core_emulation(q, k, v, False, terms), want, attention_atol(v))
    assert not within_one_bf16_step(tensor_core_emulation(q, k, v, False, terms=1), want, attention_atol(v))


def test_three_terms_hold_p_to_float32_precision():
    p = torch.from_numpy(np.random.default_rng(3).random(4096).astype(np.float32))
    assert torch.equal(sum(split_bf16(p, 3)), p)
    assert not torch.equal(sum(split_bf16(p, 2)), p)


def test_dtype_picks_the_kernel():
    """bf16 inputs go to the tensor-core kernel, float32 to the redesigned
    CUDA-core one; the three entries (the earlier CUDA-core kernel too) take
    one argument list."""
    assert fa.ENTRIES == {torch.bfloat16: "tfdl_flash_attention_tc", torch.float32: "tfdl_flash_attention_f32"}
    for entry in ("tfdl_flash_attention_tc", "tfdl_flash_attention_f32"):
        assert kernels._signatures[entry][1] == kernels._signatures["tfdl_flash_attention"][1]
    assert kernels._signatures["tfdl_flash_attention_tc"][0] == "flash_attention_tc"
    assert kernels._signatures["tfdl_flash_attention_f32"][0] == "flash_attention_f32"


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_head_widths_per_dtype_follow_each_kernels_tiling(dtype):
    """Both kernels take d in steps of 16 up to 128: the tensor-core arm by
    its m16n8k16 k-steps, the float32 arm the same widths, since a
    float32-compute ViT reaches both arms."""
    assert fa.KERNEL_HEAD_DIMS[dtype] == (16, 32, 48, 64, 80, 96, 112, 128)
    assert set(fa.KERNEL_HEAD_DIMS) == set(fa.ENTRIES)
