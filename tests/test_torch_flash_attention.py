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
"""

from __future__ import annotations

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tensorflowdistributedlearning_tpu.ops.flash_attention import flash_attention as jflash
from tensorflowdistributedlearning_tpu.parallel.ring_attention import attention_reference
from tensorflowdistributedlearning_tpu_torch.ops import flash_attention as fa
from tensorflowdistributedlearning_tpu_torch.ops import kernels

RTOL, ATOL = 2e-5, 2e-6
BF16_STEP = 2.0 ** -7


def _qkv(seed, b=2, t=64, h=2, d=16):
    rng = np.random.default_rng(seed)
    return tuple(rng.normal(0, 1, (b, t, h, d)).astype(np.float32) for _ in range(3))


def _port(q, k, v, causal, dtype=torch.float32):
    return fa.flash_attention(*(torch.from_numpy(a).to(dtype) for a in (q, k, v)), causal=causal)


@pytest.mark.parametrize("causal", [False, True], ids=["full", "causal"])
@pytest.mark.parametrize("shape", [(2, 64, 2, 16), (1, 300, 1, 8), (3, 37, 2, 32), (1, 1, 1, 16)],
                         ids=["t64", "ragged300", "odd37", "t1"])
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
