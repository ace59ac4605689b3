"""The port's ring attention (``parallel/ring_attention.py``) against the
JAX package's on the CPU, at ``rtol 2e-5, atol 2e-6``.

- ``attention_reference`` with ``causal``, ``kv_mask``, ``segment_ids``
  and all three composed is JAX's, forward and gradients (``jax.vjp``),
  on one process; so is ``ring_attention`` without a group (one block).
- 4 gloo ranks as one sequence group (``tests/test_torch_dp_worker.py``
  mode ``ring``, one launch, started before the JAX references are
  computed): ``make_ring_attention`` over the global Q/K/V takes each
  rank's block round the ring; the ranks' outputs put together are JAX's
  ``attention_reference`` and JAX's ``make_ring_attention`` on a 4-device
  sequence mesh, and their gradients (each rank's block of Q, K and V)
  summed are JAX's gradients of the reference, for every case.
"""

from __future__ import annotations

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tensorflowdistributedlearning_tpu.parallel import make_mesh
from tensorflowdistributedlearning_tpu.parallel.ring_attention import attention_reference as jreference
from tensorflowdistributedlearning_tpu.parallel.ring_attention import make_ring_attention as jmake_ring
from tensorflowdistributedlearning_tpu_torch.parallel.ring_attention import attention_reference, ring_attention
from tests import test_torch_dp_worker as worker
from tests.test_torch_dp_worker import one_torch_thread  # noqa: F401 (autouse)


RTOL, ATOL = 2e-5, 2e-6
WORLD = 4
SHAPE = (2, 4 * WORLD, 2, 8)  # [B, S, H, D]: 4 tokens a rank
CASES = worker.RING_CASES


def _data(seed=0):
    rng = np.random.default_rng(seed)
    b, s = SHAPE[:2]
    d = {k: rng.normal(size=SHAPE).astype(np.float32) for k in ("q", "k", "v", "g")}
    mask = rng.uniform(size=(b, s)) > 0.3
    mask[1, : s // 2] = False  # a padded half: early rows see no key for a while
    d["kv_mask"] = mask
    seg = np.sort(rng.integers(0, 3, size=(b, s)), axis=1).astype(np.int32)
    seg[0, -3:] = 7  # a segment whose keys are all padding below
    d["segment_ids"] = seg
    d["kv_mask"][0, -3:] = False  # ... so those queries see nothing: zeros
    return d


def _extras(d, masked, segmented):
    return ([d["kv_mask"]] if masked else []) + ([d["segment_ids"]] if segmented else [])


def _jax_case(d, causal, masked, segmented):
    """JAX's reference output and its gradients of ``sum(out * g)``."""
    kw = dict(causal=causal, kv_mask=jnp.asarray(d["kv_mask"]) if masked else None,
              segment_ids=jnp.asarray(d["segment_ids"]) if segmented else None)
    out, vjp = jax.vjp(lambda q, k, v: jreference(q, k, v, **kw), *(jnp.asarray(d[n]) for n in ("q", "k", "v")))
    return np.asarray(out), [np.asarray(g) for g in vjp(jnp.asarray(d["g"]))]


def _port_case(fn, d, masked, segmented):
    leaves = [torch.from_numpy(d[n]).requires_grad_(True) for n in ("q", "k", "v")]
    extras = [torch.from_numpy(e) for e in _extras(d, masked, segmented)]
    out = fn(*leaves, *extras)
    (out * torch.from_numpy(d["g"])).sum().backward()
    return out.detach().numpy(), [t.grad.numpy() for t in leaves]


def _close(got, want):
    np.testing.assert_allclose(got, want, rtol=RTOL, atol=ATOL)


@pytest.fixture(scope="module")
def ring(tmp_path_factory):
    d = str(tmp_path_factory.mktemp("ring"))
    data = _data()
    np.savez(os.path.join(d, "ring.npz"), **data)
    launch = worker.start("ring", WORLD, d)
    want = {name: _jax_case(data, *flags) for name, flags in CASES.items()}
    mesh = make_mesh(WORLD, sequence_parallel=WORLD)
    jring = jmake_ring(mesh, causal=True, masked=True, segmented=True, batch_axis=None)
    composed = np.asarray(jring(*(data[n] for n in ("q", "k", "v")), data["kv_mask"], data["segment_ids"]))
    return dict(data=data, want=want, jax_ring=composed, ranks=worker.finish(launch))


@pytest.mark.parametrize("name", list(CASES))
def test_reference_is_jax_s(name):
    causal, masked, segmented = CASES[name]
    d = _data(1)
    want_out, want_grads = _jax_case(d, causal, masked, segmented)
    fn = lambda q, k, v, *e: attention_reference(  # noqa: E731
        q, k, v, causal=causal, kv_mask=e[0] if masked else None, segment_ids=e[-1] if segmented else None)
    out, grads = _port_case(fn, d, masked, segmented)
    _close(out, want_out)
    for g, w in zip(grads, want_grads):
        _close(g, w)


@pytest.mark.parametrize("name", list(CASES))
def test_one_block_ring_is_the_reference(name):
    """Without a sequence group the ring is the blockwise online softmax
    over the one local block: JAX's reference, forward and gradients."""
    causal, masked, segmented = CASES[name]
    d = _data(2)
    want_out, want_grads = _jax_case(d, causal, masked, segmented)
    fn = lambda q, k, v, *e: ring_attention(  # noqa: E731
        q, k, v, causal=causal, kv_mask=e[0] if masked else None, segment_ids=e[-1] if segmented else None)
    out, grads = _port_case(fn, d, masked, segmented)
    _close(out, want_out)
    for g, w in zip(grads, want_grads):
        _close(g, w)


@pytest.mark.parametrize("name", list(CASES))
def test_ring_over_four_ranks_is_jax_s(ring, name):
    ranks = ring["ranks"]
    out = np.concatenate([r[name]["y"].numpy() for r in ranks], axis=1)
    want_out, want_grads = ring["want"][name]
    _close(out, want_out)
    for i, w in enumerate(want_grads):
        _close(sum(r[name]["grads"][i] for r in ranks).numpy(), w)
    if name == "composed":
        _close(out, ring["jax_ring"])
        # the fully masked queries return exact zeros
        assert not np.any(out[0, -3:])
