"""The port's mixture-of-experts dispatch (``parallel/expert.py``) against
the JAX package's, on the CPU.

- ``top1_dispatch``: expert, slot and keep equal to JAX's on seeded logits
  with exact ties and capacity drops; the gate probability within 1 ulp
  (each framework's own ``exp``).
- ``dense_moe_apply`` (forward and gradients) and ``load_balance_loss``
  within 1e-6 of JAX's.
- ``moe_apply`` on 2 gloo ranks (``tests/test_torch_dp_worker.py`` mode
  ``moe``) against JAX's ``shard_map`` ``moe_apply`` on
  ``make_mesh(4, model_parallel=2)``: the output and the router's and the
  tokens' gradients within 1e-6 on both ranks, and rank e's gradient of
  its own expert E times JAX's (the ranks hold the same tokens, so the
  backward all-to-all hands expert e every rank's cotangent; the step's
  mean over the group undoes the factor, ``parallel/expert.py``).
"""

from __future__ import annotations

import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import PartitionSpec as P

from tensorflowdistributedlearning_tpu.parallel import expert as jmoe
from tensorflowdistributedlearning_tpu.parallel.mesh import MODEL_AXIS, make_mesh
from tensorflowdistributedlearning_tpu_torch import parallel as tparallel
from tensorflowdistributedlearning_tpu_torch.parallel import collectives
from tensorflowdistributedlearning_tpu_torch.parallel import expert as tmoe
from tests import test_torch_dp_worker as worker
from tests.test_torch_dp_worker import one_torch_thread  # noqa: F401 (autouse)


E = 2  # experts = ranks of the expert group
D = 8
T = 16
TOL = 1e-6


def _logits(seed: int, t: int = 64, e: int = 4) -> np.ndarray:
    """Seeded logits with exact ties (rows copied from their own max, and
    whole rows equal) on a few experts' worth of tokens."""
    rng = np.random.default_rng(seed)
    logits = rng.normal(0, 1, (t, e)).astype(np.float32)
    logits[::7, 1] = logits[::7].max(axis=1)  # a tie between the first max and column 1
    logits[3::11] = 0.5  # every expert tied
    logits[5, :] = logits[5, 2]
    return logits


@pytest.mark.parametrize("capacity", [1, 5, 12, 64])
@pytest.mark.parametrize("seed", [0, 1])
def test_top1_dispatch_equals_jax(capacity, seed):
    logits = _logits(seed)
    want = [np.asarray(a) for a in jmoe.top1_dispatch(jnp.asarray(logits), capacity)]
    got = [a.numpy() for a in tmoe.top1_dispatch(torch.from_numpy(logits), capacity)]
    for name, w, g in zip(("expert", "slot", "keep"), want[:3], got[:3]):
        np.testing.assert_array_equal(g, w, err_msg=name)
    assert (~got[2]).any() == (capacity < 64)  # drops exactly where the pool overflows a buffer
    ulp = np.spacing(np.abs(want[3]).astype(np.float32))
    assert np.all(np.abs(got[3] - want[3]) <= ulp), np.abs(got[3] - want[3]).max()


def test_top1_dispatch_routing():
    """JAX's hand-worked case: first index on a tie-free row, slots in token
    order, the second token of each expert dropped at capacity 1."""
    logits = torch.tensor([[3.0, 0.0], [0.0, 2.0], [1.0, 0.5], [0.2, 0.9]])
    expert, slot, keep, prob = tmoe.top1_dispatch(logits, capacity=1)
    assert expert.tolist() == [0, 1, 0, 1] and slot.tolist() == [0, 0, 1, 1]
    assert keep.tolist() == [True, True, False, False]
    assert bool(((prob > 0.5) & (prob < 1.0)).all())
    assert tmoe.capacity_of(16, 2, 1.25) == 10 and tmoe.capacity_of(3, 8, 0.25) == 1


def _stacked(seed: int, e: int = E):
    rng = np.random.default_rng(seed)
    return {"w": rng.normal(0, 0.5, (e, D, D)).astype(np.float32), "b": rng.normal(0, 0.1, (e, D)).astype(np.float32)}


def _jax_expert_fn(p, x):
    return jnp.tanh(x @ p["w"] + p["b"])


@pytest.mark.parametrize("factor", [1.25, 0.25])
def test_dense_moe_apply_and_its_gradients_equal_jax(factor):
    rng = np.random.default_rng(3)
    stacked = _stacked(4, e=4)
    gate = rng.normal(0, 1, (D, 4)).astype(np.float32)
    x = rng.normal(0, 1, (T, D)).astype(np.float32)
    w_out = rng.normal(0, 1, (T, D)).astype(np.float32)

    def jloss(p, g, t):
        return jnp.sum(w_out * jmoe.dense_moe_apply(_jax_expert_fn, p, g, t, capacity_factor=factor))

    jout = np.asarray(jmoe.dense_moe_apply(_jax_expert_fn, jax.tree.map(jnp.asarray, stacked), jnp.asarray(gate),
                                           jnp.asarray(x), capacity_factor=factor))
    jgrads = jax.grad(jloss, argnums=(0, 1, 2))(jax.tree.map(jnp.asarray, stacked), jnp.asarray(gate), jnp.asarray(x))
    tp = {k: torch.from_numpy(v).requires_grad_() for k, v in stacked.items()}
    tg, tx = torch.from_numpy(gate).requires_grad_(), torch.from_numpy(x).requires_grad_()
    out = tmoe.dense_moe_apply(worker.moe_expert_fn, tp, tg, tx, capacity_factor=factor)
    np.testing.assert_allclose(out.detach().numpy(), jout, rtol=0, atol=TOL)
    if factor < 1:
        assert (np.abs(jout).sum(axis=1) == 0).any()  # a dropped token's update is zero
    (torch.from_numpy(w_out) * out).sum().backward()
    for got, want in ((tp["w"].grad, jgrads[0]["w"]), (tp["b"].grad, jgrads[0]["b"]), (tg.grad, jgrads[1]),
                      (tx.grad, jgrads[2])):
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0, atol=TOL)


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_load_balance_loss_and_fractions_equal_jax(seed):
    logits = _logits(seed, t=96, e=8) * 3
    want = float(jmoe.load_balance_loss(jnp.asarray(logits)))
    got = float(tmoe.load_balance_loss(torch.from_numpy(logits)))
    assert abs(got - want) <= TOL, (got, want)
    fractions = tmoe.expert_fractions(torch.from_numpy(logits))
    assert fractions.dtype == torch.float32 and abs(float(fractions.sum()) - 1.0) <= 1e-6
    np.testing.assert_array_equal(fractions.numpy(),
                                  np.asarray(jnp.mean(jax.nn.one_hot(jnp.argmax(logits, -1), 8), axis=0)))
    # bf16 logits: the loss is float32 all the same
    assert tmoe.load_balance_loss(torch.from_numpy(logits).bfloat16()).dtype == torch.float32
    # 1 at a uniform router (every expert chosen equally often)
    uniform = torch.zeros(8, 8) + torch.eye(8) * 1e-3
    assert abs(float(tmoe.load_balance_loss(uniform)) - 1.0) <= 1e-6


def test_one_rank_group_is_the_dense_layer():
    """Without a process group ``moe_apply`` has one rank: a one-expert
    router runs as the dense layer, and a wider one is refused with JAX's
    reason."""
    rng = np.random.default_rng(5)
    stacked = _stacked(6, e=1)
    x = torch.from_numpy(rng.normal(0, 1, (T, D)).astype(np.float32))
    gate = torch.from_numpy(rng.normal(0, 1, (D, 1)).astype(np.float32))
    mine = {k: torch.from_numpy(v[0]) for k, v in stacked.items()}
    dense = tmoe.dense_moe_apply(worker.moe_expert_fn, {k: torch.from_numpy(v) for k, v in stacked.items()}, gate, x)
    assert torch.equal(tmoe.moe_apply(worker.moe_expert_fn, mine, gate, x), dense)
    with pytest.raises(ValueError, match="an over-wide router would dispatch out of the capacity buffer"):
        tmoe.moe_apply(worker.moe_expert_fn, mine, torch.zeros(D, 2), x)
    assert collectives.all_to_all(x) is x
    assert tparallel.moe_apply is tmoe.moe_apply and tparallel.top1_dispatch is tmoe.top1_dispatch


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    d = tmp_path_factory.mktemp("moe")
    rng = np.random.default_rng(11)
    data = dict(_stacked(12), gate=rng.normal(0, 1, (D, E)).astype(np.float32),
                x=rng.normal(0, 1, (T, D)).astype(np.float32), w_out=rng.normal(0, 1, (T, D)).astype(np.float32))
    np.savez(d / "moe.npz", **data)
    started = worker.start("moe", E, str(d))
    try:
        jax_out = {name: _jax_moe(data, factor) for name, factor in worker.MOE_FACTORS.items()}
    finally:
        out = worker.finish(started)
    return data, jax_out, out


def _jax_moe(data, factor):
    """JAX's ``moe_apply`` inside ``shard_map`` on a (2, 2) mesh (the tokens
    replicated, expert e on model shard e), its output and the gradients
    of ``sum(w_out * out)``."""
    mesh = make_mesh(4, model_parallel=E)

    def run(stacked, gate, x):
        def body(p, g, t):
            out = jmoe.moe_apply(_jax_expert_fn, jax.tree.map(lambda a: a[0], p), g, t, capacity_factor=factor)
            return jax.lax.pmean(out, MODEL_AXIS)

        return jax.shard_map(body, mesh=mesh, in_specs=(P(MODEL_AXIS), P(), P()), out_specs=P())(stacked, gate, x)

    args = ({"w": jnp.asarray(data["w"]), "b": jnp.asarray(data["b"])}, jnp.asarray(data["gate"]),
            jnp.asarray(data["x"]))
    out = np.asarray(jax.jit(run)(*args))
    grads = jax.jit(jax.grad(lambda *a: jnp.sum(jnp.asarray(data["w_out"]) * run(*a)), argnums=(0, 1, 2)))(*args)
    return {"out": out, "w": np.asarray(grads[0]["w"]), "b": np.asarray(grads[0]["b"]), "gate": np.asarray(grads[1]),
            "x": np.asarray(grads[2])}


def test_moe_apply_on_two_ranks_equals_jax_shard_map(ranks):
    data, jax_out, out = ranks
    for rank, o in enumerate(out):
        assert o["layout"] == [1, E, rank, E, 1]
        for name in worker.MOE_FACTORS:
            want, got = jax_out[name], o[name]
            for key in ("out", "gate", "x"):
                np.testing.assert_allclose(got[key].numpy(), want[key], rtol=0, atol=TOL, err_msg=f"{name} {key}")
            for key in ("w", "b"):
                np.testing.assert_allclose(got[key].numpy(), E * want[key][rank], rtol=0, atol=E * TOL,
                                           err_msg=f"{name} {key} of expert {rank}")
    assert (np.abs(jax_out["drop"]["out"]).sum(axis=1) == 0).any()
    # the ranks' outputs are one: the combine reads the same returned rows on each
    assert all(torch.equal(o[n]["out"], out[0][n]["out"]) for o in out for n in worker.MOE_FACTORS)
    cap = math.ceil(T * 1.25 / E)
    assert out[0]["wide_error"] == (
        f"gate_kernel routes over {2 * E} experts but the expert group has {E} ranks (one expert each); an "
        "over-wide router would dispatch out of the capacity buffer") and cap == 10
