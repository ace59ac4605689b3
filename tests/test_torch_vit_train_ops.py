"""The pieces of the port's ViT training path against the JAX package's, on
the CPU: softmax cross entropy and top-k (``ops/losses.py``,
``ops/metrics.py``), ``ClassificationTask``'s loss and metrics
(``train/step.py``), the classification augmentations
(``data/augment.py``) and the backward of ``flash_attention``
(``ops/flash_attention.py``). Inputs are numpy draws from fixed seeds.

Tolerances, stated where used:

- cross entropy and top-k: 1e-6 (float32 sums in another order);
- the augmentations: bit for bit, the JAX draws fed into the port's apply
  (``jax.random`` and ``torch.Generator`` cannot give the same numbers);
- the attention backward against ``jax.vjp`` of the JAX kernel run in the
  Pallas interpreter: float32 rtol 1e-5 and atol 1e-6·max(1, max|g|)
  (the products sum in another order); bfloat16 within one bf16 step (both
  sides compute in float32 and round once to bf16).
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tensorflowdistributedlearning_tpu.data import augment as jaugment
from tensorflowdistributedlearning_tpu.ops import losses as jlosses
from tensorflowdistributedlearning_tpu.ops import metrics as jmetrics
from tensorflowdistributedlearning_tpu.ops.flash_attention import flash_attention as jflash
from tensorflowdistributedlearning_tpu.train import step as jstep
from tensorflowdistributedlearning_tpu_torch.data import augment as taugment
from tensorflowdistributedlearning_tpu_torch.ops import flash_attention as fa
from tensorflowdistributedlearning_tpu_torch.ops import kernels
from tensorflowdistributedlearning_tpu_torch.ops import losses as tlosses
from tensorflowdistributedlearning_tpu_torch.ops import metrics as tmetrics
from tensorflowdistributedlearning_tpu_torch.train import step as tstep
from tests.test_torch_dp_worker import one_torch_thread  # noqa: F401 (autouse)


TOL_CE = 1e-6
BF16_STEP = 2.0 ** -7


def _logits(seed, b=16, k=10, scale=3.0):
    """Logits without ties (continuous draws) and integer labels."""
    rng = np.random.default_rng(seed)
    return rng.normal(0, scale, (b, k)).astype(np.float32), rng.integers(0, k, b).astype(np.int32)


# -- losses and metrics -----------------------------------------------------------


@pytest.mark.parametrize("smoothing", [0.0, 0.1, 0.3])
@pytest.mark.parametrize("k", [2, 10, 1000])
def test_softmax_cross_entropy_matches_jax(smoothing, k):
    logits, labels = _logits(k + int(10 * smoothing), k=k)
    got = tlosses.softmax_cross_entropy_per_example(torch.from_numpy(logits), torch.from_numpy(labels), smoothing)
    want = jlosses.softmax_cross_entropy_per_example(jnp.asarray(logits), jnp.asarray(labels), smoothing)
    assert got.shape == (16,) and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=TOL_CE, atol=TOL_CE)
    mean = tlosses.softmax_cross_entropy(torch.from_numpy(logits), torch.from_numpy(labels), smoothing)
    np.testing.assert_allclose(float(mean), float(jlosses.softmax_cross_entropy(
        jnp.asarray(logits), jnp.asarray(labels), smoothing)), rtol=TOL_CE, atol=TOL_CE)


@pytest.mark.parametrize("smoothing", [0.0, 0.1])
def test_smoothed_cross_entropy_is_torch_label_smoothing(smoothing):
    """The JAX form ``-(1-s)·logp_true - (s/K)·sum(logp)`` and
    ``F.cross_entropy(label_smoothing=s)`` are one quantity."""
    logits, labels = _logits(3)
    got = tlosses.softmax_cross_entropy(torch.from_numpy(logits), torch.from_numpy(labels), smoothing)
    want = torch.nn.functional.cross_entropy(torch.from_numpy(logits), torch.from_numpy(labels).long(),
                                             label_smoothing=smoothing)
    assert abs(float(got) - float(want)) <= TOL_CE


def test_bf16_logits_take_float32_log_softmax():
    logits, labels = _logits(5)
    lb = torch.from_numpy(logits).to(torch.bfloat16)
    got = tlosses.softmax_cross_entropy_per_example(lb, torch.from_numpy(labels), 0.1)
    want = jlosses.softmax_cross_entropy_per_example(jnp.asarray(logits).astype(jnp.bfloat16), jnp.asarray(labels),
                                                     0.1)
    assert got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=TOL_CE, atol=TOL_CE)


@pytest.mark.parametrize("k_classes, k", [(10, 5), (10, 1), (5, 5), (4, 5), (1000, 5)])
def test_top1_and_topk_match_jax(k_classes, k):
    logits, labels = _logits(k_classes + k, b=64, k=k_classes, scale=1.0)
    t_logits, t_labels = torch.from_numpy(logits), torch.from_numpy(labels)
    np.testing.assert_array_equal(tmetrics.top1_accuracy_scores(t_logits, t_labels).numpy(),
                                  np.asarray(jmetrics.top1_accuracy_scores(jnp.asarray(logits), jnp.asarray(labels))))
    got = tmetrics.topk_accuracy_scores(t_logits, t_labels, k=k)
    want = jmetrics.topk_accuracy_scores(jnp.asarray(logits), jnp.asarray(labels), k=k)
    assert got.dtype == torch.float32
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_topk_falls_back_to_top1_when_k_covers_the_classes():
    logits, labels = _logits(8, b=64, k=5, scale=1.0)
    t_logits, t_labels = torch.from_numpy(logits), torch.from_numpy(labels)
    top1 = tmetrics.top1_accuracy_scores(t_logits, t_labels)
    assert torch.equal(tmetrics.topk_accuracy_scores(t_logits, t_labels, k=5), top1)
    assert float(top1.mean()) < 1.0


# -- the classification task --------------------------------------------------------


@pytest.mark.parametrize("smoothing", [0.0, 0.1])
@pytest.mark.parametrize("mixed", [False, True], ids=["plain", "lam"])
def test_classification_task_loss_matches_jax(smoothing, mixed):
    logits, labels = _logits(11, k=10)
    rng = np.random.default_rng(12)
    batch = {"labels": labels}
    if mixed:
        batch.update(labels_b=rng.integers(0, 10, 16).astype(np.int32), lam=rng.uniform(0.5, 1, 16).astype(np.float32))
    got = tstep.ClassificationTask(label_smoothing=smoothing).loss(
        torch.from_numpy(logits), {k: torch.from_numpy(v) for k, v in batch.items()})
    want = jstep.ClassificationTask(label_smoothing=smoothing).loss(
        jnp.asarray(logits), {k: jnp.asarray(v) for k, v in batch.items()})
    assert abs(float(got) - float(want)) <= TOL_CE


@pytest.mark.parametrize("k_classes", [4, 10])
def test_classification_task_eval_loss_and_metrics_match_jax(k_classes):
    logits, labels = _logits(k_classes, k=k_classes)
    tb, jb = {"labels": torch.from_numpy(labels)}, {"labels": jnp.asarray(labels)}
    task, jtask = tstep.ClassificationTask(label_smoothing=0.1), jstep.ClassificationTask(label_smoothing=0.1)
    # eval cross entropy is unsmoothed
    np.testing.assert_allclose(task.loss_per_example(torch.from_numpy(logits), tb).numpy(),
                               np.asarray(jtask.loss_per_example(jnp.asarray(logits), jb)), rtol=TOL_CE, atol=TOL_CE)
    got = task.metric_scores(torch.from_numpy(logits), tb)
    want = jtask.metric_scores(jnp.asarray(logits), jb)
    assert sorted(got) == sorted(want) == (["metrics/top1", "metrics/top5"] if k_classes > 5 else ["metrics/top1"])
    for name in want:
        np.testing.assert_array_equal(got[name].numpy(), np.asarray(want[name]))


# -- augmentations: JAX's draws through the port's apply -------------------------------


def _images(seed, b=6, h=16, w=12, c=3):
    return np.random.default_rng(seed).normal(size=(b, h, w, c)).astype(np.float32)


@pytest.mark.parametrize("pad, flip", [(4, True), (2, False), (1, True), (0, True)])
def test_classification_augment_apply_is_jax_bit_for_bit(pad, flip):
    images = _images(pad)
    key = jax.random.key(pad + 10 * flip)
    want = np.asarray(jaugment.augment_classification_batch(key, jnp.asarray(images), crop_padding=pad, flip=flip))
    kf, ky, kx = jax.random.split(key, 3)
    b = images.shape[0]
    flips = torch.from_numpy(np.array(jax.random.bernoulli(kf, 0.5, (b,)))) if flip else None
    ys = xs = None
    if pad:
        ys = torch.from_numpy(np.array(jax.random.randint(ky, (b,), 0, 2 * pad + 1)))
        xs = torch.from_numpy(np.array(jax.random.randint(kx, (b,), 0, 2 * pad + 1)))
    got = taugment.apply_classification_augment(torch.from_numpy(images), flips, ys, xs, crop_padding=pad)
    np.testing.assert_array_equal(got.numpy(), want)


def test_mixup_apply_is_jax_bit_for_bit():
    images, labels = _images(21), np.arange(6, dtype=np.int32)
    key = jax.random.key(21)
    want = jaugment.mixup_batch(key, jnp.asarray(images), jnp.asarray(labels))
    kp, kl = jax.random.split(key)
    perm = torch.from_numpy(np.array(jax.random.permutation(kp, 6)))
    lam = torch.from_numpy(np.array(jax.random.beta(kl, 0.2, 0.2, (6,))))
    got = taugment.apply_mixup(torch.from_numpy(images), torch.from_numpy(labels), perm, lam)
    assert sorted(got) == sorted(want)
    for name in want:
        np.testing.assert_array_equal(got[name].numpy(), np.asarray(want[name]), err_msg=name)
    assert got["lam"].dtype == torch.float32 and bool((got["lam"] >= 0.5).all())


def test_cutmix_apply_is_jax_bit_for_bit():
    images, labels = _images(31, b=8, h=17, w=13), np.arange(8, dtype=np.int32)
    key = jax.random.key(31)
    want = jaugment.cutmix_batch(key, jnp.asarray(images), jnp.asarray(labels))
    kp, kl, ky, kx = jax.random.split(key, 4)
    draws = dict(perm=jax.random.permutation(kp, 8), lam0=jax.random.beta(kl, 1.0, 1.0, (8,)),
                 cy=jax.random.randint(ky, (8,), 0, 17), cx=jax.random.randint(kx, (8,), 0, 13))
    got = taugment.apply_cutmix(torch.from_numpy(images), torch.from_numpy(labels),
                                **{k: torch.from_numpy(np.array(v)) for k, v in draws.items()})
    assert sorted(got) == sorted(want)
    for name in want:
        np.testing.assert_array_equal(got[name].numpy(), np.asarray(want[name]), err_msg=name)


def test_cutmix_lam_is_the_surviving_area_after_clamping():
    """A box centred at a corner is clamped: ``lam`` counts the pixels that
    kept their own image."""
    images = torch.from_numpy(_images(41, b=2, h=10, w=10))
    out = taugment.apply_cutmix(images, torch.arange(2), torch.tensor([1, 0]), torch.tensor([0.36, 0.36]),
                                torch.tensor([0, 5]), torch.tensor([0, 5]))
    # sides int(0.8 * 10) = 8: the corner box keeps rows/cols [0, 4), the centred one [1, 9)
    np.testing.assert_allclose(out["lam"].numpy(), [1 - 16 / 100, 1 - 64 / 100], rtol=1e-7)
    kept = (out["images"] == images).all(dim=-1).float().mean(dim=(1, 2))
    np.testing.assert_allclose(kept.numpy(), out["lam"].numpy(), rtol=1e-7)


@pytest.mark.parametrize("alpha, var", [(0.2, 0.25 / 1.4), (1.0, 1.0 / 12.0)])
def test_beta_sample_follows_the_beta_distribution(alpha, var):
    """Mean 1/2 and variance 1/(4(2a+1)) of Beta(a, a) over 20 000 draws
    (5 standard errors)."""
    gen = torch.Generator().manual_seed(0)
    x = taugment.beta_sample(gen, 20_000, alpha)
    assert x.dtype == torch.float32 and bool(((x >= 0) & (x <= 1)).all())
    assert abs(float(x.mean()) - 0.5) < 5 * (var / 20_000) ** 0.5
    assert abs(float(x.var()) - var) < 0.02 * var + 5e-3


@pytest.mark.parametrize("policy", ["flip_crop", "crop", "none", "mixup", "cutmix"])
def test_prepare_classification_batch_policies(policy):
    gen = torch.Generator().manual_seed(3)
    batch = {"images": torch.from_numpy(_images(51, b=8, h=16, w=16)), "labels": torch.arange(8, dtype=torch.int32)}
    out = taugment.prepare_classification_batch(gen, batch, policy)
    if policy == "none":
        assert out is batch
        return
    assert out["images"].shape == batch["images"].shape
    assert torch.equal(out["labels"], batch["labels"])
    assert ("lam" in out) == (policy in ("mixup", "cutmix"))
    again = taugment.prepare_classification_batch(torch.Generator().manual_seed(3), batch, policy)
    assert all(torch.equal(out[k], again[k]) for k in out)


# -- the attention backward -----------------------------------------------------------


def _jax_vjp(q, k, v, g, causal, dtype=jnp.float32):
    args = tuple(jnp.asarray(a).astype(dtype) for a in (q, k, v))
    _, vjp = jax.vjp(lambda a, b, c: jflash(a, b, c, causal=causal, interpret=True), *args)
    return vjp(jnp.asarray(g).astype(dtype))


def _qkvg(seed, shape):
    rng = np.random.default_rng(seed)
    return tuple(rng.normal(0, 1, shape).astype(np.float32) for _ in range(4))


def _port_grads(q, k, v, g, causal, dtype=torch.float32):
    ts = [torch.from_numpy(a).to(dtype).requires_grad_(True) for a in (q, k, v)]
    out = fa.flash_attention(*ts, causal=causal)
    out.backward(torch.from_numpy(g).to(dtype))
    return out, [t.grad for t in ts]


@pytest.mark.parametrize("causal", [False, True], ids=["full", "causal"])
@pytest.mark.parametrize("shape", [(2, 20, 3, 16), (1, 37, 2, 32), (2, 1, 1, 16)], ids=["t20", "t37", "t1"])
def test_float32_backward_matches_jax_vjp(causal, shape):
    q, k, v, g = _qkvg(sum(shape) + causal, shape)
    _, got = _port_grads(q, k, v, g, causal)
    want = _jax_vjp(q, k, v, g, causal)
    atol = 1e-6 * max(1.0, float(np.abs(g).max()))
    for name, a, b in zip("qkv", got, want):
        assert a.dtype == torch.float32
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-5, atol=atol, err_msg=f"d{name}")


@pytest.mark.parametrize("causal", [False, True], ids=["full", "causal"])
def test_bf16_backward_within_one_bf16_step(causal):
    q, k, v, g = _qkvg(60 + causal, (2, 20, 3, 16))
    _, got = _port_grads(q, k, v, g, causal, torch.bfloat16)
    want = _jax_vjp(q, k, v, g, causal, jnp.bfloat16)
    for name, a, b in zip("qkv", got, want):
        assert a.dtype == torch.bfloat16 and b.dtype == jnp.bfloat16
        np.testing.assert_allclose(a.float().numpy(), np.asarray(b, np.float32), rtol=BF16_STEP, atol=1e-6,
                                   err_msg=f"d{name}")


def test_backward_reaches_one_qkv_tensor_through_its_strided_views():
    """The ViT's q, k, v are views of its qkv projection: the gradient of
    the whole tensor is the three gradients in their slots, and nothing
    launches on the CPU."""
    rng = np.random.default_rng(70)
    qkv_np = rng.normal(size=(2, 20, 3, 3, 16)).astype(np.float32)
    g = rng.normal(size=(2, 20, 3, 16)).astype(np.float32)
    kernels.reset_launch_counts()
    qkv = torch.from_numpy(qkv_np).requires_grad_(True)
    out = fa.flash_attention(qkv[:, :, 0], qkv[:, :, 1], qkv[:, :, 2])
    out.backward(torch.from_numpy(g))
    assert kernels.launch_counts()["flash_attention"] == 0
    want = _jax_vjp(qkv_np[:, :, 0], qkv_np[:, :, 1], qkv_np[:, :, 2], g, False)
    for j in range(3):
        np.testing.assert_allclose(qkv.grad[:, :, j].numpy(), np.asarray(want[j]), rtol=1e-5, atol=1e-6 * np.abs(g).max())


def test_backward_is_flash_attention_backward_and_saves_only_the_inputs():
    q, k, v, g = (torch.from_numpy(a) for a in _qkvg(80, (1, 9, 2, 16)))
    qs, ks, vs = (t.clone().requires_grad_(True) for t in (q, k, v))
    out = fa.flash_attention(qs, ks, vs, causal=True)
    assert [t.data_ptr() for t in out.grad_fn.saved_tensors] == [qs.data_ptr(), ks.data_ptr(), vs.data_ptr()]
    out.backward(g)
    for got, want in zip((qs.grad, ks.grad, vs.grad), fa.flash_attention_backward(q, k, v, g, causal=True)):
        assert torch.equal(got, want)


def test_no_graph_without_inputs_that_need_a_gradient():
    q, k, v, _ = (torch.from_numpy(a) for a in _qkvg(90, (1, 5, 1, 16)))
    assert fa.flash_attention(q, k, v).grad_fn is None
    with torch.no_grad():
        assert fa.flash_attention(q.requires_grad_(True), k, v).grad_fn is None
