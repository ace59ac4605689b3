"""The port's training ops against the JAX package's, on the CPU: the Lovász
hinge and its gradient, the streaming metrics, the depthwise conv's autograd
(plain arms) against ``jax.grad`` through the Pallas kernel in interpret
mode, training-mode BatchNorm, and the fused BN+act kernel arm refusing a
gradient. Inputs are made with numpy from seeds; each tolerance is stated
where it is used.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax import linen as jnn

from tensorflowdistributedlearning_tpu.ops import losses as jlosses
from tensorflowdistributedlearning_tpu.ops import metrics as jmetrics
from tensorflowdistributedlearning_tpu.ops import pallas_kernels as jk
from tensorflowdistributedlearning_tpu_torch.models import layers as tlayers
from tensorflowdistributedlearning_tpu_torch.ops import kernels as tk
from tensorflowdistributedlearning_tpu_torch.ops import losses as tlosses
from tensorflowdistributedlearning_tpu_torch.ops import metrics as tmetrics
from tests.test_torch_dp_worker import one_torch_thread  # noqa: F401 (autouse)



@pytest.fixture(autouse=True)
def _zero_counts():
    tk.reset_launch_counts()
    yield


def _seg_batch(seed, b=4, h=9, w=11, empty_rows=(1,)):
    rng = np.random.default_rng(seed)
    logits = rng.normal(size=(b, h, w)).astype(np.float32) * 2.0
    labels = (rng.uniform(size=(b, h, w)) > 0.5).astype(np.float32)
    for r in empty_rows:
        labels[r] = 0.0
    return logits, labels


# -- Lovász hinge (tolerance 1e-6: same f32 arithmetic in another order) ------------


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_lovasz_per_image_matches_jax(seed):
    logits, labels = _seg_batch(seed)
    want = np.asarray(jlosses.lovasz_hinge_per_image(jnp.asarray(logits), jnp.asarray(labels)))
    got = tlosses.lovasz_hinge_per_image(torch.from_numpy(logits), torch.from_numpy(labels)).numpy()
    np.testing.assert_allclose(got, want, atol=1e-6, rtol=1e-6)
    np.testing.assert_allclose(
        float(tlosses.lovasz_hinge(torch.from_numpy(logits), torch.from_numpy(labels))),
        float(jlosses.lovasz_hinge(jnp.asarray(logits), jnp.asarray(labels))), atol=1e-6, rtol=1e-6,
    )


def test_lovasz_loss_layout_and_flat_match_jax():
    logits, labels = _seg_batch(3)
    y_pred, y_true = logits[..., None], labels[..., None]
    np.testing.assert_allclose(
        float(tlosses.lovasz_loss(torch.from_numpy(y_true), torch.from_numpy(y_pred))),
        float(jlosses.lovasz_loss(jnp.asarray(y_true), jnp.asarray(y_pred))), atol=1e-6, rtol=1e-6,
    )
    np.testing.assert_allclose(
        float(tlosses.lovasz_hinge(torch.from_numpy(logits), torch.from_numpy(labels), per_image=False)),
        float(jlosses.lovasz_hinge(jnp.asarray(logits), jnp.asarray(labels), per_image=False)),
        atol=1e-6, rtol=1e-6,
    )


def test_lovasz_void_pixels_match_jax():
    logits, labels = _seg_batch(4)
    labels = labels.copy()
    labels[0, :3] = 255  # the ignore label
    labels[2] = 255  # an all-void image scores 0
    want = np.asarray(jlosses.lovasz_hinge_per_image(jnp.asarray(logits), jnp.asarray(labels), ignore=255))
    got = tlosses.lovasz_hinge_per_image(torch.from_numpy(logits), torch.from_numpy(labels), ignore=255).numpy()
    assert got[2] == 0.0
    np.testing.assert_allclose(got, want, atol=1e-6, rtol=1e-6)


def test_lovasz_grad_matches_jax():
    rng = np.random.default_rng(5)
    gt = (rng.uniform(size=(50,)) > 0.4).astype(np.float32)
    valid = (rng.uniform(size=(50,)) > 0.2).astype(np.float32)
    for v in (None, valid):
        want = np.asarray(jlosses.lovasz_grad(jnp.asarray(gt), None if v is None else jnp.asarray(v)))
        got = tlosses.lovasz_grad(torch.from_numpy(gt), None if v is None else torch.from_numpy(v)).numpy()
        np.testing.assert_allclose(got, want, atol=1e-6, rtol=0)


def test_lovasz_gradient_matches_jax_on_tie_free_logits():
    # distinct errors everywhere, so sort order (and the gradient) is unique
    rng = np.random.default_rng(6)
    logits = rng.permutation(np.linspace(-3, 3, 2 * 7 * 8)).reshape(2, 7, 8).astype(np.float32)
    labels = (rng.uniform(size=logits.shape) > 0.5).astype(np.float32)
    want = np.asarray(jax.grad(lambda z: jlosses.lovasz_hinge(z, jnp.asarray(labels)))(jnp.asarray(logits)))
    z = torch.from_numpy(logits).requires_grad_(True)
    tlosses.lovasz_hinge(z, torch.from_numpy(labels)).backward()
    np.testing.assert_allclose(z.grad.numpy(), want, atol=1e-6, rtol=0)


def test_sigmoid_cross_entropy_matches_jax():
    logits, labels = _seg_batch(7)
    np.testing.assert_allclose(
        float(tlosses.sigmoid_cross_entropy(torch.from_numpy(logits), torch.from_numpy(labels))),
        float(jlosses.sigmoid_cross_entropy(jnp.asarray(logits), jnp.asarray(labels))), atol=1e-6, rtol=1e-6,
    )


# -- metrics (binary inputs: exact) -----------------------------------------------------


def _masks(seed, b=6, h=8, w=8):
    rng = np.random.default_rng(seed)
    t = (rng.uniform(size=(b, h, w, 1)) > 0.6).astype(np.float32)
    p = (rng.uniform(size=(b, h, w, 1)) > 0.6).astype(np.float32)
    t[0] = 0.0
    p[0] = 0.0  # empty/empty: IoU 1.0
    t[1] = 0.0  # empty truth, some prediction: IoU 0
    p[2] = t[2]  # perfect
    return t, p


@pytest.mark.parametrize("seed", [0, 1])
def test_iou_and_accuracy_scores_match_jax_exactly(seed):
    t, p = _masks(seed)
    want_iou = np.asarray(jmetrics.iou_scores(jnp.asarray(t), jnp.asarray(p)))
    got_iou = tmetrics.iou_scores(torch.from_numpy(t), torch.from_numpy(p)).numpy()
    np.testing.assert_array_equal(got_iou, want_iou)
    assert got_iou[0] == 1.0 and got_iou[2] == 1.0
    np.testing.assert_array_equal(
        tmetrics.mean_accuracy_scores(torch.from_numpy(t), torch.from_numpy(p)).numpy(),
        np.asarray(jmetrics.mean_accuracy_scores(jnp.asarray(t), jnp.asarray(p))),
    )


def test_streaming_means_match_jax():
    t, p = _masks(2)
    weights = np.array([1, 1, 0, 1, 0, 1], np.float32)
    jstate = jmetrics.Mean.empty().update(jmetrics.iou_scores(jnp.asarray(t), jnp.asarray(p)), jnp.asarray(weights))
    tstate = tmetrics.Mean.empty().update(tmetrics.iou_scores(torch.from_numpy(t), torch.from_numpy(p)),
                                          torch.from_numpy(weights))
    assert float(tstate.count) == float(jstate.count) == 4.0
    np.testing.assert_allclose(float(tstate.compute()), float(jstate.compute()), atol=1e-7)
    merged = tstate.merge(tmetrics.Mean.empty().update(torch.ones(3)))
    assert float(merged.count) == 7.0
    jv, _ = jmetrics.miou(jnp.asarray(t), jnp.asarray(p))
    tv, _ = tmetrics.miou(torch.from_numpy(t), torch.from_numpy(p))
    np.testing.assert_allclose(float(tv), float(jv), atol=1e-7)
    ja, _ = jmetrics.mean_accuracy(jnp.asarray(t), jnp.asarray(p))
    ta, _ = tmetrics.mean_accuracy(torch.from_numpy(t), torch.from_numpy(p))
    np.testing.assert_allclose(float(ta), float(ja), atol=1e-7)
    assert tmetrics.IOU_THRESHOLDS == jmetrics.IOU_THRESHOLDS


# -- depthwise autograd (plain arms) vs jax.grad through the Pallas kernel --------------


@pytest.mark.parametrize(
    "shape,k,rate",
    [((2, 9, 9, 8), 3, 2), ((1, 7, 6, 5), 5, 1), ((2, 13, 13, 4), 3, 8),
     # the ASPP calls' geometry at narrow width (the dw band kernel's path), and an odd channel count
     ((2, 13, 13, 8), 3, 2), ((2, 13, 13, 8), 3, 4), ((2, 13, 13, 8), 3, 8), ((1, 9, 11, 6), 3, 2)],
)
def test_depthwise_autograd_matches_jax_grad_through_pallas(shape, k, rate):
    rng = np.random.default_rng(rate)
    x = rng.normal(size=shape).astype(np.float32)
    w = rng.normal(size=(k, k, shape[-1])).astype(np.float32)
    g = rng.normal(size=shape).astype(np.float32)

    def f(xx, ww):
        return jnp.sum(jk.depthwise_conv2d(xx, ww, rate, interpret=True) * jnp.asarray(g))

    jdx, jdw = jax.grad(f, argnums=(0, 1))(jnp.asarray(x), jnp.asarray(w))
    xt = torch.from_numpy(x).requires_grad_(True)
    wt = torch.from_numpy(w).requires_grad_(True)
    (tk.depthwise_conv2d(xt, wt, rate) * torch.from_numpy(g)).sum().backward()
    np.testing.assert_allclose(xt.grad.numpy(), np.asarray(jdx), atol=1e-4, rtol=0)  # dx: 1e-4
    np.testing.assert_allclose(wt.grad.numpy(), np.asarray(jdw), atol=1e-3, rtol=0)  # dw: atol 1e-3
    # the plain backward, called directly, is the same function
    dx, dw = tk.depthwise_conv2d_backward_plain(torch.from_numpy(x), torch.from_numpy(w), torch.from_numpy(g), rate)
    torch.testing.assert_close(dx, xt.grad, atol=1e-5, rtol=0)
    torch.testing.assert_close(dw, wt.grad, atol=1e-4, rtol=0)
    assert tk.launch_counts() == {k_: 0 for k_ in tk.LAUNCHES}  # CPU tensors launch nothing


def test_depthwise_autograd_matches_grouped_conv_autograd():
    rng = np.random.default_rng(11)
    x = torch.from_numpy(rng.normal(size=(2, 10, 12, 6)).astype(np.float32))
    w = torch.from_numpy(rng.normal(size=(3, 3, 6)).astype(np.float32))
    grads = []
    for fn in (tk.depthwise_conv2d, tk.depthwise_conv2d_plain):
        xx, ww = x.clone().requires_grad_(True), w.clone().requires_grad_(True)
        (fn(xx, ww, 4) ** 2).sum().backward()
        grads.append((xx.grad, ww.grad))
    torch.testing.assert_close(grads[0][0], grads[1][0], atol=1e-5, rtol=1e-5)
    torch.testing.assert_close(grads[0][1], grads[1][1], atol=1e-4, rtol=1e-5)


def test_depthwise_dw_rejects_bad_shapes():
    with pytest.raises(ValueError, match="one \\[B,H,W,C\\] shape"):
        tk.depthwise_conv2d_dw(torch.zeros(1, 4, 4, 3), torch.zeros(1, 4, 4, 2), (3, 3))
    with pytest.raises(ValueError, match="odd kernel"):
        tk.depthwise_conv2d_dw(torch.zeros(1, 4, 4, 3), torch.zeros(1, 4, 4, 3), (2, 3))


def test_bn_act_kernel_arm_refuses_gradients(monkeypatch):
    # run the kernel arm's checks on CPU tensors: the refusal comes before
    # anything touches CUDA
    monkeypatch.setattr(tk, "_use_plain", lambda t: False)
    x = torch.randn(1, 3, 3, 4, requires_grad=True)
    m, b = torch.ones(4), torch.zeros(4)
    with pytest.raises(RuntimeError, match="inference-only"):
        tk.bn_act_folded(x, m, b, "relu")
    with pytest.raises(RuntimeError, match="inference-only"):
        tk.fused_bn_act(x.detach(), torch.ones(4, requires_grad=True), torch.zeros(4), torch.zeros(4),
                        torch.ones(4), act="relu")
    with torch.no_grad(), pytest.raises(ValueError, match="CUDA device"):
        tk.bn_act_folded(x, m, b, "relu")  # past the refusal: the CUDA checks


# -- training-mode BatchNorm against flax ------------------------------------------------


def test_batchnorm_training_mode_matches_flax():
    rng = np.random.default_rng(8)
    x = (rng.normal(size=(4, 5, 6, 7)) * 2 + 0.5).astype(np.float32)
    scale = rng.uniform(0.5, 1.5, 7).astype(np.float32)
    bias = rng.normal(0, 0.2, 7).astype(np.float32)
    mean0 = rng.normal(0, 0.3, 7).astype(np.float32)
    var0 = rng.uniform(0.5, 1.5, 7).astype(np.float32)
    bn = jnn.BatchNorm(use_running_average=False, momentum=0.99, epsilon=1e-3)
    variables = {"params": {"scale": jnp.asarray(scale), "bias": jnp.asarray(bias)},
                 "batch_stats": {"mean": jnp.asarray(mean0), "var": jnp.asarray(var0)}}
    want, mutated = bn.apply(variables, jnp.asarray(x), mutable=["batch_stats"])
    want = np.asarray(jax.nn.relu(want))
    tbn = tlayers.BatchNorm(7, eps=1e-3, decay=0.99).train()
    with torch.no_grad():
        tbn.weight.copy_(torch.from_numpy(scale))
        tbn.bias.copy_(torch.from_numpy(bias))
        tbn.running_mean.copy_(torch.from_numpy(mean0))
        tbn.running_var.copy_(torch.from_numpy(var0))
    got = tbn(torch.from_numpy(x), act="relu")
    np.testing.assert_allclose(got.detach().numpy(), want, atol=1e-5, rtol=0)  # forward: 1e-5
    stats = mutated["batch_stats"]
    np.testing.assert_allclose(tbn.running_mean.numpy(), np.asarray(stats["mean"]), atol=1e-6, rtol=0)
    np.testing.assert_allclose(tbn.running_var.numpy(), np.asarray(stats["var"]), atol=1e-6, rtol=0)
    # the biased variance, not F.batch_norm's unbiased one
    batch_var = x.reshape(-1, 7).var(axis=0)
    np.testing.assert_allclose(tbn.running_var.numpy(), 0.99 * var0 + 0.01 * batch_var, atol=1e-6)
    # eval mode goes back to the running statistics (the folded kernel path)
    tbn.eval()
    with torch.no_grad():
        out = tbn(torch.from_numpy(x), act="none")
    m, b = tbn.folded()
    torch.testing.assert_close(out, torch.from_numpy(x) * m + b)
