"""bf16 compute in the port's ResNet segmenter (``tgs_salt_bf16``) against
the JAX package's, on the CPU, and the bf16 arms of the depthwise and
fused-BN kernels' plain versions against the JAX kernels run in interpret
mode (as the JAX package's own tests run them).

Tolerances, stated where used:

- kernels: the depthwise forward, dx and dw within one bf16 ulp of the
  interpreted Pallas kernel (both sum in float32 and round once; the sums'
  order differs, which can move a value across a rounding boundary);
  ``fused_bn_act`` within one bf16 ulp of the kernel and of flax's
  ``BatchNorm(dtype=bfloat16)`` followed by the activation (the port
  folds the statistics, flax normalises unfolded, both in float32). Near
  zero, where a bf16 ulp is far below float32's noise on unit-scale
  inputs (sigmoid and gelu of large negative values), 1e-6 absolute;
- the segmenter's bf16 logits against JAX's float32 logits within
  2e-2·max|logit| plus JAX's own bf16-vs-float32 distance: the two
  packages round every conv, depthwise and BN output to bf16, at different
  places inside each op;
- one bf16 training step (batch statistics): the Lovász loss within 2e-2
  (relative) of JAX's bf16 loss; every gradient leaf float32 and finite,
  the depthwise filters' gradients rounded to bf16.
- the bf16 gradient, leaf by leaf, under sigmoid cross entropy (smooth, as
  the repo's trajectory tests) with the BatchNorm statistics fixed at the
  running ones: JAX's ``train=False`` gradient, and the port's training
  code with its moments taken from the running statistics. With batch
  statistics the gradient of a randomly initialised BatchNorm network is
  chaotic (BN's gradient explosion at init): JAX's own bf16 gradient lies
  0.2-1.0 of the leaf's max|g| from its float32 one in the backbone's
  leaves, at batch 2 at 33x33 and at batch 16 at 65x65 alike, and 19x
  (batch 2) to 152x (batch 8 at 65x65) where the float32 leaf nearly
  vanishes, so a bound per leaf would measure which chaotic realisation
  each package draws. Statistics fixed at the batch's own
  float32 statistics are no cure: a channel with no variance in a batch of
  2 at 3x3 multiplies the noise by rsqrt(eps). With the random running
  statistics of this test JAX's bf16 gradient lies at most 0.139 of the
  leaf's max|g| from the float32 one, the port's at most 0.165; the
  port's exceeds JAX's by up to 0.052 (two realisations of the same
  rounding noise), so 17 of the 108 leaves would fail a bound of 2e-2 plus
  once JAX's distance, and none fails twice it. Held: each leaf within 2e-2·max|g32_leaf| + 2·max|g_jax16
  - g32| of JAX's float32 gradient ``g32``. Planted faults fail it: the
  gradient doubled (0.93 of max|g| off in the first leaf), the convs'
  biases cut from the graph (a zeroed leaf), and the convs computed in
  float32 (a dropped bf16 cast; narrowly, 0.074 against a bound of 0.070
  in ``postnorm.weight``), which also fails
  ``test_bf16_segmenter_computes_in_bf16``.
"""

from __future__ import annotations

import dataclasses
from unittest import mock

import flax.linen as fnn
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tensorflowdistributedlearning_tpu import config as jconfig
from tensorflowdistributedlearning_tpu import configs as jconfigs
from tensorflowdistributedlearning_tpu.models import build_model as jbuild
from tensorflowdistributedlearning_tpu.ops import losses as jlosses
from tensorflowdistributedlearning_tpu.ops import pallas_kernels as jk
from tensorflowdistributedlearning_tpu.train import step as jstep
from tensorflowdistributedlearning_tpu_torch import configs as tconfigs
from tensorflowdistributedlearning_tpu_torch.config import ModelConfig, TrainConfig
from tensorflowdistributedlearning_tpu_torch.models import build_model
from tensorflowdistributedlearning_tpu_torch.models.layers import BatchNorm
from tensorflowdistributedlearning_tpu_torch.ops import kernels as tk
from tensorflowdistributedlearning_tpu_torch.ops import losses as tlosses
from tensorflowdistributedlearning_tpu_torch.train import step as tstep
from tensorflowdistributedlearning_tpu_torch.train.state import create_train_state
from tensorflowdistributedlearning_tpu_torch.utils.convert import from_flax
from tests.test_torch_dp_worker import one_torch_thread  # noqa: F401 (autouse)


TINY = dict(n_blocks=(1, 1, 1), input_shape=(33, 33), base_depth=16, width_multiplier=0.125)
BF16 = torch.bfloat16


def _bf16_ulps(a: np.ndarray, b: np.ndarray, atol: float = 1e-6) -> np.ndarray:
    """Distance in bf16 steps between two arrays of bf16 values (given as
    float32): the bit patterns mapped to ordered integers; 0 where the two
    are within ``atol`` (float32 noise near zero)."""

    def ordered(x):
        bits = np.ascontiguousarray(x, np.float32).view(np.int32) >> 16
        return np.where(bits < 0, -(bits & 0x7FFF), bits).astype(np.int64)

    return np.where(np.abs(a - b) <= atol, 0, np.abs(ordered(a) - ordered(b)))


def _to_bf16_np(t: torch.Tensor) -> np.ndarray:
    return t.float().numpy()


def _jnp_bf16(a: np.ndarray):
    return jnp.asarray(a, jnp.float32).astype(jnp.bfloat16)


# -- the kernels' bf16 plain arms against the interpreted Pallas kernels --------------------


@pytest.mark.parametrize("shape, k, rate", [((2, 9, 11, 16), 3, 1), ((1, 13, 13, 24), 3, 2), ((2, 7, 6, 8), 5, 3),
                                            ((1, 5, 5, 6), 3, 4)])
def test_depthwise_bf16_forward_dx_dw_match_jax(shape, k, rate):
    rng = np.random.default_rng(sum(shape) + k + rate)
    x = rng.normal(size=shape).astype(np.float32)
    w = rng.normal(0, 0.4, (k, k, shape[-1])).astype(np.float32)
    g = rng.normal(size=shape).astype(np.float32)
    xj, wj, gj = _jnp_bf16(x), _jnp_bf16(w), _jnp_bf16(g)
    out, vjp = jax.vjp(lambda a, b: jk.depthwise_conv2d(a, b, rate, interpret=True), xj, wj)
    jdx, jdw = vjp(gj)
    assert out.dtype == jdx.dtype == jdw.dtype == jnp.bfloat16
    xt, wt, gt = (torch.tensor(np.asarray(a.astype(jnp.float32))).to(BF16) for a in (xj, wj, gj))
    got = tk.depthwise_conv2d_forward(xt, wt, rate)
    dx, dw = tk.depthwise_conv2d_backward_plain(xt, wt, gt, rate)
    assert got.dtype == dx.dtype == dw.dtype == BF16
    assert torch.equal(tk.depthwise_conv2d_dx(gt, wt, rate), dx)
    assert torch.equal(tk.depthwise_conv2d_dw(xt, gt, (k, k), rate), dw)
    for name, mine, theirs in (("forward", got, out), ("dx", dx, jdx), ("dw", dw, jdw)):
        ulps = _bf16_ulps(_to_bf16_np(mine), np.asarray(theirs.astype(jnp.float32)))
        assert ulps.max() <= 1, (name, int(ulps.max()))


def test_depthwise_bf16_autograd_gives_bf16_gradients():
    """The autograd Function in bf16 (the layer casts the filter to bf16):
    dx and dw in bf16, each the plain backward's."""
    rng = np.random.default_rng(7)
    x = torch.from_numpy(rng.normal(size=(2, 9, 9, 8)).astype(np.float32)).to(BF16).requires_grad_()
    w = torch.from_numpy(rng.normal(size=(3, 3, 8)).astype(np.float32)).to(BF16).requires_grad_()
    g = torch.from_numpy(rng.normal(size=(2, 9, 9, 8)).astype(np.float32)).to(BF16)
    out = tk.depthwise_conv2d(x, w, 2)
    out.backward(g)
    dx, dw = tk.depthwise_conv2d_backward_plain(x.detach(), w.detach(), g, 2)
    assert x.grad.dtype == w.grad.dtype == BF16
    assert torch.equal(x.grad, dx) and torch.equal(w.grad, dw)


@pytest.mark.parametrize("act", ["none", "relu", "relu6", "sigmoid", "gelu"])
@pytest.mark.parametrize("with_residual", [False, True])
def test_bn_act_bf16_matches_jax_kernel(act, with_residual):
    rng = np.random.default_rng(11)
    c = 24
    x = _jnp_bf16(3 * rng.normal(size=(2, 5, 7, c)))
    r = _jnp_bf16(rng.normal(size=(2, 5, 7, c))) if with_residual else None
    scale, bias, mean = (rng.uniform(0.5, 1.5, c), rng.normal(size=c), rng.normal(size=c))
    var = rng.uniform(0.5, 1.5, c)
    vecs = [np.asarray(v, np.float32) for v in (scale, bias, mean, var)]
    want = jk.fused_bn_act(x, *map(jnp.asarray, vecs), eps=1e-3, act=act, residual=r, interpret=True)
    assert want.dtype == jnp.bfloat16
    xt = torch.tensor(np.asarray(x.astype(jnp.float32))).to(BF16)
    rt = None if r is None else torch.tensor(np.asarray(r.astype(jnp.float32))).to(BF16)
    got = tk.fused_bn_act(xt, *map(torch.from_numpy, vecs), eps=1e-3, act=act, residual=rt)
    assert got.dtype == BF16
    assert _bf16_ulps(_to_bf16_np(got), np.asarray(want.astype(jnp.float32))).max() <= 1


@pytest.mark.parametrize("act", ["none", "relu", "relu6"])
def test_bn_act_bf16_matches_flax_batchnorm(act):
    """Eval-mode BN of a bf16-compute model: flax's ``BatchNorm(dtype=bf16)``
    with float32 parameters, then the activation on its bf16 output (the
    piecewise-linear ones commute with the rounding)."""
    rng = np.random.default_rng(12)
    c = 16
    x = _jnp_bf16(2 * rng.normal(size=(3, 4, 5, c)))
    variables = {
        "params": {"scale": jnp.asarray(rng.uniform(0.5, 1.5, c), jnp.float32),
                   "bias": jnp.asarray(rng.normal(size=c), jnp.float32)},
        "batch_stats": {"mean": jnp.asarray(rng.normal(size=c), jnp.float32),
                        "var": jnp.asarray(rng.uniform(0.5, 1.5, c), jnp.float32)},
    }
    y = fnn.BatchNorm(use_running_average=True, epsilon=1e-3, dtype=jnp.bfloat16).apply(variables, x)
    want = {"none": y, "relu": jnp.maximum(y, 0), "relu6": jnp.clip(y, 0, 6)}[act]
    assert want.dtype == jnp.bfloat16
    t = {k: torch.tensor(np.asarray(v)) for d in variables.values() for k, v in d.items()}
    m, b = tk.fold_bn(t["scale"], t["bias"], t["mean"], t["var"], 1e-3)
    got = tk.bn_act_folded(torch.tensor(np.asarray(x.astype(jnp.float32))).to(BF16), m, b, act)
    assert _bf16_ulps(_to_bf16_np(got), np.asarray(want.astype(jnp.float32))).max() <= 1


def test_bn_act_bf16_vector_rule():
    """The bf16-activation row kernel's vector arm: 8 channels a thread,
    every base 16-byte aligned; otherwise its scalar arm."""
    x = torch.zeros(2, 3, 3, 16, dtype=BF16)
    m = torch.zeros(16)
    assert tk.bn_act_vectorized_bf16(16, x, m, m, None, x)
    assert not tk.bn_act_vectorized_bf16(12, x, m, m)  # 12 % 8: a float32 row vector, not a bf16 one
    assert tk.bn_act_vectorized(12, x, m, m)
    flat = torch.zeros(2 * 3 * 3 * 16 + 4, dtype=BF16)
    assert not tk.bn_act_vectorized_bf16(16, flat[4:], m, m)  # 8 bytes off


def test_dw_plan_budgets_bf16_elements():
    """dw's band plan in bf16: the staged bands cost half the bytes, so
    bands never shrink and an image that float32 cannot stage in one band
    can be; the tap sums stay float32."""
    h = w = 101
    for c in (64, 1024):
        f32 = tk.dw_plan(1, h, w, c, 3, 3, 1, True, 4)
        b16 = tk.dw_plan(1, h, w, c, 3, 3, 1, True, 2)
        assert b16.band_rows >= f32.band_rows
        assert b16.smem_bytes == tk.dw_band_smem(h, w, 3, 3, 1, b16.channels, b16.band_rows, b16.stages, 2)
        assert b16.smem_bytes <= tk.H100_SMEM_BLOCK
    assert tk.dw_band_smem(1, 1, 3, 3, 1, 32, 1, 1, 2) == 4 * tk.DW_BAND_WARPS * 9 * 32  # the tap sums bound it
    assert tk.dw_plan(2, 9, 9, 8, 3, 3, 1, False, 2) is None  # unaligned: the tile kernel


def test_dw_route_reads_bf16_alignment():
    """A bf16 dw needs 8-byte bases (a thread's 4 channels), float32 16."""
    buf = torch.zeros(2 * 5 * 5 * 8 + 4, dtype=BF16)
    x = buf[4:].view(2, 5, 5, 8)  # 8 bytes off a 16-byte boundary
    assert tk.dw_route(x, x, (3, 3)) is not None
    assert tk.dw_route(buf[2:-2].view(2, 5, 5, 8), x, (3, 3)) is None  # 4 bytes off


# -- the bf16 segmenter ----------------------------------------------------------------------


def _variables(jm, h, seed):
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(2, h, h, 2)).astype(np.float32)
    v = jm.init(jax.random.key(seed), jnp.asarray(x), train=False)
    params = jax.tree_util.tree_map(
        lambda a: np.asarray(a, np.float32) + rng.normal(0, 0.05, a.shape).astype(np.float32), v["params"])
    stats = jax.tree_util.tree_map(lambda a: np.asarray(a, np.float32), v["batch_stats"])
    stats = {k: v for k, v in stats.items()}
    flat = jax.tree_util.tree_flatten_with_path(stats)
    leaves = [(rng.uniform(0.5, 1.5, a.shape) if p[-1].key == "var" else rng.normal(0, 0.2, a.shape)).astype(np.float32)
              for p, a in flat[0]]
    stats = jax.tree_util.tree_unflatten(flat[1], leaves)
    return params, stats, x


@pytest.fixture(scope="module")
def segmenter():
    kw = dict(TINY, use_pallas_depthwise=True)
    j32, j16 = jbuild(jconfig.ModelConfig(**kw)), jbuild(jconfig.ModelConfig(**kw, dtype="bfloat16"))
    params, stats, x = _variables(j32, 33, 0)
    cfg = ModelConfig(**kw, dtype="bfloat16")
    model = build_model(cfg, "cpu")
    model.load_state_dict(from_flax(params, stats, cfg))
    return dict(j32=j32, j16=j16, params=params, stats=stats, x=x, cfg=cfg, model=model)


def test_preset_is_tgs_salt_in_bf16():
    want = jconfigs.get_preset("tgs_salt_bf16").model
    got = tconfigs.get_preset("tgs_salt_bf16").model
    assert got.to_dict() == dataclasses.asdict(want) | {"input_shape": list(want.input_shape),
                                                       "n_blocks": list(want.n_blocks)}
    assert got == dataclasses.replace(tconfigs.get_preset("tgs_salt").model, dtype="bfloat16")


def test_bf16_segmenter_logits_match_jax(segmenter):
    s = segmenter
    v = {"params": s["params"], "batch_stats": s["stats"]}
    want32 = np.asarray(s["j32"].apply(v, jnp.asarray(s["x"]), train=False))
    want16 = np.asarray(s["j16"].apply(v, jnp.asarray(s["x"]), train=False))
    assert want16.dtype == np.float32 and want32.std() > 0.3
    with torch.inference_mode():
        got = s["model"](torch.from_numpy(s["x"]))
    assert got.dtype == torch.float32 and got.shape == (2, 33, 33, 1)
    jax_gap = float(np.abs(want16 - want32).max())
    err = float(np.abs(got.numpy() - want32).max())
    assert err <= 2e-2 * float(np.abs(want32).max()) + jax_gap, (err, jax_gap)


def test_bf16_segmenter_computes_in_bf16(segmenter):
    """Every conv, depthwise conv and BN of the bf16 model returns bf16;
    the logits leave in float32."""
    seen = []
    hooks = [m.register_forward_hook(lambda mod, a, out: seen.append(out.dtype))
             for m in segmenter["model"].modules()
             if type(m).__name__ in ("Conv2dSame", "DepthwiseConv2D", "BatchNorm", "SpaceToDepthConv")]
    try:
        with torch.inference_mode():
            segmenter["model"](torch.from_numpy(segmenter["x"]))
    finally:
        for h in hooks:
            h.remove()
    assert len(seen) > 40 and set(seen) == {BF16}


class JaxBce(jstep.SegmentationTask):
    def loss(self, logits, batch):
        return jlosses.sigmoid_cross_entropy(logits, batch["labels"])


class PortBce(tstep.SegmentationTask):
    def loss(self, logits, batch):
        return tlosses.sigmoid_cross_entropy(logits, batch["labels"])


def test_bf16_train_step_matches_jax(segmenter):
    """One training step with batch statistics: the loss, and gradients in
    float32 (see the module note for why they are held per leaf only with
    the statistics fixed)."""
    s = segmenter
    images, labels = _step_batch(s)
    ljax = s["j16"].apply
    params, stats = s["params"], s["stats"]

    def loss_fn(p):
        logits, _ = ljax({"params": p, "batch_stats": stats}, jnp.asarray(images), train=True, mutable=["batch_stats"])
        return jstep.SegmentationTask().loss(logits, {"labels": jnp.asarray(labels)})

    loss16 = jax.jit(loss_fn)(params)
    state = create_train_state(s["cfg"], TrainConfig(), "cpu", state_dict=from_flax(params, stats, s["cfg"]))
    batch = {"images": torch.from_numpy(images), "labels": torch.from_numpy(labels)}
    loss, _ = tstep.forward_backward(state, tstep.SegmentationTask(), batch)
    assert abs(float(loss) - float(loss16)) <= 2e-2 * abs(float(loss16)), (float(loss), float(loss16))
    named = dict(state.model.named_parameters())
    assert len(named) == len(jax.tree_util.tree_leaves(params))
    assert all(p.grad.dtype == torch.float32 and bool(torch.isfinite(p.grad).all()) for p in named.values())
    # the depthwise filters' gradients were rounded to bf16 before reaching the float32 parameter
    dw = state.model.aspp.conv_3x3_1.depthwise.weight.grad
    assert torch.equal(dw, dw.to(BF16).float())


def _step_batch(s):
    rng = np.random.default_rng(4)
    images = s["x"] + rng.normal(0, 0.3, s["x"].shape).astype(np.float32)
    labels = (rng.uniform(size=(2, 33, 33, 1)) < 0.4).astype(np.float32)
    return images, labels


def _running_moments(bn, xf):
    """``BatchNorm._moments`` with the statistics fixed: ``E[x]`` and
    ``E[x²]`` of the running mean and variance."""
    return bn.running_mean, bn.running_var + bn.running_mean * bn.running_mean


def test_bf16_gradients_with_fixed_statistics_match_jax_per_leaf(segmenter):
    s = segmenter
    images, labels = _step_batch(s)

    def jax_grads(jm):
        def loss_fn(params):
            logits = jm.apply({"params": params, "batch_stats": s["stats"]}, jnp.asarray(images), train=False)
            return JaxBce().loss(logits, {"labels": jnp.asarray(labels)})

        return from_flax(jax.device_get(jax.jit(jax.grad(loss_fn))(s["params"])), s["stats"], s["cfg"])

    g32, jax16 = jax_grads(s["j32"]), jax_grads(s["j16"])
    state = create_train_state(s["cfg"], TrainConfig(), "cpu", state_dict=from_flax(s["params"], s["stats"], s["cfg"]))
    bns = [m for m in state.model.modules() if isinstance(m, BatchNorm)]
    for bn in bns:
        bn.frozen_stats = True
    batch = {"images": torch.from_numpy(images), "labels": torch.from_numpy(labels)}
    with mock.patch.object(BatchNorm, "_moments", _running_moments):
        tstep.forward_backward(state, PortBce(), batch)
    loaded = from_flax(s["params"], s["stats"], s["cfg"])
    assert all(torch.equal(v, loaded[k]) for k, v in state.model.state_dict().items() if k.endswith("running_var"))
    named = dict(state.model.named_parameters())
    assert len(named) == len(jax.tree_util.tree_leaves(s["params"])) and set(named) <= set(g32)
    for name, p in named.items():
        assert p.grad.dtype == torch.float32, name
        scale = float(g32[name].abs().max())
        jax_gap = float((jax16[name] - g32[name]).abs().max())
        err = float((p.grad - g32[name]).abs().max())
        assert err <= 2e-2 * scale + 2 * jax_gap, (name, err / scale, jax_gap / scale)
