"""The port's sequence-axis operations (``parallel/spatial.py``, the ring
and gather collectives of ``parallel/collectives.py``) against the
unsharded ops and the JAX package's ``parallel/spatial.py`` on the CPU.

- 2 and 4 gloo ranks as one sequence group (``tests/test_torch_dp_worker.py``
  mode ``spops``, one launch each, started before the JAX references are
  computed so the two overlap), each on its block of the rows of one
  batch: every ``spatial_conv2d`` case (stride 1/2, rate 1..16, grouped,
  ``same``/``fixed``, the halo and the all-gather paths), the halo
  exchange, the max pool, the global mean, the gather, ``ring_all_gather``
  and ``reduce_scatter``. The ranks' outputs put together are the
  unsharded op's, and their gradients of a weighted sum are the unsharded
  op's gradients (a replicated input's summed over the ranks, as JAX's
  transpose sums them). The convolutions, the halo exchange and the pool,
  forward and gradients, are also JAX's ``shard_map`` of its own functions
  on a sequence mesh of the same size.
- The refusals: JAX's ``ValueError`` texts for ``validate_spatial_config``
  (``tgs_salt``'s 101 x 101 at degree 2, the MoE ViT, the classifier at
  224, the ViT's patch rule), for the ops' own checks, and for a
  space-to-depth stem under the sequence axis; queue A 12.4 no longer
  refuses the sequence axis.
"""

from __future__ import annotations

import dataclasses
import inspect
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F
from jax.sharding import PartitionSpec as P

from tensorflowdistributedlearning_tpu import config as jconfig
from tensorflowdistributedlearning_tpu import configs as jconfigs
from tensorflowdistributedlearning_tpu.parallel import make_mesh
from tensorflowdistributedlearning_tpu.parallel import spatial as jspatial
from tensorflowdistributedlearning_tpu.parallel.mesh import SEQUENCE_AXIS
from tensorflowdistributedlearning_tpu_torch import config as tconfig
from tensorflowdistributedlearning_tpu_torch.config import ModelConfig, TrainConfig, require_supported_training
from tensorflowdistributedlearning_tpu_torch.configs import get_preset
from tensorflowdistributedlearning_tpu_torch.models import build_model, set_spatial
from tensorflowdistributedlearning_tpu_torch.models.layers import (
    Conv2dSame,
    conv2d_same,
    fixed_padding,
    max_pool_same,
)
from tensorflowdistributedlearning_tpu_torch.parallel import spatial
from tests import test_torch_dp_worker as worker
from tests.test_torch_dp_worker import one_torch_thread  # noqa: F401 (autouse)


CASES = worker.SP_CONV_CASES
SHAPE = (2, 16, 9, 4)
WORLDS = (2, 4)


def _plain_conv(x, w, stride, rate, groups, phase):
    if phase == "same":
        return conv2d_same(x, w, None, stride, rate, groups)
    xp = fixed_padding(x, w.shape[-1], rate=rate)
    return F.conv2d(xp.permute(0, 3, 1, 2), w, stride=stride, dilation=rate, groups=groups).permute(0, 2, 3, 1)


def _data(world):
    rng = np.random.default_rng(world)
    f32 = np.float32
    x = rng.normal(size=SHAPE).astype(f32)
    d = {"x": x}
    for i, (s, r, g, ph) in enumerate(CASES):
        w = rng.normal(0, 0.5, (4 if g > 1 else 5, SHAPE[3] // g, 3, 3)).astype(f32)
        y = _plain_conv(torch.from_numpy(x), torch.from_numpy(w), s, r, g, ph)
        d[f"w{i}"], d[f"g{i}"] = w, rng.normal(size=tuple(y.shape)).astype(f32)
    b, h, wd, c = SHAPE
    d["g_halo"] = rng.normal(size=(world, b, h // world + 2 * worker.SP_HALO, wd, c)).astype(f32)
    d["g_pool"] = rng.normal(size=tuple(max_pool_same(torch.from_numpy(x)).shape)).astype(f32)
    d["g_mean"] = rng.normal(size=(world, b, c)).astype(f32)
    d["g_gather"] = rng.normal(size=(world,) + SHAPE).astype(f32)
    d["y_scatter"] = rng.normal(size=(world,) + SHAPE).astype(f32)
    d["g_scatter"] = rng.normal(size=SHAPE).astype(f32)
    return d


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """Both launches started first, then the JAX references, then the
    ranks' results."""
    started = {}
    for world in WORLDS:
        d = str(tmp_path_factory.mktemp(f"spops{world}"))
        data = _data(world)
        np.savez(os.path.join(d, "spops.npz"), **data)
        started[world] = (data, worker.start("spops", world, d))
    jax_out = {world: _jax_ops(world, started[world][0]) for world in WORLDS}
    return {world: dict(data=data, ranks=worker.finish(launch), jax=jax_out[world])
            for world, (data, launch) in started.items()}


def _jax_ops(world, d):
    """JAX's shard_map of its own convolutions, halo exchange and max pool
    on a sequence mesh of ``world`` devices, each on its own copy of the
    input: the outputs (each device's block in order along H) and the vjp
    of the port's cotangents (each op's dx, each conv's dw)."""
    mesh = make_mesh(world, sequence_parallel=world)
    spec = P(None, SEQUENCE_AXIS, None, None)
    n = len(CASES)
    ws = [jnp.asarray(d[f"w{i}"].transpose(2, 3, 1, 0)) for i in range(n)]

    def body(*args):
        xs, kernels = args[:n + 2], args[n + 2:]
        outs = [jspatial.spatial_conv2d(x, k, stride=s, rate=r, feature_group_count=g, phase=ph)
                for x, k, (s, r, g, ph) in zip(xs, kernels, CASES)]
        outs.append(jspatial.halo_exchange(xs[n], worker.SP_HALO))
        outs.append(jspatial.spatial_max_pool(xs[n + 1], 3, 2))
        return tuple(outs)

    f = jax.shard_map(body, mesh=mesh, in_specs=(spec,) * (n + 2) + (P(),) * n, out_specs=(spec,) * (n + 2))
    cts = [d[f"g{i}"] for i in range(n)] + [np.concatenate(list(d["g_halo"]), axis=1), d["g_pool"]]

    @jax.jit
    def run(x, kernels, cts):
        y, vjp = jax.vjp(f, *([x] * (n + 2)), *kernels)
        return y, vjp(tuple(cts))

    y, grads = run(jnp.asarray(d["x"]), ws, cts)
    return {"y": [np.asarray(t) for t in y], "dx": [np.asarray(g) for g in grads[:n + 2]],
            "dw": [np.asarray(g).transpose(3, 2, 0, 1) for g in grads[n + 2:]]}


def _cat(ranks, key, pick, dim=1):
    return torch.cat([pick(r[key]) for r in ranks], dim=dim)


def _close(got, want, tol=1e-5):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), rtol=tol, atol=tol)


def _whole_grads(fn, inputs, cotangent):
    leaves = [torch.from_numpy(np.asarray(t)).requires_grad_(True) for t in inputs]
    y = fn(*leaves)
    (y * torch.as_tensor(cotangent)).sum().backward()
    return y.detach(), [t.grad for t in leaves]


@pytest.mark.parametrize("world", WORLDS)
def test_ranks_form_one_sequence_group(runs, world):
    for r, out in enumerate(runs[world]["ranks"]):
        assert out["layout"] == (1, world, 0, r, world)


@pytest.mark.parametrize("world", WORLDS)
@pytest.mark.parametrize("case", range(len(CASES)), ids=lambda i: "s{}r{}g{}{}".format(*CASES[i]))
def test_spatial_conv2d_is_the_unsharded_conv_and_jax(runs, world, case):
    d, ranks, jx = runs[world]["data"], runs[world]["ranks"], runs[world]["jax"]
    s, r, g, ph = CASES[case]
    y, (dx, dw) = _whole_grads(lambda x, w: _plain_conv(x, w, s, r, g, ph), (d["x"], d[f"w{case}"]), d[f"g{case}"])
    convs = [out["conv"][case] for out in ranks]
    got_y = torch.cat([c["y"] for c in convs], dim=1)
    got_dx = torch.cat([c["grads"][0] for c in convs], dim=1)
    got_dw = sum(c["grads"][1] for c in convs)
    for got, want in ((got_y, y), (got_dx, dx), (got_dw, dw)):
        _close(got, want)
    _close(got_y, jx["y"][case])
    _close(got_dx, jx["dx"][case])
    _close(got_dw, jx["dw"][case])
    # which path each block took: a rate-r 3x3 conv's halo is r rows
    assert {c["gather"] for c in convs} == {r > SHAPE[1] // world}


@pytest.mark.parametrize("world", WORLDS)
def test_every_conv_case_takes_the_same_path_in_both_packages(runs, world):
    """The gather fallback runs where JAX's does: both packages hold at
    least one case of each path at each size."""
    paths = [c["gather"] for c in runs[world]["ranks"][0]["conv"]]
    assert any(paths) and not all(paths)
    # the port's test of the path is JAX's condition halo > H_local
    src = inspect.getsource(jspatial.spatial_conv2d)
    assert "if halo > h_local:" in src


def _halo_oracle(x, world, halo):
    """Every rank's extended block, built from the whole ``x``."""
    k = x.shape[1] // world
    zeros = torch.zeros_like(x[:, :halo])
    out = []
    for r in range(world):
        top = x[:, r * k - halo:r * k] if r else zeros
        bottom = x[:, (r + 1) * k:(r + 1) * k + halo] if r < world - 1 else zeros
        out.append(torch.cat([top, x[:, r * k:(r + 1) * k], bottom], dim=1))
    return out


@pytest.mark.parametrize("world", WORLDS)
def test_halo_exchange_pool_and_mean(runs, world):
    d, ranks, jx = runs[world]["data"], runs[world]["ranks"], runs[world]["jax"]
    x = torch.from_numpy(d["x"]).requires_grad_(True)
    blocks = _halo_oracle(x, world, worker.SP_HALO)
    sum((b * torch.from_numpy(g)).sum() for b, g in zip(blocks, d["g_halo"])).backward()
    for r, out in enumerate(ranks):
        _close(out["halo"]["y"], blocks[r].detach(), 0)
    _close(_cat(ranks, "halo", lambda o: o["grads"][0]), x.grad)
    _close(_cat(ranks, "halo", lambda o: o["y"]), jx["y"][len(CASES)], 0)
    _close(_cat(ranks, "halo", lambda o: o["grads"][0]), jx["dx"][len(CASES)])
    y, (dx,) = _whole_grads(max_pool_same, (d["x"],), d["g_pool"])
    _close(_cat(ranks, "pool", lambda o: o["y"]), y, 0)
    _close(_cat(ranks, "pool", lambda o: o["grads"][0]), dx)
    _close(_cat(ranks, "pool", lambda o: o["y"]), jx["y"][len(CASES) + 1], 0)
    _close(_cat(ranks, "pool", lambda o: o["grads"][0]), jx["dx"][len(CASES) + 1])
    y, (dx,) = _whole_grads(lambda a: a.mean(dim=(1, 2)), (d["x"],), d["g_mean"].sum(0))
    for out in ranks:
        _close(out["mean"]["y"], y, 1e-6)
    _close(_cat(ranks, "mean", lambda o: o["grads"][0]), dx, 1e-6)


@pytest.mark.parametrize("world", WORLDS)
def test_gathers_and_reduce_scatter_transpose_each_other(runs, world):
    """The gather's backward sums every rank's cotangent (JAX's
    ``psum_scatter``), the ring all-gather is the same map, and the
    reduce-scatter's backward gathers the cotangent."""
    d, ranks = runs[world]["data"], runs[world]["ranks"]
    x = torch.from_numpy(d["x"])
    summed = torch.from_numpy(d["g_gather"].sum(0))
    for key in ("gather", "ring_gather"):
        for out in ranks:
            _close(out[key]["y"], x, 0)
        _close(_cat(ranks, key, lambda o: o["grads"][0]), summed, 1e-6)
    total = torch.from_numpy(d["y_scatter"].sum(0))
    _close(_cat(ranks, "scatter", lambda o: o["y"]), total, 1e-6)
    for out in ranks:
        _close(out["scatter"]["grads"][0], d["g_scatter"], 0)


# -- without a group, and the refusals --------------------------------------------


def test_one_rank_ops_are_the_plain_ops():
    """Without a sequence group the ops are the unsharded ones (the
    outermost halos are the zero padding)."""
    rng = np.random.default_rng(0)
    x = torch.from_numpy(rng.normal(size=SHAPE).astype(np.float32))
    for s, r, g, ph in CASES:
        w = torch.from_numpy(rng.normal(size=(4, SHAPE[3] // g, 3, 3)).astype(np.float32))
        _close(spatial.spatial_conv2d(x, w, stride=s, rate=r, groups=g, phase=ph), _plain_conv(x, w, s, r, g, ph))
    _close(spatial.spatial_max_pool(x), max_pool_same(x), 0)
    _close(spatial.spatial_global_mean(x), x.mean(dim=(1, 2)), 1e-6)
    assert spatial.spatial_gather(x) is x and spatial.reduce_scatter(x) is x and spatial.ring_all_gather(x) is x
    _close(spatial.halo_exchange(x, 1)[:, 1:-1], x, 0)
    assert float(spatial.halo_exchange(x, 1)[:, [0, -1]].abs().max()) == 0.0
    # a spatial conv (JAX's SpatialConv) holds nn.Conv2d's leaves: a plain
    # conv's state loads into it
    plain = Conv2dSame(4, 5, 3, stride=2, dilation=2)
    conv = Conv2dSame(4, 5, 3, stride=2, dilation=2)
    conv.spatial = True
    conv.load_state_dict(plain.state_dict())
    with torch.no_grad():
        _close(conv(x), plain(x))


def _same_error(port_call, jax_call):
    with pytest.raises(ValueError) as want:
        jax_call()
    with pytest.raises(ValueError) as got:
        port_call()
    assert str(got.value) == str(want.value)


def test_op_errors_are_jax_s():
    x = torch.zeros((1, 6, 5, 2))
    jx = jnp.zeros((1, 6, 5, 2))
    w = torch.zeros((2, 2, 3, 3))
    _same_error(lambda: spatial.halo_exchange(x, 7), lambda: jspatial.halo_exchange(jx, 7))
    _same_error(lambda: spatial.spatial_conv2d(x, w, phase="valid"),
                lambda: jspatial.spatial_conv2d(jx, jnp.zeros((3, 3, 2, 2)), phase="valid"))
    _same_error(lambda: spatial.spatial_conv2d(x, torch.zeros((2, 2, 2, 3))),
                lambda: jspatial.spatial_conv2d(jx, jnp.zeros((2, 3, 2, 2))))
    _same_error(lambda: spatial.spatial_conv2d(x[:, :5], w, stride=2),
                lambda: jspatial.spatial_conv2d(jx[:, :5], jnp.zeros((3, 3, 2, 2)), stride=2))
    _same_error(lambda: spatial.spatial_max_pool(x[:, :5]), lambda: jspatial.spatial_max_pool(jx[:, :5]))
    _same_error(lambda: spatial.shard_spatial(x, spatial_axis=0),
                lambda: jspatial.shard_spatial(np.zeros((1, 6, 5, 2)), None, spatial_axis=0))


def _validate_pair(jmodel, tmodel, degree):
    _same_error(lambda: spatial.validate_spatial_config(tmodel, degree),
                lambda: jspatial.validate_spatial_config(jmodel, degree))


def test_validate_spatial_config_texts_are_jax_s():
    """tgs_salt's 101 x 101 at degree 2 (JAX suggests 112), the MoE ViT,
    the classifier at 224 (stride 32 x 2), the ViT's patch rule; the
    admitted shapes pass both."""
    tgs, jtgs = get_preset("tgs_salt").model, jconfigs.get_preset("tgs_salt").model
    _validate_pair(jtgs, tgs, 2)
    with pytest.raises(ValueError, match=r"\(e\.g\. 112\)"):
        spatial.validate_spatial_config(tgs, 2)
    for name in ("vit_s16_moe_imagenet", "resnet50_classic_imagenet"):
        _validate_pair(jconfigs.get_preset(name).model, get_preset(name).model, 2)
    vit, jvit = get_preset("vit_s16_imagenet").model, jconfigs.get_preset("vit_s16_imagenet").model
    _validate_pair(dataclasses.replace(jvit, input_shape=(208, 208)), dataclasses.replace(vit, input_shape=(208, 208)),
                   2)
    for cfg, jcfg, degree in ((dataclasses.replace(tgs, input_shape=(112, 112)),
                               dataclasses.replace(jtgs, input_shape=(112, 112)), 2), (vit, jvit, 2), (vit, jvit, 7)):
        spatial.validate_spatial_config(cfg, degree)
        jspatial.validate_spatial_config(jcfg, degree)
    for degree in (0, 1):
        spatial.validate_spatial_config(tgs, degree)


def test_space_to_depth_under_the_sequence_axis_raises_jax_s_text():
    from tensorflowdistributedlearning_tpu.models.layers import ConvBN as JConvBN

    cfg = ModelConfig(n_blocks=(1, 1, 1, 1), block_layout="classic", stem_space_to_depth=True, width_multiplier=0.125,
                      input_shape=(64, 64), input_channels=3, num_classes=10)
    model = build_model(cfg, "cpu")
    with pytest.raises(ValueError) as want:
        JConvBN(8, 3, stride=2, space_to_depth=True, spatial_axis_name=SEQUENCE_AXIS).init(
            jax.random.key(0), jnp.zeros((1, 8, 8, 3)))
    with pytest.raises(ValueError) as got:
        set_spatial(model)
    assert str(got.value) == str(want.value)


def test_the_sequence_axis_is_no_longer_refused():
    """Queue A 12.4 is gone from the refusals: the narrow segmenter at 32 x 32
    and the ViT preset pass ``require_supported_training`` at degree 2,
    the too-short input raises JAX's text, the MoE ViT JAX's refusal."""
    seg = ModelConfig(n_blocks=(1, 1, 1), input_shape=(32, 32), width_multiplier=0.125)
    require_supported_training(seg, TrainConfig(sequence_parallel=2))
    require_supported_training(get_preset("vit_s16_imagenet").model, TrainConfig(sequence_parallel=2))
    with pytest.raises(ValueError, match="divisible by stride\\*sequence_parallel"):
        require_supported_training(dataclasses.replace(seg, input_shape=(24, 24)), TrainConfig(sequence_parallel=2))
    with pytest.raises(ValueError, match="moe_experts cannot combine"):
        require_supported_training(get_preset("vit_s16_moe_imagenet").model, TrainConfig(sequence_parallel=2))
    assert "A 12.4" not in inspect.getsource(tconfig)
    # JAX's combination errors stay
    for kw in (dict(model_parallel=2, sequence_parallel=2), dict(pipeline_parallel=2, sequence_parallel=2),
               dict(expert_parallel=2, sequence_parallel=2), dict(augmentation="mixup", sequence_parallel=2)):
        _same_error(lambda: TrainConfig(**kw), lambda: jconfig.TrainConfig(**kw))
