"""The port's segmentation model against the JAX package's, on the CPU.

Weights come from the JAX model's ``init`` (perturbed, with random BN
statistics so BN is no identity) and cross over through ``from_flax``; inputs
are made with numpy from a seed. Whole-model eval logits are held to
atol 1e-4, rtol 1e-4 at an odd (33x33) and an even (32x32) input, the even
size exercising flax's uneven SAME padding on stride-2 convs and the max-pool.
"""

from __future__ import annotations

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax.traverse_util import flatten_dict, unflatten_dict

from tensorflowdistributedlearning_tpu import config as jconfig
from tensorflowdistributedlearning_tpu.data import augment as jaug
from tensorflowdistributedlearning_tpu.models import build_model as jbuild
from tensorflowdistributedlearning_tpu.models import layers as jlayers
from tensorflowdistributedlearning_tpu.models import resnet as jresnet
from tensorflowdistributedlearning_tpu.train.step import SegmentationTask as JTask
from tensorflowdistributedlearning_tpu_torch.config import ModelConfig, require_supported
from tensorflowdistributedlearning_tpu_torch.data import augment as taug
from tensorflowdistributedlearning_tpu_torch.models import build_model, layers as tlayers
from tensorflowdistributedlearning_tpu_torch.models import resnet as tresnet
from tensorflowdistributedlearning_tpu_torch.train.step import SegmentationTask
from tensorflowdistributedlearning_tpu_torch.utils.convert import flatten, from_flax, load_flax_npz
from tests.test_torch_dp_worker import one_torch_thread  # noqa: F401 (autouse)


TINY = dict(n_blocks=(1, 1, 1), width_multiplier=0.125, base_depth=16)


def _variables(cfg_kwargs, seed=0):
    """JAX model, perturbed params and random batch stats, input batch."""
    jm = jbuild(jconfig.ModelConfig(**cfg_kwargs))
    h, w = cfg_kwargs["input_shape"]
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(2, h, w, 2)).astype(np.float32)
    v = jm.init(jax.random.key(seed), jnp.asarray(x), train=False)
    params = jax.tree_util.tree_map(
        lambda a: np.asarray(a) + rng.normal(0, 0.05, a.shape).astype(np.float32), v["params"]
    )
    stats = unflatten_dict({
        k: (rng.uniform(0.5, 1.5, a.shape) if k[-1] == "var" else rng.normal(0, 0.2, a.shape)).astype(np.float32)
        for k, a in flatten_dict(v["batch_stats"]).items()
    })
    return jm, params, stats, x


@pytest.fixture(scope="module", params=[(33, 33), (32, 32)], ids=["odd33", "even32"])
def pair(request):
    kw = dict(TINY, input_shape=request.param)
    jm, params, stats, x = _variables(kw)
    logits = np.asarray(jm.apply({"params": params, "batch_stats": stats}, jnp.asarray(x), train=False))
    cfg = ModelConfig(**kw, use_pallas_depthwise=True)
    model = build_model(cfg, "cpu")
    model.load_state_dict(from_flax(params, stats, cfg))
    return dict(cfg=cfg, model=model, params=params, stats=stats, x=x, logits=logits)


def test_eval_logits_match_jax(pair):
    with torch.inference_mode():
        got = pair["model"](torch.from_numpy(pair["x"])).numpy()
    want = pair["logits"]
    assert got.shape == want.shape == (2, *pair["cfg"].input_shape, 1)
    assert want.std() > 0.3  # random BN stats keep the comparison meaningful
    np.testing.assert_allclose(got, want, atol=1e-4, rtol=1e-4)


def test_depthwise_flag_does_not_change_cpu_numerics(pair):
    cfg = dataclasses.replace(pair["cfg"], use_pallas_depthwise=False)
    model = build_model(cfg, "cpu")
    model.load_state_dict(from_flax(pair["params"], pair["stats"], cfg))
    x = torch.from_numpy(pair["x"])
    with torch.inference_mode():
        torch.testing.assert_close(model(x), pair["model"](x), rtol=0, atol=0)


def test_serve_predictions_match_jax(pair):
    jout = JTask().serve_predictions(jnp.asarray(pair["logits"]))
    with torch.inference_mode():
        out = SegmentationTask().serve_predictions(pair["model"](torch.from_numpy(pair["x"])))
    jp, jmask = np.asarray(jout["probabilities"]), np.asarray(jout["mask"])
    p, mask = out["probabilities"].numpy(), out["mask"].numpy()
    # probs inherit the logits' 1e-4 tolerance through sigmoid' <= 1/4
    np.testing.assert_allclose(p, jp, atol=3e-5, rtol=0)
    away = np.abs(jp - 0.5) >= 1e-4
    np.testing.assert_array_equal(mask[away], jmask[away])
    np.testing.assert_array_equal(mask, (p > 0.5).astype(np.float32))


def test_parameter_count_matches_jax_tiny(pair):
    n_jax = sum(np.size(a) for a in jax.tree_util.tree_leaves(pair["params"]))
    assert sum(p.numel() for p in pair["model"].parameters()) == n_jax


def test_parameter_count_matches_jax_full_width():
    jm = jbuild(jconfig.ModelConfig())
    shapes = jax.eval_shape(lambda k, x: jm.init(k, x, train=False), jax.random.key(0), jnp.zeros((1, 101, 101, 2)))
    n_jax = sum(int(np.prod(a.shape)) for a in jax.tree_util.tree_leaves(shapes["params"]))
    with torch.device("meta"):
        model = tresnet.ResNetSegmentation(ModelConfig(use_pallas_depthwise=True))
    n_port = sum(p.numel() for p in model.parameters())
    assert n_port == n_jax
    assert 41_000_000 < n_port < 42_500_000


def test_state_dict_names_map_one_to_one_onto_flax(pair):
    state = from_flax(pair["params"], pair["stats"], pair["cfg"])
    assert set(state) == set(pair["model"].state_dict())
    n_leaves = len(flatten(pair["params"])) + len(flatten(pair["stats"]))
    assert len(state) == n_leaves


# -- from_flax strictness -------------------------------------------------------------


def _flat(pair):
    return dict(flatten(pair["params"])), dict(flatten(pair["stats"]))


def test_from_flax_rejects_unused_leaf(pair):
    params, stats = _flat(pair)
    params["backbone/extra/kernel"] = np.zeros((1, 1, 1, 1), np.float32)
    with pytest.raises(ValueError, match="does not use"):
        from_flax(params, stats, pair["cfg"])


def test_from_flax_rejects_missing_leaf(pair):
    params, stats = _flat(pair)
    del params["aspp/project/bn/scale"]
    with pytest.raises(KeyError, match="aspp/project/bn/scale"):
        from_flax(params, stats, pair["cfg"])


def test_from_flax_rejects_missing_batch_stat(pair):
    params, stats = _flat(pair)
    del stats["backbone/postnorm/var"]
    with pytest.raises(KeyError, match="postnorm/var"):
        from_flax(params, stats, pair["cfg"])


def test_from_flax_rejects_wrong_shape(pair):
    params, stats = _flat(pair)
    params["decoder_conv_3x3/bias"] = np.zeros((2,), np.float32)
    with pytest.raises(ValueError, match="shape"):
        from_flax(params, stats, pair["cfg"])


def test_from_flax_rejects_other_config(pair):
    cfg = dataclasses.replace(pair["cfg"], base_depth=32)
    with pytest.raises(ValueError):
        from_flax(pair["params"], pair["stats"], cfg)


def test_from_flax_reads_the_npz_layout(pair, tmp_path):
    flat = flatten_dict({"params": pair["params"], "batch_stats": pair["stats"]}, sep="/")
    path = tmp_path / "vars.npz"
    np.savez(path, **{k: np.asarray(v) for k, v in flat.items()})
    params, stats = load_flax_npz(str(path))
    state = from_flax(params, stats, pair["cfg"])
    ref = from_flax(pair["params"], pair["stats"], pair["cfg"])
    assert all(torch.equal(state[k], ref[k]) for k in ref)


def test_depthwise_weight_layout(pair):
    state = from_flax(pair["params"], pair["stats"], pair["cfg"])
    flax_k = np.asarray(pair["params"]["aspp"]["conv_3x3_2"]["depthwise"]["kernel"])
    np.testing.assert_array_equal(state["aspp.conv_3x3_2.depthwise.weight"].numpy(), flax_k[:, :, 0, :])
    conv_k = np.asarray(pair["params"]["backbone"]["conv1_1"]["conv"]["kernel"])
    np.testing.assert_array_equal(state["backbone.conv1_1.conv.weight"].numpy(), conv_k.transpose(3, 2, 0, 1))


# -- layers -----------------------------------------------------------------------------


@pytest.mark.parametrize("size", [31, 32, 101, 26])
@pytest.mark.parametrize("k,stride,rate", [(3, 2, 1), (1, 2, 1), (3, 1, 2), (3, 1, 1)])
def test_conv2d_same_matches_flax_same(size, k, stride, rate):
    rng = np.random.default_rng(size + k)
    x = rng.normal(size=(1, size, size, 3)).astype(np.float32)
    w = rng.normal(size=(k, k, 3, 4)).astype(np.float32)
    want = jax.lax.conv_general_dilated(
        jnp.asarray(x), jnp.asarray(w), (stride, stride), "SAME", rhs_dilation=(rate, rate),
        dimension_numbers=("NHWC", "HWIO", "NHWC"),
    )
    got = tlayers.conv2d_same(torch.from_numpy(x), torch.from_numpy(w.transpose(3, 2, 0, 1)), None, stride, rate)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5, rtol=1e-5)


@pytest.mark.parametrize("size", [26, 25, 51, 8])
def test_max_pool_matches_flax_same(size):
    import flax.linen as nn

    x = np.random.default_rng(size).normal(size=(2, size, size, 3)).astype(np.float32) - 5.0
    want = nn.max_pool(jnp.asarray(x), (3, 3), strides=(2, 2), padding="SAME")
    got = tlayers.max_pool_same(torch.from_numpy(x), 3, 2)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


@pytest.mark.parametrize("mode", ["constant", "symmetric", "reflect"])
@pytest.mark.parametrize("k,rate", [(3, 1), (5, 1), (3, 2), (4, 1)])
def test_fixed_padding_matches_jax(mode, k, rate):
    x = np.random.default_rng(k).normal(size=(1, 6, 7, 2)).astype(np.float32)
    want = jlayers.fixed_padding(jnp.asarray(x), k, mode=mode, rate=rate)
    got = tlayers.fixed_padding(torch.from_numpy(x), k, mode=mode, rate=rate)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


@pytest.mark.parametrize("src,dst", [((1, 1), (13, 13)), ((13, 13), (26, 26)), ((26, 26), (101, 101)),
                                     ((8, 8), (32, 32)), ((9, 9), (33, 33)), ((4, 5), (7, 11))])
def test_upsample_matches_jax(src, dst):
    x = np.random.default_rng(0).normal(size=(2, *src, 3)).astype(np.float32)
    want = jlayers.upsample(jnp.asarray(x), dst)
    got = tlayers.upsample(torch.from_numpy(x), dst)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5, rtol=1e-5)


@pytest.mark.parametrize("stride", [1, 2, 3])
def test_subsample_matches_jax(stride):
    x = np.arange(2 * 7 * 6 * 3, dtype=np.float32).reshape(2, 7, 6, 3)
    np.testing.assert_array_equal(
        tlayers.subsample(torch.from_numpy(x), stride).numpy(), np.asarray(jlayers.subsample(jnp.asarray(x), stride))
    )


@pytest.mark.parametrize("c,m", [(64, 1.0), (64, 0.125), (3, 0.1), (1024, 0.3)])
def test_scaled_width_matches_jax(c, m):
    assert tlayers.scaled_width(c, m) == jlayers.scaled_width(c, m)


@pytest.mark.parametrize("n_blocks,wm", [((3, 4, 6), 1.0), ((1, 1, 1), 0.125), ((2, 3, 1), 0.5)])
def test_block_specs_match_jax(n_blocks, wm):
    ours = tresnet.resnet_block_specs(n_blocks, tresnet.SEGMENTATION_MULTI_GRID, wm)
    theirs = jresnet.resnet_block_specs(n_blocks, jresnet.SEGMENTATION_MULTI_GRID, wm)
    assert [(b.name, [dataclasses.asdict(u) for u in b.units]) for b in ours] == [
        (b.name, [dataclasses.asdict(u) for u in b.units]) for b in theirs
    ]


def test_stack_blocks_dense_rates():
    blocks = tresnet.resnet_block_specs((3, 4, 6))
    applied = list(tresnet.stack_blocks_dense(blocks, 8))
    assert [a[2].stride for a in applied].count(2) == 1  # only block1's last unit strides
    assert [a[3] for a in applied[-3:]] == [4, 4, 4]  # block4 runs at rate 4 x multi-grid
    with pytest.raises(ValueError, match="multiple of 4"):
        list(tresnet.stack_blocks_dense(blocks, 6))


def test_training_mode_raises():
    # training mode runs (batch statistics; the training slice); remat, once
    # refused here, trains since queue A 4's model half: the same loss,
    # gradients and running statistics as the model without it, bit for bit
    model = build_model(ModelConfig(**TINY, input_shape=(17, 17)), "cpu").train()
    assert model(torch.randn(2, 17, 17, 2)).shape == (2, 17, 17, 1)
    cfg = ModelConfig(**TINY, input_shape=(17, 17), remat=True)
    remat = build_model(cfg, "cpu").train()
    plain = build_model(dataclasses.replace(cfg, remat=False), "cpu").train()
    plain.load_state_dict(remat.state_dict())
    x = torch.from_numpy(np.random.default_rng(3).normal(size=(2, 17, 17, 2)).astype(np.float32))
    losses = []
    for m in (remat, plain):
        loss = m(x).square().mean()
        loss.backward()
        losses.append(loss.detach())
    assert torch.equal(losses[0], losses[1])
    for (name, a), b in zip(remat.named_parameters(), plain.parameters()):
        assert torch.equal(a.grad, b.grad), name
    for (name, a), b in zip(remat.state_dict().items(), plain.state_dict().values()):
        assert torch.equal(a, b), name


# -- preprocessing ------------------------------------------------------------------------


def test_preprocessing_matches_jax():
    img = np.random.default_rng(5).uniform(0, 1, (3, 101, 101, 1)).astype(np.float32)
    want = np.asarray(jaug.add_laplace_channel(jaug.normalize(jnp.asarray(img))))
    got = taug.add_laplace_channel(taug.normalize(torch.from_numpy(img))).numpy()
    assert got.shape == (3, 101, 101, 2)
    np.testing.assert_allclose(got, want, atol=1e-5, rtol=1e-6)
    assert (taug.MEAN, taug.STD) == (jaug.MEAN, jaug.STD)


def test_laplacian_multi_channel_matches_jax():
    img = np.random.default_rng(6).normal(size=(2, 9, 8, 3)).astype(np.float32)
    np.testing.assert_allclose(
        taug.laplacian(torch.from_numpy(img)).numpy(), np.asarray(jaug.laplacian(jnp.asarray(img))), atol=1e-5
    )


# -- configuration -------------------------------------------------------------------------


def test_model_config_mirrors_jax_field_for_field():
    ours = {f.name: f.default for f in dataclasses.fields(ModelConfig)}
    theirs = {f.name: f.default for f in dataclasses.fields(jconfig.ModelConfig)}
    assert ours == theirs


@pytest.mark.parametrize(
    "kwargs",
    [{"backbone": "vgg"}, {"block_type": "dense"}, {"dtype": "float16"}, {"block_layout": "wide"},
     {"block_layout": "classic"}, {"width_multiplier": 0.0}, {"stem_space_to_depth": True},
     {"moe_experts": -1}, {"moe_experts": 2}],
)
def test_model_config_rejects_what_jax_rejects(kwargs):
    with pytest.raises(ValueError):
        jconfig.ModelConfig(**kwargs)
    with pytest.raises(ValueError):
        ModelConfig(**kwargs)


@pytest.mark.parametrize(
    "kwargs",
    [{"backbone": "xception"}, {"backbone": "vit", "num_classes": 10, "moe_experts": 2}, {"num_classes": 10},
     {"dtype": "bfloat16"}, {"stem_space_to_depth": True, "input_shape": (100, 100)}, {"block_type": "basic_block"},
     {"block_layout": "classic", "n_blocks": (3, 4, 6, 3)}],
)
def test_later_slices_raise_not_implemented(kwargs):
    """Each knob a later slice brought is accepted, and a narrow model of
    each builds and runs: the ResNet knobs of queue A 4 (the classification
    head, bf16 compute, the space-to-depth stem, basic blocks, the classic
    layout), the Xception backbone (queue A 11) and the Switch-MoE ViT
    (queue A 12.3) (the parity tests are
    ``tests/test_torch_resnet_classifier.py``,
    ``tests/test_torch_resnet_bf16.py``, ``tests/test_torch_xception.py``
    and ``tests/test_torch_vit_moe.py``)."""
    cfg = ModelConfig(**kwargs)
    require_supported(cfg)
    if cfg.moe_experts:
        model = build_model(dataclasses.replace(cfg, embed_dim=32, num_heads=2, input_shape=(32, 32)), "cpu")
        assert [n for n, m in model.named_modules() if n.endswith(".moe")] == [
            f"block{i}.moe" for i in range(2, cfg.vit_layers + 1, 2)]
        out = model(torch.zeros(2, 32, 32, 2))
        assert out.shape == (2, 10) and bool(torch.isfinite(out).all())
        return
    narrow = dataclasses.replace(cfg, width_multiplier=0.125, base_depth=16, input_shape=(32, 32),
                                 n_blocks=(1, 1, 1, 1) if cfg.block_layout == "classic" else (1, 1, 1))
    out = build_model(narrow, "cpu")(torch.randn(2, 32, 32, 2))
    assert out.shape == ((2, 10) if cfg.num_classes else (2, 32, 32, 1))
    assert out.dtype == torch.float32 and bool(torch.isfinite(out).all())


def test_vit_without_num_classes_raises_value_error_at_build():
    cfg = ModelConfig(backbone="vit")
    require_supported(cfg)
    with pytest.raises(ValueError, match="set num_classes"):
        build_model(cfg, "cpu")


def test_model_config_json_round_trip():
    cfg = ModelConfig(**TINY, input_shape=(33, 33), use_pallas_depthwise=True)
    assert ModelConfig.from_json(cfg.to_json()) == cfg
    with pytest.raises(ValueError, match="unknown"):
        ModelConfig.from_dict({"bogus": 1})
