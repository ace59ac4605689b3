"""The port's ViT classifier (``models/vit.py``, ``configs.py``, the ViT
mapping of ``utils/convert.py``) against the JAX package's, on the CPU.

A tiny ViT (32x32x3 input, patch 8, embed 32, 2 heads, 2 layers, 10
classes) is initialised by flax, its parameters perturbed from a numpy
seed, and carried across with ``from_flax``; inputs are numpy draws. JAX's
fused-attention path is forced open (``vit._fused_platform_ok``, as
``tests/test_flash_attention.py`` does), so its Pallas kernel runs in the
interpreter. Tolerances on the logits:

- float32 compute: rtol 1e-5, atol 1e-5 (measured: 3.6e-7 at logits of
  about 1.4);
- bfloat16 compute: atol 0.03 at logits of about 1.4 (measured: 3.5e-3).
  Both packages round every Dense, LayerNorm and gelu output to bf16, but
  at different places inside each op (XLA's bf16 dot and PyTorch's, the
  gelu's tanh form rounded per op in JAX, once in PyTorch), so their
  activations differ by a few bf16 steps. The argmax must agree on every
  row whose top two logits lie further apart than the bound.
"""

from __future__ import annotations

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax.traverse_util import flatten_dict

import tensorflowdistributedlearning_tpu.models.vit as jvit
from tensorflowdistributedlearning_tpu import config as jconfig
from tensorflowdistributedlearning_tpu import configs as jconfigs
from tensorflowdistributedlearning_tpu.models import build_model as jbuild
from tensorflowdistributedlearning_tpu_torch import configs as tconfigs
from tensorflowdistributedlearning_tpu_torch.config import (
    ModelConfig,
    TrainConfig,
    require_supported,
    require_supported_training,
)
from tensorflowdistributedlearning_tpu_torch.models import build_model, model_for
from tensorflowdistributedlearning_tpu_torch.models import vit as tvit
from tensorflowdistributedlearning_tpu_torch.ops import kernels
from tensorflowdistributedlearning_tpu_torch.utils.convert import flatten, from_flax, kernel_leaves
from tests.test_torch_dp_worker import one_torch_thread  # noqa: F401 (autouse)


TINY_VIT = dict(backbone="vit", num_classes=10, input_shape=(32, 32), input_channels=3, patch_size=8,
                embed_dim=32, num_heads=2, vit_layers=2, output_stride=None)
TOL_F32 = 1e-5
TOL_BF16 = 0.03
VIT_S16_PARAMS = 22_049_896


def tiny_vit_pair(dtype="float32", fused=True, seed=0, batch=3, **over):
    """JAX model, perturbed flax params, the port's config, state and input
    (``over`` replaces fields of the tiny ViT)."""
    kw = dict(TINY_VIT, **over, dtype=dtype, use_fused_attention=fused)
    jm = jbuild(jconfig.ModelConfig(**kw))
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(batch, 32, 32, 3)).astype(np.float32)
    v = jm.init(jax.random.key(seed), jnp.asarray(x), train=False)
    params = jax.tree_util.tree_map(lambda a: np.asarray(a) + rng.normal(0, 0.05, a.shape).astype(np.float32),
                                    v["params"])
    cfg = ModelConfig(**kw)
    return dict(jm=jm, params=params, cfg=cfg, x=x, state=from_flax(params, {}, cfg))


@pytest.fixture
def fused_jax(monkeypatch):
    monkeypatch.setattr(jvit, "_fused_platform_ok", lambda: True)


def _port_logits(pair):
    model = build_model(pair["cfg"], "cpu")
    model.load_state_dict(pair["state"], strict=True)
    with torch.inference_mode():
        return model(torch.from_numpy(pair["x"]))


# -- configs -------------------------------------------------------------------


@pytest.mark.parametrize("name", sorted(jconfigs.PRESETS))
def test_preset_equals_jax(name):
    j = jconfigs.get_preset(name)
    want = {"model": dataclasses.asdict(j.model), "train": dataclasses.asdict(j.train),
            "global_batch": j.global_batch, "description": j.description}
    want["model"]["input_shape"] = list(want["model"]["input_shape"])
    want["model"]["n_blocks"] = list(want["model"]["n_blocks"])
    assert tconfigs.get_preset(name).to_dict() == want


def test_get_preset_rejects_unknown_names():
    with pytest.raises(ValueError, match="Unknown preset"):
        tconfigs.get_preset("vit_huge")


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("fused", [False, True], ids=["xla_path", "fused"])
def test_vit_is_supported_for_serving_but_not_training(dtype, fused):
    """The ViT serves, and trains since ViT training was ported (queue A
    1); ``remat``, once refused here, trains too (queue A 4): each block
    recomputed in the backward, gradients bit for bit those without it."""
    cfg = ModelConfig(**TINY_VIT, dtype=dtype, use_fused_attention=fused)
    require_supported(cfg)
    require_supported_training(cfg, TrainConfig())
    remat_cfg = dataclasses.replace(cfg, remat=True)
    require_supported_training(remat_cfg, TrainConfig())
    models = [build_model(c, "cpu", generator=torch.Generator().manual_seed(0)).train() for c in (remat_cfg, cfg)]
    x = torch.from_numpy(np.random.default_rng(0).normal(size=(2, *cfg.input_shape, cfg.input_channels))
                         .astype(np.float32))
    for m in models:
        m(x).float().square().mean().backward()
    for (name, a), b in zip(models[0].named_parameters(), models[1].parameters()):
        assert torch.equal(a.grad, b.grad), name


def test_preset_model_is_supported():
    """Both ViT presets: the Switch-MoE one, refused until queue A 12.3,
    builds too (its parity tests are ``tests/test_torch_vit_moe.py``)."""
    require_supported(tconfigs.get_preset("vit_s16_imagenet").model)
    require_supported(tconfigs.get_preset("vit_s16_moe_imagenet").model)


@pytest.mark.parametrize(
    "kwargs, match",
    [({"embed_dim": 30, "num_heads": 4}, "not divisible by num_heads"),
     ({"input_shape": (30, 32)}, "not divisible by patch_size")],
)
def test_vit_rejects_bad_geometry_at_build(kwargs, match):
    with pytest.raises(ValueError, match=match):
        build_model(ModelConfig(**dict(TINY_VIT, **kwargs)), "cpu")


def test_vit_rejects_inputs_of_another_shape():
    model = build_model(ModelConfig(**TINY_VIT), "cpu")
    with pytest.raises(ValueError, match="input_shape"):
        model(torch.zeros(1, 32, 40, 3))


# -- head widths of the fused attention (queue C 2) ---------------------------------------


def _fused_vit(d, dtype="float32", heads=2):
    return ModelConfig(**dict(TINY_VIT, embed_dim=d * heads, num_heads=heads), dtype=dtype, use_fused_attention=True)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("d", [8, 24, 40, 144])
def test_fused_vit_with_a_head_width_no_kernel_takes_is_refused(dtype, d):
    """Refused when the config is checked, naming the queue item, and not at
    the first forward on the card; the same ViT without the fused path runs."""
    with pytest.raises(NotImplementedError, match="queue C 2"):
        require_supported(_fused_vit(d, dtype))
    with pytest.raises(NotImplementedError, match="queue C 2"):
        build_model(_fused_vit(d, dtype), "cpu")
    require_supported(dataclasses.replace(_fused_vit(d, dtype), use_fused_attention=False))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_fused_vit_with_head_width_48_is_accepted(dtype):
    cfg = _fused_vit(48, dtype)
    assert (cfg.embed_dim, cfg.num_heads) == (96, 2)
    require_supported(cfg)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_head_width_tuples_and_require_supported_agree(dtype):
    """A fused ViT is admitted exactly when every attention kernel it can
    reach takes its head width: a bfloat16-compute ViT reaches the bf16
    kernel only; a float32-compute one the float32 kernel and, under
    int8-compute (bf16 out of the int8 matmuls), the bf16 kernel."""
    from tensorflowdistributedlearning_tpu_torch.ops.flash_attention import KERNEL_HEAD_DIMS

    reached = (torch.bfloat16,) if dtype == "bfloat16" else (torch.float32, torch.bfloat16)
    for d in range(4, 261, 4):
        try:
            require_supported(_fused_vit(d, dtype))
            admitted = True
        except NotImplementedError:
            admitted = False
        assert admitted == all(d in KERNEL_HEAD_DIMS[t] for t in reached), d


# -- the forward against flax ----------------------------------------------------------


@pytest.mark.parametrize("fused", [True, False], ids=["fused", "xla_path"])
def test_float32_logits_match_flax(fused_jax, fused):
    pair = tiny_vit_pair("float32", fused)
    want = np.asarray(pair["jm"].apply({"params": pair["params"]}, jnp.asarray(pair["x"]), train=False))
    got = _port_logits(pair)
    assert got.dtype == torch.float32 and tuple(got.shape) == (3, 10)
    np.testing.assert_allclose(got.numpy(), want, rtol=TOL_F32, atol=TOL_F32)


def test_head_width_48_fused_logits_match_flax(fused_jax):
    """A newly admitted width (embed 96, 2 heads of 48): the fused path's
    CPU forward against flax on the same converted weights."""
    pair = tiny_vit_pair("float32", True, embed_dim=96, num_heads=2)
    require_supported(pair["cfg"])
    want = np.asarray(pair["jm"].apply({"params": pair["params"]}, jnp.asarray(pair["x"]), train=False))
    got = _port_logits(pair)
    np.testing.assert_allclose(got.numpy(), want, rtol=TOL_F32, atol=TOL_F32)


def test_bfloat16_logits_match_flax_within_bound(fused_jax):
    pair = tiny_vit_pair("bfloat16", True, batch=8)
    want = np.asarray(pair["jm"].apply({"params": pair["params"]}, jnp.asarray(pair["x"]), train=False))
    got = _port_logits(pair)
    assert want.dtype == np.float32 and got.dtype == torch.float32  # the logits Dense has no dtype
    got = got.numpy()
    np.testing.assert_allclose(got, want, rtol=0, atol=TOL_BF16)
    top2 = np.sort(want, axis=-1)[:, -2:]
    separated = top2[:, 1] - top2[:, 0] > 2 * TOL_BF16
    assert separated.sum() >= 4
    np.testing.assert_array_equal(got.argmax(-1)[separated], want.argmax(-1)[separated])


def test_fused_and_plain_attention_agree_and_launch_nothing_on_cpu():
    pair = tiny_vit_pair("float32", True)
    kernels.reset_launch_counts()
    fused = _port_logits(pair)
    plain = _port_logits(dict(pair, cfg=dataclasses.replace(pair["cfg"], use_fused_attention=False)))
    assert torch.equal(fused, plain)
    assert sum(kernels.launch_counts().values()) == 0


def test_layer_norm_is_flax_layer_norm():
    import flax.linen as jnn

    rng = np.random.default_rng(5)
    x = (rng.normal(size=(2, 7, 24)) * 3 + 1).astype(np.float32)
    scale, bias = rng.normal(size=24).astype(np.float32), rng.normal(size=24).astype(np.float32)
    for dtype, jdtype in ((torch.float32, jnp.float32), (torch.bfloat16, jnp.bfloat16)):
        ln = tvit.LayerNorm(24, dtype)
        ln.load_state_dict({"weight": torch.from_numpy(scale), "bias": torch.from_numpy(bias)})
        xin = torch.from_numpy(x).to(dtype)
        with torch.no_grad():
            got = ln(xin)
        want = jnn.LayerNorm(dtype=jdtype).apply({"params": {"scale": scale, "bias": bias}},
                                                 jnp.asarray(x).astype(jdtype))
        assert got.dtype == dtype
        np.testing.assert_allclose(got.float().numpy(), np.asarray(want, np.float32), rtol=2e-6, atol=2e-6)


# -- from_flax -------------------------------------------------------------------------


def test_from_flax_is_strict_both_ways():
    pair = tiny_vit_pair()
    flat = flatten(pair["params"])
    extra = dict(flat, **{"block1/attn/extra/kernel": np.zeros((2, 2), np.float32)})
    with pytest.raises(ValueError, match="does not use"):
        from_flax(extra, {}, pair["cfg"])
    missing = {k: v for k, v in flat.items() if k != "block2/mlp_out/bias"}
    with pytest.raises(KeyError, match="block2/mlp_out/bias"):
        from_flax(missing, {}, pair["cfg"])
    wrong = dict(flat, **{"pos_embedding": np.zeros((15, 32), np.float32)})
    with pytest.raises(ValueError, match="shape"):
        from_flax(wrong, {}, pair["cfg"])
    with pytest.raises(ValueError, match="batch_stats leaves"):
        from_flax(flat, {"ln_final": {"mean": np.zeros(32, np.float32)}}, pair["cfg"])


def test_from_flax_layouts():
    pair = tiny_vit_pair()
    p, s = pair["params"], pair["state"]
    np.testing.assert_array_equal(s["block1.attn.qkv.weight"].numpy(), p["block1"]["attn"]["qkv"]["kernel"].T)
    np.testing.assert_array_equal(s["patch_embed.weight"].numpy(), p["patch_embed"]["kernel"].transpose(3, 2, 0, 1))
    np.testing.assert_array_equal(s["ln_final.weight"].numpy(), p["ln_final"]["scale"])
    np.testing.assert_array_equal(s["pos_embedding"].numpy(), p["pos_embedding"])


def test_kernel_leaves_are_flax_kernels():
    pair = tiny_vit_pair()
    leaves = kernel_leaves(pair["cfg"])
    flax_kernels = sorted(k for k in flatten(pair["params"]) if k.endswith("/kernel"))
    assert sorted(path for path, _ in leaves.values()) == flax_kernels
    assert len(flax_kernels) == 2 * 4 + 2  # 4 Dense per block, the patch conv, the logits
    assert all(axis == 0 for _, axis in leaves.values())


def test_full_preset_tree_maps_strictly():
    """The full vit_s16_imagenet tree, shapes from ``jax.eval_shape`` and
    the port's template on the meta device; zeros carry the shapes through
    ``from_flax`` without materialising a random model."""
    jcfg = jconfigs.get_preset("vit_s16_imagenet").model
    tcfg = tconfigs.get_preset("vit_s16_imagenet").model
    x = jax.ShapeDtypeStruct((1, 224, 224, 3), jnp.float32)
    shapes = jax.eval_shape(lambda a: jbuild(jcfg).init(jax.random.key(0), a, train=False), x)["params"]
    flat = {"/".join(k): np.broadcast_to(np.float32(0), v.shape) for k, v in flatten_dict(shapes).items()}
    assert sum(int(np.prod(v.shape)) for v in flat.values()) == VIT_S16_PARAMS
    with torch.device("meta"):
        template = model_for(tcfg)
    assert sum(p.numel() for p in template.parameters()) == VIT_S16_PARAMS
    state = from_flax(flat, {}, tcfg)
    assert set(state) == set(template.state_dict())
    assert sum(t.numel() for t in state.values()) == VIT_S16_PARAMS
    assert len(kernel_leaves(tcfg)) == 12 * 4 + 2


def test_init_follows_flax_initializers():
    cfg = ModelConfig(**dict(TINY_VIT, embed_dim=64, num_heads=2))
    model = build_model(cfg, "cpu", generator=torch.Generator().manual_seed(1))
    w = model.block1.mlp_in.weight  # lecun normal over fan_in 64
    assert abs(w.std().item() - (1 / 64) ** 0.5) < 0.2 * (1 / 64) ** 0.5
    assert w.abs().max().item() <= 2 * (1 / 64) ** 0.5 / 0.87962566103423978 + 1e-6
    assert abs(model.pos_embedding.std().item() - 0.02) < 0.004
    assert torch.equal(model.block1.ln1.weight, torch.ones(64)) and not model.block1.mlp_in.bias.any()
    again = build_model(cfg, "cpu", generator=torch.Generator().manual_seed(1))
    assert all(torch.equal(a, b) for a, b in zip(model.state_dict().values(), again.state_dict().values()))
