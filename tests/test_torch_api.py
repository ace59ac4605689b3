"""The port's public API (queue A 18) and the run header's ``mesh`` (queue
C 4) against the JAX package's, on the CPU.

- Every name in a JAX package ``__all__`` is in the port's matching
  ``__all__``, or in :data:`NOT_EXPORTED`, which names the ROADMAP item
  that brings it or says it is not to be ported; a port export is the
  object of the module it names.
- ``utils``: ``count_params``, ``metric_comparison``,
  ``get_available_devices`` and ``profiling``'s ``StepTimer``, ``sync``,
  ``annotate``, ``trace``, ``memory_stats``, ``log_memory`` behave as
  JAX's on the CPU; ``configs.resnet_depth_blocks`` and
  ``native.decode_png_batch`` give JAX's answers (the latter bit for bit
  on the same PNGs through the native decoder, and through ``data/png.py``
  but for its RGB-to-grey fold, within 2^-23).
- C 4: ``mesh.axis_sizes`` is JAX's ``make_mesh`` axis dict at dp, tp,
  pp, ep and sp layouts, and JAX's ``obs.compare._normalized_layout``
  reads a port header to the right ``data_parallel``; the one-process
  ``run_info`` is JAX's three keys.
"""

from __future__ import annotations

import dataclasses
import importlib
import logging
import os

import numpy as np
import pytest
import torch

import tensorflowdistributedlearning_tpu as jpkg
import tensorflowdistributedlearning_tpu_torch as tpkg
from tensorflowdistributedlearning_tpu import configs as jconfigs
from tensorflowdistributedlearning_tpu.obs import compare as jcompare
from tensorflowdistributedlearning_tpu.parallel import mesh as jmesh
from tensorflowdistributedlearning_tpu.utils import profiling as jprofiling
from tensorflowdistributedlearning_tpu_torch import configs as tconfigs
from tensorflowdistributedlearning_tpu_torch.config import ModelConfig, TrainConfig
from tensorflowdistributedlearning_tpu_torch.parallel import mesh as tmesh
from tensorflowdistributedlearning_tpu_torch.train.trainer import run_info
from tensorflowdistributedlearning_tpu_torch.utils import profiling as tprofiling

A14_2 = "ROADMAP queue A 14.2 (the trainers' fault sites, preemption, the supervisor)"
A14_4 = "ROADMAP queue A 14.4 (the fleet tier)"
A13 = "ROADMAP queue A 13's remainder (obs/recompile.py, after CUDA graphs, B 7)"
SHARDING = "not to port: JAX sharding helpers (mesh.py's layouts and groups stand in for them)"

# JAX package exports the port does not export, and why
NOT_EXPORTED = {
    "obs": {"RecompileDetector": A13},
    "train": {"make_multi_train_step": "not to port: a K-step lax.scan compiled as one XLA program"},
    "parallel": {n: SHARDING for n in ("available_devices", "batch_sharding", "make_mesh", "replicate",
                                       "replicated_sharding", "shard_batch", "shard_batch_stacked",
                                       "global_shard_batch", "pmean_tree", "psum_tree", "vma_of",
                                       "shard_state_weight_update", "weight_update_spec")},
    "resilience": {n: A14_2 for n in ("ABORT_CRASH_LOOP", "ABORT_RESTART_BUDGET", "ABORT_SIGNALED", "EXIT_PREEMPTED",
                                      "PreemptedError", "PreemptionHandler", "Supervisor", "SupervisorResult",
                                      "ledger_progress", "run_supervised")},
    "serve": {n: A14_4 for n in ("AutoscaleConfig", "Autoscaler", "FleetConfig", "FleetManager", "FleetRouter",
                                 "PromoteConfig", "PromotionController", "ServeFleet")},
}
PACKAGES = ["", "data", "models", "native", "obs", "ops", "parallel", "resilience", "serve", "train", "utils"]


def _pkg(root, sub):
    return importlib.import_module(root + (f".{sub}" if sub else ""))


@pytest.mark.parametrize("sub", PACKAGES, ids=lambda s: s or "top")
def test_every_jax_export_is_exported_or_listed(sub):
    jmod = _pkg("tensorflowdistributedlearning_tpu", sub)
    tmod = _pkg("tensorflowdistributedlearning_tpu_torch", sub)
    listed = NOT_EXPORTED.get(sub, {})
    for name in jmod.__all__:
        if name in listed:
            assert name not in tmod.__all__, name
            assert listed[name].startswith(("ROADMAP queue", "not to port")), name
            continue
        assert name in tmod.__all__, f"{sub}.{name}"
        assert getattr(tmod, name) is not None
    assert set(listed) <= set(jmod.__all__)


@pytest.mark.parametrize("sub", [p for p in PACKAGES if p], ids=str)
def test_port_exports_are_their_modules_objects(sub):
    tmod = _pkg("tensorflowdistributedlearning_tpu_torch", sub)
    for name in tmod.__all__:
        obj = getattr(tmod, name)
        home = getattr(obj, "__module__", None)
        if home and home.startswith("tensorflowdistributedlearning_tpu_torch.") and not isinstance(obj, type(os)):
            assert getattr(importlib.import_module(home), getattr(obj, "__name__", name), obj) is obj, name


def test_top_level_exports_train_config_version_and_a_lazy_model():
    assert tpkg.TrainConfig is TrainConfig and tpkg.ModelConfig is ModelConfig
    assert tpkg.__version__ == jpkg.__version__
    from tensorflowdistributedlearning_tpu_torch.train.trainer import Trainer

    assert tpkg.Model is Trainer
    with pytest.raises(AttributeError):
        tpkg.NoSuchName  # noqa: B018


# -- utils ---------------------------------------------------------------------------


def test_count_params_is_jaxs():
    from tensorflowdistributedlearning_tpu.utils import count_params as jcount
    from tensorflowdistributedlearning_tpu_torch.models import build_model
    from tensorflowdistributedlearning_tpu_torch.utils import count_params

    tree = {"a": np.zeros((3, 4)), "b": [np.zeros(5), {"c": np.zeros((2, 2, 2))}], "d": 1.0}
    assert count_params(tree) == jcount(tree) == 12 + 5 + 8
    model = build_model(ModelConfig(backbone="vit", num_classes=4, input_shape=(16, 16), input_channels=3,
                                    patch_size=4, embed_dim=32, vit_layers=2, num_heads=4, output_stride=None), "cpu")
    assert count_params(model) == count_params(dict(model.named_parameters())) == sum(
        p.numel() for p in model.parameters())


@pytest.mark.parametrize("greater", [True, False])
def test_metric_comparison_is_jaxs(greater):
    from tensorflowdistributedlearning_tpu.utils import metric_comparison as jcmp
    from tensorflowdistributedlearning_tpu_torch.utils import metric_comparison

    for best, cur in ((0.5, 0.6), (0.6, 0.5), (0.5, 0.5)):
        args = ({"metrics/mean_iou": best}, {"metrics/mean_iou": cur})
        assert metric_comparison(*args, greater_is_better=greater) == jcmp(*args, greater_is_better=greater)
    for bad in (({}, {"metrics/mean_iou": 1.0}), ({"metrics/mean_iou": 1.0}, {"x": 1.0})):
        with pytest.raises(ValueError) as want:
            jcmp(*bad)
        with pytest.raises(ValueError) as got:
            metric_comparison(*bad)
        assert str(got.value) == str(want.value)


def test_get_available_devices_names_as_jax_does():
    from tensorflowdistributedlearning_tpu.utils import get_available_devices as jdevices
    from tensorflowdistributedlearning_tpu_torch.utils import get_available_devices

    # on this CPU host: JAX lists its CPU devices as CPU:i, the port its one
    # host as CPU:0 and no card
    assert get_available_devices() == ["CPU:0"] == jdevices("cpu")[:1]
    assert get_available_devices("cpu") == ["CPU:0"]
    assert get_available_devices("cuda") == get_available_devices("gpu") == []
    with pytest.raises(ValueError):
        get_available_devices("tpu")


def test_step_timer_is_jaxs():
    for mod, out in ((jprofiling, np.zeros(3, np.float32)), (tprofiling, torch.zeros(3))):
        timer = mod.StepTimer(items_per_step=8)
        with pytest.raises(RuntimeError, match="no steps recorded"):
            timer.summary()
        with pytest.raises(RuntimeError, match="without start"):
            timer.stop()
        for _ in range(3):
            timer.start()
            timer.stop(out)
        with timer.step():
            pass
        s = timer.summary()
        assert s["steps"] == 3 and len(timer.times) == 4
        assert s["items_per_sec"] == pytest.approx(8 / s["mean_s"])
    jkeys = set(jprofiling.StepTimer(items_per_step=2).__class__.summary.__code__.co_varnames)
    assert jkeys  # both build on obs.metrics.TimeHistogram.summary
    jt, tt = jprofiling.StepTimer(), tprofiling.StepTimer()
    for t in (jt, tt):
        for dt in (0.5, 0.1, 0.2, 0.3):
            t._hist.record(dt)
    assert tt.summary() == jt.summary()


def test_sync_annotate_trace_and_memory_on_the_cpu(tmp_path):
    tprofiling.sync({"a": torch.ones(2), "b": [torch.zeros(1)]})
    tprofiling.sync({})
    with tprofiling.trace(str(tmp_path / "trace")):
        with tprofiling.annotate("phase"):
            torch.ones(4).sum()
    assert os.path.getsize(tmp_path / "trace" / "trace.json") > 0
    # the CPU reports no device memory, as JAX's CPU devices report none
    assert tprofiling.memory_stats() == {} == {k: v for k, v in jprofiling.memory_stats().items() if v.get("bytes_limit")}
    lines = []
    assert tprofiling.log_memory(lambda *a: lines.append(a)) == {} and lines == []


def test_resnet_depth_blocks_is_jaxs():
    for depth in (50, 101, 152):
        assert tconfigs.resnet_depth_blocks(depth) == jconfigs.resnet_depth_blocks(depth)
    with pytest.raises(ValueError) as want:
        jconfigs.resnet_depth_blocks(34)
    with pytest.raises(ValueError) as got:
        tconfigs.resnet_depth_blocks(34)
    assert str(got.value) == str(want.value)


@pytest.mark.parametrize("decoder", ["native", "png.py"])
@pytest.mark.parametrize("channels", [1, 3])
def test_decode_png_batch_is_jaxs(tmp_path, monkeypatch, decoder, channels):
    from PIL import Image

    from tensorflowdistributedlearning_tpu.native import decode_png_batch as jdecode
    from tensorflowdistributedlearning_tpu_torch.native import decode_png_batch, loader

    rng = np.random.default_rng(channels)
    paths = []
    for i, mode in enumerate(("L", "RGB", "L")):
        shape = (12, 10) if mode == "L" else (12, 10, 3)
        p = tmp_path / f"{i}.png"
        Image.fromarray(rng.integers(0, 256, shape, dtype=np.uint8), mode).save(p)
        paths.append(str(p))
    if decoder == "png.py":
        monkeypatch.setitem(loader._libs, "io", None)
    got = decode_png_batch(paths, 12, 10, channels)
    want = jdecode(paths, 12, 10, channels)
    assert got.dtype == np.float32 and got.shape == (3, 12, 10, channels)
    # data/png.py folds RGB to grey in numpy float32, one rounding apart
    # from the C decoder's sum: within 2^-23 there, bit for bit elsewhere
    atol = 2.0 ** -23 if decoder == "png.py" and channels == 1 else 0.0
    np.testing.assert_allclose(got, want, rtol=0, atol=atol)
    assert decode_png_batch([], 12, 10, channels).shape == (0, 12, 10, channels)


# -- C 4: the run header's mesh ------------------------------------------------------


LAYOUTS = [  # (world, TrainConfig kwargs)
    (8, {}),
    (8, dict(model_parallel=2)),
    (8, dict(model_parallel=4, weight_update_sharding=True)),
    (8, dict(pipeline_parallel=2)),
    (8, dict(expert_parallel=8)),
    (8, dict(sequence_parallel=2)),
    (4, dict(sequence_parallel=4)),
]


@pytest.mark.parametrize("world, kw", LAYOUTS, ids=lambda v: str(v))
def test_header_mesh_is_jaxs(world, kw):
    tcfg = TrainConfig(**kw)
    pp, ep, sp = tcfg.pipeline_parallel, tcfg.expert_parallel, tcfg.sequence_parallel
    lay = tmesh.Layout(world, tmesh.model_axis_degree(tcfg), 0, pipeline=pp > 1, expert=ep > 1, sequence=sp > 1)
    want_mesh = jmesh.make_mesh(world, model_parallel=max(tcfg.model_parallel, pp, ep), sequence_parallel=sp)
    want = {name: int(size) for name, size in zip(want_mesh.axis_names, want_mesh.devices.shape)}
    assert tmesh.axis_sizes(lay) == want
    header = {"mesh": tmesh.axis_sizes(lay), "train_config": dataclasses.asdict(tcfg)}
    layout = jcompare._normalized_layout(header)
    assert layout["data_parallel"] == world // (max(tcfg.model_parallel, pp, ep) * sp)
    assert {k: layout[k] for k in ("model_parallel", "pipeline_parallel", "sequence_parallel", "expert_parallel")} \
        == {k: kw.get(k, 1) for k in ("model_parallel", "pipeline_parallel", "sequence_parallel", "expert_parallel")}


def test_one_process_run_info_has_jaxs_keys():
    cfg = ModelConfig(n_blocks=(1, 1, 1), input_shape=(32, 32), base_depth=8)
    info = run_info("segmentation", 4, 8, cfg, TrainConfig(), n_folds=2)
    assert info["mesh"] == {"batch": 1, "model": 1, "sequence": 1} and "plan" not in info
    assert run_info("classification", 1, 8, cfg, TrainConfig(), {"source": "explicit"})["plan"] == {
        "source": "explicit"}
    assert jcompare._normalized_layout(info)["data_parallel"] == 1
