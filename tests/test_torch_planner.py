"""The port's parallelism planner (``parallel/planner.py``) and ``plan``
command against the JAX package's, on the CPU.

- The engine: on the same hand-built ``Topology`` and the same
  ``ModelProfile`` numbers (JAX's ``ShapeDtypeStruct`` leaves, the port's
  ``planner.Leaf``), ``plan()`` gives JAX's chosen layout, every
  candidate's verdict, reject reason and detail, predicted bytes, headroom
  and score, JAX's ``render_plan_table`` text and JSON plan, or JAX's
  ``PlanError`` text; the scenarios are the counterparts of JAX's
  ``tests/test_planner.py`` cases, plus TPU device kinds, measured costs
  and a measured margin.
- ``profile_model``: parameter, BatchNorm-statistic and optimizer bytes,
  parameter count and layer count equal JAX's exactly for every preset
  the port has; the activation term is within 1e-3 of JAX's (the module
  boundaries differ: 1 - 9.3e-6 for the MoE ViT, 1 - 6.8e-5 for
  Xception-41, every other preset exact).
- The placed state: the prediction equals the port's own state's memory
  event (``train.trainer.state_bytes``) replicated, at (1, 2) slices and
  under ZeRO-1 at (2, 1) and (2, 2), once torch's per-parameter float32
  Adam steps are swapped for optax's int32 counts.
- The wiring: ``auto`` keeps pinned flags; both trainers refuse an
  unresolved ``'auto'`` with JAX's text; ``fit_preset`` and the ``train``
  command plan ``auto`` and write the header's ``plan``; an indivisible
  explicit layout fails at parse time with its named constraint; for every
  preset the layout ``auto`` chooses on 8 devices is one the port trains.
- The ``plan`` command: JAX's table and ``--json`` text for the same
  arguments, and its exit codes (0 feasible, 1 infeasible, 2 usage).
"""

from __future__ import annotations

import dataclasses
import json
import os

import jax
import numpy as np
import pytest

from tensorflowdistributedlearning_tpu import cli as jcli
from tensorflowdistributedlearning_tpu import config as jconfig
from tensorflowdistributedlearning_tpu import configs as jconfigs
from tensorflowdistributedlearning_tpu.parallel import planner as jplanner
from tensorflowdistributedlearning_tpu.train import fit as jfit
from tensorflowdistributedlearning_tpu.train import trainer as jtrainer
from tensorflowdistributedlearning_tpu_torch import configs as tconfigs
from tensorflowdistributedlearning_tpu_torch.__main__ import main as cli_main
from tensorflowdistributedlearning_tpu_torch.config import ModelConfig, TrainConfig, require_supported_training
from tensorflowdistributedlearning_tpu_torch.parallel import planner, tensor
from tensorflowdistributedlearning_tpu_torch.train import fit as tfit
from tensorflowdistributedlearning_tpu_torch.train.state import create_train_state
from tensorflowdistributedlearning_tpu_torch.train.trainer import Trainer, state_bytes
from tests import test_torch_dp_worker as worker
from tests.test_torch_dp_worker import one_torch_thread  # noqa: F401 (autouse)

CIFARISH = dict(num_classes=10, input_shape=(32, 32), input_channels=3, n_blocks=(1, 1, 1), base_depth=8,
                width_multiplier=0.0625, output_stride=None)
VIT = dict(backbone="vit", num_classes=10, input_shape=(32, 32), input_channels=3, patch_size=8, embed_dim=64,
           vit_layers=4, num_heads=2, output_stride=None)
TOPO8 = dict(n_devices=8, local_device_count=8)
POD = dict(n_devices=32, local_device_count=8, process_count=4)
PINNED_DP = {"model_parallel": 1, "pipeline_parallel": 1, "sequence_parallel": 1, "expert_parallel": 1,
             "weight_update_sharding": False}


def _profiles(params, opt, act=0, n_layers=1):
    """The same profile numbers for both packages: ``params`` and ``opt``
    map names to shapes (float32)."""
    count = sum(int(np.prod(s)) for s in params.values())
    jp = jplanner.ModelProfile(
        params={k: jax.ShapeDtypeStruct(tuple(s), np.float32) for k, s in params.items()}, batch_stats={},
        opt_state={k: jax.ShapeDtypeStruct(tuple(s), np.float32) for k, s in opt.items()},
        activation_bytes_per_example=act, param_count=count, n_layers=n_layers)
    tp = planner.ModelProfile(
        params={k: planner.Leaf(tuple(s)) for k, s in params.items()}, batch_stats={},
        opt_state={k: planner.Leaf(tuple(s)) for k, s in opt.items()},
        activation_bytes_per_example=act, param_count=count, n_layers=n_layers)
    return jp, tp


SMALL = ({"w": (8, 4)}, {"mu": (8, 4)})
WIDE = ({"w": (8, 16)}, {"mu": (8, 16)})
BIG = ({"w": (4096, 4096)}, {"mu": (4096, 4096)})

# (model, train config kwargs, global batch, topology, profile (params,
# opt, act, n_layers), plan kwargs): the JAX tests' cases and more
SCENARIOS = {
    "indivisible_model_axis": (CIFARISH, {}, 64, TOPO8, SMALL, dict(pinned={"model_parallel": 3})),
    "batch_indivisible": (CIFARISH, {}, 12, TOPO8, SMALL, dict(pinned=PINNED_DP)),
    "spatial_stride": (CIFARISH, {}, 64, TOPO8, SMALL, {}),
    "grad_accum_indivisible": (CIFARISH, dict(grad_accum_steps=3), 64, TOPO8, SMALL, dict(pinned=PINNED_DP)),
    "pipeline_stage_backbones": (VIT, {}, 64, TOPO8, SMALL, {}),
    "conflict_tp_pp": (VIT, {}, 64, TOPO8, SMALL, dict(pinned={"model_parallel": 2, "pipeline_parallel": 2})),
    "conflict_pp_zero": (VIT, {}, 64, TOPO8, SMALL,
                         dict(pinned={"pipeline_parallel": 2, "weight_update_sharding": True})),
    "composition_grad_accum": (CIFARISH, dict(grad_accum_steps=2), 16, TOPO8, BIG + (1024,), {}),
    "composition_mixup": (VIT, dict(augmentation="mixup"), 64, TOPO8, SMALL, {}),
    "budget_picks_zero1": (CIFARISH, {}, 64, TOPO8, ({"w": (8, 3)}, {"mu": (8, 3)}),
                           dict(hbm_bytes_per_device=8 * 3 * 4 + 24 - 1)),
    "explicit_over_budget": (CIFARISH, {}, 64, TOPO8, SMALL, dict(pinned=PINNED_DP, hbm_bytes_per_device=16)),
    "scoring_tie": (CIFARISH, {}, 64, TOPO8, ({}, {}, 0, 1), {}),
    "large_params_small_batch": (CIFARISH, {}, 8, TOPO8, BIG + (1024, 1), {}),
    "pod_spans_processes": (CIFARISH, {}, 64, POD, WIDE, dict(pinned={"model_parallel": 16})),
    "pod_tp8": (CIFARISH, {}, 64, POD, WIDE, dict(pinned={"model_parallel": 8})),
    "pod_process_batch": (CIFARISH, {}, 30, POD, WIDE, {}),
    "auto_pins_zero": (CIFARISH, {}, 64, TOPO8, WIDE + (64, 2), dict(pinned={"weight_update_sharding": True})),
    "tpu_v5e": (CIFARISH, {}, 8, dict(TOPO8, device_kind="TPU v5 lite", hbm_bytes_per_device=16 << 30),
                BIG + (1 << 20, 3), {}),
    "tpu_v4_pod": (VIT, {}, 256, dict(POD, device_kind="TPU v4"), BIG + (1 << 16, 4), {}),
    "moe_experts": (dict(VIT, moe_experts=8), {}, 64, TOPO8, WIDE + (4096, 6), {}),
    "measured_costs": (CIFARISH, {}, 64, TOPO8, BIG + (1024, 2),
                       dict(measured=(2.5e13, 3.0e10, 4), measured_margin_bytes=12345)),
    "measured_flops_only": (VIT, {}, 64, TOPO8, WIDE + (512, 2), dict(measured=(1e13, None, 1))),
}


def _run(pkg, scenario):
    model, tkw, batch, topo, prof, kw = SCENARIOS[scenario]
    kw = dict(kw)
    jp, tp = _profiles(*prof)
    if pkg is jplanner:
        mcfg, tcfg, profile = jconfig.ModelConfig(**model), jconfig.TrainConfig(**tkw), jp
    else:
        mcfg, tcfg, profile = ModelConfig(**model), TrainConfig(**tkw), tp
    measured = kw.pop("measured", None)
    if measured:
        kw["measured_costs"] = pkg.MeasuredCosts(flops_per_sec_per_chip=measured[0],
                                                 collective_bytes_per_sec=measured[1], captures=measured[2],
                                                 source="/some/workdir")
    return pkg.plan(mcfg, tcfg, batch, topology=pkg.Topology(**topo), profile=profile, **kw)


@pytest.mark.parametrize("scenario", sorted(SCENARIOS))
def test_plan_is_jaxs_on_the_same_topology_and_profile(scenario):
    try:
        want = _run(jplanner, scenario)
    except jplanner.PlanError as e:
        with pytest.raises(planner.PlanError) as got:
            _run(planner, scenario)
        assert str(got.value) == str(e)
        return
    got = _run(planner, scenario)
    assert got.layout.to_json() == want.layout.to_json()
    assert json.dumps(got.to_json(), sort_keys=True) == json.dumps(want.to_json(), sort_keys=True)
    assert [c.to_json() for c in got.candidates] == [c.to_json() for c in want.candidates]
    assert planner.render_plan_table(got) == jplanner.render_plan_table(want)
    assert got.header() == want.header() and got.warnings == want.warnings


def test_the_scenarios_cover_the_named_constraints_and_the_choices():
    """The scenarios above reach every reject reason the JAX tests name and
    the choices they pin (checked on the port's plans)."""
    reasons = set()
    for name in SCENARIOS:
        try:
            p = _run(planner, name)
        except planner.PlanError as e:
            reasons.update(r for r in (planner.REJECT_MODEL_AXIS, planner.REJECT_BATCH, planner.REJECT_GRAD_ACCUM,
                                       planner.REJECT_CONFLICT, planner.REJECT_SPANS_PROCESSES,
                                       planner.REJECT_PROCESS_BATCH) if r in str(e))
            continue
        reasons.update(c.reject_reason for c in p.candidates if c.reject_reason)
    assert {planner.REJECT_MODEL_AXIS, planner.REJECT_BATCH, planner.REJECT_GRAD_ACCUM, planner.REJECT_PIPELINE,
            planner.REJECT_SPATIAL, planner.REJECT_CONFLICT, planner.REJECT_BUDGET, planner.REJECT_SPANS_PROCESSES,
            planner.REJECT_PROCESS_BATCH} <= reasons
    assert _run(planner, "budget_picks_zero1").layout == planner.Layout(data_parallel=8, weight_update_sharding=True)
    assert _run(planner, "scoring_tie").layout == planner.Layout(data_parallel=8)
    assert _run(planner, "large_params_small_batch").layout.model_parallel > 1
    assert _run(planner, "pod_tp8").layout == planner.Layout(data_parallel=4, model_parallel=8)
    assert _run(planner, "composition_grad_accum").layout.model_parallel == 1
    explicit = _run(planner, "explicit_over_budget")
    assert explicit.source == "explicit" and not explicit.chosen.feasible and "budget" in explicit.warnings[0]
    assert _run(planner, "measured_costs").cost_provenance == "measured"


def test_reject_reason_strings_and_constants_are_jaxs():
    for name in dir(jplanner):
        if name.startswith("REJECT_") or name in ("DEFAULT_PEAK_FLOPS", "ICI_BYTES_PER_SEC", "ACTIVATION_BWD_FACTOR",
                                                   "COLLECTIVE_LATENCY_S", "COLLECTIVE_LATENCY_CPU_S",
                                                   "SPATIAL_HALO_FRAC", "PEAK_FLOPS_BY_KIND", "_SOFT_REJECTS"):
            assert getattr(planner, name) == getattr(jplanner, name), name
    assert planner.__all__ == jplanner.__all__


def test_a_cuda_card_prices_at_its_peak_and_pays_the_interconnect_latency(monkeypatch):
    monkeypatch.delenv("TFDL_PEAK_FLOPS", raising=False)
    card = planner.Topology(n_devices=2, local_device_count=2, device_kind="NVIDIA H100 80GB HBM3")
    assert card.peak_flops() == 989e12
    assert card.collective_latency_s() == planner.COLLECTIVE_LATENCY_S
    cpu = planner.Topology(n_devices=2, local_device_count=2)
    assert cpu.peak_flops() == planner.DEFAULT_PEAK_FLOPS
    assert cpu.collective_latency_s() == planner.COLLECTIVE_LATENCY_CPU_S
    monkeypatch.setenv("TFDL_PEAK_FLOPS", "1e15")
    assert card.peak_flops() == 1e15 and cpu.peak_flops() == planner.DEFAULT_PEAK_FLOPS


def test_detect_topology_of_one_cpu_process():
    topo = planner.detect_topology(device="cpu")
    assert topo == planner.Topology(n_devices=1, local_device_count=1, process_count=1, hbm_bytes_per_device=None,
                                    device_kind="cpu")
    with pytest.raises(planner.PlanError, match="requested 8 devices but only 1 are visible"):
        planner.detect_topology(8, device="cpu")


# -- profile_model ---------------------------------------------------------------


@pytest.mark.parametrize("name", sorted(tconfigs.PRESETS))
def test_profile_bytes_are_jaxs_for_every_preset(name):
    jpre, tpre = jconfigs.get_preset(name), tconfigs.get_preset(name)
    want = jplanner.profile_model(jpre.model, jpre.train)
    got = planner.profile_model(tpre.model, tpre.train)
    assert got.params_bytes == want.params_bytes
    assert got.opt_state_bytes == want.opt_state_bytes
    assert planner._tree_bytes(got.batch_stats, lambda s: ()) == jplanner._tree_bytes(want.batch_stats, lambda s: ())
    assert got.param_count == want.param_count and got.n_layers == want.n_layers
    assert abs(got.activation_bytes_per_example / want.activation_bytes_per_example - 1.0) <= 1e-3
    # every candidate's params and optimizer bytes under the real spec rules
    topo = dict(n_devices=8, local_device_count=8)
    jp = jplanner.plan(jpre.model, dataclasses.replace(jpre.train, n_devices=None), jpre.global_batch,
                       topology=jplanner.Topology(**topo), profile=want)
    tp = planner.plan(tpre.model, dataclasses.replace(tpre.train, n_devices=None), tpre.global_batch,
                      topology=planner.Topology(**topo), profile=got)
    for jc, tc in zip(jp.candidates, tp.candidates):
        assert tc.layout.to_json() == jc.layout.to_json()
        for key in ("params_bytes_per_chip", "opt_state_bytes_per_chip", "batch_stats_bytes_per_chip"):
            assert (tc.bytes or {}).get(key) == (jc.bytes or {}).get(key), (tc.layout.describe(), key)


@pytest.mark.parametrize("optimizer, ema", [("adam", 0.9), ("adam", 0.0), ("sgd", 0.9), ("sgd", 0.0), ("lars", 0.0)])
def test_optimizer_state_is_optaxs_for_each_chain(optimizer, ema):
    kw = dict(optimizer=optimizer, ema_decay=ema, weight_decay=1e-4, grad_clip_norm=1.0)
    mcfg = dict(CIFARISH)
    want = jplanner.profile_model(jconfig.ModelConfig(**mcfg), jconfig.TrainConfig(**kw))
    got = planner.profile_model(ModelConfig(**mcfg), TrainConfig(**kw))
    assert got.opt_state_bytes == want.opt_state_bytes


def _torch_counter_bytes(state):
    """Bytes of the per-parameter scalar steps torch's optimizer keeps (Adam)."""
    from tensorflowdistributedlearning_tpu_torch.train.step import _slot_shapes

    return sum(4 for g in state.optimizer.param_groups for p in g["params"]
               for shape, _ in _slot_shapes(state.optimizer, g, p).values() if tuple(shape) == ())


@pytest.mark.parametrize("dp, tp, zero1", [(1, 1, False), (1, 2, False), (2, 1, True), (2, 2, True)],
                         ids=["replicated", "tp2", "zero2", "tp2_zero2"])
@pytest.mark.parametrize("model", ["cls", "vit"])
def test_prediction_is_the_placed_states_memory_event(model, dp, tp, zero1):
    """Replicated on one process, and each rank's slices of (dp, tp) grids
    with ZeRO-1 over the data positions (each rank's state cut offline for
    its data and model index)."""
    from tensorflowdistributedlearning_tpu_torch.parallel import zero

    mkw = worker.TP_CLS if model == "cls" else worker.VTP_VIT
    tkw = dict(optimizer="adam", lr=1e-3, ema_decay=0.9)
    cfg = ModelConfig(**mkw)
    n = dp * tp
    p = planner.plan(cfg, TrainConfig(**tkw), 8, topology=planner.Topology(n_devices=n, local_device_count=n),
                     pinned=dict(PINNED_DP, model_parallel=tp, weight_update_sharding=zero1))
    predicted = p.chosen.bytes
    counts = 2 * 4  # optax's Adam and schedule counts, int32
    for r in range(n):
        state = create_train_state(cfg, TrainConfig(**tkw), "cpu")
        if tp > 1:
            tensor.shard_state_tensor_parallel(state, TrainConfig(**tkw, model_parallel=tp), tp, r % tp)
        if zero1:
            zero.shard_state(state, TrainConfig(**tkw, weight_update_sharding=True), dp, r // tp)
        event = state_bytes(state, zero1)
        assert event["params_bytes_per_device"] == predicted["params_bytes_per_chip"]
        assert event["opt_state_bytes_per_device"] - _torch_counter_bytes(state) + counts == \
            predicted["opt_state_bytes_per_chip"]


# -- the wiring ----------------------------------------------------------------------


def test_auto_pins_explicit_flags():
    jp, tp = _profiles(*WIDE, act=64, n_layers=2)
    p = planner.plan(ModelConfig(**CIFARISH), TrainConfig(), 64, topology=planner.Topology(**TOPO8), profile=tp,
                     pinned={"weight_update_sharding": True})
    assert p.layout.weight_update_sharding
    cfg = dataclasses.replace(TrainConfig(parallelism="auto"), **p.overrides())
    assert cfg.weight_update_sharding
    header = json.loads(json.dumps(p.header()))
    assert header["source"] == "auto" and "total_bytes_per_chip" in header["predicted"]
    json.loads(json.dumps(p.to_json()))


def test_plan_for_config_dispatch():
    _, tp = _profiles(*WIDE)
    topo = planner.Topology(**TOPO8)
    p = planner.plan_for_config(ModelConfig(**CIFARISH), TrainConfig(parallelism="auto", weight_update_sharding=True),
                                64, topology=topo, profile=tp)
    assert p.source == "auto" and p.layout.weight_update_sharding
    p = planner.plan_for_config(ModelConfig(**CIFARISH), TrainConfig(), 64, topology=topo, profile=tp)
    assert p.source == "explicit" and p.layout == planner.Layout(data_parallel=8)
    with pytest.raises(planner.PlanError, match=planner.REJECT_MODEL_AXIS):
        planner.validate_config(ModelConfig(**CIFARISH), TrainConfig(model_parallel=5), 64, topology=topo)


def test_trainers_refuse_an_unresolved_auto_with_jaxs_text(tmp_path):
    with pytest.raises(ValueError) as want:
        jfit.ClassifierTrainer(str(tmp_path / "j"), None, jconfig.ModelConfig(**CIFARISH),
                               jconfig.TrainConfig(parallelism="auto"))
    with pytest.raises(ValueError) as got:
        tfit.ClassifierTrainer(str(tmp_path / "t"), None, ModelConfig(**CIFARISH), TrainConfig(parallelism="auto"),
                               device="cpu")
    assert str(got.value) == str(want.value)
    with pytest.raises(ValueError) as want:
        jtrainer.Trainer(str(tmp_path / "j2"), str(tmp_path), train_config=jconfig.TrainConfig(parallelism="auto"))
    with pytest.raises(ValueError) as got:
        Trainer(str(tmp_path / "t2"), str(tmp_path), train_config=TrainConfig(parallelism="auto"), device="cpu")
    assert str(got.value) == str(want.value)


@pytest.mark.parametrize("budget", [None, 0.9])
def test_auto_chooses_a_layout_the_port_trains_for_every_preset(budget):
    topo = planner.Topology(**TOPO8)
    chosen = 0
    for name, pre in tconfigs.PRESETS.items():
        tcfg = dataclasses.replace(pre.train, parallelism="auto", model_parallel=1, pipeline_parallel=1,
                                   sequence_parallel=1, expert_parallel=1, weight_update_sharding=False)
        hbm = None
        if budget:
            full = planner.plan(pre.model, tcfg, pre.global_batch, topology=topo).chosen.bytes
            hbm = int(full["total_bytes_per_chip"] * budget)
        try:
            p = planner.plan(pre.model, tcfg, pre.global_batch, topology=topo, hbm_bytes_per_device=hbm)
        except planner.PlanError:
            continue
        require_supported_training(pre.model, dataclasses.replace(tcfg, **p.overrides()), topo.n_devices)
        chosen += 1
    assert chosen >= 4


def test_fit_preset_plans_auto_and_an_explicit_layout(tmp_path, monkeypatch):
    preset = worker.vtp_preset()
    monkeypatch.setitem(tconfigs.PRESETS, "vit_tiny_plan", preset)
    res = tfit.fit_preset("vit_tiny_plan", str(tmp_path / "auto"), steps=1, device="cpu", parallelism="auto")
    assert res.steps == 1
    header = worker_ledger(tmp_path / "auto")[0]
    assert header["plan"]["source"] == "auto" and header["plan"]["layout"]["data_parallel"] == 1
    assert header["train_config"]["parallelism"] == "auto"
    assert header["mesh"] == {"batch": 1, "model": 1, "sequence": 1}
    # the explicit path goes through the validator: its plan rides the header
    tfit.fit_preset("vit_tiny_plan", str(tmp_path / "explicit"), steps=1, device="cpu")
    assert worker_ledger(tmp_path / "explicit")[0]["plan"]["source"] == "explicit"
    # a layout the topology cannot hold fails before the trainer exists
    with pytest.raises(ValueError, match="1 devices not divisible by model_parallel"):
        tfit.fit_preset("vit_tiny_plan", str(tmp_path / "bad"), steps=1, device="cpu", parallelism="auto",
                        model_parallel=2)
    with pytest.raises(planner.PlanError, match=planner.REJECT_GRAD_ACCUM):
        tfit.fit_preset("vit_tiny_plan", str(tmp_path / "bad2"), steps=1, device="cpu", grad_accum_steps=3)
    assert not os.path.exists(tmp_path / "bad2" / "telemetry.jsonl")


def worker_ledger(d):
    with open(os.path.join(d, "telemetry.jsonl")) as f:
        return [json.loads(line) for line in f if line.strip()]


def test_train_command_plans_auto(tmp_path):
    from tests.conftest import make_salt_dataset

    data, _, _ = make_salt_dataset(tmp_path, n_images=8, n_test=0, shape=(32, 32))
    m = str(tmp_path / "m")
    assert cli_main(["train", "--data-dir", data, "--model-dir", m, "--batch-size", "4", "--steps", "1",
                     "--n-fold", "2", "--input-shape", "32", "32", "--n-blocks", "1", "1", "1", "--base-depth", "8",
                     "--checkpoint-every", "1", "--eval-throttle-secs", "0", "--parallelism", "auto",
                     "--hbm-budget-gb", "4", "--device", "cpu"]) == 0
    header = worker_ledger(m)[0]
    assert header["plan"]["source"] == "auto" and header["plan"]["hbm_bytes_per_device"] == 4 << 30
    assert header["train_config"]["hbm_budget_gb"] == 4.0


# -- the plan command ----------------------------------------------------------------


def _both(capsys, args):
    jrc = jcli.main(["plan", *args, "--n-devices", "1"])
    jout = capsys.readouterr()
    trc = cli_main(["plan", *args, "--device", "cpu"])
    tout = capsys.readouterr()
    return (jrc, jout), (trc, tout)


@pytest.mark.parametrize("args", [
    ["--preset", "cifar10_smoke", "--batch-size", "64"],
    ["--preset", "vit_s16_imagenet", "--json"],
    ["--preset", "tgs_salt", "--hbm-gb", "0.5"],
    ["--preset", "resnet50_imagenet", "--grad-accum", "2", "--json"],
    ["--backbone", "resnet", "--input-shape", "32", "32", "--n-blocks", "1", "1", "1", "--base-depth", "16",
     "--num-classes", "10", "--weight-update-sharding"],
], ids=["table", "json", "budget", "accum", "preset-less"])
def test_plan_command_prints_jaxs_plan(capsys, args):
    (jrc, jout), (trc, tout) = _both(capsys, args)
    assert trc == jrc
    assert tout.out == jout.out
    if "--json" in args:
        assert json.loads(tout.out)["candidates"]


def test_plan_command_exit_codes(capsys, tmp_path):
    (jrc, jout), (trc, tout) = _both(capsys, ["--preset", "cifar10_smoke", "--model-parallel", "3"])
    assert trc == jrc == 1
    assert planner.REJECT_MODEL_AXIS in tout.err and tout.err == jout.err
    (jrc, _), (trc, tout) = _both(capsys, ["--preset", "no_such_preset"])
    assert trc == jrc == 2 and "Unknown preset" in tout.err
    (jrc, _), (trc, tout) = _both(capsys, ["--preset", "cifar10_smoke", "--measured-costs-from", str(tmp_path)])
    assert trc == jrc == 2 and "no op_roofline events" in tout.err


# -- measured margin and costs from a workdir's ledgers ----------------------------


def _write_ledgers(d):
    os.makedirs(d, exist_ok=True)
    rows = {
        "telemetry.jsonl": [
            {"event": "run_header", "t": 0.0},
            {"event": "memory_watermark", "phase": "train", "peak_bytes": 900, "step": 2,
             "predicted_bytes_per_device": 800, "measured_minus_predicted_bytes": 100},
            {"event": "op_roofline", "achieved_flops_per_sec_per_chip": 3.0e13,
             "achieved_collective_bytes_per_sec": 2.0e10},
            {"event": "op_roofline", "achieved_flops_per_sec_per_chip": 2.0e13},
        ],
        "telemetry-1.jsonl": [
            {"event": "run_header", "t": 0.0, "process_index": 1},
            {"event": "memory_watermark", "phase": "train", "peak_bytes": 1300, "step": 2,
             "predicted_bytes_per_device": 800, "measured_minus_predicted_bytes": 500},
            {"event": "op_roofline", "achieved_flops_per_sec_per_chip": 2.5e13,
             "achieved_collective_bytes_per_sec": 1.0e10},
        ],
    }
    for name, events in rows.items():
        with open(os.path.join(d, name), "w") as f:
            f.write("".join(json.dumps(e) + "\n" for e in events))


def test_measured_margin_and_costs_are_jaxs(tmp_path, capsys):
    d = str(tmp_path / "w")
    _write_ledgers(d)
    assert planner.measured_margin_from_workdir(d) == jplanner.measured_margin_from_workdir(d) == 500
    want = jplanner.measured_costs_from_workdir(d)
    got = planner.measured_costs_from_workdir(d)
    assert got.to_json() == want.to_json()
    assert planner.measured_costs_from_workdir(str(tmp_path / "none")) is None
    from tensorflowdistributedlearning_tpu.obs import fleet as jfleet
    from tensorflowdistributedlearning_tpu_torch.obs import fleet as tfleet

    jl, tl = jfleet.discover_ledgers(d), tfleet.discover_ledgers(d)
    assert [(x.process_index, os.path.basename(x.path), x.events, x.parse_errors, x.header) for x in tl] == [
        (x.process_index, os.path.basename(x.path), x.events, x.parse_errors, x.header) for x in jl]
    (jrc, jout), (trc, tout) = _both(capsys, ["--preset", "cifar10_smoke", "--measured-costs-from", d,
                                              "--measured-margin-from", d])
    assert trc == jrc == 0 and tout.out == jout.out and "cost provenance: measured" in tout.out
