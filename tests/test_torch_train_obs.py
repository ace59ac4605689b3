"""The trainers' observability (``obs/telemetry.py``, ``obs/health.py``,
``obs/profiler.py``, ``utils/summary.py`` as ``Trainer.train`` and ``fit``
drive them) against the JAX package's, on the CPU.

The same tiny segmenter (and the tiny ViT of ``tests/test_torch_fit.py``)
on the same seeded data, from the same flax weights, with augmentation off
(the packages cannot draw the same augmentations), goes through JAX's and
the port's ``Trainer.train`` (2 folds x 4 steps) and ``fit`` (4 steps):
windows every 2 steps, checkpoints every 2, every span traced,
``TFDL_PEAK_FLOPS`` set in both. Checked:

- both run headers carry JAX's three-key ``mesh`` and the same planner
  ``plan`` (the explicit layout validated on one CPU device);
- the ledgers hold the same event kinds with the same field names per kind
  (``jax_version`` against ``torch_version`` in the fingerprint aside);
- the windows' scalars are each window's last step's (the TensorBoard
  scalars too) and have JAX's keys and lr; each fold's first window (the
  loss of step 2, one Adam update from equal weights: the train-step
  tests' reach) agrees with JAX's: the loss within 1e-3 (relative; 7e-5
  seen), mean IoU within 1e-4, pixel accuracy within two of the batch's
  4096 pixels crossing the threshold (one seen). Later windows drift
  apart, as multi-step trajectories of the two packages do (Lovász sort
  ties, BatchNorm over 4 images: 1 % by step 4);
- ``mfu`` in both, each equal to ``6·params·batch / time per step /
  peak`` (JAX's mean ``step`` span; the port's step and fetch-wait time
  per step), so the two agree within the ratio of their times per step;
- JAX's ``obs.report.build_report`` reads both workdirs with the same
  sections and the same window, eval and checkpoint counts;
- the health monitors give the same verdicts on the same sequences (1e-9),
  and a NaN in the data aborts both trainers after a ``nan_loss`` alert,
  with the final checkpoint on disk.
"""

from __future__ import annotations

import glob
import math
import os

import jax
import numpy as np
import pytest
import torch

import tensorflowdistributedlearning_tpu.models.vit as jvit
from tensorflowdistributedlearning_tpu import config as jconfig
from tensorflowdistributedlearning_tpu import obs as jobs
from tensorflowdistributedlearning_tpu.data import augment as jaug
from tensorflowdistributedlearning_tpu.data import pipeline as jpipe
from tensorflowdistributedlearning_tpu.obs import report as jreport
from tensorflowdistributedlearning_tpu.parallel import planner as jplanner
from tensorflowdistributedlearning_tpu.train import fit as jfit
from tensorflowdistributedlearning_tpu.train import trainer as jtrainer
from tensorflowdistributedlearning_tpu.utils import summary as jsummary
from tensorflowdistributedlearning_tpu_torch.config import ModelConfig, TrainConfig
from tensorflowdistributedlearning_tpu_torch.data import augment as taug
from tensorflowdistributedlearning_tpu_torch.data import pipeline as tpipe
from tensorflowdistributedlearning_tpu_torch.obs import health as thealth
from tensorflowdistributedlearning_tpu_torch.obs.ledger import read_ledger
from tensorflowdistributedlearning_tpu_torch.train import fit as tfit
from tensorflowdistributedlearning_tpu_torch.train import step as tstep
from tensorflowdistributedlearning_tpu_torch.train.state import create_train_state
from tensorflowdistributedlearning_tpu_torch.train.trainer import Trainer
from tensorflowdistributedlearning_tpu_torch.utils import summary as tsummary
from tensorflowdistributedlearning_tpu_torch.utils.convert import from_flax
from tests import test_torch_dp_worker as worker
from tests.conftest import make_salt_dataset

PEAK = 1e12
TINY = dict(n_blocks=(1, 1, 1), input_shape=(32, 32), base_depth=16, width_multiplier=0.125, use_pallas_depthwise=True)
NO_AUG = dict(horizontal_flip=False, vertical_flip=False, rotate_range=0.0, crop_probability=0.0,
              height_shift_range=0.0, width_shift_range=0.0, transpose_probability=0.0)
LOOP = dict(checkpoint_every_steps=2, eval_every_steps=4, save_best=2, train_log_every_steps=2,
            trace_sample_rate=1.0, seed=0)
SEG_LOOP = dict(LOOP, n_folds=2, eval_throttle_secs=0)


def _no_plan(*_a, **_k):
    raise RuntimeError("no plan in this comparison")


def _segmentation_runs(root, data, ids, mp, **extra):
    """JAX's and the port's Trainer.train from JAX's initial weights."""
    jt = jtrainer.Trainer(str(root / "jax"), data, train_config=jconfig.TrainConfig(**SEG_LOOP, n_devices=1, **extra),
                          augment_config=jaug.AugmentConfig(**NO_AUG), **TINY)
    init = jax.device_get(jt._init_state())
    cfg = ModelConfig(**TINY)
    pt = Trainer(str(root / "port"), data, train_config=TrainConfig(**SEG_LOOP, **extra),
                 augment_config=taug.AugmentConfig(**NO_AUG), device="cpu", **TINY)
    mp.setattr(pt, "_init_state", lambda: pt._counted(create_train_state(
        cfg, pt.train_config, "cpu", state_dict=from_flax(init.params, init.batch_stats, cfg))))
    return jt, pt


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    root = tmp_path_factory.mktemp("obs")
    data, _, ids = make_salt_dataset(root / "salt", n_images=16, shape=(32, 32))
    mp = pytest.MonkeyPatch()
    mp.setenv("TFDL_PEAK_FLOPS", str(PEAK))
    mp.setattr(jvit, "_fused_platform_ok", lambda: True)
    steps = []
    real_step = tstep.make_train_step

    def recording_step(*a, **k):
        step = real_step(*a, **k)

        def run(state, batch):
            state, metrics = step(state, batch)
            steps.append(tstep.compute_metrics(metrics))
            return state, metrics

        return run

    try:
        jt, pt = _segmentation_runs(root, data, ids, mp)
        jres = jt.train(ids, batch_size=4, steps=4)
        mp.setattr(tstep, "make_train_step", recording_step)
        tres = pt.train(ids, batch_size=4, steps=4)
        mp.setattr(tstep, "make_train_step", real_step)
        # fit: the tiny ViT on the synthetic stream
        common = dict(worker.VIT_ADAMW, **LOOP, n_devices=1)
        jf = jfit.ClassifierTrainer(str(root / "jfit"), None, jconfig.ModelConfig(**worker.VIT_TINY),
                                    jconfig.TrainConfig(**common))
        finit = jax.device_get(jf._host_template().params)
        fcfg = ModelConfig(**worker.VIT_TINY)
        pf = tfit.ClassifierTrainer(str(root / "tfit"), None, fcfg, TrainConfig(**common), device="cpu")
        mp.setattr(pf, "_init_state", lambda: pf._counted(create_train_state(
            fcfg, pf.train_config, "cpu", state_dict=from_flax(finit, {}, fcfg))))
        jf.fit(batch_size=8, steps=4)
        pf.fit(batch_size=8, steps=4)
    finally:
        mp.undo()
    return dict(root=root, jres=jres, tres=tres, port_steps=steps, params=pt.params,
                dirs={"train": (str(root / "jax"), str(root / "port")), "fit": (str(root / "jfit"), str(root / "tfit"))})


def _kinds(events):
    out = {}
    for e in events:
        out.setdefault(e["event"], set()).update(k for k in e if k not in ("event", "t"))
    return out


@pytest.mark.parametrize("run", ["train", "fit"])
def test_ledgers_have_jaxs_event_kinds_and_fields(runs, run):
    jdir, tdir = runs["dirs"][run]
    jev, tev = jobs.read_ledger(jdir), read_ledger(tdir)
    assert _kinds(tev) == _kinds(jev)
    assert {"run_header", "memory", "compile", "step_window", "cost", "eval", "checkpoint", "trace",
            "run_end"} <= set(_kinds(tev))
    jfp, tfp = jev[0]["fingerprint"], tev[0]["fingerprint"]
    assert set(tfp) - {"torch_version"} == set(jfp) - {"jax_version"}
    assert [e["event"] for e in tev if e["event"] not in ("trace", "compile", "cost", "memory")] == [
        e["event"] for e in jev if e["event"] not in ("trace", "compile", "cost", "memory")]
    assert tev[-1]["event"] == "run_end" and not tev[-1].get("interrupted")


@pytest.mark.parametrize("run", ["train", "fit"])
def test_run_headers_carry_jaxs_mesh_and_plan(runs, run):
    jdir, tdir = runs["dirs"][run]
    jheader, theader = jobs.read_ledger(jdir)[0], read_ledger(tdir)[0]
    assert theader["mesh"] == jheader["mesh"] == {"batch": 1, "model": 1, "sequence": 1}
    assert theader["plan"] == jheader["plan"]
    assert theader["plan"]["source"] == "explicit" and theader["plan"]["feasible"]


def test_window_scalars_are_the_last_steps_and_match_jax(runs):
    """Repair of the window scalars: they are the window's last step's
    metrics (with the lr), not the window's mean, in the ledger and in the
    fold's TensorBoard ``train`` scalars."""
    jdir, tdir = runs["dirs"]["train"]
    jw = [e for e in jobs.read_ledger(jdir) if e["event"] == "step_window"]
    tw = [e for e in read_ledger(tdir) if e["event"] == "step_window"]
    assert [(w["fold"], w["step"], w["steps"]) for w in tw] == [(w["fold"], w["step"], w["steps"]) for w in jw] == [
        (0, 2, 2), (0, 4, 2), (1, 2, 2), (1, 4, 2)]
    steps = runs["port_steps"]
    assert len(steps) == 8
    for i, w in enumerate(tw):
        last = steps[2 * i + 1]
        mean = {k: (steps[2 * i][k] + last[k]) / 2 for k in last}
        for k, v in last.items():
            assert w["scalars"][k] == pytest.approx(v, rel=1e-6, abs=1e-7), k
        assert any(abs(w["scalars"][k] - mean[k]) > 1e-6 for k in last)
    for t, j in zip(tw, jw):
        assert set(t["scalars"]) == set(j["scalars"])
        assert t["scalars"]["lr"] == j["scalars"]["lr"]
        if t["step"] != 2:
            continue  # three updates on: the trajectories drift apart (Lovász ties, BN over 4 images)
        assert t["scalars"]["loss"] == pytest.approx(j["scalars"]["loss"], rel=1e-3)
        assert t["scalars"]["metrics/mean_iou"] == pytest.approx(j["scalars"]["metrics/mean_iou"], abs=1e-4)
        # two of the batch's 4 x 32 x 32 pixels may cross the threshold
        assert t["scalars"]["metrics/mean_acc"] == pytest.approx(j["scalars"]["metrics/mean_acc"], abs=2 / 4096)
    for fold in (0, 1):
        (events,) = glob.glob(os.path.join(tdir, f"fold{fold}", "train", "events.out.tfevents.*"))
        tb = jsummary.read_events(events)
        ledgered = [w for w in tw if w["fold"] == fold]
        assert [s for s, _ in tb] == [w["step"] for w in ledgered]
        for (_, got), w in zip(tb, ledgered):
            assert got == pytest.approx(w["scalars"], rel=1e-6)
        tags = {f"{k}/{i}" for k in ("image", "label", "probability", "prediction") for i in range(3)}
        assert _image_tags(events) == {2: tags, 4: tags}
        (evals,) = glob.glob(os.path.join(tdir, f"fold{fold}", "eval", "events.out.tfevents.*"))
        assert [s for s, _ in jsummary.read_events(evals)] == [4] and _image_tags(evals) == {4: tags}


def _image_tags(path):
    out = {}
    for step, images in tsummary.read_images(path):
        assert all(a.dtype == np.uint8 and a.shape == (32, 32) for a in images.values())
        out.setdefault(step, set()).update(images)
    return out


def _step_s(window, port: bool) -> float:
    """The time per step each package prices a window's step FLOPs with:
    JAX's mean ``step`` span; the port's step and fetch-wait time per step
    (an eager step span holds the launches; the wait for the card lands in
    ``fetch_wait``)."""
    if port:
        return (window["compute_s"] + window["fetch_wait_s"]) / window["steps"]
    return window["step_time_ms"]["mean_ms"] / 1e3


def test_mfu_prices_each_packages_time_per_step(runs):
    """``mfu`` = 6·params·global_batch / time per step / peak in both, each
    over its own time per step (JAX's mean ``step`` span; the port's step
    and fetch-wait time per step), so the two agree within the ratio of
    their times per step."""
    for run in ("train", "fit"):
        jdir, tdir = runs["dirs"][run]
        ledgers = {"jax": jobs.read_ledger(jdir), "port": read_ledger(tdir)}
        windows = {k: [e for e in v if e["event"] == "step_window"] for k, v in ledgers.items()}
        assert len(windows["jax"]) == len(windows["port"]) > 0
        for name, events in ledgers.items():
            assert all("mfu" in w for w in windows[name])
            if run == "train":
                flops = 6 * runs["params"] * events[0]["global_batch"]
                for w in windows[name]:
                    assert w["mfu"] == pytest.approx(flops / _step_s(w, name == "port") / PEAK, rel=2e-3, abs=1e-4)
        for j, t in zip(windows["jax"], windows["port"]):
            ratio = _step_s(t, True) / _step_s(j, False)
            assert t["mfu"] == pytest.approx(j["mfu"] / ratio, rel=2e-3, abs=1e-4)


@pytest.mark.parametrize("run", ["train", "fit"])
def test_jaxs_report_reads_the_ports_workdir(runs, run):
    jdir, tdir = runs["dirs"][run]
    jrep, trep = jreport.build_report(jdir), jreport.build_report(tdir)
    assert set(trep) == set(jrep)
    assert trep["run"]["windows"] == jrep["run"]["windows"] and trep["run"]["completed"]
    assert trep["evals"]["count"] == jrep["evals"]["count"] and trep["checkpoints"] == jrep["checkpoints"]
    assert trep["header"]["fingerprint"]["platform"] == "cpu"


def test_results_agree_with_jax(runs):
    assert len(runs["tres"]) == len(runs["jres"]) == 2
    for t, j in zip(runs["tres"], runs["jres"]):
        assert set(t) == set(j) and all(np.isfinite(v) for v in t.values())


# -- the health monitors -----------------------------------------------------------


class _Sink:
    def __init__(self):
        self.events = []

    def event(self, kind, **fields):
        self.events.append((kind, fields))


def _alerts(sink):
    return [(k, {f: v for f, v in a.items() if f != "alert_id"}) for k, a in sink.events]


def test_health_monitors_give_jaxs_verdicts():
    rng = np.random.default_rng(0)
    losses = list(1.0 + 0.01 * rng.standard_normal(20)) + [3.0, 1.0, float("nan"), 1.0]
    windows = []
    for i, loss in enumerate(losses):
        mean_ms = 10.0 + 0.1 * i if i < 12 else 30.0 if i < 16 else 10.0
        frac = 0.1 if i < 6 else 0.8 if i < 9 else 0.1
        windows.append((i, {"loss": loss}, {"step_time_ms": {"mean_ms": mean_ms}, "data_wait_frac": frac,
                                            "dirty": i == 0}))
    verdicts = []
    for lib in (jobs, thealth):
        mon, sink = lib.HealthMonitor(nan_action="warn"), _Sink()
        for step, scalars, fields in windows:
            mon.observe_window(sink, step, scalars, fields)
        mon.observe_memory(sink, 3, {"peak_bytes": 98, "bytes_limit": 100})
        mon.reset()
        mon.observe_window(sink, 99, {"loss": 10.0}, {"step_time_ms": {"mean_ms": 50.0}})
        verdicts.append(_alerts(sink))
    assert len(verdicts[0]) >= 6
    for (jk, ja), (tk, ta) in zip(*verdicts):
        assert jk == tk and set(ja) == set(ta)
        for f, v in ja.items():
            if isinstance(v, float) and not math.isnan(v):
                assert ta[f] == pytest.approx(v, abs=1e-9), f
            else:
                assert ta[f] == v, f
    assert len(verdicts[0]) == len(verdicts[1])
    for lib in (jobs, thealth):
        with pytest.raises(lib.HealthAbortError, match="non-finite train loss at step 7"):
            lib.HealthMonitor(nan_action="abort").observe_window(_Sink(), 7, {"loss": float("inf")}, {})


def test_a_nan_in_the_data_aborts_both_trainers_after_the_final_checkpoint(tmp_path, monkeypatch):
    data, _, ids = make_salt_dataset(tmp_path / "salt", n_images=16, shape=(32, 32))
    for lib in (jpipe, tpipe):
        real = lib.InMemoryDataset.from_directory.__func__

        def poisoned(cls, *a, _real=real, **k):
            ds = _real(cls, *a, **k)
            ds.images[:, 5, 5, 0] = np.nan
            return ds

        monkeypatch.setattr(lib.InMemoryDataset, "from_directory", classmethod(poisoned))
    monkeypatch.setattr(jplanner, "validate_config", _no_plan)
    jt, pt = _segmentation_runs(tmp_path, data, ids, monkeypatch, nan_guard="abort")
    for trainer, abort, read in ((jt, jobs.HealthAbortError, jobs.read_ledger),
                                 (pt, thealth.HealthAbortError, read_ledger)):
        with pytest.raises(abort, match="non-finite train loss at step 2"):
            trainer.train(ids, batch_size=4, steps=4)
        events = read(trainer.model_dir)
        (alert,) = [e for e in events if e["event"] == "health_alert"]
        assert alert["monitor"] == "nan_loss" and alert["action"] == "abort" and alert["step"] == 2
        assert events[-1]["event"] == "run_end" and events[-1]["interrupted"]
        assert os.listdir(os.path.join(trainer.model_dir, "fold0", "checkpoints"))
    # the abort surfaced at the step-2 checkpoint's flush: JAX leaves that
    # periodic checkpoint; the port also writes the final one (the state
    # at the abort) before it re-raises
    tckpt = [e for e in read_ledger(pt.model_dir) if e["event"] == "checkpoint"]
    assert [(e["step"], e.get("final")) for e in tckpt] == [(2, True)]


def test_a_cadence_capture_spans_its_steps_and_prices_them(tmp_path, monkeypatch):
    """Every ``every_windows``-th window starts a capture on the calling
    thread that stops after ``capture_steps`` steps, is parsed there and
    ledgers a ``train`` roofline priced like JAX's (the steps' FLOPs over
    their time against the peak), and flags its window for the trainers
    (``window_profiled``); a capture asked for while one runs is refused
    and counted, as is one while another session of the process runs, and
    ``run_end`` carries the counters."""
    from tensorflowdistributedlearning_tpu_torch.obs import profiler as tprof
    from tensorflowdistributedlearning_tpu_torch.obs.telemetry import Telemetry

    monkeypatch.setenv("TFDL_PEAK_FLOPS", str(PEAK))
    rows = [tprof.OpTime("void tfdl_depthwise_tiled_kernel<float>", 3.0, 6, 0.75),
            tprof.OpTime("void tfdl_bn_act_rows_kernel<4>", 1.0, 2, 0.25)]
    monkeypatch.setattr(tprof, "kernel_breakdown", lambda events: rows)
    tel = Telemetry(str(tmp_path), device="cpu")
    tel.set_step_flops(2e9)
    prof = tprof.ContinuousProfiler(tel, every_windows=2, capture_steps=2, phase="train", device="cpu")
    tel.set_profiler(prof)
    prof.on_window(step=5, windows=1)
    assert not prof.capturing
    prof.on_window(step=10, windows=2)
    assert prof.capturing and prof.on_window(step=10, windows=2) is None and prof.refused == 1
    assert not tel.window_profiled()
    for _ in range(2):
        with tel.span("step"):
            pass
    # stopped, parsed and ledgered on the train thread at its last step; the
    # window that holds it is flagged once
    assert not prof.capturing and prof.captures == 1 and prof.steps_captured == 2
    assert tel.window_profiled() and not tel.window_profiled()
    prof.close()
    assert prof.captures == 1 and prof.errors == 0
    assert tprof.exclusive_session()
    try:
        prof.on_window(step=20, windows=4)
        assert prof.refused == 2 and not prof.capturing
    finally:
        tprof.release_session()
    tel.close()
    events = read_ledger(str(tmp_path))
    assert events[-1]["event"] == "run_end"
    assert events[-1]["profiler"] == {"captures": 1, "errors": 0, "refused": 2, "rate_limited": 0}
    (capture,) = [e for e in events if e["event"] == "profile_capture"]
    (roof,) = [e for e in events if e["event"] == "op_roofline"]
    assert capture["reason"] == "cadence" and capture["steps"] == 2 and capture["step"] == 10
    assert roof["phase"] == "train" and roof["buckets"] == {"conv": 3.0, "fusion(elementwise/bn)": 1.0}
    assert roof["analytic_flops_per_step"] == 2e9
    assert 0 < roof["mfu"] == pytest.approx(roof["achieved_flops_per_sec_per_chip"] / PEAK, abs=1e-4)
