"""The port's host loop (``train/async_loop.py``) against the JAX package's,
on the CPU, where nothing is in flight: the orderings are what is compared.

- The same ``PendingWindow`` sequences, with the same metric states, go
  through JAX's and the port's ``HostOverlap`` at dispatch-ahead 0 and 2:
  the same windows are emitted at the same calls, in the same order, with
  the same scalars (float32 division of the same totals: exactly equal),
  and the spans are entered in the same order.
- ``DispatchBudget`` waits on the oldest step once the budget is passed,
  under ``fetch_wait`` (none with ``span=None``), in both; the port's
  ``drain`` waits once for every step in flight.
- One eval pass of ``Trainer._evaluate`` over several batches counts
  exactly one ``EVAL_FETCH_COUNTER`` transfer, as JAX's does.
- A tiny ``Trainer.train`` at dispatch-ahead 0 and 2 ends bit for bit the
  same, and so do its ledgers' window scalars.
"""

from __future__ import annotations

import contextlib

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tensorflowdistributedlearning_tpu.ops import metrics as jmetrics
from tensorflowdistributedlearning_tpu.train import async_loop as jloop
from tensorflowdistributedlearning_tpu_torch.config import TrainConfig
from tensorflowdistributedlearning_tpu_torch.obs.ledger import read_ledger
from tensorflowdistributedlearning_tpu_torch.obs.telemetry import Telemetry
from tensorflowdistributedlearning_tpu_torch.ops import metrics as tmetrics
from tensorflowdistributedlearning_tpu_torch.train import async_loop as tloop
from tensorflowdistributedlearning_tpu_torch.train.checkpoint import CheckpointManager
from tensorflowdistributedlearning_tpu_torch.train.trainer import Trainer
from tests.conftest import make_salt_dataset
from tests.test_torch_dp_worker import one_torch_thread  # noqa: F401 (autouse)


TINY = dict(n_blocks=(1, 1, 1), input_shape=(32, 32), base_depth=16, width_multiplier=0.125, use_pallas_depthwise=True)


class _Recorder:
    """A telemetry stand-in: records span entries and window drains."""

    def __init__(self, log):
        self.log = log

    @contextlib.contextmanager
    def span(self, name):
        self.log.append(("span", name))
        yield

    def drain_window_samples(self):
        self.log.append(("drain",))
        return {}


def _metrics(lib, rng):
    """One step's metric states with random totals and counts."""
    out = {}
    for name in ("loss", "metrics/mean_iou", "metrics/mean_acc"):
        total, count = np.float32(rng.normal() * 4), np.float32(rng.integers(1, 9))
        if lib is jloop:
            out[name] = jmetrics.Mean(total=jnp.asarray(total), count=jnp.asarray(count))
        else:
            out[name] = tmetrics.Mean(torch.tensor(total), torch.tensor(count))
    return out


def _drive(lib, budget, script):
    """Run ``script`` (a list of ("track", seed) | ("window", step, seed) |
    ("flush",)) through one package's HostOverlap; returns the call log."""
    log = []
    overlap = lib.HostOverlap(_Recorder(log), dispatch_ahead=budget,
                              emit=lambda rec, scalars: log.append(("emit", rec.step, scalars)))
    for op in script:
        if op[0] == "track":
            overlap.track(_metrics(lib, np.random.default_rng(op[1])))
        elif op[0] == "window":
            rate = None if op[1] == 2 else 100.0 + op[1]
            overlap.window(lib.PendingWindow(step=op[1], metrics=_metrics(lib, np.random.default_rng(op[2])),
                                             steps=2, lr=1e-3 / op[1], images_per_sec=rate, dirty=op[1] == 2))
        else:
            overlap.flush()
        log.append(("after", op[0]))
    return log


SCRIPT = [("track", 1), ("track", 2), ("window", 2, 2), ("track", 3), ("track", 4), ("window", 4, 4),
          ("flush",), ("track", 5), ("track", 6), ("window", 6, 6), ("track", 7), ("flush",), ("flush",)]


@pytest.mark.parametrize("budget", [0, 2])
def test_host_overlap_emits_jaxs_windows_in_jaxs_order(budget):
    jlog, tlog = _drive(jloop, budget, SCRIPT), _drive(tloop, budget, SCRIPT)
    assert [e[:2] for e in tlog] == [e[:2] for e in jlog]
    emits = [(e, f) for e, f in zip(tlog, jlog) if e[0] == "emit"]
    assert [e[1] for e, _ in emits] == [2, 4, 6]
    for (_, step, got), (_, _, want) in emits:
        assert got == want, step  # the same float32 divisions
    if budget:
        # each window is written one boundary late (or at a flush), behind a fetch_wait
        assert tlog.index(("emit", 2, emits[0][0][2])) > tlog.index(("span", "fetch_wait"))
        assert ("span", "step") not in tlog
    else:
        assert tlog[:3] == [("after", "track"), ("after", "track"), ("span", "step")]


def test_dispatch_budget_blocks_past_the_budget_as_jax_does():
    for budget, span in ((2, "fetch_wait"), (1, None)):
        logs = []
        for lib in (jloop, tloop):
            log = []
            tracker = lib.DispatchBudget(_Recorder(log), budget, span=span)
            for i in range(5):
                tracker.track(_metrics(lib, np.random.default_rng(i)))
                log.append(("tracked", i))
            logs.append(log)
        assert logs[0] == logs[1]
        assert logs[0].count(("span", "fetch_wait")) == (3 if span else 0)
    assert tloop.eval_budget(None, 0).budget == jloop.eval_budget(None, 0).budget == 1
    assert tloop.eval_budget(None, 3).budget == jloop.eval_budget(None, 3).budget == 3
    with pytest.raises(TypeError, match="not a Mean"):
        tloop.merge_metrics_device(None, {"x": torch.zeros(())})
    with pytest.raises(ValueError, match="no eval batches"):
        tloop.fetch_metrics(None)


def test_drain_waits_for_the_steps_in_flight_once_as_fetch_wait():
    """The port's ``drain`` (before the trainer's image summaries, which
    the JAX package has no counterpart of): one ``fetch_wait`` wait for
    every tracked step, after which nothing is in flight; nothing to wait
    for with nothing tracked, or in sync mode."""
    log = []
    overlap = tloop.HostOverlap(_Recorder(log), dispatch_ahead=2, emit=lambda rec, scalars: None)
    for i in range(2):
        overlap.track(_metrics(tloop, np.random.default_rng(i)))
    assert log == []
    overlap.drain()
    assert log == [("span", "fetch_wait")]
    overlap.drain()
    for i in range(2):
        overlap.track(_metrics(tloop, np.random.default_rng(i)))
    assert log == [("span", "fetch_wait")]  # the budget starts empty again
    sync_log = []
    sync = tloop.HostOverlap(_Recorder(sync_log), dispatch_ahead=0, emit=lambda rec, scalars: None)
    sync.track(_metrics(tloop, np.random.default_rng(0)))
    sync.drain()
    assert sync_log == []


@pytest.fixture(scope="module")
def salt(tmp_path_factory):
    data, _, ids = make_salt_dataset(tmp_path_factory.mktemp("salt"), n_images=16, shape=(32, 32))
    return data, ids


def test_one_eval_pass_is_one_host_transfer(salt, tmp_path):
    from tensorflowdistributedlearning_tpu_torch.data import pipeline as pipeline_lib

    data, ids = salt
    trainer = Trainer(str(tmp_path), data, train_config=TrainConfig(n_folds=2, seed=0), device="cpu", **TINY)
    tel = Telemetry(str(tmp_path), device="cpu")
    trainer._telemetry = tel
    state = trainer._init_state()
    ds = pipeline_lib.InMemoryDataset.from_directory(data, ids=ids)
    reads = []
    real = tloop.step_lib.compute_metrics
    tloop.step_lib.compute_metrics = lambda acc: reads.append(1) or real(acc)
    try:
        for passes in (1, 2):
            trainer._evaluate(state, ds, 3, fold=0)  # 6 batches of 3
            assert tel.registry.counter(tloop.EVAL_FETCH_COUNTER).value == passes
        assert len(reads) == 2
    finally:
        tloop.step_lib.compute_metrics = real
        tel.close()
    events = [e for e in read_ledger(str(tmp_path)) if e["event"] == "eval"]
    assert len(events) == 2 and events[0]["fold"] == 0
    assert jloop.EVAL_FETCH_COUNTER == tloop.EVAL_FETCH_COUNTER


def test_dispatch_ahead_0_and_2_train_bit_for_bit_the_same(salt, tmp_path):
    data, ids = salt
    finals, scalars = [], []
    for ahead in (0, 2):
        model_dir = str(tmp_path / f"ahead{ahead}")
        tcfg = TrainConfig(n_folds=2, seed=0, checkpoint_every_steps=3, eval_every_steps=3,
                           train_log_every_steps=2, dispatch_ahead_steps=ahead)
        Trainer(model_dir, data, train_config=tcfg, device="cpu", **TINY).train(ids, batch_size=4, steps=5)
        state = torch.load(f"{model_dir}/fold1/checkpoints/5/state.pt", weights_only=False)
        finals.append(state["model"])
        scalars.append([(e["step"], e["scalars"]) for e in read_ledger(model_dir) if e["event"] == "step_window"])
    assert set(finals[0]) == set(finals[1])
    assert all(torch.equal(finals[0][k], finals[1][k]) for k in finals[0])
    assert scalars[0] == scalars[1] and [s for s, _ in scalars[0]] == [2, 4, 2, 4]
    assert CheckpointManager(str(tmp_path / "ahead2" / "fold0")).latest_step() == 5
