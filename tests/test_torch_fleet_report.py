"""The port's fleet merge (``obs/fleet.py``: ``straggler_section``,
``fleet_section``, ``fleet_summary``, ``render_fleet_section``) against the
JAX package's, on the CPU, on multi-process workdirs:

- written by the port: two gloo ranks of ``Trainer.train``
  (``tests/test_torch_dp_worker.py``, mode ``ledger``), each writing its own
  ledger (``telemetry.jsonl``, ``telemetry-1.jsonl``);
- written by the JAX package's ``RunLedger``: two and three processes with
  a slow host and barrier waits, and a serving replica's ledger beside a
  trainer's, as JAX's ``tests/test_fleet.py`` writes them; a torn line.

Held, exactly: each function's dict as JSON at the default and a tight
skew threshold, the rendered lines, the report's fleet section and text,
and ``telemetry-report`` / ``telemetry-top --once`` stdout and exit code.
The port-written fleet section names both ranks.
"""

from __future__ import annotations

import json
import os
import time

import pytest

from tensorflowdistributedlearning_tpu import cli as jcli
from tensorflowdistributedlearning_tpu.obs import fleet as jfleet
from tensorflowdistributedlearning_tpu.obs import report as jreport
from tensorflowdistributedlearning_tpu.obs.ledger import RunLedger as JRunLedger
from tensorflowdistributedlearning_tpu.obs.ledger import per_process_filename
from tensorflowdistributedlearning_tpu_torch import __main__ as tcli
from tensorflowdistributedlearning_tpu_torch import obs as tobs
from tensorflowdistributedlearning_tpu_torch.obs import fleet as tfleet
from tensorflowdistributedlearning_tpu_torch.obs import report as treport
from tests import test_torch_dp_worker as worker
from tests.conftest import make_salt_dataset

NOW = 1_760_000_000.0


def _process_ledger(workdir, idx, mean_ms, *, process_count=2, steps=(2, 4, 6), barrier_s=0.0):
    """One process's ledger as JAX's ``tests/test_fleet.py`` writes it."""
    led = JRunLedger(str(workdir), filename=per_process_filename(idx))
    led.event("run_header", schema_version=1, process_index=idx, process_count=process_count, task="classification",
              fingerprint={"platform": "cpu", "device_kind": "cpu", "n_devices": 4, "process_index": idx,
                           "process_count": process_count, "jax_version": "0.0"})
    for s in steps:
        led.event("step_window", step=s, steps=2, data_wait_s=0.01, compute_s=mean_ms * 2 / 1000, fetch_wait_s=0.0,
                  barrier_wait_s=barrier_s, data_wait_frac=0.0, dirty=False,
                  step_time_ms={"count": 2.0, "mean_ms": mean_ms, "p50_ms": mean_ms, "p90_ms": mean_ms,
                                "p99_ms": mean_ms, "max_ms": mean_ms})
    led.event("run_end", steps=steps[-1])
    led.close()


@pytest.fixture(scope="module")
def workdirs(tmp_path_factory):
    root = tmp_path_factory.mktemp("fleet")
    make_salt_dataset(root / "gloo", n_images=16, shape=(32, 32))
    started = worker.start("ledger", 2, str(root / "gloo"))
    dirs = {}
    d = root / "slow_host"
    _process_ledger(d, 0, 100.0, barrier_s=0.4)
    _process_ledger(d, 1, 200.0, barrier_s=0.01)
    dirs["slow_host"] = str(d)
    d = root / "three"
    for i, ms in enumerate((100.0, 104.0, 118.0)):
        _process_ledger(d, i, ms, process_count=3, barrier_s=0.05 * i)
    dirs["three"] = str(d)
    d = root / "serving"
    _process_ledger(d, 0, 100.0)
    led = JRunLedger(str(d), filename=per_process_filename(1))
    led.event("run_header", schema_version=1, process_index=1, kind="serve", replica=1)
    for n in (3, 5):
        led.event("serve_window", replica=1, requests=n, batches=n, examples=n, errors=0, queue_wait_ms={},
                  compute_ms={"count": n, "mean_ms": 2.0, "p50_ms": 2.0, "p90_ms": 2.5, "p99_ms": 3.0,
                              "max_ms": 3.0})
    led.close()
    with open(os.path.join(d, per_process_filename(1)), "a") as f:
        f.write('{"event": "serve_window", "replica": 1, "requ\n')
    dirs["serving"] = str(d)
    results = worker.finish(started, timeout=240.0)
    assert results[0]["results"] == results[1]["results"]
    dirs["gloo"] = str(root / "gloo" / "model")
    return dirs


NAMES = ("gloo", "slow_host", "three", "serving")


def _dump(obj) -> str:
    return json.dumps(obj, sort_keys=True)


def test_the_gloo_run_left_one_ledger_per_rank(workdirs):
    ledgers = tfleet.discover_ledgers(workdirs["gloo"])
    assert [led.process_index for led in ledgers] == [0, 1]
    assert [os.path.basename(led.path) for led in ledgers] == ["telemetry.jsonl", "telemetry-1.jsonl"]
    section = tfleet.fleet_section(workdirs["gloo"])
    assert [row["process_index"] for row in section["per_process"]] == [0, 1]
    # as in JAX's Trainer, only rank 0 logs step windows, so there is no
    # second host to compare a window with
    assert section["per_process"][0]["windows"] == 4 and section["per_process"][1]["windows"] == 0
    assert "straggler" not in section


@pytest.mark.parametrize("threshold", [jfleet.DEFAULT_SKEW_THRESHOLD, 1.01])
@pytest.mark.parametrize("name", NAMES)
def test_fleet_section_and_summary_equal_jax(workdirs, name, threshold):
    assert tfleet.DEFAULT_SKEW_THRESHOLD == jfleet.DEFAULT_SKEW_THRESHOLD
    assert tobs.STRAGGLER_ALERT_EVENT == tfleet.STRAGGLER_ALERT_EVENT == jfleet.STRAGGLER_ALERT_EVENT
    wd = workdirs[name]
    want = jfleet.fleet_section(wd, skew_threshold=threshold)
    got = tfleet.fleet_section(wd, skew_threshold=threshold)
    assert want is not None and _dump(got) == _dump(want)
    assert tfleet.render_fleet_section(got) == jfleet.render_fleet_section(want)
    assert _dump(tfleet.fleet_summary(wd, skew_threshold=threshold)) == _dump(
        jfleet.fleet_summary(wd, skew_threshold=threshold))
    want_st = jfleet.straggler_section(jfleet.discover_ledgers(wd), skew_threshold=threshold, max_alerts=2)
    got_st = tfleet.straggler_section(tfleet.discover_ledgers(wd), skew_threshold=threshold, max_alerts=2)
    assert _dump(got_st) == _dump(want_st)


def test_summary_of_a_workdir_without_ledgers_equals_jax(tmp_path):
    assert tfleet.fleet_summary(str(tmp_path)) == jfleet.fleet_summary(str(tmp_path)) == {
        "processes": 0, "per_process": [], "ledger_parse_errors": 0}
    _process_ledger(tmp_path, 0, 100.0, process_count=1)
    assert _dump(tfleet.fleet_summary(str(tmp_path))) == _dump(jfleet.fleet_summary(str(tmp_path)))
    assert tfleet.fleet_section(str(tmp_path)) is None and jfleet.fleet_section(str(tmp_path)) is None


@pytest.mark.parametrize("name", NAMES)
def test_report_fleet_and_text_equal_jax(workdirs, name):
    want = jreport.build_report(workdirs[name], straggler_threshold=1.1)
    got = treport.build_report(workdirs[name], straggler_threshold=1.1)
    want.pop("trace")
    got.pop("trace")
    assert _dump(got) == _dump(want) and "fleet" in got
    assert treport.render_report(got) == jreport.render_report(want)


@pytest.mark.parametrize("name", NAMES)
def test_commands_equal_jax(workdirs, name, capsys, monkeypatch):
    monkeypatch.setattr(time, "time", lambda: NOW)
    for argv in (["telemetry-report", workdirs[name], "--straggler-threshold", "1.05"],
                 ["telemetry-report", workdirs[name], "--json"],
                 ["telemetry-top", workdirs[name], "--once"]):
        outs = []
        for main in (jcli.main, tcli.main):
            rc = main(argv)
            outs.append((rc, capsys.readouterr().out))
        assert outs[1] == outs[0] and outs[0][0] == 0, argv
