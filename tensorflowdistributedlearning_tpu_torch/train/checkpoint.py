"""Checkpointing: periodic saves, auto-resume, best-k export (counterpart of
the JAX package's ``train/checkpoint.py``, which keeps Orbax managers).

Layout under a fold directory:

    checkpoints/{step}/state.pt       periodic: model, optimizer, step, EMA
    checkpoints/data_state-{step}.json  the data service's resume state
    export/best/{step}/state.pt       best-k: the eval view of the model
    export/best/{step}/metrics.json   the eval metrics it was ranked on

State is ``torch.save`` of state_dicts (no ``safetensors``: the GPU host has
none). A step directory is written under a temporary name and renamed into
place, so a killed save leaves no half-written step. ``restore_latest``
skips (and deletes) an unreadable step and falls back to the previous one;
a checkpoint whose structure does not match the current state raises
:class:`CheckpointStructureError` instead, since the configuration changed.
Best exports are ranked on ``metrics/mean_iou``, higher is better (the
reference compared the wrong way round, SURVEY §2.4.4).

In a data-parallel run rank 0 alone writes and deletes; the other ranks
take its decision (whether a step was saved, whether an export was kept)
through a broadcast that returns only after rank 0 has written, so no rank
reads a half-written step. Every rank restores; the trainer then
``replicate``s rank 0's state. Under ZeRO-1 or tensor parallelism every
rank joins the gather of the whole state that rank 0 writes (a periodic
step, or the eval view of a best export), after the same broadcast
decision; a restore slices the whole state into the rank's layout, so the
files do not depend on ``(dp, tp)``.
"""

from __future__ import annotations

import contextlib
import glob
import json
import logging
import os
import shutil
from typing import Dict, List, Optional

import torch

from tensorflowdistributedlearning_tpu_torch.parallel import multihost
from tensorflowdistributedlearning_tpu_torch.train.state import TrainState

logger = logging.getLogger(__name__)

STATE_NAME = "state.pt"
METRICS_NAME = "metrics.json"


class CheckpointStructureError(RuntimeError):
    """The checkpoint does not match the current training state — a
    configuration change, not corruption."""


def _steps(root: str) -> List[int]:
    if not os.path.isdir(root):
        return []
    return sorted(int(d) for d in os.listdir(root) if d.isdigit() and os.path.isdir(os.path.join(root, d)))


def _write_step(root: str, step: int, payload: Dict, metrics: Optional[Dict[str, float]] = None) -> None:
    final = os.path.join(root, str(step))
    tmp = os.path.join(root, f".tmp-{step}-{os.getpid()}")
    shutil.rmtree(tmp, ignore_errors=True)
    os.makedirs(tmp)
    torch.save(payload, os.path.join(tmp, STATE_NAME))
    if metrics is not None:
        with open(os.path.join(tmp, METRICS_NAME), "w") as f:
            json.dump(metrics, f)
    os.replace(tmp, final)


def _load(path: str) -> Dict:
    return torch.load(path, map_location="cpu", weights_only=True)


class CheckpointManager:
    """Periodic + best-k checkpointing for one fold directory."""

    def __init__(
        self,
        directory: str,
        *,
        save_every_steps: int = 500,
        max_to_keep: int = 5,
        save_best: int = 5,
        best_metric: str = "metrics/mean_iou",
        greater_is_better: bool = True,
    ):
        self.directory = os.path.abspath(directory)
        self.save_every_steps = save_every_steps
        self.max_to_keep = max_to_keep
        self.save_best = save_best
        self.best_metric = best_metric
        self.greater_is_better = greater_is_better
        self._ckpt_dir = os.path.join(self.directory, "checkpoints")
        self._best_dir = os.path.join(self.directory, "export", "best")
        self.writer = multihost.is_main()
        if self.writer:
            os.makedirs(self._ckpt_dir, exist_ok=True)
            os.makedirs(self._best_dir, exist_ok=True)

    # -- periodic ---------------------------------------------------------

    def save(self, state: TrainState) -> bool:
        """Save the state at its step now; re-offering a saved step is a
        no-op. Keeps the newest ``max_to_keep`` steps."""
        if state.sharded:
            # the whole state is a gather every rank joins: decide first
            if not multihost.broadcast_object(self.writer and state.step not in self.all_steps()):
                return False
            payload = state.state_dict()
            if self.writer:
                self._write_periodic(state.step, payload)
            return multihost.broadcast_object(True)
        saved = False
        if self.writer and state.step not in self.all_steps():
            self._write_periodic(state.step, state.state_dict())
            saved = True
        return multihost.broadcast_object(saved)

    def _write_periodic(self, step: int, payload: Dict) -> None:
        _write_step(self._ckpt_dir, step, payload)
        for old in self.all_steps()[: -self.max_to_keep]:
            shutil.rmtree(os.path.join(self._ckpt_dir, str(old)), ignore_errors=True)

    def is_save_step(self, step: int) -> bool:
        """Whether ``step`` is on the periodic save cadence."""
        return step % self.save_every_steps == 0

    def maybe_save(self, state: TrainState, step: Optional[int] = None) -> bool:
        """Save iff ``step`` (default ``state.step``) is on the cadence."""
        step = state.step if step is None else step
        return self.save(state) if self.is_save_step(step) else False

    def all_steps(self) -> List[int]:
        return _steps(self._ckpt_dir)

    def latest_step(self) -> Optional[int]:
        steps = self.all_steps()
        return steps[-1] if steps else None

    def restore_latest(self, state: TrainState) -> TrainState:
        """Auto-resume: load the newest readable checkpoint into ``state``
        (in place; returned), or leave it as it is when there is none. An
        unreadable step is deleted with a warning and the previous one
        tried."""
        for step in reversed(self.all_steps()):
            path = os.path.join(self._ckpt_dir, str(step), STATE_NAME)
            try:
                payload = _load(path)
            except Exception as e:  # noqa: BLE001 — a truncated or corrupt step file
                logger.warning(
                    "checkpoint at step %d under %s is unreadable (%s: %s) — falling back to the previous step",
                    step, self.directory, type(e).__name__, str(e)[:200],
                )
                if self.writer:
                    shutil.rmtree(os.path.join(self._ckpt_dir, str(step)), ignore_errors=True)
                continue
            try:
                state.load_state_dict(payload)
            except (KeyError, RuntimeError, ValueError) as e:
                raise CheckpointStructureError(
                    f"checkpoint at step {step} under {self.directory} does not match the current training "
                    "state — most often the optimizer or model configuration changed since it was written. "
                    f"Use a fresh model_dir or the original configuration. ({str(e)[:300]})"
                ) from e
            return state
        return state

    # -- the data service's resume state (sidecar) ---------------------------

    def _data_state_path(self, step: int) -> str:
        return os.path.join(self._ckpt_dir, f"data_state-{step}.json")

    def save_data_state(self, step: int, state: Dict) -> None:
        """Write the input stream's resume state (a ``DataServiceState`` JSON
        dict, ``data/service.py``) beside the step's checkpoint, atomically;
        rank 0 alone writes. Sidecars of steps no longer kept (and not
        ``step``) are removed."""
        if not self.writer:
            return
        path = self._data_state_path(step)
        tmp = f"{path}.{os.getpid()}.tmp"
        with open(tmp, "w", encoding="utf-8") as f:
            json.dump({"step": int(step), **state}, f)
        os.replace(tmp, path)
        kept = set(self.all_steps())
        for old in glob.glob(os.path.join(self._ckpt_dir, "data_state-*.json")):
            try:
                old_step = int(os.path.basename(old)[len("data_state-") : -len(".json")])
            except ValueError:
                continue
            if old_step != step and old_step not in kept:
                try:
                    os.remove(old)
                except OSError:
                    pass

    def restore_data_state(self, step: int) -> Optional[Dict]:
        """The resume state saved with ``step``, or None when there is none
        (a run without the service). A sidecar that does not parse, or parses
        to something else, warns and gives None: the index-keyed stream's
        state follows from the step alone."""
        path = self._data_state_path(step)
        try:
            with open(path, encoding="utf-8") as f:
                state = json.load(f)
            if not isinstance(state, dict) or not {"seed", "batch_index"} <= state.keys():
                raise ValueError(f"not a data_state sidecar: {state!r:.120}")
            return state
        except FileNotFoundError:
            return None
        except (OSError, ValueError) as e:
            logger.warning("data-state sidecar for step %d is unreadable (%s) — deriving the stream state from "
                           "the step instead", step, e)
            return None

    # -- best export ------------------------------------------------------

    def best_steps(self) -> Dict[int, float]:
        """``{step: ranking metric}`` of the kept best exports."""
        out = {}
        for step in _steps(self._best_dir):
            try:
                with open(os.path.join(self._best_dir, str(step), METRICS_NAME)) as f:
                    out[step] = float(json.load(f)[self.best_metric])
            except (OSError, ValueError, KeyError):
                continue
        return out

    def export_best(self, state: TrainState, metrics: Dict[str, float]) -> bool:
        """Offer the eval view of ``state`` (EMA parameters when tracked) with
        its eval ``metrics``; it stays only if it ranks in the top
        ``save_best`` on the best metric. Returns whether it was kept."""
        if state.sharded:
            # the eval view's whole state dict is a gather every rank joins:
            # decide first
            if not multihost.broadcast_object(self.writer and state.step not in self.best_steps()):
                return multihost.broadcast_object(False)
            with state.eval_params() as model:
                # copies: the live parameters return to the model on exit
                model_sd = {k: v.detach().clone() for k, v in state.model_state_dict(model).items()}
            kept = self._export_best(state, metrics, model_sd) if self.writer else False
            return multihost.broadcast_object(kept)
        return multihost.broadcast_object(self._export_best(state, metrics) if self.writer else False)

    def _export_best(self, state: TrainState, metrics: Dict[str, float], model_sd=None) -> bool:
        """Write the eval view (``model_sd``, its whole state dict, when the
        caller gathered it) as a best export if it ranks."""
        kept = self.best_steps()
        if state.step in kept:
            return False
        with contextlib.nullcontext() if model_sd is not None else state.eval_params() as model:
            payload = {"step": state.step, "model": model_sd if model_sd is not None else model.state_dict()}
            _write_step(self._best_dir, state.step, payload, {k: float(v) for k, v in metrics.items()})
        kept[state.step] = float(metrics[self.best_metric])
        sign = 1.0 if self.greater_is_better else -1.0
        ranked = sorted(kept, key=lambda s: (sign * kept[s], s), reverse=True)
        for step in ranked[self.save_best :]:
            shutil.rmtree(os.path.join(self._best_dir, str(step)), ignore_errors=True)
        return state.step in ranked[: self.save_best]

    def best_step(self) -> Optional[int]:
        kept = self.best_steps()
        if not kept:
            return None
        sign = 1.0 if self.greater_is_better else -1.0
        return max(kept, key=lambda s: (sign * kept[s], -s))

    def restore_best(self, state: TrainState) -> TrainState:
        """Load the best export's model (and step) into ``state``; falls back
        to the latest periodic checkpoint, then leaves ``state`` as it is.
        A best export holds the eval view, so a tracked EMA is set to its
        parameters: ``state.eval_params()`` is then the export itself, and
        after a fallback it is the checkpoint's EMA."""
        step = self.best_step()
        if step is None:
            return self.restore_latest(state)
        payload = _load(os.path.join(self._best_dir, str(step), STATE_NAME))
        try:
            state.model.load_state_dict(payload["model"], strict=True)
        except RuntimeError as e:
            raise CheckpointStructureError(
                f"best export at step {step} under {self.directory} does not match the model: {str(e)[:300]}"
            ) from e
        if state.ema is not None:
            with torch.no_grad():
                for name, p in state.model.named_parameters():
                    state.ema[name].copy_(p)
        state.step = int(payload["step"])
        return state

    def restore_best_or_raise(self, state: TrainState, hint: str = "") -> TrainState:
        """:meth:`restore_best` that refuses to hand back a fresh init."""
        if self.best_step() is None and self.latest_step() is None:
            raise RuntimeError(f"no trained checkpoint under {self.directory}" + (f" — {hint}" if hint else ""))
        return self.restore_best(state)
