"""Single-run classification training (counterpart of the JAX package's
``train/fit.py``: ``ClassifierTrainer`` :84, ``_train_stream`` :322,
``fit`` :438, ``_evaluate`` :842, ``serving_fn`` :1016,
``export_serving`` :1072, ``fit_preset`` :1126).

One run, no folds, top-1 as the model-selection metric: resume from the
latest checkpoint → the train loop (the index-keyed synthetic stream,
prefetched to the device; on-device augmentation keyed by (seed, step);
training-mode forward, softmax cross entropy, backward, one optimizer
update) → a checkpoint every ``checkpoint_every_steps`` → an eval every
``eval_every_steps`` (default: the checkpoint cadence) with best-k export
of the eval view (the EMA when tracked) on ``metrics/top1`` → the final
checkpoint, and a final eval when the last step was not an eval step.

The models are the classifiers the port builds: the ViT and the ResNet
classifier (every layout, unit type and stem; float32 or bf16 compute;
``remat``), under Adam, SGD or LARS with ``grad_accum_steps`` >= 1.
Data-parallel under a process group as ``train/trainer.py`` is: every rank
trains a replica on its device, draws ``batch_size / world`` rows a step
from its own stream (seed ``seed + rank``, as the JAX package's process
index), runs the data-parallel step (one all-reduce of the flat gradient,
the BN running statistics' mean where the model has BatchNorm, the metric
sums), and rank 0 alone writes.
Serving restores refuse to run under more than one rank.

Input: only the synthetic stream is ported. ``data_dir=None``, or a
directory without record shards and without an ImageFolder split, trains on
``data/synthetic.py``'s index-keyed batches (batch i a pure function of
(seed, i), so a resumed run sees what the uninterrupted run saw) and
evaluates one pass of 4 synthetic batches (seed + 1). A directory that
holds data the port cannot read yet raises, naming the queue item: record
shards (``*.tfrecord``, queue A 4), an ImageFolder ``train/`` or ``val/``
split (queue A 11). Left out of the loop, each a ROADMAP item: telemetry,
health monitors and the profiler (A 13), fault injection and preemption
(A 14), dispatch-ahead (``async_loop``, A 11), and tensor, pipeline, expert
and sequence parallelism (A 12, refused by ``require_supported_training``).
"""

from __future__ import annotations

import dataclasses
import glob
import logging
import os
from typing import Dict, Iterator, Optional

import numpy as np
import torch

from tensorflowdistributedlearning_tpu_torch.config import (
    ModelConfig,
    TrainConfig,
    require_supported_training,
    validate_training_data_format,
)
from tensorflowdistributedlearning_tpu_torch.data import augment as augment_lib
from tensorflowdistributedlearning_tpu_torch.data import pipeline as pipeline_lib
from tensorflowdistributedlearning_tpu_torch.data import synthetic as synthetic_lib
from tensorflowdistributedlearning_tpu_torch.parallel import collectives, multihost
from tensorflowdistributedlearning_tpu_torch.train import step as step_lib
from tensorflowdistributedlearning_tpu_torch.train.checkpoint import CheckpointManager
from tensorflowdistributedlearning_tpu_torch.train.state import (
    TrainState,
    create_train_state,
    replicate,
    template_train_state,
)
from tensorflowdistributedlearning_tpu_torch.train.trainer import augment_seed
from tensorflowdistributedlearning_tpu_torch.utils.devices import DeviceLike, resolve_device

logger = logging.getLogger(__name__)

# the synthetic eval pass: batches of the per-process size, all rows valid
EVAL_SYNTHETIC_BATCHES = 4


@dataclasses.dataclass
class FitResult:
    final_metrics: Dict[str, float]
    n_params: int
    steps: int
    # the artifact directory when fit_preset exported one after training
    serving_artifact: Optional[str] = None


class ClassifierTrainer:
    """Classification trainer: one run of ``model_config`` (with
    ``num_classes``) under ``train_config`` in ``model_dir``. ``device`` is
    CUDA (the rank's GPU under a process group) unless the caller asks for
    the CPU."""

    def __init__(
        self,
        model_dir: str,
        data_dir: Optional[str],
        model_config: ModelConfig,
        train_config: Optional[TrainConfig] = None,
        device: DeviceLike = None,
    ):
        if model_config.num_classes is None:
            raise ValueError(
                "fit() trains classification models; model_config.num_classes is None "
                "(use train.trainer.Trainer for the segmentation task)"
            )
        self.model_dir = model_dir
        self.data_dir = data_dir
        self.model_config = model_config
        self.train_config = train_config or TrainConfig()
        require_supported_training(model_config, self.train_config)
        multihost.initialize(backend=multihost.backend_for(device))
        multihost.require_world_size(self.train_config.n_devices)
        self.data_parallel = collectives.is_initialized()
        self.device = resolve_device(device)
        self.task = step_lib.ClassificationTask(label_smoothing=self.train_config.label_smoothing)
        self._n_params: Optional[int] = None
        if multihost.is_main():
            os.makedirs(model_dir, exist_ok=True)

    @property
    def params(self) -> int:
        if self._n_params is None:
            raise AttributeError("fit() must build the model first")
        return self._n_params

    def _log(self, msg: str, *args) -> None:
        if multihost.is_main():
            logger.info(msg, *args)

    # -- data -------------------------------------------------------------

    def _require_synthetic(self) -> None:
        """Refuse a ``data_dir`` that holds data the port cannot read yet:
        the synthetic stream must never stand in for data that exists."""
        d = self.data_dir
        if d is None:
            return
        shards = glob.glob(os.path.join(d, "train-*.tfrecord")) + glob.glob(os.path.join(d, "val-*.tfrecord"))
        if shards:
            raise NotImplementedError(
                f"{d} holds record shards ({os.path.basename(sorted(shards)[0])}, ...): fit() from records is not "
                "ported yet (data/records.py, queue A 4 of ROADMAP.md)"
            )
        for split in ("train", "val"):
            if os.path.isdir(os.path.join(d, split)):
                raise NotImplementedError(
                    f"{d}/{split} is an ImageFolder split: fit() from an ImageFolder is not ported yet "
                    "(data/imagefolder.py, queue A 11 of ROADMAP.md)"
                )

    def _synthetic(self, batch_size: int, seed: int, steps: int, **kw) -> Iterator[Dict[str, np.ndarray]]:
        """The synthetic classification stream of this model's shapes, once
        :meth:`_require_synthetic` has passed."""
        self._require_synthetic()
        cfg = self.model_config
        return synthetic_lib.synthetic_batches(
            "classification", batch_size, seed=seed, steps=steps, input_shape=cfg.input_shape,
            channels=cfg.input_channels, num_classes=cfg.num_classes, **kw,
        )

    def _train_stream(self, batch_size: int, steps: int, start_step: int = 0) -> Iterator[Dict[str, np.ndarray]]:
        """This rank's train batches from ``start_step`` on: index-keyed
        synthetic batches (seed ``seed + rank``)."""
        local_bs = multihost.per_process_batch_size(batch_size)
        return self._synthetic(local_bs, self.train_config.seed + multihost.process_index(), steps,
                               start_index=start_step, index_keyed=True)

    def _prepare_train(self, step: int, batch: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
        """On-device augmentation under ``TrainConfig.augmentation``, drawn
        from a generator keyed by (seed, step) and this rank."""
        policy = self.train_config.augmentation
        if policy == "none":
            return batch
        seed = augment_seed(self.train_config.seed, 0, step, multihost.process_index())
        gen = torch.Generator(device=self.device).manual_seed(seed)
        return augment_lib.prepare_classification_batch(gen, batch, policy)

    # -- training ---------------------------------------------------------

    def _init_state(self) -> TrainState:
        generator = torch.Generator().manual_seed(self.train_config.seed)
        return self._counted(create_train_state(self.model_config, self.train_config, self.device,
                                                generator=generator))

    def _template_state(self) -> TrainState:
        """The restore template: allocated, not drawn."""
        return self._counted(template_train_state(self.model_config, self.train_config, self.device))

    def _counted(self, state: TrainState) -> TrainState:
        self._n_params = sum(p.numel() for p in state.model.parameters())
        return state

    def _checkpointer(self) -> CheckpointManager:
        """The one manager of this run directory: fit() and the serving
        restore agree on the cadence and the best metric."""
        tcfg = self.train_config
        return CheckpointManager(
            self.model_dir, save_every_steps=tcfg.checkpoint_every_steps, save_best=tcfg.save_best,
            best_metric="metrics/top1",
        )

    def fit(self, batch_size: int = 64, steps: int = 10_000, eval_every_steps: Optional[int] = None) -> FitResult:
        """Train to ``steps`` (global ``batch_size``) with periodic
        checkpoints, evals and best export; resumes from the latest
        checkpoint, and a run already at ``steps`` only evaluates.
        ``eval_every_steps`` defaults to ``TrainConfig.eval_every_steps``,
        then to ``checkpoint_every_steps``."""
        tcfg = self.train_config
        validate_training_data_format(tcfg)
        self._require_synthetic()
        multihost.per_process_batch_size(batch_size)  # fail fast, clear message
        eval_every = eval_every_steps or tcfg.eval_every_steps or tcfg.checkpoint_every_steps
        ckpt = self._checkpointer()
        state = replicate(ckpt.restore_latest(self._init_state()))
        start_step = state.step
        if start_step >= steps:
            self._log("already trained to step %d", start_step)
            return FitResult(self._evaluate(state, batch_size), self.params, start_step)
        if start_step > 0:
            self._log("resumes at step %d", start_step)
        train_step = step_lib.make_train_step(
            self.task, data_parallel=self.data_parallel, weight_decay=self.model_config.weight_decay,
            accum=tcfg.grad_accum_steps,
        )
        batches = pipeline_lib.device_prefetch(
            self._train_stream(batch_size, steps - start_step, start_step),
            lambda b: pipeline_lib.to_device(b, self.device), depth=tcfg.prefetch_depth,
        )
        lr_sched = step_lib.make_host_lr_schedule(tcfg)
        step_no = start_step
        last_eval_step = -1
        final_metrics: Dict[str, float] = {}
        window = None
        for raw in batches:
            state, metrics = train_step(state, self._prepare_train(step_no, raw))
            window = step_lib.merge_metrics(window, metrics)
            step_no += 1
            if step_no % tcfg.train_log_every_steps == 0:
                self._log("step %d: %s lr %.6g", step_no, step_lib.compute_metrics(window), lr_sched(step_no))
                window = None
            ckpt.maybe_save(state, step=step_no)
            if step_no % eval_every == 0:
                last_eval_step = step_no
                final_metrics = self._evaluate(state, batch_size)
                ckpt.export_best(state, final_metrics)
        ckpt.save(state)
        if last_eval_step != step_no:
            final_metrics = self._evaluate(state, batch_size)
            ckpt.export_best(state, final_metrics)
        return FitResult(final_metrics, self.params, step_no)

    def _evaluate(self, state: TrainState, batch_size: int) -> Dict[str, float]:
        """One eval pass of the eval view (EMA parameters when tracked): 4
        synthetic batches of the per-process size from ``seed + 1``, every
        row valid; metrics summed over the ranks."""
        local_bs = multihost.per_process_batch_size(batch_size)
        eval_step = step_lib.make_eval_step(self.task, data_parallel=self.data_parallel)
        acc = None
        with state.eval_params() as model:
            for raw in self._synthetic(local_bs, self.train_config.seed + 1, EVAL_SYNTHETIC_BATCHES):
                batch = pipeline_lib.to_device(dict(raw, valid=np.ones(local_bs, np.float32)), self.device)
                acc = step_lib.merge_metrics(acc, eval_step(model, batch))
        state.model.train()
        result = step_lib.compute_metrics(acc)
        self._log("eval @ %d: %s", state.step, result)
        return result

    # -- serving ----------------------------------------------------------

    def _restore_best_host(self) -> TrainState:
        """The best export (falling back to the latest checkpoint) in a
        template that draws no weights; single-process only."""
        if multihost.process_count() > 1:
            raise RuntimeError(
                "serving_fn/export_serving run single-process; load the model_dir from a single-process "
                "run to export"
            )
        return self._checkpointer().restore_best_or_raise(self._template_state(), hint="fit() first")

    def serving_fn(self, serving_dtype: str = "float32"):
        """``serve(images) -> {"probabilities", "class"}`` of the best state
        (its eval view: the EMA parameters even after a fallback to a
        periodic checkpoint) under the serving spec ``serving_dtype``
        (``float32``, ``bfloat16``, ``int8`` or ``int8-compute``; see
        ``train/quantize.py``), on the trainer's device. Wire contract for
        every spec: float32 in, float32 out (``class`` int32). The closure
        carries its manifest ``quantization`` section as
        ``serve.quantization``."""
        from tensorflowdistributedlearning_tpu_torch.train import quantize, serving

        state = self._restore_best_host()
        with state.eval_params() as eval_model:
            weights = {k: v.detach().cpu().clone() for k, v in eval_model.state_dict().items()}
        del state
        qstate, section = quantize.quantize_state(weights, serving_dtype, self.model_config)
        model = serving.serving_model(self.model_config, qstate, section, self.device)
        serve = serving.make_serving_fn(
            model, self.device, data_format=self.train_config.data_format,
            act_dtype=quantize.compute_dtype(serving_dtype),
        )
        serve.quantization = section
        return serve

    def export_serving(self, directory: Optional[str] = None, serving_dtype: str = "float32") -> str:
        """Write the serving artifact of the best state under the spec
        ``serving_dtype`` (default ``{model_dir}/export/serving``, or
        ``serving-{spec}`` for the quantized specs); returns its manifest
        path."""
        from tensorflowdistributedlearning_tpu_torch.train import quantize
        from tensorflowdistributedlearning_tpu_torch.train.serving import export_serving_artifact

        quantize.check_serving_spec(serving_dtype)
        suffix = "serving" if serving_dtype == "float32" else f"serving-{serving_dtype}"
        directory = directory or os.path.join(self.model_dir, "export", suffix)
        state = self._restore_best_host()
        with state.eval_params() as eval_model:
            return export_serving_artifact(
                eval_model, self.model_config, directory, data_format=self.train_config.data_format,
                metadata={"step": state.step}, serving_dtype=serving_dtype,
            )


def fit_preset(
    preset_name: str,
    model_dir: str,
    data_dir: Optional[str] = None,
    steps: int = 100,
    batch_size: Optional[int] = None,
    eval_every_steps: Optional[int] = None,
    export_serving: Optional[str] = None,
    export_dir: Optional[str] = None,
    device: DeviceLike = None,
    **overrides,
) -> FitResult:
    """Train a named classification preset (the ``fit`` command).
    ``overrides`` are ``TrainConfig`` fields (``optimizer``, ``lr``,
    ``augmentation``, ``ema_decay``, ``grad_clip_norm``,
    ``grad_accum_steps``, ...); None keeps
    the preset's value, and a knob the port does not run yet raises
    ``NotImplementedError`` from ``require_supported_training``. Swapping
    the optimizer needs an explicit ``lr`` (preset learning rates are tuned
    for their optimizer). ``export_serving`` (a serving spec) exports the
    best state after training into ``export_dir`` (default under
    ``model_dir``)."""
    from tensorflowdistributedlearning_tpu_torch.configs import get_preset

    preset = get_preset(preset_name)
    if preset.model.num_classes is None:
        raise ValueError(
            f"Preset {preset_name!r} is a segmentation config; use the `train` command (K-fold Trainer) for it"
        )
    train_cfg = preset.train
    optimizer, lr = overrides.get("optimizer"), overrides.get("lr")
    if optimizer is not None and optimizer != train_cfg.optimizer and lr is None:
        raise ValueError(
            f"preset {preset_name!r} pairs optimizer={train_cfg.optimizer!r} with lr={train_cfg.lr}; "
            "overriding --optimizer requires an explicit --lr tuned for it"
        )
    given = {k: v for k, v in overrides.items() if v is not None}
    if given:
        train_cfg = dataclasses.replace(train_cfg, **given)
    trainer = ClassifierTrainer(model_dir, data_dir, preset.model, train_cfg, device=device)
    result = trainer.fit(batch_size=batch_size or preset.global_batch, steps=steps,
                         eval_every_steps=eval_every_steps)
    if export_serving is not None:
        result.serving_artifact = os.path.dirname(trainer.export_serving(export_dir, serving_dtype=export_serving))
    return result
