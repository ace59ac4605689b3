"""Single-run classification training (counterpart of the JAX package's
``train/fit.py``: ``ClassifierTrainer`` :84, ``_train_stream`` :322,
``fit`` :438, ``_evaluate`` :842, ``serving_fn`` :1016,
``export_serving`` :1072, ``fit_preset`` :1126).

One run, no folds, top-1 as the model-selection metric: resume from the
latest checkpoint → the train loop (the train stream below, prefetched to
the device; on-device augmentation keyed by (seed, step);
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
sums; under ``weight_update_sharding`` the update is ZeRO-1's,
``parallel/zero.py``: each rank updates its slices of the optimizer state
and the EMA and all-gathers the parameters), and rank 0 alone writes.
Serving restores refuse to run under more than one rank. Under
``model_parallel = tp`` > 1 the ResNet classifiers train tensor-parallel
on a ``(world / tp, tp)`` grid (``parallel/tensor.py``): the ranks of a
model group hold the channel slices of one replica and share its data
slot, and the step is JAX's ``make_train_step_gspmd``, whose BatchNorm
statistics span the global batch (``tensor.make_train_step_gspmd``).
Under ``pipeline_parallel = K`` > 1 the ViT and the Xception-41
classifier train as K-stage GPipe pipelines on a ``(world / K, K)`` grid
(``parallel/pipeline.py``, ``train/pipeline_step.py``): the ranks of a
stage group share a data slot, split the local batch into
``pipeline_microbatches`` (default K) microbatches, and keep the whole
parameters replicated, so checkpoints are the plain strategy's. Under
``expert_parallel = E`` > 1 (it must equal ``moe_experts``) the Switch-MoE
ViT trains on a ``(world / E, E)`` grid (``parallel/expert.py``): the
ranks of an expert group share a data slot, each computes one expert of
every MoE layer under the all-to-all dispatch, in training and in eval as
the JAX package's ``fit`` does, and the step averages the gradient over
every rank, which is the dense step's gradient per data slot; the
parameters stay whole and replicated, so checkpoints are the plain
strategy's and the exports serve through the plain model, every expert
local. Under ``sequence_parallel = sp`` > 1 every dense model trains
H-sharded on a ``(world / sp, sp)`` grid (``parallel/spatial.py``; the
ViT through ``parallel/ring_attention.py``): the ranks of a sequence group
share a data slot and augment the whole images, each forwards its block of
the rows in the step, and the step averages the gradient over every rank;
the parameters stay whole, so checkpoints and exports are the plain
strategy's.

Input, in the JAX package's order of preference (``data_dir`` may hold any
of them; a stream is this rank's share):

- record shards ``{data_dir}/train-*.tfrecord`` (``data/records.py``):
  with ``data_service_workers`` > 0 (the default) through the streaming data
  service (``data/service.py``; all shards, dealt per epoch, batch i a pure
  function of (seed, i), a resume validating the checkpoint's sidecar and
  replaying the exact remaining stream); with 0 through
  ``ClassificationRecords`` (this rank's shards, the resume step folded into
  the seed), which refuses a checkpoint that carries a service sidecar.
  ``eval_holdout_fraction`` > 0 with no ``val-*.tfrecord`` holds out the
  last ceil(fraction · n) sorted train shards as the eval split;
- an ImageFolder split ``{data_dir}/train/{class}/*.png|jpg``
  (``data/imagefolder.py``), the resume step folded into the seed;
- otherwise ``data/synthetic.py``'s index-keyed batches.

Eval: ``val`` record shards or ``{data_dir}/val/``, else the train records or
folder (warned once: selection on train data), one ordered pass with
``valid = 0`` padding and the batch count equal on every rank; else 4
synthetic batches (seed + 1).

Observability and the host loop, as ``train/trainer.py``'s and the JAX
package's: one run ledger in ``model_dir`` (step windows, ``mfu``, eval,
checkpoint, memory, ``resumed`` and ``data_redeal`` events, traces, health
alerts, cadence profiles), TensorBoard scalars in ``train/`` and ``eval/``
(rank 0), dispatch-ahead with deferred window fetches
(``train/async_loop.py``), and a health abort that writes the final
checkpoint before it re-raises. The run header carries the planner's
``plan`` (``parallel/planner.py``): the one ``fit_preset`` resolved, else
the explicit layout's validation with telemetry on. Left out: fault
injection and preemption (A 14); tensor parallelism of the Xception-41
classifier, which JAX's own step cannot train (refused by
``require_supported_training``).
"""

from __future__ import annotations

import dataclasses
import logging
import math
import os
import time
from typing import Dict, Iterator, Optional, Tuple

import numpy as np
import torch

from tensorflowdistributedlearning_tpu_torch.config import (
    ModelConfig,
    TrainConfig,
    require_supported_layout,
    require_supported_training,
    validate_training_data_format,
)
from tensorflowdistributedlearning_tpu_torch.data import augment as augment_lib
from tensorflowdistributedlearning_tpu_torch.data import imagefolder
from tensorflowdistributedlearning_tpu_torch.data import pipeline as pipeline_lib
from tensorflowdistributedlearning_tpu_torch.data import records as records_lib
from tensorflowdistributedlearning_tpu_torch.data import service as service_lib
from tensorflowdistributedlearning_tpu_torch.data import synthetic as synthetic_lib
from tensorflowdistributedlearning_tpu_torch.obs import health as health_lib
from tensorflowdistributedlearning_tpu_torch.obs import telemetry as obs_lib
from tensorflowdistributedlearning_tpu_torch.parallel import collectives, mesh, multihost
from tensorflowdistributedlearning_tpu_torch.parallel import tensor as tensor_lib
from tensorflowdistributedlearning_tpu_torch.train import async_loop
from tensorflowdistributedlearning_tpu_torch.train import step as step_lib
from tensorflowdistributedlearning_tpu_torch.train.checkpoint import CheckpointManager
from tensorflowdistributedlearning_tpu_torch.train.state import (
    TrainState,
    create_train_state,
    replicate,
    template_train_state,
)
from tensorflowdistributedlearning_tpu_torch.train.trainer import (
    augment_seed,
    close_telemetry,
    open_telemetry,
    require_resolved_parallelism,
    run_info,
    run_plan,
    setup_step_telemetry,
)
from tensorflowdistributedlearning_tpu_torch.utils.devices import DeviceLike, resolve_device
from tensorflowdistributedlearning_tpu_torch.utils.summary import SummaryWriter

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
        plan: Optional[Dict] = None,
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
        require_resolved_parallelism(self.train_config, plan, "ClassifierTrainer",
                                     "fit_preset / the fit CLI do this automatically")
        self._plan = plan
        require_supported_training(model_config, self.train_config)
        multihost.initialize(backend=multihost.backend_for(device))
        multihost.require_world_size(self.train_config.n_devices)
        require_supported_layout(model_config, self.train_config, collectives.world_size())
        mesh.init_mesh_for(self.train_config)
        self.data_parallel = collectives.is_initialized()
        self.tensor_parallel = self.train_config.model_parallel > 1
        # GPipe stages over ViT blocks or Xception's middle flow; the
        # parameters stay in the canonical replicated tree
        self.pipeline_parallel = self.train_config.pipeline_parallel > 1
        if self.pipeline_parallel:
            from tensorflowdistributedlearning_tpu_torch.train.pipeline_step import validate_pipeline_config

            validate_pipeline_config(model_config, self.train_config.pipeline_parallel, self._pp_microbatches)
        self.device = resolve_device(device)
        self.task = step_lib.ClassificationTask(label_smoothing=self.train_config.label_smoothing)
        self._n_params: Optional[int] = None
        self._telemetry = obs_lib.NULL_TELEMETRY
        if multihost.is_main():
            os.makedirs(model_dir, exist_ok=True)

    @property
    def params(self) -> int:
        if self._n_params is None:
            raise AttributeError("fit() must build the model first")
        return self._n_params

    @property
    def _pp_microbatches(self) -> int:
        """Microbatches per local batch of the pipeline (default: one per
        stage)."""
        tcfg = self.train_config
        return tcfg.pipeline_microbatches or tcfg.pipeline_parallel

    def _log(self, msg: str, *args) -> None:
        if multihost.is_main():
            logger.info(msg, *args)

    # -- data -------------------------------------------------------------

    def _synthetic(self, batch_size: int, seed: int, steps: int, **kw) -> Iterator[Dict[str, np.ndarray]]:
        """The synthetic classification stream of this model's shapes."""
        cfg = self.model_config
        return synthetic_lib.synthetic_batches(
            "classification", batch_size, seed=seed, steps=steps, input_shape=cfg.input_shape,
            channels=cfg.input_channels, num_classes=cfg.num_classes, **kw,
        )

    def _holdout_partition(self, paths):
        """``(train_paths, heldout_paths)`` under ``eval_holdout_fraction``:
        the last ceil(fraction · n) sorted shards (at least one) are the eval
        split, the same on every rank."""
        frac = self.train_config.eval_holdout_fraction
        if frac <= 0:
            return list(paths), []
        n_hold = max(1, math.ceil(frac * len(paths)))
        if n_hold >= len(paths):
            raise ValueError(
                f"eval_holdout_fraction={frac} would hold out {n_hold} of {len(paths)} train record shard(s), "
                "leaving none to train on; write more shards or lower the fraction"
            )
        return list(paths[:-n_hold]), list(paths[-n_hold:])

    def _open_records(self, split: str, host_shard: bool = True) -> Optional[records_lib.ClassificationRecords]:
        """The record source of ``split`` (``{data_dir}/{split}-*.tfrecord``),
        or None when there are no such shards. With
        ``eval_holdout_fraction`` > 0 and no ``val`` shards, ``train`` leaves
        out the held-out shards and ``val`` is them. ``host_shard`` keeps
        this rank's round-robin shards; the data service takes them all and
        deals them per epoch."""
        if self.data_dir is None:
            return None
        cfg = self.model_config

        def open_split(glob_split):
            try:
                return records_lib.ClassificationRecords(
                    self.data_dir, split=glob_split, image_shape=cfg.input_shape, channels=cfg.input_channels,
                    num_classes=cfg.num_classes,
                )
            except ValueError:  # no shards for this split
                return None

        ds = open_split(split)
        if self.train_config.eval_holdout_fraction > 0 and open_split("val") is None:
            if split == "train" and ds is not None:
                ds.paths, _ = self._holdout_partition(ds.paths)
            elif split == "val":
                ds = open_split("train")
                if ds is not None:
                    _, ds.paths = self._holdout_partition(ds.paths)
        if ds is None or not host_shard:
            return ds
        n_shards = len(ds.paths)
        ds.paths = records_lib.host_shard_paths(ds.paths)
        if not ds.paths:
            raise ValueError(
                f"{split} has {n_shards} record shard(s) for {multihost.data_slot()[1]} processes — every process "
                "needs at least one; re-shard the dataset (write_classification_shards(shards>=process_count))"
            )
        return ds

    def _open_split(self, split: str) -> Optional[imagefolder.ImageFolder]:
        """The ImageFolder split ``{data_dir}/{split}``, or None."""
        if self.data_dir is None:
            return None
        root = os.path.join(self.data_dir, split)
        if not os.path.isdir(root):
            return None
        cfg = self.model_config
        ds = imagefolder.ImageFolder(root, cfg.input_shape, channels=cfg.input_channels)
        if ds.num_classes > cfg.num_classes:
            raise ValueError(f"{root} has {ds.num_classes} classes but the model has num_classes={cfg.num_classes}")
        return ds

    def _train_stream(
        self, batch_size: int, steps: int, start_step: int = 0, resume_state: Optional[Dict] = None, registry=None
    ) -> Tuple[Iterator[Dict[str, np.ndarray]], Optional[service_lib.StreamingDataService]]:
        """This rank's train batches from ``start_step`` on, and the data
        service feeding them (None when another stream does; the caller
        closes it). ``resume_state`` is the checkpoint's service sidecar;
        ``registry`` takes the service's ``data_service/*`` queues."""
        tcfg = self.train_config
        local_bs = multihost.per_process_batch_size(batch_size)
        # the streams without an index key fold the resume point into their
        # seed, so a resumed run does not replay the first batches
        seed = tcfg.seed + multihost.data_slot()[0] + 7919 * start_step
        use_service = tcfg.data_service_workers > 0
        records_ds = self._open_records("train", host_shard=not use_service)
        if records_ds is not None:
            if use_service:
                cfg = self.model_config
                service = service_lib.StreamingDataService(
                    service_lib.ClassificationRecordSource(
                        records_ds.paths, image_shape=cfg.input_shape, channels=cfg.input_channels,
                        num_classes=cfg.num_classes,
                    ),
                    batch_size=local_bs, seed=tcfg.seed, workers=tcfg.data_service_workers, start_batch=start_step,
                    resume_state=resume_state, registry=registry,
                )
                if service.redeal is not None:
                    self._log("the data service re-deals across a world resize: %s", service.redeal)
                    self._telemetry.event("data_redeal", step=start_step, **service.redeal)
                return service.batches(steps=steps), service
            if resume_state is not None:
                raise ValueError(
                    "this checkpoint carries a data-service resume sidecar but data_service_workers=0 selects the "
                    "legacy stream — resuming would silently replay or skip training data; resume with "
                    "--data-workers >= 1 (any count: batch content is worker-invariant)"
                )
            return records_ds.batches(local_bs, seed=seed, steps=steps), None
        train_split = self._open_split("train")
        if train_split is not None:
            # geometry runs on the device (_prepare_train): the host decodes and normalises
            return imagefolder.train_batches(train_split.host_shard(), local_bs, seed=seed, steps=steps,
                                             augment=False), None
        return self._synthetic(local_bs, tcfg.seed + multihost.data_slot()[0], steps, start_index=start_step,
                               index_keyed=True), None

    def _prepare_train(self, step: int, batch: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
        """On-device augmentation under ``TrainConfig.augmentation``, drawn
        from a generator keyed by (seed, step) and this rank."""
        policy = self.train_config.augmentation
        if policy == "none":
            return batch
        seed = augment_seed(self.train_config.seed, 0, step, multihost.data_slot()[0])
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
        self._n_params = state.param_count()
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
        checkpoints (each with the data service's sidecar), evals and best
        export; resumes from the latest checkpoint, and a run already at
        ``steps`` only evaluates. ``eval_every_steps`` defaults to
        ``TrainConfig.eval_every_steps``, then to ``checkpoint_every_steps``."""
        tcfg = self.train_config
        validate_training_data_format(tcfg)
        local_bs = multihost.per_process_batch_size(batch_size)  # fail fast, clear message
        if self.pipeline_parallel and local_bs % self._pp_microbatches:
            raise ValueError(
                f"per-replica batch {local_bs} not divisible into {self._pp_microbatches} pipeline microbatches"
            )
        # a layout fault of the eval split shows now, not at the first eval
        self._open_records("val")
        eval_every = eval_every_steps or tcfg.eval_every_steps or tcfg.checkpoint_every_steps
        plan = run_plan(self._plan, self.model_config, tcfg, batch_size, self.device)
        self._telemetry = open_telemetry(
            self.model_dir, tcfg, run_info("classification", steps, batch_size, self.model_config, tcfg, plan),
            self.device,
        )
        try:
            return self._fit_instrumented(batch_size, steps, eval_every)
        finally:
            close_telemetry(self._telemetry)
            self._telemetry = obs_lib.NULL_TELEMETRY

    def _fit_instrumented(self, batch_size: int, steps: int, eval_every: int) -> FitResult:
        """The run under ``self._telemetry``: restore, then train or, at
        ``steps`` already, evaluate."""
        tcfg = self.train_config
        tel = self._telemetry
        state = self._init_state()
        setup_step_telemetry(tel, self, state, batch_size, tcfg.profile_every_windows)
        ckpt = self._checkpointer()
        state = replicate(ckpt.restore_latest(state))
        start_step = state.step
        if start_step >= steps:
            self._log("already trained to step %d", start_step)
            metrics = self._evaluate(state, batch_size, step_no=start_step)
            tel.close(steps=start_step, already_trained=True)
            return FitResult(metrics, self.params, start_step)
        if start_step > 0:
            self._log("resumes at step %d", start_step)
            tel.event("resumed", step=start_step)
        resume_state = ckpt.restore_data_state(start_step) if start_step > 0 else None
        is_main = multihost.is_main()
        # the registry's queues are drained per window, which rank 0 alone writes
        registry = tel.registry if tel.enabled and is_main else None
        stream, service = self._train_stream(batch_size, steps - start_step, start_step, resume_state, registry)
        tb_train = SummaryWriter(os.path.join(self.model_dir, "train")) if is_main else None
        tb_eval = SummaryWriter(os.path.join(self.model_dir, "eval")) if is_main else None
        try:
            result = self._fit_loop(state, ckpt, stream, service, batch_size, eval_every, registry, tb_train, tb_eval)
        finally:
            if service is not None:
                service.close()
            for writer in (tb_train, tb_eval):
                if writer is not None:
                    writer.close()
        tel.memory_event(step=result.steps)
        tel.close(steps=result.steps, final_metrics={k: float(v) for k, v in result.final_metrics.items()})
        return result

    def _fit_loop(self, state: TrainState, ckpt: CheckpointManager, stream, service, batch_size: int,
                  eval_every: int, registry, tb_train, tb_eval) -> FitResult:
        """The steps from ``state.step`` to the stream's end: each step, its
        log window, checkpoint (with the service's sidecar) and eval on
        their cadence, then the final checkpoint and eval. A health abort
        writes the final checkpoint, then re-raises."""
        tcfg = self.train_config
        tel = self._telemetry
        local_bs = multihost.per_process_batch_size(batch_size)
        if self.tensor_parallel:
            train_step = tensor_lib.make_train_step_gspmd(
                self.task, weight_decay=self.model_config.weight_decay, seed=tcfg.seed
            )
        elif self.pipeline_parallel:
            from tensorflowdistributedlearning_tpu_torch.train import pipeline_step

            train_step = pipeline_step.make_train_step_pipeline(
                self.task, self.model_config, self._pp_microbatches, seed=tcfg.seed
            )
        else:
            train_step = step_lib.make_train_step(
                self.task, data_parallel=self.data_parallel, weight_decay=self.model_config.weight_decay,
                accum=tcfg.grad_accum_steps, seed=tcfg.seed,
            )
        batches = pipeline_lib.device_prefetch(
            stream, lambda b: pipeline_lib.to_device(b, self.device), depth=tcfg.prefetch_depth, registry=registry
        )

        def save_sidecar(step: int) -> None:
            if service is not None:
                ckpt.save_data_state(step, service.state(step).to_json())

        def emit_window(rec: async_loop.PendingWindow, scalars: Dict[str, float]) -> None:
            if tb_train is not None:
                tb_train.scalars(scalars, rec.step)
            tel.window_event(
                rec.step, steps=rec.steps, images_per_sec=rec.images_per_sec, scalars=scalars, dirty=rec.dirty,
                samples=rec.samples, examples=rec.steps * local_bs,
            )

        def evaluate(step: int) -> Dict[str, float]:
            metrics = self._evaluate(state, batch_size, step_no=step)
            if tb_eval is not None:
                tb_eval.scalars(metrics, step)
                tb_eval.flush()
            ckpt.export_best(state, metrics)
            return metrics

        overlap = async_loop.HostOverlap(tel, dispatch_ahead=tcfg.dispatch_ahead_steps, emit=emit_window)
        lr_sched = step_lib.make_host_lr_schedule(tcfg)
        step_no = state.step
        last_eval_step = -1
        final_metrics: Dict[str, float] = {}
        window_t0 = time.perf_counter()
        window_start = step_no
        # the first window holds the first run; eval and checkpoint windows
        # are not training time either
        window_dirty = True
        abort_err = None
        batches_it = iter(batches)
        try:
            while True:
                with tel.span(obs_lib.SPAN_DATA_WAIT):
                    raw = next(batches_it, None)
                if raw is None:
                    break
                with tel.span(obs_lib.SPAN_STEP):
                    state, metrics = train_step(state, self._prepare_train(step_no, raw))
                step_no += 1
                overlap.track(metrics)
                if tb_train is not None and step_no % tcfg.train_log_every_steps == 0:
                    now = time.perf_counter()
                    if tel.window_profiled():
                        window_dirty = True
                    images_per_sec = None
                    if not window_dirty and step_no > window_start:
                        images_per_sec = (step_no - window_start) * batch_size / (now - window_t0)
                    overlap.window(async_loop.PendingWindow(
                        step=step_no, metrics=metrics, steps=step_no - window_start, lr=lr_sched(step_no),
                        images_per_sec=images_per_sec, dirty=window_dirty,
                    ))
                    window_t0, window_start, window_dirty = now, step_no, False
                    tel.mark_warm(obs_lib.SPAN_STEP, obs_lib.SPAN_DATA_WAIT)
                saved = False
                if ckpt.is_save_step(step_no):
                    with tel.span(obs_lib.SPAN_CHECKPOINT):
                        saved = ckpt.maybe_save(state, step=step_no)
                if saved:
                    overlap.flush()
                    window_dirty = True
                    save_sidecar(step_no)
                    tel.checkpoint_event(step_no)
                if step_no % eval_every == 0:
                    overlap.flush()
                    last_eval_step = step_no
                    final_metrics = evaluate(step_no)
                    window_dirty = True
            overlap.flush()
        except health_lib.HealthAbortError as e:
            abort_err = e
        with tel.span(obs_lib.SPAN_CHECKPOINT):
            ckpt.save(state)
        save_sidecar(step_no)
        tel.checkpoint_event(step_no, final=True)
        if abort_err is not None:
            raise abort_err
        if last_eval_step != step_no:
            final_metrics = evaluate(step_no)
        return FitResult(final_metrics, self.params, step_no)

    def _evaluate(self, state: TrainState, batch_size: int, step_no: Optional[int] = None) -> Dict[str, float]:
        """One eval pass of the eval view (EMA parameters when tracked): the
        ``val`` records or folder, else the train records or folder (warned
        once), each one ordered pass with ``valid = 0`` padding and the same
        batch count on every rank; else 4 synthetic batches of the
        per-process size from ``seed + 1``. Metrics are summed over the
        ranks."""
        local_bs = multihost.per_process_batch_size(batch_size)
        val_folder = self._open_split("val")
        eval_records = self._open_records("val")
        if eval_records is None and val_folder is None:
            eval_records = self._open_records("train")
            if eval_records is not None:
                self._warn_eval_on_train("train record shards")
        if eval_records is not None:
            return self._evaluate_records(state, eval_records, local_bs, step_no)
        eval_split = val_folder
        if eval_split is None:
            eval_split = self._open_split("train")
            if eval_split is not None:
                self._warn_eval_on_train("the train ImageFolder split")
        if eval_split is None:
            batches = (dict(b, valid=np.ones(local_bs, np.float32))
                       for b in self._synthetic(local_bs, self.train_config.seed + 1, EVAL_SYNTHETIC_BATCHES))
        else:
            num = multihost.eval_num_batches(len(eval_split), local_bs)
            batches = imagefolder.eval_batches(eval_split.host_shard(), local_bs, num_batches=num)
        return self._eval_pass(state, batches, step_no)

    def _evaluate_records(self, state: TrainState, ds: records_lib.ClassificationRecords,
                          local_bs: int, step_no: Optional[int] = None) -> Dict[str, float]:
        """One ordered pass over this rank's record shards, extended to the
        largest batch count of any rank by wrap-around rows with
        ``valid = 0``."""
        num = multihost.all_processes_max_batches(records_lib.count_records(ds.paths), local_bs)
        return self._eval_pass(state, ds.batches(local_bs, repeat=False, pad_to_batches=num), step_no)

    def _eval_pass(self, state: TrainState, batches: Iterator[Dict[str, np.ndarray]],
                   step_no: Optional[int] = None) -> Dict[str, float]:
        """Accumulate the eval step's metrics over ``batches`` (rows weighted
        by ``valid``) on the device under the ``eval`` span, at most
        ``dispatch_ahead_steps`` (at least 1) batches in flight; one
        device-to-host copy per pass, then the ``eval`` event."""
        if self.tensor_parallel:
            eval_step = tensor_lib.make_eval_step_gspmd(self.task)
        elif self.pipeline_parallel:
            from tensorflowdistributedlearning_tpu_torch.train import pipeline_step

            eval_step = pipeline_step.make_eval_step_pipeline(self.task, self.model_config, self._pp_microbatches)
        else:
            eval_step = step_lib.make_eval_step(self.task, data_parallel=self.data_parallel)
        tel = self._telemetry
        t0 = time.perf_counter()
        with tel.span(obs_lib.SPAN_EVAL):
            budget = async_loop.eval_budget(tel, self.train_config.dispatch_ahead_steps)
            acc = None
            with state.eval_params() as model:
                for raw in batches:
                    acc = async_loop.merge_metrics_device(
                        acc, eval_step(model, pipeline_lib.to_device(raw, self.device))
                    )
                    budget.track(acc)
            state.model.train()
            result = async_loop.fetch_metrics(acc, telemetry=tel)
        step_no = state.step if step_no is None else step_no
        self._log("eval @ %d: %s", step_no, result)
        tel.eval_event(step_no, result, time.perf_counter() - t0)
        tel.mark_warm(obs_lib.SPAN_EVAL)
        return result

    def _warn_eval_on_train(self, source: str) -> None:
        """Once per trainer: selection on train data overestimates."""
        if getattr(self, "_warned_eval_on_train", False):
            return
        self._warned_eval_on_train = True
        logger.warning(
            "no val split found — eval (and best-checkpoint selection) is running on %s; metrics/top1 will "
            "overestimate generalization. Provide val-*.tfrecord shards / a val/ folder, or set "
            "TrainConfig.eval_holdout_fraction to carve one out of the train record shards.", source,
        )

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
    ``grad_accum_steps``, ``model_parallel``, ``pipeline_parallel``,
    ``pipeline_microbatches``, ``expert_parallel``, ``eval_holdout_fraction``,
    ``data_service_workers``, ``parallelism``, ``hbm_budget_gb``, ...);
    None keeps the preset's value, and a knob the port does not run yet
    raises ``NotImplementedError`` from ``require_supported_training``.
    Swapping the optimizer needs an explicit ``lr`` (preset learning rates
    are tuned for their optimizer). ``export_serving`` (a serving spec)
    exports the best state after training into ``export_dir`` (default
    under ``model_dir``).

    Every layout goes through the parallelism planner before the trainer
    exists, as in the JAX package: ``parallelism='auto'`` derives it
    (``model_parallel``, ``pipeline_parallel``, ``sequence_parallel`` and
    ``expert_parallel`` above 1, and ``weight_update_sharding`` when given,
    stay pinned; a prior run's ledgered rooflines in ``model_dir`` price
    the candidates), an explicit one is validated, so an indivisible
    layout fails here with its named constraint; the plan rides the run
    header."""
    from tensorflowdistributedlearning_tpu_torch.configs import get_preset
    from tensorflowdistributedlearning_tpu_torch.parallel import planner as planner_lib

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
    # the topology must see every rank, as the trainer's mesh will; the
    # degrees asked for must lay out over them (the mesh's text)
    multihost.initialize(backend=multihost.backend_for(device))
    multihost.require_world_size(train_cfg.n_devices)
    global_batch = batch_size or preset.global_batch
    if train_cfg.parallelism == "auto":
        # pin only what the caller asked for; the preset's own layout is
        # what auto derives again
        pinned = {k: given[k] for k in ("model_parallel", "pipeline_parallel", "sequence_parallel",
                                        "expert_parallel") if given.get(k, 1) != 1}
        if "weight_update_sharding" in given:
            pinned["weight_update_sharding"] = given["weight_update_sharding"]
        mesh.require_divisible(max([1] + [v for k, v in pinned.items() if k != "weight_update_sharding"]))
        try:
            measured = planner_lib.measured_costs_from_workdir(model_dir)
        except Exception:  # noqa: BLE001 — a torn ledger must not block
            measured = None
        plan = planner_lib.plan(preset.model, train_cfg, global_batch, pinned=pinned, source="auto",
                                measured_costs=measured, device=device)
        train_cfg = dataclasses.replace(train_cfg, **plan.overrides())
    else:
        # the port's refusals and the validators' JAX texts first, then the
        # mesh's, then the planner's named constraints
        require_supported_training(preset.model, train_cfg, collectives.world_size())
        mesh.require_divisible(mesh.model_axis_degree(train_cfg))
        plan = planner_lib.validate_config(preset.model, train_cfg, global_batch, device=device)
    trainer = ClassifierTrainer(model_dir, data_dir, preset.model, train_cfg, device=device, plan=plan.header())
    result = trainer.fit(batch_size=global_batch, steps=steps, eval_every_steps=eval_every_steps)
    if export_serving is not None:
        result.serving_artifact = os.path.dirname(trainer.export_serving(export_dir, serving_dtype=export_serving))
    return result
