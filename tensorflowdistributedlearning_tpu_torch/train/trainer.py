"""K-fold trainer, on one device or data-parallel over ranks (counterpart
of the JAX package's ``train/trainer.py``: ``Trainer.train`` :289,
``_train_fold`` :388, ``_evaluate`` :737, ``predict`` :857,
``export_serving`` :998, ``_predict_one`` :1036).

Per fold: stratified index manifests (``folds.json``, written once) →
auto-resume from the fold's latest checkpoint → the train loop (shuffled
in-memory batches, pinned-memory prefetch to the device, on-device
augmentation + Laplacian channel, training-mode forward, per-image Lovász
hinge, backward, optimizer update) → periodic checkpoints every
``checkpoint_every_steps``, each with the data service's resume sidecar →
eval every ``eval_every_steps`` (or, without
it, when a checkpoint lands and ``eval_throttle_secs`` have passed) with
best-k export on ``metrics/mean_iou`` → the final checkpoint, eval and
export. A fold already trained to ``steps`` is evaluated and not trained
again.

``predict`` is the fold × TTA ensemble: every fold's eval view (its EMA
when tracked) under every test-time transform, averaged.

Data-parallel: under a process group (``torchrun``, or explicit
coordinator arguments; ``parallel/multihost.py``) every rank trains a
replica on its own device: it loads its round-robin share of the fold's
train and eval ids (``host_shard``), draws ``batch_size / world`` rows per
step, and runs the data-parallel step (gradient mean, BN-statistics mean,
metric sums; under ``weight_update_sharding`` the update is ZeRO-1's,
``parallel/zero.py``). Eval runs the same number of steps on every rank
(``eval_num_batches``, ``valid = 0`` padding) and sums the metrics, so every
rank holds the global metrics and takes the same export decision. Rank 0
alone writes files and logs; prediction and serving refuse to run
multi-process, as in the JAX package.

Tensor-parallel under ``model_parallel = tp`` > 1 (``parallel/tensor.py``;
JAX's ``make_train_step(auto_model=True)``): the ranks form a ``(world /
tp, tp)`` grid (``parallel/mesh.py``); the ranks of one model group hold
the channel slices of one replica and share its data slot (ids, rows,
augmentation and dropout draws by data index), the step reduces over the
data group with per-tower BatchNorm, and checkpoints and exports are whole.

Sequence-parallel under ``sequence_parallel = sp`` > 1
(``parallel/spatial.py``; JAX's ``make_train_step(spatial=True)``): the
ranks form the same grid with a sequence group in the model slot; the
ranks of one group share a data slot, augment the whole images (and add
the Laplacian channel) from the data index's generator, and each takes
its block of the rows in the step (``step.spatial_batch``). The backbone
runs H-sharded, its BatchNorm over the group; eval and the fold x TTA
``predict`` are H-sharded the same way, and ``predict`` runs on every rank
of the process group (each rank restores the fold's checkpoint and
returns the whole ensemble).

The fold's train batches: with ``TrainConfig.data_service_workers`` > 0
(the default, 2) the streaming data service over the fold's arrays
(``data/service.py``, ``ArrayBatchSource``, seed ``seed + fold``): batch i
is a pure function of (seed + fold, i), the JAX package's batch i, and a
resumed fold validates the checkpoint's sidecar and replays the exact
remaining stream. ``data_service_workers=0`` feeds ``pipeline.train_batches``
with the resume step folded into its seed, as the JAX package does then.

Observability, as the JAX package's: one run ledger for the K-fold run in
``model_dir`` (``obs/telemetry.py``; ``TrainConfig.telemetry``) with the
step windows (the data-wait / step / fetch-wait split, throughput, ``mfu``,
the prefetch and data-service queues), eval, checkpoint and memory events,
sampled traces (``trace_sample_rate``), the health monitors (``nan_guard``
'abort' writes the final checkpoint, then raises ``HealthAbortError``) and
cadence profiles (``profile_every_windows``); TensorBoard scalars and
input/label/probability/prediction images in ``fold{i}/train`` and
``fold{i}/eval`` (rank 0). The host loop runs ``dispatch_ahead_steps``
steps ahead of the card and writes each window one boundary late
(``train/async_loop.py``). Each rank writes its own ledger
(``telemetry-{i}.jsonl`` on rank i > 0).

Not in this slice: fault injection and preemption handling (queue A 14).
"""

from __future__ import annotations

import dataclasses
import logging
import os
import time
from typing import Dict, List, Optional, Sequence

import numpy as np
import torch

from tensorflowdistributedlearning_tpu_torch.config import (
    ModelConfig,
    TrainConfig,
    require_supported_training,
    validate_training_data_format,
)
from tensorflowdistributedlearning_tpu_torch.data import augment as augment_lib
from tensorflowdistributedlearning_tpu_torch.data import folds as folds_lib
from tensorflowdistributedlearning_tpu_torch.data import pipeline as pipeline_lib
from tensorflowdistributedlearning_tpu_torch.data import service as service_lib
from tensorflowdistributedlearning_tpu_torch.obs import health as health_lib
from tensorflowdistributedlearning_tpu_torch.obs import telemetry as obs_lib
from tensorflowdistributedlearning_tpu_torch.obs.profiler import ContinuousProfiler
from tensorflowdistributedlearning_tpu_torch.parallel import collectives, mesh, multihost
from tensorflowdistributedlearning_tpu_torch.train import async_loop
from tensorflowdistributedlearning_tpu_torch.train import step as step_lib
from tensorflowdistributedlearning_tpu_torch.train.checkpoint import CheckpointManager
from tensorflowdistributedlearning_tpu_torch.train.state import (
    TrainState,
    create_train_state,
    replicate,
    template_train_state,
)
from tensorflowdistributedlearning_tpu_torch.utils.devices import DeviceLike, resolve_device
from tensorflowdistributedlearning_tpu_torch.utils.summary import SummaryWriter

logger = logging.getLogger(__name__)

_MODEL_FIELDS = {f.name for f in dataclasses.fields(ModelConfig)}


def augment_seed(seed: int, fold: int, step: int, rank: int = 0) -> int:
    """The augmentation generator's seed for one train step: a pure function
    of (seed + fold, step), so a resumed fold draws what the uninterrupted
    run drew at the same step. A data index (``rank``) > 0 folds itself in,
    so the shards of one global batch draw different augmentations (the JAX
    package draws the whole global batch from one key) and the ranks of a
    model group the same ones; data index 0 draws what one process draws."""
    entropy = [seed + fold, step] + ([rank] if rank else [])
    return int(np.random.SeedSequence(entropy).generate_state(1, np.uint64)[0] >> 1)


def tensor_bytes(tensors) -> int:
    """Bytes of the tensors among ``tensors``."""
    return sum(t.numel() * t.element_size() for t in tensors if isinstance(t, torch.Tensor))


def state_bytes(state: TrainState, weight_update_sharding: bool = False) -> Dict[str, int]:
    """The memory event's state accounting per device, as the JAX package's
    ``tree_bytes_per_device`` gives it: the parameters; and the optimizer
    state, which is the slots as they stand after init (Adam's two moments
    and its step, SGD's and LARS's trace, counted at their size before
    torch allocates them at the first update) and the EMA, this rank's
    slices of both under ZeRO-1. ``weight_update_sharding`` is the
    configuration's. The scalar counters differ: optax keeps one ``count``
    per counting transform, torch's Adam a ``step`` per parameter."""
    from tensorflowdistributedlearning_tpu_torch.train.step import optimizer_slot_bytes

    opt = optimizer_slot_bytes(state.optimizer)
    if state.ema is not None:
        opt += tensor_bytes(state.ema.values())
    return {"params_bytes_per_device": tensor_bytes(state.model.parameters()), "opt_state_bytes_per_device": opt,
            "weight_update_sharding": bool(weight_update_sharding)}


def setup_step_telemetry(tel, trainer, state: TrainState, batch_size: int, every_windows: int) -> None:
    """The per-fold (per-run) telemetry set-up both trainers share: the
    memory event, JAX's ``6 · params · global_batch`` step pricing (and the
    gradient all-reduce's ``2 · params`` bytes over more than one rank),
    and the cadence profiler."""
    tel.memory_event(**state_bytes(state, trainer.train_config.weight_update_sharding))
    if not tel.enabled:
        return
    world = multihost.process_count()
    # this rank's parameters: its slices under tensor parallelism
    params_bytes = tensor_bytes(state.model.parameters())
    tel.set_step_flops(
        6.0 * float(trainer.params) * float(batch_size), n_devices=world,
        collective_bytes_per_step=2.0 * params_bytes if world > 1 else None,
    )
    if tel.profiler is None:
        tel.set_profiler(ContinuousProfiler(tel, every_windows=every_windows, phase="train", device=trainer.device))


def run_info(task: str, steps: int, batch_size: int, model_config: ModelConfig, train_config: TrainConfig,
             plan: Optional[Dict] = None, **extra) -> Dict:
    """The run header's JAX keys: the mesh's three axes as the JAX
    package's trainers write them (``mesh.axis_sizes``), and ``plan``, the
    parallelism planner's header (``parallel/planner.py``), when there is
    one."""
    return {
        "task": task, "steps": steps, "global_batch": batch_size, **extra,
        "mesh": mesh.axis_sizes(),
        "model_config": dataclasses.asdict(model_config),
        "train_config": dataclasses.asdict(train_config),
        **({"plan": plan} if plan else {}),
    }


def run_plan(plan: Optional[Dict], model_config: ModelConfig, train_config: TrainConfig, batch_size: int,
             device=None) -> Optional[Dict]:
    """The run header's ``plan``: ``plan`` when the caller resolved one,
    else, with telemetry on, the planner's validation of the explicit
    layout (best-effort, as the JAX package's trainers: the mesh already
    checked divisibility, so a planner failure costs the header its plan,
    not the run). ``device`` is the trainer's, whose topology is read."""
    if plan is not None or not train_config.telemetry:
        return plan
    from tensorflowdistributedlearning_tpu_torch.parallel import planner as planner_lib

    try:
        return planner_lib.validate_config(model_config, train_config, batch_size, device=device).header()
    except Exception as e:  # noqa: BLE001 — the plan is telemetry here
        logger.warning("parallelism plan unavailable: %s", e)
        return None


def require_resolved_parallelism(train_config: TrainConfig, plan: Optional[Dict], trainer: str,
                                 resolver: str) -> None:
    """The JAX trainers' refusal of an unresolved ``parallelism='auto'``:
    the mesh is built from the explicit degrees, so 'auto' must be planned
    (and its plan handed in) before the trainer exists."""
    if train_config.parallelism == "auto" and plan is None:
        raise ValueError(
            f"parallelism='auto' must be resolved before constructing {trainer}: plan the layout first "
            f"({resolver}; programmatically, call parallel.planner.plan(model_config, train_config, global_batch), "
            "apply plan.overrides() onto the config, and pass plan=plan.header())"
        )


def open_telemetry(model_dir: str, train_config: TrainConfig, info: Dict, device) -> obs_lib.Telemetry:
    """The run's telemetry (every rank writes its own ledger, rank 0
    ``telemetry.jsonl``), with the health monitors of ``train_config``,
    timing the process group's sync points as ``barrier_wait``."""
    tel = obs_lib.Telemetry(
        model_dir, enabled=train_config.telemetry, memory_every_windows=train_config.telemetry_memory_every_windows,
        trace_sample_rate=train_config.trace_sample_rate,
        health=health_lib.HealthMonitor.from_train_config(train_config), device=device, run_info=info,
    )
    multihost.instrument(tel)
    return tel


def close_telemetry(tel: obs_lib.Telemetry) -> None:
    """Teardown of :func:`open_telemetry`: a run that did not close with its
    results is recorded as interrupted."""
    multihost.uninstrument(tel)
    tel.close(interrupted=True)


_SINGLE_PROCESS = (
    "serving/predict restore runs single-process; load this model_dir from a single-process session"
)


class Trainer:
    """K-fold cross-validated trainer for the segmentation task.
    ``**kwargs`` takes every ``ModelConfig`` field (unknown keys raise);
    ``device`` is CUDA (the rank's GPU under a process group) unless the
    caller asks for the CPU. ``n_devices`` is the world size: None takes the
    process group the launcher set up (one process without one), any other
    value must equal it. ``TrainConfig.model_parallel`` (or
    ``sequence_parallel``) lays the world out as ``(world / tp, tp)``;
    ``pipeline_parallel`` > 1 raises (the pipeline is ``fit``'s alone).
    ``parallelism='auto'`` must come resolved, with the planner's header
    as ``plan`` (the ``train`` command does this), as in the JAX
    package; the run header carries ``plan``, the explicit layout's
    validation when none was given and telemetry is on."""

    def __init__(
        self,
        model_dir: str,
        data_directory: str,
        data_format: str = "NHWC",
        lr: float = 0.001,
        n_devices: Optional[int] = None,
        n_fold: int = 5,
        seed: int = 42,
        save_best: int = 5,
        train_config: Optional[TrainConfig] = None,
        augment_config: Optional[augment_lib.AugmentConfig] = None,
        device: DeviceLike = None,
        plan: Optional[Dict] = None,
        **kwargs,
    ):
        unknown = set(kwargs) - _MODEL_FIELDS
        if unknown:
            raise ValueError(f"Unknown model config keys: {sorted(unknown)}")
        self.model_dir = model_dir
        self.data_directory = data_directory
        self.model_config = ModelConfig(**kwargs)
        self.train_config = train_config or TrainConfig(
            data_format=data_format, lr=lr, n_devices=n_devices, n_folds=n_fold, seed=seed, save_best=save_best
        )
        # the reference trainer passed crop_probability=0
        self.augment_config = augment_config or augment_lib.AugmentConfig(crop_probability=0.0)
        require_resolved_parallelism(self.train_config, plan, "Trainer", "the train CLI does this automatically")
        self._plan = plan
        if self.train_config.pipeline_parallel > 1:
            # JAX's Trainer ignores the field; a pipeline is fit's alone
            raise NotImplementedError(
                f"pipeline_parallel={self.train_config.pipeline_parallel}: the K-fold Trainer does not pipeline "
                "(ROADMAP.md, standing findings); ClassifierTrainer.fit (the fit command, fit_preset) is the "
                "pipeline's only entry point"
            )
        require_supported_training(self.model_config, self.train_config)
        multihost.initialize(backend=multihost.backend_for(device))
        multihost.require_world_size(self.train_config.n_devices)
        mesh.init_mesh_for(self.train_config)
        self.data_parallel = collectives.is_initialized()
        self.device = resolve_device(device)
        self.task = step_lib.SegmentationTask()
        self._n_params: Optional[int] = None
        self._telemetry = obs_lib.NULL_TELEMETRY
        if multihost.is_main():
            os.makedirs(model_dir, exist_ok=True)

    @property
    def params(self) -> int:
        """Total trainable parameter count, known once a state was built."""
        if self._n_params is None:
            raise AttributeError("Parameter count unknown — train() must build the model first")
        return self._n_params

    def _fold_dir(self, fold: int) -> str:
        return os.path.join(self.model_dir, f"fold{fold}")

    def _init_state(self) -> TrainState:
        generator = torch.Generator().manual_seed(self.train_config.seed)
        return self._counted(create_train_state(self.model_config, self.train_config, self.device, generator=generator))

    def _template_state(self) -> TrainState:
        """The restore template: allocated, not drawn (a restore overwrites
        every tensor)."""
        return self._counted(template_train_state(self.model_config, self.train_config, self.device))

    def _counted(self, state: TrainState) -> TrainState:
        self._n_params = state.param_count()
        return state

    def _require_single_process(self, sequence_ok: bool = False) -> None:
        """Raise under a process group, unless ``sequence_ok`` and the ranks
        form sequence groups (H-sharded prediction runs on every rank)."""
        if multihost.process_count() > 1 and not (sequence_ok and mesh.sequence_parallel_degree() > 1):
            raise RuntimeError(_SINGLE_PROCESS)

    def _checkpointer(self, fold: int) -> CheckpointManager:
        tcfg = self.train_config
        return CheckpointManager(
            self._fold_dir(fold), save_every_steps=tcfg.checkpoint_every_steps, save_best=tcfg.save_best
        )

    # -- training ---------------------------------------------------------

    def train(
        self, X: Sequence[str], y: Optional[Sequence[int]] = None, batch_size: int = 64, steps: int = 10_000
    ) -> List[Dict[str, float]]:
        """Train every fold; returns each fold's final eval metrics. ``X``:
        example ids under ``{data_directory}/images``; ``y``: stratification
        classes (from mask coverage when omitted). ``batch_size`` is global:
        each of W ranks draws ``batch_size / W`` rows per step."""
        validate_training_data_format(self.train_config)
        multihost.per_process_batch_size(batch_size)  # fail fast, clear message
        dataset = pipeline_lib.InMemoryDataset.from_directory(self.data_directory, ids=list(X))
        if y is None:
            y = folds_lib.coverage_to_class(pipeline_lib.mask_coverage(dataset.masks))
        manifests = None
        if multihost.is_main():
            manifests = folds_lib.write_fold_manifests(
                self.model_dir, list(X), list(np.asarray(y)), self.train_config.n_folds, self.train_config.seed
            )
        manifests = multihost.broadcast_object(manifests)
        tcfg = self.train_config
        plan = run_plan(self._plan, self.model_config, tcfg, batch_size, self.device)
        # one ledger for the K-fold run; events carry their fold
        self._telemetry = open_telemetry(
            self.model_dir, tcfg,
            run_info("segmentation", steps, batch_size, self.model_config, tcfg, plan, n_folds=tcfg.n_folds),
            self.device,
        )
        try:
            results = []
            for fold, manifest in enumerate(manifests):
                self._log("Processing fold %d", fold)
                results.append(self._train_fold(fold, dataset, manifest, batch_size, steps))
                self._log("Finished training fold %d", fold)
            self._telemetry.close(
                folds=len(results), final_metrics={k: float(v) for k, v in (results[-1] if results else {}).items()}
            )
            return results
        finally:
            close_telemetry(self._telemetry)
            self._telemetry = obs_lib.NULL_TELEMETRY

    def _log(self, msg: str, *args) -> None:
        """Log from rank 0 only."""
        if multihost.is_main():
            logger.info(msg, *args)

    def _train_fold(
        self,
        fold: int,
        dataset: pipeline_lib.InMemoryDataset,
        manifest: Dict[str, List[str]],
        batch_size: int,
        steps: int,
    ) -> Dict[str, float]:
        tcfg = self.train_config
        tel = self._telemetry
        # loss history and step-time baselines are per-fold facts
        if tel.health is not None:
            tel.health.reset()
        local_bs = multihost.per_process_batch_size(batch_size)
        train_ds = dataset.select(pipeline_lib.host_shard(manifest["train"]))
        eval_ds = dataset.select(pipeline_lib.host_shard(manifest["eval"]))
        eval_global_n = len(manifest["eval"])
        ckpt = self._checkpointer(fold)
        state = replicate(ckpt.restore_latest(self._init_state()))
        setup_step_telemetry(tel, self, state, batch_size, tcfg.profile_every_windows)
        start_step = state.step
        if start_step >= steps:
            self._log("fold %d already trained to step %d", fold, start_step)
            return self._evaluate(state, eval_ds, local_bs, fold, eval_global_n, step_no=start_step)
        if start_step > 0:
            self._log("fold %d resumes at step %d", fold, start_step)
            tel.event("resumed", step=start_step, fold=fold)

        train_step = step_lib.make_train_step(
            self.task, data_parallel=self.data_parallel, weight_decay=self.model_config.weight_decay,
            accum=tcfg.grad_accum_steps, seed=tcfg.seed,
        )
        is_main = multihost.is_main()
        # the registry's queues are drained per window, which rank 0 alone
        # writes: the other ranks record nothing
        registry = tel.registry if tel.enabled and is_main else None
        service = None
        if tcfg.data_service_workers > 0:
            service = service_lib.StreamingDataService(
                # the arrays are this rank's shard for this world size: the
                # sidecar records it, so a resume under another world size
                # re-deals explicitly
                service_lib.ArrayBatchSource(
                    {"images": train_ds.images, "masks": train_ds.masks}, process_count=multihost.data_slot()[1]
                ),
                batch_size=local_bs, seed=tcfg.seed + fold, workers=tcfg.data_service_workers,
                start_batch=start_step, registry=registry,
                resume_state=ckpt.restore_data_state(start_step) if start_step > 0 else None,
            )
            if service.redeal is not None:
                self._log("fold %d: the data service re-deals across a world resize: %s", fold, service.redeal)
                tel.event("data_redeal", step=start_step, fold=fold, **service.redeal)
            batches = service.batches(steps=steps - start_step)
        else:
            batches = pipeline_lib.train_batches(
                train_ds, local_bs, seed=tcfg.seed + fold + 7919 * start_step, steps=steps - start_step
            )
        batches = pipeline_lib.device_prefetch(
            batches, lambda b: pipeline_lib.to_device(b, self.device), depth=tcfg.prefetch_depth, registry=registry
        )
        tb_train = SummaryWriter(os.path.join(self._fold_dir(fold), "train")) if is_main else None
        tb_eval = SummaryWriter(os.path.join(self._fold_dir(fold), "eval")) if is_main else None
        try:
            return self._train_loop(fold, state, ckpt, train_step, batches, service, eval_ds, batch_size,
                                    eval_global_n, tb_train, tb_eval)
        finally:
            if service is not None:
                service.close()
            for writer in (tb_train, tb_eval):
                if writer is not None:
                    writer.close()

    def _train_loop(self, fold, state, ckpt, train_step, batches, service, eval_ds, batch_size, eval_global_n,
                    tb_train, tb_eval):
        """The fold's steps from its resume point: each step, its log
        window, checkpoint (with the service's sidecar) and eval on their
        cadence, then the final checkpoint, eval and export. A health abort
        writes the final checkpoint, then re-raises."""
        tcfg = self.train_config
        tel = self._telemetry
        local_bs = multihost.per_process_batch_size(batch_size)

        def save_sidecar(step: int) -> None:
            if service is not None:
                ckpt.save_data_state(step, service.state(step).to_json())

        def emit_window(rec: async_loop.PendingWindow, scalars: Dict[str, float]) -> None:
            if tb_train is not None:
                tb_train.scalars(scalars, rec.step)
            tel.window_event(
                rec.step, steps=rec.steps, images_per_sec=rec.images_per_sec, scalars=scalars, dirty=rec.dirty,
                samples=rec.samples, examples=rec.steps * local_bs, **rec.extra,
            )

        overlap = async_loop.HostOverlap(tel, dispatch_ahead=tcfg.dispatch_ahead_steps, emit=emit_window)
        lr_sched = step_lib.make_host_lr_schedule(tcfg)
        last_eval_time = 0.0
        last_eval_step = -1
        final_metrics: Dict[str, float] = {}
        step_no = state.step
        window_t0 = time.perf_counter()
        window_start = step_no
        # the first window holds the first run; windows with an eval or a
        # checkpoint are not training time either
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
                    batch = self._prepare_train(fold, step_no, raw)
                    state, metrics = train_step(state, batch)
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
                        images_per_sec=images_per_sec, dirty=window_dirty, extra={"fold": fold},
                    ))
                    window_t0, window_start, window_dirty = now, step_no, False
                    tel.mark_warm(obs_lib.SPAN_STEP, obs_lib.SPAN_DATA_WAIT)
                    if multihost.process_count() == 1:
                        # the wait for the steps in flight is fetch_wait; the
                        # summaries' own forward and encoding are in no span,
                        # as in the JAX package
                        overlap.drain()
                        self._write_image_summaries(tb_train, state.model, batch, step_no)
                saved = False
                if ckpt.is_save_step(step_no):
                    with tel.span(obs_lib.SPAN_CHECKPOINT):
                        saved = ckpt.maybe_save(state, step=step_no)
                if saved:
                    overlap.flush()
                    window_dirty = True
                    save_sidecar(step_no)
                    tel.checkpoint_event(step_no, fold=fold)
                if tcfg.eval_every_steps:
                    due = step_no % tcfg.eval_every_steps == 0
                else:
                    # a clock decides: every rank takes rank 0's reading
                    due = saved and multihost.broadcast_object(
                        time.time() - last_eval_time >= tcfg.eval_throttle_secs
                    )
                if due:
                    overlap.flush()
                    last_eval_time = time.time()
                    last_eval_step = step_no
                    final_metrics = self._evaluate(state, eval_ds, local_bs, fold, eval_global_n, writer=tb_eval,
                                                   step_no=step_no)
                    ckpt.export_best(state, final_metrics)
                    window_dirty = True
            overlap.flush()
        except health_lib.HealthAbortError as e:
            abort_err = e
        with tel.span(obs_lib.SPAN_CHECKPOINT):
            ckpt.save(state)
        save_sidecar(step_no)
        tel.checkpoint_event(step_no, fold=fold, final=True)
        if abort_err is not None:
            raise abort_err
        if last_eval_step != step_no:
            final_metrics = self._evaluate(state, eval_ds, local_bs, fold, eval_global_n, writer=tb_eval,
                                           step_no=step_no)
            ckpt.export_best(state, final_metrics)
        return final_metrics

    def _prepare_train(self, fold: int, step: int, raw: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
        """On-device augmentation + Laplacian channel: {'images', 'masks'} ->
        {'images', 'labels'}, drawn from the step's (and rank's) own
        generator."""
        seed = augment_seed(self.train_config.seed, fold, step, multihost.data_slot()[0])
        gen = torch.Generator(device=self.device).manual_seed(seed)
        return augment_lib.augment_batch(gen, raw["images"], raw["masks"], self.augment_config)

    def _evaluate(
        self, state: TrainState, eval_ds: pipeline_lib.InMemoryDataset, batch_size: int, fold: int,
        global_n: Optional[int] = None, writer: Optional[SummaryWriter] = None, step_no: Optional[int] = None,
    ) -> Dict[str, float]:
        """One full eval pass with streaming metrics (EMA parameters when
        tracked) under the ``eval`` span; the accumulator stays on the
        device, one host transfer per pass. ``eval_ds`` is this rank's shard
        and ``batch_size`` its share; ``global_n`` (the fold's eval size)
        sets the step count every rank runs, and the metrics are summed over
        the ranks. With ``writer``: the eval scalars and images."""
        eval_step = step_lib.make_eval_step(self.task, data_parallel=self.data_parallel)
        global_n = len(eval_ds) if global_n is None else global_n
        num = multihost.eval_num_batches(global_n, batch_size) if self.data_parallel else None
        tel = self._telemetry
        t0 = time.perf_counter()
        first_batch = None
        with tel.span(obs_lib.SPAN_EVAL):
            budget = async_loop.eval_budget(tel, self.train_config.dispatch_ahead_steps)
            acc = None
            with state.eval_params() as model:
                for raw in pipeline_lib.eval_batches(eval_ds, batch_size, num_batches=num):
                    placed = pipeline_lib.to_device(raw, self.device)
                    batch = augment_lib.prepare_eval_batch(placed["images"], placed["masks"])
                    batch["valid"] = placed["valid"]
                    acc = async_loop.merge_metrics_device(acc, eval_step(model, batch))
                    budget.track(acc)
                    if first_batch is None:
                        first_batch = batch
                state.model.train()
                result = async_loop.fetch_metrics(acc, telemetry=tel)
                eval_s = time.perf_counter() - t0
                if step_no is None:
                    step_no = state.step
                if writer is not None and multihost.process_count() == 1:
                    self._write_image_summaries(writer, model, first_batch, step_no)
        tel.eval_event(step_no, result, eval_s, fold=fold)
        tel.mark_warm(obs_lib.SPAN_EVAL)
        self._log("fold %d eval @ %d (%.3f s): %s", fold, step_no, eval_s, result)
        if writer is not None:
            writer.scalars(result, step_no)
            writer.flush()
        return result

    def _write_image_summaries(self, writer: SummaryWriter, model: torch.nn.Module, batch, step_no: int) -> None:
        """input/label/probability/prediction images of the first three
        examples of ``batch`` (the JAX package's tags ``image/i``,
        ``label/i``, ``probability/i``, ``prediction/i``): one eval-mode
        forward of ``model`` as it stands, which leaves BN's running
        statistics alone and the model in the mode it found."""
        was_training = model.training
        model.eval()
        try:
            with torch.no_grad():
                probs = torch.sigmoid(model(batch["images"][:3]))[..., 0].cpu().numpy()
        finally:
            model.train(was_training)
        images = batch["images"][:3, ..., 0].cpu().numpy()
        labels = batch["labels"][:3, ..., 0].cpu().numpy()
        for i in range(min(3, images.shape[0])):
            lo, hi = images[i].min(), images[i].max()
            writer.image(f"image/{i}", (images[i] - lo) / max(hi - lo, 1e-6), step_no)
            writer.image(f"label/{i}", labels[i], step_no)
            writer.image(f"probability/{i}", probs[i], step_no)
            writer.image(f"prediction/{i}", (probs[i] > 0.5).astype(np.float32), step_no)

    # -- prediction ---------------------------------------------------------

    def predict(
        self, test_dir: str, batch_size: int = 64, tta: bool = True, folds: Optional[Sequence[int]] = None
    ) -> Dict[str, object]:
        """Fold × TTA ensemble prediction over ``{test_dir}/images``.

        For every fold's best state (falling back to its latest periodic
        checkpoint; raises for a fold never trained), in its eval view (the
        EMA parameters when tracked, even after a fallback), and every TTA
        transform (``tta=False``: only ``"none"``), forward the transformed
        images and invert the transform on the probabilities; the members
        are summed in that order and divided by their count, as the JAX
        package does.

        Returns ``{"ids", "probabilities" [N,H,W,1], "masks" [N,H,W,1]}``
        as numpy float32 arrays, ``[N,1,H,W]`` under ``data_format="NCHW"``;
        the masks are ``mean > task.threshold``. Single-process only, or
        every rank of a sequence-parallel process group (each forwards its
        block of the rows; every rank returns the whole ensemble)."""
        self._require_single_process(sequence_ok=True)
        transforms = augment_lib.TTA_TRANSFORMS if tta else ("none",)
        folds = list(folds) if folds is not None else list(range(self.train_config.n_folds))
        test_ds = pipeline_lib.InMemoryDataset.from_directory(test_dir, with_masks=False)
        total = None
        n_members = 0
        for fold in folds:
            state = self._restore_fold(fold, sequence_ok=True)
            with state.eval_params() as model:
                for transformation in transforms:
                    probs = self._predict_one(model, test_ds, batch_size, transformation)
                    total = probs if total is None else total + probs
                    n_members += 1
        mean_probs = total / n_members
        if self.train_config.data_format == "NCHW":
            mean_probs = np.transpose(mean_probs, (0, 3, 1, 2))
        return {
            "ids": list(test_ds.ids),
            "probabilities": mean_probs,
            "masks": (mean_probs > self.task.threshold).astype(np.float32),
        }

    def _predict_one(
        self, model: torch.nn.Module, test_ds: pipeline_lib.InMemoryDataset, batch_size: int, transformation: str
    ) -> np.ndarray:
        """Probabilities [N, H, W, 1] of one ensemble member: ``model`` (a
        fold's eval view) under one TTA transform. Batches follow
        ``eval_batches``' padding contract and reach the device through the
        pinned copy; the valid rows (picked by the host's mask, so the host
        never waits for the device) stay on the device until one copy to
        the host at the end."""
        predict_step = step_lib.make_predict_step(self.task)
        chunks = []
        for raw in pipeline_lib.eval_batches(test_ds, batch_size):
            placed = pipeline_lib.to_device({"images": raw["images"]}, self.device)
            images = augment_lib.tta_transform(placed["images"], transformation)
            out = predict_step(model, {"images": augment_lib.add_laplace_channel(images)})
            probs = augment_lib.tta_inverse(out["probabilities"], transformation)
            chunks.append(probs[torch.from_numpy(raw["valid"] > 0)])
        return torch.cat(chunks)[: len(test_ds)].cpu().numpy()

    # -- serving ------------------------------------------------------------

    def restore_fold(self, fold: int) -> TrainState:
        """The fold's best exported state (falling back to its latest
        periodic checkpoint), loaded into a template that draws no weights;
        raises if the fold was never trained, and under a process group of
        more than one rank."""
        return self._restore_fold(fold)

    def _restore_fold(self, fold: int, sequence_ok: bool = False) -> TrainState:
        self._require_single_process(sequence_ok)
        return self._checkpointer(fold).restore_best_or_raise(
            self._template_state(), hint=f"train fold {fold} first"
        )

    def serving_fn(self, fold: int, serving_dtype: str = "float32"):
        """``serve(images) -> {"probabilities", "mask"}`` of the fold's best
        state under the serving spec ``serving_dtype`` (``float32``,
        ``bfloat16``, ``int8`` or ``int8-compute``; see
        ``train/quantize.py``), on the trainer's device. Wire contract for
        every spec: float32 in, float32 out. The closure carries its
        manifest ``quantization`` section as ``serve.quantization``."""
        from tensorflowdistributedlearning_tpu_torch.train import quantize, serving

        state = self.restore_fold(fold)
        # the EMA parameters, even when the restore fell back to a periodic
        # (live-trajectory) checkpoint; a best export already holds them
        with state.eval_params() as eval_model:
            weights = {k: v.detach().cpu().clone() for k, v in eval_model.state_dict().items()}
        qstate, section = quantize.quantize_state(weights, serving_dtype, self.model_config)
        model = serving.serving_model(self.model_config, qstate, section, self.device)
        serve = serving.make_serving_fn(
            model, self.device, data_format=self.train_config.data_format,
            act_dtype=quantize.compute_dtype(serving_dtype),
        )
        serve.quantization = section
        return serve

    def export_serving(self, fold: int, directory: Optional[str] = None, serving_dtype: str = "float32") -> str:
        """Write the serving artifact of the fold's best state under the
        spec ``serving_dtype`` (default ``{fold_dir}/export/serving``, or
        ``serving-{spec}`` for the quantized specs, so the float32 reference
        and its candidates sit side by side for quantize-check), the
        artifact ``serve`` and ``InferenceEngine.from_artifact`` load;
        returns its manifest path."""
        from tensorflowdistributedlearning_tpu_torch.train import quantize
        from tensorflowdistributedlearning_tpu_torch.train.serving import export_serving_artifact

        quantize.check_serving_spec(serving_dtype)
        suffix = "serving" if serving_dtype == "float32" else f"serving-{serving_dtype}"
        directory = directory or os.path.join(self._fold_dir(fold), "export", suffix)
        state = self.restore_fold(fold)
        with state.eval_params() as eval_model:
            return export_serving_artifact(
                eval_model,
                self.model_config,
                directory,
                data_format=self.train_config.data_format,
                metadata={"fold": fold, "step": state.step},
                serving_dtype=serving_dtype,
            )


# The reference exposed this as ``class Model``.
Model = Trainer
