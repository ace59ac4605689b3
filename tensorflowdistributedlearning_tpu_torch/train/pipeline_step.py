"""Train and eval steps under pipeline parallelism (counterpart of the JAX
package's ``train/pipeline_step.py``).

The ranks lie on a ``(dp, K)`` grid (``parallel/mesh.py`` with a stage
group): each data position is a K-stage GPipe pipeline
(``parallel/pipeline.py``) whose ranks read the same rows. Two model
families pipeline:

- the ViT: the patch and position embedding run on every stage, the
  ``vit_layers`` blocks go over the stages (stage k holds L/K consecutive
  blocks), the head (final LayerNorm, pool, logits) runs on the pipeline's
  output;
- the Xception-41 classifier: the entry flow runs on every stage, the 8
  middle-flow units go over the stages with BatchNorm per microbatch (the
  GPipe regime), the exit flow, pool, dropout and logits run on the output.

One train step: the local batch's embedding (entry flow) splits into M
microbatches, the fill/drain schedule runs them, the head takes the
pipeline's output on every stage, and the last stage's loss starts the
backward; the other stages join the reverse schedule with no loss of
their own (:func:`pipeline.pipeline_backward`), and stage 0 carries the
gradient on into the embedding (entry flow). Only the stages whose copy
is read compute with gradients: the embedding on stage 0, the head on the
last stage (JAX computes both everywhere and counts the shared leaves
once, ``:24-29``).

The parameters stay whole and replicated: the canonical model's tree, so
checkpoints, serving export and eval are interchangeable with every other
strategy. Stage k's gradient is non-zero only in its own blocks (units),
stage 0's alone in the embedding (entry flow), the last stage's alone in
the head (exit flow), so one sum of the flat gradient over the stage group
assembles the whole gradient, each leaf counted once. The data group's
mean follows, as in the plain step, then the clip and the update.

Xception's BatchNorm: each middle unit's running statistics become the mean
of its M per-microbatch updates (``pipeline_apply_aux``); each stage writes
its own units' and a sum over the stage group of the stacked statistics,
zero outside each stage's slot, fills the rest (JAX ``:321-335``). The entry
and exit flows' statistics come from the whole local batch on every stage.
Then every statistic takes the data group's mean. The exit head's dropout
is keyed by (seed, step, data index, chunk 0), as the plain step keys it,
so every stage draws the same mask and the two strategies draw the same
masks for the same rows.

``local_stages=K`` runs the same step with all K stages in this process
(the one-rank schedule, no collective), which a distributed step is held
against bit for bit. JAX's named scopes ``obs/pipeline_embed``,
``obs/pipeline_entry``, ``obs/pipeline_fill_drain`` and
``obs/pipeline_head`` are ``torch.profiler.record_function`` ranges here.
"""

from __future__ import annotations

from typing import Dict, Optional

import torch
import torch.nn as nn

from tensorflowdistributedlearning_tpu_torch.config import ModelConfig
from tensorflowdistributedlearning_tpu_torch.models import vit as vit_lib
from tensorflowdistributedlearning_tpu_torch.models.layers import dropout_key
from tensorflowdistributedlearning_tpu_torch.parallel import collectives, mesh
from tensorflowdistributedlearning_tpu_torch.parallel import pipeline as pipeline_lib
from tensorflowdistributedlearning_tpu_torch.train.state import pmean_batch_stats
from tensorflowdistributedlearning_tpu_torch.train.step import Metrics, _metric_deltas, dropout_seed

_profile = torch.profiler.record_function


def validate_pipeline_config(config: ModelConfig, pipeline_parallel: int, microbatches: int) -> None:
    """Config-time checks, with the JAX package's texts."""
    if config.backbone not in ("vit", "xception"):
        raise ValueError(
            f"pipeline_parallel does not support backbone={config.backbone!r}: "
            "it requires homogeneous stages (the GPipe runner's regime) — "
            "backbone='vit' (transformer blocks) or backbone='xception' (the "
            "8 identical 728-wide middle-flow units). ResNet's bottleneck "
            "stages change width/stride and cannot pipeline"
        )
    if config.moe_experts:
        raise ValueError(
            "pipeline_parallel and moe_experts cannot combine: MoE blocks "
            "break the homogeneous-stage regime the GPipe runner requires "
            "(dense and MoE blocks have different param shapes)"
        )
    if config.backbone == "xception":
        from tensorflowdistributedlearning_tpu_torch.models.xception import MIDDLE_FLOW_UNITS

        if config.num_classes is None:
            raise ValueError(
                "pipeline_parallel with backbone='xception' supports the "
                "classifier layout only (the segmentation head needs the "
                "atrous end-point dict, which the stage split does not "
                "thread through)"
            )
        if MIDDLE_FLOW_UNITS % pipeline_parallel:
            raise ValueError(
                f"{MIDDLE_FLOW_UNITS} Xception middle-flow units not "
                f"divisible by pipeline_parallel={pipeline_parallel}: stages "
                "must hold equal unit groups (use 2, 4, or 8)"
            )
    elif config.vit_layers % pipeline_parallel:
        raise ValueError(
            f"vit_layers={config.vit_layers} not divisible by "
            f"pipeline_parallel={pipeline_parallel}: stages must hold equal "
            "block groups"
        )
    if microbatches < pipeline_parallel:
        raise ValueError(
            f"pipeline_microbatches={microbatches} < pipeline stages "
            f"{pipeline_parallel}: the fill/drain schedule needs at least one "
            "microbatch per stage (and wants many more — bubble fraction is "
            "(K-1)/(M+K-1))"
        )


def _microbatches(x: torch.Tensor, microbatches: int) -> torch.Tensor:
    """``[B, ...]`` as ``[M, B/M, ...]``; JAX's text when B does not divide."""
    b = x.shape[0]
    if b % microbatches:
        raise ValueError(f"local batch {b} not divisible into {microbatches} microbatches")
    return x.reshape((microbatches, b // microbatches) + tuple(x.shape[1:]))


def _reduce_metrics(metrics: Metrics) -> Metrics:
    """Sum the metric states over the data group, in place (one
    collective). Every stage holds the same states (the head ran on the
    same output), so the stage group's mean, JAX's ``pmean`` over the model
    axis, is the identity."""
    collectives.psum_([t for m in metrics.values() for t in (m.total, m.count)], mesh.data_group())
    return metrics


def _vit_stage_params(model: nn.Module, k: int, group: int):
    """Stage ``k``'s ``group`` blocks stacked for
    ``grouped_pipeline_stage_fn``: ``stack_vit_block_params(...)[k]``,
    stacking only this stage's blocks."""
    named = dict(model.named_parameters())
    return pipeline_lib.stack_stage_params([vit_lib.block_params(named, k * group + i + 1) for i in range(group)])


def _vit_forward(config: ModelConfig, stages: pipeline_lib.Placement, model: nn.Module, stage_fn, microbatches: int,
                 images: torch.Tensor, train: bool):
    """The pipelined ViT: ``(output [M, ...], logits)``. In training the
    embedding has gradients on the first stage only and the head on the
    last only."""
    group = config.vit_layers // stages.k
    with _profile("obs/pipeline_embed"), torch.set_grad_enabled(train and stages.holds_first):
        tokens = vit_lib.embed_tokens(config, model, images)
    x = _microbatches(tokens, microbatches)
    with _profile("obs/pipeline_fill_drain"):
        out = pipeline_lib.pipeline_apply(stage_fn, stages.per_stage(lambda k: _vit_stage_params(model, k, group)), x,
                                          local_stages=stages.local_stages)
    with _profile("obs/pipeline_head"), torch.set_grad_enabled(train and stages.holds_last):
        logits = vit_lib.head_logits(config, model, out.reshape((tokens.shape[0],) + tuple(out.shape[2:])))
    return out, logits


def _backward(stages: pipeline_lib.Placement, loss: torch.Tensor, out: torch.Tensor) -> None:
    """The last stage's loss starts the backward; the other stages join the
    reverse schedule without one."""
    if stages.holds_last:
        loss.backward()
    else:
        pipeline_lib.pipeline_backward(out)


def _assemble_gradient(state, stages: pipeline_lib.Placement) -> None:
    """Sum the flat gradient over the stage group (each leaf non-zero on
    one stage), then the data group's mean."""
    if stages.local_stages is not None:
        return
    collectives.psum_(state.flat_grad, mesh.stage_group())
    collectives.pmean_(state.flat_grad, mesh.data_group())


def make_train_step_pipeline(task, config: ModelConfig, microbatches: int, *, seed: int = 0,
                             local_stages: Optional[int] = None):
    """``step(state, batch) -> (state, metrics)``: the pipeline-parallel
    train step of ``config``'s family (the ViT or the Xception-41
    classifier) over this rank's stage group, the update as the plain
    step's (clip, lr, optimizer, EMA), the metric contributions from the
    pre-update logits summed over the data group. ``seed``
    (``TrainConfig.seed``) keys the Xception head's dropout as
    ``train/step.py`` keys it; the ViT draws nothing."""
    if config.backbone == "xception":
        return _xception_train_step(task, config, microbatches, seed, local_stages)
    return _vit_train_step(task, config, microbatches, local_stages)


def _vit_train_step(task, config: ModelConfig, microbatches: int, local_stages: Optional[int]):
    def step(state, batch: Dict[str, torch.Tensor]):
        stages = pipeline_lib.Placement(local_stages=local_stages)
        stage_fn = vit_lib.grouped_pipeline_stage_fn(config, config.vit_layers // stages.k)
        model = state.model
        model.train()
        state.flatten_grads()
        state.zero_grad()
        out, logits = _vit_forward(config, stages, model, stage_fn, microbatches, batch["images"], True)
        with torch.set_grad_enabled(stages.holds_last):
            loss = task.loss(logits, batch)
        _backward(stages, loss, out)
        _assemble_gradient(state, stages)
        state.apply_gradients()
        with torch.no_grad():
            metrics = _metric_deltas(task.metric_scores(logits.detach(), batch), loss.detach())
        return state, (metrics if local_stages is not None else _reduce_metrics(metrics))

    return step


def _assemble_middle_stats(model: nn.Module, stages: pipeline_lib.Placement) -> None:
    """Every middle unit's running statistics on every stage: the stacked
    statistics, zero outside this stage's slot, summed over the stage group
    (a copy, not a reduction)."""
    from tensorflowdistributedlearning_tpu_torch.models import xception as xc

    if stages.local_stages is not None or stages.k == 1:
        return
    tree = {n: b for n, b in model.backbone.named_buffers() if n.startswith(xc.MIDDLE_FLOW_PREFIX)}
    stacked = xc.stack_middle_unit_tree(tree, stages.k)
    k = stages.mine[0]
    for leaf in stacked.values():
        leaf[:k].zero_()
        leaf[k + 1:].zero_()
    collectives.psum_(list(stacked.values()), mesh.stage_group())
    with torch.no_grad():
        for name, t in xc.unstack_middle_unit_tree(stacked).items():
            tree[name].copy_(t)


def _xception_train_step(task, config: ModelConfig, microbatches: int, seed: int, local_stages: Optional[int]):
    from tensorflowdistributedlearning_tpu_torch.models import xception as xc

    def step(state, batch: Dict[str, torch.Tensor]):
        stages = pipeline_lib.Placement(local_stages=local_stages)
        group = xc.MIDDLE_FLOW_UNITS // stages.k
        stage_fn = xc.grouped_middle_stage_fn(config, group, train=True)
        model = state.model
        model.train()
        entry, head = xc.XceptionEntryFlow(model).train(), xc.XceptionExitHead(model).train()
        units = xc.middle_units(model)
        state.flatten_grads()
        state.zero_grad()
        images = batch["images"]
        # the plain step's key of the exit head's mask: every stage draws the same
        with dropout_key(dropout_seed(seed, state.step, mesh.data_index(), 0)):
            with _profile("obs/pipeline_entry"), torch.set_grad_enabled(stages.holds_first):
                feats = entry(images)
            x = _microbatches(feats, microbatches)
            with _profile("obs/pipeline_fill_drain"):
                out, new_stats = pipeline_lib.pipeline_apply_aux(
                    stage_fn, stages.per_stage(lambda k: units[k * group:(k + 1) * group]), x,
                    local_stages=stages.local_stages)
            local = stages.local_stages is not None
            for k, stats in zip(stages.mine, new_stats if local else [new_stats]):
                xc.set_running_stats(units[k * group:(k + 1) * group], stats)
            with _profile("obs/pipeline_head"), torch.set_grad_enabled(stages.holds_last):
                logits = head(out.reshape((images.shape[0],) + tuple(out.shape[2:])))
                loss = task.loss(logits, batch)
        _backward(stages, loss, out)
        _assemble_middle_stats(model, stages)
        _assemble_gradient(state, stages)
        state.apply_gradients()
        if not local:
            pmean_batch_stats(model)
        with torch.no_grad():
            metrics = _metric_deltas(task.metric_scores(logits.detach(), batch), loss.detach())
        return state, (metrics if local else _reduce_metrics(metrics))

    return step


def make_eval_step_pipeline(task, config: ModelConfig, microbatches: int, *, local_stages: Optional[int] = None):
    """``step(model, batch) -> metrics``: the pipelined forward in
    inference mode (BN on its running statistics, through the fused BN
    kernel on CUDA), per-example losses weighted by ``batch['valid']`` as
    ``make_eval_step``'s, summed over the data group."""
    from tensorflowdistributedlearning_tpu_torch.models import xception as xc

    def step(model: nn.Module, batch: Dict[str, torch.Tensor]) -> Metrics:
        stages = pipeline_lib.Placement(local_stages=local_stages)
        model.eval()
        images = batch["images"]
        with torch.no_grad():
            if config.backbone == "xception":
                group = xc.MIDDLE_FLOW_UNITS // stages.k
                units = xc.middle_units(model)
                x = _microbatches(xc.XceptionEntryFlow(model).eval()(images), microbatches)
                out = pipeline_lib.pipeline_apply(xc.grouped_middle_stage_fn(config, group, train=False),
                                                  stages.per_stage(lambda k: units[k * group:(k + 1) * group]), x,
                                                  local_stages=stages.local_stages)
                logits = xc.XceptionExitHead(model).eval()(out.reshape((images.shape[0],) + tuple(out.shape[2:])))
            else:
                stage_fn = vit_lib.grouped_pipeline_stage_fn(config, config.vit_layers // stages.k)
                _, logits = _vit_forward(config, stages, model, stage_fn, microbatches, images, False)
            loss = task.loss_per_example(logits, batch)
            metrics = _metric_deltas(task.metric_scores(logits, batch), loss, batch.get("valid"))
        return metrics if local_stages is not None else _reduce_metrics(metrics)

    return step
