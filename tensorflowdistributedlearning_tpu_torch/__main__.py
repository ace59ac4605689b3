"""Command line of the PyTorch port (counterpart of the JAX package's
``cli.py``; the port carries ``train``, ``fit``, ``plan``, ``predict``,
``serve``, ``convert``, ``quantize-check``, ``records-index``,
``telemetry-report`` and ``telemetry-top``).

    python -m tensorflowdistributedlearning_tpu_torch train \\
        --data-dir DATA --model-dir MODEL_DIR --batch-size 64 --n-fold 5 --steps 10000 \\
        --export-serving --serving-dtype int8-compute
    torchrun --nproc-per-node 4 -m tensorflowdistributedlearning_tpu_torch train \\
        --data-dir DATA --model-dir MODEL_DIR --batch-size 256 --sync-bn
    python -m tensorflowdistributedlearning_tpu_torch fit \\
        --preset vit_s16_imagenet --model-dir MODEL_DIR --steps 1000 --batch-size 64 --export-serving
    python -m tensorflowdistributedlearning_tpu_torch fit \\
        --preset resnet50_classic_imagenet --data-dir RECORDS --model-dir MODEL_DIR --eval-holdout-fraction 0.1
    python -m tensorflowdistributedlearning_tpu_torch fit \\
        --preset vit_s16_imagenet --model-dir MODEL_DIR --parallelism auto --model-parallel 2
    python -m tensorflowdistributedlearning_tpu_torch plan --preset vit_s16_imagenet --json
    python -m tensorflowdistributedlearning_tpu_torch records-index RECORDS
    python -m tensorflowdistributedlearning_tpu_torch predict \\
        --model-dir MODEL_DIR --test-dir TEST --n-fold 5 --output pred.npz --submission submission.csv
    python -m tensorflowdistributedlearning_tpu_torch predict \\
        --artifact-dir MODEL_DIR/fold0/export/serving --test-dir TEST --output pred.npz
    python -m tensorflowdistributedlearning_tpu_torch convert \\
        --params flax_vars.npz --config cfg.json --out ARTIFACT_DIR --serving-dtype int8-compute
    python -m tensorflowdistributedlearning_tpu_torch convert \\
        --params vit_vars.npz --preset vit_s16_imagenet --out VIT_ARTIFACT_DIR
    python -m tensorflowdistributedlearning_tpu_torch serve \\
        --artifact-dir ARTIFACT_DIR --port 8500 --buckets 1 4 16 64
    python -m tensorflowdistributedlearning_tpu_torch serve \\
        --registry registry.json --workdir WORKDIR --trace-sample-rate 0.01 --slo-p99-ms 50
    python -m tensorflowdistributedlearning_tpu_torch quantize-check \\
        --reference-dir F32_ARTIFACT --candidate-dir INT8_ARTIFACT
    python -m tensorflowdistributedlearning_tpu_torch telemetry-report MODEL_DIR [--json]
    python -m tensorflowdistributedlearning_tpu_torch telemetry-report --compare RUN_A RUN_B
    python -m tensorflowdistributedlearning_tpu_torch telemetry-top WORKDIR --once
"""

from __future__ import annotations

import argparse
import json
import os
import sys
from typing import List, Optional

from tensorflowdistributedlearning_tpu_torch.train.quantize import SERVING_SPECS


def _best_fold(results: List[dict]) -> int:
    """The fold a deployment would serve: highest mean IoU."""
    return max(range(len(results)), key=lambda i: results[i].get("metrics/mean_iou", float("-inf")))


def cmd_train(args) -> int:
    """K-fold training, on one device or data-parallel over the ranks of a
    process group (``torchrun``, or the explicit ``--coordinator-address``
    / ``--num-processes`` / ``--process-id`` on every rank; ``--device
    cpu`` ranks use gloo); rank 0 prints one JSON line with the folds'
    final eval metrics and ``n_params`` (and the exported artifact with
    ``--export-serving``, single-process only)."""
    from tensorflowdistributedlearning_tpu_torch.config import TrainConfig
    from tensorflowdistributedlearning_tpu_torch.data import pipeline as pipeline_lib
    from tensorflowdistributedlearning_tpu_torch.parallel import multihost
    from tensorflowdistributedlearning_tpu_torch.train.trainer import Trainer

    multihost.initialize(
        args.coordinator_address, args.num_processes, args.process_id, backend=multihost.backend_for(args.device)
    )
    if args.export_serving and multihost.process_count() > 1:
        print("--export-serving runs single-process: export the trained model_dir from a single-process "
              "session", file=sys.stderr)
        return 2
    ids = pipeline_lib.discover_ids(args.data_dir)
    if not ids:
        print(f"No images found under {args.data_dir}/images", file=sys.stderr)
        return 1
    tcfg = TrainConfig(
        lr=args.lr,
        n_folds=args.n_fold,
        seed=args.seed,
        save_best=args.save_best,
        checkpoint_every_steps=args.checkpoint_every,
        eval_throttle_secs=args.eval_throttle_secs,
        n_devices=args.n_devices,
        sync_batch_norm=args.sync_bn,
        model_parallel=args.model_parallel,
        sequence_parallel=args.sequence_parallel,
        weight_update_sharding=args.weight_update_sharding,
        parallelism=args.parallelism,
        hbm_budget_gb=args.hbm_budget_gb,
        **_loop_overrides(args),
    )
    model_kwargs = dict(
        input_shape=tuple(args.input_shape),
        n_blocks=tuple(args.n_blocks),
        base_depth=args.base_depth,
        backbone=args.backbone,
        use_pallas_depthwise=args.use_pallas_depthwise,
        block_type=args.block_type,
        dtype=args.dtype,
    )
    plan_header = None
    if tcfg.parallelism == "auto":
        # derive the layout before the Trainer lays out its ranks; the
        # flags set explicitly stay pinned
        import dataclasses

        from tensorflowdistributedlearning_tpu_torch.config import ModelConfig
        from tensorflowdistributedlearning_tpu_torch.parallel import planner as planner_lib

        pinned = {}
        if args.sequence_parallel != 1:
            pinned["sequence_parallel"] = args.sequence_parallel
        if args.model_parallel != 1:
            pinned["model_parallel"] = args.model_parallel
        if args.weight_update_sharding:
            pinned["weight_update_sharding"] = True
        run_plan = planner_lib.plan(ModelConfig(**model_kwargs), tcfg, args.batch_size, pinned=pinned, source="auto",
                                    device=args.device)
        tcfg = dataclasses.replace(tcfg, **run_plan.overrides())
        plan_header = run_plan.header()
    trainer = Trainer(args.model_dir, args.data_dir, train_config=tcfg, device=args.device, plan=plan_header,
                      **model_kwargs)
    results = trainer.train(ids, batch_size=args.batch_size, steps=args.steps)
    out = {"folds": results, "n_params": trainer.params}
    if args.export_serving and results:
        fold = _best_fold(results)
        out["serving_fold"] = fold
        out["serving_artifact"] = os.path.dirname(trainer.export_serving(fold, serving_dtype=args.serving_dtype))
        out["serving_dtype"] = args.serving_dtype
        _stamp_baseline(out["serving_artifact"], args.device)
    if multihost.is_main():
        print(json.dumps(out))
    return 0


def _stamp_baseline(artifact_dir: str, device) -> None:
    """Stamp a fresh export's ``drift_baseline`` (``serve --drift-threshold``
    reads it). A fault of the artifact's files is logged and the export
    survives; any other failure (a kernel's, say) propagates."""
    import logging

    from tensorflowdistributedlearning_tpu_torch.serve.quant_check import stamp_drift_baseline

    try:
        stamp_drift_baseline(artifact_dir, device=device)
    except (OSError, ValueError, KeyError) as e:
        logging.getLogger(__name__).warning("drift-baseline stamp failed for %s: %s", artifact_dir, e)


def cmd_fit(args) -> int:
    """Classification training of a named preset (``train/fit.py``) on the
    record shards or ImageFolder split of ``--data-dir``, or on synthetic
    data without one; rank 0 prints one JSON line
    with ``preset``, ``steps``, ``n_params``, ``final_metrics`` and, with
    ``--export-serving`` (single-process only), ``serving_artifact``."""
    from tensorflowdistributedlearning_tpu_torch.parallel import multihost
    from tensorflowdistributedlearning_tpu_torch.train.fit import fit_preset

    multihost.initialize(
        args.coordinator_address, args.num_processes, args.process_id, backend=multihost.backend_for(args.device)
    )
    if args.export_serving and multihost.process_count() > 1:
        print("--export-serving runs single-process: export the trained model_dir from a single-process "
              "run", file=sys.stderr)
        return 2
    result = fit_preset(
        args.preset,
        args.model_dir,
        data_dir=args.data_dir,
        steps=args.steps,
        batch_size=args.batch_size,
        eval_every_steps=args.eval_every,
        export_serving=args.serving_dtype if args.export_serving else None,
        device=args.device,
        optimizer=args.optimizer,
        lr=args.lr,
        augmentation=args.augmentation,
        ema_decay=args.ema_decay,
        grad_clip_norm=args.grad_clip,
        grad_accum_steps=args.grad_accum,
        eval_holdout_fraction=args.eval_holdout_fraction,
        model_parallel=args.model_parallel,
        pipeline_parallel=args.pipeline_parallel,
        pipeline_microbatches=args.pipeline_microbatches,
        expert_parallel=args.expert_parallel,
        sequence_parallel=args.sequence_parallel,
        weight_update_sharding=args.weight_update_sharding,
        data_service_workers=args.data_workers,
        prefetch_depth=args.prefetch_depth,
        dispatch_ahead_steps=args.dispatch_ahead,
        trace_sample_rate=args.trace_sample_rate,
        nan_guard=args.nan_guard,
        profile_every_windows=args.profile_every_windows,
        parallelism=args.parallelism,
        hbm_budget_gb=args.hbm_budget_gb,
    )
    summary = {"preset": args.preset, "steps": result.steps, "n_params": result.n_params,
               "final_metrics": result.final_metrics}
    if result.serving_artifact:
        summary["serving_artifact"] = result.serving_artifact
        _stamp_baseline(result.serving_artifact, args.device)
    if multihost.is_main():
        print(json.dumps(summary))
    return 0


def cmd_plan(args) -> int:
    """Print the parallelism planner's candidate table (or the full JSON
    plan): how ``--parallelism auto`` would lay this model out on this
    topology, with exact predicted bytes per device and a named reason for
    every rejected candidate. Exit status: 0 a feasible layout exists, 1 the
    planner found none (or the pinned layout is infeasible), 2 usage."""
    import dataclasses

    from tensorflowdistributedlearning_tpu_torch.config import ModelConfig, TrainConfig
    from tensorflowdistributedlearning_tpu_torch.parallel import multihost
    from tensorflowdistributedlearning_tpu_torch.parallel import planner as planner_lib

    multihost.initialize(
        args.coordinator_address, args.num_processes, args.process_id, backend=multihost.backend_for(args.device)
    )
    if args.preset:
        from tensorflowdistributedlearning_tpu_torch.configs import get_preset

        try:
            preset = get_preset(args.preset)
        except ValueError as e:
            print(f"plan: {e}", file=sys.stderr)
            return 2
        mcfg, tcfg = preset.model, preset.train
        batch = args.batch_size or preset.global_batch
    else:
        mcfg = ModelConfig(
            backbone=args.backbone,
            input_shape=tuple(args.input_shape),
            n_blocks=tuple(args.n_blocks),
            base_depth=args.base_depth,
            block_type=args.block_type,
            dtype=args.dtype,
            num_classes=args.num_classes,
        )
        tcfg = TrainConfig()
        batch = args.batch_size or 64
    replace = {"n_devices": args.n_devices}
    if args.grad_accum is not None:
        replace["grad_accum_steps"] = args.grad_accum
    if args.hbm_gb is not None:
        replace["hbm_budget_gb"] = args.hbm_gb
    # the preset's own layout stripped: the table shows what auto picks,
    # with only the flags given pinned on top
    replace.update(model_parallel=1, pipeline_parallel=1, sequence_parallel=1, expert_parallel=1,
                   weight_update_sharding=False)
    tcfg = dataclasses.replace(tcfg, **replace)
    pinned = {
        key: value
        for key, value in (
            ("model_parallel", args.model_parallel),
            ("pipeline_parallel", args.pipeline_parallel),
            ("sequence_parallel", args.sequence_parallel),
            ("expert_parallel", args.expert_parallel),
            ("weight_update_sharding", args.weight_update_sharding),
        )
        if value is not None
    }
    margin = None
    if args.measured_margin_from:
        margin = planner_lib.measured_margin_from_workdir(args.measured_margin_from)
        if margin is None:
            print(f"plan: no measured watermark residual under {args.measured_margin_from} (CPU backends ledger "
                  "none) — planning without margin", file=sys.stderr)
    measured_costs = None
    if args.measured_costs_from:
        measured_costs = planner_lib.measured_costs_from_workdir(args.measured_costs_from)
        if measured_costs is None:
            print(f"plan: no op_roofline events under {args.measured_costs_from} — run with "
                  "--profile-every-windows N to ledger roofline captures, then re-plan", file=sys.stderr)
            return 2
    try:
        result = planner_lib.plan(mcfg, tcfg, batch, pinned=pinned, measured_margin_bytes=margin,
                                  measured_costs=measured_costs, device=args.device)
    except planner_lib.PlanError as e:
        print(f"plan: {e}", file=sys.stderr)
        return 1
    print(json.dumps(result.to_json()) if args.json else planner_lib.render_plan_table(result))
    return 0 if result.chosen.feasible else 1


def cmd_records_index(args) -> int:
    """Write the ``.idx`` count/offset sidecar of every shard matching
    ``--glob`` under the directory; prints one line per shard, then one
    JSON line of totals."""
    import glob

    from tensorflowdistributedlearning_tpu_torch.data import records as records_lib

    paths = sorted(glob.glob(os.path.join(args.data_dir, args.glob)))
    if not paths:
        print(f"no shards matching {args.glob!r} under {args.data_dir}", file=sys.stderr)
        return 1
    total = 0
    for path in paths:
        n = len(records_lib.write_shard_index(path))
        total += n
        print(f"{records_lib.shard_index_path(path)}: {n} record(s)")
    print(json.dumps({"shards": len(paths), "records": total}))
    return 0


_LOOP_FLAGS = (
    ("data_workers", "data_service_workers"),
    ("prefetch_depth", "prefetch_depth"),
    ("dispatch_ahead", "dispatch_ahead_steps"),
    ("trace_sample_rate", "trace_sample_rate"),
    ("nan_guard", "nan_guard"),
    ("profile_every_windows", "profile_every_windows"),
)


def cmd_telemetry_report(args) -> int:
    """The goodput report of a workdir's run ledgers (``obs/report.py``),
    and the front door of the cross-run registry and run-vs-run compare
    (``obs/compare.py``): JAX's ``cmd_telemetry_report``. rc 2 for a
    missing workdir or ledger, 1 for a ``ValueError``."""
    from tensorflowdistributedlearning_tpu_torch.obs import compare as compare_lib
    from tensorflowdistributedlearning_tpu_torch.obs.report import report_workdir

    try:
        if args.compare:
            ref_a, ref_b = args.compare
            result = compare_lib.compare_workdirs(ref_a, ref_b, registry_dir=args.registry_dir)
            print(json.dumps(result) if args.json else compare_lib.render_compare(result))
            return 0
        if args.workdir is None:
            print("telemetry-report: a workdir is required unless --compare is given", file=sys.stderr)
            return 2
        if args.export_trace:
            from tensorflowdistributedlearning_tpu_torch.obs.trace import write_chrome_trace

            # raises the no-ledger FileNotFoundError itself
            n = write_chrome_trace(args.workdir, args.export_trace)
            print(json.dumps({"written": args.export_trace, "span_events": n}))
            return 0
        if args.register:
            if not args.registry_dir:
                print("telemetry-report: --register requires --registry-dir", file=sys.stderr)
                return 2
            print(json.dumps(compare_lib.register_run(args.registry_dir, args.workdir)))
            return 0
        kwargs = {}
        if args.straggler_threshold is not None:
            kwargs["straggler_threshold"] = args.straggler_threshold
        print(report_workdir(args.workdir, trace_dir=args.trace_dir, top=args.top, as_json=args.json, **kwargs))
    except FileNotFoundError as e:
        print(f"telemetry-report: {e}", file=sys.stderr)
        return 2
    except ValueError as e:
        print(f"telemetry-report: {e}", file=sys.stderr)
        return 1
    return 0


def cmd_telemetry_top(args) -> int:
    """The live console over a workdir's merged ledgers (``obs/top.py``);
    ``--once`` prints one frame."""
    from tensorflowdistributedlearning_tpu_torch.obs.top import top

    return top(args.workdir, interval_s=args.interval, once=args.once)


def _loop_overrides(args) -> dict:
    """The ``TrainConfig`` fields of the host-loop and observability flags
    that were given (the config's defaults stay the single source)."""
    return {field: getattr(args, flag) for flag, field in _LOOP_FLAGS if getattr(args, flag) is not None}


def _add_host_loop(p: argparse.ArgumentParser) -> None:
    """The host-loop and observability flags of ``train`` and ``fit`` (the
    JAX CLI's); None keeps the config's value."""
    p.add_argument("--data-workers", type=int, default=None,
                   help="workers of the streaming data service (data/service.py) that read, decode and assemble "
                   "the train batches; batch content does not depend on the count. 0 = the in-line streams "
                   "(default: the config's, 2)")
    p.add_argument("--prefetch-depth", type=int, default=None,
                   help="host-to-device input prefetch depth (>= 1; default: the config's, 2)")
    p.add_argument("--dispatch-ahead", type=int, default=None,
                   help="launch at most this many train steps ahead of the card, each log window's metrics "
                   "fetched one window late; 0 = the synchronous loop (numerics identical either way; default: "
                   "the config's, 2)")
    p.add_argument("--trace-sample-rate", type=float, default=None,
                   help="fraction of train steps, eval passes and checkpoints persisted as `trace` ledger "
                   "events; 0 disables (the config's default)")
    p.add_argument("--nan-guard", choices=("warn", "abort", "off"), default=None,
                   help="non-finite loss guard: warn (alert and go on), abort (alert, write the final "
                   "checkpoint, stop), off; default: the config's (warn)")
    p.add_argument("--profile-every-windows", type=int, default=None,
                   help="capture a torch.profiler trace of a few train steps every N log windows and ledger "
                   "profile_capture / op_roofline events; 0 disables (the config's default)")


def _add_planner(p: argparse.ArgumentParser) -> None:
    """The layout-selection flags of ``train`` and ``fit``
    (``parallel/planner.py``)."""
    p.add_argument("--parallelism", choices=("explicit", "auto"), default="explicit",
                   help="'auto' derives the whole (dp, tp, pp, spatial, zero1) layout from the model's exact "
                   "param/opt-state accounting, the per-device memory budget and the topology "
                   "(parallel/planner.py); any parallelism flag set explicitly stays pinned. 'explicit' (default) "
                   "runs the flags as given, validated through the same planner. Either way the plan rides the "
                   "run header; inspect the candidates with the plan command")
    p.add_argument("--hbm-budget-gb", type=float, default=None,
                   help="per-device memory budget in GiB for the planner's feasibility gate (default: the card's "
                   "memory over the ranks that share it; CPU ranks report none)")


def _add_process_group(p: argparse.ArgumentParser) -> None:
    """The explicit process-group flags (``torchrun``'s environment is
    discovered without them)."""
    p.add_argument("--coordinator-address", default=None, metavar="HOST:PORT",
                   help="join an explicit process group at this address (tcp://HOST:PORT or file://PATH also "
                   "taken); torchrun's environment is discovered without it")
    p.add_argument("--num-processes", type=int, default=None, help="world size of the explicit process group")
    p.add_argument("--process-id", type=int, default=None, help="this process's rank in the explicit group")


def _predict_from_artifact(args) -> int:
    """``predict --artifact-dir``: inference through the bucketed serve
    engine from an exported artifact, with the manifest's preprocessing
    contract (normalized images, the Laplacian channel when the artifact
    takes two channels, NCHW when it was exported so) and no checkpoint."""
    import numpy as np
    import torch

    from tensorflowdistributedlearning_tpu_torch.data import augment as augment_lib
    from tensorflowdistributedlearning_tpu_torch.data import pipeline as pipeline_lib
    from tensorflowdistributedlearning_tpu_torch.serve import InferenceEngine
    from tensorflowdistributedlearning_tpu_torch.train import serving as serving_lib

    engine = InferenceEngine.from_artifact(args.artifact_dir, device=args.device)
    manifest = serving_lib.read_manifest(args.artifact_dir)
    nchw = manifest.get("data_format") == "NCHW"
    channels = manifest["input_shape"][1 if nchw else -1]

    test_ds = pipeline_lib.InMemoryDataset.from_directory(args.test_dir, with_masks=False)
    images = test_ds.images  # [N, H, W, 1] normalized
    if channels == 2:  # the segmentation contract: image + Laplacian channel
        images = augment_lib.add_laplace_channel(torch.from_numpy(images)).numpy()
    if nchw:
        images = np.transpose(images, (0, 3, 1, 2))

    step = engine.max_batch_size
    chunks = [engine.infer(images[i : i + step]) for i in range(0, len(images), step)]
    outputs = {k: np.concatenate([c[k] for c in chunks]) for k in chunks[0]}
    if args.submission and "mask" in outputs:
        from tensorflowdistributedlearning_tpu_torch.data.kaggle import write_submission

        write_submission(args.submission, test_ds.ids, outputs["mask"])
    if args.output:
        np.savez(args.output, ids=np.asarray(test_ds.ids), **outputs)
        print(json.dumps({"written": args.output, "n": len(test_ds.ids)}))
    else:
        summary = {
            "n": len(test_ds.ids),
            "outputs": {k: list(v.shape) for k, v in outputs.items()},
            "bucket_hits": {str(b): n for b, n in engine.bucket_hits.items()},
        }
        if "mask" in outputs:
            summary["mean_mask_coverage"] = float(outputs["mask"].mean())
        print(json.dumps(summary))
    return 0


def cmd_predict(args) -> int:
    """Fold x TTA ensemble prediction from the fold checkpoints under
    ``--model-dir`` (or, with ``--artifact-dir``, one exported artifact
    through the serve engine); prints one JSON line."""
    import numpy as np

    from tensorflowdistributedlearning_tpu_torch.config import TrainConfig
    from tensorflowdistributedlearning_tpu_torch.train.trainer import Trainer

    if args.artifact_dir:
        return _predict_from_artifact(args)
    trainer = Trainer(
        args.model_dir,
        "",
        train_config=TrainConfig(n_folds=args.n_fold),
        device=args.device,
        input_shape=tuple(args.input_shape),
        n_blocks=tuple(args.n_blocks),
        base_depth=args.base_depth,
        backbone=args.backbone,
        use_pallas_depthwise=args.use_pallas_depthwise,
        block_type=args.block_type,
        dtype=args.dtype,
    )
    pred = trainer.predict(args.test_dir, batch_size=args.batch_size, tta=not args.no_tta)
    if args.submission:
        from tensorflowdistributedlearning_tpu_torch.data.kaggle import write_submission

        write_submission(args.submission, pred["ids"], pred["masks"])
    if args.output:
        np.savez(args.output, ids=np.asarray(pred["ids"]), probabilities=pred["probabilities"], masks=pred["masks"])
        print(json.dumps({"written": args.output, "n": len(pred["ids"])}))
    else:
        print(json.dumps({"n": len(pred["ids"]), "mean_mask_coverage": float(pred["masks"].mean())}))
    return 0


def cmd_convert(args) -> int:
    """Flax variables (.npz of ``params/...`` and ``batch_stats/...``) plus a
    ModelConfig (a JSON file, or a preset's model) -> a serving artifact of
    the port: the segmenter or the ViT classifier."""
    import torch

    from tensorflowdistributedlearning_tpu_torch.config import ModelConfig
    from tensorflowdistributedlearning_tpu_torch.configs import get_preset
    from tensorflowdistributedlearning_tpu_torch.models import model_for
    from tensorflowdistributedlearning_tpu_torch.train.serving import export_serving_artifact
    from tensorflowdistributedlearning_tpu_torch.utils.convert import from_flax, load_flax_npz

    if (args.config is None) == (args.preset is None):
        print("convert: give exactly one of --config and --preset", file=sys.stderr)
        return 2
    if args.preset is not None:
        config = get_preset(args.preset).model
    else:
        with open(args.config) as f:
            config = ModelConfig.from_json(f.read())
    params, stats = load_flax_npz(args.params)
    state = from_flax(params, stats, config)
    with torch.device("meta"):
        model = model_for(config)
    model.load_state_dict(state, strict=True, assign=True)
    path = export_serving_artifact(
        model, config, args.out, data_format=args.data_format, serving_dtype=args.serving_dtype
    )
    print(json.dumps({"artifact": args.out, "manifest": path, "tensors": len(state),
                      "serving_dtype": args.serving_dtype}))
    return 0


def cmd_quantize_check(args) -> int:
    """The float32-vs-quantized accuracy gate (serve/quant_check.py): prints
    the verdict record as one JSON line; the exit status is the gate."""
    from tensorflowdistributedlearning_tpu_torch.serve.quant_check import run_quant_check

    result = run_quant_check(
        args.reference_dir,
        args.candidate_dir,
        batch_size=args.batch_size,
        seed=args.seed,
        thresholds={
            "max_abs_delta": args.max_abs_delta,
            "mean_abs_delta": args.mean_abs_delta,
            "min_iou": args.min_iou,
            "max_disagree": args.max_disagree,
        },
        allow_fingerprint_mismatch=args.allow_fingerprint_mismatch,
        device=args.device,
    )
    print(json.dumps(result))
    return 0 if result["passed"] else 1


def _drift_monitor(args, artifact_dir: str):
    """The primary model's DriftMonitor under ``--drift-threshold``, or None
    (with a warning) when its manifest has no usable baseline."""
    import logging

    from tensorflowdistributedlearning_tpu_torch.obs import health as health_lib
    from tensorflowdistributedlearning_tpu_torch.train import serving as serving_lib

    baseline = serving_lib.read_manifest(artifact_dir).get("drift_baseline")
    if not baseline:
        logging.getLogger(__name__).warning(
            "serve: --drift-threshold set but %s carries no drift_baseline — export with train/fit "
            "--export-serving to stamp one; drift monitoring disabled", artifact_dir,
        )
        return None
    try:
        return health_lib.DriftMonitor(
            baseline, threshold=args.drift_threshold, min_requests=args.drift_min_requests,
            sustain_windows=args.drift_sustain_windows,
        )
    except ValueError as e:
        logging.getLogger(__name__).warning("serve: drift monitoring disabled: %s", e)
        return None


def cmd_serve(args) -> int:
    """Serve an artifact, or every model of a ``registry.json``, over HTTP:
    warm the buckets, run a micro-batcher per model behind /v1/predict,
    ledger windows into ``{workdir}/telemetry.jsonl`` (JAX's
    ``telemetry-report`` renders it), drain on SIGINT/SIGTERM."""
    import signal

    if not args.artifact_dir and not args.registry:
        print("serve: one of --artifact-dir or --registry is required", file=sys.stderr)
        return 2
    if args.visible_devices:
        # before CUDA initialises: the ordinals this replica may claim
        os.environ["CUDA_VISIBLE_DEVICES"] = args.visible_devices

    from tensorflowdistributedlearning_tpu_torch.obs.metrics import MetricsRegistry
    from tensorflowdistributedlearning_tpu_torch.obs.telemetry import Telemetry
    from tensorflowdistributedlearning_tpu_torch.resilience import faults
    from tensorflowdistributedlearning_tpu_torch.serve import (
        InferenceEngine,
        MicroBatcher,
        ServingServer,
        bind_ephemeral,
    )
    from tensorflowdistributedlearning_tpu_torch.serve.registry import DEFAULT_MODEL, ModelEntry, read_registry

    if args.registry:
        registry = read_registry(os.path.dirname(os.path.abspath(args.registry)), path=args.registry)
        entries = list(registry.models.values())
        if args.model:
            entries = [registry.entry(args.model)]
        versioned = True
    else:
        entries = [ModelEntry(name=args.model or DEFAULT_MODEL, artifact_dir=args.artifact_dir,
                              version=args.model_version or 1, prewarm_budget=args.prewarm_buckets)]
        versioned = args.model_version is not None
    # bound before the telemetry, so that the run header carries the real port
    sock = bind_ephemeral(args.host, args.port)
    port = sock.getsockname()[1]
    workdir = args.workdir or args.artifact_dir or os.path.dirname(os.path.abspath(args.registry))
    run_info = {
        "kind": "serve",
        "replica": args.replica_id,
        "artifact_dir": args.artifact_dir,
        "buckets": list(args.buckets),
        "max_wait_ms": args.max_wait_ms,
        "queue_size": args.queue_size,
        "port": port,
        "endpoint": f"http://{args.host}:{port}",
    }
    if args.model:
        run_info["model"] = args.model
    if args.registry:
        run_info["models"] = {e.name: e.version for e in entries}
    if args.visible_devices:
        run_info["visible_devices"] = args.visible_devices
    telemetry = Telemetry(workdir, trace_sample_rate=args.trace_sample_rate, process_index=args.replica_id,
                          run_info=run_info, device=args.device)
    if args.inject_fault:
        faults.install(args.inject_fault, seed=args.seed)
    capture = drift = None
    if args.capture_dir:
        from tensorflowdistributedlearning_tpu_torch.loop.capture import TrafficCapture

        capture = TrafficCapture(args.capture_dir, sample_fraction=args.capture_fraction,
                                 records_per_shard=args.capture_records_per_shard,
                                 quota_bytes=int(args.capture_quota_mb * (1 << 20)))
    if args.drift_threshold is not None:
        drift = _drift_monitor(args, entries[0].artifact_dir)
    # the primary model rides the telemetry's registry; later tenants own theirs
    engines = [
        InferenceEngine.from_artifact(
            e.artifact_dir, device=args.device, buckets=e.buckets or tuple(args.buckets),
            registry=telemetry.registry if i == 0 else MetricsRegistry(), tracer=telemetry.tracer,
        )
        for i, e in enumerate(entries)
    ]
    warmup = {}
    for e, engine in zip(entries, engines):
        timings = engine.warmup(telemetry, budget=e.prewarm_budget, mark_warm=False)
        warmup.update({(f"{e.name}/{b}" if args.registry else str(b)): s for b, s in timings.items()})
    telemetry.mark_warm()

    def batcher(engine):
        return MicroBatcher(engine, max_wait_ms=args.max_wait_ms, max_queue=args.queue_size,
                            default_deadline_ms=args.default_deadline_ms)

    first = entries[0]
    server = ServingServer(
        engines[0], batcher(engines[0]), telemetry=telemetry, window_secs=args.window_secs,
        slo_p99_ms=first.slo_p99_ms if first.slo_p99_ms is not None else args.slo_p99_ms,
        slo_error_budget=first.slo_error_budget if first.slo_error_budget is not None else args.slo_error_budget,
        replica_id=args.replica_id, sock=sock, model=first.name,
        registry_version=first.version if versioned else None, capture=capture, drift_monitor=drift,
    )
    for e, engine in zip(entries[1:], engines[1:]):
        server.add_model(e.name, engine, batcher(engine), version=e.version, slo_p99_ms=e.slo_p99_ms,
                         slo_error_budget=e.slo_error_budget if e.slo_error_budget is not None else 0.01)
    server.start()
    ready = {
        "serving": server.url,
        "port": server.port,
        "replica": args.replica_id,
        "buckets": list(server.engine.buckets),
        "warmup_s": warmup,
        "ledger": workdir,
    }
    if args.registry or args.model:
        ready["models"] = {e.name: e.version for e in entries}
    print(json.dumps(ready), flush=True)
    server.install_signal_handlers((signal.SIGINT, signal.SIGTERM))
    try:
        server.wait()
    finally:
        server.shutdown()
        faults.uninstall()
    return 0


def _add_model_args(p: argparse.ArgumentParser) -> None:
    """The segmenter's model flags shared by ``train`` and ``predict`` (the
    JAX CLI's shared model arguments)."""
    p.add_argument("--input-shape", type=int, nargs=2, default=(101, 101))
    p.add_argument("--n-blocks", type=int, nargs="+", default=(3, 4, 6))
    p.add_argument("--base-depth", type=int, default=256)
    p.add_argument("--backbone", choices=("resnet", "xception"), default="resnet")
    p.add_argument("--block-type", choices=("bottleneck", "basic_block"), default="bottleneck")
    p.add_argument("--dtype", choices=("float32", "bfloat16"), default="float32",
                   help="compute dtype (parameters, loss and metrics stay float32)")


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(prog="python -m tensorflowdistributedlearning_tpu_torch")
    sub = p.add_subparsers(dest="command", required=True)

    t = sub.add_parser("train", help="K-fold cross-validated training, on one device or data-parallel")
    t.add_argument("--data-dir", required=True, help="directory with images/*.png and masks/*.png")
    t.add_argument("--model-dir", required=True)
    t.add_argument("--batch-size", type=int, default=64)
    t.add_argument("--n-fold", type=int, default=5)
    t.add_argument("--seed", type=int, default=42)
    _add_model_args(t)
    t.add_argument("--lr", type=float, default=0.001)
    t.add_argument("--steps", type=int, default=10_000)
    t.add_argument("--save-best", type=int, default=5)
    t.add_argument("--checkpoint-every", type=int, default=500)
    t.add_argument("--eval-throttle-secs", type=int, default=300)
    t.add_argument("--export-serving", action="store_true",
                   help="after training, export the best fold's serving artifact ({fold_dir}/export/serving)")
    t.add_argument("--serving-dtype", choices=SERVING_SPECS, default="float32",
                   help="post-training precision spec of --export-serving (train/quantize.py): bfloat16 casts "
                   "the weights, int8 stores conv filters as int8 with per-channel symmetric scales, "
                   "int8-compute stores the same bytes and runs eligible convs in int8 arithmetic; "
                   "quantized specs export to {fold_dir}/export/serving-{spec}")
    t.add_argument("--use-pallas-depthwise", action="store_true",
                   help="route the depthwise convs through the hand-written kernels (forward, dx, dw)")
    t.add_argument("--device", default=None,
                   help="torch device (default: cuda, this rank's GPU in a process group; no CPU fallback); "
                   "cpu ranks use gloo")
    t.add_argument("--n-devices", type=int, default=None,
                   help="the world size the run expects (default: whatever the launcher set up); a rank owns "
                   "one device")
    t.add_argument("--sync-bn", action="store_true",
                   help="synchronized BatchNorm: training statistics over the global batch instead of per rank")
    t.add_argument("--model-parallel", type=int, default=1,
                   help="tensor parallelism: shard the parameters, BN statistics and optimizer state over this many "
                   "ranks per replica (channel slices; the K-fold trainer keeps per-replica BatchNorm)")
    t.add_argument("--sequence-parallel", type=int, default=1,
                   help="spatial (sequence) parallelism: shard every image's rows over this many ranks per replica "
                   "(halo-exchange convolutions, BatchNorm over the group; the input height must divide by "
                   "output_stride x this)")
    t.add_argument("--weight-update-sharding", action="store_true",
                   help="ZeRO-1: shard the optimizer state and the weight update over the data-parallel ranks "
                   "(per-rank optimizer bytes drop ~world-fold; the update's numerics are the replicated one's)")
    _add_host_loop(t)
    _add_planner(t)
    _add_process_group(t)
    t.set_defaults(fn=cmd_train)

    f = sub.add_parser("fit", help="single-run classification training from a named preset")
    f.add_argument("--preset", required=True)
    f.add_argument("--model-dir", required=True)
    f.add_argument("--data-dir", default=None,
                   help="record shards ({split}-*.tfrecord) or an ImageFolder split (train/, val/); omitted: "
                   "synthetic data")
    f.add_argument("--steps", type=int, default=100)
    f.add_argument("--batch-size", type=int, default=None, help="global batch (default: the preset's)")
    f.add_argument("--eval-every", type=int, default=None)
    f.add_argument("--optimizer", choices=("adam", "sgd", "lars"), default=None,
                   help="override the preset's optimizer; requires --lr when it differs from the preset's pairing")
    f.add_argument("--lr", type=float, default=None, help="override the preset's learning rate")
    f.add_argument("--augmentation", choices=("flip_crop", "crop", "none", "mixup", "cutmix"), default=None,
                   help="override the preset's train augmentation policy")
    f.add_argument("--ema-decay", type=float, default=None,
                   help="track a parameter EMA at this decay and evaluate/export the averaged weights; 0 disables")
    f.add_argument("--grad-clip", type=float, default=None,
                   help="clip gradients to this global l2 norm before the update; 0 disables")
    f.add_argument("--grad-accum", type=int, default=None,
                   help="accumulate gradients over this many sequential microbatches per step (one optimizer "
                   "update on their mean; the per-rank batch must divide)")
    f.add_argument("--eval-holdout-fraction", type=float, default=None,
                   help="with record shards and no val split: hold out this fraction of train shards as the eval "
                   "split")
    f.add_argument("--model-parallel", type=int, default=None,
                   help="tensor parallelism: shard the parameters, BN statistics and optimizer state over this many "
                   "ranks per replica (BatchNorm statistics over the global batch; default: the preset's)")
    f.add_argument("--pipeline-parallel", type=int, default=None,
                   help="GPipe pipeline parallelism over ViT blocks or the Xception-41 classifier's middle flow: "
                   "this many stages per replica, a rank each (default: the preset's)")
    f.add_argument("--pipeline-microbatches", type=int, default=None,
                   help="microbatches per local batch for the pipeline schedule (default: one per stage; set >> "
                   "stages to shrink the fill/drain bubble)")
    f.add_argument("--expert-parallel", type=int, default=None,
                   help="expert parallelism for MoE presets: one expert per rank with all-to-all dispatch (must "
                   "equal the preset's moe_experts; default: the preset's, every expert local)")
    f.add_argument("--sequence-parallel", type=int, default=None,
                   help="spatial (sequence) parallelism: shard every image's rows over this many ranks per replica "
                   "(halo-exchange convolutions; ring attention for the ViT presets; default: the preset's)")
    f.add_argument("--weight-update-sharding", action="store_true", default=None,
                   help="ZeRO-1: shard the optimizer state and the weight update over the data-parallel ranks "
                   "(default: the preset's; resnet50_bf16_8k sets it)")
    _add_host_loop(f)
    f.add_argument("--export-serving", action="store_true",
                   help="after training, export the best state's serving artifact ({model_dir}/export/serving)")
    f.add_argument("--serving-dtype", choices=SERVING_SPECS, default="float32",
                   help="precision spec of --export-serving (quantized specs export to export/serving-{spec})")
    f.add_argument("--device", default=None,
                   help="torch device (default: cuda, this rank's GPU in a process group; no CPU fallback); "
                   "cpu ranks use gloo")
    _add_planner(f)
    _add_process_group(f)
    f.set_defaults(fn=cmd_fit)

    pl = sub.add_parser(
        "plan",
        help="print the parallelism planner's candidate table for a model + batch + topology: chosen layout, "
        "predicted params/opt/activation bytes per device (params and optimizer state exact), headroom against "
        "the memory budget, and why each rejected candidate lost (parallel/planner.py)",
    )
    pl.add_argument("--preset", default=None,
                    help="plan for a named preset's model and train config (batch defaults to the preset's)")
    pl.add_argument("--batch-size", type=int, default=None, help="global batch (default: the preset's, else 64)")
    pl.add_argument("--n-devices", type=int, default=None,
                    help="devices to plan for (default: the world size; a rank owns one device)")
    pl.add_argument("--hbm-gb", type=float, default=None,
                    help="per-device memory budget in GiB (default: the card's memory over the ranks that share "
                    "it; CPU ranks report none — feasibility is then divisibility-only)")
    pl.add_argument("--grad-accum", type=int, default=None)
    # pin any subset of the layout; the planner fills the rest by score
    pl.add_argument("--model-parallel", type=int, default=None)
    pl.add_argument("--pipeline-parallel", type=int, default=None)
    pl.add_argument("--sequence-parallel", type=int, default=None)
    pl.add_argument("--expert-parallel", type=int, default=None)
    pl.add_argument("--weight-update-sharding", action="store_true", default=None)
    # model flags for planning without a preset (train's)
    pl.add_argument("--backbone", choices=("resnet", "xception", "vit"), default="resnet")
    pl.add_argument("--input-shape", type=int, nargs=2, default=(101, 101))
    pl.add_argument("--n-blocks", type=int, nargs="+", default=(3, 4, 6))
    pl.add_argument("--base-depth", type=int, default=256)
    pl.add_argument("--block-type", choices=("bottleneck", "basic_block"), default="bottleneck")
    pl.add_argument("--dtype", choices=("float32", "bfloat16"), default="float32")
    pl.add_argument("--num-classes", type=int, default=None,
                    help="classification head (default: the segmentation head, like train)")
    pl.add_argument("--measured-margin-from", default=None, metavar="WORKDIR",
                    help="add the measured-vs-predicted memory_watermark residual a prior run ledgered in WORKDIR "
                    "to every candidate's budget check")
    pl.add_argument("--measured-costs-from", default=None, metavar="WORKDIR",
                    help="score candidates with the achieved FLOP/s and collective bytes/s of the op_roofline "
                    "events a prior run ledgered in WORKDIR (--profile-every-windows) instead of the analytic "
                    "constants; exits 2 when WORKDIR has none")
    pl.add_argument("--json", action="store_true",
                    help="the full machine-readable plan (chosen layout and every candidate's verdict)")
    pl.add_argument("--device", default=None,
                    help="the device whose topology is planned for (default: cuda, its name and memory; cpu: "
                    "CPU ranks)")
    _add_process_group(pl)
    pl.set_defaults(fn=cmd_plan)

    pr = sub.add_parser("predict", help="fold x TTA ensemble prediction")
    pr.add_argument("--model-dir", required=True, help="the trained folds (fold{K}/...); ignored with --artifact-dir")
    pr.add_argument("--test-dir", required=True, help="directory with images/*.png")
    pr.add_argument("--artifact-dir", default=None,
                    help="run inference from an exported serving artifact (through the bucketed serve engine) "
                    "instead of restoring checkpoints; --model-dir is ignored")
    pr.add_argument("--no-tta", action="store_true", help="disable test-time augmentation (single forward pass)")
    pr.add_argument("--output", default=None, help="write predictions to this .npz (default: stdout summary)")
    pr.add_argument("--submission", default=None, help="also write a Kaggle RLE submission csv here")
    pr.add_argument("--batch-size", type=int, default=64)
    pr.add_argument("--n-fold", type=int, default=5)
    _add_model_args(pr)
    pr.add_argument("--use-pallas-depthwise", action="store_true",
                    help="route the depthwise convs through the hand-written kernels")
    pr.add_argument("--device", default="cuda", help="torch device (default cuda; no CPU fallback)")
    pr.set_defaults(fn=cmd_predict)

    s = sub.add_parser("serve", help="serve an exported artifact, or a registry of them, over HTTP")
    s.add_argument("--artifact-dir", default=None, help="the artifact to serve; required unless --registry")
    s.add_argument("--registry", default=None, metavar="PATH",
                   help="a registry.json (serve/registry.py): every entry's artifact loads as its own engine and "
                   "micro-batcher; requests pick one by the payload's \"model\" key")
    s.add_argument("--model", default=None,
                   help="the name this replica serves under (with --registry: load only that entry)")
    s.add_argument("--model-version", type=int, default=None,
                   help="registry version of the served artifact (on /healthz, /metrics and serve_window)")
    s.add_argument("--prewarm-buckets", type=int, default=None,
                   help="warm only the first K buckets (smallest first); a colder bucket's first hit is counted "
                   "as serve/cold_bucket_hits and a post-warmup first run")
    s.add_argument("--visible-devices", default=None, metavar="IDS",
                   help="comma-separated CUDA device ordinals this replica may claim (CUDA_VISIBLE_DEVICES)")
    s.add_argument("--host", default="127.0.0.1")
    s.add_argument("--port", type=int, default=8500, help="0 picks a free port")
    s.add_argument("--buckets", type=int, nargs="+", default=[1, 4, 16, 64])
    s.add_argument("--max-wait-ms", type=float, default=5.0)
    s.add_argument("--queue-size", type=int, default=256)
    s.add_argument("--default-deadline-ms", type=float, default=None,
                   help="deadline of requests that carry none; expired requests answer 504")
    s.add_argument("--workdir", default=None,
                   help="telemetry ledger dir ({workdir}/telemetry.jsonl; default: the artifact dir)")
    s.add_argument("--window-secs", type=float, default=30.0,
                   help="ledger window cadence; 0 disables periodic windows (the final one is still written)")
    s.add_argument("--trace-sample-rate", type=float, default=0.0,
                   help="fraction of requests whose queue/pad/compute trace persists as `trace` ledger events")
    s.add_argument("--slo-p99-ms", type=float, default=None,
                   help="p99 latency target in ms as a windowed error budget: a breach writes a health_alert and "
                   "flips /healthz to degraded")
    s.add_argument("--slo-error-budget", type=float, default=0.01,
                   help="fraction of a window's requests allowed over the p99 target")
    s.add_argument("--replica-id", type=int, default=0,
                   help="this replica's id: on serve_window events and /healthz; replica i > 0 writes "
                   "telemetry-{i}.jsonl")
    s.add_argument("--inject-fault", default=None, metavar="SPEC",
                   help="fault drill (resilience/faults.py): 'sigkill@N' kills this replica after its Nth answered "
                   "request")
    s.add_argument("--seed", type=int, default=0, help="seed of ranged --inject-fault specs")
    s.add_argument("--capture-dir", default=None, metavar="DIR",
                   help="arm the traffic-capture tee (loop/capture.py): accepted requests of the primary model "
                   "into record shards under DIR")
    s.add_argument("--capture-fraction", type=float, default=1.0,
                   help="fraction of accepted requests the tee samples (a fixed stride)")
    s.add_argument("--capture-quota-mb", type=float, default=64.0,
                   help="disk ceiling of the sealed capture shards (oldest evicted first)")
    s.add_argument("--capture-records-per-shard", type=int, default=64, help="records per sealed capture shard")
    s.add_argument("--drift-threshold", type=float, default=None,
                   help="arm the DriftMonitor: total-variation distance of the served class distribution from "
                   "the manifest's drift_baseline past this writes drift_alert events")
    s.add_argument("--drift-min-requests", type=int, default=20, help="window floor before a drift verdict counts")
    s.add_argument("--drift-sustain-windows", type=int, default=2,
                   help="consecutive over-threshold windows before the alert fires")
    s.add_argument("--device", default=None, help="torch device; default cuda (no CPU fallback)")
    s.set_defaults(fn=cmd_serve)

    c = sub.add_parser("convert", help="flax variables .npz + config JSON (or a preset) -> serving artifact")
    c.add_argument("--params", required=True, help=".npz of flatten_dict({'params','batch_stats'}, sep='/')")
    c.add_argument("--config", default=None, help="ModelConfig as JSON")
    c.add_argument("--preset", default=None,
                   help="a preset's ModelConfig instead of --config (configs.py), e.g. vit_s16_imagenet")
    c.add_argument("--out", required=True, help="artifact directory to write")
    c.add_argument("--data-format", default="NHWC", choices=["NHWC", "NCHW"])
    c.add_argument("--serving-dtype", choices=SERVING_SPECS, default="float32",
                   help="post-training precision spec of the artifact (train/quantize.py)")
    c.set_defaults(fn=cmd_convert)

    q = sub.add_parser(
        "quantize-check",
        help="accuracy gate between a float32 serving artifact and a quantized sibling: pinned eval "
        "batch, per-precision delta thresholds; prints the verdict, exit 1 on failure",
    )
    q.add_argument("--reference-dir", required=True, help="the float32 reference artifact directory")
    q.add_argument("--candidate-dir", required=True,
                   help="the quantized candidate artifact directory (its manifest quantization section "
                   "selects the threshold set)")
    q.add_argument("--batch-size", type=int, default=16,
                   help="pinned eval batch size (fixed-batch artifacts pin their own)")
    q.add_argument("--seed", type=int, default=0, help="seed of the pinned eval batch")
    q.add_argument("--max-abs-delta", type=float, default=None,
                   help="override the precision's max |delta| budget on float outputs")
    q.add_argument("--mean-abs-delta", type=float, default=None,
                   help="override the precision's mean |delta| budget")
    q.add_argument("--min-iou", type=float, default=None, help="override the precision's minimum mask IoU")
    q.add_argument("--max-disagree", type=float, default=None,
                   help="override the precision's max class-disagreement fraction")
    q.add_argument("--allow-fingerprint-mismatch", action="store_true",
                   help="compare artifacts whose manifests carry different source fingerprints "
                   "(normally a hard fail: the pair derives from different weights)")
    q.add_argument("--device", default=None, help="torch device; default cuda (no CPU fallback)")
    q.set_defaults(fn=cmd_quantize_check)

    ri = sub.add_parser("records-index",
                        help="write .idx count/offset sidecars for existing TFRecord shards (new shards get them "
                        "from write_classification_shards)")
    ri.add_argument("data_dir", help="directory holding *.tfrecord shards")
    ri.add_argument("--glob", default="*.tfrecord", help="shard filename pattern (default: *.tfrecord)")
    ri.set_defaults(fn=cmd_records_index)

    rep = sub.add_parser(
        "telemetry-report",
        help="render the goodput report from a workdir's run ledgers (and the profiler captures under it)",
    )
    rep.add_argument("workdir", nargs="?", default=None,
                     help="the workdir holding telemetry.jsonl (and telemetry-{i}.jsonl per extra process, merged); "
                     "optional with --compare")
    rep.add_argument("--trace-dir", default=None,
                     help="a profiler capture directory to read ops.json from (default: search the workdir)")
    rep.add_argument("--top", type=int, default=10, help="device kernels to list from the captures")
    rep.add_argument("--json", action="store_true", help="machine-readable output")
    rep.add_argument("--export-trace", default=None, metavar="OUT_JSON",
                     help="instead of the report, export the last run's sampled trace spans as Chrome/Perfetto "
                     "trace-event JSON")
    rep.add_argument("--straggler-threshold", type=float, default=None,
                     help="a window alerts when the slowest process's mean step time exceeds this multiple of "
                     "the median (default 1.25)")
    rep.add_argument("--registry-dir", default=None, metavar="DIR",
                     help="cross-run registry ({DIR}/runs.jsonl): --register appends this workdir's summary row; "
                     "--compare operands may be registered run ids")
    rep.add_argument("--register", action="store_true",
                     help="append the workdir's run summary to the registry and print the row")
    rep.add_argument("--compare", nargs=2, metavar=("RUN_A", "RUN_B"), default=None,
                     help="instead of the report, emit noise-aware deltas between two runs (workdirs, or "
                     "registered run ids with --registry-dir)")
    rep.set_defaults(fn=cmd_telemetry_report)

    tp = sub.add_parser(
        "telemetry-top",
        help="live console over a workdir's merged run ledgers; --once prints a single frame",
    )
    tp.add_argument("workdir", help="the workdir whose telemetry.jsonl / telemetry-{i}.jsonl ledgers to tail")
    tp.add_argument("--interval", type=float, default=2.0, help="seconds between frame refreshes")
    tp.add_argument("--once", action="store_true",
                    help="print one frame and exit (an empty workdir renders a 'no ledgers yet' frame, rc 0)")
    tp.set_defaults(fn=cmd_telemetry_top)
    return p


def main(argv: Optional[List[str]] = None) -> int:
    args = build_parser().parse_args(argv)
    return args.fn(args)


if __name__ == "__main__":
    sys.exit(main())
