#!/usr/bin/env python3
"""Smoke test of the PyTorch port on one NVIDIA GPU (run from the repo root).

    python3 chip_smoke.py

Phases, each fatal on failure (exit 1, no result line):

1. probe   — a CUDA device is required; prints the card's name and power
             limit as ``nvidia-smi`` reports them.
2. build   — builds every kernel of ``tensorflowdistributedlearning_tpu_torch/
             csrc`` with nvcc (in parallel) and prints the build seconds.
3. kernels — runs one forward of the full-width serve model (ModelConfig()
             with use_pallas_depthwise=True, seeded random weights and BN
             statistics) at bucket 64, captures every kernel call's inputs,
             and holds each kernel against its plain PyTorch version on those
             inputs and on extra sweeps. Tolerances: sigmoid-mask bitwise
             (the float4 kernel and the earlier one-thread-per-element
             kernel, on the path's logits, edge values, linspace sweeps,
             random finite bit patterns, n % 4 != 0 and an unaligned base),
             the earlier kernel timed beside it (earlier_ms) with two floors
             (an empty kernel, and PyTorch reading the logits once and
             writing twice);
             fused BN+act rtol 1e-6, atol 1e-6 (sigmoid/gelu are libm calls
             that may differ by an ulp) and bit for bit its earlier kernel
             (one thread per element) on the 59 path calls and a sweep (every
             act with and without a residual, C = 33, a base that is not
             16-byte aligned), the earlier kernel timed beside it
             (earlier_ms); depthwise atol 1e-5 (summation order
             differs from the grouped conv) and bit for bit the earlier
             depthwise kernel, on the path's three calls and a sweep (C = 72
             and 6, 5x5 at rate 3, 7x7, B = 1, H = W = 1, a halo too large
             to stage), the earlier kernel timed beside it (earlier_ms).
             TF32 is off for convs and
             matmuls. Times are medians of CUDA-event timings with the 50 MB
             L2 flushed before every launch (and a 0.1 ms device spin after
             the flush, so that the host's launch path is not timed); per
             kernel they are summed over
             the calls of one forward at bucket 64, beside the bound (bytes
             over 3.35 TB/s or f32 operations over 67 TFLOP/s, the larger).
4. serve   — exports an artifact, serves it through the port's engine,
             micro-batcher and HTTP server on an ephemeral port, sends
             concurrent /v1/predict requests of 1-16 instances plus timed
             requests per bucket, expects 413 above 64 instances, checks
             shapes, mask == (probs > 0.5) and agreement with a forward
             through the plain versions on the card (probs atol 1e-5; mask
             equal where |p - 0.5| >= 1e-5), and checks that the served
             forwards launched 3 depthwise, 59 BN+act and 1 sigmoid-mask
             kernels each.
   serve-obs — the serve tier's observability on the same model: the
             float32 artifact and its bfloat16 spec, each stamped with its
             drift baseline on the card (a segmenter has no class output, so
             the drift monitor declines it, as in the JAX package: the
             fit-resnet50 phase serves the monitor), served as two tenants
             of one registry.json. First without telemetry, then with a
             ledger, tracing at rate 1.0, an SLO, the capture tee and
             windows emitted by hand: a fixed request script over both
             tenants (a 413, a malformed 400, a 429 from a held full queue,
             x-request-id echoed), the bucket-1 p50 over HTTP and the
             8-client closed-loop requests/s with telemetry off and on
             (fixed windows in the order off, on, on, off; the gap against
             the spread of each pair),
             /admin/profile?seconds=1 under load, an SLO target that holds,
             then one that is breached (health_alert, /healthz degraded, a
             postmortem capture), then recovered (ok). Checks the ledger
             (run_header, serve_start, serve_window counters equal to the
             script's per tenant, cost and memory_watermark events with
             bytes_in_use, the alerts, run_end), each sampled request's
             request span with queue_wait / pad / compute under it linked
             to a batch span, Prometheus counters equal to the JSON
             /metrics, the capture holding device kernels of depthwise,
             BN + act and sigmoid-mask, the later postmortem capture (on
             another thread) device kernels too, no profiler error, the capture
             shards read back bit for bit, responses bit for bit their
             engine batch's rows, and the launches per forward of each
             tenant (3 depthwise, 1 sigmoid-mask and 59 BN + act: folded
             float32 or, in the bfloat16 tenant, with bf16 parameters).
             Beside it a `serve` process (the command, --prewarm-buckets 2,
             --inject-fault sigkill@3): a cold bucket-16 hit counted as a
             post-warmup first run, and the process killed after its third
             answer.
5. int8    — exports float32 and int8-compute artifacts of the same model
             and serves the latter through the engine (buckets 1/4/16/64)
             and over HTTP; checks 52 int8_conv2d, 3 depthwise, 59 BN+act
             BN+act with bf16 parameters and 1 sigmoid-mask launches per
             forward, and the served probabilities against the plain
             int8-compute forward (1e-5);
             prints quantize-check's record against float32 (printed, not
             asserted: the weights are random); checks that 43 of the 52 int8
             convs (the 1x1 ones) launch the TMA + wgmma GEMM (int8_gemm.cu)
             and the 9 k x k ones the im2col implicit GEMM (int8_conv_tc.cu);
             holds each of the 52 int8 conv calls of a bucket-64 forward and
             an odd sweep (every route: Cin 3 to 512, Cout 1 and 70, 1x1 to
             7x7, explicit asymmetric pads, B = 1, 51x51 and 13x13) bitwise
             against the plain version and the earlier kernel (int8_conv.cu
             for every shape), the 59 BN calls (bf16 parameters) and a sweep
             bitwise against the plain version and their earlier kernel, and
             fused_bias_act (every act, f32 and bf16, with and without bias,
             at [12 544, 1536] and C = 8 on the vector arm, at (3, 7, 5, 33)
             and on a base one element off on the earlier kernel's arm) bit
             for bit its earlier kernel, bitwise the plain version where the
             act is exact and to the BN+act tolerance (or one bf16 step) for
             sigmoid and gelu; timed in bf16 gelu and relu beside the earlier
             kernel (earlier_ms), with the static SASS instruction counts of
             its vector kernels (cuobjdump).
             Times: int8 kernels alone on the quantized input, per route,
             beside the earlier kernel on the same inputs, the bound (bytes
             over 3.35 TB/s or int8 operations over 1979 TOPS), the plain
             version, and library yardsticks (torch._int_mm on the 1x1
             GEMMs, F.conv2d in float32 on the kxk shapes: torch has no int8
             conv).
   vit     — serves the vit_s16_imagenet preset (ViT-S/16: 224x224x3, 196
             tokens, embed 384, 6 heads of 64, 12 layers, 1000 classes, bf16
             compute, fused attention; 22 049 896 seeded random parameters,
             the logits calibrated to std 3), full width and depth: the
             float32 and int8-compute specs, and the float32 spec of a
             float32-compute variant, each through the engine at buckets
             1/4/16/64 and over HTTP at 1/4/16 instances; the bfloat16 and
             int8 storage specs through the engine at bucket 64. Checks the
             manifest, shapes, class == argmax(probabilities), 12
             flash_attention launches per forward, all 12 through the
             tensor-core arm in bf16 compute and none in float32 compute
             (plus 49 int8_matmul under int8-compute, all 49 through the
             TMA + wgmma GEMM) and none of the segmenter's kernels, and each
             served batch against the same batch through the plain versions
             on the card (max |dprobs| 1e-5 in float32 compute, 2e-2 in bf16
             compute and under int8-compute, classes equal where the top two
             are further apart; under int8-compute, also bit for bit equal
             with only the int8 matmul made plain). Holds flash_attention
             against its plain version at the 12 calls of a bucket-64
             forward in float32 (rtol 2e-5, atol 2e-6·max(1, max|v|): the
             JAX tolerance, its absolute part scaled to the values) and in
             bf16 (one bf16 step beyond that), and on an
             odd sweep (causal and not, T = 1/63/65/196/197/257/300, D = 16
             to 128 in steps of 16, B·H = 1, strided, contiguous and an
             unaligned base); times each arm summed over its
             forward's 12 calls beside its bound, the plain version and
             F.scaled_dot_product_attention (a yardstick the port never
             calls), and the earlier CUDA-core kernel (flash_attention.cu)
             on the same inputs; holds the 49 int8_matmul calls of an
             int8-compute forward bitwise against the plain version (M =
             64·196 and 64) and an odd sweep (K = 70/33/5 take the conv
             route), timing the GEMM and, as the earlier kernel, the conv
             route at the path's shapes; profiles the bucket-64 bf16,
             int8-compute and float32-compute forwards.
   fit-vit — ClassifierTrainer.fit on the same preset (its TrainConfig:
             AdamW 1e-3, weight decay 0.1, clip 1.0, label smoothing 0.1,
             flip_crop, cosine with warmup), full width and depth, on the
             index-keyed synthetic stream: 10 steps at batch 64, a
             checkpoint and an eval (4 batches) every 5, best export on
             metrics/top1; checks the checkpoint and export steps, finite
             metrics, 12 tensor-core attention launches per train step and
             per eval forward and nothing else; prints the wall time and
             final metrics; restores the best export (no init draw, timed)
             and serves it through serving_fn("float32") and
             ("bfloat16") on a batch of 64 (class == argmax; probabilities
             1e-5 and 2e-2 of the restored model's own forward) and through
             the engine after export_serving (1e-5).
   train-vit — the preset's train step on a resident batch of 64: ms per
             step (median of steps 3-10), images/s, 12 tensor-core
             attention launches per step, torch.profiler's device time,
             idle share and top kernels (the idle share also against the
             unprofiled step); every attention forward of one step held
             against the plain version (one bf16 step beyond the float32
             tolerance), the CUDA arm's dq, dk, dv against the plain arm's
             (the same backward on the same inputs: reported bit for bit or
             not, held to the forward's tolerance), the 12 backwards timed
             per step beside their bound (five products of 2·B·H·T²·D in
             float32 over 67 TFLOP/s, TF32 off) and SDPA's forward and
             backward on the same tensors (a yardstick); one bf16 step from
             one state with the fused and the plain attention, loss and
             every gradient leaf within 2e-2·max|g_leaf| (worst leaf
             printed); a float32-compute step at depth 2 and batch 8
             through the CUDA-core arm, held the same way.
6. backward — captures the three ASPP depthwise calls (input, filter, rate
             and the output gradient) from one full-width training forward
             and backward at batch 64, and holds the dx and dw kernels
             against the plain backward there: dx atol 1e-5 and, with the
             forward, bit for bit the earlier kernel there and on the
             forward's sweep; dx is one launch that allocates only its
             output; dw rtol 1e-4 with atol 1e-4·max|dw_plain| (each entry
             sums B·H·W products in another order), bitwise equal across
             two launches, through the band kernel (its plan logged); the
             earlier dw kernel to the same tolerance. A dw sweep holds each
             case to the same tolerance, bitwise across two launches, one
             launch each, on its stated route: the earlier tile kernel for C
             = 6, C = 33 and a base 4 bytes off; the band kernel for H = W =
             1, 7x7 at rate 3, 1x3 and 3x1, 5x5 at rate 3, a halo larger
             than the image, and B = 1 at 101x101x64 (a grid of at least 132
             blocks). Times as in 3, summed per train step: dx beside the
             earlier kernel on a flipped copy, dw beside the earlier tile
             kernel (earlier_ms) and two floors (an empty kernel; PyTorch
             reading x and g once, x.sum() + g.sum()); library:
             aten.convolution_backward.
7. train   — writes a TGS-layout dataset from the seed (256 images of
             101x101, a third of the masks empty) and its train.csv, takes
             the ids and coverage classes from load_tgs_training_set (the
             training script's loader) and runs Trainer.train
             on the full-width model, batch 64, 2 folds of 10 steps,
             checkpoints and evals every 5 steps; checks every fold's
             checkpoints and best export, finite metrics, exactly 3/3/3
             depthwise forward/dx/dw and 0 BN+act and 0 sigmoid-mask
             launches per train step (3 depthwise and 59 BN+act per eval
             forward), and that a re-run is a no-op resume. The folds feed
             through the data service (TrainConfig's default 2 workers):
             fold 0 stopped at step 5 (data_state-5.json written) and
             resumed to 10 is handed batches 5-9 equal, by sha256 of
             the images and masks, to the uninterrupted fold's. Then 10 steps
             on one fixed batch must lower the loss (ms per step, images/s);
             torch.profiler over 3 steps gives the device idle share; one
             step from one state with the kernels and with the plain
             versions agrees (loss 1e-5; every gradient leaf to
             1e-4·max|g_leaf| + 1e-6; the plain run launches nothing); and
             the exported best fold serves, through the engine at bucket 4,
             what the trainer's eval-mode forward gives (1e-6). Then
             predict: a test directory of 128 new images from another seed
             through Trainer.predict (2 folds x 4 TTA transforms at batch
             64, 16 forwards, each launching 3 depthwise and 59 BN+act
             kernels), held against the same ensemble through the plain
             versions (probabilities 1e-5, masks equal away from the
             threshold), its wall time and images/s; a fold restore timed
             into the draw-free template, into a freshly drawn state (the
             ensemble through that restore bit for bit the same) and as the
             export's torch.load alone; and `predict --artifact-dir` on
             fold 0's export, equal to engine.infer on the same images.
8. dp      — data-parallel training on 192 TGS-layout images of the
             seed, full width, global batch 64. One NCCL rank in this
             process (a file:// store): Trainer.train, 2 folds x 3 steps,
             3/3/3 depthwise launches per train step as in 7; under
             PyTorch's deterministic algorithms 3 steps from one state bit
             for bit 3 single-device steps (and those repeatable), the
             one-rank all-reduce the identity; ms per step of both
             steps, alternating, and the gradient all-reduce alone (CUDA
             events) beside 2 x 166.9 MB over 3.35 TB/s. Then two gloo
             ranks sharing the card, each a subprocess of this script
             (``dp-rank``) loading the warm build (beside this process's
             own build at the start, two processes, ``cold-build``, built
             the libraries of this path into one cold directory at the
             same time as each other and loaded them): per-rank and
             synchronized BN,
             the first step against its single-process emulation on rank 0
             (the ranks' rows forward and backward, gradients and
             statistics averaged; for synchronized BN the whole batch with
             its statistics formed from the ranks' row blocks, and the
             plain whole-batch step beside it) under sigmoid cross entropy
             under deterministic algorithms (loss 1e-5, every gradient leaf
             1e-4·max|g| + 1e-6, BN statistics 1e-5),
             the replicas' digests equal after 3 steps, ms per step and the
             host-staged all-reduce; then Trainer.train on both ranks
             (2 folds x 3 steps, 3/3/3 launches per train step, equal
             metrics).

9. train-bf16 — tgs_salt_bf16 (the segmenter in bf16 compute, full width
             and depth, depthwise kernels on) through Trainer.train (2 folds
             x 10 steps at batch 64 on 256 TGS-layout images; 3/3/3 bf16
             depthwise fwd/dx/dw launches per step, 59 bf16 BN launches per
             eval forward), the step on a resident batch (ms, images/s,
             profile, idle share), every bf16 kernel call of a step and an
             eval forward held against its plain version (one bf16 step; BN
             bit for bit for relu) and timed beside its bound, the plain
             version and the library call, then Trainer.predict over 128
             images and fold 0's export through the engine at bucket 64.
10. fit-resnet50 — resnet50_classic_imagenet (full width and depth, bf16,
             space-to-depth stem) through fit_preset on synthetic
             ImageNet-shaped data (10 steps at batch 64, the preset's SGD
             recipe, one eval, the float32 export), a restore, that export
             through the engine; then the restored state with its running
             statistics re-estimated from 4 training-mode forwards and its
             logits scaled to std 3 (10 steps leave the statistics near
             their init and every softmax saturated): each of the 52 BN
             calls of its eval forward at batch 64 held bit for bit against
             the plain version, its float32 export through the engine
             (buckets 1/16/32/64) and HTTP (1 and 4 instances) with 52 bf16 BN
             launches per forward, its drift baseline stamped on the card and
             the served classes scored against it by the server's drift
             monitor (the stamp's own pinned batch, served in the engine's
             bucket 32 as the stamp ran it, must score 0 and leave the
             monitor healthy), its bfloat16 spec through the engine
             against its plain forward and the float32 spec, and the step
             on a resident batch.
   fit-records — resnet50_classic_imagenet (full width and depth, bf16)
             through fit_preset on 768 class-conditional 224x224 images
             from the seed in 16 record shards with .idx sidecars,
             eval_holdout_fraction 0.125 (2 shards, 96 images; the second
             eval batch half padding), the data service's default 2
             workers, 10 steps at batch 64, one eval, the best export.
             Prints the decoder in use (native, or data/png.py where
             native/io.cc does not build). Checks: shard 0's records read
             back decode to the pixels written; 2 eval forwards over
             exactly 96 valid rows, 52 bf16 BN launches each, none per
             train step; a run stopped at step 5 writes
             data_state-5.json and, resumed, draws batches 5-9 equal to
             the uninterrupted stream's; the service alone gives batches
             0-3 equal at 1, 2 and 4 workers. Times: the service alone at
             1/2/4 workers (images/s, no model), fit's train loop
             (images/s, host clock) and the share of fit's wall time the
             host waits on the next batch; then 5 steps from an
             ImageFolder train/ (96 images) and val/ (32) split, one eval
             over 32 valid rows.
11. train-lars — resnet50_bf16_8k's model (remat) under its LARS recipe
             without ZeRO-1, grad_accum_steps 2, 5 steps at batch 64 with and
             without remat (ms per step, peak device memory), then one
             remat step bit for bit one plain step under deterministic
             algorithms.
12. train-tp — tensor parallelism (model_parallel 2) of the full-width
             segmenter on gloo ranks sharing the card (``chip_smoke.py
             tp-rank ...``, the warm build directory), global batch 8:
             two ranks hold the step against the one-rank step from the
             same state for 2 steps (deterministic algorithms; the one-rank
             step computed by the ranks' channel blocks, so its forward is
             theirs to the bit: loss 1e-5, gradient leaves 1e-4·max|g_leaf|
             + 1e-6, BN statistics 1e-5; the plain one-rank step's loss and
             statistics held too, its gradient reported),
             time it and its channel gathers, then run Trainer.train (2
             folds x 2 steps) with every depthwise and BN launch counted
             and the first step's calls on the channel slices held against
             the plain versions, their memory events the rule's bytes to
             the byte; then four ranks as a (2, 2) grid take 2 steps with
             and without ZeRO-1, bit for bit, each rank's optimizer bytes
             the rule's.
13. train-pp — pipeline parallelism (pipeline_parallel 2, 4 microbatches,
             bubble (K-1)/(M+K-1) = 0.2) of vit_s16_imagenet and
             xception41_imagenet at full width (bf16, 224x224x3) on two
             gloo ranks sharing the card (``chip_smoke.py pp-rank ...``),
             global batch 64 (dp = 1): per model 2 pipelined steps bit for
             bit the one-rank schedule (``local_stages``) on both ranks
             under deterministic algorithms, the plain one-rank step's
             first-step gap reported (the ViT's loss held within one bf16
             step), ms per step beside both one-rank steps, one step's
             activation sends and receives, output broadcast and gradient
             assembly timed with their bytes held to the shapes' count, the
             ranks' states equal; then fit_preset 2 steps resumed to 4 on
             both ranks with every attention (ViT) and eval BN (Xception)
             launch counted per step and per eval forward and the first
             calls held against the plain versions; the export served
             through the plain model in this process.
14. train-moe — expert parallelism and the Switch-MoE ViT:
             vit_s16_moe_imagenet at full width (bf16, 224x224x3, 12
             blocks, every other one an 8-expert top-1 MoE, 71 694 184
             parameters). The step on a resident batch of 64 with every
             expert local, alone on the host (ms, idle share, peak memory,
             the first loss beside ViT-S/16's, each MoE layer's load
             balance and fractions); then 8 gloo ranks sharing the card
             start (``chip_smoke.py moe-rank ...``, held until the
             one-card part is done) while seeded weights are exported and
             served by the engine at buckets 1 and 64 (the engine's logits
             within one bf16 step, at each row's scale, of the plain
             model's) and fit_preset trains with every expert local, 2
             steps resumed to 4 at batch 64 (12 attention launches per
             train step and eval forward); then the ranks at
             expert_parallel 8, dp 1, global batch 64: 2 steps held
             against the one-card dense step from the same state (loss
             within one bf16 step, every gradient leaf within
             2e-2·max|leaf|), the ranks' states equal, ms per step, one
             step's 24 all-to-alls of [8, 1960, 384] bf16 (12.04 MB) and
             its gradient all-reduce timed with their bytes held to the
             shapes' count.
15. train-sp — sequence parallelism (sequence_parallel 2, dp 1) on two
             gloo ranks sharing the card (``chip_smoke.py sp-rank ...``):
             (a) tgs_salt at full width and depth on 112x112 (101 does not
             divide by output stride 8 x 2), batch 64: one step held
             against the one-rank step computed on the ranks' row blocks
             (``split_row_blocks``, built with its own geometry: loss
             1e-5, gradient leaves 1e-4·max|g_leaf| + 1e-6, BN statistics
             1e-5; the plain one-rank step's loss and statistics held, its
             gradient's relative gap within 4x a witness's, the plain step
             on images one ulp above), which convs take the halo or the all-gather
             (at least one each), one step with its halo shifts, row
             gathers, their backward sums and all-reduces timed, then 3
             steps timed alone beside the one-rank step's, peak memory
             against the one-rank step's; Trainer.train 2 folds x 2 steps
             with every launch counted per step and eval forward, each
             rank's first step's depthwise fwd/dx/dw calls and first eval
             forward's BN calls held against the plain versions (as
             train-dp2's), and Trainer.predict on both ranks held within
             1e-5 of this process's plain predict of the same checkpoints;
             (b) ViT-S/16 at full width (bf16), one step held against the
             one-card step (loss within one bf16 step, every leaf within
             2e-2·max|leaf|), its ring rotations timed, 3 steps timed,
             fit_preset 2 steps; (c) ring attention alone at [64, 196, 6,
             64] against attention_reference on the card (f32 1e-5, bf16
             one step).

Prints the kernel table as one JSON line, then the last line
``{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": ...}}``.
"""

from __future__ import annotations

import contextlib
import hashlib
import json
import math
import os
import shutil
import statistics
import subprocess
import sys
import tempfile
import threading
import time
import urllib.error
import urllib.parse
import urllib.request
from concurrent.futures import ThreadPoolExecutor
from unittest import mock

import numpy as np

SEED = 20261016
PEAK_BYTES_S = 3.35e12  # H100 SXM HBM3 (NVIDIA data sheet)
PEAK_F32_FLOP_S = 67e12  # H100 SXM f32 outside the tensor cores
PEAK_INT8_OPS_S = 1979e12  # H100 SXM int8 tensor cores, dense
BUCKET = 64
TOL_DEPTHWISE = 1e-5
TOL_BN = 1e-6
TOL_PROBS = 1e-5
PKG = "tensorflowdistributedlearning_tpu_torch"
# (int8 convs, int8 Dense layers) of each full-depth model served as
# int8-compute: JAX's interceptor count (tests/test_torch_int8_models.py
# counts it with jax.eval_shape and holds the port's rule to it)
INT8_ARM_BUCKETS = (1, BUCKET)
INT8_ARM_REPS = 3  # engine forwards a spec a turn, two turns each
INT8_LAYERS = {
    "resnet50_classic_imagenet": (51, 1),
    "tgs_salt_bf16": (52, 0),
    "xception41_imagenet": (40, 1),
    "xception41_segmenter": (50, 0),
}
REPLACES = {
    "depthwise_conv2d": "tensorflowdistributedlearning_tpu/ops/pallas_kernels.py:138",
    "depthwise_conv2d_dx": "tensorflowdistributedlearning_tpu/ops/pallas_kernels.py:170",
    "depthwise_conv2d_dw": "tensorflowdistributedlearning_tpu/ops/pallas_kernels.py:172",
    "depthwise_conv2d_dw_tile": "tensorflowdistributedlearning_tpu/ops/pallas_kernels.py:172",
    "fused_bn_act": "tensorflowdistributedlearning_tpu/ops/pallas_kernels.py:398",
    "fused_bn_act_bf16": "tensorflowdistributedlearning_tpu/ops/pallas_kernels.py:398",
    "fused_sigmoid_mask": "tensorflowdistributedlearning_tpu/ops/pallas_kernels.py:573",
    "fused_bias_act": "tensorflowdistributedlearning_tpu/ops/pallas_kernels.py:504",
    "int8_conv2d": "tensorflowdistributedlearning_tpu/ops/quant_kernels.py:432",
    "int8_conv2d_gemm": "tensorflowdistributedlearning_tpu/ops/quant_kernels.py:432",
    "int8_conv2d_conv": "tensorflowdistributedlearning_tpu/ops/quant_kernels.py:432",
    "int8_matmul": "tensorflowdistributedlearning_tpu/ops/quant_kernels.py:241",
    "int8_matmul_conv": "tensorflowdistributedlearning_tpu/ops/quant_kernels.py:241",
    "flash_attention": "tensorflowdistributedlearning_tpu/ops/flash_attention.py:97",
    "flash_attention_f32": "tensorflowdistributedlearning_tpu/ops/flash_attention.py:97",
    "depthwise_conv2d_bf16": "tensorflowdistributedlearning_tpu/ops/pallas_kernels.py:138",
    "depthwise_conv2d_dx_bf16": "tensorflowdistributedlearning_tpu/ops/pallas_kernels.py:170",
    "depthwise_conv2d_dw_bf16": "tensorflowdistributedlearning_tpu/ops/pallas_kernels.py:172",
    "fused_bn_act_bf16_act": "tensorflowdistributedlearning_tpu/ops/pallas_kernels.py:398",
}
SOURCES = {
    "depthwise_conv2d": f"{PKG}/csrc/depthwise.cu",
    "depthwise_conv2d_dx": f"{PKG}/csrc/depthwise.cu",
    "depthwise_conv2d_dw": f"{PKG}/csrc/depthwise_dw.cu",
    "depthwise_conv2d_dw_tile": f"{PKG}/csrc/depthwise_dw.cu",
    "fused_bn_act": f"{PKG}/csrc/bn_act.cu",
    "fused_bn_act_bf16": f"{PKG}/csrc/bn_act.cu",
    "fused_sigmoid_mask": f"{PKG}/csrc/sigmoid_mask.cu",
    "fused_bias_act": f"{PKG}/csrc/bias_act.cu",
    "int8_conv2d": f"{PKG}/csrc/int8_conv_tc.cu",
    "int8_conv2d_gemm": f"{PKG}/csrc/int8_gemm.cu",
    "int8_conv2d_conv": f"{PKG}/csrc/int8_conv.cu",
    "int8_matmul": f"{PKG}/csrc/int8_gemm.cu",
    "int8_matmul_conv": f"{PKG}/csrc/int8_conv.cu",
    "flash_attention": f"{PKG}/csrc/flash_attention_tc.cu",
    "flash_attention_f32": f"{PKG}/csrc/flash_attention_f32.cu",
    "depthwise_conv2d_bf16": f"{PKG}/csrc/depthwise.cu",
    "depthwise_conv2d_dx_bf16": f"{PKG}/csrc/depthwise.cu",
    "depthwise_conv2d_dw_bf16": f"{PKG}/csrc/depthwise_dw.cu",
    "fused_bn_act_bf16_act": f"{PKG}/csrc/bn_act.cu",
}
# rows of the kernels line that are one arm of a wrapper with two kernels:
# their launches from the wrapper's counters (all launches, one arm's apart);
# the float32 rows leave out the bf16 arms' launches (every bf16 dw of the
# paths takes the band route, which the train-bf16 phase asserts)
ARM_LAUNCHES = {
    "depthwise_conv2d": lambda c: c["depthwise_conv2d"] - c["depthwise_conv2d_bf16"],
    "depthwise_conv2d_dx": lambda c: c["depthwise_conv2d_dx"] - c["depthwise_conv2d_dx_bf16"],
    "fused_bn_act": lambda c: c["fused_bn_act"] - c["fused_bn_act_bf16_act"],
    "depthwise_conv2d_dw": lambda c: c["depthwise_conv2d_dw_band"] - c["depthwise_conv2d_dw_bf16"],
    "depthwise_conv2d_dw_tile": lambda c: c["depthwise_conv2d_dw"] - c["depthwise_conv2d_dw_band"],
    "int8_conv2d": lambda c: c["int8_conv2d_tc"],
    "int8_conv2d_gemm": lambda c: c["int8_conv2d_gemm"],
    "int8_conv2d_conv": lambda c: c["int8_conv2d"] - c["int8_conv2d_gemm"] - c["int8_conv2d_tc"],
    "int8_matmul": lambda c: c["int8_matmul_gemm"],
    "int8_matmul_conv": lambda c: c["int8_matmul"] - c["int8_matmul_gemm"],
    "flash_attention": lambda c: c["flash_attention_tc"],
    "flash_attention_f32": lambda c: c["flash_attention"] - c["flash_attention_tc"],
}
# the kernels no main path calls, held directly against their plain
# versions: fused_bias_act (the JAX package has no caller of it),
# int8_matmul's conv route (the path's K are all multiples of 16) and dw's
# tile route (every path dw has C % 4 == 0, aligned bases and a band that
# fits); int8_conv2d's conv route is on the Xception int8-compute paths
OFF_PATH = ("fused_bias_act", "int8_matmul_conv", "depthwise_conv2d_dw_tile")
_NO_BF16 = {"depthwise_conv2d_bf16": 0, "depthwise_conv2d_dx_bf16": 0, "depthwise_conv2d_dw_bf16": 0,
            "fused_bn_act_bf16_act": 0}
_NO_QUANT = {"fused_bn_act_bf16": 0, "fused_bias_act": 0, "int8_conv2d": 0, "int8_conv2d_gemm": 0,
             "int8_conv2d_tc": 0, "int8_matmul": 0, "int8_matmul_gemm": 0,
             "flash_attention": 0, "flash_attention_tc": 0, **_NO_BF16}
PER_FORWARD = {"depthwise_conv2d": 3, "fused_bn_act": 59, "fused_sigmoid_mask": 1}
# launches per training step, and per eval-mode forward of the trainer
PER_TRAIN_STEP = {"depthwise_conv2d": 3, "depthwise_conv2d_dx": 3, "depthwise_conv2d_dw": 3,
                  "depthwise_conv2d_dw_band": 3, "fused_bn_act": 0, "fused_sigmoid_mask": 0, **_NO_QUANT}
PER_EVAL_FORWARD = {"depthwise_conv2d": 3, "depthwise_conv2d_dx": 0, "depthwise_conv2d_dw": 0,
                    "depthwise_conv2d_dw_band": 0, "fused_bn_act": 59, "fused_sigmoid_mask": 0, **_NO_QUANT}
# launches per int8-compute serve forward of the full-width model: every one
# of its 63 convs that the int8 rule takes (52: the 43 1x1 ones through the
# GEMM, the 9 k x k ones through the im2col kernel); every BN with bf16
# parameters
PER_INT8_FORWARD = {"int8_conv2d": 52, "int8_conv2d_gemm": 43, "int8_conv2d_tc": 9, "depthwise_conv2d": 3,
                    "fused_bn_act": 0, "fused_bn_act_bf16": 59,
                    "fused_sigmoid_mask": 1, "depthwise_conv2d_dx": 0, "depthwise_conv2d_dw": 0,
                    "depthwise_conv2d_dw_band": 0, "fused_bias_act": 0, "int8_matmul": 0, "int8_matmul_gemm": 0,
                    "flash_attention": 0, "flash_attention_tc": 0, **_NO_BF16}
VIT_MLP = (64 * 196, 384, 1536)  # ViT-S/16 MLP at batch 64 (196 patch tokens, no cls): M, K width, N hidden
VIT_PRESET = "vit_s16_imagenet"
_NO_SEGMENTER = {"depthwise_conv2d": 0, "depthwise_conv2d_dx": 0, "depthwise_conv2d_dw": 0,
                 "depthwise_conv2d_dw_band": 0, "fused_bn_act": 0,
                 "fused_bn_act_bf16": 0, "fused_bias_act": 0, "fused_sigmoid_mask": 0, "int8_conv2d": 0,
                 "int8_conv2d_gemm": 0, "int8_conv2d_tc": 0, **_NO_BF16}
# launches per ViT-S/16 serve forward: one attention kernel per block (the
# tensor-core arm in bf16 compute, the CUDA-core arm in float32 compute),
# and under int8-compute one int8 matmul per Dense (4 per block and the
# logits), every one through the GEMM route
PER_VIT_FORWARD = {**_NO_SEGMENTER, "int8_matmul": 0, "int8_matmul_gemm": 0, "flash_attention": 12,
                   "flash_attention_tc": 12}
PER_VIT_INT8_FORWARD = {**PER_VIT_FORWARD, "int8_matmul": 49, "int8_matmul_gemm": 49}
PER_VIT_F32_FORWARD = {**PER_VIT_FORWARD, "flash_attention_tc": 0}
# float32: the JAX package's kernel-vs-oracle tolerance, set there on values
# of unit scale; the output is a convex combination of v's rows summed in
# another order, so the absolute part scales with max|v| (attention_atol)
TOL_ATTN_RTOL, TOL_ATTN_ATOL = 2e-5, 2e-6
PEAK_BF16_FLOP_S = 989e12  # H100 SXM bf16 tensor cores, dense
# served ViT probabilities against the same forward through the plain versions
# on the card: tight where the model computes in float32; in bf16 (and under
# int8-compute) an attention output one bf16 step apart moves the next
# layer's rounding and quantization, so the bound is on the probabilities
# (calibrated logits, std 3) plus equal classes where the top two are apart
TOL_VIT_F32 = 1e-5
TOL_VIT_BF16 = 2e-2
# ViT training: fit 10 steps at batch 64 with a checkpoint and an eval
# every 5; the train step timed on a resident batch of 64
VIT_BATCH = 64
VIT_FIT_STEPS = 10
VIT_FIT_EVERY = 5
# timed HTTP requests per size in each ViT serving spec
VIT_HTTP_REPS = 1
# the fit-vit dispatch arms: steps per arm, the timed span and the window
# (short, to keep the run's time for the train-pp phase)
VIT_ARM_STEPS = 8
VIT_ARM_TIMED = (2, 6)
VIT_ARM_WINDOW = 4
TRAIN_BATCH = 64
TRAIN_IMAGES = 256
TRAIN_FOLDS = 2
TRAIN_STEPS = 10
PREDICT_IMAGES = 128
# data-parallel phase: 2 folds x 5 steps per run at global batch 64; 192
# images give each fold 96 train and 96 eval images, and three fixed
# batches for the one-rank step check
DP_IMAGES = 192
DP_FOLDS = 2
DP_STEPS = 3
# timed steps of the data-parallel phases (the medians skip the first);
# cut from 6 and 4 in PR 17 to pay for train-tp
DP_TIMED_ALTERNATIONS = 4
DP_TIMED_STEPS = 2
DP_RANKS = 2
DP_TIMEOUT_S = 600
TOL_DX = 1e-5
TOL_DW_REL = 1e-4
TOL_LOSS = 1e-5
# bf16 compute: tgs_salt_bf16 through Trainer.train (2 folds x 10 steps),
# resnet50_classic_imagenet through fit_preset (10 steps at batch 64), and
# resnet50_bf16_8k's model and LARS recipe with remat and accumulation (5
# steps at batch 64, without ZeRO-1). The bf16 arms hold their plain
# versions within one bf16 step (float32 sums in another order, one
# rounding); the BN arm bit for bit for its piecewise-linear activations
TOL_BF16_STEPS = 1
# steps on a resident batch timed by train-bf16 and fit-resnet50 (the median
# skips the first two)
RESIDENT_STEPS = 7
BF16_ROWS = ("depthwise_conv2d_bf16", "depthwise_conv2d_dx_bf16", "depthwise_conv2d_dw_bf16", "fused_bn_act_bf16_act")
BF16_PRESET = "tgs_salt_bf16"
R50_PRESET = "resnet50_classic_imagenet"
LARS_PRESET = "resnet50_bf16_8k"
BF16_TRAIN_STEPS = 10
R50_BATCH = 64
R50_FIT_STEPS = 10
R50_CALIBRATION_BATCHES = 4
# the ResNet-50's bfloat16 serving spec (bf16 BN parameters and statistics,
# flax's unfolded BN in bf16 arithmetic) against its float32 spec: the
# largest logit gap (logit_gap) over the logits' std. The spec's own
# distance: 0.687 on the card; JAX's bf16 spec lies 1.13 from its float32
# spec at a reduced size on the CPU, where the port's bf16 spec is JAX's
# within 1e-4 (tests/test_torch_resnet_classifier.py)
TOL_R50_BF16_SPEC = 1.0
# drift score of the stamp's own pinned batch served back at the stamp's
# batch shape (the engine's bucket 32): the stamp's classes exactly (padded
# into bucket 64, bf16 numerics moved 4 of the 32 classes on the H100)
DRIFT_OWN_INPUTS_MAX = 0.0
LARS_STEPS = 5
# fit-records: resnet50_classic_imagenet through fit_preset on record shards
# written from the seed (768 class-conditional 224x224 images, 16 shards, 2
# held out: 96 eval images, the second eval batch half padding), 20 steps at
# batch 64 through the data service's default 2 workers; a run stopped at
# step 10 and resumed; the service alone with 1/2/4 workers; then 5 steps
# from an ImageFolder split of 128 images (96 train, 32 val)
FR_IMAGES = 768
FR_SHARDS = 16
FR_HOLDOUT = 0.125
FR_STOP = 5
FR_WORKERS = (1, 2, 4)
FR_SERVICE_BATCHES = 8  # batches timed per worker count
FR_FOLDER_CLASSES = 8
FR_FOLDER_STEPS = 5
PER_BF16_TRAIN_STEP = {**PER_TRAIN_STEP, "depthwise_conv2d_bf16": 3, "depthwise_conv2d_dx_bf16": 3,
                       "depthwise_conv2d_dw_bf16": 3}
PER_BF16_EVAL_FORWARD = {**PER_EVAL_FORWARD, "depthwise_conv2d_bf16": 3,
                         "fused_bn_act_bf16_act": PER_EVAL_FORWARD["fused_bn_act"]}
# the ResNet classifiers launch no kernel in training (no depthwise conv;
# training BN is plain) and, per eval-mode forward of ResNet-50 (classic),
# one BN + act for each of the root's 4 BNs and the 3 of each of 16 units
PER_R50_TRAIN_STEP = {**PER_TRAIN_STEP, "depthwise_conv2d": 0, "depthwise_conv2d_dx": 0, "depthwise_conv2d_dw": 0,
                      "depthwise_conv2d_dw_band": 0}
PER_R50_FORWARD = {**PER_R50_TRAIN_STEP, "fused_bn_act": 4 + 3 * 16, "fused_bn_act_bf16_act": 4 + 3 * 16}
PER_R50_BF16_SPEC_FORWARD = {**PER_R50_TRAIN_STEP, "fused_bn_act_bf16": 4 + 3 * 16}
# the calls of a two-rank run's main path held against the plain versions,
# by wrapper of ops/kernels.py: the rank's first train step's depthwise
# forward, dx and dw, and its first eval forward's BN calls, all at the
# rank's batch (half the global batch)
RANK_HELD = {"depthwise_conv2d_forward": 3, "depthwise_conv2d_dx": 3, "depthwise_conv2d_dw": 3,
             "bn_act_folded": PER_EVAL_FORWARD["fused_bn_act"]}


class SmokeFailure(Exception):
    pass


def check(cond: bool, msg: str) -> None:
    if not cond:
        raise SmokeFailure(msg)


def log(msg: str) -> None:
    print(msg, flush=True)


# -- timing -----------------------------------------------------------------


class Timer:
    """Median CUDA-event time of one call, L2 flushed before each launch.
    After the flush the device spins for about 0.1 ms (``torch.cuda._sleep``)
    so that the host has enqueued the call before the device reaches the
    start event: the time is the device's, without the host's launch path
    (a short kernel behind a Python wrapper otherwise counts the wrapper)."""

    LEAD_CYCLES = 200_000  # about 0.1 ms at the H100's clock

    def __init__(self, torch):
        self.torch = torch
        self.flush = torch.empty(64 << 20, dtype=torch.uint8, device="cuda")

    def ms(self, fn, reps: int = 20, warmup: int = 3) -> float:
        torch = self.torch
        for _ in range(warmup):
            fn()
        torch.cuda.synchronize()
        starts = [torch.cuda.Event(enable_timing=True) for _ in range(reps)]
        ends = [torch.cuda.Event(enable_timing=True) for _ in range(reps)]
        for s, e in zip(starts, ends):
            self.flush.zero_()
            torch.cuda._sleep(self.LEAD_CYCLES)
            s.record()
            fn()
            e.record()
        torch.cuda.synchronize()
        return statistics.median(s.elapsed_time(e) for s, e in zip(starts, ends))


def bound_ms(nbytes: float, flops: float) -> float:
    return max(nbytes / PEAK_BYTES_S, flops / PEAK_F32_FLOP_S) * 1e3


def bound_by(nbytes: float, flops: float) -> str:
    return "bytes" if nbytes / PEAK_BYTES_S >= flops / PEAK_F32_FLOP_S else "operations"


def int8_bound(nbytes: float, ops: float):
    """(bound_ms, bound_by) of int8 tensor-core work: bytes over 3.35 TB/s
    or int8 operations over 1979 TOPS, the larger."""
    t_bytes, t_ops = nbytes / PEAK_BYTES_S, ops / PEAK_INT8_OPS_S
    return max(t_bytes, t_ops) * 1e3, "bytes" if t_bytes >= t_ops else "operations"


def same(torch, a, b) -> bool:
    """Bitwise agreement of two results: one dtype, one shape, equal values
    (torch.equal: +0 and -0 count equal, NaN never)."""
    return a.dtype == b.dtype and a.shape == b.shape and torch.equal(a, b)


def depthwise_valid_taps(h: int, w: int, k: int, rate: int) -> int:
    """Taps inside the image summed over output pixels (SAME, stride 1)."""
    pad = rate * (k - 1) // 2

    def per_axis(n):
        return sum(1 for o in range(n) for i in range(k) if 0 <= o + i * rate - pad < n)

    return per_axis(h) * per_axis(w)


def depthwise_sweep(torch, gen):
    """(x, w, rate) off the paths' shapes: C = 72 and C = 6 (not a multiple
    of 4), 5x5 at rate 3, 7x7, B = 1, H = W = 1, and a rate whose halo no
    tile can stage."""
    cases = [((5, 17, 23, 72), 3, 2), ((3, 9, 11, 6), 3, 2), ((1, 17, 23, 72), 5, 3), ((2, 9, 7, 40), 7, 1),
             ((1, 13, 13, 1024), 3, 4), ((2, 1, 1, 8), 3, 1), ((1, 40, 40, 256), 7, 12)]
    for shape, k, rate in cases:
        yield (torch.randn(*shape, device="cuda", generator=gen),
               torch.randn(k, k, shape[-1], device="cuda", generator=gen), rate)


def depthwise_agreement(torch, x, w, rate: int, dx: bool, what: str) -> float:
    """The tiled depthwise kernel (forward, or dx: the flip an index) bit
    for bit against the earlier kernel (dx on a flipped copy), and within
    TOL_DEPTHWISE of the plain version; returns max|kernel - plain|."""
    from tensorflowdistributedlearning_tpu_torch.ops import kernels

    got = kernels.depthwise_conv2d_dx(x, w, rate) if dx else kernels.depthwise_conv2d_forward(x, w, rate)
    earlier = kernels._earlier_depthwise(x, w, rate, dx)
    want = kernels._dx_plain(x, w, rate) if dx else kernels.depthwise_conv2d_plain(x, w, rate)
    name = "dx" if dx else "forward"
    if not same(torch, got, earlier):
        n = int((got != earlier).sum())
        raise SmokeFailure(f"depthwise {name} {what}: {n} elements differ from the earlier kernel "
                           f"(max {(got - earlier).abs().max().item()})")
    e = (got - want).abs().max().item()
    check(e <= TOL_DEPTHWISE, f"depthwise {name} {what}: max|err| {e} > {TOL_DEPTHWISE} against the plain version")
    return e


# -- phases -------------------------------------------------------------------


def probe(torch) -> str:
    check(torch.cuda.is_available(), "torch.cuda.is_available() is false: this smoke test needs an NVIDIA GPU")
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60,
    )
    check(out.returncode == 0, f"nvidia-smi failed: {out.stderr.strip()}")
    card = out.stdout.strip().splitlines()[0]
    log(f"card: {card}")
    log(f"torch {torch.__version__}, CUDA {torch.version.cuda}, device {torch.cuda.get_device_name(0)}")
    return card


def build():
    from tensorflowdistributedlearning_tpu_torch.ops import _build, kernels

    t0 = time.perf_counter()
    paths = _build.build_all()
    built = time.perf_counter() - t0
    for fn_name in kernels._signatures:
        kernels._entry(fn_name)
    log(f"build: {len(paths)} kernel libraries, nvcc in parallel {built:.3f} s, "
        f"loaded in {time.perf_counter() - t0:.3f} s")


def randomize_bn(torch, model, generator) -> None:
    """Random BN parameters and running statistics, so BN is no identity."""
    from tensorflowdistributedlearning_tpu_torch.models.layers import BatchNorm

    with torch.no_grad():
        for m in model.modules():
            if isinstance(m, BatchNorm):
                c = m.bias.shape[0]
                m.weight.copy_(torch.empty(c).uniform_(0.8, 1.2, generator=generator))
                m.bias.copy_(torch.empty(c).normal_(0.0, 0.1, generator=generator))
                m.running_mean.copy_(torch.empty(c).normal_(0.0, 0.1, generator=generator))
                m.running_var.copy_(torch.empty(c).uniform_(0.5, 1.5, generator=generator))


def calibrate_head(torch, model, x) -> None:
    """Scale and shift the last conv (decoder_conv_3x3) so the logits of
    ``x`` have mean 0 and std 2: random deep weights otherwise saturate the
    sigmoid (every probability 1.0), and comparisons of probabilities would
    say nothing."""
    with torch.inference_mode():
        logits = model(x)
        mean, std = logits.mean(), logits.std()
        conv = model.decoder_conv_3x3
        conv.weight.mul_(2.0 / std)
        conv.bias.sub_(mean).mul_(2.0 / std)


def make_instances(torch, n: int, seed: int):
    """Seeded 101x101 grey images through normalize + add_laplace_channel."""
    from tensorflowdistributedlearning_tpu_torch.data.augment import add_laplace_channel, normalize

    rng = np.random.default_rng(seed)
    images = torch.from_numpy(rng.uniform(0.0, 1.0, (n, 101, 101, 1)).astype(np.float32))
    return add_laplace_channel(normalize(images)).numpy()


def capture_path_calls(torch, model, x):
    """One forward with hooks recording each kernel call's inputs."""
    from tensorflowdistributedlearning_tpu_torch.models.layers import BatchNorm, DepthwiseConv2D

    calls = {"bn": [], "dw": []}

    def bn_hook(module, args, kwargs):
        inp = args[0].contiguous()
        m, b = module.folded()
        calls["bn"].append((inp, m, b, kwargs.get("act", "relu"), kwargs.get("residual")))

    def dw_hook(module, args):
        calls["dw"].append((args[0].contiguous(), module.weight.detach(), module.rate))

    handles = []
    for mod in model.modules():
        if isinstance(mod, BatchNorm):
            handles.append(mod.register_forward_pre_hook(bn_hook, with_kwargs=True))
        elif isinstance(mod, DepthwiseConv2D):
            handles.append(mod.register_forward_pre_hook(dw_hook))
    try:
        with torch.inference_mode():
            logits = model(x)
    finally:
        for h in handles:
            h.remove()
    return calls, logits


def bn_sweep(torch, path_shapes, gen, dtype: str):
    """BN + act sweep inputs ``(x, (scale, bias, mean, var), residual)``:
    the largest and smallest path shapes, C = 33 with an odd total (the
    row kernels' scalar arm), and a 13x13x256 view whose base is one
    element past a 16-byte boundary (the scalar arm for an unaligned base); ``x``
    in ``dtype`` (float32 or bfloat16), times 3."""
    shapes = sorted(set(path_shapes), key=lambda sh: -np.prod(sh))
    cases = []
    for shape, offset in ((shapes[0], 0), (shapes[-1], 0), ((3, 7, 5, 33), 0), ((2, 13, 13, 256), 1)):
        c, n = shape[-1], int(np.prod(shape))
        flat = 3 * torch.randn(n + offset, device="cuda", generator=gen)
        x = flat.to(getattr(torch, dtype))[offset:].view(shape)
        res = torch.randn(n + offset, device="cuda", generator=gen)[offset:].view(shape)
        vecs = (torch.rand(c, device="cuda", generator=gen) + 0.5, torch.randn(c, device="cuda", generator=gen),
                torch.randn(c, device="cuda", generator=gen), torch.rand(c, device="cuda", generator=gen) + 0.5)
        cases.append((x, vecs, res))
    return cases


def kernel_phase(torch, model, timer, card: str):
    import torch.nn.functional as F

    from tensorflowdistributedlearning_tpu_torch.ops import kernels

    x = torch.from_numpy(make_instances(torch, BUCKET, SEED)).cuda()
    calls, logits = capture_path_calls(torch, model, x)
    check(len(calls["dw"]) == PER_FORWARD["depthwise_conv2d"], f"depthwise calls per forward: {len(calls['dw'])}")
    check(len(calls["bn"]) == PER_FORWARD["fused_bn_act"], f"BN+act calls per forward: {len(calls['bn'])}")
    gen = torch.Generator(device="cuda").manual_seed(SEED)
    rows = {}

    # depthwise: the path's three ASPP calls, timed beside the earlier kernel,
    # then the sweep; each bitwise the earlier kernel and within 1e-5 of plain
    err = 0.0
    ms = plain = lib = earlier = nbytes = flops = 0.0
    with torch.inference_mode():
        for xin, w, rate in calls["dw"]:
            err = max(err, depthwise_agreement(torch, xin, w, rate, False, f"serve path {tuple(xin.shape)} rate {rate}"))
            b, h, wd, c = xin.shape
            k = w.shape[0]
            ms += timer.ms(lambda: kernels.depthwise_conv2d(xin, w, rate))
            earlier += timer.ms(lambda: kernels._earlier_depthwise(xin, w, rate, False))
            plain += timer.ms(lambda: kernels.depthwise_conv2d_plain(xin, w, rate))
            xv = xin.permute(0, 3, 1, 2)
            wt = w.permute(2, 0, 1).unsqueeze(1).contiguous()
            pad = rate * (k - 1) // 2
            lib += timer.ms(lambda: F.conv2d(xv, wt, padding=pad, dilation=rate, groups=c))
            nbytes += 4 * (2 * xin.numel() + w.numel())
            flops += 2 * b * c * depthwise_valid_taps(h, wd, k, rate)
            log(f"depthwise {tuple(xin.shape)} rate {rate}: bitwise the earlier kernel")
        n = 0
        for xo, wo, rate in depthwise_sweep(torch, gen):
            err = max(err, depthwise_agreement(torch, xo, wo, rate, False, f"sweep {tuple(xo.shape)} "
                                               f"{wo.shape[0]}x{wo.shape[1]} rate {rate}"))
            n += 1
    log(f"depthwise forward: {len(calls['dw'])} path calls and {n} sweep cases bitwise the earlier kernel, within "
        f"{TOL_DEPTHWISE} of plain (max|err| {err:.3g})")
    rows["depthwise_conv2d"] = dict(max_abs_err=err, ms=ms, plain_ms=plain, library_ms=lib, earlier_ms=earlier,
                                    bound_ms=bound_ms(nbytes, flops), bound_by=bound_by(nbytes, flops))

    # BN + act: the path's 59 calls, then every act with and without a
    # residual; each bit for bit the earlier kernel, within TOL_BN of plain
    err = 0.0
    ms = plain = earlier = nbytes = flops = 0.0
    with torch.inference_mode():
        for xin, m, b, act, res in calls["bn"]:
            got = kernels.bn_act_folded(xin, m, b, act, res)
            check(same(torch, got, kernels._earlier_bn_act(xin, m, b, act, res)),
                  f"fused_bn_act path call {tuple(xin.shape)}: not bitwise the earlier kernel")
            want = kernels.bn_act_folded_plain(xin, m, b, act, res)
            torch.testing.assert_close(got, want, rtol=TOL_BN, atol=TOL_BN)
            err = max(err, (got - want).abs().max().item())
            ms += timer.ms(lambda: kernels.bn_act_folded(xin, m, b, act, res))
            earlier += timer.ms(lambda: kernels._earlier_bn_act(xin, m, b, act, res))
            plain += timer.ms(lambda: kernels.bn_act_folded_plain(xin, m, b, act, res))
            nbytes += 4 * (2 * xin.numel() + 2 * m.numel() + (res.numel() if res is not None else 0))
            flops += 3 * xin.numel()
        n = 0
        for x, vecs, res in bn_sweep(torch, [tuple(c[0].shape) for c in calls["bn"]], gen, "float32"):
            m, b = kernels.fold_bn(*vecs, 1e-3)
            for act in kernels.ACTIVATIONS:
                for r in (None, res):
                    what = f"fused_bn_act sweep {tuple(x.shape)} {act} res={r is not None} base%16={x.data_ptr() % 16}"
                    got = kernels.bn_act_folded(x, m, b, act, r)
                    check(same(torch, got, kernels._earlier_bn_act(x, m, b, act, r)),
                          f"{what}: not bitwise the earlier kernel")
                    want = kernels.bn_act_folded_plain(x, m, b, act, r)
                    torch.testing.assert_close(got, want, rtol=TOL_BN, atol=TOL_BN, msg=lambda e: f"{what}: {e}")
                    err = max(err, (got - want).abs().max().item())
                    n += 1
    log(f"fused_bn_act: {len(calls['bn'])} path calls and {n} sweep cases bitwise the earlier kernel, within "
        f"{TOL_BN} of plain (max|err| {err:.3g}); per bucket-{BUCKET} forward {ms:.4f} ms, earlier kernel "
        f"{earlier:.4f} ms [{card}]")
    rows["fused_bn_act"] = dict(max_abs_err=err, ms=ms, plain_ms=plain, library_ms=None, earlier_ms=earlier,
                                bound_ms=bound_ms(nbytes, flops), bound_by=bound_by(nbytes, flops))

    # sigmoid-mask: the path's logits, then an edge sweep; the float4 kernel
    # and the earlier kernel each bitwise the plain version
    def bitwise(lg, what):
        pp, mp = kernels.fused_sigmoid_mask_plain(lg, 0.5)
        for arm, launch in (("kernel", kernels.fused_sigmoid_mask), ("earlier kernel", kernels._earlier_fused_sigmoid_mask)):
            p, mk = launch(lg, 0.5)
            diff = (p.view(torch.int32) != pp.view(torch.int32)) | (mk.view(torch.int32) != mp.view(torch.int32))
            if bool(diff.any()):
                bad = diff.flatten().nonzero().flatten()[:5]
                raise SmokeFailure(f"sigmoid-mask {arm} not bitwise on {what}: {int(diff.sum())} elements differ, "
                                   f"e.g. inputs {lg.flatten()[bad].tolist()} kernel {p.flatten()[bad].tolist()} "
                                   f"plain {pp.flatten()[bad].tolist()}")
        finite = torch.isfinite(pp)
        return max((p - pp)[finite].abs().max().item() if bool(finite.any()) else 0.0, (mk - mp).abs().max().item())

    with torch.inference_mode():
        check(kernels.sigmoid_mask_vectorized(logits), f"the path's logits {tuple(logits.shape)} miss the float4 arm")
        err = bitwise(logits, f"path logits {tuple(logits.shape)}")
        edges = torch.tensor(
            [float("inf"), float("-inf"), 0.0, -0.0, 1e-45, -1e-45, 1e-38, -1e-38, 1e-8, -1e-8, 6e-8, -6e-8,
             1e-7, -1e-7, 88.0, -88.0, 88.7, -88.7, 89.0, -89.0, 103.9, -103.9, 104.0, -104.0, 1e4, -1e4,
             3.4e38, -3.4e38, 17.0, -17.0, 16.6, -16.6],
            device="cuda",
        )
        err = max(err, bitwise(edges, "edge values"))
        err = max(err, bitwise(torch.linspace(-110.0, 110.0, 1 << 22, device="cuda"), "linspace sweep"))
        err = max(err, bitwise(torch.linspace(-1e-3, 1e-3, 1 << 20, device="cuda"), "near-zero sweep"))
        bits = torch.randint(-(2 ** 31), 2 ** 31 - 1, (1 << 22,), device="cuda", generator=gen, dtype=torch.int64)
        rnd = bits.to(torch.int32).view(torch.float32)
        err = max(err, bitwise(rnd[torch.isfinite(rnd)], "random finite bit patterns"))
        odd = torch.linspace(-30.0, 30.0, (1 << 20) + 3, device="cuda")
        check(odd.numel() % 4 != 0 and kernels.sigmoid_mask_vectorized(odd), "the n % 4 != 0 case misses its arm")
        err = max(err, bitwise(odd, "n % 4 != 0 (float4 arm, scalar tail)"))
        shifted = logits.flatten()[1:]
        check(not kernels.sigmoid_mask_vectorized(shifted), "an unaligned base took the float4 arm")
        err = max(err, bitwise(shifted, "a base 4 bytes off (scalar arm)"))
        n = logits.numel()
        ms = timer.ms(lambda: kernels.fused_sigmoid_mask(logits, 0.5))
        earlier = timer.ms(lambda: kernels._earlier_fused_sigmoid_mask(logits, 0.5))
        plain = timer.ms(lambda: kernels.fused_sigmoid_mask_plain(logits, 0.5))
        # floors of a 7.8 MB call under this timer: an empty kernel, and
        # PyTorch's copy with the same traffic (read n floats, write 2n)
        empty = timer.ms(lambda: torch.cuda._sleep(0))
        copy = timer.ms(lambda: logits.view(1, -1).expand(2, -1).contiguous())
        nbytes, flops = 4 * 3 * n, 4 * n
    log(f"fused_sigmoid_mask: the float4 kernel and the earlier kernel bitwise equal to the plain version on the path "
        f"logits, edge sweeps, n % 4 != 0 and an unaligned base; {ms:.4f} ms per bucket-{BUCKET} forward (earlier "
        f"kernel {earlier:.4f} ms, bound {bound_ms(nbytes, flops):.4f} ms); floors under this timer: an empty kernel "
        f"{empty:.4f} ms, PyTorch reading the logits once and writing twice {copy:.4f} ms [{card}]")
    rows["fused_sigmoid_mask"] = dict(max_abs_err=err, ms=ms, plain_ms=plain, library_ms=None, earlier_ms=earlier,
                                      bound_ms=bound_ms(nbytes, flops), bound_by=bound_by(nbytes, flops))
    return rows


def device_kernel(evt) -> bool:
    """Whether a profiler event is work on the card: a CUDA event that is
    not a user annotation (``Optimizer.step#AdamW.step`` shows on the
    device timeline too, over the kernels it launched)."""
    return str(getattr(evt, "device_type", "")).endswith("CUDA") and not getattr(evt, "is_user_annotation", False)


def profile_forward(torch, engine, x, reps: int = 3):
    """torch.profiler over ``reps`` engine forwards at bucket 64: wall time,
    summed device-kernel time and the idle share per forward, and the kernels
    that take the most device time."""
    from torch.profiler import ProfilerActivity, profile

    engine.infer(x)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(reps):
            engine.infer(x)
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3 / reps
    kernels_us = {}
    for evt in prof.events():
        if device_kernel(evt):
            kernels_us[evt.name] = kernels_us.get(evt.name, 0.0) + evt.time_range.elapsed_us()
    device_ms = sum(kernels_us.values()) / 1e3 / reps
    if device_ms <= 0:
        return [f"bucket {x.shape[0]}: wall {wall_ms:.3f} ms per forward; device time not measured "
                "(the profiler recorded no CUDA kernels)"]
    lines = [f"bucket {x.shape[0]}: wall {wall_ms:.3f} ms per forward, device kernels {device_ms:.3f} ms, "
             f"device idle {max(0.0, 1 - device_ms / wall_ms):.3f} of the wall time"]
    for name, us in sorted(kernels_us.items(), key=lambda kv: -kv[1])[:10]:
        lines.append(f"  {us / 1e3 / reps:9.3f} ms  {name[:110]}")
    return lines


def post(url: str, payload: dict, timeout: float = 300.0):
    body = json.dumps(payload).encode()
    req = urllib.request.Request(url, data=body, headers={"Content-Type": "application/json"})
    try:
        with urllib.request.urlopen(req, timeout=timeout) as r:
            return r.status, json.loads(r.read())
    except urllib.error.HTTPError as e:
        return e.code, json.loads(e.read())


# timed requests per bucket over HTTP (bucket 64 at its own count) and engine
# forwards per bucket (few, to keep the run's time for the train-pp phase)
HTTP_REPS, HTTP_REPS_64, ENGINE_REPS = 3, 1, 5


def serve_phase(torch, model, cfg, card: str, device: str = "cuda"):
    from tensorflowdistributedlearning_tpu_torch.ops import kernels
    from tensorflowdistributedlearning_tpu_torch.serve import (
        InferenceEngine, MicroBatcher, ServingServer, bind_ephemeral,
    )
    from tensorflowdistributedlearning_tpu_torch.train import serving

    results = {}
    with tempfile.TemporaryDirectory(prefix="chip-smoke-") as art:
        serving.export_serving_artifact(model, cfg, art)
        engine = InferenceEngine.from_artifact(art, device=device)
        warm = engine.warmup()
        log(f"serve: warmup s per bucket {json.dumps({str(b): round(s, 4) for b, s in warm.items()})}")
        batcher = MicroBatcher(engine, max_wait_ms=5.0, max_queue=256)
        server = ServingServer(engine, batcher, sock=bind_ephemeral("127.0.0.1", 0)).start()
        url = server.url + "/v1/predict"
        try:
            # the main path: counts from 0 just before, read just after
            kernels.reset_launch_counts()
            sizes = [1, 3, 16, 7, 2, 12, 4, 16, 1, 5, 9, 1]
            inst = {i: make_instances(torch, n, SEED + 1 + i) for i, n in enumerate(sizes)}

            def one(i):
                return i, post(url, {"instances": inst[i].tolist()})

            # record the batches the engine runs (padded input, outputs) for
            # the concurrent requests, to hold them against the plain forward
            batches = []
            serve_fn = engine.serve_fn

            def recording(x):
                out = serve_fn(x)
                batches.append((np.array(x, copy=True), {k: v.cpu().numpy() for k, v in out.items()}))
                return out

            engine.serve_fn = recording
            with ThreadPoolExecutor(max_workers=6) as pool:
                answered = dict(pool.map(one, range(len(sizes))))
            engine.serve_fn = serve_fn
            per_bucket = {}
            for b in engine.buckets:
                x = make_instances(torch, b, SEED + 100 + b).tolist()
                lat = []
                for _ in range(HTTP_REPS_64 if b == 64 else HTTP_REPS):
                    t0 = time.perf_counter()
                    status, _ = post(url, {"instances": x})
                    lat.append(time.perf_counter() - t0)
                    check(status == 200, f"bucket {b} request: HTTP {status}")
                per_bucket[b] = statistics.median(lat) * 1e3
            one_x = make_instances(torch, 1, SEED + 7).tolist()
            t0 = time.perf_counter()
            with ThreadPoolExecutor(max_workers=8) as pool:
                statuses = list(pool.map(lambda _: post(url, {"instances": one_x})[0], range(96)))
            rps = len(statuses) / (time.perf_counter() - t0)
            check(all(s == 200 for s in statuses), f"closed-loop statuses {sorted(set(statuses))}")
            # the engine alone (no HTTP/JSON): forward latency per bucket, and
            # a profiler view of one bucket-64 forward
            engine_ms = {}
            for b in engine.buckets:
                x = make_instances(torch, b, SEED + 200 + b)
                lat = []
                for _ in range(ENGINE_REPS):
                    t0 = time.perf_counter()
                    engine.infer(x)
                    lat.append(time.perf_counter() - t0)
                engine_ms[b] = statistics.median(lat) * 1e3
            profile = profile_forward(torch, engine, make_instances(torch, BUCKET, SEED + 300))
            counts = kernels.launch_counts()
            forwards = sum(engine.bucket_hits.values())

            status, body = post(url, {"instances": make_instances(torch, 65, SEED + 9).tolist()})
            check(status == 413 and body["error"]["code"] == "request_too_large", f"65 instances: HTTP {status} {body}")
            with urllib.request.urlopen(server.url + "/healthz", timeout=30) as r:
                check(json.loads(r.read())["ok"] is True, "healthz not ok")
        finally:
            server.shutdown()

        log(f"serve: {forwards} forwards, bucket hits {engine.bucket_hits}, launches {counts}")
        for b, ms in per_bucket.items():
            log(f"serve: bucket {b} p50 request latency {ms:.3f} ms over HTTP [{card}]")
        log(f"serve: {rps:.3f} requests/s, 8 closed-loop clients, 1 instance each [{card}]")
        for b, ms in engine_ms.items():
            log(f"engine: bucket {b} p50 forward {ms:.3f} ms (pad, H2D, forward, D2H; no HTTP) [{card}]")
        for line in profile:
            log(f"profile: {line} [{card}]")

        # each response is its rows of one engine batch, bit for bit; each
        # batch agrees with the same padded batch through the plain versions
        ref_model = serving.load_model(art, device)
        plain = {
            "depthwise_conv2d": kernels.depthwise_conv2d_plain,
            "bn_act_folded": kernels.bn_act_folded_plain,
            "fused_sigmoid_mask": kernels.fused_sigmoid_mask_plain,
        }
        for i, (status, body) in answered.items():
            n = sizes[i]
            check(status == 200, f"request {i}: HTTP {status} {body}")
            check(body["n"] == n, f"request {i}: n {body['n']} != {n}")
            p = np.asarray(body["predictions"]["probabilities"], np.float32)
            mk = np.asarray(body["predictions"]["mask"], np.float32)
            check(p.shape == (n, 101, 101, 1) and mk.shape == p.shape, f"request {i}: shapes {p.shape} {mk.shape}")
            check(bool(np.isfinite(p).all()), f"request {i}: non-finite probabilities")
            check(np.array_equal(mk, (p > 0.5).astype(np.float32)), f"request {i}: mask != (probs > 0.5)")
            rows = [
                (bx, bout, off) for bx, bout in batches for off in range(bx.shape[0] - n + 1)
                if np.array_equal(bx[off:off + n], inst[i])
            ]
            check(len(rows) >= 1, f"request {i}: its instances are in no engine batch")
            _, bout, off = rows[0]
            check(np.array_equal(p, bout["probabilities"][off:off + n]) and np.array_equal(mk, bout["mask"][off:off + n]),
                  f"request {i}: response differs from its engine batch's rows")
        with mock.patch.multiple(kernels, **plain):
            ref_serve = serving.make_serving_fn(ref_model, device)
            before = kernels.launch_counts()
            worst = 0.0
            for bx, bout in batches:
                ref = {k: v.cpu().numpy() for k, v in ref_serve(bx).items()}
                d = float(np.abs(bout["probabilities"] - ref["probabilities"]).max())
                worst = max(worst, d)
                check(d <= TOL_PROBS, f"batch of {bx.shape[0]}: probs differ from the plain forward by {d} > {TOL_PROBS}")
                away = np.abs(ref["probabilities"] - 0.5) >= 1e-5
                check(np.array_equal(bout["mask"][away], ref["mask"][away]), f"batch of {bx.shape[0]}: mask differs")
            check(kernels.launch_counts() == before, "the plain reference forward launched a kernel")
        log(f"serve: {len(answered)} concurrent responses in {len(batches)} engine batches agree with the plain "
            f"forward, max|dprobs| {worst:.3g}")
        for name, per in PER_FORWARD.items():
            check(counts[name] > 0, f"{name} was not launched on the serve path")
            check(counts[name] == per * forwards,
                  f"{name}: {counts[name]} launches for {forwards} forwards, expected {per} each")
        results["launches"] = counts
    return results


# -- serve tier observability ----------------------------------------------------

OBS_REQUESTS = 20  # per SLO window: the tracker's min_requests
OBS_CLIENTS = 8
# bucket-1 requests one at a time, then closed-loop clients, seconds per arm
# (short, to keep the run's time for the train-pp phase)
OBS_SEQUENTIAL_S = 0.5
OBS_LOOP_S = 1.5
OBS_PROFILE_S = 3  # the /admin/profile capture under load


def post_raw(url: str, body: bytes, headers=None, timeout: float = 300.0):
    """POST raw bytes; (status, headers, JSON body)."""
    req = urllib.request.Request(url, data=body, headers={"Content-Type": "application/json", **(headers or {})})
    try:
        with urllib.request.urlopen(req, timeout=timeout) as r:
            return r.status, dict(r.headers), json.loads(r.read())
    except urllib.error.HTTPError as e:
        return e.code, dict(e.headers), json.loads(e.read())


def get_url(url: str, headers=None, timeout: float = 60.0):
    req = urllib.request.Request(url, headers=headers or {})
    try:
        with urllib.request.urlopen(req, timeout=timeout) as r:
            return r.status, r.read().decode()
    except urllib.error.HTTPError as e:
        return e.code, e.read().decode()


def http_load(url: str, x, clients: int = OBS_CLIENTS) -> dict:
    """One arm of the telemetry off/on comparison, in fixed windows: bucket-1
    requests one at a time for OBS_SEQUENTIAL_S (their latencies, ms), then
    ``clients`` closed-loop clients for OBS_LOOP_S (completions over the
    wall time until the last answer)."""
    body = json.dumps({"instances": x}).encode()
    lat = []
    t_end = time.perf_counter() + OBS_SEQUENTIAL_S
    while time.perf_counter() < t_end:
        t0 = time.perf_counter()
        check(post_raw(url, body)[0] == 200, "bucket-1 request failed")
        lat.append((time.perf_counter() - t0) * 1e3)
    stop_t = time.perf_counter() + OBS_LOOP_S

    def client(_):
        statuses = []
        while time.perf_counter() < stop_t:
            statuses.append(post_raw(url, body)[0])
        return statuses

    t0 = time.perf_counter()
    with ThreadPoolExecutor(max_workers=clients) as pool:
        statuses = sum(pool.map(client, range(clients)), [])
    rps = len(statuses) / (time.perf_counter() - t0)
    check(all(s == 200 for s in statuses), f"closed-loop statuses {sorted(set(statuses))}")
    return {"lat_ms": lat, "p50_ms": statistics.median(lat), "rps": rps, "requests": len(lat) + len(statuses)}


def off_on_gap(off, on) -> dict:
    """The on-minus-off gap of two off and two on readings, beside the
    spread of each pair (the host's drift within one call): the gap is
    resolved only when it exceeds the larger spread."""
    gap = statistics.mean(on) - statistics.mean(off)
    bound = max(abs(off[0] - off[1]), abs(on[0] - on[1]))
    return {"off": [round(v, 3) for v in off], "on": [round(v, 3) for v in on], "gap": round(gap, 3),
            "spread_off": round(abs(off[0] - off[1]), 3), "spread_on": round(abs(on[0] - on[1]), 3),
            "resolved": abs(gap) > bound}


def keepalive_posts(url: str, body: bytes, n: int):
    """``n`` POSTs on one HTTP/1.1 connection, then a GET on it: the server
    answers a connection's requests in order and accounts a request's latency
    (its SLO sample) after answering it, so when the GET answers, all ``n``
    are in the server's window."""
    import http.client

    u = urllib.parse.urlparse(url)
    conn = http.client.HTTPConnection(u.hostname, u.port, timeout=300)
    statuses = []
    try:
        for _ in range(n):
            conn.request("POST", u.path, body=body, headers={"Content-Type": "application/json"})
            r = conn.getresponse()
            r.read()
            statuses.append(r.status)
        conn.request("GET", "/healthz")
        conn.getresponse().read()
    finally:
        conn.close()
    return statuses


def spawn_fault_drill(root: str, artifact: str, device: str = "cuda"):
    """A `serve` process of the command: the artifact at buckets 1/4/16/64
    with only 1 and 4 warm, ledger windows every 0.5 s, killed after its
    third answered request."""
    out = open(os.path.join(root, "drill.out"), "w")
    err = open(os.path.join(root, "drill.err"), "w")
    proc = subprocess.Popen(
        [sys.executable, "-m", PKG, "serve", "--artifact-dir", artifact, "--port", "0", "--workdir",
         os.path.join(root, "drill"), "--prewarm-buckets", "2", "--window-secs", "0.5", "--trace-sample-rate", "1.0",
         "--inject-fault", "sigkill@3", *(["--device", device] if device != "cuda" else [])],
        stdout=out, stderr=err, cwd=os.getcwd())
    return proc, out, err


def fault_drill(torch, proc, root: str, x1, x16):
    """Drive the drill: bucket 1, a cold bucket 16, bucket 1 (the kill)."""
    deadline = time.monotonic() + 300
    ready = None
    while ready is None and time.monotonic() < deadline and proc.poll() is None:
        with open(os.path.join(root, "drill.out")) as f:
            line = f.readline()
        if line.strip():
            ready = json.loads(line)
        else:
            time.sleep(0.2)
    if ready is None:
        with open(os.path.join(root, "drill.err")) as f:
            tail = f.read()[-3000:]
        raise SmokeFailure(f"serve-obs: the serve process did not come up (rc {proc.poll()}): {tail}")
    url = ready["serving"]
    check(sorted(ready["warmup_s"]) == ["1", "4"], f"serve-obs drill: warmed {ready['warmup_s']}")
    check(post(url + "/v1/predict", {"instances": x1})[0] == 200, "serve-obs drill: first request")
    check(post(url + "/v1/predict", {"instances": x16})[0] == 200, "serve-obs drill: cold bucket-16 request")
    metrics = json.loads(get_url(url + "/metrics")[1])
    cold = metrics["registry"]["counters"].get("serve/cold_bucket_hits/16")
    check(cold == 1, f"serve-obs drill: cold bucket-16 hits {cold}")
    status = post(url + "/v1/predict", {"instances": x1})[0]
    rc = proc.wait(60)
    check(status == 200 and rc == -9, f"serve-obs drill: third request HTTP {status}, process rc {rc}")
    from tensorflowdistributedlearning_tpu_torch.obs.ledger import read_ledger

    events = read_ledger(os.path.join(root, "drill"))
    kinds = [e["event"] for e in events]
    late = [e for e in events if e["event"] == "compile" and e["post_warmup"]]
    check("serve_start" in kinds and "run_end" not in kinds and len(late) == 1,
          f"serve-obs drill ledger: {sorted(set(kinds))}, post-warmup first runs {len(late)}")
    return {"cold_first_run_s": late[0]["duration_s"], "windows": kinds.count("serve_window")}


def check_request_traces(events, ids):
    """Each traced request: one ``request`` span (status 200) with
    queue_wait, pad and compute under it, the compute linked to the compute
    span of a batch trace."""
    spans = [e for e in events if e["event"] == "trace"]
    by_id = {e["span_id"]: e for e in spans}
    batch_computes = {e["span_id"] for e in spans if e["name"] == "compute"
                      and by_id.get(e.get("parent_id"), {}).get("name") == "batch"}
    roots = {e["trace_id"]: e for e in spans if e["name"] == "request"}
    for rid in ids:
        root = roots.get(rid)
        check(root is not None and root["attrs"]["status"] == 200, f"serve-obs: no request span for {rid}")
        kids = {e["name"]: e for e in spans if e["trace_id"] == rid and e.get("parent_id") == root["span_id"]}
        check(set(kids) == {"queue_wait", "pad", "compute"}, f"serve-obs: {rid} spans {sorted(kids)}")
        check(kids["compute"]["attrs"]["batch_span_id"] in batch_computes, f"serve-obs: {rid} not linked to a batch")
    return len(roots)


def serve_obs_phase(torch, model, cfg, card: str, device: str = "cuda"):
    from tensorflowdistributedlearning_tpu_torch.data import png, records
    from tensorflowdistributedlearning_tpu_torch.loop.capture import TrafficCapture, to_uint8_image
    from tensorflowdistributedlearning_tpu_torch.obs import health
    from tensorflowdistributedlearning_tpu_torch.obs.ledger import read_ledger
    from tensorflowdistributedlearning_tpu_torch.obs.metrics import MetricsRegistry
    from tensorflowdistributedlearning_tpu_torch.obs.telemetry import Telemetry
    from tensorflowdistributedlearning_tpu_torch.ops import kernels
    from tensorflowdistributedlearning_tpu_torch.serve import (
        InferenceEngine, MicroBatcher, ServingServer, bind_ephemeral,
    )
    from tensorflowdistributedlearning_tpu_torch.serve.quant_check import stamp_drift_baseline
    from tensorflowdistributedlearning_tpu_torch.serve.registry import ModelEntry, read_registry, write_registry
    from tensorflowdistributedlearning_tpu_torch.train import serving

    out = {}
    laps = {}
    t_lap = [time.perf_counter()]

    def lap(what: str) -> None:
        now = time.perf_counter()
        laps[what] = round(now - t_lap[0], 2)
        t_lap[0] = now

    root = tempfile.mkdtemp(prefix="chip-smoke-obs-")
    drill = None
    try:
        arts = {}
        for spec in ("float32", "bfloat16"):
            arts[spec] = os.path.join(root, spec)
            serving.export_serving_artifact(model, cfg, arts[spec], serving_dtype=spec)
            stamp_drift_baseline(arts[spec], device=device)
            baseline = serving.read_manifest(arts[spec]).get("drift_baseline")
            check(bool(baseline) and set(baseline["outputs"]) == {"probabilities", "mask"},
                  f"serve-obs: the {spec} export carries no drift baseline")
            try:
                health.DriftMonitor(baseline)
                raise SmokeFailure("serve-obs: a segmenter baseline gave a drift monitor")
            except ValueError as e:
                check("no integer output histogram" in str(e), f"serve-obs: drift monitor refused with {e}")
        lap("export")
        drill = spawn_fault_drill(root, arts["float32"], device)
        write_registry(root, [ModelEntry(name="seg", artifact_dir=arts["float32"], version=1),
                              ModelEntry(name="seg16", artifact_dir=arts["bfloat16"], version=2)])
        entries = list(read_registry(root).models.values())
        one = make_instances(torch, 1, SEED + 500).tolist()

        # telemetry off: a server of its own, measured beside the other
        bare_engine = InferenceEngine.from_artifact(arts["float32"], device=device)
        bare_engine.warmup()
        bare = ServingServer(bare_engine, MicroBatcher(bare_engine, max_wait_ms=5.0), sock=bind_ephemeral()).start()
        lap("off")

        # telemetry on
        workdir, capdir = os.path.join(root, "work"), os.path.join(root, "capture")
        tel = Telemetry(workdir, trace_sample_rate=1.0, device=device,
                        run_info={"kind": "serve", "models": {e.name: e.version for e in entries}})
        engines = {e.name: InferenceEngine.from_artifact(e.artifact_dir, device=device, tracer=tel.tracer,
                                                         registry=tel.registry if i == 0 else MetricsRegistry())
                   for i, e in enumerate(entries)}
        for e in engines.values():
            e.warmup(tel, mark_warm=False)
        tel.mark_warm()
        capture = TrafficCapture(capdir, records_per_shard=32)
        server = ServingServer(engines["seg"], MicroBatcher(engines["seg"], max_wait_ms=5.0), telemetry=tel,
                               window_secs=0, slo_p99_ms=60_000, model="seg", registry_version=1, capture=capture,
                               sock=bind_ephemeral())
        server.add_model("seg16", engines["seg16"], MicroBatcher(engines["seg16"], max_wait_ms=5.0, max_queue=1),
                         version=2, slo_p99_ms=60_000)
        server.start()
        lap("start")
        url = server.url + "/v1/predict"
        want = {name: {"requests": 0, "examples": 0} for name in engines}
        sent = []  # the primary's answered instances (what the capture may hold)
        batches = {name: [] for name in engines}

        def recording(name, fn):
            def run(x):
                y = fn(x)
                batches[name].append((np.array(x, copy=True), {k: v.cpu().numpy() for k, v in y.items()}))
                return y
            return run

        def answered(name, x, n=1):
            want[name]["requests"] += n
            want[name]["examples"] += n * len(x)
            if name == "seg":
                sent.extend([x] * n)

        try:
            # the main path: counts from 0 just before, read just after
            kernels.reset_launch_counts()
            fns = {name: e.serve_fn for name, e in engines.items()}
            for name, e in engines.items():
                e.serve_fn = recording(name, fns[name])
            script = [("seg", n) for n in (1, 3, 16, 7, 2, 12, 4, 16)] + [("seg16", n) for n in (2, 5, 1, 8)]
            inst = [make_instances(torch, n, SEED + 600 + i) for i, (_, n) in enumerate(script)]

            def one_request(i):
                name = script[i][0]
                return i, post_raw(url, json.dumps({"instances": inst[i].tolist(), "model": name}).encode(),
                                   headers={"x-request-id": f"obs-{i}"})

            # the primary's concurrently; seg16's one at a time (its queue holds one)
            with ThreadPoolExecutor(max_workers=6) as pool:
                replies = dict(pool.map(one_request, [i for i, (n, _) in enumerate(script) if n == "seg"]))
            replies.update(one_request(i) for i, (n, _) in enumerate(script) if n == "seg16")
            for i, (status, headers, body) in replies.items():
                check(status == 200 and headers.get("x-request-id") == f"obs-{i}" and body["n"] == len(inst[i]),
                      f"serve-obs request {i}: HTTP {status} {str(body)[:200]}")
                answered(script[i][0], inst[i])
            for name, e in engines.items():
                e.serve_fn = fns[name]
            row = json.dumps(one[0])
            status, headers, body = post_raw(url, ("{\"instances\": [" + ",".join([row] * 65) + "]}").encode(),
                                             headers={"x-request-id": "obs-413"})
            check(status == 413 and body["error"]["request_id"] == "obs-413" and headers["x-request-id"] == "obs-413",
                  f"serve-obs 413: HTTP {status} {body}")
            status, headers, body = post_raw(url, b"{not json")
            check(status == 400 and body["error"]["code"] == "bad_request" and headers.get("x-request-id"),
                  f"serve-obs malformed: HTTP {status} {body}")
            # a full queue: seg16's worker held in a forward, one request queued
            entered, release = threading.Event(), threading.Event()
            inner = engines["seg16"].serve_fn

            def held(x):
                entered.set()
                release.wait(60)
                return inner(x)

            engines["seg16"].serve_fn = held
            body16 = json.dumps({"instances": one, "model": "seg16"}).encode()
            with ThreadPoolExecutor(max_workers=2) as pool:
                first = pool.submit(post_raw, url, body16)
                check(entered.wait(60), "serve-obs: the held forward never started")
                second = pool.submit(post_raw, url, body16)
                depth = engines["seg16"].registry.gauge("serve/queue_depth")
                t_end = time.monotonic() + 60
                while depth.value != 1 and time.monotonic() < t_end:
                    time.sleep(0.002)
                status, headers, body = post_raw(url, body16)
                check(status == 429 and headers.get("Retry-After") and body["error"]["code"] == "queue_full",
                      f"serve-obs 429: HTTP {status} {body}")
                release.set()
                check(first.result()[0] == 200 and second.result()[0] == 200, "serve-obs: the held requests failed")
            engines["seg16"].serve_fn = inner
            answered("seg16", one, 2)
            held_window = server.emit_window()
            check(held_window["models"]["seg16"]["rejected_queue_full"] == 1, "serve-obs: 429 not counted")
            lap("script")

            # off, on, on, off in one call: the host's drift shows as the
            # spread of each pair
            loads = {"off": [], "on": []}
            for which in ("off", "on", "on", "off"):
                loads[which].append(http_load((bare.url + "/v1/predict") if which == "off" else url, one))
            answered("seg", one, sum(r["requests"] for r in loads["on"]))
            out["p50_ms"] = off_on_gap([r["p50_ms"] for r in loads["off"]], [r["p50_ms"] for r in loads["on"]])
            out["rps"] = off_on_gap([r["rps"] for r in loads["off"]], [r["rps"] for r in loads["on"]])
            out["samples"] = {which: [(len(r["lat_ms"]), r["requests"] - len(r["lat_ms"])) for r in runs]
                              for which, runs in loads.items()}
            lap("off-on-on-off")

            # /admin/profile under load
            stop = threading.Event()
            loaded = []
            body1 = json.dumps({"instances": one}).encode()

            def client():
                while not stop.is_set():
                    loaded.append(post_raw(url, body1)[0])

            threads = [threading.Thread(target=client) for _ in range(OBS_CLIENTS)]
            for t in threads:
                t.start()
            time.sleep(0.3)
            # the loaded server is host-bound: about two batched forwards a
            # second, each ~30 ms on the card, so a 1 s window once held no
            # whole forward (no depthwise kernel); 3 s holds several
            status, text = get_url(server.url + f"/admin/profile?seconds={OBS_PROFILE_S}")
            check(status == 202, f"serve-obs /admin/profile: HTTP {status} {text}")
            capture_id = json.loads(text)["capture_id"]
            t_end = time.monotonic() + 120
            while server.profiler.capturing and time.monotonic() < t_end:
                time.sleep(0.05)
            stop.set()
            for t in threads:
                t.join()
            check(not server.profiler.capturing and all(s == 200 for s in loaded),
                  f"serve-obs: profile under load, statuses {sorted(set(loaded))}")
            answered("seg", one, len(loaded))
            lap("profile")

            # an SLO that holds, then one that is breached, then recovered
            slo_status = []
            for target in (60_000, 1e-3, 60_000):
                server.slo.p99_target_ms = target
                with ThreadPoolExecutor(max_workers=4) as pool:
                    statuses = sum(pool.map(lambda _: keepalive_posts(url, body1, OBS_REQUESTS // 4), range(4)), [])
                check(statuses == [200] * OBS_REQUESTS, f"serve-obs: SLO requests {statuses}")
                answered("seg", one, OBS_REQUESTS)
                server.emit_window()
                slo_status.append(json.loads(get_url(server.url + "/healthz")[1])["status"])
            check(slo_status == ["ok", "degraded", "ok"], f"serve-obs /healthz through the SLO: {slo_status}")
            lap("slo")

            prom = get_url(server.url + "/metrics?format=prometheus")[1]
            snap = json.loads(get_url(server.url + "/metrics")[1])
            counts = kernels.launch_counts()
            forwards = {name: sum(e.bucket_hits.values()) for name, e in engines.items()}
            forwards["off"] = sum(bare_engine.bucket_hits.values())
        finally:
            server.shutdown()
            bare.shutdown()
        lap("shutdown")
        check(server.profiler.errors == 0, f"serve-obs: {server.profiler.errors} profiler errors")

        # launches per forward of each tenant
        log(f"serve-obs: forwards {forwards}, launches {counts}")
        f32, b16 = forwards["seg"] + forwards["off"], forwards["seg16"]
        expect = {"depthwise_conv2d": 3 * (f32 + b16), "fused_bn_act": 59 * f32,
                  "fused_bn_act_bf16": 59 * b16, "fused_sigmoid_mask": f32 + b16, "depthwise_conv2d_bf16": 0,
                  "fused_bn_act_bf16_act": 0}
        check({k: counts[k] for k in expect} == expect, f"serve-obs launches {counts}, expected {expect}")
        out["launches"] = counts

        # Prometheus against the JSON view, same moment
        values = {}
        for line in prom.splitlines():
            if line and not line.startswith("#"):
                name, value = line.rsplit(" ", 1)
                values[name] = float(value)
        for name, value in snap["registry"]["counters"].items():
            check(values.get("tfdl_" + name.replace("/", "_") + "_total") == value, f"serve-obs prometheus {name}")
        for name, row in snap["models"].items():
            for metric in ("requests", "completed", "rejected_queue_full"):
                key = f'tfdl_serve_model_{metric}_total{{model="{name}",version="{row["version"]}"}}'
                check(values.get(key) == row[metric], f"serve-obs prometheus {key}")

        # the ledger
        events = read_ledger(workdir)
        keep_ledgers(workdir, "serve-obs")
        kinds = [e["event"] for e in events]
        check(kinds[0] == "run_header" and kinds[-1] == "run_end" and "serve_start" in kinds,
              f"serve-obs ledger kinds {sorted(set(kinds))}")
        platform = "gpu" if device == "cuda" else "cpu"
        check(events[0]["fingerprint"]["platform"] == platform and "torch_version" in events[0]["fingerprint"],
              f"serve-obs run header {events[0]['fingerprint']}")
        final = [e for e in events if e["event"] == "serve_window"][-1]
        for name, w in want.items():
            row = final["models"][name]
            check(row["requests"] == row["completed"] == w["requests"] and row["errors"] == 0,
                  f"serve-obs {name}: window {row}, script {w}")
            check(row["batched_examples"] == w["examples"], f"serve-obs {name}: examples {row}, script {w}")
        check(final["final"] and final["recompiles_post_warmup"] == 0, f"serve-obs final window {final}")
        cost = [e for e in events if e["event"] == "cost"]
        marks = [e for e in events if e["event"] == "memory_watermark"]
        check(cost and all(c["chip_seconds"] > 0 for c in cost), "serve-obs: no cost events")
        check(device != "cuda" or (marks and all(m.get("bytes_in_use") for m in marks) and marks[0]["bytes_limit"] > 0),
              f"serve-obs: watermarks {marks[:1]}")
        alerts = [e for e in events if e["event"] == "health_alert" and e["monitor"] == "slo"]
        check([a.get("resolved", False) for a in alerts] == [False, True], f"serve-obs SLO alerts {alerts}")
        captures = {e["capture_id"]: e for e in events if e["event"] == "profile_capture"}
        roofs = {e["capture_id"]: e for e in events if e["event"] == "op_roofline"}
        postmortem = [c for c in captures.values() if c["reason"] == "alert"]
        check(capture_id in captures and (capture_id in roofs or device != "cuda") and len(postmortem) == 1
              and postmortem[0]["alert_id"] == alerts[0]["alert_id"], f"serve-obs captures {list(captures.values())}")
        # the postmortem: a later session on another thread, over the
        # recovery round's traffic, holds the worker's kernels too
        check(postmortem[0]["capture_id"] in roofs or device != "cuda",
              f"serve-obs: the postmortem capture holds no device kernels {postmortem[0]}")
        with open(os.path.join(captures[capture_id]["logdir"], "ops.json")) as f:
            ops = json.load(f)
        held = {needle: sum(r["occurrences"] for r in ops if needle in r["name"])
                for needle in ("tfdl_depthwise", "tfdl_bn_act", "tfdl_sigmoid_mask")}
        log(f"serve-obs: the {OBS_PROFILE_S} s admin capture holds {held} launches over {len(loaded)} loaded requests")
        for needle, n in held.items():
            check(n > 0 or device != "cuda", f"serve-obs: the capture holds no {needle} kernel ({held})")
        out["roofline"] = {k: roofs.get(capture_id, {}).get(k) for k in ("total_ms", "buckets", "classes")}
        out["admin_capture"] = {"seconds": OBS_PROFILE_S, "launches": held, "loaded_requests": len(loaded)}
        traced = check_request_traces(events, [f"obs-{i}" for i in range(len(script))])
        out["traced_requests"] = traced

        # capture shards: each record one of the primary's answered examples
        known = {to_uint8_image(x).tobytes() for inst_x in {id(x): x for x in sent}.values()
                 for x in np.asarray(inst_x)}
        n_rec = 0
        for name in sorted(os.listdir(capdir)):
            if name.endswith(".tfrecord"):
                for payload in records.read_records(os.path.join(capdir, name)):
                    label, blob = records.decode_classification_record(payload)
                    img = png.read_png(blob)
                    check(label == 0 and img.reshape(101, 101, 2).tobytes() in known,
                          "serve-obs: a capture record is none of the submitted examples")
                    n_rec += 1
        cap = [e for e in events if e["event"] == "capture_window"][-1]
        check(n_rec == cap["total_captured"] > 0, f"serve-obs capture: {n_rec} records, window {cap}")
        out["captured"], out["tee_dropped"] = n_rec, final["tee_dropped"]

        # each response is its rows of one engine batch, bit for bit
        for i, (status, _, body) in replies.items():
            n, name = len(inst[i]), script[i][0]
            p = np.asarray(body["predictions"]["probabilities"], np.float32)
            mk = np.asarray(body["predictions"]["mask"], np.float32)
            rows = [(bout, off) for bx, bout in batches[name] for off in range(bx.shape[0] - n + 1)
                    if np.array_equal(bx[off:off + n], inst[i])]
            check(len(rows) >= 1, f"serve-obs request {i}: its instances are in no engine batch")
            bout, off = rows[0]
            check(np.array_equal(p, bout["probabilities"][off:off + n]) and np.array_equal(mk, bout["mask"][off:off + n]),
                  f"serve-obs request {i}: response differs from its engine batch's rows")

        lap("checks")
        out["drill"] = fault_drill(torch, drill[0], root, one, make_instances(torch, 16, SEED + 501).tolist())
        lap("drill")
        out["laps_s"] = laps
    finally:
        if drill is not None:
            if drill[0].poll() is None:
                drill[0].kill()
                drill[0].wait(30)
            drill[1].close()
            drill[2].close()
        shutil.rmtree(root, ignore_errors=True)
    log(f"serve-obs: telemetry off against on at trace rate 1.0, in the order off, on, on, off; per arm "
        f"{OBS_SEQUENTIAL_S:g} s of bucket-1 requests one at a time, then {OBS_LOOP_S:g} s of "
        f"{OBS_CLIENTS} closed-loop clients; (sequential, closed-loop) requests per arm {json.dumps(out['samples'])} "
        f"[{card}]")
    log(f"serve-obs: bucket-1 p50 over HTTP, ms: {json.dumps(out['p50_ms'])} [{card}]")
    log(f"serve-obs: {OBS_CLIENTS}-client closed-loop requests/s: {json.dumps(out['rps'])} [{card}]")
    log(f"serve-obs: /admin/profile under load: {json.dumps(out['roofline'])} [{card}]")
    log(f"serve-obs: {out['traced_requests']} traced requests, {out['captured']} captured examples "
        f"({out['tee_dropped']} dropped), drill: cold first run {out['drill']['cold_first_run_s']} s, "
        f"{out['drill']['windows']} windows before the kill; seconds by part {json.dumps(out['laps_s'])}")
    return out


# -- int8-compute serving --------------------------------------------------------


def capture_int8_calls(torch, model, x):
    """One forward of an int8-compute model with hooks recording each
    QuantConv2d's and BatchNorm's inputs (and counting the depthwise calls)."""
    from tensorflowdistributedlearning_tpu_torch.models.layers import BatchNorm, DepthwiseConv2D
    from tensorflowdistributedlearning_tpu_torch.ops.quant_kernels import QuantConv2d

    calls = {"int8": [], "bn": [], "dw": 0}

    def conv_hook(module, args):
        calls["int8"].append((args[0].contiguous(), module))

    def bn_hook(module, args, kwargs):
        calls["bn"].append((args[0].contiguous(), module.unfolded(), kwargs.get("act", "relu")))

    def dw_hook(module, args):
        calls["dw"] += 1

    handles = []
    for mod in model.modules():
        if isinstance(mod, QuantConv2d):
            handles.append(mod.register_forward_pre_hook(conv_hook))
        elif isinstance(mod, BatchNorm):
            handles.append(mod.register_forward_pre_hook(bn_hook, with_kwargs=True))
        elif isinstance(mod, DepthwiseConv2D):
            handles.append(mod.register_forward_pre_hook(dw_hook))
    try:
        with torch.inference_mode():
            model(x)
    finally:
        for h in handles:
            h.remove()
    return calls


def int_mm_ms(torch, timer, a, b_t):
    """Time of torch._int_mm of int8 ``a`` [M, K] with int8 [K, N] given as
    ``b_t`` [N, K]: a yardstick only (no quantization, no epilogue, int32
    out). cuBLASLt takes the column-major [K, N] view; a copy otherwise."""
    b = b_t.t()
    try:
        torch._int_mm(a, b)
    except RuntimeError:
        b = b.contiguous()
    return timer.ms(lambda: torch._int_mm(a, b))


def int8_conv_checks(torch, calls, timer, card):
    """The 52 path calls of int8_conv2d: each through the route
    ``conv_route`` picks, bitwise against the plain version and against the
    earlier kernel (int8_conv.cu) on the same inputs; times per route summed
    per bucket-64 forward, each beside the earlier kernel's on the same
    calls; then the odd sweep, which meets every route and its edges.
    Returns the rows of the three routes: ``int8_conv2d`` (k x k,
    int8_conv_tc.cu), ``int8_conv2d_gemm`` (1x1, int8_gemm.cu) and
    ``int8_conv2d_conv`` (int8_conv.cu, which no path call takes, timed at
    the path's 52 calls)."""
    import torch.nn.functional as F

    from tensorflowdistributedlearning_tpu_torch.ops import quant_kernels as qk

    keys = ("ms", "earlier_ms", "plain_ms", "library_ms", "nbytes", "ops", "calls")
    acc = {route: dict.fromkeys(keys, 0.0) for route in ("tc", "gemm", "conv")}
    forced = dict.fromkeys(keys, 0.0)  # every path call through int8_conv.cu
    quant_ms = quant_bytes = 0.0
    with torch.inference_mode():
        for i, (x, mod) in enumerate(calls):
            wk, ws, bias, pads = mod.weight_q, mod.w_scale, mod.bias, mod.pads
            got = qk.int8_conv2d_ohwi(x, wk, ws, pads, bias=bias, out_dtype=torch.bfloat16)
            want = qk.int8_conv2d_ohwi_plain(x, wk, ws, pads, bias=bias, out_dtype=torch.bfloat16)
            xq, xs = qk.quantize_activations(x)
            old = torch.empty_like(got)
            qk._earlier_int8_conv(xq, xs, wk, ws, bias, old, pads, "none")
            cout, kh, kw, cin = wk.shape
            route = qk.conv_route(kh, kw, cin, pads)
            check(same(torch, got, want) and same(torch, old, want),
                  f"int8_conv2d path call {i} {tuple(x.shape)} x {tuple(wk.shape)} ({route}): kernel != plain "
                  f"({int((got != want).sum())} elements differ) or earlier kernel != plain "
                  f"({int((old != want).sum())} differ)")
            b, h, w, _ = x.shape
            m = b * got.shape[1] * got.shape[2]
            out = torch.empty_like(got)
            a = acc[route]
            ms = timer.ms(lambda: qk._launch_conv(xq, xs, wk, ws, bias, out, pads, "none"))
            a["ms"] += ms
            earlier = timer.ms(lambda: qk._earlier_int8_conv(xq, xs, wk, ws, bias, out, pads, "none"))
            plain = timer.ms(
                lambda: qk._epilogue_plain(qk._conv_acc_plain(xq, wk, pads), xs, ws, bias, "none", torch.bfloat16),
                reps=5, warmup=1,
            )
            if kh == kw == 1:
                lib = int_mm_ms(torch, timer, xq.view(m, cin), wk.view(cout, cin))
            else:
                (pt, pb), (pl, pr) = pads
                xf = F.pad(x.float().permute(0, 3, 1, 2), (pl, pr, pt, pb))
                wf = (wk.float() * ws.view(-1, 1, 1, 1)).permute(0, 3, 1, 2).contiguous()
                lib = timer.ms(lambda: F.conv2d(xf, wf))
            nbytes = x.numel() + wk.numel() + 2 * m * cout + 8 * cout
            ops = 2.0 * m * cout * kh * kw * cin
            log(f"int8_conv2d path call {i}: {tuple(x.shape)} x {kh}x{kw}x{cout} ({route}) {ms:.4f} ms, earlier "
                f"kernel {earlier:.4f} ms, library {lib:.4f} ms, bound {int8_bound(nbytes, ops)[0]:.4f} ms [{card}]")
            for r in (a, forced):
                r["earlier_ms"] += earlier
                r["plain_ms"] += plain
                r["library_ms"] += lib
                r["nbytes"] += nbytes
                r["ops"] += ops
                r["calls"] += 1
            quant_ms += timer.ms(lambda: qk.quantize_activations(x))
            quant_bytes += x.numel() * (x.element_size() + 1)
    # the conv route's row: int8_conv.cu timed at all the path's calls (the
    # earlier kernel's time there), since the path sends it none
    forced["ms"] = forced.pop("earlier_ms")
    rows = {}
    for route, name, a in (("tc", "int8_conv2d", acc["tc"]), ("gemm", "int8_conv2d_gemm", acc["gemm"]),
                           ("conv", "int8_conv2d_conv", forced)):
        bound, by = int8_bound(a["nbytes"], a["ops"])
        rows[name] = dict(max_abs_err=0.0, ms=a["ms"], plain_ms=a["plain_ms"], library_ms=a["library_ms"],
                          bound_ms=bound, bound_by=by)
        if "earlier_ms" in a:
            rows[name]["earlier_ms"] = a["earlier_ms"]
        log(f"int8_conv2d route {route} ({SOURCES[name]}): {int(acc[route]['calls'])} path calls; per "
            f"bucket-{BUCKET} forward {a['ms']:.4f} ms" + (
                f", the earlier kernel on the same calls {a['earlier_ms']:.4f} ms" if "earlier_ms" in a
                else f" (all {int(a['calls'])} path calls through this route)")
            + f", plain {a['plain_ms']:.4f} ms, library {a['library_ms']:.4f} ms, bound {bound:.4f} ms by {by} "
            f"({a['nbytes'] / 1e9:.4f} GB, {a['ops'] / 1e12:.4f} T int8 ops) [{card}]")
    new = acc["tc"]["ms"] + acc["gemm"]["ms"]
    log(f"int8_conv2d: {len(calls)} path calls bitwise equal to the plain version and the earlier kernel; "
        f"per bucket-{BUCKET} forward {new:.4f} ms through the routes, the earlier kernel {forced['ms']:.4f} ms "
        f"(1x1 {acc['gemm']['earlier_ms']:.4f} + k x k {acc['tc']['earlier_ms']:.4f}); library yardsticks "
        f"torch._int_mm on the 1x1 GEMMs {acc['gemm']['library_ms']:.4f} ms + F.conv2d in float32 on the kxk "
        f"shapes {acc['tc']['library_ms']:.4f} ms (torch has no int8 conv); the quantize pass before the kernel "
        f"{quant_ms:.4f} ms ({quant_bytes / 1e9:.4f} GB) [{card}]")

    # the odd sweep, every route and its edges: Cin 3, 5, 16, 48, 64, 96, 128,
    # 512; Cout 1, 5, 40, 70, 72, 130; 1x1 to 7x7; explicit asymmetric pads
    # (also on a 1x1); B = 1 at 51x51 and 17x23, 13x13; M never a multiple
    # of 128; an all-zero input, a zero filter channel, a bf16 input; bf16
    # and f32 out, with and without bias, the acts whose arithmetic is exact
    gen = torch.Generator(device="cuda").manual_seed(SEED + 31)
    cases = [
        (1, 17, 23, 3, 5, 3, "SAME"), (2, 9, 7, 5, 1, 5, "SAME"), (1, 17, 23, 64, 1, 3, "SAME"),
        (3, 11, 13, 16, 70, 5, ((2, 0), (1, 3))), (2, 8, 9, 5, 6, 3, "VALID"), (1, 17, 23, 48, 40, 1, "SAME"),
        (2, 6, 5, 32, 72, 3, ((0, 2), (3, 0))), (3, 11, 13, 64, 70, 5, ((2, 0), (1, 3))),
        (2, 13, 13, 128, 70, 3, "SAME"), (1, 51, 51, 64, 64, 3, "SAME"), (2, 13, 13, 512, 1, 3, "SAME"),
        (1, 13, 13, 512, 256, 1, "SAME"), (1, 9, 7, 5, 24, 1, "SAME"), (2, 7, 9, 96, 33, 1, ((1, 0), (0, 2))),
        (1, 3, 4, 64, 130, 7, "SAME"),
    ]
    n, routes = 0, {}
    with torch.inference_mode():
        for b, h, w, cin, cout, k, padding in cases:
            x = 2 * torch.randn(b, h, w, cin, device="cuda", generator=gen)
            wq = torch.randint(-127, 128, (k, k, cin, cout), device="cuda", generator=gen, dtype=torch.int8)
            wq[..., 0] = 0  # a zero filter channel
            ws = torch.rand(cout, device="cuda", generator=gen) * 1e-2 + 1e-3
            bias = torch.randn(cout, device="cuda", generator=gen)
            pads = qk._pads_or_raise(padding, wq)
            route = qk.conv_route(k, k, cin, pads)
            routes[(b, h, w, cin, cout, k, str(padding))] = route
            wk = qk._hwio_to_ohwi(wq)
            for xin in (x, torch.zeros_like(x), x.to(torch.bfloat16)):
                xq, xs = qk.quantize_activations(xin)
                for out_dtype, act, bb in ((torch.bfloat16, "none", None), (torch.float32, "relu", bias),
                                           (torch.bfloat16, "relu6", bias)):
                    got = qk.int8_conv2d(xin, wq, ws, padding=padding, bias=bb, act=act, out_dtype=out_dtype)
                    want = qk.int8_conv2d_plain(xin, wq, ws, padding=padding, bias=bb, act=act, out_dtype=out_dtype)
                    old = torch.empty_like(want)
                    qk._earlier_int8_conv(xq, xs, wk, ws, bb, old, pads, act)
                    check(same(torch, got, want) and same(torch, old, want),
                          f"int8_conv2d sweep {(b, h, w, cin, cout, k, padding)} ({route}) {act} {out_dtype}: kernel "
                          f"!= plain ({int((got != want).sum())} differ) or earlier kernel != plain "
                          f"({int((old != want).sum())} differ)")
                    n += 1
    check(sorted(set(routes.values())) == ["conv", "gemm", "tc"], f"int8_conv2d sweep routes {routes}")
    log(f"int8_conv2d: odd sweep, {n} cases bitwise equal to the plain version and the earlier kernel; routes "
        f"{routes}")
    return rows


def held_close(torch, got, want, act: str, what: str) -> float:
    """Bitwise for the acts with exact arithmetic; sigmoid and gelu (libm)
    within the fused BN+act tolerance in float32, or one bf16 step."""
    if act in ("none", "relu", "relu6"):
        check(same(torch, got, want), f"{what}: kernel != plain")
    elif got.dtype == torch.float32:
        torch.testing.assert_close(got, want, rtol=TOL_BN, atol=TOL_BN, msg=lambda m: f"{what}: {m}")
    else:  # one bf16 step: 2^-7 relative just above a power of two
        torch.testing.assert_close(got.float(), want.float(), rtol=2 ** -7, atol=TOL_BN, msg=lambda m: f"{what}: {m}")
    return (got.float() - want.float()).abs().max().item()


def int8_matmul_checks(torch, calls, timer, card):
    """int8_matmul at the ViT's int8-compute path calls (each QuantLinear's
    input and layer from one bucket-64 forward): kernel against plain
    bitwise, every call through the GEMM route, times summed per forward
    through the wrapper's route and, as the earlier kernel, through the
    conv route at the same shapes; then an odd sweep of M, K, N with every
    act, held directly, whose K = 70, 33 and 5 take the conv route. Returns
    the rows of the two routes."""
    from tensorflowdistributedlearning_tpu_torch.ops import kernels
    from tensorflowdistributedlearning_tpu_torch.ops import quant_kernels as qk

    row = dict(max_abs_err=0.0, ms=0.0, plain_ms=0.0, library_ms=0.0)
    conv = dict(max_abs_err=0.0, ms=0.0)
    nbytes = ops = quant_ms = 0.0
    shapes = {}
    with torch.inference_mode():
        before = kernels.launch_counts()
        for i, (x, mod) in enumerate(calls):
            wk, ws, bias, odt = mod.weight_q, mod.w_scale, mod.bias, mod.out_dtype
            got = qk.int8_matmul_nk(x, wk, ws, bias=bias, out_dtype=odt)
            want = qk.int8_matmul_plain(x, wk.t(), ws, bias=bias, out_dtype=odt)
            check(same(torch, got, want), f"int8_matmul path call {i} {tuple(x.shape)} x {tuple(wk.shape)}: kernel "
                  f"!= plain ({int((got != want).sum())} elements differ)")
            n, k = wk.shape
            m = x.numel() // k
            shapes[(m, k, n)] = shapes.get((m, k, n), 0) + 1
        gemm = kernels.launch_counts()["int8_matmul_gemm"] - before["int8_matmul_gemm"]
        check(gemm == len(calls), f"int8_matmul: {gemm} of the {len(calls)} path calls took the GEMM route")
        for x, mod in calls:
            wk, ws, bias, odt = mod.weight_q, mod.w_scale, mod.bias, mod.out_dtype
            n, k = wk.shape
            m = x.numel() // k
            xq, xs = qk.quantize_activations(x)
            xq = xq.view(m, k)
            out = torch.empty(m, n, dtype=odt, device=x.device)
            row["ms"] += timer.ms(lambda: qk._launch_matmul(xq, xs, wk, ws, bias, out, "none"))
            conv["ms"] += timer.ms(lambda: qk._launch("int8_matmul", xq.view(1, 1, m, k), xs, wk, ws, bias, out,
                                                      (1, 1, m, k, n, 1, 1), ((0, 0), (0, 0)), "none"))
            row["plain_ms"] += timer.ms(
                lambda: qk._epilogue_plain((xq.double() @ wk.t().double()).to(torch.int32), xs, ws, bias,
                                           "none", odt), reps=5, warmup=1)
            row["library_ms"] += int_mm_ms(torch, timer, xq, wk)
            quant_ms += timer.ms(lambda: qk.quantize_activations(x))
            nbytes += m * k + n * k + m * n * out.element_size() + 8 * n
            ops += 2.0 * m * n * k
    row["bound_ms"], row["bound_by"] = int8_bound(nbytes, ops)
    row["earlier_ms"] = conv["ms"]
    log(f"int8_matmul: {len(calls)} ViT path calls bitwise equal to the plain version, all through the GEMM route "
        f"(M, K, N: {shapes}); per bucket-{BUCKET} forward: GEMM {row['ms']:.4f} ms, the conv route (the earlier "
        f"kernel) {conv['ms']:.4f} ms, plain {row['plain_ms']:.4f} ms, torch._int_mm (no quantize, no epilogue, "
        f"int32 out) {row['library_ms']:.4f} ms, bound {row['bound_ms']:.4f} ms by {row['bound_by']} "
        f"({nbytes / 1e9:.4f} GB, {ops / 1e12:.4f} T int8 ops); the quantize pass before the kernel "
        f"{quant_ms:.4f} ms [{card}]")

    gen = torch.Generator(device="cuda").manual_seed(SEED + 41)
    routes = {}
    with torch.inference_mode():
        for m, k, n in (VIT_MLP, (37, 70, 24), (1, 5, 3), (300, 33, 17), (129, 384, 1), (64, 384, 1000)):
            x = torch.randn(m, k, device="cuda", generator=gen)
            wq = torch.randint(-127, 128, (k, n), device="cuda", generator=gen, dtype=torch.int8)
            ws = torch.rand(n, device="cuda", generator=gen) * 1e-2 + 1e-3
            bias = torch.randn(n, device="cuda", generator=gen)
            route = qk.matmul_route(k)
            routes[(m, k, n)] = route
            for act in kernels.ACTIVATIONS:
                for out_dtype in (torch.bfloat16, torch.float32):
                    got = qk.int8_matmul(x, wq, ws, bias=bias, act=act, out_dtype=out_dtype)
                    want = qk.int8_matmul_plain(x, wq, ws, bias=bias, act=act, out_dtype=out_dtype)
                    e = held_close(torch, got, want, act, f"int8_matmul {(m, k, n)} {act} {out_dtype} ({route})")
                    r = row if route == "gemm" else conv
                    r["max_abs_err"] = max(r["max_abs_err"], e)
    check(sorted(set(routes.values())) == ["conv", "gemm"], f"int8_matmul sweep routes {routes}")
    log(f"int8_matmul: odd sweep bitwise equal to the plain version (sigmoid/gelu within tolerance), routes "
        f"{routes}, max|err| GEMM {row['max_abs_err']:.3g}, conv route {conv['max_abs_err']:.3g}")
    conv_row = dict(max_abs_err=conv["max_abs_err"], ms=conv["ms"], plain_ms=row["plain_ms"],
                    library_ms=row["library_ms"], bound_ms=row["bound_ms"], bound_by=row["bound_by"])
    return row, conv_row


def bits_equal(torch, a, b) -> bool:
    """The same bits: one dtype, one shape, equal bit patterns (+0 and -0
    apart)."""
    if a.dtype != b.dtype or a.shape != b.shape:
        return False
    view = torch.int16 if a.element_size() == 2 else torch.int32
    return torch.equal(a.view(view), b.view(view))


def sass_counts(lib_path: str, prefix: str):
    """{mangled kernel name: static SASS instruction count, NOPs left out}
    of the kernels in a built library whose name starts with ``prefix``, from
    ``cuobjdump -sass``; None where the toolkit has no cuobjdump."""
    from tensorflowdistributedlearning_tpu_torch.ops import _build

    tool = os.path.join(os.path.dirname(_build.nvcc_path()), "cuobjdump")
    if not os.path.isfile(tool):
        return None
    out = subprocess.run([tool, "-sass", lib_path], capture_output=True, text=True, timeout=120, check=True).stdout
    counts, name = {}, None
    for line in out.splitlines():
        stripped = line.strip()
        if stripped.startswith("Function :"):
            name = stripped.split(":", 1)[1].strip()
            counts[name] = 0
        elif name is not None and stripped.startswith("/*") and "*/" in stripped:
            instr = stripped.split("*/", 1)[1].strip()
            if instr and not instr.startswith("NOP") and not instr.startswith("/*"):
                counts[name] += 1
    return {k: v for k, v in counts.items() if prefix in k}


def fused_bias_act_checks(torch, timer, card):
    """fused_bias_act held directly (no path calls it): every act, f32 and
    bf16, with and without bias, bit for bit the earlier kernel and held
    close to the plain version, at the ViT MLP hidden shape [12 544, 1536]
    and C = 8 (the vector arm), (3, 7, 5, 33) and C = 64 on a base one
    element off (the earlier kernel's arm); timed on the hidden shape in
    bf16 with gelu (the MLP's epilogue) beside the earlier kernel, and with
    relu beside it (the same bytes without libm's tanhf)."""
    from tensorflowdistributedlearning_tpu_torch.ops import _build
    from tensorflowdistributedlearning_tpu_torch.ops import kernels

    gen = torch.Generator(device="cuda").manual_seed(SEED + 51)
    m, _, n = VIT_MLP
    err = 0.0
    cases = (((m, n), 0, True), ((4099, 8), 0, True), ((3, 7, 5, 33), 0, False), ((37, 64), 1, False))
    checked = 0
    with torch.inference_mode():
        for shape, offset, vector in cases:
            numel = int(np.prod(shape))
            base = 3 * torch.randn(numel + offset, device="cuda", generator=gen)
            bias = torch.randn(shape[-1], device="cuda", generator=gen)
            for dtype in (torch.float32, torch.bfloat16):
                x = base.to(dtype)[offset:].view(shape)
                plan = kernels.bias_act_route(x, torch.empty_like(x))
                check((plan is not None) == vector, f"fused_bias_act {shape} {dtype} offset {offset}: plan {plan}, "
                      f"expected the {'vector' if vector else 'earlier'} arm")
                for act in kernels.ACTIVATIONS:
                    for bb in (bias, None):
                        what = f"fused_bias_act {shape} {dtype} {act} {'bias' if bb is not None else 'no bias'}"
                        got = kernels.fused_bias_act(x, bb, act)
                        old = kernels._earlier_fused_bias_act(x, bb, act)
                        check(bits_equal(torch, got, old), f"{what}: not bit for bit the earlier kernel "
                              f"({int((got.float() != old.float()).sum())} elements differ)")
                        want = kernels.fused_bias_act_plain(x, bb, act)
                        err = max(err, held_close(torch, got, want, act, what))
                        checked += 1
        xb = (3 * torch.randn(m, n, device="cuda", generator=gen)).to(torch.bfloat16)
        bias = torch.randn(n, device="cuda", generator=gen)
        plan = kernels.bias_act_route(xb, torch.empty_like(xb))
        ms = timer.ms(lambda: kernels.fused_bias_act(xb, bias, "gelu"))
        earlier = timer.ms(lambda: kernels._earlier_fused_bias_act(xb, bias, "gelu"))
        plain = timer.ms(lambda: kernels.fused_bias_act_plain(xb, bias, "gelu"))
        relu = timer.ms(lambda: kernels.fused_bias_act(xb, bias, "relu"))
        relu_earlier = timer.ms(lambda: kernels._earlier_fused_bias_act(xb, bias, "relu"))
        # floors under this timer: an empty kernel, and PyTorch's copy with
        # the same traffic (read and write every bf16 element once)
        empty = timer.ms(lambda: torch.cuda._sleep(0))
        copy = timer.ms(lambda: xb.clone())
    nbytes, flops = 2 * 2 * xb.numel() + 4 * n, 12 * xb.numel()
    arm = (f"vector: {plan.vec} channels a thread, {plan.groups} column groups x {plan.rows} row walkers, "
           f"{plan.blocks} blocks")
    row = dict(max_abs_err=err, ms=ms, plain_ms=plain, library_ms=None, earlier_ms=earlier,
               bound_ms=bound_ms(nbytes, flops), bound_by=bound_by(nbytes, flops), arm=arm)
    log(f"fused_bias_act: {checked} cases (every act, f32 and bf16, with and without bias, at {(m, n)}, (4099, 8), "
        f"(3, 7, 5, 33) and (37, 64) one element off) bit for bit the earlier kernel, max|err| vs plain {err:.3g}; "
        f"at {(m, n)} bf16 ({arm}): gelu {ms:.4f} ms (earlier kernel {earlier:.4f} ms, plain {plain:.4f} ms), relu "
        f"{relu:.4f} ms (earlier kernel {relu_earlier:.4f} ms), bound {row['bound_ms']:.4f} ms by {row['bound_by']}; "
        f"floors under this timer: an empty kernel {empty:.4f} ms, PyTorch's copy of x {copy:.4f} ms [{card}]")
    sass = sass_counts(_build.library_path("bias_act"), "bias_act")
    if sass is None:
        log("fused_bias_act SASS instruction counts: not measured (no cuobjdump beside nvcc)")
    else:
        for name, count in sorted(sass.items()):
            log(f"fused_bias_act SASS: {count} instructions (static, NOPs left out) in {name}")
    return row


def bn_unfolded_checks(torch, calls, timer, card):
    """The BN calls of an int8-compute forward (bf16 parameters, flax's
    unfolded order): kernel against plain and against the earlier kernel
    bitwise, times summed per bucket-64 forward beside the earlier kernel's;
    then a sweep (every act, bf16 and f32 input, C = 33, an unaligned base),
    bitwise the earlier kernel, and bitwise the plain version where the act
    is exact (sigmoid and gelu within the BN+act tolerance). Bytes: x in its
    own dtype (bf16 after an int8 conv, f32 after a float conv), f32 out, the
    three f32 vectors; operations: subtract, multiply, add per element."""
    from tensorflowdistributedlearning_tpu_torch.ops import kernels

    ms = plain = earlier = nbytes = flops = err = 0.0
    n_bf16 = n = 0
    gen = torch.Generator(device="cuda").manual_seed(SEED + 57)
    with torch.inference_mode():
        for xin, (mean, mul, bias), act in calls:
            got = kernels.bn_act_unfolded(xin, mean, mul, bias, act)
            want = kernels.bn_act_unfolded_plain(xin, mean, mul, bias, act)
            check(same(torch, got, want), f"unfolded BN+act {tuple(xin.shape)} {xin.dtype}: kernel != plain")
            check(same(torch, got, kernels._earlier_bn_act_unfolded(xin, mean, mul, bias, act)),
                  f"unfolded BN+act {tuple(xin.shape)} {xin.dtype}: not bitwise the earlier kernel")
            ms += timer.ms(lambda: kernels.bn_act_unfolded(xin, mean, mul, bias, act))
            earlier += timer.ms(lambda: kernels._earlier_bn_act_unfolded(xin, mean, mul, bias, act))
            plain += timer.ms(lambda: kernels.bn_act_unfolded_plain(xin, mean, mul, bias, act))
            nbytes += xin.element_size() * xin.numel() + 4 * got.numel() + 4 * 3 * mean.numel()
            flops += 3 * xin.numel()
            n_bf16 += xin.dtype == torch.bfloat16
        shapes = [tuple(c[0].shape) for c in calls]
        for dtype in ("bfloat16", "float32"):
            for x, (scale, bias, mean, var), _ in bn_sweep(torch, shapes, gen, dtype):
                vecs = kernels.unfold_bn_bf16(scale, bias, mean, var, 1e-3)
                for act in kernels.ACTIVATIONS:
                    what = f"fused_bn_act_bf16 sweep {tuple(x.shape)} {x.dtype} {act} base%16={x.data_ptr() % 16}"
                    got = kernels.bn_act_unfolded(x, *vecs, act)
                    check(same(torch, got, kernels._earlier_bn_act_unfolded(x, *vecs, act)),
                          f"{what}: not bitwise the earlier kernel")
                    err = max(err, held_close(torch, got, kernels.bn_act_unfolded_plain(x, *vecs, act), act, what))
                    n += 1
    row = dict(max_abs_err=err, ms=ms, plain_ms=plain, library_ms=None, earlier_ms=earlier,
               bound_ms=bound_ms(nbytes, flops), bound_by=bound_by(nbytes, flops))
    log(f"fused_bn_act_bf16: {len(calls)} int8-path calls ({n_bf16} with bf16 input) bitwise equal to the plain "
        f"version and to the earlier kernel, {n} sweep cases bitwise the earlier kernel (max|err| against plain "
        f"{err:.3g}); {ms:.4f} ms per bucket-{BUCKET} forward (earlier kernel {earlier:.4f} ms, plain {plain:.4f} ms, "
        f"bound {row['bound_ms']:.4f} ms by {row['bound_by']}, {nbytes / 1e6:.1f} MB) [{card}]")
    return row


def int8_phase(torch, model, cfg, card: str, timer=None, device: str = "cuda"):
    """int8-compute serving of the full-width model (the main path of this
    phase): export float32 and int8-compute artifacts from the same weights,
    serve the latter through the engine and over HTTP with launch counts per
    forward; then hold every int8 conv call of a bucket-64 forward, an odd
    sweep, the unfolded BN calls and fused_bias_act against their plain
    versions, compare the served probabilities with the plain
    forward, and print quantize-check's record against float32."""
    from tensorflowdistributedlearning_tpu_torch.ops import kernels
    from tensorflowdistributedlearning_tpu_torch.ops import quant_kernels as qk
    from tensorflowdistributedlearning_tpu_torch.serve import (
        InferenceEngine, MicroBatcher, ServingServer, bind_ephemeral,
    )
    from tensorflowdistributedlearning_tpu_torch.serve.quant_check import run_quant_check
    from tensorflowdistributedlearning_tpu_torch.train import serving

    rows = {}
    with tempfile.TemporaryDirectory(prefix="chip-smoke-int8-") as root:
        arts, nbytes = {}, {}
        for spec in ("float32", "int8-compute"):
            arts[spec] = os.path.join(root, spec)
            t0 = time.perf_counter()
            serving.export_serving_artifact(model, cfg, arts[spec], serving_dtype=spec)
            nbytes[spec] = os.path.getsize(os.path.join(arts[spec], serving.WEIGHTS_NAME))
            log(f"int8: exported the {spec} artifact in {time.perf_counter() - t0:.3f} s, weights {nbytes[spec]} bytes")
        check(nbytes["int8-compute"] <= 0.3 * nbytes["float32"], f"int8 artifact bytes {nbytes}")
        engine = InferenceEngine.from_artifact(arts["int8-compute"], device=device)
        qmodel = serving.load_model(arts["int8-compute"], device)
        n_quant = sum(isinstance(m, qk.QuantConv2d) for m in qmodel.modules())
        check(n_quant == PER_INT8_FORWARD["int8_conv2d"], f"{n_quant} int8 convs in the loaded model")
        warm = engine.warmup()
        log(f"int8: engine warmup s per bucket {json.dumps({str(b): round(s, 4) for b, s in warm.items()})}")
        batcher = MicroBatcher(engine, max_wait_ms=5.0, max_queue=256)
        server = ServingServer(engine, batcher, sock=bind_ephemeral("127.0.0.1", 0)).start()
        url = server.url + "/v1/predict"
        batches = []
        try:
            # the main path: counts from 0 just before, read just after
            kernels.reset_launch_counts()
            serve_fn = engine.serve_fn

            def recording(x):
                out = serve_fn(x)
                batches.append((np.array(x, copy=True), {k: v.cpu().numpy() for k, v in out.items()}))
                return out

            engine.serve_fn = recording
            sizes = [1, 3, 16, 7, 2, 12]
            inst = {i: make_instances(torch, n, SEED + 61 + i) for i, n in enumerate(sizes)}
            with ThreadPoolExecutor(max_workers=6) as pool:
                answered = dict(pool.map(lambda i: (i, post(url, {"instances": inst[i].tolist()})), range(len(sizes))))
            engine.serve_fn = serve_fn
            per_bucket, engine_ms = {}, {}
            for b in engine.buckets:
                x = make_instances(torch, b, SEED + 70 + b)
                lat = []
                for _ in range(2):
                    t0 = time.perf_counter()
                    status, _ = post(url, {"instances": x.tolist()})
                    lat.append(time.perf_counter() - t0)
                    check(status == 200, f"int8 bucket {b} request: HTTP {status}")
                per_bucket[b] = statistics.median(lat) * 1e3
                lat = []
                for _ in range(5):
                    t0 = time.perf_counter()
                    engine.infer(x)
                    lat.append(time.perf_counter() - t0)
                engine_ms[b] = statistics.median(lat) * 1e3
            profile = profile_forward(torch, engine, make_instances(torch, BUCKET, SEED + 80)) if device == "cuda" else []
            counts = kernels.launch_counts()
            forwards = sum(engine.bucket_hits.values())
        finally:
            server.shutdown()
        log(f"int8: {forwards} forwards, bucket hits {engine.bucket_hits}, launches {counts}")
        for b in engine.buckets:
            log(f"int8: bucket {b} p50 request latency {per_bucket[b]:.3f} ms over HTTP, engine forward "
                f"{engine_ms[b]:.3f} ms (pad, H2D, forward, D2H) [{card}]")
        for line in profile:
            log(f"profile int8-compute: {line} [{card}]")
        for name, per in PER_INT8_FORWARD.items():
            check(counts[name] == per * forwards,
                  f"int8 path: {name} launched {counts[name]} times in {forwards} forwards, expected {per} each")
        for i, (status, body) in answered.items():
            check(status == 200 and body["n"] == sizes[i], f"int8 request {i}: HTTP {status}")
            p = np.asarray(body["predictions"]["probabilities"], np.float32)
            check(p.shape == (sizes[i], 101, 101, 1) and bool(np.isfinite(p).all()), f"int8 request {i}: {p.shape}")
            check(np.array_equal(np.asarray(body["predictions"]["mask"], np.float32), (p > 0.5).astype(np.float32)),
                  f"int8 request {i}: mask != (probs > 0.5)")

        # each served batch against the int8-compute forward through the plain versions
        plain = {"depthwise_conv2d": kernels.depthwise_conv2d_plain, "bn_act_folded": kernels.bn_act_folded_plain,
                 "bn_act_unfolded": kernels.bn_act_unfolded_plain, "fused_sigmoid_mask": kernels.fused_sigmoid_mask_plain}
        with mock.patch.multiple(kernels, **plain), mock.patch.object(qk, "int8_conv2d_ohwi", qk.int8_conv2d_ohwi_plain):
            ref_serve = serving.make_serving_fn(qmodel, device, act_dtype=torch.bfloat16)
            before = kernels.launch_counts()
            worst = 0.0
            for bx, bout in batches:
                ref = ref_serve(bx)["probabilities"].cpu().numpy()
                d = float(np.abs(bout["probabilities"] - ref).max())
                worst = max(worst, d)
                check(d <= TOL_PROBS, f"int8 batch of {bx.shape[0]}: probs differ from the plain forward by {d}")
            x64 = torch.from_numpy(make_instances(torch, BUCKET, SEED + 90)).to(device, torch.bfloat16)
            with torch.inference_mode():
                ref_logits = qmodel(x64)
            check(kernels.launch_counts() == before, "the plain int8-compute forward launched a kernel")
        with torch.inference_mode():
            logits = qmodel(x64)
        d_logits = (logits - ref_logits).abs().max().item()
        check(d_logits <= TOL_PROBS * max(1.0, ref_logits.abs().max().item()),
              f"int8 bucket-64 logits differ from the plain forward by {d_logits}")
        log(f"int8: {len(batches)} served batches agree with the plain int8-compute forward, max|dprobs| {worst:.3g}; "
            f"bucket-64 logits (std {ref_logits.std().item():.3f}) max|dlogits| {d_logits:.3g}")

        record = run_quant_check(arts["float32"], arts["int8-compute"], device=device)
        log(f"int8: quantize-check of int8-compute against float32 (random weights: printed, not asserted): "
            f"{json.dumps(record)}")
        if device != "cuda":
            return counts, rows
        calls = capture_int8_calls(torch, qmodel, x64)
        check(len(calls["int8"]) == PER_INT8_FORWARD["int8_conv2d"], f"{len(calls['int8'])} int8 conv calls")
        check(len(calls["bn"]) == PER_INT8_FORWARD["fused_bn_act_bf16"], f"{len(calls['bn'])} BN calls")
        check(calls["dw"] == PER_INT8_FORWARD["depthwise_conv2d"], f"{calls['dw']} depthwise calls")
        rows.update(int8_conv_checks(torch, calls["int8"], timer, card))
        rows["fused_bn_act_bf16"] = bn_unfolded_checks(torch, calls["bn"], timer, card)
        rows["fused_bias_act"] = fused_bias_act_checks(torch, timer, card)
    return counts, rows


# where the phases leave copies of their run ledgers and profiler captures
# for the readers phase (set by main; None in a rehearsal of one phase)
KEEP_LEDGERS = None


def keep_ledgers(workdir: str, name: str) -> None:
    """Copy ``workdir``'s run ledgers (``telemetry.jsonl``,
    ``telemetry-{i}.jsonl``) and its ``profile/`` captures under
    ``KEEP_LEDGERS/name``, before the phase's temporary directory goes."""
    if KEEP_LEDGERS is None:
        return
    dst = os.path.join(KEEP_LEDGERS, name)
    os.makedirs(dst, exist_ok=True)
    for f in os.listdir(workdir):
        if f.startswith("telemetry") and f.endswith(".jsonl"):
            shutil.copy2(os.path.join(workdir, f), dst)
    if os.path.isdir(os.path.join(workdir, "profile")):
        shutil.copytree(os.path.join(workdir, "profile"), os.path.join(dst, "profile"))


def run_cli(argv):
    """``(rc, stdout)`` of the port's command line run in this process."""
    import io

    from tensorflowdistributedlearning_tpu_torch import __main__ as cli

    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        rc = cli.main(argv)
    return rc, buf.getvalue()


def readers_phase(torch, card: str, root: str, device: str = "cuda") -> dict:
    """The port's telemetry readers on the card host, over the ledgers the
    phases left under ``root`` (``keep_ledgers``): ``telemetry-report`` of
    each workdir as text and ``--json`` (the trainers' windows, the serve
    tier's windows, the two dp ranks' fleet section naming both, the
    trace section from the Xception trainer's cadence captures'
    ``ops.json``, read whole and through ``--trace-dir`` of one capture),
    ``--export-trace``, ``--register`` of two fits and ``--compare`` of
    them by workdir and by run id, and ``telemetry-top --once`` of each.
    Every command exits 0 with its sections non-empty. On the CPU
    (``device="cpu"``, a rehearsal) a capture holds no kernel."""
    out = {"workdirs": sorted(os.listdir(root)), "commands": 0}
    t0 = time.perf_counter()

    def cmd(argv, what):
        rc, text = run_cli(argv)
        out["commands"] += 1
        check(rc == 0 and text.strip(), f"readers {what}: rc {rc}, {len(text)} characters of output")
        return text

    for name in out["workdirs"]:
        wd = os.path.join(root, name)
        text = cmd(["telemetry-report", wd], f"report {name}")
        check("no ledger" not in text and text.count("\n") >= 3, f"readers report {name}: {text[:200]}")
        report = json.loads(cmd(["telemetry-report", wd, "--json"], f"report --json {name}"))
        check(report.get("header") and (report["run"]["windows"] or report.get("serve") or report.get("fleet")),
              f"readers report --json {name}: sections {sorted(report)}")
        frame = cmd(["telemetry-top", wd, "--once"], f"top {name}")
        check("no ledgers yet" not in frame, f"readers top {name}: {frame[:200]}")
        if name == "train-dp2":
            procs = [row["process_index"] for row in report["fleet"]["per_process"]]
            check(procs == [0, 1], f"readers: the dp fleet section names processes {procs}")
            out["fleet_processes"] = procs
        if name == "train-xception":
            trace = report["trace"]
            on_card = device == "cuda"
            check(trace and (bool(trace["top_ops"] and trace["buckets_ms"]) and "note" not in trace) == on_card,
                  f"readers: train-xception's trace section {trace}")
            captures = sorted(os.listdir(os.path.join(wd, "profile")))
            one = json.loads(cmd(["telemetry-report", wd, "--json", "--trace-dir",
                                  os.path.join(wd, "profile", captures[0]), "--top", "3"], "report --trace-dir"))
            check(len(one["trace"]["top_ops"]) == (3 if on_card else 0), f"readers --trace-dir: {one['trace']}")
            out["trace_ms"] = trace["buckets_ms"]
            out["trace_top"] = trace["top_ops"][0]["name"] if on_card else None
            log(f"readers: train-xception's {len(captures)} captures' ops.json: kernel ms by bucket "
                f"{json.dumps(trace['buckets_ms'])}, top kernel {out['trace_top']} [{card}]")
        if name == "serve-obs":
            path = os.path.join(root, "serve-obs.trace.json")
            written = json.loads(cmd(["telemetry-report", wd, "--export-trace", path], "--export-trace"))
            check(written["span_events"] > 0 and os.path.getsize(path) > 0, f"readers --export-trace: {written}")
            out["span_events"] = written["span_events"]
    registry = os.path.join(root, "registry")
    fits = [os.path.join(root, n) for n in ("fit-resnet50", "fit-xception")]
    rows = [json.loads(cmd(["telemetry-report", wd, "--register", "--registry-dir", registry], "--register"))
            for wd in fits]
    check(all(r["run_id"] and r["config_hash"] for r in rows), f"readers --register: {rows}")
    for refs in (fits, [r["run_id"] for r in rows]):
        cmp = json.loads(cmd(["telemetry-report", "--compare", *refs, "--registry-dir", registry, "--json"],
                             "--compare"))
        check(cmp["deltas"], f"readers --compare {refs}: {cmp}")
    cmd(["telemetry-report", "--compare", *fits], "--compare text")
    out["seconds"] = time.perf_counter() - t0
    log(f"readers: {out['commands']} telemetry-report / telemetry-top commands over {out['workdirs']} exit 0 with "
        f"their sections, in {out['seconds']:.3f} s; the dp fleet names processes {out.get('fleet_processes')}, "
        f"{out.get('span_events')} span events exported [{card}]")
    return out


def int8_arm(torch, name: str, art: str, card: str, device: str = "cuda", expect=None, bf16_art=None,
             seed: int = SEED + 300):
    """One phase's trained model served from its ``int8-compute`` export
    ``art`` at buckets 1 and 64 through the engine (the arm's path: counts
    from 0 just before, read just after, no HTTP): the loaded model's
    ``QuantConv2d`` / ``QuantLinear`` counts against ``expect`` (JAX's
    interceptor count, ``INT8_LAYERS``); every int8 conv and matmul call of
    the bucket-64 forward held bit for bit against its plain arm and timed
    by route (the launch alone: quantized operands, the epilogue; CUDA
    events, L2 flushed); each bucket's answers against the forward of the
    same loaded model through the plain versions; with ``bf16_art`` (the
    same weights under the bfloat16 spec) both engines' bucket-64 forwards
    timed in turns (bfloat16, int8-compute, int8-compute, bfloat16).
    ``device="cpu"`` rehearses it (no launches, no timing)."""
    from tensorflowdistributedlearning_tpu_torch.ops import kernels
    from tensorflowdistributedlearning_tpu_torch.ops import quant_kernels as qk
    from tensorflowdistributedlearning_tpu_torch.serve import InferenceEngine
    from tensorflowdistributedlearning_tpu_torch.train import serving

    on_card = device == "cuda"
    manifest = serving.read_manifest(art)
    check(serving.serving_spec(manifest) == "int8-compute", f"int8 {name}: {art} is not an int8-compute artifact")
    shape = tuple(manifest["input_shape"][1:])
    engine = InferenceEngine.from_artifact(art, device=device, buckets=INT8_ARM_BUCKETS)
    qmodel = serving.load_model(art, device)
    layers = (sum(isinstance(m, qk.QuantConv2d) for m in qmodel.modules()),
              sum(isinstance(m, qk.QuantLinear) for m in qmodel.modules()))
    check(expect is None or layers == tuple(expect),
          f"int8 {name}: {layers[0]} int8 convs and {layers[1]} int8 Dense loaded, JAX's interceptor routes {expect}")
    engine.warmup()
    rng = np.random.default_rng(seed)
    xs = {b: rng.normal(size=(b, *shape)).astype(np.float32) for b in INT8_ARM_BUCKETS}
    served, serve_ms = {}, {}
    # the arm's path: counts from 0 just before, read just after
    kernels.reset_launch_counts()
    for b in INT8_ARM_BUCKETS:
        t0 = time.perf_counter()
        served[b] = engine.infer(xs[b])
        serve_ms[b] = (time.perf_counter() - t0) * 1e3
    counts = kernels.launch_counts()
    forwards = len(INT8_ARM_BUCKETS)
    if on_card:
        check(counts["int8_conv2d"] == layers[0] * forwards and counts["int8_matmul"] == layers[1] * forwards,
              f"int8 {name}: launches {counts} in {forwards} forwards of {layers} int8 layers")
    per_forward = {k: v / forwards for k, v in counts.items() if v}
    versus = None
    if bf16_art is not None:
        engine16 = InferenceEngine.from_artifact(bf16_art, device=device, buckets=(BUCKET,))
        engine16.warmup()
        lat = {"bfloat16": [], "int8-compute": []}
        for spec in ("bfloat16", "int8-compute", "int8-compute", "bfloat16"):
            e = engine16 if spec == "bfloat16" else engine
            for _ in range(INT8_ARM_REPS):
                t0 = time.perf_counter()
                e.infer(xs[BUCKET])
                lat[spec].append(time.perf_counter() - t0)
        versus = {spec: statistics.median(v) * 1e3 for spec, v in lat.items()}
        del engine16

    # the answers against the same loaded model through the plain versions
    def matmul_nk_plain(x, wk, w_scale, *, bias=None, act="none", out_dtype=None):
        return qk.int8_matmul_plain(x, wk.t(), w_scale, bias=bias, act=act, out_dtype=out_dtype)

    plain = {"depthwise_conv2d": kernels.depthwise_conv2d_plain, "bn_act_folded": kernels.bn_act_folded_plain,
             "bn_act_unfolded": kernels.bn_act_unfolded_plain, "fused_sigmoid_mask": kernels.fused_sigmoid_mask_plain}
    dprobs = 0.0
    with mock.patch.multiple(kernels, **plain), mock.patch.object(qk, "int8_conv2d_ohwi", qk.int8_conv2d_ohwi_plain), \
            mock.patch.object(qk, "int8_matmul_nk", matmul_nk_plain):
        ref_serve = serving.make_serving_fn(qmodel, device, act_dtype=torch.bfloat16)
        before = kernels.launch_counts()
        for b in INT8_ARM_BUCKETS:
            ref = {k: v.cpu().numpy() for k, v in ref_serve(xs[b]).items()}
            got = served[b]
            check(got["probabilities"].shape == ref["probabilities"].shape
                  and bool(np.isfinite(got["probabilities"]).all()), f"int8 {name} bucket {b}: {got['probabilities'].shape}")
            d = float(np.abs(got["probabilities"] - ref["probabilities"]).max())
            dprobs = max(dprobs, d)
            check(d <= TOL_PROBS, f"int8 {name} bucket {b}: probabilities {d} from the plain-arm forward")
            if "class" in got:
                check_classes(got["probabilities"], got["class"], f"int8 {name} bucket {b}")
        check(kernels.launch_counts() == before, f"int8 {name}: the plain-arm forward launched a kernel")

    # every int8 call of the bucket-64 forward, bit for bit its plain arm, timed by route
    calls = []
    hooks = [m.register_forward_pre_hook(lambda mod, args: calls.append((args[0].contiguous(), mod)))
             for m in qmodel.modules() if isinstance(m, (qk.QuantConv2d, qk.QuantLinear))]
    x64 = torch.from_numpy(xs[BUCKET]).to(device, torch.bfloat16)
    try:
        with torch.inference_mode():
            qmodel(x64)
    finally:
        for h in hooks:
            h.remove()
    check(len(calls) == sum(layers), f"int8 {name}: {len(calls)} int8 calls in one forward of {layers} layers")
    timer = Timer(torch) if on_card else None
    routes = {}
    with torch.inference_mode():
        for i, (x, mod) in enumerate(calls):
            if isinstance(mod, qk.QuantLinear):
                got = qk.int8_matmul_nk(x, mod.weight_q, mod.w_scale, bias=mod.bias, out_dtype=torch.bfloat16)
                want = qk.int8_matmul_plain(x, mod.weight_q.t(), mod.w_scale, bias=mod.bias, out_dtype=torch.bfloat16)
                xq, xs_ = qk.quantize_activations(x)
                xq = xq.reshape(-1, x.shape[-1])
                route = f"matmul_{qk.matmul_route(x.shape[-1])}"
                out = torch.empty_like(got).reshape(xq.shape[0], -1)

                def launch():
                    qk._launch_matmul(xq, xs_, mod.weight_q, mod.w_scale, mod.bias, out, "none")
            else:
                got = qk.int8_conv2d_ohwi(x, mod.weight_q, mod.w_scale, mod.pads, bias=mod.bias, out_dtype=torch.bfloat16)
                want = qk.int8_conv2d_ohwi_plain(x, mod.weight_q, mod.w_scale, mod.pads, bias=mod.bias,
                                                 out_dtype=torch.bfloat16)
                xq, xs_ = qk.quantize_activations(x)
                out = torch.empty_like(got)
                cout, kh, kw, cin = mod.weight_q.shape
                route = qk.conv_route(kh, kw, cin, mod.pads, xq.data_ptr() % 16 == 0 and mod.weight_q.data_ptr() % 16 == 0)

                def launch():
                    qk._launch_conv(xq, xs_, mod.weight_q, mod.w_scale, mod.bias, out, mod.pads, "none")
            check(bits_equal(torch, got, want), f"int8 {name} call {i} {tuple(x.shape)} ({route}): kernel != plain "
                  f"({int((got != want).sum())} elements differ)")
            r = routes.setdefault(route, {"calls": 0, "ms": 0.0, "cin": {}})
            r["calls"] += 1
            r["cin"][x.shape[-1]] = r["cin"].get(x.shape[-1], 0) + 1
            if timer is not None:
                r["ms"] += timer.ms(launch)
    total = sum(r["ms"] for r in routes.values())
    log(f"int8 {name}: the int8-compute export loaded {layers[0]} int8 convs and {layers[1]} int8 Dense "
        f"(JAX's interceptor: {expect}); buckets {'/'.join(map(str, INT8_ARM_BUCKETS))} through the engine "
        f"{' / '.join(f'{serve_ms[b]:.3f}' for b in INT8_ARM_BUCKETS)} ms, launches per forward "
        f"{json.dumps(per_forward)}; answers max|dprobs| {dprobs:.3g} from the plain-arm forward [{card}]")
    if versus is not None:
        log(f"int8 {name}: engine forward at bucket {BUCKET} (pad, H2D, forward, D2H), median of {2 * INT8_ARM_REPS} "
            f"in turns: int8-compute {versus['int8-compute']:.3f} ms, bfloat16 spec {versus['bfloat16']:.3f} ms, "
            f"ratio {versus['int8-compute'] / versus['bfloat16']:.3f} [{card}]")
    for route, r in sorted(routes.items()):
        share = f", {r['ms'] / total:.3f} of the int8 time" if total else ""
        log(f"int8 {name}: route {route}: {r['calls']} calls per bucket-{BUCKET} forward (Cin {json.dumps(r['cin'])}), "
            f"each bit for bit its plain arm, {r['ms']:.4f} ms summed{share} [{card}]")
    return {"launches": counts, "forwards": forwards, "layers": list(layers), "serve_ms": serve_ms, "versus": versus,
            "routes": {k: {"calls": r["calls"], "ms": r["ms"]} for k, r in routes.items()}, "dprobs": dprobs}


# -- the ViT-S/16 classifier ------------------------------------------------------


def attention_atol(v) -> float:
    return TOL_ATTN_ATOL * max(1.0, v.abs().max().item())


def bf16_step_apart(torch, got, want, atol: float):
    """How far two bf16 results of one float32 computation may be apart,
    and are: each is its float32 value rounded once to bf16, and the two
    float32 values agree to the float32 tolerance (rtol 2e-5, atol),
    so they may differ by that plus one bf16 step (the spacing at the larger
    magnitude). ``atol`` is :func:`attention_atol` of the inputs. Returns
    (within, worst index, got, want) for the message."""
    g, w = got.float(), want.float()
    _, e = torch.frexp(torch.maximum(g.abs(), w.abs()))
    step = torch.ldexp(torch.ones_like(g), (e - 8).clamp_min(-133))
    excess = (g - w).abs() - (step + TOL_ATTN_RTOL * w.abs() + atol)
    i = int(excess.flatten().argmax())
    return bool((excess <= 0).all()), i, g.flatten()[i].item(), w.flatten()[i].item()


def check_bf16_step(torch, got, want, atol: float, what: str) -> None:
    ok, i, g, w = bf16_step_apart(torch, got, want, atol)
    check(got.dtype == torch.bfloat16 and ok,
          f"{what}: kernel and plain more than one bf16 step beyond the float32 tolerance apart "
          f"(element {i}: kernel {g!r}, plain {w!r})")


def make_vit_instances(n: int, seed: int, shape=(224, 224, 3)):
    """Seeded float32 images (224x224x3 for the preset), standard normal:
    what an ImageNet pipeline hands the model after its normalization."""
    return np.random.default_rng(seed).normal(size=(n, *shape)).astype(np.float32)


def calibrate_logits(torch, model, x) -> None:
    """Scale a classifier's ``logits`` Dense so the logits of ``x`` have std
    3: random weights otherwise give near-uniform (or saturated)
    probabilities over 1000 classes, and comparisons of them would say
    little."""
    with torch.inference_mode():
        std = model(x).float().std()
        model.logits.weight.mul_(3.0 / std)


def attention_flops(shape, causal: bool = False) -> float:
    b, t, h, d = shape
    pairs = t * (t + 1) / 2 if causal else t * t
    return 4.0 * b * h * pairs * d


def capture_attention_calls(torch, model, x):
    """One forward with every ``flash_attention`` call's q, k, v recorded
    (the strided views the model hands the kernel)."""
    from tensorflowdistributedlearning_tpu_torch.ops import flash_attention as fa

    calls = []
    real = fa.flash_attention

    def recording(q, k, v, *, causal=False):
        calls.append((q, k, v))
        return real(q, k, v, causal=causal)

    with mock.patch.object(fa, "flash_attention", recording), torch.inference_mode():
        model(x)
    return calls


def attention_checks(torch, bf16_calls, f32_calls, timer, card):
    """The kernels against their plain version at the 12 path calls of a
    bucket-64 forward (bf16, the preset, through the tensor-core arm;
    float32, the float32-compute variant, through the CUDA-core arm) and on
    an odd sweep; each arm timed summed over its forward's 12 calls beside
    its bound and SDPA on the same tensors. The earlier CUDA-core kernel
    (``flash_attention.cu``, which the wrapper no longer picks for either
    dtype) is timed beside each arm on the same inputs. Returns the two
    rows."""
    import torch.nn.functional as F

    from tensorflowdistributedlearning_tpu_torch.ops import flash_attention as fa
    from tensorflowdistributedlearning_tpu_torch.ops import kernels

    err = {"bf16": 0.0, "f32": 0.0}  # max |kernel - plain| per arm, path and sweep
    with torch.inference_mode():
        for dtype, calls in (("bf16", bf16_calls), ("f32", f32_calls)):
            before = kernels.launch_counts()
            for i, (q, k, v) in enumerate(calls):
                got, want = fa.flash_attention(q, k, v), fa.flash_attention_plain(q, k, v)
                what = f"flash_attention path call {i} {dtype} {tuple(q.shape)} strides {q.stride()}"
                if dtype == "f32":
                    torch.testing.assert_close(got, want, rtol=TOL_ATTN_RTOL, atol=attention_atol(v),
                                               msg=lambda m: f"{what}: {m}")
                else:
                    check_bf16_step(torch, got, want, attention_atol(v), what)
                err[dtype] = max(err[dtype], (got.float() - want.float()).abs().max().item())
            tc = kernels.launch_counts()["flash_attention_tc"] - before["flash_attention_tc"]
            check(tc == (len(calls) if dtype == "bf16" else 0),
                  f"flash_attention: {tc} of the {len(calls)} {dtype} path calls took the tensor-core arm")
        log(f"flash_attention: {len(bf16_calls)} bf16 path calls (all through the tensor-core arm) and "
            f"{len(f32_calls)} float32 path calls (the CUDA-core arm) held against the plain version (float32 "
            f"rtol {TOL_ATTN_RTOL} atol {TOL_ATTN_ATOL}·max(1, max|v|); bf16 one bf16 step beyond that), "
            f"max|err| bf16 {err['bf16']:.3g}, float32 {err['f32']:.3g}")
        gen = torch.Generator(device="cuda").manual_seed(SEED + 61)
        sweep = [(2, 196, 6, 64, True), (3, 1, 2, 64, False), (1, 1, 1, 64, True), (2, 197, 6, 64, False),
                 (2, 197, 3, 64, True), (1, 300, 2, 64, False), (2, 300, 1, 64, True), (2, 196, 4, 32, False),
                 (1, 300, 2, 32, True), (2, 196, 2, 128, False), (1, 257, 2, 128, True), (1, 196, 1, 64, False),
                 (1, 300, 1, 16, True)]
        # T around the 32-row query tiles and 16-key chunks, both maskings
        sweep += [(2, t, 3, 64, causal) for t in (1, 63, 65, 196, 257) for causal in (False, True)]
        # the head widths between 16 and 128 that are not powers of two
        sweep += [(2, 150, 2, d, causal) for d in (48, 80, 96, 112) for causal in (False, True)]
        n = 0
        for b, t, h, d, causal in sweep:
            qkv = 2 * torch.randn(b, t, 3, h, d, device="cuda", generator=gen)
            flat = 2 * torch.randn(b * t * h * d + 1, device="cuda", generator=gen)
            for dt in (torch.float32, torch.bfloat16):
                x = qkv.to(dt)
                unaligned = flat.to(dt)[1:].view(b, t, h, d)  # base 4 (2) bytes past 16-byte alignment
                for q, k, v in ((x[:, :, 0], x[:, :, 1], x[:, :, 2]),
                                tuple(x[:, :, j].contiguous() for j in range(3)),
                                (unaligned, x[:, :, 1], x[:, :, 2])):
                    got, want = fa.flash_attention(q, k, v, causal=causal), fa.flash_attention_plain(q, k, v, causal=causal)
                    what = (f"flash_attention sweep {(b, t, h, d)} causal={causal} {dt} contiguous={q.is_contiguous()} "
                            f"base%16={q.data_ptr() % 16}")
                    if dt == torch.float32:
                        torch.testing.assert_close(got, want, rtol=TOL_ATTN_RTOL, atol=attention_atol(v),
                                                   msg=lambda m: f"{what}: {m}")
                    else:
                        check_bf16_step(torch, got, want, attention_atol(v), what)
                    arm = "f32" if dt == torch.float32 else "bf16"
                    err[arm] = max(err[arm], (got.float() - want.float()).abs().max().item())
                    n += 1
        log(f"flash_attention: odd sweep (causal and not; T = 1, 63, 65, 196, 197, 257, 300; D = 16 to 128 in steps "
            f"of 16; B·H = 1; strided, contiguous and an unaligned base; both arms), {n} cases within tolerance")

        rows = {}
        for arm, calls, peak, peak_name in (("bf16", bf16_calls, PEAK_BF16_FLOP_S, "989 TFLOP/s bf16"),
                                            ("f32", f32_calls, PEAK_F32_FLOP_S, "67 TFLOP/s f32")):
            ms = plain = lib = earlier = nbytes = flops = 0.0
            for q, k, v in calls:
                ms += timer.ms(lambda: fa.flash_attention(q, k, v))
                plain += timer.ms(lambda: fa.flash_attention_plain(q, k, v))
                qt, kt, vt = (a.transpose(1, 2) for a in (q, k, v))
                lib += timer.ms(lambda: F.scaled_dot_product_attention(qt, kt, vt))
                # the earlier CUDA-core kernel (flash_attention.cu) on the same inputs
                earlier += timer.ms(lambda: fa._launch("tfdl_flash_attention", q, k, v, False))
                nbytes += 4 * q.numel() * q.element_size()
                flops += attention_flops(q.shape)
            t_bytes, t_ops = nbytes / PEAK_BYTES_S, flops / peak
            rows[arm] = dict(max_abs_err=err[arm], ms=ms, plain_ms=plain, library_ms=lib, earlier_ms=earlier,
                             bound_ms=max(t_bytes, t_ops) * 1e3, bound_by="bytes" if t_bytes >= t_ops else "operations")
            extra = f", the earlier CUDA-core kernel (flash_attention.cu) on the same {arm} inputs {earlier:.4f} ms"
            if arm == "bf16":
                extra += f"; the float32 bound of FMAs on the CUDA cores would be {flops / PEAK_F32_FLOP_S * 1e3:.4f} ms"
            log(f"flash_attention {arm} arm: per bucket-{BUCKET} forward ({len(calls)} calls, "
                f"{tuple(calls[0][0].shape)} {calls[0][0].dtype}): kernel {ms:.4f} ms, plain {plain:.4f} ms, SDPA "
                f"{lib:.4f} ms; bound {rows[arm]['bound_ms']:.4f} ms by {rows[arm]['bound_by']} ({nbytes / 1e9:.4f} GB "
                f"over 3.35 TB/s, {flops / 1e9:.2f} GFLOP over {peak_name}); the kernel reaches "
                f"{flops / ms / 1e9:.2f} TFLOP/s{extra} [{card}]")
    return rows["bf16"], rows["f32"]


def vit_plain_serve(torch, model, device, act_dtype):
    """The serving closure of ``model`` with the attention and int8 matmul
    kernels replaced by their plain versions (a context manager's worth of
    patches, returned with the closure)."""
    from tensorflowdistributedlearning_tpu_torch.ops import flash_attention as fa
    from tensorflowdistributedlearning_tpu_torch.ops import quant_kernels as qk
    from tensorflowdistributedlearning_tpu_torch.train import serving

    def plain_nk(x, wk, w_scale, **kw):
        return qk.int8_matmul_plain(x, wk.t(), w_scale, **kw)

    patches = [mock.patch.object(fa, "flash_attention", fa.flash_attention_plain),
               mock.patch.object(qk, "int8_matmul_nk", plain_nk)]
    return serving.make_serving_fn(model, device, act_dtype=act_dtype), patches


def check_classes(p, cls, what: str) -> None:
    """``class`` is an argmax of ``probabilities`` on every row."""
    check(cls.dtype == np.int32 and cls.shape == p.shape[:1], f"{what}: class {cls.dtype} {cls.shape}")
    check(bool(np.isfinite(p).all()), f"{what}: non-finite probabilities")
    check(np.array_equal(p[np.arange(p.shape[0]), cls], p.max(-1)), f"{what}: class is not the argmax")


def compare_with_plain(torch, batches, model, device, act_dtype, tol, what):
    """Each served batch (padded engine input, outputs) against the same
    batch through the plain versions; returns the largest difference."""
    from tensorflowdistributedlearning_tpu_torch.ops import kernels

    ref_serve, patches = vit_plain_serve(torch, model, device, act_dtype)
    worst = 0.0
    with contextlib.ExitStack() as stack:
        for p in patches:
            stack.enter_context(p)
        before = kernels.launch_counts()
        for bx, bout in batches:
            ref = {k: v.cpu().numpy() for k, v in ref_serve(bx).items()}
            d = float(np.abs(bout["probabilities"] - ref["probabilities"]).max())
            worst = max(worst, d)
            check(d <= tol, f"{what}: a batch of {bx.shape[0]} differs from the plain forward by {d} > {tol}")
            top2 = np.sort(ref["probabilities"], axis=-1)[:, -2:]
            apart = top2[:, 1] - top2[:, 0] > 2 * tol
            check(np.array_equal(bout["class"][apart], ref["class"][apart]), f"{what}: class differs from plain")
        check(kernels.launch_counts() == before, f"{what}: the plain forward launched a kernel")
    return worst


def int8_swap_is_bitwise(torch, batches, model, device, act_dtype) -> int:
    """Each served int8-compute batch again with only the int8 matmul
    replaced by its plain version (the attention kernel kept): the outputs
    must be bit for bit the served ones. Returns the batches compared."""
    from tensorflowdistributedlearning_tpu_torch.ops import kernels
    from tensorflowdistributedlearning_tpu_torch.ops import quant_kernels as qk
    from tensorflowdistributedlearning_tpu_torch.train import serving

    def plain_nk(x, wk, w_scale, **kw):
        return qk.int8_matmul_plain(x, wk.t(), w_scale, **kw)

    serve = serving.make_serving_fn(model, device, act_dtype=act_dtype)
    with mock.patch.object(qk, "int8_matmul_nk", plain_nk):
        kernels.reset_launch_counts()
        for bx, bout in batches:
            out = {k: v.cpu().numpy() for k, v in serve(bx).items()}
            for k in bout:
                check(np.array_equal(out[k], bout[k]), f"int8-compute batch of {bx.shape[0]}: {k} with the plain int8 "
                      "matmul differs from the served one")
        counts = kernels.launch_counts()
    check(counts["int8_matmul"] == 0 and counts["flash_attention"] == counts["flash_attention_tc"] == 12 * len(batches),
          f"the plain-int8 forward launched {counts}")
    return len(batches)


def serve_vit_spec(torch, model, cfg, spec, card, root, buckets, http_sizes, seed, device="cuda"):
    """Export ``model`` under ``spec``, serve it through the engine (and,
    when ``http_sizes``, over HTTP): the main path, counts from 0 just
    before and read just after. Returns the launch counts, the forwards,
    the recorded engine batches and the loaded model."""
    shape = (*cfg.input_shape, cfg.input_channels)
    from tensorflowdistributedlearning_tpu_torch.ops import kernels
    from tensorflowdistributedlearning_tpu_torch.serve import (
        InferenceEngine, MicroBatcher, ServingServer, bind_ephemeral,
    )
    from tensorflowdistributedlearning_tpu_torch.train import serving

    art = os.path.join(root, f"{cfg.dtype}-{spec}")
    t0 = time.perf_counter()
    serving.export_serving_artifact(model, cfg, art, serving_dtype=spec)
    size = os.path.getsize(os.path.join(art, serving.WEIGHTS_NAME))
    manifest = serving.read_manifest(art)
    check(manifest["task"] == "classification" and manifest["num_classes"] == cfg.num_classes
          and manifest["outputs"]["class"]["dtype"] == "int32", f"vit {spec}: manifest {manifest['outputs']}")
    engine = InferenceEngine.from_artifact(art, device=device, buckets=buckets)
    warm = engine.warmup()
    tag = f"vit {cfg.dtype}-compute {spec}"
    log(f"{tag}: exported in {time.perf_counter() - t0:.3f} s, weights {size} bytes; warmup s per bucket "
        f"{json.dumps({str(b): round(s, 4) for b, s in warm.items()})}")
    batches, lat_http, lat_engine = [], {}, {}
    serve_fn = engine.serve_fn

    def recording(x):
        out = serve_fn(x)
        batches.append((np.array(x, copy=True), {k: v.cpu().numpy() for k, v in out.items()}))
        return out

    server = None
    if http_sizes:
        batcher = MicroBatcher(engine, max_wait_ms=5.0, max_queue=64)
        server = ServingServer(engine, batcher, sock=bind_ephemeral("127.0.0.1", 0)).start()
    try:
        kernels.reset_launch_counts()
        engine.serve_fn = recording
        for b in http_sizes:
            x = make_vit_instances(b, seed + b, shape)
            lat = []
            for _ in range(VIT_HTTP_REPS):
                t0 = time.perf_counter()
                status, body = post(server.url + "/v1/predict", {"instances": x.tolist()})
                lat.append(time.perf_counter() - t0)
                check(status == 200 and body["n"] == b, f"{tag}: {b} instances over HTTP: {status}")
            p = np.asarray(body["predictions"]["probabilities"], np.float32)
            cls = np.asarray(body["predictions"]["class"])
            check(p.shape == (b, cfg.num_classes) and cls.shape == (b,), f"{tag}: HTTP shapes {p.shape} {cls.shape}")
            check_classes(p, cls.astype(np.int32), f"{tag} HTTP {b}")
            lat_http[b] = statistics.median(lat) * 1e3
        for b in buckets:
            x = make_vit_instances(b, seed + 100 + b, shape)
            lat = []
            for _ in range(3):
                t0 = time.perf_counter()
                out = engine.infer(x)
                lat.append(time.perf_counter() - t0)
            check(out["probabilities"].shape == (b, cfg.num_classes), f"{tag}: engine shape {out['probabilities'].shape}")
            check_classes(out["probabilities"], out["class"], f"{tag} engine bucket {b}")
            lat_engine[b] = statistics.median(lat) * 1e3
        counts = kernels.launch_counts()
        forwards = sum(engine.bucket_hits.values())
    finally:
        engine.serve_fn = serve_fn
        if server is not None:
            server.shutdown()
    for b, ms in lat_http.items():
        log(f"{tag}: {b} instances p50 request latency {ms:.3f} ms over HTTP [{card}]")
    for b, ms in lat_engine.items():
        log(f"{tag}: engine bucket {b} p50 forward {ms:.3f} ms (pad, H2D, forward, D2H), "
            f"{b / ms * 1e3:.1f} images/s [{card}]")
    return dict(art=art, counts=counts, forwards=forwards, batches=batches, engine=engine,
                model=serving.load_model(art, device), act_dtype=serving.quantize.compute_dtype(spec))


def vit_phase(torch, card: str, timer, device: str = "cuda", cfg=None):
    """Serving of the vit_s16_imagenet preset (full width and depth, bf16
    compute, fused attention; seeded random weights, the logits calibrated
    to std 3): the main paths are the float32 and int8-compute specs of the
    preset and the float32 spec of a float32-compute variant, each exported
    and served through the engine at buckets 1/4/16/64 and over HTTP at
    1/4/16 instances, with 12 flash_attention launches per forward (plus 49
    int8_matmul under int8-compute) and no segmenter kernel; the preset's
    bfloat16 and int8 storage specs are served at bucket 64. Served
    probabilities are held against the plain forward on the card; the
    kernels against their plain versions at the path's calls; the
    bucket-64 forwards of the three main paths are profiled. ``cfg`` (default the preset) and
    ``device="cpu"`` rehearse the serving part on the CPU at a small size;
    the kernel checks and profiles need the card."""
    import dataclasses

    from tensorflowdistributedlearning_tpu_torch.configs import get_preset
    from tensorflowdistributedlearning_tpu_torch.models import build_model
    from tensorflowdistributedlearning_tpu_torch.ops import quant_kernels as qk

    preset = cfg is None
    cfg = get_preset(VIT_PRESET).model if preset else cfg
    shape = (*cfg.input_shape, cfg.input_channels)
    t0 = time.perf_counter()
    model = build_model(cfg, "cpu", generator=torch.Generator().manual_seed(SEED + 60)).to(device).eval()
    calibrate_logits(torch, model, torch.from_numpy(make_vit_instances(16, SEED + 62, shape)).to(device))
    n_params = sum(p.numel() for p in model.parameters())
    log(f"vit: {VIT_PRESET if preset else cfg} (embed {cfg.embed_dim}, {cfg.vit_layers} layers, {cfg.num_heads} "
        f"heads, patch {cfg.patch_size}, {cfg.dtype}, fused attention {cfg.use_fused_attention}), {n_params} "
        f"parameters, built in {time.perf_counter() - t0:.3f} s")
    check(not preset or n_params == 22_049_896, f"vit parameters {n_params}")
    cfg32 = dataclasses.replace(cfg, dtype="float32")
    model32 = build_model(cfg32, "cpu").to(device).eval()
    model32.load_state_dict(model.state_dict())

    paths, rows = {}, {}
    with tempfile.TemporaryDirectory(prefix="chip-smoke-vit-") as root:
        runs = {}
        for key, m, c, spec, buckets, http, tol in (
            ("vit", model, cfg, "float32", (1, 4, 16, 64), (1, 4), TOL_VIT_BF16),
            ("vit-int8-compute", model, cfg, "int8-compute", (1, 4, 16, 64), (1, 4), TOL_VIT_BF16),
            ("vit-f32", model32, cfg32, "float32", (1, 4, 16, 64), (1, 4), TOL_VIT_F32),
            ("vit-bfloat16", model, cfg, "bfloat16", (64,), (), TOL_VIT_BF16),
            ("vit-int8", model, cfg, "int8", (64,), (), TOL_VIT_BF16),
        ):
            run = serve_vit_spec(torch, m, c, spec, card, root, buckets, http, SEED + 70 + 1000 * len(runs), device)
            per = (PER_VIT_INT8_FORWARD if spec == "int8-compute"
                   else PER_VIT_F32_FORWARD if c.dtype == "float32" else PER_VIT_FORWARD)
            for name, n in per.items():
                check(run["counts"][name] == n * run["forwards"],
                      f"{key}: {name} launched {run['counts'][name]} times in {run['forwards']} forwards, "
                      f"expected {n} each")
            worst = compare_with_plain(torch, run["batches"], run["model"], device, run["act_dtype"], tol, key)
            log(f"{key}: {run['forwards']} forwards launched {run['counts']}; {len(run['batches'])} served batches "
                f"agree with the plain forward on the card, max|dprobs| {worst:.3g} (bound {tol})")
            if spec == "int8-compute" and device == "cuda":
                n = int8_swap_is_bitwise(torch, run["batches"], run["model"], device, run["act_dtype"])
                log(f"{key}: {n} served batches bit for bit equal with the int8 matmul's plain version in place of "
                    f"the kernel")
            runs[key] = run
            paths[key] = run["counts"]

        if device != "cuda":
            return paths, rows
        for key in ("vit", "vit-int8-compute", "vit-f32"):
            for line in profile_forward(torch, runs[key]["engine"], make_vit_instances(BUCKET, SEED + 95, shape)):
                log(f"profile {key}: {line} [{card}]")

        x64 = torch.from_numpy(make_vit_instances(BUCKET, SEED + 96, shape)).to(device)
        bf16_calls = capture_attention_calls(torch, model, x64)
        f32_calls = capture_attention_calls(torch, model32, x64)
        check(len(bf16_calls) == len(f32_calls) == 12, f"attention calls {len(bf16_calls)}, {len(f32_calls)}")
        rows["flash_attention"], rows["flash_attention_f32"] = attention_checks(torch, bf16_calls, f32_calls, timer,
                                                                                 card)
        del bf16_calls, f32_calls

        qmodel = runs["vit-int8-compute"]["model"]
        int8_calls = []
        handles = [mod.register_forward_pre_hook(lambda mod, args: int8_calls.append((args[0].contiguous(), mod)))
                   for mod in qmodel.modules() if isinstance(mod, qk.QuantLinear)]
        try:
            with torch.inference_mode():
                qmodel(x64.to(torch.bfloat16))
        finally:
            for h in handles:
                h.remove()
        check(len(int8_calls) == PER_VIT_INT8_FORWARD["int8_matmul"], f"{len(int8_calls)} int8 matmul calls")
        rows["int8_matmul"], rows["int8_matmul_conv"] = int8_matmul_checks(torch, int8_calls, timer, card)
    return paths, rows


# -- ViT training -------------------------------------------------------------


def vit_train_config(steps_every: int):
    """The preset's ModelConfig and TrainConfig (AdamW 1e-3, weight decay
    0.1 on the kernels, clip 1.0, label smoothing 0.1, flip_crop, cosine
    with warmup) with checkpoints and evals every ``steps_every`` steps."""
    import dataclasses

    from tensorflowdistributedlearning_tpu_torch.configs import get_preset

    preset = get_preset(VIT_PRESET)
    tcfg = dataclasses.replace(preset.train, checkpoint_every_steps=steps_every, eval_every_steps=steps_every,
                               seed=SEED % 1000, save_best=2)
    return preset.model, tcfg


def capture_training_attention(torch, state, task, batch):
    """One training forward and backward (``step.forward_backward``) with
    every ``flash_attention`` call recorded: its inputs (the strided views
    of qkv), its output and the cotangent of its output. Returns the loss
    and the calls; the gradients stay in the parameters' ``.grad``."""
    from tensorflowdistributedlearning_tpu_torch.ops import flash_attention as fa
    from tensorflowdistributedlearning_tpu_torch.train import step as step_lib

    calls = []
    real = fa.flash_attention

    def recording(q, k, v, *, causal=False):
        out = real(q, k, v, causal=causal)
        rec = {"q": q.detach(), "k": k.detach(), "v": v.detach(), "out": out.detach(), "causal": causal,
               "grad": q.requires_grad}
        calls.append(rec)
        if out.requires_grad:
            out.register_hook(lambda g, rec=rec: rec.__setitem__("g", g.detach()))
        return out

    with mock.patch.object(fa, "flash_attention", recording):
        loss, _ = step_lib.forward_backward(state, task, batch)
    return loss, calls


def hold_attention_forward(torch, rec, what: str) -> float:
    """A training call's output (the kernel's) against the plain version on
    its inputs, at the forward's tolerance for its dtype; max|err|."""
    from tensorflowdistributedlearning_tpu_torch.ops import flash_attention as fa

    q, k, v, got = rec["q"], rec["k"], rec["v"], rec["out"]
    with torch.no_grad():
        want = fa.flash_attention_plain(q, k, v, causal=rec["causal"])
    if got.dtype == torch.float32:
        torch.testing.assert_close(got, want, rtol=TOL_ATTN_RTOL, atol=attention_atol(v), msg=lambda m: f"{what}: {m}")
    else:
        check_bf16_step(torch, got, want, attention_atol(v), what)
    return (got.float() - want.float()).abs().max().item()


def hold_attention_backward(torch, rec, what: str):
    """The CUDA arm's dq, dk, dv (autograd through the kernel, on views of
    one qkv tensor laid out as the model's) against the plain arm's
    (``flash_attention_backward`` on the same inputs and cotangent): the
    same function on the same tensors, so bit for bit is expected; held to
    the forward's tolerance and reported bitwise or not. Returns (bitwise,
    max|err|)."""
    from tensorflowdistributedlearning_tpu_torch.ops import flash_attention as fa

    q, k, v, g = rec["q"], rec["k"], rec["v"], rec["g"]
    qkv = torch.stack([q, k, v], dim=2).requires_grad_(True)
    fa.flash_attention(qkv[:, :, 0], qkv[:, :, 1], qkv[:, :, 2], causal=rec["causal"]).backward(g)
    views = [qkv.detach()[:, :, j] for j in range(3)]
    want = fa.flash_attention_backward(*views, g, causal=rec["causal"])
    bitwise, err = True, 0.0
    for j, w in enumerate(want):
        got = qkv.grad[:, :, j]
        bitwise &= same(torch, got, w)
        err = max(err, (got.float() - w.float()).abs().max().item())
        if got.dtype == torch.float32:
            torch.testing.assert_close(got, w, rtol=TOL_ATTN_RTOL, atol=attention_atol(w),
                                       msg=lambda m: f"{what} d{'qkv'[j]}: {m}")
        else:
            check_bf16_step(torch, got, w, attention_atol(w), f"{what} d{'qkv'[j]}")
    return bitwise, err


def attention_backward_flops(shape) -> float:
    """The backward's products (JAX's _flash_bwd): S = q·kᵀ, dV = Pᵀ·g,
    dP = g·vᵀ, dQ = dS·k, dK = dSᵀ·q, each 2·B·H·T²·D."""
    b, t, h, d = shape
    return 10.0 * b * h * t * t * d


def time_attention_backward(torch, calls, timer, card):
    """The attention backwards of one train step (plain PyTorch, float32
    math) timed summed over the step's calls, beside their bound (the five
    products in float32 on the CUDA cores, TF32 off; the bytes of q, k, v,
    g read once and dq, dk, dv written once) and beside SDPA's forward and
    backward on the same tensors (a yardstick; the port never calls it)."""
    import torch.nn.functional as F

    from tensorflowdistributedlearning_tpu_torch.ops import flash_attention as fa

    ms = lib = nbytes = flops = 0.0
    for rec in calls:
        q, k, v, g = rec["q"], rec["k"], rec["v"], rec["g"]
        ms += timer.ms(lambda: fa.flash_attention_backward(q, k, v, g), reps=10, warmup=2)
        qt, kt, vt = (a.transpose(1, 2).detach().requires_grad_(True) for a in (q, k, v))
        gt = g.transpose(1, 2)

        def sdpa():
            out = F.scaled_dot_product_attention(qt, kt, vt)
            torch.autograd.grad(out, (qt, kt, vt), gt)

        lib += timer.ms(sdpa, reps=10, warmup=2)
        nbytes += 7 * q.numel() * q.element_size()
        flops += attention_backward_flops(q.shape)
    t_bytes, t_ops = nbytes / PEAK_BYTES_S, flops / PEAK_F32_FLOP_S
    bound = max(t_bytes, t_ops) * 1e3
    row = dict(ms=ms, bound_ms=bound, bound_by="bytes" if t_bytes >= t_ops else "operations", sdpa_fwd_bwd_ms=lib,
               calls=len(calls), bf16_tensor_core_bound_ms=max(t_bytes, flops / PEAK_BF16_FLOP_S) * 1e3)
    log(f"train-vit: attention backward (plain PyTorch, float32 math) per train step: {len(calls)} calls of "
        f"{tuple(calls[0]['q'].shape)} {calls[0]['q'].dtype}, {ms:.4f} ms; bound {bound:.4f} ms by {row['bound_by']} "
        f"({flops / 1e9:.2f} GFLOP over 67 TFLOP/s f32, {nbytes / 1e9:.4f} GB over 3.35 TB/s; the same products on "
        f"the bf16 tensor cores would be {row['bf16_tensor_core_bound_ms']:.4f} ms); SDPA forward + backward on the "
        f"same tensors {lib:.4f} ms [{card}]")
    return row


def fused_step_parity(torch, state, task, batch, card):
    """One bf16 step's loss and gradients from one state with the fused
    attention (the kernel, its autograd arm) and with the plain attention
    (autograd through ``flash_attention_plain``), held to the ViT's bf16
    bound scaled by each leaf's largest value; the worst leaf printed."""
    from tensorflowdistributedlearning_tpu_torch.models.vit import MultiHeadSelfAttention
    from tensorflowdistributedlearning_tpu_torch.ops import kernels
    from tensorflowdistributedlearning_tpu_torch.train import step as step_lib

    attns = [m for m in state.model.modules() if isinstance(m, MultiHeadSelfAttention)]
    kernels.reset_launch_counts()
    loss_k, _ = step_lib.forward_backward(state, task, batch)
    grads_k = {n: p.grad.detach().clone() for n, p in state.model.named_parameters()}
    fused_launches = kernels.launch_counts()["flash_attention"]
    for m in attns:
        m.use_fused = False
    try:
        kernels.reset_launch_counts()
        loss_p, _ = step_lib.forward_backward(state, task, batch)
        check(kernels.launch_counts()["flash_attention"] == 0, "the plain-attention step launched attention")
    finally:
        for m in attns:
            m.use_fused = True
    d_loss = abs(float(loss_k) - float(loss_p))
    check(d_loss <= TOL_VIT_BF16 * abs(float(loss_p)), f"fused vs plain attention loss {float(loss_k)} vs {float(loss_p)}")
    worst, worst_name = 0.0, ""
    for n, p in state.model.named_parameters():
        err = (grads_k[n] - p.grad).abs().max().item()
        tol = TOL_VIT_BF16 * p.grad.abs().max().item()
        check(err <= tol, f"fused vs plain attention gradient {n}: max|err| {err} > {tol}")
        if tol and err / tol > worst:
            worst, worst_name = err / tol, n
    state.zero_grad()
    log(f"train-vit: one bf16 step from one state, fused attention ({fused_launches} launches) vs plain: |dloss| "
        f"{d_loss:.3g} (loss {float(loss_p):.5f}); every gradient leaf within {TOL_VIT_BF16}·max|g_leaf| (worst "
        f"{worst_name} at {worst:.3f} of its tolerance) [{card}]")
    return worst, worst_name


def vit_train_phase(torch, card: str, timer, device: str = "cuda", cfg=None, batch: int = VIT_BATCH,
                    f32_batch: int = 8):
    """The ViT train step on a resident batch (the preset, full width and
    depth, batch 64, bf16 compute): ms per step, images/s, launches per
    step, the profile; every attention call of a step held against the
    plain version, forward and backward; the backward timed beside its
    bound and SDPA; the fused-vs-plain step parity; and one float32-compute
    step at depth 2 (batch ``f32_batch``) so the float32 kernel runs under
    training. ``cfg`` and ``device="cpu"`` rehearse it small on the CPU
    (no timing, no profile, no launches there)."""
    import dataclasses

    from tensorflowdistributedlearning_tpu_torch.data import pipeline as pipeline_lib
    from tensorflowdistributedlearning_tpu_torch.data.synthetic import synthetic_classification_batch
    from tensorflowdistributedlearning_tpu_torch.ops import kernels
    from tensorflowdistributedlearning_tpu_torch.train import step as step_lib
    from tensorflowdistributedlearning_tpu_torch.train.state import create_train_state

    preset_cfg, tcfg = vit_train_config(VIT_FIT_EVERY)
    cfg = cfg or preset_cfg
    on_card = device == "cuda"
    per_step = PER_VIT_FORWARD if on_card else {k: 0 for k in PER_VIT_FORWARD}
    state = create_train_state(cfg, tcfg, device, generator=torch.Generator().manual_seed(SEED + 80))
    raw = synthetic_classification_batch(np.random.default_rng(SEED + 81), batch, cfg.input_shape,
                                         cfg.input_channels, cfg.num_classes)
    fixed = pipeline_lib.to_device(raw, torch.device(device))
    task = step_lib.ClassificationTask(label_smoothing=tcfg.label_smoothing)
    train_step = step_lib.make_train_step(task, weight_decay=cfg.weight_decay)

    # the main path: counts from 0 just before the timed steps, read just after
    kernels.reset_launch_counts()
    losses, times = [], []
    for i in range(10):
        before = kernels.launch_counts()
        t0 = time.perf_counter()
        state, metrics = train_step(state, fixed)
        losses.append(step_lib.compute_metrics(metrics)["loss"])  # the host copy waits for the step
        times.append(time.perf_counter() - t0)
        after = kernels.launch_counts()
        delta = {k: after[k] - before[k] for k in per_step}
        check(delta == per_step, f"train-vit step {i}: launches {delta}, expected {per_step}")
    counts = kernels.launch_counts()
    check(all(np.isfinite(losses)), f"train-vit: non-finite losses {losses}")
    ms = statistics.median(times[2:]) * 1e3
    out = dict(launches=counts, step_ms=ms, images_per_s=batch / ms * 1e3, losses=losses)
    log(f"train-vit: {VIT_PRESET} train step on a resident batch of {batch}: {ms:.3f} ms per step (median of steps "
        f"3-10), {batch / ms * 1e3:.3f} images/s; {per_step['flash_attention_tc']} tensor-core attention launches "
        f"per step; losses {[round(v, 5) for v in losses]} [{card}]")
    if on_card:
        lines, stats = profile_steps(torch, train_step, state, fixed)
        for line in lines:
            log(f"profile train-vit: {line} [{card}]")
        if stats is not None:
            # the profiler slows the host: the idle share of the unprofiled step
            stats["idle_unprofiled"] = max(0.0, 1 - stats["device_ms"] / ms)
            log(f"train-vit: device kernels {stats['device_ms']:.3f} ms of the unprofiled {ms:.3f} ms step: device "
                f"idle {stats['idle_unprofiled']:.3f} [{card}]")
        out["profile"] = stats

    # every attention call of one step, forward and backward
    _, calls = capture_training_attention(torch, state, task, fixed)
    check(len(calls) == cfg.vit_layers and all("g" in c and c["grad"] for c in calls),
          f"train-vit: {len(calls)} attention calls with gradients, expected {cfg.vit_layers}")
    fwd_err = max(hold_attention_forward(torch, c, f"train-vit attention call {i} forward") for i, c in enumerate(calls))
    held = [hold_attention_backward(torch, c, f"train-vit attention call {i} backward") for i, c in enumerate(calls)]
    out.update(attention_forward_err=fwd_err, attention_backward_bitwise=all(b for b, _ in held),
               attention_backward_err=max(e for _, e in held))
    log(f"train-vit: the {len(calls)} attention forwards of a training step {tuple(calls[0]['q'].shape)} "
        f"{calls[0]['q'].dtype} held against the plain version (max|err| {fwd_err:.3g}); the CUDA arm's dq, dk, dv "
        f"{'bit for bit' if out['attention_backward_bitwise'] else 'not bit for bit (within the tolerance)'} the "
        f"plain arm's (max|err| {out['attention_backward_err']:.3g})")
    if on_card:
        out["attention_backward"] = time_attention_backward(torch, calls, timer, card)
    del calls
    if cfg.dtype == "bfloat16":
        out["parity_worst"] = fused_step_parity(torch, state, task, fixed, card)
    del state, fixed
    if on_card:
        torch.cuda.empty_cache()

    # a float32-compute step at depth 2: the CUDA-core kernel under training
    cfg32 = dataclasses.replace(cfg, dtype="float32", vit_layers=2)
    state32 = create_train_state(cfg32, tcfg, device, generator=torch.Generator().manual_seed(SEED + 82))
    raw32 = synthetic_classification_batch(np.random.default_rng(SEED + 83), f32_batch, cfg.input_shape,
                                           cfg.input_channels, cfg.num_classes)
    kernels.reset_launch_counts()
    _, calls32 = capture_training_attention(torch, state32, task, pipeline_lib.to_device(raw32, torch.device(device)))
    c32 = kernels.launch_counts()
    want32 = (2, 0) if on_card else (0, 0)
    check((c32["flash_attention"], c32["flash_attention_tc"]) == want32,
          f"float32 step launches {c32['flash_attention']} attention ({c32['flash_attention_tc']} tensor-core)")
    err32 = max(hold_attention_forward(torch, c, f"float32 step attention call {i} forward")
                for i, c in enumerate(calls32))
    held32 = [hold_attention_backward(torch, c, f"float32 step attention call {i} backward")
              for i, c in enumerate(calls32)]
    out.update(f32_attention_forward_err=err32, f32_attention_backward_bitwise=all(b for b, _ in held32))
    log(f"train-vit: float32-compute step at depth 2, batch {f32_batch}: {len(calls32)} attention calls "
        f"{tuple(calls32[0]['q'].shape)} through the CUDA-core arm (launches {want32[0]}), forwards within the "
        f"float32 tolerance of plain (max|err| {err32:.3g}); dq, dk, dv "
        f"{'bit for bit' if out['f32_attention_backward_bitwise'] else 'not bit for bit (within the tolerance)'} "
        f"the plain arm's")
    return out


def fit_vit_phase(torch, card: str, device: str = "cuda", cfg=None, batch: int = VIT_BATCH,
                  steps: int = VIT_FIT_STEPS, every: int = VIT_FIT_EVERY):
    """ClassifierTrainer.fit on the preset (full width and depth, bf16,
    fused attention; the main training path of this model) on synthetic
    data: ``steps`` steps at ``batch``, a checkpoint and an eval every
    ``every``, best export on metrics/top1; then the restored best state
    served through ``serving_fn`` in float32 and bfloat16 and exported
    through the engine."""
    import dataclasses

    from tensorflowdistributedlearning_tpu_torch.ops import kernels
    from tensorflowdistributedlearning_tpu_torch.serve import InferenceEngine
    from tensorflowdistributedlearning_tpu_torch.train import step as step_lib
    from tensorflowdistributedlearning_tpu_torch.train.fit import EVAL_SYNTHETIC_BATCHES, ClassifierTrainer

    preset_cfg, tcfg = vit_train_config(every)
    tcfg = dataclasses.replace(tcfg, train_log_every_steps=steps)  # one window: the ledger's steps sum to the run
    cfg = cfg or preset_cfg
    on_card = device == "cuda"
    per = PER_VIT_FORWARD if on_card else {k: 0 for k in PER_VIT_FORWARD}
    shape = (*cfg.input_shape, cfg.input_channels)
    out = {}
    with tempfile.TemporaryDirectory(prefix="chip-smoke-fit-vit-") as root:
        model_dir = os.path.join(root, "model")
        ledger = LaunchLedger(kernels, step_lib)
        trainer = ClassifierTrainer(model_dir, None, cfg, tcfg, device=device)
        with ledger.patch():
            kernels.reset_launch_counts()
            t0 = time.perf_counter()
            result = trainer.fit(batch_size=batch, steps=steps)
            if on_card:
                torch.cuda.synchronize()
            fit_s = time.perf_counter() - t0
            counts = kernels.launch_counts()
        check(result.steps == steps, f"fit-vit: {result.steps} steps")
        check(sorted(result.final_metrics) == ["loss", "metrics/top1", "metrics/top5"] and
              all(np.isfinite(v) for v in result.final_metrics.values()), f"fit-vit metrics {result.final_metrics}")
        files = {kind: sorted(int(d) for d in os.listdir(os.path.join(model_dir, *sub)) if d.isdigit())
                 for kind, sub in (("checkpoints", ("checkpoints",)), ("best", ("export", "best")))}
        check(files["checkpoints"] == list(range(every, steps + 1, every)), f"fit-vit checkpoints {files}")
        check(len(files["best"]) >= 1, "fit-vit: no best export")
        n_evals = steps // every + (steps % every != 0)
        check(len(ledger.train) == steps and len(ledger.eval) == n_evals * EVAL_SYNTHETIC_BATCHES,
              f"fit-vit: {len(ledger.train)} train steps and {len(ledger.eval)} eval forwards recorded")
        for i, delta in enumerate(ledger.train + ledger.eval):
            delta = {k: delta[k] for k in per}
            check(delta == per, f"fit-vit step or eval forward {i}: launches {delta}, expected {per}")
        log(f"fit-vit: ClassifierTrainer.fit, {VIT_PRESET} ({result.n_params} parameters), {steps} steps at batch "
            f"{batch} on synthetic data, checkpoints and evals every {every}: {fit_s:.3f} s wall (data, "
            f"augmentation, evals, checkpoints and best exports included) [{card}]")
        log(f"fit-vit: final metrics {json.dumps(result.final_metrics)}; checkpoints {files['checkpoints']}, best "
            f"exports {files['best']}; {len(ledger.train)} train steps and {len(ledger.eval)} eval forwards launched "
            f"{per['flash_attention_tc']} tensor-core attention kernels each; totals {counts}")
        out.update(launches=counts, fit_s=fit_s, final_metrics=result.final_metrics, n_params=result.n_params)
        check_run_ledger(model_dir, steps, n_evals, "fit-vit")

        t0 = time.perf_counter()
        best = trainer._restore_best_host()
        if on_card:
            torch.cuda.synchronize()
        out["restore_s"] = time.perf_counter() - t0
        log(f"fit-vit: restore of the best export (step {best.step}, no init draw) {out['restore_s']:.3f} s [{card}]")
        x = make_vit_instances(batch, SEED + 84, shape)
        with torch.inference_mode():
            logits = best.model.eval()(torch.from_numpy(x).to(device))
            direct = step_lib.ClassificationTask().predictions(logits)["probabilities"].float()
        del best
        served = {}
        for spec in ("float32", "bfloat16"):
            serve = trainer.serving_fn(spec)
            kernels.reset_launch_counts()
            answer = serve(x)
            launched = kernels.launch_counts()
            probs, cls = answer["probabilities"], answer["class"]
            check(probs.shape == (batch, cfg.num_classes) and probs.dtype == torch.float32 and
                  cls.dtype == torch.int32 and bool(torch.isfinite(probs).all()), f"fit-vit serve {spec}: outputs")
            check(torch.equal(cls, probs.argmax(-1).to(torch.int32)), f"fit-vit serve {spec}: class != argmax")
            check({k: launched[k] for k in per} == per, f"fit-vit serve {spec}: launches {launched}")
            d = (probs - direct).abs().max().item()
            tol = TOL_VIT_F32 if spec == "float32" else TOL_VIT_BF16
            check(d <= tol, f"fit-vit serve {spec}: max|dprobs| {d} against the restored model's forward > {tol}")
            served[spec] = d
        log(f"fit-vit: serving_fn float32 and bfloat16 of the restored best answer a batch of {batch}: class == "
            f"argmax, max|dprobs| against the restored model's own forward {served['float32']:.3g} (float32) and "
            f"{served['bfloat16']:.3g} (bfloat16 weights)")
        manifest = trainer.export_serving()
        engine = InferenceEngine.from_artifact(os.path.dirname(manifest), device=device, buckets=(batch,))
        kernels.reset_launch_counts()
        infer = engine.infer(x)
        launched = kernels.launch_counts()
        d = float(np.abs(infer["probabilities"] - direct.cpu().numpy()).max())
        check(d <= TOL_VIT_F32, f"fit-vit export: engine probabilities {d} from the restored model's forward")
        check({k: launched[k] for k in per} == per, f"fit-vit export: engine launches {launched}")
        log(f"fit-vit: export_serving through the engine at bucket {batch}: max|dprobs| {d:.3g}, launches "
            f"{per['flash_attention_tc']} tensor-core attention kernels")
        out["serve_max_dprobs"] = served
        if on_card:
            out["arms"] = dispatch_arms(torch, card, cfg, tcfg, batch, VIT_ARM_STEPS, os.path.join(root, "arms"),
                                        timed=VIT_ARM_TIMED, log_every=VIT_ARM_WINDOW)
    return out


def dispatch_arms(torch, card: str, cfg, tcfg, batch: int, steps: int, root: str, timed=(5, 15),
                  log_every: int = 5, device: str = "cuda"):
    """ClassifierTrainer.fit of ``cfg`` for ``steps`` steps in four arms:
    dispatch-ahead 0 and 2 with telemetry on, 2 with it off, then 0 with it
    on again; a window every ``log_every`` steps, no checkpoint or eval
    until the end. Steps ``timed[0]`` + 1 to ``timed[1]`` are timed on the
    host clock, from their first call after the card finished the earlier
    steps to the card's end of the last: ms per step. The steps after them
    run under a CUDA-only profile: device kernel time per step, and the
    idle share against the timed steps (1 - kernel time / ms per step).
    Recorded, not claimed."""
    import dataclasses

    from torch.profiler import ProfilerActivity, profile

    from tensorflowdistributedlearning_tpu_torch.obs.ledger import read_ledger
    from tensorflowdistributedlearning_tpu_torch.train import step as step_lib
    from tensorflowdistributedlearning_tpu_torch.train.fit import ClassifierTrainer

    first, last = timed
    sync = torch.cuda.synchronize if device == "cuda" else (lambda: None)
    out = []
    for i, (ahead, telemetry) in enumerate(((0, True), (2, True), (2, False), (0, True))):
        arm_cfg = dataclasses.replace(tcfg, dispatch_ahead_steps=ahead, telemetry=telemetry,
                                      train_log_every_steps=log_every, checkpoint_every_steps=10 * steps,
                                      eval_every_steps=10 * steps)
        real = step_lib.make_train_step
        marks = {}

        def make(*a, **k):
            inner = real(*a, **k)
            calls = [0]

            def step(state, b):
                if calls[0] == first:
                    sync()
                    marks["t0"] = time.perf_counter()
                if calls[0] == last:
                    sync()
                    marks["t1"] = time.perf_counter()
                    marks["session"] = contextlib.ExitStack()
                    marks["session"].enter_context(profiler_session())
                    activity = ProfilerActivity.CUDA if device == "cuda" else ProfilerActivity.CPU
                    marks["prof"] = marks["session"].enter_context(profile(activities=[activity]))
                result = inner(state, b)
                calls[0] += 1
                if calls[0] == steps:
                    sync()
                    marks["session"].close()
                return result

            return step

        trainer = ClassifierTrainer(os.path.join(root, f"arm{i}"), None, cfg, arm_cfg, device=device)
        with mock.patch.object(step_lib, "make_train_step", make):
            trainer.fit(batch_size=batch, steps=steps)
        ms = (marks["t1"] - marks["t0"]) * 1e3 / (last - first)
        device_ms = sum(evt.time_range.elapsed_us() for evt in marks["prof"].events()
                        if device_kernel(evt)) / 1e3 / (steps - last)
        idle = max(0.0, 1 - device_ms / ms)
        arm = {"dispatch_ahead": ahead, "telemetry": telemetry, "ms_per_step": ms, "idle": idle,
               "device_ms_per_step": device_ms}
        spans = ""
        if telemetry:
            # the clean windows' time per step three ways: the mean step span
            # (the JAX package's mfu), step + fetch-wait time (the port's) and
            # the wall time its images/s imply (recorded)
            wins = [w for w in read_ledger(os.path.join(root, f"arm{i}")) if w["event"] == "step_window"
                    and not w["dirty"] and w.get("images_per_sec")]
            check(wins, f"fit-vit arm {i}: no clean window")
            arm["window_ms"] = {
                "step_span": statistics.mean(w["step_time_ms"]["mean_ms"] for w in wins),
                "step_and_fetch": statistics.mean((w["compute_s"] + w["fetch_wait_s"]) / w["steps"] * 1e3
                                                  for w in wins),
                "wall": statistics.mean(batch / w["images_per_sec"] * 1e3 for w in wins),
            }
            spans = (f"; its {len(wins)} clean windows' ms per step: mean step span "
                     f"{arm['window_ms']['step_span']:.3f}, step + fetch-wait {arm['window_ms']['step_and_fetch']:.3f}, "
                     f"wall {arm['window_ms']['wall']:.3f}")
        out.append(arm)
        log(f"fit-vit arm {i}: dispatch-ahead {ahead}, telemetry {'on' if telemetry else 'off'}: {ms:.3f} ms per step "
            f"(steps {first + 1}-{last}, host clock, the card's end of the last included), device kernels "
            f"{device_ms:.3f} ms per step (steps {last + 1}-{steps}, profiled), device idle {idle:.3f}{spans} [{card}]")
    return out


# -- training -------------------------------------------------------------------


def write_salt_dataset(root: str, n: int, size: int, seed: int) -> list:
    """A TGS-layout dataset from ``seed``: ``{root}/images/*.png`` and
    ``{root}/masks/*.png``, 8-bit grey, one disk of salt per mask and every
    third mask empty; the image is noise plus a brighter disk."""
    from tensorflowdistributedlearning_tpu_torch.data.png import write_png_gray

    rng = np.random.default_rng(seed)
    os.makedirs(os.path.join(root, "images"), exist_ok=True)
    os.makedirs(os.path.join(root, "masks"), exist_ok=True)
    yy, xx = np.mgrid[0:size, 0:size]
    ids = []
    for i in range(n):
        if i % 3 == 0:
            mask = np.zeros((size, size), bool)
        else:
            cy, cx = rng.uniform(0.2, 0.8, 2) * size
            r = rng.uniform(0.1, 0.35) * size
            mask = (yy - cy) ** 2 + (xx - cx) ** 2 < r ** 2
        image = np.clip(rng.normal(110, 30, (size, size)) + 60 * mask, 0, 255).astype(np.uint8)
        name = f"s{i:04d}"
        write_png_gray(os.path.join(root, "images", f"{name}.png"), image)
        write_png_gray(os.path.join(root, "masks", f"{name}.png"), (mask * 255).astype(np.uint8))
        ids.append(name)
    return ids


def capture_train_calls(torch, model, images, labels):
    """One training-mode forward and backward of the Lovász loss with hooks
    recording each depthwise call's input, filter, rate and output gradient."""
    from tensorflowdistributedlearning_tpu_torch.models.layers import DepthwiseConv2D
    from tensorflowdistributedlearning_tpu_torch.train.step import SegmentationTask

    calls = []

    def hook(module, args, out):
        entry = {"x": args[0].detach().contiguous(), "w": module.weight.detach().contiguous(), "rate": module.rate}
        calls.append(entry)
        out.register_hook(lambda g: entry.__setitem__("g", g.detach().contiguous()))

    handles = [m.register_forward_hook(hook) for m in model.modules() if isinstance(m, DepthwiseConv2D)]
    try:
        model.train()
        logits = model(images)
        SegmentationTask().loss(logits, {"labels": labels}).backward()
    finally:
        for h in handles:
            h.remove()
    model.zero_grad(set_to_none=True)
    return calls


def dw_sweep(torch, gen):
    """(x, w, g, rate, route) off the train path's shapes, each with the dw
    route it must take: the earlier tile kernel for C = 6, C = 33 and a base
    4 bytes off; the band kernel for H = W = 1, 7x7 at rate 3, 1x3 and 3x1,
    5x5 at rate 3, a halo larger than the image (5x5 at rate 4 on 5 x 6) and
    B = 1 at 101x101x64."""
    cases = [((3, 9, 11, 6), (3, 3), 2, "tile"), ((2, 9, 11, 33), (3, 3), 1, "tile"), ((2, 9, 11, 16), (3, 3), 2, "tile"),
             ((2, 1, 1, 8), (3, 3), 1, "band"), ((2, 15, 17, 40), (7, 7), 3, "band"), ((2, 13, 13, 64), (1, 3), 2, "band"),
             ((2, 13, 13, 64), (3, 1), 2, "band"), ((1, 17, 23, 72), (5, 5), 3, "band"), ((2, 5, 6, 16), (5, 5), 4, "band"),
             ((1, 101, 101, 64), (3, 3), 1, "band")]
    for i, (shape, (kh, kw), rate, route) in enumerate(cases):
        numel = int(np.prod(shape))
        if i == 2:  # a base 4 bytes off: views one float into a buffer
            x = torch.randn(numel + 1, device="cuda", generator=gen)[1:].view(shape)
        else:
            x = torch.randn(*shape, device="cuda", generator=gen)
        yield x, torch.randn(kh, kw, shape[-1], device="cuda", generator=gen), torch.randn(*shape, device="cuda",
                                                                                          generator=gen), rate, route


def dw_agreement(torch, x, g, kh: int, kw: int, rate: int, what: str) -> float:
    """dw within rtol TOL_DW_REL + TOL_DW_REL·max|dw_plain| of the plain
    version and bitwise equal across two launches; returns max|err|."""
    from tensorflowdistributedlearning_tpu_torch.ops import kernels

    dw = kernels.depthwise_conv2d_dw(x, g, (kh, kw), rate)
    dw_again = kernels.depthwise_conv2d_dw(x, g, (kh, kw), rate)
    pdw = kernels._dw_plain(x, g, kh, kw, rate)
    torch.cuda.synchronize()
    e, scale = (dw - pdw).abs().max().item(), pdw.abs().max().item()
    check(bool(((dw - pdw).abs() <= TOL_DW_REL * pdw.abs() + TOL_DW_REL * scale).all()),
          f"dw {what}: max|err| {e} beyond rtol {TOL_DW_REL} + {TOL_DW_REL}·max|dw| ({scale})")
    check(torch.equal(dw, dw_again), f"dw {what}: two launches differ (the kernel must be bitwise repeatable)")
    return e


def describe_dw_route(plan) -> str:
    if plan is None:
        return "the earlier tile kernel"
    return (f"the band kernel ({plan.channels} channels x {plan.band_rows}-row bands x {plan.images} images a block, "
            f"{plan.stages} stage(s), {plan.blocks} blocks, {plan.smem_bytes} B of shared memory)")


def backward_phase(torch, calls, timer, card: str):
    """dx and dw kernels against the plain backward at the train path's
    shapes, plus the dw sweep; times per train step."""
    from tensorflowdistributedlearning_tpu_torch.ops import kernels

    aten = torch.ops.aten
    gen = torch.Generator(device="cuda").manual_seed(SEED + 5)
    rows = {}
    for name in ("depthwise_conv2d_dx", "depthwise_conv2d_dw"):
        rows[name] = dict(max_abs_err=0.0, ms=0.0, plain_ms=0.0, library_ms=0.0, earlier_ms=0.0, nbytes=0.0, flops=0.0)
    floors = {"empty": 0.0, "read": 0.0}
    tile_err = 0.0  # the earlier tile kernel's max|err|, on the path calls and its sweep cases
    with torch.no_grad():
        # dx (and the forward) bitwise the earlier kernel on the train path's
        # calls and the sweep; dx one launch, no flip copy
        n = 0
        for c in calls:
            what = f"train path {tuple(c['x'].shape)} rate {c['rate']}"
            depthwise_agreement(torch, c["x"], c["w"], c["rate"], False, what)
            depthwise_agreement(torch, c["g"], c["w"], c["rate"], True, what)
        for xo, wo, rate in depthwise_sweep(torch, gen):
            depthwise_agreement(torch, xo, wo, rate, True, f"sweep {tuple(xo.shape)} {wo.shape[0]}x{wo.shape[1]} "
                                f"rate {rate}")
            n += 1
        g0, w0, r0 = calls[0]["g"], calls[0]["w"], calls[0]["rate"]
        torch.cuda.synchronize()
        kernels.reset_launch_counts()
        allocated = torch.cuda.memory_stats()["allocation.all.allocated"]
        kernels.depthwise_conv2d_dx(g0, w0, r0)
        torch.cuda.synchronize()
        check(torch.cuda.memory_stats()["allocation.all.allocated"] - allocated == 1
              and sum(kernels.launch_counts().values()) == kernels.launch_counts()["depthwise_conv2d_dx"] == 1,
              f"dx is not one launch with its output the only allocation: {kernels.launch_counts()}")
        log(f"depthwise: forward and dx bitwise the earlier kernel on the {len(calls)} train path calls, dx on "
            f"{n} sweep cases; dx is one launch and allocates only its output")
        for c in calls:
            x, w, g, rate = c["x"], c["w"], c["g"], c["rate"]
            kh, kw, ch = w.shape
            what = f"{tuple(x.shape)} {kh}x{kw} rate {rate}"
            plan = kernels.dw_route(x, g, (kh, kw), rate)
            check(plan is not None, f"dw {what}: the train path call missed the band kernel")
            dx = kernels.depthwise_conv2d_dx(g, w, rate)
            pdx = kernels._dx_plain(g, w, rate)
            kernels.reset_launch_counts()
            e_dw = dw_agreement(torch, x, g, kh, kw, rate, what)
            check(kernels.launch_counts()["depthwise_conv2d_dw_band"] == 2, f"dw {what}: {kernels.launch_counts()}")
            earlier, pdw = kernels._earlier_depthwise_dw(x, g, (kh, kw), rate), kernels._dw_plain(x, g, kh, kw, rate)
            torch.cuda.synchronize()
            check(bool(((earlier - pdw).abs() <= TOL_DW_REL * pdw.abs() + TOL_DW_REL * pdw.abs().max()).all()),
                  f"dw {what}: the earlier kernel beyond the dw tolerance")
            tile_err = max(tile_err, (earlier - pdw).abs().max().item())
            e_dx, dx_scale = (dx - pdx).abs().max().item(), pdx.abs().max().item()
            check(e_dx <= TOL_DX, f"dx {what}: max|err| {e_dx} > {TOL_DX} (max|dx| {dx_scale})")
            rows["depthwise_conv2d_dx"]["max_abs_err"] = max(rows["depthwise_conv2d_dx"]["max_abs_err"], e_dx)
            rows["depthwise_conv2d_dw"]["max_abs_err"] = max(rows["depthwise_conv2d_dw"]["max_abs_err"], e_dw)
            log(f"backward {what}: dx max|err| {e_dx:.3g} (max|dx| {dx_scale:.3g}); dw through "
                f"{describe_dw_route(plan)}, max|err| {e_dw:.3g} (max|dw| {pdw.abs().max().item():.3g}), bitwise "
                f"repeatable, not bitwise the earlier kernel (another summation order; max|dw - earlier| "
                f"{(earlier - kernels.depthwise_conv2d_dw(x, g, (kh, kw), rate)).abs().max().item():.3g})")
            b, h, wd, _ = x.shape
            xv, gv = x.permute(0, 3, 1, 2), g.permute(0, 3, 1, 2)
            wt = w.permute(2, 0, 1).unsqueeze(1).contiguous()
            pad = [rate * (kh - 1) // 2, rate * (kw - 1) // 2]

            def library(mask):
                return aten.convolution_backward(gv, xv, wt, None, [1, 1], pad, [rate, rate], False, [0, 0], ch,
                                                 mask)

            flops = 2 * b * ch * depthwise_valid_taps(h, wd, kh, rate)
            rx, rw = rows["depthwise_conv2d_dx"], rows["depthwise_conv2d_dw"]
            rx["ms"] += timer.ms(lambda: kernels.depthwise_conv2d_dx(g, w, rate))
            rx["earlier_ms"] += timer.ms(lambda: kernels._earlier_depthwise(g, w, rate, True))
            rx["plain_ms"] += timer.ms(lambda: kernels._dx_plain(g, w, rate))
            rx["library_ms"] += timer.ms(lambda: library([True, False, False]))
            rx["nbytes"] += 4 * (2 * g.numel() + w.numel())
            rx["flops"] += flops
            rw["ms"] += timer.ms(lambda: kernels.depthwise_conv2d_dw(x, g, (kh, kw), rate))
            rw["earlier_ms"] += timer.ms(lambda: kernels._earlier_depthwise_dw(x, g, (kh, kw), rate))
            rw["plain_ms"] += timer.ms(lambda: kernels._dw_plain(x, g, kh, kw, rate))
            rw["library_ms"] += timer.ms(lambda: library([False, True, False]))
            rw["nbytes"] += 4 * (x.numel() + g.numel() + w.numel())
            rw["flops"] += flops
            # floors under this timer: an empty kernel (dw is two launches),
            # and PyTorch reading x and g once
            floors["empty"] += timer.ms(lambda: torch.cuda._sleep(0))
            floors["read"] += timer.ms(lambda: (x.sum(), g.sum()))
        # the dw sweep, each case on its stated route with one launch each
        n = 0
        for x, w, g, rate, route in dw_sweep(torch, gen):
            kh, kw, _ = w.shape
            what = f"sweep {tuple(x.shape)} {kh}x{kw} rate {rate}{'' if x.data_ptr() % 16 == 0 else ' (base 4 bytes off)'}"
            plan = kernels.dw_route(x, g, (kh, kw), rate)
            check((plan is not None) == (route == "band"), f"dw {what}: took {describe_dw_route(plan)}, not the {route} "
                  "route")
            if x.shape[0] == 1 and x.shape[1] == 101:
                check(plan.blocks >= 132, f"dw {what}: {plan.blocks} blocks do not fill the 132 SMs")
            kernels.reset_launch_counts()
            e = dw_agreement(torch, x, g, kh, kw, rate, what)
            counts = kernels.launch_counts()
            check(counts["depthwise_conv2d_dw"] == 2 and counts["depthwise_conv2d_dw_band"] == (2 if plan else 0),
                  f"dw {what}: launches {counts}")
            e_dx = (kernels.depthwise_conv2d_dx(g, w, rate) - kernels._dx_plain(g, w, rate)).abs().max().item()
            check(e_dx <= TOL_DX, f"dx {what}: max|err| {e_dx} > {TOL_DX}")
            if plan is None:
                tile_err = max(tile_err, e)
            else:
                rows["depthwise_conv2d_dw"]["max_abs_err"] = max(rows["depthwise_conv2d_dw"]["max_abs_err"], e)
            log(f"backward {what}: dw through {describe_dw_route(plan)}, max|err| {e:.3g}, bitwise repeatable; dx max|err| "
                f"{e_dx:.3g}")
            n += 1
        log(f"dw: {len(calls)} train path calls through the band kernel and {n} sweep cases on their routes, within "
            f"rtol {TOL_DW_REL} + {TOL_DW_REL}·max|dw| of the plain version, bitwise repeatable")
    for name, r in rows.items():
        nbytes, flops = r.pop("nbytes"), r.pop("flops")
        r.update(bound_ms=bound_ms(nbytes, flops), bound_by=bound_by(nbytes, flops))
        log(f"{name}: {r['ms']:.4f} ms per train step at batch {TRAIN_BATCH} (plain {r['plain_ms']:.4f} ms, library "
            f"{r['library_ms']:.4f} ms, earlier kernel {r['earlier_ms']:.4f} ms, bound {r['bound_ms']:.4f} ms by "
            f"{r['bound_by']}, {nbytes / 1e6:.1f} MB) [{card}]")
    log(f"depthwise_conv2d_dw floors per train step under this timer: 3 empty kernels {floors['empty']:.4f} ms (dw is "
        f"two launches a call), PyTorch reading x and g once (x.sum() + g.sum()) {floors['read']:.4f} ms [{card}]")
    # the earlier tile kernel as its own row: the route every other shape
    # takes, timed at the train path's calls, where it launched no time
    tile = dict(rows["depthwise_conv2d_dw"], max_abs_err=tile_err)
    tile["ms"] = tile.pop("earlier_ms")
    rows["depthwise_conv2d_dw_tile"] = tile
    return rows


class LaunchLedger:
    """Wraps the trainer's step builders so that each train step's, each
    eval forward's and each predict forward's kernel launches are recorded
    as deltas of the counts; with ``trainer_cls`` (the K-fold Trainer), each
    image summary's eval-mode forward too (``summary``)."""

    def __init__(self, kernels, step_lib, trainer_cls=None):
        self.kernels, self.step_lib, self.trainer_cls = kernels, step_lib, trainer_cls
        self.train, self.eval, self.predict, self.summary = [], [], [], []

    def _wrap(self, make, sink):
        kernels = self.kernels

        def maker(*args, **kwargs):
            inner = make(*args, **kwargs)

            def step(*a, **kw):
                before = kernels.launch_counts()
                out = inner(*a, **kw)
                after = kernels.launch_counts()
                sink.append({k: after[k] - before[k] for k in after})
                return out

            return step

        return maker

    def patch(self):
        steps = mock.patch.multiple(
            self.step_lib,
            make_train_step=self._wrap(self.step_lib.make_train_step, self.train),
            make_eval_step=self._wrap(self.step_lib.make_eval_step, self.eval),
            make_predict_step=self._wrap(self.step_lib.make_predict_step, self.predict),
        )
        if self.trainer_cls is None:
            return steps
        stack = contextlib.ExitStack()
        stack.enter_context(steps)
        real = self.trainer_cls._write_image_summaries
        kernels, sink = self.kernels, self.summary

        def summaries(trainer, *a, **kw):
            before = kernels.launch_counts()
            real(trainer, *a, **kw)
            after = kernels.launch_counts()
            sink.append({k: after[k] - before[k] for k in after})

        stack.enter_context(mock.patch.object(self.trainer_cls, "_write_image_summaries", summaries))
        return stack


def fold_files(model_dir: str, fold: int):
    """{kind: {step: mtime}} of a fold's checkpoints and best exports."""
    out = {}
    for kind, sub in (("checkpoints", "checkpoints"), ("best", os.path.join("export", "best"))):
        root = os.path.join(model_dir, f"fold{fold}", sub)
        steps = sorted(int(d) for d in os.listdir(root) if d.isdigit()) if os.path.isdir(root) else []
        out[kind] = {s: os.path.getmtime(os.path.join(root, str(s), "state.pt")) for s in steps}
    return out


def profile_steps(torch, step, state, batch, reps: int = 3):
    """torch.profiler over ``reps`` train steps: wall and device-kernel time
    per step, the device idle share, and the kernels that take the most, as
    lines of text and ``{"wall_ms", "device_ms", "idle"}`` (None when the
    profiler recorded no CUDA kernel)."""
    from torch.profiler import ProfilerActivity, profile

    step(state, batch)
    torch.cuda.synchronize()
    with profiler_session(), profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(reps):
            step(state, batch)
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3 / reps
    kernels_us = {}
    for evt in prof.events():
        if device_kernel(evt):
            kernels_us[evt.name] = kernels_us.get(evt.name, 0.0) + evt.time_range.elapsed_us()
    device_ms = sum(kernels_us.values()) / 1e3 / reps
    if device_ms <= 0:
        return ([f"train step: wall {wall_ms:.3f} ms; device time not measured (the profiler recorded no CUDA "
                 "kernels)"], None)
    idle = max(0.0, 1 - device_ms / wall_ms)
    lines = [f"train step at batch {batch['images'].shape[0]}: wall {wall_ms:.3f} ms, device kernels {device_ms:.3f} "
             f"ms, device idle {idle:.3f} of the wall time"]
    for name, us in sorted(kernels_us.items(), key=lambda kv: -kv[1])[:12]:
        lines.append(f"  {us / 1e3 / reps:9.3f} ms  {name[:110]}")
    return lines, {"wall_ms": wall_ms, "device_ms": device_ms, "idle": idle}


@contextlib.contextmanager
def profiler_session():
    """The process's one profiler session (``obs.profiler``'s): a trainer's
    cadence capture asked for meanwhile is refused and counted."""
    from tensorflowdistributedlearning_tpu_torch.obs import profiler

    check(profiler.exclusive_session(blocking=True), "the profiler session")
    try:
        yield
    finally:
        profiler.release_session()


def check_run_ledger(model_dir: str, steps: int, evals: int, what: str, data_service: bool = False,
                     windows: int = None):
    """The run's ledger parses and holds a ``run_header``, ``step_window``s
    whose ``steps`` sum to the ``steps`` run (``windows`` of them when
    given), one ``eval`` event per eval pass and a ``run_end`` that is not
    interrupted; with ``data_service``, every window carries the service's
    block. Returns the events."""
    from tensorflowdistributedlearning_tpu_torch.obs.ledger import last_run_events, read_ledger_with_errors

    events, errors = read_ledger_with_errors(os.path.join(model_dir, "telemetry.jsonl"))
    events = last_run_events(events)
    check(errors == 0 and events and events[0]["event"] == "run_header", f"{what} ledger: {errors} parse errors, "
          f"first event {events[0]['event'] if events else None}")
    wins = [e for e in events if e["event"] == "step_window"]
    n_evals = sum(e["event"] == "eval" for e in events)
    check(sum(w["steps"] for w in wins) == steps and (windows is None or len(wins) == windows),
          f"{what} ledger: {len(wins)} windows of {sum(w['steps'] for w in wins)} steps, expected {steps}")
    check(n_evals == evals, f"{what} ledger: {n_evals} eval events, expected {evals}")
    check(events[-1]["event"] == "run_end" and not events[-1].get("interrupted"), f"{what} ledger: no clean run_end")
    # a run with the cadence profiler armed ledgers its counters: a capture
    # that failed or was refused fails the phase
    prof = events[-1].get("profiler")
    n_captures = sum(e["event"] == "profile_capture" for e in events)
    check(prof is None and n_captures == 0 or prof is not None and prof["errors"] == 0 and prof["refused"] == 0
          and prof["captures"] == n_captures, f"{what} ledger: profiler {prof}, {n_captures} profile_capture events")
    for alert in (e for e in events if e["event"] == "health_alert"):
        log(f"{what}: health_alert {json.dumps({k: v for k, v in alert.items() if k not in ('event', 't')})}")
    if data_service:
        check(all("data_service" in w for w in wins), f"{what} ledger: a window without the data_service block")
    kinds = sorted({e["event"] for e in events})
    log(f"{what}: ledger {len(events)} events ({', '.join(kinds)}), {len(wins)} windows of {steps} steps, {n_evals} "
        f"evals, run_end {json.dumps({k: v for k, v in events[-1].items() if k not in ('event', 't')})[:200]}")
    return events


def batch_digest(batch) -> str:
    """sha256 over a host batch's arrays, in key order."""
    h = hashlib.sha256()
    for k in sorted(batch):
        h.update(k.encode())
        h.update(np.ascontiguousarray(batch[k]).tobytes())
    return h.hexdigest()


def observe_prefetch(pipeline_lib, digests, waits=None):
    """Patch ``pipeline_lib.device_prefetch`` so that every host batch the
    trainers' prefetch thread takes is digested into ``digests`` (on that
    thread: nothing waits on the device), and, with ``waits``, the host's
    ``(start, end)`` wait for each next batch is recorded."""
    real = pipeline_lib.device_prefetch

    def prefetch(iterator, place, depth=2, registry=None):
        def digested():
            for b in iterator:
                digests.append(batch_digest(b))
                yield b

        gen = real(digested(), place, depth, registry=registry)
        if waits is None:
            return gen

        def timed():
            while True:
                t0 = time.perf_counter()
                b = next(gen, None)
                if b is None:
                    return
                waits.append((t0, time.perf_counter()))
                yield b

        return timed()

    return mock.patch.object(pipeline_lib, "device_prefetch", prefetch)


def train_phase(torch, card: str, device: str = "cuda", model_kwargs=None, n_images: int = TRAIN_IMAGES,
                size: int = 101, batch: int = TRAIN_BATCH, steps: int = TRAIN_STEPS, every: int = 5,
                n_test: int = PREDICT_IMAGES):
    """Trainer.train on the full-width model (the main training path), then
    the learning, profile, kernel-vs-plain and serve checks."""
    from tensorflowdistributedlearning_tpu_torch.config import ModelConfig, TrainConfig
    from tensorflowdistributedlearning_tpu_torch.data import augment as augment_lib
    from tensorflowdistributedlearning_tpu_torch.data import folds as folds_lib
    from tensorflowdistributedlearning_tpu_torch.data import pipeline as pipeline_lib
    from tensorflowdistributedlearning_tpu_torch.data.kaggle import load_tgs_training_set
    from tensorflowdistributedlearning_tpu_torch.ops import kernels
    from tensorflowdistributedlearning_tpu_torch.serve import InferenceEngine
    from tensorflowdistributedlearning_tpu_torch.train import step as step_lib
    from tensorflowdistributedlearning_tpu_torch.train.state import create_train_state
    from tensorflowdistributedlearning_tpu_torch.train.trainer import Trainer

    model_kwargs = dict(model_kwargs or {}, use_pallas_depthwise=True)
    cfg = ModelConfig(input_shape=(size, size), **model_kwargs)
    tcfg = TrainConfig(n_folds=TRAIN_FOLDS, seed=SEED % 1000, checkpoint_every_steps=every, eval_every_steps=every,
                       save_best=2, train_log_every_steps=steps)
    results = {}
    with tempfile.TemporaryDirectory(prefix="chip-smoke-train-") as root:
        data, model_dir = os.path.join(root, "data"), os.path.join(root, "model")
        t0 = time.perf_counter()
        written = write_salt_dataset(data, n_images, size, SEED + 11)
        # the training script's ids and stratification classes: train.csv and the masks' coverage bins
        train_csv = os.path.join(root, "train.csv")
        with open(train_csv, "w") as f:
            f.write("id,rle_mask\n" + "".join(f"{i},\n" for i in reversed(written)))
        ids, classes = load_tgs_training_set(data, train_csv)
        check(ids == sorted(written) and len(classes) == len(ids), "load_tgs_training_set ids")
        log(f"train: wrote {len(ids)} {size}x{size} TGS-layout images and train.csv in {time.perf_counter() - t0:.3f} "
            f"s; load_tgs_training_set: {len(ids)} ids, coverage classes {np.bincount(classes).tolist()}")

        # the main path: counts from 0 just before, read just after
        ledger = LaunchLedger(kernels, step_lib, Trainer)
        trainer = Trainer(model_dir, data, train_config=tcfg, device=device,
                          input_shape=(size, size), **model_kwargs)
        fed = []
        with ledger.patch(), observe_prefetch(pipeline_lib, fed):
            kernels.reset_launch_counts()
            t0 = time.perf_counter()
            folds = trainer.train(ids, classes, batch_size=batch, steps=steps)
            if device == "cuda":
                torch.cuda.synchronize()
            train_s = time.perf_counter() - t0
            counts = kernels.launch_counts()
        log(f"train: Trainer.train, {TRAIN_FOLDS} folds x {steps} steps at batch {batch}, {train_s:.3f} s "
            f"(data, augmentation, eval, checkpoints included) [{card}]")
        for fold, metrics in enumerate(folds):
            log(f"train: fold {fold} final eval {json.dumps(metrics)}")
            check(all(np.isfinite(v) for v in metrics.values()), f"fold {fold}: non-finite metrics {metrics}")
            files = fold_files(model_dir, fold)
            check(sorted(files["checkpoints"]) == list(range(every, steps + 1, every)),
                  f"fold {fold}: checkpoints at {sorted(files['checkpoints'])}")
            check(len(files["best"]) >= 1, f"fold {fold}: no best export")
        check(len(ledger.train) == TRAIN_FOLDS * steps, f"{len(ledger.train)} train steps recorded")
        for i, delta in enumerate(ledger.train):
            check(delta == PER_TRAIN_STEP, f"train step {i}: launches {delta}, expected {PER_TRAIN_STEP}")
        # the image summaries' eval-mode forwards: one per log window and per eval pass
        eval_forwards = len(ledger.eval) + len(ledger.summary)
        n_evals = TRAIN_FOLDS * (steps // every)
        check(len(ledger.summary) == TRAIN_FOLDS * (steps // tcfg.train_log_every_steps) + n_evals,
              f"train: {len(ledger.summary)} image summaries")
        for i, delta in enumerate(ledger.eval + ledger.summary):
            check(delta == PER_EVAL_FORWARD, f"eval forward {i}: launches {delta}, expected {PER_EVAL_FORWARD}")
        want = {k: PER_TRAIN_STEP[k] * len(ledger.train) + PER_EVAL_FORWARD[k] * eval_forwards for k in counts}
        check(counts == want, f"train path launches {counts}, expected {want}")
        log(f"train: {len(ledger.train)} train steps launched {PER_TRAIN_STEP} each; {len(ledger.eval)} eval forwards "
            f"and {len(ledger.summary)} image-summary forwards launched {PER_EVAL_FORWARD} each; totals {counts}")
        results["launches"] = counts
        check_run_ledger(model_dir, TRAIN_FOLDS * steps, n_evals, "train")

        # a re-run is a no-op resume: no step trains, no checkpoint changes
        before = {f: fold_files(model_dir, f) for f in range(TRAIN_FOLDS)}
        kernels.reset_launch_counts()
        again = Trainer(model_dir, data, train_config=tcfg, device=device, input_shape=(size, size),
                        **model_kwargs).train(ids, classes, batch_size=batch, steps=steps)
        rerun = kernels.launch_counts()
        check(rerun["depthwise_conv2d_dx"] == 0 and rerun["depthwise_conv2d_dw"] == 0, f"the re-run trained: {rerun}")
        check({f: fold_files(model_dir, f) for f in range(TRAIN_FOLDS)} == before, "the re-run rewrote checkpoints")
        for a, b in zip(again, folds):
            check(all(abs(a[k] - b[k]) <= 1e-6 for k in b), f"re-run eval {a} != {b}")
        log(f"train: re-run is a no-op resume (launches {rerun}, checkpoints untouched, same eval)")

        # the fold stream is the data service's (data_service_workers=2, the
        # default): fold 0 stopped at step ``every`` and resumed to ``steps`` is handed
        # what the uninterrupted fold 0 was, batch for batch
        check(tcfg.data_service_workers == 2, f"data_service_workers {tcfg.data_service_workers}")
        check(len(fed) == TRAIN_FOLDS * steps, f"{len(fed)} batches fed to the uninterrupted run")
        resumed = Trainer(os.path.join(root, "model-resumed"), data, train_config=tcfg, device=device,
                          input_shape=(size, size), **model_kwargs)
        manifest = folds_lib.write_fold_manifests(resumed.model_dir, ids, list(np.asarray(classes)), tcfg.n_folds,
                                                  tcfg.seed)[0]
        dataset = pipeline_lib.InMemoryDataset.from_directory(data, ids=ids)
        fed_parts = []
        t0 = time.perf_counter()
        for stop in (every, steps):
            fed_parts.append([])
            with observe_prefetch(pipeline_lib, fed_parts[-1]):
                resumed._train_fold(0, dataset, manifest, batch, stop)
            if stop == every:
                sidecar = os.path.join(resumed.model_dir, "fold0", "checkpoints", f"data_state-{every}.json")
                check(os.path.exists(sidecar), f"no {sidecar} after a fold stopped at step {every}")
                state = json.load(open(sidecar))
                check(state["batch_index"] == every and state["seed"] == tcfg.seed, f"fold 0 sidecar {state}")
        resume_s = time.perf_counter() - t0
        check(fed_parts[0] == fed[:every], f"the fold stopped at step {every} was fed other batches than steps "
              f"0-{every - 1}")
        check(fed_parts[1] == fed[every:steps], f"the resumed fold was fed other batches than the uninterrupted "
              f"fold's steps {every}-{steps - 1}")
        results["resume_s"] = resume_s
        log(f"train: fold 0 stopped at step {every} (data_state-{every}.json: {json.dumps(state)}) and resumed to "
            f"{steps}: steps {every}-{steps - 1} fed the same {steps - every} batches (sha256 of images and masks) "
            f"as the uninterrupted fold; both runs {resume_s:.3f} s [{card}]")

        # the train step learns: 10 steps on one fixed batch from a fresh state
        dataset = pipeline_lib.InMemoryDataset.from_directory(data, ids=ids[:batch])
        placed = pipeline_lib.to_device({"images": dataset.images, "masks": dataset.masks}, torch.device(device))
        fixed = augment_lib.prepare_eval_batch(placed["images"], placed["masks"])
        state = create_train_state(cfg, tcfg, device, generator=torch.Generator().manual_seed(SEED))
        train_step = step_lib.make_train_step(step_lib.SegmentationTask())
        losses, times = [], []
        for _ in range(RESIDENT_STEPS):
            t0 = time.perf_counter()
            state, metrics = train_step(state, fixed)
            losses.append(step_lib.compute_metrics(metrics)["loss"])  # the host copy waits for the step
            times.append(time.perf_counter() - t0)
        check(all(np.isfinite(losses)), f"non-finite losses {losses}")
        check(losses[-1] < losses[0], f"10 steps on one batch did not lower the loss: {losses}")
        ms = statistics.median(times[2:]) * 1e3
        results.update(step_ms=ms, images_per_s=batch / ms * 1e3, losses=losses)
        log(f"train: fixed-batch losses {[round(v, 5) for v in losses]}")
        log(f"train: {ms:.3f} ms per step (median of steps 3-10), {batch / ms * 1e3:.3f} images/s at batch {batch} "
            f"[{card}]")
        if device == "cuda":
            for line in profile_steps(torch, train_step, state, fixed)[0]:
                log(f"profile: {line} [{card}]")

        # kernel path vs plain path: one step from one state and batch
        snapshot = {k: v.detach().clone() for k, v in state.model.state_dict().items()}
        task = step_lib.SegmentationTask()
        kernels.reset_launch_counts()
        loss_k, _ = step_lib.forward_backward(state, task, fixed)
        grads_k = {n: p.grad.detach().clone() for n, p in state.model.named_parameters()}
        check(kernels.launch_counts() == PER_TRAIN_STEP, f"kernel step launches {kernels.launch_counts()}")
        state.model.load_state_dict(snapshot)
        plain = {"depthwise_conv2d": kernels.depthwise_conv2d_plain, "bn_act_folded": kernels.bn_act_folded_plain,
                 "fused_sigmoid_mask": kernels.fused_sigmoid_mask_plain}
        with mock.patch.multiple(kernels, **plain):
            kernels.reset_launch_counts()
            loss_p, _ = step_lib.forward_backward(state, task, fixed)
            check(sum(kernels.launch_counts().values()) == 0, f"the plain step launched {kernels.launch_counts()}")
        state.model.load_state_dict(snapshot)
        d_loss = abs(float(loss_k) - float(loss_p))
        check(d_loss <= TOL_LOSS, f"kernel vs plain loss {float(loss_k)} vs {float(loss_p)}")
        worst, worst_name = 0.0, ""
        for n, p in state.model.named_parameters():
            gp, gk = p.grad, grads_k[n]
            err = (gk - gp).abs().max().item()
            tol = 1e-4 * gp.abs().max().item() + 1e-6
            check(err <= tol, f"gradient {n}: kernel vs plain max|err| {err} > {tol}")
            if err / tol > worst:
                worst, worst_name = err / tol, n
        log(f"train: kernel vs plain step: |dloss| {d_loss:.3g}; every gradient leaf within 1e-4·max|g|+1e-6 "
            f"(worst {worst_name} at {worst:.3f} of its tolerance)")

        # serve the trained model
        manifest = trainer.export_serving(0)
        engine = InferenceEngine.from_artifact(os.path.dirname(manifest), device=device, buckets=(1, 4))
        x4 = make_instances(torch, 4, SEED + 21)
        served = engine.infer(x4)["probabilities"]
        best = trainer.restore_fold(0).model.eval()
        with torch.no_grad():
            direct = torch.sigmoid(best(torch.from_numpy(x4).to(device))).cpu().numpy()
        d_serve = float(np.abs(served - direct).max())
        check(d_serve <= 1e-6, f"served probabilities differ from the eval-mode forward by {d_serve}")
        log(f"train: exported fold 0 serves through the engine at bucket 4, max|dprobs| vs eval forward {d_serve:.3g}")
        del best
        results.update(predict_checks(torch, trainer, os.path.dirname(manifest), root, card, device, size, batch,
                                      n_test))
    return results


def predict_checks(torch, trainer, artifact: str, root: str, card: str, device: str, size: int, batch: int,
                   n_test: int):
    """Trainer.predict, the fold x TTA ensemble, over a test directory of
    ``n_test`` new images: launches per forward, the same ensemble through
    the plain versions, and ``predict --artifact-dir`` on fold 0's export
    against the engine on the same images. Returns the launch counts of
    both routes and the ensemble's wall time."""
    from tensorflowdistributedlearning_tpu_torch.__main__ import main as cli_main
    from tensorflowdistributedlearning_tpu_torch.data import augment as augment_lib
    from tensorflowdistributedlearning_tpu_torch.data import pipeline as pipeline_lib
    from tensorflowdistributedlearning_tpu_torch.ops import kernels
    from tensorflowdistributedlearning_tpu_torch.serve import InferenceEngine
    from tensorflowdistributedlearning_tpu_torch.train import step as step_lib

    test_dir = os.path.join(root, "test")
    ids = write_salt_dataset(test_dir, n_test, size, SEED + 13)
    members = trainer.train_config.n_folds * len(augment_lib.TTA_TRANSFORMS)
    forwards = members * -(-n_test // batch)

    # the main path: counts from 0 just before, read just after
    ledger = LaunchLedger(kernels, step_lib)
    with ledger.patch():
        kernels.reset_launch_counts()
        t0 = time.perf_counter()
        pred = trainer.predict(test_dir, batch_size=batch)  # the host copy of each member waits for it
        predict_s = time.perf_counter() - t0
        counts = kernels.launch_counts()
    check(pred["ids"] == ids, "predict's ids are not the test directory's")
    probs, masks = pred["probabilities"], pred["masks"]
    check(probs.shape == (n_test, size, size, 1) and masks.shape == probs.shape, f"predict shapes {probs.shape}")
    check(bool(np.isfinite(probs).all()) and probs.min() >= 0 and probs.max() <= 1, "predict probabilities out of [0, 1]")
    check(np.array_equal(masks, (probs > 0.5).astype(np.float32)), "predict masks are not mean > 0.5")
    check(len(ledger.predict) == forwards, f"{len(ledger.predict)} predict forwards, expected {forwards}")
    for i, delta in enumerate(ledger.predict):
        check(delta == PER_EVAL_FORWARD, f"predict forward {i}: launches {delta}, expected {PER_EVAL_FORWARD}")
    want = {k: PER_EVAL_FORWARD[k] * forwards for k in counts}
    check(counts == want, f"predict launches {counts}, expected {want}")
    log(f"predict: Trainer.predict, {trainer.train_config.n_folds} folds x {len(augment_lib.TTA_TRANSFORMS)} "
        f"transforms over {n_test} {size}x{size} images at batch {batch}: {predict_s:.3f} s wall (restores, data and "
        f"host copies included), {n_test / predict_s:.3f} images/s, {forwards} forwards, "
        f"{n_test * members / predict_s:.3f} image-forwards/s [{card}]")
    log(f"predict: every forward launched {PER_EVAL_FORWARD}; totals {counts}")
    # parts of the wall time, each timed alone: a fold restore (predict
    # makes one a fold) into the draw-free template, the same restore into a
    # freshly drawn state (what it replaced), torch.load of the export, and
    # decoding the test directory
    def drawn_restore(fold):
        return trainer._checkpointer(fold).restore_best_or_raise(trainer._init_state())

    def timed(fn):
        t0 = time.perf_counter()
        fn()
        if device == "cuda":
            torch.cuda.synchronize()
        return time.perf_counter() - t0

    ckpt = trainer._checkpointer(0)
    export = os.path.join(ckpt.directory, "export", "best", str(ckpt.best_step()), "state.pt")
    restore_s = timed(lambda: trainer.restore_fold(0))
    drawn_s = timed(lambda: drawn_restore(0))
    torch_load_s = timed(lambda: torch.load(export, map_location="cpu", weights_only=True))
    load_s = timed(lambda: pipeline_lib.InMemoryDataset.from_directory(test_dir, with_masks=False))
    log(f"predict: one fold restore {restore_s:.3f} s without an init draw, {drawn_s:.3f} s into a freshly drawn "
        f"state; torch.load of the best export alone {torch_load_s:.3f} s; decoding the {n_test} test images "
        f"{load_s:.3f} s (host) [{card}]")
    with mock.patch.object(trainer, "restore_fold", drawn_restore):
        before = trainer.predict(test_dir, batch_size=batch)
    check(before["ids"] == pred["ids"] and all(np.array_equal(before[k], pred[k]) for k in ("probabilities", "masks")),
          "predict: the draw-free restore changed the predictions")
    log("predict: the ensemble through the draw-free restore is bit for bit the one through the drawn restore")

    # the same ensemble through the plain versions
    plain = {"depthwise_conv2d": kernels.depthwise_conv2d_plain, "bn_act_folded": kernels.bn_act_folded_plain,
             "fused_sigmoid_mask": kernels.fused_sigmoid_mask_plain}
    with mock.patch.multiple(kernels, **plain):
        kernels.reset_launch_counts()
        ref = trainer.predict(test_dir, batch_size=batch)
        check(sum(kernels.launch_counts().values()) == 0, f"the plain predict launched {kernels.launch_counts()}")
    d_probs = float(np.abs(probs - ref["probabilities"]).max())
    check(d_probs <= TOL_PROBS, f"predict: kernels vs plain max|dprobs| {d_probs} > {TOL_PROBS}")
    away = np.abs(ref["probabilities"] - 0.5) > TOL_PROBS
    check(np.array_equal(masks[away], ref["masks"][away]), "predict: masks differ from the plain ensemble's")
    log(f"predict: kernels vs plain ensemble max|dprobs| {d_probs:.3g}, masks equal away from the threshold "
        f"({int((~away).sum())} pixels within {TOL_PROBS}); mean mask coverage {float(masks.mean()):.4f}")

    # predict --artifact-dir on fold 0's export, against the engine
    out = os.path.join(root, "predict-artifact.npz")
    kernels.reset_launch_counts()
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(sys.stderr):
        code = cli_main(["predict", "--model-dir", trainer.model_dir, "--test-dir", test_dir, "--artifact-dir",
                         artifact, "--device", device, "--output", out])
    artifact_s = time.perf_counter() - t0
    artifact_counts = kernels.launch_counts()
    check(code == 0, f"predict --artifact-dir exited {code}")
    images = pipeline_lib.InMemoryDataset.from_directory(test_dir, with_masks=False).images
    images = augment_lib.add_laplace_channel(torch.from_numpy(images)).numpy()
    engine = InferenceEngine.from_artifact(artifact, device=device)
    saved = np.load(out)
    check(list(saved["ids"]) == ids, "predict --artifact-dir ids")
    for i in range(0, n_test, engine.max_batch_size):
        direct = engine.infer(images[i : i + engine.max_batch_size])
        for key in ("probabilities", "mask"):
            check(np.array_equal(saved[key][i : i + engine.max_batch_size], direct[key]),
                  f"predict --artifact-dir {key} differ from engine.infer on rows {i}..")
    chunks = -(-n_test // engine.max_batch_size)
    want = {k: v * chunks for k, v in PER_FORWARD.items()}
    check({k: artifact_counts[k] for k in want} == want and
          sum(artifact_counts.values()) == sum(want.values()),
          f"predict --artifact-dir launches {artifact_counts}, expected {want}")
    log(f"predict --artifact-dir: fold 0's export over {n_test} images in {chunks} engine forwards, {artifact_s:.3f} s "
        f"wall (artifact load included), equal to engine.infer on the same images; launches {want} [{card}]")
    return dict(predict_launches=counts, artifact_launches=artifact_counts, predict_s=predict_s,
                predict_images_per_s=n_test / predict_s, predict_forwards=forwards, restore_s=restore_s,
                drawn_restore_s=drawn_s, torch_load_s=torch_load_s)


# -- data-parallel training ---------------------------------------------------------


def state_digest(model) -> str:
    """sha256 of every parameter and buffer, in state_dict order."""
    h = hashlib.sha256()
    for name, t in model.state_dict().items():
        h.update(name.encode())
        h.update(t.detach().cpu().contiguous().numpy().tobytes())
    return h.hexdigest()[:16]


def same_state(torch, a, b) -> bool:
    return all(torch.equal(x, y) for x, y in zip(a.model.state_dict().values(), b.model.state_dict().values()))


def worst_gradient(want, got, what: str) -> float:
    """Every gradient leaf of ``got`` within 1e-4·max|want_leaf| + 1e-6 of
    ``want`` (the train step's kernel-vs-plain bound); returns the worst
    leaf's share of its tolerance."""
    worst = 0.0
    for name, w in want.items():
        err = (got[name] - w).abs().max().item()
        tol = 1e-4 * w.abs().max().item() + 1e-6
        check(err <= tol, f"{what}: gradient {name} max|err| {err} > {tol}")
        worst = max(worst, err / tol)
    return worst


def dp_batches(torch, data: str, ids, batch: int, n: int, device):
    """``n`` global batches of ``batch`` rows, in file order, with the eval
    preparation (no augmentation draw), on ``device``."""
    from tensorflowdistributedlearning_tpu_torch.data import augment as augment_lib
    from tensorflowdistributedlearning_tpu_torch.data import pipeline as pipeline_lib

    ds = pipeline_lib.InMemoryDataset.from_directory(data, ids=ids[: batch * n])
    placed = pipeline_lib.to_device({"images": ds.images, "masks": ds.masks}, torch.device(device))
    return [augment_lib.prepare_eval_batch(placed["images"][k * batch:(k + 1) * batch],
                                           placed["masks"][k * batch:(k + 1) * batch]) for k in range(n)]


def host_ms(torch, fn, reps: int = 5, warmup: int = 1) -> float:
    """Median host wall time of ``fn`` with the device synchronized before
    and after (for collectives that stage through the host)."""
    times = []
    for _ in range(reps + warmup):
        if torch.cuda.is_available():
            torch.cuda.synchronize()
        t0 = time.perf_counter()
        fn()
        if torch.cuda.is_available():
            torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
    return statistics.median(times[warmup:])


def check_trainer_launches(train, evals, counts, folds, steps: int, what: str) -> None:
    """Each train step's and eval forward's launch deltas, and their sum."""
    check(len(train) == folds * steps, f"{what}: {len(train)} train steps recorded")
    for i, delta in enumerate(train):
        check(delta == PER_TRAIN_STEP, f"{what} train step {i}: launches {delta}, expected {PER_TRAIN_STEP}")
    for i, delta in enumerate(evals):
        check(delta == PER_EVAL_FORWARD, f"{what} eval forward {i}: launches {delta}, expected {PER_EVAL_FORWARD}")
    want = {k: PER_TRAIN_STEP[k] * len(train) + PER_EVAL_FORWARD[k] * len(evals) for k in counts}
    check(counts == want, f"{what} launches {counts}, expected {want}")


def dp_world_one(torch, card: str, root: str, data: str, ids, device: str, model_kwargs, size: int, batch: int,
                 steps: int, timer):
    """Trainer.train as one NCCL rank (the main path of the data-parallel
    step), then its step against the single-device step and its times."""
    from tensorflowdistributedlearning_tpu_torch.config import ModelConfig, TrainConfig
    from tensorflowdistributedlearning_tpu_torch.ops import kernels
    from tensorflowdistributedlearning_tpu_torch.parallel import collectives
    from tensorflowdistributedlearning_tpu_torch.train import step as step_lib
    from tensorflowdistributedlearning_tpu_torch.train.state import create_train_state
    from tensorflowdistributedlearning_tpu_torch.train.trainer import Trainer

    cfg = ModelConfig(input_shape=(size, size), **model_kwargs)
    tcfg = TrainConfig(n_folds=DP_FOLDS, seed=SEED % 1000 + 1, checkpoint_every_steps=steps, save_best=1)
    out = {}

    # the main path: counts from 0 just before, read just after
    ledger = LaunchLedger(kernels, step_lib, Trainer)
    trainer = Trainer(os.path.join(root, "model-dp"), data, train_config=tcfg,
                      device=None if device == "cuda" else device, input_shape=(size, size), **model_kwargs)
    check(trainer.data_parallel and collectives.world_size() == 1, "the trainer did not take the one-rank group")
    with ledger.patch():
        kernels.reset_launch_counts()
        t0 = time.perf_counter()
        folds = trainer.train(ids, batch_size=batch, steps=steps)
        if device == "cuda":
            torch.cuda.synchronize()
        train_s = time.perf_counter() - t0
        counts = kernels.launch_counts()
    for fold, metrics in enumerate(folds):
        check(all(np.isfinite(v) for v in metrics.values()), f"train-dp fold {fold}: non-finite metrics {metrics}")
        check(sorted(fold_files(os.path.join(root, "model-dp"), fold)["checkpoints"]) == [steps],
              f"train-dp fold {fold}: checkpoints")
    # eval forwards: the passes' and the image summaries'
    check_trainer_launches(ledger.train, ledger.eval + ledger.summary, counts, DP_FOLDS, steps, "train-dp")
    out["launches"] = counts
    log(f"train-dp: Trainer.train as 1 {torch.distributed.get_backend()} rank on {trainer.device}, {DP_FOLDS} folds x "
        f"{steps} steps at batch {batch}, {train_s:.3f} s; {len(ledger.train)} train steps launched "
        f"{PER_TRAIN_STEP} each, {len(ledger.eval)} eval forwards {PER_EVAL_FORWARD} each [{card}]")
    del trainer

    # the data-parallel step of one rank against the single-device step:
    # three steps from one seeded state on three fixed batches, under
    # PyTorch's deterministic algorithms (by default cuDNN picks algorithms
    # that add in a run-dependent order, so the single-device step is not
    # bitwise repeatable: it is checked here)
    fixed = dp_batches(torch, data, ids, batch, 3, trainer_device(torch, device))
    task = step_lib.SegmentationTask()
    dp_step = step_lib.make_train_step(task, data_parallel=True)
    single_step = step_lib.make_train_step(task)

    def run(step):
        state = create_train_state(cfg, tcfg, trainer_device(torch, device),
                                   generator=torch.Generator().manual_seed(SEED + 5))
        return state, [step_lib.compute_metrics(step(state, b)[1])["loss"] for b in fixed]

    with deterministic_algorithms(torch):
        single, loss_single = run(single_step)
        again, loss_again = run(single_step)
        check(same_state(torch, single, again) and loss_again == loss_single,
              "3 single-device steps are not bitwise repeatable under deterministic algorithms")
        del again
        dp, loss_dp = run(dp_step)
    check(same_state(torch, dp, single) and loss_dp == loss_single,
          f"3 one-rank data-parallel steps are not bit for bit 3 single-device steps (losses {loss_dp} vs "
          f"{loss_single})")
    flat = dp.flat_grad
    before = flat.clone()
    collectives.pmean_(flat)
    check(torch.equal(before, flat), "the one-rank all-reduce of the gradient is not the identity")
    log(f"train-dp: 3 one-rank data-parallel steps are bit for bit 3 single-device steps under deterministic "
        f"algorithms (losses {loss_dp}); the one-rank all-reduce of the gradient is the identity")
    # with the default algorithms, as Trainer.train runs: the single-device
    # step against itself and the one-rank step against both, read, not held
    def gap(a, b):
        return max((x - y).abs().max().item() for x, y in zip(a.model.state_dict().values(),
                                                              b.model.state_dict().values()))

    first, loss_first = run(single_step)
    dp_default, loss_dp_default = run(dp_step)
    second, loss_second = run(single_step)
    out["default_single_gap"] = gap(first, second)
    out["default_dp_gap"] = max(gap(dp_default, first), gap(dp_default, second))
    log(f"train-dp: default algorithms, 3 steps from one state: single-device vs single-device max|dstate| "
        f"{out['default_single_gap']:.3g} (losses {loss_first} vs {loss_second}); one-rank data-parallel vs "
        f"single-device max|dstate| {out['default_dp_gap']:.3g} (losses {loss_dp_default})")
    del first, second, dp_default
    fixed = fixed[:1]

    # times: the two steps alternately on one batch, then the all-reduce alone
    ms = {"dp": [], "single": []}
    for _ in range(DP_TIMED_ALTERNATIONS):
        for name, step, state in (("dp", dp_step, dp), ("single", single_step, single)):
            ms[name].append(host_ms(torch, lambda: step(state, fixed[0]), reps=1, warmup=0))
    out["ms_dp"], out["ms_single"] = statistics.median(ms["dp"][1:]), statistics.median(ms["single"][1:])
    nbytes = flat.numel() * flat.element_size()
    out["allreduce_bound_ms"] = 2 * nbytes / PEAK_BYTES_S * 1e3
    out["allreduce_ms"] = timer.ms(lambda: collectives.pmean_(flat)) if timer is not None else host_ms(
        torch, lambda: collectives.pmean_(flat))
    log(f"train-dp: {out['ms_dp']:.3f} ms per one-rank data-parallel step vs {out['ms_single']:.3f} ms single-device "
        f"at batch {batch} (median of {DP_TIMED_ALTERNATIONS - 1}, alternating); gradient all-reduce of "
        f"{flat.numel()} float32 "
        f"({nbytes / 1e6:.1f} MB) {out['allreduce_ms']:.4f} ms, bound {out['allreduce_bound_ms']:.4f} ms "
        f"(read and write once at 3.35 TB/s) [{card}]")
    return out


@contextlib.contextmanager
def deterministic_algorithms(torch):
    """PyTorch's deterministic algorithms (and cuDNN's) for the duration."""
    saved = (torch.are_deterministic_algorithms_enabled(), torch.backends.cudnn.deterministic,
             torch.backends.cudnn.benchmark)
    torch.use_deterministic_algorithms(True)
    torch.backends.cudnn.deterministic, torch.backends.cudnn.benchmark = True, False
    try:
        yield
    finally:
        torch.use_deterministic_algorithms(saved[0])
        torch.backends.cudnn.deterministic, torch.backends.cudnn.benchmark = saved[1], saved[2]


def trainer_device(torch, device: str):
    if device == "cuda":
        return torch.device("cuda", torch.cuda.current_device())
    return torch.device(device)


@contextlib.contextmanager
def record_kernel_calls(torch, limits):
    """Records the first ``limits[name]`` calls of each named wrapper of
    ops/kernels.py while it runs as before: its arguments (tensors cloned),
    its result, and for dw the route it planned at the call. Yields
    ``{name: [(args, out, plan), ...]}``."""
    from tensorflowdistributedlearning_tpu_torch.ops import kernels

    calls = {name: [] for name in limits}

    def recording(name, inner):
        def wrapper(*args):
            plan = kernels.dw_route(*args) if name == "depthwise_conv2d_dw" else None
            out = inner(*args)
            if len(calls[name]) < limits[name]:
                kept = tuple(a.detach().clone() if isinstance(a, torch.Tensor) else a for a in args)
                calls[name].append((kept, out.detach().clone(), plan))
            return out

        return wrapper

    with contextlib.ExitStack() as stack:
        for name in limits:
            stack.enter_context(mock.patch.object(kernels, name, recording(name, getattr(kernels, name))))
        yield calls


def hold_rank_calls(torch, calls, whole_batch: int):
    """A rank's recorded main-path calls (:data:`RANK_HELD`) held as the
    single-device path's are: the forward and dx bitwise the earlier kernel
    and within TOL_DEPTHWISE / TOL_DX of plain; dw on the band kernel, its
    plan the one planned at the call, within the dw tolerance of plain and
    bitwise a relaunch; BN bitwise the earlier kernel and within TOL_BN of
    plain. Returns each kernel's max|err| and the dw plans beside the plans
    at ``whole_batch`` rows."""
    from tensorflowdistributedlearning_tpu_torch.ops import kernels

    for name, n in RANK_HELD.items():
        check(len(calls[name]) == n, f"recorded {len(calls[name])} {name} calls of the rank's main path, expected {n}")
    out = {"depthwise_conv2d": 0.0, "depthwise_conv2d_dx": 0.0, "depthwise_conv2d_dw": 0.0, "fused_bn_act": 0.0,
           "dw_plans": [], "shapes": []}
    with torch.inference_mode():
        for (x, w, rate), got, _ in calls["depthwise_conv2d_forward"]:
            what = f"depthwise forward, the rank's {tuple(x.shape)} rate {rate}"
            check(same(torch, got, kernels._earlier_depthwise(x, w, rate, False)), f"{what}: not bitwise the earlier kernel")
            e = (got - kernels.depthwise_conv2d_plain(x, w, rate)).abs().max().item()
            check(e <= TOL_DEPTHWISE, f"{what}: max|err| {e} > {TOL_DEPTHWISE} against the plain version")
            out["depthwise_conv2d"] = max(out["depthwise_conv2d"], e)
            out["shapes"].append(list(x.shape))
        for (g, w, rate), got, _ in calls["depthwise_conv2d_dx"]:
            what = f"depthwise dx, the rank's {tuple(g.shape)} rate {rate}"
            check(same(torch, got, kernels._earlier_depthwise(g, w, rate, True)), f"{what}: not bitwise the earlier kernel")
            e = (got - kernels._dx_plain(g, w, rate)).abs().max().item()
            check(e <= TOL_DX, f"{what}: max|err| {e} > {TOL_DX} against the plain version")
            out["depthwise_conv2d_dx"] = max(out["depthwise_conv2d_dx"], e)
        for (x, g, ks, rate), got, plan in calls["depthwise_conv2d_dw"]:
            kh, kw = int(ks[0]), int(ks[1])
            b, h, wd, c = x.shape
            what = f"dw, the rank's {tuple(x.shape)} {kh}x{kw} rate {rate}"
            check(plan is not None, f"{what}: the call took the earlier tile kernel, not the band kernel")
            check(kernels.dw_route(x, g, (kh, kw), rate) == plan, f"{what}: the held copy plans otherwise than the call")
            kernels.reset_launch_counts()
            e = dw_agreement(torch, x, g, kh, kw, rate, what)
            check(kernels.launch_counts()["depthwise_conv2d_dw_band"] == 2, f"{what}: {kernels.launch_counts()}")
            check(same(torch, got, kernels.depthwise_conv2d_dw(x, g, (kh, kw), rate)),
                  f"{what}: the path's result is not bitwise a relaunch")
            out["depthwise_conv2d_dw"] = max(out["depthwise_conv2d_dw"], e)
            out["dw_plans"].append(f"{tuple(x.shape)} rate {rate}: {describe_dw_route(plan)}; at batch {whole_batch}: "
                                   f"{describe_dw_route(kernels.dw_plan(whole_batch, h, wd, c, kh, kw, rate, True))}")
        for (x, m, b, act, res), got, _ in calls["bn_act_folded"]:
            what = f"fused_bn_act, the rank's eval call {tuple(x.shape)} {act} res={res is not None}"
            check(same(torch, got, kernels._earlier_bn_act(x, m, b, act, res)), f"{what}: not bitwise the earlier kernel")
            want = kernels.bn_act_folded_plain(x, m, b, act, res)
            e = (got - want).abs().max().item()
            check(bool(((got - want).abs() <= TOL_BN + TOL_BN * want.abs()).all()),
                  f"{what}: max|err| {e} beyond {TOL_BN} + {TOL_BN}·|plain|")
            out["fused_bn_act"] = max(out["fused_bn_act"], e)
        out["bn_rows"] = sorted({x.shape[0] for (x, *_), _, _ in calls["bn_act_folded"]})
    return out


def dp_rank(torch, rank: int, world: int, store: str, root: str, device: str, model_kwargs, size: int,
            batch: int, steps: int):
    """One of the ranks that share the card over gloo: the first
    data-parallel step of per-rank and of synchronized BN held against its
    single-process emulation (rank 0), ``steps`` steps, a digest of the
    replica, the times, and Trainer.train with its launches."""
    from tensorflowdistributedlearning_tpu_torch.config import ModelConfig, TrainConfig
    from tensorflowdistributedlearning_tpu_torch.ops import kernels
    from tensorflowdistributedlearning_tpu_torch.parallel import collectives, mesh, multihost
    from tensorflowdistributedlearning_tpu_torch.train import step as step_lib
    from tensorflowdistributedlearning_tpu_torch.train.state import create_train_state, replicate
    from tensorflowdistributedlearning_tpu_torch.train.trainer import Trainer

    dev = torch.device(device if device == "cpu" else "cuda:0")
    multihost.initialize(store, world, rank, backend="gloo", timeout=300)
    out = {"rank": rank}
    try:
        if dev.type == "cuda":
            torch.cuda.set_device(0)
            torch.backends.cudnn.allow_tf32 = False
            torch.backends.cuda.matmul.allow_tf32 = False
            t0 = time.perf_counter()
            build()  # loads the warm build, or builds it cold racing the other rank
            out["build_s"] = time.perf_counter() - t0
        data = os.path.join(root, "data")
        ids = sorted(f[:-4] for f in os.listdir(os.path.join(data, "images")))
        cfg = ModelConfig(input_shape=(size, size), **model_kwargs)
        task = smooth_task()
        (whole,) = dp_batches(torch, data, ids, batch, 1, dev)
        rows = mesh.shard_rows(batch, rank, world)
        local = {k: v[rows] for k, v in whole.items()}
        for name, sync in (("off", False), ("on", True)):
            tcfg = TrainConfig(seed=SEED % 1000 + 2, sync_batch_norm=sync)
            state = replicate(create_train_state(cfg, tcfg, dev, generator=torch.Generator().manual_seed(SEED + 7)))
            step = step_lib.make_train_step(task, data_parallel=True)
            # the first step and its emulation in one summation order each
            with deterministic_algorithms(torch):
                loss = step_lib.compute_metrics(step(state, local)[1])["loss"]
                grads = {n: p.grad.detach().clone() for n, p in state.model.named_parameters()}
                stats = {n: b.detach().clone() for n, b in state.model.named_buffers()}
                if rank == 0:
                    out[f"first_{name}"] = dp_emulation(torch, cfg, tcfg, dev, task, whole, world, loss, grads,
                                                        stats, per_rank=not sync)
            times = [host_ms(torch, lambda: step(state, local), reps=1, warmup=0) for _ in range(DP_TIMED_STEPS - 1)]
            out[f"digest_{name}"] = state_digest(state.model)
            out[f"ms_{name}"] = statistics.median(times)
            if not sync:
                flat = state.flat_grad
                out["allreduce_ms"] = host_ms(torch, lambda: collectives.pmean_(flat), reps=3)
                out["allreduce_mb"] = flat.numel() * flat.element_size() / 1e6
                del flat
            del state, grads, stats
            if dev.type == "cuda":
                torch.cuda.empty_cache()

        # the main path: Trainer.train, counts from 0 just before, read just after
        tcfg = TrainConfig(n_folds=DP_FOLDS, seed=SEED % 1000 + 3, checkpoint_every_steps=steps, save_best=1,
                           n_devices=world)
        trainer = Trainer(os.path.join(root, "model-dp2"), data, train_config=tcfg, device=dev,
                          input_shape=(size, size), **model_kwargs)
        ledger = LaunchLedger(kernels, step_lib, Trainer)
        with ledger.patch(), record_kernel_calls(torch, RANK_HELD) as recorded:
            kernels.reset_launch_counts()
            t0 = time.perf_counter()
            out["metrics"] = trainer.train(ids, batch_size=batch, steps=steps)
            if dev.type == "cuda":
                torch.cuda.synchronize()
            out["train_s"] = time.perf_counter() - t0
            out["launches"] = kernels.launch_counts()
        out["ledger_train"], out["ledger_eval"] = ledger.train, ledger.eval + ledger.summary
        if dev.type == "cuda":  # on the CPU the plain versions ran: nothing to hold
            out["held"] = hold_rank_calls(torch, recorded, batch)
        del recorded
        multihost.barrier()
    finally:
        multihost.shutdown()
    return out


def smooth_task():
    """The segmentation task under sigmoid cross entropy. The first-step
    checks compare runs whose logits differ in the last bits (global BN
    statistics as a mean of the ranks' means); the Lovász hinge's gradient
    is piecewise constant in the logits, so such a bit moves it through the
    sort order of near-equal errors, and the comparison would measure that.
    Trainer.train keeps the Lovász hinge."""
    from tensorflowdistributedlearning_tpu_torch.ops import losses as losses_lib
    from tensorflowdistributedlearning_tpu_torch.train import step as step_lib

    class SmoothTask(step_lib.SegmentationTask):
        def loss(self, logits, batch):
            return losses_lib.sigmoid_cross_entropy(logits, batch["labels"])

    return SmoothTask()


@contextlib.contextmanager
def split_batch_convs(world: int):
    """Every convolution of a whole batch as ``world`` convolutions of the
    ranks' row blocks, concatenated: cuDNN picks its algorithm by batch
    size, so this gives each row what the rank that owns it computes."""
    import torch.nn.functional as F

    plain = F.conv2d

    def conv2d(x, *args, **kwargs):
        import torch

        return torch.cat([plain(block, *args, **kwargs) for block in x.chunk(world)])

    F.conv2d = conv2d
    try:
        yield
    finally:
        F.conv2d = plain


def dp_emulation(torch, cfg, tcfg, dev, task, whole, world: int, loss, grads, stats, per_rank: bool):
    """The first data-parallel step's semantics in this process, from the
    same seeded state. Per-rank BN: each rank's rows forward and backward,
    the gradients and statistics averaged. Synchronized BN: one whole-batch
    forward and backward with the statistics formed from the ranks' row
    blocks (``layers.split_moments``) and each convolution run on the
    ranks' blocks (:func:`split_batch_convs`), so that the forward is the
    ranks' to the bit and only the backward's sums over the batch are
    grouped otherwise; and the plain whole-batch step beside it. Holds the step's loss (1e-5), gradient (per leaf
    1e-4·max|g| + 1e-6) and BN statistics (1e-5) against the emulation, and
    the loss and statistics against the plain whole-batch step; the
    gradient's distance from the plain step is reported (a rounding-level
    change of the statistics can take a ReLU or max-pool kink the other
    way)."""
    import dataclasses

    from tensorflowdistributedlearning_tpu_torch.models.layers import split_moments
    from tensorflowdistributedlearning_tpu_torch.parallel import mesh
    from tensorflowdistributedlearning_tpu_torch.train import step as step_lib
    from tensorflowdistributedlearning_tpu_torch.train.state import create_train_state

    # no sync flag: its statistics would reduce over the group
    emu = create_train_state(cfg, dataclasses.replace(tcfg, sync_batch_norm=False), dev,
                             generator=torch.Generator().manual_seed(SEED + 7))
    snapshot = {k: v.clone() for k, v in emu.model.state_dict().items()}

    def run(parts, split: bool):
        g_sum, s_sum, losses = {}, {}, []
        for rows in parts:
            emu.model.load_state_dict(snapshot)
            with contextlib.ExitStack() as stack:
                if split:
                    stack.enter_context(split_moments(world))
                    stack.enter_context(split_batch_convs(world))
                l, _ = step_lib.forward_backward(emu, task, {k: v[rows] for k, v in whole.items()})
            losses.append(float(l))
            for n, p in emu.model.named_parameters():
                g_sum[n] = g_sum.get(n, 0) + p.grad
            for n, b in emu.model.named_buffers():
                s_sum[n] = s_sum.get(n, 0) + b
        k = len(parts)
        return sum(losses) / k, {n: g / k for n, g in g_sum.items()}, {n: s / k for n, s in s_sum.items()}

    def held(want_loss, want_s, what):
        d_loss = abs(loss - want_loss)
        check(d_loss <= TOL_LOSS, f"{what}: loss {loss} vs {want_loss}")
        d_stats = max((stats[n] - s).abs().max().item() for n, s in want_s.items())
        check(d_stats <= 1e-5, f"{what}: BN statistics {d_stats} apart")
        return d_loss, d_stats

    if per_rank:
        want_loss, want_g, want_s = run([mesh.shard_rows(whole["images"].shape[0], r, world) for r in range(world)],
                                        split=False)
        d_loss, d_stats = held(want_loss, want_s, "per-rank BN first step vs its emulation")
        out = {"worst_gradient": worst_gradient(want_g, grads, "per-rank BN first step vs its emulation")}
    else:
        want_loss, want_g, want_s = run([slice(None)], split=True)
        d_loss, d_stats = held(want_loss, want_s, "synchronized BN first step vs its emulation")
        out = {"worst_gradient": worst_gradient(want_g, grads, "synchronized BN first step vs its emulation")}
        plain_loss, plain_g, plain_s = run([slice(None)], split=False)
        out["plain_d_loss"], out["plain_d_stats"] = held(plain_loss, plain_s,
                                                         "synchronized BN first step vs the whole-batch step")
        out["plain_worst_gradient"] = max(
            (grads[n] - g).abs().max().item() / (1e-4 * g.abs().max().item() + 1e-6) for n, g in plain_g.items())
    del emu
    out.update(d_loss=d_loss, d_stats=d_stats)
    return out


# the kernel libraries the data-parallel path launches (depthwise fwd/dx,
# dw, BN): what two processes build cold into one directory at once
COLD_LIBS = ("depthwise", "depthwise_dw", "bn_act")


def start_cold_builds(directory: str):
    """Starts DP_RANKS processes (``chip_smoke.py cold-build DIR K``) that
    build :data:`COLD_LIBS` into the one cold ``directory`` at once; their
    build times land in ``DIR/cold-build-K.json``."""
    env = dict(os.environ, TFDL_TORCH_BUILD_DIR=directory)
    return [subprocess.Popen([sys.executable, os.path.abspath(__file__), "cold-build", directory, str(k)], env=env,
                             stdout=subprocess.PIPE, stderr=subprocess.STDOUT)
            for k in range(DP_RANKS)]


def finish_cold_builds(procs, directory: str, timeout: float = 600.0):
    """Waits for :func:`start_cold_builds`' processes; each must exit 0.
    Returns their build times (s)."""
    deadline = time.perf_counter() + timeout
    texts = []
    try:
        for p in procs:
            out, _ = p.communicate(timeout=max(1.0, deadline - time.perf_counter()))
            texts.append(out.decode(errors="replace"))
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    for k, (p, text) in enumerate(zip(procs, texts)):
        check(p.returncode == 0, f"cold build {k} exited {p.returncode}:\n{text[-3000:]}")
    times = []
    for k in range(len(procs)):
        with open(os.path.join(directory, f"cold-build-{k}.json")) as f:
            times.append(json.load(f)["build_s"])
    return times


def cold_build_main(argv) -> int:
    """``chip_smoke.py cold-build DIR K``: builds :data:`COLD_LIBS` into
    ``TFDL_TORCH_BUILD_DIR`` (DIR), loads every entry point of them, and
    writes ``DIR/cold-build-K.json``."""
    from tensorflowdistributedlearning_tpu_torch.ops import _build, kernels

    every = _build.sources()
    t0 = time.perf_counter()
    with mock.patch.object(_build, "sources", lambda: {n: every[n] for n in COLD_LIBS}):
        _build.build_all()
        for fn_name, (lib, _) in kernels._signatures.items():
            if lib in COLD_LIBS:
                kernels._entry(fn_name)
    with open(os.path.join(argv[0], f"cold-build-{argv[1]}.json"), "w") as f:
        json.dump({"build_s": time.perf_counter() - t0}, f)
    return 0


def dp_two_ranks(torch, card: str, root: str, device: str, model_kwargs, size: int, batch: int, steps: int,
                 cold=None):
    """Two gloo ranks on the one card, each a subprocess of this script
    (``chip_smoke.py dp-rank ...``). ``cold``: the build times of
    :func:`start_cold_builds`' processes, and the ranks load the warm
    build; without it the ranks build the kernels into one cold directory
    at once."""
    env = dict(os.environ) if cold else dict(os.environ, TFDL_TORCH_BUILD_DIR=os.path.join(root, "build-cold"))
    store = f"file://{os.path.join(root, 'store-dp2')}"
    procs, logs = [], []
    t0 = time.perf_counter()
    try:
        for rank in range(DP_RANKS):
            logs.append(open(os.path.join(root, f"rank{rank}.log"), "w"))
            procs.append(subprocess.Popen(
                [sys.executable, os.path.abspath(__file__), "dp-rank", str(rank), str(DP_RANKS), store, root, device,
                 json.dumps(model_kwargs), str(size), str(batch), str(steps)],
                stdout=logs[-1], stderr=subprocess.STDOUT, env=env,
            ))
        deadline = time.perf_counter() + DP_TIMEOUT_S
        for rank, p in enumerate(procs):
            try:
                p.wait(timeout=max(1.0, deadline - time.perf_counter()))
            except subprocess.TimeoutExpired:
                pass
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
        for f in logs:
            f.close()
    wall = time.perf_counter() - t0
    outs = []
    for rank, p in enumerate(procs):
        with open(os.path.join(root, f"rank{rank}.log")) as f:
            text = f.read()
        check(p.returncode == 0, f"dp rank {rank} exited {p.returncode}:\n{text[-3000:]}")
        with open(os.path.join(root, f"rank{rank}.json")) as f:
            outs.append(json.load(f))
    r0 = outs[0]
    for o in outs[1:]:
        for name in ("off", "on"):
            check(o[f"digest_{name}"] == r0[f"digest_{name}"],
                  f"replicas differ after {steps} steps (BN {name}): {[x[f'digest_{name}'] for x in outs]}")
        check(o["metrics"] == r0["metrics"], f"ranks return different metrics: {o['metrics']} vs {r0['metrics']}")
    for o in outs:
        check_trainer_launches(o["ledger_train"], o["ledger_eval"], o["launches"], DP_FOLDS, steps,
                               f"train-dp2 rank {o['rank']}")
    keep_ledgers(os.path.join(root, "model-dp2"), "train-dp2")
    for name in ("off", "on"):
        e = r0[f"first_{name}"]
        plain = (f"; against the plain whole-batch step |dloss| {e['plain_d_loss']:.3g}, BN statistics "
                 f"{e['plain_d_stats']:.3g}, worst gradient leaf at {e['plain_worst_gradient']:.3f} of the tolerance "
                 "(reported)") if "plain_d_loss" in e else ""
        log(f"train-dp2: BN {name}: first step vs its single-process emulation: |dloss| {e['d_loss']:.3g}, worst "
            f"gradient leaf at {e['worst_gradient']:.3f} of its tolerance, BN statistics {e['d_stats']:.3g}{plain}; "
            f"after {steps} steps the {DP_RANKS} replicas' digests are equal ({r0[f'digest_{name}']})")
    held = {}
    for o in outs if device == "cuda" else ():
        h = o["held"]
        log(f"train-dp2 rank {o['rank']}: its Trainer.train's first step's {RANK_HELD['depthwise_conv2d_forward']} "
            f"depthwise forward, dx and dw calls at {h['shapes']} and its first eval forward's "
            f"{RANK_HELD['bn_act_folded']} fused_bn_act calls at {h['bn_rows']} rows held against the plain versions: "
            f"forward max|err| {h['depthwise_conv2d']:.3g}, dx {h['depthwise_conv2d_dx']:.3g}, dw "
            f"{h['depthwise_conv2d_dw']:.3g}, BN {h['fused_bn_act']:.3g} (forward, dx and BN bitwise the earlier "
            f"kernels, dw bitwise a relaunch)")
        for plan in h["dw_plans"]:
            log(f"train-dp2 rank {o['rank']}: dw {plan}")
        for name in ("depthwise_conv2d", "depthwise_conv2d_dx", "depthwise_conv2d_dw", "fused_bn_act"):
            held[name] = max(held.get(name, 0.0), h[name])
    loads = [round(o.get("build_s", 0.0), 3) for o in outs]
    builds = [round(t, 3) for t in cold] if cold else loads
    where = (f"cold builds of {'/'.join(COLD_LIBS)} racing in one directory {builds} s (two processes beside this "
             f"one's build at the start), the ranks' loads of the warm build {loads} s") if cold else \
        f"cold kernel builds racing in one directory {builds} s"
    log(f"train-dp2: {DP_RANKS} gloo ranks sharing {device} at batch {batch // DP_RANKS} each (global {batch}): "
        f"{r0['ms_off']:.3f} ms per step with per-rank BN, {r0['ms_on']:.3f} ms with synchronized BN (rank 0, median "
        f"of {DP_TIMED_STEPS - 1}); host-staged gradient all-reduce of {r0['allreduce_mb']:.1f} MB {r0['allreduce_ms']:.3f} ms; "
        f"{where}; {wall:.3f} s in all [{card}]")
    log(f"train-dp2: Trainer.train on every rank, {DP_FOLDS} folds x {steps} steps, {r0['train_s']:.3f} s; each rank's "
        f"{len(r0['ledger_train'])} train steps launched {PER_TRAIN_STEP} each; metrics equal on every rank "
        f"{json.dumps(r0['metrics'])} [{card}]")
    return {"launches": r0["launches"], "ms_off": r0["ms_off"], "ms_on": r0["ms_on"],
            "allreduce_ms": r0["allreduce_ms"], "build_s": builds, "held": held}


def dp_phase(torch, card: str, device: str = "cuda", model_kwargs=None, n_images: int = DP_IMAGES,
             size: int = 101, batch: int = TRAIN_BATCH, steps: int = DP_STEPS, timer=None, cold=None):
    """Data-parallel training: one NCCL rank in this process, then two gloo
    ranks sharing the card (``cold``: see :func:`dp_two_ranks`)."""
    from tensorflowdistributedlearning_tpu_torch.parallel import multihost

    model_kwargs = dict(model_kwargs or {}, use_pallas_depthwise=True)
    with tempfile.TemporaryDirectory(prefix="chip-smoke-dp-") as root:
        data = os.path.join(root, "data")
        ids = write_salt_dataset(data, n_images, size, SEED + 31)
        multihost.initialize(f"file://{os.path.join(root, 'store-dp1')}", 1, 0,
                             backend="nccl" if device == "cuda" else "gloo", timeout=300)
        try:
            one = dp_world_one(torch, card, root, data, ids, device, model_kwargs, size, batch, steps, timer)
        finally:
            multihost.shutdown()
        if device == "cuda":
            torch.cuda.empty_cache()
        two = dp_two_ranks(torch, card, root, device, model_kwargs, size, batch, steps, cold=cold)
    return {"train-dp": one, "train-dp2": two}


def dp_rank_main(argv) -> int:
    """``chip_smoke.py dp-rank RANK WORLD STORE ROOT DEVICE MODEL_KWARGS SIZE
    BATCH STEPS``: one rank of the two-rank phase; writes
    ``ROOT/rank{RANK}.json``."""
    import torch

    rank, world, store, root, device = int(argv[0]), int(argv[1]), argv[2], argv[3], argv[4]
    model_kwargs, size, batch, steps = json.loads(argv[5]), int(argv[6]), int(argv[7]), int(argv[8])
    try:
        out = dp_rank(torch, rank, world, store, root, device, model_kwargs, size, batch, steps)
    except SmokeFailure as e:
        print(f"FAIL: {e}", file=sys.stderr)
        return 1
    with open(os.path.join(root, f"rank{rank}.json"), "w") as f:
        json.dump(out, f)
    return 0


# -- ResNet bf16 compute, the ResNet-50 classifier, LARS + remat + accumulation ---------------


def bf16_step_map(torch, a, b):
    """Distance in bf16 steps between two bf16 tensors, element by element
    (bit patterns as ordered integers)."""

    def ordered(t):
        bits = t.contiguous().view(torch.int16).to(torch.int32)
        return torch.where(bits < 0, -(bits & 0x7FFF), bits)

    return (ordered(a) - ordered(b)).abs()


def bf16_steps(torch, a, b, atol: float = 1e-6) -> int:
    """Largest distance in bf16 steps between two bf16 tensors, 0 where the
    two are within ``atol``: near zero a bf16 step is far below float32's
    noise (:func:`smooth_act_sweep` reads it)."""
    if not a.numel():
        return 0
    steps = bf16_step_map(torch, a, b)
    return int(torch.where((a.float() - b.float()).abs() <= atol, 0, steps).max())


def hold_bf16(torch, got, want, what: str, steps: int = TOL_BF16_STEPS) -> float:
    """A bf16 kernel result against its plain version: one dtype and shape,
    within ``steps`` bf16 steps; returns max|got - want|."""
    check(got.dtype == want.dtype == torch.bfloat16 and got.shape == want.shape,
          f"{what}: {got.dtype} {tuple(got.shape)} against {want.dtype} {tuple(want.shape)}")
    n = bf16_steps(torch, got, want)
    check(n <= steps, f"{what}: {n} bf16 steps from the plain version (> {steps})")
    return (got.float() - want.float()).abs().max().item()


def smooth_act_sweep(torch, card: str, shape=(64, 51, 51, 128)) -> dict:
    """The bf16 BN row kernel with sigmoid and gelu, which no bf16 path
    calls, on the draws of tests/test_torch_cuda.py's first case (``shape``,
    a CUDA generator seeded with ``len(act)``; x·3, a residual, m, b), with
    and without the residual: held within TOL_BF16_STEPS of the plain
    version at the 1e-6 absolute floor of :func:`bf16_steps`. Logs the raw
    largest step count and the largest |gap| among elements more than one
    step apart: gelu's ``0.5·y·(1 + tanh(inner))`` cancels for large
    negative ``y``, where tanh's float32 result near -1 moves in steps of
    6e-8, so a tiny result can be many bf16 steps apart while its absolute
    gap stays below ``|y|·6e-8``."""
    from tensorflowdistributedlearning_tpu_torch.ops import kernels

    out = {}
    n, c = int(np.prod(shape)), shape[-1]
    with torch.no_grad():
        for act in ("sigmoid", "gelu"):
            g = torch.Generator(device="cuda").manual_seed(len(act))
            x = (3.0 * torch.randn(n, device="cuda", generator=g)).to(torch.bfloat16).view(shape)
            r = torch.randn(n, device="cuda", generator=g).to(torch.bfloat16).view(shape)
            m, b = torch.rand(c, device="cuda", generator=g) + 0.5, torch.randn(c, device="cuda", generator=g)
            for res in (None, r):
                what = f"BN + {act} sweep {shape}{' + residual' if res is not None else ''}"
                got, want = kernels.bn_act_folded(x, m, b, act, res), kernels.bn_act_folded_plain(x, m, b, act, res)
                hold_bf16(torch, got, want, f"train-bf16 {what}")
                steps = bf16_step_map(torch, got, want)
                far = steps > TOL_BF16_STEPS
                gap = float((got.float() - want.float()).abs()[far].max()) if bool(far.any()) else 0.0
                out[what] = dict(raw_steps=int(steps.max()), far=int(far.sum()), far_max_abs_gap=gap)
                log(f"train-bf16: {what}: raw largest gap {int(steps.max())} bf16 steps; {int(far.sum())} elements "
                    f"more than {TOL_BF16_STEPS} step apart, largest |gap| among them {gap:.3g} [{card}]")
    return out


def bf16_kernel_rows(torch, calls, bn_calls, timer, card: str, batch: int):
    """The bf16 arms at the train path's shapes: each recorded call of a
    tgs_salt_bf16 train step (depthwise forward, dx, dw) and eval forward
    (BN + act) held against its plain version (within one bf16 step; BN bit
    for bit for its piecewise-linear activations), then timed beside the
    plain version, its bound (bytes over 3.35 TB/s or float32 operations
    over 67 TFLOP/s, the larger) and the library call (bf16
    ``F.conv2d(groups=C)`` and ``aten.convolution_backward``; BN has no
    single call, so its eager bf16 ``x*m + b`` then the activation is
    logged beside it as ``eager_ms``), summed per train step or per
    bucket-64 forward."""
    import torch.nn.functional as F

    from tensorflowdistributedlearning_tpu_torch.ops import kernels

    aten = torch.ops.aten
    rows = {name: dict(max_abs_err=0.0, ms=0.0, plain_ms=0.0, library_ms=0.0, nbytes=0.0, flops=0.0)
            for name in BF16_ROWS}
    rows["fused_bn_act_bf16_act"]["library_ms"] = None
    rows["fused_bn_act_bf16_act"]["eager_ms"] = 0.0
    on_card = timer is not None
    with torch.no_grad():
        for (x, w, rate), out, _ in calls["depthwise_conv2d_forward"]:
            what = f"train-bf16 forward {tuple(x.shape)} rate {rate}"
            r = rows["depthwise_conv2d_bf16"]
            r["max_abs_err"] = max(r["max_abs_err"], hold_bf16(torch, out, kernels.depthwise_conv2d_plain(x, w, rate),
                                                               what))
            kh, kw, ch = w.shape
            b, h, wd, _ = x.shape
            r["nbytes"] += 2 * (2 * x.numel() + w.numel())
            r["flops"] += 2 * b * ch * depthwise_valid_taps(h, wd, kh, rate)
            if on_card:
                wt = w.permute(2, 0, 1).unsqueeze(1).contiguous()
                pad = (rate * (kh - 1) // 2, rate * (kw - 1) // 2)
                xv = x.permute(0, 3, 1, 2)
                r["ms"] += timer.ms(lambda: kernels.depthwise_conv2d_forward(x, w, rate))
                r["plain_ms"] += timer.ms(lambda: kernels.depthwise_conv2d_plain(x, w, rate))
                r["library_ms"] += timer.ms(lambda: F.conv2d(xv, wt, padding=pad, dilation=rate, groups=ch))
        fwd_x = {c[0][2]: c[0][0] for c in calls["depthwise_conv2d_forward"]}
        for (g, w, rate), out, _ in calls["depthwise_conv2d_dx"]:
            what = f"train-bf16 dx {tuple(g.shape)} rate {rate}"
            r = rows["depthwise_conv2d_dx_bf16"]
            r["max_abs_err"] = max(r["max_abs_err"], hold_bf16(torch, out, kernels._dx_plain(g, w, rate), what))
            kh, kw, ch = w.shape
            b, h, wd, _ = g.shape
            r["nbytes"] += 2 * (2 * g.numel() + w.numel())
            r["flops"] += 2 * b * ch * depthwise_valid_taps(h, wd, kh, rate)
            if on_card:
                x = fwd_x[rate]
                gv, xv = g.permute(0, 3, 1, 2), x.permute(0, 3, 1, 2)
                wt = w.permute(2, 0, 1).unsqueeze(1).contiguous()
                pad = [rate * (kh - 1) // 2, rate * (kw - 1) // 2]
                r["ms"] += timer.ms(lambda: kernels.depthwise_conv2d_dx(g, w, rate))
                r["plain_ms"] += timer.ms(lambda: kernels._dx_plain(g, w, rate))
                r["library_ms"] += timer.ms(lambda: aten.convolution_backward(
                    gv, xv, wt, None, [1, 1], pad, [rate, rate], False, [0, 0], ch, [True, False, False]))
        for (x, g, ks, rate), out, plan in calls["depthwise_conv2d_dw"]:
            kh, kw = ks
            what = f"train-bf16 dw {tuple(x.shape)} rate {rate}"
            if on_card:
                check(plan is not None, f"{what}: the bf16 call missed the band kernel")
            r = rows["depthwise_conv2d_dw_bf16"]
            want = kernels._dw_plain(x, g, kh, kw, rate).to(torch.bfloat16)
            r["max_abs_err"] = max(r["max_abs_err"], hold_bf16(torch, out, want, what))
            if on_card:
                check(torch.equal(out, kernels.depthwise_conv2d_dw(x, g, ks, rate)), f"{what}: not bitwise repeatable")
            ch = x.shape[-1]
            b, h, wd, _ = x.shape
            r["nbytes"] += 2 * (x.numel() + g.numel() + kh * kw * ch)
            r["flops"] += 2 * b * ch * depthwise_valid_taps(h, wd, kh, rate)
            if on_card:
                gv, xv = g.permute(0, 3, 1, 2), x.permute(0, 3, 1, 2)
                wt = torch.zeros(ch, 1, kh, kw, dtype=torch.bfloat16, device=x.device)
                pad = [rate * (kh - 1) // 2, rate * (kw - 1) // 2]
                r["ms"] += timer.ms(lambda: kernels.depthwise_conv2d_dw(x, g, ks, rate))
                r["plain_ms"] += timer.ms(lambda: kernels._dw_plain(x, g, kh, kw, rate))
                r["library_ms"] += timer.ms(lambda: aten.convolution_backward(
                    gv, xv, wt, None, [1, 1], pad, [rate, rate], False, [0, 0], ch, [False, True, False]))
        r = rows["fused_bn_act_bf16_act"]
        for (x, m, b, act, res), out, _ in bn_calls:
            want = kernels.bn_act_folded_plain(x, m, b, act, res)
            what = f"train-bf16 BN {tuple(x.shape)} {act}"
            steps = 0 if act in ("none", "relu", "relu6") else TOL_BF16_STEPS
            r["max_abs_err"] = max(r["max_abs_err"], hold_bf16(torch, out, want, what, steps))
            r["nbytes"] += 2 * (2 * x.numel() + (res.numel() if res is not None else 0)) + 8 * m.numel()
            r["flops"] += (3 if res is not None else 2) * x.numel()
            if on_card:
                r["ms"] += timer.ms(lambda: kernels.bn_act_folded(x, m, b, act, res))
                r["plain_ms"] += timer.ms(lambda: kernels.bn_act_folded_plain(x, m, b, act, res))
                mb, bb = m.to(torch.bfloat16), b.to(torch.bfloat16)
                r["eager_ms"] += timer.ms(lambda: kernels.activate(x * mb + bb, act))
    for name, r in rows.items():
        nbytes, flops = r.pop("nbytes"), r.pop("flops")
        r.update(bound_ms=bound_ms(nbytes, flops), bound_by=bound_by(nbytes, flops))
        if on_card:
            per = "per bucket-64 forward" if name == "fused_bn_act_bf16_act" else f"per train step at batch {batch}"
            lib = (f"eager bf16 x*m+b then act {r['eager_ms']:.4f} ms (no single library call)"
                   if r["library_ms"] is None else f"library {r['library_ms']:.4f} ms")
            log(f"{name}: {r['ms']:.4f} ms {per} (plain {r['plain_ms']:.4f} ms, {lib}, bound {r['bound_ms']:.4f} ms "
                f"by {r['bound_by']}, {nbytes / 1e6:.1f} MB), max|err| {r['max_abs_err']:.3g} [{card}]")
    return rows


def train_bf16_phase(torch, card: str, timer, device: str = "cuda", model_kwargs=None, n_images: int = TRAIN_IMAGES,
                     size: int = 101, batch: int = TRAIN_BATCH, steps: int = BF16_TRAIN_STEPS,
                     n_test: int = PREDICT_IMAGES):
    """tgs_salt_bf16 (the main path's segmenter in bf16 compute, full width
    and depth; ``use_pallas_depthwise`` on, as the train phase runs) through
    Trainer.train (2 folds x ``steps`` steps at ``batch``), the step on a
    resident batch (ms, images/s, profile), every bf16 kernel call of a step
    and an eval forward held against its plain version and timed, then
    Trainer.predict and a bucket-64 engine forward of fold 0's export.
    ``model_kwargs`` and ``device="cpu"`` rehearse it small on the CPU."""
    import dataclasses

    from tensorflowdistributedlearning_tpu_torch.config import ModelConfig, TrainConfig
    from tensorflowdistributedlearning_tpu_torch.configs import get_preset
    from tensorflowdistributedlearning_tpu_torch.data import augment as augment_lib
    from tensorflowdistributedlearning_tpu_torch.data import pipeline as pipeline_lib
    from tensorflowdistributedlearning_tpu_torch.ops import kernels
    from tensorflowdistributedlearning_tpu_torch.serve import InferenceEngine
    from tensorflowdistributedlearning_tpu_torch.train import step as step_lib
    from tensorflowdistributedlearning_tpu_torch.train.state import create_train_state
    from tensorflowdistributedlearning_tpu_torch.train.trainer import Trainer

    on_card = device == "cuda"
    preset = dataclasses.replace(get_preset(BF16_PRESET).model, use_pallas_depthwise=True)
    model_kwargs = dict(model_kwargs or {}, use_pallas_depthwise=True, dtype="bfloat16")
    cfg = ModelConfig(input_shape=(size, size), **model_kwargs)
    if on_card:
        check(cfg == preset, f"train-bf16: {cfg} is not the {BF16_PRESET} preset")
    per_step = PER_BF16_TRAIN_STEP if on_card else {k: 0 for k in PER_BF16_TRAIN_STEP}
    per_eval = PER_BF16_EVAL_FORWARD if on_card else {k: 0 for k in PER_BF16_EVAL_FORWARD}
    tcfg = TrainConfig(n_folds=TRAIN_FOLDS, seed=SEED % 1000 + 1, checkpoint_every_steps=steps, eval_every_steps=steps,
                       save_best=1)
    out = {}
    with tempfile.TemporaryDirectory(prefix="chip-smoke-train-bf16-") as root:
        data, model_dir = os.path.join(root, "data"), os.path.join(root, "model")
        ids = write_salt_dataset(data, n_images, size, SEED + 31)
        ledger = LaunchLedger(kernels, step_lib)
        trainer = Trainer(model_dir, data, train_config=tcfg, device=device, input_shape=(size, size), **model_kwargs)
        # the main path: counts from 0 just before, read just after
        with ledger.patch():
            kernels.reset_launch_counts()
            t0 = time.perf_counter()
            folds = trainer.train(ids, batch_size=batch, steps=steps)
            if on_card:
                torch.cuda.synchronize()
            train_s = time.perf_counter() - t0
            counts = kernels.launch_counts()
        check(len(folds) == TRAIN_FOLDS and all(np.isfinite(v) for f in folds for v in f.values()),
              f"train-bf16: fold metrics {folds}")
        check(len(ledger.train) == TRAIN_FOLDS * steps, f"train-bf16: {len(ledger.train)} train steps recorded")
        for i, delta in enumerate(ledger.train):
            check(delta == per_step, f"train-bf16 step {i}: launches {delta}, expected {per_step}")
        for i, delta in enumerate(ledger.eval):
            check(delta == per_eval, f"train-bf16 eval forward {i}: launches {delta}, expected {per_eval}")
        out["launches"] = counts
        log(f"train-bf16: Trainer.train of {BF16_PRESET} ({trainer.params} parameters, bf16 compute, depthwise "
            f"kernels on), {TRAIN_FOLDS} folds x {steps} steps at batch {batch} on {len(ids)} images: {train_s:.3f} s "
            f"(data, augmentation, eval, checkpoints included); folds {json.dumps(folds)} [{card}]")
        log(f"train-bf16: {len(ledger.train)} train steps launched {per_step['depthwise_conv2d_bf16']}/"
            f"{per_step['depthwise_conv2d_dx_bf16']}/{per_step['depthwise_conv2d_dw_bf16']} bf16 depthwise fwd/dx/dw "
            f"each; {len(ledger.eval)} eval forwards {per_eval['fused_bn_act_bf16_act']} bf16 BN + act each")

        # the step on a resident batch
        dataset = pipeline_lib.InMemoryDataset.from_directory(data, ids=ids[:batch])
        placed = pipeline_lib.to_device({"images": dataset.images, "masks": dataset.masks}, torch.device(device))
        fixed = augment_lib.prepare_eval_batch(placed["images"], placed["masks"])
        state = create_train_state(cfg, tcfg, device, generator=torch.Generator().manual_seed(SEED + 32))
        train_step = step_lib.make_train_step(step_lib.SegmentationTask())
        losses, times = [], []
        for _ in range(RESIDENT_STEPS):
            t0 = time.perf_counter()
            state, metrics = train_step(state, fixed)
            losses.append(step_lib.compute_metrics(metrics)["loss"])
            times.append(time.perf_counter() - t0)
        check(all(np.isfinite(losses)), f"train-bf16: non-finite losses {losses}")
        ms = statistics.median(times[2:]) * 1e3
        out.update(step_ms=ms, images_per_s=batch / ms * 1e3, train_s=train_s)
        log(f"train-bf16: {ms:.3f} ms per step (median of steps 3-{RESIDENT_STEPS}), {batch / ms * 1e3:.3f} images/s at batch "
            f"{batch}; losses {[round(v, 5) for v in losses]} [{card}]")
        if on_card:
            lines, stats = profile_steps(torch, train_step, state, fixed)
            for line in lines:
                log(f"profile train-bf16: {line} [{card}]")
            if stats is not None:
                stats["idle_unprofiled"] = max(0.0, 1 - stats["device_ms"] / ms)
                log(f"train-bf16: device kernels {stats['device_ms']:.3f} ms of the unprofiled {ms:.3f} ms step: "
                    f"device idle {stats['idle_unprofiled']:.3f} [{card}]")
            out["profile"] = stats

        # every bf16 kernel call of one step and one eval forward, held and timed
        limits = {"depthwise_conv2d_forward": 3, "depthwise_conv2d_dx": 3, "depthwise_conv2d_dw": 3}
        with record_kernel_calls(torch, limits) as calls:
            step_lib.forward_backward(state, step_lib.SegmentationTask(), fixed)
        state.zero_grad()
        from tensorflowdistributedlearning_tpu_torch.models.layers import BatchNorm

        n_bn = sum(isinstance(m, BatchNorm) for m in state.model.modules())
        check(n_bn == PER_EVAL_FORWARD["fused_bn_act"] or not on_card, f"train-bf16: {n_bn} BatchNorms")
        with record_kernel_calls(torch, {"bn_act_folded": n_bn}) as bn:
            with torch.no_grad():
                state.model.eval()(fixed["images"])
        state.model.train()
        n_calls = {k: len(v) for k, v in {**calls, **bn}.items()}
        check(n_calls == dict(limits, bn_act_folded=n_bn), f"train-bf16: recorded calls {n_calls}")
        check(all(a[0].dtype == torch.bfloat16 for v in calls.values() for a, _, _ in v)
              and all(a[0].dtype == torch.bfloat16 for a, _, _ in bn["bn_act_folded"]),
              "train-bf16: a path call was not bf16")
        del state
        out["rows"] = bf16_kernel_rows(torch, calls, bn["bn_act_folded"], timer if on_card else None, card, batch)
        if on_card:
            out["smooth_act_sweep"] = smooth_act_sweep(torch, card)
        del calls, bn
        log(f"train-bf16: every bf16 kernel call of a step (3 forward, 3 dx, 3 dw) and of an eval forward ({n_bn} BN) held "
            f"against its plain version: max|err| "
            f"{json.dumps({k: round(r['max_abs_err'], 6) for k, r in out['rows'].items()})}")

        # predict, then fold 0's export through the engine at bucket 64
        test_dir = os.path.join(root, "test")
        write_salt_dataset(test_dir, n_test, size, SEED + 33)
        shutil.rmtree(os.path.join(test_dir, "masks"))
        with ledger.patch():
            kernels.reset_launch_counts()
            t0 = time.perf_counter()
            pred = trainer.predict(test_dir, batch_size=batch)
            if on_card:
                torch.cuda.synchronize()
            predict_s = time.perf_counter() - t0
            out["predict_launches"] = kernels.launch_counts()
        check(pred["probabilities"].shape == (n_test, size, size, 1) and np.isfinite(pred["probabilities"]).all(),
              f"train-bf16 predict: {pred['probabilities'].shape}")
        for i, delta in enumerate(ledger.predict):
            check(delta == per_eval, f"train-bf16 predict forward {i}: launches {delta}, expected {per_eval}")
        out.update(predict_s=predict_s, predict_forwards=len(ledger.predict))
        log(f"train-bf16: Trainer.predict, {TRAIN_FOLDS} folds x 4 transforms over {n_test} images at batch {batch}: "
            f"{predict_s:.3f} s wall, {n_test / predict_s:.3f} images/s, {len(ledger.predict)} forwards [{card}]")
        manifest = trainer.export_serving(0)
        engine = InferenceEngine.from_artifact(os.path.dirname(manifest), device=device, buckets=(batch,))
        x = make_instances(torch, batch, SEED + 34) if size == 101 else np.random.default_rng(SEED + 34).normal(
            size=(batch, size, size, 2)).astype(np.float32)
        engine.warmup()
        kernels.reset_launch_counts()
        t0 = time.perf_counter()
        served = engine.infer(x)
        engine_ms = (time.perf_counter() - t0) * 1e3
        out["engine_launches"] = kernels.launch_counts()
        want = dict(per_eval, fused_sigmoid_mask=1 if on_card else 0)
        check(out["engine_launches"] == want, f"train-bf16 engine: launches {out['engine_launches']}, expected {want}")
        best = trainer.restore_fold(0).model.eval()
        with torch.no_grad():
            direct = torch.sigmoid(best(torch.from_numpy(x).to(device))).cpu().numpy()
        d = float(np.abs(served["probabilities"] - direct).max())
        check(d <= 1e-6, f"train-bf16 engine: probabilities {d} from the restored model's forward")
        out["engine_ms"] = engine_ms
        log(f"train-bf16: fold 0's export through the engine at bucket {batch}: {engine_ms:.3f} ms (pad, H2D, forward, "
            f"D2H), max|dprobs| {d:.3g} from the restored model, launches {per_eval['depthwise_conv2d_bf16']} bf16 "
            f"depthwise + {per_eval['fused_bn_act_bf16_act']} bf16 BN + 1 sigmoid-mask [{card}]")
        del engine, best
        # fold 0's best as int8-compute
        art8 = os.path.dirname(trainer.export_serving(0, serving_dtype="int8-compute"))
        art16 = os.path.dirname(trainer.export_serving(0, serving_dtype="bfloat16"))
        out["int8"] = int8_arm(torch, BF16_PRESET, art8, card, device,
                               expect=INT8_LAYERS[BF16_PRESET] if cfg == preset else None, bf16_art=art16)
    return out


def logit_gap(p: np.ndarray, q: np.ndarray) -> float:
    """Two softmaxes compared as their logits: ``log p - log q`` centred per
    row (a softmax forgets its row's shift), its largest magnitude over the
    std of ``log q``."""
    logq = np.log(q.astype(np.float64))
    d = np.log(p.astype(np.float64)) - logq
    d -= d.mean(axis=-1, keepdims=True)
    return float(np.abs(d).max() / logq.std())


def estimate_bn_statistics(torch, model, batches) -> None:
    """Set every BatchNorm's running statistics to the mean of its batch
    statistics over ``batches`` (no-grad training-mode forwards, a
    classifier's dropout keyed by the seed), its decay as it was
    afterwards; leaves the model in eval mode."""
    from tensorflowdistributedlearning_tpu_torch.models.layers import BatchNorm, dropout_key

    bns = [m for m in model.modules() if isinstance(m, BatchNorm)]
    saved = [bn.decay for bn in bns]
    model.train()
    try:
        with torch.no_grad(), dropout_key(SEED):
            for i, x in enumerate(batches):
                for bn in bns:
                    bn.decay = i / (i + 1)
                model(x)
    finally:
        for bn, decay in zip(bns, saved):
            bn.decay = decay
        model.eval()


def hold_bn_calls(torch, calls, what: str) -> float:
    """Recorded ``bn_act_folded`` calls on bf16 activations held against
    the plain version on the same inputs: bit for bit for the
    piecewise-linear activations, within TOL_BF16_STEPS otherwise; returns
    the largest max|err|."""
    from tensorflowdistributedlearning_tpu_torch.ops import kernels

    worst = 0.0
    with torch.no_grad():
        for (x, m, b, act, res), out, _ in calls:
            steps = 0 if act in ("none", "relu", "relu6") else TOL_BF16_STEPS
            want = kernels.bn_act_folded_plain(x, m, b, act, res)
            worst = max(worst, hold_bf16(torch, out, want, f"{what} BN {tuple(x.shape)} {act}", steps))
    return worst


def r50_instances(n: int, seed: int, shape) -> np.ndarray:
    return np.random.default_rng(seed).normal(size=(n, *shape)).astype(np.float32)


def fit_resnet50_phase(torch, card: str, device: str = "cuda", cfg=None, batch: int = R50_BATCH,
                       steps: int = R50_FIT_STEPS, buckets=(1, 16, 32, 64), http_sizes=(1, 4)):
    """resnet50_classic_imagenet (ResNet-50, classic widths, space-to-depth
    stem, bf16 compute; full width and depth) through ``fit_preset`` on
    synthetic ImageNet-shaped data: ``steps`` steps at ``batch`` under the
    preset's SGD recipe, one eval at the end, the float32-spec export, a
    restore of the best state; then the export through the engine (buckets
    ``buckets``) and HTTP (``http_sizes`` instances) with its drift
    baseline stamped and scored by the server's drift monitor, the bfloat16 spec
    through the engine, and the step on a resident batch (ms, images/s,
    profile). ``cfg`` and ``device="cpu"`` rehearse it small."""
    import dataclasses

    from tensorflowdistributedlearning_tpu_torch import configs
    from tensorflowdistributedlearning_tpu_torch.data.synthetic import synthetic_classification_batch
    from tensorflowdistributedlearning_tpu_torch.data import pipeline as pipeline_lib
    from tensorflowdistributedlearning_tpu_torch.models.layers import BatchNorm
    from tensorflowdistributedlearning_tpu_torch.ops import kernels
    from tensorflowdistributedlearning_tpu_torch.serve import (
        InferenceEngine, MicroBatcher, ServingServer, bind_ephemeral,
    )
    from tensorflowdistributedlearning_tpu_torch.obs import health
    from tensorflowdistributedlearning_tpu_torch.serve.quant_check import pinned_eval_batch, stamp_drift_baseline
    from tensorflowdistributedlearning_tpu_torch.train import serving
    from tensorflowdistributedlearning_tpu_torch.train import step as step_lib
    from tensorflowdistributedlearning_tpu_torch.train.fit import EVAL_SYNTHETIC_BATCHES, ClassifierTrainer, fit_preset
    from tensorflowdistributedlearning_tpu_torch.train.state import create_train_state

    on_card = device == "cuda"
    preset = configs.get_preset(R50_PRESET)
    cfg = cfg or preset.model
    per_step = PER_R50_TRAIN_STEP if on_card else {k: 0 for k in PER_R50_TRAIN_STEP}
    per_fwd = PER_R50_FORWARD if on_card else {k: 0 for k in PER_R50_FORWARD}
    shape = (*cfg.input_shape, cfg.input_channels)
    out = {}
    with tempfile.TemporaryDirectory(prefix="chip-smoke-fit-r50-") as root, \
            mock.patch.dict(configs.PRESETS, {R50_PRESET: dataclasses.replace(preset, model=cfg)}):
        model_dir = os.path.join(root, "model")
        ledger = LaunchLedger(kernels, step_lib)
        with ledger.patch():
            kernels.reset_launch_counts()
            t0 = time.perf_counter()
            result = fit_preset(R50_PRESET, model_dir, steps=steps, batch_size=batch, eval_every_steps=steps,
                                export_serving="float32", device=device, train_log_every_steps=steps)
            if on_card:
                torch.cuda.synchronize()
            fit_s = time.perf_counter() - t0
            counts = kernels.launch_counts()
        check(result.steps == steps and sorted(result.final_metrics) == ["loss", "metrics/top1", "metrics/top5"]
              and all(np.isfinite(v) for v in result.final_metrics.values()), f"fit-resnet50: {result}")
        check(len(ledger.train) == steps and len(ledger.eval) == EVAL_SYNTHETIC_BATCHES,
              f"fit-resnet50: {len(ledger.train)} train steps, {len(ledger.eval)} eval forwards")
        for i, delta in enumerate(ledger.train):
            check(delta == per_step, f"fit-resnet50 step {i}: launches {delta}, expected {per_step}")
        for i, delta in enumerate(ledger.eval):
            check(delta == per_fwd, f"fit-resnet50 eval forward {i}: launches {delta}, expected {per_fwd}")
        out.update(launches=counts, fit_s=fit_s, n_params=result.n_params, final_metrics=result.final_metrics)
        check_run_ledger(model_dir, steps, 1, "fit-resnet50")
        keep_ledgers(model_dir, "fit-resnet50")
        log(f"fit-resnet50: fit_preset {R50_PRESET} ({result.n_params} parameters), {steps} steps at batch {batch} "
            f"on synthetic data ({preset.train.optimizer}, lr {preset.train.lr}, {preset.train.lr_schedule} with "
            f"{preset.train.lr_warmup_steps} warmup steps), one eval, the float32 export: {fit_s:.3f} s wall; final "
            f"{json.dumps(result.final_metrics)}; {len(ledger.eval)} eval forwards launched "
            f"{per_fwd['fused_bn_act_bf16_act']} bf16 BN + act each [{card}]")
        trainer = ClassifierTrainer(model_dir, None, cfg, preset.train, device=device)
        t0 = time.perf_counter()
        best = trainer._restore_best_host()
        if on_card:
            torch.cuda.synchronize()
        out["restore_s"] = time.perf_counter() - t0
        log(f"fit-resnet50: restore of the best state (step {best.step}, no init draw) {out['restore_s']:.3f} s [{card}]")
        x = r50_instances(batch, SEED + 41, shape)
        xt = torch.from_numpy(x).to(device)
        task = step_lib.ClassificationTask()

        # fit_preset's own export through the engine: the restored state's forward
        engine = InferenceEngine.from_artifact(result.serving_artifact, device=device, buckets=(batch,))
        with best.eval_params() as model, torch.inference_mode():
            direct = task.predictions(model.eval()(xt))["probabilities"].float().cpu().numpy()
        got = engine.infer(x)
        d = float(np.abs(got["probabilities"] - direct).max())
        check(d <= TOL_VIT_F32, f"fit-resnet50 export: probabilities {d} from the restored model's forward")
        check_classes(got["probabilities"], got["class"], "fit-resnet50 export")
        log(f"fit-resnet50: fit_preset's float32 export through the engine at bucket {batch}: max|dprobs| {d:.3g} from "
            f"the restored model's forward")
        del engine

        # the served state: 10 steps at decay 0.99 leave the running statistics
        # 90% at their init, so the eval-mode logits are huge and every softmax
        # saturates; the running statistics are re-estimated from training-mode
        # forwards and the logits scaled to std 3, so probabilities and
        # classes can show a serving fault
        with best.eval_params() as model:
            calib = [r50_instances(batch, SEED + 45 + i, shape) for i in range(R50_CALIBRATION_BATCHES)]
            estimate_bn_statistics(torch, model, [torch.from_numpy(c).to(device) for c in calib])
            calibrate_logits(torch, model.eval(), xt)
            n_bn = sum(isinstance(m, BatchNorm) for m in model.modules())
            check(n_bn == per_fwd["fused_bn_act"] or not on_card, f"fit-resnet50: {n_bn} BatchNorms")
            with record_kernel_calls(torch, {"bn_act_folded": n_bn}) as bn, torch.inference_mode():
                logits = model(xt)
            direct = task.predictions(logits)["probabilities"].float().cpu().numpy()
            out["logit_std"] = float(logits.float().std())
            art = os.path.join(root, "served")
            art16 = os.path.join(root, "served-bfloat16")
            art8 = os.path.join(root, "served-int8-compute")
            for directory, spec in ((art, "float32"), (art16, "bfloat16"), (art8, "int8-compute")):
                serving.export_serving_artifact(model, cfg, directory, metadata={"step": best.step}, serving_dtype=spec)
        del best
        out["bn_held_err"] = hold_bn_calls(torch, bn["bn_act_folded"], "fit-resnet50 eval forward")
        check(len(bn["bn_act_folded"]) == n_bn and all(a[0].dtype == torch.bfloat16 for a, _, _ in bn["bn_act_folded"]),
              "fit-resnet50: recorded BN calls")
        log(f"fit-resnet50: running statistics re-estimated from {R50_CALIBRATION_BATCHES} training-mode forwards of "
            f"{batch}, logits std {out['logit_std']:.3f}; the {len(bn['bn_act_folded'])} BN calls of one eval forward "
            f"at batch {batch} held against the plain version: max|err| {out['bn_held_err']:.3g}")

        # the export's drift baseline, stamped on the card, read by the drift
        # monitor of the server that serves it
        baseline = stamp_drift_baseline(art, device=device)
        check(serving.read_manifest(art).get("drift_baseline") == baseline, "fit-resnet50: no drift baseline stamped")
        drift = health.DriftMonitor(baseline, threshold=0.35, min_requests=1, sustain_windows=1)
        # the export through the engine and HTTP: the main serving path
        engine = InferenceEngine.from_artifact(art, device=device, buckets=buckets)
        warm = engine.warmup()
        batcher = MicroBatcher(engine, max_wait_ms=5.0, max_queue=64)
        server = ServingServer(engine, batcher, sock=bind_ephemeral("127.0.0.1", 0), window_secs=0,
                               drift_monitor=drift).start()
        lat_engine, lat_http = {}, {}
        try:
            kernels.reset_launch_counts()
            for n in http_sizes:
                xs = r50_instances(n, SEED + 42 + n, shape)
                status, body = post(server.url + "/v1/predict", {"instances": xs.tolist()})
                t0 = time.perf_counter()
                status, body = post(server.url + "/v1/predict", {"instances": xs.tolist()})
                lat_http[n] = (time.perf_counter() - t0) * 1e3
                check(status == 200 and body["n"] == n, f"fit-resnet50 HTTP {n}: {status}")
                p = np.asarray(body["predictions"]["probabilities"], np.float32)
                check_classes(p, np.asarray(body["predictions"]["class"], np.int32), f"fit-resnet50 HTTP {n}")
            for b in buckets:
                lat = []
                for _ in range(3):
                    t0 = time.perf_counter()
                    got = engine.infer(x[:b])
                    lat.append(time.perf_counter() - t0)
                lat_engine[b] = statistics.median(lat) * 1e3
                check_classes(got["probabilities"], got["class"], f"fit-resnet50 engine bucket {b}")
            served = kernels.launch_counts()
            forwards = sum(engine.bucket_hits.values())
            scored = server.emit_window()["drift"]
            # the stamp's own inputs served in one bucket of the stamp's
            # batch: their classes are the stamp's
            pinned = pinned_eval_batch(serving.read_manifest(art), baseline["batch"], baseline["seed"])
            for i in range(0, len(pinned), engine.max_batch_size):
                chunk = pinned[i:i + engine.max_batch_size]
                status, body = post(server.url + "/v1/predict", {"instances": chunk.tolist()})
                check(status == 200 and body["n"] == len(chunk), f"fit-resnet50 pinned batch: HTTP {status}")
            own = server.emit_window()["drift"]
        finally:
            server.shutdown()
        check(scored["output"] == "class" and 0.0 <= scored["score"] <= 1.0, f"fit-resnet50 drift: {scored}")
        check(own["healthy"] and own["score"] <= DRIFT_OWN_INPUTS_MAX,
              f"fit-resnet50 drift on the baseline's own inputs: {own}, wanted a score <= {DRIFT_OWN_INPUTS_MAX}")
        out["drift"], out["drift_own_inputs"] = scored, own
        log(f"fit-resnet50: drift monitor on the stamped baseline (the export's {baseline['batch']}-image pinned "
            f"batch): total-variation score {scored['score']} of the served classes (healthy {scored['healthy']}), "
            f"{own['score']} of the pinned batch itself served (healthy {own['healthy']}), threshold 0.35")
        d = float(np.abs(got["probabilities"] - direct).max())
        check(d <= TOL_VIT_F32, f"fit-resnet50 engine: probabilities {d} from the served model's forward")
        want = {k: v * forwards for k, v in per_fwd.items()}
        check({k: served[k] for k in want} == want, f"fit-resnet50 serve: launches {served}, expected {want}")
        out.update(serve_launches=served, serve_forwards=forwards, engine_ms=lat_engine, http_ms=lat_http)
        log(f"fit-resnet50: warmup s per bucket {json.dumps({str(b): round(s, 4) for b, s in warm.items()})}; "
            f"{forwards} served forwards launched {per_fwd['fused_bn_act_bf16_act']} bf16 BN + act each; max|dprobs| "
            f"{d:.3g} from the served model's forward, top probability {float(got['probabilities'].max(-1).mean()):.3f} "
            f"on average")
        for b, ms in lat_engine.items():
            log(f"fit-resnet50: engine bucket {b} p50 forward {ms:.3f} ms (pad, H2D, forward, D2H), "
                f"{b / ms * 1e3:.1f} images/s [{card}]")
        for n, ms in lat_http.items():
            log(f"fit-resnet50: {n} instances request latency {ms:.3f} ms over HTTP [{card}]")

        # the bfloat16 spec: bf16 BN parameters, the unfolded arm; held against
        # its own forward through the plain versions, and against the float32
        # spec within TOL_R50_BF16_SPEC with equal classes where the top two are apart
        engine16 = InferenceEngine.from_artifact(art16, device=device, buckets=(batch,))
        kernels.reset_launch_counts()
        got16 = engine16.infer(x)
        c16 = kernels.launch_counts()
        want16 = PER_R50_BF16_SPEC_FORWARD if on_card else {k: 0 for k in PER_R50_BF16_SPEC_FORWARD}
        check({k: c16[k] for k in want16} == want16, f"fit-resnet50 bfloat16 spec: launches {c16}")
        plain16 = serving.load_serving_artifact(art16, device)
        with mock.patch.multiple(kernels, bn_act_unfolded=kernels.bn_act_unfolded_plain,
                                 bn_act_folded=kernels.bn_act_folded_plain):
            kernels.reset_launch_counts()
            want16p = plain16(x)["probabilities"].float().cpu().numpy()
            check(sum(kernels.launch_counts().values()) == 0, "fit-resnet50: the plain bfloat16 forward launched")
        d16 = float(np.abs(got16["probabilities"] - want16p).max())
        check(d16 <= TOL_VIT_F32, f"fit-resnet50 bfloat16 spec: probabilities {d16} from its plain forward")
        check_classes(got16["probabilities"], got16["class"], "fit-resnet50 bfloat16 spec")
        d32 = float(np.abs(got16["probabilities"] - direct).max())
        gap = logit_gap(got16["probabilities"], direct)
        check(gap <= TOL_R50_BF16_SPEC, f"fit-resnet50 bfloat16 spec: logits {gap} of their std from the float32 spec's")
        out.update(bf16_spec_dprobs=d16, bf16_spec_vs_f32_dprobs=d32, bf16_spec_vs_f32_logit_gap=gap)
        log(f"fit-resnet50: bfloat16 spec through the engine at bucket {batch}: max|dprobs| {d16:.3g} from its plain "
            f"forward; from the float32 spec logits {gap:.4g} of their std apart (bound {TOL_R50_BF16_SPEC}), "
            f"max|dprobs| {d32:.3g}; {want16['fused_bn_act_bf16']} BN launches with bf16 parameters")
        del engine, engine16, plain16
        # the same served state as int8-compute
        out["int8"] = int8_arm(torch, R50_PRESET, art8, card, device,
                               expect=INT8_LAYERS[R50_PRESET] if cfg is preset.model else None, bf16_art=art16)

    # the step on a resident batch
    state = create_train_state(cfg, preset.train, device, generator=torch.Generator().manual_seed(SEED + 43))
    raw = synthetic_classification_batch(np.random.default_rng(SEED + 44), batch, cfg.input_shape,
                                         cfg.input_channels, cfg.num_classes)
    fixed = pipeline_lib.to_device(raw, torch.device(device))
    train_step = step_lib.make_train_step(step_lib.ClassificationTask(label_smoothing=preset.train.label_smoothing),
                                          weight_decay=cfg.weight_decay)
    times, losses = [], []
    for _ in range(RESIDENT_STEPS):
        t0 = time.perf_counter()
        state, metrics = train_step(state, fixed)
        losses.append(step_lib.compute_metrics(metrics)["loss"])
        times.append(time.perf_counter() - t0)
    check(all(np.isfinite(losses)), f"fit-resnet50: non-finite losses {losses}")
    ms = statistics.median(times[2:]) * 1e3
    out.update(step_ms=ms, images_per_s=batch / ms * 1e3)
    log(f"fit-resnet50: train step on a resident batch of {batch}: {ms:.3f} ms (median of steps 3-{RESIDENT_STEPS}), "
        f"{batch / ms * 1e3:.3f} images/s [{card}]")
    if on_card:
        lines, stats = profile_steps(torch, train_step, state, fixed)
        for line in lines:
            log(f"profile fit-resnet50: {line} [{card}]")
        if stats is not None:
            stats["idle_unprofiled"] = max(0.0, 1 - stats["device_ms"] / ms)
            log(f"fit-resnet50: device kernels {stats['device_ms']:.3f} ms of the unprofiled {ms:.3f} ms step: device "
                f"idle {stats['idle_unprofiled']:.3f} [{card}]")
        out["profile"] = stats
    return out


def class_images(n: int, shape, num_classes: int, seed: int):
    """``n`` class-conditional uint8 images (pixels ~ N((k + 0.5) / K · 255,
    40), the synthetic ImageFolder writer's recipe) and their labels."""
    rng = np.random.default_rng(seed)
    labels = rng.integers(0, num_classes, n)
    images = [np.clip(rng.standard_normal(shape, dtype=np.float32) * np.float32(40.0)
                      + np.float32((k + 0.5) / num_classes * 255.0), 0, 255).astype(np.uint8) for k in labels]
    return images, [int(k) for k in labels]


def fit_records_phase(torch, card: str, device: str = "cuda", cfg=None, batch: int = R50_BATCH,
                      steps: int = R50_FIT_STEPS, n_images: int = FR_IMAGES, shards: int = FR_SHARDS,
                      folder_per_class: int = 16, stop: int = FR_STOP):
    """resnet50_classic_imagenet through ``fit_preset`` on record shards
    (the main path of ``fit`` with data: the data service's default 2
    workers), a stop at step ``stop`` and a resume, the service alone, then an
    ImageFolder split. ``cfg`` and ``device="cpu"`` rehearse it small."""
    import dataclasses

    from tensorflowdistributedlearning_tpu_torch import configs
    from tensorflowdistributedlearning_tpu_torch.data import imagefolder, records
    from tensorflowdistributedlearning_tpu_torch.data import pipeline as pipeline_lib
    from tensorflowdistributedlearning_tpu_torch.data import service as service_lib
    from tensorflowdistributedlearning_tpu_torch.native import loader
    from tensorflowdistributedlearning_tpu_torch.ops import kernels
    from tensorflowdistributedlearning_tpu_torch.train import step as step_lib
    from tensorflowdistributedlearning_tpu_torch.train.fit import ClassifierTrainer, fit_preset

    on_card = device == "cuda"
    preset = configs.get_preset(R50_PRESET)
    cfg = cfg or preset.model
    tcfg = preset.train
    per_step = PER_R50_TRAIN_STEP if on_card else {k: 0 for k in PER_R50_TRAIN_STEP}
    per_fwd = PER_R50_FORWARD if on_card else {k: 0 for k in PER_R50_FORWARD}
    shape = (*cfg.input_shape, cfg.input_channels)
    out = {"decoder": loader.decoder()}
    if out["decoder"] == "native":
        log(f"fit-records: image decoder native (native/io.cc, {'PNG + JPEG' if loader.jpeg_available() else 'PNG'})")
    else:
        log("fit-records: image decoder png.py — native/io.cc did not build here (png.h / jpeglib.h missing), so "
            "PNGs at the target size decode through data/png.py and a JPEG or a resize would raise")
    check(tcfg.data_service_workers == 2, f"{R50_PRESET}: data_service_workers {tcfg.data_service_workers}")
    with tempfile.TemporaryDirectory(prefix="chip-smoke-fit-records-") as root, \
            mock.patch.dict(configs.PRESETS, {R50_PRESET: dataclasses.replace(preset, model=cfg)}):
        data = os.path.join(root, "records")
        t0 = time.perf_counter()
        images, labels = class_images(n_images, shape, cfg.num_classes, SEED + 51)
        paths = records.write_classification_shards(data, images, labels, shards=shards)
        write_s = time.perf_counter() - t0
        check(all(os.path.exists(records.shard_index_path(p)) for p in paths), "a shard without its .idx sidecar")
        check(records.count_records(paths) == n_images, "record count")
        # shard 0 read back through the native reader decodes to the pixels written
        blobs, rows = [], list(range(0, n_images, shards))
        for i, payload in zip(rows, records.RecordStream(paths[:1])):
            label, blob = records.decode_classification_record(payload)
            check(label == labels[i], f"record {i}: label {label} != {labels[i]}")
            blobs.append(blob)
        decoded = loader.decode_image_blobs(blobs, cfg.input_shape, cfg.input_channels)
        want = np.stack([images[i] for i in rows]).astype(np.float32) / np.float32(255.0)
        check(np.array_equal(decoded, want), "records read back decode to other pixels than were written")
        log(f"fit-records: wrote {n_images} class-conditional {shape[0]}x{shape[1]}x{shape[2]} images into {shards} "
            f"record shards with .idx sidecars in {write_s:.3f} s ({sum(os.path.getsize(p) for p in paths) / 2**20:.1f} "
            f"MiB); shard 0's {len(rows)} records decode ({out['decoder']}) to the pixels written")

        overrides = dict(eval_holdout_fraction=FR_HOLDOUT, train_log_every_steps=steps)
        trainer = ClassifierTrainer(os.path.join(root, "probe"), data, cfg, dataclasses.replace(tcfg, **overrides),
                                    device=device)
        train_paths = trainer._open_records("train", host_shard=False).paths
        eval_paths = trainer._open_records("val").paths
        n_eval = records.count_records(eval_paths)
        check(len(eval_paths) == int(np.ceil(FR_HOLDOUT * shards)) and eval_paths == paths[-len(eval_paths):],
              f"held-out shards {eval_paths}")
        del trainer

        # the main path: counts from 0 just before, read just after
        ledger = LaunchLedger(kernels, step_lib)
        valid_rows = []

        def counting_eval():
            """Wrap the eval step builder in place now to sum each batch's valid rows."""
            current = step_lib.make_eval_step

            def make(*args, **kwargs):
                inner = current(*args, **kwargs)

                def step(model, b):
                    valid_rows.append(float(b["valid"].sum()))
                    return inner(model, b)

                return step

            return mock.patch.object(step_lib, "make_eval_step", make)

        fed, waits = [], []
        with ledger.patch(), counting_eval(), observe_prefetch(pipeline_lib, fed, waits):
            kernels.reset_launch_counts()
            t0 = time.perf_counter()
            result = fit_preset(R50_PRESET, os.path.join(root, "model"), data_dir=data, steps=steps,
                                batch_size=batch, eval_every_steps=steps, device=device, **overrides)
            if on_card:
                torch.cuda.synchronize()
            fit_s = time.perf_counter() - t0
            counts = kernels.launch_counts()
        check(result.steps == steps and all(np.isfinite(v) for v in result.final_metrics.values()),
              f"fit-records: {result}")
        check(len(ledger.train) == steps and len(fed) == steps, f"fit-records: {len(ledger.train)} steps")
        n_eval_batches = -(-n_eval // batch)
        check(len(ledger.eval) == n_eval_batches and sum(valid_rows) == n_eval,
              f"fit-records: {len(ledger.eval)} eval forwards over {sum(valid_rows)} valid rows, expected "
              f"{n_eval_batches} over {n_eval}")
        for i, delta in enumerate(ledger.train):
            check(delta == per_step, f"fit-records step {i}: launches {delta}, expected {per_step}")
        for i, delta in enumerate(ledger.eval):
            check(delta == per_fwd, f"fit-records eval forward {i}: launches {delta}, expected {per_fwd}")
        events = check_run_ledger(os.path.join(root, "model"), steps, 1, "fit-records", data_service=True)
        svc = [w["data_service"] for w in events if w["event"] == "step_window"]
        log(f"fit-records: the windows' data_service blocks {json.dumps(svc)}")
        blocked = sum(b - a for a, b in waits)
        loop_ips = (len(waits) - 2) * batch / (waits[-1][0] - waits[1][0]) if len(waits) > 2 else float("nan")
        out.update(launches=counts, fit_s=fit_s, final_metrics=result.final_metrics, eval_valid_rows=sum(valid_rows),
                   blocked_s=blocked, blocked_share=blocked / fit_s, loop_images_per_s=loop_ips)
        log(f"fit-records: fit_preset {R50_PRESET} on {len(train_paths)} train shards ({n_images - n_eval} records), "
            f"eval_holdout_fraction {FR_HOLDOUT} ({len(eval_paths)} shards, {n_eval} records), {steps} steps at batch "
            f"{batch} through the data service's {tcfg.data_service_workers} workers, one eval, the best export: "
            f"{fit_s:.3f} s wall; final {json.dumps(result.final_metrics)} [{card}]")
        log(f"fit-records: {len(ledger.eval)} eval forwards over {sum(valid_rows):.0f} valid rows of "
            f"{len(ledger.eval) * batch}, each launching {per_fwd['fused_bn_act_bf16_act']} bf16 BN + act; "
            f"{len(ledger.train)} train steps launched none")
        log(f"fit-records: train loop {loop_ips:.1f} images/s (host clock, batches 2-{len(waits) - 1}); the host "
            f"waited {blocked:.3f} s on the next batch, {blocked / fit_s:.4f} of fit's wall time [{card}]")

        # a run stopped at step ``stop`` writes its sidecar; resumed, it draws the
        # uninterrupted stream's batches 10-19
        resumed_dir = os.path.join(root, "model-resumed")
        parts = []
        for until in (stop, steps):
            parts.append([])
            with observe_prefetch(pipeline_lib, parts[-1]):
                fit_preset(R50_PRESET, resumed_dir, data_dir=data, steps=until, batch_size=batch,
                           eval_every_steps=steps, device=device, **overrides)
            if until == stop:
                sidecar = os.path.join(resumed_dir, "checkpoints", f"data_state-{stop}.json")
                check(os.path.exists(sidecar), f"no {sidecar} after a run stopped at step {stop}")
                state = json.load(open(sidecar))
                check(state["batch_index"] == stop and state["batch_size"] == batch, f"sidecar {state}")
        check(parts[0] == fed[:stop] and parts[1] == fed[stop:],
              f"the resumed run drew other batches than the uninterrupted stream's {stop}-{steps - 1}")
        log(f"fit-records: stopped at step {stop} (data_state-{stop}.json: {json.dumps(state)}), resumed to "
            f"{steps}: batches {stop}-{steps - 1} equal the uninterrupted stream's (sha256 of images, labels, valid)")

        # the service alone: batches 0-3 do not depend on the worker count;
        # the data path's rate with 1/2/4 workers, no model
        out["service_images_per_s"] = {}
        for workers in FR_WORKERS:
            source = service_lib.ClassificationRecordSource(
                train_paths, image_shape=cfg.input_shape, channels=cfg.input_channels, num_classes=cfg.num_classes)
            service = service_lib.StreamingDataService(source, batch_size=batch, seed=tcfg.seed, workers=workers)
            t0 = time.perf_counter()
            got = [batch_digest(b) for b in service.batches(steps=FR_SERVICE_BATCHES)]
            dt = time.perf_counter() - t0
            check(got[:4] == fed[:4], f"service batches 0-3 with {workers} workers differ from fit's")
            out["service_images_per_s"][workers] = FR_SERVICE_BATCHES * batch / dt
            log(f"fit-records: data service alone, {workers} worker(s), {FR_SERVICE_BATCHES} batches of {batch} "
                f"(read, {out['decoder']} decode, normalise): {FR_SERVICE_BATCHES * batch / dt:.1f} images/s; "
                f"batches 0-3 equal fit's [{card}]")

        # an ImageFolder split: 5 steps, one eval over val/
        folder = os.path.join(root, "folder")
        imagefolder.write_synthetic_imagefolder(os.path.join(folder, "train"), FR_FOLDER_CLASSES, folder_per_class * 3 // 4,
                                                cfg.input_shape, cfg.input_channels, seed=SEED + 52)
        imagefolder.write_synthetic_imagefolder(os.path.join(folder, "val"), FR_FOLDER_CLASSES, folder_per_class // 4,
                                                cfg.input_shape, cfg.input_channels, seed=SEED + 53)
        n_val = FR_FOLDER_CLASSES * (folder_per_class // 4)
        folder_ledger = LaunchLedger(kernels, step_lib)
        valid_rows.clear()
        with folder_ledger.patch(), counting_eval():
            kernels.reset_launch_counts()
            t0 = time.perf_counter()
            res = fit_preset(R50_PRESET, os.path.join(root, "model-folder"), data_dir=folder, steps=FR_FOLDER_STEPS,
                             batch_size=batch, eval_every_steps=FR_FOLDER_STEPS, device=device)
            if on_card:
                torch.cuda.synchronize()
            folder_s = time.perf_counter() - t0
            out["folder_launches"] = kernels.launch_counts()
        check(res.steps == FR_FOLDER_STEPS and all(np.isfinite(v) for v in res.final_metrics.values()),
              f"fit-records ImageFolder: {res}")
        check(len(folder_ledger.train) == FR_FOLDER_STEPS and sum(valid_rows) == n_val,
              f"ImageFolder: {len(folder_ledger.train)} steps, {sum(valid_rows)} valid eval rows")
        for delta in folder_ledger.eval:
            check(delta == per_fwd, f"ImageFolder eval forward: launches {delta}, expected {per_fwd}")
        out["folder_s"] = folder_s
        log(f"fit-records: ImageFolder train/ ({FR_FOLDER_CLASSES * (folder_per_class * 3 // 4)} images) and val/ "
            f"({n_val}): {FR_FOLDER_STEPS} steps at batch {batch}, one eval over {sum(valid_rows):.0f} valid rows, "
            f"{folder_s:.3f} s wall; final {json.dumps(res.final_metrics)} [{card}]")
    return out


@contextlib.contextmanager
def cublas_deterministic():
    """cuBLAS's deterministic workspace for the duration (PyTorch's
    deterministic mode refuses a matmul without it)."""
    saved = os.environ.get("CUBLAS_WORKSPACE_CONFIG")
    os.environ["CUBLAS_WORKSPACE_CONFIG"] = ":4096:8"
    try:
        yield
    finally:
        if saved is None:
            os.environ.pop("CUBLAS_WORKSPACE_CONFIG")
        else:
            os.environ["CUBLAS_WORKSPACE_CONFIG"] = saved


def train_lars_phase(torch, card: str, device: str = "cuda", cfg=None, batch: int = R50_BATCH,
                     steps: int = LARS_STEPS):
    """The resnet50_imagenet model with ``remat`` (resnet50_bf16_8k's
    model) under resnet50_bf16_8k's LARS recipe without ZeRO-1, with
    ``grad_accum_steps`` = 2, on a resident synthetic batch: ``steps`` steps
    with and without ``remat`` (ms per step, peak device memory), then one
    remat step held bit for bit against one plain step under deterministic
    algorithms. ``cfg`` and ``device="cpu"`` rehearse it small."""
    import dataclasses

    from tensorflowdistributedlearning_tpu_torch.configs import get_preset
    from tensorflowdistributedlearning_tpu_torch.data.synthetic import synthetic_classification_batch
    from tensorflowdistributedlearning_tpu_torch.data import pipeline as pipeline_lib
    from tensorflowdistributedlearning_tpu_torch.models import build_model
    from tensorflowdistributedlearning_tpu_torch.ops import kernels
    from tensorflowdistributedlearning_tpu_torch.train import step as step_lib
    from tensorflowdistributedlearning_tpu_torch.train.state import create_train_state

    on_card = device == "cuda"
    preset = get_preset(LARS_PRESET)
    cfg = cfg or preset.model
    check(cfg.remat, "train-lars: the model must have remat on")
    tcfg = dataclasses.replace(preset.train, weight_update_sharding=False, grad_accum_steps=2)
    task = step_lib.ClassificationTask(label_smoothing=tcfg.label_smoothing)
    raw = synthetic_classification_batch(np.random.default_rng(SEED + 51), batch, cfg.input_shape,
                                         cfg.input_channels, cfg.num_classes)
    fixed = pipeline_lib.to_device(raw, torch.device(device))
    init = {k: v.cpu() for k, v in build_model(cfg, device, generator=torch.Generator().manual_seed(SEED + 52))
            .state_dict().items()}
    out = {}
    kernels.reset_launch_counts()
    for remat in (True, False):
        c = dataclasses.replace(cfg, remat=remat)
        state = create_train_state(c, tcfg, device, state_dict=init)
        train_step = step_lib.make_train_step(task, weight_decay=c.weight_decay, accum=tcfg.grad_accum_steps)
        if on_card:
            torch.cuda.synchronize()
            torch.cuda.empty_cache()
            torch.cuda.reset_peak_memory_stats()
        times, losses = [], []
        for _ in range(steps):
            t0 = time.perf_counter()
            state, metrics = train_step(state, fixed)
            losses.append(step_lib.compute_metrics(metrics)["loss"])
            times.append(time.perf_counter() - t0)
        check(all(np.isfinite(losses)), f"train-lars remat={remat}: non-finite losses {losses}")
        ms = statistics.median(times[1:]) * 1e3
        peak = torch.cuda.max_memory_allocated() if on_card else 0
        key = "remat" if remat else "plain"
        out[key] = dict(step_ms=ms, images_per_s=batch / ms * 1e3, peak_bytes=peak, losses=losses)
        log(f"train-lars: {LARS_PRESET}'s model (remat {remat}), lars lr {tcfg.lr} with {tcfg.lr_warmup_steps} warmup "
            f"steps, grad_accum_steps 2, batch {batch}: {ms:.3f} ms per step (median of steps 2-{steps}), "
            f"{batch / ms * 1e3:.3f} images/s, peak device memory {peak / 2 ** 30:.3f} GiB "
            f"(torch.cuda.max_memory_allocated); losses {[round(v, 5) for v in losses]} [{card}]")
        del state, train_step
        if on_card:
            torch.cuda.empty_cache()
    out["launches"] = kernels.launch_counts()
    want = PER_R50_TRAIN_STEP if on_card else {k: 0 for k in PER_R50_TRAIN_STEP}
    check(out["launches"] == want, f"train-lars: launches {out['launches']}")
    if on_card:
        out["peak_ratio"] = out["remat"]["peak_bytes"] / out["plain"]["peak_bytes"]
        out["time_ratio"] = out["remat"]["step_ms"] / out["plain"]["step_ms"]
        log(f"train-lars: remat peak memory {out['peak_ratio']:.3f} of the plain step's, step time "
            f"{out['time_ratio']:.3f} of it [{card}]")

    # one remat step against one plain step, bit for bit
    results = []
    with deterministic_algorithms(torch), cublas_deterministic():
        for remat in (True, False):
            c = dataclasses.replace(cfg, remat=remat)
            state = create_train_state(c, tcfg, device, state_dict=init)
            state, metrics = step_lib.make_train_step(task, weight_decay=c.weight_decay,
                                                      accum=tcfg.grad_accum_steps)(state, fixed)
            results.append((step_lib.compute_metrics(metrics), {k: v.detach().clone() for k, v in
                                                                 state.model.state_dict().items()},
                            [state.optimizer.state[p]["trace"].clone() for p in state.model.parameters()]))
            del state
    (m_r, s_r, t_r), (m_p, s_p, t_p) = results
    differ = [k for k in s_r if not torch.equal(s_r[k], s_p[k])]
    check(m_r == m_p and not differ and all(torch.equal(a, b) for a, b in zip(t_r, t_p)),
          f"train-lars: the remat step is not bit for bit the plain one ({len(differ)} tensors differ, e.g. "
          f"{differ[:3]}; metrics {m_r} vs {m_p})")
    out["bitwise"] = True
    log(f"train-lars: one remat step bit for bit one plain step under deterministic algorithms (parameters, BN "
        f"running statistics moved once, LARS traces, metrics {json.dumps(m_r)})")
    return out


# ZeRO-1 (parallel/zero.py): resnet50_bf16_8k's model and LARS recipe on two
# gloo ranks that share the card, replicated and sharded, then its preset
# through fit_preset with a resume
ZERO_RANKS = 2
ZERO_STEPS = 2  # timed steps per mode at global batch 64
ZERO_HELD_STEPS = 3  # lockstep steps under deterministic algorithms
ZERO_FIT_STOP = 2
ZERO_FIT_STEPS = 4
ZERO_TIMEOUT_S = 420
# LARS under ZeRO-1 against the replicated LARS step from the same state:
# the slices' squared sums reach the trust ratio's norms in another order,
# which moves an update (at most lr·0.001·|p| per leaf) by a few float32
# roundings, and p + update rounds to a neighbouring float; so per element
# |dp| <= ZERO_LARS_ULPS spacings of p plus TOL_ZERO_LARS·lr
TOL_ZERO_LARS = 1e-6
ZERO_LARS_ULPS = 2


def zero_rank(torch, rank: int, world: int, store: str, root: str, device: str, cfg_kwargs, batch: int,
              steps: int):
    """One of the ranks of ``train-zero1``: each mode alone (``steps`` steps
    on a resident batch: ms per step, peak memory, the memory event's
    bytes; the ZeRO mode's parameter all-gather timed), the ZeRO step held
    step by step against the replicated one from the same state, then
    fit_preset of resnet50_bf16_8k to ZERO_FIT_STOP and resumed to
    ZERO_FIT_STEPS with its launches counted, and its last checkpoint
    restored into a ZeRO-1 template."""
    import dataclasses

    from tensorflowdistributedlearning_tpu_torch import configs
    from tensorflowdistributedlearning_tpu_torch.config import ModelConfig
    from tensorflowdistributedlearning_tpu_torch.data import pipeline as pipeline_lib
    from tensorflowdistributedlearning_tpu_torch.data.synthetic import synthetic_classification_batch
    from tensorflowdistributedlearning_tpu_torch.models import build_model
    from tensorflowdistributedlearning_tpu_torch.obs.ledger import read_ledger_with_errors
    from tensorflowdistributedlearning_tpu_torch.ops import kernels
    from tensorflowdistributedlearning_tpu_torch.parallel import mesh, multihost, zero
    from tensorflowdistributedlearning_tpu_torch.train import step as step_lib
    from tensorflowdistributedlearning_tpu_torch.train.checkpoint import CheckpointManager
    from tensorflowdistributedlearning_tpu_torch.train.fit import EVAL_SYNTHETIC_BATCHES, fit_preset
    from tensorflowdistributedlearning_tpu_torch.train.state import create_train_state, replicate, template_train_state
    from tensorflowdistributedlearning_tpu_torch.train.trainer import state_bytes

    on_card = device == "cuda"
    dev = torch.device("cuda:0" if on_card else "cpu")
    multihost.initialize(store, world, rank, backend="gloo", timeout=300)
    out = {"rank": rank}
    try:
        if on_card:
            torch.cuda.set_device(0)
            torch.backends.cudnn.allow_tf32 = False
            torch.backends.cuda.matmul.allow_tf32 = False
        preset = configs.get_preset(LARS_PRESET)
        cfg = ModelConfig(**cfg_kwargs) if cfg_kwargs else preset.model
        tcfg = {mode: dataclasses.replace(preset.train, weight_update_sharding=mode == "zero")
                for mode in ("replicated", "zero")}
        task = step_lib.ClassificationTask(label_smoothing=preset.train.label_smoothing)
        raw = synthetic_classification_batch(np.random.default_rng(SEED + 61), batch, cfg.input_shape,
                                             cfg.input_channels, cfg.num_classes)
        rows = mesh.shard_rows(batch, rank, world)
        local = pipeline_lib.to_device({k: v[rows] for k, v in raw.items()}, dev)
        init = {k: v.cpu() for k, v in build_model(cfg, dev, generator=torch.Generator().manual_seed(SEED + 62))
                .state_dict().items()}
        train_step = step_lib.make_train_step(task, data_parallel=True, weight_decay=cfg.weight_decay,
                                              seed=preset.train.seed)

        def fresh(mode):
            return replicate(create_train_state(cfg, tcfg[mode], dev, state_dict=init))

        for mode in ("replicated", "zero"):
            state = fresh(mode)
            if on_card:
                torch.cuda.synchronize()
                torch.cuda.empty_cache()
                torch.cuda.reset_peak_memory_stats()
            times, losses = [], []
            for _ in range(steps):
                t0 = time.perf_counter()
                state, metrics = train_step(state, local)
                losses.append(step_lib.compute_metrics(metrics)["loss"])  # waits for the card
                times.append(time.perf_counter() - t0)
            rec = dict(step_ms=statistics.median(times[1:]) * 1e3, losses=losses,
                       peak_bytes=torch.cuda.max_memory_allocated() if on_card else 0,
                       **state_bytes(state, mode == "zero"))
            if mode == "zero":
                layout = state.zero
                rec["all_gather_ms"] = host_ms(torch, layout.gather_params, reps=3)
                rec["all_gather_mb"] = zero.all_gather_bytes(layout) / 1e6
                rec["sharded"], rec["whole"] = len(layout.sharded), len(layout.dims) - len(layout.sharded)
                # the slots of the leaves every rank keeps whole (LARS: a trace each)
                rec["tail_bytes"] = sum(layout.params[n].numel() * layout.params[n].element_size()
                                        for n, d in layout.dims.items() if d is None)
            out[mode] = rec
            del state
            if on_card:
                torch.cuda.empty_cache()

        # the ZeRO step against the replicated step from the same state
        with deterministic_algorithms(torch), cublas_deterministic():
            rep, sharded = fresh("replicated"), fresh("zero")
            held = []
            for k in range(ZERO_HELD_STEPS):
                if k:
                    sharded.load_state_dict(rep.state_dict())
                lr = rep.schedule(rep.step)
                _, m_rep = train_step(rep, local)
                _, m_zero = train_step(sharded, local)
                pairs = list(zip(rep.model.parameters(), sharded.model.parameters()))
                gap = max(float((a - b).abs().max()) for a, b in pairs)
                # the distance in units of the parameter's float32 spacing
                ulps = max(float(((a - b).abs() / (torch.nextafter(a.abs(), torch.full_like(a, float("inf")))
                                                    - a.abs())).max()) for a, b in pairs)
                excess = max(float(((a - b).abs() - ZERO_LARS_ULPS * (torch.nextafter(
                    a.abs(), torch.full_like(a, float("inf"))) - a.abs())).max()) for a, b in pairs)
                stats = all(torch.equal(a, b) for a, b in zip(rep.model.buffers(), sharded.model.buffers()))
                held.append(dict(lr=lr, gap=gap, ulps=ulps, excess=excess, stats_equal=stats,
                                 loss_equal=step_lib.compute_metrics(m_rep) == step_lib.compute_metrics(m_zero)))
            out["held"] = held
            out["held_digest"] = state_digest(sharded.model)
            del rep, sharded
        if on_card:
            torch.cuda.empty_cache()

        # the main path: fit_preset with ZeRO-1, stopped and resumed; counts from 0 just before
        model_dir = os.path.join(root, "fit-zero1")
        ledger = LaunchLedger(kernels, step_lib)
        with mock.patch.dict(configs.PRESETS, {LARS_PRESET: dataclasses.replace(preset, model=cfg)}), ledger.patch():
            kernels.reset_launch_counts()
            t0 = time.perf_counter()
            results = [fit_preset(LARS_PRESET, model_dir, steps=stop, batch_size=batch, device=dev,
                                  checkpoint_every_steps=ZERO_FIT_STOP).final_metrics
                       for stop in (ZERO_FIT_STOP, ZERO_FIT_STEPS)]
            if on_card:
                torch.cuda.synchronize()
            out["fit_s"] = time.perf_counter() - t0
            out["launches"] = kernels.launch_counts()
        out["fit_metrics"] = results
        out["ledger_train"], out["ledger_eval"] = ledger.train, ledger.eval
        out["eval_forwards"] = 2 * EVAL_SYNTHETIC_BATCHES
        events, errors = read_ledger_with_errors(
            os.path.join(model_dir, "telemetry.jsonl" if rank == 0 else f"telemetry-{rank}.jsonl"))
        out["memory_events"] = [{k: e.get(k) for k in ("opt_state_bytes_per_device", "params_bytes_per_device",
                                                        "weight_update_sharding")}
                                for e in events if e["event"] == "memory" and "opt_state_bytes_per_device" in e]
        out["ledger_errors"] = errors
        # the last checkpoint into a ZeRO-1 template on every rank: the whole
        # state it gathers back is the file's
        restored = CheckpointManager(model_dir).restore_latest(template_train_state(cfg, tcfg["zero"], dev))
        check(restored.zero is not None and restored.step == ZERO_FIT_STEPS,
              f"train-zero1 rank {rank}: restored a {'ZeRO-1' if restored.zero else 'replicated'} state at step "
              f"{restored.step}")
        whole = restored.state_dict()
        out["restored_digest"] = optimizer_digest(whole["optimizer"])
        out["restored_model"] = state_digest(restored.model)
        del restored, whole
        multihost.barrier()
    finally:
        multihost.shutdown()
    return out


def optimizer_digest(opt_state) -> str:
    """sha256 of an optimizer state dict's tensors, by index and slot."""
    h = hashlib.sha256()
    for i in sorted(opt_state["state"], key=int):
        for key, v in sorted(opt_state["state"][i].items()):
            h.update(f"{i}/{key}".encode())
            h.update(v.detach().cpu().contiguous().numpy().tobytes() if hasattr(v, "numpy") else repr(v).encode())
    return h.hexdigest()[:16]


def train_zero1_phase(torch, card: str, device: str = "cuda", cfg=None, batch: int = R50_BATCH,
                      steps: int = ZERO_STEPS):
    """ZeRO-1 on two gloo ranks sharing the card (each ``chip_smoke.py
    zero-rank ...``, with the kernels' warm build directory), then this
    process restores their checkpoint into one replicated state. ``cfg``
    and ``device="cpu"`` rehearse it small."""
    import dataclasses

    from tensorflowdistributedlearning_tpu_torch import configs
    from tensorflowdistributedlearning_tpu_torch.data import pipeline as pipeline_lib
    from tensorflowdistributedlearning_tpu_torch.data.synthetic import synthetic_classification_batch
    from tensorflowdistributedlearning_tpu_torch.train.checkpoint import CheckpointManager
    from tensorflowdistributedlearning_tpu_torch.train.state import template_train_state

    on_card = device == "cuda"
    preset = configs.get_preset(LARS_PRESET)
    cfg_kwargs = dataclasses.asdict(cfg) if cfg is not None else {}
    cfg = cfg or preset.model
    with tempfile.TemporaryDirectory(prefix="chip-smoke-zero1-") as root:
        store = f"file://{os.path.join(root, 'store')}"
        procs, logs = [], []
        t0 = time.perf_counter()
        try:
            for rank in range(ZERO_RANKS):
                logs.append(open(os.path.join(root, f"rank{rank}.log"), "w"))
                procs.append(subprocess.Popen(
                    [sys.executable, os.path.abspath(__file__), "zero-rank", str(rank), str(ZERO_RANKS), store, root,
                     device, json.dumps(cfg_kwargs), str(batch), str(steps)],
                    stdout=logs[-1], stderr=subprocess.STDOUT,
                ))
            deadline = time.perf_counter() + ZERO_TIMEOUT_S
            for p in procs:
                try:
                    p.wait(timeout=max(1.0, deadline - time.perf_counter()))
                except subprocess.TimeoutExpired:
                    pass
        finally:
            for p in procs:
                if p.poll() is None:
                    p.kill()
                    p.wait()
            for f in logs:
                f.close()
        wall = time.perf_counter() - t0
        outs = []
        for rank, p in enumerate(procs):
            with open(os.path.join(root, f"rank{rank}.log")) as f:
                text = f.read()
            check(p.returncode == 0, f"zero rank {rank} exited {p.returncode}:\n{text[-3000:]}")
            with open(os.path.join(root, f"rank{rank}.json")) as f:
                outs.append(json.load(f))
        r0 = outs[0]
        for o in outs[1:]:
            for key in ("held_digest", "fit_metrics", "restored_digest", "restored_model"):
                check(o[key] == r0[key], f"train-zero1: ranks differ in {key}: {[x[key] for x in outs]}")
            for mode in ("replicated", "zero"):
                check(o[mode]["losses"] == r0[mode]["losses"], f"train-zero1 {mode}: ranks' losses differ")
        for o in outs:
            what = f"train-zero1 rank {o['rank']}"
            for k, h in enumerate(o["held"]):
                check(h["excess"] <= TOL_ZERO_LARS * h["lr"] and h["stats_equal"] and h["loss_equal"],
                      f"{what}: held step {k}: max|dp| {h['gap']:.3g} ({h['ulps']:.3g} spacings of p), beyond "
                      f"{ZERO_LARS_ULPS} spacings {h['excess']:.3g} against {TOL_ZERO_LARS:g}·lr {h['lr']:.3g} (BN "
                      f"statistics equal {h['stats_equal']}, metrics equal {h['loss_equal']})")
            rep, z = o["replicated"], o["zero"]
            for mode in ("replicated", "zero"):
                check(all(np.isfinite(o[mode]["losses"])), f"{what} {mode}: losses {o[mode]['losses']}")
            check(not rep["weight_update_sharding"] and z["weight_update_sharding"]
                  and rep["params_bytes_per_device"] == z["params_bytes_per_device"],
                  f"{what}: memory event fields {rep} / {z}")
            # the sharded slots halve; the whole leaves' slots stay on each rank
            want = (rep["opt_state_bytes_per_device"] - z["tail_bytes"]) // ZERO_RANKS + z["tail_bytes"]
            check(z["opt_state_bytes_per_device"] == want,
                  f"{what}: ZeRO opt bytes {z['opt_state_bytes_per_device']}, expected {want} (replicated "
                  f"{rep['opt_state_bytes_per_device']}, whole tail {z['tail_bytes']})")
            check(o["ledger_errors"] == 0 and len(o["memory_events"]) == 2 and all(
                e == {"opt_state_bytes_per_device": z["opt_state_bytes_per_device"],
                      "params_bytes_per_device": z["params_bytes_per_device"], "weight_update_sharding": True}
                for e in o["memory_events"]), f"{what}: fit's memory events {o['memory_events']}")
            per_step = PER_R50_TRAIN_STEP if on_card else {k: 0 for k in PER_R50_TRAIN_STEP}
            per_fwd = PER_R50_FORWARD if on_card else {k: 0 for k in PER_R50_FORWARD}
            check(len(o["ledger_train"]) == ZERO_FIT_STEPS and len(o["ledger_eval"]) == o["eval_forwards"],
                  f"{what}: fit ran {len(o['ledger_train'])} train steps, {len(o['ledger_eval'])} eval forwards")
            for delta in o["ledger_train"]:
                check(delta == per_step, f"{what}: fit step launches {delta}, expected {per_step}")
            for delta in o["ledger_eval"]:
                check(delta == per_fwd, f"{what}: fit eval forward launches {delta}, expected {per_fwd}")
            check(all(np.isfinite(v) for m in o["fit_metrics"] for v in m.values()), f"{what}: {o['fit_metrics']}")

        # rank 0's checkpoint into one process: the whole state the ranks gathered
        model_dir = os.path.join(root, "fit-zero1")
        t1 = time.perf_counter()
        tcfg = dataclasses.replace(preset.train, weight_update_sharding=True)
        state = CheckpointManager(model_dir).restore_latest(template_train_state(cfg, tcfg, device))
        check(state.zero is None and state.step == ZERO_FIT_STEPS, f"train-zero1: one-process restore at step "
              f"{state.step}, layout {state.zero}")
        got = optimizer_digest(state.optimizer.state_dict())
        check(got == r0["restored_digest"] and state_digest(state.model) == r0["restored_model"],
              f"train-zero1: the one-process restore's optimizer state {got} / model {state_digest(state.model)} "
              f"against the ranks' {r0['restored_digest']} / {r0['restored_model']}")
        raw = synthetic_classification_batch(np.random.default_rng(SEED + 63), 8, cfg.input_shape, cfg.input_channels,
                                             cfg.num_classes)
        with torch.no_grad():
            logits = state.model.eval()(pipeline_lib.to_device(raw, torch.device(device))["images"])
        check(tuple(logits.shape) == (8, cfg.num_classes) and bool(torch.isfinite(logits).all()),
              f"train-zero1: restored forward {tuple(logits.shape)}")
        restore_s = time.perf_counter() - t1
        del state, logits
        if on_card:
            torch.cuda.empty_cache()
    rep, z = r0["replicated"], r0["zero"]
    gaps = [f"{h['gap']:.3g} ({h['ulps']:.3g} spacings of p) at lr {h['lr']:.3g}" for h in r0["held"]]
    log(f"train-zero1: {LARS_PRESET}'s model and LARS recipe on {ZERO_RANKS} gloo ranks sharing {device}, global batch "
        f"{batch} ({batch // ZERO_RANKS} a rank), median of steps 2-{steps}: replicated {rep['step_ms']:.3f} ms per "
        f"step, ZeRO-1 {z['step_ms']:.3f} ms; peak device memory (rank 0, torch.cuda.max_memory_allocated) "
        f"{rep['peak_bytes'] / 2 ** 30:.3f} / {z['peak_bytes'] / 2 ** 30:.3f} GiB [{card}]")
    log(f"train-zero1: opt_state_bytes_per_device {rep['opt_state_bytes_per_device']} replicated, "
        f"{', '.join(str(o['zero']['opt_state_bytes_per_device']) for o in outs)} by rank under ZeRO-1 "
        f"({z['sharded']} leaves sharded, {z['whole']} whole: {z['tail_bytes']} bytes of trace on every rank); the "
        f"parameter all-gather (host-staged over gloo) {z['all_gather_mb']:.1f} MB in {z['all_gather_ms']:.3f} ms "
        f"[{card}]")
    log(f"train-zero1: the ZeRO step against the replicated step from the same state (deterministic algorithms): "
        f"max|dp| {', '.join(gaps)}; BN statistics and metrics equal; ranks' digests equal")
    log(f"train-zero1: fit_preset {LARS_PRESET} with ZeRO-1 to step {ZERO_FIT_STOP}, resumed to {ZERO_FIT_STEPS}: "
        f"{r0['fit_s']:.3f} s, metrics {json.dumps(r0['fit_metrics'])}; eval forwards launched "
        f"{PER_R50_FORWARD['fused_bn_act_bf16_act']} bf16 BN + act each; its checkpoint restored on both ranks into "
        f"ZeRO-1 shards and in this process into one replicated state ({restore_s:.3f} s), the same whole state; "
        f"{wall:.3f} s for the ranks [{card}]")
    return {"launches": r0["launches"], "replicated_step_ms": rep["step_ms"], "zero_step_ms": z["step_ms"],
            "replicated_peak_bytes": rep["peak_bytes"], "zero_peak_bytes": z["peak_bytes"],
            "replicated_opt_bytes": rep["opt_state_bytes_per_device"],
            "zero_opt_bytes": [o["zero"]["opt_state_bytes_per_device"] for o in outs],
            "all_gather_ms": z["all_gather_ms"], "all_gather_mb": z["all_gather_mb"],
            "held_gaps": [h["gap"] for h in r0["held"]], "held_ulps": [h["ulps"] for h in r0["held"]],
            "fit_s": r0["fit_s"], "ranks_s": wall}


def zero_rank_main(argv) -> int:
    """``chip_smoke.py zero-rank RANK WORLD STORE ROOT DEVICE CFG BATCH
    STEPS``: one rank of ``train-zero1``; writes ``ROOT/rank{RANK}.json``."""
    import torch

    rank, world, store, root, device = int(argv[0]), int(argv[1]), argv[2], argv[3], argv[4]
    cfg_kwargs, batch, steps = json.loads(argv[5]), int(argv[6]), int(argv[7])
    if cfg_kwargs:
        for key in ("input_shape", "n_blocks"):
            cfg_kwargs[key] = tuple(cfg_kwargs[key])
    try:
        out = zero_rank(torch, rank, world, store, root, device, cfg_kwargs, batch, steps)
    except SmokeFailure as e:
        print(f"FAIL: {e}", file=sys.stderr)
        return 1
    with open(os.path.join(root, f"rank{rank}.json"), "w") as f:
        json.dump(out, f)
    return 0


# tensor parallelism: the segmenter through Trainer.train on ranks that
# share the card (gloo), and its composition with ZeRO-1
TP_DEGREE = 2
TP_ZERO_RANKS = 4  # a (2, 2) grid
TP_BATCH = 8  # global; cut from 64 by the host-staged gathers (PERF.md §4)
TP_IMAGES = 32
TP_FOLDS = 2
TP_TRAIN_STEPS = 2  # per fold
TP_HELD_STEPS = 2  # cut from 3 to pay for train-sp
TP_TIMED_STEPS = 1
TP_ZERO_STEPS = 2
TP_TIMEOUT_S = 300
# the ViT arm: vit_s16_imagenet at full width and depth on the same two ranks
TP_VIT_BATCH = 16  # global; cut from 64 by the host-staged gathers (PERF.md §4)
TP_VIT_TIMED_STEPS = 2  # the first with its collectives timed, the second alone
TP_VIT_FIT_STEPS = 2
TP_VIT_HELD_CALLS = 4  # attention calls of each rank's fit held against plain


@contextlib.contextmanager
def timed_collectives(torch, collectives):
    """For the duration, every all-gather (the channel gathers, forward and
    backward) and every sum over a group that is not the default one (the
    replicated inputs' backward, over the model group; the metric sums over
    every rank are left out) of ``parallel/collectives.py`` is timed with
    the card synchronized around it; yields ``{kind: [calls, seconds,
    bytes landed or reduced]}``."""
    rec = {"gather": [0, 0.0, 0], "allreduce": [0, 0.0, 0]}
    real_gather, real_psum = collectives.all_gather, collectives.psum_

    def timed(kind, fn, nbytes):
        if torch.cuda.is_available():
            torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = fn()
        if torch.cuda.is_available():
            torch.cuda.synchronize()
        r = rec[kind]
        r[0], r[1], r[2] = r[0] + 1, r[1] + time.perf_counter() - t0, r[2] + nbytes(out)
        return out

    def gather(flat, group=None):
        return timed("gather", lambda: real_gather(flat, group), lambda out: out.numel() * out.element_size())

    def psum(tensors, group=None):
        if group is None:
            return real_psum(tensors, group)
        ts = [tensors] if isinstance(tensors, torch.Tensor) else list(tensors)
        return timed("allreduce", lambda: real_psum(tensors, group),
                     lambda _: sum(t.numel() * t.element_size() for t in ts))

    with mock.patch.object(collectives, "all_gather", gather), mock.patch.object(collectives, "psum_", psum):
        yield rec


def whole_digest(whole) -> str:
    """sha256 of a whole state dict: step, model, optimizer, EMA."""
    h = hashlib.sha256()
    h.update(str(whole["step"]).encode())
    for name, t in whole["model"].items():
        h.update(name.encode())
        h.update(t.detach().cpu().contiguous().numpy().tobytes())
    h.update(optimizer_digest(whole["optimizer"]).encode())
    for name in sorted(whole.get("ema") or {}):
        h.update(whole["ema"][name].detach().cpu().contiguous().numpy().tobytes())
    return h.hexdigest()[:16]


def tree_copy(torch, obj):
    """``obj`` (nested dicts and lists of tensors and plain values) with
    every tensor cloned."""
    if isinstance(obj, torch.Tensor):
        return obj.detach().clone()
    if isinstance(obj, dict):
        return {k: tree_copy(torch, v) for k, v in obj.items()}
    if isinstance(obj, (list, tuple)):
        return type(obj)(tree_copy(torch, v) for v in obj)
    return obj


def tp_units(model) -> dict:
    """``{module name: kind}`` of the tensor-parallel layers of a sliced
    model (those whose ``tp`` is set): ``channelwise`` (BatchNorm, the
    depthwise conv), ``pointwise`` (a split-separable conv's pointwise
    pair), ``leaves`` (the ViT's LayerNorm and position table, the MoE
    layer's leaves: gathered whole where they are used) or ``column`` (a
    conv, ``ConvBN``, a Dense, the ViT's patch conv, whose whole input's
    cotangent is summed)."""
    from tensorflowdistributedlearning_tpu_torch.models.layers import BatchNorm, DepthwiseConv2D, SplitSeparableConv2D
    from tensorflowdistributedlearning_tpu_torch.models.vit import LayerNorm, MoEMlp, ViTClassifier

    kinds = {}
    for name, m in model.named_modules():
        if getattr(m, "tp", None) is None:
            continue
        kinds[name] = ("channelwise" if isinstance(m, (BatchNorm, DepthwiseConv2D))
                       else "pointwise" if isinstance(m, SplitSeparableConv2D)
                       else "leaves" if isinstance(m, (LayerNorm, ViTClassifier, MoEMlp)) else "column")
    return kinds


@contextlib.contextmanager
def split_channel_blocks(torch, model, units, dims, tp: int):
    """For the duration, every layer of the whole ``model`` named in
    ``units`` (:func:`tp_units`) computes as the ``tp`` ranks of the
    tensor-parallel step compute it: block by block of its output channels,
    each block with that block of its leaves (``dims``: the leaves' sliced
    dimensions, ``tensor.tensor_parallel_specs``) on the whole input (a
    contracting layer) or on that block of it (a per-channel layer, as a
    contiguous copy), the blocks concatenated; a contracting layer's blocks'
    input cotangents are summed before they reach the input, as the model
    group's all-reduce sums them. One process then runs the ranks'
    forward to the bit, and the one-rank step under it is what the
    tensor-parallel step is held against (as :func:`dp_emulation` splits
    the batch for the data-parallel step)."""

    class Replicas(torch.autograd.Function):
        @staticmethod
        def forward(ctx, x, n):
            return tuple(x.view_as(x) for _ in range(n))

        @staticmethod
        def backward(ctx, *gs):
            total = gs[0]
            for g in gs[1:]:
                total = total + g
            return total, None

    modules = dict(model.named_modules())
    names = {id(m): n for n, m in model.named_modules()}

    def leaves(members):
        out = []
        for sub in members:
            prefix = names[id(sub)]
            for is_param, store in ((True, sub._parameters), (False, sub._buffers)):
                for n, t in store.items():
                    if t is not None and dims.get(f"{prefix}.{n}") is not None:
                        out.append((store, n, dims[f"{prefix}.{n}"], is_param))
            out += leaves(list(sub.children()))
        return out

    def blockwise(fn, items, args_of):
        outs = []
        for m in range(tp):
            saved = []
            for store, n, dim, is_param in items:
                t = store[n]
                k = t.shape[dim] // tp
                view = t.narrow(dim, m * k, k)
                saved.append((store, n, t))
                store[n] = view.contiguous() if is_param else view
            try:
                outs.append(fn(*args_of(m)))
            finally:
                for store, n, t in saved:
                    store[n] = t
        return torch.cat(outs, dim=-1)

    def block_of(t, m):
        if t is None:
            return None
        k = t.shape[-1] // tp
        return t.narrow(-1, m * k, k).contiguous()

    patched = []
    for name, kind in units.items():
        mod = modules[name]
        if kind == "channelwise":
            items = leaves([mod])
            if hasattr(mod, "running_mean"):
                def fwd(x, act="relu", residual=None, local=mod._forward, items=items):
                    return blockwise(local, items, lambda m: (block_of(x, m), act, block_of(residual, m)))
            else:
                def fwd(x, local=mod._forward, items=items):
                    return blockwise(local, items, lambda m: (block_of(x, m),))
            attr = "forward"
        else:
            members = [mod.pointwise, mod.pointwise_bn] if kind == "pointwise" else [mod]
            attr = "_pointwise" if kind == "pointwise" else "forward"
            local = getattr(mod, attr if kind == "pointwise" else "_forward")

            def fwd(x, local=local, items=leaves(members)):
                xs = Replicas.apply(x, tp)
                return blockwise(local, items, lambda m: (xs[m],))
        setattr(mod, attr, fwd)
        patched.append((mod, attr))
    try:
        yield
    finally:
        for mod, attr in patched:
            delattr(mod, attr)


def tp_collective_bytes(cfg, rows: int, tp: int):
    """``(bytes landed, calls)`` of the channel all-gathers and ``(bytes
    reduced, calls)`` of the input-cotangent sums of one rank in one
    training step on ``rows`` rows, from the shapes alone: a meta-device
    forward of the whole model with the input and output of each layer
    that the rule gives a tensor-parallel form (:func:`tp_units` of a copy
    cut by it) recorded. A layer's whole output lands in the forward; a
    per-channel layer's whole input cotangent lands in the backward; a
    contracting layer's input cotangent is summed, unless its input needs
    no gradient (the images)."""
    import dataclasses

    import torch

    from tensorflowdistributedlearning_tpu_torch.models import model_for
    from tensorflowdistributedlearning_tpu_torch.parallel import tensor

    # the plain depthwise and attention versions: the kernels take no meta
    # tensors, and the shapes are the same
    cfg = dataclasses.replace(cfg, use_pallas_depthwise=False, use_fused_attention=False)
    with torch.device("meta"):
        sliced, whole = model_for(cfg), model_for(cfg)
    tensor.shard_model(sliced, tensor.layout_for(sliced, tp, 0))
    modules = dict(whole.named_modules())
    count = {"gather": [0, 0], "allreduce": [0, 0]}

    def add(kind, t):
        count[kind][0] += t.numel() * t.element_size()
        count[kind][1] += 1

    def hook(kind):
        def record(module, args, out):
            if kind == "leaves":
                # the parameters gathered whole; their backward moves nothing
                for name, p in module.named_parameters(recurse=False):
                    add("gather", p)
                return
            add("gather", out)
            if kind == "channelwise":
                add("gather", args[0])
            elif args[0].requires_grad:
                add("allreduce", args[0])

        return record

    for name, kind in tp_units(sliced).items():
        modules[name].register_forward_hook(hook(kind))
    whole.train()
    whole(torch.empty((rows,) + tuple(cfg.input_shape) + (cfg.input_channels,), device="meta"))
    return count


def tp_rule_bytes(cfg, dp: int, tp: int, zero: bool):
    """The rule's per-rank bytes for ``cfg`` under Adam without an EMA (the
    Trainer's default): ``(params, opt_state)`` on every rank of a (dp, tp)
    grid, from the shapes alone (a meta-device model cut by the
    tensor-parallel rule, then the ZeRO-1 rule): a sliced leaf holds 1/tp
    (and 1/dp of its slots under ZeRO-1); Adam keeps two moments and a
    float32 step per parameter."""
    import torch

    from tensorflowdistributedlearning_tpu_torch.models import model_for
    from tensorflowdistributedlearning_tpu_torch.parallel import tensor, zero as zero_lib

    with torch.device("meta"):
        model = model_for(cfg)
    layout = tensor.layout_for(model, tp, 0)
    tensor.shard_model(model, layout)
    dims = zero_lib.weight_update_specs(model, dp, layout) if zero and dp > 1 else {}
    params = opt = 0
    for name, p in model.named_parameters():
        params += p.numel() * 4
        opt += 2 * 4 * p.numel() // (dp if dims.get(name) is not None else 1) + 4
    return params, opt


def tp_vit(torch, rank: int, root: str, dev, overrides, batch: int) -> dict:
    """The ViT arm of a ``train-tp`` rank at (1, 2): ViT-S/16's step held
    against the one-card step from the same state (rank 0), its ms, one
    step's gathers and input-cotangent sums, then ``fit_preset`` with
    ``parallelism='auto'`` pinned at ``model_parallel`` 2 (the planner
    validates the layout and writes the header's ``plan``), its launches
    counted and its attention calls recorded, and the rank's memory and
    watermark events against the plan's prediction."""
    import dataclasses

    from tensorflowdistributedlearning_tpu_torch import configs
    from tensorflowdistributedlearning_tpu_torch.data import pipeline as pipeline_lib
    from tensorflowdistributedlearning_tpu_torch.data.synthetic import synthetic_classification_batch
    from tensorflowdistributedlearning_tpu_torch.obs.ledger import read_ledger_with_errors
    from tensorflowdistributedlearning_tpu_torch.ops import kernels
    from tensorflowdistributedlearning_tpu_torch.parallel import collectives, multihost, tensor
    from tensorflowdistributedlearning_tpu_torch.train import step as step_lib
    from tensorflowdistributedlearning_tpu_torch.train.fit import fit_preset
    from tensorflowdistributedlearning_tpu_torch.train.state import create_train_state
    from tensorflowdistributedlearning_tpu_torch.train.step import _slot_shapes

    on_card = dev.type == "cuda"
    preset = configs.get_preset(VIT_PRESET)
    cfg = dataclasses.replace(preset.model, **(overrides or {}))
    tcfg = dataclasses.replace(preset.train, seed=SEED % 1000 + 87)
    fixed = pipeline_lib.to_device(synthetic_classification_batch(
        np.random.default_rng(SEED + 87), batch, cfg.input_shape, cfg.input_channels, cfg.num_classes), dev)
    task = step_lib.ClassificationTask(label_smoothing=tcfg.label_smoothing)
    init = drawn_state(torch, cfg, tcfg, dev, SEED + 88).model.state_dict()
    state = create_train_state(cfg, dataclasses.replace(tcfg, model_parallel=TP_DEGREE), dev, state_dict=init)
    step = tensor.make_train_step_gspmd(task, weight_decay=cfg.weight_decay, seed=tcfg.seed)
    _, metrics = step(state, fixed)
    loss = step_lib.compute_metrics(metrics)["loss"]
    names = [n for n, _ in state.model.named_parameters()]
    grads = dict(zip(names, state.tp.gather([(n, p.grad) for n, p in state.model.named_parameters()])))
    out = {"n_params": state.param_count()}
    one = single = None
    if rank == 0:
        one = create_train_state(cfg, tcfg, dev, state_dict=init)
        single = step_lib.make_train_step(task, weight_decay=cfg.weight_decay, seed=tcfg.seed)
        _, m1 = single(one, fixed)
        want_loss = step_lib.compute_metrics(m1)["loss"]
        worst = max(float((grads[n] - p.grad).abs().max()) / (TOL_MOE_GRAD * float(p.grad.abs().max()) + 1e-12)
                    for n, p in one.model.named_parameters())
        check(np.isfinite(loss) and abs(loss - want_loss) <= bf16_spacing(want_loss) and worst <= 1.0,
              f"train-tp ViT-S/16 held step vs the one-card step: loss {loss} vs {want_loss}, worst gradient leaf at "
              f"{worst:.3f} of {TOL_MOE_GRAD}·max|leaf|")
        out["held"] = {"loss": loss, "one_card_loss": want_loss, "worst_gradient": worst}
    del init, grads
    multihost.barrier()
    # the timed steps: the first with each collective timed, the card
    # synchronized around it, the rest alone
    with timed_collectives(torch, collectives) as rec:
        out["collective_step_ms"] = rep_ms(torch, lambda: step(state, fixed), 1)
    out["collectives"] = rec
    multihost.barrier()
    out["step_ms"] = rep_ms(torch, lambda: step(state, fixed), TP_VIT_TIMED_STEPS - 1)
    if one is not None:
        # the held step warmed it
        out["one_rank_ms"] = rep_ms(torch, lambda: single(one, fixed), TP_VIT_TIMED_STEPS)
    multihost.barrier()
    del state, one, fixed
    if on_card:
        torch.cuda.empty_cache()

    # the main path: fit_preset through the planner, counts from 0 just
    # before, read just after
    model_dir = os.path.join(root, "fit-vit-tp")
    with mock.patch.dict(configs.PRESETS, {VIT_PRESET: dataclasses.replace(preset, model=cfg)}), \
            record_attention_calls(torch, TP_VIT_HELD_CALLS) as attention:
        kernels.reset_launch_counts()
        t0 = time.perf_counter()
        r = fit_preset(VIT_PRESET, model_dir, steps=TP_VIT_FIT_STEPS, batch_size=batch, device=dev,
                       parallelism="auto", model_parallel=TP_DEGREE, seed=tcfg.seed, train_log_every_steps=1)
        if on_card:
            torch.cuda.synchronize()
        out["fit_s"] = time.perf_counter() - t0
        out["launches"] = kernels.launch_counts()
    out["fit"] = {"steps": r.steps, "final_metrics": r.final_metrics}
    out["held_calls"] = {}
    if on_card and attention:
        out["held_calls"]["flash_attention"] = max(
            hold_attention_forward(torch, c, f"train-tp ViT rank {rank} attention") for c in attention)
    out["n_attention_calls"] = len(attention)
    events, errors = read_ledger_with_errors(
        os.path.join(model_dir, "telemetry.jsonl" if rank == 0 else f"telemetry-{rank}.jsonl"))
    header = next((e for e in events if e["event"] == "run_header"), {})
    out["ledger_errors"], out["mesh"], out["plan"] = errors, header.get("mesh"), header.get("plan")
    out["memory_events"] = [{k: e.get(k) for k in ("params_bytes_per_device", "opt_state_bytes_per_device")}
                            for e in events if e["event"] == "memory" and "opt_state_bytes_per_device" in e]
    out["watermarks"] = [{k: e.get(k) for k in ("phase", "peak_bytes", "predicted_bytes_per_device",
                                                "measured_minus_predicted_bytes")}
                         for e in events if e["event"] == "memory_watermark"]
    # torch's Adam keeps a float32 step per parameter, optax two int32 counts
    probe = create_train_state(cfg, dataclasses.replace(tcfg, model_parallel=TP_DEGREE), dev)
    out["torch_step_bytes"] = sum(4 for g in probe.optimizer.param_groups for p in g["params"]
                                  for shape, _ in _slot_shapes(probe.optimizer, g, p).values() if tuple(shape) == ())
    out["optax_count_bytes"] = 8 if tcfg.optimizer == "adam" else 4
    del probe
    return out


def tp_rank(torch, rank: int, world: int, store: str, root: str, device: str, model_kwargs, size: int, batch: int,
            vit=None):
    """One rank of ``train-tp``. At ``world`` = 2 (a (1, 2) grid): the
    tensor-parallel step held step by step against the one-rank step from
    the same state (rank 0 runs both), the step's ms, its gathers' ms and
    MB, the ViT arm (:func:`tp_vit`; ``vit`` holds its ``overrides`` and
    ``batch``), then Trainer.train with its launches counted and its
    depthwise and BN calls recorded. At ``world`` = 4 (a (2, 2) grid): the
    step with and without ZeRO-1, and the whole states' digests."""
    from tensorflowdistributedlearning_tpu_torch.config import ModelConfig, TrainConfig
    from tensorflowdistributedlearning_tpu_torch.models import build_model
    from tensorflowdistributedlearning_tpu_torch.obs.ledger import read_ledger_with_errors
    from tensorflowdistributedlearning_tpu_torch.ops import kernels
    from tensorflowdistributedlearning_tpu_torch.parallel import collectives, mesh, multihost
    from tensorflowdistributedlearning_tpu_torch.train import step as step_lib
    from tensorflowdistributedlearning_tpu_torch.train.state import create_train_state
    from tensorflowdistributedlearning_tpu_torch.train.trainer import Trainer, state_bytes

    dev = torch.device(device if device == "cpu" else "cuda:0")
    multihost.initialize(store, world, rank, backend="gloo", timeout=300)
    out = {"rank": rank}
    try:
        if dev.type == "cuda":
            torch.cuda.set_device(0)
            torch.backends.cudnn.allow_tf32 = False
            torch.backends.cuda.matmul.allow_tf32 = False
        lay = mesh.init_mesh(TP_DEGREE)
        out["layout"] = [lay.dp, lay.tp, lay.data_index, lay.model_index]
        data = os.path.join(root, "data")
        ids = sorted(f[:-4] for f in os.listdir(os.path.join(data, "images")))
        cfg = ModelConfig(input_shape=(size, size), **model_kwargs)
        task = smooth_task()
        fixed = dp_batches(torch, data, ids, batch, max(TP_HELD_STEPS, TP_ZERO_STEPS), dev)
        rows = mesh.shard_rows(batch)
        local = [{k: v[rows] for k, v in b.items()} for b in fixed]
        step = step_lib.make_train_step(task, data_parallel=True)
        # one seeded draw of the whole model, every state loaded from it
        init = build_model(cfg, "cpu", generator=torch.Generator().manual_seed(SEED + 71)).state_dict()

        def fresh(**kw):
            return create_train_state(cfg, TrainConfig(seed=SEED % 1000 + 7, **kw), dev, state_dict=init)

        if world == TP_ZERO_RANKS:
            for mode, kw in (("tp", {}), ("zero", {"weight_update_sharding": True})):
                state = fresh(model_parallel=TP_DEGREE, **kw)
                losses, times = [], []
                with deterministic_algorithms(torch):
                    for k in range(TP_ZERO_STEPS):
                        t0 = time.perf_counter()
                        _, metrics = step(state, local[k])
                        losses.append(step_lib.compute_metrics(metrics)["loss"])
                        times.append((time.perf_counter() - t0) * 1e3)
                out[mode] = {"digest": whole_digest(state.state_dict()), "losses": losses, "ms": times,
                             "zero": state.zero is not None, **state_bytes(state, bool(kw))}
                del state
                if dev.type == "cuda":
                    torch.cuda.empty_cache()
            multihost.barrier()
            return out

        # the tensor-parallel step against the one-rank step from the same
        # state, step by step: held against it under the ranks' channel
        # blocks (split_channel_blocks: the ranks' forward to the bit), and
        # the plain one-rank step beside it (its gradient read, not held: a
        # rounding-level change takes a ReLU or max-pool kink the other way)
        state = fresh(model_parallel=TP_DEGREE)
        one = fresh() if rank == 0 else None
        del init
        single = step_lib.make_train_step(task)
        units = tp_units(state.model)
        held = []

        def one_rank_step(whole, k, split):
            # the model's state: the step's loss, gradient and BN statistics
            # do not read the optimizer's
            one.model.load_state_dict(whole)
            with split_channel_blocks(torch, one.model, units, state.tp.dims, TP_DEGREE) if split \
                    else contextlib.nullcontext():
                _, m1 = single(one, fixed[k])
            return (step_lib.compute_metrics(m1)["loss"], {n: p.grad.clone() for n, p in one.model.named_parameters()},
                    {n: b.clone() for n, b in one.model.named_buffers()})

        with deterministic_algorithms(torch):
            for k in range(TP_HELD_STEPS):
                # copies: a replicated leaf's entry is the live tensor, which the step updates
                whole = tree_copy(torch, state.model_state_dict())
                _, metrics = step(state, local[k])
                loss = step_lib.compute_metrics(metrics)["loss"]
                names = [n for n, _ in state.model.named_parameters()]
                grads = dict(zip(names, state.tp.gather([(n, p.grad) for n, p in state.model.named_parameters()])))
                stats = state.model_state_dict()
                if one is not None:
                    rec = {}
                    for what, split in (("split", True), ("plain", False)):
                        want_loss, want_g, want_s = one_rank_step(whole, k, split)
                        d_loss = abs(loss - want_loss)
                        d_stats = max((stats[n] - b).abs().max().item() for n, b in want_s.items())
                        check(d_loss <= TOL_LOSS and d_stats <= 1e-5,
                              f"train-tp held step {k} vs the {what} one-rank step: loss {loss} vs {want_loss}, BN "
                              f"statistics {d_stats} apart")
                        if split:
                            worst = worst_gradient(want_g, grads, f"train-tp held step {k} vs the one-rank step")
                        else:
                            worst = max((grads[n] - g).abs().max().item() / (1e-4 * g.abs().max().item() + 1e-6)
                                        for n, g in want_g.items())
                        rec[what] = {"d_loss": d_loss, "worst_gradient": worst, "d_stats": d_stats}
                    held.append(rec)
                del whole, grads, stats
        out["held"] = held

        # ms per step on a resident batch, then one step's collectives timed
        times = [host_ms(torch, lambda: step(state, local[0]), reps=1, warmup=0) for _ in range(TP_TIMED_STEPS + 1)]
        out["step_ms"] = statistics.median(times[1:])
        if one is not None:
            out["one_rank_ms"] = statistics.median(
                [host_ms(torch, lambda: single(one, fixed[0]), reps=1, warmup=0) for _ in range(TP_TIMED_STEPS + 1)][1:])
        with timed_collectives(torch, collectives) as rec:
            step(state, local[0])
        out["collectives"] = rec
        del state, one
        if dev.type == "cuda":
            torch.cuda.empty_cache()
        t0 = time.perf_counter()
        out["vit"] = tp_vit(torch, rank, root, dev, (vit or {}).get("overrides"), (vit or {}).get("batch", TP_VIT_BATCH))
        out["vit"]["arm_s"] = time.perf_counter() - t0
        if rank == 0:
            # the (2, 2) grid's ranks may start now: what follows is not timed
            with open(os.path.join(root, "tp2-timed"), "w"):
                pass
        if dev.type == "cuda":
            torch.cuda.empty_cache()

        # the main path: Trainer.train, counts from 0 just before, read just after
        tcfg = TrainConfig(n_folds=TP_FOLDS, seed=SEED % 1000 + 8, checkpoint_every_steps=TP_TRAIN_STEPS, save_best=1,
                           n_devices=world, model_parallel=TP_DEGREE)
        model_dir = os.path.join(root, "model-tp")
        trainer = Trainer(model_dir, data, train_config=tcfg, device=dev, input_shape=(size, size), **model_kwargs)
        ledger = LaunchLedger(kernels, step_lib, Trainer)
        with ledger.patch(), record_kernel_calls(torch, RANK_HELD) as recorded:
            kernels.reset_launch_counts()
            t0 = time.perf_counter()
            out["metrics"] = trainer.train(ids, batch_size=batch, steps=TP_TRAIN_STEPS)
            if dev.type == "cuda":
                torch.cuda.synchronize()
            out["train_s"] = time.perf_counter() - t0
            out["launches"] = kernels.launch_counts()
        out["params"] = trainer.params
        out["ledger_train"], out["ledger_eval"] = ledger.train, ledger.eval + ledger.summary
        if dev.type == "cuda":  # on the CPU the plain versions ran: nothing to hold
            out["held_calls"] = hold_rank_calls(torch, recorded, batch)
        del recorded
        events, errors = read_ledger_with_errors(
            os.path.join(model_dir, "telemetry.jsonl" if rank == 0 else f"telemetry-{rank}.jsonl"))
        out["memory_events"] = [{k: e.get(k) for k in ("params_bytes_per_device", "opt_state_bytes_per_device")}
                                for e in events if e["event"] == "memory" and "opt_state_bytes_per_device" in e]
        out["ledger_errors"] = errors
        out["mesh"] = next((e.get("mesh") for e in events if e["event"] == "run_header"), None)
        multihost.barrier()
    finally:
        multihost.shutdown()
    return out


def tp_start(root: str, world: int, device: str, model_kwargs, size: int, batch: int, vit=None):
    """Start ``world`` ranks of ``chip_smoke.py tp-rank ...`` sharing the
    card on the warm build directory; ``(processes, logs)``."""
    store = f"file://{os.path.join(root, f'store-tp{world}')}"
    procs, logs = [], []
    for rank in range(world):
        logs.append(open(os.path.join(root, f"tp{world}-rank{rank}.log"), "w"))
        procs.append(subprocess.Popen(
            [sys.executable, os.path.abspath(__file__), "tp-rank", str(rank), str(world), store, root, device,
             json.dumps(model_kwargs), str(size), str(batch), json.dumps(vit or {})],
            stdout=logs[-1], stderr=subprocess.STDOUT,
        ))
    return procs, logs


def tp_finish(root: str, world: int, procs, logs, deadline: float, prefix: str = "tp"):
    """Wait for the ranks until ``deadline`` (``time.perf_counter``), kill
    any still running, and return their outputs
    (``ROOT/{prefix}{world}-rank{rank}.json``), rank by rank."""
    try:
        for p in procs:
            try:
                p.wait(timeout=max(1.0, deadline - time.perf_counter()))
            except subprocess.TimeoutExpired:
                pass
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
        for f in logs:
            f.close()
    outs = []
    for rank, p in enumerate(procs):
        with open(os.path.join(root, f"{prefix}{world}-rank{rank}.log")) as f:
            text = f.read()
        check(p.returncode == 0, f"{prefix} rank {rank} of {world} exited {p.returncode}:\n{text[-3000:]}")
        with open(os.path.join(root, f"{prefix}{world}-rank{rank}.json")) as f:
            outs.append(json.load(f))
    return outs


def tp_vit_checks(torch, card: str, device: str, outs, overrides, batch: int) -> dict:
    """The ViT arm's checks and lines over the two ranks' outputs; returns
    its numbers, with ``held`` (kernel name: max|err| of the attention
    calls held) and ``launches`` (rank 0's fit)."""
    import dataclasses

    from tensorflowdistributedlearning_tpu_torch import configs

    cfg = dataclasses.replace(configs.get_preset(VIT_PRESET).model, **(overrides or {}))
    r0 = outs[0]["vit"]
    held = {}
    for o in outs:
        v, what = o["vit"], f"train-tp ViT rank {o['rank']}"
        check(v["fit"]["steps"] == TP_VIT_FIT_STEPS and all(np.isfinite(x) for x in v["fit"]["final_metrics"].values()),
              f"{what}: fit {v['fit']}")
        check(v["fit"]["final_metrics"] == r0["fit"]["final_metrics"], f"{what}: metrics apart from rank 0's")
        check(v["ledger_errors"] == 0 and v["mesh"] == {"batch": 1, "model": TP_DEGREE, "sequence": 1},
              f"{what}: ledger errors {v['ledger_errors']}, mesh {v['mesh']}")
        plan = v["plan"] or {}
        check(plan.get("source") == "auto" and plan.get("feasible") and plan["layout"]["model_parallel"] == TP_DEGREE
              and plan["layout"]["data_parallel"] == 1, f"{what}: header plan {plan}")
        pred = plan["predicted"]
        check(v["memory_events"] and all(
            e["params_bytes_per_device"] == pred["params_bytes_per_chip"]
            and e["opt_state_bytes_per_device"] - v["torch_step_bytes"] + v["optax_count_bytes"]
            == pred["opt_state_bytes_per_chip"] for e in v["memory_events"]),
            f"{what}: memory events {v['memory_events']} against the plan's {pred} (torch's steps "
            f"{v['torch_step_bytes']} bytes, optax's counts {v['optax_count_bytes']})")
        fa = v["launches"].get("flash_attention", 0)
        if device == "cuda":
            check(fa > 0 and fa % cfg.vit_layers == 0, f"{what}: {fa} flash_attention launches in fit")
            check(v["n_attention_calls"] == TP_VIT_HELD_CALLS, f"{what}: {v['n_attention_calls']} attention calls held")
            for name, e in v["held_calls"].items():
                held[name] = max(held.get(name, 0.0), e)
    col = r0["collectives"]
    shapes = tp_collective_bytes(cfg, batch, TP_DEGREE)
    if configs.get_preset(VIT_PRESET).train.grad_clip_norm:
        # the clip's sum of the sliced leaves' squares over the model group
        shapes["allreduce"] = [shapes["allreduce"][0] + 4, shapes["allreduce"][1] + 1]
    for kind in ("gather", "allreduce"):
        check([col[kind][2], col[kind][0]] == shapes[kind],
              f"train-tp ViT: one step's {kind}s moved {col[kind][2]} bytes in {col[kind][0]} calls, the shapes' "
              f"count {shapes[kind][0]} in {shapes[kind][1]}")
    h = r0["held"]
    pred = r0["plan"]["predicted"]
    marks = r0["watermarks"]
    log(f"train-tp ViT: the {TP_DEGREE}-rank step against the one-card step from the same state: loss {h['loss']} vs "
        f"{h['one_card_loss']} (one bf16 step allowed), worst gradient leaf at {h['worst_gradient']:.3f} of "
        f"{TOL_MOE_GRAD}·max|leaf|; each rank's first {TP_VIT_HELD_CALLS} fit attention calls held against the plain "
        f"version, max|err| {held.get('flash_attention', 0.0):.3g}")
    log(f"train-tp ViT: {VIT_PRESET} ({r0['n_params']} parameters, {cfg.dtype}, {cfg.input_shape[0]}x"
        f"{cfg.input_shape[1]}) on {TP_DEGREE} gloo ranks sharing {device} at model_parallel {TP_DEGREE}, global batch "
        f"{batch}: {r0['step_ms'][0]:.3f} ms per step alone (rank 0), {r0['collective_step_ms'][0]:.3f} ms with its "
        f"collectives timed; the one-card step {r0['one_rank_ms'][0]:.3f} ms (median of {TP_VIT_TIMED_STEPS}); that "
        f"step's {col['gather'][0]} all-gathers land {col['gather'][2] / 1e6:.1f} MB in {col['gather'][1] * 1e3:.3f} ms and "
        f"its {col['allreduce'][0]} input-cotangent sums reduce {col['allreduce'][2] / 1e6:.1f} MB in "
        f"{col['allreduce'][1] * 1e3:.3f} ms (both byte counts the shapes') [{card}]")
    log(f"train-tp ViT: fit_preset(parallelism='auto', model_parallel={TP_DEGREE}) {TP_VIT_FIT_STEPS} steps in "
        f"{r0['fit_s']:.3f} s, launches {json.dumps({k: c for k, c in r0['launches'].items() if c})}; the plan "
        f"predicts {pred['params_bytes_per_chip']} parameter and {pred['opt_state_bytes_per_chip']} optimizer bytes per "
        f"rank, each rank's memory events {[o['vit']['memory_events'][0] for o in outs]} (the torch Adam steps' "
        f"{r0['torch_step_bytes']} bytes for optax's {r0['optax_count_bytes']}); watermarks "
        f"{json.dumps(marks[-2:]) if marks else 'none'}; arm {r0['arm_s']:.3f} s [{card}]")
    return {"held": held, "launches": r0["launches"], "step_ms": r0["step_ms"], "one_rank_ms": r0["one_rank_ms"],
            "collective_step_ms": r0["collective_step_ms"], "gather_mb": col["gather"][2] / 1e6, "gather_ms": col["gather"][1] * 1e3, "gather_calls": col["gather"][0],
            "allreduce_mb": col["allreduce"][2] / 1e6, "allreduce_ms": col["allreduce"][1] * 1e3,
            "allreduce_calls": col["allreduce"][0], "held_step": h, "fit_s": r0["fit_s"], "arm_s": r0["arm_s"],
            "predicted": pred, "memory_events": [o["vit"]["memory_events"][0] for o in outs],
            "measured_minus_predicted_bytes": [m.get("measured_minus_predicted_bytes") for m in marks][-1:]}


def plan_commands(torch, card: str, device: str) -> dict:
    """The ``plan`` command in this process, on one card (``--device
    cpu`` rehearses it): ``--preset vit_s16_imagenet --json`` and
    ``--preset tgs_salt`` (the table), each with the memory budget the card
    reports; exit 0, a feasible chosen layout, the budget the card's.
    Before them the trainers' header plan (``train.trainer.run_plan``,
    which every run with telemetry on makes on every rank) is timed for
    the presets of ``dp``, ``train-moe`` and ``train-sp``, each profile
    uncached and the first with the planner's imports, as a rank's first
    run pays them."""
    import dataclasses
    import io

    from tensorflowdistributedlearning_tpu_torch import configs
    from tensorflowdistributedlearning_tpu_torch.__main__ import main as cli_main
    from tensorflowdistributedlearning_tpu_torch.train.trainer import run_plan

    args = ["--device", device]
    limit = torch.cuda.mem_get_info(0)[1] if device == "cuda" else None
    out = {"header_plan_s": {}}
    for name in ("tgs_salt", MOE_PRESET, VIT_PRESET):
        pre = configs.get_preset(name)
        # earlier phases of this process may have profiled the preset
        if "tensorflowdistributedlearning_tpu_torch.parallel.planner" in sys.modules:
            sys.modules["tensorflowdistributedlearning_tpu_torch.parallel.planner"]._profile_model_cached.cache_clear()
        t0 = time.perf_counter()
        run_plan(None, pre.model, dataclasses.replace(pre.train, telemetry=True), pre.global_batch, device)
        out["header_plan_s"][name] = time.perf_counter() - t0
    for name, extra in ((VIT_PRESET, ["--json"]), ("tgs_salt", [])):
        buf = io.StringIO()
        t0 = time.perf_counter()
        with contextlib.redirect_stdout(buf):
            rc = cli_main(["plan", "--preset", name, *extra, *args])
        text = buf.getvalue()
        check(rc == 0, f"train-tp: plan --preset {name} exited {rc}: {text[-500:]}")
        if extra:
            plan = json.loads(text)
            check(plan["feasible"] and plan["topology"]["hbm_bytes_per_device"] == limit,
                  f"train-tp: plan --preset {name}: feasible {plan['feasible']}, budget "
                  f"{plan['topology']['hbm_bytes_per_device']} against the card's {limit}")
            out[name] = {k: plan[k] for k in ("layout", "predicted", "headroom_frac", "score") if k in plan}
            log(f"train-tp: plan --preset {name} --json: {json.dumps(out[name])} [{card}]")
        else:
            check("chosen" in text and "parallelism plan" in text, f"train-tp: plan --preset {name}: {text[-500:]}")
            for line in text.splitlines():
                log(f"train-tp: plan --preset {name}: {line}")
        out[f"{name}_s"] = time.perf_counter() - t0
    log(f"train-tp: the trainers' header plan, each profile uncached (the first with the planner's imports): "
        f"{json.dumps(out['header_plan_s'])} s; then the plan commands {out[f'{VIT_PRESET}_s']:.3f} and "
        f"{out['tgs_salt_s']:.3f} s [{card}]")
    return out


def train_tp_phase(torch, card: str, device: str = "cuda", model_kwargs=None, n_images: int = TP_IMAGES,
                   size: int = 101, batch: int = TP_BATCH, vit_overrides=None, vit_batch: int = TP_VIT_BATCH):
    """Tensor parallelism (``model_parallel`` 2) of the segmenter and of
    ViT-S/16: two gloo ranks sharing the card, then four as a (2, 2) grid
    with and without ZeRO-1; before them the ``plan`` command on the card.
    ``model_kwargs``, ``vit_overrides`` and ``device="cpu"`` rehearse it
    small."""
    from tensorflowdistributedlearning_tpu_torch.config import ModelConfig

    model_kwargs = dict(model_kwargs or {}, use_pallas_depthwise=True)
    cfg = ModelConfig(input_shape=(size, size), **model_kwargs)
    on_card = device == "cuda"
    vit = {"overrides": dict(vit_overrides or {}), "batch": vit_batch}
    planned = plan_commands(torch, card, device)
    with tempfile.TemporaryDirectory(prefix="chip-smoke-tp-") as root:
        write_salt_dataset(os.path.join(root, "data"), n_images, size, SEED + 73)
        t0 = time.perf_counter()
        deadline = t0 + TP_TIMEOUT_S
        two = tp_start(root, TP_DEGREE, device, model_kwargs, size, batch, vit)
        four = None
        try:
            # the grid starts once the two ranks' timed steps are done, beside
            # their Trainer.train (its wall time is read, not held)
            marker = os.path.join(root, "tp2-timed")
            while four is None and time.perf_counter() < deadline and all(p.poll() is None for p in two[0]):
                if os.path.exists(marker):
                    four = tp_start(root, TP_ZERO_RANKS, device, model_kwargs, size, batch)
                else:
                    time.sleep(0.2)
            outs = tp_finish(root, TP_DEGREE, *two, deadline)
            t1 = time.perf_counter()
            check(four is not None, "train-tp: the two ranks never reached their untimed part")
            grid = tp_finish(root, TP_ZERO_RANKS, *four, deadline)
        finally:
            for procs, logs in [x for x in (two, four) if x is not None]:
                for p in procs:
                    if p.poll() is None:
                        p.kill()
                        p.wait()
                for f in logs:
                    f.close()
        t2 = time.perf_counter()
    r0 = outs[0]
    params_bytes, opt_bytes = tp_rule_bytes(cfg, 1, TP_DEGREE, zero=False)
    _, zero_opt_bytes = tp_rule_bytes(cfg, TP_ZERO_RANKS // TP_DEGREE, TP_DEGREE, zero=True)
    for o in outs:
        what = f"train-tp rank {o['rank']}"
        check(o["layout"] == [1, TP_DEGREE, 0, o["rank"]], f"{what}: layout {o['layout']}")
        check(o["metrics"] == r0["metrics"], f"{what}: metrics {o['metrics']} vs rank 0's {r0['metrics']}")
        check(all(np.isfinite(v) for m in o["metrics"] for v in m.values()), f"{what}: {o['metrics']}")
        check_trainer_launches(o["ledger_train"], o["ledger_eval"], o["launches"], TP_FOLDS, TP_TRAIN_STEPS, what)
        check(o["ledger_errors"] == 0 and o["mesh"] == {"batch": 1, "model": TP_DEGREE, "sequence": 1},
              f"{what}: ledger errors {o['ledger_errors']}, mesh {o['mesh']}")
        check(len(o["memory_events"]) >= TP_FOLDS and all(
            e == {"params_bytes_per_device": params_bytes, "opt_state_bytes_per_device": opt_bytes}
            for e in o["memory_events"]),
            f"{what}: memory events {o['memory_events']}, the rule says {params_bytes} / {opt_bytes} bytes")
    check(len(r0["held"]) == TP_HELD_STEPS, f"train-tp: {len(r0['held'])} held steps")
    for o in grid:
        what = f"train-tp (2, 2) rank {o['rank']}"
        check(o["layout"] == [TP_ZERO_RANKS // TP_DEGREE, TP_DEGREE, o["rank"] // TP_DEGREE, o["rank"] % TP_DEGREE],
              f"{what}: layout {o['layout']}")
        check(o["zero"]["zero"] and not o["tp"]["zero"], f"{what}: ZeRO-1 layout {o['zero']['zero']}")
        check(o["zero"]["digest"] == o["tp"]["digest"] == grid[0]["tp"]["digest"]
              and o["zero"]["losses"] == o["tp"]["losses"],
              f"{what}: {TP_ZERO_STEPS} ZeRO-1 steps not bit for bit the tensor-parallel steps: "
              f"{o['zero']['digest']} / {o['tp']['digest']}, losses {o['zero']['losses']} / {o['tp']['losses']}")
        check(o["tp"]["params_bytes_per_device"] == params_bytes and o["tp"]["opt_state_bytes_per_device"] == opt_bytes
              and o["zero"]["opt_state_bytes_per_device"] == zero_opt_bytes,
              f"{what}: bytes {o['tp']} / {o['zero']}, the rule says {params_bytes} / {opt_bytes} / {zero_opt_bytes}")
        check(all(np.isfinite(o[m]["losses"]).all() for m in ("tp", "zero")), f"{what}: losses")
    held_err = {}
    for o in outs if on_card else ():
        h = o["held_calls"]
        log(f"train-tp rank {o['rank']}: its Trainer.train's first step's {RANK_HELD['depthwise_conv2d_forward']} "
            f"depthwise forward, dx and dw calls on its channel slices {h['shapes']} and its first eval forward's "
            f"{RANK_HELD['bn_act_folded']} fused_bn_act calls held against the plain versions: forward max|err| "
            f"{h['depthwise_conv2d']:.3g}, dx {h['depthwise_conv2d_dx']:.3g}, dw {h['depthwise_conv2d_dw']:.3g}, BN "
            f"{h['fused_bn_act']:.3g} (forward, dx and BN bitwise the earlier kernels, dw bitwise a relaunch)")
        for plan in h["dw_plans"]:
            log(f"train-tp rank {o['rank']}: dw {plan}")
        for name in ("depthwise_conv2d", "depthwise_conv2d_dx", "depthwise_conv2d_dw", "fused_bn_act"):
            held_err[name] = max(held_err.get(name, 0.0), h[name])
    col = r0["collectives"]
    shapes = tp_collective_bytes(cfg, batch, TP_DEGREE)
    for kind in ("gather", "allreduce"):
        check([col[kind][2], col[kind][0]] == shapes[kind],
              f"train-tp: one step's {kind}s moved {col[kind][2]} bytes in {col[kind][0]} calls, the shapes' count "
              f"{shapes[kind][0]} in {shapes[kind][1]}")
    gather_mb, gather_ms = col["gather"][2] / 1e6, col["gather"][1] * 1e3
    reduce_mb, reduce_ms = col["allreduce"][2] / 1e6, col["allreduce"][1] * 1e3
    held = r0["held"]

    def listed(what, key, fmt):
        return ", ".join(format(h[what][key], fmt) for h in held)

    log(f"train-tp: the {TP_DEGREE}-rank step against the one-rank step from the same state, {TP_HELD_STEPS} steps "
        f"under deterministic algorithms: under the ranks' channel blocks |dloss| {listed('split', 'd_loss', '.3g')}, "
        f"worst gradient leaf at {listed('split', 'worst_gradient', '.3f')} of its tolerance, BN statistics "
        f"{listed('split', 'd_stats', '.3g')} apart; against the plain one-rank step |dloss| "
        f"{listed('plain', 'd_loss', '.3g')}, BN statistics {listed('plain', 'd_stats', '.3g')}, worst gradient leaf "
        f"at {listed('plain', 'worst_gradient', '.3f')} of the tolerance (reported)")
    log(f"train-tp: tgs_salt ({r0['params']} parameters, float32) on {TP_DEGREE} gloo ranks sharing {device} at "
        f"model_parallel {TP_DEGREE}, global batch {batch}: {r0['step_ms']:.3f} ms per step (rank 0, median of "
        f"{TP_TIMED_STEPS}), the one-rank step {r0['one_rank_ms']:.3f} ms; one step's {col['gather'][0]} channel "
        f"all-gathers land {gather_mb:.1f} MB in {gather_ms:.3f} ms and its {col['allreduce'][0]} input-cotangent "
        f"sums reduce {reduce_mb:.1f} MB in {reduce_ms:.3f} ms (host-staged, the card synchronized around each; "
        f"both byte counts the shapes', tp_collective_bytes) "
        f"[{card}]")
    log(f"train-tp: Trainer.train on both ranks, {TP_FOLDS} folds x {TP_TRAIN_STEPS} steps, {r0['train_s']:.3f} s; "
        f"each rank's {len(r0['ledger_train'])} train steps launched {PER_TRAIN_STEP} each, its "
        f"{len(r0['ledger_eval'])} eval forwards {PER_EVAL_FORWARD} each; memory events {params_bytes} parameter and "
        f"{opt_bytes} optimizer bytes per rank, the rule's to the byte; metrics equal on both ranks "
        f"{json.dumps(r0['metrics'])}; {t1 - t0:.3f} s for the ranks (the grid's beside their Trainer.train) "
        f"[{card}]")
    vit_out = tp_vit_checks(torch, card, device, outs, vit_overrides, vit_batch)
    for name, e in vit_out.pop("held").items():
        held_err[name] = max(held_err.get(name, 0.0), e)
    g0 = grid[0]
    log(f"train-tp: (2, 2) grid of {TP_ZERO_RANKS} gloo ranks at global batch {batch}: {TP_ZERO_STEPS} steps with "
        f"ZeRO-1 bit for bit the tensor-parallel steps (digest {g0['zero']['digest']}, losses {g0['zero']['losses']}); "
        f"optimizer bytes per rank {opt_bytes} without ZeRO-1, "
        f"{', '.join(str(o['zero']['opt_state_bytes_per_device']) for o in grid)} with it (the rule: "
        f"{zero_opt_bytes}); step ms {[round(x, 3) for x in g0['tp']['ms']]} / {[round(x, 3) for x in g0['zero']['ms']]}; "
        f"{t2 - t0:.3f} s for both launches [{card}]")
    return {"launches": r0["launches"], "held": held_err, "step_ms": r0["step_ms"], "one_rank_ms": r0["one_rank_ms"],
            "gather_mb": gather_mb, "gather_ms": gather_ms, "gather_calls": col["gather"][0],
            "allreduce_mb": reduce_mb, "allreduce_ms": reduce_ms, "allreduce_calls": col["allreduce"][0],
            "params_bytes_per_rank": params_bytes, "opt_bytes_per_rank": opt_bytes,
            "zero_opt_bytes_per_rank": zero_opt_bytes, "held_steps": held, "train_s": r0["train_s"],
            "ranks_s": t1 - t0, "phase_ranks_s": t2 - t0,
            "grid_step_ms": {m: g0[m]["ms"] for m in ("tp", "zero")}, "vit": vit_out, "plan": planned}


def tp_rank_main(argv) -> int:
    """``chip_smoke.py tp-rank RANK WORLD STORE ROOT DEVICE MODEL_KWARGS SIZE
    BATCH [VIT]``: one rank of ``train-tp`` (VIT: the ViT arm's overrides and
    batch as JSON); writes ``ROOT/tp{WORLD}-rank{RANK}.json``."""
    import torch

    rank, world, store, root, device = int(argv[0]), int(argv[1]), argv[2], argv[3], argv[4]
    model_kwargs, size, batch = json.loads(argv[5]), int(argv[6]), int(argv[7])
    vit = json.loads(argv[8]) if len(argv) > 8 else {}
    for key in ("n_blocks",):
        if key in model_kwargs:
            model_kwargs[key] = tuple(model_kwargs[key])
    if "input_shape" in vit.get("overrides", {}):
        vit["overrides"]["input_shape"] = tuple(vit["overrides"]["input_shape"])
    try:
        out = tp_rank(torch, rank, world, store, root, device, model_kwargs, size, batch, vit)
    except SmokeFailure as e:
        print(f"FAIL: {e}", file=sys.stderr)
        return 1
    with open(os.path.join(root, f"tp{world}-rank{rank}.json"), "w") as f:
        json.dump(out, f)
    return 0


# pipeline parallelism: vit_s16_imagenet and xception41_imagenet at full
# width as 2-stage GPipe pipelines (4 microbatches) on two gloo ranks sharing
# the card, global batch 64 (dp = 1)
PP_STAGES = 2
PP_MICROBATCHES = 4
PP_BATCH = 64
PP_HELD_STEPS = 2
PP_TIMED_STEPS = 1
PP_FIT_STOP = 2
PP_FIT_STEPS = 4
PP_HELD_CALLS = 4  # attention / BN calls of each rank's fit held against plain
PP_TIMEOUT_S = 300
PP_PRESETS = (VIT_PRESET, "xception41_imagenet")  # X41_PRESET, defined with the Xception phases


@contextlib.contextmanager
def timed_pipeline_collectives(torch, collectives, stage_group):
    """For the duration, every point-to-point send and receive of the
    pipeline, its output broadcast and each sum over the stage group (the
    gradient's assembly, and Xception's middle statistics) is timed with
    the card synchronized around it; yields ``{kind: [calls, seconds,
    bytes]}``."""
    rec = {k: [0, 0.0, 0] for k in ("send", "recv", "broadcast", "assembly", "stats")}
    real = {n: getattr(collectives, n) for n in ("send", "recv", "broadcast_", "psum_")}

    def nbytes(tensors):
        ts = [tensors] if isinstance(tensors, torch.Tensor) else list(tensors)
        return sum(t.numel() * t.element_size() for t in ts)

    def timed(kind, fn, n):
        if torch.cuda.is_available():
            torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = fn()
        if torch.cuda.is_available():
            torch.cuda.synchronize()
        r = rec[kind]
        r[0], r[1], r[2] = r[0] + 1, r[1] + time.perf_counter() - t0, r[2] + n
        return out

    def send(t, dst, group=None):
        return timed("send", lambda: real["send"](t, dst, group), nbytes(t))

    def recv(like, src, group=None):
        return timed("recv", lambda: real["recv"](like, src, group), nbytes(like))

    def broadcast_(tensors, src=0, group=None):
        if group is not stage_group:
            return real["broadcast_"](tensors, src, group)
        return timed("broadcast", lambda: real["broadcast_"](tensors, src, group), nbytes(tensors))

    def psum_(tensors, group=None):
        if group is not stage_group:
            return real["psum_"](tensors, group)
        kind = "assembly" if isinstance(tensors, torch.Tensor) else "stats"
        return timed(kind, lambda: real["psum_"](tensors, group), nbytes(tensors))

    with mock.patch.multiple(collectives, send=send, recv=recv, broadcast_=broadcast_, psum_=psum_):
        yield rec


def pp_shape_bytes(cfg, batch: int, n_params: int, stats_numel: int) -> dict:
    """One pipelined step's bytes per rank of 2 stages from the shapes
    alone: each rank sends one direction of one hop (stage 0 the
    activations, stage 1 their cotangents) and receives the other, the
    output broadcast is the whole local batch's stage output, the gradient
    assembly the float32 parameters, the statistics' sum the middle units'
    float32 running statistics."""
    from tensorflowdistributedlearning_tpu_torch.models.layers import scaled_width

    h, w = cfg.input_shape
    if cfg.backbone == "vit":
        act = (h // cfg.patch_size) * (w // cfg.patch_size) * scaled_width(cfg.embed_dim, cfg.width_multiplier)
    else:
        act = (h // 16) * (w // 16) * scaled_width(728, cfg.width_multiplier)
    hop = batch * act * (2 if cfg.dtype == "bfloat16" else 4)
    return {"send": hop, "recv": hop, "broadcast": hop, "assembly": 4 * n_params, "stats": 4 * stats_numel}


@contextlib.contextmanager
def pipeline_step_ledger(torch, kernels, pipeline_step):
    """Wraps the pipeline's step builders: each train step's and eval
    forward's kernel launches are recorded as deltas; yields ``(train,
    eval)``."""
    train, evals = [], []

    def wrap(make, sink):
        def maker(*a, **kw):
            inner = make(*a, **kw)

            def step(*x, **y):
                before = kernels.launch_counts()
                out = inner(*x, **y)
                after = kernels.launch_counts()
                sink.append({k: after[k] - before[k] for k in after})
                return out

            return step

        return maker

    with mock.patch.multiple(pipeline_step, make_train_step_pipeline=wrap(pipeline_step.make_train_step_pipeline, train),
                             make_eval_step_pipeline=wrap(pipeline_step.make_eval_step_pipeline, evals)):
        yield train, evals


@contextlib.contextmanager
def record_attention_calls(torch, limit: int):
    """The first ``limit`` ``flash_attention`` calls while it runs as
    before: their inputs and output (cloned)."""
    from tensorflowdistributedlearning_tpu_torch.ops import flash_attention as fa

    calls, real = [], fa.flash_attention

    def recording(q, k, v, *, causal=False):
        out = real(q, k, v, causal=causal)
        if len(calls) < limit:
            calls.append({"q": q.detach().clone(), "k": k.detach().clone(), "v": v.detach().clone(),
                          "out": out.detach().clone(), "causal": causal})
        return out

    with mock.patch.object(fa, "flash_attention", recording):
        yield calls


def pp_per_rank_launches(torch, cfg, on_card: bool):
    """A rank's kernel launches per pipelined train step and per eval
    forward: the ViT's bf16 attention once per block of its stage and
    microbatch; Xception's eval-mode BN once per BN of the entry and exit
    flows and of its stage's units per microbatch (its training BN is
    plain)."""
    from tensorflowdistributedlearning_tpu_torch.models import model_for
    from tensorflowdistributedlearning_tpu_torch.models import xception as xc
    from tensorflowdistributedlearning_tpu_torch.models.layers import BatchNorm
    from tensorflowdistributedlearning_tpu_torch.ops import kernels

    zero = {k: 0 for k in kernels.launch_counts()}
    if not on_card:
        return zero, zero
    if cfg.backbone == "vit":
        n = cfg.vit_layers // PP_STAGES * PP_MICROBATCHES
        per = dict(zero, flash_attention=n, flash_attention_tc=n)
        return per, per
    with torch.device("meta"):
        model = model_for(cfg)
    count = lambda m: sum(isinstance(b, BatchNorm) for b in m.modules())  # noqa: E731
    units = xc.middle_units(model)[: xc.MIDDLE_FLOW_UNITS // PP_STAGES]
    n = count(xc.XceptionEntryFlow(model)) + count(xc.XceptionExitHead(model)) + PP_MICROBATCHES * sum(
        count(u) for u in units)
    return zero, dict(zero, fused_bn_act=n, fused_bn_act_bf16_act=n)


def pp_model_run(torch, name: str, cfg, dev, batch: int, root: str, rank: int) -> dict:
    """One model's part of a ``train-pp`` rank: the pipelined step held
    against the one-rank schedule (rank 0 runs both) and reported against
    the plain one-rank step, times, one step's transfers, the state digest,
    then ``fit_preset`` 2 + 2 steps with the launches counted and the
    kernels' calls recorded."""
    import dataclasses

    from tensorflowdistributedlearning_tpu_torch import configs
    from tensorflowdistributedlearning_tpu_torch.data import pipeline as pipeline_lib
    from tensorflowdistributedlearning_tpu_torch.data.synthetic import synthetic_classification_batch
    from tensorflowdistributedlearning_tpu_torch.models import build_model
    from tensorflowdistributedlearning_tpu_torch.models import xception as xc
    from tensorflowdistributedlearning_tpu_torch.obs.ledger import read_ledger_with_errors
    from tensorflowdistributedlearning_tpu_torch.ops import kernels
    from tensorflowdistributedlearning_tpu_torch.parallel import collectives, mesh, multihost
    from tensorflowdistributedlearning_tpu_torch.train import pipeline_step
    from tensorflowdistributedlearning_tpu_torch.train import step as step_lib
    from tensorflowdistributedlearning_tpu_torch.train.fit import fit_preset
    from tensorflowdistributedlearning_tpu_torch.train.state import create_train_state

    on_card = dev.type == "cuda"
    preset = configs.get_preset(name)
    tcfg = dataclasses.replace(preset.train, pipeline_parallel=PP_STAGES, pipeline_microbatches=PP_MICROBATCHES,
                               seed=SEED % 1000 + 91)
    task = step_lib.ClassificationTask(label_smoothing=tcfg.label_smoothing)
    init = build_model(cfg, "cpu", generator=torch.Generator().manual_seed(SEED + 91)).state_dict()
    rng = np.random.default_rng(SEED + 92)
    fixed = [pipeline_lib.to_device(synthetic_classification_batch(
        rng, batch, cfg.input_shape, cfg.input_channels, cfg.num_classes), dev) for _ in range(PP_HELD_STEPS)]
    state = create_train_state(cfg, tcfg, dev, state_dict=init)
    one = create_train_state(cfg, tcfg, dev, state_dict=init) if rank == 0 else None
    plain = create_train_state(cfg, dataclasses.replace(tcfg, pipeline_parallel=1, pipeline_microbatches=None), dev,
                               state_dict=init) if rank == 0 else None
    del init
    step = pipeline_step.make_train_step_pipeline(task, cfg, PP_MICROBATCHES, seed=tcfg.seed)
    local = pipeline_step.make_train_step_pipeline(task, cfg, PP_MICROBATCHES, seed=tcfg.seed, local_stages=PP_STAGES)
    single = step_lib.make_train_step(task, seed=tcfg.seed)
    out = {"n_params": state.param_count(), "held": []}

    def grads(s):
        return {n: p.grad.detach().clone() for n, p in s.model.named_parameters()}

    # the pipelined step against the one-rank schedule, step by step from one
    # state, and the plain one-rank step's gap at the first (reported)
    with deterministic_algorithms(torch):
        for k in range(PP_HELD_STEPS):
            _, metrics = step(state, fixed[k])
            rec = {"loss": step_lib.compute_metrics(metrics)["loss"], "digest": state_digest(state.model),
                   "opt_digest": optimizer_digest(state.optimizer.state_dict())}
            if one is not None:
                _, m1 = local(one, fixed[k])
                rec["one_rank"] = {"loss": step_lib.compute_metrics(m1)["loss"], "digest": state_digest(one.model),
                                   "opt_digest": optimizer_digest(one.optimizer.state_dict())}
                if k == 0:
                    _, m2 = single(plain, fixed[0])
                    want, got = grads(plain), grads(state)
                    rec["plain"] = {
                        "loss": step_lib.compute_metrics(m2)["loss"],
                        "worst_gradient": max((got[n] - g).abs().max().item() / (1e-4 * g.abs().max().item() + 1e-6)
                                              for n, g in want.items()),
                    }
                    del want, got
            out["held"].append(rec)
    del plain

    # ms per step on a resident batch; one step's transfers
    out["step_ms"] = statistics.median(
        [host_ms(torch, lambda: step(state, fixed[0]), reps=1, warmup=0) for _ in range(PP_TIMED_STEPS + 1)][1:])
    if one is not None:
        out["one_rank_ms"] = statistics.median(
            [host_ms(torch, lambda: local(one, fixed[0]), reps=1, warmup=0) for _ in range(PP_TIMED_STEPS + 1)][1:])
        out["plain_ms"] = statistics.median(
            [host_ms(torch, lambda: single(one, fixed[0]), reps=1, warmup=0) for _ in range(PP_TIMED_STEPS + 1)][1:])
    # the ranks enter the timed step together (rank 0 timed the one-rank steps alone)
    multihost.barrier()
    with timed_pipeline_collectives(torch, collectives, mesh.stage_group()) as rec:
        step(state, fixed[0])
    out["transfers"] = rec
    stats = 0
    if cfg.backbone == "xception":
        stats = sum(b.numel() for n, b in state.model.backbone.named_buffers() if n.startswith(xc.MIDDLE_FLOW_PREFIX))
    out["shape_bytes"] = pp_shape_bytes(cfg, batch, out["n_params"], stats)
    out["final_digest"] = state_digest(state.model)
    del state, one, fixed
    if on_card:
        torch.cuda.empty_cache()

    # the main path: fit_preset 2 steps, then resumed to 4; counts from 0
    # just before, read just after
    model_dir = os.path.join(root, f"fit-{name}")
    fit = {}
    with contextlib.ExitStack() as stack, mock.patch.dict(
            configs.PRESETS, {name: dataclasses.replace(preset, model=cfg)}):
        train_deltas, eval_deltas = stack.enter_context(pipeline_step_ledger(torch, kernels, pipeline_step))
        attention = stack.enter_context(record_attention_calls(torch, PP_HELD_CALLS))
        bn = stack.enter_context(record_kernel_calls(torch, {"bn_act_folded": PP_HELD_CALLS}))
        kernels.reset_launch_counts()
        t0 = time.perf_counter()
        for stop in (PP_FIT_STOP, PP_FIT_STEPS):
            r = fit_preset(name, model_dir, steps=stop, batch_size=batch, device=dev, pipeline_parallel=PP_STAGES,
                           pipeline_microbatches=PP_MICROBATCHES, checkpoint_every_steps=PP_FIT_STOP,
                           train_log_every_steps=PP_FIT_STOP, seed=tcfg.seed)
            fit[str(stop)] = {"steps": r.steps, "final_metrics": r.final_metrics}
        if on_card:
            torch.cuda.synchronize()
        out["fit_s"] = time.perf_counter() - t0
        out["launches"] = kernels.launch_counts()
    out["fit"] = fit
    out["train_deltas"], out["eval_deltas"] = train_deltas, eval_deltas
    out["model_dir"] = model_dir
    held = {}
    if on_card:
        if attention:
            held["flash_attention"] = max(hold_attention_forward(torch, c, f"train-pp {name} rank {rank} attention")
                                          for c in attention)
        if bn["bn_act_folded"]:
            held["fused_bn_act_bf16_act"] = hold_bn_calls(torch, bn["bn_act_folded"], f"train-pp {name} rank {rank}")
    out["held_calls"] = held
    out["n_attention_calls"], out["n_bn_calls"] = len(attention), len(bn["bn_act_folded"])
    events, errors = read_ledger_with_errors(
        os.path.join(model_dir, "telemetry.jsonl" if rank == 0 else f"telemetry-{rank}.jsonl"))
    out["ledger_errors"] = errors
    out["mesh"] = [e.get("mesh") for e in events if e["event"] == "run_header"]
    return out


def pp_rank(torch, rank: int, world: int, store: str, root: str, device: str, cfgs, batch: int):
    """One rank of ``train-pp`` at ``pipeline_parallel`` 2: for each model,
    :func:`pp_model_run`."""
    from tensorflowdistributedlearning_tpu_torch.parallel import mesh, multihost

    dev = torch.device(device if device == "cpu" else "cuda:0")
    multihost.initialize(store, world, rank, backend="gloo", timeout=300)
    out = {"rank": rank}
    try:
        if dev.type == "cuda":
            torch.cuda.set_device(0)
            torch.backends.cudnn.allow_tf32 = False
            torch.backends.cuda.matmul.allow_tf32 = False
        lay = mesh.init_mesh(PP_STAGES, pipeline=True)
        out["layout"] = [lay.dp, lay.tp, lay.data_index, lay.model_index, mesh.pipeline_parallel_degree(),
                         mesh.model_parallel_degree()]
        for name, cfg in cfgs.items():
            out[name] = pp_model_run(torch, name, cfg, dev, batch, root, rank)
            if dev.type == "cuda":
                torch.cuda.empty_cache()
        multihost.barrier()
    finally:
        multihost.shutdown()
    return out


def pp_configs(overrides=None) -> dict:
    """``{preset: ModelConfig}`` of the phase's models: the presets' own,
    or with ``overrides`` (``{preset: {field: value}}``, a CPU rehearsal's
    narrow copies)."""
    import dataclasses

    from tensorflowdistributedlearning_tpu_torch import configs

    overrides = overrides or {}
    out = {}
    for name in PP_PRESETS:
        kw = dict(overrides.get(name, {}))
        if "input_shape" in kw:
            kw["input_shape"] = tuple(kw["input_shape"])
        out[name] = dataclasses.replace(configs.get_preset(name).model, **kw)
    return out


def train_pp_phase(torch, card: str, device: str = "cuda", overrides=None, batch: int = PP_BATCH):
    """Pipeline parallelism (``pipeline_parallel`` 2, 4 microbatches) of
    ViT-S/16 and the Xception-41 classifier: two gloo ranks sharing the
    card, each ``chip_smoke.py pp-rank ...`` on the warm build directory;
    then each fit's export served through the plain model in this process.
    ``overrides`` (narrow copies of the presets' models) and
    ``device="cpu"`` rehearse it small."""
    from tensorflowdistributedlearning_tpu_torch import configs
    from tensorflowdistributedlearning_tpu_torch.ops import flash_attention as fa
    from tensorflowdistributedlearning_tpu_torch.ops import kernels
    from tensorflowdistributedlearning_tpu_torch.parallel import pipeline as pipeline_lib
    from tensorflowdistributedlearning_tpu_torch.train.fit import EVAL_SYNTHETIC_BATCHES, ClassifierTrainer

    on_card = device == "cuda"
    cfgs = pp_configs(overrides)
    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory(prefix="chip-smoke-pp-") as root:
        store = f"file://{os.path.join(root, 'store')}"
        procs, logs = [], []
        try:
            for rank in range(PP_STAGES):
                logs.append(open(os.path.join(root, f"pp{PP_STAGES}-rank{rank}.log"), "w"))
                procs.append(subprocess.Popen(
                    [sys.executable, os.path.abspath(__file__), "pp-rank", str(rank), str(PP_STAGES), store, root,
                     device, json.dumps(overrides or {}), str(batch)],
                    stdout=logs[-1], stderr=subprocess.STDOUT,
                ))
            outs = tp_finish(root, PP_STAGES, procs, logs, t0 + PP_TIMEOUT_S, prefix="pp")
        finally:
            for p in procs:
                if p.poll() is None:
                    p.kill()
                    p.wait()
            for f in logs:
                f.close()
        t1 = time.perf_counter()
        result = {"bubble": pipeline_lib.bubble_fraction(PP_STAGES, PP_MICROBATCHES), "ranks_s": t1 - t0,
                  "models": {}}
        launches = {k: 0 for k in kernels.launch_counts()}
        held = {}
        for name, cfg in cfgs.items():
            r0, r1 = outs[0][name], outs[1][name]
            what = f"train-pp {name}"
            check(outs[0]["layout"] == [1, PP_STAGES, 0, 0, PP_STAGES, 1] and
                  outs[1]["layout"] == [1, PP_STAGES, 0, 1, PP_STAGES, 1],
                  f"{what}: layouts {outs[0]['layout']} / {outs[1]['layout']}")
            check(len(r0["held"]) == PP_HELD_STEPS, f"{what}: {len(r0['held'])} held steps")
            for k, (h0, h1) in enumerate(zip(r0["held"], r1["held"])):
                one = h0["one_rank"]
                check(h0["loss"] == h1["loss"] == one["loss"] and np.isfinite(h0["loss"]),
                      f"{what} held step {k}: losses {h0['loss']} / {h1['loss']}, one-rank schedule {one['loss']}")
                check(h0["digest"] == h1["digest"] == one["digest"] and h0["opt_digest"] == h1["opt_digest"] ==
                      one["opt_digest"], f"{what} held step {k}: states {h0['digest']} / {h1['digest']}, one-rank "
                      f"{one['digest']}; optimizer {h0['opt_digest']} / {h1['opt_digest']} / {one['opt_digest']}")
            check(r0["final_digest"] == r1["final_digest"], f"{what}: the ranks' states part after the timed steps")
            plain = r0["held"][0]["plain"]
            d_plain = abs(plain["loss"] - r0["held"][0]["loss"])
            if cfg.backbone == "vit":
                spacing = 2.0 ** (math.floor(math.log2(abs(plain["loss"]))) - 7)
                check(d_plain <= spacing, f"{what}: |dloss| {d_plain} against the plain one-rank step, over one bf16 "
                      f"step ({spacing})")
            for i, o in enumerate((r0, r1)):
                for kind, want in o["shape_bytes"].items():
                    got = o["transfers"][kind][2]
                    check(got == want, f"{what} rank {i}: one step's {kind} moved {got} bytes, the shapes' count {want}")
            per_step, per_eval = pp_per_rank_launches(torch, cfg, on_card)
            for o in (r0, r1):
                rank_what = f"{what} rank {0 if o is r0 else 1}"
                check([f["steps"] for f in o["fit"].values()] == [PP_FIT_STOP, PP_FIT_STEPS] and all(
                    np.isfinite(v) for f in o["fit"].values() for v in f["final_metrics"].values()),
                      f"{rank_what}: fit {o['fit']}")
                check(o["fit"] == r0["fit"], f"{rank_what}: fit results {o['fit']} against rank 0's {r0['fit']}")
                check(len(o["train_deltas"]) == PP_FIT_STEPS and len(o["eval_deltas"]) == 2 * EVAL_SYNTHETIC_BATCHES,
                      f"{rank_what}: {len(o['train_deltas'])} train steps, {len(o['eval_deltas'])} eval forwards")
                for i, delta in enumerate(o["train_deltas"] + o["eval_deltas"]):
                    want = per_step if i < PP_FIT_STEPS else per_eval
                    check({k: delta[k] for k in want} == want, f"{rank_what} train step or eval forward {i}: "
                          f"launches {delta}, expected {want}")
                check(o["ledger_errors"] == 0 and o["mesh"] == [{"batch": 1, "model": PP_STAGES, "sequence": 1}] * 2,
                      f"{rank_what}: ledger errors {o['ledger_errors']}, mesh {o['mesh']}")
                if on_card:
                    calls = o["n_attention_calls"] if cfg.backbone == "vit" else o["n_bn_calls"]
                    check(calls == PP_HELD_CALLS, f"{rank_what}: {calls} kernel calls held")
                for k, e in o["held_calls"].items():
                    held[k] = max(held.get(k, 0.0), e)
            for k, v in r0["launches"].items():
                launches[k] += v

            # the fit's checkpoint through the plain model in this process
            trainer = ClassifierTrainer(r0["model_dir"], None, cfg, configs.get_preset(name).train, device=device)
            serve = trainer.serving_fn()
            x = make_vit_instances(batch, SEED + 93, (*cfg.input_shape, cfg.input_channels))
            got = {k: v.cpu().numpy() for k, v in serve(x).items()}
            best = trainer._restore_best_host()
            with best.eval_params() as model, torch.no_grad(), \
                    mock.patch.object(fa, "flash_attention", fa.flash_attention_plain), \
                    mock.patch.object(kernels, "bn_act_folded", kernels.bn_act_folded_plain):
                model.eval()
                kernels.reset_launch_counts()
                logits = model(torch.from_numpy(x).to(device)).float()
                check(sum(kernels.launch_counts().values()) == 0, f"{what}: the plain forward launched")
                want = torch.softmax(logits, -1).cpu().numpy()
            d = float(np.abs(got["probabilities"] - want).max())
            top2 = np.sort(want, -1)[:, -2:]
            apart = top2[:, 1] - top2[:, 0] > 2 * TOL_VIT_BF16
            check(d <= TOL_VIT_BF16 and np.array_equal(got["class"][apart], want.argmax(-1)[apart]),
                  f"{what}: the export's answers {d} from the plain model's")
            check_classes(got["probabilities"], got["class"], f"{what} serve")
            del trainer, best
            tr = {k: {"calls": r0["transfers"][k][0], "ms": r0["transfers"][k][1] * 1e3,
                      "mb": r0["transfers"][k][2] / 1e6} for k in r0["transfers"]}
            tr1 = {k: {"calls": r1["transfers"][k][0], "ms": r1["transfers"][k][1] * 1e3,
                       "mb": r1["transfers"][k][2] / 1e6} for k in r1["transfers"]}
            result["models"][name] = {
                "n_params": r0["n_params"], "step_ms": r0["step_ms"], "step_ms_rank1": r1["step_ms"],
                "one_rank_ms": r0["one_rank_ms"], "plain_ms": r0["plain_ms"], "transfers_rank0": tr,
                "transfers_rank1": tr1, "held_losses": [h["loss"] for h in r0["held"]], "plain_d_loss": d_plain,
                "plain_worst_gradient": plain["worst_gradient"], "fit_s": r0["fit_s"], "serve_dprobs": d,
                "final_metrics": r0["fit"][str(PP_FIT_STEPS)]["final_metrics"],
            }
            m = result["models"][name]
            log(f"train-pp {name} ({m['n_params']} parameters, {cfg.dtype}) on {PP_STAGES} gloo ranks sharing {device} "
                f"at pipeline_parallel {PP_STAGES}, {PP_MICROBATCHES} microbatches, global batch {batch}: "
                f"{PP_HELD_STEPS} steps bit for bit the one-rank schedule on both ranks under deterministic "
                f"algorithms (losses {m['held_losses']}); the plain one-rank step's first loss {plain['loss']} "
                f"(|dloss| {d_plain:.3g}), worst gradient leaf {plain['worst_gradient']:.3f} of the train-step "
                f"tolerance (reported) [{card}]")
            log(f"train-pp {name}: {m['step_ms']:.3f} ms per pipelined step (rank 0, median of {PP_TIMED_STEPS}; rank 1 "
                f"{m['step_ms_rank1']:.3f}), the one-rank schedule {m['one_rank_ms']:.3f} ms, the plain one-rank step "
                f"{m['plain_ms']:.3f} ms; bubble (K-1)/(M+K-1) = {result['bubble']:.3f} [{card}]")
            log(f"train-pp {name}: one step's transfers, rank 0 / rank 1 (host-staged, the card synchronized around "
                f"each; a receive's and a sum's ms include the wait for the other rank; bytes the shapes' count): "
                + "; ".join(
                    f"{k} {tr[k]['calls']}/{tr1[k]['calls']} calls {tr[k]['mb']:.1f}/{tr1[k]['mb']:.1f} MB "
                    f"{tr[k]['ms']:.3f}/{tr1[k]['ms']:.3f} ms" for k in tr) + f" [{card}]")
            log(f"train-pp {name}: fit_preset {PP_FIT_STOP} steps, then resumed to {PP_FIT_STEPS}, on both ranks "
                f"{m['fit_s']:.3f} s (rank 0); each train step launched {per_step if on_card else {}} and each eval "
                f"forward {per_eval if on_card else {}} per rank (nonzero counts held); final "
                f"{json.dumps(m['final_metrics'])}; the export served through the plain model, max|dprobs| {d:.3g} "
                f"[{card}]")
    result["launches"] = launches
    result["held"] = held
    result["phase_s"] = time.perf_counter() - t0
    return result


def pp_rank_main(argv) -> int:
    """``chip_smoke.py pp-rank RANK WORLD STORE ROOT DEVICE OVERRIDES BATCH``:
    one rank of ``train-pp``; writes ``ROOT/pp{WORLD}-rank{RANK}.json``."""
    # cuBLAS's deterministic workspace, read when the first handle is made
    os.environ.setdefault("CUBLAS_WORKSPACE_CONFIG", ":4096:8")
    import torch

    rank, world, store, root, device = int(argv[0]), int(argv[1]), argv[2], argv[3], argv[4]
    cfgs, batch = pp_configs(json.loads(argv[5])), int(argv[6])
    try:
        out = pp_rank(torch, rank, world, store, root, device, cfgs, batch)
    except SmokeFailure as e:
        print(f"FAIL: {e}", file=sys.stderr)
        return 1
    with open(os.path.join(root, f"pp{world}-rank{rank}.json"), "w") as f:
        json.dump(out, f)
    return 0



# expert parallelism: the Switch-MoE ViT served, trained on one card with
# every expert local, and trained at expert_parallel 8 on gloo ranks that
# share the card
MOE_PRESET = "vit_s16_moe_imagenet"
MOE_BATCH = 64
MOE_BUCKETS = (1, 64)
MOE_FIT_STOP = 2
MOE_FIT_STEPS = 4
MOE_TIMED_STEPS = 5  # steps on a resident batch; the median skips the first two
MOE_EP = 8  # ranks of the expert group: one expert each
MOE_EP_BATCH = 64  # global; dp = 1, so every rank holds the whole batch
MOE_EP_HELD_STEPS = 2
MOE_EP_TIMEOUT_S = 300
# a gradient leaf of a bf16 step within 2e-2·max|leaf| of its reference (the
# port's bf16 leaf bound, tests/test_torch_vit_train_step.py)
TOL_MOE_GRAD = 2e-2
# JAX's own bound on a load-balancing value (tests/test_expert.py): E·Σ f·P is
# 1 at a uniform split and not bounded below by 1
MOE_BALANCE_MIN = 0.99


def bf16_spacing(x: float) -> float:
    """One bf16 step at the magnitude of ``x``."""
    return 2.0 ** (math.floor(math.log2(abs(x))) - 7) if x else 2.0 ** -133


def moe_a2a_bytes(cfg, batch: int, world: int) -> int:
    """One all-to-all's bytes on a rank: the ``[E, C, D]`` dispatch buffer in
    the compute dtype, C = ceil(batch · tokens · factor / E)."""
    from tensorflowdistributedlearning_tpu_torch.models.layers import scaled_width
    from tensorflowdistributedlearning_tpu_torch.parallel.expert import capacity_of

    h, w = cfg.input_shape
    tokens = batch * (h // cfg.patch_size) * (w // cfg.patch_size)
    d = scaled_width(cfg.embed_dim, cfg.width_multiplier)
    return world * capacity_of(tokens, world, cfg.moe_capacity_factor) * d * (2 if cfg.dtype == "bfloat16" else 4)


def drawn_state(torch, cfg, tcfg, device, seed: int):
    """A fresh training state of ``cfg`` whose weights are drawn on
    ``device`` from ``seed`` (a CPU draw of the MoE preset's 71.7M
    parameters takes seconds)."""
    from tensorflowdistributedlearning_tpu_torch.models import build_model
    from tensorflowdistributedlearning_tpu_torch.train.state import create_train_state

    with torch.device(device):
        model = build_model(cfg, device, generator=torch.Generator(device).manual_seed(seed))
    return create_train_state(cfg, tcfg, device, state_dict=model.state_dict())


def moe_balance(torch, model, images):
    """Each MoE layer's load-balancing value (its recorded aux loss over the
    weight) and dispatch fractions from one training-mode forward of
    ``images`` without gradients, in the layers' collection order."""
    from tensorflowdistributedlearning_tpu_torch.models import vit

    model.train()
    with torch.no_grad():
        model(images)
    layers = vit.moe_layers(model)
    aux = vit.pop_aux_losses(model)
    return [{"balance": float(a) / m.aux_weight, "fractions": [round(float(f), 5) for f in m.expert_fraction]}
            for m, a in zip(layers, aux)]


@contextlib.contextmanager
def timed_expert_collectives(torch, collectives):
    """For the duration, each all-to-all and each all-reduce of the step is
    timed with the card synchronized around it; yields ``{kind: [calls,
    seconds, bytes]}``."""
    rec = {"all_to_all": [0, 0.0, 0], "all_reduce": [0, 0.0, 0]}
    real_a2a, real_reduce = collectives._all_to_all_single, collectives._reduce_

    def timed(kind, fn, n):
        if torch.cuda.is_available():
            torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = fn()
        if torch.cuda.is_available():
            torch.cuda.synchronize()
        r = rec[kind]
        r[0], r[1], r[2] = r[0] + 1, r[1] + time.perf_counter() - t0, r[2] + n
        return out

    def a2a(x, group):
        return timed("all_to_all", lambda: real_a2a(x, group), x.numel() * x.element_size())

    def reduce_(tensors, op, group=None):
        ts = [tensors] if isinstance(tensors, torch.Tensor) else list(tensors)
        return timed("all_reduce", lambda: real_reduce(tensors, op, group), sum(t.numel() * t.element_size() for t in ts))

    with mock.patch.multiple(collectives, _all_to_all_single=a2a, _reduce_=reduce_):
        yield rec


def moe_rank(torch, rank: int, world: int, store: str, root: str, device: str, cfg, batch: int):
    """One rank of ``train-moe``'s expert-parallel part: the preset's train
    step at ``expert_parallel`` = ``world`` (one expert per rank, dp 1)
    from ``ROOT/moe_init.pt`` on the seeded batch, once ``ROOT/go`` exists.
    Rank 0 runs the one-card dense step on a copy of the state before each
    held step and holds the loss and every gradient leaf against it; the
    last held step is timed (the ranks enter it together); then one step
    with its all-to-alls and all-reduces timed, the launches of each step
    and the state's digest."""
    import dataclasses

    from tensorflowdistributedlearning_tpu_torch import configs
    from tensorflowdistributedlearning_tpu_torch.data import pipeline as pipeline_lib
    from tensorflowdistributedlearning_tpu_torch.data.synthetic import synthetic_classification_batch
    from tensorflowdistributedlearning_tpu_torch.ops import kernels
    from tensorflowdistributedlearning_tpu_torch.parallel import collectives, mesh, multihost
    from tensorflowdistributedlearning_tpu_torch.train import step as step_lib
    from tensorflowdistributedlearning_tpu_torch.train.state import create_train_state

    t_start = time.perf_counter()
    dev = torch.device(device if device == "cpu" else "cuda:0")
    on_card = dev.type == "cuda"
    multihost.initialize(store, world, rank, backend="gloo", timeout=MOE_EP_TIMEOUT_S)
    out = {"rank": rank}
    try:
        if on_card:
            torch.cuda.set_device(0)
            torch.backends.cudnn.allow_tf32 = False
            torch.backends.cuda.matmul.allow_tf32 = False
        tcfg = dataclasses.replace(configs.get_preset(MOE_PRESET).train, expert_parallel=world, seed=SEED % 1000 + 101)
        init = torch.load(os.path.join(root, "moe_init.pt"), weights_only=True)
        state = create_train_state(cfg, tcfg, dev, state_dict=init)
        dense = create_train_state(cfg, dataclasses.replace(tcfg, expert_parallel=1), dev,
                                   state_dict=init) if rank == 0 else None
        del init
        lay = mesh.layout()
        out["layout"] = [lay.dp, lay.tp, lay.data_index, lay.model_index, mesh.expert_parallel_degree()]
        fixed = pipeline_lib.to_device(synthetic_classification_batch(
            np.random.default_rng(SEED + 103), batch, cfg.input_shape, cfg.input_channels, cfg.num_classes), dev)
        task = step_lib.ClassificationTask(label_smoothing=tcfg.label_smoothing)
        step = step_lib.make_train_step(task, data_parallel=True, weight_decay=cfg.weight_decay, seed=tcfg.seed)
        # the step's gradient before the update clips it
        grads = {}
        apply = state.apply_gradients

        def snapshot_then_apply():
            if rank == 0:
                grads.update({n: p.grad.detach().clone() for n, p in state.model.named_parameters()})
            apply()

        state.apply_gradients = snapshot_then_apply
        out["setup_s"] = time.perf_counter() - t_start  # the process's own start (imports) not included
        while not os.path.exists(os.path.join(root, "go")):
            time.sleep(0.05)
        multihost.barrier()
        out["held"], out["step_launches"] = [], []
        for k in range(MOE_EP_HELD_STEPS):
            rec = {}
            if dense is not None:
                dense.model.load_state_dict(state.model.state_dict())
                loss, _ = step_lib.forward_backward(dense, task, fixed)
                rec["dense_loss"] = float(loss)
            multihost.barrier()
            if on_card:
                torch.cuda.synchronize()
            before = kernels.launch_counts()
            t0 = time.perf_counter()
            _, metrics = step(state, fixed)
            rec["loss"] = step_lib.compute_metrics(metrics)["loss"]  # the host copy waits for the step
            out["step_ms"] = (time.perf_counter() - t0) * 1e3
            after = kernels.launch_counts()
            out["step_launches"].append({n: after[n] - before[n] for n in after})
            if dense is not None:
                worst, where = 0.0, None
                for n, p in dense.model.named_parameters():
                    share = float((grads[n] - p.grad).abs().max()) / (TOL_MOE_GRAD * float(p.grad.abs().max()) + 1e-12)
                    if share > worst:
                        worst, where = share, n
                rec["worst_gradient"], rec["worst_leaf"] = worst, where
                grads.clear()
            out["held"].append(rec)
        del dense
        if on_card:
            torch.cuda.empty_cache()
        multihost.barrier()
        with timed_expert_collectives(torch, collectives) as rec:
            step(state, fixed)
        out["transfers"] = rec
        out["final_digest"] = state_digest(state.model)
        if on_card:
            out["peak_gb"] = torch.cuda.max_memory_allocated() / 1e9
        multihost.barrier()
    finally:
        multihost.shutdown()
    return out


def moe_rank_main(argv) -> int:
    """``chip_smoke.py moe-rank RANK WORLD STORE ROOT DEVICE CONFIG BATCH``:
    one rank of ``train-moe``'s expert-parallel part (CONFIG a ModelConfig
    as JSON); writes ``ROOT/moe{WORLD}-rank{RANK}.json``."""
    import torch

    from tensorflowdistributedlearning_tpu_torch.config import ModelConfig

    rank, world, store, root, device = int(argv[0]), int(argv[1]), argv[2], argv[3], argv[4]
    cfg, batch = ModelConfig.from_json(argv[5]), int(argv[6])
    try:
        out = moe_rank(torch, rank, world, store, root, device, cfg, batch)
    except SmokeFailure as e:
        print(f"FAIL: {e}", file=sys.stderr)
        return 1
    with open(os.path.join(root, f"moe{world}-rank{rank}.json"), "w") as f:
        json.dump(out, f)
    return 0


def train_moe_phase(torch, card: str, device: str = "cuda", cfg=None, dense_cfg=None, batch: int = MOE_BATCH,
                    ep: int = MOE_EP, ep_batch: int = MOE_EP_BATCH, buckets=MOE_BUCKETS):
    """vit_s16_moe_imagenet (bf16, 224x224x3, 12 blocks of which 6 are
    8-expert Switch MoE, 71 694 184 parameters) at full width: the step on
    a resident batch with every expert local (ms, idle share, peak memory,
    the first loss beside ViT-S/16's, each MoE layer's balance and
    fractions), timed before any rank starts; then ``ep`` gloo ranks
    sharing the card at ``expert_parallel`` = ``ep`` (dp 1, global batch
    ``ep_batch``) start and wait while (a) an export of seeded weights is
    served by the engine at buckets 1 and 64 against the plain model and
    (b) fit_preset trains with every expert local, 2 steps then resumed to
    4; then (c) the ranks take 2 steps held against the one-card dense
    step, the ranks' states equal, ms per step and the all-to-alls' bytes
    and ms. ``cfg``, ``dense_cfg`` and ``device="cpu"`` rehearse it small."""
    from tensorflowdistributedlearning_tpu_torch import configs
    from tensorflowdistributedlearning_tpu_torch.models import build_model

    on_card = device == "cuda"
    preset = configs.get_preset(MOE_PRESET)
    cfg = cfg or preset.model
    dense_cfg = dense_cfg or configs.get_preset(VIT_PRESET).model
    per = PER_VIT_FORWARD if on_card else {k: 0 for k in PER_VIT_FORWARD}
    shape = (*cfg.input_shape, cfg.input_channels)
    n_moe = sum(1 for i in range(cfg.vit_layers) if i % 2 == 1)
    t0 = time.perf_counter()
    out = _moe_resident(torch, cfg, dense_cfg, card, device, batch, n_moe)
    with tempfile.TemporaryDirectory(prefix="chip-smoke-moe-") as root:
        # seeded weights drawn on the device, the logits calibrated to std 3
        with torch.device(device):
            model = build_model(cfg, device, generator=torch.Generator(device).manual_seed(SEED + 101))
        calibrate_logits(torch, model.eval(), torch.from_numpy(make_vit_instances(8, SEED + 102, shape)).to(device))
        out["n_params"] = sum(p.numel() for p in model.parameters())
        torch.save({k: v.detach().cpu() for k, v in model.state_dict().items()}, os.path.join(root, "moe_init.pt"))
        store = f"file://{os.path.join(root, 'store')}"
        procs, logs = [], []
        try:
            for rank in range(ep):
                logs.append(open(os.path.join(root, f"moe{ep}-rank{rank}.log"), "w"))
                procs.append(subprocess.Popen(
                    [sys.executable, os.path.abspath(__file__), "moe-rank", str(rank), str(ep), store, root, device,
                     cfg.to_json(), str(ep_batch)],
                    stdout=logs[-1], stderr=subprocess.STDOUT,
                ))
            out.update(_moe_serve(torch, model, cfg, card, root, device, per, buckets))
            del model
            if on_card:
                torch.cuda.empty_cache()
            out.update(_moe_fit(torch, cfg, card, root, device, per, batch))
            t_go = time.perf_counter()
            with open(os.path.join(root, "go"), "w"):
                pass
            outs = tp_finish(root, ep, procs, logs, t_go + MOE_EP_TIMEOUT_S, prefix="moe")
        finally:
            for p in procs:
                if p.poll() is None:
                    p.kill()
                    p.wait()
            for f in logs:
                f.close()
        out["ep"] = _moe_ep_checks(outs, cfg, card, device, per, ep, ep_batch, n_moe, time.perf_counter() - t_go)
    out["phase_s"] = time.perf_counter() - t0
    log(f"train-moe: {out['phase_s']:.1f} s in all (resident step {out['resident_s']:.1f} s, serve "
        f"{out['serve_s']:.1f} s, fit {out['fit_s']:.1f} s, {ep} ranks {out['ep']['ranks_s']:.1f} s after the go) "
        f"[{card}]")
    return out


def _moe_serve(torch, model, cfg, card: str, root: str, device: str, per, buckets):
    """(a): the export served by the engine at each bucket, a full bucket of
    seeded instances each, against the plain model on the same batch: the
    engine's logits (recorded at its serving head) within one bf16 step at
    the magnitude of their row's largest plain logit, the probabilities
    within the bf16 ViT bound, the class where the top two lie apart; 12
    attention launches per forward."""
    from tensorflowdistributedlearning_tpu_torch.ops import flash_attention as fa
    from tensorflowdistributedlearning_tpu_torch.ops import kernels
    from tensorflowdistributedlearning_tpu_torch.serve import InferenceEngine
    from tensorflowdistributedlearning_tpu_torch.train import step as step_lib
    from tensorflowdistributedlearning_tpu_torch.train.serving import export_serving_artifact

    t0 = time.perf_counter()
    manifest = export_serving_artifact(model, cfg, os.path.join(root, "export"))
    engine = InferenceEngine.from_artifact(os.path.dirname(manifest), device=device, buckets=buckets)
    head = step_lib.ClassificationTask.serve_predictions
    recorded = []

    def recording(task, logits):
        recorded.append(logits.detach().float().cpu())
        return head(task, logits)

    out = {"serve_launches": {k: 0 for k in kernels.launch_counts()}, "serve": {}}
    for b in buckets:
        x = make_vit_instances(b, SEED + 104 + b, (*cfg.input_shape, cfg.input_channels))
        kernels.reset_launch_counts()
        recorded.clear()
        with mock.patch.object(step_lib.ClassificationTask, "serve_predictions", recording):
            got = engine.infer(x)
        launched = kernels.launch_counts()
        check({k: launched[k] for k in per} == per, f"train-moe serve bucket {b}: launches {launched}, expected {per}")
        check(len(recorded) == 1 and recorded[0].shape == (b, cfg.num_classes),
              f"train-moe serve bucket {b}: {len(recorded)} serving-head calls")
        for k, v in launched.items():
            out["serve_launches"][k] += v
        with torch.no_grad(), mock.patch.object(fa, "flash_attention", fa.flash_attention_plain):
            want = model.eval()(torch.from_numpy(x).to(device)).float().cpu()
        check(kernels.launch_counts() == launched, "train-moe: the plain forward launched")
        d = (recorded[0] - want).abs().amax(dim=-1)
        step = torch.exp2(torch.floor(torch.log2(want.abs().amax(dim=-1))) - 7)
        check(bool((d <= step).all()), f"train-moe serve bucket {b}: engine logits {float(d.max())} from the plain "
              f"model's, over one bf16 step at the row's scale ({float(step[int((d - step).argmax())])})")
        want_p = torch.softmax(want, -1).numpy()
        dp = float(np.abs(got["probabilities"] - want_p).max())
        top2 = np.sort(want_p, -1)[:, -2:]
        apart = top2[:, 1] - top2[:, 0] > 2 * TOL_VIT_BF16
        check(dp <= TOL_VIT_BF16 and np.array_equal(got["class"][apart], want_p.argmax(-1)[apart]),
              f"train-moe serve bucket {b}: probabilities {dp} from the plain model's")
        check_classes(got["probabilities"], got["class"], f"train-moe serve bucket {b}")
        out["serve"][str(b)] = {"max_dlogit": float(d.max()), "max_dlogit_over_step": float((d / step).max()),
                                "max_dprobs": dp}
    out["serve_s"] = time.perf_counter() - t0
    log(f"train-moe: {MOE_PRESET} ({sum(p.numel() for p in model.parameters())} parameters, {cfg.dtype}, "
        f"{cfg.moe_experts} experts in every other of {cfg.vit_layers} blocks) exported from seeded weights and served "
        f"by the engine: " + "; ".join(
            f"bucket {b} max|dlogit| {v['max_dlogit']:.3g} against the plain model ({v['max_dlogit_over_step']:.3f} "
            f"of one bf16 step at the row's scale), max|dprobs| {v['max_dprobs']:.3g}" for b, v in out["serve"].items())
        + f"; {per['flash_attention_tc']} tensor-core attention launches per forward [{card}]")
    return out


def _moe_fit(torch, cfg, card: str, root: str, device: str, per, batch: int):
    """(b): fit_preset with every expert local, 2 steps then resumed to 4,
    every train step's and eval forward's launches counted."""
    import dataclasses

    from tensorflowdistributedlearning_tpu_torch import configs
    from tensorflowdistributedlearning_tpu_torch.ops import kernels
    from tensorflowdistributedlearning_tpu_torch.train import step as step_lib
    from tensorflowdistributedlearning_tpu_torch.train.fit import EVAL_SYNTHETIC_BATCHES, fit_preset

    on_card = device == "cuda"
    preset = configs.get_preset(MOE_PRESET)
    t0 = time.perf_counter()
    model_dir = os.path.join(root, "fit")
    ledger = LaunchLedger(kernels, step_lib)
    fit = {}
    with ledger.patch(), mock.patch.dict(configs.PRESETS, {MOE_PRESET: dataclasses.replace(preset, model=cfg)}):
        kernels.reset_launch_counts()
        for stop in (MOE_FIT_STOP, MOE_FIT_STEPS):
            r = fit_preset(MOE_PRESET, model_dir, steps=stop, batch_size=batch, device=device,
                           checkpoint_every_steps=MOE_FIT_STOP, train_log_every_steps=MOE_FIT_STOP)
            fit[str(stop)] = {"steps": r.steps, "final_metrics": r.final_metrics}
        if on_card:
            torch.cuda.synchronize()
        launches = kernels.launch_counts()
    fit_s = time.perf_counter() - t0
    check([f["steps"] for f in fit.values()] == [MOE_FIT_STOP, MOE_FIT_STEPS] and all(
        np.isfinite(v) for f in fit.values() for v in f["final_metrics"].values()), f"train-moe fit: {fit}")
    n_evals = 2 * EVAL_SYNTHETIC_BATCHES
    check(len(ledger.train) == MOE_FIT_STEPS and len(ledger.eval) == n_evals,
          f"train-moe fit: {len(ledger.train)} train steps and {len(ledger.eval)} eval forwards recorded")
    for i, delta in enumerate(ledger.train + ledger.eval):
        delta = {k: delta[k] for k in per}
        check(delta == per, f"train-moe fit step or eval forward {i}: launches {delta}, expected {per}")
    log(f"train-moe: fit_preset {MOE_PRESET}, every expert local, {MOE_FIT_STOP} steps then resumed to "
        f"{MOE_FIT_STEPS} at batch {batch}: {fit_s:.3f} s (evals, checkpoints and the restore included; the "
        f"expert-parallel ranks start meanwhile); each of the {MOE_FIT_STEPS} train steps and {n_evals} eval forwards "
        f"launched {per['flash_attention_tc']} tensor-core attention kernels; final "
        f"{json.dumps(fit[str(MOE_FIT_STEPS)]['final_metrics'])} [{card}]")
    return {"fit": fit, "fit_s": fit_s, "launches": launches}


def _moe_resident(torch, cfg, dense_cfg, card: str, device: str, batch: int, n_moe: int):
    """The step on a resident batch with every expert local, alone on the
    host: ms, idle share, peak memory, the first loss beside ViT-S/16's on
    the same batch, each MoE layer's balance and fractions at init."""
    import dataclasses

    from tensorflowdistributedlearning_tpu_torch import configs
    from tensorflowdistributedlearning_tpu_torch.data import pipeline as pipeline_lib
    from tensorflowdistributedlearning_tpu_torch.data.synthetic import synthetic_classification_batch
    from tensorflowdistributedlearning_tpu_torch.train import step as step_lib

    on_card = device == "cuda"
    t0 = time.perf_counter()
    dev = torch.device(device)
    fixed = pipeline_lib.to_device(synthetic_classification_batch(
        np.random.default_rng(SEED + 105), batch, cfg.input_shape, cfg.input_channels, cfg.num_classes), dev)
    tcfg = dataclasses.replace(configs.get_preset(MOE_PRESET).train, seed=SEED % 1000 + 105)
    task = step_lib.ClassificationTask(label_smoothing=tcfg.label_smoothing)
    dense = drawn_state(torch, dense_cfg, tcfg, dev, SEED + 106)
    _, m = step_lib.make_train_step(task, weight_decay=dense_cfg.weight_decay)(dense, fixed)
    dense_loss = step_lib.compute_metrics(m)["loss"]
    del dense
    state = drawn_state(torch, cfg, tcfg, dev, SEED + 107)
    balance = moe_balance(torch, state.model, fixed["images"])
    check(len(balance) == n_moe and all(MOE_BALANCE_MIN <= b["balance"] < cfg.moe_experts and
                                        abs(sum(b["fractions"]) - 1.0) <= 1e-4 for b in balance),
          f"train-moe: the MoE layers' balance values and fractions {balance}")
    step = step_lib.make_train_step(task, weight_decay=cfg.weight_decay)
    if on_card:
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
    losses, times = [], []
    for _ in range(MOE_TIMED_STEPS):
        t1 = time.perf_counter()
        _, metrics = step(state, fixed)
        losses.append(step_lib.compute_metrics(metrics)["loss"])  # the host copy waits for the step
        times.append(time.perf_counter() - t1)
    check(all(np.isfinite(losses)), f"train-moe: losses {losses}")
    ms = statistics.median(times[2:]) * 1e3
    out = {"step_ms": ms, "images_per_s": batch / ms * 1e3, "first_loss": losses[0], "dense_first_loss": dense_loss,
           "balance": balance}
    if on_card:
        out["peak_gb"] = torch.cuda.max_memory_allocated() / 1e9
        lines, stats = profile_steps(torch, step, state, fixed)
        for line in lines:
            log(f"profile train-moe: {line} [{card}]")
        if stats is not None:
            stats["idle_unprofiled"] = max(0.0, 1 - stats["device_ms"] / ms)
        out["profile"] = stats
    idle = out.get("profile") or {}
    log(f"train-moe: the step on a resident batch of {batch}, every expert local: {ms:.3f} ms (median of steps "
        f"3-{MOE_TIMED_STEPS}), {batch / ms * 1e3:.3f} images/s, device idle "
        f"{idle.get('idle_unprofiled', float('nan')):.3f} of the unprofiled step, peak memory "
        f"{out.get('peak_gb', float('nan')):.3f} GB; first loss {losses[0]:.5f} beside ViT-S/16's {dense_loss:.5f} on "
        f"the same batch [{card}]")
    log(f"train-moe: load balance E·Σf·P and dispatch fractions of the {n_moe} MoE layers (flax's collection order) "
        "at init: " + "; ".join(f"{b['balance']:.4f} {b['fractions']}" for b in balance))
    del state, fixed
    if on_card:
        torch.cuda.empty_cache()
    out["resident_s"] = time.perf_counter() - t0
    return out


def _moe_ep_checks(outs, cfg, card, device, per, ep, batch, n_moe, ranks_s):
    """(c)'s checks over the ranks' outputs, and its lines."""
    on_card = device == "cuda"
    what = f"train-moe expert_parallel {ep}"
    r0 = outs[0]
    for r, o in enumerate(outs):
        check(o["layout"] == [1, ep, 0, r, ep], f"{what} rank {r}: layout {o['layout']}")
        check(o["final_digest"] == r0["final_digest"],
              f"{what}: rank {r}'s state parts from rank 0's ({o['final_digest']} / {r0['final_digest']})")
        check(len(o["step_launches"]) == MOE_EP_HELD_STEPS and all(
            {k: d[k] for k in per} == per for d in o["step_launches"]),
              f"{what} rank {r}: step launches {o['step_launches']}, expected {per}")
    nbytes = moe_a2a_bytes(cfg, batch, ep)
    for r, o in enumerate(outs):
        calls, _, got = o["transfers"]["all_to_all"]
        check(calls == 4 * n_moe and got == 4 * n_moe * nbytes,
              f"{what} rank {r}: {calls} all-to-alls of {got} bytes, the shapes' count {4 * n_moe} of {nbytes}")
    for k, h in enumerate(r0["held"]):
        d = abs(h["loss"] - h["dense_loss"])
        check(np.isfinite(h["loss"]) and d <= bf16_spacing(h["dense_loss"]),
              f"{what} held step {k}: loss {h['loss']} against the one-card dense step's {h['dense_loss']}, over one "
              "bf16 step")
        check(h["worst_gradient"] <= 1.0, f"{what} held step {k}: gradient leaf {h['worst_leaf']} at "
              f"{h['worst_gradient']:.3f} of {TOL_MOE_GRAD}·max|leaf| from the one-card dense step's")
    a2a, red = r0["transfers"]["all_to_all"], r0["transfers"]["all_reduce"]
    out = {"ranks_s": ranks_s, "step_ms": r0["step_ms"], "step_ms_ranks": [o["step_ms"] for o in outs],
           "held": r0["held"], "all_to_all": {"calls": a2a[0], "mb": a2a[2] / 1e6, "ms": a2a[1] * 1e3},
           "all_reduce": {"calls": red[0], "mb": red[2] / 1e6, "ms": red[1] * 1e3},
           "peak_gb_rank0": r0.get("peak_gb"), "launches": r0["step_launches"][0],
           "setup_s": [round(o["setup_s"], 3) for o in outs]}
    log(f"train-moe: expert_parallel {ep} on {ep} gloo ranks sharing {device} (dp 1, each rank the whole global "
        f"batch {batch}): {MOE_EP_HELD_STEPS} steps held against the one-card dense step from the same state: losses "
        f"{[round(h['loss'], 6) for h in r0['held']]} vs {[round(h['dense_loss'], 6) for h in r0['held']]} (within "
        f"one bf16 step), worst gradient leaf {max(h['worst_gradient'] for h in r0['held']):.3f} of "
        f"{TOL_MOE_GRAD}·max|leaf|; the {ep} ranks' states equal after the steps [{card}]")
    log(f"train-moe: {r0['step_ms']:.3f} ms per expert-parallel step (rank 0, the last held step; ranks "
        f"{min(out['step_ms_ranks']):.3f}-{max(out['step_ms_ranks']):.3f}); one step's {a2a[0]} all-to-alls of "
        f"{nbytes / 1e6:.2f} MB ({ep} x {nbytes // ep // (2 if cfg.dtype == 'bfloat16' else 4) // cfg.embed_dim} x "
        f"{cfg.embed_dim} {cfg.dtype}) {a2a[2] / 1e6:.1f} MB in {a2a[1] * 1e3:.3f} ms and {red[0]} all-reduce(s) of "
        f"{red[2] / 1e6:.1f} MB in {red[1] * 1e3:.3f} ms (host-staged, the card synchronized around each); peak "
        f"memory of rank 0 {r0.get('peak_gb', float('nan')):.3f} GB; {per['flash_attention_tc']} tensor-core "
        f"attention launches per step on every rank; each rank's set-up (group, state) {min(out['setup_s']):.1f}-"
        f"{max(out['setup_s']):.1f} s [{card}]")
    return out


# sequence parallelism: the full-width segmenter and ViT-S/16 H-sharded over
# two gloo ranks sharing the card (dp 1, sp 2), and ring attention alone
SP_DEGREE = 2
SP_SIZE = 112  # the smallest height >= tgs_salt's 101 that degree 2 admits (output_stride 8 x 2)
SP_BATCH = 64
SP_IMAGES = 128  # 2 folds: 64 train and 64 eval ids each
SP_TEST_IMAGES = 64
SP_FOLDS = 2
SP_STEPS = 2  # per fold, one checkpoint and one eval at the end (cut from 3)
SP_TIMED_REPS = 2  # sharded and one-rank steps timed alone, after a warm-up (cut from 3, PERF.md §4)
SP_WITNESS_FACTOR = 4  # the plain one-rank step's gradient gap against the one-ulp witness's
SP_VIT_FIT_STEPS = 2
SP_RING_SHAPE = (64, 196, 6, 64)  # ViT-S/16's attention at batch 64: [B, S, H, D]
SP_TIMEOUT_S = 300
TOL_RING_F32 = 1e-5


@contextlib.contextmanager
def timed_sequence_collectives(torch, collectives):
    """For the duration, every collective of the sequence axis is timed with
    the card synchronized around it: the shifts (halo rows, ring
    rotations), the row gathers and their backward's sums, and every
    all-reduce over a group (BatchNorm moments, the gradient mean); yields
    ``{kind: [calls, seconds, bytes]}`` (bytes received, landed or
    reduced)."""
    rec = {"shift": [0, 0.0, 0], "gather": [0, 0.0, 0], "scatter": [0, 0.0, 0], "allreduce": [0, 0.0, 0]}
    real = {"_p2p": collectives._p2p, "_gather_dim": collectives._gather_dim,
            "_sum_own_block": collectives._sum_own_block, "pmean_": collectives.pmean_}

    def timed(kind, fn, nbytes):
        if torch.cuda.is_available():
            torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = fn()
        if torch.cuda.is_available():
            torch.cuda.synchronize()
        r = rec[kind]
        r[0], r[1], r[2] = r[0] + 1, r[1] + time.perf_counter() - t0, r[2] + nbytes(out)
        return out

    def size(t):
        return 0 if t is None else t.numel() * t.element_size()

    def p2p(x, dst, src, group):
        return timed("shift", lambda: real["_p2p"](x, dst, src, group), size)

    def gather_dim(x, group, dim):
        return timed("gather", lambda: real["_gather_dim"](x, group, dim), size)

    def sum_own_block(x, group, dim):
        return timed("scatter", lambda: real["_sum_own_block"](x, group, dim), lambda _: size(x))

    def pmean(tensors, group=None):
        ts = [tensors] if isinstance(tensors, torch.Tensor) else list(tensors)
        return timed("allreduce", lambda: real["pmean_"](tensors, group), lambda _: sum(size(t) for t in ts))

    with mock.patch.multiple(collectives, _p2p=p2p, _gather_dim=gather_dim, _sum_own_block=sum_own_block,
                             pmean_=pmean):
        yield rec


@contextlib.contextmanager
def record_conv_paths(torch, model):
    """For the duration, the first call of each H-sharded k x k conv of
    ``model`` records ``(name, H_local, rate, stride, path)``: ``halo`` or
    ``gather`` (``spatial.uses_gather``)."""
    from tensorflowdistributedlearning_tpu_torch.models.layers import Conv2dSame
    from tensorflowdistributedlearning_tpu_torch.parallel import spatial

    seen, hooks = {}, []
    for name, m in model.named_modules():
        if isinstance(m, Conv2dSame) and m.spatial and m.kernel_size[0] > 1:
            def hook(mod, args, name=name):
                if name not in seen:
                    h, k, rate = args[0].shape[1], mod.kernel_size[0], mod.dilation[0]
                    seen[name] = (name, h, rate, mod.stride[0], "gather" if spatial.uses_gather(h, k, rate) else "halo")
            hooks.append(m.register_forward_pre_hook(hook))
    try:
        yield seen
    finally:
        for h in hooks:
            h.remove()


@contextlib.contextmanager
def split_row_blocks(torch, model, sp: int):
    """For the duration, the plain (one-rank) segmenter ``model`` computes
    its backbone as the ``sp`` ranks of the sequence-parallel step compute
    it, with its own geometry (nothing of ``parallel/spatial.py``): every
    k x k convolution pads the whole input as the plain layer does (flax's
    SAME: total ``max((ceil(H/s) - 1)·s + ek - H, 0)`` for the dilated
    extent ``ek``, the low side ``total // 2``; slim's ``fixed_padding``,
    total ``ek - 1``, for a strided depthwise), then computes each row
    block's output rows from the padded rows they read, ``[i·r·s, i·r·s +
    (r - 1)·s + ek)`` for ``r`` output rows a block, as one ``F.conv2d`` of
    the shape a rank's halo exchange gives it; where the halo ``(ek - 1) //
    2`` exceeds the block a rank gathers the rows, so the whole padded
    input is convolved and each block's rows kept. A 1 x 1 conv runs block
    by block; every BatchNorm's moments are the mean of the blocks'
    moments; the blocks are then put together. The forward is then the
    ranks' to the bit (elementwise ops and the max pool are exact block by
    block), and only the backward's sums over the rows are grouped
    otherwise: what the sequence-parallel step is held against (as
    :func:`split_channel_blocks` holds the tensor-parallel step)."""
    import torch.nn.functional as F

    from tensorflowdistributedlearning_tpu_torch.models.layers import BatchNorm, Conv2dSame
    from tensorflowdistributedlearning_tpu_torch.models.xception import DepthwiseConvSame

    def pads(n, ek, stride, fixed):
        total = ek - 1 if fixed else max((-(-n // stride) - 1) * stride + ek - n, 0)
        return total // 2, total - total // 2

    def conv_blocks(mod, x):
        k = mod.kernel_size[0]
        h = x.shape[1] // sp
        if k == 1:
            blocks = [x.narrow(1, s * h, h).contiguous() for s in range(sp)]
            return torch.cat([Conv2dSame._forward(mod, b) for b in blocks], dim=1)
        dt = mod.compute_dtype
        w, stride, rate = mod.weight.to(dt), mod.stride[0], mod.dilation[0]
        ek = (k - 1) * rate + 1
        fixed = isinstance(mod, DepthwiseConvSame) and stride > 1
        ph, pw = pads(x.shape[1], ek, stride, fixed), pads(x.shape[2], ek, stride, fixed)
        padded = F.pad(x.float() if dt == torch.float32 else x.to(dt), (0, 0, pw[0], pw[1], ph[0], ph[1]))

        def conv(t):
            return F.conv2d(t.permute(0, 3, 1, 2), w, None, stride=stride, dilation=rate,
                            groups=mod.groups).permute(0, 2, 3, 1)

        rows = h // stride
        if (ek - 1) // 2 > h:
            whole = conv(padded)
            outs = [whole.narrow(1, s * rows, rows).contiguous() for s in range(sp)]
        else:
            outs = [conv(padded.narrow(1, s * rows * stride, (rows - 1) * stride + ek).contiguous())
                    for s in range(sp)]
        y = torch.cat(outs, dim=1)
        return y if mod.bias is None else y + mod.bias.to(dt)

    def moments(xf):
        h = xf.shape[1] // sp
        total = None
        for s in range(sp):
            b = xf.narrow(1, s * h, h).contiguous()
            st = torch.stack([b.mean(dim=(0, 1, 2)), (b * b).mean(dim=(0, 1, 2))])
            total = st if total is None else total + st
        total = total.div_(float(sp))
        return total[0], total[1]

    patched = []
    for m in model.backbone.modules():
        if isinstance(m, Conv2dSame):
            m._forward = lambda x, mod=m: conv_blocks(mod, x)
            patched.append((m, "_forward"))
        elif isinstance(m, BatchNorm):
            m._moments = moments
            patched.append((m, "_moments"))
    try:
        yield
    finally:
        for m, attr in patched:
            delattr(m, attr)


def rep_ms(torch, fn, reps: int, warmup: int = 0):
    """``[median, min, max]`` of ``reps`` host wall times of ``fn`` (ms)
    after ``warmup`` untimed calls, the device synchronized around each."""
    times = [host_ms(torch, fn, reps=1, warmup=0) for _ in range(warmup + reps)][warmup:]
    return [statistics.median(times), min(times), max(times)]


def gradient_gap(torch, want, got) -> dict:
    """How far the gradient ``got`` lies from ``want``: the worst leaf's
    max|err| as a share of 1e-4·max|want_leaf| + 1e-6 (the train-step
    bound) and its name, the leaves beyond that bound, and the relative
    norm ||got - want|| / ||want|| over every leaf."""
    worst, name, beyond, num, den = 0.0, None, 0, 0.0, 0.0
    for n, w in want.items():
        d = got[n] - w
        share = d.abs().max().item() / (1e-4 * w.abs().max().item() + 1e-6)
        beyond += share > 1.0
        if share > worst:
            worst, name = share, n
        num += float(d.double().square().sum())
        den += float(w.double().square().sum())
    return {"worst_gradient": worst, "worst_leaf": name, "beyond": int(beyond), "leaves": len(want),
            "rel_norm": math.sqrt(num / den) if den else 0.0}


def sp_peak(torch, fn):
    """``fn()`` and this process's peak device memory during it (GB; nan on
    the CPU)."""
    if not torch.cuda.is_available():
        return fn(), float("nan")
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    out = fn()
    torch.cuda.synchronize()
    return out, torch.cuda.max_memory_allocated() / 1e9


def sp_segmenter(torch, rank: int, root: str, dev, seg_kwargs, size: int, batch: int) -> dict:
    """(a)'s held step, timings and collectives, then the main path:
    Trainer.train and Trainer.predict at sequence_parallel 2."""
    import dataclasses

    from tensorflowdistributedlearning_tpu_torch.config import ModelConfig, TrainConfig
    from tensorflowdistributedlearning_tpu_torch.models import build_model
    from tensorflowdistributedlearning_tpu_torch.ops import kernels
    from tensorflowdistributedlearning_tpu_torch.parallel import collectives, multihost
    from tensorflowdistributedlearning_tpu_torch.train import step as step_lib
    from tensorflowdistributedlearning_tpu_torch.train.state import create_train_state
    from tensorflowdistributedlearning_tpu_torch.train.trainer import Trainer

    on_card = dev.type == "cuda"
    data = os.path.join(root, "data")
    ids = sorted(f[:-4] for f in os.listdir(os.path.join(data, "images")))
    cfg = ModelConfig(input_shape=(size, size), **seg_kwargs)
    task = smooth_task()
    fixed = dp_batches(torch, data, ids, batch, 1, dev)[0]
    # one seeded draw on the card, the same on both ranks
    with torch.device(dev):
        init = build_model(cfg, dev, generator=torch.Generator(dev).manual_seed(SEED + 81)).state_dict()
    tcfg = TrainConfig(seed=SEED % 1000 + 81)
    state = create_train_state(cfg, dataclasses.replace(tcfg, sequence_parallel=SP_DEGREE), dev, state_dict=init)
    step = step_lib.make_train_step(task, data_parallel=True)
    out = {"n_params": sum(p.numel() for p in state.model.parameters())}
    # one held step: the sharded step against the one-rank step from the same
    # state and batch (rank 0 runs both)
    with deterministic_algorithms(torch), record_conv_paths(torch, state.model) as paths:
        (_, metrics), out["peak_gb"] = sp_peak(torch, lambda: step(state, fixed))
    out["paths"] = list(paths.values())
    loss = step_lib.compute_metrics(metrics)["loss"]
    grads = {n: p.grad.detach().clone() for n, p in state.model.named_parameters()}
    stats = {n: b.detach().clone() for n, b in state.model.named_buffers()}
    one = single = None
    if rank == 0:
        # the one-rank step from the same state, computed the ranks' way
        # (split_row_blocks: their forward to the bit) and plainly, and a
        # witness: the plain step on images one float32 ulp above. The plain
        # step's gradient is read against the tolerance, not held: at full
        # width a rounding-level change takes ReLU or max-pool kinks the
        # other way and moves the stem's gradient by percents (ROADMAP queue
        # C); the witness measures how far rounding alone moves it
        one = create_train_state(cfg, tcfg, dev, state_dict=init)
        single = step_lib.make_train_step(task)
        nudged = dict(fixed, images=torch.nextafter(fixed["images"], torch.full_like(fixed["images"], math.inf)))
        held, plain_g = {}, None
        for what in ("split", "plain", "witness"):
            one.model.load_state_dict(init)
            with deterministic_algorithms(torch), \
                    split_row_blocks(torch, one.model, SP_DEGREE) if what == "split" else contextlib.nullcontext():
                (_, m1), peak = sp_peak(torch, lambda: single(one, nudged if what == "witness" else fixed))
            want_loss = step_lib.compute_metrics(m1)["loss"]
            want_g = {n: p.grad.detach().clone() for n, p in one.model.named_parameters()}
            if what == "witness":
                # the nudged plain step against the plain step
                held[what] = gradient_gap(torch, plain_g, want_g) | {"d_loss": abs(want_loss - held_loss)}
                continue
            d_loss = abs(loss - want_loss)
            d_stats = max((stats[n] - b).abs().max().item() for n, b in one.model.named_buffers())
            check(d_loss <= TOL_LOSS and d_stats <= 1e-5,
                  f"train-sp held step vs the {what} one-rank step: loss {loss} vs {want_loss}, BN statistics "
                  f"{d_stats} apart")
            held[what] = gradient_gap(torch, want_g, grads) | {"d_loss": d_loss, "d_stats": d_stats}
            if what == "split":
                worst_gradient(want_g, grads, "train-sp held step vs the one-rank step on the ranks' blocks")
            else:
                out["one_rank_peak_gb"], plain_g, held_loss = peak, want_g, want_loss
        out["held"] = dict(held, loss=loss)
        # the plain step's gap is rounding's: within SP_WITNESS_FACTOR of
        # how far one ulp of input moves the plain gradient (a wrong halo,
        # gather or backward sum moves it by the gradient's own size)
        check(held["plain"]["rel_norm"] <= SP_WITNESS_FACTOR * held["witness"]["rel_norm"],
              f"train-sp held step vs the plain one-rank step: ||dg||/||g|| {held['plain']['rel_norm']:.3g}, more "
              f"than {SP_WITNESS_FACTOR}x the witness's {held['witness']['rel_norm']:.3g}")
        del plain_g, want_g, nudged
    del init, grads, stats
    # the step with its collectives timed (the card synchronized around
    # each; also the default algorithms' warm-up), then SP_TIMED_REPS steps
    # timed alone; the ranks enter each together. Then the one-rank step
    # alone, a warm-up and SP_TIMED_REPS
    multihost.barrier()
    with timed_sequence_collectives(torch, collectives) as rec:
        step(state, fixed)
    out["collectives"] = rec
    multihost.barrier()
    out["step_ms"] = rep_ms(torch, lambda: step(state, fixed), SP_TIMED_REPS)
    if one is not None:
        out["one_rank_ms"] = rep_ms(torch, lambda: single(one, fixed), SP_TIMED_REPS, warmup=1)
    multihost.barrier()
    del state, one, fixed
    if on_card:
        torch.cuda.empty_cache()

    # the main path: Trainer.train, then Trainer.predict; counts from 0 just
    # before each, read just after
    tcfg = TrainConfig(n_folds=SP_FOLDS, seed=SEED % 1000 + 82, checkpoint_every_steps=SP_STEPS, save_best=1,
                       eval_throttle_secs=0, n_devices=SP_DEGREE, sequence_parallel=SP_DEGREE)
    trainer = Trainer(os.path.join(root, "model-sp"), data, train_config=tcfg, device=dev, input_shape=(size, size),
                      **seg_kwargs)
    ledger = LaunchLedger(kernels, step_lib, Trainer)
    with ledger.patch():
        with record_kernel_calls(torch, RANK_HELD) as recorded:
            kernels.reset_launch_counts()
            t0 = time.perf_counter()
            out["metrics"] = trainer.train(ids, batch_size=batch, steps=SP_STEPS)
            if on_card:
                torch.cuda.synchronize()
            out["train_s"] = time.perf_counter() - t0
            out["launches"] = kernels.launch_counts()
        if on_card:  # on the CPU the plain versions ran: nothing to hold
            # the first train step's depthwise calls (the head, on gathered
            # whole maps) and the first eval forward's BN calls (the
            # backbone's on this rank's row blocks, the head's whole)
            out["held_calls"] = hold_rank_calls(torch, recorded, batch)
        del recorded
        kernels.reset_launch_counts()
        t0 = time.perf_counter()
        pred = trainer.predict(os.path.join(root, "test"), batch_size=batch)
        out["predict_s"] = time.perf_counter() - t0
        out["predict_launches"] = kernels.launch_counts()
    out["ledger_train"], out["ledger_eval"], out["ledger_predict"] = ledger.train, ledger.eval, ledger.predict
    np.save(os.path.join(root, f"sp-predict-rank{rank}.npy"), pred["probabilities"])
    out["predict_ids"] = pred["ids"]
    return out


def sp_vit(torch, rank: int, root: str, dev, overrides, batch: int) -> dict:
    """(b): ViT-S/16's step at sequence_parallel 2 held against the
    one-card plain step (rank 0), its ms and ring rotations, then
    fit_preset 2 steps with the launches counted."""
    import dataclasses

    from tensorflowdistributedlearning_tpu_torch import configs
    from tensorflowdistributedlearning_tpu_torch.data import pipeline as pipeline_lib
    from tensorflowdistributedlearning_tpu_torch.data.synthetic import synthetic_classification_batch
    from tensorflowdistributedlearning_tpu_torch.ops import kernels
    from tensorflowdistributedlearning_tpu_torch.parallel import collectives, multihost
    from tensorflowdistributedlearning_tpu_torch.train import step as step_lib
    from tensorflowdistributedlearning_tpu_torch.train.fit import fit_preset
    from tensorflowdistributedlearning_tpu_torch.train.state import create_train_state

    on_card = dev.type == "cuda"
    preset = configs.get_preset(VIT_PRESET)
    cfg = dataclasses.replace(preset.model, **(overrides or {}))
    tcfg = dataclasses.replace(preset.train, seed=SEED % 1000 + 83)
    fixed = pipeline_lib.to_device(synthetic_classification_batch(
        np.random.default_rng(SEED + 83), batch, cfg.input_shape, cfg.input_channels, cfg.num_classes), dev)
    task = step_lib.ClassificationTask(label_smoothing=tcfg.label_smoothing)
    init = drawn_state(torch, cfg, tcfg, dev, SEED + 84).model.state_dict()
    state = create_train_state(cfg, dataclasses.replace(tcfg, sequence_parallel=SP_DEGREE), dev, state_dict=init)
    step = step_lib.make_train_step(task, data_parallel=True, weight_decay=cfg.weight_decay)
    (_, metrics), peak = sp_peak(torch, lambda: step(state, fixed))
    out = {"peak_gb": peak, "n_params": sum(p.numel() for p in state.model.parameters())}
    loss = step_lib.compute_metrics(metrics)["loss"]
    grads = {n: p.grad.detach().clone() for n, p in state.model.named_parameters()}
    one = single = None
    if rank == 0:
        one = create_train_state(cfg, tcfg, dev, state_dict=init)
        single = step_lib.make_train_step(task, weight_decay=cfg.weight_decay)
        (_, m1), out["one_rank_peak_gb"] = sp_peak(torch, lambda: single(one, fixed))
        want_loss = step_lib.compute_metrics(m1)["loss"]
        worst = max(float((grads[n] - p.grad).abs().max()) / (TOL_MOE_GRAD * float(p.grad.abs().max()) + 1e-12)
                    for n, p in one.model.named_parameters())
        check(np.isfinite(loss) and abs(loss - want_loss) <= bf16_spacing(want_loss) and worst <= 1.0,
              f"train-sp ViT-S/16 held step vs the one-card step: loss {loss} vs {want_loss}, worst gradient leaf at "
              f"{worst:.3f} of {TOL_MOE_GRAD}·max|leaf|")
        out["held"] = {"loss": loss, "one_card_loss": want_loss, "worst_gradient": worst}
    del init, grads
    # timed as the segmenter's step is
    multihost.barrier()
    with timed_sequence_collectives(torch, collectives) as rec:
        step(state, fixed)
    out["collectives"] = rec
    multihost.barrier()
    out["step_ms"] = rep_ms(torch, lambda: step(state, fixed), SP_TIMED_REPS)
    if one is not None:
        out["one_rank_ms"] = rep_ms(torch, lambda: single(one, fixed), SP_TIMED_REPS, warmup=1)
    multihost.barrier()
    del state, one, fixed
    if on_card:
        torch.cuda.empty_cache()

    # the main path: fit_preset, counts from 0 just before, read just after
    with mock.patch.dict(configs.PRESETS, {VIT_PRESET: dataclasses.replace(preset, model=cfg)}):
        kernels.reset_launch_counts()
        t0 = time.perf_counter()
        r = fit_preset(VIT_PRESET, os.path.join(root, "fit-vit-sp"), steps=SP_VIT_FIT_STEPS, batch_size=batch,
                       device=dev, sequence_parallel=SP_DEGREE, seed=tcfg.seed, train_log_every_steps=1)
        if on_card:
            torch.cuda.synchronize()
        out["fit_s"] = time.perf_counter() - t0
        out["fit_launches"] = kernels.launch_counts()
    out["fit"] = {"steps": r.steps, "final_metrics": r.final_metrics}
    return out


def sp_ring(torch, rank: int, dev, shape) -> dict:
    """(c): ring attention alone on this rank's block of seeded global Q/K/V
    against ``attention_reference`` of the whole on the card, float32 and
    bf16, timed beside the reference."""
    from tensorflowdistributedlearning_tpu_torch.parallel import multihost
    from tensorflowdistributedlearning_tpu_torch.parallel.ring_attention import attention_reference, ring_attention

    out = {}
    g = torch.Generator(dev).manual_seed(SEED + 85)
    q, k, v = (torch.randn(shape, generator=g, device=dev) for _ in range(3))
    blk = shape[1] // SP_DEGREE

    def local(t):
        return t[:, rank * blk:(rank + 1) * blk].contiguous()

    for name, dtype in (("float32", torch.float32), ("bfloat16", torch.bfloat16)):
        qd, kd, vd = (t.to(dtype) for t in (q, k, v))
        got = ring_attention(local(qd), local(kd), local(vd))
        want = attention_reference(qd, kd, vd)[:, rank * blk:(rank + 1) * blk]
        err = (got.float() - want.float()).abs().max().item()
        if dtype == torch.float32:
            check(got.dtype == dtype and err <= TOL_RING_F32, f"train-sp ring attention {name}: max|err| {err}")
        else:
            check_bf16_step(torch, got, want, attention_atol(vd.float()), f"train-sp ring attention {name}")
        multihost.barrier()
        # one timed call each: the checked calls were the warm-up
        ring_ms = host_ms(torch, lambda: ring_attention(local(qd), local(kd), local(vd)), reps=1, warmup=0)
        ref_ms = host_ms(torch, lambda: attention_reference(qd, kd, vd), reps=1, warmup=0)
        out[name] = {"max_abs_err": err, "ms": ring_ms, "reference_ms": ref_ms}
    return out


def sp_rank(torch, rank: int, world: int, store: str, root: str, device: str, params) -> dict:
    """One rank of ``train-sp`` at (dp, sp) = (1, 2): (a) the segmenter,
    (b) ViT-S/16, (c) ring attention alone."""
    from tensorflowdistributedlearning_tpu_torch.parallel import mesh, multihost

    dev = torch.device(device if device == "cpu" else "cuda:0")
    multihost.initialize(store, world, rank, backend="gloo", timeout=300)
    out = {"rank": rank}
    try:
        if dev.type == "cuda":
            torch.cuda.set_device(0)
            torch.backends.cudnn.allow_tf32 = False
            torch.backends.cuda.matmul.allow_tf32 = False
        lay = mesh.init_mesh(SP_DEGREE, sequence=True)
        out["layout"] = [lay.dp, lay.tp, lay.data_index, mesh.sequence_index()]
        seg_kwargs = dict(params["seg"])
        if "n_blocks" in seg_kwargs:
            seg_kwargs["n_blocks"] = tuple(seg_kwargs["n_blocks"])
        t0 = time.perf_counter()
        out["seg"] = sp_segmenter(torch, rank, root, dev, seg_kwargs, params["size"], params["batch"])
        t1 = time.perf_counter()
        out["vit"] = sp_vit(torch, rank, root, dev, params.get("vit"), params["vit_batch"])
        t2 = time.perf_counter()
        out["ring"] = sp_ring(torch, rank, dev, tuple(params["ring_shape"]))
        out["laps_s"] = [t1 - t0, t2 - t1, time.perf_counter() - t2]
        multihost.barrier()
    finally:
        multihost.shutdown()
    return out


def sp_rank_main(argv) -> int:
    """``chip_smoke.py sp-rank RANK WORLD STORE ROOT DEVICE PARAMS``: one
    rank of ``train-sp`` (PARAMS as JSON); writes
    ``ROOT/sp{WORLD}-rank{RANK}.json``."""
    import torch

    rank, world, store, root, device = int(argv[0]), int(argv[1]), argv[2], argv[3], argv[4]
    try:
        out = sp_rank(torch, rank, world, store, root, device, json.loads(argv[5]))
    except SmokeFailure as e:
        print(f"FAIL: {e}", file=sys.stderr)
        return 1
    with open(os.path.join(root, f"sp{world}-rank{rank}.json"), "w") as f:
        json.dump(out, f)
    return 0


def sp_collective_line(rec) -> str:
    parts = []
    for kind, label in (("shift", "shifts"), ("gather", "row gathers"), ("scatter", "gathers' backward sums"),
                        ("allreduce", "all-reduces")):
        calls, secs, nbytes = rec[kind]
        parts.append(f"{calls} {label} {nbytes / 1e6:.2f} MB in {secs * 1e3:.3f} ms")
    return ", ".join(parts)


def train_sp_phase(torch, card: str, device: str = "cuda", seg_kwargs=None, vit_overrides=None, size: int = SP_SIZE,
                   batch: int = SP_BATCH, vit_batch: int = SP_BATCH, n_images: int = SP_IMAGES,
                   n_test: int = SP_TEST_IMAGES, ring_shape=SP_RING_SHAPE):
    """Sequence parallelism (sequence_parallel 2, dp 1) on two gloo ranks
    sharing the card (``chip_smoke.py sp-rank ...``): (a) tgs_salt at full
    width and depth on 112 x 112 (the one cut: 101 does not divide by
    output_stride 8 x 2): one step held against the one-rank step, Trainer.train
    2 folds x 2 steps with a checkpoint and an eval, Trainer.predict held
    against this process's plain predict of the same checkpoints; (b)
    ViT-S/16 at full width: one step held against the one-card step,
    fit_preset 2 steps; (c) ring attention alone at [64, 196, 6, 64].
    ``seg_kwargs``, ``vit_overrides`` and ``device="cpu"`` rehearse it
    small."""
    from tensorflowdistributedlearning_tpu_torch import configs
    from tensorflowdistributedlearning_tpu_torch.config import TrainConfig
    from tensorflowdistributedlearning_tpu_torch.ops import kernels
    from tensorflowdistributedlearning_tpu_torch.train import step as step_lib
    from tensorflowdistributedlearning_tpu_torch.train.trainer import Trainer

    on_card = device == "cuda"
    tgs = configs.get_preset("tgs_salt").model
    seg_kwargs = dict(seg_kwargs or {k: getattr(tgs, k) for k in ("n_blocks", "base_depth", "width_multiplier",
                                                                   "output_stride")}, use_pallas_depthwise=True)
    params = {"seg": seg_kwargs, "size": size, "batch": batch, "vit": vit_overrides, "vit_batch": vit_batch,
              "ring_shape": list(ring_shape)}
    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory(prefix="chip-smoke-sp-") as root:
        write_salt_dataset(os.path.join(root, "data"), n_images, size, SEED + 86)
        write_salt_dataset(os.path.join(root, "test"), n_test, size, SEED + 87)
        shutil.rmtree(os.path.join(root, "test", "masks"))
        store = f"file://{os.path.join(root, 'store')}"
        procs, logs = [], []
        try:
            for rank in range(SP_DEGREE):
                logs.append(open(os.path.join(root, f"sp{SP_DEGREE}-rank{rank}.log"), "w"))
                procs.append(subprocess.Popen(
                    [sys.executable, os.path.abspath(__file__), "sp-rank", str(rank), str(SP_DEGREE), store, root,
                     device, json.dumps(params)],
                    stdout=logs[-1], stderr=subprocess.STDOUT,
                ))
            outs = tp_finish(root, SP_DEGREE, procs, logs, t0 + SP_TIMEOUT_S, prefix="sp")
        finally:
            for p in procs:
                if p.poll() is None:
                    p.kill()
                    p.wait()
            for f in logs:
                f.close()
        t1 = time.perf_counter()
        # the same checkpoints' plain predict in this process
        tcfg = TrainConfig(n_folds=SP_FOLDS, seed=SEED % 1000 + 82)
        plain = Trainer(os.path.join(root, "model-sp"), os.path.join(root, "data"), train_config=tcfg,
                        device=trainer_device(torch, device), input_shape=(size, size), **seg_kwargs)
        whole = plain.predict(os.path.join(root, "test"), batch_size=batch)
        sharded = [np.load(os.path.join(root, f"sp-predict-rank{r}.npy")) for r in range(SP_DEGREE)]
    per_step = PER_TRAIN_STEP if on_card else {k: 0 for k in PER_TRAIN_STEP}
    per_eval = PER_EVAL_FORWARD if on_card else {k: 0 for k in PER_EVAL_FORWARD}
    r0 = outs[0]
    seg, vit = r0["seg"], r0["vit"]
    for o in outs:
        what = f"train-sp rank {o['rank']}"
        check(o["layout"] == [1, SP_DEGREE, 0, o["rank"]], f"{what}: layout {o['layout']}")
        s = o["seg"]
        check(s["metrics"] == seg["metrics"] and all(np.isfinite(v) for m in s["metrics"] for v in m.values()),
              f"{what}: metrics {s['metrics']} vs rank 0's {seg['metrics']}")
        check(len(s["ledger_train"]) == SP_FOLDS * SP_STEPS and all(d == per_step for d in s["ledger_train"]),
              f"{what}: train step launches {s['ledger_train']}, expected {per_step} each")
        check(len(s["ledger_eval"]) >= SP_FOLDS and all(d == per_eval for d in s["ledger_eval"]),
              f"{what}: eval forward launches {s['ledger_eval']}, expected {per_eval} each")
        want = {k: per_step[k] * len(s["ledger_train"]) + per_eval[k] * len(s["ledger_eval"]) for k in s["launches"]}
        check(s["launches"] == want, f"{what}: Trainer.train launches {s['launches']}, expected {want}")
        n_pred = len(s["ledger_predict"])
        check(n_pred == SP_FOLDS * 4 * -(-n_test // batch) and all(d == per_eval for d in s["ledger_predict"]),
              f"{what}: {n_pred} predict forwards launched {s['ledger_predict']}")
        check(s["predict_ids"] == whole["ids"], f"{what}: predict ids")
        check(any(p[-1] == "gather" for p in s["paths"]) and any(p[-1] == "halo" for p in s["paths"]),
              f"{what}: conv paths {s['paths']}")
        check(o["vit"]["fit"] == vit["fit"] and o["vit"]["fit"]["steps"] == SP_VIT_FIT_STEPS
              and all(np.isfinite(v) for v in o["vit"]["fit"]["final_metrics"].values()),
              f"{what}: fit {o['vit']['fit']} vs rank 0's {vit['fit']}")
        check(all(v == 0 for v in o["vit"]["fit_launches"].values()),
              f"{what}: the H-sharded ViT launched {o['vit']['fit_launches']} (ring attention is plain tensor ops)")
    pred_err = max(float(np.abs(p - whole["probabilities"]).max()) for p in sharded)
    check(pred_err <= TOL_PROBS, f"train-sp: Trainer.predict on the ranks vs the plain predict of the same "
                                 f"checkpoints: max|err| {pred_err}")
    launches = {k: sum(o["seg"]["launches"][k] + o["seg"]["predict_launches"][k] + o["vit"]["fit_launches"][k]
                       for o in outs[:1]) for k in seg["launches"]}
    halo = [p for p in seg["paths"] if p[-1] == "halo"]

    def peaks(part):
        return ", ".join(format(o[part]["peak_gb"], ".3f") for o in outs)

    gathered = [p for p in seg["paths"] if p[-1] == "gather"]
    log(f"train-sp: the segmenter's {len(seg['paths'])} H-sharded k x k convs at {size}x{size} over {SP_DEGREE} "
        f"ranks: {len(halo)} take the halo exchange, {len(gathered)} the all-gather fallback (where the halo, the rate, exceeds H_local): "
        + "; ".join(f"{n} H_local {h} rate {r} stride {s} {p}" for n, h, r, s, p in seg["paths"]))
    h = seg["held"]
    hs, hp, hw = h["split"], h["plain"], h["witness"]

    def timed(ms):
        return f"{ms[0]:.3f} ms (median of {SP_TIMED_REPS}, {ms[1]:.3f}-{ms[2]:.3f})"

    def gap(g):
        return (f"worst gradient leaf at {g['worst_gradient']:.3f} of the tolerance ({g['worst_leaf']}), "
                f"{g['beyond']} of {g['leaves']} leaves beyond it, ||dg||/||g|| {g['rel_norm']:.3g}")

    log(f"train-sp: tgs_salt ({seg['n_params']} parameters, float32, {size}x{size}x2) on {SP_DEGREE} gloo ranks "
        f"sharing {device} at sequence_parallel {SP_DEGREE}, batch {batch}: one step from the same state under "
        f"deterministic algorithms against the one-rank step computed on the ranks' row blocks (split_row_blocks, "
        f"its own geometry): |dloss| {hs['d_loss']:.3g}, BN statistics {hs['d_stats']:.3g} apart, "
        f"{gap(hs)} (held: every leaf within 1e-4·max|leaf| + 1e-6); against the plain one-rank step |dloss| "
        f"{hp['d_loss']:.3g}, BN statistics {hp['d_stats']:.3g} (held), {gap(hp)} (held: ||dg||/||g|| within "
        f"{SP_WITNESS_FACTOR}x the witness's); the witness, the "
        f"plain step on images one float32 ulp above against the plain step: |dloss| {hw['d_loss']:.3g}, {gap(hw)} "
        f"[{card}]")
    log(f"train-sp: the segmenter's step {timed(seg['step_ms'])} on rank 0 (rank 1 {timed(outs[-1]['seg']['step_ms'])}), "
        f"the one-rank step {timed(seg['one_rank_ms'])}; peak memory per rank {peaks('seg')} GB, the one-rank "
        f"step's {seg['one_rank_peak_gb']:.3f} GB [{card}]")
    held_err = {}
    for o in outs if on_card else ():
        hc = o["seg"]["held_calls"]
        log(f"train-sp rank {o['rank']}: its Trainer.train's first step's {RANK_HELD['depthwise_conv2d_forward']} "
            f"depthwise forward, dx and dw calls on the head's gathered maps {hc['shapes']} and its first eval "
            f"forward's {RANK_HELD['bn_act_folded']} fused_bn_act calls (the backbone's on its row blocks, the "
            f"head's whole) held against the plain versions: forward max|err| {hc['depthwise_conv2d']:.3g}, dx "
            f"{hc['depthwise_conv2d_dx']:.3g}, dw {hc['depthwise_conv2d_dw']:.3g}, BN {hc['fused_bn_act']:.3g} "
            f"(forward, dx and BN bitwise the earlier kernels, dw bitwise a relaunch)")
        for plan in hc["dw_plans"]:
            log(f"train-sp rank {o['rank']}: dw {plan}")
        for name in ("depthwise_conv2d", "depthwise_conv2d_dx", "depthwise_conv2d_dw", "fused_bn_act"):
            held_err[name] = max(held_err.get(name, 0.0), hc[name])
    log(f"train-sp: the segmenter step's collectives on rank 0, a step of its own before the timed ones (host-staged, the card synchronized around each): "
        f"{sp_collective_line(seg['collectives'])} [{card}]")
    log(f"train-sp: Trainer.train {SP_FOLDS} folds x {SP_STEPS} steps on both ranks, {seg['train_s']:.3f} s, each "
        f"train step launched {per_step}, each eval forward {per_eval}; metrics equal on both ranks "
        f"{json.dumps(seg['metrics'])}; Trainer.predict ({SP_FOLDS} folds x 4 transforms over {n_test} images, "
        f"{len(seg['ledger_predict'])} forwards) {seg['predict_s']:.3f} s on the ranks, their probabilities within "
        f"{pred_err:.3g} of the plain predict of the same checkpoints [{card}]")
    hv = vit["held"]
    log(f"train-sp: ViT-S/16 ({vit['n_params']} parameters, bf16) at sequence_parallel {SP_DEGREE}, "
        f"{vit_batch} images: one step against the one-card step from the same state: loss {hv['loss']:.6f} vs "
        f"{hv['one_card_loss']:.6f}, worst gradient leaf at {hv['worst_gradient']:.3f} of "
        f"{TOL_MOE_GRAD}·max|leaf|; {timed(vit['step_ms'])} per step, the one-card step {timed(vit['one_rank_ms'])}; "
        f"peak memory per rank {peaks('vit')} GB, the one-card step's "
        f"{vit['one_rank_peak_gb']:.3f} GB; one step's collectives {sp_collective_line(vit['collectives'])}; "
        f"fit_preset {SP_VIT_FIT_STEPS} steps {vit['fit_s']:.3f} s, final {json.dumps(vit['fit']['final_metrics'])} "
        f"[{card}]")
    ring = r0["ring"]
    log(f"train-sp: ring attention alone at {list(ring_shape)} over {SP_DEGREE} ranks: float32 max|err| "
        f"{ring['float32']['max_abs_err']:.3g} (bound {TOL_RING_F32}), bf16 within one bf16 step "
        f"(max|err| {ring['bfloat16']['max_abs_err']:.3g}); ms float32 {ring['float32']['ms']:.3f} / bf16 "
        f"{ring['bfloat16']['ms']:.3f} on a rank's block, attention_reference of the whole "
        f"{ring['float32']['reference_ms']:.3f} / {ring['bfloat16']['reference_ms']:.3f} ms [{card}]")
    log(f"train-sp: launches on the main path (rank 0: Trainer.train, Trainer.predict, fit_preset) {launches}; "
        f"rank laps (a, b, c) {[round(x, 1) for x in r0['laps_s']]} s; {t1 - t0:.1f} s for the ranks, "
        f"{time.perf_counter() - t0:.1f} s in all [{card}]")
    return {"launches": launches, "held_calls": held_err, "phase_s": time.perf_counter() - t0, "ranks_s": t1 - t0,
            "seg_step_ms": seg["step_ms"], "seg_one_rank_ms": seg["one_rank_ms"], "seg_held": h,
            "seg_peak_gb": [o["seg"]["peak_gb"] for o in outs], "seg_one_rank_peak_gb": seg["one_rank_peak_gb"],
            "seg_collectives": seg["collectives"], "conv_paths": seg["paths"], "train_s": seg["train_s"],
            "predict_s": seg["predict_s"], "predict_err": pred_err,
            "vit_step_ms": vit["step_ms"], "vit_one_card_ms": vit["one_rank_ms"], "vit_held": hv,
            "vit_peak_gb": [o["vit"]["peak_gb"] for o in outs], "vit_one_card_peak_gb": vit["one_rank_peak_gb"],
            "vit_collectives": vit["collectives"], "vit_fit_s": vit["fit_s"], "ring": ring, "laps_s": r0["laps_s"]}



# Xception-41: the segmenter through Trainer.train with every observability
# knob on, and the classifier preset through fit_preset
XC_STEPS = 10  # per fold; cut from 20 to pay for train-tp's ViT arm (PERF.md §4)
XC_EVERY = 10
XC_LOG_EVERY = 5
XC_TRACE_RATE = 0.25
XC_PROFILE_EVERY = 2
XC_NAN_STEPS = 5
XC_NAN_IMAGES = 64
# a window's mfu (the step FLOPs over its step and fetch-wait time per step)
# against the mfu its images/s imply (the same FLOPs over its wall time per
# step): at most this ratio, and at most 1
MFU_IMPLIED_RATIO = 1.25
X41_PRESET = "xception41_imagenet"
X41_STEPS = 10


def xception_counts(per, n_bn: int) -> dict:
    """``per`` with the BN launches of an Xception forward."""
    return {**per, "fused_bn_act": n_bn}


def train_xception_phase(torch, card: str, device: str = "cuda", model_kwargs=None, n_images: int = TRAIN_IMAGES,
                         size: int = 101, batch: int = TRAIN_BATCH, steps: int = XC_STEPS, every: int = XC_EVERY,
                         log_every: int = XC_LOG_EVERY, nan_images: int = XC_NAN_IMAGES):
    """The Xception-41 segmenter (reference widths, ``output_stride=8``,
    depthwise kernels in the ASPP, float32) through Trainer.train, 2 folds
    x ``steps`` steps at ``batch`` on the train phase's seeded salt
    dataset, with dispatch-ahead 2, a window every ``log_every`` steps,
    traces at 0.25, a cadence profile every 2 windows and the NaN guard on
    abort; an eval and a checkpoint every ``every`` steps. Checks the
    launches, the ledger (memory, windows, mfu, traces, checkpoints, the
    capture and its roofline), the event files, the served export, and a
    NaN drill. ``model_kwargs`` and ``device="cpu"`` rehearse it small."""
    from tensorflowdistributedlearning_tpu_torch.config import ModelConfig, TrainConfig
    from tensorflowdistributedlearning_tpu_torch.data import augment as augment_lib
    from tensorflowdistributedlearning_tpu_torch.data import folds as folds_lib
    from tensorflowdistributedlearning_tpu_torch.data import pipeline as pipeline_lib
    from tensorflowdistributedlearning_tpu_torch.models import model_for
    from tensorflowdistributedlearning_tpu_torch.models.layers import BatchNorm
    from tensorflowdistributedlearning_tpu_torch.obs import health
    from tensorflowdistributedlearning_tpu_torch.obs import profiler as profiler_lib
    from tensorflowdistributedlearning_tpu_torch.obs import trace as trace_lib
    from tensorflowdistributedlearning_tpu_torch.obs.ledger import read_ledger
    from tensorflowdistributedlearning_tpu_torch.ops import kernels
    from tensorflowdistributedlearning_tpu_torch.serve import InferenceEngine
    from tensorflowdistributedlearning_tpu_torch.train import step as step_lib
    from tensorflowdistributedlearning_tpu_torch.train.trainer import Trainer
    from tensorflowdistributedlearning_tpu_torch.utils import summary

    on_card = device == "cuda"
    model_kwargs = dict(model_kwargs or {}, backbone="xception", output_stride=8, use_pallas_depthwise=True)
    cfg = ModelConfig(input_shape=(size, size), **model_kwargs)
    with torch.device("meta"):
        n_bn = sum(isinstance(m, BatchNorm) for m in model_for(cfg).modules())
    zero = {k: 0 for k in PER_TRAIN_STEP}
    per_step = PER_TRAIN_STEP if on_card else zero
    per_eval = xception_counts(PER_EVAL_FORWARD, n_bn) if on_card else zero
    tcfg = TrainConfig(n_folds=TRAIN_FOLDS, seed=SEED % 1000 + 5, checkpoint_every_steps=every,
                       eval_every_steps=every, save_best=2, dispatch_ahead_steps=2, train_log_every_steps=log_every,
                       trace_sample_rate=XC_TRACE_RATE, profile_every_windows=XC_PROFILE_EVERY, nan_guard="abort")
    out = {}
    with tempfile.TemporaryDirectory(prefix="chip-smoke-train-xception-") as root:
        data, model_dir = os.path.join(root, "data"), os.path.join(root, "model")
        ids = write_salt_dataset(data, n_images, size, SEED + 11)  # the train phase's dataset
        ledger = LaunchLedger(kernels, step_lib, Trainer)
        trainer = Trainer(model_dir, data, train_config=tcfg, device=device, input_shape=(size, size),
                          **model_kwargs)
        decisions = []
        real_span = trace_lib.Tracer.span

        @contextlib.contextmanager
        def deciding_span(tracer, name, **kw):
            """The tracer's span, recording each root span's sampling verdict."""
            with real_span(tracer, name, **kw) as opened:
                if opened is not None and opened.parent_id is None:
                    decisions.append((name, opened.sampled))
                yield opened

        with ledger.patch(), mock.patch.object(trace_lib.Tracer, "span", deciding_span):
            kernels.reset_launch_counts()
            t0 = time.perf_counter()
            folds = trainer.train(ids, batch_size=batch, steps=steps)
            if on_card:
                torch.cuda.synchronize()
            train_s = time.perf_counter() - t0
            counts = kernels.launch_counts()
        check(len(folds) == TRAIN_FOLDS and all(np.isfinite(v) for f in folds for v in f.values()),
              f"train-xception: fold metrics {folds}")
        n_evals = TRAIN_FOLDS * (steps // every)
        check(len(ledger.train) == TRAIN_FOLDS * steps, f"train-xception: {len(ledger.train)} train steps")
        check(len(ledger.summary) == TRAIN_FOLDS * (steps // log_every) + n_evals,
              f"train-xception: {len(ledger.summary)} image summaries")
        for i, delta in enumerate(ledger.train):
            check({k: delta[k] for k in per_step} == per_step, f"train-xception step {i}: launches {delta}")
        for i, delta in enumerate(ledger.eval + ledger.summary):
            check({k: delta[k] for k in per_eval} == per_eval, f"train-xception eval forward {i}: launches {delta}")
        forwards = len(ledger.eval) + len(ledger.summary)
        want = {k: per_step[k] * len(ledger.train) + per_eval[k] * forwards for k in per_step}
        check({k: counts[k] for k in want} == want, f"train-xception launches {counts}, expected {want}")
        out.update(launches=counts, train_s=train_s, n_params=trainer.params, n_bn=n_bn)
        log(f"train-xception: Trainer.train of Xception-41 + ASPP + decoder ({trainer.params} parameters, "
            f"{size}x{size}x2, output_stride 8, float32), {TRAIN_FOLDS} folds x {steps} steps at batch {batch}: "
            f"{train_s:.3f} s (data, evals, checkpoints, summaries, traces and profiles included); {len(ledger.train)} "
            f"steps launched {per_step['depthwise_conv2d']}/{per_step['depthwise_conv2d_dx']}/"
            f"{per_step['depthwise_conv2d_dw']} depthwise fwd/dx/dw each, {forwards} eval and image-summary forwards "
            f"{per_eval['fused_bn_act']} BN + act each; folds {json.dumps(folds)} [{card}]")

        # the ledger
        events = check_run_ledger(model_dir, TRAIN_FOLDS * steps, n_evals, "train-xception")
        keep_ledgers(model_dir, "train-xception")
        mems = [e for e in events if e["event"] == "memory"]
        check(len(mems) >= TRAIN_FOLDS, f"train-xception: {len(mems)} memory events")
        if on_card:
            in_use = [d.get("bytes_in_use") for e in mems for d in e["devices"].values()]
            check(in_use and all(v for v in in_use), f"train-xception: memory events' bytes_in_use {in_use}")
        windows = [e for e in events if e["event"] == "step_window"]
        for w in windows:
            check("fetch_wait_s" in w and "step_time_ms" in w and ("mfu" in w or not on_card),
                  f"train-xception window {w}")
        # mfu: the ledger rounds it to 4 places (JAX's field), so the check
        # recomputes it from the window's own fields, unrounded
        peak = profiler_lib.resolve_peak_flops(device=device)
        flops = 6.0 * trainer.params * batch
        mfus = []
        for w in windows:
            mfu = flops * w["steps"] / (w["compute_s"] + w["fetch_wait_s"]) / peak if peak else None
            # the JAX package's pricing, over the mean step span alone (recorded)
            span_mfu = flops / (w["step_time_ms"]["mean_ms"] / 1e3) / peak if peak else None
            implied = flops / batch * w["images_per_sec"] / peak if peak and not w["dirty"] else None
            log(f"train-xception: window fold {w['fold']} step {w['step']}{' (dirty)' if w['dirty'] else ''}: "
                f"{w.get('images_per_sec')} images/s, step span {w['step_time_ms']['mean_ms']} ms mean, compute "
                f"{w['compute_s']} s, fetch_wait {w['fetch_wait_s']} s, data_wait {w['data_wait_s']} s; mfu "
                f"{w.get('mfu')} ({mfu if mfu is None else f'{mfu:.4e}'} unrounded), over the mean step span "
                f"{span_mfu if span_mfu is None else f'{span_mfu:.4e}'}, implied by images/s "
                f"{implied if implied is None else f'{implied:.4e}'} [{card}]")
            if w["dirty"]:
                continue
            mfus.append((w["fold"], w["step"], mfu, span_mfu, implied))
            check(not on_card or w["mfu"] == round(mfu, 4) and mfu <= 1.0 and mfu <= MFU_IMPLIED_RATIO * implied,
                  f"train-xception window fold {w['fold']} step {w['step']}: mfu {w.get('mfu')} ({mfu}) against "
                  f"{implied} implied by {w['images_per_sec']} images/s")
        check(len(mfus) >= TRAIN_FOLDS, f"train-xception: {len(mfus)} clean windows")
        out["mfu"] = mfus
        # every step, eval and checkpoint span was offered to the sampler, and
        # exactly the sampled ones are in the ledger
        traces = [e for e in events if e["event"] == "trace" and not e.get("parent_id")]
        ckpts = [e for e in events if e["event"] == "checkpoint"]
        names = ("step", "eval", "checkpoint")
        offered = {n: sum(d == n for d, _ in decisions) for n in names}
        sampled = {n: sum(d == n and v for d, v in decisions) for n in names}
        ledgered = {n: sum(t["name"] == n for t in traces) for n in names}
        share = sum(sampled.values()) / max(1, sum(offered.values()))
        check(offered == {"step": TRAIN_FOLDS * steps, "eval": n_evals, "checkpoint": len(ckpts)}
              and sampled == ledgered and sampled["step"] >= 1 and 0.08 <= share <= 0.5,
              f"train-xception traces: offered {offered}, sampled {sampled}, ledgered {ledgered}")
        by_name = ledgered
        check(len(ckpts) == TRAIN_FOLDS * (steps // every + 1) and ckpts[-1].get("final"),
              f"train-xception: checkpoint events {[(e['step'], e.get('final')) for e in ckpts]}")
        log(f"train-xception: traces at rate {XC_TRACE_RATE}: sampled {by_name} of the offered {offered} step, eval "
            f"and checkpoint spans (share {share:.3f}), each sampled one in the ledger; {len(ckpts)} checkpoint "
            f"events; {len(mems)} memory events")
        captures = [e for e in events if e["event"] == "profile_capture"]
        roofs = [e for e in events if e["event"] == "op_roofline"]
        # one capture every XC_PROFILE_EVERY windows of the run, none refused
        # and none failed (check_run_ledger read the counters)
        n_captures = TRAIN_FOLDS * (steps // log_every) // XC_PROFILE_EVERY
        check(len(captures) == n_captures and events[-1].get("profiler", {}).get("captures") == n_captures,
              f"train-xception: {len(captures)} cadence captures, expected {n_captures}; run_end profiler "
              f"{events[-1].get('profiler')}")
        if on_card:
            # a capture begun at a fold's last window holds no train step: no mfu
            priced = [r for r in roofs if "mfu" in r]
            check(roofs and all(r["phase"] == "train" for r in roofs) and priced
                  and all(r["mfu"] <= 1.0 and r["analytic_flops_per_step"] == flops for r in priced),
                  f"train-xception rooflines {[(r['step'], r.get('mfu')) for r in roofs]}")
            ops = json.load(open(os.path.join(captures[0]["logdir"], "ops.json")))
            names = {o["name"]: o["occurrences"] for o in ops}
            tiled = sum(n for k, n in names.items() if "tfdl_depthwise_tiled_kernel" in k)
            band = sum(n for k, n in names.items() if "tfdl_depthwise_dw_band_kernel" in k)
            check(tiled >= 6 and band >= 3, f"train-xception capture: depthwise fwd+dx {tiled}, dw {band} launches")
            log(f"train-xception: {len(captures)} cadence captures; the first holds {len(ops)} kernels, "
                f"{tiled} depthwise forward and dx launches and {band} dw launches; rooflines "
                f"{[(r['step'], r.get('mfu'), r['classes']) for r in roofs]} [{card}]")

        # the event files
        for fold in range(TRAIN_FOLDS):
            fold_windows = [w for w in windows if w["fold"] == fold]
            (train_events,) = [os.path.join(model_dir, f"fold{fold}", "train", f)
                               for f in os.listdir(os.path.join(model_dir, f"fold{fold}", "train"))]
            scalars = summary.read_events(train_events)
            check([s for s, _ in scalars] == [w["step"] for w in fold_windows] and all(
                all(abs(v - w["scalars"][k]) <= 1e-6 * max(1.0, abs(v)) for k, v in got.items())
                for (_, got), w in zip(scalars, fold_windows)), f"train-xception fold {fold}: TensorBoard scalars")
            tags = {}
            for step, images in summary.read_images(train_events):
                tags.setdefault(step, set()).update(images)
            kinds = {t.split("/")[0] for step_tags in tags.values() for t in step_tags}
            check(kinds == {"image", "label", "probability", "prediction"} and len(tags) == steps // log_every,
                  f"train-xception fold {fold}: image summaries {tags}")
        log(f"train-xception: fold{{0,1}}/train scalars equal the windows' scalars; image, label, probability and "
            f"prediction summaries decoded at every window")

        # the export, served
        manifest = trainer.export_serving(0)
        engine = InferenceEngine.from_artifact(os.path.dirname(manifest), device=device, buckets=(batch,))
        x = make_instances(torch, batch, SEED + 62)[:, :size, :size]
        kernels.reset_launch_counts()
        got = engine.infer(x)["probabilities"]
        served = kernels.launch_counts()
        best = trainer.restore_fold(0).model.eval()
        plain = {"depthwise_conv2d": kernels.depthwise_conv2d_plain, "bn_act_folded": kernels.bn_act_folded_plain,
                 "fused_sigmoid_mask": kernels.fused_sigmoid_mask_plain}
        with mock.patch.multiple(kernels, **plain), torch.no_grad():
            want = torch.sigmoid(best(torch.from_numpy(x).to(device))).cpu().numpy()
        del best
        d = float(np.abs(got - want).max())
        per_serve = {"depthwise_conv2d": 3, "fused_bn_act": n_bn, "fused_sigmoid_mask": 1} if on_card else {
            "depthwise_conv2d": 0, "fused_bn_act": 0, "fused_sigmoid_mask": 0}
        check(d <= TOL_PROBS, f"train-xception export: probabilities {d} from the plain forward")
        check({k: served[k] for k in per_serve} == per_serve, f"train-xception export: launches {served}")
        out["serve_launches"] = served
        log(f"train-xception: fold 0's export through the engine at bucket {batch}: launches {per_serve}, max|dprobs| "
            f"{d:.3g} from the forward through the plain versions [{card}]")
        del engine
        # fold 0's best as int8-compute
        full = cfg == ModelConfig(input_shape=(101, 101), backbone="xception", output_stride=8, use_pallas_depthwise=True)
        art8 = os.path.dirname(trainer.export_serving(0, serving_dtype="int8-compute"))
        art16 = os.path.dirname(trainer.export_serving(0, serving_dtype="bfloat16"))
        out["int8"] = int8_arm(torch, "xception41_segmenter", art8, card, device,
                               expect=INT8_LAYERS["xception41_segmenter"] if full else None, bf16_art=art16)

        # the step on a resident batch: ms, images/s, idle share
        dataset = pipeline_lib.InMemoryDataset.from_directory(data, ids=ids[:batch])
        placed = pipeline_lib.to_device({"images": dataset.images, "masks": dataset.masks}, torch.device(device))
        fixed = augment_lib.prepare_eval_batch(placed["images"], placed["masks"])
        state = trainer._init_state()
        train_step = step_lib.make_train_step(step_lib.SegmentationTask())
        times = []
        for _ in range(6):
            t0 = time.perf_counter()
            state, metrics = train_step(state, fixed)
            step_lib.compute_metrics(metrics)
            times.append(time.perf_counter() - t0)
        ms = statistics.median(times[2:]) * 1e3
        out.update(step_ms=ms, images_per_s=batch / ms * 1e3)
        log(f"train-xception: {ms:.3f} ms per step (median of steps 3-6 on a resident batch), "
            f"{batch / ms * 1e3:.3f} images/s at batch {batch} [{card}]")
        if on_card:
            lines, stats = profile_steps(torch, train_step, state, fixed)
            for line in lines:
                log(f"profile train-xception: {line} [{card}]")
            out["profile"] = stats
        del state

        # the NaN drill: one NaN pixel in one train image of fold 0
        drill_ids = ids[:nan_images]
        classes = folds_lib.coverage_to_class(pipeline_lib.mask_coverage(
            pipeline_lib.InMemoryDataset.from_directory(data, ids=drill_ids).masks))
        poisoned_id = folds_lib.build_fold_manifests(drill_ids, list(classes), tcfg.n_folds, tcfg.seed)[0]["train"][0]
        real = pipeline_lib.InMemoryDataset.from_directory.__func__

        def poisoned(cls, *a, **k):
            ds = real(cls, *a, **k)
            ds.images[list(ds.ids).index(poisoned_id), size // 2, size // 2, 0] = np.nan
            return ds

        drill_dir = os.path.join(root, "model-nan")
        with mock.patch.object(pipeline_lib.InMemoryDataset, "from_directory", classmethod(poisoned)):
            try:
                Trainer(drill_dir, data, train_config=tcfg, device=device, input_shape=(size, size),
                        **model_kwargs).train(drill_ids, classes, batch_size=batch, steps=XC_NAN_STEPS)
                raised = None
            except health.HealthAbortError as e:
                raised = e
        check(raised is not None, "train-xception NaN drill: no HealthAbortError")
        drill = read_ledger(drill_dir)
        alerts = [e for e in drill if e["event"] == "health_alert"]
        check(len(alerts) == 1 and alerts[0]["monitor"] == "nan_loss" and alerts[0]["action"] == "abort",
              f"train-xception NaN drill: alerts {alerts}")
        final = fold_files(drill_dir, 0)["checkpoints"]
        last = [e for e in drill if e["event"] == "checkpoint"][-1]
        check(last.get("final") and last["step"] in final and drill[-1]["event"] == "run_end"
              and drill[-1]["interrupted"], f"train-xception NaN drill: checkpoints {list(final)}, last {drill[-1]}")
        log(f"train-xception: NaN drill ({poisoned_id} holds one NaN pixel, {XC_NAN_STEPS} steps): "
            f"{type(raised).__name__}: {raised}; health_alert {json.dumps({k: v for k, v in alerts[0].items() if k != 't'})}; "
            f"the final checkpoint at step {last['step']} on disk")
    return out


def fit_xception_phase(torch, card: str, device: str = "cuda", cfg=None, batch: int = R50_BATCH,
                       steps: int = X41_STEPS, log_every: int = XC_LOG_EVERY):
    """xception41_imagenet (Xception-41 classifier, 224x224x3, bf16 compute,
    1000 classes; full width and depth) through ``fit_preset`` on synthetic
    data: ``steps`` steps at ``batch``, one eval at the end, the float32
    export; then the export through the engine (the bf16-activation BN
    arm) against its forward through the plain versions, and the step on a
    resident batch. ``cfg`` and ``device="cpu"`` rehearse it small."""
    import dataclasses

    from tensorflowdistributedlearning_tpu_torch import configs
    from tensorflowdistributedlearning_tpu_torch.data import pipeline as pipeline_lib
    from tensorflowdistributedlearning_tpu_torch.data.synthetic import synthetic_classification_batch
    from tensorflowdistributedlearning_tpu_torch.models import model_for
    from tensorflowdistributedlearning_tpu_torch.models.layers import BatchNorm
    from tensorflowdistributedlearning_tpu_torch.ops import kernels
    from tensorflowdistributedlearning_tpu_torch.serve import InferenceEngine
    from tensorflowdistributedlearning_tpu_torch.train import serving
    from tensorflowdistributedlearning_tpu_torch.train import step as step_lib
    from tensorflowdistributedlearning_tpu_torch.train.fit import EVAL_SYNTHETIC_BATCHES, ClassifierTrainer, fit_preset
    from tensorflowdistributedlearning_tpu_torch.train.state import create_train_state

    on_card = device == "cuda"
    preset = configs.get_preset(X41_PRESET)
    cfg = cfg or preset.model
    with torch.device("meta"):
        n_bn = sum(isinstance(m, BatchNorm) for m in model_for(cfg).modules())
    zero = {k: 0 for k in PER_R50_TRAIN_STEP}
    per_step = PER_R50_TRAIN_STEP if on_card else zero
    per_fwd = {**PER_R50_TRAIN_STEP, "fused_bn_act": n_bn, "fused_bn_act_bf16_act": n_bn} if on_card else zero
    shape = (*cfg.input_shape, cfg.input_channels)
    out = {}
    with tempfile.TemporaryDirectory(prefix="chip-smoke-fit-xception-") as root, \
            mock.patch.dict(configs.PRESETS, {X41_PRESET: dataclasses.replace(preset, model=cfg)}):
        model_dir = os.path.join(root, "model")
        ledger = LaunchLedger(kernels, step_lib)
        with ledger.patch():
            kernels.reset_launch_counts()
            t0 = time.perf_counter()
            result = fit_preset(X41_PRESET, model_dir, steps=steps, batch_size=batch, eval_every_steps=steps,
                                export_serving="float32", device=device, train_log_every_steps=log_every)
            if on_card:
                torch.cuda.synchronize()
            fit_s = time.perf_counter() - t0
            counts = kernels.launch_counts()
        check(result.steps == steps and all(np.isfinite(v) for v in result.final_metrics.values()),
              f"fit-xception: {result}")
        check(len(ledger.train) == steps and len(ledger.eval) == EVAL_SYNTHETIC_BATCHES,
              f"fit-xception: {len(ledger.train)} train steps, {len(ledger.eval)} eval forwards")
        for i, delta in enumerate(ledger.train + ledger.eval):
            want = per_step if i < steps else per_fwd
            check({k: delta[k] for k in want} == want, f"fit-xception step or eval forward {i}: launches {delta}")
        check_run_ledger(model_dir, steps, 1, "fit-xception", windows=steps // log_every)
        keep_ledgers(model_dir, "fit-xception")
        out.update(launches=counts, fit_s=fit_s, n_params=result.n_params, final_metrics=result.final_metrics)
        log(f"fit-xception: fit_preset {X41_PRESET} ({result.n_params} parameters, bf16 compute), {steps} steps at "
            f"batch {batch} on synthetic data ({preset.train.optimizer}, lr {preset.train.lr}), one eval, the float32 "
            f"export: {fit_s:.3f} s wall; final {json.dumps(result.final_metrics)}; {len(ledger.eval)} eval forwards "
            f"launched {per_fwd['fused_bn_act_bf16_act']} bf16 BN + act each [{card}]")

        # the export through the engine against its forward through the plain versions
        trainer = ClassifierTrainer(model_dir, None, cfg, preset.train, device=device)
        best = trainer._restore_best_host()
        x = r50_instances(batch, SEED + 71, shape)
        xt = torch.from_numpy(x).to(device)
        with best.eval_params() as model:
            calib = [r50_instances(batch, SEED + 72 + i, shape) for i in range(R50_CALIBRATION_BATCHES)]
            estimate_bn_statistics(torch, model, [torch.from_numpy(c).to(device) for c in calib])
            calibrate_logits(torch, model.eval(), xt)
            art = os.path.join(root, "served")
            art8 = os.path.join(root, "served-int8-compute")
            art16 = os.path.join(root, "served-bfloat16")
            for directory, spec in ((art, "float32"), (art8, "int8-compute"), (art16, "bfloat16")):
                serving.export_serving_artifact(model, cfg, directory, metadata={"step": best.step}, serving_dtype=spec)
        del best
        engine = InferenceEngine.from_artifact(art, device=device, buckets=(batch,))
        kernels.reset_launch_counts()
        got = engine.infer(x)
        served = kernels.launch_counts()
        check({k: served[k] for k in per_fwd} == per_fwd, f"fit-xception serve: launches {served}")
        plain_model = serving.load_serving_artifact(art, device)
        with mock.patch.multiple(kernels, bn_act_folded=kernels.bn_act_folded_plain):
            kernels.reset_launch_counts()
            want = plain_model(x)
            check(sum(kernels.launch_counts().values()) == 0, "fit-xception: the plain forward launched")
        p, pw = got["probabilities"], want["probabilities"].float().cpu().numpy()
        cls, clsw = got["class"], want["class"].cpu().numpy()
        d = float(np.abs(p - pw).max())
        top2 = np.sort(pw, -1)[:, -2:]
        apart = top2[:, 1] - top2[:, 0] > 2 * TOL_VIT_F32
        check(d <= TOL_VIT_F32 and np.array_equal(cls[apart], clsw[apart]),
              f"fit-xception serve: max|dprobs| {d}, top-1 {int((cls != clsw).sum())} rows apart")
        check_classes(p, cls, "fit-xception serve")
        out.update(serve_launches=served, serve_dprobs=d, top1_agree=float((cls == clsw).mean()))
        log(f"fit-xception: the export (running statistics re-estimated, logits at std 3) through the engine at "
            f"bucket {batch}: {per_fwd['fused_bn_act_bf16_act']} bf16-activation BN + act launches, max|dprobs| {d:.3g} "
            f"and top-1 on {int(apart.sum())} of {batch} rows equal to the forward through the plain versions [{card}]")
        del engine, plain_model
        # the same served state as int8-compute
        out["int8"] = int8_arm(torch, X41_PRESET, art8, card, device,
                               expect=INT8_LAYERS[X41_PRESET] if cfg is preset.model else None, bf16_art=art16)

    # the step on a resident batch
    state = create_train_state(cfg, preset.train, device, generator=torch.Generator().manual_seed(SEED + 73))
    raw = synthetic_classification_batch(np.random.default_rng(SEED + 74), batch, cfg.input_shape,
                                         cfg.input_channels, cfg.num_classes)
    fixed = pipeline_lib.to_device(raw, torch.device(device))
    train_step = step_lib.make_train_step(step_lib.ClassificationTask(label_smoothing=preset.train.label_smoothing),
                                          weight_decay=cfg.weight_decay)
    times, losses = [], []
    for _ in range(6):
        t0 = time.perf_counter()
        state, metrics = train_step(state, fixed)
        losses.append(step_lib.compute_metrics(metrics)["loss"])
        times.append(time.perf_counter() - t0)
    check(all(np.isfinite(losses)), f"fit-xception: non-finite losses {losses}")
    ms = statistics.median(times[2:]) * 1e3
    out.update(step_ms=ms, images_per_s=batch / ms * 1e3)
    log(f"fit-xception: train step on a resident batch of {batch}: {ms:.3f} ms (median of steps 3-6), "
        f"{batch / ms * 1e3:.3f} images/s [{card}]")
    if on_card:
        lines, stats = profile_steps(torch, train_step, state, fixed)
        for line in lines:
            log(f"profile fit-xception: {line} [{card}]")
        out["profile"] = stats
    return out


def main() -> int:
    t_start = time.perf_counter()
    marks = [t_start]

    def mark(phase: str) -> None:
        """Log the wall time since the previous mark (the phase's, setup included)."""
        marks.append(time.perf_counter())
        log(f"phase {phase}: {marks[-1] - marks[-2]:.1f} s (at {marks[-1] - t_start:.1f} s)")

    try:
        import torch
    except ImportError as e:
        print(f"FAIL: torch is not importable: {e}", file=sys.stderr)
        return 1
    global KEEP_LEDGERS
    cold_dir, cold_procs = None, []
    KEEP_LEDGERS = tempfile.mkdtemp(prefix="chip-smoke-ledgers-")
    try:
        card = probe(torch)
        torch.backends.cudnn.allow_tf32 = False
        torch.backends.cuda.matmul.allow_tf32 = False
        try:
            from tensorflowdistributedlearning_tpu_torch.config import ModelConfig
            from tensorflowdistributedlearning_tpu_torch.models import build_model
        except ImportError as e:
            raise SmokeFailure(f"the port package is not importable from {os.getcwd()}: {e}")
        # beside this process's build, two processes build the data-parallel
        # path's libraries into one cold directory at once, racing each other
        cold_dir = tempfile.mkdtemp(prefix="chip-smoke-cold-")
        cold_procs = start_cold_builds(cold_dir)
        build()
        cold = finish_cold_builds(cold_procs, cold_dir)
        log(f"build: the two cold builds of {'/'.join(COLD_LIBS)} racing in one directory beside it "
            f"{[round(t, 3) for t in cold]} s")
        mark("build")
        cfg = ModelConfig(use_pallas_depthwise=True)
        gen = torch.Generator().manual_seed(SEED)
        t0 = time.perf_counter()
        model = build_model(cfg, "cpu", generator=gen)
        randomize_bn(torch, model, gen)
        model = model.cuda().eval()
        calibrate_head(torch, model, torch.from_numpy(make_instances(torch, 16, SEED + 2)).cuda())
        n_params = sum(p.numel() for p in model.parameters())
        log(f"model: full-width ResNet-v2 + DeepLabV3+, {n_params} parameters, built in {time.perf_counter() - t0:.3f} s")
        timer = Timer(torch)
        rows = kernel_phase(torch, model, timer, card)
        mark("kernels")
        for name, r in rows.items():
            earlier = f", earlier kernel {r['earlier_ms']:.4f} ms" if "earlier_ms" in r else ""
            log(f"{name}: {r['ms']:.4f} ms per forward at bucket {BUCKET} (plain {r['plain_ms']:.4f} ms, "
                f"library {r['library_ms'] if r['library_ms'] is None else round(r['library_ms'], 4)} ms{earlier}, "
                f"bound {r['bound_ms']:.4f} ms by {r['bound_by']}) [{card}]")
        served = serve_phase(torch, model, cfg, card)
        mark("serve")
        observed = serve_obs_phase(torch, model, cfg, card)
        mark("serve-obs")
        int8_counts, int8_rows = int8_phase(torch, model, cfg, card, timer)
        mark("int8")
        rows.update(int8_rows)
        del model
        torch.cuda.empty_cache()
        vit_paths, vit_rows = vit_phase(torch, card, timer)
        mark("vit")
        rows.update(vit_rows)
        torch.cuda.empty_cache()
        fitted = fit_vit_phase(torch, card)
        mark("fit-vit")
        torch.cuda.empty_cache()
        vit_trained = vit_train_phase(torch, card, timer)
        mark("train-vit")
        torch.cuda.empty_cache()
        rows["flash_attention"]["max_abs_err"] = max(rows["flash_attention"]["max_abs_err"],
                                                     vit_trained["attention_forward_err"])
        rows["flash_attention_f32"]["max_abs_err"] = max(rows["flash_attention_f32"]["max_abs_err"],
                                                         vit_trained["f32_attention_forward_err"])

        from tensorflowdistributedlearning_tpu_torch.data.synthetic import synthetic_segmentation_batch

        train_model = build_model(cfg, "cpu", generator=torch.Generator().manual_seed(SEED + 3)).cuda()
        images = torch.from_numpy(make_instances(torch, TRAIN_BATCH, SEED + 4)).cuda()
        labels = synthetic_segmentation_batch(np.random.default_rng(SEED + 4), TRAIN_BATCH)["labels"]
        calls = capture_train_calls(torch, train_model, images, torch.from_numpy(labels).cuda())
        check(len(calls) == 3 and all("g" in c for c in calls), f"captured {len(calls)} depthwise calls with gradients")
        del train_model, images
        torch.cuda.empty_cache()
        rows.update(backward_phase(torch, calls, timer, card))
        mark("backward")
        del calls
        torch.cuda.empty_cache()
        trained = train_phase(torch, card)
        mark("train")
        torch.cuda.empty_cache()
        dp = dp_phase(torch, card, timer=timer, cold=cold)
        mark("dp")
        torch.cuda.empty_cache()
        trained16 = train_bf16_phase(torch, card, timer)
        mark("train-bf16")
        rows.update(trained16.pop("rows"))
        torch.cuda.empty_cache()
        fitted50 = fit_resnet50_phase(torch, card)
        mark("fit-resnet50")
        rows["fused_bn_act_bf16_act"]["max_abs_err"] = max(rows["fused_bn_act_bf16_act"]["max_abs_err"],
                                                           fitted50["bn_held_err"])
        torch.cuda.empty_cache()
        fit_records = fit_records_phase(torch, card)
        mark("fit-records")
        rates = "/".join(f"{v:.1f}" for v in fit_records["service_images_per_s"].values())
        log(f"fit-records: the data path alone {rates} images/s at {'/'.join(map(str, FR_WORKERS))} workers, fit's "
            f"train loop {fit_records['loop_images_per_s']:.1f}, the step on a resident batch "
            f"{fitted50['images_per_s']:.1f} images/s (fit-resnet50) [{card}]")
        torch.cuda.empty_cache()
        lars = train_lars_phase(torch, card)
        mark("train-lars")
        torch.cuda.empty_cache()
        zero1 = train_zero1_phase(torch, card)
        mark("train-zero1")
        torch.cuda.empty_cache()
        tp = train_tp_phase(torch, card)
        mark("train-tp")
        torch.cuda.empty_cache()
        pp = train_pp_phase(torch, card)
        mark("train-pp")
        torch.cuda.empty_cache()
        moe = train_moe_phase(torch, card)
        mark("train-moe")
        torch.cuda.empty_cache()
        sp = train_sp_phase(torch, card)
        mark("train-sp")
        torch.cuda.empty_cache()
        xception = train_xception_phase(torch, card)
        mark("train-xception")
        torch.cuda.empty_cache()
        x41 = fit_xception_phase(torch, card)
        mark("fit-xception")
        readers = readers_phase(torch, card, KEEP_LEDGERS)
        mark("readers")
    except SmokeFailure as e:
        print(f"FAIL: {e}", file=sys.stderr)
        return 1
    finally:
        for p in cold_procs:
            if p.poll() is None:
                p.kill()
                p.wait()
        if cold_dir is not None:
            shutil.rmtree(cold_dir, ignore_errors=True)
        shutil.rmtree(KEEP_LEDGERS, ignore_errors=True)
    for name, e in (list(dp["train-dp2"]["held"].items()) + list(tp["held"].items()) + list(pp["held"].items())
                    + list(sp["held_calls"].items())):
        rows[name]["max_abs_err"] = max(rows[name]["max_abs_err"], e)
    paths = {"serve": served["launches"], "serve-obs": observed["launches"], "serve-int8-compute": int8_counts, "train": trained["launches"],
             "predict": trained["predict_launches"], "predict-artifact": trained["artifact_launches"],
             "train-dp": dp["train-dp"]["launches"], "train-dp2": dp["train-dp2"]["launches"], **vit_paths,
             "fit-vit": fitted["launches"], "train-vit": vit_trained["launches"],
             "train-bf16": trained16["launches"], "predict-bf16": trained16["predict_launches"],
             "serve-bf16": trained16["engine_launches"], "fit-resnet50": fitted50["launches"],
             "serve-resnet50": fitted50["serve_launches"], "fit-records": fit_records["launches"],
             "fit-imagefolder": fit_records["folder_launches"], "train-lars": lars["launches"],
             "train-zero1": zero1["launches"], "train-tp": tp["launches"], "train-tp-vit": tp["vit"]["launches"],
             "train-pp": pp["launches"],
             "serve-moe": moe["serve_launches"], "train-moe": moe["launches"], "train-moe-ep": moe["ep"]["launches"],
             "train-sp": sp["launches"],
             "train-xception": xception["launches"], "serve-xception": xception["serve_launches"],
             "fit-xception": x41["launches"], "serve-xception41": x41["serve_launches"],
             **{f"serve-int8-{key}": phase["int8"].pop("launches")
                for key, phase in (("bf16", trained16), ("resnet50", fitted50), ("xception", xception),
                                   ("xception41", x41))}}
    def launches(name, counts):
        return ARM_LAUNCHES[name](counts) if name in ARM_LAUNCHES else counts.get(name, 0)

    table = [
        {"name": name, "route": "cuda", "source": SOURCES[name], "replaces": REPLACES[name],
         "launches": sum(launches(name, p) for p in paths.values()),
         "launches_by_path": {path: launches(name, p) for path, p in paths.items()}, **rows[name]}
        for name in SOURCES
    ]
    log(f"total: {time.perf_counter() - t_start:.1f} s")
    missing = [r["name"] for r in table if r["launches"] == 0 and r["name"] not in OFF_PATH]
    if missing:
        print(f"FAIL: launched no time on the main paths: {missing}", file=sys.stderr)
        return 1
    print(json.dumps({"kernels": table, "card": card,
                      "train": {k: trained[k] for k in ("step_ms", "images_per_s")},
                      "predict": {k: trained[k] for k in ("predict_s", "predict_images_per_s", "predict_forwards",
                                                          "restore_s", "drawn_restore_s", "torch_load_s")},
                      "serve_obs": {k: v for k, v in observed.items() if k != "launches"},
                      "fit_vit": {k: v for k, v in fitted.items() if k != "launches"},
                      "train_vit": {k: v for k, v in vit_trained.items() if k not in ("launches", "losses")},
                      "train_dp": {k: v for k, v in dp["train-dp"].items() if k != "launches"},
                      "train_dp2": {k: v for k, v in dp["train-dp2"].items() if k not in ("launches", "held")},
                      "train_bf16": {k: v for k, v in trained16.items() if not k.endswith("launches")},
                      "fit_resnet50": {k: v for k, v in fitted50.items() if not k.endswith("launches")},
                      "fit_records": {k: v for k, v in fit_records.items() if not k.endswith("launches")},
                      "train_lars": {k: v for k, v in lars.items() if k != "launches"},
                      "train_zero1": {k: v for k, v in zero1.items() if k != "launches"},
                      "train_tp": {k: v for k, v in tp.items() if k not in ("launches", "held")},
                      "train_pp": {k: v for k, v in pp.items() if k not in ("launches", "held")},
                      "train_moe": {k: v for k, v in moe.items() if not k.endswith("launches")},
                      "train_sp": {k: v for k, v in sp.items() if k not in ("launches", "held_calls")},
                      "train_xception": {k: v for k, v in xception.items() if not k.endswith("launches")},
                      "fit_xception": {k: v for k, v in x41.items() if not k.endswith("launches")},
                      "readers": readers}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    ranks = {"dp-rank": dp_rank_main, "zero-rank": zero_rank_main, "tp-rank": tp_rank_main, "pp-rank": pp_rank_main,
             "moe-rank": moe_rank_main, "sp-rank": sp_rank_main, "cold-build": cold_build_main}
    sys.exit(ranks[sys.argv[1]](sys.argv[2:]) if sys.argv[1:2] and sys.argv[1] in ranks else main())
