"""One rank of the PyTorch port's data-parallel tests (a worker: it holds no
test of its own): ``tests/test_torch_parallel.py`` and
``tests/test_torch_train_trainer.py`` start W of these as subprocesses,

    python tests/test_torch_dp_worker.py MODE RANK WORLD STORE DIR

which join one gloo group through the ``file://`` store STORE (no port is
bound), run on the CPU, write ``DIR/rank{RANK}.pt`` and exit. It imports no
JAX: the parent holds the results against the JAX package.

``step``: collectives, ``replicate`` of a perturbed state, and the
data-parallel train step from ``DIR/init.pt`` on this rank's rows of the
global batches in ``DIR/batches.npz`` (per-rank BN and sync BN, states after
1 and 3 steps), then an eval pass over this rank's round-robin share of
``DIR/eval.npz``.

``accum``: one data-parallel step with ``grad_accum_steps`` = 2 from
``DIR/init.pt`` on this rank's rows of the first global batch of
``DIR/batches.npz``, with the all-reduces it made counted
(``tests/test_torch_lars_accum_remat.py``).

``fit``: the ViT's data-parallel train step from ``DIR/fit_init.pt`` on
this rank's rows of ``DIR/fit_batch.npz`` (the averaged gradient, the
parameters after the update, the summed metrics), then
``ClassifierTrainer.fit`` of the tiny ViT under the group and what its
serving restore raises there.

``zero``: ZeRO-1 (``parallel/zero.py``) beside the replicated
data-parallel step from ``DIR/init.pt`` on this rank's rows of
``DIR/batches.npz``, under the Adam chain (clip, AdamW, EMA), Nesterov SGD
with sync BN and LARS: the ZeRO state after each step (and its
replicated twin's, which under LARS starts each step from the ZeRO
state), the whole state the ZeRO one gathers, a ZeRO
checkpoint in ``DIR/ckpt`` (written by rank 0) and, when ``DIR/whole``
holds a replicated checkpoint, that checkpoint restored into this rank's
shards; then ``ClassifierTrainer.fit`` of a narrow Xception-41 classifier
under ZeRO-1, 2 + 2 steps resumed and 4 uninterrupted, with the dropout
masks each forward drew (``tests/test_torch_zero1.py``).

``tp``: tensor parallelism (``parallel/tensor.py``) at ``model_parallel``
2 over the W ranks (``(1, 2)`` at W = 2, ``(2, 2)`` at W = 4): the sliced
segmenter's forward, the ``Trainer`` step and ``fit``'s step
(``tensor.make_train_step_gspmd``, with and without ZeRO-1) from
``DIR/tp_init.pt`` on this rank's rows of ``DIR/tp_batches.npz`` (the
whole gradient and state after one plain-SGD step at lr 1, so the update
is the gradient), two Adam steps with and without ZeRO-1, a checkpoint in
``DIR/tp-ckpt`` and, when ``DIR/tp-whole`` holds a replicated checkpoint,
that checkpoint restored into this rank's slices; ``Trainer.train`` over
``DIR/data``; and ``ClassifierTrainer.fit`` of the tiny ResNet classifier
under ZeRO-1, 2 + 2 steps resumed and 4 uninterrupted
(``tests/test_torch_tensor_parallel.py``).

``vtp``: tensor parallelism of the ViT at ``model_parallel`` 2 (``(1, 2)``
at W = 2, ``(2, 2)`` at W = 4): a LayerNorm alone from ``DIR/vtp_init.pt``
(its output, gradients, and the output local statistics would give), the
sliced ViT's and MoE ViT's forward on the whole ``DIR/vtp_batch.npz`` and
``fit``'s step on this rank's rows (one plain-SGD step at lr 1, the ViT
also under ZeRO-1 and in bf16 compute; the MoE ViT's only at W = 2, and at
W = 4 the refusals of ``fit_preset``, given and planned), then
``fit_preset`` of the tiny ViT with ``parallelism='auto'`` at
``model_parallel`` 2 (``tests/test_torch_vit_tensor_parallel.py``).

``pp``: pipeline parallelism (``parallel/pipeline.py``,
``train/pipeline_step.py``): the runner over all W ranks as one stage
group on the toy stages of ``DIR/pp_toy.npz`` (forward, gradients summed
over the group, aux means); then at ``pipeline_parallel`` 2 (``(1, 2)`` at
W = 2, ``(2, 2)`` at W = 4) from ``DIR/pp_init.pt`` on this rank's rows of
``DIR/pp_batches.npz``: one plain-SGD step at lr 1 of the ViT (the update
is the gradient; at W = 2 rank 0 also runs the one-rank schedule), the
Xception-41 classifier's in float64 without dropout and with it beside the
plain data-parallel step, both eval steps with ``valid`` weights; then
``ClassifierTrainer.fit`` of the narrow ViT and Xception-41 at
``pipeline_parallel`` 2, 2 + 2 steps resumed and 4 uninterrupted
(``tests/test_torch_pipeline.py``).

``moe``: ``parallel/expert.moe_apply`` over all W ranks as one expert
group (expert r on rank r) on the arrays of ``DIR/moe.npz``: the output
and the gradients of a weighted sum of it (this rank's expert, the router,
the tokens) at two capacity factors, and what an over-wide router raises
(``tests/test_torch_expert.py``).

``ep``: expert parallelism at ``expert_parallel`` 2 (``(1, 2)`` at W = 2,
``(2, 2)`` at W = 4) from ``DIR/ep_init.pt`` on this rank's rows of
``DIR/ep_batch.npz``: one plain-SGD step at lr 1 of the Switch-MoE ViT
(the update is the gradient), with ZeRO-1 and with ``grad_accum_steps``
2; the eval step; then ``ClassifierTrainer.fit`` at ``expert_parallel``
2, with and without ZeRO-1, 2 + 2 steps resumed and 4 uninterrupted
(``tests/test_torch_vit_moe.py``).

``spops``: the sequence axis's operations (``parallel/spatial.py``) with
all W ranks as one sequence group, each on its block of the rows of the
arrays in ``DIR/spops.npz``: every case of ``spatial_conv2d`` in
``SP_CONV_CASES`` (halo or gather path), the halo exchange, the max pool,
the global mean, the gather, ``ring_all_gather`` and ``reduce_scatter``,
each output and the gradients of a weighted sum of it
(``tests/test_torch_spatial.py``).

``ring``: ``parallel/ring_attention.make_ring_attention`` with all W ranks
as one sequence group on the global Q/K/V and masks of ``DIR/ring.npz``,
for each case of ``RING_CASES``: this rank's output block and the
gradients of a weighted sum of it (``tests/test_torch_ring_attention.py``).

``sp``: sequence parallelism at ``sequence_parallel`` 2 (``(1, 2)`` at W =
2, ``(2, 2)`` at W = 4) from ``DIR/sp_init.pt`` and ``DIR/sp_batches.npz``:
at W = 2 the eval-mode forward of each network of ``SP_MODELS`` on its
row blocks; one plain-SGD step at lr 1 of the narrow segmenter (the
update is the gradient) and the plain gradient of this data index's rows;
at W = 4 two Adam steps with and without ZeRO-1; at W = 2
``Trainer.train`` over ``DIR/data`` with its ``predict`` over
``DIR/test``, and ``ClassifierTrainer.fit`` of the tiny ViT
(``tests/test_torch_spatial_model.py``).

``trainer``: ``Trainer.train`` of the tiny model over the dataset in
``DIR/data``, its no-op re-run, and what must raise under the group. Every
directory made, file opened for writing, renamed or removed under the model
directory is recorded from Python's audit events (``torch.save`` writes
from C++, but a checkpoint step shows as its directory's mkdir and
rename).
"""

from __future__ import annotations

import contextlib
import os
import sys

import numpy as np
import pytest
import torch

TIMEOUT_S = 60.0
TINY = dict(n_blocks=(1, 1, 1), input_shape=(33, 33), base_depth=16, width_multiplier=0.125,
            use_pallas_depthwise=True)
SGD = dict(optimizer="sgd", lr=1e-2, lr_decay_steps=2, sgd_momentum=0.9)
VIT_TINY = dict(backbone="vit", num_classes=10, input_shape=(16, 16), input_channels=3, patch_size=4, embed_dim=32,
                num_heads=2, vit_layers=2, output_stride=None, use_fused_attention=True)
VIT_ADAMW = dict(optimizer="adam", lr=1e-3, weight_decay=0.1, grad_clip_norm=1.0, label_smoothing=0.1,
                 lr_schedule="cosine", lr_warmup_steps=1, lr_decay_steps=10, augmentation="none")


# torch's intra-op thread count in a test process before any module changes it
DEFAULT_TORCH_THREADS = torch.get_num_threads()


@contextlib.contextmanager
def torch_threads(n: int):
    """For the duration, ``n`` torch intra-op threads (the count restored
    after). The test modules that compute on the CPU take one: under the
    suite's six loaded workers on one host, OpenMP loops at the default
    count spin against each other (one float64 backward took 85.9 s loaded
    against 0.35 s idle, ``tests/test_torch_xception.py``)."""
    before = torch.get_num_threads()
    torch.set_num_threads(n)
    try:
        yield
    finally:
        torch.set_num_threads(before)


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """One torch intra-op thread for every test of a module that imports
    this fixture (autouse; the count restored after the module): see
    :func:`torch_threads`."""
    with torch_threads(1):
        yield


def launch(mode: str, world: int, directory: str, timeout: float = 240.0):
    """Run ``world`` ranks of ``mode`` over ``directory`` and return their
    results, rank by rank. Every rank is killed if any is still running
    when the call returns; a rank that fails raises with its output."""
    return finish(start(mode, world, directory), timeout)


def start(mode: str, world: int, directory: str):
    """Start ``world`` ranks of ``mode`` over ``directory``; :func:`finish`
    collects them."""
    import subprocess

    store = os.path.join(directory, f"store-{mode}")
    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    env = dict(os.environ, PYTHONPATH=repo + os.pathsep + os.environ.get("PYTHONPATH", ""), OMP_NUM_THREADS="1")
    procs = [
        subprocess.Popen(
            [sys.executable, os.path.abspath(__file__), mode, str(rank), str(world), f"file://{store}", directory],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True, env=env, cwd=repo,
        )
        for rank in range(world)
    ]
    return mode, world, directory, procs


def finish(started, timeout: float = 240.0):
    """The results of :func:`start`'s ranks, rank by rank (see
    :func:`launch`)."""
    mode, world, directory, procs = started
    try:
        for rank, p in enumerate(procs):
            out, _ = p.communicate(timeout=timeout)
            if p.returncode != 0:
                raise AssertionError(f"rank {rank} of {world} ({mode}) exited {p.returncode}:\n{out[-4000:]}")
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    return [torch.load(os.path.join(directory, f"rank{r}.pt"), weights_only=False) for r in range(world)]


def _bce_task():
    from tensorflowdistributedlearning_tpu_torch.ops import losses as losses_lib
    from tensorflowdistributedlearning_tpu_torch.train import step as step_lib

    class BceTask(step_lib.SegmentationTask):
        """The segmentation task under sigmoid cross entropy: a smooth
        objective, so a one-step comparison measures the step and not the
        Lovász hinge's sort order at ulp-close errors."""

        def loss(self, logits, batch):
            return losses_lib.sigmoid_cross_entropy(logits, batch["labels"])

    return BceTask()


def _state(cfg, tcfg_kwargs, init):
    from tensorflowdistributedlearning_tpu_torch.config import TrainConfig
    from tensorflowdistributedlearning_tpu_torch.train.state import create_train_state

    return create_train_state(cfg, TrainConfig(**tcfg_kwargs), "cpu", state_dict=init["state_dict"],
                              step=init["step"])


def _snapshot(state):
    return {k: v.detach().clone() for k, v in state.model.state_dict().items()}


def _collectives(rank: int, world: int):
    """What the collectives give on this rank."""
    from tensorflowdistributedlearning_tpu_torch.parallel import collectives, multihost

    a = torch.tensor([float(rank + 1), 2.0 * rank])
    b = torch.full((2, 3), float(rank))
    collectives.psum_([a, b])
    c = torch.tensor([float(rank), 1.0])
    collectives.pmean_(c)
    d = torch.tensor([float(rank), -float(rank)])
    collectives.pmax_(d)
    e = torch.full((3,), float(rank))
    collectives.broadcast_([e])
    # the differentiable mean: the cotangent of x_r is the mean of the
    # ranks' cotangents of y
    x = torch.tensor([1.0 + rank, 2.0 * rank], requires_grad=True)
    w = torch.tensor([float(rank + 1), 3.0])
    y = collectives.pmean(x)
    (y * w).sum().backward()
    return {
        "psum": (a, b), "pmean": c, "pmax": d, "broadcast": e, "pmean_y": y.detach(), "pmean_grad": x.grad,
        "max_batches": multihost.all_processes_max_batches(3 * rank + 1, 2),
        "object": multihost.broadcast_object({"rank": rank}),
        "info": multihost.process_info(),
    }


def _step_mode(rank: int, world: int, directory: str):
    from tensorflowdistributedlearning_tpu_torch.config import ModelConfig
    from tensorflowdistributedlearning_tpu_torch.data import augment as augment_lib
    from tensorflowdistributedlearning_tpu_torch.data import pipeline as pipeline_lib
    from tensorflowdistributedlearning_tpu_torch.parallel import mesh, multihost
    from tensorflowdistributedlearning_tpu_torch.train import step as step_lib
    from tensorflowdistributedlearning_tpu_torch.train.state import replicate

    out = {"collectives": _collectives(rank, world)}
    cfg = ModelConfig(**TINY)
    init = torch.load(os.path.join(directory, "init.pt"), weights_only=False)
    data = np.load(os.path.join(directory, "batches.npz"))
    images, labels = data["images"], data["labels"]  # [steps, global batch, ...]
    rows = mesh.shard_rows(images.shape[1], rank, world)
    task = _bce_task()

    # replicate: rank 0's state reaches every rank, whatever a rank held
    state = _state(cfg, SGD, init)
    if rank:
        with torch.no_grad():
            for t in state.model.state_dict().values():
                t.add_(1.0)
    out["replicated"] = _snapshot(replicate(state))

    for name, extra in (("per_rank", {}), ("sync", {"sync_batch_norm": True})):
        state = replicate(_state(cfg, dict(SGD, **extra), init))
        train_step = step_lib.make_train_step(task, data_parallel=True)
        losses = []
        for k in range(images.shape[0]):
            batch = {"images": torch.from_numpy(images[k, rows]), "labels": torch.from_numpy(labels[k, rows])}
            state, metrics = train_step(state, batch)
            losses.append(step_lib.compute_metrics(metrics)["loss"])
            if k == 0:
                out[f"{name}_1"] = _snapshot(state)
        out[f"{name}_{images.shape[0]}"] = _snapshot(state)
        out[f"{name}_losses"] = losses
        flat = state.flat_grad
        out[f"{name}_flat"] = all(
            p.grad.untyped_storage().data_ptr() == flat.untyped_storage().data_ptr()
            for p in state.model.parameters()
        )

    # eval over this rank's round-robin share of an uneven eval set
    ev = np.load(os.path.join(directory, "eval.npz"))
    ids = [str(i) for i in range(len(ev["images"]))]
    dataset = pipeline_lib.InMemoryDataset(ev["images"], ev["masks"], ids).select(pipeline_lib.host_shard(ids))
    local_bs = multihost.per_process_batch_size(int(ev["batch"]))
    num = multihost.eval_num_batches(len(ids), local_bs)
    eval_step = step_lib.make_eval_step(task, data_parallel=True)
    acc = None
    for raw in pipeline_lib.eval_batches(dataset, local_bs, num_batches=num):
        batch = augment_lib.prepare_eval_batch(torch.from_numpy(raw["images"]), torch.from_numpy(raw["masks"]))
        batch["valid"] = torch.from_numpy(raw["valid"])
        acc = step_lib.merge_metrics(acc, eval_step(state.model, batch))
    out["eval"] = step_lib.compute_metrics(acc)
    out["eval_shard"] = list(dataset.ids)
    out["eval_steps"] = num
    return out


def _accum_mode(rank: int, world: int, directory: str):
    """One data-parallel step with ``grad_accum_steps`` = 2 on this rank's
    rows of the global batch: the state after it, the loss, and how many
    all-reduces the step made (one for the gradient, one for the BN
    statistics, whatever the chunk count)."""
    from tensorflowdistributedlearning_tpu_torch.config import ModelConfig
    from tensorflowdistributedlearning_tpu_torch.parallel import collectives, mesh
    from tensorflowdistributedlearning_tpu_torch.train import step as step_lib
    from tensorflowdistributedlearning_tpu_torch.train.state import replicate

    cfg = ModelConfig(**TINY)
    init = torch.load(os.path.join(directory, "init.pt"), weights_only=False)
    data = np.load(os.path.join(directory, "batches.npz"))
    rows = mesh.shard_rows(data["images"].shape[1], rank, world)
    state = replicate(_state(cfg, SGD, init))
    train_step = step_lib.make_train_step(_bce_task(), data_parallel=True, accum=2)
    batch = {"images": torch.from_numpy(data["images"][0, rows]), "labels": torch.from_numpy(data["labels"][0, rows])}
    calls = []
    real = collectives.pmean_

    def counted(tensors, *args, **kwargs):
        calls.append(1)
        return real(tensors, *args, **kwargs)

    collectives.pmean_ = counted
    try:
        state, metrics = train_step(state, batch)
    finally:
        collectives.pmean_ = real
    return {"state": _snapshot(state), "loss": step_lib.compute_metrics(metrics)["loss"], "all_reduces": len(calls)}


def _fit_mode(rank: int, world: int, directory: str):
    from tensorflowdistributedlearning_tpu_torch.config import ModelConfig, TrainConfig
    from tensorflowdistributedlearning_tpu_torch.parallel import mesh
    from tensorflowdistributedlearning_tpu_torch.train import step as step_lib
    from tensorflowdistributedlearning_tpu_torch.train.fit import ClassifierTrainer
    from tensorflowdistributedlearning_tpu_torch.train.state import replicate

    cfg = ModelConfig(**VIT_TINY)
    init = torch.load(os.path.join(directory, "fit_init.pt"), weights_only=False)
    data = np.load(os.path.join(directory, "fit_batch.npz"))
    rows = mesh.shard_rows(len(data["labels"]), rank, world)
    state = replicate(_state(cfg, VIT_ADAMW, init))
    train_step = step_lib.make_train_step(step_lib.ClassificationTask(label_smoothing=0.1), data_parallel=True)
    state, metrics = train_step(state, {k: torch.from_numpy(v[rows]) for k, v in data.items()})
    out = {
        "grads": {n: p.grad.detach().clone() for n, p in state.model.named_parameters()},
        "params": _snapshot(state),
        "metrics": step_lib.compute_metrics(metrics),
    }
    model_dir = os.path.join(directory, "fit-model")
    trainer = ClassifierTrainer(model_dir, None, cfg, TrainConfig(**VIT_ADAMW, checkpoint_every_steps=2,
                                                                  n_devices=world), device="cpu")
    out["fit"] = trainer.fit(batch_size=8, steps=3).final_metrics
    try:
        trainer.serving_fn()
        out["serving"] = None
    except RuntimeError as e:
        out["serving"] = str(e)
    return out


ZERO_CONFIGS = {
    # the everything-on chain of the JAX package's ZeRO-1 tests
    "adam": dict(optimizer="adam", lr=1e-2, weight_decay=1e-4, ema_decay=0.9, grad_clip_norm=1.0),
    "sgd": dict(SGD, sync_batch_norm=True),
    "lars": dict(optimizer="lars", lr=0.5, weight_decay=1e-4, sgd_momentum=0.9),
}
ZERO_FIT = dict(optimizer="adam", lr=1e-3, weight_decay=1e-4, ema_decay=0.9, grad_clip_norm=1.0,
                augmentation="none", checkpoint_every_steps=2, seed=7, weight_update_sharding=True)


def zero_fit_model():
    """The narrow Xception-41 classifier of the ZeRO fit (its dropout live)."""
    import dataclasses

    from tensorflowdistributedlearning_tpu_torch import configs

    model = configs.get_preset("xception41_imagenet").model
    return dataclasses.replace(model, width_multiplier=0.0625, input_shape=(32, 32), num_classes=10,
                               dtype="float32")


def _whole(state):
    """The state's whole optimizer state and EMA, replicated format."""
    sd = state.state_dict()
    return {"optimizer": sd["optimizer"], "ema": sd.get("ema"), "step": sd["step"]}


def _zero_mode(rank: int, world: int, directory: str):
    import dataclasses

    from tensorflowdistributedlearning_tpu_torch.config import ModelConfig, TrainConfig
    from tensorflowdistributedlearning_tpu_torch.models import xception
    from tensorflowdistributedlearning_tpu_torch.parallel import mesh
    from tensorflowdistributedlearning_tpu_torch.train import step as step_lib
    from tensorflowdistributedlearning_tpu_torch.train.checkpoint import CheckpointManager
    from tensorflowdistributedlearning_tpu_torch.train.fit import ClassifierTrainer
    from tensorflowdistributedlearning_tpu_torch.train.state import replicate

    cfg = ModelConfig(**TINY)
    init = torch.load(os.path.join(directory, "init.pt"), weights_only=False)
    data = np.load(os.path.join(directory, "batches.npz"))
    images, labels = data["images"], data["labels"]
    rows = mesh.shard_rows(images.shape[1], rank, world)
    task = _bce_task()
    out = {}
    for name, kw in ZERO_CONFIGS.items():
        rep = replicate(_state(cfg, kw, init))
        zero = replicate(_state(cfg, dict(kw, weight_update_sharding=True), init))
        assert rep.zero is None and zero.zero is not None
        train_step = step_lib.make_train_step(task, data_parallel=True)
        run = {"rep": [], "zero": [], "losses": []}
        for k in range(images.shape[0]):
            batch = {"images": torch.from_numpy(images[k, rows]), "labels": torch.from_numpy(labels[k, rows])}
            if name == "lars" and k:
                # LARS is held step by step: the twin starts where ZeRO is
                rep.load_state_dict(zero.state_dict())
            _, m_rep = train_step(rep, batch)
            _, m_zero = train_step(zero, batch)
            run["rep"].append(_snapshot(rep))
            run["zero"].append(_snapshot(zero))
            run["losses"].append((step_lib.compute_metrics(m_rep)["loss"], step_lib.compute_metrics(m_zero)["loss"]))
        run["rep_whole"], run["zero_whole"] = _whole(rep), _whole(zero)
        run["slots"] = {k: [v for v in slots.values() if isinstance(v, torch.Tensor)]
                        for k, slots in zero.optimizer.state_dict()["state"].items()}
        run["dims"] = dict(zero.zero.dims)
        out[name] = run
        if name == "adam":
            with zero.eval_params() as model:
                run["eval_params"] = {k: v.detach().clone() for k, v in model.named_parameters()}
            run["after_eval_params"] = _snapshot(zero)
            ckpt = CheckpointManager(os.path.join(directory, "ckpt"), save_every_steps=1)
            run["saved"] = ckpt.save(zero)
            whole_dir = os.path.join(directory, "whole")
            if os.path.isdir(whole_dir):
                restored = CheckpointManager(whole_dir).restore_latest(
                    _state(cfg, dict(kw, weight_update_sharding=True), init))
                run["restored"] = {"whole": _whole(restored), "model": _snapshot(restored),
                                   "ema": {k: v.clone() for k, v in restored.ema.items()},
                                   "slots": {k: dict(v) for k, v in restored.optimizer.state_dict()["state"].items()}}

    # fit under ZeRO-1: 2 + 2 steps resumed against 4, recording the masks
    masks = []
    plain = xception.Xception41._dropout

    def recording(self, x):
        y = plain(self, x)
        if self.training:
            # the kept features, and the features that could be kept
            masks.append(torch.stack([y != 0, x != 0]))
        return y

    xception.Xception41._dropout = recording
    fit = {}
    try:
        for run, stops in (("resumed", (2, 4)), ("straight", (4,))):
            model_dir = os.path.join(directory, f"fit-{run}")
            del masks[:]
            for stop in stops:
                tcfg = TrainConfig(**ZERO_FIT, n_devices=world)
                trainer = ClassifierTrainer(model_dir, None, zero_fit_model(), tcfg, device="cpu")
                fit[f"{run}_{stop}"] = trainer.fit(batch_size=8, steps=stop).final_metrics
            fit[f"{run}_masks"] = [m.clone() for m in masks]
    finally:
        xception.Xception41._dropout = plain
    out["fit"] = fit
    out["fit_config"] = dataclasses.asdict(zero_fit_model())
    return out


TP = 2
TP_CLS = dict(n_blocks=(1, 1, 1, 1), block_layout="classic", block_type="basic_block", stem_space_to_depth=True,
              width_multiplier=0.125, num_classes=10, input_shape=(32, 32), input_channels=3, output_stride=None)
# one plain SGD step at lr 1: the update is minus the gradient
TP_SGD = dict(optimizer="sgd", lr=1.0, sgd_momentum=0.0, lr_decay_steps=10_000)
TP_ADAM = dict(optimizer="adam", lr=1e-2, weight_decay=1e-4, ema_decay=0.9, grad_clip_norm=1.0)
TP_FIT = dict(optimizer="adam", lr=1e-3, ema_decay=0.9, grad_clip_norm=1.0, augmentation="none",
              checkpoint_every_steps=2, seed=7, model_parallel=TP, weight_update_sharding=True)


def _whole_grads(state):
    """The step's gradient (after its data-group mean), whole."""
    names = [n for n, _ in state.model.named_parameters()]
    grads = [p.grad.detach().clone() for _, p in state.model.named_parameters()]
    if state.tp is not None:
        grads = state.tp.gather(list(zip(names, grads)))
    return dict(zip(names, grads))


def _tp_mode(rank: int, world: int, directory: str):
    from tensorflowdistributedlearning_tpu_torch.config import ModelConfig, TrainConfig
    from tensorflowdistributedlearning_tpu_torch.parallel import mesh, tensor
    from tensorflowdistributedlearning_tpu_torch.train import step as step_lib
    from tensorflowdistributedlearning_tpu_torch.train.checkpoint import CheckpointManager
    from tensorflowdistributedlearning_tpu_torch.train.fit import ClassifierTrainer
    from tensorflowdistributedlearning_tpu_torch.train.state import replicate
    from tensorflowdistributedlearning_tpu_torch.train.trainer import Trainer

    lay = mesh.init_mesh(TP)
    init = torch.load(os.path.join(directory, "tp_init.pt"), weights_only=False)
    data = np.load(os.path.join(directory, "tp_batches.npz"))
    seg, cls = ModelConfig(**TINY), ModelConfig(**TP_CLS)
    out = {"layout": (lay.dp, lay.tp, lay.data_index, lay.model_index)}

    def state_of(cfg, kw, which):
        return replicate(_state(cfg, dict(kw, model_parallel=TP), init[which]))

    def rows(prefix):
        r = mesh.shard_rows(len(data[f"{prefix}_labels"]))
        return {"images": torch.from_numpy(data[f"{prefix}_images"][r]),
                "labels": torch.from_numpy(data[f"{prefix}_labels"][r])}

    # the sliced segmenter's forward on the whole batch, eval and train mode
    state = state_of(seg, TP_SGD, "seg")
    out["slices"] = {k: v.clone() for k, v in state.model.state_dict().items()}
    images = torch.from_numpy(data["seg_images"])
    with torch.no_grad():
        out["logits_eval"] = state.model.eval()(images)
        out["logits_train"] = state.model.train()(images)
    out["stats_after_forward"] = state.model_state_dict()

    # the Trainer's step (per-tower BN) and fit's (global-batch BN), one
    # plain SGD step at lr 1 each; fit's also under ZeRO-1
    for name, cfg, which, make, kw in (
        ("trainer", seg, "seg", lambda: step_lib.make_train_step(_bce_task(), data_parallel=True), {}),
        ("fit", cls, "cls", lambda: tensor.make_train_step_gspmd(step_lib.ClassificationTask()), {}),
        ("fit_zero", cls, "cls", lambda: tensor.make_train_step_gspmd(step_lib.ClassificationTask()),
         {"weight_update_sharding": True}),
    ):
        state = state_of(cfg, dict(TP_SGD, **kw), which)
        state, metrics = make()(state, rows(which))
        out[name] = {"loss": step_lib.compute_metrics(metrics)["loss"], "grads": _whole_grads(state),
                     "state": state.model_state_dict()}

    # Adam with clip and EMA: ZeRO-1 over the data group against the TP step
    run = {}
    for mode, kw in (("tp", {}), ("zero", {"weight_update_sharding": True})):
        state = state_of(cls, dict(TP_ADAM, **kw), "cls")
        train_step = tensor.make_train_step_gspmd(step_lib.ClassificationTask())
        for _ in range(2):
            state, metrics = train_step(state, rows("cls"))
        run[mode] = state.state_dict()
        run[f"{mode}_loss"] = step_lib.compute_metrics(metrics)["loss"]
        if mode == "zero":
            out["saved"] = CheckpointManager(os.path.join(directory, "tp-ckpt"), save_every_steps=1).save(state)
            whole_dir = os.path.join(directory, "tp-whole")
            if os.path.isdir(whole_dir):
                restored = CheckpointManager(whole_dir).restore_latest(state_of(cls, dict(TP_ADAM, **kw), "cls"))
                out["restored"] = {"whole": restored.state_dict(),
                                   "slices": {k: v.clone() for k, v in restored.model.state_dict().items()}}
    out["adam"] = run

    # Trainer.train at model_parallel 2 over DIR/data
    trainer = Trainer(os.path.join(directory, "tp-trainer"), os.path.join(directory, "data"),
                      train_config=TrainConfig(n_folds=2, seed=0, checkpoint_every_steps=2, eval_throttle_secs=0,
                                               save_best=2, model_parallel=TP, n_devices=world),
                      device="cpu", input_shape=(32, 32), **{k: v for k, v in TINY.items() if k != "input_shape"})
    from tensorflowdistributedlearning_tpu_torch.data import pipeline as pipeline_lib

    out["trainer_results"] = trainer.train(pipeline_lib.discover_ids(os.path.join(directory, "data")), batch_size=4,
                                           steps=2)
    out["trainer_params"] = trainer.params

    # fit under TP and ZeRO-1: 2 + 2 steps resumed against 4
    fit = {}
    for name, stops in (("resumed", (2, 4)), ("straight", (4,))):
        for stop in stops:
            t = ClassifierTrainer(os.path.join(directory, f"tp-fit-{name}"), None, cls,
                                  TrainConfig(**TP_FIT, n_devices=world), device="cpu")
            fit[f"{name}_{stop}"] = t.fit(batch_size=8, steps=stop).final_metrics
    out["fit_runs"] = fit
    return out


PP = 2
PP_VIT = dict(backbone="vit", num_classes=4, input_shape=(16, 16), input_channels=3, patch_size=4, embed_dim=32,
              vit_layers=4, num_heads=4, output_stride=None)
PP_XC = dict(backbone="xception", num_classes=4, input_shape=(64, 64), input_channels=3, width_multiplier=0.125,
             output_stride=None, dtype="float32")
PP_M = 4
PP_FIT = dict(optimizer="adam", lr=1e-3, ema_decay=0.9, grad_clip_norm=1.0, augmentation="none",
              checkpoint_every_steps=2, seed=5, pipeline_parallel=PP, pipeline_microbatches=2)


def pp_toy_stage(p, x):
    """The runner tests' toy stage: a 3x3 SAME conv, bias, relu (NHWC)."""
    y = torch.nn.functional.conv2d(x.permute(0, 3, 1, 2), p["w"].permute(3, 2, 0, 1), p["b"], padding=1)
    return torch.relu(y.permute(0, 2, 3, 1))


def _float64(model):
    """``model`` computing in float64 (parameters, statistics and every
    layer's compute dtype)."""
    model.double()
    for m in model.modules():
        if hasattr(m, "compute_dtype"):
            m.compute_dtype = torch.float64
    return model


def _pp_mode(rank: int, world: int, directory: str):
    from unittest import mock

    from tensorflowdistributedlearning_tpu_torch.config import ModelConfig, TrainConfig
    from tensorflowdistributedlearning_tpu_torch.parallel import collectives, mesh
    from tensorflowdistributedlearning_tpu_torch.parallel import pipeline as pp
    from tensorflowdistributedlearning_tpu_torch.train import pipeline_step
    from tensorflowdistributedlearning_tpu_torch.train import step as step_lib
    from tensorflowdistributedlearning_tpu_torch.train.fit import ClassifierTrainer
    from tensorflowdistributedlearning_tpu_torch.train.state import replicate

    out = {}
    # the runner: all W ranks one stage group, K = W
    toy = np.load(os.path.join(directory, "pp_toy.npz"))
    lay = mesh.init_mesh(world, pipeline=True)
    out["runner_layout"] = (lay.dp, lay.tp, mesh.pipeline_parallel_degree(), mesh.model_parallel_degree())
    stacked = {"w": torch.from_numpy(toy["w"]).requires_grad_(), "b": torch.from_numpy(toy["b"]).requires_grad_()}
    x = torch.from_numpy(toy["x"]).requires_grad_()
    y = pp.make_pipeline_fn(pp_toy_stage)(stacked, x)
    torch.sum(torch.from_numpy(toy["w_out"]) * y).backward()
    grads = [stacked["w"].grad, stacked["b"].grad]
    out["runner_own_slot_only"] = all(
        float(g[j].abs().max()) == 0.0 for g in grads for j in range(world) if j != mesh.model_index())
    collectives.psum_(grads, mesh.stage_group())
    out["runner"] = {"out": y.detach(), "grad_w": grads[0], "grad_b": grads[1], "grad_x": x.grad}
    my = {k: v[mesh.model_index()].detach() for k, v in stacked.items()}
    _, aux = pp.pipeline_apply_aux(lambda p, h: (lambda o: (o, [o.mean(dim=(0, 1, 2))]))(pp_toy_stage(p, h)), my,
                                   x.detach())
    out["runner_aux"] = aux[0]
    try:
        pp.make_pipeline_fn(pp_toy_stage)({k: v[:1] for k, v in stacked.items()}, x)
    except ValueError as e:
        out["runner_stage_count"] = str(e)

    # the train and eval steps at pipeline_parallel 2
    lay = mesh.init_mesh(PP, pipeline=True)
    out["layout"] = (lay.dp, lay.tp, lay.data_index, lay.model_index, mesh.pipeline_parallel_degree())
    init = torch.load(os.path.join(directory, "pp_init.pt"), weights_only=False)
    data = np.load(os.path.join(directory, "pp_batches.npz"))
    task = step_lib.ClassificationTask()

    def rows(prefix):
        r = mesh.shard_rows(len(data[f"{prefix}_labels"]))
        return {k: torch.from_numpy(data[f"{prefix}_{k}"][r]) for k in ("images", "labels", "valid")
                if f"{prefix}_{k}" in data}

    def result(state, metrics):
        return {"loss": step_lib.compute_metrics(metrics)["loss"],
                "grads": {n: p.grad.detach().clone() for n, p in state.model.named_parameters()},
                "state": _snapshot(state)}

    vit = ModelConfig(**PP_VIT)
    batch = rows("vit")
    state = replicate(_state(vit, TP_SGD, init["vit"]))
    state, metrics = pipeline_step.make_train_step_pipeline(task, vit, PP_M)(state, batch)
    out["vit"] = result(state, metrics)
    if rank == 0 and lay.dp == 1:
        one = _state(vit, TP_SGD, init["vit"])
        one, m1 = pipeline_step.make_train_step_pipeline(task, vit, PP_M, local_stages=PP)(one, batch)
        out["vit_one_rank"] = result(one, m1)
    model = _state(vit, TP_SGD, init["vit"]).model
    ev = rows("vit_eval")
    out["vit_eval"] = step_lib.compute_metrics(pipeline_step.make_eval_step_pipeline(task, vit, PP_M)(model, ev))

    # Xception-41 in float64: without dropout against JAX, with it against
    # the plain data-parallel step (the same masks)
    xc = ModelConfig(**PP_XC)
    batch = {k: v.double() if k == "images" else v for k, v in rows(f"xc{world}").items()}
    with mock.patch.object(torch.Tensor, "float", torch.Tensor.double):
        for name, keep, make in (
            ("xc", 1.0, lambda: pipeline_step.make_train_step_pipeline(task, xc, PP_M, seed=3)),
            ("xc_dropout", 0.5, lambda: pipeline_step.make_train_step_pipeline(task, xc, PP_M, seed=3)),
            ("xc_plain", 0.5, lambda: step_lib.make_train_step(task, data_parallel=True, seed=3)),
        ):
            state = _state(xc, TP_SGD, init["xc"])
            _float64(state.model).keep_prob = keep
            state.flat_grad = None
            state.optimizer = step_lib.make_optimizer(TrainConfig(**TP_SGD), state.model)
            state, metrics = make()(state, batch)
            out[name] = result(state, metrics)
    model = _state(xc, TP_SGD, init["xc"]).model
    model.keep_prob = 1.0
    out["xc_eval"] = step_lib.compute_metrics(
        pipeline_step.make_eval_step_pipeline(task, xc, PP_M)(model, rows(f"xc{world}_eval")))

    # fit at pipeline_parallel 2: 2 + 2 steps resumed against 4, both models
    fit = {}
    for key, cfg in (("vit", ModelConfig(**dict(VIT_TINY, vit_layers=2))), ("xc", zero_fit_model())):
        for name, stops in (("resumed", (2, 4)), ("straight", (4,))):
            for stop in stops:
                t = ClassifierTrainer(os.path.join(directory, f"pp-fit-{key}-{name}"), None, cfg,
                                      TrainConfig(**PP_FIT, n_devices=world), device="cpu")
                fit[f"{key}_{name}_{stop}"] = t.fit(batch_size=8, steps=stop).final_metrics
    out["fit_runs"] = fit
    try:
        ClassifierTrainer(os.path.join(directory, "pp-fit-odd"), None, ModelConfig(**dict(VIT_TINY, vit_layers=2)),
                          TrainConfig(**dict(PP_FIT, pipeline_microbatches=4)), device="cpu").fit(
            batch_size=6 * lay.dp, steps=1)
    except ValueError as e:
        out["fit_batch_error"] = str(e)
    return out


def moe_expert_fn(p, x):
    """The expert-parallel tests' expert: ``tanh(x @ w + b)``."""
    return torch.tanh(x @ p["w"] + p["b"])


MOE_FACTORS = {"moe": 1.25, "drop": 0.25}


def _moe_mode(rank: int, world: int, directory: str):
    from tensorflowdistributedlearning_tpu_torch.parallel import expert, mesh

    data = dict(np.load(os.path.join(directory, "moe.npz")))
    lay = mesh.init_mesh(world, expert=True)
    out = {"layout": [lay.dp, lay.tp, lay.model_index, mesh.expert_parallel_degree(), mesh.model_parallel_degree()]}
    group = mesh.expert_group()
    for name, factor in MOE_FACTORS.items():
        leaves = {k: torch.from_numpy(data[k]).requires_grad_() for k in ("gate", "x")}
        mine = {k: torch.from_numpy(data[k][lay.model_index]).requires_grad_() for k in ("w", "b")}
        y = expert.moe_apply(moe_expert_fn, mine, leaves["gate"], leaves["x"], capacity_factor=factor, group=group)
        (torch.from_numpy(data["w_out"]) * y).sum().backward()
        out[name] = {"out": y.detach(), **{k: t.grad for k, t in {**mine, **leaves}.items()}}
    try:
        expert.moe_apply(moe_expert_fn, mine, torch.zeros(data["gate"].shape[0], 2 * world),
                         torch.from_numpy(data["x"]), group=group)
    except ValueError as e:
        out["wide_error"] = str(e)
    return out


EP = 2
EP_VIT = dict(backbone="vit", num_classes=4, input_shape=(16, 16), input_channels=3, patch_size=4, embed_dim=32,
              vit_layers=4, num_heads=4, output_stride=None, moe_experts=EP, moe_capacity_factor=2.0)
EP_FIT = dict(optimizer="adam", lr=1e-3, ema_decay=0.9, grad_clip_norm=1.0, augmentation="none",
              checkpoint_every_steps=2, seed=9, expert_parallel=EP)


def _ep_mode(rank: int, world: int, directory: str):
    from tensorflowdistributedlearning_tpu_torch.config import ModelConfig, TrainConfig
    from tensorflowdistributedlearning_tpu_torch.models import vit
    from tensorflowdistributedlearning_tpu_torch.parallel import mesh
    from tensorflowdistributedlearning_tpu_torch.train import step as step_lib
    from tensorflowdistributedlearning_tpu_torch.train.fit import ClassifierTrainer
    from tensorflowdistributedlearning_tpu_torch.train.state import replicate

    init = torch.load(os.path.join(directory, "ep_init.pt"), weights_only=False)
    cfg = ModelConfig(**EP_VIT)
    lay = mesh.init_mesh(EP, expert=True)
    batch = {k: torch.from_numpy(v) for k, v in np.load(os.path.join(directory, "ep_batch.npz")).items()}
    rows = {k: v[mesh.shard_rows(len(v))] for k, v in batch.items()}
    task = step_lib.ClassificationTask()
    out = {"layout": [lay.dp, lay.tp, lay.data_index, lay.model_index, mesh.expert_parallel_degree()]}
    for name, kw, accum in (("ep", {}, 1), ("ep_zero", dict(weight_update_sharding=True), 1), ("ep_accum", {}, 2)):
        state = replicate(_state(cfg, dict(TP_SGD, expert_parallel=EP, **kw), init))
        out[f"{name}_groups"] = sorted({str(m.expert_group is not None) for m in vit.moe_layers(state.model)})
        out[f"{name}_zero"] = state.zero is not None
        state, metrics = step_lib.make_train_step(task, data_parallel=True, accum=accum)(state, rows)
        out[name] = {"params": _snapshot(state), "metrics": step_lib.compute_metrics(metrics),
                     "fractions": [m.expert_fraction for m in vit.moe_layers(state.model)]}
    model = replicate(_state(cfg, dict(TP_SGD, expert_parallel=EP), init)).model
    eval_rows = dict(rows, valid=torch.ones(len(rows["labels"])))
    out["eval"] = step_lib.compute_metrics(step_lib.make_eval_step(task, data_parallel=True)(model, eval_rows))

    fit = {}
    for zero in (False, True):
        for name, stops in (("resumed", (2, 4)), ("straight", (4,))):
            for stop in stops:
                t = ClassifierTrainer(os.path.join(directory, f"ep-fit-{zero}-{name}"), None, cfg,
                                      TrainConfig(**EP_FIT, weight_update_sharding=zero, n_devices=world),
                                      device="cpu")
                fit[f"{zero}_{name}_{stop}"] = t.fit(batch_size=8, steps=stop).final_metrics
    out["fit_runs"] = fit
    return out


# (stride, rate, groups, phase) of the spatial_conv2d cases; on 16 rows a
# rate-8 halo exceeds the 4-row blocks of 4 ranks and rate 16 every block,
# so both paths run
SP_CONV_CASES = ((1, 1, 1, "same"), (2, 1, 1, "same"), (1, 2, 1, "same"), (1, 4, 1, "same"), (1, 8, 1, "same"),
                 (1, 16, 1, "same"), (2, 1, 4, "fixed"), (1, 2, 4, "same"), (2, 2, 1, "fixed"), (2, 16, 1, "same"))
SP_HALO = 2


def _sp_blocks(x: torch.Tensor, rank: int, world: int, dim: int = 1) -> torch.Tensor:
    k = x.shape[dim] // world
    return x.narrow(dim, rank * k, k)


def _grad_case(fn, inputs, cotangent):
    """``fn(*inputs)`` with every input a fresh leaf; the output and each
    input's gradient of ``sum(output * cotangent)``."""
    leaves = [t.detach().clone().requires_grad_(t.is_floating_point()) for t in inputs]
    y = fn(*leaves)
    (y * cotangent).sum().backward()
    return {"y": y.detach(), "grads": [t.grad for t in leaves]}


def _spops_mode(rank: int, world: int, directory: str):
    from tensorflowdistributedlearning_tpu_torch.parallel import mesh, spatial

    lay = mesh.init_mesh(world, sequence=True)
    data = {k: torch.from_numpy(v) for k, v in np.load(os.path.join(directory, "spops.npz")).items()}
    x = data["x"]
    xl = _sp_blocks(x, rank, world)
    out = {"layout": (lay.dp, lay.tp, lay.data_index, mesh.sequence_index(), mesh.sequence_parallel_degree())}
    out["conv"] = [
        dict(_grad_case(lambda a, w: spatial.spatial_conv2d(a, w, stride=s, rate=r, groups=g, phase=ph),
                        (xl, data[f"w{i}"]), _sp_blocks(data[f"g{i}"], rank, world)),
             gather=spatial.uses_gather(xl.shape[1], 3, r))
        for i, (s, r, g, ph) in enumerate(SP_CONV_CASES)
    ]
    out["halo"] = _grad_case(lambda a: spatial.halo_exchange(a, SP_HALO), (xl,), data["g_halo"][rank])
    out["pool"] = _grad_case(lambda a: spatial.spatial_max_pool(a, 3, 2), (xl,), _sp_blocks(data["g_pool"], rank, world))
    out["mean"] = _grad_case(lambda a: spatial.spatial_global_mean(a), (xl,), data["g_mean"][rank])
    out["gather"] = _grad_case(lambda a: spatial.spatial_gather(a), (xl,), data["g_gather"][rank])
    out["ring_gather"] = _grad_case(lambda a: spatial.ring_all_gather(a, axis=1), (xl,), data["g_gather"][rank])
    out["scatter"] = _grad_case(lambda a: spatial.reduce_scatter(a, axis=1), (data["y_scatter"][rank],),
                                _sp_blocks(data["g_scatter"], rank, world))
    return out


# (causal, masked, segmented) of the ring-attention cases
RING_CASES = {"plain": (False, False, False), "causal": (True, False, False), "masked": (False, True, False),
              "segmented": (False, False, True), "composed": (True, True, True)}


def _ring_mode(rank: int, world: int, directory: str):
    from tensorflowdistributedlearning_tpu_torch.parallel import mesh
    from tensorflowdistributedlearning_tpu_torch.parallel.ring_attention import make_ring_attention

    mesh.init_mesh(world, sequence=True)
    data = {k: torch.from_numpy(v) for k, v in np.load(os.path.join(directory, "ring.npz")).items()}
    out = {}
    for name, (causal, masked, segmented) in RING_CASES.items():
        fn = make_ring_attention(causal=causal, masked=masked, segmented=segmented)
        extras = ([data["kv_mask"]] if masked else []) + ([data["segment_ids"]] if segmented else [])
        out[name] = _grad_case(lambda q, k, v, *e: fn(q, k, v, *e), [data["q"], data["k"], data["v"], *extras],
                               _sp_blocks(data["g"], rank, world))
        out[name]["grads"] = out[name]["grads"][:3]
    return out


SP = 2
SP_SEG = dict(n_blocks=(1, 1, 1), input_shape=(32, 32), base_depth=16, width_multiplier=0.125,
              use_pallas_depthwise=True)
SP_MODELS = {
    "resnet_seg": SP_SEG,
    "resnet_cls": dict(n_blocks=(1, 1, 1), input_shape=(64, 64), input_channels=3, base_depth=16,
                       width_multiplier=0.125, num_classes=10),
    "xception_seg": dict(backbone="xception", input_shape=(32, 32), base_depth=16, width_multiplier=0.0625),
    "xception_cls": dict(backbone="xception", input_shape=(64, 64), input_channels=3, width_multiplier=0.0625,
                         num_classes=10, output_stride=None),
    "vit": VIT_TINY,
}
SP_FIT = dict(VIT_ADAMW, checkpoint_every_steps=2, seed=5, sequence_parallel=SP)
SP_TRAINER = dict(n_folds=2, seed=0, checkpoint_every_steps=2, eval_throttle_secs=0, save_best=2,
                  train_log_every_steps=1)


def _sp_mode(rank: int, world: int, directory: str):
    from tensorflowdistributedlearning_tpu_torch.config import ModelConfig, TrainConfig
    from tensorflowdistributedlearning_tpu_torch.data import pipeline as pipeline_lib
    from tensorflowdistributedlearning_tpu_torch.models import empty_model
    from tensorflowdistributedlearning_tpu_torch.parallel import mesh, spatial
    from tensorflowdistributedlearning_tpu_torch.train import step as step_lib
    from tensorflowdistributedlearning_tpu_torch.train.fit import ClassifierTrainer
    from tensorflowdistributedlearning_tpu_torch.train.state import replicate
    from tensorflowdistributedlearning_tpu_torch.train.trainer import Trainer

    lay = mesh.init_mesh(SP, sequence=True)
    init = torch.load(os.path.join(directory, "sp_init.pt"), weights_only=False)
    data = {k: torch.from_numpy(v) for k, v in np.load(os.path.join(directory, "sp_batches.npz")).items()}
    out = {"layout": (lay.dp, lay.tp, lay.data_index, mesh.sequence_index(), mesh.sequence_parallel_degree())}
    placed = mesh.shard_batch_spatial({"images": data["seg_images"], "labels": data["seg_labels"]})
    out["placed"] = {k: v.clone() for k, v in placed.items()}
    seg = ModelConfig(**SP_SEG)
    rows = {k: data[f"seg_{k}"][mesh.shard_rows(len(data["seg_labels"]))] for k in ("images", "labels")}
    if world == 2:
        fwd = {}
        for name, kw in SP_MODELS.items():
            model = empty_model(ModelConfig(**kw), "cpu", spatial=True)
            model.load_state_dict(init[name])
            with torch.no_grad():
                fwd[name] = model(spatial.shard_spatial(data[f"{name}_images"]))
        out["forward"] = fwd

    state = replicate(_state(seg, dict(TP_SGD, sequence_parallel=SP), init["step"]))
    before = _snapshot(state)
    state, metrics = step_lib.make_train_step(_bce_task(), data_parallel=True)(state, rows)
    after = state.model_state_dict()
    names = [n for n, _ in state.model.named_parameters()]
    out["step"] = {"loss": step_lib.compute_metrics(metrics)["loss"], "state": after,
                   "grads": {n: before[n] - after[n] for n in names}}
    plain = _state(seg, TP_SGD, init["step"])
    loss, _ = step_lib.forward_backward(plain, _bce_task(), rows)
    out["plain_share"] = {"loss": float(loss), "grads": {n: p.grad.clone() for n, p in plain.model.named_parameters()},
                          "state": plain.model_state_dict()}

    if world == 4:
        run = {}
        for name, kw in (("replicated", {}), ("zero", {"weight_update_sharding": True})):
            state = replicate(_state(seg, dict(TP_ADAM, sequence_parallel=SP, **kw), init["step"]))
            out[f"{name}_sharded"] = state.zero is not None
            train_step = step_lib.make_train_step(_bce_task(), data_parallel=True)
            for _ in range(2):
                state, _ = train_step(state, rows)
            run[name] = state.state_dict()
        out["adam"] = run
        return out

    data_dir = os.path.join(directory, "data")
    model = {k: v for k, v in SP_SEG.items()}
    trainer = Trainer(os.path.join(directory, "sp-model"), data_dir,
                      train_config=TrainConfig(**SP_TRAINER, sequence_parallel=SP), device="cpu", **model)
    out["train"] = trainer.train(pipeline_lib.discover_ids(data_dir), batch_size=4, steps=2)
    out["predict"] = trainer.predict(os.path.join(directory, "test"), batch_size=4)
    vit = ClassifierTrainer(os.path.join(directory, "sp-fit"), None, ModelConfig(**VIT_TINY),
                            TrainConfig(**SP_FIT, n_devices=world), device="cpu")
    out["fit"] = vit.fit(batch_size=8, steps=2).final_metrics
    return out


def _trainer_mode(rank: int, world: int, directory: str):
    from tensorflowdistributedlearning_tpu_torch.config import TrainConfig
    from tensorflowdistributedlearning_tpu_torch.data import pipeline as pipeline_lib
    from tensorflowdistributedlearning_tpu_torch.train.trainer import Trainer

    model_dir = os.path.join(directory, "model")
    data = os.path.join(directory, "data")
    writes = []

    def audit(event, args):
        # every way a process creates, changes or removes a file or directory
        if event not in ("open", "os.rename", "os.remove", "os.rmdir", "os.mkdir", "shutil.rmtree"):
            return
        path = args[0]
        if event == "open":
            mode, flags = args[1], args[2]
            writing = any(c in (mode or "") for c in "wax+") or bool(flags & (os.O_WRONLY | os.O_RDWR | os.O_CREAT))
            if not writing:
                return
        if not isinstance(path, (str, bytes, os.PathLike)) or not os.fsdecode(path).startswith(model_dir):
            return
        if event == "os.mkdir" and os.path.isdir(path):
            return  # makedirs(exist_ok=True) of a directory that is there
        writes.append((event, os.fsdecode(path)))

    sys.addaudithook(audit)
    tcfg = dict(n_folds=2, seed=0, checkpoint_every_steps=2, eval_throttle_secs=0, save_best=2)
    model = {k: v for k, v in TINY.items() if k != "input_shape"}
    ids = pipeline_lib.discover_ids(data)

    def trainer(**kw):
        return Trainer(model_dir, data, train_config=TrainConfig(**dict(tcfg, **kw)), device="cpu",
                       input_shape=(32, 32), **model)

    out = {"results": trainer(n_devices=world).train(ids, batch_size=4, steps=4)}
    out["first_writes"] = list(writes)
    del writes[:]
    out["rerun"] = trainer().train(ids, batch_size=4, steps=4)
    out["rerun_writes"] = list(writes)
    for what, call in (
        ("n_devices", lambda: trainer(n_devices=world + 1)),
        ("predict", lambda: trainer().predict(os.path.join(directory, "test"), batch_size=4)),
        ("batch", lambda: trainer().train(ids, batch_size=world + 1, steps=4)),
    ):
        try:
            call()
            out[what] = None
        except (ValueError, RuntimeError) as e:
            out[what] = f"{type(e).__name__}: {e}"
    return out


# the JAX package's tiny ViT (tests/test_vit.py) and its Switch-MoE twin
VTP_VIT = dict(backbone="vit", num_classes=4, input_shape=(16, 16), input_channels=3, patch_size=4, embed_dim=32,
               vit_layers=2, num_heads=4, output_stride=None)
VTP_MOE = dict(VTP_VIT, moe_experts=2)
VTP_FIT = dict(optimizer="adam", lr=1e-3, ema_decay=0.9, grad_clip_norm=1.0, augmentation="none",
               checkpoint_every_steps=2, seed=7)
VTP_PRESET = "vit_tiny_tensor_parallel"


def vtp_preset():
    """A tiny ViT preset for ``fit_preset`` (put into ``configs.PRESETS``)."""
    from tensorflowdistributedlearning_tpu_torch import configs
    from tensorflowdistributedlearning_tpu_torch.config import ModelConfig, TrainConfig

    return configs.Preset(model=ModelConfig(**VTP_VIT), train=TrainConfig(**VTP_FIT), global_batch=8,
                          description="the JAX package's tiny ViT")


def _moe_refusals(directory: str, cfg):
    """The texts ``fit_preset`` raises for a tiny MoE ViT preset at
    ``model_parallel`` TP beside data parallelism: given, and planned."""
    import dataclasses

    from tensorflowdistributedlearning_tpu_torch import configs
    from tensorflowdistributedlearning_tpu_torch.train.fit import fit_preset

    configs.PRESETS[VTP_PRESET + "_moe"] = dataclasses.replace(vtp_preset(), model=cfg)
    out = {}
    for how in ("explicit", "auto"):
        try:
            fit_preset(VTP_PRESET + "_moe", os.path.join(directory, f"vtp-moe-{how}"), steps=1, device="cpu",
                       parallelism=how, model_parallel=TP)
            out[how] = None
        except NotImplementedError as e:
            out[how] = str(e)
    return out


def _vtp_mode(rank: int, world: int, directory: str):
    import dataclasses

    from tensorflowdistributedlearning_tpu_torch import configs
    from tensorflowdistributedlearning_tpu_torch.config import ModelConfig
    from tensorflowdistributedlearning_tpu_torch.models.vit import LayerNorm
    from tensorflowdistributedlearning_tpu_torch.parallel import collectives, mesh, tensor
    from tensorflowdistributedlearning_tpu_torch.train import step as step_lib
    from tensorflowdistributedlearning_tpu_torch.train.fit import fit_preset
    from tensorflowdistributedlearning_tpu_torch.train.state import replicate

    lay = mesh.init_mesh(TP)
    init = torch.load(os.path.join(directory, "vtp_init.pt"), weights_only=False)
    data = np.load(os.path.join(directory, "vtp_batch.npz"))
    out = {"layout": (lay.dp, lay.tp, lay.data_index, lay.model_index)}

    # LayerNorm alone at tp 2: its output and gradients, and the output of
    # the mistake it must not make (statistics of the local channels, each
    # rank normalising its own channels by them)
    ln = LayerNorm(data["ln_x"].shape[-1])
    ln.load_state_dict(init["ln"])
    layout = tensor.layout_for(ln, TP, lay.model_index, lay.model_group)
    tensor.shard_model(ln, layout)
    x = torch.from_numpy(data["ln_x"]).requires_grad_()
    y = ln(x)
    (y * torch.from_numpy(data["ln_cotangent"])).sum().backward()
    grads = layout.gather([("weight", ln.weight.grad), ("bias", ln.bias.grad)])
    k = ln.weight.shape[0]
    mine = x.detach().narrow(-1, lay.model_index * k, k)
    local = torch.nn.functional.layer_norm(mine, (k,), ln.weight.detach(), ln.bias.detach(), ln.eps)
    out["ln"] = {"y": y.detach(), "dx": x.grad, "dweight": grads[0], "dbias": grads[1],
                 "local_statistics": collectives.gather_channels(local, lay.model_group)}

    rows = mesh.shard_rows(len(data["labels"]))
    batch = {"images": torch.from_numpy(data["images"][rows]), "labels": torch.from_numpy(data["labels"][rows])}
    for name, which, kw in (("vit", "vit", {}), ("vit_zero", "vit", {"weight_update_sharding": True}),
                            ("moe", "moe", {}), ("vit_bf16", "vit", {})):
        cfg = ModelConfig(**(VTP_MOE if which == "moe" else VTP_VIT))
        if name == "vit_bf16":
            cfg = dataclasses.replace(cfg, dtype="bfloat16")
        state = replicate(_state(cfg, dict(TP_SGD, model_parallel=TP, **kw), init[which]))
        with torch.no_grad():
            logits = state.model.eval()(torch.from_numpy(data["images"]))
        if which == "moe" and lay.dp > 1:
            out[name] = {"logits": logits, "refused": _moe_refusals(directory, cfg)}
            continue
        state, metrics = tensor.make_train_step_gspmd(step_lib.ClassificationTask())(state, batch)
        out[name] = {"logits": logits, "loss": step_lib.compute_metrics(metrics)["loss"],
                     "grads": _whole_grads(state), "state": state.model_state_dict(),
                     "slices": {n: tuple(t.shape) for n, t in state.model.state_dict().items()}}

    # fit_preset at model_parallel 2 through the planner
    configs.PRESETS[VTP_PRESET] = vtp_preset()
    fit = fit_preset(VTP_PRESET, os.path.join(directory, "vtp-fit"), steps=2, device="cpu", parallelism="auto",
                     model_parallel=TP, n_devices=world)
    out["fit"] = {"metrics": fit.final_metrics, "n_params": fit.n_params}
    return out


def _ledger_mode(rank: int, world: int, directory: str):
    """One ``Trainer.train`` over the ranks, 2 folds x 4 steps, a log
    window every 2 steps: each rank writes its own run ledger into the
    model dir (``telemetry.jsonl``, ``telemetry-1.jsonl``) for the
    telemetry readers' tests."""
    from tensorflowdistributedlearning_tpu_torch.config import TrainConfig
    from tensorflowdistributedlearning_tpu_torch.data import pipeline as pipeline_lib
    from tensorflowdistributedlearning_tpu_torch.train.trainer import Trainer

    model = {k: v for k, v in TINY.items() if k != "input_shape"}
    tcfg = TrainConfig(n_folds=2, seed=0, checkpoint_every_steps=2, eval_throttle_secs=0, save_best=2,
                       train_log_every_steps=2, trace_sample_rate=1.0, n_devices=world)
    data = os.path.join(directory, "data")
    trainer = Trainer(os.path.join(directory, "model"), data, train_config=tcfg, device="cpu", input_shape=(32, 32),
                      **model)
    return {"results": trainer.train(pipeline_lib.discover_ids(data), batch_size=4, steps=4)}


def main(argv) -> int:
    mode, rank, world, store, directory = argv[0], int(argv[1]), int(argv[2]), argv[3], argv[4]
    torch.set_num_threads(1)
    from tensorflowdistributedlearning_tpu_torch.parallel import multihost

    multihost.initialize(store, world, rank, backend="gloo", timeout=TIMEOUT_S)
    out = {"step": _step_mode, "accum": _accum_mode, "fit": _fit_mode, "trainer": _trainer_mode,
           "zero": _zero_mode, "tp": _tp_mode, "pp": _pp_mode, "moe": _moe_mode, "ep": _ep_mode,
           "spops": _spops_mode, "ring": _ring_mode, "sp": _sp_mode, "vtp": _vtp_mode, "ledger": _ledger_mode}[mode](
        rank, world, directory)
    multihost.barrier()
    torch.save(out, os.path.join(directory, f"rank{rank}.pt"))
    multihost.shutdown()
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
