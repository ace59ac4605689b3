"""Training of the port (counterpart of the JAX package's ``train``): the
state, the tasks and the step builders, under the JAX package's exported
names. ``make_multi_train_step`` (a K-step ``lax.scan`` compiled as one
program) has no eager counterpart."""

from tensorflowdistributedlearning_tpu_torch.train.state import TrainState, create_train_state
from tensorflowdistributedlearning_tpu_torch.train.step import (
    ClassificationTask,
    SegmentationTask,
    make_eval_step,
    make_optimizer,
    make_predict_step,
    make_train_step,
)

__all__ = [
    "TrainState",
    "create_train_state",
    "ClassificationTask",
    "SegmentationTask",
    "make_eval_step",
    "make_optimizer",
    "make_predict_step",
    "make_train_step",
]
