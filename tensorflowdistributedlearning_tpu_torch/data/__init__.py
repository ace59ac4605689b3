"""Input pipeline of the port (counterpart of the JAX package's ``data``):
augmentation, K-fold manifests, in-memory batches, the streaming data
service and synthetic batches, under the JAX package's exported names."""

from tensorflowdistributedlearning_tpu_torch.data.augment import (
    AugmentConfig,
    add_laplace_channel,
    augment_batch,
    prepare_eval_batch,
    tta_inverse,
    tta_transform,
    TTA_TRANSFORMS,
)
from tensorflowdistributedlearning_tpu_torch.data.folds import (
    build_fold_manifests,
    coverage_to_class,
    stratified_kfold,
    write_fold_manifests,
)
from tensorflowdistributedlearning_tpu_torch.data.pipeline import (
    InMemoryDataset,
    device_prefetch,
    eval_batches,
    host_shard,
    train_batches,
)
from tensorflowdistributedlearning_tpu_torch.data.service import (
    ArrayBatchSource,
    ClassificationRecordSource,
    DataServiceState,
    StreamingDataService,
    epoch_shard_assignment,
)
from tensorflowdistributedlearning_tpu_torch.data.synthetic import synthetic_batches

__all__ = [
    "AugmentConfig",
    "add_laplace_channel",
    "augment_batch",
    "prepare_eval_batch",
    "tta_inverse",
    "tta_transform",
    "TTA_TRANSFORMS",
    "build_fold_manifests",
    "coverage_to_class",
    "stratified_kfold",
    "write_fold_manifests",
    "InMemoryDataset",
    "device_prefetch",
    "eval_batches",
    "host_shard",
    "train_batches",
    "synthetic_batches",
    "ArrayBatchSource",
    "ClassificationRecordSource",
    "DataServiceState",
    "StreamingDataService",
    "epoch_shard_assignment",
]
