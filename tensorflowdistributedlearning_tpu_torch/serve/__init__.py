from tensorflowdistributedlearning_tpu_torch.serve.batcher import (
    DeadlineExceededError,
    MicroBatcher,
    QueueFullError,
    ServerClosedError,
)
from tensorflowdistributedlearning_tpu_torch.serve.engine import (
    DEFAULT_BUCKETS,
    InferenceEngine,
    RequestTooLargeError,
)
from tensorflowdistributedlearning_tpu_torch.serve.server import ServingServer, bind_ephemeral

__all__ = [
    "DEFAULT_BUCKETS",
    "DeadlineExceededError",
    "InferenceEngine",
    "MicroBatcher",
    "QueueFullError",
    "RequestTooLargeError",
    "ServerClosedError",
    "ServingServer",
    "bind_ephemeral",
]
