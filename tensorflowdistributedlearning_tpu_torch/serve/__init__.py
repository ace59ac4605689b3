"""The serving tier of the port (counterpart of the JAX package's
``serve``): the bucketed engine, the micro-batcher, the HTTP server and the
quantization accuracy gate, under the JAX package's exported names; the
fleet, its router, autoscaler and promotions come with queue A 14.4."""

from tensorflowdistributedlearning_tpu_torch.serve.batcher import (
    DeadlineExceededError,
    MicroBatcher,
    QueueFullError,
    Request,
    ServerClosedError,
)
from tensorflowdistributedlearning_tpu_torch.serve.engine import (
    DEFAULT_BUCKETS,
    InferenceEngine,
    RequestTooLargeError,
)
from tensorflowdistributedlearning_tpu_torch.serve.quant_check import DEFAULT_THRESHOLDS, output_delta, run_quant_check
from tensorflowdistributedlearning_tpu_torch.serve.server import ServingServer, bind_ephemeral

__all__ = [
    "DEFAULT_BUCKETS",
    "DEFAULT_THRESHOLDS",
    "DeadlineExceededError",
    "InferenceEngine",
    "MicroBatcher",
    "QueueFullError",
    "Request",
    "RequestTooLargeError",
    "ServerClosedError",
    "ServingServer",
    "bind_ephemeral",
    "output_delta",
    "run_quant_check",
]
