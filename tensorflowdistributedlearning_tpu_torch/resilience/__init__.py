"""Fault injection and retries of the port (counterpart of the JAX
package's ``resilience``), under its exported names; preemption handling
and the supervisor come with queue A 14.2."""

from tensorflowdistributedlearning_tpu_torch.resilience.faults import (
    SITE_CHECKPOINT,
    SITE_DATA,
    SITE_IO,
    SITE_STEP,
    FaultInjector,
    FaultSpec,
    InjectedFault,
    TransientInjectedIOError,
    parse_fault_spec,
)
from tensorflowdistributedlearning_tpu_torch.resilience.retry import RetryExhaustedError, call_with_retry

__all__ = [
    "FaultInjector",
    "FaultSpec",
    "InjectedFault",
    "RetryExhaustedError",
    "SITE_CHECKPOINT",
    "SITE_DATA",
    "SITE_IO",
    "SITE_STEP",
    "TransientInjectedIOError",
    "call_with_retry",
    "parse_fault_spec",
]
