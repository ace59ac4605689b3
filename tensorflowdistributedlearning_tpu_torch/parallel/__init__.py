"""Data, tensor and pipeline parallelism over ``torch.distributed``
(counterpart of the JAX package's ``parallel``): the process group and its
helpers (:mod:`.multihost`), the (batch, model) layout of the ranks
(:mod:`.mesh`), the collectives of the steps (:mod:`.collectives`),
ZeRO-1 (:mod:`.zero`), tensor parallelism (:mod:`.tensor`) and the GPipe
runner (:mod:`.pipeline`)."""

from tensorflowdistributedlearning_tpu_torch.parallel import collectives, mesh, multihost

__all__ = ["collectives", "mesh", "multihost"]
