"""Data parallelism over ``torch.distributed`` (counterpart of the JAX
package's ``parallel``): the process group and its helpers
(:mod:`.multihost`), the batch axis (:mod:`.mesh`) and the collectives of
the data-parallel step (:mod:`.collectives`)."""

from tensorflowdistributedlearning_tpu_torch.parallel import collectives, mesh, multihost

__all__ = ["collectives", "mesh", "multihost"]
