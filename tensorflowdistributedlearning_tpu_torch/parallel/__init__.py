"""Data, tensor, pipeline and expert parallelism over ``torch.distributed``
(counterpart of the JAX package's ``parallel``): the process group and its
helpers (:mod:`.multihost`), the (batch, model) layout of the ranks
(:mod:`.mesh`), the collectives of the steps (:mod:`.collectives`),
ZeRO-1 (:mod:`.zero`), tensor parallelism (:mod:`.tensor`), the GPipe
runner (:mod:`.pipeline`) and the mixture-of-experts dispatch
(:mod:`.expert`, whose ``moe_apply`` and ``top1_dispatch`` are exported
here as the JAX package exports them)."""

from tensorflowdistributedlearning_tpu_torch.parallel import collectives, mesh, multihost
from tensorflowdistributedlearning_tpu_torch.parallel.expert import moe_apply, top1_dispatch

__all__ = ["collectives", "mesh", "multihost", "moe_apply", "top1_dispatch"]
