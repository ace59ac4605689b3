"""Data, tensor, pipeline, expert and sequence parallelism over
``torch.distributed`` (counterpart of the JAX package's ``parallel``): the
process group and its helpers (:mod:`.multihost`), the (batch, model)
layout of the ranks (:mod:`.mesh`), the collectives of the steps
(:mod:`.collectives`), ZeRO-1 (:mod:`.zero`), tensor parallelism
(:mod:`.tensor`), the GPipe runner (:mod:`.pipeline`), the
mixture-of-experts dispatch (:mod:`.expert`), the halo-exchange
convolutions of the sequence axis (:mod:`.spatial`) and ring attention
(:mod:`.ring_attention`); the functions the JAX package exports from
those modules are exported here under their names."""

from tensorflowdistributedlearning_tpu_torch.parallel import collectives, mesh, multihost
from tensorflowdistributedlearning_tpu_torch.parallel.expert import moe_apply, top1_dispatch
from tensorflowdistributedlearning_tpu_torch.parallel.ring_attention import (
    attention_reference,
    make_ring_attention,
    ring_attention,
)
from tensorflowdistributedlearning_tpu_torch.parallel.spatial import (
    halo_exchange,
    reduce_scatter,
    ring_all_gather,
    spatial_conv2d,
)

__all__ = [
    "attention_reference",
    "collectives",
    "halo_exchange",
    "make_ring_attention",
    "mesh",
    "moe_apply",
    "multihost",
    "reduce_scatter",
    "ring_all_gather",
    "ring_attention",
    "spatial_conv2d",
    "top1_dispatch",
]
