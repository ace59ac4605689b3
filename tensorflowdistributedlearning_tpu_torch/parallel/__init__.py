"""Data, tensor, pipeline, expert and sequence parallelism over
``torch.distributed`` (counterpart of the JAX package's ``parallel``): the
process group and its helpers (:mod:`.multihost`), the (batch, model)
layout of the ranks (:mod:`.mesh`), the collectives of the steps
(:mod:`.collectives`), ZeRO-1 (:mod:`.zero`), tensor parallelism
(:mod:`.tensor`), the GPipe runner (:mod:`.pipeline`), the
mixture-of-experts dispatch (:mod:`.expert`), the halo-exchange
convolutions of the sequence axis (:mod:`.spatial`) and ring attention
(:mod:`.ring_attention`), and the parallelism planner (:mod:`.planner`);
the functions the JAX package exports from those modules are exported here
under their names (its sharding helpers have no counterpart: the layouts
and groups of :mod:`.mesh` stand in for them)."""

from tensorflowdistributedlearning_tpu_torch.parallel import collectives, mesh, multihost
from tensorflowdistributedlearning_tpu_torch.parallel.expert import moe_apply, top1_dispatch
from tensorflowdistributedlearning_tpu_torch.parallel.mesh import BATCH_AXIS, MODEL_AXIS, SEQUENCE_AXIS, local_batch_size
from tensorflowdistributedlearning_tpu_torch.parallel.multihost import initialize as initialize_multihost
from tensorflowdistributedlearning_tpu_torch.parallel.multihost import process_info
from tensorflowdistributedlearning_tpu_torch.parallel.pipeline import make_pipeline_fn, pipeline_apply, stack_stage_params
from tensorflowdistributedlearning_tpu_torch.parallel.planner import (
    Layout,
    ParallelPlan,
    PlanError,
    Topology,
    plan,
    plan_for_config,
    render_plan_table,
    validate_config,
)
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
from tensorflowdistributedlearning_tpu_torch.parallel.tensor import (
    make_train_step_gspmd,
    shard_state_tensor_parallel,
    tensor_parallel_specs,
)
from tensorflowdistributedlearning_tpu_torch.parallel.zero import apply_gradients_sharded, weight_update_specs

__all__ = [
    "BATCH_AXIS",
    "Layout",
    "MODEL_AXIS",
    "ParallelPlan",
    "PlanError",
    "SEQUENCE_AXIS",
    "Topology",
    "apply_gradients_sharded",
    "attention_reference",
    "collectives",
    "halo_exchange",
    "initialize_multihost",
    "local_batch_size",
    "make_pipeline_fn",
    "make_ring_attention",
    "make_train_step_gspmd",
    "mesh",
    "moe_apply",
    "multihost",
    "pipeline_apply",
    "plan",
    "plan_for_config",
    "process_info",
    "reduce_scatter",
    "render_plan_table",
    "ring_all_gather",
    "ring_attention",
    "shard_state_tensor_parallel",
    "spatial_conv2d",
    "stack_stage_params",
    "tensor_parallel_specs",
    "top1_dispatch",
    "validate_config",
    "weight_update_specs",
]
