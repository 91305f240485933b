"""Parallelism of the port (``dlrover_tpu/parallel``): the mesh over the
world's ranks, the data and fsdp shardings, their collectives and the
train step.  Tensor, sequence and pipeline parallelism are ROADMAP
A4b."""

from dlrover_tpu_torch.parallel.mesh import (
    AxisName,
    MeshContext,
    create_parallel_mesh,
    destroy_parallel_mesh,
    get_mesh_context,
)
from dlrover_tpu_torch.parallel.sharding import (
    BatchSharding,
    LogicalAxisRules,
    Placement,
    default_rules,
)
from dlrover_tpu_torch.parallel.train_step import (
    TrainStepFns,
    build_train_step,
)

__all__ = [
    "AxisName",
    "BatchSharding",
    "LogicalAxisRules",
    "MeshContext",
    "Placement",
    "TrainStepFns",
    "build_train_step",
    "create_parallel_mesh",
    "default_rules",
    "destroy_parallel_mesh",
    "get_mesh_context",
]
