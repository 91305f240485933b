"""Parallelism of the port (``dlrover_tpu/parallel``): the mesh over the
world's ranks, the data, fsdp, tensor, seq and pipe shardings, their
collectives, the pipeline and the train step.  The expert axis is
ROADMAP A7."""

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
