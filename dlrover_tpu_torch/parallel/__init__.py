"""The train step of the port (``dlrover_tpu/parallel``).  One device
for now: the mesh, shardings, collectives and pipeline are ROADMAP A4."""

from dlrover_tpu_torch.parallel.train_step import (
    TrainStepFns,
    build_train_step,
)

__all__ = ["TrainStepFns", "build_train_step"]
