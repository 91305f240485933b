"""Training-process side of the elastic launch (``dlrover_tpu/trainer/
elastic``): the world from the agent's env and step-level progress.
The elastic sampler comes with the data plane (ROADMAP A3c.6)."""

from dlrover_tpu_torch.trainer.elastic.context import (  # noqa: F401
    ElasticContext,
    init_distributed,
    local_rank,
    process_count,
    process_rank,
)
from dlrover_tpu_torch.trainer.elastic.trainer import ElasticTrainer  # noqa: F401
