"""Training-process side of the elastic launch (``dlrover_tpu/trainer/
elastic``): the world from the agent's env, step-level progress, and
the elastic sampler that resumes mid-epoch at another world size."""

from dlrover_tpu_torch.trainer.elastic.context import (  # noqa: F401
    ElasticContext,
    init_distributed,
    local_rank,
    process_count,
    process_rank,
)
from dlrover_tpu_torch.trainer.elastic.sampler import (  # noqa: F401
    ElasticBatchIterator,
    ElasticDistributedSampler,
    restore_sampler_from_state,
    state_dict_with_sampler,
)
from dlrover_tpu_torch.trainer.elastic.trainer import ElasticTrainer  # noqa: F401
