from dlrover_tpu_torch.rl.config import RLConfig, RoleConfig  # noqa: F401
from dlrover_tpu_torch.rl.engine import ModelEngine  # noqa: F401
from dlrover_tpu_torch.rl.ppo import (  # noqa: F401
    compute_gae,
    ppo_loss,
    ReplayBuffer,
)
from dlrover_tpu_torch.rl.inference import (  # noqa: F401
    InferenceBackend,
    JitSamplerBackend,
    KVCacheBackend,
)
from dlrover_tpu_torch.rl.trainer import RLHFTrainer  # noqa: F401
from dlrover_tpu_torch.rl.kv_cache import (  # noqa: F401
    BlockPool,
    PagedCacheConfig,
    init_block_pool,
)
from dlrover_tpu_torch.rl.scheduler import (  # noqa: F401
    ContinuousBatchingScheduler,
    GenRequest,
    GenResult,
    SchedulerConfig,
)
