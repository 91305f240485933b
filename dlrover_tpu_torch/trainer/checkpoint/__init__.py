from dlrover_tpu_torch.trainer.checkpoint.checkpointer import (  # noqa: F401
    Checkpointer,
    StorageType,
)
