"""The training loop of the port (``dlrover_tpu/trainer``)."""

from dlrover_tpu_torch.trainer.trainer import Trainer, TrainingArgs

__all__ = ["Trainer", "TrainingArgs"]
