"""``auto_accelerate`` of the port (``dlrover_tpu/accelerate``): one
card, or a mesh of ``data`` and ``fsdp`` axes over the world's ranks;
tensor, sequence and pipeline strategies are ROADMAP A4b."""

from dlrover_tpu_torch.accelerate.analyser import (
    ModelProfile,
    analyse_model,
)
from dlrover_tpu_torch.accelerate.api import (
    AccelerateResult,
    auto_accelerate,
)
from dlrover_tpu_torch.accelerate.strategy import Strategy

__all__ = [
    "AccelerateResult",
    "ModelProfile",
    "Strategy",
    "analyse_model",
    "auto_accelerate",
]
