"""``auto_accelerate`` of the port (``dlrover_tpu/accelerate``): one
card, or a mesh of ``data``, ``fsdp``, ``tensor``, ``seq`` and ``pipe``
axes over the world's ranks; the strategy search is not ported yet."""

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
