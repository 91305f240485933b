"""``auto_accelerate`` of the port (``dlrover_tpu/accelerate``), for one
device; strategies over several devices are ROADMAP A4."""

from dlrover_tpu_torch.accelerate.api import (
    AccelerateResult,
    ModelProfile,
    Strategy,
    analyse_model,
    auto_accelerate,
)

__all__ = [
    "AccelerateResult",
    "ModelProfile",
    "Strategy",
    "analyse_model",
    "auto_accelerate",
]
