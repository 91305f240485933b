"""Optimizers of the port (``dlrover_tpu/optimizers``)."""

from dlrover_tpu_torch.optimizers.agd import AGD
from dlrover_tpu_torch.optimizers.host_offload import (
    FusedOffloadState,
    HostOffloadAdamW,
    OffloadState,
    build_fused_offload_step,
    build_grouped_offload_step,
    build_offloaded_train_step,
    offload_state_from_jax,
)
from dlrover_tpu_torch.optimizers.low_bit import (
    QTensor,
    QuantizedMoments,
    dequantize_qtensor,
    quantized_state_from_jax,
)
from dlrover_tpu_torch.optimizers.schedules import (
    available_schedulers,
    get_scheduler,
)
from dlrover_tpu_torch.optimizers.wsam import (
    wsam_apply_sharpness,
    wsam_gradients,
)

__all__ = [
    "AGD",
    "FusedOffloadState",
    "HostOffloadAdamW",
    "OffloadState",
    "QTensor",
    "QuantizedMoments",
    "available_schedulers",
    "build_fused_offload_step",
    "build_grouped_offload_step",
    "build_offloaded_train_step",
    "dequantize_qtensor",
    "get_scheduler",
    "offload_state_from_jax",
    "quantized_state_from_jax",
    "wsam_apply_sharpness",
    "wsam_gradients",
]
