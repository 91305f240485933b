"""Optimizers of the port (``dlrover_tpu/optimizers``)."""

from dlrover_tpu_torch.optimizers.agd import AGD
from dlrover_tpu_torch.optimizers.low_bit import (
    QTensor,
    QuantizedMoments,
    dequantize_qtensor,
    quantized_state_from_jax,
)

__all__ = [
    "AGD",
    "QTensor",
    "QuantizedMoments",
    "dequantize_qtensor",
    "quantized_state_from_jax",
]
