"""Kernels of the port and their plain PyTorch versions.

``ops/csrc/*.cu`` are hand-written CUDA C++ for ``sm_90a``, built at
first CUDA use by ``ops/_build.py`` and called through ``ctypes``.  Each
wrapper takes its plain version for CPU tensors, launches its kernel
for CUDA tensors (or raises), and counts its launches in
``ops._build.launches``.
"""

from dlrover_tpu_torch.ops.quantization import (
    dequantize_blockwise,
    fused_int8_adam_update,
    quantize_blockwise,
)

__all__ = [
    "dequantize_blockwise",
    "fused_int8_adam_update",
    "quantize_blockwise",
]
