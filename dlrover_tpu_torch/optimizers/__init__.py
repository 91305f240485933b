"""Optimizers of the port (``dlrover_tpu/optimizers``)."""

from dlrover_tpu_torch.optimizers.agd import AGD

__all__ = ["AGD"]
