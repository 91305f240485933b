"""Model analysis for strategy selection.

Port of ``dlrover_tpu/accelerate/analyser.py``: ``ModelProfile`` and
``fits_in_memory`` are copies; ``analyse_model`` builds the params (and
the optimizer state, where the optimizer can size it with
``init_state()``) on the ``meta`` device, so it touches no memory, where
the JAX version takes ``jax.eval_shape``; ``device_memory_bytes`` reads
the card's memory.
"""

from dataclasses import dataclass, field
from typing import Dict, Optional, Tuple

import torch

from dlrover_tpu_torch.parallel.train_step import (
    InitParamsFn,
    OptimizerFn,
    param_leaves,
)


@dataclass
class ModelProfile:
    num_params: int
    param_bytes: int  # as init_params_fn builds them (fp32 masters)
    largest_leaf: int
    leaf_count: int
    # optimizer adds 2 fp32 moments/param for adam-family
    optimizer_bytes: int = 0
    # rough activation bytes per sample at bf16 (caller-supplied)
    activation_bytes_per_sample: int = 0
    # leading dim of the stacked "layers" subtree (0 = no stack):
    # pipeline candidates must divide it evenly into stages
    num_layers: int = 0
    extra: Dict = field(default_factory=dict)

    def train_state_bytes(self) -> int:
        return self.param_bytes + self.optimizer_bytes


def _nbytes(t: torch.Tensor) -> int:
    return t.numel() * t.element_size()


def analyse_model(
    init_params_fn: InitParamsFn,
    optimizer_fn: Optional[OptimizerFn] = None,
) -> ModelProfile:
    """Census of params and optimizer state, built on ``meta``."""
    params = init_params_fn(None, torch.device("meta"))
    leaves = param_leaves(params)
    optimizer_bytes = 0
    if optimizer_fn is not None:
        opt = optimizer_fn(leaves)
        if hasattr(opt, "init_state"):
            opt.init_state()
            optimizer_bytes = sum(
                _nbytes(t) for st in opt.state.values()
                for t in st.values() if isinstance(t, torch.Tensor)
            )
    num_layers = 0
    layers = params.get("layers") if isinstance(params, dict) else None
    if isinstance(layers, dict) and layers:
        first = next(iter(layers.values()))
        num_layers = int(first.shape[0]) if first.dim() else 0
    return ModelProfile(
        num_params=sum(t.numel() for t in leaves),
        param_bytes=sum(_nbytes(t) for t in leaves),
        largest_leaf=max((t.numel() for t in leaves), default=0),
        leaf_count=len(leaves),
        optimizer_bytes=optimizer_bytes,
        num_layers=num_layers,
    )


def device_memory_bytes(default_gb: float = 16.0) -> int:
    """The card's memory; without a card the JAX version's default
    (16 GB), so that strategy selection on the CPU is deterministic and
    equal to the JAX package's."""
    if torch.cuda.is_available():
        dev = torch.cuda.current_device()
        return int(torch.cuda.get_device_properties(dev).total_memory)
    return int(default_gb * (1 << 30))


def fits_in_memory(
    profile: ModelProfile,
    n_devices: int,
    fsdp: int,
    tensor: int,
    batch_per_device: int = 1,
    headroom: float = 0.85,
    pipe: int = 1,
    micro_steps: int = 1,
) -> Tuple[bool, float]:
    """Memory-fit model: params+opt shard over fsdp*tensor*pipe;
    activations scale with the local batch divided by gradient-
    accumulation micro steps.  Returns (fits, utilization)."""
    hbm = device_memory_bytes() * headroom
    shard = max(fsdp * tensor * pipe, 1)
    state = profile.train_state_bytes() / shard
    if micro_steps > 1:
        # the accumulation train path carries a full fp32 param-shaped
        # grad_sum through its scan, on top of the per-micro-step
        # gradients — unmodeled it OOMs exactly the candidates that
        # accumulation was supposed to rescue
        state += profile.num_params * 4.0 / shard
    acts = (
        profile.activation_bytes_per_sample
        * batch_per_device
        / max(micro_steps, 1)
    )
    used = state + acts
    return used <= hbm, used / hbm
