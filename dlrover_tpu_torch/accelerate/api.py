"""``auto_accelerate``: from loss, optimizer and param init to a train
step, on one device.

Port of ``dlrover_tpu/accelerate/api.py:26-225`` with its own copies of
``Strategy`` (``accelerate/strategy.py:23``) and ``ModelProfile`` /
``analyse_model`` (``accelerate/analyser.py:18-73``).  On one device the
strategy is the one-device strategy: there is no candidate search, mesh
or dry run.  A strategy or a device list spanning more than one device
raises ``NotImplementedError`` (ROADMAP A4).  ``analyse_model`` builds
the params (and the optimizer state, where the optimizer can size it
with ``init_state()``) on the ``meta`` device, so it touches no memory.
"""

from dataclasses import dataclass
from typing import Callable, Optional, Sequence

import torch

from dlrover_tpu_torch.common.device import DeviceLike, resolve_device
from dlrover_tpu_torch.parallel.train_step import (
    InitParamsFn,
    OptimizerFn,
    TrainStepFns,
    build_train_step,
    param_leaves,
)


@dataclass(frozen=True)
class Strategy:
    """One parallelization plan: the JAX package's mesh dims and micro
    steps (its remat and pipeline knobs have no use on one device)."""

    data: int = 1
    fsdp: int = 1
    tensor: int = 1
    seq: int = 1
    expert: int = 1
    pipe: int = 1
    num_micro_steps: int = 1

    @property
    def n_devices(self) -> int:
        return (self.data * self.fsdp * self.tensor * self.seq
                * self.expert * self.pipe)

    def describe(self) -> str:
        parts = [
            f"{k}={v}"
            for k, v in [("dp", self.data), ("fsdp", self.fsdp),
                         ("tp", self.tensor), ("sp", self.seq),
                         ("ep", self.expert), ("pp", self.pipe)]
            if v > 1
        ]
        return "x".join(parts) if parts else "single-device"


@dataclass
class ModelProfile:
    num_params: int
    param_bytes: int  # as init_params_fn builds them (fp32 masters)
    largest_leaf: int
    leaf_count: int
    optimizer_bytes: int = 0
    num_layers: int = 0

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


@dataclass
class AccelerateResult:
    fns: TrainStepFns
    strategy: Strategy
    profile: ModelProfile


def auto_accelerate(
    loss_fn: Callable,
    optimizer: OptimizerFn,
    init_params_fn: InitParamsFn,
    param_axes=None,
    load_strategy: Optional[Strategy] = None,
    devices: Optional[Sequence[DeviceLike]] = None,
    device: DeviceLike = None,
) -> AccelerateResult:
    """``optimizer`` builds the optimizer over the list of param leaves
    (``lambda ps: AGD(ps, lr=3e-4)``); ``init_params_fn(generator,
    device)`` builds the params.  ``param_axes`` (the logical axes of a
    sharded run) is accepted and unused on one device.  The device is
    ``device``, or the one entry of ``devices``, or ``cuda``."""
    del param_axes  # sharding rules: ROADMAP A4
    if devices is not None:
        if len(devices) != 1:
            raise NotImplementedError(
                f"auto_accelerate over {len(devices)} devices: multi-GPU "
                "strategies are ROADMAP A4"
            )
        if device is not None and resolve_device(device) != resolve_device(
                devices[0]):
            raise ValueError("device and devices disagree")
        device = devices[0]
    strategy = Strategy() if load_strategy is None else load_strategy
    if strategy.n_devices > 1:
        raise NotImplementedError(
            f"strategy {strategy.describe()} spans {strategy.n_devices} "
            "devices: multi-GPU strategies are ROADMAP A4"
        )
    dev = resolve_device(device)
    profile = analyse_model(init_params_fn, optimizer)
    fns = build_train_step(
        loss_fn=loss_fn,
        optimizer_fn=optimizer,
        init_params_fn=init_params_fn,
        num_micro_steps=strategy.num_micro_steps,
        device=dev,
    )
    return AccelerateResult(fns=fns, strategy=strategy, profile=profile)
