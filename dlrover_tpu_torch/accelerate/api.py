"""``auto_accelerate``: from loss, optimizer and param init to a train
step, on one card or over a mesh of ``data``, ``fsdp``, ``tensor``,
``seq`` and ``pipe`` axes.

Port of ``dlrover_tpu/accelerate/api.py:26-225`` (the ``load_strategy``
path), with ``Strategy`` from ``accelerate/strategy.py`` and the
profile from ``accelerate/analyser.py``.  One process drives one card:
the mesh is the world of processes that ``trainer.elastic.
init_distributed`` joins (``devices``, where given, holds this process's
own card only).

- Without ``param_axes`` the step is the one-card step of earlier
  slices, and a strategy or a world of more than one device raises.
- With ``param_axes`` (the params' logical axes, as the JAX version
  takes them) the step is ``build_train_step`` over the strategy's mesh
  and ``default_rules(**strategy.rule_flags())``.  At ``{data 1,
  fsdp 1}`` its collectives are no-ops.  Under ``pipe > 1`` the mesh's
  ``pipeline_microbatches`` is ``Strategy.pipe_microbatches`` or
  ``2 x pipe``.  A strategy sized for another world raises: the JAX
  version re-solves the factorization (``solver.resolve_for_world``).
- ``expert`` > 1 raises (ROADMAP A7).  There is no candidate search or
  dry run yet: without ``load_strategy`` the strategy is
  pure data parallelism over the world.
"""

from dataclasses import dataclass
from typing import Callable, Optional, Sequence

from dlrover_tpu_torch.accelerate.analyser import (  # noqa: F401
    ModelProfile,
    analyse_model,
)
from dlrover_tpu_torch.accelerate.strategy import Strategy
from dlrover_tpu_torch.common.device import DeviceLike, resolve_device
from dlrover_tpu_torch.common.log import default_logger as logger
from dlrover_tpu_torch.parallel.mesh import MeshContext, create_parallel_mesh
from dlrover_tpu_torch.parallel.sharding import (
    LATER_AXES,
    LogicalAxisRules,
    default_rules,
)
from dlrover_tpu_torch.parallel.train_step import (
    InitParamsFn,
    OptimizerFn,
    TrainStepFns,
    build_train_step,
)


@dataclass
class AccelerateResult:
    fns: TrainStepFns
    strategy: Strategy
    profile: ModelProfile
    mesh_ctx: Optional[MeshContext] = None
    rules: Optional[LogicalAxisRules] = None


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
    device)`` builds the global params (every rank draws the same ones
    and keeps its slices).  The device is ``device``, or the one entry
    of ``devices``, or ``cuda:<local rank>``."""
    if devices is not None:
        if len(devices) != 1:
            raise ValueError(
                f"auto_accelerate over {len(devices)} devices: one process "
                "drives one card, and the mesh is the world of processes "
                "(python -m dlrover_tpu_torch.run --nproc_per_node=N)")
        if device is not None and resolve_device(device) != resolve_device(
                devices[0]):
            raise ValueError("device and devices disagree")
        device = devices[0]
    from dlrover_tpu_torch.trainer.elastic.context import init_distributed

    ctx = init_distributed(device)
    dev = ctx.device
    strategy = Strategy() if load_strategy is None else load_strategy
    for name, label in LATER_AXES.items():
        if dict(strategy.mesh_dims())[name] > 1:
            raise NotImplementedError(
                f"strategy {strategy.describe()}: {name} parallelism is "
                f"ROADMAP {label}; this port shards over data, fsdp, "
                "tensor, seq and pipe")
    profile = analyse_model(init_params_fn, optimizer)
    if param_axes is None:
        if strategy.n_devices > 1 or ctx.world_size > 1:
            raise ValueError(
                f"strategy {strategy.describe()} over a world of "
                f"{ctx.world_size}: a sharded step needs param_axes (the "
                "params' logical axes, models.llama.param_logical_axes)")
        fns = build_train_step(
            loss_fn=loss_fn,
            optimizer_fn=optimizer,
            init_params_fn=init_params_fn,
            num_micro_steps=strategy.num_micro_steps,
            device=dev,
        )
        return AccelerateResult(fns=fns, strategy=strategy, profile=profile)
    if load_strategy is None:
        strategy = Strategy(data=ctx.world_size)
    if strategy.n_devices != ctx.world_size:
        raise ValueError(
            f"strategy {strategy.describe()} covers {strategy.n_devices} "
            f"devices, the world has {ctx.world_size} ranks")
    mesh_ctx = create_parallel_mesh(strategy.mesh_dims(), device=dev)
    if strategy.pipe > 1:
        mesh_ctx.pipeline_microbatches = (
            strategy.pipe_microbatches or 2 * strategy.pipe)
    rules = default_rules(**strategy.rule_flags())
    fns = build_train_step(
        loss_fn=loss_fn,
        optimizer_fn=optimizer,
        init_params_fn=init_params_fn,
        num_micro_steps=strategy.num_micro_steps,
        device=dev,
        mesh_ctx=mesh_ctx,
        param_axes=param_axes,
        rules=rules,
    )
    logger.info("auto_accelerate: %s params -> strategy %s",
                profile.num_params, strategy.describe())
    return AccelerateResult(fns=fns, strategy=strategy, profile=profile,
                            mesh_ctx=mesh_ctx, rules=rules)
