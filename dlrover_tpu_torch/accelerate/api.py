"""``auto_accelerate``: from loss, optimizer and param init to a train
step, on one card or over a mesh of ``data``, ``fsdp``, ``tensor``,
``seq`` and ``pipe`` axes, with the strategy searched, pinned or
re-solved for the world.

Port of ``dlrover_tpu/accelerate/api.py`` with ``Strategy`` and the
candidates from ``accelerate/strategy.py``, the profile from
``accelerate/analyser.py``, the race from ``accelerate/search.py`` over
``accelerate/dry_runner.py``, the tuning from ``bayes_search.py`` and
the planner from ``dim_planner.py``.  One process drives one card: the
mesh is the world of processes that ``trainer.elastic.
init_distributed`` joins (``devices``, where given, holds this process's
own card only).

- Without ``param_axes`` the step is the one-card step of earlier
  slices, and a strategy or a world of more than one device raises, as
  does a dry run (a candidate's sharded step needs the axes).
- With ``param_axes`` (the params' logical axes, as the JAX version
  takes them) the step is ``build_train_step`` over the strategy's mesh
  and ``default_rules(**strategy.rule_flags())``; under ``pipe > 1`` the
  mesh's ``pipeline_microbatches`` is ``Strategy.pipe_microbatches`` or
  ``2 x pipe``.  The strategy is:

  - ``load_strategy``, re-solved with ``solver.resolve_for_world`` when
    it was sized for another world (the elastic re-mesh after a
    membership change);
  - else, with ``dry_run`` and a ``sample_batch_fn``, the winner of
    ``successive_halving`` over ``generate_candidates``, then tuned by
    ``tune_strategy`` over ``tune_space`` (Bayesian optimization,
    ``tune_budget`` more timed builds), with ``planner`` a
    ``CalibratedPlanner`` fitted on what was timed.  Over several ranks
    the times are agreed (the slowest rank's), so every rank picks the
    same winner.  Where every candidate failed to build the call raises
    (the reference falls back to the untimed ``candidates[0]``);
  - else ``generate_candidates(...)[0]``, the analytic ranking's first.

- ``moe=True`` and an ``expert`` axis above 1 raise (ROADMAP A7).
- ``Strategy.remat`` is not read on the build path, as in the reference:
  the model's ``LlamaConfig.remat`` decides.
"""

from dataclasses import dataclass, field
from typing import Callable, Optional, Sequence

from dlrover_tpu_torch.accelerate.analyser import (  # noqa: F401
    ModelProfile,
    analyse_model,
)
from dlrover_tpu_torch.accelerate.strategy import (
    Strategy,
    generate_candidates,
)
from dlrover_tpu_torch.common.device import DeviceLike, resolve_device
from dlrover_tpu_torch.common.log import default_logger as logger
from dlrover_tpu_torch.parallel.mesh import (
    MeshContext,
    create_hybrid_parallel_mesh,
    create_parallel_mesh,
    destroy_parallel_mesh,
)
from dlrover_tpu_torch.parallel.sharding import (
    LATER_AXES,
    BatchSharding,
    LogicalAxisRules,
    default_rules,
)
from dlrover_tpu_torch.parallel.train_step import (
    InitParamsFn,
    OptimizerFn,
    TrainStepFns,
    build_train_step,
)

#: ``sample_batch_fn(batch_sharding) -> batch``: this rank's rows of a
#: sample global batch, on the card
SampleBatchFn = Callable[[BatchSharding], dict]


@dataclass
class AccelerateResult:
    fns: TrainStepFns
    strategy: Strategy
    profile: ModelProfile
    mesh_ctx: Optional[MeshContext] = None
    rules: Optional[LogicalAxisRules] = None
    # {strategy.describe(): [agreed seconds per round]} of the race, and
    # "bayes_tune": {config: seconds or None} (empty without a dry run)
    timings: dict = field(default_factory=dict)
    # measurement-calibrated planner (None without a dry run): already
    # fitted on this run's timings; ``planner.plan(n_devices=256)``
    # ranks candidates at a larger target scale
    planner: object = None


def _check_axes(strategy: Strategy):
    for name, label in LATER_AXES.items():
        if dict(strategy.mesh_dims())[name] > 1:
            raise NotImplementedError(
                f"strategy {strategy.describe()}: {name} parallelism is "
                f"ROADMAP {label}; this port shards over data, fsdp, "
                "tensor, seq and pipe")


#: ``check_mesh(mesh_ctx) -> None``, or ValueError where the model
#: cannot run over the mesh (``models.llama.check_mesh`` with its config)
CheckMeshFn = Callable[[MeshContext], None]


def _mesh_for(strategy: Strategy, dev, set_global: bool) -> MeshContext:
    _check_axes(strategy)
    dcn = tuple(dict(strategy.extras).get("dcn", ()))
    if dcn:
        sizes = dict(strategy.mesh_dims())
        mesh_ctx = create_hybrid_parallel_mesh(
            [(n, sizes[n]) for n in dcn],
            [(n, s) for n, s in sizes.items() if n not in dcn],
            device=dev, set_global=set_global)
    else:
        mesh_ctx = create_parallel_mesh(strategy.mesh_dims(), device=dev,
                                        set_global=set_global)
    if strategy.pipe > 1:
        mesh_ctx.pipeline_microbatches = (
            strategy.pipe_microbatches or 2 * strategy.pipe)
    return mesh_ctx


def _step_for(strategy: Strategy, mesh_ctx: MeshContext, dev, loss_fn,
              optimizer, init_params_fn, param_axes):
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
    return fns, rules


class _CandidateBuilder:
    """The dry run's ``build_fn``: a candidate's mesh (checked by the
    model's ``check_mesh``), sharded step, this rank's sample batch
    (checked against the step's micro steps and pipeline microbatches)
    and state (seed 0).  The mesh is kept from the moment it exists, so
    ``teardown`` gives back its groups after a build that failed half
    way too."""

    def __init__(self, dev, sample_batch_fn: SampleBatchFn, step_args,
                 check_mesh: Optional[CheckMeshFn] = None):
        self.dev = dev
        self.sample_batch_fn = sample_batch_fn
        self.step_args = step_args
        self.check_mesh = check_mesh
        self.mesh: Optional[MeshContext] = None

    def __call__(self, strategy: Strategy):
        self.mesh = _mesh_for(strategy, self.dev, set_global=False)
        if self.check_mesh is not None:
            # a layout the model cannot run fails here, before a
            # collective, and is agreed away as a failed build
            self.check_mesh(self.mesh)
        fns, _ = _step_for(strategy, self.mesh, self.dev, *self.step_args)
        batch = self.sample_batch_fn(fns.batch_sharding)
        # a batch the step cannot cut fails here, before a collective
        fns.check_batch(batch)
        state = fns.init_state(0)
        return fns.train_step, state, batch

    def teardown(self):
        mesh, self.mesh = self.mesh, None
        if mesh is not None:
            destroy_parallel_mesh(mesh)


def _search(profile, world, builder, candidates, tune_space, tune_budget,
            global_batch, batch_per_replica, seq_len):
    """The race, the tuning and the calibrated planner:
    ``(strategy, timings, planner)``."""
    from dlrover_tpu_torch.accelerate.bayes_search import tune_strategy
    from dlrover_tpu_torch.accelerate.dim_planner import CalibratedPlanner
    from dlrover_tpu_torch.accelerate.search import successive_halving

    strategy, timings = successive_halving(builder, candidates)
    if strategy is None:
        raise RuntimeError(
            f"every candidate failed its dry run: {timings} (the reasons "
            "are in the log)")
    if tune_space:
        # BO over the winner's tunables (micro steps, pipe microbatches,
        # ...): the knobs no analytic model predicts
        strategy, tune_hist = tune_strategy(
            builder, strategy, tune_space, budget=tune_budget)
        timings["bayes_tune"] = tune_hist
    by_desc = {c.describe(): c for c in candidates}
    measured = [
        (by_desc[d], t[-1])
        for d, t in timings.items()
        if d in by_desc and t and t[-1] is not None
    ]
    # the candidates' constant rank basis: with a known global batch,
    # per-device rows = global / n
    rank_bpr = (global_batch / world if global_batch is not None
                else batch_per_replica)
    planner = CalibratedPlanner(profile, batch_per_replica=rank_bpr,
                                seq_len=seq_len)
    planner.calibrate(measured)
    return strategy, timings, planner


def auto_accelerate(
    loss_fn: Callable,
    optimizer: OptimizerFn,
    init_params_fn: InitParamsFn,
    param_axes=None,
    sample_batch_fn: Optional[SampleBatchFn] = None,
    devices: Optional[Sequence[DeviceLike]] = None,
    load_strategy: Optional[Strategy] = None,
    dry_run: bool = False,
    long_context: bool = False,
    moe: bool = False,
    batch_per_replica: int = 1,
    seq_len: int = 2048,
    global_batch: Optional[int] = None,
    tune_space: Optional[dict] = None,
    tune_budget: int = 6,
    device: DeviceLike = None,
    check_mesh: Optional[CheckMeshFn] = None,
) -> AccelerateResult:
    """``optimizer`` builds the optimizer over the list of param leaves
    (``lambda ps: AGD(ps, lr=3e-4)``); ``init_params_fn(generator,
    device)`` builds the global params (every rank draws the same ones
    and keeps its slices).  The device is ``device``, or the one entry
    of ``devices``, or ``cuda:<local rank>``.

    ``batch_per_replica``/``seq_len`` describe the workload the
    candidates are ranked at; ``global_batch`` (the rows of a global
    batch) drops the candidates whose data x fsdp does not divide it.
    ``sample_batch_fn(batch_sharding) -> batch`` (this rank's rows, on
    the card) enables the timed dry run; ``tune_space`` maps Strategy
    fields to value lists (``{"num_micro_steps": [1, 2, 4]}``) tuned
    after the race with ``tune_budget`` more timed builds.
    ``check_mesh(mesh_ctx)`` (``lambda m: llama.check_mesh(cfg, m)``)
    raises where the model cannot run over a mesh: a raced candidate
    that fails it is skipped on every rank (the model's forward checks
    the strategy it is given)."""
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
    if moe:
        raise NotImplementedError(
            "moe=True: expert parallelism and the MoE model are ROADMAP A7")
    from dlrover_tpu_torch.trainer.elastic.context import init_distributed

    ctx = init_distributed(device)
    dev = ctx.device
    world = ctx.world_size
    if load_strategy is not None:
        _check_axes(load_strategy)
    profile = analyse_model(init_params_fn, optimizer)
    if param_axes is None:
        strategy = Strategy() if load_strategy is None else load_strategy
        if strategy.n_devices > 1 or world > 1 or dry_run:
            raise ValueError(
                f"strategy {strategy.describe()} over a world of {world}"
                f"{' with a dry run' if dry_run else ''}: a sharded step "
                "needs param_axes (the params' logical axes, "
                "models.llama.param_logical_axes)")
        fns = build_train_step(
            loss_fn=loss_fn,
            optimizer_fn=optimizer,
            init_params_fn=init_params_fn,
            num_micro_steps=strategy.num_micro_steps,
            device=dev,
        )
        return AccelerateResult(fns=fns, strategy=strategy, profile=profile)

    timings, planner = {}, None
    step_args = (loss_fn, optimizer, init_params_fn, param_axes)
    if load_strategy is not None:
        strategy = load_strategy
        if strategy.n_devices != world:
            # the elastic re-mesh: a strategy sized for the previous world
            # is re-solved for this one (a same-size restart keeps it)
            from dlrover_tpu_torch.accelerate.solver import resolve_for_world

            strategy = resolve_for_world(
                profile, world, batch_per_replica, seq_len,
                prior=strategy, long_context=long_context,
                global_batch=global_batch).strategy
    else:
        candidates = generate_candidates(
            profile, world, long_context=long_context,
            batch_per_replica=batch_per_replica, seq_len=seq_len,
            global_batch=global_batch)
        if not candidates:
            raise RuntimeError(
                f"no strategy fits: {profile.num_params} params on "
                f"{world} devices")
        if dry_run and sample_batch_fn is not None:
            strategy, timings, planner = _search(
                profile, world,
                _CandidateBuilder(dev, sample_batch_fn, step_args,
                                  check_mesh),
                candidates, tune_space, tune_budget, global_batch,
                batch_per_replica, seq_len)
        else:
            strategy = candidates[0]
    mesh_ctx = _mesh_for(strategy, dev, set_global=True)
    fns, rules = _step_for(strategy, mesh_ctx, dev, *step_args)
    logger.info("auto_accelerate: %s params -> strategy %s",
                profile.num_params, strategy.describe())
    return AccelerateResult(fns=fns, strategy=strategy, profile=profile,
                            mesh_ctx=mesh_ctx, rules=rules, timings=timings,
                            planner=planner)
