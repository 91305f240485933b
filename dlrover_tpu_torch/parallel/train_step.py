"""The train step ``auto_accelerate`` hands back, on one card or over a
mesh of ``data``, ``fsdp``, ``tensor``, ``seq`` and ``pipe`` axes, one
process per card.

Port of ``dlrover_tpu/parallel/train_step.py:31-242``.  The state is a
dict ``{"step": int, "params": nested dict of leaf tensors,
"opt_state": the optimizer}``; PyTorch updates params and optimizer
state in place, so ``train_step(state, batch)`` returns the same state
object, one step on.  Gradient accumulation over ``num_micro_steps``
follows the reference's ``lax.scan``: the batch is cut into
``num_micro_steps`` consecutive slices along dim 0, the grads are summed
in fp32 and scaled by ``1 / n``, and so is the loss.  ``grad_norm`` is
the global L2 norm of those grads (``optax.global_norm``), before the
update.

Over a mesh (``mesh_ctx``, ``param_axes`` and ``rules``, as the JAX
``build_train_step`` takes them):

- each rank gets the rows of the global batch that ``batch_sharding``
  gives it (``BATCH -> (data, fsdp)``), cut on the host by
  ``data.prefetch.device_prefetch``: every tensor, seq and pipe rank of
  one (data, fsdp) coordinate gets the same rows;
- each leaf is kept as the rank's slice (``placements``: the tensor and
  pipe axes by the rule table, fsdp on the dim
  ``param_sharding_with_fsdp`` picks), and the loss runs under a
  ``ParamGather`` that carries the mesh: the model gathers each layer's
  fsdp slices inside its layer loop (again in a ``remat="full"``
  recompute) and the embedding, final norm and head around their own
  use, and computes on the tensor and pipe slices as they are
  (``models/llama.py``).  The gather's gradient is a reduce-scatter onto
  the slice;
- the grads are mean-reduced over the axes that hold other rows or
  tokens (data, fsdp, seq; ``collectives.grad_sync``, one all-reduce per
  leaf), ``grad_norm`` is the norm of the whole gradient (each leaf's
  squared norm summed over the axes that cut it), and the optimizer
  updates each rank's slice elementwise;
- the loss is each rank's mean over its rows and tokens, averaged over
  data, fsdp and seq: the global batch's mean when every row carries the
  same number of tokens (no mask), as the JAX step's is;
- ``QuantizedMoments`` over a cut leaf raises (ROADMAP A6): its
  1,024-element blocks run over the flattened global leaf, and a slice
  of ``[L, D, F]`` along an inner dim is not a run of that order.

Collectives over an axis of one rank are no-ops, so at ``{data 1,
fsdp 1}`` the sharded step computes what the unsharded one does, bit
for bit, with the gather hook and the placements in place.  The expert
axis above 1 raises (ROADMAP A7).  Buffer donation and AOT compilation
(``aot_compile``) have no counterpart: PyTorch updates the state in
place and compiles nothing ahead.
"""

from dataclasses import dataclass
from typing import Any, Callable, Dict, List, Optional

import torch

from dlrover_tpu_torch.common.device import DeviceLike, resolve_device
from dlrover_tpu_torch.parallel.mesh import AxisName, MeshContext
from dlrover_tpu_torch.parallel.sharding import (
    BATCH,
    LATER_AXES,
    BatchSharding,
    LogicalAxisRules,
    ParamGather,
    gather_scope,
    logical_sharding,
    placement_for,
    rules_scope,
    shard_pytree,
    tree_map,
)

#: ``init_params_fn(generator, device) -> params`` (nested dict of
#: tensors); ``optimizer_fn(list of leaves) -> torch.optim.Optimizer``
InitParamsFn = Callable[[Optional[torch.Generator], torch.device], Dict]
OptimizerFn = Callable[[List[torch.Tensor]], torch.optim.Optimizer]


def param_leaves(params) -> List[torch.Tensor]:
    """The leaves of a nested dict of tensors, in insertion order."""
    if isinstance(params, dict):
        return [t for v in params.values() for t in param_leaves(v)]
    return [params]


@dataclass
class TrainStepFns:
    """What ``build_train_step`` hands back."""

    # (state, batch) -> (state, {"loss", "grad_norm"[, "done"]}); on
    # CUDA "done" is an event recorded after the optimizer update; the
    # batch is this rank's rows (``batch_sharding.local``) on ``device``
    train_step: Callable
    init_state: Callable  # (seed) -> state
    eval_step: Callable  # (state, batch) -> {"loss"}
    device: torch.device
    batch_sharding: BatchSharding = None
    # a Placement per param leaf (the params' structure); None unsharded
    placements: Optional[Dict] = None
    mesh_ctx: Optional[MeshContext] = None
    #: the ParamGather of the last train or eval step (None unsharded)
    last_gather: Optional[ParamGather] = None


def _paths(tree, prefix=""):
    """``(path, leaf)`` of nested dicts, ``/``-joined, in leaf order."""
    if isinstance(tree, dict):
        return [kv for k, v in tree.items()
                for kv in _paths(v, f"{prefix}{k}/")]
    return [(prefix[:-1], tree)]


def _check_axes(mesh_ctx: MeshContext):
    for name, label in LATER_AXES.items():
        if mesh_ctx.axis_size(name) > 1:
            raise NotImplementedError(
                f"a mesh with {name}={mesh_ctx.axis_size(name)}: this port "
                f"shards over data, fsdp, tensor, seq and pipe; {name} is "
                f"ROADMAP {label}")


def _placements(mesh_ctx, rules, param_axes, shapes) -> Dict:
    uses_fsdp = rules.uses_axis(AxisName.FSDP)
    # in the params' own order: the step zips placements with leaves
    return tree_map(
        lambda shape, axes: placement_for(mesh_ctx, rules, axes, shape,
                                          uses_fsdp),
        shapes, param_axes)


def build_train_step(
    loss_fn: Callable,  # (params, batch) -> scalar loss
    optimizer_fn: OptimizerFn,
    init_params_fn: InitParamsFn,
    num_micro_steps: int = 1,
    device: DeviceLike = None,
    mesh_ctx: Optional[MeshContext] = None,
    param_axes: Optional[Dict] = None,
    rules: Optional[LogicalAxisRules] = None,
    batch_logical_axes=(BATCH,),
) -> TrainStepFns:
    if num_micro_steps < 1:
        raise ValueError(f"num_micro_steps must be >= 1, got "
                         f"{num_micro_steps}")
    dev = resolve_device(device)
    placements, sharded, sharded_paths = None, None, []
    place_leaves = None
    batch_sharding = BatchSharding(1, 0, dev)
    if mesh_ctx is not None:
        if param_axes is None or rules is None:
            raise ValueError("a sharded train step needs param_axes and "
                             "rules beside mesh_ctx")
        _check_axes(mesh_ctx)
        logical_sharding(mesh_ctx, rules, batch_logical_axes)
        shapes = tree_map(lambda t: tuple(t.shape),
                          init_params_fn(None, torch.device("meta")))
        placements = _placements(mesh_ctx, rules, param_axes, shapes)
        place_leaves = param_leaves(placements)
        # the leaves fsdp cuts: the model must gather them
        sharded = [p.shard(AxisName.FSDP) is not None for p in place_leaves]
        sharded_paths = [k for k, p in _paths(placements)
                         if p.shard(AxisName.FSDP) is not None]
        fsdp = mesh_ctx.axis_size(AxisName.FSDP)
        batch_sharding = BatchSharding(
            mesh_ctx.axis_size(AxisName.DATA) * fsdp,
            mesh_ctx.axis_index(AxisName.DATA) * fsdp
            + mesh_ctx.axis_index(AxisName.FSDP),
            dev)
        if any(p.sharded for p in place_leaves):
            from dlrover_tpu_torch.optimizers.low_bit import (
                QuantizedMoments,
            )

            meta = [torch.empty(p.local_shape, device="meta")
                    for p in place_leaves]
            if isinstance(optimizer_fn(meta), QuantizedMoments):
                raise NotImplementedError(
                    "QuantizedMoments over a sharded leaf (fsdp, tensor or "
                    "pipe > 1): its 1,024-element blocks run over the "
                    "flattened global leaf, which a slice does not hold "
                    "in order: ROADMAP A6")
    fns = TrainStepFns(train_step=None, init_state=None, eval_step=None,
                       device=dev, batch_sharding=batch_sharding,
                       placements=placements, mesh_ctx=mesh_ctx)

    def init_state(seed: int = 0):
        gen = torch.Generator(device=dev).manual_seed(seed)
        params = init_params_fn(gen, dev)
        if placements is not None:
            # every rank draws the same global params from the seed and
            # keeps its slices
            params = shard_pytree(params, placements)
        leaves = param_leaves(params)
        for p in leaves:
            p.requires_grad_(True)
        opt = optimizer_fn(leaves)
        if hasattr(opt, "init_state"):
            opt.init_state()  # the reference's opt.init(params)
        return {"step": 0, "params": params, "opt_state": opt}

    def run_loss(params, batch):
        """The loss under this step's rules and, over a mesh, a fresh
        ``ParamGather``."""
        if placements is None:
            return loss_fn(params, batch)
        gather = ParamGather(placements, mesh_ctx.group(AxisName.FSDP),
                             mesh_ctx, rules)
        fns.last_gather = gather
        with rules_scope(rules), gather_scope(gather):
            loss = loss_fn(params, batch)
        missing = set(sharded_paths) - {p for p, _ in gather.gathered}
        if missing:
            raise RuntimeError(
                f"the loss used {sorted(missing)} without gathering them: "
                "under fsdp the model takes its weights from "
                "parallel.sharding.active_gather()")
        return loss

    def loss_and_grads(params, leaves, batch):
        loss = run_loss(params, batch)
        grads = torch.autograd.grad(loss, leaves)
        return loss.detach().float(), grads

    def train_step(state, batch):
        params = state["params"]
        leaves = param_leaves(params)
        if num_micro_steps > 1:
            size = next(iter(batch.values())).shape[0]
            if size % num_micro_steps:
                raise ValueError(
                    f"batch of {size} rows does not split into "
                    f"{num_micro_steps} micro steps"
                )
            mb = size // num_micro_steps
            loss, grads = None, None
            for i in range(num_micro_steps):
                micro = {k: v[i * mb:(i + 1) * mb] for k, v in batch.items()}
                l_i, g_i = loss_and_grads(params, leaves, micro)
                if grads is None:
                    loss = l_i
                    grads = [g.float() for g in g_i]
                else:
                    loss = loss + l_i
                    torch._foreach_add_(grads, [g.float() for g in g_i])
                del g_i
            scale = 1.0 / num_micro_steps
            loss = loss * scale
            torch._foreach_mul_(grads, scale)
        else:
            loss, grads = loss_and_grads(params, leaves, batch)
        if placements is None:
            grad_norm = torch.linalg.vector_norm(torch.stack(
                torch._foreach_norm([g.float() for g in grads])))
        else:
            from dlrover_tpu_torch.parallel.collectives import (
                BATCH_AXES,
                global_norm,
                grad_sync,
                mean_all_reduce_,
            )

            grads = list(grads)
            grad_sync(grads, mesh_ctx, sharded)
            grad_norm = global_norm(grads, mesh_ctx, place_leaves)
            mean_all_reduce_([loss], mesh_ctx.group_over(*BATCH_AXES))
        for p, g in zip(leaves, grads):
            p.grad = g.to(p.dtype)
        del grads
        opt = state["opt_state"]
        opt.step()
        opt.zero_grad(set_to_none=True)
        state["step"] += 1
        metrics = {"loss": loss, "grad_norm": grad_norm}
        if dev.type == "cuda":
            # the loss is ready after the forward: a reader that wants
            # the whole step waits on this event instead, and times
            # steps on the card's clock from one such event to the next
            metrics["done"] = torch.cuda.Event(enable_timing=True)
            metrics["done"].record()
        return state, metrics

    @torch.no_grad()
    def eval_step(state, batch):
        loss = run_loss(state["params"], batch).float()
        if placements is not None:
            from dlrover_tpu_torch.parallel.collectives import (
                BATCH_AXES,
                mean_all_reduce_,
            )

            mean_all_reduce_([loss], mesh_ctx.group_over(*BATCH_AXES))
        return {"loss": loss}

    fns.train_step = train_step
    fns.init_state = init_state
    fns.eval_step = eval_step
    return fns
