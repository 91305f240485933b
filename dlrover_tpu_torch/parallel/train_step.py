"""The train step ``auto_accelerate`` hands back, on one device.

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

What has no counterpart on one device is left out: the mesh, the
param/batch shardings, buffer donation and AOT compilation
(``aot_compile``); they come with ROADMAP A4.
"""

from dataclasses import dataclass
from typing import Any, Callable, Dict, List, Optional

import torch

from dlrover_tpu_torch.common.device import DeviceLike, resolve_device

#: ``init_params_fn(generator, device) -> params`` (nested dict of
#: tensors); ``optimizer_fn(list of leaves) -> torch.optim.Optimizer``
InitParamsFn = Callable[[Optional[torch.Generator], torch.device], Dict]
OptimizerFn = Callable[[List[torch.Tensor]], torch.optim.Optimizer]


def param_leaves(params) -> List[torch.Tensor]:
    """The leaves of a nested dict of tensors, in insertion order."""
    if isinstance(params, dict):
        return [t for v in params.values() for t in param_leaves(v)]
    return [params]


def batch_to_device(batch: Dict[str, Any], device: torch.device):
    """A batch of numpy arrays or tensors -> the same keys as tensors on
    ``device``."""
    return {k: torch.as_tensor(v).to(device) for k, v in batch.items()}


@dataclass
class TrainStepFns:
    """What ``build_train_step`` hands back."""

    # (state, batch) -> (state, {"loss", "grad_norm"[, "done"]}); on
    # CUDA "done" is an event recorded after the optimizer update
    train_step: Callable
    init_state: Callable  # (seed) -> state
    eval_step: Callable  # (state, batch) -> {"loss"}
    device: torch.device


def build_train_step(
    loss_fn: Callable,  # (params, batch) -> scalar loss
    optimizer_fn: OptimizerFn,
    init_params_fn: InitParamsFn,
    num_micro_steps: int = 1,
    device: DeviceLike = None,
) -> TrainStepFns:
    if num_micro_steps < 1:
        raise ValueError(f"num_micro_steps must be >= 1, got "
                         f"{num_micro_steps}")
    dev = resolve_device(device)

    def init_state(seed: int = 0):
        gen = torch.Generator(device=dev).manual_seed(seed)
        params = init_params_fn(gen, dev)
        leaves = param_leaves(params)
        for p in leaves:
            p.requires_grad_(True)
        opt = optimizer_fn(leaves)
        if hasattr(opt, "init_state"):
            opt.init_state()  # the reference's opt.init(params)
        return {"step": 0, "params": params, "opt_state": opt}

    def loss_and_grads(params, leaves, batch):
        loss = loss_fn(params, batch)
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
        grad_norm = torch.linalg.vector_norm(
            torch.stack(torch._foreach_norm([g.float() for g in grads]))
        )
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
        return {"loss": loss_fn(state["params"], batch).float()}

    return TrainStepFns(
        train_step=train_step,
        init_state=init_state,
        eval_step=eval_step,
        device=dev,
    )
