"""Timed dry runs of candidate strategies, one process a card.

Port (a rewrite) of ``dlrover_tpu/accelerate/dry_runner.py``
(``time_strategy``, ``pick_best``).  The reference has one controller
that builds a candidate's sharded step, runs it and reads the host
clock.  Here every process drives its own card and times its own steps,
so over a world of more than one rank the verdict is agreed:

- the steps are timed on the card's clock (CUDA events after each
  step, the card synchronised before and after the window; the host
  clock on the CPU), and each candidate's mean step time is the MAX over
  the ranks (an all-reduce on the world's host group,
  ``ElasticContext.host_group``, or the gloo world itself): every rank
  ranks the same numbers and picks the same winner;
- a build that fails (the mesh, the placements, ``init_state``, the
  sample batch: anything before the candidate's first collective, an
  out-of-memory error there included) is agreed by an all-reduce of a
  flag: on every rank the candidate is recorded as ``None``, as the
  reference records it;
- a failure inside a step (warm-up or timed) is not caught: the other
  ranks would wait in a collective that never completes, so the rank
  raises and the launcher's fault path takes over;
- a kernel that fails to build or to launch (``ops._build.KernelError``)
  is never taken for a failed candidate: it raises.

One candidate's state is live at a time (``search.py``'s memory
discipline): after each timing the state, the step closure, the
optimizer and any caught exception are dropped, the builder's
``teardown`` (where it has one) gives back the candidate's process
groups, and the card's cache is emptied before the next build.

``WARMUP_STEPS`` untimed steps run before the window, so that what a
new mesh pays once (its communicators, created in its first step, the
kernels' modules loaded then, the allocator's growth) is not raced; the
ranks then meet on the host group, so that none enters the window while
another still finishes its warm-up (its first collective would wait,
and the wait be timed).
"""

import gc
import time
from typing import Callable, List, Optional, Tuple

import torch

from dlrover_tpu_torch.accelerate.strategy import Strategy
from dlrover_tpu_torch.common.log import default_logger as logger
from dlrover_tpu_torch.ops._build import KernelError

#: untimed steps before each window
WARMUP_STEPS = 1


def _agreement_group():
    """``(group, world > 1)``: the host-side group every rank of the
    world agrees over (None: the default group, itself gloo)."""
    import torch.distributed as dist

    if not (dist.is_available() and dist.is_initialized()):
        return None, False
    if dist.get_world_size() == 1:
        return None, False
    from dlrover_tpu_torch.trainer.elastic.context import get_context

    ctx = get_context()
    group = None if ctx is None else ctx.host_group
    if group is None and dist.get_backend() != "gloo":
        raise RuntimeError(
            "the dry run agrees over a host (gloo) group: join the world "
            "through trainer.elastic.init_distributed, which makes one "
            "beside an NCCL world")
    return group, True


def _all_max(value: float, group) -> float:
    import torch.distributed as dist

    t = torch.tensor([value], dtype=torch.float64)
    dist.all_reduce(t, op=dist.ReduceOp.MAX, group=group)
    return float(t[0])


def _device_of(batch) -> torch.device:
    if isinstance(batch, dict):
        for v in batch.values():
            if isinstance(v, torch.Tensor):
                return v.device
    if isinstance(batch, torch.Tensor):
        return batch.device
    return torch.device("cpu")


def _run_steps(live: dict, warmup: int, steps: int) -> List[float]:
    """Every step's seconds (warm-up first) on the card's clock, or the
    host's on the CPU.  ``live`` holds the step, the state and the
    batch: the state is rebound there after each step, and no other
    name pins it."""
    dev = _device_of(live["batch"])
    cuda = dev.type == "cuda"
    marks = []

    def mark():
        if cuda:
            ev = torch.cuda.Event(enable_timing=True)
            ev.record()
            marks.append(ev)
        else:
            marks.append(time.perf_counter())

    if cuda:
        torch.cuda.synchronize(dev)
    mark()
    for i in range(warmup + steps):
        if i == warmup:
            # the window starts on an idle card, every rank together: a
            # rank that enters it late (its first step's communicator
            # set-up and module loading are its own) would make the
            # others' first collective wait, and that wait be timed
            if cuda:
                torch.cuda.synchronize(dev)
            group, multi = _agreement_group()
            if multi:
                import torch.distributed as dist

                dist.barrier(group=group)
            mark()
        live["state"], _ = live["step"](live["state"], live["batch"])
        mark()
    if cuda:
        torch.cuda.synchronize(dev)
        gaps = [a.elapsed_time(b) / 1e3 for a, b in zip(marks, marks[1:])]
    else:
        gaps = [b - a for a, b in zip(marks, marks[1:])]
    if steps:
        del gaps[warmup]  # the meeting before the window
    return gaps


def time_strategy(
    build_fn: Callable[[Strategy], Tuple[Callable, object, object]],
    strategy: Strategy,
    warmup: int = WARMUP_STEPS,
    steps: int = 3,
) -> Optional[float]:
    """``build_fn(strategy) -> (step_fn, state, batch)``; returns the
    mean seconds of ``steps`` steps after ``warmup`` untimed ones (over
    a world: the largest rank's), or None when the candidate failed to
    build on any rank.  ``build_fn.teardown()``, where it exists, runs
    after every timing, a failed one too."""
    group, multi = _agreement_group()
    teardown = getattr(build_fn, "teardown", None)
    live = {}
    # a step that raised leaves the other ranks in a collective: then
    # nothing is torn down (a group's shutdown could wait on them too)
    settled = False
    try:
        failure = ""
        try:
            live["step"], live["state"], live["batch"] = build_fn(
                strategy)[:3]
        except KernelError:
            raise
        except Exception as e:  # noqa: BLE001 - a candidate that cannot build
            failure = f"{type(e).__name__}: {e}"
        failed = bool(failure)
        if multi:
            failed = _all_max(float(failed), group) > 0
        if failed:
            settled = True
            logger.warning("strategy %s failed dry run: %s",
                           strategy.describe(),
                           failure or "the build failed on another rank")
            return None
        per_step = _run_steps(live, warmup, steps)
        settled = True
        mean = sum(per_step[warmup:]) / max(steps, 1)
        logger.info("dry run %s: step seconds %s (the first %d untimed), "
                    "mean %.6f on this rank", strategy.describe(),
                    [round(t, 6) for t in per_step], warmup, mean)
        return _all_max(mean, group) if multi else mean
    finally:
        live.clear()
        if settled:
            if teardown is not None:
                teardown()
            gc.collect()
            if torch.cuda.is_available() and torch.cuda.is_initialized():
                torch.cuda.empty_cache()


def pick_best(
    build_fn: Callable,
    candidates: List[Strategy],
    max_candidates: int = 4,
) -> Tuple[Optional[Strategy], dict]:
    """Dry-run the top candidates; fastest wins (the reference's
    DRYRUN task phase)."""
    timings = {}
    best, best_t = None, float("inf")
    for s in candidates[:max_candidates]:
        t = time_strategy(build_fn, s)
        timings[s.describe()] = t
        if t is not None and t < best_t:
            best, best_t = s, t
    return best, timings
