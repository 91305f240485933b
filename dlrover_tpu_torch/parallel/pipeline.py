"""Pipeline parallelism: microbatches hop from stage to stage over the
``pipe`` axis, one point-to-point transfer a tick.

Port of ``dlrover_tpu/parallel/pipeline.py:25-151`` (GPipe-style SPMD:
every stage runs the same loop over clock ticks; the reference's
``lax.ppermute`` inside a ``lax.scan`` becomes one ``batch_isend_irecv``
between neighbouring stages of the pipe group a tick, and autograd
through the loop gives the backward schedule).  Each process is one
stage and holds its own slice of the stacked layers (``LAYERS -> pipe``).

What differs from the reference, with the same outputs and gradients:

- Ticks where a stage holds no microbatch (the bubble: stage ``s``
  before tick ``s`` and after tick ``s + M - 1``) pass their input on
  without running ``stage_fn``: what they would compute only ever
  reaches other bubble ticks.  The transfers run at every tick on every
  stage, so every rank makes the same calls in the same order, forward
  and backward.
- The chunked schedule's padding ticks (past ``M + S - 1``) are not run,
  nor is the transfer after the last tick (its result is dropped).
- Stage 0 picks the microbatch with ``torch.where``, which keeps the
  received activation in its graph: its transfer's backward (stage 0
  receiving the gradient of what it sent) runs on stage 0 as on every
  stage, and the other stages keep the microbatches in theirs.
"""

from typing import Callable, Dict, List, Optional

import torch
from torch.utils.checkpoint import checkpoint, set_checkpoint_early_stop

from dlrover_tpu_torch.parallel.collectives import exchange, reduce_from
from dlrover_tpu_torch.parallel.mesh import AxisName, MeshContext


class _ToNextStage(torch.autograd.Function):
    """Send ``y`` to the next stage and return what the previous stage
    sent (zeros on stage 0); backward, the same hop the other way."""

    @staticmethod
    def forward(ctx, y, prev: Optional[int], nxt: Optional[int], group):
        ctx.prev, ctx.nxt, ctx.group = prev, nxt, group
        y = y.contiguous()
        got = torch.zeros_like(y)
        exchange([(y, nxt)] if nxt is not None else [],
                 [(got, prev)] if prev is not None else [], group)
        return got

    @staticmethod
    def backward(ctx, g):
        g = g.contiguous()
        gy = torch.zeros_like(g)
        exchange([(g, ctx.prev)] if ctx.prev is not None else [],
                 [(gy, ctx.nxt)] if ctx.nxt is not None else [], ctx.group)
        return gy, None, None, None


def pipeline_spmd(
    stage_fn: Callable,
    stage_params,
    microbatches: torch.Tensor,
    mesh_ctx: MeshContext,
    schedule: str = "chunked",
) -> torch.Tensor:
    """Run ``microbatches`` ``[M, mb, ...]`` through the pipeline over
    ``mesh_ctx``'s pipe axis; returns ``[M, mb, ...]``, valid on every
    stage after the final broadcast.

    ``stage_fn(stage_params, x) -> y`` is this stage's chunk of layers
    (activations keep one shape across stages).  Only stage 0 reads the
    microbatches.  ``schedule``: ``"chunked"`` (default) wraps each run
    of ``S`` ticks in a checkpoint, so the backward holds about ``S``
    microbatches of stage activations at a time (the reference's
    ``jax.checkpoint`` over chunks); ``"gpipe"`` is the plain loop,
    whose backward keeps every tick's.  The last stage's outputs reach
    the others by a sum over the pipe group of a masked copy; its
    gradient is the identity, as the computation after it runs alike
    on every stage."""
    if schedule not in ("chunked", "gpipe"):
        raise ValueError(f"unknown pipeline schedule {schedule!r}")
    n_stages = mesh_ctx.axis_size(AxisName.PIPELINE)
    stage = mesh_ctx.axis_index(AxisName.PIPELINE)
    group = mesh_ctx.group(AxisName.PIPELINE)
    prev, nxt = mesh_ctx.stage_peers()
    num_mb = microbatches.shape[0]
    total = num_mb + n_stages - 1
    dev = microbatches.device
    first = torch.full((), stage == 0, dtype=torch.bool, device=dev)

    def tick(incoming, t):
        x = torch.where(first, microbatches[min(t, num_mb - 1)], incoming)
        # stage s holds microbatch t - s at tick t; elsewhere a bubble
        y = stage_fn(stage_params, x) if stage <= t < stage + num_mb else x
        if t == total - 1:
            return None, y
        return _ToNextStage.apply(y, prev, nxt, group), y

    def run(incoming, ticks):
        ys = []
        for t in ticks:
            incoming, y = tick(incoming, t)
            ys.append(y)
        return incoming, ys

    incoming = torch.zeros_like(microbatches[0])
    if schedule == "gpipe":
        _, ys = run(incoming, range(total))
    else:
        ys = []
        for c in range(0, total, n_stages):
            ticks = range(c, min(c + n_stages, total))

            def chunk(inc, _ticks=ticks):
                carry, out = run(inc, _ticks)
                return (*out, carry) if carry is not None else tuple(out)

            # every rank recomputes the whole chunk, transfers included
            with set_checkpoint_early_stop(False):
                out = checkpoint(chunk, incoming, use_reentrant=False)
            if len(out) > len(ticks):
                incoming = out[-1]
                out = out[:-1]
            ys.extend(out)
    # the last stage finished microbatch m at tick m + S - 1
    outs = torch.stack(ys[n_stages - 1:n_stages - 1 + num_mb])
    last = torch.full((), stage == n_stages - 1, dtype=torch.bool,
                      device=dev)
    outs = torch.where(last, outs, torch.zeros_like(outs))
    return reduce_from(outs, group)


def split_microbatches(batch, num_microbatches: int):
    """``[B, ...] -> [M, B/M, ...]``, leaf by leaf of a dict."""
    if isinstance(batch, dict):
        return {k: split_microbatches(v, num_microbatches)
                for k, v in batch.items()}
    b = batch.shape[0]
    if b % num_microbatches:
        raise ValueError(
            f"batch {b} not divisible into {num_microbatches} microbatches")
    return batch.reshape((num_microbatches, b // num_microbatches)
                         + tuple(batch.shape[1:]))


def merge_microbatches(stream):
    """``[M, mb, ...] -> [M * mb, ...]``, leaf by leaf of a dict."""
    if isinstance(stream, dict):
        return {k: merge_microbatches(v) for k, v in stream.items()}
    return stream.reshape((stream.shape[0] * stream.shape[1],)
                          + tuple(stream.shape[2:]))


def stack_stage_params(per_stage_params: List[Dict]):
    """A list of per-stage param dicts -> one dict stacked on a leading
    stage dim (which the pipe axis cuts)."""
    first = per_stage_params[0]
    if isinstance(first, dict):
        return {k: stack_stage_params([p[k] for p in per_stage_params])
                for k in first}
    return torch.stack(per_stage_params)
