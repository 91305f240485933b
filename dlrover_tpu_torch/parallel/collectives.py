"""Collectives of the data and fsdp axes.

Port of ``dlrover_tpu/parallel/collectives.py:130`` (``grad_sync``) and
of what GSPMD inserts for an fsdp-sharded param in the JAX version: the
all-gather before its use and the reduce-scatter of its gradient
(``all_gather_dim``).

``grad_sync`` is one mean all-reduce per leaf, not bucketed: the
params are stacked over layers, so a Llama model has twelve leaves and
a step makes twelve calls, each at least a layer-stack in size.  The
mean is a sum and a division by the group's size (``ReduceOp.AVG``
exists on NCCL only), on both backends alike.

The sequence and expert collectives of the JAX file (``ulysses_attention``,
``ring_attention``, ``seq_all_to_all``, ``ring_permute``,
``distributed_softmax``, ``expert_all_to_all``) wait for ROADMAP A4b
and A7.

A collective over a group of one rank (or no group) is a no-op; a
failed collective raises.
"""

from typing import List, Optional, Sequence

import torch
import torch.distributed as dist

from dlrover_tpu_torch.parallel.mesh import MeshContext


def _size(group) -> int:
    return 1 if group is None else dist.get_world_size(group)


class _AllGatherDim(torch.autograd.Function):
    """All-gather along ``dim``; the gradient is the sum over the
    group, reduce-scattered back onto each rank's slice."""

    @staticmethod
    def forward(ctx, t, dim, group):
        ctx.dim, ctx.group = dim, group
        n = _size(group)
        src = t.movedim(dim, 0).contiguous()
        out = torch.empty((n * src.shape[0],) + tuple(src.shape[1:]),
                          dtype=t.dtype, device=t.device)
        dist.all_gather_into_tensor(out, src, group=group)
        out = out.movedim(0, dim)
        return out if dim == 0 else out.contiguous()

    @staticmethod
    def backward(ctx, g):
        dim, group = ctx.dim, ctx.group
        n = _size(group)
        src = g.movedim(dim, 0).contiguous()
        out = torch.empty((src.shape[0] // n,) + tuple(src.shape[1:]),
                          dtype=g.dtype, device=g.device)
        dist.reduce_scatter_tensor(out, src, op=dist.ReduceOp.SUM,
                                   group=group)
        out = out.movedim(0, dim)
        return (out if dim == 0 else out.contiguous()), None, None


def all_gather_dim(t: torch.Tensor, dim: int, group=None) -> torch.Tensor:
    """The slices of ``t`` held by the ranks of ``group``, concatenated
    along ``dim`` in rank order; ``t`` itself when the group has one
    rank."""
    if _size(group) == 1:
        return t
    return _AllGatherDim.apply(t, dim, group)


def mean_all_reduce_(tensors: Sequence[torch.Tensor], group=None):
    """In place: each tensor becomes its mean over ``group``."""
    n = _size(group)
    if n == 1:
        return
    for t in tensors:
        dist.all_reduce(t, op=dist.ReduceOp.SUM, group=group)
        t.div_(n)


def grad_sync(grads: List[torch.Tensor], mesh: Optional[MeshContext],
              sharded: Optional[Sequence[bool]] = None):
    """Mean-reduce gradients in place over the data-flavoured axes.

    A leaf the fsdp axis shards (``sharded[i]``) carries its slice's sum
    over the fsdp ranks already (the reduce-scatter of its gather), so it
    is summed over ``data`` and divided by ``data x fsdp``; a replicated
    leaf is averaged over ``data x fsdp`` at once.  Every leaf ends as
    the mean of the ranks' gradients, which is the gradient of the mean
    of the ranks' losses."""
    if mesh is None or mesh.num_devices <= 1:
        return
    from dlrover_tpu_torch.parallel.mesh import AxisName

    n = mesh.axis_size(AxisName.DATA) * mesh.axis_size(AxisName.FSDP)
    data = mesh.group(AxisName.DATA)
    world = mesh.data_group()
    if sharded is None:
        sharded = [False] * len(grads)
    for g, s in zip(grads, sharded):
        group = data if s else world
        if _size(group) > 1:
            dist.all_reduce(g, op=dist.ReduceOp.SUM, group=group)
        g.div_(n)


def global_norm(grads: List[torch.Tensor], mesh: Optional[MeshContext],
                sharded: Sequence[bool]) -> torch.Tensor:
    """L2 norm of the whole gradient: the squared norms of the fsdp
    slices summed over the fsdp ranks, the replicated leaves counted
    once (``optax.global_norm`` over global arrays)."""
    from dlrover_tpu_torch.parallel.mesh import AxisName

    group = None if mesh is None else mesh.group(AxisName.FSDP)
    norms = torch._foreach_norm([g.float() for g in grads])
    if _size(group) == 1 or not any(sharded):
        return torch.linalg.vector_norm(torch.stack(norms))
    # split on the host: a mask tensor would be a copy to the card
    parts = [torch.stack([x for x, s in zip(norms, sharded) if s == want]
                         ).square().sum()
             if any(s == want for s in sharded) else None
             for want in (True, False)]
    total = parts[0]
    dist.all_reduce(total, op=dist.ReduceOp.SUM, group=group)
    if parts[1] is not None:
        total = total + parts[1]
    return torch.sqrt(total)
