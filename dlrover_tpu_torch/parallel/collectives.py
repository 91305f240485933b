"""Collectives of the mesh's axes, each on the autograd path a
``torch.autograd.Function`` whose backward is its transpose.

Port of ``dlrover_tpu/parallel/collectives.py`` and of what GSPMD
inserts in the JAX version:

- fsdp: the all-gather of a param before its use and the reduce-scatter
  of its gradient (``all_gather_dim``);
- tensor (Megatron's conjugate pair): ``copy_to`` (identity forward,
  sum over the group backward) where a replicated activation enters a
  column-parallel product, and ``reduce_from`` (sum forward, identity
  backward) after a row-parallel product and the vocab-parallel
  embedding.  A loss computed alike on every tensor rank is counted
  once;
- seq: ``seq_all_to_all`` (the Ulysses exchange, ``:41``; its backward
  is the exchange the inverse way), ``ring_permute`` (``:65``; backward:
  the reversed rotation), ``distributed_softmax`` (``:73``),
  ``ulysses_attention`` (``:102``) and ``ring_attention`` (``:174``);
- expert: ``expert_all_to_all`` (``:89``), for ROADMAP A7;
- ``psum`` and ``pmax`` with the reference's semantics under
  ``shard_map``: ``psum``'s transpose is ``psum``, ``pmax`` carries no
  gradient (the softmax it shifts does not depend on the shift).

``grad_sync`` (``:130``) is one mean all-reduce per leaf over the axes
that hold other rows or tokens (data, fsdp unless it shards the leaf,
seq), not bucketed: the params are stacked over layers, so a Llama model
has twelve leaves.  The mean is a sum and a division by the group's size
(``ReduceOp.AVG`` exists on NCCL only), on both backends alike.

Point-to-point transfers (the ring, the pipeline's hops) go through one
``batch_isend_irecv`` per call, sends and receives together, so no
order of the two can deadlock.  A collective over a group of one rank
(or no group) is a no-op; a failed collective raises.
"""

from typing import Callable, List, Optional, Sequence, Tuple

import torch
import torch.distributed as dist

from dlrover_tpu_torch.parallel.mesh import AxisName, MeshContext

#: the merge's "minus infinity": ``exp(m_run - m_new)`` of two -inf is
#: NaN, of two of these 1 (the reference's ``finfo(float32).max * -1``)
NEG_INF = torch.finfo(torch.float32).max * -1.0


def _size(group) -> int:
    return 1 if group is None else dist.get_world_size(group)


def _rank(group) -> int:
    return 0 if group is None else dist.get_rank(group)


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


def _all_reduce(t: torch.Tensor, group, op=dist.ReduceOp.SUM):
    out = t.contiguous().clone()
    dist.all_reduce(out, op=op, group=group)
    return out


class _ReduceFrom(torch.autograd.Function):
    """Sum over the group forward, identity backward."""

    @staticmethod
    def forward(ctx, x, group):
        return _all_reduce(x, group)

    @staticmethod
    def backward(ctx, g):
        return g, None


class _CopyTo(torch.autograd.Function):
    """Identity forward, sum over the group backward."""

    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return _all_reduce(g, ctx.group), None


class _Psum(torch.autograd.Function):
    """Sum over the group forward and backward (``lax.psum`` under
    ``shard_map``: each rank's output feeds its own loss)."""

    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return _all_reduce(x, group)

    @staticmethod
    def backward(ctx, g):
        return _all_reduce(g, ctx.group), None


def reduce_from(x: torch.Tensor, group) -> torch.Tensor:
    """The sum of ``x`` over ``group`` (a row-parallel product's partial
    sums); its gradient passes through unchanged, since what follows is
    computed alike on every rank of the group."""
    if _size(group) == 1:
        return x
    return _ReduceFrom.apply(x, group)


def copy_to(x: torch.Tensor, group) -> torch.Tensor:
    """``x`` unchanged, its gradient summed over ``group``: a replicated
    activation entering a column-parallel product, whose ranks each
    give the gradient of their own columns."""
    if _size(group) == 1:
        return x
    return _CopyTo.apply(x, group)


def psum(x: torch.Tensor, group) -> torch.Tensor:
    """``lax.psum``: the sum over ``group``; the gradient is summed too."""
    if _size(group) == 1:
        return x
    return _Psum.apply(x, group)


def pmax(x: torch.Tensor, group) -> torch.Tensor:
    """``lax.pmax``: the elementwise max over ``group``, no gradient."""
    x = x.detach()
    if _size(group) == 1:
        return x
    return _all_reduce(x, group, dist.ReduceOp.MAX)


def _all_to_all(x: torch.Tensor, group, scatter: int, gather: int):
    """``lax.all_to_all(tiled=True)``: ``x`` cut into ``n`` parts along
    ``scatter``, part ``j`` sent to rank ``j``; the parts received
    concatenated along ``gather`` in rank order."""
    n = _size(group)
    parts = x.shape[scatter] // n
    if parts * n != x.shape[scatter]:
        raise ValueError(f"dim {scatter} of {tuple(x.shape)} does not split "
                         f"over {n} ranks")
    # [n, ...] with part j first: the exchange sends dim 0's slabs
    send = x.unflatten(scatter, (n, parts)).movedim(scatter, 0).contiguous()
    recv = torch.empty_like(send)
    dist.all_to_all_single(recv, send, group=group)
    # recv[j] is rank j's part: put j just before the gather dim
    return recv.movedim(0, gather).flatten(gather, gather + 1).contiguous()


class _AllToAll(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group, scatter, gather):
        ctx.group, ctx.scatter, ctx.gather = group, scatter, gather
        return _all_to_all(x, group, scatter, gather)

    @staticmethod
    def backward(ctx, g):
        return (_all_to_all(g, ctx.group, ctx.gather, ctx.scatter), None,
                None, None)


def seq_all_to_all(x: torch.Tensor, group, scatter_axis: int,
                   gather_axis: int) -> torch.Tensor:
    """The Ulysses exchange: scatter ``scatter_axis`` over the group,
    gather ``gather_axis`` from it (``[B, S/p, H, D] -> [B, S, H/p, D]``
    with ``scatter_axis=2, gather_axis=1``); its gradient is the
    exchange the inverse way."""
    if _size(group) == 1:
        return x
    return _AllToAll.apply(x, group, scatter_axis, gather_axis)


def expert_all_to_all(x: torch.Tensor, group, split_axis: int = 0,
                      concat_axis: int = 0) -> torch.Tensor:
    """MoE dispatch/combine exchange over the expert group (ROADMAP A7
    calls it)."""
    return seq_all_to_all(x, group, split_axis, concat_axis)


def exchange(sends: Sequence[Tuple[torch.Tensor, int]],
             recvs: Sequence[Tuple[torch.Tensor, int]], group=None):
    """One ``batch_isend_irecv``: ``(tensor, global peer rank)`` sends
    and receives into the given tensors, waited on together."""
    ops = [dist.P2POp(dist.isend, t, peer, group) for t, peer in sends]
    ops += [dist.P2POp(dist.irecv, t, peer, group) for t, peer in recvs]
    if ops:
        for req in dist.batch_isend_irecv(ops):
            req.wait()


def _rotate(xs, group, shift: int):
    n, me = _size(group), _rank(group)
    to = dist.get_global_rank(group, (me + shift) % n)
    frm = dist.get_global_rank(group, (me - shift) % n)
    xs = [x.contiguous() for x in xs]
    outs = [torch.empty_like(x) for x in xs]
    exchange([(x, to) for x in xs], [(o, frm) for o in outs], group)
    return outs


class _RingPermute(torch.autograd.Function):
    @staticmethod
    def forward(ctx, group, shift, *xs):
        ctx.group, ctx.shift = group, shift
        return tuple(_rotate(xs, group, shift))

    @staticmethod
    def backward(ctx, *gs):
        gs = [torch.zeros_like(g) if g is None else g for g in gs]
        return (None, None, *_rotate(gs, ctx.group, -ctx.shift))


def ring_permute(x: torch.Tensor, group, shift: int = 1):
    """Rotate ``x`` to the rank ``shift`` places on along the group's
    ring (``lax.ppermute``); the gradient rotates back."""
    if _size(group) == 1:
        return x
    return _RingPermute.apply(group, shift, x)[0]


def distributed_softmax(logits: torch.Tensor, group,
                        dim: int = -1) -> torch.Tensor:
    """Softmax over a dim cut across ``group``: the global max (pmax),
    then the global sum (psum); equal to a softmax of the gathered dim."""
    m = pmax(logits.amax(dim=dim, keepdim=True), group)
    unnorm = torch.exp(logits - m)
    return unnorm / psum(unnorm.sum(dim=dim, keepdim=True), group)


def ulysses_attention(q, k, v, group, inner_attention: Optional[Callable]
                      = None, causal: bool = True) -> torch.Tensor:
    """Ulysses sequence parallelism: q, k, v ``[B, S/p, H, D]`` are
    exchanged for ``[B, S, H/p, D]`` (the whole sequence, a group of
    heads), attended by ``inner_attention`` (default the flash kernels,
    their plain versions on the CPU), and the output exchanged back."""
    if inner_attention is None:
        from dlrover_tpu_torch.ops.flash_attention import flash_attention

        inner_attention = flash_attention
    q, k, v = (seq_all_to_all(x, group, 2, 1) for x in (q, k, v))
    out = inner_attention(q, k, v, causal=causal)
    return seq_all_to_all(out, group, 1, 2)


def dense_block_lse(q, k, v, causal: bool, scale: float):
    """The plain ``(out, lse)`` of one K/V block (the reference's
    ``_dense_block_lse``, differentiable by autograd): q ``[B, S, H, D]``,
    k/v ``[B, X, KV, D]``; out in q's dtype, lse ``[B, S, H]`` fp32."""
    b, s, h, d = q.shape
    kv = k.shape[2]
    g = h // kv
    qg = q.float().reshape(b, s, kv, g, d)
    logits = torch.einsum("bqkgd,bxkd->bqkgx", qg, k.float()) * scale
    if causal:
        x = k.shape[1]
        keep = (torch.arange(s, device=q.device)[:, None]
                >= torch.arange(x, device=q.device)[None, :])
        logits = torch.where(keep[None, :, None, None], logits,
                             torch.full_like(logits, NEG_INF))
    lse = torch.logsumexp(logits, dim=-1)
    p = torch.exp(logits - lse[..., None])
    out = torch.einsum("bqkgx,bxkd->bqkgd", p, v.float())
    return out.reshape(b, s, h, d).to(q.dtype), lse.reshape(b, s, h)


#: ``block_fn(q, k, v, causal, scale) -> (out, lse [B, S, H])``
BlockFn = Callable[..., Tuple[torch.Tensor, torch.Tensor]]


def flash_block(q, k, v, causal: bool, scale: float):
    """The ring's per-block kernel: ``flash_attention_lse`` (B2-B4 on the
    card, with the lse cotangent in the backward; their plain versions
    on the CPU)."""
    from dlrover_tpu_torch.ops.flash_attention import flash_attention_lse

    return flash_attention_lse(q, k, v, causal=causal, sm_scale=scale)


def ring_block(q, kc, vc, my_idx: int, src_idx: int, causal: bool,
               scale: float, block_fn: BlockFn = flash_block):
    """One ring step's block: the chunk that came from ring position
    ``src_idx``.  Under ``causal`` a chunk from above the diagonal is
    skipped (None), the diagonal one is causal, one below is full."""
    if causal and src_idx > my_idx:
        return None
    return block_fn(q, kc, vc, causal and src_idx == my_idx, scale)


def ring_merge(state, out_i, lse_i):
    """The online merge of one block's normalised output into the
    running ``(acc, m_run, den)`` (fp32 ``[B, S, H, D]``, ``[B, S, H]``,
    ``[B, S, H]``) by its lse: exact softmax over the blocks seen."""
    acc, m_run, den = state
    m_new = torch.maximum(m_run, lse_i)
    alpha = torch.exp(m_run - m_new)
    beta = torch.exp(lse_i - m_new)
    acc = acc * alpha[..., None] + out_i.float() * beta[..., None]
    return acc, m_new, den * alpha + beta


def ring_init(q):
    """The merge's empty state for the local q chunk."""
    b, s, h, d = q.shape
    return (torch.zeros(b, s, h, d, dtype=torch.float32, device=q.device),
            torch.full((b, s, h), NEG_INF, dtype=torch.float32,
                       device=q.device),
            torch.zeros(b, s, h, dtype=torch.float32, device=q.device))


def ring_finish(state, dtype):
    acc, _, den = state
    return (acc / den[..., None]).to(dtype)


class _KeepInGraph(torch.autograd.Function):
    """``x`` unchanged, with ``deps`` as inputs that receive zero
    gradients: a rotation whose chunk was skipped still has its backward
    run on this rank, as the other ranks' rotations wait for it."""

    @staticmethod
    def forward(ctx, x, *deps):
        ctx.shapes = [(d.shape, d.dtype, d.device) for d in deps]
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return (g, *(torch.zeros(s, dtype=dt, device=dev)
                     for s, dt, dev in ctx.shapes))


def keep_in_graph(x: torch.Tensor, *deps: torch.Tensor) -> torch.Tensor:
    """``x``, with the backward of ``deps`` run on this rank (see
    ``_KeepInGraph``); ``x`` itself when no dep needs a gradient."""
    if not any(d.requires_grad for d in deps) or not torch.is_grad_enabled():
        return x
    return _KeepInGraph.apply(x, *deps)


def ring_attention(q, k, v, group, causal: bool = False,
                   scale: Optional[float] = None,
                   block_fn: BlockFn = flash_block) -> torch.Tensor:
    """Blockwise ring attention over a sequence cut in contiguous chunks
    across ``group``: q stays, the K/V chunk rotates one rank on per step
    (``ring_permute``, ``n - 1`` rotations on every rank whether a block
    was skipped or not) and each block's ``(out, lse)`` is merged by
    ``ring_merge``.  q ``[B, S/p, H, D]``, k/v ``[B, S/p, KV, D]``;
    returns the context of the local q chunk.  ``ring_block`` and
    ``ring_merge`` need no group: a caller can run the loop over chunks
    it holds itself."""
    n, me = _size(group), _rank(group)
    if scale is None:
        scale = q.shape[-1] ** -0.5
    state = ring_init(q)
    kc, vc = k, v
    for step in range(n):
        # after `step` rotations the chunk held came from `step` behind
        src = (me - step) % n
        res = ring_block(q, kc, vc, me, src, causal, scale, block_fn)
        if res is None:
            state = (keep_in_graph(state[0], kc, vc),) + state[1:]
        else:
            state = ring_merge(state, *res)
        if step < n - 1:
            kc, vc = _RingPermute.apply(group, 1, kc, vc)
    return ring_finish(state, q.dtype)


# ------------------------------------------------ gradients and norms


def mean_all_reduce_(tensors: Sequence[torch.Tensor], group=None):
    """In place: each tensor becomes its mean over ``group``."""
    n = _size(group)
    if n == 1:
        return
    for t in tensors:
        dist.all_reduce(t, op=dist.ReduceOp.SUM, group=group)
        t.div_(n)


#: the axes whose ranks hold other rows or tokens of the batch: the
#: gradient and the loss are means over them
BATCH_AXES = (AxisName.DATA, AxisName.FSDP, AxisName.SEQUENCE)


def grad_sync(grads: List[torch.Tensor], mesh: Optional[MeshContext],
              sharded: Optional[Sequence[bool]] = None):
    """Mean-reduce gradients in place over the axes that hold other rows
    or tokens: data, fsdp and seq.

    A leaf the fsdp axis shards (``sharded[i]``) carries its slice's sum
    over the fsdp ranks already (the reduce-scatter of its gather), so it
    is summed over data and seq; any other leaf over data, fsdp and seq.
    Each is then divided by ``data x fsdp x seq``: the mean of the ranks'
    gradients, the gradient of the mean of the ranks' losses.  Tensor and
    pipe ranks give each leaf's gradient whole already: a replicated
    leaf's is equal on every tensor rank (the conjugate operators), and
    each stage holds its own layers (the pipeline's input sums its
    gradient over the stages)."""
    if mesh is None or mesh.num_devices <= 1:
        return
    n = 1
    for a in BATCH_AXES:
        n *= mesh.axis_size(a)
    if n == 1:
        return
    over_slice = mesh.group_over(AxisName.DATA, AxisName.SEQUENCE)
    over_all = mesh.group_over(*BATCH_AXES)
    if sharded is None:
        sharded = [False] * len(grads)
    for g, s in zip(grads, sharded):
        group = over_slice if s else over_all
        if _size(group) > 1:
            dist.all_reduce(g, op=dist.ReduceOp.SUM, group=group)
        g.div_(n)


#: the axes that cut params into slices (data and seq replicate them)
PARAM_AXES = (AxisName.FSDP, AxisName.TENSOR, AxisName.PIPELINE)


def global_norm(grads: List[torch.Tensor], mesh: Optional[MeshContext],
                placements: Sequence) -> torch.Tensor:
    """L2 norm of the whole gradient (``optax.global_norm`` over global
    arrays): every global element counted once.  Each leaf's squared
    norm is summed over the axes that cut it (fsdp, tensor, pipe), never
    over one that replicates it; one small all-reduce per such axis."""
    norms = torch._foreach_norm([g.float() for g in grads])
    cut = [frozenset(a for a in PARAM_AXES
                     if mesh is not None and mesh.axis_size(a) > 1
                     and p is not None and p.shard(a) is not None)
           for p in placements]
    if not any(cut):
        return torch.linalg.vector_norm(torch.stack(norms))
    # one partial sum per set of cutting axes, split on the host: a mask
    # tensor would be a copy to the card
    sets = sorted(set(cut), key=sorted)
    part = {s: torch.stack([x for x, c in zip(norms, cut) if c == s]
                           ).square().sum() for s in sets}
    for a in PARAM_AXES:
        with_a = [s for s in sets if a in s]
        if not with_a:
            continue
        vec = torch.stack([part[s] for s in with_a])
        dist.all_reduce(vec, op=dist.ReduceOp.SUM, group=mesh.group(a))
        for i, s in enumerate(with_a):
            part[s] = vec[i]
    return torch.sqrt(torch.stack([part[s] for s in sets]).sum())

