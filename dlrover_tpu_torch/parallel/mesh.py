"""Named device mesh over ``torch.distributed``: one process per card.

Port of ``dlrover_tpu/parallel/mesh.py`` (``AxisName``, ``MeshContext``,
``_resolve_dims``, ``create_parallel_mesh``, ``get_mesh_context``,
``axis_size``, ``data_parallel_size``, ``destroy_parallel_mesh``,
``build_device_mesh_dims``).  The JAX version lays a ``Mesh`` over the
devices of one program; here each process holds one card and the mesh
is ``torch.distributed.device_mesh.init_device_mesh`` over the world's
ranks, with one process group per axis.  Axis order is the
``parallel_config`` order and the last axis is the innermost: rank
``r`` sits at the row-major coordinates of ``r`` in the mesh shape, as
a device does in the JAX mesh.  ``-1`` takes what the world size
leaves.

At world 1 there is no process group (``trainer.elastic.
init_distributed`` makes none), so the mesh holds no ``DeviceMesh``:
every axis has size 1 and every collective over it is a no-op.

Beside the group of each axis, ``group_over(*axes)`` gives the group of
the ranks that differ only along ``axes`` (the gradient mean over data,
fsdp and seq, the loss mean), made for every coordinate at once when
the mesh is built; ``stage_peers()`` gives the global ranks of the
previous and next pipeline stage, the pipeline's point-to-point peers.

The device kind follows the process's device: a CUDA mesh needs an
NCCL world, a CPU mesh a gloo one.  There is no other pairing: a CUDA
gradient never syncs over gloo.

``create_hybrid_parallel_mesh`` (the reference's ``:158``) lays the DCN
axes across nodes and keeps the ICI axes inside one: the ranks are
grouped by node (``granule_fn(rank)``, by default each rank's node
index, gathered over the world), nodes in numeric order, and the mesh
is ``create_parallel_mesh`` of the DCN axes (outermost) then the ICI
axes.  The agent numbers ranks node by node, so that order is the
ranks' own; a grouping that would need another order is refused.
"""

import math
import threading
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Sequence, Tuple

import torch

from dlrover_tpu_torch.common.log import default_logger as logger


class AxisName:
    """Canonical mesh-axis names (reference group names
    ``distributed.py`` "data"/"tensor"/"pipe"/"sequence"/"expert")."""

    DATA = "data"
    FSDP = "fsdp"  # parameter-sharding (ZeRO-3) sub-axis of data
    TENSOR = "tensor"
    SEQUENCE = "seq"
    EXPERT = "expert"
    PIPELINE = "pipe"

    ALL = (DATA, FSDP, TENSOR, SEQUENCE, EXPERT, PIPELINE)


@dataclass
class MeshContext:
    """The mesh's axes, and for each axis of size > 1 its process
    group (from the ``DeviceMesh``)."""

    # torch.distributed.device_mesh.DeviceMesh, or None at world 1
    mesh: Optional[object]
    dims: List[Tuple[str, int]] = field(default_factory=list)
    device: torch.device = torch.device("cpu")
    # pipeline microbatch count when pipe > 1 (set by auto_accelerate;
    # None -> 2 x pipe stages: bubble share (P-1)/(M+P-1))
    pipeline_microbatches: Optional[int] = None
    # this process's global rank, and the groups over several axes
    # (``group_over``), keyed by the tuple of axes of size > 1
    rank: int = 0
    groups: Dict[Tuple[str, ...], object] = field(default_factory=dict)

    def axis_size(self, name: str) -> int:
        return dict(self.dims).get(name, 1)

    @property
    def axis_names(self) -> Tuple[str, ...]:
        return tuple(n for n, _ in self.dims)

    @property
    def num_devices(self) -> int:
        return math.prod(s for _, s in self.dims) if self.dims else 1

    def axis_index(self, name: str) -> int:
        """This rank's coordinate along ``name`` (0 on an axis of
        size 1 or one the mesh lacks): the ``DeviceMesh``'s own, from
        ``rank`` alone (a mesh without a process group, as a test
        builds one, places any rank)."""
        return self.coords().get(name, 0)

    def group(self, name: str):
        """The process group of ``name`` (None on an axis of size 1)."""
        if self.axis_size(name) <= 1:
            return None
        return self.mesh.get_group(name)

    def coords(self, rank: Optional[int] = None) -> Dict[str, int]:
        """The mesh coordinates of global ``rank`` (default: this
        process's): row-major over ``dims``, the last axis innermost."""
        r = self.rank if rank is None else rank
        out = {}
        for name, size in reversed(self.dims):
            out[name] = r % size
            r //= size
        return out

    def rank_at(self, coords: Dict[str, int]) -> int:
        """The global rank at ``coords`` (the inverse of ``coords``)."""
        r = 0
        for name, size in self.dims:
            r = r * size + coords.get(name, 0)
        return r

    def group_over(self, *names: str):
        """The group of the ranks that share this rank's coordinates on
        every axis but ``names``: the axis's own group for one axis of
        size > 1, None when all of them have size 1."""
        big = tuple(n for n, s in self.dims if n in names and s > 1)
        if not big:
            return None
        if len(big) == 1:
            return self.group(big[0])
        if big not in self.groups:
            raise KeyError(
                f"no group over {big}: create_parallel_mesh makes the "
                f"groups of {MULTI_AXIS_GROUPS}")
        return self.groups[big]

    def stage_peers(self) -> Tuple[Optional[int], Optional[int]]:
        """The global ranks of the previous and the next pipeline stage
        at this rank's other coordinates (None past either end)."""
        n = self.axis_size(AxisName.PIPELINE)
        me = self.coords()
        i = me.get(AxisName.PIPELINE, 0)
        prev = nxt = None
        if i > 0:
            prev = self.rank_at({**me, AxisName.PIPELINE: i - 1})
        if i < n - 1:
            nxt = self.rank_at({**me, AxisName.PIPELINE: i + 1})
        return prev, nxt


_context: Optional[MeshContext] = None
_lock = threading.Lock()

#: the groups over several axes that ``create_parallel_mesh`` makes (a
#: set's axes of size > 1, when two or more): the gradient mean of a leaf
#: that fsdp shards, and of any other leaf and the loss
MULTI_AXIS_GROUPS = (
    (AxisName.DATA, AxisName.SEQUENCE),
    (AxisName.DATA, AxisName.FSDP, AxisName.SEQUENCE),
)


def _multi_axis_groups(ctx: "MeshContext") -> Dict[Tuple[str, ...], object]:
    """Every group of ``MULTI_AXIS_GROUPS`` over the world's ranks, made
    by all ranks in one order (``new_subgroups_by_enumeration`` is a
    collective of the world); this rank's group of each."""
    import itertools

    import torch.distributed as dist

    out = {}
    sizes = dict(ctx.dims)
    for names in MULTI_AXIS_GROUPS:
        big = tuple(n for n, s in ctx.dims if n in names and s > 1)
        if len(big) < 2 or big in out:
            continue
        rest = [n for n, _ in ctx.dims if n not in big]
        lists = []
        for fixed in itertools.product(*(range(sizes[n]) for n in rest)):
            base = dict(zip(rest, fixed))
            lists.append(sorted(
                ctx.rank_at({**base, **dict(zip(big, inner))})
                for inner in itertools.product(
                    *(range(sizes[n]) for n in big))))
        out[big], _ = dist.new_subgroups_by_enumeration(lists)
    return out


def _resolve_dims(
    parallel_config: Sequence[Tuple[str, int]], num_devices: int
) -> List[Tuple[str, int]]:
    dims: List[Tuple[str, int]] = []
    infer_index = -1
    known = 1
    for i, (name, size) in enumerate(parallel_config):
        if size == -1:
            if infer_index >= 0:
                raise ValueError("at most one axis size may be -1")
            infer_index = i
            dims.append((name, -1))
        else:
            if size <= 0:
                raise ValueError(f"axis {name!r} size must be >0 or -1")
            known *= size
            dims.append((name, size))
    if infer_index >= 0:
        if num_devices % known != 0:
            raise ValueError(
                f"{num_devices} devices not divisible by fixed axes {known}"
            )
        name = dims[infer_index][0]
        dims[infer_index] = (name, num_devices // known)
        known *= dims[infer_index][1]
    if known != num_devices:
        raise ValueError(
            f"mesh {dims} covers {known} devices, have {num_devices}"
        )
    return dims


def _world() -> Tuple[int, Optional[str]]:
    import torch.distributed as dist

    if dist.is_available() and dist.is_initialized():
        return dist.get_world_size(), dist.get_backend()
    return 1, None


def create_parallel_mesh(
    parallel_config: Optional[Sequence[Tuple[str, int]]] = None,
    device: Optional[torch.device] = None,
    set_global: bool = True,
) -> MeshContext:
    """Build the named mesh over the world's ranks.

    ``parallel_config`` is ``[(axis_name, size), ...]``; one size may be
    ``-1`` (inferred).  Default: pure data parallelism over all ranks.
    ``device`` is this process's card (or the CPU); it must match the
    world's backend (NCCL for CUDA, gloo for the CPU).
    """
    dev = torch.device("cpu") if device is None else torch.device(device)
    world, backend = _world()
    if parallel_config is None:
        parallel_config = [(AxisName.DATA, -1)]
    dims = _resolve_dims(parallel_config, world)
    names = tuple(n for n, _ in dims)
    if len(set(names)) != len(names):
        raise ValueError(f"duplicate axis names in {names}")
    mesh = None
    if world > 1:
        want = "nccl" if dev.type == "cuda" else "gloo"
        if backend != want:
            raise RuntimeError(
                f"a {dev.type} mesh needs a {want} world, this one is "
                f"{backend}")
        from torch.distributed.device_mesh import init_device_mesh

        # the groups of the axes that have more than one rank; dropping
        # the axes of size 1 leaves every rank's coordinates as they are
        big = [(n, s) for n, s in dims if s > 1]
        mesh = init_device_mesh(
            dev.type, tuple(s for _, s in big),
            mesh_dim_names=tuple(n for n, _ in big))
    ctx = MeshContext(mesh=mesh, dims=list(dims), device=dev)
    if world > 1:
        import torch.distributed as dist

        ctx.rank = dist.get_rank()
        ctx.groups = _multi_axis_groups(ctx)
    if set_global:
        global _context
        with _lock:
            _context = ctx
    logger.info("parallel mesh: %s over %d ranks", dict(dims), world)
    return ctx


def _granule_order(key):
    """Numeric keys in numeric order (node 10 after node 2), then the
    others by their text."""
    return (0, key, "") if isinstance(key, int) else (1, 0, str(key))


def hybrid_layout(
    dcn_config: Sequence[Tuple[str, int]],
    ici_config: Sequence[Tuple[str, int]],
    granules: Sequence[object],
) -> Tuple[List[Tuple[str, int]], List[int]]:
    """``(dims, layout)`` of the hybrid mesh whose rank ``r`` lies in
    granule ``granules[r]``: the DCN dims over the granules, the ICI
    dims over the ranks of one granule, and the global ranks in the
    mesh's row-major order (granules in ``_granule_order``, each
    granule's ranks in rank order).  Uneven granules raise."""
    groups: Dict[object, List[int]] = {}
    for rank, key in enumerate(granules):
        groups.setdefault(key, []).append(rank)
    keys = sorted(groups, key=_granule_order)
    per = {len(g) for g in groups.values()}
    if len(per) != 1:
        raise ValueError(
            f"uneven granules: {sorted(per)} ranks per granule")
    dcn_dims = _resolve_dims(dcn_config, len(keys))
    ici_dims = _resolve_dims(ici_config, per.pop())
    return (list(dcn_dims) + list(ici_dims),
            [r for k in keys for r in groups[k]])


def _node_indices(world: int) -> List[int]:
    """Every rank's node index (``DLROVER_TPU_NODE_INDEX``), gathered
    over the world."""
    from dlrover_tpu_torch.common.env import get_node_index

    mine = get_node_index()
    if world <= 1:
        return [mine]
    import torch.distributed as dist

    rows = [None] * world
    dist.all_gather_object(rows, mine)
    return [int(r) for r in rows]


def create_hybrid_parallel_mesh(
    dcn_config: Sequence[Tuple[str, int]],
    ici_config: Sequence[Tuple[str, int]],
    device: Optional[torch.device] = None,
    set_global: bool = True,
    granule_fn=None,
) -> MeshContext:
    """Multi-node mesh: DCN axes stride ACROSS nodes, ICI axes stay
    INSIDE a node (reference ``dlrover_tpu/parallel/mesh.py:158``, where
    the granule is a TPU slice).  Put data and pipe in ``dcn_config``,
    tensor, seq, expert and fsdp in ``ici_config``: their collectives
    then run over the node's own links.

    ``granule_fn(rank) -> key`` groups the world's ranks (default: each
    rank's node index, gathered over the world; the test seam).  The
    mesh is ``create_parallel_mesh`` over the DCN axes (outermost) then
    the ICI axes, so ``destroy_parallel_mesh`` frees it the same way.
    Where the granules in numeric order do not hold the ranks in their
    own order (the reference permutes its devices; the agent numbers
    ranks node by node, so no launch of the port does this), it raises.
    """
    world, _ = _world()
    if granule_fn is None:
        granules = _node_indices(world)
    else:
        granules = [granule_fn(r) for r in range(world)]
    dims, layout = hybrid_layout(dcn_config, ici_config, granules)
    if layout != list(range(world)):
        raise ValueError(
            f"granules {granules} do not hold the ranks in order: the "
            "ranks of one node must follow each other, nodes in "
            "numeric order")
    n_dcn = len(list(dcn_config))
    logger.info("hybrid mesh: dcn %s x ici %s over %d ranks",
                dict(dims[:n_dcn]), dict(dims[n_dcn:]), world)
    return create_parallel_mesh(dims, device=device, set_global=set_global)


def get_mesh_context() -> Optional[MeshContext]:
    return _context


def axis_size(name: str) -> int:
    return _context.axis_size(name) if _context else 1


def destroy_parallel_mesh(ctx: Optional[MeshContext] = None):
    """Forget the global mesh context.  With ``ctx``, also destroy the
    process groups ``create_parallel_mesh`` made for it (each axis's
    and those of ``group_over``), never the world's default group, which
    a mesh of one axis over the whole world reuses, nor the elastic
    context's host group: what a dry run calls between candidates, so
    that a race does not pile up communicators.  Every rank of the world
    destroys in the same order, as it created."""
    global _context
    with _lock:
        if ctx is None or _context is ctx:
            _context = None
    if ctx is None or ctx.mesh is None:
        return
    import torch.distributed as dist

    from dlrover_tpu_torch.trainer.elastic.context import get_context

    keep = {id(dist.distributed_c10d._get_default_group())}
    elastic = get_context()
    if elastic is not None and elastic.host_group is not None:
        keep.add(id(elastic.host_group))
    groups = [ctx.mesh.get_group(n) for n in ctx.mesh.mesh_dim_names]
    groups += [ctx.groups[k] for k in sorted(ctx.groups)]
    done = set()
    for g in groups:
        if id(g) in keep or id(g) in done:
            continue
        done.add(id(g))
        dist.destroy_process_group(g)
    ctx.mesh = None
    ctx.groups = {}


def data_parallel_size() -> int:
    """Total batch-sharding factor: data * fsdp axes (ZeRO shards
    params over the same replicas that shard the batch)."""
    return axis_size(AxisName.DATA) * axis_size(AxisName.FSDP)


def build_device_mesh_dims(
    num_devices: int,
    data: int = -1,
    fsdp: int = 1,
    tensor: int = 1,
    seq: int = 1,
    expert: int = 1,
    pipe: int = 1,
) -> List[Tuple[str, int]]:
    """Convenience: the canonical axis ordering (outermost→innermost =
    pipe, data, fsdp, expert, seq, tensor) with one inferred dim."""
    dims = [
        (AxisName.PIPELINE, pipe),
        (AxisName.DATA, data),
        (AxisName.FSDP, fsdp),
        (AxisName.EXPERT, expert),
        (AxisName.SEQUENCE, seq),
        (AxisName.TENSOR, tensor),
    ]
    return _resolve_dims(dims, num_devices)
