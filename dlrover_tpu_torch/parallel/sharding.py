"""Logical-axis sharding rules, and the placements the train step keeps.

Port of ``dlrover_tpu/parallel/sharding.py``.  ``LogicalAxisRules``,
``default_rules``, ``rules_scope``, ``active_rules`` and
``filter_spec_for_mesh`` are copies (a ``PartitionSpec`` here is a
tuple of mesh-axis entries, as JAX's is).  What GSPMD does with the
specs in the JAX version is done by hand here:

- ``param_sharding_with_fsdp`` returns the dim of a param that the
  ``fsdp`` axis shards (the rule table's, else the largest divisible
  dim still unsharded, as in the reference), or None.
- ``shard_pytree`` keeps each rank's slice of every leaf as a plain
  local tensor and records its ``Placement`` beside it: one ``Shard``
  per mesh axis that cuts the leaf (``LAYERS -> pipe``; ``HEADS``,
  ``KV_HEADS``, ``MLP``, ``VOCAB -> tensor``; ``EMBED -> fsdp`` or the
  dim ``param_sharding_with_fsdp`` picks), with a start per dim and the
  local shape.  The model sees plain tensors: the kernels are ``ctypes``
  calls that take plain tensors, so a DTensor would never reach them.
- ``ParamGather`` is how the forward gets its weights back over
  ``fsdp``: the model asks the active gather (``gather_scope``/
  ``active_gather``) for each leaf where it uses it, and for each
  layer's slices inside the layer loop (``models/llama.py``), so no card
  ever holds every layer's full weights at once.  The gather's gradient
  is a reduce-scatter onto the rank's slice
  (``collectives.all_gather_dim``).  The tensor and pipe slices stay
  local: the model computes on them (column- and row-parallel
  projections, a vocab-parallel embedding and loss, a stage's layers).
  The gather also carries the mesh and the rule table the model reads
  (``mesh_ctx``, ``rules``).
- ``BatchSharding`` is ``BATCH -> (data, fsdp)``: the rows of a global
  batch that a rank holds.  Every tensor, seq and pipe rank of one
  (data, fsdp) coordinate holds the same rows.

The expert axis waits for ROADMAP A7: ``logical_sharding`` and
``apply_sharding_constraint`` raise for a spec that names it with
size > 1.
"""

import contextlib
import threading
from dataclasses import dataclass
from typing import Dict, List, Optional, Sequence, Tuple

import torch

from dlrover_tpu_torch.parallel.mesh import AxisName, MeshContext

# logical axis vocabulary used by model definitions
BATCH = "batch"
SEQ = "seq_len"
EMBED = "embed"
MLP = "mlp"
HEADS = "heads"
KV_HEADS = "kv_heads"
HEAD_DIM = "head_dim"
VOCAB = "vocab"
EXPERT = "expert"
LAYERS = "layers"

#: the mesh axes that wait for a later slice (ROADMAP label): a spec or
#: a strategy that uses one of them with size > 1 raises
LATER_AXES = {
    AxisName.EXPERT: "A7",
}


class PartitionSpec(tuple):
    """One entry per array dim: a mesh axis, a tuple of them, or None."""

    def __new__(cls, *entries):
        return super().__new__(cls, entries)

    def __repr__(self):
        return f"PartitionSpec{tuple(self)!r}"


class LogicalAxisRules:
    """Ordered mapping logical-axis -> mesh axis (or tuple of axes).

    First match wins; unlisted logical axes are replicated (None).
    """

    def __init__(self, rules: Sequence[Tuple[str, Optional[object]]]):
        self._rules: List[Tuple[str, Optional[object]]] = list(rules)

    def mesh_axes(self, logical: Optional[str]):
        if logical is None:
            return None
        for name, axes in self._rules:
            if name == logical:
                return axes
        return None

    def spec(self, logical_axes: Sequence[Optional[str]]):
        """PartitionSpec from a tuple of logical axis names."""
        used = set()
        entries = []
        for ax in logical_axes:
            target = self.mesh_axes(ax)
            # a mesh axis may appear at most once in a spec
            if target is None:
                entries.append(None)
                continue
            flat = target if isinstance(target, tuple) else (target,)
            if any(a in used for a in flat):
                entries.append(None)
                continue
            used.update(flat)
            entries.append(target)
        return PartitionSpec(*entries)

    def extend(self, extra: Sequence[Tuple[str, Optional[object]]]):
        return LogicalAxisRules(list(extra) + self._rules)

    def uses_axis(self, mesh_axis: str,
                  exclude: Sequence[str] = (BATCH,)) -> bool:
        """True when some rule (outside ``exclude``) targets
        ``mesh_axis`` — i.e. the strategy actively shards params over
        it (BATCH is excluded by default: it always carries the data
        axes for activations regardless of the param strategy)."""
        for name, axes in self._rules:
            if name in exclude:
                continue
            flat = axes if isinstance(axes, tuple) else (axes,)
            if mesh_axis in flat:
                return True
        return False


def default_rules(
    fsdp: bool = True,
    tensor_parallel: bool = False,
    sequence_parallel: bool = False,
    expert_parallel: bool = False,
    pipeline: bool = False,
) -> LogicalAxisRules:
    """The canonical rule tables (strategy selection in one place)."""
    rules: List[Tuple[str, Optional[object]]] = [
        # batch is always sharded over every data-flavored axis
        (BATCH, (AxisName.DATA, AxisName.FSDP)),
    ]
    if pipeline:
        rules.append((LAYERS, AxisName.PIPELINE))
    if sequence_parallel:
        rules.append((SEQ, AxisName.SEQUENCE))
    if tensor_parallel:
        rules += [
            (HEADS, AxisName.TENSOR),
            (KV_HEADS, AxisName.TENSOR),
            (MLP, AxisName.TENSOR),
            (VOCAB, AxisName.TENSOR),
        ]
    if expert_parallel:
        rules.append((EXPERT, AxisName.EXPERT))
    if fsdp:
        # ZeRO-3: shard the big parameter dim over the fsdp axis
        rules.append((EMBED, AxisName.FSDP))
    return LogicalAxisRules(rules)


_scope = threading.local()


@contextlib.contextmanager
def rules_scope(rules: "LogicalAxisRules"):
    """Bind the active rule table while the train step runs the loss."""
    stack = getattr(_scope, "stack", None)
    if stack is None:
        stack = _scope.stack = []
    stack.append(rules)
    try:
        yield rules
    finally:
        stack.pop()


def active_rules() -> Optional["LogicalAxisRules"]:
    stack = getattr(_scope, "stack", None)
    return stack[-1] if stack else None


def filter_spec_for_mesh(spec, mesh):
    """Drop spec entries referencing axes the mesh doesn't have (a rule
    table is strategy-global; the mesh picks which axes exist)."""
    mesh_axes = set(mesh.axis_names)
    entries = []
    for e in spec:
        flat = e if isinstance(e, tuple) else (e,)
        if e is None or all(a in mesh_axes for a in flat):
            entries.append(e)
        else:
            present = tuple(a for a in flat if a in mesh_axes)
            entries.append(
                present if len(present) > 1
                else (present[0] if present else None)
            )
    return PartitionSpec(*entries)


def _check_later_axes(spec, mesh: MeshContext):
    """Raise for a spec that shards over an axis this port lacks."""
    for e in spec:
        for a in e if isinstance(e, tuple) else (e,):
            if a in LATER_AXES and mesh.axis_size(a) > 1:
                raise NotImplementedError(
                    f"sharding over the {a!r} axis is ROADMAP "
                    f"{LATER_AXES[a]}: this port shards over data, fsdp, "
                    "tensor, seq and pipe")


def logical_sharding(mesh: MeshContext, rules: LogicalAxisRules,
                     logical_axes):
    """The spec of ``logical_axes`` on ``mesh``; raises for the expert
    axis (ROADMAP A7)."""
    spec = filter_spec_for_mesh(rules.spec(logical_axes), mesh)
    _check_later_axes(spec, mesh)
    return spec


def apply_sharding_constraint(x, logical_axes, rules: LogicalAxisRules):
    """The activation constraint.  Each rank already holds its own
    slice of every activation (its rows, its seq chunk, its heads), laid
    out by the model itself, so there is nothing to move; a constraint
    over the expert axis raises (ROADMAP A7)."""
    from dlrover_tpu_torch.parallel.mesh import get_mesh_context

    ctx = get_mesh_context()
    if ctx is not None:
        logical_sharding(ctx, rules, logical_axes)
    return x


def param_sharding_with_fsdp(
    mesh: MeshContext,
    rules: LogicalAxisRules,
    logical_axes,
    shape,
    fsdp_axis: str = AxisName.FSDP,
) -> Optional[int]:
    """The dim of a param of ``shape`` that the fsdp axis shards, or
    None (replicated).  The rule table's placement wins; otherwise the
    fsdp axis goes to the param's LARGEST still-unsharded, divisible
    dim (reference ``zero_optimization.py:240`` FSDP shards every
    parameter, and the all-gather rides the biggest dim)."""
    spec = logical_sharding(mesh, rules, logical_axes)
    fsdp_size = mesh.axis_size(fsdp_axis)
    if fsdp_size <= 1:
        return None
    for i, e in enumerate(spec):
        if fsdp_axis in (e if isinstance(e, tuple) else (e,)):
            if shape[i] % fsdp_size:
                raise ValueError(
                    f"dim {i} of {tuple(shape)} does not split over "
                    f"fsdp {fsdp_size}")
            return i
    candidates = [
        (dim_size, i)
        for i, (dim_size, e) in enumerate(zip(shape, spec))
        if e is None and dim_size % fsdp_size == 0 and dim_size > 1
    ]
    if not candidates:
        return None
    return max(candidates)[1]


@dataclass(frozen=True)
class Shard:
    """One mesh axis cutting a leaf: along ``dim`` into ``num`` equal
    parts, of which this rank holds part ``index``."""

    axis: str
    dim: int
    num: int
    index: int


@dataclass(frozen=True)
class Placement:
    """Where a rank's slice of a leaf sits in the global leaf: the
    ``Shard`` of each mesh axis that cuts it (none: the whole leaf,
    replicated), with the slice's start on every dim and its shape.
    Two axes on one dim split it in the order of ``shards`` (the first
    outermost), as a tuple entry of a JAX spec does."""

    global_shape: Tuple[int, ...]
    shards: Tuple[Shard, ...] = ()

    @staticmethod
    def of(shape, dim: Optional[int], num_shards: int, index: int,
           axis: str = AxisName.FSDP) -> "Placement":
        """One axis (fsdp by default) cutting ``dim``, or none."""
        shape = tuple(int(s) for s in shape)
        if dim is None or num_shards <= 1:
            return Placement(shape)
        return Placement(shape, (Shard(axis, dim, num_shards, index),))

    def _dim_split(self, dim: int) -> Tuple[int, int]:
        """(parts, this rank's part) of ``dim`` over its shards."""
        num, index = 1, 0
        for s in self.shards:
            if s.dim == dim:
                num, index = num * s.num, index * s.num + s.index
        return num, index

    @property
    def local_shape(self) -> Tuple[int, ...]:
        return tuple(n // self._dim_split(d)[0]
                     for d, n in enumerate(self.global_shape))

    @property
    def starts(self) -> Tuple[int, ...]:
        """The slice's first index on every dim of the global leaf."""
        return tuple(self._dim_split(d)[1] * (n // self._dim_split(d)[0])
                     for d, n in enumerate(self.global_shape))

    @property
    def sharded(self) -> bool:
        return bool(self.shards)

    def shard(self, axis: str) -> Optional[Shard]:
        """The shard of mesh axis ``axis``, or None."""
        return next((s for s in self.shards if s.axis == axis), None)

    def dim_of(self, axis: str) -> Optional[int]:
        """The dim that ``axis`` cuts, or None."""
        s = self.shard(axis)
        return None if s is None else s.dim

    @property
    def dim(self) -> Optional[int]:
        """The one dim that is cut (None: replicated); a leaf cut on two
        dims raises (read ``shards``)."""
        dims = {s.dim for s in self.shards}
        if len(dims) > 1:
            raise ValueError(f"{self} is cut on dims {sorted(dims)}")
        return next(iter(dims), None)

    @property
    def start(self) -> int:
        """The start on ``dim`` (0 when replicated)."""
        return 0 if self.dim is None else self.starts[self.dim]

    def local(self, full: torch.Tensor) -> torch.Tensor:
        """This rank's slice of the global ``full``, as its own
        contiguous tensor (``full`` itself when nothing cuts it)."""
        if not self.sharded:
            return full
        out = full
        for d, (start, size) in enumerate(zip(self.starts,
                                              self.local_shape)):
            if size != full.shape[d]:
                out = out.narrow(d, start, size)
        return out.clone()


def placement_for(mesh: MeshContext, rules: LogicalAxisRules, logical_axes,
                  shape, use_fsdp: bool) -> Placement:
    """The placement of a param of ``shape`` with ``logical_axes`` on
    this rank of ``mesh``: the rule table's axes (tensor, pipe, ...), and
    with ``use_fsdp`` the fsdp axis on the dim
    ``param_sharding_with_fsdp`` picks."""
    shape = tuple(int(s) for s in shape)
    spec = logical_sharding(mesh, rules, logical_axes)
    fsdp_dim = (param_sharding_with_fsdp(mesh, rules, logical_axes, shape)
                if use_fsdp else None)
    shards = []
    for d, e in enumerate(spec):
        for a in e if isinstance(e, tuple) else (e,):
            if a is None or a == AxisName.FSDP or mesh.axis_size(a) <= 1:
                continue
            n = mesh.axis_size(a)
            if shape[d] % n:
                raise ValueError(
                    f"dim {d} of {shape} does not split over {a} {n}")
            shards.append(Shard(a, d, n, mesh.axis_index(a)))
    if fsdp_dim is not None:
        # where the rule table names fsdp on a dim beside another axis
        # (a tuple entry), keep the table's order
        shards.append(Shard(AxisName.FSDP, fsdp_dim,
                            mesh.axis_size(AxisName.FSDP),
                            mesh.axis_index(AxisName.FSDP)))
    return Placement(shape, tuple(shards))


def tree_map(fn, *trees):
    """``fn`` over the leaves of nested dicts of one structure.  Lists
    and tuples are leaves here (shapes, logical axes), unlike in
    ``common.tree.tree_map``."""
    first = trees[0]
    if isinstance(first, dict):
        return {k: tree_map(fn, *(t[k] for t in trees)) for k in first}
    return fn(*trees)


def shard_pytree(params: Dict, placements: Dict) -> Dict:
    """Each leaf of ``params`` (global tensors) cut to this rank's
    slice by its ``Placement``; the full tensors are not kept."""
    return tree_map(lambda t, p: p.local(t), params, placements)


@dataclass(frozen=True)
class BatchSharding:
    """``BATCH -> (data, fsdp)``: a global batch's rows split into
    ``num_shards`` consecutive blocks in (data, fsdp) row-major order;
    this rank holds block ``index``, on ``device``."""

    num_shards: int
    index: int
    device: torch.device

    def local(self, batch):
        """This rank's rows of a batch (a dict of arrays/tensors, or one
        array), cut on the host: only these rows cross to the card."""
        if isinstance(batch, dict):
            return {k: self.local(v) for k, v in batch.items()}
        if self.num_shards == 1:
            return batch
        rows = batch.shape[0]
        if rows % self.num_shards:
            raise ValueError(
                f"a batch of {rows} rows does not split over "
                f"{self.num_shards} data x fsdp ranks")
        size = rows // self.num_shards
        return batch[self.index * size:(self.index + 1) * size]


class ParamGather:
    """The weights of a sharded model gathered over fsdp, one use at a
    time.

    ``placements`` mirrors the params (a ``Placement`` per leaf);
    ``group`` is the fsdp group (None at fsdp 1, where every gather
    returns its input).  ``leaf(path, t)`` gathers a whole leaf
    (embedding, head, final norm) around its own use; ``layer(lp)``
    gathers one layer's slices of the stacked ``layers`` leaves.  What
    the tensor and pipe axes cut stays cut.  ``gathered`` lists
    ``(path, elements)`` of every gather of the step, recomputes
    included.  ``mesh_ctx`` and ``rules`` are the step's mesh and rule
    table, which the model reads for its tensor, seq and pipe axes."""

    def __init__(self, placements: Dict, group=None,
                 mesh_ctx: Optional[MeshContext] = None,
                 rules: Optional[LogicalAxisRules] = None):
        self.placements = placements
        self.group = group
        self.mesh_ctx = mesh_ctx
        self.rules = rules
        self.gathered: List[Tuple[str, int]] = []

    def _gather(self, path: str, t: torch.Tensor, dim: Optional[int]):
        from dlrover_tpu_torch.parallel.collectives import all_gather_dim

        out = t if dim is None else all_gather_dim(t, dim, self.group)
        self.gathered.append((path, int(out.numel())))
        return out

    def leaf(self, path: str, t: torch.Tensor) -> torch.Tensor:
        p = self.placements
        for key in path.split("/"):
            p = p[key]
        return self._gather(path, t, p.dim_of(AxisName.FSDP))

    def layer(self, lp: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
        out = {}
        for k, v in lp.items():
            dim = self.placements["layers"][k].dim_of(AxisName.FSDP)
            if dim == 0:
                raise ValueError(
                    f"layers/{k} is sharded over fsdp along its layer dim: "
                    "a layer's weights would live on one rank only")
            out[k] = self._gather(f"layers/{k}", v,
                                  None if dim is None else dim - 1)
        return out


@contextlib.contextmanager
def gather_scope(gather: Optional[ParamGather]):
    """Bind the active ``ParamGather`` while the train step runs the
    loss (and the recompute of its checkpointed layers, which runs
    inside the same call to ``autograd.grad``)."""
    stack = getattr(_scope, "gathers", None)
    if stack is None:
        stack = _scope.gathers = []
    stack.append(gather)
    try:
        yield gather
    finally:
        stack.pop()


def active_gather() -> Optional[ParamGather]:
    stack = getattr(_scope, "gathers", None)
    return stack[-1] if stack else None
