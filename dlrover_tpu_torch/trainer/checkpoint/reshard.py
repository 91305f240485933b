"""Device-count-agnostic checkpoint layouts + elastic reshard reads.

Port of ``dlrover_tpu/trainer/checkpoint/reshard.py``.  The layout
header, the box arithmetic, the plan and the range reads are the
reference's (numpy, no ``jax``); what changed: leaves are named through
the port's ``_flatten_keyed`` (JAX key paths), a leaf's dtype string is
mapped by the port's own table (``agent/ckpt_shm.py``, so ``bfloat16``
needs no ``ml_dtypes``), a streamed leaf is a CPU tensor, and
``derive_layouts`` reads the placements the sharded train step recorded
(the fsdp slice of each param and of its moments), where the reference
reads ``jax.Array`` shardings.

What follows is the reference's account of the format.

A classic flash-checkpoint shard (``shard_{rank}.drckpt``) is only
readable by the rank that wrote it: the file records local shapes and
byte offsets, nothing about WHERE the shard sits in the global state.
A job that loses a host therefore cannot read its own storage
checkpoint on the new world — every world-size change degenerates to
restart-from-scratch (PAPER.md §1's headline promise, inverted).

This module makes the format world-agnostic and implements the
resharded read:

- :class:`LeafLayout` — the per-leaf global-layout header: the leaf's
  GLOBAL shape plus this shard's index slice (start + local shape per
  dim).  Layout dicts ride the shm slot meta and the ``.drckpt``
  header (``agent/ckpt_shm.py``), so both the periodic persist and the
  emergency crash flush produce world-agnostic shards.  Old files
  simply lack the header and keep restoring on an unchanged world.
- layout constructors — :func:`replicated_layouts` (every rank holds
  the full leaf: the data-parallel case), :func:`axis0_layouts` (the
  leading dim sharded evenly across ranks: the FSDP host-sharding
  case, and the simulated-host harness in ``tests/test_reshard.py``),
  :func:`derive_layouts` (from the train step's placements).
- :func:`iter_copy_runs` — the N-d intersection math: given a source
  shard's block and a target block of the same global leaf, yield the
  ``(src_offset, dst_offset, nbytes)`` contiguous runs that move
  exactly the overlapping bytes, nothing else.
- :func:`plan_reshard` / :func:`stream_resharded_leaves` — scan every
  shard header in a checkpoint dir (headers only — a header read is
  KBs against GB shards), claim each target leaf's uncovered region
  greedily across the sources, and stream only the overlapping byte
  ranges (seek + readinto) into one preallocated buffer per leaf,
  yielding leaves as their bytes land, exactly like the same-world
  stream (``stream_shard_leaves``).

The reshard plan and the byte movement are pure host work.
"""

import os
import pickle
import re
import struct
from dataclasses import dataclass
from typing import Dict, Iterator, List, Optional, Sequence, Tuple

import numpy as np

from dlrover_tpu_torch.agent.ckpt_shm import (
    _flatten_keyed,
    _leaf_meta,
    _views,
    itemsize,
)
from dlrover_tpu_torch.common import parallel_io

_HDR = struct.Struct("<Q")
_SHARD_RE = re.compile(r"^shard_(\d+)\.drckpt$")


class ReshardError(RuntimeError):
    """The checkpoint cannot be reassembled onto the requested
    layouts (missing coverage, conflicting global shapes, mixed
    steps, or shards without layout headers)."""


@dataclass(frozen=True)
class LeafLayout:
    """One leaf's place in the global state: the global shape and
    this shard's index slice (``start`` + local ``shape`` per dim).
    A replicated leaf is ``start == 0`` with ``shape ==
    global_shape`` — any single shard covers it."""

    global_shape: Tuple[int, ...]
    start: Tuple[int, ...]
    shape: Tuple[int, ...]

    def __post_init__(self):
        if not (
            len(self.global_shape) == len(self.start) == len(self.shape)
        ):
            raise ValueError(
                f"rank mismatch: global={self.global_shape} "
                f"start={self.start} shape={self.shape}"
            )
        for g, s, e in zip(self.global_shape, self.start, self.shape):
            if s < 0 or e <= 0 or s + e > g:
                raise ValueError(
                    f"block [{self.start}+{self.shape}] outside "
                    f"global {self.global_shape}"
                )

    @property
    def replicated(self) -> bool:
        return self.shape == self.global_shape

    def as_dict(self) -> Dict:
        """JSON/pickle-safe form that rides shm meta and the shard
        header."""
        return {
            "global_shape": list(self.global_shape),
            "start": list(self.start),
            "shape": list(self.shape),
        }

    @classmethod
    def from_dict(cls, d: Dict) -> "LeafLayout":
        return cls(
            global_shape=tuple(int(v) for v in d["global_shape"]),
            start=tuple(int(v) for v in d["start"]),
            shape=tuple(int(v) for v in d["shape"]),
        )


def _keyed_leaves(tree) -> List[Tuple[str, object]]:
    return _flatten_keyed(tree)


def _leaf_shape(leaf) -> Tuple[int, ...]:
    return tuple(int(v) for v in _leaf_meta(leaf)[1])


def replicated_layouts(tree) -> Dict[str, Dict]:
    """Every leaf fully replicated (the data-parallel snapshot: each
    rank's shard holds the complete state).  Under this layout ANY
    world size restores from any one shard — the job that shrinks
    2→1 reads the survivor's (or any) shard file."""
    return {
        key: LeafLayout(
            global_shape=_leaf_shape(leaf),
            start=tuple(0 for _ in _leaf_shape(leaf)),
            shape=_leaf_shape(leaf),
        ).as_dict()
        for key, leaf in _keyed_leaves(tree)
    }


def axis0_layouts(local_tree, rank: int, world: int,
                  min_shard_dim0: int = 1) -> Dict[str, Dict]:
    """The leading dim of every (large-enough) leaf holds this rank's
    ``1/world`` slice; leaves whose dim0 is smaller than
    ``min_shard_dim0 * world`` (scalars, tiny vectors) are treated as
    replicated.  ``local_tree`` is THIS rank's local block — the
    caller's per-rank snapshot, exactly what ``save_state`` writes."""
    out: Dict[str, Dict] = {}
    for key, leaf in _keyed_leaves(local_tree):
        shape = _leaf_shape(leaf)
        if shape and shape[0] >= min_shard_dim0:
            d0 = shape[0]
            out[key] = LeafLayout(
                global_shape=(d0 * world,) + shape[1:],
                start=(rank * d0,) + tuple(0 for _ in shape[1:]),
                shape=shape,
            ).as_dict()
        else:
            out[key] = LeafLayout(
                global_shape=shape,
                start=tuple(0 for _ in shape),
                shape=shape,
            ).as_dict()
    return out


def placements_by_key(state, placements) -> Dict[str, object]:
    """{key of a leaf of ``state``: the ``Placement`` of its param} for
    the params (``['params']<path>``) and each of their optimizer
    moments (``['opt_state'].<name><path>``); every other leaf (the
    steps) maps to None."""
    from dlrover_tpu_torch.models.convert import _dict_paths

    by_path = dict(_dict_paths(placements))
    out = {}
    for key, _ in _keyed_leaves(state):
        place = None
        if key.startswith("['params']"):
            place = by_path.get(key[len("['params']"):])
        elif key.startswith("['opt_state']."):
            rest = key[len("['opt_state']."):]
            path = rest[rest.find("["):] if "[" in rest else ""
            place = by_path.get(path)
        out[key] = place
    return out


def derive_layouts(state, placements=None) -> Optional[Dict[str, Dict]]:
    """Layouts of this rank's state from the placements the train step
    recorded (``TrainStepFns.placements``: a ``parallel.sharding.
    Placement`` per param, the params' structure).  A param and each of
    its optimizer moments carry the param's global shape, its slice's
    start on every dim (each of fsdp, tensor and pipe may cut one) and
    its local shape; every other leaf (the steps) is whole.  With no
    placements (a one-card step) every leaf is whole.  The reference
    derives the same from live ``jax.Array`` shardings."""
    if placements is None:
        return replicated_layouts(state)
    places = placements_by_key(state, placements)
    out = {}
    for key, leaf in _keyed_leaves(state):
        shape = _leaf_shape(leaf)
        place = places[key]
        if place is None or not place.sharded:
            out[key] = LeafLayout(
                global_shape=shape, start=tuple(0 for _ in shape),
                shape=shape).as_dict()
            continue
        if tuple(place.local_shape) != shape:
            raise ValueError(
                f"{key}: local shape {shape}, placement says "
                f"{tuple(place.local_shape)}")
        out[key] = LeafLayout(global_shape=tuple(place.global_shape),
                              start=tuple(place.starts),
                              shape=shape).as_dict()
    return out


# ----------------------------------------------------- box arithmetic
def _intersect(a_start, a_shape, b_start, b_shape):
    """Intersection of two boxes, or None."""
    lo = tuple(max(x, y) for x, y in zip(a_start, b_start))
    hi = tuple(
        min(x + w, y + v)
        for x, w, y, v in zip(a_start, a_shape, b_start, b_shape)
    )
    if any(h <= l for l, h in zip(lo, hi)):
        return None
    return lo, tuple(h - l for l, h in zip(lo, hi))


def _subtract_box(box, hole):
    """``box`` minus ``hole`` (both (start, shape)) as disjoint boxes.
    Standard axis-sweep split: slabs strictly below/above the hole on
    each dim, shrinking toward the intersection."""
    inter = _intersect(box[0], box[1], hole[0], hole[1])
    if inter is None:
        return [box]
    out = []
    cur_start = list(box[0])
    cur_shape = list(box[1])
    for d in range(len(cur_start)):
        i_lo = inter[0][d]
        i_hi = inter[0][d] + inter[1][d]
        c_lo = cur_start[d]
        c_hi = cur_start[d] + cur_shape[d]
        if c_lo < i_lo:
            s, sh = list(cur_start), list(cur_shape)
            sh[d] = i_lo - c_lo
            out.append((tuple(s), tuple(sh)))
        if i_hi < c_hi:
            s, sh = list(cur_start), list(cur_shape)
            s[d] = i_hi
            sh[d] = c_hi - i_hi
            out.append((tuple(s), tuple(sh)))
        cur_start[d] = i_lo
        cur_shape[d] = i_hi - i_lo
    return out


def iter_copy_runs(
    src_start: Sequence[int],
    src_shape: Sequence[int],
    dst_start: Sequence[int],
    dst_shape: Sequence[int],
    itemsize: int,
    box: Optional[Tuple[Tuple[int, ...], Tuple[int, ...]]] = None,
) -> Iterator[Tuple[int, int, int]]:
    """Contiguous ``(src_off_bytes, dst_off_bytes, nbytes)`` runs
    moving ``box`` (default: the src∩dst intersection) of a row-major
    global leaf from the source block to the target block.  Offsets
    are relative to each block's own first byte.  A run folds every
    trailing dim the box spans fully in BOTH blocks, so a replicated
    source feeding a replicated target is ONE run."""
    src_start = tuple(src_start)
    src_shape = tuple(src_shape)
    dst_start = tuple(dst_start)
    dst_shape = tuple(dst_shape)
    if box is None:
        box = _intersect(src_start, src_shape, dst_start, dst_shape)
        if box is None:
            return
    b_start, b_shape = box
    n = len(b_start)
    if n == 0:  # scalar leaf
        yield 0, 0, itemsize
        return
    # j = first dim index such that every dim AFTER j is spanned
    # fully in both blocks (runs are contiguous over dims [j..n))
    j = n - 1
    while j > 0 and (
        b_shape[j] == src_shape[j] == dst_shape[j]
    ):
        j -= 1
    run_elems = b_shape[j]
    for d in range(j + 1, n):
        run_elems *= b_shape[d]
    src_strides = [1] * n
    dst_strides = [1] * n
    for d in range(n - 2, -1, -1):
        src_strides[d] = src_strides[d + 1] * src_shape[d + 1]
        dst_strides[d] = dst_strides[d + 1] * dst_shape[d + 1]
    rel_src = tuple(b - s for b, s in zip(b_start, src_start))
    rel_dst = tuple(b - s for b, s in zip(b_start, dst_start))
    outer = b_shape[:j]
    for idx in np.ndindex(*outer) if outer else [()]:
        src_off = sum(
            (rel_src[d] + (idx[d] if d < j else 0)) * src_strides[d]
            for d in range(j)
        )
        dst_off = sum(
            (rel_dst[d] + (idx[d] if d < j else 0)) * dst_strides[d]
            for d in range(j)
        )
        src_off += rel_src[j] * src_strides[j]
        dst_off += rel_dst[j] * dst_strides[j]
        yield (
            src_off * itemsize,
            dst_off * itemsize,
            run_elems * itemsize,
        )


# ------------------------------------------------------ shard headers
@dataclass
class ShardInfo:
    """One shard file's header: enough to plan range reads without
    touching its raw section."""

    rank: int
    path: str
    step: int
    #: {key: (dtype_str, shape, offset, nbytes)} from the 5-tuple specs
    specs: Dict[str, Tuple[str, Tuple[int, ...], int, int]]
    #: {key: LeafLayout} — None when the file predates layout headers
    layouts: Optional[Dict[str, LeafLayout]]
    #: file offset where the raw section begins
    data_offset: int


def read_shard_header(path: str, storage=None) -> ShardInfo:
    """Header-only read of one ``.drckpt`` (KBs, never the raw GB)."""
    f = storage.open_read(path) if storage is not None else open(path, "rb")
    with f:
        hdr = f.read(_HDR.size)
        if not hdr or len(hdr) < _HDR.size:
            raise ReshardError(f"no header in {path}")
        (hdr_len,) = _HDR.unpack(hdr)
        meta = pickle.loads(f.read(hdr_len))
    m = _SHARD_RE.match(os.path.basename(path))
    rank = int(m.group(1)) if m else -1
    raw_layouts = meta.get("layouts")
    layouts = (
        {
            k: LeafLayout.from_dict(v)
            for k, v in raw_layouts.items()
        }
        if raw_layouts
        else None
    )
    return ShardInfo(
        rank=rank,
        path=path,
        step=int(meta.get("step", -1)),
        specs={
            key: (str(dt), tuple(shape), int(off), int(nb))
            for key, dt, shape, off, nb in meta["specs"]
        },
        layouts=layouts,
        data_offset=_HDR.size + hdr_len,
    )


def scan_checkpoint_shards(ckpt_dir: str, storage=None) -> List[ShardInfo]:
    """Every shard header in a committed checkpoint dir, rank order."""
    if storage is not None:
        names = storage.listdir(ckpt_dir)
    else:
        names = sorted(os.listdir(ckpt_dir)) if os.path.isdir(
            ckpt_dir
        ) else []
    shards = []
    for name in names:
        if _SHARD_RE.match(name):
            shards.append(
                read_shard_header(
                    os.path.join(ckpt_dir, name), storage
                )
            )
    shards.sort(key=lambda s: s.rank)
    return shards


# ------------------------------------------------------ reshard plan
@dataclass
class _LeafPlan:
    key: str
    dtype: str  # numpy name, as in the shard's specs
    shape: Tuple[int, ...]  # target local shape
    #: per source: (path, [(src_file_off, dst_buf_off, nbytes)])
    reads: List[Tuple[str, List[Tuple[int, int, int]]]]
    nbytes: int


def plan_reshard(
    shards: Sequence[ShardInfo],
    target_layouts: Dict[str, Dict],
) -> Tuple[int, List[_LeafPlan]]:
    """Claim every target leaf's region across the source shards.

    Greedy with explicit remainder subtraction: replicated sources
    overlap each other completely, and double-reading their bytes
    would both waste IO and (harmlessly but wastefully) rewrite the
    same destination — each source only claims what previous sources
    left uncovered.  Raises :class:`ReshardError` on mixed steps,
    missing layout headers, conflicting global shapes/dtypes, or any
    uncovered remainder."""
    if not shards:
        raise ReshardError("no shard files to reshard from")
    steps = {s.step for s in shards}
    if len(steps) > 1:
        raise ReshardError(
            f"mixed steps across shard files: {sorted(steps)}"
        )
    step = steps.pop()
    plans: List[_LeafPlan] = []
    for key, raw in target_layouts.items():
        want = (
            raw if isinstance(raw, LeafLayout)
            else LeafLayout.from_dict(raw)
        )
        dtype: Optional[str] = None
        remainder = [(want.start, want.shape)]
        reads: List[Tuple[str, List[Tuple[int, int, int]]]] = []
        for shard in shards:
            if not remainder:
                break
            if shard.layouts is None:
                raise ReshardError(
                    f"{shard.path} has no layout header (old-format "
                    "shard): restore is only possible on an "
                    "unchanged world"
                )
            if key not in shard.specs or key not in shard.layouts:
                continue
            dt, sshape, soff, _snb = shard.specs[key]
            src = shard.layouts[key]
            if src.global_shape != want.global_shape:
                raise ReshardError(
                    f"leaf {key}: global shape {src.global_shape} in "
                    f"{shard.path} != requested {want.global_shape}"
                )
            if tuple(sshape) != src.shape:
                raise ReshardError(
                    f"leaf {key}: spec shape {sshape} != layout "
                    f"block {src.shape} in {shard.path}"
                )
            if dtype is None:
                dtype = str(dt)
            elif str(dt) != dtype:
                raise ReshardError(
                    f"leaf {key}: dtype {dt} in {shard.path} != "
                    f"{dtype}"
                )
            runs: List[Tuple[int, int, int]] = []
            next_remainder = []
            for box in remainder:
                inter = _intersect(
                    src.start, src.shape, box[0], box[1]
                )
                if inter is None:
                    next_remainder.append(box)
                    continue
                for s_off, d_off, nb in iter_copy_runs(
                    src.start, src.shape, want.start, want.shape,
                    itemsize(dtype), box=inter,
                ):
                    runs.append(
                        (
                            shard.data_offset + soff + s_off,
                            d_off,
                            nb,
                        )
                    )
                next_remainder.extend(_subtract_box(box, inter))
            remainder = next_remainder
            if runs:
                runs.sort()  # sequential file access
                reads.append((shard.path, runs))
        if remainder:
            raise ReshardError(
                f"leaf {key}: region {remainder} covered by no shard "
                f"({len(shards)} shards scanned)"
            )
        if dtype is None:
            raise ReshardError(f"leaf {key}: found in no shard")
        nbytes = int(np.prod(want.shape or (1,))) * itemsize(dtype)
        plans.append(
            _LeafPlan(
                key=key,
                dtype=dtype,
                shape=want.shape,
                reads=reads,
                nbytes=nbytes,
            )
        )
    return step, plans


def stream_resharded_leaves(
    ckpt_dir: str,
    target_layouts: Dict[str, Dict],
    storage=None,
    shards: Optional[List[ShardInfo]] = None,
):
    """Generator mirroring ``ckpt_shm.stream_shard_leaves`` for a
    WORLD-CHANGED restore: yields ``("meta", step, specs, layouts)``
    first, then ``("leaf", key, ndarray)`` as each leaf's overlap
    reads complete.  Each leaf owns one freshly-allocated private
    buffer; only the overlapping byte ranges ever cross the storage
    boundary.  File handles are opened once per source shard and
    shared across leaves."""
    if shards is None:
        shards = scan_checkpoint_shards(ckpt_dir, storage)
    step, plans = plan_reshard(shards, target_layouts)
    specs = [
        (p.key, p.dtype, p.shape, 0, p.nbytes) for p in plans
    ]
    layouts = {
        k: (
            v.as_dict() if isinstance(v, LeafLayout) else dict(v)
        )
        for k, v in target_layouts.items()
    }
    yield "meta", step, specs, layouts
    handles: Dict[str, object] = {}
    chunk = parallel_io.chunk_nbytes()
    try:
        for plan in plans:
            raw = np.empty(plan.nbytes, dtype=np.uint8)
            mv = memoryview(raw)
            for path, runs in plan.reads:
                f = handles.get(path)
                if f is None:
                    f = (
                        storage.open_read(path)
                        if storage is not None
                        else open(path, "rb")
                    )
                    handles[path] = f
                for src_off, dst_off, nb in runs:
                    f.seek(src_off)
                    filled = 0
                    while filled < nb:
                        want = min(chunk, nb - filled)
                        view = mv[
                            dst_off + filled : dst_off + filled + want
                        ]
                        if hasattr(f, "readinto"):
                            got = f.readinto(view)
                        else:  # buffered remote reader
                            data = f.read(want)
                            got = len(data)
                            if got:
                                view[:got] = data
                        if not got:
                            raise ReshardError(
                                f"short read in {path} at "
                                f"{src_off + filled}"
                            )
                        filled += got
            yield "leaf", plan.key, _views(
                raw, 0, [(plan.key, plan.dtype, plan.shape, 0,
                          plan.nbytes)])[plan.key]
    finally:
        for f in handles.values():
            try:
                f.close()
            except Exception:  # noqa: BLE001
                pass


def checkpoint_world_size(shards: Sequence[ShardInfo]) -> int:
    """The world that WROTE a checkpoint (max shard rank + 1)."""
    return max((s.rank for s in shards), default=-1) + 1


def layouts_equal(a: Optional[Dict], b: Optional[Dict]) -> bool:
    """Whether two layout dicts describe the same placement (the gate
    for 'this shard/snapshot already matches what the restore wants —
    read it directly, no reshard')."""
    if a is None or b is None:
        return False
    if set(a) != set(b):
        return False
    for key in a:
        la = a[key] if isinstance(a[key], dict) else a[key].as_dict()
        lb = b[key] if isinstance(b[key], dict) else b[key].as_dict()
        if (
            list(la["global_shape"]) != list(lb["global_shape"])
            or list(la["start"]) != list(lb["start"])
            or list(la["shape"]) != list(lb["shape"])
        ):
            return False
    return True
