"""Shared-memory checkpoint shard handling, used on both sides of the
agent/training-process boundary.

Port of ``dlrover_tpu/agent/ckpt_shm.py``.  One shard is one process's
train state:

- shm segment ``dlrover_tpu_torch_ckpt_{name}_{rank}``: two slots of
  concatenated raw leaf bytes (the port's own prefix: a JAX job and a
  port job on one machine never attach to each other's segments);
- ``SharedDict`` ``ckpt_meta_{name}_{rank}``: {"step", "specs":
  [(keypath, dtype, shape, offset, nbytes)], "total_bytes", "valid",
  "slots", ...}.

A persisted shard (``*.drckpt``) is an 8-byte little-endian header
length, the pickled meta and the raw bytes: the format of the JAX
package, under the JAX package's key paths (``models/convert.py``), so
a shard written by either package restores in the other.  Dtype strings
are numpy's names (``"float32"``, ``"bfloat16"``, ``"int8"``); the port
maps them to torch dtypes itself and moves every leaf as bytes, so
``bfloat16`` needs no ``ml_dtypes``.

What changed against the reference, where it touched ``jax``:

- ``_flatten_keyed`` takes the port's train state (or a nested dict of
  tensors) and runs on the caller's thread: a Python step count is read
  there, and ``opt.step()`` updates tensors in place, so the caller must
  hand over tensors that no later step writes (``Trainer`` copies them on
  the device, or waits for the drain).
- ``_drain_leaves`` copies CUDA leaves through two pinned bounce buffers
  on a copy stream (which first waits for the work queued before the
  save): chunk k+1 crosses PCIe while chunk k is ``parallel_memcpy``'d
  into the segment.  A copy into pageable shm memory straight from the
  device would be synchronous and run at the pageable rate.
- ``load_state`` hands back CPU tensors viewing the segment (or one
  private copy); ``restore_to_target`` copies them into the target's
  tensors in place, CUDA ones through the same bounce buffers.
"""

import pickle
import struct
import threading
import time as _time
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from dlrover_tpu_torch.common import parallel_io
from dlrover_tpu_torch.common.fault_injection import maybe_crash
from dlrover_tpu_torch.common.log import default_logger as logger
from dlrover_tpu_torch.common.multi_process import (
    SharedDict,
    SharedLock,
    SharedMemory,
)
from dlrover_tpu_torch.models.convert import (
    HostScalar,
    _dict_paths,
    is_train_state,
    train_state_leaves,
)

SHM_PREFIX = "dlrover_tpu_torch_ckpt"
_HDR = struct.Struct("<Q")
#: generation side-segment payload: published step + 1 (0 = none)
_GEN = struct.Struct("<q")
#: bytes of each of the two pinned bounce buffers: 8 memcpy workers get
#: 32 MiB each, and the pair pins 512 MiB of host memory
BOUNCE_BYTES = 256 << 20

DTYPES = {
    "float64": torch.float64,
    "float32": torch.float32,
    "float16": torch.float16,
    "bfloat16": torch.bfloat16,
    "int64": torch.int64,
    "int32": torch.int32,
    "int16": torch.int16,
    "int8": torch.int8,
    "uint8": torch.uint8,
    "bool": torch.bool,
}
_NAMES = {v: k for k, v in DTYPES.items()}


def dtype_name(dtype: torch.dtype) -> str:
    """The numpy name of a torch dtype (the shard's string)."""
    if dtype not in _NAMES:
        raise TypeError(f"no checkpoint dtype for {dtype}")
    return _NAMES[dtype]


def torch_dtype(name: str) -> torch.dtype:
    if name not in DTYPES:
        raise TypeError(f"checkpoint dtype {name!r} has no torch dtype")
    return DTYPES[name]


def itemsize(name: str) -> int:
    return torch.empty((), dtype=torch_dtype(name)).element_size()


def _leaf_meta(leaf) -> Tuple[str, Tuple[int, ...]]:
    if torch.is_tensor(leaf):
        return dtype_name(leaf.dtype), tuple(leaf.shape)
    if isinstance(leaf, HostScalar):
        return leaf.dtype, ()
    arr = np.asarray(leaf)
    return str(arr.dtype), tuple(arr.shape)


def _u8(t: torch.Tensor) -> torch.Tensor:
    """A flat uint8 view of a tensor's bytes (contiguous first)."""
    t = t.detach()
    if not t.is_contiguous():
        t = t.contiguous()
    return t.reshape(-1).view(torch.uint8)


def _host_u8(leaf) -> np.ndarray:
    """The bytes of a host leaf as a flat uint8 numpy array."""
    if isinstance(leaf, HostScalar):
        leaf = leaf.value()
    if torch.is_tensor(leaf):
        return _u8(leaf).numpy()
    arr = np.ascontiguousarray(np.asarray(leaf))
    return arr.reshape(-1).view(np.uint8)


def _flatten_keyed(tree) -> List[Tuple[str, object]]:
    """``[(keypath, leaf)]`` in JAX's flatten order: a port train state
    through ``train_state_leaves``, a nested dict by its sorted keys, or
    a list of pairs as given.  Host numbers are read now, by value."""
    if isinstance(tree, (list, tuple)):
        pairs = list(tree)
    elif is_train_state(tree):
        pairs = train_state_leaves(tree)
    else:
        pairs = list(_dict_paths(tree))
    return [(k, v.value() if isinstance(v, HostScalar) else v)
            for k, v in pairs]


def _target_leaves(target) -> List[Tuple[str, object]]:
    if is_train_state(target):
        return train_state_leaves(target)
    return list(_dict_paths(target))


# -- the pinned bounce pipeline between the card and host memory ----------
class _Bounce:
    """Two pinned host buffers and a copy stream on one device."""

    def __init__(self, device: torch.device, nbytes: int):
        self.device = device
        self.nbytes = nbytes
        self.bufs = [
            torch.empty(nbytes, dtype=torch.uint8, pin_memory=True)
            for _ in range(2)
        ]
        if not all(b.is_pinned() for b in self.bufs):
            raise RuntimeError("pinned bounce buffers were not pinned")
        self.host = [b.numpy() for b in self.bufs]
        self.stream = torch.cuda.Stream(device)
        self.lock = threading.Lock()


_bounces: Dict[int, _Bounce] = {}
_bounces_lock = threading.Lock()


def _bounce(device: torch.device) -> _Bounce:
    index = (device.index if device.index is not None
             else torch.cuda.current_device())
    with _bounces_lock:
        b = _bounces.get(index)
        if b is None:
            b = _bounces[index] = _Bounce(torch.device("cuda", index),
                                          BOUNCE_BYTES)
        return b


def _batches(pieces, size: int):
    """Cut ``[(device u8 tensor, host u8 array)]`` into batches that each
    fill one bounce buffer: ``[(device slice, host slice, offset in the
    buffer)]``, a leaf split where it crosses a buffer's end.  Small
    leaves share a buffer, so they share its one synchronisation."""
    batch, used = [], 0
    for dev, host in pieces:
        n, off = dev.numel(), 0
        while off < n:
            m = min(size - used, n - off)
            batch.append((dev[off:off + m], host[off:off + m], used))
            used += m
            off += m
            if used == size:
                yield batch
                batch, used = [], 0
    if batch:
        yield batch


def _memcpy(dst: np.ndarray, src: np.ndarray):
    # every worker on one bounce buffer's worth (the pool's default
    # chunk would leave some idle)
    parallel_io.parallel_memcpy(dst, src, chunk=max(
        parallel_io.MIN_PARALLEL_BYTES,
        -(-src.nbytes // parallel_io.copy_workers())))


def device_to_host(pieces, ready: Optional[torch.cuda.Event] = None):
    """Copy each ``(device u8 tensor, host u8 array)`` pair device ->
    host through the bounce buffers.  The copy stream first waits for
    ``ready`` (else for the current stream): the work that wrote the
    sources.  Returns when every byte is in host memory."""
    if not pieces:
        return
    b = _bounce(pieces[0][0].device)
    with b.lock:
        if ready is not None:
            b.stream.wait_event(ready)
        else:
            b.stream.wait_stream(torch.cuda.current_stream(b.device))
        pending = None
        for i, batch in enumerate(_batches(pieces, b.nbytes)):
            j = i % 2
            with torch.cuda.stream(b.stream):
                for src, _dst, at in batch:
                    b.bufs[j][at:at + src.numel()].copy_(
                        src, non_blocking=True)
                ev = torch.cuda.Event()
                ev.record(b.stream)
            if pending is not None:
                _land(b, *pending)
            pending = (j, ev, batch)
        if pending is not None:
            _land(b, *pending)


def _land(b: _Bounce, j: int, ev, batch):
    ev.synchronize()
    for _src, dst, at in batch:
        _memcpy(dst, b.host[j][at:at + dst.nbytes])


def host_to_device(pieces):
    """Copy each ``(device u8 tensor, host u8 array)`` pair host ->
    device through the bounce buffers: the memcpy of batch k+1 into a
    pinned buffer overlaps batch k's transfer.  The copy stream first
    waits for the current stream (whatever last wrote the targets) and
    the current stream then waits for the copies; returns when they are
    done, so the host sources may be reused."""
    if not pieces:
        return
    b = _bounce(pieces[0][0].device)
    with b.lock:
        b.stream.wait_stream(torch.cuda.current_stream(b.device))
        events = [None, None]
        for i, batch in enumerate(_batches(pieces, b.nbytes)):
            j = i % 2
            if events[j] is not None:
                events[j].synchronize()
            for _dst, src, at in batch:
                _memcpy(b.host[j][at:at + src.nbytes], src)
            with torch.cuda.stream(b.stream):
                for dst, _src, at in batch:
                    dst.copy_(b.bufs[j][at:at + dst.numel()],
                              non_blocking=True)
                events[j] = torch.cuda.Event()
                events[j].record(b.stream)
        b.stream.synchronize()
        torch.cuda.current_stream(b.device).wait_stream(b.stream)


def _as_tensor(value) -> torch.Tensor:
    if torch.is_tensor(value):
        return value
    return torch.from_numpy(np.ascontiguousarray(np.asarray(value)))


def restore_to_target(target, arrays: Dict[str, torch.Tensor],
                      copy_host: bool = False):
    """Copy {keypath: CPU tensor} into ``target``: a port train state
    (its tensors are written in place, its Python counts set; the same
    object is returned) or a nested dict (tensors written in place, any
    other leaf replaced by the restored value, in a new dict).  CUDA
    targets are filled through the bounce buffers and the call returns
    once the bytes are on the card, so the source views (zero-copy shm)
    may be dropped.  ``copy_host=True`` copies values that stay on the
    host (required when ``arrays`` views live shm)."""
    leaves = _target_leaves(target)
    device_pieces = []
    replaced = {}
    for key, leaf in leaves:
        if key not in arrays:
            raise KeyError(f"checkpoint missing leaf {key}")
        value = _as_tensor(arrays[key])
        if isinstance(leaf, HostScalar):
            leaf.set(value.item())
            continue
        if not torch.is_tensor(leaf):
            replaced[key] = value.clone() if copy_host else value
            continue
        if tuple(value.shape) != tuple(leaf.shape):
            raise ValueError(
                f"leaf {key}: checkpoint shape {tuple(value.shape)} != "
                f"target {tuple(leaf.shape)}")
        if value.dtype != leaf.dtype:
            value = value.to(leaf.dtype)
        if leaf.device.type == "cuda":
            if not leaf.is_contiguous():
                raise ValueError(f"leaf {key}: target is not contiguous")
            device_pieces.append((_u8(leaf), _u8(value).numpy()))
        else:
            with torch.no_grad():
                leaf.copy_(value)
    host_to_device(device_pieces)
    if is_train_state(target):
        return target
    return _rebuild(target, replaced)


def _rebuild(node, replaced, prefix: str = ""):
    if isinstance(node, dict):
        return {k: _rebuild(v, replaced, f"{prefix}['{k}']")
                for k, v in node.items()}
    return replaced.get(prefix, node)


def _views(buf, base: int, specs) -> Dict[str, torch.Tensor]:
    """{keypath: CPU tensor} over ``buf`` (no copy)."""
    out = {}
    for key, dts, shape, off, nbytes in specs:
        dt = torch_dtype(dts)
        if nbytes == 0:
            out[key] = torch.empty(tuple(shape), dtype=dt)
            continue
        raw = torch.frombuffer(buf, dtype=torch.uint8, count=int(nbytes),
                               offset=base + int(off))
        out[key] = raw.view(dt).reshape(tuple(shape))
    return out


class SharedMemoryHandler:
    """One checkpoint shard in shared memory (one per training process).

    The training-process side writes (``save_state``); the agent-side
    saver reads (``dump_to_file``, ``load_state``).  Both sides
    synchronize through the companion ``SharedLock`` owned by the agent.
    """

    def __init__(self, rank: int, name: str = "default",
                 host: bool = False):
        # host=True on the agent side (creates the meta dict service)
        self._rank = rank
        self._name = name
        self._shm_name = f"{SHM_PREFIX}_{name}_{rank}"
        self._shm: Optional[SharedMemory] = None
        self._gen_name = f"{SHM_PREFIX}_gen_{name}_{rank}"
        self._gen: Optional[SharedMemory] = None
        self.meta = SharedDict(f"ckpt_meta_{name}_{rank}", create=host)

    # -- writer (training process) ----------------------------------------
    NUM_SLOTS = 2  # double-buffer: previous snapshot survives a crash
    _ALIGN = 4096

    def save_state(self, step: int, tree, layouts=None,
                   ready: Optional[torch.cuda.Event] = None) -> int:
        """Snapshot a train state (or keyed leaves) into shm; returns the
        bytes written.

        ``layouts`` ({keypath: LeafLayout dict},
        ``trainer/checkpoint/reshard.py``) rides the slot meta and every
        persisted header, making the shard readable by any world size.
        ``ready`` is an event recorded after the work that wrote the CUDA
        leaves (else the copy stream waits for the current stream).

        Double-buffered: consecutive saves alternate between two regions
        of the segment, and the top-level meta keeps pointing at the
        previous complete snapshot until the new one is fully written, so
        a crash mid-write never destroys the last restorable state."""
        pairs = _flatten_keyed(tree)
        specs = []
        offset = 0
        for key, leaf in pairs:
            dts, shape = _leaf_meta(leaf)
            nbytes = itemsize(dts) * int(np.prod(shape or (1,)))
            specs.append((key, dts, shape, offset, nbytes))
            offset += nbytes
        total = offset

        meta_all = self.meta.get_all()
        stride = int(meta_all.get("stride", 0))
        slots = dict(meta_all.get("slots", {}))
        last = int(meta_all.get("last_slot", self.NUM_SLOTS - 1))
        if total > stride:
            # the segment will be recreated zero-filled: every old
            # snapshot dies, so invalidate the meta before touching it
            stride = -(-total // self._ALIGN) * self._ALIGN
            slots = {}
            self.mark_invalid()
        slot = (last + 1) % self.NUM_SLOTS
        base = slot * stride

        # repoint the restorable snapshot at the OTHER slot (or mark
        # nothing restorable) before writing this one
        slots[str(slot)] = {"valid": False}
        other = slots.get(str((slot + 1) % self.NUM_SLOTS))
        header = {"slots": slots, "stride": stride, "last_slot": last}
        if other and other.get("valid"):
            repoint = dict(
                header,
                step=other["step"],
                specs=other["specs"],
                total_bytes=other["total_bytes"],
                base=other["base"],
                valid=True,
            )
            repoint["layouts"] = other.get("layouts")
            self.meta.update(repoint)
        else:
            self.meta.update(dict(header, valid=False))

        self._ensure_shm(self.NUM_SLOTS * stride)
        self._drain_leaves(pairs, specs, base, ready)

        # torn-publish chaos hook: the new slot is written, the meta
        # still points at the other valid slot
        maybe_crash("mid_weight_publish")

        slot_meta = {
            "step": step,
            "specs": specs,
            "total_bytes": total,
            "base": base,
            "valid": True,
            "layouts": dict(layouts) if layouts else None,
        }
        slots[str(slot)] = slot_meta
        self.meta.update(
            dict(slot_meta, slots=slots, stride=stride, last_slot=slot))
        return total

    def _drain_leaves(self, pairs, specs, base: int, ready=None):
        """Host leaves are ``parallel_memcpy``'d straight into the slot;
        CUDA leaves go through the bounce pipeline (``device_to_host``)."""
        buf = np.ndarray((self._shm.size,), dtype=np.uint8,
                         buffer=self._shm.buf)
        device = []
        for (_key, leaf), (_, _dts, _shape, off, nbytes) in zip(pairs, specs):
            if nbytes == 0:
                continue
            dst = buf[base + off:base + off + nbytes]
            if torch.is_tensor(leaf) and leaf.device.type == "cuda":
                device.append((_u8(leaf), dst))
            elif torch.is_tensor(leaf) and leaf.device.type != "cpu":
                raise ValueError(f"cannot snapshot a leaf on {leaf.device}")
            else:
                parallel_io.parallel_memcpy(dst, _host_u8(leaf))
        device_to_host(device, ready)

    def mark_invalid(self):
        self.meta.update({"valid": False, "slots": {}})

    # -- generation side-segment (weight publish, ROADMAP A5) -------------
    # One little-endian int64 in its own tiny segment: the last published
    # step + 1 (0 = nothing published), bumped only after save_state
    # returned, so a torn publish never advances it.

    def _attach_gen(self, create: bool = False) -> Optional[SharedMemory]:
        if self._gen is None:
            try:
                self._gen = SharedMemory(
                    self._gen_name, create=create, size=_GEN.size)
            except FileNotFoundError:
                return None
            except FileExistsError:
                self._gen = SharedMemory(self._gen_name, create=False)
        return self._gen

    def publish_generation(self, step: int):
        """Stamp ``step`` as the published generation (writer side;
        call after a successful ``save_state``)."""
        seg = self._attach_gen(create=True)
        _GEN.pack_into(seg.buf, 0, int(step) + 1)

    def peek_generation(self) -> int:
        """Last published generation, or -1 when none."""
        seg = self._attach_gen(create=False)
        if seg is None:
            return -1
        return int(_GEN.unpack_from(seg.buf, 0)[0]) - 1

    def steps_available(self):
        """Steps restorable from this segment, newest first."""
        meta = self.meta.get_all()
        steps = set()
        if meta.get("valid"):
            steps.add(int(meta.get("step", -1)))
        for slot_meta in meta.get("slots", {}).values():
            if slot_meta.get("valid"):
                steps.add(int(slot_meta.get("step", -1)))
        return sorted((s for s in steps if s >= 0), reverse=True)

    def _resolve_slot(self, meta: Dict, step: Optional[int]):
        """Slot meta holding ``step`` (None = newest valid) or None."""
        if step is None or (meta.get("valid") and meta.get("step") == step):
            return meta if meta.get("valid") else None
        for slot_meta in meta.get("slots", {}).values():
            if slot_meta.get("valid") and slot_meta.get("step") == step:
                return slot_meta
        return None

    def preallocate(self, nbytes: int) -> float:
        """Create the segment and fault in its pages ahead of the first
        snapshot (tmpfs allocates lazily, and first-touch faulting runs
        at a fraction of the memcpy rate).  Returns the seconds taken,
        0.0 when a valid snapshot already lives in the segment (a
        relaunched process: zeroing it would destroy the restorable
        state)."""
        if self.get_step() >= 0 and self.attach(min_size=nbytes):
            logger.info(
                "rank %s: shm already holds a valid step-%s snapshot; "
                "skipping preallocation", self._rank, self.get_step())
            return 0.0
        start = _time.time()
        self.mark_invalid()
        stride = -(-nbytes // self._ALIGN) * self._ALIGN
        self.meta.update({"stride": stride})
        self._ensure_shm(self.NUM_SLOTS * stride)
        view = np.ndarray((self._shm.size,), dtype=np.uint8,
                          buffer=self._shm.buf)
        parallel_io.parallel_fill(view, 0)
        dur = _time.time() - start
        logger.info(
            "rank %s: preallocated %.1f MB shm in %.2fs (%.2f GB/s, "
            "workers=%s)", self._rank, self._shm.size / 1e6, dur,
            parallel_io.throughput_gbps(self._shm.size, dur),
            parallel_io.copy_workers())
        return dur

    def _ensure_shm(self, size: int):
        if self._shm is None or self._shm.size < size:
            if self._shm is not None:
                self._shm.close()
            # attaches an adequately-sized existing segment (a relaunched
            # process's predecessor may hold the only snapshot); recreates
            # it only on growth
            self._shm = SharedMemory(
                self._shm_name, create=True, size=max(size, 1))

    @property
    def segment_size(self) -> int:
        return self._shm.size if self._shm is not None else 0

    # -- reader (agent or restarted training process) ----------------------
    def attach(self, min_size: int = 0) -> bool:
        """Attach to the segment; re-attach when the writer grew and
        recreated it (a stale mapping would silently truncate reads)."""
        if self._shm is not None and self._shm.size < min_size:
            self._shm.close()
            self._shm = None
        if self._shm is not None:
            return True
        try:
            self._shm = SharedMemory(self._shm_name)
        except FileNotFoundError:
            return False
        if min_size and self._shm.size < min_size:
            self._shm.close()
            self._shm = None
            return False
        # a fresh attach (restarted process) faults every page on first
        # touch; WILLNEED asks the kernel to populate ahead of the
        # restore's pass (the reference names the wrapper's mapping,
        # which it does not have, so its advice is never given)
        try:
            import mmap as _mmap

            self._shm._shm._mmap.madvise(_mmap.MADV_WILLNEED)
        except (AttributeError, OSError, ValueError):
            pass  # private CPython detail; purely advisory
        return True

    def get_step(self) -> int:
        meta = self.meta.get_all()
        if not meta.get("valid"):
            return -1
        return meta.get("step", -1)

    def slot_layouts(self, step: Optional[int] = None):
        slot = self._resolve_slot(self.meta.get_all(), step)
        if slot is None:
            return None
        return slot.get("layouts") or None

    def slot_shapes(self, step: Optional[int] = None):
        """{keypath: local shape} of the slot holding ``step``, from the
        meta alone."""
        slot = self._resolve_slot(self.meta.get_all(), step)
        if slot is None:
            return None
        return {key: tuple(int(d) for d in shape)
                for key, _dt, shape, _off, _nb in slot["specs"]}

    def load_state(self, copy: bool = True, step: Optional[int] = None
                   ) -> Tuple[int, Dict[str, torch.Tensor]]:
        """{keypath: CPU tensor} of the slot holding ``step`` (None =
        newest).  ``copy=False`` gives views of the segment (the restore
        path: copy them onward, and drop them before the slot is reused
        two snapshots later); ``copy=True`` one private copy."""
        meta = self.meta.get_all()
        slot = self._resolve_slot(meta, step)
        if slot is None:
            return -1, {}
        base = int(slot.get("base", 0))
        total = slot.get("total_bytes", 0)
        if not self.attach(min_size=base + total):
            return -1, {}
        buf = self._shm.buf
        if copy:
            private = np.empty(total, dtype=np.uint8)
            parallel_io.parallel_memcpy(
                private,
                np.ndarray((total,), dtype=np.uint8, buffer=buf,
                           offset=base))
            buf, base = private, 0
        return slot.get("step", -1), _views(buf, base, slot["specs"])

    def dump_to_file(self, path: str, storage, step: Optional[int] = None
                     ) -> Optional[int]:
        """Persist header + raw shm bytes of a slot to ``path`` (agent
        side).  Returns the raw bytes written, or None on failure."""
        meta = self.meta.get_all()
        slot = self._resolve_slot(meta, step)
        if slot is None:
            logger.warning("no valid shm checkpoint for rank %s (step=%s)",
                           self._rank, step)
            return None
        base = int(slot.get("base", 0))
        total = slot["total_bytes"]
        if not self.attach(min_size=base + total):
            logger.warning("shm segment missing for rank %s", self._rank)
            return None
        file_meta = {"step": slot["step"], "specs": slot["specs"]}
        if slot.get("layouts"):
            file_meta["layouts"] = slot["layouts"]
        header = pickle.dumps(file_meta)
        view = memoryview(self._shm.buf)[base:base + total]
        try:
            def _chunks():
                yield _HDR.pack(len(header))
                yield header
                for off, n in parallel_io.chunked_iter(total):
                    yield view[off:off + n]

            storage.write_chunks(_chunks(), path)
        finally:
            view.release()
        return int(total)

    def unlink_name(self):
        """Remove the segment's /dev/shm name without closing the mapping
        (the memory dies with the last mapping)."""
        _unlink(self._shm, self._shm_name)

    def close(self, unlink: bool = False):
        """Close the mappings; ``unlink=True`` also removes both names,
        whether or not this side ever mapped them (the writer may have
        been another handler)."""
        if unlink:
            _unlink(self._shm, self._shm_name)
            _unlink(self._gen, self._gen_name)
        for shm in (self._shm, self._gen):
            if shm is not None:
                shm.close()
        self._shm = self._gen = None
        self.meta.close()


def _unlink(shm: Optional[SharedMemory], name: str):
    try:
        if shm is not None:
            shm.unlink()
        else:
            shm = SharedMemory(name)
            shm.unlink()
            shm.close()
    except FileNotFoundError:
        pass
    except Exception as e:  # noqa: BLE001
        logger.warning("unlink of %s failed: %s", name, e)


class TruncatedShardError(ValueError):
    """The shard file ended before the raw section was complete."""


def stream_shard_leaves(path: str, storage=None):
    """Generator over a persisted ``*.drckpt`` shard, leaf by leaf.

    Yields ``("meta", step, specs, layouts)`` first, then ``("leaf", key,
    CPU tensor)`` for each leaf the moment its bytes land, in offset
    order.  All leaves view ONE private buffer of the shard's size.
    Raises :class:`TruncatedShardError` on a short file."""
    f = storage.open_read(path) if storage is not None else open(path, "rb")
    with f:
        hdr = f.read(_HDR.size)
        if not hdr or len(hdr) < _HDR.size:
            raise TruncatedShardError(f"no header in {path}")
        (hdr_len,) = _HDR.unpack(hdr)
        meta = pickle.loads(f.read(hdr_len))
        specs = meta["specs"]
        total = max((int(off) + int(nbytes)
                     for _k, _d, _s, off, nbytes in specs), default=0)
        yield "meta", meta.get("step", -1), specs, meta.get("layouts")
        raw = np.empty(total, dtype=np.uint8)
        mv = memoryview(raw)
        filled = 0
        chunk = parallel_io.chunk_nbytes()

        def _fill_to(limit: int):
            nonlocal filled
            while filled < limit:
                want = min(chunk, limit - filled)
                if hasattr(f, "readinto"):
                    got = f.readinto(mv[filled:filled + want])
                else:
                    data = f.read(want)
                    got = len(data)
                    if got:
                        mv[filled:filled + got] = data
                if not got:
                    raise TruncatedShardError(
                        f"truncated shard file {path} "
                        f"({filled} of {total} raw bytes)")
                filled += got

        for spec in sorted(specs, key=lambda s: int(s[3])):
            _fill_to(int(spec[3]) + int(spec[4]))
            yield "leaf", spec[0], _views(raw, 0, [spec])[spec[0]]


def read_shard_file(path: str, storage=None
                    ) -> Tuple[int, Dict[str, torch.Tensor]]:
    """Load a persisted ``*.drckpt`` shard: (step, {keypath: CPU tensor})
    viewing one private buffer; (-1, {}) on a truncated file, or on a
    missing one when read through ``storage``."""
    try:
        step, arrays = -1, {}
        for item in stream_shard_leaves(path, storage):
            if item[0] == "meta":
                step = item[1]
            else:
                arrays[item[1]] = item[2]
        return step, arrays
    except TruncatedShardError as e:
        logger.warning("%s", e)
        return -1, {}
    except (FileNotFoundError, IsADirectoryError):
        if storage is not None:
            return -1, {}
        raise


def shard_lock(rank: int, name: str = "default",
               create: bool = False) -> SharedLock:
    return SharedLock(f"ckpt_{name}_{rank}", create=create)
