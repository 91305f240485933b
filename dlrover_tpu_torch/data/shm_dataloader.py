"""Cross-process shared-memory batch channel.

Copy of ``dlrover_tpu/data/shm_dataloader.py``.

Reference parity: ``atorch/atorch/data/shm_dataloader.py:138`` +
``shm_context.py`` — a producer process (data worker) materializes
batches into a shared-memory ring; consumer (training proc) reads
without pickling tensors through a pipe.  On TPU hosts this feeds the
single training process from CPU-side preprocessing workers without
the GIL or copy chains.

Design: a fixed-slot ring over one ``SharedMemory`` segment.  The
batch schema (shapes/dtypes) is declared up front so slot size is
static (XLA-friendly static shapes end to end).

Data plane (this is the input-side sibling of the flash-checkpoint
rewire in ``common/parallel_io.py``):

- **Zero-copy slots.**  Writer and reader address each slot's fields
  through cached ``np.ndarray`` views directly over the shm buffer;
  large fields move with ``parallel_memcpy`` (chunked, GIL-releasing).
  The legacy ``tobytes()``/``bytes()+frombuffer`` round trips — four
  full serial copies per batch — survive only behind
  ``zero_copy=False`` (benchmark reference + escape hatch).
- **RPC-free steady state.**  Per-slot full/free/writing states live
  in an atomic header region at the front of the segment itself
  (aligned ``uint64`` stores), so ``put`` and ``next_batch`` never
  touch the ``SharedDict``.  The dict is retained only for the
  spec/num_slots/closed *handshake* at attach/close time.  Ordering:
  x86-TSO already guarantees the payload stores become visible before
  the ``FULL`` publication store; for weakly-ordered ISAs the
  producer issues an explicit full barrier (:func:`_memory_fence`, a
  pthread-mutex round trip) between the payload write and the state
  flip, and the consumer issues one between observing ``FULL`` and
  reading the payload — a release/acquire pair.
- **Distinct end-of-stream vs timeout.**  A clean producer ``close``
  yields ``None`` / ends iteration; a slot that never fills raises
  :class:`ShmSlotTimeout` — a slow producer can no longer silently
  truncate an epoch.
"""

import pickle
import threading
import time
from typing import Dict, Iterator, List, Optional, Tuple

import numpy as np

from dlrover_tpu_torch.common.log import default_logger as logger
from dlrover_tpu_torch.common.multi_process import SharedDict, SharedMemory
from dlrover_tpu_torch.common.parallel_io import (
    input_copy_workers,
    parallel_memcpy,
)

# header slot states (uint64 stores are single aligned movs — atomic
# on every platform CPython runs on)
SLOT_FREE = 0
SLOT_WRITING = 1
SLOT_FULL = 2

#: header word 0: 0 = open, 1 = producer closed cleanly
_HDR_CLOSED = 0
#: payload begins at the next 64-byte boundary after the header words
_HDR_ALIGN = 64


_fence_lock = threading.Lock()


def _memory_fence():
    """Full memory barrier via a pthread-mutex round trip.

    NumPy stores carry no ordering guarantees of their own; on
    weakly-ordered ISAs (ARM) the producer's ``FULL`` flip could
    otherwise become visible before the payload bytes.  A mutex
    acquire/release is a full fence on every platform CPython runs
    on, and at one round trip per *batch* (not per chunk) the cost is
    noise.  On x86-TSO this is belt-and-braces.
    """
    with _fence_lock:
        pass


class ShmSlotTimeout(TimeoutError):
    """A ring slot did not change state within the timeout.

    Raised instead of returning ``None`` so a merely-slow (or crashed
    mid-slot) producer is never mistaken for a clean end of stream.
    """


class BatchSpec:
    """Static schema: {name: (shape, dtype)} per batch element."""

    def __init__(self, fields: Dict[str, Tuple[tuple, str]]):
        self.fields = {
            name: (tuple(shape), np.dtype(dtype))
            for name, (shape, dtype) in fields.items()
        }
        self.slot_bytes = sum(
            int(np.prod(shape)) * dtype.itemsize
            for shape, dtype in self.fields.values()
        )

    def serialize(self) -> bytes:
        return pickle.dumps(
            {
                name: (shape, dtype.str)
                for name, (shape, dtype) in self.fields.items()
            }
        )

    @classmethod
    def deserialize(cls, raw: bytes) -> "BatchSpec":
        return cls(pickle.loads(raw))


def _attach_ring(name: str, timeout: float = 60.0) -> "_ShmRing":
    """Writer-side attach: block until the consumer's ring exists.

    Exponential backoff 0.1 -> 2 s (the ``wait_for_persist`` pattern)
    instead of a fixed 200 ms poll: attach storms from a large worker
    pool stay cheap, and the common fast path still reacts in 100 ms.
    """
    deadline = time.monotonic() + timeout
    poll = 0.1
    while True:
        try:
            meta = SharedDict(f"shm_ring_meta_{name}", create=False)
            raw = meta.get("spec")
            num_slots = meta.get("num_slots")
            meta.close()
            if raw and num_slots:
                spec = BatchSpec.deserialize(raw)
                return _ShmRing(
                    name, spec, int(num_slots), create=False
                )
        except (FileNotFoundError, TimeoutError, ConnectionError):
            pass
        if time.monotonic() > deadline:
            raise TimeoutError(f"shm ring {name!r} never appeared")
        time.sleep(poll)
        poll = min(poll * 2, 2.0)


class _ShmRing:
    def __init__(self, name: str, spec: BatchSpec, num_slots: int,
                 create: bool):
        self.spec = spec
        self.num_slots = num_slots
        # header: [closed, state_0 .. state_{n-1}] as aligned uint64
        hdr_words = 1 + num_slots
        self.payload_off = (
            (hdr_words * 8 + _HDR_ALIGN - 1) // _HDR_ALIGN * _HDR_ALIGN
        )
        total = self.payload_off + spec.slot_bytes * num_slots
        self.shm = SharedMemory(
            name=f"shm_ring_{name}", create=create, size=total
        )
        self._hdr = np.frombuffer(
            self.shm.buf, dtype=np.uint64, count=hdr_words
        )
        self.meta = SharedDict(f"shm_ring_meta_{name}", create=create)
        if create:
            self._hdr[:] = 0
            # the dict carries only the attach/close HANDSHAKE; slot
            # states live in the header so the steady path is RPC-free
            self.meta.update(
                {
                    "spec": spec.serialize(),
                    "num_slots": num_slots,
                    "closed": False,
                }
            )
        # per-slot, per-field zero-copy views over the segment
        self._views: List[Dict[str, np.ndarray]] = []
        for slot in range(num_slots):
            views = {}
            for name_, shape, dtype, off, _ in self._offsets():
                views[name_] = np.frombuffer(
                    self.shm.buf,
                    dtype=dtype,
                    count=int(np.prod(shape)) or 1,
                    offset=self.payload_off
                    + slot * spec.slot_bytes
                    + off,
                ).reshape(shape)
            self._views.append(views)

    def _offsets(self):
        off = 0
        for name, (shape, dtype) in self.spec.fields.items():
            nbytes = int(np.prod(shape)) * dtype.itemsize
            yield name, shape, dtype, off, nbytes
            off += nbytes

    # ------------------------------------------------------ header ops
    def slot_state(self, slot: int) -> int:
        return int(self._hdr[1 + slot])

    def set_slot_state(self, slot: int, state: int):
        self._hdr[1 + slot] = state

    def closed(self) -> bool:
        return bool(self._hdr[_HDR_CLOSED])

    def mark_closed(self):
        self._hdr[_HDR_CLOSED] = 1

    # ------------------------------------------------------- payload
    def slot_views(self, slot: int) -> Dict[str, np.ndarray]:
        """The slot's fields as zero-copy views over the segment."""
        return self._views[slot]

    def write_slot(self, slot: int, batch: Dict[str, np.ndarray],
                   zero_copy: bool = True):
        views = self._views[slot]
        for name, shape, dtype, off, nbytes in self._offsets():
            arr = np.ascontiguousarray(batch[name], dtype=dtype)
            if arr.shape != shape:
                raise ValueError(
                    f"batch field {name}: {arr.shape} != spec {shape}"
                )
            if zero_copy:
                # one chunked GIL-releasing copy straight into the
                # segment (parallel for large fields)
                parallel_memcpy(
                    views[name], arr, workers=input_copy_workers()
                )
            else:
                # legacy reference path: tobytes materializes a full
                # intermediate copy, then the buffer assignment copies
                # again
                base = self.payload_off + slot * self.spec.slot_bytes
                self.shm.buf[base + off : base + off + nbytes] = (
                    arr.tobytes()
                )

    def read_slot(self, slot: int, copy: bool = True,
                  zero_copy: bool = True) -> Dict[str, np.ndarray]:
        if not copy:
            return self._views[slot]
        out = {}
        for name, shape, dtype, off, nbytes in self._offsets():
            if zero_copy:
                dst = np.empty(shape, dtype=dtype)
                parallel_memcpy(
                    dst,
                    self._views[slot][name],
                    workers=input_copy_workers(),
                )
                out[name] = dst
            else:
                base = self.payload_off + slot * self.spec.slot_bytes
                raw = bytes(
                    self.shm.buf[base + off : base + off + nbytes]
                )
                out[name] = np.frombuffer(raw, dtype=dtype).reshape(
                    shape
                )
        return out

    def close(self, unlink: bool = False):
        # drop the views before closing: a live export keeps the mmap
        # pinned (BufferError); a consumer still holding copy=False
        # views is its own problem — warn, don't crash
        self._views = []
        self._hdr = None
        try:
            self.shm.close()
        except BufferError:
            logger.warning(
                "shm ring close deferred: batch views still alive"
            )
        if unlink:
            try:
                self.shm.unlink()
            except FileNotFoundError:
                pass
        self.meta.close()


def _backoff_sleep(delay: float, cap: float = 0.005) -> float:
    """One poll sleep; returns the next (exponentially grown) delay.
    Same pattern as ``wait_for_persist``'s 0.1 -> 2 s, scaled to input
    latencies: 0.2 ms first response so a just-freed slot is picked up
    almost immediately, 5 ms cap — an oversleep at the cap costs under
    a tenth of a large-batch copy, while an idle poll at 5 ms is
    negligible CPU.  (The header poll is a plain shm load; the old
    code paid a SharedDict RPC per 2 ms poll.)"""
    time.sleep(delay)
    return min(delay * 2, cap)


class ShmBatchWriter:
    """Producer side (data-worker process).  The CONSUMER owns the
    ring and its meta service (the training process outlives data
    workers); the writer attaches — pass ``create=True`` only for
    producer-owned standalone rings.  One writer per ring: slots are
    claimed round-robin without cross-producer arbitration."""

    def __init__(self, name: str, spec: Optional[BatchSpec] = None,
                 num_slots: int = 4, create: bool = False,
                 zero_copy: bool = True):
        if create:
            if spec is None:
                raise ValueError("create=True requires a spec")
            self._ring = _ShmRing(name, spec, num_slots, create=True)
        else:
            self._ring = _attach_ring(name)
        self._zero_copy = zero_copy
        self._next = 0

    def put(self, batch: Dict[str, np.ndarray],
            timeout: float = 300.0) -> bool:
        """Write one batch; blocks while the ring is full.  Steady
        state touches only the shm header — zero SharedDict RPCs."""
        slot = self._next
        deadline = time.monotonic() + timeout
        delay = 0.0002
        while self._ring.slot_state(slot) != SLOT_FREE:
            if time.monotonic() > deadline:
                return False
            delay = _backoff_sleep(delay)
        # WRITING marks the slot torn until the payload is complete:
        # a consumer never sees a half-written batch, and a producer
        # crash mid-slot leaves WRITING behind (consumer times out
        # loudly instead of reading garbage)
        self._ring.set_slot_state(slot, SLOT_WRITING)
        self._ring.write_slot(slot, batch, zero_copy=self._zero_copy)
        _memory_fence()  # payload visible before the FULL publication
        self._ring.set_slot_state(slot, SLOT_FULL)
        self._next = (slot + 1) % self._ring.num_slots
        return True

    def close(self):
        self._ring.mark_closed()  # consumer's RPC-free fast check
        try:
            self._ring.meta.set("closed", True)  # handshake parity
        except (ConnectionError, OSError, TimeoutError):
            pass  # consumer already gone; the header flag is durable
        self._ring.close()


class ShmDataLoader:
    """Consumer side (training process) — iterate numpy batches.

    ``next_batch(copy=True)`` hands back private arrays (one chunked
    parallel copy out of the slot).  ``copy=False`` returns zero-copy
    views over the slot itself; the slot is recycled on the following
    ``next_batch``/``release_slot`` call, so at most one batch of
    views is live at a time.
    """

    def __init__(self, name: str, spec: BatchSpec,
                 num_slots: int = 4, timeout: float = 300.0,
                 zero_copy: bool = True):
        # the consumer CREATES the ring: it owns the meta service and
        # outlives producer processes
        self._ring = _ShmRing(name, spec, num_slots, create=True)
        self._next = 0
        self._timeout = timeout
        self._zero_copy = zero_copy
        self._held_slot: Optional[int] = None

    def __iter__(self) -> Iterator[Dict[str, np.ndarray]]:
        while True:
            batch = self.next_batch()
            if batch is None:
                return
            yield batch

    def release_slot(self):
        """Recycle the slot behind the last ``copy=False`` batch; its
        views must no longer be used."""
        if self._held_slot is not None:
            self._ring.set_slot_state(self._held_slot, SLOT_FREE)
            self._held_slot = None

    def next_batch(
        self, copy: bool = True
    ) -> Optional[Dict[str, np.ndarray]]:
        """The next batch, or ``None`` after a clean producer close.

        Raises :class:`ShmSlotTimeout` when the slot stays unfilled
        past the loader timeout — a slow or crashed-mid-slot producer
        must surface as an error, not truncate the epoch the way a
        silent ``None`` would.
        """
        self.release_slot()
        slot = self._next
        deadline = time.monotonic() + self._timeout
        delay = 0.0002
        while self._ring.slot_state(slot) != SLOT_FULL:
            # producer publishes FULL before closed (program order +
            # total store order), so closed with a non-FULL slot means
            # the stream genuinely ended
            if self._ring.closed():
                if self._ring.slot_state(slot) == SLOT_FULL:
                    break
                return None
            if time.monotonic() > deadline:
                logger.warning(
                    "shm dataloader timed out on slot %d "
                    "(producer slow or crashed mid-batch)", slot
                )
                raise ShmSlotTimeout(
                    f"slot {slot} not filled within "
                    f"{self._timeout}s and producer has not closed"
                )
            delay = _backoff_sleep(delay)
        _memory_fence()  # acquire: FULL observed before payload reads
        batch = self._ring.read_slot(
            slot, copy=copy, zero_copy=self._zero_copy
        )
        if copy:
            self._ring.set_slot_state(slot, SLOT_FREE)
        else:
            self._held_slot = slot
        self._next = (slot + 1) % self._ring.num_slots
        return batch

    def close(self):
        self.release_slot()
        self._ring.close(unlink=True)
