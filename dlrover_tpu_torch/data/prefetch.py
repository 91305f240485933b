"""Device prefetch: overlap host batch prep with device compute.

Port of ``dlrover_tpu/data/prefetch.py``.  ``batch_nbytes``,
``_ThroughputMeter`` and ``host_prefetch`` are copies.
``device_prefetch`` is the GPU data preloader the reference's docstring
names (``atorch/atorch/data/preloader.py``) in place of
``jax.device_put``: each batch is cut to the rank's rows
(``sharding.local``, ``BATCH -> (data, fsdp)``) on the host, put in
pinned host memory, and copied to the card with ``copy_(...,
non_blocking=True)`` on a dedicated copy stream; an event recorded
after the copy is what the compute stream waits on when the batch is
handed out.  ``size`` transfers are in flight.  The pinned buffers of a
batch are kept until the batch after it is handed out, by which time
the step that read it is queued behind the copy's event; its card
tensors are recorded on the compute stream, so the allocator does not
reuse them before that step has run.

Two pipeline stages, separately attributable on the job timeline:

- ``host_fetch`` — producing the next host batch (``next(iterator)``;
  with ``pipelined=True`` a bounded background-thread producer runs it
  concurrently, so the fetch of batch k+1 overlaps the copy of batch k
  and the compute of batch k−1);
- ``h2d`` — staging the host batch onto the card: the rows cut, the
  copy into pinned memory and the copy's launch, on the host's clock.

Batch order is the serial iteration order.  An iterator's exception is
raised where the serial loop would have met it: after the batches
staged before it have been handed out (the reference drops them).

A stage slower than ``stall_threshold_s`` emits a ``data_stall`` span
tagged ``stage=host_fetch`` / ``stage=h2d``.  The measured host-fetch
bandwidth is exported as the ``dlrover_tpu_input_gbps{stage=
"host_fetch"}`` gauge.

On the CPU (``device="cpu"``, or a sharding on the CPU) it is the same
iterator without streams or pinned memory: the rows as tensors.
"""

import collections
import queue
import threading
import time
from typing import Iterable, Iterator, List, Optional

import torch

from dlrover_tpu_torch.common.device import DeviceLike, resolve_device
from dlrover_tpu_torch.observability.events import (
    anchored_now,
    get_event_logger,
)
from dlrover_tpu_torch.observability.metrics import record_input_io

#: gauge refresh window: batch rates are noisy, export ~1/s
_METER_WINDOW_S = 1.0
#: batches whose copy ``DevicePrefetch.h2d`` keeps
_H2D_KEEP = 1024


def batch_nbytes(batch) -> int:
    """Total array bytes in a (possibly nested) batch structure; 0 for
    leaves without ``nbytes`` (lists of strings, scalars, ...)."""
    if hasattr(batch, "nbytes"):
        return int(batch.nbytes)
    if isinstance(batch, dict):
        return sum(batch_nbytes(v) for v in batch.values())
    if isinstance(batch, (list, tuple)):
        return sum(batch_nbytes(v) for v in batch)
    return 0


class _ThroughputMeter:
    """Windowed bytes/s accumulator feeding the input-gbps gauge."""

    def __init__(self, stage: str):
        self._stage = stage
        self._bytes = 0
        self._seconds = 0.0
        self._last_export = time.monotonic()

    def observe(self, nbytes: int, seconds: float):
        self._bytes += nbytes
        self._seconds += seconds
        now = time.monotonic()
        if (
            now - self._last_export >= _METER_WINDOW_S
            and self._bytes > 0
            and self._seconds > 0.0
        ):
            record_input_io(self._stage, self._bytes, self._seconds)
            self._bytes = 0
            self._seconds = 0.0
            self._last_export = now


class _EndOfStream:
    """Queue sentinel: clean iterator end, or carries the exception."""

    def __init__(self, error: Optional[BaseException] = None):
        self.error = error


def host_prefetch(
    iterator: Iterable,
    size: int = 2,
    stall_threshold_s: float = 0.05,
) -> Iterator:
    """Yield host batches produced by a bounded background thread.

    The producer thread runs ``next(iterator)`` up to ``size`` batches
    ahead; the consumer blocks only when the producer cannot keep up —
    that wait is the true pipeline stall and is emitted as a
    ``data_stall`` span tagged ``stage=host_fetch``.  Batch order is
    exactly the serial iteration order; an iterator exception is
    re-raised at the consuming call site.
    """
    events = get_event_logger()
    meter = _ThroughputMeter("host_fetch")
    q: "queue.Queue" = queue.Queue(maxsize=max(1, size))
    stop = threading.Event()

    def _put_until_stopped(item):
        """Blocking put that still notices consumer shutdown — the
        END/ERROR sentinels MUST land (a dropped error sentinel would
        leave the consumer blocked on q.get() forever)."""
        while not stop.is_set():
            try:
                q.put(item, timeout=0.5)
                return
            except queue.Full:
                continue

    def _produce():
        it = iter(iterator)
        try:
            while not stop.is_set():
                t0 = time.monotonic()
                try:
                    batch = next(it)
                except StopIteration:
                    _put_until_stopped(_EndOfStream())
                    return
                # the gauge measures the PRODUCTION bandwidth (the
                # fetch itself), not the backpressure wait below
                meter.observe(
                    batch_nbytes(batch), time.monotonic() - t0
                )
                _put_until_stopped(batch)
        except BaseException as e:  # noqa: BLE001 - re-raised consumer-side
            _put_until_stopped(_EndOfStream(e))

    thread = threading.Thread(
        target=_produce, name="input-host-prefetch", daemon=True
    )
    thread.start()
    try:
        while True:
            t0_mono = time.monotonic()
            t0_wall = anchored_now(t0_mono)
            item = q.get()
            wait = time.monotonic() - t0_mono
            if isinstance(item, _EndOfStream):
                if item.error is not None:
                    raise item.error
                return
            if events.enabled and wait >= stall_threshold_s:
                events.complete(
                    "data_stall", t0_wall, wait, stage="host_fetch"
                )
            yield item
    finally:
        stop.set()


def _map(fn, batch):
    if isinstance(batch, dict):
        return {k: _map(fn, v) for k, v in batch.items()}
    if isinstance(batch, (list, tuple)):
        return type(batch)(_map(fn, v) for v in batch)
    return fn(batch)


def _leaves(batch) -> List[torch.Tensor]:
    if isinstance(batch, dict):
        return [t for v in batch.values() for t in _leaves(v)]
    if isinstance(batch, (list, tuple)):
        return [t for v in batch for t in _leaves(v)]
    return [batch]


class _InFlight:
    """One batch on its way: the card tensors, the pinned sources they
    are copied from, and the copy's events."""

    __slots__ = ("batch", "pinned", "start", "done", "nbytes", "host_s")

    def __init__(self, batch, pinned, start, done, nbytes, host_s):
        self.batch, self.pinned = batch, pinned
        self.start, self.done = start, done
        self.nbytes, self.host_s = nbytes, host_s


class DevicePrefetch:
    """The iterator ``device_prefetch`` returns.  ``h2d`` keeps, per
    batch handed out (the last ``_H2D_KEEP`` of them), its bytes, the host
    seconds of its staging, and on the card the copy's start and end
    events: ``h2d_times()`` reads them as milliseconds."""

    def __init__(self, iterator, size, device, sharding,
                 stall_threshold_s, pipelined):
        self._size = max(1, size)
        self._device = device
        self._sharding = sharding
        self._threshold = stall_threshold_s
        self._events = get_event_logger()
        self.h2d = collections.deque(maxlen=_H2D_KEEP)
        self._stream = None
        if device.type == "cuda":
            self._stream = torch.cuda.Stream(device=device)
        if pipelined:
            # host_prefetch already accounts the host_fetch stalls (the
            # queue wait); fetching from it again through _fetch would
            # double-book the same wall clock
            self._it = iter(host_prefetch(
                iterator, size=self._size,
                stall_threshold_s=stall_threshold_s))
            self._fetch = next
        else:
            self._it = iter(iterator)
            self._fetch = self._timed_fetch
        self._q = collections.deque()
        self._held = None  # the batch last handed out
        self._gen = self._run()

    def __iter__(self):
        return self

    def __next__(self):
        return next(self._gen)

    def close(self):
        self._gen.close()

    def _timed_fetch(self, it):
        """next(it) with stall accounting; raises StopIteration."""
        if not self._events.enabled:
            return next(it)
        t0_mono = time.monotonic()
        t0_wall = anchored_now(t0_mono)
        batch = next(it)
        dur = time.monotonic() - t0_mono
        if dur >= self._threshold:
            self._events.complete(
                "data_stall", t0_wall, dur, stage="host_fetch")
        return batch

    def _put(self, batch) -> _InFlight:
        t0_mono = time.monotonic()
        t0_wall = anchored_now(t0_mono)
        if self._sharding is not None:
            batch = self._sharding.local(batch)
        host = _map(torch.as_tensor, batch)
        nbytes = sum(int(t.nbytes) for t in _leaves(host))
        if self._stream is None:
            out = _InFlight(host, None, None, None, nbytes, 0.0)
        else:
            pinned = _map(lambda t: t.pin_memory(), host)
            start = torch.cuda.Event(enable_timing=True)
            done = torch.cuda.Event(enable_timing=True)
            with torch.cuda.stream(self._stream):
                start.record(self._stream)
                dev = _map(lambda t: torch.empty_like(
                    t, device=self._device), pinned)
                for d, p in zip(_leaves(dev), _leaves(pinned)):
                    d.copy_(p, non_blocking=True)
                done.record(self._stream)
            out = _InFlight(dev, pinned, start, done, nbytes, 0.0)
        dur = time.monotonic() - t0_mono
        out.host_s = dur
        if self._events.enabled and dur >= self._threshold:
            self._events.complete("data_stall", t0_wall, dur, stage="h2d")
        return out

    def _hand_out(self, item: _InFlight):
        if item.done is not None:
            compute = torch.cuda.current_stream(self._device)
            compute.wait_event(item.done)
            for t in _leaves(item.batch):
                t.record_stream(compute)
        self.h2d.append((item.nbytes, item.host_s, item.start, item.done))
        # the previous batch's pinned buffers go now: its step is queued
        # behind its copy's event
        self._held = item
        return item.batch

    def _run(self):
        error = None
        ended = False

        def stage():
            """Fetch and stage the next batch; False once the iterator
            ended or failed (its error is raised after the batches
            already staged have been handed out, as a serial loop would
            have consumed them)."""
            nonlocal error, ended
            if ended:
                return False
            try:
                self._q.append(self._put(self._fetch(self._it)))
                return True
            except StopIteration:
                pass
            except Exception as e:  # noqa: BLE001 - raised after the queue
                error = e
            ended = True
            return False

        try:
            for _ in range(self._size):
                if not stage():
                    break
            while self._q:
                item = self._q.popleft()
                stage()
                yield self._hand_out(item)
            if error is not None:
                raise error
        finally:
            # batches never handed out: their copies must end before
            # their buffers go back to the allocators
            if self._stream is not None:
                self._stream.synchronize()
            self._q.clear()
            self._held = None
            close = getattr(self._it, "close", None)
            if close is not None:
                close()

    def h2d_times(self) -> List[dict]:
        """``{"bytes", "host_ms", "copy_ms"}`` per batch in ``h2d``
        (``copy_ms`` on the card's clock; None on the CPU).  Waits for
        the copies."""
        out = []
        for nbytes, host_s, start, done in self.h2d:
            ms = None
            if done is not None:
                done.synchronize()
                ms = start.elapsed_time(done)
            out.append({"bytes": nbytes, "host_ms": host_s * 1e3,
                        "copy_ms": ms})
        return out


def device_prefetch(
    iterator: Iterable,
    size: int = 2,
    sharding: Optional[object] = None,
    stall_threshold_s: float = 0.05,
    pipelined: bool = False,
    device: DeviceLike = None,
) -> DevicePrefetch:
    """Yield card-resident batches with ``size`` transfers in flight.

    ``sharding`` (a ``parallel.sharding.BatchSharding``) places each
    batch in its training layout: only the rank's rows are pinned and
    copied, onto the sharding's device.  Without one the whole batch
    goes to ``device`` (``cuda`` unless the caller passes ``"cpu"``).

    ``pipelined=True`` adds the background host producer
    (:func:`host_prefetch`): ``next(iterator)`` for batch k+1 runs
    concurrently with the copy of batch k and the compute of batch
    k−1.  ``pipelined=False`` is the serial fallback — identical batch
    order, host fetch inline on the consumer thread.

    A host fetch slower than ``stall_threshold_s`` is emitted as a
    ``data_stall`` span tagged ``stage=host_fetch``; a staging slower
    than the threshold as ``stage=h2d``.
    """
    dev = (sharding.device if sharding is not None
           else resolve_device(device))
    return DevicePrefetch(iterator, size, dev, sharding,
                          stall_threshold_s, pipelined)
