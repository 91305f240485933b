"""Chunked parallel-copy substrate for the flash-checkpoint data plane.

Copy of ``dlrover_tpu/common/parallel_io.py``; the knobs keep their
names, so one environment tunes either package.

Every checkpoint hot path is, at bottom, a large host-side memcpy:
draining device snapshots into shared memory (``ckpt_shm.save_state``),
rebuilding private buffers on restore (``load_state(copy=True)``),
faulting in freshly-created segments (``preallocate``) and streaming
shm out to storage (``dump_to_file``).  A single-threaded NumPy copy
tops out at one core's bandwidth — and when the destination pages are
cold, at the first-touch fault rate (measured 0.17 GB/s faulting vs
7.7 GB/s resident in the build container).  NumPy copies on DISJOINT
slices release the GIL, so N worker threads give ~N× effective
bandwidth up to the memory bus; the same chunking bounds peak extra
memory on streaming writes.  This is the shape of fix CheckFreq's
pipelined snapshot/persist split and Gemini's chunked in-memory
traffic scheduling use for the same problem.

Tunables (environment):

- ``DLROVER_TPU_CKPT_COPY_WORKERS``: copy thread count.  ``1`` is the
  byte-identical serial fallback — no pool, no background threads, the
  exact pre-parallel code path.  Default: ``min(cpu_count, 8)``.
- ``DLROVER_TPU_CKPT_CHUNK_MB``: chunk granularity for both parallel
  copies and streaming writes.  Default 64 MB.

The worker pool is process-wide, lazily created, and fork-aware (a
forked child never inherits dead executor threads).
"""

import os
import threading
from concurrent.futures import ThreadPoolExecutor
from typing import Iterator, Optional, Tuple

import numpy as np

COPY_WORKERS_ENV = "DLROVER_TPU_CKPT_COPY_WORKERS"
CHUNK_MB_ENV = "DLROVER_TPU_CKPT_CHUNK_MB"
INPUT_COPY_WORKERS_ENV = "DLROVER_TPU_INPUT_COPY_WORKERS"

_DEFAULT_CHUNK_MB = 64
#: below this, thread dispatch costs more than the copy saves
MIN_PARALLEL_BYTES = 8 * 1024 * 1024


def copy_workers() -> int:
    """Configured copy-thread count (>= 1)."""
    raw = os.getenv(COPY_WORKERS_ENV, "")
    if raw:
        try:
            return max(1, int(raw))
        except ValueError:
            pass
    return max(1, min(os.cpu_count() or 1, 8))


def input_copy_workers() -> int:
    """Copy-thread count for the input data plane (shm batch ring,
    pipelined loader).  ``DLROVER_TPU_INPUT_COPY_WORKERS`` when set,
    else the checkpoint worker count — ``1`` remains the byte-identical
    serial fallback for both planes."""
    raw = os.getenv(INPUT_COPY_WORKERS_ENV, "")
    if raw:
        try:
            return max(1, int(raw))
        except ValueError:
            pass
    return copy_workers()


def chunk_nbytes() -> int:
    """Configured chunk size in bytes (>= 1 MB)."""
    raw = os.getenv(CHUNK_MB_ENV, "")
    try:
        mb = int(raw) if raw else _DEFAULT_CHUNK_MB
    except ValueError:
        mb = _DEFAULT_CHUNK_MB
    return max(1, mb) * 1024 * 1024


def chunked_iter(total: int,
                 chunk: Optional[int] = None) -> Iterator[Tuple[int, int]]:
    """Yield ``(offset, length)`` covering ``[0, total)`` in order."""
    chunk = chunk or chunk_nbytes()
    off = 0
    while off < total:
        n = min(chunk, total - off)
        yield off, n
        off += n


_pool: Optional[ThreadPoolExecutor] = None
_pool_workers = 0
_pool_pid = -1
_pool_lock = threading.Lock()


def _get_pool(workers: int) -> ThreadPoolExecutor:
    global _pool, _pool_workers, _pool_pid
    with _pool_lock:
        if (
            _pool is None
            or _pool_workers < workers
            or _pool_pid != os.getpid()  # forked child: threads are gone
        ):
            if _pool is not None and _pool_pid == os.getpid():
                _pool.shutdown(wait=False)
            _pool = ThreadPoolExecutor(
                max_workers=workers, thread_name_prefix="ckpt-io"
            )
            _pool_workers = workers
            _pool_pid = os.getpid()
        return _pool


def _flat_u8(buf) -> np.ndarray:
    """A flat uint8 view over any C-contiguous buffer (zero-copy)."""
    if isinstance(buf, np.ndarray):
        if not buf.flags.c_contiguous:
            raise ValueError(
                "parallel copy requires C-contiguous arrays"
            )
        return buf.reshape(-1).view(np.uint8)
    mv = memoryview(buf)
    if not mv.contiguous:
        raise ValueError("parallel copy requires contiguous buffers")
    return np.frombuffer(mv.cast("B"), dtype=np.uint8)


def parallel_memcpy(dst, src, workers: Optional[int] = None,
                    chunk: Optional[int] = None) -> int:
    """Copy ``src`` into ``dst`` (equal byte length, both contiguous)
    across the worker pool on disjoint chunks; returns bytes copied.

    Byte-identical to ``np.copyto`` for every worker count — chunking
    only partitions the range — so workers=1 vs N is a pure speed
    knob.  Small copies (< MIN_PARALLEL_BYTES) stay serial: dispatch
    overhead would dominate.
    """
    d = _flat_u8(dst)
    s = _flat_u8(src)
    if d.nbytes != s.nbytes:
        raise ValueError(
            f"size mismatch: dst={d.nbytes} src={s.nbytes} bytes"
        )
    total = d.nbytes
    workers = workers if workers is not None else copy_workers()
    chunk = chunk or chunk_nbytes()
    if workers <= 1 or total < max(MIN_PARALLEL_BYTES, 2 * chunk):
        np.copyto(d, s)
        return total
    pool = _get_pool(workers)
    futures = [
        pool.submit(np.copyto, d[off:off + n], s[off:off + n])
        for off, n in chunked_iter(total, chunk)
    ]
    for f in futures:
        f.result()
    return total


def _fill_slice(view: np.ndarray, value: int):
    view.fill(value)


def parallel_fill(dst, value: int = 0, workers: Optional[int] = None,
                  chunk: Optional[int] = None) -> int:
    """Fill ``dst`` with ``value`` across the pool; returns the bytes
    touched.  The point is page-touch parallelism: first-touch faults
    of a fresh (tmpfs or anonymous) mapping serialize on one core
    otherwise — the measured preallocation bottleneck."""
    d = _flat_u8(dst)
    total = d.nbytes
    workers = workers if workers is not None else copy_workers()
    chunk = chunk or chunk_nbytes()
    if workers <= 1 or total < max(MIN_PARALLEL_BYTES, 2 * chunk):
        d.fill(value)
        return total
    pool = _get_pool(workers)
    futures = [
        pool.submit(_fill_slice, d[off:off + n], value)
        for off, n in chunked_iter(total, chunk)
    ]
    for f in futures:
        f.result()
    return total


#: bytes between two reads of ``parallel_touch``: the smallest page
PAGE_BYTES = 4096


def _touch_slice(view: np.ndarray) -> int:
    # one read a page, and the last byte (a slice that starts inside a
    # page may end in one the stride steps over)
    return int(view[::PAGE_BYTES].sum()) + int(view[-1])


def parallel_touch(src, workers: Optional[int] = None,
                   chunk: Optional[int] = None) -> int:
    """Read one byte of every page of ``src`` across the pool; returns
    the bytes covered.  It maps a fresh mapping's pages (the restart's
    restore prefetch) without copying them: the copy that follows then
    runs at the memory's rate and not at the first-touch fault rate.
    Reads only, so the bytes are unchanged; numpy's reductions release
    the GIL, so the caller's other threads go on meanwhile."""
    s = _flat_u8(src)
    total = s.nbytes
    if total == 0:
        return 0
    workers = workers if workers is not None else copy_workers()
    chunk = chunk or chunk_nbytes()
    if workers <= 1 or total < max(MIN_PARALLEL_BYTES, 2 * chunk):
        _touch_slice(s)
        return total
    pool = _get_pool(workers)
    futures = [
        pool.submit(_touch_slice, s[off:off + n])
        for off, n in chunked_iter(total, chunk)
    ]
    for f in futures:
        f.result()
    return total


def _pread_slice(fd: int, view: np.ndarray, offset: int):
    mv = memoryview(view)
    got = 0
    while got < view.nbytes:
        n = os.preadv(fd, [mv[got:]], offset + got)
        if n == 0:
            raise EOFError(
                f"file ends before byte {offset + view.nbytes} "
                f"(read {offset + got})")
        got += n


def parallel_pread(fd: int, dst, offset: int,
                   workers: Optional[int] = None) -> int:
    """Fill ``dst`` (contiguous, writable) with the ``dst.nbytes`` bytes
    of the open file ``fd`` at ``offset``: ``os.preadv`` on disjoint
    slices across the pool (each releases the GIL).  The kernel copies
    out of the file's own pages, so reading a shared-memory segment
    this way maps none of its pages into this process: no first-touch
    fault, which is what a fresh mapping's reads wait on.  Raises
    ``EOFError`` on a short file; returns the bytes read."""
    d = _flat_u8(dst)
    total = d.nbytes
    if total == 0:
        return 0
    workers = workers if workers is not None else copy_workers()
    if workers <= 1 or total < 2 * MIN_PARALLEL_BYTES:
        _pread_slice(fd, d, offset)
        return total
    # every worker on one slice of the buffer (a caller's buffer is one
    # bounce buffer, far below the pool's default chunk)
    chunk = max(MIN_PARALLEL_BYTES, -(-total // workers))
    pool = _get_pool(workers)
    futures = [
        pool.submit(_pread_slice, fd, d[off:off + n], offset + off)
        for off, n in chunked_iter(total, chunk)
    ]
    for f in futures:
        f.result()
    return total


def throughput_gbps(nbytes: int, seconds: float) -> float:
    """GB/s with a zero-duration guard, rounded to 4 significant
    digits for span labels (fixed decimals would round a KB-scale
    test state's bandwidth to 0.0 and break the >0 invariant)."""
    gbps = nbytes / 1e9 / max(seconds, 1e-9)
    return float(f"{gbps:.4g}")
