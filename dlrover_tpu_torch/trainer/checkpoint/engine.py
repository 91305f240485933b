"""Training-process side of flash checkpoint.

Port of ``dlrover_tpu/trainer/checkpoint/engine.py``: ``CheckpointEngine``
with its serial restore (``load``) and the restore prefetch that
overlaps a restart's other legs (``start_prefetch`` -> ``RestorePrefetch``
-> ``finish_restore``, driven by ``trainer/restart_path.py``).  A
snapshot is the process's train state
copied from the card into host shared memory (two pinned bounce
buffers on a copy stream, ``agent/ckpt_shm.py``) under the agent's
``SharedLock``; persistence is asynchronous in the agent (or, with no
agent, in an in-process saver), so the step waits only for the copy
off the card, and a snapshot held by an agent survives the training
process.

What changed against the reference, where it touched ``jax``:

- ``preallocate_like`` and ``_launch_async_snapshot`` take tensors.  The state is flattened into keyed
  leaves on the caller's thread (a later ``opt.step()`` rewrites tensors
  in place and bumps Python counts, so the caller hands over tensors no
  later step writes: ``Trainer`` copies them on the device first, or
  blocks), and an async drain's copy stream waits on an event recorded
  on the caller's stream at the call.
- A restore copies into the initialised state's tensors in place (the
  reference ``device_put``s onto the target's shardings).
- Both restores read shm with ``preadv`` of the segment's file
  (``SharedMemoryHandler.open_slot``) straight into the target's
  tensors, so no page of it is mapped; the prefetch opens the slot and
  copies none of it.  The reference maps the slot and hands out views
  whose pages the consumer faults in on the main thread: on the card's
  machine those first touches are the whole of the restore's cost, and
  staging the slot in host memory beside ``init_state`` stretches
  ``init_state`` by more than it saves (``PERF.md``).
- The restore-step consensus is the local answer when the world is 1,
  ``torch.distributed.all_gather_object`` when a process group is
  initialised, and an error otherwise: a multi-process engine with no
  group must not agree with itself alone.  The reference's
  coordination-service fallback has no counterpart.
"""

import os
import threading
import time
from typing import Dict, List, Optional

import numpy as np
import torch

from dlrover_tpu_torch.common import parallel_io
from dlrover_tpu_torch.common.constants import CheckpointConstant
from dlrover_tpu_torch.common.log import default_logger as logger
from dlrover_tpu_torch.observability.events import (
    anchored_now,
    get_event_logger,
)
from dlrover_tpu_torch.common.multi_process import SharedQueue
from dlrover_tpu_torch.common.storage import (
    get_checkpoint_storage,
    is_remote_url,
)
from dlrover_tpu_torch.agent.ckpt_saver import (
    AsyncCheckpointSaver,
    CheckpointEvent,
    EVENT_QUEUE,
    FACTORY_QUEUE,
    SaverConfig,
    find_latest_checkpoint,
)
from dlrover_tpu_torch.agent.ckpt_shm import (
    SharedMemoryHandler,
    _flatten_keyed,
    _leaf_meta,
    _target_leaves,
    FileLeaf,
    itemsize,
    read_shard_file,
    restore_batches_to_target,
    restore_to_target,
    shard_lock,
    stream_shard_leaves,
)
from dlrover_tpu_torch.common.env import ckpt_close_timeout_s
from dlrover_tpu_torch.trainer.checkpoint import reshard as _reshard


def _newest_common_step(pairs) -> int:
    """Max step present in every rank's availability row ([P, 2] of
    {shm_step, storage_step}), or -1 when no step is restorable on all
    ranks (a torn post-crash state: everyone starts fresh together)."""
    rows = np.asarray(pairs)
    candidates = sorted(
        {int(v) for v in rows.reshape(-1) if v >= 0}, reverse=True
    )
    for c in candidates:
        if all((row == c).any() for row in rows):
            return c
    return -1


def _agent_factory_queue_exists() -> bool:
    """True only if an agent is actually listening — a stale socket
    file from a SIGKILLed agent must not make the standalone path
    block on a dead queue."""
    import socket as _socket

    from dlrover_tpu_torch.common.multi_process import _socket_path

    path = _socket_path("queue_" + FACTORY_QUEUE)
    if not os.path.exists(path):
        return False
    probe = _socket.socket(_socket.AF_UNIX, _socket.SOCK_STREAM)
    try:
        probe.settimeout(2.0)
        probe.connect(path)
        return True
    except OSError:
        try:
            os.unlink(path)
        except OSError:
            pass
        return False
    finally:
        probe.close()


class _StagedCandidate:
    """Leaves of one restorable step, published as they become readable.

    The prefetch thread is the single producer; ``finish_restore`` is
    the single consumer.  A storage candidate publishes each leaf as its
    bytes land in host memory, and the consumer copies leaf k to the
    card while the producer reads leaf k+1.  A shm candidate publishes
    every leaf of the slot at once, as a ``FileLeaf`` of the segment's
    file, which the consumer reads straight into the target: staging a
    slot in host memory beside ``init_state`` stretches ``init_state``
    by more than the copy it saves (``PERF.md``)."""

    def __init__(self, source: str):
        self.source = source  # "shm" | "storage"
        self.arrays: Dict[str, object] = {}
        self._order: List[str] = []
        self._cv = threading.Condition()
        self._done = False
        self.failed = False
        #: the slot's open file (shm), closed by ``close``
        self._fd: Optional[int] = None

    def publish(self, key: str, arr):
        with self._cv:
            self.arrays[key] = arr
            self._order.append(key)
            self._cv.notify_all()

    def publish_file(self, fd: int, leaves: Dict[str, FileLeaf]):
        """Publish a slot's leaves, readable from ``fd`` (now owned)."""
        with self._cv:
            self._fd = fd
            self.arrays.update(leaves)
            self._order.extend(leaves)
            self._cv.notify_all()

    def close(self):
        """Close the slot's file and drop the leaves."""
        with self._cv:
            fd, self._fd = self._fd, None
            self.arrays.clear()
        if fd is not None:
            os.close(fd)

    def finish(self, failed: bool = False):
        with self._cv:
            if self._done:
                return
            self.failed = failed
            self._done = True
            self._cv.notify_all()

    def iter_batches(self, timeout: float = 600.0):
        """Yield lists of ``(key, tensor or FileLeaf)``: every leaf
        published since the last yield, blocking for the next while the
        producer is still at work."""
        i = 0
        deadline = time.monotonic() + timeout
        while True:
            with self._cv:
                while i >= len(self._order) and not self._done:
                    if time.monotonic() > deadline:
                        raise TimeoutError(
                            f"restore prefetch ({self.source}) stalled"
                        )
                    self._cv.wait(0.5)
                if i >= len(self._order):
                    if self.failed:
                        raise RuntimeError(
                            f"prefetch candidate ({self.source}) failed"
                        )
                    return
                keys = self._order[i:]
                i = len(self._order)
                batch = [(key, self.arrays[key]) for key in keys]
            yield batch

    def wait_all(self, timeout: float = 600.0) -> Dict[str, object]:
        for _ in self.iter_batches(timeout):
            pass
        return self.arrays


class RestorePrefetch:
    """Background preparation of the restore, started the moment the
    worker knows its rank and checkpoint dir, so that it overlaps the
    state build (``init_state``) and any other leg of the restart
    before the restore.

    Resolves what is restorable (the shm steps, the newest committed
    storage step), opens the newest shm slot and publishes its leaves as
    ``FileLeaf``s, and, when storage holds a step shm does not, streams
    that shard file leaf by leaf into host memory.  A shm slot is not
    copied here: ``finish_restore`` reads it with ``preadv`` straight
    into the built state, which maps no page of the segment (a fresh
    mapping's first touches are what a restore through one waits on),
    and a copy into host memory beside ``init_state`` stretches
    ``init_state`` by more than it saves (``PERF.md``).  Nothing here
    agrees a step or writes the state;
    :meth:`CheckpointEngine.finish_restore` consumes the published
    leaves after the cross-rank step agreement, and ANY failure in this
    thread degrades the restore to the serial ``load`` path (``error``
    is set, nothing is ever half-applied)."""

    def __init__(self, engine: "CheckpointEngine",
                 checkpoint_dir: Optional[str] = None,
                 start_gate=None, layouts=None):
        self._engine = engine
        self._dir = checkpoint_dir
        self._gate = start_gate
        #: requested per-leaf global layouts for THIS rank's new
        #: slices (reshard-aware restore); None = same-world
        self._layouts = layouts
        self.error: Optional[BaseException] = None
        self.shm_steps: List[int] = []
        self.storage_step = -1
        self.storage_dir: Optional[str] = None
        #: bytes made readable: the shm slot's leaves, the storage leaves
        #: landed in host memory
        self.staged_bytes = 0
        #: host wall-clock times (``time.time()``) the staging began and
        #: ended (None until then)
        self.started_at: Optional[float] = None
        self.finished_at: Optional[float] = None
        self._avail = threading.Event()
        self._candidates: Dict[int, _StagedCandidate] = {}
        self._thread = threading.Thread(
            target=self._run, name="ckpt-restore-prefetch", daemon=True
        )
        self._thread.start()

    def wait_available(self, timeout: float = 300.0) -> bool:
        """Block until the availability snapshot (shm steps + latest
        storage step) is resolved — the input the consensus needs."""
        return self._avail.wait(timeout)

    def candidate(self, step: int) -> Optional[_StagedCandidate]:
        cand = self._candidates.get(step)
        if cand is None or cand.failed:
            return None
        return cand

    def join(self, timeout: float = 300.0):
        self._thread.join(timeout)

    def release(self, timeout: float = 300.0):
        """Wait for the thread, then drop what it holds: the slot's file
        and the storage leaves."""
        self.join(timeout)
        for cand in list(self._candidates.values()):
            cand.close()

    @property
    def done(self) -> bool:
        return not self._thread.is_alive()

    # ------------------------------------------------------- producer
    def _run(self):
        if self._gate is not None:
            try:
                # start-alignment gate (the restart coordinator's
                # barrier): the overlapped legs begin together so the
                # timeline shows the real concurrency
                self._gate()
            except Exception:  # noqa: BLE001 - alignment is best-effort
                pass
        t0_mono = time.monotonic()
        t0_wall = anchored_now(t0_mono)
        self.started_at = time.time()
        eng = self._engine
        try:
            self.shm_steps = eng._usable_shm_steps(self._layouts)
            self.storage_step, self.storage_dir = (
                eng._latest_storage_step(self._dir)
            )
        except Exception as e:  # noqa: BLE001 - degrade, never corrupt
            self.error = e
            self.finished_at = time.time()
            self._avail.set()
            logger.warning(
                "rank %s: restore prefetch failed resolving "
                "availability: %s (serial fallback)", eng._rank, e,
            )
            return
        # register EMPTY candidates for every step about to be staged
        # BEFORE publishing availability: a near-instant consensus on
        # the main thread would otherwise see an empty candidate map
        # and silently take the serial path (the consumer blocks on
        # iter_batches until the bytes land instead)
        newest_shm = self.shm_steps[0] if self.shm_steps else -1
        shm_cand = None
        if newest_shm >= 0:
            shm_cand = _StagedCandidate("shm")
            self._candidates[newest_shm] = shm_cand
        storage_cand = None
        if (
            self.storage_step >= 0
            and self.storage_dir
            # stage storage only when shm cannot serve the newest
            # step: a warm restart (live shm snapshot, older committed
            # storage) must not pay a full state-sized read that
            # consensus will almost surely discard — the rare
            # consensus-picks-older case falls back to the serial
            # read of exactly that step
            and self.storage_step > newest_shm
        ):
            storage_cand = _StagedCandidate("storage")
            self._candidates[self.storage_step] = storage_cand
        self._avail.set()
        if shm_cand is not None:
            self._stage_shm(newest_shm, shm_cand)
        if storage_cand is not None:
            self._stage_storage(
                self.storage_step, self.storage_dir, storage_cand
            )
        dur = time.monotonic() - t0_mono
        self.finished_at = time.time()
        get_event_logger().complete(
            "restore_prefetch",
            t0_wall,
            dur,
            bytes=self.staged_bytes,
            steps=sorted(self._candidates),
        )

    def _stage_shm(self, step: int, cand: _StagedCandidate):
        try:
            slot = self._engine._shm_handler.open_slot(step)
            if slot is not None and slot[1] != step:
                os.close(slot[0])
                slot = None
            if slot is None:
                cand.finish(failed=True)
                return
            fd, _step, leaves = slot
            cand.publish_file(fd, leaves)
            self.staged_bytes += sum(leaf.nbytes for leaf in leaves.values())
            cand.finish()
        except Exception as e:  # noqa: BLE001
            cand.finish(failed=True)
            logger.warning(
                "rank %s: shm prefetch of step %s failed: %s",
                self._engine._rank, step, e,
            )

    def _stage_storage(self, step: int, ckpt_dir: str,
                       cand: _StagedCandidate):
        eng = self._engine
        try:
            stream = eng._storage_leaf_stream(ckpt_dir, self._layouts)
            got = -1
            for item in stream:
                if item[0] == "meta":
                    got = item[1]
                else:
                    self.staged_bytes += int(item[2].nbytes)
                    cand.publish(item[1], item[2])
            cand.finish(failed=(got != step))
        except Exception as e:  # noqa: BLE001
            cand.finish(failed=True)
            logger.warning(
                "rank %s: storage prefetch of step %s failed: %s",
                eng._rank, step, e,
            )


class CheckpointEngine:
    """Save/restore a train state through shm + the async agent saver."""

    def __init__(
        self,
        checkpoint_dir: str,
        process_rank: int = 0,
        process_count: int = 1,
        node_rank: int = 0,
        local_shard_num: int = 1,
        name: str = "default",
        storage=None,
        step_sync_fn=None,
    ):
        self.checkpoint_dir = checkpoint_dir
        self._rank = process_rank
        self._world = process_count
        self._node_rank = node_rank
        if name == "default" and checkpoint_dir:
            # namespace the shm/lock/queue names by checkpoint dir:
            # /dev/shm is machine-global, so two jobs both called
            # "default" would collide — observed as one job's exit
            # (close(unlink=True)) deleting the other's live 3 GB
            # snapshot segment.  Hashing the dir keeps the name stable
            # across restarts of the SAME job (resume depends on it).
            import hashlib

            # URLs (gs://…, memory://…) are already absolute; abspath
            # would prepend the cwd and de-sync the name across ranks
            dir_key = (
                checkpoint_dir
                if is_remote_url(checkpoint_dir)
                else os.path.abspath(checkpoint_dir)
            )
            digest = hashlib.sha1(dir_key.encode()).hexdigest()[:8]
            name = f"d{digest}"
        self._name = name
        self._storage = storage or get_checkpoint_storage(
            path=checkpoint_dir
        )
        self._local_saver: Optional[AsyncCheckpointSaver] = None
        # cross-rank restore-step consensus hook:
        # (avail_row: List[int]) -> agreed step, where avail_row is
        # this rank's full availability set (shm slots + storage step,
        # -1 padded); default: see _sync_restore_step
        self._step_sync_fn = step_sync_fn
        self._snapshot_thread = None
        self._last_drain_ok = True
        # saves dropped because the previous drain was still running or
        # the saver held the lock — the effective RPO degrades with each
        # skip, so it must be observable (exported as
        # dlrover_tpu_ckpt_skipped_snapshots)
        self.skipped_snapshots = 0
        #: (kind, step, bytes, seconds) of each drain into shm and each
        #: restore ("restore_shm" / "restore_storage")
        self.io_log: List[tuple] = []

        # the saver serves shm/lock endpoints for global ranks
        # [node_rank*local_shard_num, ...); this process's rank must be
        # one of them or its lock/meta sockets will never exist
        local_rank = process_rank - node_rank * local_shard_num
        if not 0 <= local_rank < local_shard_num:
            raise ValueError(
                f"process_rank {process_rank} outside node {node_rank}'s "
                f"local shard range (local_shard_num={local_shard_num}); "
                "expected contiguous rank assignment "
                "rank = node_rank*local_shard_num + local_rank"
            )

        config = SaverConfig(
            checkpoint_dir=checkpoint_dir,
            local_shard_num=local_shard_num,
            global_shard_num=process_count,
            node_rank=node_rank,
            name=name,
        )
        if _agent_factory_queue_exists():
            # running under an agent: ask its factory to build the saver
            factory = SharedQueue(FACTORY_QUEUE, create=False)
            factory.put(config)
            factory.close()
        elif local_rank == 0:
            # standalone (no dlrover-tpu-run): local rank 0 hosts the
            # saver in-process; async persist still works, crash
            # resilience does not (reference: engine.py:114
            # start_saver_process).  Other local ranks connect to its
            # shm/lock endpoints as clients.
            self._local_saver = AsyncCheckpointSaver(config,
                                                     storage=self._storage)
            self._local_saver.start()
            AsyncCheckpointSaver._instance = self._local_saver
        self._shm_handler = SharedMemoryHandler(
            process_rank, name=name, host=False
        )
        self._lock = shard_lock(process_rank, name=name, create=False)
        self._event_queue = SharedQueue(
            f"{EVENT_QUEUE}_{name}", create=False
        )

    def preallocate_like(self, state) -> int:
        """Create + fault in the shm segment sized for ``state`` ahead
        of the first snapshot (page allocation off the training hot
        path; a preemption arriving before step 1 then still finds a
        live segment).  Returns the reserved bytes."""
        total = 0
        for _key, leaf in _target_leaves(state):
            dts, shape = _leaf_meta(leaf)
            total += itemsize(dts) * int(np.prod(shape or (1,)))
        if total:
            dur = self._shm_handler.preallocate(total)
            if dur:
                from dlrover_tpu_torch.observability.metrics import (
                    record_ckpt_io,
                )

                record_ckpt_io(
                    "prealloc", self._shm_handler.segment_size, dur)
        return total

    # -- save --------------------------------------------------------------
    def save_to_memory(self, step: int, state,
                       blocking: bool = True, layouts=None) -> bool:
        """Snapshot ``state`` into shm.

        ``blocking=True`` returns once every byte is in shm (the caller
        may then run a step that rewrites ``state`` in place).
        ``blocking=False`` drains into shm on a background thread; the
        caller must not write ``state``'s tensors until the drain
        finishes (``wait_for_snapshot``): hand over copies (``Trainer``'s
        "copy" mode copies them into buffers of its own on the device).

        ``layouts`` ({keypath: global-layout dict}, see
        ``trainer/checkpoint/reshard.py``) stamps the snapshot — and
        every shard file persisted from it — with each leaf's global
        shape and this shard's index slice, making the checkpoint
        restorable by ANY world size.  None writes no header: such a
        shard restores only on an unchanged world.
        """
        if not self._snapshot_slot_free(step):
            return False
        pairs = _flatten_keyed(state)
        if blocking:
            return self._drain_snapshot(step, pairs, None, layouts,
                                        _ready_event(pairs))
        return self._launch_async_snapshot(step, pairs, None, layouts)

    def _snapshot_slot_free(self, step: int) -> bool:
        if self._snapshot_thread is not None:
            if self._snapshot_thread.is_alive():
                self._count_skip()
                logger.warning(
                    "rank %s: snapshot still draining; skip step %s "
                    "(%s skipped so far)",
                    self._rank, step, self.skipped_snapshots,
                )
                return False
            self._snapshot_thread = None
        return True

    def _count_skip(self):
        self.skipped_snapshots += 1
        try:
            from dlrover_tpu_torch.observability.metrics import get_registry

            get_registry().inc_counter(
                "dlrover_tpu_ckpt_skipped_snapshots"
            )
        except Exception:  # noqa: BLE001 - metrics must never break saves
            pass

    def _launch_async_snapshot(self, step: int, pairs,
                               persist_dir: Optional[str],
                               layouts=None) -> bool:
        # the event is recorded here, on the caller's stream, so the
        # drain waits for exactly the work queued before the save
        ready = _ready_event(pairs)
        self._snapshot_thread = threading.Thread(
            target=self._drain_snapshot,
            args=(step, pairs, persist_dir, layouts, ready),
            name=f"ckpt-snapshot-{step}",
            daemon=True,
        )
        self._snapshot_thread.start()
        return True

    def _drain_snapshot(self, step: int, pairs,
                        persist_dir: Optional[str],
                        layouts=None, ready=None) -> bool:
        start = time.time()
        start_mono = time.monotonic()
        self._last_drain_ok = False
        if not self._lock.acquire(timeout=60):
            self._count_skip()
            logger.warning(
                "rank %s: saver still busy; skip memory save of step %s",
                self._rank, step,
            )
            return False
        try:
            nbytes = self._shm_handler.save_state(
                step, pairs, layouts=layouts, ready=ready
            )
        finally:
            self._lock.release()
        from dlrover_tpu_torch.common.parallel_io import throughput_gbps
        from dlrover_tpu_torch.observability.metrics import record_ckpt_io

        dur = time.monotonic() - start_mono
        get_event_logger().complete(
            "checkpoint_save",
            start,
            dur,
            step=step,
            bytes=nbytes,
            throughput_gbps=throughput_gbps(nbytes, dur),
        )
        record_ckpt_io("drain", nbytes, dur)
        self.io_log.append(("drain", step, nbytes, dur))
        logger.info(
            "rank %s: step %s snapshot (%.1f MB) to shm in %.3fs "
            "(%.2f GB/s)",
            self._rank, step, nbytes / 1e6, dur,
            throughput_gbps(nbytes, dur),
        )
        if persist_dir is not None:
            self._event_queue.put(
                CheckpointEvent(
                    event_type="save", step=step,
                    checkpoint_dir=persist_dir,
                )
            )
        self._last_drain_ok = True
        return True

    def wait_for_snapshot(self, timeout: Optional[float] = None) -> bool:
        """Join an in-flight non-blocking snapshot drain.  Returns True
        only when the drain actually wrote the snapshot (a drain that
        lost the saver lock returns False so callers don't wait on a
        persist that will never come)."""
        t = self._snapshot_thread
        if t is None:
            return True
        t.join(timeout)
        return not t.is_alive() and self._last_drain_ok

    def save_to_storage(self, step: int, state,
                        checkpoint_dir: Optional[str] = None,
                        blocking: bool = True, layouts=None) -> bool:
        target_dir = checkpoint_dir or self.checkpoint_dir
        if blocking:
            if not self.save_to_memory(step, state, layouts=layouts):
                return False
            self._event_queue.put(
                CheckpointEvent(
                    event_type="save", step=step,
                    checkpoint_dir=target_dir,
                )
            )
            return True
        # async: the persist event must trail the shm write, so the
        # drain thread enqueues it
        if not self._snapshot_slot_free(step):
            return False
        return self._launch_async_snapshot(
            step, _flatten_keyed(state), target_dir, layouts
        )

    # -- load --------------------------------------------------------------
    def load(self, target=None, checkpoint_dir: Optional[str] = None,
             layouts=None):
        """Restore the newest globally-agreed state: shm first (read
        from the segment's file straight into the target), storage
        next.

        The restore step is reconciled across processes before any data
        moves: after a node replacement, surviving ranks may hold a
        newer uncommitted shm snapshot than the relaunched node's last
        committed storage step — restoring it would silently resume a
        mixed-step global state.  Every process restores the newest
        step available on ALL ranks (each rank's set = its two shm
        slots + its latest committed storage step).

        ``layouts`` describes the per-leaf global slices THIS rank
        wants on the (possibly new) world; when the stored shards'
        placement differs, the restore reassembles each leaf from
        whichever shards cover its new slices (the reshard leg).

        Returns (step, state): ``target`` restored (a port train state
        is written in place) when given, else {keypath: CPU tensor};
        (-1, None) when nothing exists.
        """
        t0_mono = time.monotonic()
        t0_wall = anchored_now(t0_mono)
        shm_steps = self._usable_shm_steps(layouts)
        storage_step, latest_dir = self._latest_storage_step(
            checkpoint_dir
        )
        agreed = self._sync_restore_step(shm_steps, storage_step)
        if agreed < 0:
            return -1, None
        return self._restore_agreed(
            agreed, target, checkpoint_dir, shm_steps, storage_step,
            latest_dir, t0_wall, t0_mono, layouts=layouts,
        )

    def _restore_agreed(self, agreed, target, checkpoint_dir,
                        shm_steps, storage_step, latest_dir,
                        t0_wall, t0_mono, layouts=None):
        """Fetch + apply an already-agreed restore step (the serial
        data path, shared by ``load`` and ``finish_restore``'s
        fallback)."""
        shm_step = shm_steps[0] if shm_steps else -1
        source = "shm"
        step, arrays, fd = -1, {}, None
        if agreed in shm_steps:
            slot = self._shm_handler.open_slot(agreed)
            if slot is not None:
                fd, step, arrays = slot
        try:
            if step != agreed and storage_step == agreed:
                # shm miss (or invalidated between get_step and
                # open_slot): storage holds the agreed step too
                source = "storage"
                step, arrays = self._read_storage_step_dir(
                    latest_dir, layouts
                )
            if step != agreed:
                source = "storage"
                step, arrays = self._load_storage_step(
                    agreed, checkpoint_dir, layouts
                )
            if step != agreed or not arrays:
                # peers WILL resume from `agreed`; silently starting
                # fresh here would be exactly the mixed-step divergence
                # the consensus exists to prevent — fail loudly instead
                raise RuntimeError(
                    f"rank {self._rank}: globally-agreed restore step "
                    f"{agreed} unavailable locally (shm={shm_step} "
                    f"storage={storage_step})"
                )
            restored_bytes = sum(
                int(getattr(v, "nbytes", 0)) for v in arrays.values()
            )
            if target is not None:
                arrays = restore_to_target(target, arrays)
            else:
                arrays = _private(arrays)
        finally:
            if fd is not None:
                os.close(fd)
        from dlrover_tpu_torch.common.parallel_io import throughput_gbps
        from dlrover_tpu_torch.observability.metrics import record_ckpt_io

        dur = time.monotonic() - t0_mono
        get_event_logger().complete(
            "checkpoint_restore",
            t0_wall,
            dur,
            step=agreed,
            bytes=restored_bytes,
            throughput_gbps=throughput_gbps(restored_bytes, dur),
        )
        record_ckpt_io("restore", restored_bytes, dur)
        self.io_log.append((f"restore_{source}", step, restored_bytes, dur))
        return step, arrays

    def start_prefetch(self, checkpoint_dir: Optional[str] = None,
                       start_gate=None, layouts=None) -> RestorePrefetch:
        """Begin preparing the restore on a background thread (the
        restorable steps, the newest shm slot opened, a storage step
        that shm lacks streamed into host memory) — the first leg of
        the overlapped restart critical path
        (see ``trainer/restart_path.py``).  Callable before the state
        or the process group exist: it touches only shm and storage.
        ``layouts`` makes the staging reshard-aware: the byte stream
        reads whichever shard files cover this rank's NEW slices.  Pair
        with :meth:`finish_restore`; ``load`` stays the serial
        equivalent."""
        return RestorePrefetch(
            self, checkpoint_dir=checkpoint_dir,
            start_gate=start_gate, layouts=layouts,
        )

    def finish_restore(self, prefetch: Optional[RestorePrefetch],
                       target=None,
                       checkpoint_dir: Optional[str] = None,
                       layouts=None):
        """Complete an overlapped restore started by
        :meth:`start_prefetch`.

        Runs the SAME cross-rank step consensus as ``load`` (over the
        prefetch's availability snapshot — the row this rank publishes
        must describe the bytes it staged), then copies the published
        leaves into ``target`` batch by batch as they land: a shm
        slot's from the segment's file straight into the target, a
        storage stream's from host memory.  Any prefetch
        failure, consensus miss on the staged step, or staging error
        degrades to the serial ``_restore_agreed``/``load`` path —
        byte-identical result, never a half-applied state.  Returns
        what ``load`` returns.

        ``layouts`` supersedes the prefetch's (a caller may only learn
        its target slices AFTER the blind prefetch launched — the
        ``Trainer`` derives them from the freshly-initialised state):
        the consensus row is re-filtered through the layout gate and
        every fallback is layout-aware, so a blind prefetch that staged
        the wrong world's shard degrades into the reshard leg instead
        of a mis-sharded (or failed) restore."""
        if prefetch is None:
            return self.load(target=target, checkpoint_dir=checkpoint_dir,
                             layouts=layouts)
        try:
            return self._finish_restore(prefetch, target, checkpoint_dir,
                                        layouts)
        finally:
            prefetch.release()

    def _finish_restore(self, prefetch: RestorePrefetch, target,
                        checkpoint_dir, layouts):
        t0_mono = time.monotonic()
        t0_wall = anchored_now(t0_mono)
        if layouts is None:
            layouts = prefetch._layouts
        if not prefetch.wait_available(300) or prefetch.error is not None:
            prefetch.release()
            return self.load(
                target=target, checkpoint_dir=checkpoint_dir,
                layouts=layouts,
            )
        shm_steps = prefetch.shm_steps
        if layouts is not None and layouts is not prefetch._layouts:
            # stricter than what the prefetch staged: drop shm steps
            # whose placement does not serve the requested slices
            usable = set(self._usable_shm_steps(layouts))
            shm_steps = [s for s in shm_steps if s in usable]
        agreed = self._sync_restore_step(
            shm_steps, prefetch.storage_step
        )
        if agreed < 0:
            return -1, None

        def _serial():
            prefetch.release()
            return self._restore_agreed(
                agreed, target, checkpoint_dir, shm_steps,
                prefetch.storage_step, prefetch.storage_dir,
                t0_wall, t0_mono, layouts=layouts,
            )

        cand = prefetch.candidate(agreed)
        if (
            cand is not None
            and cand.source == "shm"
            and agreed not in shm_steps
        ):
            # the blind prefetch staged this step from a shm slot the
            # override's layout gate rejected (valid bytes, wrong
            # placement) — the step is only restorable via storage
            cand = None
        if cand is None:
            return _serial()
        try:
            step, state, nbytes = self._consume_staged(
                cand, agreed, target
            )
        except Exception as e:  # noqa: BLE001 - degrade, never corrupt
            logger.warning(
                "rank %s: staged restore of step %s failed (%s); "
                "serial fallback", self._rank, agreed, e,
            )
            return _serial()
        from dlrover_tpu_torch.observability.metrics import record_ckpt_io

        dur = time.monotonic() - t0_mono
        events = get_event_logger()
        events.complete(
            "checkpoint_restore",
            t0_wall,
            dur,
            step=agreed,
            bytes=nbytes,
            throughput_gbps=parallel_io.throughput_gbps(nbytes, dur),
            stage="overlap",
        )
        events.complete(
            "finish_restore", t0_wall, dur, step=agreed, bytes=nbytes
        )
        record_ckpt_io("restore", nbytes, dur)
        self.io_log.append((f"restore_{cand.source}", agreed, nbytes, dur))
        return step, state

    def _consume_staged(self, cand: _StagedCandidate, agreed: int,
                        target):
        """Apply one staged candidate: copy each batch of published
        leaves into ``target`` as it lands (a shm slot's all at once,
        read from its file; a storage stream's while the producer reads
        the next batch): the same values as ``restore_to_target``."""
        if target is None:
            arrays = _private(cand.wait_all())
            nbytes = sum(int(v.nbytes) for v in arrays.values())
            return agreed, arrays, nbytes
        nbytes = 0

        def batches():
            nonlocal nbytes
            for batch in cand.iter_batches():
                nbytes += sum(int(v.nbytes) for _k, v in batch)
                yield batch

        return agreed, restore_batches_to_target(target, batches()), nbytes

    def _sync_restore_step(self, shm_steps, storage_step: int) -> int:
        """Cross-process consensus on the restore step: the NEWEST step
        that every rank can actually restore.

        min-of-maxes is not enough: after a mid-save crash the shards
        can be torn — rank 0's newest shm slot holds step N+1 while the
        relaunched rank 1 holds step N; the min (N) must be restored
        from rank 0's OTHER slot (the double buffer keeps it).  Each
        rank publishes its availability set {shm slots, storage_step}
        and all pick the max step present in every set (-1 = none:
        every rank starts fresh, consistently)."""
        avail = [
            *shm_steps[: SharedMemoryHandler.NUM_SLOTS],
            storage_step,
        ]
        # fixed-width row for the allgather
        width = SharedMemoryHandler.NUM_SLOTS + 1
        avail += [-1] * (width - len(avail))
        if self._step_sync_fn is not None:
            # the hook sees the FULL availability row — a consensus
            # restricted to the newest shm slot could pick a step this
            # rank only holds in its second buffer
            return self._step_sync_fn(avail)
        if self._world <= 1:
            return max(avail)
        import torch.distributed as dist

        if not (dist.is_available() and dist.is_initialized()):
            # agreeing with itself alone would recreate the mixed-step
            # divergence this sync exists to prevent
            raise RuntimeError(
                f"rank {self._rank}: restore-step consensus over "
                f"{self._world} processes needs an initialised "
                "torch.distributed process group (or step_sync_fn)")
        rows = [None] * dist.get_world_size()
        dist.all_gather_object(rows, avail)
        return _newest_common_step(rows)

    def _latest_storage_step(self, checkpoint_dir: Optional[str] = None):
        root = checkpoint_dir or self.checkpoint_dir
        latest = find_latest_checkpoint(root, self._storage)
        if latest is None:
            return -1, None
        try:
            step = int(os.path.basename(latest).split("-")[-1])
        except ValueError:
            step = -1
        return step, latest

    def _read_storage_shard(self, ckpt_path: Optional[str]):
        if ckpt_path is None:
            return -1, {}
        path = os.path.join(ckpt_path, f"shard_{self._rank}.drckpt")
        if not self._storage.exists(path):
            logger.warning("no shard file %s in %s", self._rank, ckpt_path)
            return -1, {}
        return read_shard_file(path, self._storage)

    def _load_storage_step(self, step: int,
                           checkpoint_dir: Optional[str] = None,
                           layouts=None):
        """Read a specific committed step (an older step may be the
        globally-agreed one when this rank's storage is ahead)."""
        root = checkpoint_dir or self.checkpoint_dir
        path = os.path.join(
            root, f"{CheckpointConstant.CKPT_DIR_PREFIX}{step}"
        )
        if not self._storage.exists(path):
            return -1, {}
        return self._read_storage_step_dir(path, layouts)

    # -- reshard ------------------------------------------------------------
    def _reshard_active(self, layouts) -> bool:
        return bool(layouts)

    def _usable_shm_steps(self, layouts=None):
        """Steps restorable from THIS rank's shm segment under the
        requested layouts.  After a world change the segment may hold
        a snapshot of the OLD world's slices — its bytes are valid but
        placed wrong, and using them would silently resume a
        mis-sharded state.  A slot is usable when its layout header
        matches the request, or (a headerless slot) when every
        spec's local shape matches the requested local shape.  Without
        requested layouts this is exactly ``steps_available()``."""
        steps = self._shm_handler.steps_available()
        if not self._reshard_active(layouts):
            return steps
        usable = []
        for step in steps:
            slot_layouts = self._shm_handler.slot_layouts(step)
            if slot_layouts is not None:
                if _reshard.layouts_equal(slot_layouts, layouts):
                    usable.append(step)
                continue
            # headerless slot: shape-compare against the request straight
            # off the meta specs (no shm attach, no leaf views)
            shapes = self._shm_handler.slot_shapes(step)
            if shapes is None:
                continue
            ok = True
            for key, raw in layouts.items():
                want_shape = tuple(
                    int(d) for d in (
                        raw["shape"] if isinstance(raw, dict)
                        else raw.shape
                    )
                )
                if shapes.get(key) != want_shape:
                    ok = False
                    break
            if ok:
                usable.append(step)
        return usable

    def _read_storage_step_dir(self, ckpt_path: Optional[str],
                               layouts=None):
        """Read one committed checkpoint dir onto this rank: the
        direct per-rank shard when its placement matches the request,
        the resharded overlap-range read otherwise."""
        if ckpt_path is None:
            return -1, {}
        if not self._reshard_active(layouts):
            return self._read_storage_shard(ckpt_path)
        step, arrays = -1, {}
        try:
            for item in self._storage_leaf_stream(ckpt_path, layouts):
                if item[0] == "meta":
                    step = item[1]
                else:
                    arrays[item[1]] = item[2]
        except Exception as e:  # noqa: BLE001 - degrade, never corrupt
            logger.warning(
                "rank %s: storage read of %s failed: %s",
                self._rank, ckpt_path, e,
            )
            return -1, {}
        return step, arrays

    def _direct_shard_compatible(self, ckpt_dir: str, layouts) -> bool:
        """Whether ``shard_{rank}`` in ``ckpt_dir`` already holds
        exactly the requested slices (same-world restart): header-only
        check, KBs against GB shards."""
        path = os.path.join(ckpt_dir, f"shard_{self._rank}.drckpt")
        if not self._storage.exists(path):
            return False
        try:
            info = _reshard.read_shard_header(path, self._storage)
        except Exception:  # noqa: BLE001 - unreadable header
            return False
        if info.layouts is not None:
            want = {
                k: (v if isinstance(v, dict) else v.as_dict())
                for k, v in layouts.items()
            }
            have = {k: v.as_dict() for k, v in info.layouts.items()}
            return _reshard.layouts_equal(have, want)
        # headerless file: usable iff every requested local shape matches
        for key, raw in layouts.items():
            shape = tuple(
                raw["shape"] if isinstance(raw, dict) else raw.shape
            )
            spec = info.specs.get(key)
            if spec is None or tuple(spec[1]) != shape:
                return False
        return True

    def _storage_leaf_stream(self, ckpt_dir: str, layouts=None):
        """Leaf stream over one committed checkpoint dir: the direct
        per-rank shard file when it already matches the requested
        layouts (or none were requested), else the resharded
        overlap-range read across whichever shards cover this rank's
        new slices.  The reshard leg emits a ``reshard`` span with
        the world transition and the moved bytes."""
        direct = os.path.join(
            ckpt_dir, f"shard_{self._rank}.drckpt"
        )
        if not self._reshard_active(layouts) or (
            self._direct_shard_compatible(ckpt_dir, layouts)
        ):
            yield from stream_shard_leaves(direct, self._storage)
            return
        t0_mono = time.monotonic()
        t0_wall = anchored_now(t0_mono)
        shards = _reshard.scan_checkpoint_shards(
            ckpt_dir, self._storage
        )
        from_world = _reshard.checkpoint_world_size(shards)
        moved = 0
        for item in _reshard.stream_resharded_leaves(
            ckpt_dir, layouts, storage=self._storage, shards=shards
        ):
            if item[0] == "leaf":
                moved += int(item[2].nbytes)
            yield item
        from dlrover_tpu_torch.common.parallel_io import throughput_gbps
        from dlrover_tpu_torch.observability.metrics import record_reshard_io

        dur = time.monotonic() - t0_mono
        get_event_logger().complete(
            "reshard",
            t0_wall,
            dur,
            from_world=from_world,
            to_world=self._world,
            bytes=moved,
            throughput_gbps=throughput_gbps(moved, dur),
        )
        record_reshard_io(from_world, self._world, moved, dur)
        logger.info(
            "rank %s: resharded restore %s -> %s ranks (%.1f MB in "
            "%.3fs)", self._rank, from_world, self._world,
            moved / 1e6, dur,
        )

    def latest_persisted_step(self) -> int:
        tracker = os.path.join(
            self.checkpoint_dir, CheckpointConstant.TRACKER_FILE
        )
        content = self._storage.read(tracker)
        return int(content) if content else -1

    def wait_for_persist(self, step: int, timeout: float = 120) -> bool:
        """Block until the tracker shows ``step`` persisted.

        Exponential backoff (0.1 s → 2 s cap): each poll is a storage
        read, and on a remote tracker (gs://) a flat 100 ms cadence
        hammers the object store for the full timeout."""
        deadline = time.time() + timeout
        delay = 0.1
        while time.time() < deadline:
            if self.latest_persisted_step() >= step:
                return True
            time.sleep(min(delay, max(deadline - time.time(), 0.01)))
            delay = min(delay * 2, 2.0)
        # one post-deadline read: the persist may have landed during
        # the final (long) sleep
        return self.latest_persisted_step() >= step

    def close(self):
        budget = ckpt_close_timeout_s()
        self.wait_for_snapshot(timeout=budget)
        t = self._snapshot_thread
        if t is not None and t.is_alive():
            # the drain thread still holds live views over the shm
            # buffer and will touch the lock and event queue when it
            # finishes — closing ANY of them now would make the drain
            # fail on a closed handle (persist event lost) or raise
            # BufferError; leak all three and let process exit reclaim.
            # The leak is deliberate but must be OBSERVABLE: a fleet
            # where closes keep timing out is leaking multi-GB shm
            # segments (dlrover_tpu_ckpt_drain_stuck alerts on it),
            # and DLROVER_TPU_CKPT_CLOSE_TIMEOUT_S tunes the budget
            # (tests use a tiny one to pin this path).
            try:
                from dlrover_tpu_torch.observability.metrics import (
                    get_registry,
                )

                get_registry().inc_counter(
                    "dlrover_tpu_ckpt_drain_stuck"
                )
            except Exception:  # noqa: BLE001 - metrics never break close
                pass
            logger.error(
                "rank %s: snapshot drain still running after %.0fs; "
                "leaving shm/lock/queue handles open", self._rank,
                budget,
            )
            return  # saver side must stay up too: drain uses its
            # locks/queue service and the shm segments it would unlink
        self._shm_handler.close()
        self._lock.close()
        self._event_queue.close()
        if self._local_saver is not None:
            self._local_saver.close(unlink=True)
            AsyncCheckpointSaver._instance = None


def _private(arrays) -> Dict[str, torch.Tensor]:
    """{keypath: CPU tensor}, the slot's leaves read out of its file."""
    return {k: v.read() if isinstance(v, FileLeaf) else v
            for k, v in arrays.items()}


def _ready_event(pairs) -> Optional["torch.cuda.Event"]:
    """An event on the current stream of the first CUDA leaf's device,
    recorded now: the work that wrote the snapshot's tensors."""
    for _key, leaf in pairs:
        if torch.is_tensor(leaf) and leaf.device.type == "cuda":
            with torch.cuda.device(leaf.device):
                ev = torch.cuda.Event()
                ev.record()
            return ev
    return None
