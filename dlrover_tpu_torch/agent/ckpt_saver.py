"""Agent-side asynchronous checkpoint saver.

Copy of ``dlrover_tpu/agent/ckpt_saver.py``.  It persists the port's
shared-memory shards (``agent/ckpt_shm.py``) in the ``.drckpt`` format
both packages read.

Reference parity: ``dlrover/python/elastic_agent/torch/ckpt_saver.py:345``
(AsyncCheckpointSaver + CommonDirCheckpointSaver): lives in the *agent*
process so it survives training-process crashes; drains save events from
a SharedQueue, persists shm shards to storage with a two-phase stage-dir
commit, and flushes the last shm snapshot on SIGTERM or worker failure.

Commit protocol (reference ``:774+``):
1. write every shard to ``<dir>/._dlrover_ckpt_stage/checkpoint-<step>/``
2. write a per-node done file ``done_<node_rank>``
3. the committing node (node_rank 0) waits for all done files, then
   atomically moves the stage dir to ``<dir>/checkpoint-<step>`` and
   rewrites ``latest_checkpointed_iteration.txt``.

On GCS-Fuse/NFS the stage dir is on the shared filesystem, so multi-host
commits need no extra RPC.
"""

import os
import queue
import signal
import threading
import time
from dataclasses import dataclass
from typing import List, Optional

from dlrover_tpu_torch.common.constants import CheckpointConstant
from dlrover_tpu_torch.common.log import default_logger as logger
from dlrover_tpu_torch.common.multi_process import SharedQueue
from dlrover_tpu_torch.common.storage import get_checkpoint_storage
from dlrover_tpu_torch.agent.ckpt_shm import SharedMemoryHandler, shard_lock

FACTORY_QUEUE = "ckpt_factory"
EVENT_QUEUE = "ckpt_event"


@dataclass
class SaverConfig:
    """Sent by the training process to tell the agent which saver to
    build (reference: the "factory" SharedQueue protocol)."""

    checkpoint_dir: str = ""
    local_shard_num: int = 1
    global_shard_num: int = 1
    node_rank: int = 0
    name: str = "default"


@dataclass
class CheckpointEvent:
    """A save/update request from the training process."""

    event_type: str = "save"  # save | update
    step: int = 0
    checkpoint_dir: str = ""


class AsyncCheckpointSaver:
    """One instance per agent; persists every local shard."""

    _instance: Optional["AsyncCheckpointSaver"] = None
    _factory_thread: Optional[threading.Thread] = None

    def __init__(self, config: SaverConfig, storage=None):
        self.config = config
        self._storage = storage or get_checkpoint_storage(
            path=config.checkpoint_dir
        )
        self._shm_handlers: List[SharedMemoryHandler] = []
        self._locks = []
        for local_rank in range(config.local_shard_num):
            self._shm_handlers.append(
                SharedMemoryHandler(
                    self._global_rank(local_rank),
                    name=config.name,
                    host=True,
                )
            )
            self._locks.append(
                shard_lock(
                    self._global_rank(local_rank),
                    name=config.name,
                    create=True,
                )
            )
        self._event_queue = SharedQueue(
            f"{EVENT_QUEUE}_{config.name}", create=True
        )
        self._stopped = False
        self._persist_thread: Optional[threading.Thread] = None
        self._latest_persisted_step = -1

    def _global_rank(self, local_rank: int) -> int:
        return (
            self.config.node_rank * self.config.local_shard_num
            + local_rank
        )

    # -- lifecycle ---------------------------------------------------------
    def start(self):
        self._persist_thread = threading.Thread(
            target=self._event_loop, name="ckpt-saver", daemon=True
        )
        self._persist_thread.start()

    def stop(self):
        self._stopped = True

    def close(self, unlink: bool = False):
        self.stop()
        # join the event loop BEFORE closing shm: a persist in flight
        # holds memoryview slices of the segments (dump_to_file), and
        # closing under it raises BufferError "exported pointers exist"
        t = self._persist_thread
        if t is not None and t.is_alive():
            t.join(timeout=60)
            if t.is_alive():
                # the handles must stay open (the stuck persist holds
                # buffer views), but named POSIX shm is NOT reclaimed
                # at process exit — unlink the names now (safe while
                # mapped) so the multi-GB segments die with the last
                # process instead of squatting in /dev/shm until reboot
                logger.error(
                    "ckpt saver event loop still busy after 60s; "
                    "leaving handles open%s",
                    ", unlinking shm names" if unlink else "",
                )
                if unlink:
                    for handler in self._shm_handlers:
                        handler.unlink_name()
                return
        for handler in self._shm_handlers:
            handler.close(unlink=unlink)
        for lock in self._locks:
            lock.close()
        self._event_queue.close()

    def _event_loop(self):
        logger.info(
            "async ckpt saver running for %s (local shards: %s)",
            self.config.checkpoint_dir,
            self.config.local_shard_num,
        )
        while not self._stopped:
            try:
                event: CheckpointEvent = self._event_queue.get(
                    timeout=1.0
                )
            except queue.Empty:
                continue
            except Exception as e:  # noqa: BLE001
                logger.warning("ckpt event queue error: %s", e)
                time.sleep(0.5)
                continue
            try:
                self.save_step_checkpoint(
                    event.step, event.checkpoint_dir
                )
            except Exception as e:  # noqa: BLE001
                logger.error(
                    "persist of step %s failed: %s", event.step, e
                )

    # -- persist -----------------------------------------------------------
    def _stage_dir(self, root: str, step: int) -> str:
        return os.path.join(
            root,
            CheckpointConstant.STAGE_DIR,
            f"{CheckpointConstant.CKPT_DIR_PREFIX}{step}",
        )

    def _final_dir(self, root: str, step: int) -> str:
        return os.path.join(
            root, f"{CheckpointConstant.CKPT_DIR_PREFIX}{step}"
        )

    def save_step_checkpoint(self, step: int, root: Optional[str] = None,
                             commit_timeout: Optional[float] = None):
        """Persist all local shm shards of ``step`` and commit.

        A shard whose shm snapshot is at a different step makes the
        whole save fail — persisting a mixed-step checkpoint would
        silently corrupt a later restore.  ``commit_timeout`` bounds
        the node-0 done-file wait (None = SAVE_TIMEOUT): emergency
        flushes pass a small bound because under preemption the PEER
        node may never write its done file — a 600 s poll there would
        wedge the survivor's restart path behind a commit that cannot
        happen."""
        from dlrover_tpu_torch.observability.events import anchored_now

        t0_mono = time.monotonic()
        t0_wall = anchored_now(t0_mono)
        root = root or self.config.checkpoint_dir
        stage = self._stage_dir(root, step)
        self._storage.safe_makedirs(stage)
        ok = True
        persisted_bytes = 0
        io_seconds = 0.0  # pure dump time: lock waits excluded
        for local_rank, handler in enumerate(self._shm_handlers):
            global_rank = self._global_rank(local_rank)
            lock = self._locks[local_rank]
            acquired = lock.acquire(timeout=60)
            if not acquired:
                # a trainer mid-snapshot holds the lock; persisting
                # without it could write a torn buffer
                logger.error(
                    "shard %s: lock not acquired; aborting this save",
                    global_rank,
                )
                ok = False
                continue
            try:
                if step not in handler.steps_available():
                    logger.error(
                        "shm shard %s holds steps %s, wanted %s; "
                        "aborting this save",
                        global_rank, handler.steps_available(), step,
                    )
                    ok = False
                    continue
                path = os.path.join(
                    stage, f"shard_{global_rank}.drckpt"
                )
                t_io = time.monotonic()
                nbytes = handler.dump_to_file(
                    path, self._storage, step=step
                )
                if nbytes is None:
                    ok = False
                else:
                    persisted_bytes += nbytes
                    io_seconds += time.monotonic() - t_io
            finally:
                lock.release()
        if not ok:
            logger.error("step %s: some shards failed to persist", step)
            return False
        # persist-side data-plane visibility: the streamed
        # shm->storage write as a checkpoint_save span (async in the
        # agent, so overlapping train steps still charge the step in
        # the ledger) plus throughput gauges.  Span duration is full
        # wall (ledger input); throughput_gbps is computed from PURE
        # dump time so a trainer holding a shard lock for 50 s cannot
        # make a healthy storage write look like a bandwidth
        # regression.
        from dlrover_tpu_torch.common.parallel_io import throughput_gbps
        from dlrover_tpu_torch.observability.events import get_event_logger
        from dlrover_tpu_torch.observability.metrics import record_ckpt_io

        persist_dur = time.monotonic() - t0_mono
        get_event_logger().complete(
            "checkpoint_save",
            t0_wall,
            persist_dur,
            step=step,
            bytes=persisted_bytes,
            throughput_gbps=throughput_gbps(
                persisted_bytes, io_seconds
            ),
            stage="persist",
        )
        record_ckpt_io("persist", persisted_bytes, io_seconds)
        self._write_done_file(stage)
        if self.config.node_rank == 0:
            committed = self.commit_checkpoint(
                step, root,
                timeout=(
                    commit_timeout
                    if commit_timeout is not None
                    else CheckpointConstant.SAVE_TIMEOUT
                ),
            )
            if committed:
                self._latest_persisted_step = step
            return committed
        self._latest_persisted_step = step
        return True

    def _write_done_file(self, stage: str):
        self._storage.write(
            str(self.config.local_shard_num),
            os.path.join(stage, f"done_{self.config.node_rank}"),
        )

    def commit_checkpoint(self, step: int, root: str,
                          timeout: float = CheckpointConstant.SAVE_TIMEOUT) -> bool:
        """Node-rank-0: wait for all nodes' done files, then atomically
        publish the stage dir and update the tracker file."""
        stage = self._stage_dir(root, step)
        node_num = max(
            1,
            self.config.global_shard_num
            // max(self.config.local_shard_num, 1),
        )
        deadline = time.time() + timeout
        while time.time() < deadline:
            done = [
                f
                for f in self._storage.listdir(stage)
                if f.startswith("done_")
            ]
            if len(done) >= node_num:
                final = self._final_dir(root, step)
                for f in done:
                    self._storage.safe_remove(os.path.join(stage, f))
                # re-saving an existing step replaces it: safe_move
                # no-ops when the destination exists, which would
                # silently discard the fresh shards
                if self._storage.exists(final):
                    self._storage.safe_rmtree(final)
                self._storage.safe_move(stage, final)
                self._storage.write(
                    str(step),
                    os.path.join(
                        root, CheckpointConstant.TRACKER_FILE
                    ),
                )
                logger.info("checkpoint step %s committed -> %s",
                            step, final)
                return True
            time.sleep(0.2)
        logger.error("commit of step %s timed out", step)
        return False

    def max_common_step(self) -> int:
        """Newest step present in EVERY local shard's shm (what an
        emergency flush would persist), or -1.  The agent's graceful
        drain polls this to learn when the workers' drain-mode
        snapshots have landed."""
        step_sets = [
            set(h.steps_available()) for h in self._shm_handlers
        ]
        if not step_sets or not all(step_sets):
            return -1
        common = set.intersection(*step_sets)
        return max(common) if common else -1

    def save_shm_to_storage(self, reason: str = ""):
        """Emergency flush: persist whatever valid snapshot sits in shm
        (called on SIGTERM / worker failure; reference ``:473-495``).

        Picks the NEWEST step available in every local shard's shm —
        with double-buffered slots a kill that tore the shards (one at
        N+1, one at N) still flushes a complete step N instead of
        aborting on the mismatch."""
        # chaos hook: a kill pinned here dies with the emergency flush
        # half done — the shm snapshot (crash-survivable segment) and
        # the storage tier's atomic rename must both tolerate it
        from dlrover_tpu_torch.common.fault_injection import maybe_crash

        maybe_crash("mid_checkpoint_persist")
        step_sets = [set(h.steps_available()) for h in self._shm_handlers]
        if not step_sets or not all(step_sets):
            logger.info("no shm checkpoint to flush (%s)", reason)
            return False
        common = set.intersection(*step_sets)
        if not common:
            logger.error(
                "no step common to all %d shards (%s); nothing flushed",
                len(step_sets), [sorted(s) for s in step_sets],
            )
            return False
        step = max(common)
        if step <= self._latest_persisted_step:
            logger.info(
                "shm step %s already persisted; skip flush", step
            )
            return True
        logger.info(
            "emergency-flushing shm checkpoint step %s (%s)",
            step, reason,
        )
        from dlrover_tpu_torch.common.env import env_float

        # bounded commit: under preemption the peer node may never
        # write its done file; the shards themselves are persisted
        # either way, and a restart must not stall behind the poll
        return self.save_step_checkpoint(
            step,
            commit_timeout=env_float(
                "DLROVER_TPU_EMERGENCY_COMMIT_TIMEOUT_S", 20.0
            ),
        )

    #: whether the atexit fallback flush is armed (non-main-thread
    #: embedders that could not install the SIGTERM hook)
    _atexit_registered = False

    @classmethod
    def register_signal_handlers(cls):
        """Install the SIGTERM flush hook.  Must run on the MAIN thread
        (``signal.signal`` raises ValueError elsewhere) — the factory
        thread therefore never calls this; the agent does, once, before
        starting the factory."""

        def _on_term(signum, frame):  # pragma: no cover - signal path
            saver = cls._instance
            if saver is not None:
                saver.save_shm_to_storage(reason=f"signal {signum}")
            raise SystemExit(128 + signum)

        signal.signal(signal.SIGTERM, _on_term)

    @classmethod
    def _atexit_flush(cls):
        """Fallback crash-snapshot flush for embedders that could not
        install the SIGTERM hook: runs at interpreter shutdown, so a
        clean SystemExit (including the one a SIGTERM's default
        handler does NOT produce, but an embedder's catch-and-exit
        does) still lands the last shm snapshot in storage."""
        saver = cls._instance
        if saver is not None and not saver._stopped:
            try:
                saver.save_shm_to_storage(reason="atexit fallback")
            except Exception as e:  # noqa: BLE001 - shutdown path
                logger.warning("atexit ckpt flush failed: %s", e)

    @classmethod
    def register_atexit_fallback(cls):
        """Arm the atexit fallback flush + warning metric.  Called
        when ``register_signal_handlers`` failed (not on the main
        thread): embedded/test callers still get the crash snapshot
        on any orderly interpreter exit, and the metric flags that
        TRUE kill-signal coverage is missing."""
        import atexit

        if cls._atexit_registered:
            return
        cls._atexit_registered = True
        atexit.register(cls._atexit_flush)
        try:
            from dlrover_tpu_torch.observability.metrics import get_registry

            get_registry().inc_counter(
                "dlrover_tpu_ckpt_sigterm_fallback"
            )
        except Exception:  # noqa: BLE001 - metrics never break startup
            pass

    # -- factory (class-level) ---------------------------------------------
    @classmethod
    def start_async_saving_ckpt(cls, install_signal_handlers: bool = True):
        """Run the factory thread: training processes push SaverConfig
        onto the factory queue; the agent builds the saver lazily
        (reference ``:411-434``)."""
        if install_signal_handlers:
            try:
                cls.register_signal_handlers()
            except ValueError:
                # embedded/test caller off the main thread: a SIGTERM
                # will not flush, but an orderly interpreter exit
                # still can — arm the atexit fallback instead of
                # silently dropping crash-snapshot coverage
                logger.warning(
                    "not on main thread: SIGTERM flush hook not "
                    "installed; registering atexit fallback flush"
                )
                cls.register_atexit_fallback()
        factory_queue = SharedQueue(FACTORY_QUEUE, create=True)

        def _factory_loop():
            while True:
                try:
                    config: SaverConfig = factory_queue.get(timeout=2)
                except queue.Empty:
                    continue
                except Exception:  # queue closed
                    return
                if cls._instance is not None:
                    logger.info("ckpt saver already exists; skip")
                    continue
                saver = cls(config)
                saver.start()
                cls._instance = saver
                logger.info("ckpt saver created from factory event")

        cls._factory_thread = threading.Thread(
            target=_factory_loop, name="ckpt-factory", daemon=True
        )
        cls._factory_thread.start()
        return factory_queue

    @classmethod
    def get_ckpt_saver(cls) -> Optional["AsyncCheckpointSaver"]:
        return cls._instance

    @classmethod
    def reset(cls):
        if cls._instance is not None:
            cls._instance.close()
            cls._instance = None


def find_latest_checkpoint(root: str, storage=None) -> Optional[str]:
    """Resolve the newest committed checkpoint dir via the tracker."""
    storage = storage or get_checkpoint_storage(path=root)
    tracker = os.path.join(root, CheckpointConstant.TRACKER_FILE)
    content = storage.read(tracker)
    if content:
        step = content.strip()
        path = os.path.join(
            root, f"{CheckpointConstant.CKPT_DIR_PREFIX}{step}"
        )
        if storage.exists(path):
            return path
    # fall back to scanning
    candidates = []
    for entry in storage.listdir(root):
        if entry.startswith(CheckpointConstant.CKPT_DIR_PREFIX):
            try:
                candidates.append(
                    int(entry[len(CheckpointConstant.CKPT_DIR_PREFIX):])
                )
            except ValueError:
                continue
    if not candidates:
        return None
    return os.path.join(
        root,
        f"{CheckpointConstant.CKPT_DIR_PREFIX}{max(candidates)}",
    )
