"""Master-side dynamic data sharding service.

Copy of ``dlrover_tpu/master/shard/task_manager.py``.

Reference parity: ``dlrover/python/master/shard/task_manager.py:37,94,
126,169`` — dispatches shards to workers on demand, recovers shards of
dead workers, re-queues timed-out shards via a watcher thread, and
checkpoints/restores splitter + queue state.
"""

import dataclasses
import threading
import time
from typing import Callable, Dict, Optional

from dlrover_tpu_torch.common.global_context import Context
from dlrover_tpu_torch.common.log import default_logger as logger
from dlrover_tpu_torch.common.messages import (
    DatasetShardParams,
    ShardCheckpoint,
    Task,
    TaskType,
)
from dlrover_tpu_torch.master.shard.dataset_manager import BatchDatasetManager
from dlrover_tpu_torch.master.shard.dataset_splitter import new_dataset_splitter

_ctx = Context.singleton_instance()


class TaskManager:
    #: long-poll wake slice: task availability is mostly event-driven
    #: (new dataset / task ack / recovery all notify) but the timeout
    #: watcher requeues on its own clock, so parked waiters re-check
    WAIT_SLICE_S = 0.5

    def __init__(self, worker_restart_timeout: float = 0.0,
                 speed_monitor=None, check_interval: float = 30.0):
        # a Condition IS a lock for ``with`` purposes; mutations that
        # can turn a WAIT answer into a real task notify long-pollers
        self._lock = threading.Condition()
        self._worker_restart_timeout = worker_restart_timeout
        self._datasets: Dict[str, BatchDatasetManager] = {}
        self._speed_monitor = speed_monitor
        self._task_timeout = _ctx.seconds_to_timeout_task
        self._check_interval = check_interval
        self._stopped = threading.Event()
        self._watcher: Optional[threading.Thread] = None
        self._worker_client_hosts: Dict[int, str] = {}
        #: creation params per dataset, kept so a restarted master can
        #: recreate the splitter before restoring its checkpoint
        self._dataset_params: Dict[str, DatasetShardParams] = {}
        #: failover journal hook: ``cb(op, args)``.  Full-state
        #: records ("dataset": splitter position + todo, with doing
        #: FOLDED INTO todo) go out only on the RARE mutations —
        #: creation, splitter refill, client checkpoint restore; a
        #: successful ack journals an O(1) "done" delta instead.
        #: Dispatches, failures, timeouts and dead-node recovery
        #: journal NOTHING: none of them change the durable view —
        #: an unjournaled lease is still in the durable todo, so
        #: replay re-queues it exactly like the timeout requeue path.
        #: (Journaling the full checkpoint per dispatch/ack was
        #: O(shards²) per epoch through the bounded write-behind
        #: queue, stalling the control plane under its own locks.)
        self._journal_cb: Optional[Callable[[str, dict], None]] = None

    def set_journal(self, cb: Optional[Callable[[str, dict], None]]):
        with self._lock:
            self._journal_cb = cb

    def _journal_dataset_locked(self, name: str):
        """Caller holds the lock."""
        if self._journal_cb is None:
            return
        dataset = self._datasets.get(name)
        params = self._dataset_params.get(name)
        if dataset is None or params is None:
            return
        try:
            self._journal_cb(
                "dataset",
                {
                    "name": name,
                    "params": dataclasses.asdict(params),
                    "ckpt": dataset.checkpoint(),
                },
            )
        except Exception as e:  # noqa: BLE001
            logger.warning("task journal failed: %s", e)

    def new_dataset(self, params: DatasetShardParams):
        with self._lock:
            if params.dataset_name in self._datasets:
                return
            shard_size = params.batch_size * params.num_minibatches_per_shard
            splitter = new_dataset_splitter(
                params.shuffle,
                shard_size,
                params.dataset_size,
                params.num_epochs,
                params.dataset_name,
                params.storage_type,
            )
            self._datasets[params.dataset_name] = BatchDatasetManager(
                params.task_type, params.batch_size, splitter
            )
            self._dataset_params[params.dataset_name] = params
            self._journal_dataset_locked(params.dataset_name)
            self._lock.notify_all()
            logger.info(
                "created dataset %s: size=%s shard=%s epochs=%s",
                params.dataset_name,
                params.dataset_size,
                shard_size,
                params.num_epochs,
            )

    def get_dataset(self, name: str) -> Optional[BatchDatasetManager]:
        return self._datasets.get(name)

    def get_task(self, node_id: int, dataset_name: str) -> Task:
        with self._lock:
            dataset = self._datasets.get(dataset_name)
            if dataset is None:
                return Task()
            refills = dataset.refill_count
            task = dataset.get_task(node_id)
            if dataset.refill_count != refills:
                # the splitter produced a new todo batch (epoch roll):
                # journal the full state — O(shards) once per epoch.
                # A plain dispatch journals nothing: the durable view
                # keeps the shard in todo, so a crash re-queues the
                # unacked lease exactly like the timeout path.
                self._journal_dataset_locked(dataset_name)
            return task

    def report_task_status(self, dataset_name: str, task_id: int,
                           success: bool):
        with self._lock:
            dataset = self._datasets.get(dataset_name)
            if dataset is None:
                return False
            ok, doing = dataset.report_task_status(task_id, success)
            if ok and success and doing is not None:
                # O(1) "done" delta: the shard left the system for
                # good.  A FAILED ack journals nothing — the shard
                # never left the durable todo (dispatches aren't
                # journaled), only its in-memory position moved.
                shard = doing.task.shard
                self._journal_delta_locked(
                    "done",
                    {
                        "name": dataset_name,
                        "shard": [shard.name, shard.start, shard.end],
                        "epoch": dataset.get_epoch(),
                        "step": dataset.completed_step,
                    },
                )
            # a failure requeues the shard and an ack can turn a
            # parked WAIT long-poller's answer into a real task
            self._lock.notify_all()
            return ok

    def _journal_delta_locked(self, op: str, args: dict):
        """Caller holds the lock."""
        if self._journal_cb is None:
            return
        try:
            self._journal_cb(op, args)
        except Exception as e:  # noqa: BLE001
            logger.warning("task journal failed: %s", e)

    def recover_tasks(self, node_id: int):
        """Recover all doing shards of a dead worker (reference ``:169``).

        Not journaled: the move is doing -> todo, and the durable view
        (which never saw the dispatch) already has the shard in todo."""
        with self._lock:
            for dataset in self._datasets.values():
                dataset.recover_tasks_of_node(node_id)
            self._lock.notify_all()

    def wait_task(self, node_id: int, dataset_name: str,
                  wait_timeout: float = 0.0) -> Task:
        """Long-poll ``get_task``: while the dataset would only hand
        out WAIT tasks, park on the condition (woken by acks/failures/
        recovery) up to ``wait_timeout`` — the WAIT answer then still
        goes out, so the client's loop semantics are unchanged."""
        deadline = time.monotonic() + max(wait_timeout, 0.0)
        while True:
            task = self.get_task(node_id, dataset_name)
            if task.task_type != TaskType.WAIT:
                return task
            remaining = deadline - time.monotonic()
            if remaining <= 0:
                return task
            with self._lock:
                self._lock.wait(min(remaining, self.WAIT_SLICE_S))

    def wait_training_started(self, wait_timeout: float = 0.0) -> bool:
        """Long-poll ``training_started``: block until the first
        dataset registration flips it (or the timeout elapses)."""
        deadline = time.monotonic() + max(wait_timeout, 0.0)
        with self._lock:
            while not self._datasets:
                remaining = deadline - time.monotonic()
                if remaining <= 0:
                    return False
                self._lock.wait(min(remaining, self.WAIT_SLICE_S))
            return True

    def finished(self) -> bool:
        with self._lock:
            if not self._datasets:
                return False
            return all(d.completed() for d in self._datasets.values())

    def training_started(self) -> bool:
        return bool(self._datasets)

    def row_counts(self) -> int:
        """Live shard bookkeeping rows (todo + in-flight leases over
        every dataset) — the self-telemetry state-growth gauge's
        cheap accessor (``export_state`` would serialize every
        shard)."""
        with self._lock:
            return sum(
                len(d.todo) + len(d.doing)
                for d in self._datasets.values()
            )

    def get_dataset_checkpoint(self, dataset_name: str) -> Optional[ShardCheckpoint]:
        with self._lock:
            dataset = self._datasets.get(dataset_name)
            if dataset is None:
                return None
            return ShardCheckpoint(
                dataset_name=dataset_name, content=dataset.checkpoint()
            )

    def restore_dataset_from_checkpoint(self, ckpt: ShardCheckpoint) -> bool:
        with self._lock:
            dataset = self._datasets.get(ckpt.dataset_name)
            if dataset is None:
                return False
            dataset.restore_checkpoint(ckpt.content)
            self._journal_dataset_locked(ckpt.dataset_name)
            self._lock.notify_all()
            return True

    # --------------------------------------------- failover replay
    def export_state(self) -> dict:
        """JSON-safe full state for the compacted snapshot (doing
        leases fold into todo via ``BatchDatasetManager.checkpoint``)."""
        with self._lock:
            return {
                "datasets": {
                    name: {
                        "params": dataclasses.asdict(
                            self._dataset_params[name]
                        ),
                        "ckpt": dataset.checkpoint(),
                    }
                    for name, dataset in self._datasets.items()
                    if name in self._dataset_params
                }
            }

    def restore_state(self, state: dict):
        """Install snapshotted datasets (replay path — not
        re-journaled): recreate each splitter from its params, then
        restore the lease checkpoint.  In-flight (doing) shards come
        back at the FRONT of todo — the unacked leases are re-queued
        exactly as the timeout watcher would have."""
        datasets = state.get("datasets") or {}
        with self._lock:
            cb, self._journal_cb = self._journal_cb, None
            try:
                for name, entry in datasets.items():
                    params = DatasetShardParams(
                        **(entry.get("params") or {})
                    )
                    if name not in self._datasets:
                        shard_size = (
                            params.batch_size
                            * params.num_minibatches_per_shard
                        )
                        splitter = new_dataset_splitter(
                            params.shuffle,
                            shard_size,
                            params.dataset_size,
                            params.num_epochs,
                            params.dataset_name,
                            params.storage_type,
                        )
                        self._datasets[name] = BatchDatasetManager(
                            params.task_type,
                            params.batch_size,
                            splitter,
                        )
                        self._dataset_params[name] = params
                    if entry.get("ckpt"):
                        self._datasets[name].restore_checkpoint(
                            entry["ckpt"]
                        )
            finally:
                self._journal_cb = cb
            self._lock.notify_all()

    def apply_journal_op(self, op: str, args: dict):
        """Re-apply one journaled mutation (replay path)."""
        if op == "dataset":
            self.restore_state(
                {"datasets": {args.get("name", ""): args}}
            )
        elif op == "done":
            with self._lock:
                dataset = self._datasets.get(args.get("name", ""))
                if dataset is not None:
                    dataset.apply_done_for_replay(
                        args.get("shard") or ["", -1, -1],
                        int(args.get("epoch", -1)),
                        int(args.get("step", 0)),
                    )

    def start(self):
        self._watcher = threading.Thread(
            target=self._check_timeout_tasks,
            name="task-timeout-watcher",
            daemon=True,
        )
        self._watcher.start()

    def stop(self):
        self._stopped.set()

    def _check_timeout_tasks(self):
        # Event.wait instead of time.sleep so stop() interrupts the
        # 30 s pause immediately — master shutdown is prompt
        while not self._stopped.is_set():
            with self._lock:
                for dataset in self._datasets.values():
                    for task_id in dataset.get_timeout_tasks(
                        self._task_timeout
                    ):
                        doing = dataset.doing.get(task_id)
                        if doing:
                            logger.warning(
                                "task %s timed out on node %s; re-queue",
                                task_id,
                                doing.node_id,
                            )
                            # doing -> todo: already todo in the
                            # durable view, nothing to journal
                            dataset.recover_task(doing.task)
                            self._lock.notify_all()
            self._stopped.wait(self._check_interval)
