"""Per-dataset shard bookkeeping: todo/doing queues with recovery.

Copy of ``dlrover_tpu/master/shard/dataset_manager.py``.

Reference parity: ``dlrover/python/master/shard/batch_dataset_manager.py``
(+ the streaming variant).  The doubt-shard recovery protocol: a shard
moves todo -> doing on dispatch; if the worker dies or times out the
shard goes back to todo, so no sample is lost across elasticity events.
"""

import time
from abc import ABCMeta, abstractmethod
from typing import Dict, List, Optional, Tuple

from dlrover_tpu_torch.common.log import default_logger as logger
from dlrover_tpu_torch.common.messages import Task, TaskType
from dlrover_tpu_torch.master.shard.dataset_splitter import DatasetSplitter


class DoingTask:
    def __init__(self, task: Task, node_id: int, start_time: float):
        self.task = task
        self.node_id = node_id
        self.start_time = start_time


class DatasetManager(metaclass=ABCMeta):
    def __init__(self, task_type: str, batch_size: int,
                 splitter: DatasetSplitter):
        self._task_type = task_type
        self._batch_size = batch_size
        self._splitter = splitter
        self.todo: List[Task] = []
        self.doing: Dict[int, DoingTask] = {}

    @abstractmethod
    def get_task(self, node_id: int) -> Task:
        ...

    @abstractmethod
    def completed(self) -> bool:
        ...

    def get_epoch(self) -> int:
        return self._splitter.epoch


class BatchDatasetManager(DatasetManager):
    def __init__(self, task_type: str, batch_size: int,
                 splitter: DatasetSplitter):
        super().__init__(task_type, batch_size, splitter)
        self._task_id = 0
        self._completed_step = 0
        self._max_task_completed_time = 0.0
        #: bumped whenever the splitter produced a new todo batch —
        #: the failover journal records full state exactly then (the
        #: splitter position moved), and O(1) deltas otherwise
        self.refill_count = 0

    def get_task(self, node_id: int) -> Task:
        """Pop the next todo task; WAIT if dispatching is exhausted but
        the epoch may still produce more shards."""
        if not self.todo and not self._splitter.epoch_finished():
            self._create_tasks()
        if self.todo:
            task = self.todo.pop(0)
            self.doing[task.task_id] = DoingTask(
                task, node_id, time.time()
            )
            return task
        if not self.completed():
            return Task(task_id=-1, task_type=TaskType.WAIT)
        return Task()

    def _create_tasks(self):
        self.refill_count += 1
        self._splitter.create_shards()
        for shard in self._splitter.get_shards():
            task = Task(
                task_id=self._task_id,
                task_type=self._task_type,
                shard=shard,
            )
            self._task_id += 1
            self.todo.append(task)

    def report_task_status(self, task_id: int, success: bool) -> Tuple[bool, Optional[DoingTask]]:
        doing_task = self.doing.pop(task_id, None)
        if doing_task is None:
            logger.warning("unknown task %s reported", task_id)
            return False, None
        if not success:
            logger.warning(
                "task %s failed on node %s; recovering",
                task_id,
                doing_task.node_id,
            )
            self.todo.insert(0, doing_task.task)
            return False, doing_task
        elapsed = time.time() - doing_task.start_time
        self._max_task_completed_time = max(
            self._max_task_completed_time, elapsed
        )
        if doing_task.task.task_type == TaskType.TRAINING:
            shard = doing_task.task.shard
            self._completed_step += (
                (shard.end - shard.start) // max(self._batch_size, 1)
            )
        return True, doing_task

    def recover_task(self, task: Task):
        """Put a dispatched-but-unfinished task back (dead worker)."""
        if task.task_id in self.doing:
            del self.doing[task.task_id]
        self.todo.insert(0, task)

    def recover_tasks_of_node(self, node_id: int):
        for task_id in [
            tid
            for tid, dt in self.doing.items()
            if dt.node_id == node_id
        ]:
            doing = self.doing.pop(task_id)
            self.todo.insert(0, doing.task)
            logger.info(
                "recover task %s of dead node %s", task_id, node_id
            )

    def get_timeout_tasks(self, timeout: float) -> List[int]:
        now = time.time()
        return [
            tid
            for tid, dt in self.doing.items()
            if now - dt.start_time > timeout
        ]

    def completed(self) -> bool:
        return (
            self._splitter.epoch_finished()
            and not self.todo
            and not self.doing
        )

    def checkpoint(self) -> str:
        import json

        # doubt shards: both todo and doing go back to todo on restore;
        # the full shard is kept (name for streaming partitions,
        # record_indices for shuffled text datasets)
        def _shard(s):
            return [s.name, s.start, s.end, s.record_indices]

        todo_shards = [
            _shard(t.task.shard) for t in self.doing.values()
        ] + [_shard(t.shard) for t in self.todo]
        return json.dumps(
            {
                "todo": todo_shards,
                "splitter": self._splitter.checkpoint(),
                "task_id": self._task_id,
            }
        )

    def restore_checkpoint(self, checkpoint: str):
        import json

        from dlrover_tpu_torch.common.messages import DataShard

        state = json.loads(checkpoint)
        self._splitter.restore_checkpoint(state["splitter"])
        self._task_id = state.get("task_id", 0)
        self.todo.clear()
        self.doing.clear()
        for name, lo, hi, indices in state["todo"]:
            self.todo.append(
                Task(
                    task_id=self._task_id,
                    task_type=self._task_type,
                    shard=DataShard(name, lo, hi,
                                    record_indices=indices),
                )
            )
            self._task_id += 1

    def apply_done_for_replay(
        self, shard_key, epoch: int, completed_step: int
    ):
        """Replay one journaled successful ack: remove the todo task
        whose shard matches ``shard_key`` (``[name, start, end]`` —
        stable across the task-id renumbering ``restore_checkpoint``
        performs) and adopt the recorded progress.  ``epoch`` guards
        the snapshot race: ranges recur every epoch, so a stale delta
        racing a newer-epoch snapshot must not eat the new epoch's
        shard.  Idempotent — a delta the snapshot already folded in
        finds no match and ``max`` keeps the newer step."""
        name, lo, hi = shard_key
        if epoch == self._splitter.epoch:
            for i, task in enumerate(self.todo):
                s = task.shard
                if (s.name, s.start, s.end) == (name, lo, hi):
                    del self.todo[i]
                    break
        self._completed_step = max(
            self._completed_step, int(completed_step)
        )

    @property
    def completed_step(self) -> int:
        return self._completed_step
