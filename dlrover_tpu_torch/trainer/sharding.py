"""Worker-side dynamic data sharding client.

Copy of ``dlrover_tpu/trainer/sharding.py``.

Reference parity: ``dlrover/python/elastic_agent/sharding/client.py:29``
(``ShardingClient``: fetch_shard / report_batch_done against the
master's TaskManager, with a local task queue) and ``:234``
(``IndexShardingClient``: per-sample index mode).  Dead workers' shards
are recovered master-side (``TaskRescheduleCallback``), so a dataset is
consumed exactly once per epoch across an elastic worker set.
"""

import threading
import time
from collections import deque
from concurrent.futures import Future, ThreadPoolExecutor
from typing import Callable, Iterator, Optional

from dlrover_tpu_torch.agent.master_client import (
    MasterClient,
    _pace_longpoll,
)
from dlrover_tpu_torch.common.env import (
    control_longpoll_enabled,
    input_pipeline_enabled,
)
from dlrover_tpu_torch.common.log import default_logger as logger
from dlrover_tpu_torch.common.messages import DataShard, Task, TaskType


class ShardingClient:
    """Fetches data-shard tasks from the master and acknowledges them.

    With the input pipeline enabled (``DLROVER_TPU_INPUT_PIPELINE``,
    default on; also ``prefetch_tasks=``), the *next* shard task is
    requested from the master in the background the moment the current
    one is handed out — consuming a shard completely hides the
    ``get_task`` RPC round trip.  A prefetched-but-never-consumed task
    is recovered master-side by the ordinary timeout/dead-worker
    requeue, same as a shard in flight at a worker crash.
    """

    def __init__(
        self,
        dataset_name: str,
        batch_size: int,
        num_epochs: int = 1,
        dataset_size: int = 0,
        shuffle: bool = False,
        num_minibatches_per_shard: int = 2,
        client: Optional[MasterClient] = None,
        storage_type: str = "table",
        prefetch_tasks: Optional[bool] = None,
    ):
        self._client = client or MasterClient.singleton_instance()
        self._dataset_name = dataset_name
        self._batch_size = batch_size
        self._pending: deque = deque()
        self._lock = threading.Lock()
        self._prefetch_enabled = (
            input_pipeline_enabled()
            if prefetch_tasks is None
            else bool(prefetch_tasks)
        )
        self._prefetched: Optional[Future] = None
        self._rpc_pool: Optional[ThreadPoolExecutor] = None
        if dataset_size > 0:
            self._client.report_dataset_shard_params(
                dataset_name=dataset_name,
                dataset_size=dataset_size,
                batch_size=batch_size,
                num_epochs=num_epochs,
                shuffle=shuffle,
                num_minibatches_per_shard=num_minibatches_per_shard,
                storage_type=storage_type,
            )

    @property
    def dataset_name(self) -> str:
        return self._dataset_name

    def _next_task(self) -> Task:
        """One ``get_task`` RPC — prefetched result when available."""
        if self._prefetched is not None:
            fut, self._prefetched = self._prefetched, None
            return fut.result()
        return self._client.get_task(self._dataset_name)

    def _kick_prefetch(self):
        """Request the NEXT task in the background so the RPC overlaps
        the consumption of the shard just handed out."""
        if not self._prefetch_enabled or self._prefetched is not None:
            return
        if self._rpc_pool is None:
            self._rpc_pool = ThreadPoolExecutor(
                max_workers=1, thread_name_prefix="shard-prefetch"
            )
        self._prefetched = self._rpc_pool.submit(
            self._client.get_task, self._dataset_name
        )

    def fetch_shard(self, wait_interval: float = 2.0) -> Optional[DataShard]:
        """Next shard, or None when the dataset is exhausted.  Blocks
        through WAIT tasks (dataset not fully dispatched yet) — under
        long-poll the master parks the RPC until a task is
        dispatchable, so waiting out a starved dispatch queue costs
        ~1 RPC instead of one every ``wait_interval``."""
        longpoll = control_longpoll_enabled()
        while True:
            task: Task = self._next_task()
            if task.task_type == TaskType.WAIT:
                if longpoll:
                    t0 = time.monotonic()
                    task = self._client.get_task(
                        self._dataset_name, wait_timeout=30.0
                    )
                    if task.task_type == TaskType.WAIT:
                        # a saturated master answers WAIT immediately
                        # instead of parking; _pace_longpoll's shared
                        # policy keeps the retry at the 10 Hz fallback
                        _pace_longpoll(30.0, time.monotonic() - t0)
                        continue
                else:
                    time.sleep(wait_interval)
                    continue
            if task.is_empty:
                return None
            with self._lock:
                self._pending.append(task)
            self._kick_prefetch()
            return task.shard

    def report_batch_done(self, task_ids=None) -> bool:
        """Ack the oldest pending task (or specific ids)."""
        with self._lock:
            if not self._pending:
                return False
            if task_ids:
                done = [t for t in self._pending if t.task_id in task_ids]
                for t in done:
                    self._pending.remove(t)
            else:
                done = [self._pending.popleft()]
        ok = True
        for t in done:
            ok = self._client.report_task_result(
                self._dataset_name, t.task_id
            ) and ok
        return ok

    def report_task_failed(self, task_id: int, err: str) -> bool:
        with self._lock:
            self._pending = deque(
                t for t in self._pending if t.task_id != task_id
            )
        return self._client.report_task_result(
            self._dataset_name, task_id, err_message=err or "failed"
        )

    def iter_shards(self) -> Iterator[DataShard]:
        while True:
            shard = self.fetch_shard()
            if shard is None:
                return
            yield shard

    # ---------------------------------------------------------- checkpoint
    def get_shard_checkpoint(self) -> str:
        ckpt = self._client.get_shard_checkpoint(self._dataset_name)
        return ckpt.content if ckpt else ""

    def restore_shard_checkpoint(self, content: str) -> bool:
        return self._client.report_shard_checkpoint(
            self._dataset_name, content
        )


class IndexShardingClient(ShardingClient):
    """Per-sample index stream on top of shard tasks (reference
    ``IndexShardingClient`` ``sharding/client.py:234``); backs map-style
    datasets: every ``batch_size`` consumed indices auto-acks a batch."""

    def __init__(self, *args, **kwargs):
        super().__init__(*args, **kwargs)
        self._indices: deque = deque()
        self._consumed_in_batch = 0

    def fetch_sample_index(self) -> Optional[int]:
        if not self._indices:
            shard = self.fetch_shard()
            if shard is None:
                return None
            if shard.record_indices:
                self._indices.extend(shard.record_indices)
            else:
                self._indices.extend(range(shard.start, shard.end))
        return self._indices.popleft()

    def report_sample_consumed(self):
        self._consumed_in_batch += 1
        if self._consumed_in_batch >= self._batch_size:
            self._consumed_in_batch = 0
            self.report_batch_done()


class ElasticShardDataset:
    """Map-style dataset over master-dispatched indices.

    Reference parity: ``atorch/atorch/data/elastic_dataset.py:19``
    (``ElasticDataset`` reads samples by dynamically-dispatched index).
    """

    def __init__(
        self,
        read_sample: Callable[[int], object],
        sharding_client: IndexShardingClient,
    ):
        self._read_sample = read_sample
        self._client = sharding_client

    def __iter__(self):
        while True:
            index = self._client.fetch_sample_index()
            if index is None:
                return
            yield self._read_sample(index)
            self._client.report_sample_consumed()
