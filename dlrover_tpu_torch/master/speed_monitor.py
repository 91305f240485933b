"""Training-speed monitor: global-step samples -> steps/sec, hang and
straggler signals.

Copy of ``dlrover_tpu/master/speed_monitor.py``.

Reference parity: ``dlrover/python/master/monitor/speed_monitor.py:43,
81,113``.
"""

import threading
import time
from typing import Dict, List, Optional, Set, Tuple

from dlrover_tpu_torch.common.global_context import Context

_ctx = Context.singleton_instance()


class GlobalStepRecord:
    def __init__(self, global_step: int, timestamp: float, worker_num: int):
        self.global_step = global_step
        self.timestamp = timestamp
        self.worker_num = worker_num


class SpeedMonitor:
    def __init__(self, record_num: Optional[int] = None):
        self._lock = threading.Lock()
        self._max_record_count = record_num or _ctx.train_speed_record_num
        self._global_step_records: List[GlobalStepRecord] = []
        self._workers: Set[Tuple[str, int]] = set()
        self._global_step = 0
        self._target_worker_num = 0
        self._init_time = time.time()
        self._start_training_time = 0.0

    def set_target_worker_num(self, worker_num: int):
        self._target_worker_num = worker_num

    def reduce_target_worker_num(self, workers):
        with self._lock:
            removed = sum(1 for w in workers if w in self._workers)
            self._target_worker_num = max(
                self._target_worker_num - removed, 0
            )

    def add_running_worker(self, node_type: str, worker_id: int):
        with self._lock:
            self._workers.add((node_type, worker_id))

    def remove_running_worker(self, node_type: str, worker_id: int):
        with self._lock:
            self._workers.discard((node_type, worker_id))

    @property
    def running_workers(self):
        return self._workers

    def set_start_timestamp(self):
        if self._global_step == 0 and not self._global_step_records:
            self._start_training_time = time.time()

    def collect_global_step(self, global_step: int, timestamp: float):
        with self._lock:
            if not self._start_training_time:
                self._start_training_time = time.time()
            self._global_step = global_step
            self._global_step_records.append(
                GlobalStepRecord(
                    global_step, timestamp, len(self._workers)
                )
            )
            if len(self._global_step_records) > self._max_record_count:
                self._global_step_records.pop(0)

    @property
    def completed_global_step(self) -> int:
        return self._global_step

    @property
    def start_training_time(self) -> float:
        return self._start_training_time

    def running_speed(self) -> float:
        """Steps/sec over the last two samples (reference ``:113``)."""
        with self._lock:
            if len(self._global_step_records) < 2:
                return 0.0
            last, prev = (
                self._global_step_records[-1],
                self._global_step_records[-2],
            )
            dt = last.timestamp - prev.timestamp
            if dt <= 0:
                return 0.0
            return (last.global_step - prev.global_step) / dt

    def worker_adjustment_finished(self) -> bool:
        """True when the sampled worker count has been stable at the
        target for the whole record window."""
        with self._lock:
            if not self._global_step_records:
                return False
            worker_num = self._global_step_records[-1].worker_num
            if worker_num != self._target_worker_num:
                return False
            return all(
                r.worker_num == worker_num
                for r in self._global_step_records
            )

    def all_worker_joined(self) -> bool:
        with self._lock:
            return (
                self._target_worker_num > 0
                and len(self._workers) == self._target_worker_num
            )

    def step_is_stagnant(self, hang_secs: Optional[float] = None) -> bool:
        """Hang signal: no global-step progress for hang_secs while
        workers are running (feeds the master's hang diagnosis).

        Jobs that never report GlobalStep are NOT flagged — killing a
        healthy job that simply doesn't use step reporting is worse
        than missing a hang (reference gates on
        ``all_running_node_hanged`` + task hang for the same reason)."""
        hang_secs = hang_secs or _ctx.hang_detection_secs
        with self._lock:
            if not self._global_step_records:
                return False
            last = self._global_step_records[-1]
            return time.time() - last.timestamp > hang_secs
