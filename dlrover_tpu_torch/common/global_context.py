"""Global master configuration singleton.

Copy of ``dlrover_tpu/common/global_context.py``.

Reference parity: ``dlrover/python/common/global_context.py`` — tunables
the master consults everywhere; defaults may be overwritten from env or
(later) a cluster brain service.
"""

import os

from dlrover_tpu_torch.common.constants import JobConstant
from dlrover_tpu_torch.common.singleton import Singleton


class Context(Singleton):
    def __init__(self):
        self.master_port = 0
        self.train_speed_record_num = 50
        self.seconds_to_wait_failed_ps = 600
        self.seconds_for_stable_worker_count = 60
        self.seconds_interval_to_optimize = 300
        self.seconds_interval_to_change_ps = 3600
        self.step_to_adjust_worker = 200
        self.hang_detection_secs = 1800
        self.hang_downtime_secs = 300
        self.seconds_to_timeout_task = 1800
        self.relaunch_always = False
        self.max_node_relaunch_times = 3
        self.relaunch_on_worker_failure = 3
        self.master_service_timeout = JobConstant.MASTER_CLIENT_TIMEOUT
        self.node_heartbeat_timeout = JobConstant.NODE_HEARTBEAT_TIMEOUT
        self.pending_timeout_secs = 900
        self.auto_tune_parallelism = False
        self.is_tfv1_ps = False
        self.remove_exited_node = True
        self.checkpoint_replica = False
        self.load_env()

    def load_env(self):
        self.hang_detection_secs = int(
            os.getenv("DLROVER_TPU_HANG_DETECTION_SECS",
                      self.hang_detection_secs)
        )
        self.max_node_relaunch_times = int(
            os.getenv("DLROVER_TPU_MAX_RELAUNCH",
                      self.max_node_relaunch_times)
        )
        # shard-lease timeout (seconds until an unacked dispatched
        # shard is re-queued); the chaos harness shrinks it so a
        # SIGKILLed agent's leases recover inside the test budget
        try:
            self.seconds_to_timeout_task = float(
                os.getenv("DLROVER_TPU_TASK_TIMEOUT_S",
                          self.seconds_to_timeout_task)
            )
        except ValueError:
            pass
