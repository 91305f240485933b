"""The local job master (spawned by ``python -m dlrover_tpu_torch.run``).

Copy of ``dlrover_tpu/master/master.py`` (``JobMaster`` :39,
``LocalJobMaster`` :380, ``run_local_master`` :496) without the
subsystems that ROADMAP A3c.3 brings: the observatory
(``observability/health.py``), the diagnosis chain, the Brain
(``auto_scaler``, ``brain``, ``resource_optimizer``), the master's
self-telemetry, the deep-capture coordinator, the failover journal with
the sqlite datastore it needs (``DLROVER_TPU_BRAIN_DB``), the status
server, and the distributed master (k8s / ray scalers).  Their switches
default to off in the port (``common/env.py``); one turned on makes
``JobMaster`` raise ``NotImplementedError`` naming A3c.3 rather than run
without it.  The client's reconnect and its ``(job_epoch,
master_incarnation)`` fields (``common/comm.py``) stay: with no journal
the master is incarnation 0 and fences nothing.

Reference parity: ``dlrover/python/master/local_master.py``.
"""

import threading
import time
from typing import Optional

from dlrover_tpu_torch.common.constants import (
    JobExitReason,
    RendezvousName,
)
from dlrover_tpu_torch.common.global_context import Context
from dlrover_tpu_torch.common.log import default_logger as logger
from dlrover_tpu_torch.master.job_manager import (
    AllReduceNodeHandlingCallback,
    LocalJobManager,
    TaskRescheduleCallback,
)
from dlrover_tpu_torch.master.kv_store import KVStoreService
from dlrover_tpu_torch.master.rendezvous import (
    ElasticTrainingRendezvousManager,
    NetworkCheckRendezvousManager,
)
from dlrover_tpu_torch.master.servicer import (
    MasterServicer,
    create_master_service,
)
from dlrover_tpu_torch.master.shard.task_manager import TaskManager
from dlrover_tpu_torch.master.speed_monitor import SpeedMonitor

_ctx = Context.singleton_instance()


def later_subsystems_on():
    """The master subsystems ROADMAP A3c.3 brings whose switch is on (the
    port's defaults leave every one off)."""
    import os

    from dlrover_tpu_torch.common import env

    switches = (
        ("the observatory (DLROVER_TPU_OBSERVATORY)",
         env.observatory_enabled()),
        ("the live profiler and deep capture (DLROVER_TPU_PROFILE)",
         env.profile_enabled()),
        ("the Brain (DLROVER_TPU_BRAIN)", env.brain_enabled()),
        ("the master's self-telemetry (DLROVER_TPU_SELF_OBS)",
         env.self_obs_enabled()),
        ("the failover journal and its datastore (DLROVER_TPU_BRAIN_DB)",
         env.master_failover_enabled()
         and bool(os.getenv("DLROVER_TPU_BRAIN_DB", ""))),
        ("the status server (DLROVER_TPU_STATUS_PORT)",
         bool(os.getenv("DLROVER_TPU_STATUS_PORT", ""))),
    )
    return [name for name, on in switches if on]


class JobMaster:
    """Common wiring of the master components + gRPC service."""

    def __init__(self, port: int, node_num: int = 1, job_manager=None):
        import os

        from dlrover_tpu_torch.observability.events import TimelineAggregator
        from dlrover_tpu_torch.observability.metrics import get_registry

        for name in later_subsystems_on():
            raise NotImplementedError(
                f"{name} is not ported yet: ROADMAP A3c.3")
        self._job_name = os.getenv("DLROVER_TPU_JOB_NAME", "default")
        self.speed_monitor = SpeedMonitor()
        # the observatory, the Brain, the self-telemetry, the capture
        # coordinator and the diagnosis chain are A3c.3: the servicer
        # takes None for each, as the reference does with them off
        self.health_engine = None
        self.capture_coordinator = None
        self.master_telemetry = None
        self.master_health = None
        self.diagnosis_manager = None
        self.brain = None
        self.status_server = None
        # unified job-event timeline: per-node streams merge here and
        # the goodput ledger is served live (no datastore: A3c.3)
        self.timeline_aggregator = TimelineAggregator(
            job=self._job_name, registry=get_registry())
        self.task_manager = TaskManager(speed_monitor=self.speed_monitor)
        self.rdzv_managers = {
            RendezvousName.ELASTIC_TRAINING:
                ElasticTrainingRendezvousManager(),
            RendezvousName.NETWORK_CHECK: NetworkCheckRendezvousManager(),
        }
        self.kv_store = KVStoreService()
        self.job_manager = job_manager
        self.speed_monitor.set_target_worker_num(node_num)
        self._node_num = node_num
        self._port = port
        self._server = None
        self._exit_reason: Optional[str] = None
        self._stopped = threading.Event()
        #: fencing identity: epoch 0 / incarnation 0 = no durability
        #: (the failover journal is A3c.3), fencing inert
        self.job_epoch = 0
        self.incarnation = 0

        self.job_manager.add_node_event_callback(
            TaskRescheduleCallback(self.task_manager)
        )
        self.job_manager.add_node_event_callback(
            AllReduceNodeHandlingCallback(self)
        )

    @property
    def port(self) -> int:
        return self._port

    @property
    def addr(self) -> str:
        return f"127.0.0.1:{self._port}"

    def prepare(self):
        servicer = MasterServicer(
            task_manager=self.task_manager,
            job_manager=self.job_manager,
            speed_monitor=self.speed_monitor,
            rdzv_managers=self.rdzv_managers,
            kv_store=self.kv_store,
            timeline_aggregator=self.timeline_aggregator,
            job_epoch=self.job_epoch,
            incarnation=self.incarnation,
        )
        self._servicer = servicer
        self._server = create_master_service(self._port, servicer)
        self._server.start()
        self.task_manager.start()
        self.job_manager.start()
        logger.info("master serving on port %s", self._port)

    def stop(self, reason: str = ""):
        self._exit_reason = reason or self._exit_reason
        self._stopped.set()
        self.task_manager.stop()
        self.job_manager.stop()
        if self._server:
            self._server.stop(grace=0.5)

    def request_stop(self, success: bool, reason: str, msg: str = ""):
        logger.info("stop requested: success=%s reason=%s %s",
                    success, reason, msg)
        self.stop(reason)


class LocalJobMaster(JobMaster):
    """In-process master for single-host runs (reference:
    ``local_master.py:118``)."""

    def __init__(self, port: int, node_num: int = 1):
        super().__init__(
            port, node_num, job_manager=LocalJobManager(node_num)
        )

    def run(self):
        """Block until training finishes (used when run as a thread)."""
        while not self._stopped.is_set():
            if self.task_manager.finished():
                logger.info("all dataset tasks finished")
                self.request_stop(True, JobExitReason.SUCCEEDED)
                break
            time.sleep(1)
        return 0


def run_local_master(port: int, node_num: int) -> LocalJobMaster:
    """Start a local master on ``port`` in background threads and return
    it (what the run CLI calls on rank 0)."""
    master = LocalJobMaster(port, node_num)
    master.prepare()
    threading.Thread(
        target=master.run, name="local-master", daemon=True
    ).start()
    return master
