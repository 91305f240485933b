"""Job masters: local (in-process, spawned by ``python -m
dlrover_tpu_torch.run``) and distributed (its own process or pod,
supervising a multi-host job).

Copy of ``dlrover_tpu/master/master.py`` (``JobMaster`` :39,
``LocalJobMaster`` :380, ``DistributedJobMaster`` :401,
``run_local_master`` :496): the durable master
(the Brain datastore that ``DLROVER_TPU_BRAIN_DB`` opens, the failover
journal and its replay, fencing by ``(job_epoch, incarnation)``), the
observatory (``HealthEngine``, ``MasterSelfTelemetry`` and
``MasterHealth``, the diagnosis chain, the ``--status_port`` server)
and the Brain (``BrainAutoScaler`` over the health engine, journaled
under the journal's ``brain`` component), each behind the reference's
switch and default.  Not ported yet: the live profiler's deep-capture
coordinator (``DLROVER_TPU_PROFILE``, ROADMAP A7).  The profiler's
switch defaults to off in the port
(``common/env.py``); turned on, it makes ``JobMaster`` raise
``NotImplementedError`` naming its item rather than run without it.
The journal's capture component stays None, as the reference's is with
that switch off.  The local master has no scaler: its Brain drains
and shrinks, and never grows (no launch capacity), as the reference's
local master.  ``DistributedJobMaster`` takes the platform's scaler
(``ElasticJobScaler`` on k8s, ``scheduler/ray.ActorScaler`` on ray),
hands it to the Brain (grow, drain with replace) or, with the Brain
off, runs ``AllreduceAutoScaler`` over it, as the reference does.

Reference parity: ``dlrover/python/master/local_master.py`` and
``dist_master.py:86,175,211``.
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
    DistributedJobManager,
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
    """The master subsystems not ported yet whose switch is on (the
    port's default leaves it off)."""
    from dlrover_tpu_torch.common import env

    switches = (
        ("the live profiler and deep capture (DLROVER_TPU_PROFILE) is "
         "not ported yet: ROADMAP A7", env.profile_enabled()),
    )
    return [name for name, on in switches if on]


class JobMaster:
    """Common wiring of the master components + gRPC service."""

    def __init__(self, port: int, node_num: int = 1,
                 job_manager=None, diagnosis_manager=None):
        import os

        from dlrover_tpu_torch.common.env import (
            brain_enabled,
            master_workers,
            observatory_enabled,
            self_obs_enabled,
        )
        from dlrover_tpu_torch.master.datastore import get_default_datastore
        from dlrover_tpu_torch.observability.events import TimelineAggregator
        from dlrover_tpu_torch.observability.metrics import get_registry

        for name in later_subsystems_on():
            raise NotImplementedError(name)
        self._job_name = os.getenv("DLROVER_TPU_JOB_NAME", "default")
        self.speed_monitor = SpeedMonitor()
        # the observatory: streaming per-node health derivations over
        # the incoming timeline batches + agent reports.  None under
        # the DLROVER_TPU_OBSERVATORY=0 kill-switch — every consumer
        # (diagnosis operators, JobStatusRequest, status server,
        # gauges) degrades to the pre-observatory behavior exactly.
        self.health_engine = None
        if observatory_enabled():
            from dlrover_tpu_torch.observability.health import HealthEngine

            self.health_engine = HealthEngine(
                job=self._job_name, registry=get_registry()
            )
        # unified job-event timeline: per-node streams merge here, the
        # goodput ledger is served live (get-RPC + exporter gauges) and
        # durably (sqlite datastore when configured); the health
        # engine taps every accepted batch
        self.timeline_aggregator = TimelineAggregator(
            job=self._job_name,
            registry=get_registry(),
            datastore=get_default_datastore(),
            health=self.health_engine,
        )
        # the deep-capture arm is ROADMAP A7: None, as the reference's
        # is under DLROVER_TPU_PROFILE=0
        self.capture_coordinator = None
        self.task_manager = TaskManager(speed_monitor=self.speed_monitor)
        self.rdzv_managers = {
            RendezvousName.ELASTIC_TRAINING:
                ElasticTrainingRendezvousManager(),
            RendezvousName.NETWORK_CHECK: NetworkCheckRendezvousManager(),
        }
        self.kv_store = KVStoreService()
        self.job_manager = job_manager
        # control-plane SELF-telemetry: the master watching itself
        # (per-RPC-kind latency histograms, pool occupancy, state
        # growth, journal lag) + the MasterHealth overload deriver.
        # None under DLROVER_TPU_SELF_OBS=0 — the pre-self-obs metric
        # surface exactly (pinned by tests).
        self.master_telemetry = None
        self.master_health = None
        if self_obs_enabled():
            from dlrover_tpu_torch.observability.health import MasterHealth
            from dlrover_tpu_torch.observability.self_telemetry import (
                MasterSelfTelemetry,
            )

            self.master_telemetry = MasterSelfTelemetry(
                registry=get_registry(),
                pool_size=master_workers(),
            )
            self.master_telemetry.attach(
                kv_store=self.kv_store,
                rdzv_managers=self.rdzv_managers,
                task_manager=self.task_manager,
                timeline_aggregator=self.timeline_aggregator,
                datastore=get_default_datastore(),
            )
            self.master_health = MasterHealth(self.master_telemetry)
        if diagnosis_manager is None:
            from dlrover_tpu_torch.master.diagnosis import DiagnosisManager

            # with the observatory on, the chain sits on top of the
            # streaming derivations (straggler / data-stall / hang
            # watchdog operators) and records conclusions to the
            # timeline + Brain; off, it is exactly the old manager
            diagnosis_manager = DiagnosisManager(
                speed_monitor=self.speed_monitor,
                health_engine=self.health_engine,
                datastore=get_default_datastore(),
                job=self._job_name,
                capture=self.capture_coordinator,
                master_health=self.master_health,
            )
        self.diagnosis_manager = diagnosis_manager
        # the autonomy loop: observatory signals -> hysteresis-guarded
        # BrainDecision -> ONE planned action (cooperative drain
        # directive + fence + reshard re-mesh).  None under
        # DLROVER_TPU_BRAIN=0 or with the observatory off.
        self.brain = None
        if brain_enabled() and self.health_engine is not None:
            from dlrover_tpu_torch.master.auto_scaler import BrainAutoScaler
            from dlrover_tpu_torch.master.brain import (
                BrainExecutor,
                NodeDirectives,
            )
            from dlrover_tpu_torch.master.resource_optimizer import (
                ObservatoryBrainOptimizer,
            )

            self.brain = BrainAutoScaler(
                ObservatoryBrainOptimizer(),
                BrainExecutor(
                    rdzv_manager=self.rdzv_managers[
                        RendezvousName.ELASTIC_TRAINING
                    ],
                    directives=NodeDirectives(),
                    job_manager=self.job_manager,
                ),
                health_engine=self.health_engine,
                timeline_aggregator=self.timeline_aggregator,
                job=self._job_name,
            )
        #: plain-HTTP /metrics + /status (off unless --status_port)
        self.status_server = None
        self.speed_monitor.set_target_worker_num(node_num)
        self._node_num = node_num
        self._port = port
        self._server = None
        self._exit_reason: Optional[str] = None
        self._stopped = threading.Event()
        #: fencing identity (durable when a Brain db is configured;
        #: epoch 0 / incarnation 0 = no durability, fencing inert)
        self.job_epoch = 0
        self.incarnation = 0
        #: durable control-plane journal (None = failover disabled or
        #: no Brain db — today's memory-only behavior exactly)
        self.control_journal = None

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

    def _setup_failover(self):
        """Durable control-plane state: registers this incarnation,
        replays snapshot+journal into the components, then attaches
        the journal hooks — all BEFORE the gRPC server opens, so the
        first reconnecting agent sees the resumed state."""
        from dlrover_tpu_torch.common.env import master_failover_enabled
        from dlrover_tpu_torch.master.datastore import get_default_datastore

        if not master_failover_enabled():
            return
        store = get_default_datastore()
        if store is None:
            return
        from dlrover_tpu_torch.master.failover import ControlPlaneJournal
        from dlrover_tpu_torch.observability.events import get_event_logger

        self.job_epoch, self.incarnation = store.bump_incarnation(
            self._job_name
        )
        self.control_journal = ControlPlaneJournal(
            store,
            self._job_name,
            kv_store=self.kv_store,
            rdzv_managers=self.rdzv_managers,
            task_manager=self.task_manager,
            job_manager=self.job_manager,
            brain=self.brain,
            capture=self.capture_coordinator,
        )
        stats = self.control_journal.recover()
        self.control_journal.attach()
        self.control_journal.start()
        if self.incarnation > 1:
            get_event_logger().instant(
                "master_restart",
                incarnation=self.incarnation,
                job_epoch=self.job_epoch,
                **stats,
            )
            logger.info(
                "master incarnation %s resumed job epoch %s (%s)",
                self.incarnation, self.job_epoch, stats,
            )

    def prepare(self):
        self._setup_failover()
        if (
            self.master_telemetry is not None
            and self.control_journal is not None
        ):
            # the journal only exists once failover setup ran; its
            # snapshot age/duration joins the self-telemetry sweep
            self.master_telemetry.attach(
                journal=self.control_journal
            )
        servicer = MasterServicer(
            task_manager=self.task_manager,
            job_manager=self.job_manager,
            speed_monitor=self.speed_monitor,
            rdzv_managers=self.rdzv_managers,
            kv_store=self.kv_store,
            diagnosis_manager=self.diagnosis_manager,
            timeline_aggregator=self.timeline_aggregator,
            health_engine=self.health_engine,
            brain=self.brain,
            capture_coordinator=self.capture_coordinator,
            job_epoch=self.job_epoch,
            incarnation=self.incarnation,
            telemetry=self.master_telemetry,
        )
        self._servicer = servicer
        self._server = create_master_service(self._port, servicer)
        self._server.start()
        self.task_manager.start()
        self.job_manager.start()
        self.diagnosis_manager.start()
        if self.brain is not None:
            self.brain.start()
        self._start_status_server(servicer)
        logger.info("master serving on port %s", self._port)

    def _start_status_server(self, servicer):
        """Plain-HTTP ``/metrics`` (Prometheus text) + ``/status``
        (the JobStatusRequest snapshot as JSON).  Off by default:
        needs ``--status_port`` (``DLROVER_TPU_STATUS_PORT``) AND the
        observatory on."""
        import os

        raw = os.getenv("DLROVER_TPU_STATUS_PORT", "")
        if not raw:
            return
        try:
            port = int(raw)
        except ValueError:
            logger.warning(
                "ignoring malformed DLROVER_TPU_STATUS_PORT=%r", raw
            )
            return
        if port < 0:
            return
        if self.health_engine is None:
            logger.info(
                "status port requested but observatory is off "
                "(DLROVER_TPU_OBSERVATORY=0); not serving"
            )
            return
        from dlrover_tpu_torch.common import messages as msg
        from dlrover_tpu_torch.observability.metrics import get_registry
        from dlrover_tpu_torch.observability.status_server import (
            StatusServer,
        )

        def _snapshot():
            res = servicer._job_status(msg.JobStatusRequest())
            return res.status if res.available else {}

        self.status_server = StatusServer(
            port,
            registry=get_registry(),
            snapshot_fn=_snapshot,
            health_engine=self.health_engine,
            telemetry=self.master_telemetry,
        )
        try:
            self.status_server.start()
        except OSError as e:
            logger.warning(
                "status server failed to bind :%d: %s", port, e
            )
            self.status_server = None

    def process_diagnosis(self):
        """Feed inference-chain conclusions to the job manager (run
        from the supervision loops)."""
        conclusions = self.diagnosis_manager.take_conclusions()
        if conclusions:
            self.job_manager.apply_diagnosis_conclusions(conclusions)

    def stop(self, reason: str = ""):
        self._exit_reason = reason or self._exit_reason
        self._stopped.set()
        if self.control_journal is not None:
            # a job-terminal stop (request_stop always passes a
            # JobExitReason) RETIRES the durable state — a later run
            # under the same Brain db + job name must not inherit this
            # job's exhausted datasets / stale KV keys; a bare stop()
            # (master-only shutdown) snapshots so the next incarnation
            # resumes
            self.control_journal.stop(
                retire=bool(self._exit_reason)
            )
        self.task_manager.stop()
        self.job_manager.stop()
        self.diagnosis_manager.stop()
        if self.brain is not None:
            self.brain.stop()
        if self.status_server is not None:
            self.status_server.stop()
            self.status_server = None
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
            self.process_diagnosis()
            time.sleep(1)
        return 0


class DistributedJobMaster(JobMaster):
    """Multi-host master with a 30s supervision loop deciding
    early-stop / hang / all-exited (reference: ``dist_master.py:211``)."""

    SUPERVISE_INTERVAL = 30

    def __init__(self, port: int, node_num: int, scaler=None,
                 diagnosis_manager=None, pending_timeout=None,
                 autoscale: bool = True, max_workers: int = 0):
        super().__init__(
            port,
            node_num,
            job_manager=DistributedJobManager(
                node_num, scaler=scaler, pending_timeout=pending_timeout
            ),
            diagnosis_manager=diagnosis_manager,
        )
        if not autoscale and self.brain is not None:
            # autoscaling explicitly disabled: the Brain must not run
            # either (dropped before prepare() wires the journal /
            # servicer, so nothing references it)
            self.brain = None
        if self.brain is not None and scaler is not None:
            # the Brain gains launch capacity: grow decisions and
            # drain REPLACEMENTS execute through the same scaler the
            # job manager relaunches with
            self.brain.set_scaler(scaler)
        # seed periodic optimize -> ScalePlan cycle (reference
        # job_auto_scaler.py:271); with the Brain on it is replaced
        # wholesale — DLROVER_TPU_BRAIN=0 reproduces it exactly.  The
        # plan executes through the SAME scaler the job manager
        # relaunches with.
        self.auto_scaler = None
        if autoscale and scaler is not None and self.brain is None:
            import os

            from dlrover_tpu_torch.master.auto_scaler import (
                AllreduceAutoScaler,
            )
            from dlrover_tpu_torch.master.resource_optimizer import (
                LocalAllreduceOptimizer,
            )

            self.auto_scaler = AllreduceAutoScaler(
                LocalAllreduceOptimizer(
                    min_workers=node_num,
                    max_workers=max_workers or node_num,
                    job_name=os.getenv(
                        "DLROVER_TPU_JOB_NAME", "default"
                    ),
                ),
                scaler,
                speed_monitor=self.speed_monitor,
                job_manager=self.job_manager,
                rendezvous_manager=self.rdzv_managers.get(
                    RendezvousName.NETWORK_CHECK
                ),
            )

    def run(self) -> int:
        exit_code = 0
        if self.auto_scaler is not None:
            self.auto_scaler.start()
        while not self._stopped.is_set():
            if self.job_manager.all_workers_exited():
                if self.job_manager.all_workers_failed():
                    self.request_stop(
                        False, JobExitReason.WORKER_ERROR
                    )
                    exit_code = 1
                else:
                    self.request_stop(True, JobExitReason.SUCCEEDED)
                break
            stop_reason = self.job_manager.should_stop_job()
            if stop_reason:
                logger.error("stopping job: %s", stop_reason)
                self.request_stop(False, JobExitReason.WORKER_ERROR)
                exit_code = 1
                break
            if self.speed_monitor.step_is_stagnant():
                logger.warning("global step stagnant: possible hang")
                self.request_stop(False, JobExitReason.HANG_ERROR)
                exit_code = 1
                break
            if self.task_manager.finished():
                self.request_stop(True, JobExitReason.SUCCEEDED)
                break
            self.process_diagnosis()
            self._stopped.wait(self.SUPERVISE_INTERVAL)
        if self.auto_scaler is not None:
            self.auto_scaler.stop()
        return exit_code


def run_local_master(port: int, node_num: int) -> LocalJobMaster:
    """Start a local master on ``port`` in background threads and return
    it (what the run CLI calls on rank 0)."""
    master = LocalJobMaster(port, node_num)
    master.prepare()
    threading.Thread(
        target=master.run, name="local-master", daemon=True
    ).start()
    return master
