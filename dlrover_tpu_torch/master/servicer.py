"""The master RPC servicer: dispatch tables for ``get`` and ``report``.

Copy of ``dlrover_tpu/master/servicer.py``.  The Brain and deep-capture
hooks take None (ROADMAP A3c.3c and A7), as the reference's do with
those switched off.

Reference parity: ``dlrover/python/master/servicer.py:72,99,650``; the
full dispatch surface is the parity checklist in SURVEY.md Appendix A.
Every request type routes to the backing component (task manager,
rendezvous managers, KV store, job manager, speed monitor, diagnosis).
"""

import threading
import time
from typing import Optional

from dlrover_tpu_torch.common import messages as msg
from dlrover_tpu_torch.common.comm import build_master_server
from dlrover_tpu_torch.common.constants import (
    RendezvousName,
    TrainingExceptionLevel,
    TrainingLoopStatus,
)
from dlrover_tpu_torch.common.env import (
    master_failover_enabled,
    master_workers,
)
from dlrover_tpu_torch.common.fault_injection import maybe_crash
from dlrover_tpu_torch.common.log import default_logger as logger
from dlrover_tpu_torch.observability.metrics import record_control_rpc


class MasterServicer:
    # at most ``max_parked_waits`` (HALF the gRPC pool —
    # ``DLROVER_TPU_MASTER_WORKERS`` scales both together, 32 for the
    # default 64-worker pool) RPC workers may PARK in long-poll waits
    # at once; past the cap a wait degrades to an immediate answer
    # (the client just re-issues), so join/set/report mutations — the
    # RPCs that WAKE parked waiters — always find a free worker and
    # the pool cannot deadlock on its own waiters

    def __init__(
        self,
        task_manager=None,
        job_manager=None,
        speed_monitor=None,
        rdzv_managers=None,
        kv_store=None,
        diagnosis_manager=None,
        sync_service=None,
        timeline_aggregator=None,
        health_engine=None,
        brain=None,
        capture_coordinator=None,
        job_epoch: int = 0,
        incarnation: int = 0,
        telemetry=None,
        serving_status_fn=None,
    ):
        #: fencing identity: requests carrying a DIFFERENT job_epoch
        #: get a typed ``StaleEpoch`` answer (client refreshes and
        #: re-issues) instead of being dispatched against the wrong
        #: job generation.  incarnation is informational — it tells
        #: reconnecting clients the master restarted.
        self.job_epoch = job_epoch
        self.incarnation = incarnation
        self._task_manager = task_manager
        self._job_manager = job_manager
        self._speed_monitor = speed_monitor
        self._rdzv_managers = rdzv_managers or {}
        self._kv_store = kv_store
        self._diagnosis_manager = diagnosis_manager
        self._sync_service = sync_service
        self._timeline_aggregator = timeline_aggregator
        #: the observatory's streaming derivation engine (None =
        #: DLROVER_TPU_OBSERVATORY=0 or a pre-observatory master);
        #: heartbeats / steps / failures / resource reports tap it
        self._health_engine = health_engine
        #: the Brain auto-scaler (None = DLROVER_TPU_BRAIN=0):
        #: node directives ride the WaitingNodeNum response and its
        #: decision state joins the JobStatus snapshot
        self._brain = brain
        #: the deep-capture coordinator (None = DLROVER_TPU_PROFILE=0
        #: or observatory off): capture directives ride the SAME
        #: WaitingNodeNum piggyback (a Brain drain outranks them) and
        #: the latest capture per node joins the JobStatus snapshot
        self._capture = capture_coordinator
        self._start_training_time = 0.0
        #: lifetime RPC tally (gets + reports, batched items counted
        #: once per envelope) — the bench's server-side ground truth
        self.rpc_count = 0
        #: self-telemetry collector (None = DLROVER_TPU_SELF_OBS=0 or
        #: a pre-self-obs caller): per-RPC-kind latency/size
        #: histograms, in-flight/parked gauges, the ``master`` status
        #: section
        self._telemetry = telemetry
        #: zero-arg callable returning the serving plane's status dict
        #: (``ServingEngine.status()``); None = no co-located serving
        #: engine or DLROVER_TPU_SERVE_OBS=0 — the ``serving`` status
        #: section is simply absent (pinned pre-16 shape)
        self._serving_status_fn = serving_status_fn
        #: the parked-wait cap scales with the pool: half the workers
        #: may park, so mutations always find a free one
        self.max_parked_waits = max(master_workers() // 2, 1)
        self._wait_slots = threading.BoundedSemaphore(
            self.max_parked_waits
        )

    def _count_rpc(self):
        # benign race on +=: the tally is telemetry, not a lock target
        self.rpc_count += 1
        record_control_rpc()

    def _bounded_wait(self, wait_fn, immediate_fn):
        """Run a blocking wait under the parked-waiter cap; saturated
        ⇒ answer immediately (the client loop re-issues, with its own
        backoff) instead of parking another pool thread."""
        if not self._wait_slots.acquire(blocking=False):
            if self._telemetry is not None:
                self._telemetry.wait_rejected()
            return immediate_fn()
        if self._telemetry is not None:
            self._telemetry.wait_parked()
        try:
            # chaos hook: a kill pinned here dies with RPCs parked
            # mid-long-poll — the waiters must re-park on the next
            # incarnation, not crash
            maybe_crash("mid_long_poll")
            return wait_fn()
        finally:
            if self._telemetry is not None:
                self._telemetry.wait_unparked()
            self._wait_slots.release()

    def _fenced(self, envelope: msg.Envelope) -> Optional[msg.StaleEpoch]:
        """Typed fencing answer when the request's job_epoch doesn't
        match this master's.  ``-1`` (old clients / kill-switched
        failover) is never fenced."""
        if not master_failover_enabled():
            return None
        epoch = getattr(envelope, "job_epoch", -1)
        if epoch is None or epoch < 0 or epoch == self.job_epoch:
            return None
        return msg.StaleEpoch(
            job_epoch=self.job_epoch, incarnation=self.incarnation
        )

    @staticmethod
    def _response_bytes(response) -> Optional[int]:
        """Wire size of one response (None when there is none).  The
        extra serialize only runs with self-obs ON and control
        responses are small pickles — the histogram is worth the
        double-encode; a failure must not break the RPC."""
        if response is None:
            return None
        try:
            return len(msg.serialize_message(response))
        except Exception:  # noqa: BLE001
            return None

    # ------------------------------------------------------------------ get
    def get(self, envelope: msg.Envelope) -> Optional[msg.Message]:
        self._count_rpc()
        request = msg.deserialize_message(envelope.data)
        if self._telemetry is None:
            return self._get_dispatch(envelope, request)
        t0 = time.perf_counter()
        self._telemetry.rpc_begin()
        response = None
        try:
            response = self._get_dispatch(envelope, request)
            return response
        finally:
            self._telemetry.rpc_end(
                type(request).__name__,
                time.perf_counter() - t0,
                len(envelope.data or b""),
                self._response_bytes(response),
            )

    def _get_dispatch(
        self, envelope: msg.Envelope, request
    ) -> Optional[msg.Message]:
        node_id, node_type = envelope.node_id, envelope.node_type
        if isinstance(request, msg.ControlEpochRequest):
            # the refresh path — answered even to stale clients (it is
            # HOW they stop being stale)
            return msg.ControlEpoch(
                job_epoch=self.job_epoch,
                incarnation=self.incarnation,
            )
        stale = self._fenced(envelope)
        if stale is not None:
            return stale
        if isinstance(request, msg.TaskRequest):
            return self._get_task(node_id, request)
        if isinstance(request, msg.ShardCheckpointRequest):
            return self._task_manager.get_dataset_checkpoint(
                request.dataset_name
            )
        if isinstance(request, msg.RunningNodesRequest):
            return self._get_running_nodes(request)
        if isinstance(request, msg.JoinRendezvousRequest):
            return self._join_rendezvous(request)
        if isinstance(request, msg.WaitingNodeNumRequest):
            return self._get_waiting_num(request, node_id)
        if isinstance(request, msg.NetworkReadyRequest):
            return self._check_fault_node()
        if isinstance(request, msg.StragglerExistRequest):
            return self._check_straggler()
        if isinstance(request, msg.CommWorldRequest):
            return self._get_comm_world(request)
        if isinstance(request, msg.KVWaitRequest):
            # long-poll: park on the KV store's condition; an empty
            # value means the wait timed out (the client loops)
            value = self._bounded_wait(
                lambda: self._kv_store.wait(
                    request.key, timeout=request.wait_timeout
                ),
                lambda: self._kv_store.get(request.key),
            )
            return msg.KeyValuePair(key=request.key, value=value or b"")
        if isinstance(request, msg.KeyValuePair):
            return msg.KeyValuePair(
                key=request.key, value=self._kv_store.get(request.key)
            )
        if isinstance(request, msg.TrainingStatusRequest):
            started = bool(
                self._task_manager
                and self._task_manager.training_started()
            )
            # getattr throughout this dispatch: a pre-fast-path client
            # pickles its dataclasses WITHOUT the new fields (unpickle
            # restores __dict__, not defaults) and must keep working
            # across a rolling upgrade
            wait_timeout = getattr(request, "wait_timeout", 0.0)
            if (
                not started
                and wait_timeout > 0
                and self._task_manager is not None
            ):
                started = self._bounded_wait(
                    lambda: self._task_manager.wait_training_started(
                        wait_timeout
                    ),
                    lambda: False,
                )
            status = (
                TrainingLoopStatus.START
                if started
                else TrainingLoopStatus.PENDING
            )
            return msg.TrainingStatus(status=status)
        if isinstance(request, msg.ParallelConfigRequest):
            if self._job_manager:
                return self._job_manager.get_paral_config()
            return msg.ParallelConfig()
        if isinstance(request, msg.CheckHardwareResetRequest):
            restart = False
            if self._job_manager:
                restart = self._job_manager.should_restart_node(
                    node_type, node_id
                )
            return msg.ParallelConfig(restart=restart)
        if isinstance(request, msg.PsNodesRequest):
            return msg.PsNodes()
        if isinstance(request, msg.ClusterVersionRequest):
            return msg.ClusterVersion()
        if isinstance(request, msg.ElasticRunConfigRequest):
            return msg.ElasticRunConfig()
        if isinstance(request, msg.BrainQueryRequest):
            return self._brain_query(request)
        if isinstance(request, msg.TimelineQueryRequest):
            return self._timeline_query(request)
        if isinstance(request, msg.JobStatusRequest):
            return self._job_status(request)
        logger.warning("unhandled get request: %r", request)
        return None

    def _job_status(
        self, request: msg.JobStatusRequest
    ) -> msg.JobStatusResponse:
        """The observatory snapshot: streaming health derivations +
        the live goodput ledger + the newest diagnosis conclusions.
        ``available=False`` when the observatory is off (kill-switch)
        — the pre-observatory master had no such surface."""
        if self._health_engine is None:
            return msg.JobStatusResponse(available=False)
        status = {"health": self._health_engine.snapshot()}
        if self._timeline_aggregator is not None:
            try:
                status["ledger"] = self._timeline_aggregator.ledger()
            except Exception as e:  # noqa: BLE001 - partial status beats none
                logger.warning("status ledger failed: %s", e)
        if self._diagnosis_manager is not None and hasattr(
            self._diagnosis_manager, "recent_conclusions"
        ):
            status["conclusions"] = (
                self._diagnosis_manager.recent_conclusions(
                    getattr(request, "conclusions", 16)
                )
            )
        if self._speed_monitor is not None:
            status["speed"] = {
                "global_step": self._speed_monitor.completed_global_step,
                "records_per_sec": self._speed_monitor.running_speed(),
            }
        status["epoch"] = {
            "job_epoch": self.job_epoch,
            "incarnation": self.incarnation,
        }
        if self._brain is not None:
            try:
                status["brain"] = self._brain.status()
            except Exception as e:  # noqa: BLE001 - partial status
                logger.warning("status brain failed: %s", e)
        if self._capture is not None:
            try:
                status["profiles"] = self._capture.latest()
            except Exception as e:  # noqa: BLE001 - partial status
                logger.warning("status profiles failed: %s", e)
        if self._telemetry is not None:
            # the control plane's own vitals: RPC latency per kind,
            # pool occupancy, state growth, journal/datastore health
            # (absent under DLROVER_TPU_SELF_OBS=0 — pinned)
            try:
                status["master"] = self._telemetry.snapshot()
            except Exception as e:  # noqa: BLE001 - partial status
                logger.warning("status master section failed: %s", e)
        if self._serving_status_fn is not None:
            # the serving observatory: replica table + SLO quantiles +
            # per-replica health verdicts from the co-located engine
            try:
                status["serving"] = self._serving_status_fn()
            except Exception as e:  # noqa: BLE001 - partial status
                logger.warning("status serving section failed: %s", e)
        return msg.JobStatusResponse(status=status, available=True)

    def _timeline_query(
        self, request: msg.TimelineQueryRequest
    ) -> msg.TimelineQueryResponse:
        agg = self._timeline_aggregator
        if agg is None:
            return msg.TimelineQueryResponse(available=False)
        return msg.TimelineQueryResponse(
            ledger=agg.ledger(),
            events=agg.events(request.limit) if request.limit else [],
            available=True,
        )

    def _brain_query(
        self, request: msg.BrainQueryRequest
    ) -> msg.BrainQueryResponse:
        from dlrover_tpu_torch.master.datastore import get_default_datastore

        store = get_default_datastore()
        if store is None:
            return msg.BrainQueryResponse(available=False)
        if request.kind == "speed":
            payload = {
                "speed": store.speed_history(request.job)
            }
        elif request.kind == "node_events":
            payload = {
                "events": store.node_events(
                    request.job, limit=request.limit
                )
            }
        elif request.kind == "workloads":
            payload = {"workloads": store.measured_workloads()}
        elif request.kind == "profiles":
            payload = {
                "profiles": store.profiles(
                    request.job, limit=request.limit
                )
            }
        elif request.kind == "measurements":
            # cross-job calibration: ANY job's strategy service can
            # pull this fleet's history for a workload signature
            # (ref: the Go Brain serving all jobs' metrics,
            # dlrover/go/brain/pkg/datastore/dbbase/recorder.go:280)
            payload = {
                "measurements": store.load_measurements(
                    request.workload, limit=request.limit
                )
            }
        else:
            return msg.BrainQueryResponse(available=False)
        return msg.BrainQueryResponse(
            payload=payload, available=True
        )

    def _get_task(self, node_id: int, request: msg.TaskRequest) -> msg.Task:
        if not self._start_training_time:
            self._start_training_time = time.time()
            if self._speed_monitor:
                self._speed_monitor.set_start_timestamp()
        wait_timeout = getattr(request, "wait_timeout", 0.0)
        if wait_timeout > 0:
            return self._bounded_wait(
                lambda: self._task_manager.wait_task(
                    node_id, request.dataset_name, wait_timeout
                ),
                lambda: self._task_manager.get_task(
                    node_id, request.dataset_name
                ),
            )
        return self._task_manager.get_task(node_id, request.dataset_name)

    def _get_running_nodes(self, request: msg.RunningNodesRequest):
        if self._job_manager is None:
            return msg.RunningNodes()
        version = self._job_manager.nodes_version
        req_version = getattr(request, "version", -1)
        if req_version >= 0 and req_version == version:
            return msg.NotModified(version=version)
        return msg.RunningNodes(
            nodes=self._job_manager.get_running_nodes(),
            version=version,
        )

    def _get_waiting_num(self, request: msg.WaitingNodeNumRequest,
                         node_id: int = -1):
        manager = self._rdzv_managers.get(
            request.rdzv_name or RendezvousName.ELASTIC_TRAINING
        )
        if manager is None:
            return msg.WaitingNodeNum(waiting_num=0)
        # Brain directive piggyback: a pending planned action for THIS
        # node short-circuits the long poll (the agent must act now,
        # not after the park) and is consumed on delivery
        directive = None
        if self._brain is not None and node_id >= 0:
            directive = self._brain.directives.take(node_id)
        if directive is None and self._capture is not None and (
            node_id >= 0
        ):
            # a deep-capture request rides the same slot; a Brain
            # drain outranks it (the node is leaving anyway — its
            # capture stays pending and expires with the cooldown)
            directive = self._capture.directives.take(node_id)
        wait_timeout = getattr(request, "wait_timeout", 0.0)
        if directive is not None:
            waiting = manager.num_nodes_waiting()
            action, reason, decision_id = directive
            return msg.WaitingNodeNum(
                waiting_num=waiting,
                action=action,
                action_reason=reason,
                action_id=decision_id,
            )
        if wait_timeout > 0:
            waiting = self._bounded_wait(
                lambda: manager.wait_num_nodes(
                    last_num=getattr(request, "last_num", -1),
                    timeout=wait_timeout,
                ),
                manager.num_nodes_waiting,
            )
        else:
            waiting = manager.num_nodes_waiting()
        return msg.WaitingNodeNum(waiting_num=waiting)

    def _join_rendezvous(self, request: msg.JoinRendezvousRequest):
        manager = self._rdzv_managers.get(
            request.rdzv_name or RendezvousName.ELASTIC_TRAINING
        )
        if manager is None:
            return msg.RendezvousState(round=-1)
        rdzv_round = manager.join_rendezvous(
            request.node_rank, request.local_world_size
        )
        if request.rdzv_name == RendezvousName.NETWORK_CHECK:
            # joining a network check clears the training waitlist
            # bookkeeping (reference servicer.py:257-263)
            training = self._rdzv_managers.get(
                RendezvousName.ELASTIC_TRAINING
            )
            if training:
                training.remove_alive_node(request.node_rank)
        return msg.RendezvousState(round=rdzv_round)

    def _get_comm_world(self, request: msg.CommWorldRequest):
        manager = self._rdzv_managers.get(
            request.rdzv_name or RendezvousName.ELASTIC_TRAINING
        )
        if manager is None:
            return msg.CommWorld()
        wait_timeout = getattr(request, "wait_timeout", 0.0)
        req_version = getattr(request, "version", -1)
        if wait_timeout > 0:
            rdzv_round, group, world, version = self._bounded_wait(
                lambda: manager.wait_comm_world(
                    request.node_id,
                    version=req_version,
                    timeout=wait_timeout,
                ),
                lambda: manager.get_comm_world_versioned(
                    request.node_id
                ),
            )
        else:
            rdzv_round, group, world, version = (
                manager.get_comm_world_versioned(request.node_id)
            )
        if (
            req_version >= 0
            and req_version == version
            and world
        ):
            # the client's cached world is still this exact state
            return msg.NotModified(version=version)
        return msg.CommWorld(
            rdzv_name=request.rdzv_name,
            round=rdzv_round,
            group=group,
            world=world,
            version=version,
        )

    def _check_fault_node(self):
        manager = self._rdzv_managers.get(RendezvousName.NETWORK_CHECK)
        if manager is None:
            return msg.NetworkCheckResult()
        nodes, reason = manager.check_fault_node()
        return msg.NetworkCheckResult(nodes=nodes, reason=reason)

    def _check_straggler(self):
        manager = self._rdzv_managers.get(RendezvousName.NETWORK_CHECK)
        if manager is None:
            return msg.NetworkCheckResult()
        nodes, reason = manager.check_straggler()
        return msg.NetworkCheckResult(nodes=nodes, reason=reason)

    # --------------------------------------------------------------- report
    def report(self, envelope: msg.Envelope):
        self._count_rpc()
        if self._telemetry is None:
            return self._report_dispatch(envelope)[1]
        t0 = time.perf_counter()
        self._telemetry.rpc_begin()
        kind, response = "?", None
        try:
            kind, response = self._report_dispatch(envelope)
            return response
        finally:
            self._telemetry.rpc_end(
                kind,
                time.perf_counter() - t0,
                len(envelope.data or b""),
                self._response_bytes(response),
            )

    def _report_dispatch(self, envelope: msg.Envelope):
        """Fence FIRST, deserialize second (the pre-self-obs order):
        a stale client must get its typed ``StaleEpoch`` even when
        its payload no longer unpickles across a rolling upgrade, and
        a fenced request must not pay deserialization.  Returns
        ``(kind, response)`` so the telemetry wrapper can label the
        series without deserializing itself."""
        stale = self._fenced(envelope)
        if stale is not None:
            return "StaleEpoch", stale
        request = msg.deserialize_message(envelope.data)
        node_id, node_type = envelope.node_id, envelope.node_type
        kind = type(request).__name__
        success = False
        try:
            success = self._dispatch_report(node_id, node_type, request)
        except Exception as e:  # noqa: BLE001
            logger.error("report handler error for %r: %s", request, e)
            return kind, msg.BoolResponse(
                success=False, reason=repr(e)
            )
        return kind, msg.BoolResponse(success=bool(success))

    def _dispatch_report(self, node_id, node_type, request) -> bool:
        if isinstance(request, msg.BatchedReport):
            # coalesced delta reporting: dispatch IN ORDER; every item
            # runs even after a failure (dropping the tail would lose
            # reports the client thinks are delivered), the ack is the
            # conjunction
            ok = True
            for item in request.items:
                try:
                    ok = self._dispatch_report(
                        node_id, node_type, item
                    ) and ok
                except Exception as e:  # noqa: BLE001
                    logger.error(
                        "batched report item %r failed: %s", item, e
                    )
                    ok = False
            return ok
        if isinstance(request, msg.DatasetShardParams):
            self._task_manager.new_dataset(request)
            return True
        if isinstance(request, msg.ShardCheckpoint):
            return self._task_manager.restore_dataset_from_checkpoint(
                request
            )
        if isinstance(request, msg.TaskResult):
            return self._task_manager.report_task_status(
                request.dataset_name,
                request.task_id,
                success=not request.err_message,
            )
        if isinstance(request, msg.ResourceStats):
            if self._job_manager:
                self._job_manager.update_node_resource_usage(
                    node_type,
                    node_id,
                    request.cpu_percent,
                    request.memory_mb,
                    request.tpu_stats,
                )
            if self._health_engine is not None:
                self._health_engine.observe_resource(
                    node_id, request.cpu_percent, request.memory_mb
                )
            return True
        if isinstance(request, msg.GlobalStep):
            if self._speed_monitor:
                self._speed_monitor.collect_global_step(
                    request.step, request.timestamp or time.time()
                )
            if self._health_engine is not None:
                self._health_engine.observe_step(
                    node_id,
                    request.step,
                    request.timestamp or time.time(),
                )
            return True
        if isinstance(request, msg.NodeAddress):
            if self._job_manager:
                self._job_manager.update_node_address(
                    request.node_type, request.node_id, request.addr
                )
            return True
        if isinstance(request, msg.NodeTopology):
            manager = self._rdzv_managers.get(
                RendezvousName.ELASTIC_TRAINING
            )
            if manager is not None and hasattr(
                manager, "set_node_topology"
            ):
                manager.set_node_topology(
                    request.node_rank, tuple(request.levels)
                )
            return True
        if isinstance(request, msg.NetworkStatus):
            manager = self._rdzv_managers.get(
                RendezvousName.NETWORK_CHECK
            )
            if manager:
                manager.report_network_status(
                    request.node_rank,
                    request.succeeded,
                    request.elapsed_time,
                )
            return True
        if isinstance(request, msg.NodeEventMessage):
            return True
        if isinstance(request, msg.NodeFailure):
            if self._job_manager:
                self._job_manager.handle_training_failure(
                    node_type,
                    node_id,
                    request.restart_count,
                    request.error_data,
                    request.level,
                )
            if request.level == TrainingExceptionLevel.NODE_PREEMPTED:
                # graceful drain done on the node: fence it out of the
                # next round NOW so survivors' waiting-count long-polls
                # wake within one monitor interval (waiting for its
                # heartbeat to go stale would eat the preemption lead)
                training = self._rdzv_managers.get(
                    RendezvousName.ELASTIC_TRAINING
                )
                if training is not None:
                    training.fence_node(node_id)
            if self._health_engine is not None:
                self._health_engine.observe_fault(
                    node_id, request.level
                )
            return True
        if isinstance(request, msg.RendezvousParams):
            for manager in self._rdzv_managers.values():
                manager.update_rdzv_params(
                    request.min_nodes,
                    request.max_nodes,
                    request.waiting_timeout,
                    request.node_unit,
                )
            return True
        if isinstance(request, msg.KeyValuePair):
            self._kv_store.set(request.key, request.value)
            return True
        if isinstance(request, msg.ParallelConfig):
            if self._job_manager:
                self._job_manager.update_paral_config(request)
            return True
        if isinstance(request, msg.HeartBeat):
            if self._job_manager:
                self._job_manager.collect_node_heartbeat(
                    node_type, node_id, request.timestamp or time.time()
                )
            if self._health_engine is not None:
                self._health_engine.observe_heartbeat(
                    node_id, request.timestamp or time.time()
                )
            return True
        if isinstance(request, msg.NodeCheckpointState):
            manager = self._rdzv_managers.get(
                RendezvousName.ELASTIC_TRAINING
            )
            if manager:
                return manager.sync_ckpt_nodes(node_id, request.step)
            return False
        if isinstance(request, msg.ModelInfo):
            return True
        if isinstance(request, msg.DiagnosisReportData):
            if self._diagnosis_manager:
                from dlrover_tpu_torch.master.diagnosis import DiagnosisData

                self._diagnosis_manager.collect_data(
                    DiagnosisData(
                        data_type=request.data_cls,
                        content=request.data_content,
                        node_rank=request.node_rank,
                    )
                )
            return True
        if isinstance(request, msg.ProfileReport):
            if self._capture is not None:
                self._capture.record_result(
                    request.node_rank
                    if request.node_rank >= 0
                    else node_id,
                    summary=request.summary,
                    artifact=request.artifact,
                    reason=request.reason,
                    capture_id=getattr(request, "capture_id", 0),
                )
                return True
            # profiler kill-switched on the master: drop with a trace
            # (an old agent answering a pre-switch directive)
            logger.warning(
                "profile report from node %s dropped: no capture "
                "coordinator", node_id,
            )
            return False
        if isinstance(request, msg.TimelineEventsReport):
            if self._timeline_aggregator is not None:
                self._timeline_aggregator.add_events(
                    node_id, request.events
                )
            return True
        if isinstance(request, msg.Event):
            logger.info(
                "event from %s-%s: %s %s %s",
                node_type, node_id,
                request.event_type, request.action, request.msg,
            )
            return True
        if isinstance(request, (msg.SyncJoin, msg.SyncFinish,
                                msg.SyncBarrier)):
            if self._sync_service:
                return self._sync_service.handle(node_type, node_id,
                                                 request)
            return True
        if isinstance(request, msg.PsReady):
            return True
        if isinstance(request, msg.SucceededRequest):
            return True
        logger.warning("unhandled report: %r", request)
        return False


def create_master_service(port: int, servicer: MasterServicer,
                          max_workers: int = 0):
    """Build the gRPC server wired to the servicer.  ``max_workers``
    0 resolves ``DLROVER_TPU_MASTER_WORKERS`` (default 64) — each
    parked long-poll holds one of these threads for its whole wait,
    so the fan-in ceiling must be raisable without a code change."""
    return build_master_server(
        port,
        servicer.report,
        servicer.get,
        max_workers=max_workers or master_workers(),
    )
