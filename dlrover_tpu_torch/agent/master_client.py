"""Singleton agent→master client: every RPC the agent makes.

Copy of ``dlrover_tpu/agent/master_client.py``.

Reference parity: ``dlrover/python/elastic_agent/master_client.py:50``
(``MasterClient``) — one method per control-plane interaction:
rendezvous, data shards, metrics, failures, heartbeats, KV store.
Transport is the 2-RPC pickled-envelope channel
(``dlrover_tpu_torch.common.comm.MasterChannel``).
"""

import os
import threading
import time
from typing import Dict, List, Optional, Tuple

from dlrover_tpu_torch.common import messages as msg
from dlrover_tpu_torch.common.comm import MasterChannel, wait_channel_ready
from dlrover_tpu_torch.common.constants import NodeEnv, NodeType, RendezvousName
from dlrover_tpu_torch.common.env import (
    control_batch_enabled,
    control_longpoll_enabled,
    master_failover_enabled,
)
from dlrover_tpu_torch.common.fault_injection import maybe_crash
from dlrover_tpu_torch.common.log import default_logger as logger
from dlrover_tpu_torch.observability.events import get_event_logger
from dlrover_tpu_torch.observability.metrics import record_dropped_reports

#: one long-poll RPC parks on the master at most this long; waits
#: longer than a chunk loop (each chunk is still ONE rpc, so a 5 min
#: wait costs 10 RPCs instead of 1500 at a 0.2 s poll)
LONGPOLL_CHUNK_S = float(
    os.getenv("DLROVER_TPU_CONTROL_LONGPOLL_CHUNK_S", "30")
)
#: grpc deadline margin over the server-side wait: the RPC must not be
#: deadline-killed while the master is still legitimately parked
_LONGPOLL_RPC_MARGIN_S = 10.0
#: a saturated master (parked-waiter cap hit) answers a long-poll
#: immediately instead of parking; pace re-issues so the fallback is
#: a 10 Hz poll, not a hot RPC spin
_LONGPOLL_SATURATED_BACKOFF_S = 0.1


def _pace_longpoll(chunk: float, rpc_elapsed: float):
    """Sleep briefly when a long-poll chunk came back empty far sooner
    than it should have (master degraded the wait to an immediate
    answer under load)."""
    if chunk > 0.2 and rpc_elapsed < 0.05:
        time.sleep(_LONGPOLL_SATURATED_BACKOFF_S)


def _longpoll_params(wait_timeout: float):
    """ONE definition of the chunk clamp + RPC deadline: returns
    ``(clamped_wait, rpc_timeout)`` — ``rpc_timeout`` None when not
    long-polling (the channel's default applies)."""
    if wait_timeout <= 0:
        return 0.0, None
    wait_timeout = min(wait_timeout, LONGPOLL_CHUNK_S)
    return wait_timeout, wait_timeout + _LONGPOLL_RPC_MARGIN_S


class MasterClient:
    """gRPC client to the job master; one instance per process."""

    _instance: Optional["MasterClient"] = None
    _lock = threading.Lock()

    def __init__(
        self,
        master_addr: str,
        node_id: int = 0,
        node_type: str = NodeType.WORKER,
        timeout: float = 15.0,
    ):
        self._addr = master_addr
        self._node_id = node_id
        self._node_type = node_type
        self._channel = MasterChannel(
            master_addr, node_id=node_id, node_type=node_type, timeout=timeout
        )
        # delta-protocol caches: last full response + its version, so
        # a ``NotModified`` answer resolves locally
        self._comm_world_cache: Dict[
            str, Tuple[int, Tuple[int, int, Dict[int, int]]]
        ] = {}
        self._running_nodes_cache: Optional[Tuple[int, list]] = None
        #: this client's OWN kv writes (newest-last), re-asserted on
        #: an incarnation change: a master ack races the write-behind
        #: journal flush, so a crash inside the linger window loses
        #: ACKED mutations — the agent must reattach AND re-assert,
        #: like DLRover agents re-registering with a recreated master
        #: pod.  Sets are last-writer-wins, so re-asserting a value
        #: that DID survive replay is a no-op.
        self._own_kv: Dict[str, bytes] = {}
        #: pending rendezvous joins (rdzv_name -> (rank, local_ws)),
        #: re-issued on reconnect while the round is still pending —
        #: an acked-but-unflushed join otherwise parks this node on a
        #: round the restarted master doesn't know it joined
        self._pending_join: Dict[str, Tuple[int, int]] = {}
        #: dataset registrations this client made, re-asserted on an
        #: incarnation change (idempotent server-side)
        self._own_datasets: Dict[str, msg.Message] = {}
        #: last JOB epoch this client acted under: re-assertion is
        #: only valid within one job generation (-1 = not learned yet)
        self._last_job_epoch = -1
        #: Brain node directive delivered on the last WaitingNodeNum
        #: response (action, reason, decision_id); consumed by the
        #: agent via :meth:`take_node_action`
        self._node_action: Optional[Tuple[str, str, int]] = None
        # epoch fencing: a StaleEpoch-triggered refresh means the job
        # generation (or master incarnation) changed — every versioned
        # cache is void (version counters restart with the new master)
        self._channel.on_epoch_change = self._on_epoch_change

    #: own-write re-assert cache bound: coordination keys are
    #: per-round and small; only the newest matter after a restart
    MAX_OWN_KV = 256

    #: re-assertion RPC budget: these calls fire from inside another
    #: call's recovery path — each opening its own full reconnect
    #: deadline would block the outer caller minutes past its own
    REASSERT_DEADLINE_S = 15.0

    def _on_epoch_change(self, job_epoch: int, incarnation: int):
        self._comm_world_cache.clear()
        self._running_nodes_cache = None
        prev_epoch, self._last_job_epoch = (
            self._last_job_epoch, job_epoch
        )
        if prev_epoch not in (-1, job_epoch):
            # the JOB generation changed (the old job was retired):
            # this client's session state belongs to the dead
            # generation — re-asserting it would inject the retired
            # job's KV keys / datasets / joins into the new one,
            # exactly what the epoch bump exists to fence off
            self._own_kv.clear()
            self._own_datasets.clear()
            self._pending_join.clear()
            logger.warning(
                "job epoch changed %s -> %s: session state dropped, "
                "nothing re-asserted", prev_epoch, job_epoch,
            )
            return
        if prev_epoch == -1 and incarnation <= 1:
            # first epoch learn, and the master never restarted: no
            # linger-window state was lost, so there is nothing to
            # re-assert — and if this client is a straggler of a
            # RETIRED generation (it never learned the old epoch, so
            # it can't tell), re-asserting would inject dead-job
            # state into the new one.  Caches stay: a later restart
            # of THIS generation's master re-asserts normally.
            return
        logger.info(
            "master epoch refreshed: job_epoch=%s incarnation=%s "
            "(delta caches dropped, %d own kv writes re-asserted)",
            job_epoch, incarnation, len(self._own_kv),
        )
        with self._channel.bounded_deadline(self.REASSERT_DEADLINE_S):
            for key, value in list(self._own_kv.items()):
                try:
                    self._channel.report(
                        msg.KeyValuePair(key=key, value=value)
                    )
                except ConnectionError as e:
                    logger.warning(
                        "kv re-assert of %r failed: %s", key, e
                    )
                    break
            for params in list(self._own_datasets.values()):
                try:
                    self._channel.report(params)
                except ConnectionError as e:
                    logger.warning(
                        "dataset re-assert failed: %s", e
                    )
                    break
            # a node parked between join and world-received re-asserts
            # its membership too (conditional: _pending_join is popped
            # the moment a world containing this node arrives, so
            # agents that finished rendezvous can never wipe a
            # completed world here)
            for rdzv_name in list(self._pending_join):
                self._ensure_rdzv_membership(rdzv_name)

    def _record_own_kv(self, key: str, value: bytes):
        self._own_kv.pop(key, None)  # re-insert newest-last
        self._own_kv[key] = value
        while len(self._own_kv) > self.MAX_OWN_KV:
            self._own_kv.pop(next(iter(self._own_kv)))

    def _ensure_rdzv_membership(
        self, rdzv_name: str, node_rank: Optional[int] = None
    ):
        """After a master restart mid-wait: re-join the pending round
        unless the completed world already contains this node (then
        the re-parked wait consumes it; a blind re-join would wipe a
        completed world and force a full re-rendezvous)."""
        join = self._pending_join.get(rdzv_name)
        if join is None:
            return
        if node_rank is None:
            node_rank = join[0]
        try:
            _rnd, _grp, world = self.get_comm_world(
                rdzv_name, node_rank
            )
            if world and node_rank in world:
                return
            self.join_rendezvous(
                join[0], join[1], rdzv_name=rdzv_name
            )
            logger.info(
                "re-joined %s rendezvous on the new master "
                "incarnation (node %s)", rdzv_name, node_rank,
            )
        except ConnectionError as e:
            logger.warning(
                "rendezvous re-join after reconnect failed "
                "(will retry on the next outage): %s", e,
            )

    def _survive_outage(self, deadline: float, what: str) -> bool:
        """Failover path of a parked long-poll: the master died
        mid-wait.  Block until the (restarted) master's channel is
        READY again — then refresh the fencing pair so the re-issued
        wait parks on the NEW incarnation.  False when the outage
        outlives ``deadline`` or failover is kill-switched (the caller
        re-raises)."""
        if not master_failover_enabled():
            return False
        remaining = deadline - time.time()
        if remaining <= 0:
            return False
        logger.warning(
            "master unreachable during %s; waiting up to %.0fs for "
            "it to come back", what, remaining,
        )
        with get_event_logger().span("control_wait", kind="reconnect"):
            while remaining > 0:
                if wait_channel_ready(
                    self._addr, timeout=min(remaining, 10.0)
                ):
                    try:
                        # bound the probe by what's left of the
                        # caller's wait deadline — an unbounded
                        # refresh would run its own full reconnect
                        # deadline on top of it
                        self._channel.refresh_epoch(
                            deadline_s=max(
                                deadline - time.time(), 1.0
                            )
                        )
                    except ConnectionError:
                        # it flapped; keep waiting out the deadline
                        remaining = deadline - time.time()
                        continue
                    return True
                remaining = deadline - time.time()
        return False

    # ------------------------------------------------------------ lifecycle
    @classmethod
    def singleton_instance(
        cls, master_addr: str = "", node_id: Optional[int] = None
    ) -> "MasterClient":
        with cls._lock:
            if cls._instance is None:
                addr = master_addr or os.getenv(NodeEnv.MASTER_ADDR, "")
                if not addr:
                    raise RuntimeError(
                        "no master address: pass master_addr or set "
                        f"${NodeEnv.MASTER_ADDR}"
                    )
                if node_id is None:
                    node_id = int(os.getenv(NodeEnv.NODE_RANK, "0"))
                cls._instance = cls(addr, node_id=node_id)
            return cls._instance

    @classmethod
    def reset(cls):
        with cls._lock:
            if cls._instance is not None:
                cls._instance.close()
            cls._instance = None

    @property
    def addr(self) -> str:
        return self._addr

    @property
    def node_id(self) -> int:
        return self._node_id

    @property
    def rpc_count(self) -> int:
        """RPCs issued on the wire by this client (attempts)."""
        return self._channel.rpc_count

    def close(self):
        self._channel.close()

    # ----------------------------------------------------------- rendezvous
    def report_rdzv_params(
        self,
        min_nodes: int,
        max_nodes: int,
        waiting_timeout: int,
        node_unit: int = 1,
    ) -> bool:
        return self._channel.report(
            msg.RendezvousParams(
                min_nodes=min_nodes,
                max_nodes=max_nodes,
                waiting_timeout=waiting_timeout,
                node_unit=node_unit,
            )
        )

    def report_node_topology(self, node_rank: int, levels) -> bool:
        """Report this node's interconnect position (outermost level
        first) for topology-aware rank sorting."""
        return self._channel.report(
            msg.NodeTopology(node_rank=node_rank, levels=tuple(levels))
        )

    def join_rendezvous(
        self,
        node_rank: int,
        local_world_size: int,
        rdzv_name: str = RendezvousName.ELASTIC_TRAINING,
    ) -> int:
        self._pending_join[rdzv_name] = (node_rank, local_world_size)
        state = self._channel.get(
            msg.JoinRendezvousRequest(
                node_rank=node_rank,
                local_world_size=local_world_size,
                rdzv_name=rdzv_name,
            )
        )
        return state.round if state else -1

    def get_comm_world(
        self, rdzv_name: str, node_rank: int
    ) -> Tuple[int, int, Dict[int, int]]:
        """Returns (round, group, {node_rank: local_world_size}).

        Delta protocol: the request carries the version of the cached
        copy; a ``NotModified`` answer resolves from the cache without
        the master re-shipping the world.
        """
        cached = self._comm_world_cache.get(rdzv_name)
        version = cached[0] if cached else -1
        world = self._channel.get(
            msg.CommWorldRequest(
                node_id=node_rank, rdzv_name=rdzv_name, version=version
            )
        )
        if isinstance(world, msg.NotModified) and cached:
            return cached[1]
        if world is None or isinstance(world, msg.NotModified):
            return -1, 0, {}
        result = (world.round, world.group, world.world or {})
        self._comm_world_cache[rdzv_name] = (
            getattr(world, "version", 0), result
        )
        return result

    def wait_comm_world(
        self,
        rdzv_name: str,
        node_rank: int,
        timeout: float,
        poll_interval: float = 0.3,
    ) -> Tuple[int, int, Dict[int, int]]:
        """Long-poll ``get_comm_world``: block until the master
        declares the world complete (or ``timeout`` elapses — an empty
        world is then returned).  Falls back to the get-every-
        ``poll_interval`` loop under
        ``DLROVER_TPU_CONTROL_LONGPOLL=0``."""
        deadline = time.time() + max(timeout, 0.0)
        longpoll = control_longpoll_enabled()
        # a master death can be absorbed BELOW this loop (the channel
        # retries inside its reconnect deadline and re-issues the
        # parked wait transparently) — watch the incarnation between
        # iterations so a lost-in-the-linger-window join is
        # re-asserted on whichever path survived the outage
        inc_seen = self._channel.master_incarnation
        with get_event_logger().span(
            "control_wait", kind="comm_world", rdzv=rdzv_name
        ):
            while True:
                if self._channel.master_incarnation != inc_seen:
                    inc_seen = self._channel.master_incarnation
                    self._ensure_rdzv_membership(
                        rdzv_name, node_rank
                    )
                remaining = deadline - time.time()
                if remaining <= 0:
                    return -1, 0, {}
                if longpoll:
                    chunk = min(remaining, LONGPOLL_CHUNK_S)
                    t0 = time.monotonic()
                    try:
                        world = self._channel.get(
                            msg.CommWorldRequest(
                                node_id=node_rank,
                                rdzv_name=rdzv_name,
                                wait_timeout=chunk,
                            ),
                            timeout=chunk + _LONGPOLL_RPC_MARGIN_S,
                        )
                    except ConnectionError:
                        # mid-wait master death: re-park on the new
                        # incarnation.  Replay usually restored this
                        # node's join; when the join ack died in the
                        # write-behind linger window, re-assert it.
                        if self._survive_outage(
                            deadline, "comm-world wait"
                        ):
                            self._ensure_rdzv_membership(
                                rdzv_name, node_rank
                            )
                            continue
                        raise
                    if world is not None and not isinstance(
                        world, msg.NotModified
                    ):
                        result = (
                            world.round, world.group, world.world or {}
                        )
                        if result[2]:
                            if node_rank in result[2]:
                                # joined world delivered: the pending
                                # join is consumed, later monitor
                                # waits must never re-join
                                self._pending_join.pop(
                                    rdzv_name, None
                                )
                            self._comm_world_cache[rdzv_name] = (
                                getattr(world, "version", 0), result
                            )
                            return result
                    _pace_longpoll(chunk, time.monotonic() - t0)
                else:
                    rnd, group, world_map = self.get_comm_world(
                        rdzv_name, node_rank
                    )
                    if world_map:
                        if node_rank in world_map:
                            self._pending_join.pop(rdzv_name, None)
                        return rnd, group, world_map
                    time.sleep(poll_interval)

    def num_nodes_waiting(
        self,
        rdzv_name: str = RendezvousName.ELASTIC_TRAINING,
        wait_timeout: float = 0.0,
        last_num: int = -1,
    ) -> int:
        """Current waiting count; with ``wait_timeout`` > 0 the master
        long-polls until the count differs from ``last_num``."""
        wait_timeout, timeout = _longpoll_params(wait_timeout)
        res = self._channel.get(
            msg.WaitingNodeNumRequest(
                rdzv_name=rdzv_name,
                wait_timeout=wait_timeout,
                last_num=last_num,
            ),
            timeout=timeout,
        )
        if res is None:
            return 0
        # Brain directive piggyback (getattr: an old master's pickle
        # has no such fields); stashed for the agent's monitor loop
        action = getattr(res, "action", "")
        if action:
            self._node_action = (
                action,
                getattr(res, "action_reason", ""),
                int(getattr(res, "action_id", 0) or 0),
            )
        return res.waiting_num

    def take_node_action(self) -> Optional[Tuple[str, str, int]]:
        """Consume the Brain directive the last waiting-num poll
        delivered (``(action, reason, decision_id)`` or None)."""
        action, self._node_action = self._node_action, None
        return action

    def check_fault_node(self) -> Tuple[List[int], str]:
        res = self._channel.get(msg.NetworkReadyRequest())
        if res is None:
            return [], ""
        return res.nodes or [], res.reason or ""

    def check_straggler(self) -> Tuple[List[int], str]:
        res = self._channel.get(msg.StragglerExistRequest())
        if res is None:
            return [], ""
        return res.nodes or [], res.reason or ""

    def report_network_status(
        self, node_rank: int, succeeded: bool, elapsed_time: float
    ) -> bool:
        return self._channel.report(
            msg.NetworkStatus(
                node_rank=node_rank,
                succeeded=succeeded,
                elapsed_time=elapsed_time,
            )
        )

    def sync_checkpoint(self, step: int) -> bool:
        return self._channel.report(
            msg.NodeCheckpointState(step=step)
        )

    def brain_query(self, kind: str = "speed", job: str = "default",
                    limit: int = 100, workload: str = ""):
        """Query the master's durable Brain datastore; returns the
        payload dict, or None when no datastore is configured.
        ``kind="measurements"`` + ``workload`` pulls calibration
        history — usable from a DIFFERENT job's master (multi-job
        Brain)."""
        res = self._channel.get(
            msg.BrainQueryRequest(
                kind=kind, job=job, limit=limit, workload=workload
            )
        )
        if res is None or not getattr(res, "available", False):
            return None
        return res.payload

    # ------------------------------------------------------------ KV store
    def kv_store_set(self, key: str, value: bytes) -> bool:
        self._record_own_kv(key, value)
        return self._channel.report(msg.KeyValuePair(key=key, value=value))

    def kv_store_get(self, key: str) -> bytes:
        res = self._channel.get(msg.KeyValuePair(key=key))
        return res.value if res and res.value is not None else b""

    def kv_store_wait(
        self,
        key: str,
        timeout: float = 300.0,
        interval: float = 0.2,
        longpoll: Optional[bool] = None,
    ) -> bytes:
        """Block until ``key`` appears in the master KV store.

        Long-poll (default): each RPC parks on the master's KV
        condition up to ``LONGPOLL_CHUNK_S`` — an idle 5 min wait costs
        ~10 RPCs.  ``DLROVER_TPU_CONTROL_LONGPOLL=0`` (or
        ``longpoll=False``) restores the get-every-``interval`` polling
        loop as the bench reference.
        """
        if longpoll is None:
            longpoll = control_longpoll_enabled()
        deadline = time.time() + timeout
        with get_event_logger().span("control_wait", kind="kv", key=key):
            while time.time() < deadline:
                if longpoll:
                    chunk = min(
                        deadline - time.time(), LONGPOLL_CHUNK_S
                    )
                    t0 = time.monotonic()
                    try:
                        res = self._channel.get(
                            msg.KVWaitRequest(
                                key=key, wait_timeout=chunk
                            ),
                            timeout=chunk + _LONGPOLL_RPC_MARGIN_S,
                        )
                    except ConnectionError:
                        # mid-wait master death: re-park on the new
                        # incarnation (journal replay restored the KV
                        # contents, so a pre-crash set still answers)
                        if self._survive_outage(deadline, "kv wait"):
                            continue
                        raise
                    value = (
                        res.value
                        if res and res.value is not None
                        else b""
                    )
                    if value:
                        return value
                    _pace_longpoll(chunk, time.monotonic() - t0)
                else:
                    value = self.kv_store_get(key)
                    if value:
                        return value
                    time.sleep(interval)
        raise TimeoutError(f"key {key!r} not set within {timeout}s")

    # ---------------------------------------------------------- data shards
    def report_dataset_shard_params(
        self,
        dataset_name: str,
        dataset_size: int,
        batch_size: int = 0,
        num_epochs: int = 1,
        shuffle: bool = False,
        num_minibatches_per_shard: int = 2,
        storage_type: str = "table",
        task_type: str = msg.TaskType.TRAINING,
    ) -> bool:
        params = msg.DatasetShardParams(
            dataset_name=dataset_name,
            dataset_size=dataset_size,
            batch_size=batch_size,
            num_epochs=num_epochs,
            shuffle=shuffle,
            num_minibatches_per_shard=num_minibatches_per_shard,
            storage_type=storage_type,
            task_type=task_type,
        )
        # re-asserted on an incarnation change (new_dataset is a no-op
        # when the registration survived journal replay): a dataset
        # the restarted master doesn't know reads as "exhausted" to
        # every fetch_shard and silently ends the epoch
        self._own_datasets[dataset_name] = params
        return self._channel.report(params)

    def get_task(
        self, dataset_name: str, wait_timeout: float = 0.0
    ) -> msg.Task:
        """Next shard task; ``wait_timeout`` > 0 long-polls through
        WAIT answers (the master parks until a task is dispatchable).

        A mid-wait master death re-parks on the new incarnation
        (failover mode): an empty answer here would read as "dataset
        exhausted" to ``fetch_shard`` and silently end the epoch."""
        wait_timeout, timeout = _longpoll_params(wait_timeout)
        deadline = time.time() + max(wait_timeout, 5.0)
        while True:
            try:
                task = self._channel.get(
                    msg.TaskRequest(
                        dataset_name=dataset_name,
                        wait_timeout=wait_timeout,
                    ),
                    timeout=timeout,
                )
                break
            except ConnectionError:
                if self._survive_outage(deadline, "task wait"):
                    continue
                raise
        return task if task is not None else msg.Task(task_id=-1)

    def report_task_result(
        self, dataset_name: str, task_id: int, err_message: str = ""
    ) -> bool:
        return self._channel.report(
            msg.TaskResult(
                dataset_name=dataset_name,
                task_id=task_id,
                err_message=err_message,
            )
        )

    def get_shard_checkpoint(self, dataset_name: str):
        return self._channel.get(
            msg.ShardCheckpointRequest(dataset_name=dataset_name)
        )

    def report_shard_checkpoint(
        self, dataset_name: str, content: str
    ) -> bool:
        return self._channel.report(
            msg.ShardCheckpoint(dataset_name=dataset_name, content=content)
        )

    # -------------------------------------------------------------- metrics
    def report_global_step(
        self, step: int, timestamp: Optional[float] = None
    ) -> bool:
        return self._channel.report(
            msg.GlobalStep(step=step, timestamp=timestamp or time.time())
        )

    def report_resource_stats(
        self,
        cpu_percent: float,
        memory_mb: float,
        tpu_stats: Optional[list] = None,
    ) -> bool:
        return self._channel.report(
            msg.ResourceStats(
                cpu_percent=cpu_percent,
                memory_mb=memory_mb,
                tpu_stats=tpu_stats or [],
            )
        )

    def report_model_info(
        self,
        num_params: int,
        flops_per_step: float = 0.0,
        hidden_size: int = 0,
        num_layers: int = 0,
        seq_len: int = 0,
        extra=None,
    ) -> bool:
        return self._channel.report(
            msg.ModelInfo(
                num_params=num_params,
                flops_per_step=flops_per_step,
                hidden_size=hidden_size,
                num_layers=num_layers,
                seq_len=seq_len,
                extra=extra or {},
            )
        )

    def report_node_address(
        self, node_type: str, node_id: int, addr: str
    ) -> bool:
        return self._channel.report(
            msg.NodeAddress(node_type=node_type, node_id=node_id, addr=addr)
        )

    def report_heartbeat(self, timestamp: Optional[float] = None) -> bool:
        return self._channel.report(
            msg.HeartBeat(timestamp=timestamp or time.time())
        )

    def report_failure(
        self, error_data: str, restart_count: int = 0, level: str = "warning"
    ) -> bool:
        return self._channel.report(
            msg.NodeFailure(
                error_data=error_data,
                restart_count=restart_count,
                level=level,
            )
        )

    def report_succeeded(self) -> bool:
        return self._channel.report(msg.SucceededRequest())

    def report_profile(
        self,
        node_rank: int,
        kind: str = "capture",
        reason: str = "",
        capture_id: int = 0,
        summary: Optional[Dict] = None,
        artifact: str = "",
    ) -> bool:
        """Ship one deep-capture result (parsed profile summary +
        artifact path) to the master's CaptureCoordinator."""
        return self._channel.report(
            msg.ProfileReport(
                node_rank=node_rank,
                kind=kind,
                reason=reason,
                capture_id=capture_id,
                summary=summary or {},
                artifact=artifact,
            )
        )

    def report_timeline_events(self, events: list) -> bool:
        """Ship a batch of timeline records (``observability/events``
        JSONL schema) to the master's TimelineAggregator."""
        return self._channel.report(
            msg.TimelineEventsReport(events=list(events))
        )

    def get_job_status(
        self, job: str = "", conclusions: int = 16
    ) -> Optional[Dict]:
        """Fetch the master observatory's derived snapshot (per-node
        health, goodput ledger, newest diagnosis conclusions); None
        when the observatory is off (``DLROVER_TPU_OBSERVATORY=0``)
        or the master predates it."""
        res = self._channel.get(
            msg.JobStatusRequest(job=job, conclusions=conclusions)
        )
        if res is None or not getattr(res, "available", False):
            return None
        return res.status

    def get_goodput_ledger(
        self, job: str = "", limit: int = 0
    ) -> Optional[Tuple[Dict, list]]:
        """Fetch the master's merged goodput ledger (and the newest
        ``limit`` raw events); None when no aggregator is serving."""
        res = self._channel.get(
            msg.TimelineQueryRequest(job=job, limit=limit)
        )
        if res is None or not getattr(res, "available", False):
            return None
        return res.ledger, res.events

    # -------------------------------------------------------------- control
    def get_running_nodes(self) -> list:
        """Running node list; versioned — an unchanged master answers
        ``NotModified`` and the cached copy is returned."""
        cached = self._running_nodes_cache
        version = cached[0] if cached else -1
        res = self._channel.get(msg.RunningNodesRequest(version=version))
        if isinstance(res, msg.NotModified) and cached:
            return cached[1]
        if res is None or isinstance(res, msg.NotModified):
            return []
        nodes = res.nodes or []
        self._running_nodes_cache = (getattr(res, "version", 0), nodes)
        return nodes

    def get_training_status(self, wait_timeout: float = 0.0) -> str:
        """Training-loop status; ``wait_timeout`` > 0 long-polls until
        training starts (or the timeout elapses)."""
        wait_timeout, timeout = _longpoll_params(wait_timeout)
        res = self._channel.get(
            msg.TrainingStatusRequest(wait_timeout=wait_timeout),
            timeout=timeout,
        )
        return res.status if res else ""

    def get_paral_config(self) -> msg.ParallelConfig:
        res = self._channel.get(msg.ParallelConfigRequest())
        return res if res is not None else msg.ParallelConfig()

    def report_paral_config(self, config: msg.ParallelConfig) -> bool:
        return self._channel.report(config)

    def need_to_restart_training(self) -> bool:
        res = self._channel.get(msg.CheckHardwareResetRequest())
        return bool(res and getattr(res, "restart", False))

    def get_elastic_run_config(self) -> Dict[str, str]:
        res = self._channel.get(msg.ElasticRunConfigRequest())
        return res.configs if res and res.configs else {}

    def report_diagnosis_data(
        self, data_cls: str, data_content: str, node_rank: int = -1
    ) -> bool:
        return self._channel.report(
            msg.DiagnosisReportData(
                data_cls=data_cls,
                data_content=data_content,
                node_rank=node_rank,
            )
        )


class ReportBuffer:
    """Client-side coalescer for fire-and-forget reports.

    Heartbeats, speed/metric samples, node events, and timeline
    batches accumulate here and ship as ONE ``BatchedReport`` envelope
    when either threshold trips — ``max_items`` (flushed inline by the
    adder) or ``max_age_s`` (flushed by a daemon thread).  Item order
    is preserved end to end: flushes are serialized, and a
    transport-failed batch is re-queued at the FRONT so nothing is
    reordered or lost across a master hiccup or an agent restart
    (``flush`` runs on shutdown and before every rendezvous).

    The buffer is BOUNDED (``max_pending``): reports are advisory
    telemetry, so when a master outage outlives the buffer the OLDEST
    items are dropped (counted on
    ``dlrover_tpu_control_dropped_reports`` + a warning) — a long
    outage must degrade observability, never OOM the agent.

    ``DLROVER_TPU_CONTROL_BATCH=0`` degenerates ``add`` to the old
    one-RPC-per-report path.
    """

    def __init__(
        self,
        client: MasterClient,
        max_items: int = 64,
        max_age_s: float = 1.0,
        auto_flush: bool = True,
        max_pending: int = 4096,
    ):
        self._client = client
        self._max_items = max_items
        self._max_age_s = max_age_s
        self._max_pending = max(max_pending, 1)
        #: lifetime tally of overflow-dropped reports
        self.dropped = 0
        self._lock = threading.Lock()
        #: serializes flushes: two concurrent flushes could otherwise
        #: ship their batches out of order
        self._flush_lock = threading.Lock()
        self._items: List[msg.Message] = []
        self._stopped = threading.Event()
        self._thread: Optional[threading.Thread] = None
        if auto_flush:
            self._thread = threading.Thread(
                target=self._loop, name="report-buffer", daemon=True
            )
            self._thread.start()

    @property
    def pending(self) -> int:
        with self._lock:
            return len(self._items)

    def _trim_locked(self):
        """Caller holds the lock: enforce the bound by dropping the
        OLDEST items (the newest telemetry is the useful telemetry
        when the master comes back)."""
        overflow = len(self._items) - self._max_pending
        if overflow <= 0:
            return
        del self._items[:overflow]
        self.dropped += overflow
        record_dropped_reports(overflow)
        logger.warning(
            "report buffer overflow: dropped %d oldest reports "
            "(%d total dropped) — master unreachable too long?",
            overflow, self.dropped,
        )

    def add(self, message: msg.Message) -> bool:
        """Queue one report (or send it straight through when batching
        is disabled).  Returns the delivery ack for the direct path;
        for a buffered enqueue it returns True unconditionally — the
        buffer owns delivery from here (a transport-failed inline
        flush re-queues the batch, so the report is still owed, not
        lost or rejected)."""
        if not control_batch_enabled():
            return self._client._channel.report(message)
        with self._lock:
            self._items.append(message)
            self._trim_locked()
            full = len(self._items) >= self._max_items
        if full:
            self.flush()
        return True

    def flush(self) -> bool:
        """Ship everything pending as one ``BatchedReport``.  A
        transport failure re-queues the batch at the front (no loss
        below the ``max_pending`` bound, no reorder); a master-side
        handler failure is dropped with a warning — exactly what the
        old per-report path did with its False ack."""
        with self._flush_lock:
            with self._lock:
                items, self._items = self._items, []
            if not items:
                return True
            # chaos hook: agent death between drain and send loses
            # the batch with the process, like any crash would
            maybe_crash("mid_report_flush")
            try:
                ok = self._client._channel.report(
                    msg.BatchedReport(items=items)
                )
            except ConnectionError as e:
                logger.warning(
                    "report batch of %d undeliverable (%s); re-queued",
                    len(items), e,
                )
                with self._lock:
                    self._items[0:0] = items
                    self._trim_locked()
                return False
            if not ok:
                logger.warning(
                    "master rejected a report batch of %d items; "
                    "dropping it", len(items),
                )
            return ok

    def _loop(self):
        while not self._stopped.wait(self._max_age_s):
            try:
                self.flush()
            except Exception as e:  # noqa: BLE001 - reporter must survive
                logger.warning("report buffer flush failed: %s", e)

    def close(self):
        """Stop the age flusher and drain (agent shutdown — buffered
        reports must survive the process)."""
        self._stopped.set()
        if self._thread is not None:
            self._thread.join(timeout=5.0)
            self._thread = None
        try:
            self.flush()
        except Exception as e:  # noqa: BLE001
            logger.warning("report buffer final flush failed: %s", e)
