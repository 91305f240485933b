"""The per-node elastic agent: rendezvous, worker lifecycle, failover.

Reference parity: ``dlrover/python/elastic_agent/torch/training.py`` —
``ElasticLaunchConfig:118``, ``MasterRendezvousHandler:181``,
``ElasticTrainingAgent:364`` (``_invoke_run:582`` monitor loop,
``_initialize_workers:547``, restart-on-membership-change ``:716``),
``launch_agent:776`` and the node-check agent ``:906``.

Port of ``dlrover_tpu/agent/training.py``.  The rank-0 agent publishes
the ``torch.distributed`` coordinator address (``host:port``) under
``torch_coordinator/<round>`` in the master KV store, and each training
process hands it to ``init_process_group`` as ``tcp://host:port`` with
the world the master's rendezvous assembled
(``trainer/elastic/context.py``).  Every re-mesh fully restarts the
training processes, as the reference does on membership change
(``training.py:646-648``).  ``compile_cache_dir`` becomes the kernels'
build directory (``DLROVER_TPU_TORCH_BUILD_DIR``), so restarted workers
load the ``.so`` files the first incarnation built.

As in the reference, the agent can fork its workers from a zygote that
imported torch and the port once (``prefork``, ``agent/zygote.py``),
run a health check of the node's cards before each rendezvous
(``network_check``, ``agent/node_check.py``), and watches the cloud
metadata server for a maintenance event (``watch_preemption``, on by
default, ``agent/preemption.py``), which drains, flushes and fences the
node.  Workers restore through the overlapped restart path unless
``restart_overlap`` is off (``DLROVER_TPU_RESTART_OVERLAP=0``).  Beyond
the reference, the agent runs the resource, heartbeat and
training-progress monitors (``agent/monitor.py``), which the reference
defines and starts nowhere.  Not ported yet: the deep-capture directive
(ROADMAP A7), which the port's master never sends.  The SIGTERM
drain is always installed (the port has no ``DLROVER_TPU_RESHARD``
switch).
"""

import json
import os
import shutil
import signal
import socket
import subprocess
import sys
import tempfile
import time
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Sequence

from dlrover_tpu_torch.agent.ckpt_saver import AsyncCheckpointSaver
from dlrover_tpu_torch.agent.master_client import MasterClient, ReportBuffer
from dlrover_tpu_torch.common.constants import (
    AgentExitCode,
    NodeEnv,
    RendezvousConstant,
    RendezvousName,
    TrainingExceptionLevel,
)
from dlrover_tpu_torch.common.env import (
    RESTART_OVERLAP_ENV,
    control_longpoll_enabled,
    env_float,
    get_free_port,
    preempt_drain_grace_s,
)
from dlrover_tpu_torch.common.log import default_logger as logger
from dlrover_tpu_torch.observability.events import get_event_logger

from dlrover_tpu_torch.agent.zygote import SPAWN_ENV

#: when the agent spawned the worker (host clock; ``SPAWN_ENV`` says how)
SPAWNED_AT_ENV = "DLROVER_TPU_SPAWNED_AT"
#: the worker's step file (TrainingMonitor) and card stats
#: (ResourceMonitor), in the agent's own directory
STEP_FILE_ENV = "DLROVER_TPU_STEP_FILE"
CHIP_STATS_ENV = "DLROVER_TPU_CHIP_STATS_FILE"


@dataclass
class ElasticLaunchConfig:
    """Launch flags (reference ``ElasticLaunchConfig`` ``training.py:118``)."""

    min_nodes: int = 1
    max_nodes: int = 1
    nproc_per_node: int = 1
    rdzv_timeout: int = RendezvousConstant.MAX_WAIT_SECS
    # master-side window rule: how long after the last join an
    # under-max round waits before completing with what it has.
    # <0 = rdzv_timeout (the historical coupling).  The preemption
    # harness shortens THIS without shrinking the join wait: a lone
    # survivor must re-mesh in seconds, while a joining node may
    # legitimately wait minutes for peers.
    rdzv_waiting_timeout: float = -1.0
    node_unit: int = 1
    network_check: bool = False
    comm_perf_test: bool = False
    max_restarts: int = 3
    monitor_interval: float = 5.0
    # SIGTERM -> SIGKILL grace when stopping workers.  A worker blocked
    # in a collective (the COMMON failure posture: every survivor of a
    # peer crash is stalled in an allreduce/barrier) cannot run Python
    # signal handlers, so it always eats the full grace period —
    # recovery latency is dominated by this knob.
    stop_timeout: float = 15.0
    # grace used instead of stop_timeout when restarting after a
    # WORKER FAILURE: the group is already broken (survivors are wedged
    # in a collective against a dead peer, and the agent has already
    # flushed the shm checkpoint itself), so a long SIGTERM grace buys
    # nothing but recovery latency
    failure_stop_timeout: float = 1.0
    # fork restarted workers from a pre-imported zygote process
    # (agent/zygote.py): removes the import torch / torch._dynamo chain
    # from every restart's critical path
    prefork: bool = False
    node_rank: int = field(
        default_factory=lambda: int(os.getenv(NodeEnv.NODE_RANK, "0"))
    )
    # extra env vars injected into every training process
    envs: Dict[str, str] = field(default_factory=dict)
    # the kernels' build directory (DLROVER_TPU_TORCH_BUILD_DIR): a
    # restarted worker loads the .so files built before it
    compile_cache_dir: str = ""
    # overlapped restart critical path in the workers (restore prefetch
    # beside the state build, trainer/restart_path.py); False exports
    # DLROVER_TPU_RESTART_OVERLAP=0 so every worker restores serially
    restart_overlap: bool = True
    # watch the cloud metadata maintenance-event endpoint: a maintenance
    # or spot event fires there ~60s before any SIGTERM
    # (agent/preemption.py)
    watch_preemption: bool = True

    def auto_configure_params(self):
        """Fill nproc from local device count when unset (reference
        ``auto_configure_params`` ``training.py:155``)."""
        if self.nproc_per_node <= 0:
            self.nproc_per_node = 1
        if self.max_nodes < self.min_nodes:
            self.max_nodes = self.min_nodes


class WorkerState:
    INIT = "INIT"
    HEALTHY = "HEALTHY"
    FAILED = "FAILED"
    SUCCEEDED = "SUCCEEDED"


@dataclass
class RunResult:
    state: str = WorkerState.INIT
    failed_ranks: List[int] = field(default_factory=list)
    return_codes: Dict[int, int] = field(default_factory=dict)


class MasterRendezvousHandler:
    """Master-backed rendezvous (reference ``training.py:181``).

    ``next_rendezvous`` joins the master round, polls until the master
    declares the world complete, and returns
    ``(round, rank, world_size, world)`` where ``world`` maps
    node_rank -> local_world_size for every participating node.
    """

    def __init__(
        self,
        client: MasterClient,
        node_rank: int,
        local_world_size: int,
        rdzv_name: str = RendezvousName.ELASTIC_TRAINING,
        timeout: float = RendezvousConstant.MAX_WAIT_SECS,
        poll_interval: float = 0.3,
    ):
        self._client = client
        self._node_rank = node_rank
        self._local_world_size = local_world_size
        self._rdzv_name = rdzv_name
        self._timeout = timeout
        self._poll = poll_interval

    def next_rendezvous(self):
        # topology hint (e.g. "superpod0/pod1/slice2") enables
        # topology-aware rank sorting on the master; absent = no-op
        topo = os.getenv("DLROVER_TPU_TOPOLOGY", "")
        if topo:
            try:
                self._client.report_node_topology(
                    self._node_rank, tuple(topo.split("/"))
                )
            except Exception as e:  # noqa: BLE001
                logger.warning("topology report failed: %s", e)
        rdzv_round = self._client.join_rendezvous(
            self._node_rank, self._local_world_size, self._rdzv_name
        )
        logger.info(
            "node %d joined %s rendezvous round %d",
            self._node_rank,
            self._rdzv_name,
            rdzv_round,
        )
        # long-poll: the RPC parks on the master's rendezvous condition
        # and returns the moment the round completes — one RPC per
        # ~30 s chunk instead of one every 0.3 s.  wait_comm_world
        # falls back to the exact old get/sleep loop under
        # DLROVER_TPU_CONTROL_LONGPOLL=0.
        rnd, group, world = self._client.wait_comm_world(
            self._rdzv_name,
            self._node_rank,
            timeout=self._timeout,
            poll_interval=self._poll,
        )
        if world:
            if self._node_rank not in world:
                raise NodeExcludedError(
                    f"node {self._node_rank} excluded from round {rnd}"
                )
            return rnd, group, world
        raise TimeoutError(
            f"rendezvous {self._rdzv_name!r} timed out after {self._timeout}s"
        )


class NodeExcludedError(RuntimeError):
    """The master left this node out of the comm world (fault/straggler)."""


class ElasticTrainingAgent:
    """Spawns and supervises the node's training processes.

    The monitor loop (reference ``_invoke_run`` ``training.py:582``):

    - any proc FAILED  -> report to master, flush shm ckpt, restart
    - all procs done   -> SUCCEEDED, exit
    - master says new nodes waiting -> flush shm ckpt, restart (re-mesh)
    """

    def __init__(
        self,
        config: ElasticLaunchConfig,
        entrypoint: Sequence[str],
        client: Optional[MasterClient] = None,
        start_ckpt_saver: bool = True,
    ):
        self._config = config
        self._entrypoint = list(entrypoint)
        self._client = client or MasterClient.singleton_instance()
        self._node_rank = config.node_rank
        self._procs: List[subprocess.Popen] = []
        self._restart_count = 0
        self._remaining_restarts = config.max_restarts
        self._start_ckpt_saver = start_ckpt_saver
        self._coordinator_port = get_free_port()
        self._stopped = False
        #: the node received a preemption notice / SIGTERM: it must
        #: drain + flush, NOT restart into the next rendezvous (the
        #: hardware is going away; the master has fenced it)
        self._preempted = False
        #: the master excluded this node from the comm world
        self._excluded = False
        #: world size of the previous completed round (exported to
        #: workers as DLROVER_TPU_PREV_WORLD so the trainer can
        #: re-solve its parallelism strategy on a world change)
        self._last_world_size = 0
        #: last waiting-node count seen by the monitor pacing long-poll
        self._last_waiting = 0
        #: shared coalescing buffer for fire-and-forget reports
        #: (timeline batches, heartbeats, metric samples); flushed
        #: before every rendezvous and drained on shutdown
        self._report_buffer: Optional[ReportBuffer] = None
        #: the fork server workers are spawned from (``prefork``)
        self._zygote = None
        #: this agent's own directory for the workers' step file and
        #: card stats (removed when the agent exits)
        self._job_dir = ""
        #: the last node check's timings ({"elapsed", "matmul_ms", ...}
        #: of the slowest local process) and the master's verdict
        self.node_check: Optional[dict] = None

    # ------------------------------------------------------------- workers
    def _rendezvous(self):
        if self._report_buffer is not None:
            # nothing buffered may straddle a restart: the world (and
            # possibly this process) changes on the other side
            self._report_buffer.flush()
        handler = MasterRendezvousHandler(
            self._client,
            self._node_rank,
            self._config.nproc_per_node,
            timeout=self._config.rdzv_timeout,
        )
        # chaos hook: an agent SIGKILLed here has joined nothing yet —
        # the master's window rule must simply proceed without it
        from dlrover_tpu_torch.common.fault_injection import maybe_crash

        maybe_crash("mid_rendezvous")
        with get_event_logger().span(
            "rendezvous", inc=self._restart_count
        ):
            rnd, _group, world = handler.next_rendezvous()
        return rnd, world

    def _assign_worker_ranks(self, world: Dict[int, int]):
        """Global process ranks from the node world, in the MASTER's
        order (reference ``_assign_worker_ranks`` ``training.py:486``).
        The master emits the world topology-sorted (interconnect
        neighbors adjacent); dict insertion order survives the pickled
        transport, so the received order IS the rank order."""
        sorted_nodes = list(world)
        world_size = sum(world.values())
        rank_offset = 0
        for nr in sorted_nodes:
            if nr == self._node_rank:
                break
            rank_offset += world[nr]
        num_processes = world_size
        process_ids = list(
            range(rank_offset, rank_offset + world[self._node_rank])
        )
        node_index = sorted_nodes.index(self._node_rank)
        return world_size, num_processes, process_ids, node_index

    def _publish_coordinator(self, rdzv_round: int, is_first_node: bool):
        """Rank-0 node publishes the torch.distributed coordinator
        address via the master KV store; everyone else waits for it.

        This replaces the reference's ``MasterKVStore`` MASTER_ADDR /
        MASTER_PORT exchange (``master_kv_store.py``, ``training.py:252``).
        """
        key = f"torch_coordinator/{rdzv_round}"
        if is_first_node:
            host = os.getenv(
                "DLROVER_TPU_HOST_IP", socket.gethostbyname(socket.gethostname())
            )
            addr = f"{host}:{self._coordinator_port}"
            self._client.kv_store_set(key, addr.encode())
            return addr
        return self._client.kv_store_wait(
            key, timeout=self._config.rdzv_timeout
        ).decode()

    def _worker_env(
        self,
        rdzv_round: int,
        coordinator: str,
        world_size: int,
        process_rank: int,
        local_rank: int,
        node_index: int,
    ) -> Dict[str, str]:
        env = dict(os.environ)
        env.update(self._config.envs)
        env.update(
            {
                NodeEnv.MASTER_ADDR: self._client.addr,
                NodeEnv.NODE_RANK: str(self._node_rank),
                NodeEnv.NODE_INDEX: str(node_index),
                NodeEnv.PROCESS_RANK: str(process_rank),
                NodeEnv.PROCESS_COUNT: str(world_size),
                NodeEnv.LOCAL_RANK: str(local_rank),
                NodeEnv.LOCAL_PROCESS_COUNT: str(
                    self._config.nproc_per_node
                ),
                NodeEnv.COORDINATOR_ADDR: coordinator,
                "DLROVER_TPU_RDZV_ROUND": str(rdzv_round),
                "DLROVER_TPU_RESTART_COUNT": str(self._restart_count),
                # the previous round's world size: a relaunched
                # trainer compares it against the new world to decide
                # whether its pinned parallelism strategy must be
                # re-solved (accelerate/solver.resolve_for_world)
                "DLROVER_TPU_PREV_WORLD": str(self._last_world_size),
            }
        )
        if self._config.compile_cache_dir:
            env.setdefault(
                NodeEnv.KERNEL_BUILD_DIR, self._config.compile_cache_dir)
        if not self._config.restart_overlap:
            env[RESTART_OVERLAP_ENV] = "0"
        if self._job_dir:
            env[STEP_FILE_ENV] = os.path.join(self._job_dir, "step.json")
            env[CHIP_STATS_ENV] = os.path.join(self._job_dir, "cards")
        # how and when the worker was spawned (a zygote child overrides
        # the first): what a restart's breakdown starts from
        env[SPAWN_ENV] = "plain"
        env[SPAWNED_AT_ENV] = repr(time.time())
        return env

    def _initialize_workers(self) -> bool:
        """One rendezvous round + process spawn. Returns False when the
        master excluded this node."""
        if self._config.network_check:
            self._run_network_check()
        try:
            rdzv_round, world = self._rendezvous()
        except NodeExcludedError as e:
            # a scheduling verdict, not a crash: surface it as its
            # own failure level + a distinct agent exit code so the
            # controller does not reschedule the node into this job
            logger.error("%s", e)
            self._excluded = True
            self._try_report_failure(
                str(e), TrainingExceptionLevel.NODE_EXCLUDED
            )
            return False
        except (TimeoutError, ConnectionError) as e:
            logger.error("rendezvous failed: %s", e)
            self._try_report_failure(
                f"rendezvous: {e}", TrainingExceptionLevel.RDZV_ERROR
            )
            return False
        (
            world_size,
            _num,
            process_ids,
            node_index,
        ) = self._assign_worker_ranks(world)
        try:
            coordinator = self._publish_coordinator(
                rdzv_round, node_index == 0
            )
        except (TimeoutError, ConnectionError) as e:
            logger.error("coordinator exchange failed: %s", e)
            self._try_report_failure(
                f"coordinator exchange: {e}",
                TrainingExceptionLevel.RDZV_ERROR,
            )
            return False
        logger.info(
            "round %d: world_size=%d coordinator=%s local ranks=%s",
            rdzv_round,
            world_size,
            coordinator,
            process_ids,
        )
        self._procs = []
        for local_rank, process_rank in enumerate(process_ids):
            env = self._worker_env(
                rdzv_round, coordinator, world_size, process_rank,
                local_rank, node_index,
            )
            if self._zygote is not None:
                proc = self._zygote.spawn(self._entrypoint, env)
            else:
                proc = subprocess.Popen(  # noqa: S603
                    self._entrypoint, env=env
                )
            self._procs.append(proc)
        self._last_world_size = world_size
        return True

    # ------------------------------------------------------------- monitor
    def _monitor_workers(self) -> RunResult:
        result = RunResult(state=WorkerState.HEALTHY)
        codes: Dict[int, int] = {}
        running = 0
        for local_rank, proc in enumerate(self._procs):
            rc = proc.poll()
            if rc is None:
                running += 1
            else:
                codes[local_rank] = rc
                if rc != 0:
                    result.failed_ranks.append(local_rank)
        result.return_codes = codes
        if result.failed_ranks:
            result.state = WorkerState.FAILED
        elif running == 0:
            result.state = WorkerState.SUCCEEDED
        return result

    def _pace_monitor(self):
        """One monitor-interval pause.  Under long-poll the pause IS
        the waiting-count RPC parked on the master — the same one RPC
        per tick as the old sleep+poll pair, but a membership change
        wakes the loop INSTANTLY instead of at the next tick.  The
        legacy plain sleep survives the kill-switch."""
        interval = self._config.monitor_interval
        if not control_longpoll_enabled():
            time.sleep(interval)
            return
        try:
            self._last_waiting = self._client.num_nodes_waiting(
                wait_timeout=interval, last_num=self._last_waiting
            )
        except ConnectionError:
            # unreachable master must read as "no membership change"
            # (the old polling path returned False here) — a stale
            # nonzero count would fire a restart storm every tick for
            # the whole outage
            self._last_waiting = 0
            time.sleep(interval)

    def _membership_changed(self) -> bool:
        if control_longpoll_enabled():
            # _pace_monitor just fetched it — no second RPC
            waiting = self._last_waiting
        else:
            try:
                waiting = self._client.num_nodes_waiting()
            except ConnectionError:
                return False
        node_unit = max(self._config.node_unit, 1)
        return waiting > 0 and waiting % node_unit == 0

    def _stop_workers(self, timeout: Optional[float] = None):
        if timeout is None:
            timeout = self._config.stop_timeout
        for proc in self._procs:
            if proc.poll() is None:
                proc.send_signal(signal.SIGTERM)
        deadline = time.time() + timeout
        for proc in self._procs:
            remaining = max(deadline - time.time(), 0.1)
            try:
                proc.wait(timeout=remaining)
            except subprocess.TimeoutExpired:
                proc.kill()
                proc.wait()
        self._procs = []

    def _save_ckpt_to_storage(self, reason: str):
        """Flush the latest shm checkpoint snapshot before killing
        workers (reference ``_save_ckpt_to_storage`` ``training.py:670``)."""
        saver = AsyncCheckpointSaver.get_ckpt_saver()
        if saver is not None:
            try:
                saver.save_shm_to_storage(reason=reason)
            except Exception as e:  # noqa: BLE001
                logger.warning("breakpoint ckpt flush failed: %s", e)

    def _drain_worker_snapshots(self, reason: str):
        """Graceful drain: ask every live worker (SIGUSR1 →
        ``trainer/drain.py``) to snapshot at each step boundary, then
        wait — bounded by ``DLROVER_TPU_PREEMPT_DRAIN_GRACE_S`` — for
        a FRESH common step to land in shm, so the flush that follows
        persists the step the world just completed instead of the
        last periodic snapshot.  Workers wedged in a collective
        simply cannot advance; the grace expires and the flush uses
        the newest complete snapshot, exactly today's behavior.
        """
        live = [p for p in self._procs if p.poll() is None]
        if not live:
            return
        from dlrover_tpu_torch.trainer.drain import DRAIN_SIGNAL

        saver = AsyncCheckpointSaver.get_ckpt_saver()
        before = saver.max_common_step() if saver is not None else -1
        for proc in live:
            try:
                proc.send_signal(DRAIN_SIGNAL)
            except (ProcessLookupError, OSError):
                pass
        grace = preempt_drain_grace_s()
        logger.info(
            "drain requested of %d workers (%s); waiting up to "
            "%.1fs for a fresh snapshot (current common step %s)",
            len(live), reason, grace, before,
        )
        if saver is None:
            # no agent-side saver (tests / exotic embeddings): give
            # the workers one bounded beat to run their drain saves
            time.sleep(min(grace, 1.0))
            return
        deadline = time.time() + grace
        while time.time() < deadline:
            common = saver.max_common_step()
            if common > before >= 0 or (before < 0 <= common):
                logger.info(
                    "drain snapshot landed at step %s", common
                )
                return
            if all(p.poll() is not None for p in live):
                return  # nothing left to wait on
            time.sleep(0.1)
        logger.warning(
            "drain grace expired (%.1fs); flushing the newest "
            "complete snapshot (step %s)", grace,
            saver.max_common_step(),
        )

    def _restart_workers(
        self, reason: str, consume_budget: bool = True
    ) -> bool:
        """Restart the local worker set.  Failure restarts consume the
        budget; elastic re-mesh restarts (membership change) do not —
        a healthy job that scales N times must not die on the N+1th
        node join (torchelastic decrements only on failures)."""
        if consume_budget:
            if self._remaining_restarts <= 0:
                logger.error("restart budget exhausted (%s)", reason)
                return False
            self._remaining_restarts -= 1
        self._restart_count += 1
        logger.info(
            "restarting workers (%s); %d restarts left",
            reason,
            self._remaining_restarts,
        )
        # the span's inc is the NEW incarnation this restart produces,
        # correlating it with the relaunched workers' step/compile
        # spans; the nested rendezvous span carves its own share out
        # of the restart loss in the ledger
        with get_event_logger().span(
            "restart", reason=reason, inc=self._restart_count
        ):
            if not consume_budget:
                # elastic re-mesh: the workers are still coupled and
                # stepping — drain them so the flush below persists a
                # FRESH step for the new world to reshard from (a
                # failure restart skips this: the group is broken and
                # nothing can advance)
                self._drain_worker_snapshots(reason)
            self._save_ckpt_to_storage(reason)
            # failure restarts: the group is broken and the shm
            # snapshot is already flushed — survivors wedged in
            # collectives would eat the full stop grace for nothing
            self._stop_workers(
                timeout=self._config.failure_stop_timeout
                if consume_budget
                else None
            )
            return self._initialize_workers()

    def _report_failure(self, result: RunResult):
        self._try_report_failure(
            str(result.return_codes), TrainingExceptionLevel.PROCESS_ERROR
        )

    def _try_report_failure(self, error_data: str, level: str):
        try:
            self._client.report_failure(
                error_data=error_data,
                restart_count=self._restart_count,
                level=level,
            )
        except ConnectionError as e:
            logger.warning("failed reporting failure to master: %s", e)

    def _run_network_check(self):
        """Pre-flight node health check round (reference
        ``run_network_check`` ``training.py:1154``): the network-check
        rendezvous, then one payload process a local card
        (``agent/node_check.py``) in a process group of their own; the
        slowest one's seconds go to the master, whose verdict is
        logged.  Raises when the payload failed."""
        with tempfile.TemporaryDirectory(prefix="node_check_") as tmp:
            handler = MasterRendezvousHandler(
                self._client,
                self._node_rank,
                self._config.nproc_per_node,
                rdzv_name=RendezvousName.NETWORK_CHECK,
                timeout=self._config.rdzv_timeout,
            )
            try:
                handler.next_rendezvous()
            except (TimeoutError, NodeExcludedError) as e:
                logger.warning("network-check rendezvous failed: %s", e)
                return
            with get_event_logger().span(
                    "node_check", inc=self._restart_count):
                results, rc = self._run_node_check_payload(tmp)
        elapsed = max((r["elapsed"] for r in results), default=-1.0)
        self._client.report_network_status(
            self._node_rank, succeeded=(rc == 0), elapsed_time=elapsed
        )
        faults, reason = self._client.check_fault_node()
        slowest = max(results, key=lambda r: r["elapsed"], default={})
        self.node_check = dict(slowest, fault_nodes=faults, reason=reason)
        spawns = ",".join(sorted({r.get("spawn", "?") for r in results}))
        logger.info(
            "node check of node %d (%s spawn): %s in %.3fs; master "
            "verdict: fault nodes %s%s", self._node_rank, spawns or "no",
            "passed" if rc == 0 else f"failed (exit {rc})", elapsed,
            faults, f" ({reason})" if reason else " (normal)")
        if rc != 0:
            raise RuntimeError(
                f"node {self._node_rank} failed the health check"
            )

    def _run_node_check_payload(self, tmp: str):
        """Run ``nproc_per_node`` payload processes, forked from the
        zygote when there is one (no ``import torch`` of their own);
        returns (their results, the worst exit code).  A wedged card
        must not hang the agent: a payload still running after 300 s is
        killed."""
        from dlrover_tpu_torch.agent import node_check

        nproc = max(self._config.nproc_per_node, 1)
        addr = f"127.0.0.1:{get_free_port()}"
        procs = []
        for rank in range(nproc):
            env = dict(os.environ)
            env.update(self._config.envs)
            env.update({
                node_check.RESULT_FILE_ENV: os.path.join(tmp, f"{rank}"),
                node_check.RANK_ENV: str(rank),
                node_check.WORLD_ENV: str(nproc),
                node_check.ADDR_ENV: addr,
            })
            argv = [sys.executable, "-m",
                    "dlrover_tpu_torch.agent.node_check"]
            if self._zygote is not None:
                procs.append(self._zygote.spawn(argv, env))
            else:
                procs.append(subprocess.Popen(argv, env=env))  # noqa: S603
        deadline = time.time() + 300
        rc = 0
        for proc in procs:
            try:
                code = proc.wait(timeout=max(deadline - time.time(), 0.1))
            except subprocess.TimeoutExpired:
                proc.kill()
                proc.wait()
                code = -1
            rc = code if rc == 0 else rc
        results = []
        for rank in range(nproc):
            try:
                with open(os.path.join(tmp, f"{rank}")) as f:
                    f.readline()  # the elapsed seconds, as the reference
                    results.append(json.loads(f.readline()))
            except (OSError, ValueError):
                rc = rc or 1
        return results, rc

    # ----------------------------------------------------------------- run
    def _start_zygote(self):
        """The fork server, started with the workers' base env; a spawn
        waits for its preload (``ZygotePool.spawn``)."""
        from dlrover_tpu_torch.agent.zygote import ZygotePool

        pool = ZygotePool(name=f"zygote_{self._node_rank}_{os.getpid()}")
        env = dict(os.environ)
        env.update(self._config.envs)
        if self._config.compile_cache_dir:
            env.setdefault(
                NodeEnv.KERNEL_BUILD_DIR, self._config.compile_cache_dir)
        if pool.start(env=env):
            self._zygote = pool

    def _start_monitors(self) -> list:
        from dlrover_tpu_torch.agent.monitor import (
            HeartbeatReporter,
            ResourceMonitor,
            TrainingMonitor,
        )

        monitors = [
            ResourceMonitor(
                self._client,
                chip_stats_file=os.path.join(self._job_dir, "cards"),
                buffer=self._report_buffer),
            HeartbeatReporter(self._client, buffer=self._report_buffer),
            TrainingMonitor(
                os.path.join(self._job_dir, "step.json"), self._client,
                buffer=self._report_buffer),
        ]
        for m in monitors:
            m.start()
        return monitors

    def run(self) -> int:
        """Agent main loop. Returns a process exit code."""
        factory_queue = None
        timeline_reporter = None
        preemption_watcher = None
        self._report_buffer = ReportBuffer(self._client)
        self._job_dir = tempfile.mkdtemp(prefix="dlrover_tpu_torch_agent_")
        monitors = self._start_monitors()
        events = get_event_logger()
        if events.enabled:
            from dlrover_tpu_torch.agent.monitor import TimelineReporter

            timeline_reporter = TimelineReporter(
                events.path,
                client=self._client,
                buffer=self._report_buffer,
                # ship cadence bounds how fast the master's health
                # derivations (and therefore the Brain) can see a
                # signal; chaos/bench harnesses tighten it
                interval=env_float(
                    "DLROVER_TPU_TIMELINE_REPORT_S", 5.0
                ),
            )
            timeline_reporter.start()
        if self._start_ckpt_saver:
            factory_queue = AsyncCheckpointSaver.start_async_saving_ckpt()
        # graceful-drain SIGTERM: supersede the bare ckpt_saver flush
        # hook with drain → flush → fence → exit, so a pod kill leaves
        # survivors a FRESH checkpoint and an already-fenced master
        try:
            signal.signal(signal.SIGTERM, self._on_sigterm)
        except ValueError:
            logger.warning(
                "not on main thread: graceful SIGTERM drain not "
                "installed"
            )
        if self._config.watch_preemption:
            from dlrover_tpu_torch.agent.preemption import PreemptionWatcher

            preemption_watcher = PreemptionWatcher()
            preemption_watcher.on_preemption(self._on_preemption)
            preemption_watcher.start()
        if self._config.prefork:
            self._start_zygote()
        try:
            return self._invoke_run()
        finally:
            self._stopped = True
            if preemption_watcher is not None:
                preemption_watcher.stop()
            for m in monitors:
                m.stop()
            self._stop_workers()
            if self._zygote is not None:
                self._zygote.close()
                self._zygote = None
            shutil.rmtree(self._job_dir, ignore_errors=True)
            if timeline_reporter is not None:
                timeline_reporter.stop()
                timeline_reporter.flush()  # the final partial batch
            if self._report_buffer is not None:
                # flush-on-shutdown: buffered heartbeats/metrics/
                # timeline batches must survive the agent
                self._report_buffer.close()
                self._report_buffer = None
            if factory_queue is not None:
                factory_queue.close()
                # the job's segments die with its agent: tmpfs pages
                # are RAM, and no later agent attaches to them
                AsyncCheckpointSaver.reset(unlink=True)

    def _on_preemption(self, event: str):
        """Maintenance event: drain the workers to a fresh snapshot,
        flush it to storage, and fence this node at the master BEFORE
        the hardware goes away (the SIGTERM path may never run).  The
        ``node_preempted`` report makes the master fence the node out
        of the next round immediately, so survivors observe the
        membership change within one monitor interval instead of
        waiting for this node's heartbeat to go stale."""
        self._preempted = True
        with get_event_logger().span("preemption_drain", event=event):
            self._drain_worker_snapshots(f"preemption:{event}")
            self._save_ckpt_to_storage(f"preemption:{event}")
            self._try_report_failure(
                f"maintenance event {event}",
                TrainingExceptionLevel.NODE_PREEMPTED,
            )

    def _on_sigterm(self, signum, frame):  # pragma: no cover - signal
        """Pod kill: drain → flush → fence, then die with the
        preemption exit code.  Runs on the main thread (signal
        contract); every step is bounded so the pod's termination
        grace is respected."""
        logger.warning("SIGTERM: graceful drain before exit")
        self._on_preemption(f"SIGTERM:{signum}")
        self._stop_workers(
            timeout=self._config.failure_stop_timeout
        )
        raise SystemExit(AgentExitCode.NODE_PREEMPTED)

    def _exit_code(self, default: int = AgentExitCode.ERROR) -> int:
        if self._excluded:
            return AgentExitCode.NODE_EXCLUDED
        if self._preempted:
            return AgentExitCode.NODE_PREEMPTED
        return default

    def _take_brain_directive(self):
        """A master directive delivered on the monitor-pacing poll.
        ``capture`` executes here (background — the monitor loop keeps
        supervising); ``drain`` is returned to the loop.  Ignored (and
        logged) when the respective machinery is kill-switched — the
        master's execution deadline then falls back to fencing this
        node without our cooperation."""
        directive = self._client.take_node_action()
        if directive is None:
            return None
        action, reason, decision_id = directive
        if action == "capture":
            self._start_capture(reason, decision_id)
            return None
        if action != "drain":
            logger.warning(
                "ignoring unknown brain directive %r (decision %s)",
                action, decision_id,
            )
            return None
        return directive

    # ------------------------------------------------------ deep capture
    def _start_capture(self, reason: str, capture_id: int):
        """A master ``capture`` directive: the deep capture is ROADMAP
        A7 (the port's master never sends one: its capture coordinator
        is off)."""
        raise NotImplementedError(
            f"capture directive {capture_id} ({reason}): deep capture is "
            "not ported yet: ROADMAP A7")

    def _execute_brain_drain(self, reason: str, decision_id: int) -> int:
        """The cooperative half of a Brain drain_replace/shrink: the
        PR-9 graceful-drain protocol (snapshot-every-step → flush →
        ``node_preempted`` report, which fences this node at the
        master) and exit with the preemption code so the controller
        reschedules the pod instead of counting a crash."""
        logger.warning(
            "brain directive: graceful drain and exit "
            "(decision %s: %s)", decision_id, reason,
        )
        # ``_on_preemption``'s drain -> flush -> fence, but the flush
        # persists without a commit (the port's): the other nodes flush
        # only after the fence that this drain's report sets, so a
        # drained node 0 would wait out the commit timeout for their
        # done files (the reference waits
        # DLROVER_TPU_EMERGENCY_COMMIT_TIMEOUT_S)
        event = f"preemption:brain:{reason}"
        self._preempted = True
        with get_event_logger().span("preemption_drain",
                                     event=f"brain:{reason}"):
            self._drain_worker_snapshots(event)
            saver = AsyncCheckpointSaver.get_ckpt_saver()
            if saver is not None:
                try:
                    saver.save_shm_to_storage(reason=event, commit=False)
                except Exception as e:  # noqa: BLE001
                    logger.warning("breakpoint ckpt flush failed: %s", e)
            self._try_report_failure(
                f"maintenance event brain:{reason}",
                TrainingExceptionLevel.NODE_PREEMPTED,
            )
        self._stop_workers(timeout=self._config.failure_stop_timeout)
        return AgentExitCode.NODE_PREEMPTED

    def _invoke_run(self) -> int:
        if not self._initialize_workers():
            return self._exit_code()
        while True:
            self._pace_monitor()
            directive = self._take_brain_directive()
            result = self._monitor_workers()
            if result.state == WorkerState.SUCCEEDED:
                # a completed job outranks a drain directive: there is
                # nothing left to drain and the success must be
                # reported as one
                logger.info("all workers finished successfully")
                try:
                    self._client.report_succeeded()
                except ConnectionError:
                    pass
                return 0
            if directive is not None:
                _action, reason, decision_id = directive
                return self._execute_brain_drain(reason, decision_id)
            if result.state == WorkerState.FAILED:
                if self._preempted:
                    # the hardware is going away and the drain +
                    # flush + fence already happened — restarting
                    # into a rendezvous the master fenced us out of
                    # would only delay the pod's death
                    logger.info(
                        "workers gone after preemption drain; "
                        "exiting without restart"
                    )
                    return AgentExitCode.NODE_PREEMPTED
                logger.error(
                    "worker failure: local ranks %s codes %s",
                    result.failed_ranks,
                    result.return_codes,
                )
                self._report_failure(result)
                if not self._restart_workers("worker failure"):
                    return self._exit_code()
                continue
            # HEALTHY: elastic re-mesh when new nodes wait at the master
            if self._membership_changed():
                if not self._restart_workers(
                    "membership change", consume_budget=False
                ):
                    return self._exit_code()


def launch_agent(
    config: ElasticLaunchConfig,
    entrypoint: Sequence[str],
    master_addr: str = "",
) -> int:
    """Build the client + agent and run (reference ``launch_agent``
    ``training.py:776``)."""
    config.auto_configure_params()
    client = MasterClient.singleton_instance(master_addr)
    waiting_timeout = (
        config.rdzv_waiting_timeout
        if config.rdzv_waiting_timeout >= 0
        else config.rdzv_timeout
    )
    client.report_rdzv_params(
        config.min_nodes,
        config.max_nodes,
        waiting_timeout,
        config.node_unit,
    )
    agent = ElasticTrainingAgent(config, entrypoint, client=client)
    return agent.run()
