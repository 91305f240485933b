"""Master-side rendezvous managers.

Copy of ``dlrover_tpu/master/rendezvous.py``.

Reference parity: ``dlrover/python/master/elastic_training/rdzv_manager.py``
(RendezvousManager ABC ``:58``, min/max/node-unit window ``:135``,
``join_rendezvous:213``, ``num_nodes_waiting:272`` — the restart signal,
ckpt-step barrier ``sync_ckpt_nodes:295``; ElasticTrainingRendezvousManager
``:329``; NetworkCheckRendezvousManager ``:390`` with pairwise group
shuffling for straggler/fault isolation).

TPU notes: a "node" is a TPU-VM worker; ``local_world_size`` is its
training-process count (usually 1 process driving N chips).  The
completed world is what the agent feeds into
``jax.distributed.initialize`` (process_id = rank in this world).
"""

import math
import threading
import time
from abc import ABCMeta
from typing import Callable, Dict, List, Optional, Tuple

from dlrover_tpu_torch.common.constants import NetworkFailureReason
from dlrover_tpu_torch.common.fault_injection import maybe_crash
from dlrover_tpu_torch.common.log import default_logger as logger


class RendezvousParameters:
    def __init__(self, min_nodes: int = 1, max_nodes: int = 1,
                 waiting_timeout: float = 30.0, node_unit: int = 1,
                 join_timeout: float = 600.0):
        self.min_nodes = min_nodes
        self.max_nodes = max_nodes
        self.waiting_timeout = waiting_timeout
        self.node_unit = node_unit
        self.join_timeout = join_timeout


class RendezvousManager(metaclass=ABCMeta):
    #: long-poll wake slice: rendezvous completion is partly
    #: TIME-driven (the waiting_timeout window rule), so a parked
    #: waiter re-evaluates at this cadence even without a notify —
    #: server-side CPU only, zero RPCs
    WAIT_SLICE_S = 0.2

    def __init__(self):
        # a Condition IS a lock for ``with`` purposes; every mutation
        # notifies so long-poll waiters (comm world / waiting count)
        # wake on the event instead of the client re-polling over RPC
        self._lock = threading.Condition()
        self._name = ""
        self._waiting_nodes: Dict[int, int] = {}  # rank -> local_world_size
        self._rdzv_nodes: Dict[int, int] = {}
        self._lastcall_time = 0.0
        self._rdzv_params = RendezvousParameters()
        self._rdzv_round = 0
        self._node_unit = 1
        self._start_rdzv_time = 0.0
        self._latest_rdzv_nodes: List[int] = []
        self._ckpt_steps: Dict[int, int] = {}
        # node_rank -> interconnect hierarchy labels (outermost first);
        # fed by NodeTopology reports, consumed at round completion
        self._node_topology: Dict[int, tuple] = {}
        #: bumped on every state change (join/remove/params/round
        #: completion); the ``CommWorld`` delta protocol's version
        self._version = 0
        #: preemption-fenced nodes: rank -> fence expiry (epoch s).
        #: A fenced node is excluded from round completion (its
        #: hardware is going away); the fence expires so a re-created
        #: pod with the same rank can rejoin later.
        self._fenced: Dict[int, float] = {}
        #: a member of the live world was fenced: survivors must
        #: re-mesh even though nobody is WAITING yet — this makes
        #: ``num_nodes_waiting`` signal the membership change within
        #: one monitor interval of the preemption notice instead of
        #: after the dead node's heartbeat goes stale
        self._pending_remesh = False
        #: failover journal hook: ``cb(op, args)``; rendezvous state is
        #: tiny, so every mutation journals the FULL state dict —
        #: replay is last-writer-wins and therefore idempotent, and a
        #: restarted master resumes the same round at the same version
        self._journal_cb: Optional[Callable[[str, dict], None]] = None

    def set_journal(self, cb: Optional[Callable[[str, dict], None]]):
        with self._lock:
            self._journal_cb = cb

    def _journal_locked(self):
        """Caller holds the lock: journal the full current state."""
        if self._journal_cb is not None:
            try:
                self._journal_cb("state", self._export_locked())
            except Exception as e:  # noqa: BLE001
                logger.warning("rendezvous journal failed: %s", e)

    def _mutated(self):
        """Caller holds the lock: version-stamp the change, wake
        long-poll waiters, journal the new state."""
        self._version += 1
        self._lock.notify_all()
        self._journal_locked()

    @property
    def state_version(self) -> int:
        with self._lock:
            return self._version

    @property
    def rdzv_params(self) -> RendezvousParameters:
        """The live window parameters (the agents' ``--nnodes`` min/max
        land here via ``report_rdzv_params``) — the Brain's world
        clamps read them instead of guessing from ``--node_num``."""
        with self._lock:
            params = self._rdzv_params
            return RendezvousParameters(
                min_nodes=params.min_nodes,
                max_nodes=params.max_nodes,
                waiting_timeout=params.waiting_timeout,
                node_unit=self._node_unit,
            )

    def current_world_ranks(self) -> List[int]:
        """Node ranks of the latest COMPLETED round — the world the
        Brain plans against (insertion order = rank order)."""
        with self._lock:
            return list(self._latest_rdzv_nodes)

    def fenced_ranks(self) -> List[int]:
        """Live (unexpired) preemption fences — the Brain must not
        re-plan a node that is already on its way out."""
        with self._lock:
            return sorted(self._live_fenced_locked().keys())

    def set_node_topology(self, node_rank: int, levels: tuple):
        with self._lock:
            self._node_topology[node_rank] = tuple(levels)
            # journaled (ranks sort by topology after replay) but NOT
            # version-bumped: topology is advisory, not world state
            self._journal_locked()

    def _topology_order(self, ranks: List[int]) -> List[int]:
        """Caller holds the lock."""
        if not self._node_topology:
            return ranks
        from dlrover_tpu_torch.master.net_topology import order_by_topology

        return order_by_topology(ranks, self._node_topology)

    def update_rdzv_params(self, min_nodes: int, max_nodes: int,
                           waiting_timeout: float, node_unit: int):
        with self._lock:
            self._rdzv_params.min_nodes = min_nodes
            self._rdzv_params.max_nodes = max_nodes
            self._rdzv_params.waiting_timeout = waiting_timeout
            self._node_unit = max(node_unit, 1)
            self._mutated()
            logger.info(
                "%s rdzv params: min=%s max=%s timeout=%s unit=%s",
                self._name, min_nodes, max_nodes, waiting_timeout, node_unit,
            )

    def get_rdzv_round(self) -> int:
        return self._rdzv_round

    def add_alive_node(self, node_rank: int):
        pass

    def remove_alive_node(self, node_rank: int):
        """Drop a dead node from the pending rendezvous."""
        with self._lock:
            if node_rank in self._waiting_nodes:
                del self._waiting_nodes[node_rank]
                self._mutated()
                logger.info(
                    "%s: removed dead node %s from waiting list",
                    self._name, node_rank,
                )

    def _live_fenced_locked(self) -> Dict[int, float]:
        """Caller holds the lock: prune expired fences, return live."""
        now = time.time()
        expired = [r for r, t in self._fenced.items() if t <= now]
        for r in expired:
            del self._fenced[r]
        return self._fenced

    def fence_node(self, node_rank: int,
                   ttl_s: Optional[float] = None):
        """Preemption fencing: the node reported it is about to die
        (graceful drain done).  Drop it from the pending round,
        exclude it from completions until the fence expires, and —
        when it was part of the live world — raise the pending-remesh
        flag so survivors' waiting-count long-polls wake NOW."""
        if ttl_s is None:
            from dlrover_tpu_torch.common.env import env_float

            ttl_s = env_float("DLROVER_TPU_FENCE_TTL_S", 30.0)
        with self._lock:
            self._fenced[node_rank] = time.time() + max(ttl_s, 0.0)
            self._waiting_nodes.pop(node_rank, None)
            if node_rank in self._latest_rdzv_nodes:
                self._pending_remesh = True
            self._mutated()
            logger.info(
                "%s: fenced node %s for %.0fs (pending_remesh=%s)",
                self._name, node_rank, ttl_s, self._pending_remesh,
            )

    def join_rendezvous(self, node_rank: int, local_world_size: int) -> int:
        with self._lock:
            if not self._waiting_nodes:
                self._start_rdzv_time = time.time()
            # a join IS liveness: a re-created pod re-announcing
            # itself clears its own fence
            self._fenced.pop(node_rank, None)
            self._waiting_nodes[node_rank] = local_world_size
            self._rdzv_nodes = {}
            self._lastcall_time = time.time()
            self._mutated()
        # chaos hook: the join is journaled but the round is pending —
        # a kill pinned here proves a restarted master resumes the
        # SAME round with the already-joined members
        maybe_crash("mid_rendezvous")
        return self._rdzv_round

    def _check_rdzv_completed(self) -> bool:
        """Caller holds the lock.  The window rule (reference ``:135``):
        complete immediately at max_nodes; after waiting_timeout complete
        with the largest multiple of node_unit >= min_nodes."""
        fenced = self._live_fenced_locked()
        eligible = {
            r: v
            for r, v in self._waiting_nodes.items()
            if r not in fenced
        }
        waiting = len(eligible)
        params = self._rdzv_params
        if waiting == params.max_nodes:
            completed = True
        else:
            over_min = (
                waiting >= params.min_nodes
                and waiting >= self._node_unit
            )
            timed_out = (
                self._lastcall_time > 0
                and time.time() - self._lastcall_time
                >= params.waiting_timeout
            )
            completed = over_min and timed_out
        if completed:
            # round down to a node_unit multiple; excess nodes STAY in
            # the waiting list so they keep signalling a pending
            # re-rendezvous instead of being stranded
            usable = (waiting // self._node_unit) * self._node_unit
            usable = min(usable, self._rdzv_params.max_nodes)
            ranks = sorted(eligible.keys())[:usable]
            # topology-aware ordering: neighbors on the interconnect
            # get adjacent global ranks (the world dict's insertion
            # order IS the rank order the agents apply); numeric order
            # when no topology was reported
            ranks = self._topology_order(ranks)
            self._rdzv_nodes = {
                r: self._waiting_nodes[r] for r in ranks
            }
            self._latest_rdzv_nodes = list(self._rdzv_nodes.keys())
            for r in ranks:
                del self._waiting_nodes[r]
            self._lastcall_time = 0.0
            self._rdzv_round += 1
            self._ckpt_steps = {}  # new world: reset the ckpt barrier
            # the re-mesh the fence demanded has happened
            self._pending_remesh = False
            self._mutated()
            logger.info(
                "%s rendezvous round %s completed with %s nodes",
                self._name, self._rdzv_round, len(self._rdzv_nodes),
            )
        return completed

    def get_comm_world(self, node_rank: int) -> Tuple[int, int, Dict[int, int]]:
        """Return (round, group, world).  Empty world while pending."""
        with self._lock:
            if not self._rdzv_nodes:
                self._check_rdzv_completed()
            if self._rdzv_nodes:
                return self._rdzv_round, 0, dict(self._rdzv_nodes)
            return self._rdzv_round, 0, {}

    def get_comm_world_versioned(
        self, node_rank: int
    ) -> Tuple[int, int, Dict[int, int], int]:
        """``get_comm_world`` plus the matching state version, read
        atomically (the Condition's lock is reentrant, so the bump a
        lazy round-completion performs inside ``get_comm_world`` is
        visible in the version returned WITH that world)."""
        with self._lock:
            rnd, group, world = self.get_comm_world(node_rank)
            return rnd, group, world, self._version

    def wait_comm_world(
        self, node_rank: int, version: int = -1, timeout: float = 0.0
    ) -> Tuple[int, int, Dict[int, int], int]:
        """Long-poll ``get_comm_world``: block until the world is
        complete AND the state version moved past the caller's cached
        ``version`` (or ``timeout`` elapses); returns
        ``(round, group, world, version)``."""
        deadline = time.monotonic() + max(timeout, 0.0)
        while True:
            rnd, group, world, current = (
                self.get_comm_world_versioned(node_rank)
            )
            if world and (version < 0 or current != version):
                return rnd, group, world, current
            remaining = deadline - time.monotonic()
            if remaining <= 0:
                return rnd, group, world, current
            with self._lock:
                # completion can be time-driven (the window rule), so
                # cap the park and re-evaluate
                self._lock.wait(min(remaining, self.WAIT_SLICE_S))

    def wait_num_nodes(
        self, last_num: int = -1, timeout: float = 0.0
    ) -> int:
        """Long-poll ``num_nodes_waiting``: block until the (gated)
        waiting count differs from the caller's ``last_num`` or the
        timeout elapses."""
        deadline = time.monotonic() + max(timeout, 0.0)
        while True:
            waiting = self.num_nodes_waiting()
            if last_num < 0 or waiting != last_num:
                return waiting
            remaining = deadline - time.monotonic()
            if remaining <= 0:
                return waiting
            with self._lock:
                self._lock.wait(min(remaining, self.WAIT_SLICE_S))

    def num_nodes_waiting(self) -> int:
        """Nonzero once a new rendezvous is pending — the running agents
        poll this to learn that a restart/re-mesh is required.

        Gated (reference ``:272-285``): leftover sub-node_unit nodes
        alone must NOT signal a restart (they cannot change the world),
        or every completed round with a remainder would trigger an
        infinite restart storm.  A re-joining member of the latest world
        always signals (its training process died).  A PENDING REMESH
        (a live-world member was preemption-fenced) signals even with
        an empty waiting list: the survivors must re-rendezvous away
        from the dying node, and they learn it from this count."""
        with self._lock:
            if not self._waiting_nodes:
                return self._node_unit if self._pending_remesh else 0
            rejoined = any(
                r in self._latest_rdzv_nodes
                for r in self._waiting_nodes
            )
            if (
                rejoined
                or self._pending_remesh
                or len(self._waiting_nodes) >= self._node_unit
            ):
                return max(
                    len(self._waiting_nodes),
                    self._node_unit if self._pending_remesh else 0,
                )
            return 0

    def sync_ckpt_nodes(self, node_id: int, step: int) -> bool:
        """Barrier: all latest-rendezvous nodes report the same in-memory
        checkpoint step (reference ``:295``)."""
        with self._lock:
            self._ckpt_steps[node_id] = step
            steps = set(self._ckpt_steps.values())
            if len(steps) > 1:
                return False
            return len(self._ckpt_steps) == len(self._latest_rdzv_nodes)

    # --------------------------------------------- failover replay
    def _export_locked(self) -> dict:
        """Caller holds the lock: JSON-safe full state (int dict keys
        become strings on the wire; restore converts them back)."""
        state = {
            "waiting": dict(self._waiting_nodes),
            "rdzv_nodes": dict(self._rdzv_nodes),
            "round": self._rdzv_round,
            "latest": list(self._latest_rdzv_nodes),
            "ckpt_steps": dict(self._ckpt_steps),
            "topology": {
                str(r): list(v)
                for r, v in self._node_topology.items()
            },
            "params": [
                self._rdzv_params.min_nodes,
                self._rdzv_params.max_nodes,
                self._rdzv_params.waiting_timeout,
                self._node_unit,
            ],
            "lastcall": self._lastcall_time,
            "version": self._version,
            "fenced": {
                str(r): float(t) for r, t in self._fenced.items()
            },
            "pending_remesh": self._pending_remesh,
        }
        state.update(self._export_extra_locked())
        return state

    def _export_extra_locked(self) -> dict:
        """Subclass state rider (network-check verdicts etc.)."""
        return {}

    def _restore_extra_locked(self, state: dict):
        pass

    def export_state(self) -> dict:
        with self._lock:
            return self._export_locked()

    def restore_state(self, state: dict):
        """Install a journaled/snapshotted state (replay path — not
        re-journaled).  The version is restored as-is so pre-crash
        clients' ``NotModified`` caches stay coherent with the new
        incarnation."""
        with self._lock:
            self._waiting_nodes = {
                int(k): int(v)
                for k, v in (state.get("waiting") or {}).items()
            }
            self._rdzv_nodes = {
                int(k): int(v)
                for k, v in (state.get("rdzv_nodes") or {}).items()
            }
            self._rdzv_round = int(state.get("round", 0))
            self._latest_rdzv_nodes = [
                int(r) for r in (state.get("latest") or [])
            ]
            self._ckpt_steps = {
                int(k): int(v)
                for k, v in (state.get("ckpt_steps") or {}).items()
            }
            self._node_topology = {
                int(k): tuple(v)
                for k, v in (state.get("topology") or {}).items()
            }
            params = state.get("params")
            if params:
                self._rdzv_params.min_nodes = int(params[0])
                self._rdzv_params.max_nodes = int(params[1])
                self._rdzv_params.waiting_timeout = float(params[2])
                self._node_unit = max(int(params[3]), 1)
            # the window rule is time-driven: restart the waiting
            # window NOW so a pending round can't complete instantly
            # off a stale pre-crash timestamp (members that died with
            # the master re-join and re-arm it anyway)
            if self._waiting_nodes and state.get("lastcall"):
                self._lastcall_time = time.time()
            self._fenced = {
                int(k): float(v)
                for k, v in (state.get("fenced") or {}).items()
            }
            self._pending_remesh = bool(
                state.get("pending_remesh", False)
            )
            self._restore_extra_locked(state)
            self._version = max(
                self._version, int(state.get("version", 0))
            )
            self._lock.notify_all()


class ElasticTrainingRendezvousManager(RendezvousManager):
    def __init__(self):
        super().__init__()
        self._name = "elastic-training"


class NetworkCheckRendezvousManager(RendezvousManager):
    """Pairwise health-check rendezvous (reference ``:390``).

    Nodes are split into groups of 2 that run a matmul+collective
    payload; a second round re-pairs suspect nodes with known-good ones
    so a bad chip/link is isolated to a single node.
    """

    GROUP_SIZE = 2

    def __init__(self):
        super().__init__()
        self._name = "network-check"
        self._node_status: Dict[int, bool] = {}
        self._node_times: Dict[int, float] = {}
        self._check_round = 0
        self._node_groups: List[Dict[int, int]] = []
        self._fault_nodes: List[int] = []
        self._straggler_ratio = 3.0

    def join_rendezvous(self, node_rank: int, local_world_size: int) -> int:
        with self._lock:
            if not self._waiting_nodes:
                self._start_rdzv_time = time.time()
                self._node_groups = []
                if self._check_round >= 2:
                    # a fresh sweep after a completed 2-round check:
                    # stale verdicts from the previous sweep must not
                    # leak (a then-healthy node may be broken now)
                    self._node_status = {}
                    self._node_times = {}
                    self._check_round = 0
            self._waiting_nodes[node_rank] = local_world_size
            self._rdzv_nodes = {}
            self._lastcall_time = time.time()
            self._mutated()
        return self._rdzv_round

    def get_comm_world(self, node_rank: int) -> Tuple[int, int, Dict[int, int]]:
        with self._lock:
            if not self._rdzv_nodes:
                if self._check_rdzv_completed():
                    self._group_nodes()
                    self._check_round += 1
            if self._rdzv_nodes:
                for group_idx, group in enumerate(self._node_groups):
                    if node_rank in group:
                        return self._rdzv_round, group_idx, dict(group)
                return self._rdzv_round, 0, {}
            return self._rdzv_round, 0, {}

    def _group_nodes(self):
        """Round r=1: adjacent pairs.  Round r>=2: reverse order so a
        suspect node lands with a different peer (reference's shuffle)."""
        ranks = list(self._rdzv_nodes.keys())
        if self._check_round % 2 == 1:
            ranks = ranks[::-1]
        groups = []
        for i in range(0, len(ranks), self.GROUP_SIZE):
            chunk = ranks[i : i + self.GROUP_SIZE]
            groups.append({r: self._rdzv_nodes[r] for r in chunk})
        # a trailing singleton can't run a pair check; merge it
        if len(groups) > 1 and len(groups[-1]) == 1:
            groups[-2].update(groups.pop())
        self._node_groups = groups
        logger.info(
            "network-check round %s groups: %s",
            self._check_round,
            [list(g.keys()) for g in groups],
        )

    def report_network_status(self, node_rank: int, succeeded: bool,
                              elapsed: float):
        with self._lock:
            prev = self._node_status.get(node_rank)
            # a success in any round clears earlier suspicion
            self._node_status[node_rank] = succeeded or bool(prev)
            if succeeded:
                self._node_times[node_rank] = elapsed
            # journaled without a version bump: health verdicts are
            # poll-read (check_fault_node), not delta-shipped
            self._journal_locked()

    def check_fault_node(self) -> Tuple[List[int], str]:
        with self._lock:
            if not self._rdzv_nodes:
                return [], NetworkFailureReason.NO_INIT
            expected = set(self._rdzv_nodes.keys())
            reported = set(self._node_status.keys())
            if not expected.issubset(reported):
                return [], NetworkFailureReason.WAITING_NODE
            faults = sorted(
                r for r in expected if not self._node_status[r]
            )
            reason = (
                NetworkFailureReason.NODE_FAILURE if faults else ""
            )
            return faults, reason

    def check_straggler(self) -> Tuple[List[int], str]:
        with self._lock:
            times = {
                r: t
                for r, t in self._node_times.items()
                if r in self._rdzv_nodes
            }
            if len(times) < 2:
                return [], ""
            values = sorted(times.values())
            median = values[len(values) // 2]
            if median <= 0:
                return [], ""
            stragglers = sorted(
                r
                for r, t in times.items()
                if t > self._straggler_ratio * median
                and not math.isclose(t, median)
            )
            return stragglers, ""

    def reset(self):
        with self._lock:
            self._node_status = {}
            self._node_times = {}
            self._check_round = 0

    def _export_extra_locked(self) -> dict:
        return {
            "node_status": {
                str(r): bool(v)
                for r, v in self._node_status.items()
            },
            "node_times": {
                str(r): float(v)
                for r, v in self._node_times.items()
            },
            "check_round": self._check_round,
            "node_groups": [
                {str(r): int(v) for r, v in g.items()}
                for g in self._node_groups
            ],
        }

    def _restore_extra_locked(self, state: dict):
        self._node_status = {
            int(k): bool(v)
            for k, v in (state.get("node_status") or {}).items()
        }
        self._node_times = {
            int(k): float(v)
            for k, v in (state.get("node_times") or {}).items()
        }
        self._check_round = int(state.get("check_round", 0))
        self._node_groups = [
            {int(k): int(v) for k, v in g.items()}
            for g in (state.get("node_groups") or [])
        ]
