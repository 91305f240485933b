"""The Brain's execution arm: planned actions, not emergent restarts.

Copy of ``dlrover_tpu/master/brain.py`` (imports rewritten).  In the
port the drained node's agent is ``agent/training.py``
(``_execute_brain_drain``), its survivors re-solve through
``accelerate/solver.resolve_for_world`` and restore through
``trainer/checkpoint/reshard.py``.  One addition: once a drain's
pod-side leg has handed the node's pod to the scaler, the job manager
releases the node (``JobManager.release_node``), so that its
silent heartbeat does not relaunch it beside the replacement; the
pod-side leg finds a node that has not sent its first heartbeat yet
(still INITIAL in the job manager), where the reference skips it; and a
drain with a replacement completes, and launches the replacement, once
the survivors have re-meshed without the node, not at its fence.
Because that leaves a window of a re-mesh between the fence and the
pod-side leg, the leg is journaled before its plan reaches the scaler
(``followed_up`` in the Brain's journaled state), and a master that
fails over re-runs it unless the record says that it ran; the reference
never re-runs a resumed decision's leg.

A :class:`~dlrover_tpu_torch.master.resource_optimizer.BrainDecision` names
a world transition; this module turns it into ONE coordinated action
built from pieces the master and the agent already have:

- **drain_replace / shrink**: post a cooperative ``drain`` directive
  for the target node (:class:`NodeDirectives`, delivered piggybacked
  on the agent's monitor-pacing ``WaitingNodeNum`` poll — zero extra
  RPCs).  The agent runs the graceful-drain protocol: SIGUSR1
  snapshot-every-step → flush → ``node_preempted`` report (which
  fences the node at the rendezvous manager) → exit with the
  preemption code.  Survivors' long-polls wake within one monitor
  interval, re-rendezvous without the node, ``solver.resolve_for_world``
  re-solves the mesh and the reshard-aware restore resumes from the
  drained step — never a restart-from-scratch.  When a scaler is
  attached (k8s), the replacement pod is launched through it in the
  same action.
- **grow**: a worker-count :class:`ScalePlan` through the scaler (the
  new pod joins the rendezvous; the window rule + elastic re-mesh do
  the rest).  Without a scaler there is no launch capacity and the
  optimizer never emits grow.

Execution is ASYNCHRONOUS: ``begin`` fires the action, the
auto-scaler polls ``check`` each cycle until the world reflects it,
and ``force`` is the deadline fallback — a node that never picked up
its directive (dead agent, wedged monitor loop) is fenced
master-side so survivors re-mesh anyway, and a grow whose pod never
arrived is abandoned.  Both outcomes are journaled, so a failed-over
master resumes or abandons instead of flip-flopping.
"""

import threading
from typing import Dict, List, Optional, Tuple

from dlrover_tpu_torch.common.constants import NodeStatus, NodeType
from dlrover_tpu_torch.common.log import default_logger as logger
from dlrover_tpu_torch.common.messages import ScalePlan
from dlrover_tpu_torch.master.resource_optimizer import (
    ACTION_DRAIN_REPLACE,
    ACTION_GROW,
    ACTION_SHRINK,
    OUTCOME_ABANDONED,
    OUTCOME_DONE,
    OUTCOME_FENCED_FALLBACK,
    BrainDecision,
)

#: the cooperative directive verb the agent understands
DIRECTIVE_DRAIN = "drain"


class NodeDirectives:
    """Pending per-node directives, consumed on delivery.

    One slot per node: the Brain issues one planned action at a time,
    so a second post for the same node replaces the first (same
    decision resumed after a failover keeps its id)."""

    def __init__(self):
        self._lock = threading.Lock()
        self._pending: Dict[int, Tuple[str, str, int]] = {}

    def post(self, node_rank: int, action: str, reason: str,
             decision_id: int):
        with self._lock:
            self._pending[int(node_rank)] = (
                action, reason, int(decision_id)
            )

    def take(self, node_rank: int) -> Optional[Tuple[str, str, int]]:
        """Consume the node's pending directive (the delivery)."""
        with self._lock:
            return self._pending.pop(int(node_rank), None)

    def peek(self, node_rank: int) -> Optional[Tuple[str, str, int]]:
        with self._lock:
            return self._pending.get(int(node_rank))

    def clear(self, node_rank: int):
        with self._lock:
            self._pending.pop(int(node_rank), None)

    def pending_nodes(self) -> List[int]:
        with self._lock:
            return sorted(self._pending)


class BrainExecutor:
    """Executes one :class:`BrainDecision` against the live job."""

    def __init__(self, rdzv_manager=None, directives=None,
                 job_manager=None, scaler=None):
        self._rdzv = rdzv_manager
        self.directives = directives or NodeDirectives()
        self._job_manager = job_manager
        self._scaler = scaler
        #: decision ids whose pod-side follow-up already ran
        self._followed_up = set()
        #: called once a follow-up is marked, before its plan reaches the
        #: scaler (the Brain journals its state there)
        self.on_follow_up = None

    def set_scaler(self, scaler):
        self._scaler = scaler

    def followed_up(self) -> List[int]:
        return sorted(self._followed_up)

    def restore_followed_up(self, ids):
        self._followed_up = {int(i) for i in ids}

    @property
    def can_launch(self) -> bool:
        """Whether this master can CREATE nodes (grow / replace)."""
        return self._scaler is not None

    # ------------------------------------------------------------ world
    def current_world(self) -> List[int]:
        if self._rdzv is None:
            return []
        return self._rdzv.current_world_ranks()

    def fenced(self) -> List[int]:
        if self._rdzv is None:
            return []
        return self._rdzv.fenced_ranks()

    def world_bounds(self) -> Tuple[int, int]:
        """(min_nodes, max_nodes) from the live rendezvous params."""
        if self._rdzv is None:
            return 1, 1
        params = self._rdzv.rdzv_params
        return params.min_nodes, params.max_nodes

    def _node_name(self, node_rank: int) -> Optional[str]:
        """rank -> pod name for scaler-side removal/migration (the
        seed mapping; an unmapped rank just skips the scaler leg —
        the cooperative directive still drains it)."""
        node = self._node_of(node_rank)
        return node.name if node is not None else None

    def _node_of(self, node_rank: int):
        if self._job_manager is None:
            return None
        candidates = list(self._job_manager.get_running_nodes())
        # the port's fallback: a node the rendezvous holds whose first
        # heartbeat (one a monitor interval, 15 s) has not come yet is
        # still INITIAL in the job manager, and its pod is the plan's
        candidates += [n for n in self._job_manager.nodes.values()
                       if n.status in (NodeStatus.INITIAL,
                                       NodeStatus.PENDING)]
        for node in candidates:
            key = (
                node.rank_index
                if node.rank_index is not None
                else node.id
            )
            if key == node_rank and node.name:
                return node
        return None

    # ---------------------------------------------------------- execute
    def begin(self, decision: BrainDecision):
        """Fire the action (non-blocking).  Drains post ONLY the
        cooperative directive here: deleting the pod through the
        scaler in the same breath would SIGTERM the agent before the
        directive's next-poll delivery, collapsing the graceful drain
        into the pod's termination grace — the pod-side leg runs as a
        follow-up once the node is fenced/out of the world (or from
        ``force`` when it never cooperates)."""
        if decision.action in (ACTION_DRAIN_REPLACE, ACTION_SHRINK):
            self.directives.post(
                decision.node,
                DIRECTIVE_DRAIN,
                decision.reason,
                decision.decision_id,
            )
        elif decision.action == ACTION_GROW:
            plan = ScalePlan()
            plan.node_group_resources[NodeType.WORKER] = {
                "count": decision.to_world
            }
            self._scale(plan)

    def _replaces(self, decision: BrainDecision) -> bool:
        """Whether the drain's pod-side leg launches a replacement."""
        return (
            self._scaler is not None
            and decision.action == ACTION_DRAIN_REPLACE
            and decision.to_world >= decision.from_world
        )

    def _scaler_followup(self, decision: BrainDecision):
        """Pod-side leg of a drain, AFTER the drain concluded: delete
        the (already exiting) pod, plus a replacement when the
        decision planned one.  Idempotence guard: a resumed check and
        the original completion must not double-create pods."""
        if self._scaler is None:
            return
        if decision.decision_id in self._followed_up:
            return
        self._followed_up.add(decision.decision_id)
        node = self._node_of(decision.node)
        if node is None:
            return
        if self.on_follow_up is not None:
            self.on_follow_up()
        plan = ScalePlan()
        if self._replaces(decision):
            # replace: a fresh pod for the drained one
            plan.migrate_nodes[node.name] = {"type": NodeType.WORKER}
        else:
            plan.remove_nodes.append(node.name)
        self._scale(plan)
        # the port's addition: the pod is the scaler's now, so the job
        # manager's heartbeat watch must not relaunch it a second time
        self._job_manager.release_node(node.id)

    def _scale(self, plan: ScalePlan):
        if self._scaler is None:
            return
        try:
            self._scaler.scale(plan)
        except Exception as e:  # noqa: BLE001 - the directive path
            # still drains; the pod-side leg is best-effort
            logger.warning("brain scaler leg failed: %s", e)

    def check(self, decision: BrainDecision) -> Optional[str]:
        """Poll for completion; an outcome string once the world
        reflects the decision, None while still pending."""
        world = self.current_world()
        if decision.action in (ACTION_DRAIN_REPLACE, ACTION_SHRINK):
            gone = bool(world) and decision.node not in world
            if self._replaces(decision):
                # the port's order: the replacement comes once the
                # survivors have re-meshed without the node.  Their next
                # restart then commits a step of their own world, which
                # the newcomer restores; launched at the fence, it can
                # reach the rendezvous first, and the world it forms with
                # the survivors shares no step but the last commit
                if gone:
                    self._scaler_followup(decision)
                    return OUTCOME_DONE
                return None
            if decision.node in self.fenced() or gone:
                self._scaler_followup(decision)
                return OUTCOME_DONE
            return None
        if decision.action == ACTION_GROW:
            if len(world) >= decision.to_world:
                return OUTCOME_DONE
            return None
        return OUTCOME_DONE  # unknown action: nothing to wait for

    def force(self, decision: BrainDecision) -> str:
        """Deadline fallback: make the decision safe without the
        cooperating party."""
        if decision.action in (ACTION_DRAIN_REPLACE, ACTION_SHRINK):
            # the node never picked its directive up (dead / wedged
            # agent): fence it master-side so survivors re-mesh away
            # from it; its own teardown is the job manager's problem
            self.directives.clear(decision.node)
            if self._rdzv is not None:
                self._rdzv.fence_node(decision.node)
            # the node isn't cooperating: deleting its pod (SIGTERM →
            # the agent's own drain handler, bounded by the pod
            # grace) is exactly the right escalation here
            self._scaler_followup(decision)
            logger.warning(
                "brain: node %s never acked drain (decision %s); "
                "fenced master-side", decision.node,
                decision.decision_id,
            )
            return OUTCOME_FENCED_FALLBACK
        return OUTCOME_ABANDONED

    def resume(self, decision: BrainDecision) -> bool:
        """Re-arm an in-flight action inherited from a dead master
        incarnation (directives are memory-only and died with it).
        Returns False when the decision is already satisfied."""
        # the port's: the pod-side follow-up is journaled before its
        # plan goes out, so the dead incarnation's record says whether
        # it ran (``restore_followed_up``); a leg that had not run, as
        # one that waits for the survivors' re-mesh, runs here.  The
        # reference never re-runs it, and a replacement whose leg came
        # after the fence was lost with the master.  A record lost in
        # the journal's write-behind linger re-runs the leg
        if self.check(decision) is not None:
            return False
        if decision.action in (ACTION_DRAIN_REPLACE, ACTION_SHRINK):
            self.directives.post(
                decision.node,
                DIRECTIVE_DRAIN,
                decision.reason,
                decision.decision_id,
            )
        # grow: the plan was already handed to the scaler/operator
        # pre-crash; re-issuing would double-create — just keep
        # waiting for the world (the deadline abandons it otherwise)
        return True


def execution_deadline_s(interval_s: float) -> float:
    """How long an in-flight action may stay pending before ``force``:
    generous multiples of the decision cadence, floored
    (``DLROVER_TPU_BRAIN_EXEC_DEADLINE_S``) so a tight chaos interval
    still leaves room for a real drain + re-mesh."""
    from dlrover_tpu_torch.common.env import env_float

    return max(
        8.0 * interval_s,
        env_float("DLROVER_TPU_BRAIN_EXEC_DEADLINE_S", 20.0),
    )
