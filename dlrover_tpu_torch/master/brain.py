"""The Brain's execution arm: planned actions, not emergent restarts.

Copy of ``dlrover_tpu/master/brain.py`` (imports rewritten).  In the
port the drained node's agent is ``agent/training.py``
(``_execute_brain_drain``), its survivors re-solve through
``accelerate/solver.resolve_for_world`` and restore through
``trainer/checkpoint/reshard.py``.

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

from dlrover_tpu_torch.common.constants import NodeType
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

    def set_scaler(self, scaler):
        self._scaler = scaler

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
        if self._job_manager is None:
            return None
        for node in self._job_manager.get_running_nodes():
            key = (
                node.rank_index
                if node.rank_index is not None
                else node.id
            )
            if key == node_rank and node.name:
                return node.name
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
        name = self._node_name(decision.node)
        if name is None:
            return
        plan = ScalePlan()
        if decision.action == ACTION_DRAIN_REPLACE and (
            decision.to_world >= decision.from_world
        ):
            # replace: a fresh pod for the drained one
            plan.migrate_nodes[name] = {"type": NodeType.WORKER}
        else:
            plan.remove_nodes.append(name)
        self._scale(plan)

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
            if decision.node in self.fenced() or (
                world and decision.node not in world
            ):
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
        # the pod-side follow-up may have run on the dead incarnation
        # with its journal record still in the write-behind linger —
        # a resumed drain therefore NEVER re-runs it (same reasoning
        # as grow below: re-issuing risks double-created pods; a
        # missing replacement is the controller's to reconcile)
        self._followed_up.add(decision.decision_id)
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
