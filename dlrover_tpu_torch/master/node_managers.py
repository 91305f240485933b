"""Per-node-type managers: chief / worker / evaluator accounting.

Copy of ``dlrover_tpu/master/node_managers.py``.

Reference parity: ``dlrover/python/master/node/training_node.py:154``
(``TrainingNodeManager`` base), ``node/worker.py:32,66,102``
(``ChiefManager`` / ``EvaluatorManager`` / ``WorkerManager``).  The PS
manager is out of TPU scope (SURVEY.md §2.8); chief and evaluator
carry over: a chief failure is job-fatal (it owns coordination state),
evaluators complete independently of the training workers, workers
carry the relaunch budget.
"""

from typing import Dict, List, Optional

from dlrover_tpu_torch.common.constants import (
    NodeStatus,
    NodeType,
)
from dlrover_tpu_torch.common.log import default_logger as logger
from dlrover_tpu_torch.common.node import Node


class TrainingNodeManager:
    """Accounting for one node type (ref ``training_node.py:154``)."""

    node_type = NodeType.WORKER
    # a failure of this group kills the job (chief semantics)
    critical = False

    def __init__(self, max_relaunch_count: Optional[int] = None):
        """``max_relaunch_count`` overrides the per-node budget when
        given; None (default) honors each Node's own configured
        ``max_relaunch_count`` — a registry-level default would
        silently diverge from the env-configured budget."""
        self._nodes: Dict[int, Node] = {}
        self._max_relaunch = max_relaunch_count

    def add_node(self, node: Node):
        self._nodes[node.id] = node

    @property
    def nodes(self) -> Dict[int, Node]:
        return self._nodes

    def running_nodes(self) -> List[Node]:
        return [
            n
            for n in self._nodes.values()
            if n.status == NodeStatus.RUNNING
        ]

    def pending_nodes(self) -> List[Node]:
        return [
            n
            for n in self._nodes.values()
            if n.status in (NodeStatus.INITIAL, NodeStatus.PENDING)
        ]

    def all_finished(self) -> bool:
        return bool(self._nodes) and all(
            n.status in NodeStatus.end_states()
            for n in self._nodes.values()
        )

    def relaunchable(self, node: Node) -> bool:
        """May this node be relaunched after a failure? Delegates to
        the node's OWN budget (ref ``Node`` relaunch bookkeeping)
        unless the registry pins an override."""
        if not node.relaunchable:
            return False
        if self._max_relaunch is not None:
            return node.relaunch_count < self._max_relaunch
        return not node.exceeded_max_relaunch()

    def failure_is_fatal(self, node: Node) -> bool:
        """Does this failure end the job?"""
        return self.critical and not self.relaunchable(node)


class WorkerManager(TrainingNodeManager):
    """The allreduce training group (ref ``WorkerManager:102``)."""

    node_type = NodeType.WORKER
    critical = False


class ChiefManager(TrainingNodeManager):
    """The coordination-owning node (ref ``ChiefManager:32``): its
    unrecoverable failure is job-fatal."""

    node_type = NodeType.CHIEF
    critical = True


class EvaluatorManager(TrainingNodeManager):
    """Side evaluation nodes (ref ``EvaluatorManager:66``): they
    complete independently — the job may finish training while
    evaluation still runs, and eval failures never kill training."""

    node_type = NodeType.EVALUATOR
    critical = False

    def wait_for_evaluation(self) -> bool:
        """True when the job should keep running only for evaluators
        (training done, eval still in flight)."""
        return bool(self.running_nodes() or self.pending_nodes())


_MANAGER_TYPES = {
    NodeType.WORKER: WorkerManager,
    NodeType.CHIEF: ChiefManager,
    NodeType.EVALUATOR: EvaluatorManager,
}


class NodeGroupRegistry:
    """Routes nodes to their per-type manager (the reference keeps one
    manager per replica group inside DistributedJobManager)."""

    def __init__(self, max_relaunch_count: Optional[int] = None):
        self._managers: Dict[str, TrainingNodeManager] = {}
        self._max_relaunch = max_relaunch_count

    def manager(self, node_type: str) -> TrainingNodeManager:
        mgr = self._managers.get(node_type)
        if mgr is None:
            cls = _MANAGER_TYPES.get(node_type, TrainingNodeManager)
            mgr = cls(max_relaunch_count=self._max_relaunch)
            self._managers[node_type] = mgr
        return mgr

    def route(self, node: Node) -> TrainingNodeManager:
        mgr = self.manager(node.type)
        mgr.add_node(node)
        return mgr

    def training_finished(self) -> bool:
        """Training is done when chief+workers finished, regardless of
        evaluators (ref semantics: evaluation trails training)."""
        for node_type in (NodeType.CHIEF, NodeType.WORKER):
            mgr = self._managers.get(node_type)
            if mgr and mgr.nodes and not mgr.all_finished():
                return False
        return True

    def job_should_stop(self, failed_node: Node) -> bool:
        """A failure is job-fatal when its group says so."""
        mgr = self.manager(failed_node.type)
        fatal = mgr.failure_is_fatal(failed_node)
        if fatal:
            logger.error(
                "fatal failure: %s node %s exhausted its relaunch "
                "budget", failed_node.type, failed_node.id,
            )
        return fatal
