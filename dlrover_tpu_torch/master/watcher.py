"""Node watchers: cluster events -> NodeEvents for the job manager.

Copy of ``dlrover_tpu/master/watcher.py`` (imports rewritten to the
port): ``pod_phase_to_status``, ``NodeWatcher``, ``PodWatcher`` and
``FakeWatcher``.  ``PodWatcher`` imports the ``kubernetes`` package
only when it builds its own client (``scheduler/kubernetes.py``), so
this module imports on a machine without it.

Reference parity: ``dlrover/python/master/watcher/`` — ``PodWatcher``
(``k8s_watcher.py``: list/watch pods, map phases to NodeStatus) and the
base watcher.  The client is injected (tests use fakes, per the
reference's own strategy).
"""

import threading
from abc import ABCMeta, abstractmethod
from typing import Callable, List, Optional

from dlrover_tpu_torch.common.constants import NodeEventType, NodeStatus
from dlrover_tpu_torch.common.log import default_logger as logger
from dlrover_tpu_torch.common.node import Node
from dlrover_tpu_torch.master.job_manager import NodeEvent

_POD_PHASE_TO_STATUS = {
    "Pending": NodeStatus.PENDING,
    "Running": NodeStatus.RUNNING,
    "Succeeded": NodeStatus.SUCCEEDED,
    "Failed": NodeStatus.FAILED,
    "Unknown": NodeStatus.UNKNOWN,
}


def pod_phase_to_status(phase: str) -> str:
    return _POD_PHASE_TO_STATUS.get(phase, NodeStatus.UNKNOWN)


class NodeWatcher(metaclass=ABCMeta):
    @abstractmethod
    def list(self) -> List[Node]:
        ...

    @abstractmethod
    def watch(self, handler: Callable[[NodeEvent], None]):
        """Blocking watch loop, one NodeEvent per cluster change."""


class PodWatcher(NodeWatcher):
    """k8s pod list/watch → NodeEvent (reference ``k8s_watcher.py``)."""

    def __init__(self, job_name: str, k8s_client=None):
        if k8s_client is None:
            from dlrover_tpu_torch.scheduler.kubernetes import k8sClient

            k8s_client = k8sClient.singleton_instance()
        self._client = k8s_client
        self._job_name = job_name
        self._selector = f"job={job_name}"
        self._stopped = threading.Event()

    def _pod_to_node(self, pod) -> Optional[Node]:
        meta = pod.metadata
        labels = meta.labels or {}
        try:
            node_id = int(labels.get("node-id", "-1"))
        except ValueError:
            return None
        if node_id < 0:
            return None
        node = Node(
            node_type=labels.get("node-type", "worker"),
            node_id=node_id,
            name=meta.name,
            status=pod_phase_to_status(pod.status.phase),
        )
        if pod.status.phase == "Failed":
            # exit reason from the first terminated container
            statuses = pod.status.container_statuses or []
            for cs in statuses:
                term = cs.state and cs.state.terminated
                if term:
                    node.exit_reason = term.reason or ""
                    break
        return node

    def list(self) -> List[Node]:
        pods = self._client.list_pods(self._selector)
        nodes = []
        for pod in pods.items:
            node = self._pod_to_node(pod)
            if node:
                nodes.append(node)
        return nodes

    def watch(self, handler: Callable[[NodeEvent], None]):
        backoff = 1.0
        while not self._stopped.is_set():
            try:
                for raw in self._client.watch_pods(self._selector):
                    if self._stopped.is_set():
                        return
                    backoff = 1.0  # stream is healthy
                    node = self._pod_to_node(raw["object"])
                    if node is None:
                        continue
                    etype = {
                        "ADDED": NodeEventType.ADDED,
                        "MODIFIED": NodeEventType.MODIFIED,
                        "DELETED": NodeEventType.DELETED,
                    }.get(raw["type"], NodeEventType.MODIFIED)
                    handler(NodeEvent(etype, node))
            except Exception as e:  # noqa: BLE001
                logger.warning(
                    "pod watch interrupted: %s; retry in %.0fs",
                    e,
                    backoff,
                )
                if self._stopped.wait(backoff):
                    return
                backoff = min(backoff * 2, 60.0)

    def stop(self):
        self._stopped.set()


class FakeWatcher(NodeWatcher):
    """Test double: events pushed programmatically."""

    def __init__(self, nodes: Optional[List[Node]] = None):
        self._nodes = nodes or []
        self._handler = None

    def list(self) -> List[Node]:
        return list(self._nodes)

    def watch(self, handler):
        self._handler = handler

    def push(self, event: NodeEvent):
        if self._handler:
            self._handler(event)
