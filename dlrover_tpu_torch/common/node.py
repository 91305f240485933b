"""Node model: resources + lifecycle bookkeeping for a TPU-VM worker.

Copy of ``dlrover_tpu/common/node.py``.

Reference parity: ``dlrover/python/common/node.py:37,124,149``
(NodeResource / NodeGroupResource / Node).  TPU twist: the resource unit
is a TPU-VM worker with N chips on an ICI slice; ``tpu_topology`` carries
the slice shape instead of gpu_type.
"""

import copy
import time
from dataclasses import dataclass, field
from typing import Dict, Optional

from dlrover_tpu_torch.common.constants import (
    NodeExitReason,
    NodeStatus,
    NodeType,
)


@dataclass
class NodeResource:
    """Resources of a node.

    cpu: cores; memory: MiB; tpu_chips: chips attached to this worker;
    tpu_type: e.g. "v5e"; tpu_topology: e.g. "4x4".
    """

    cpu: float = 0.0
    memory: int = 0
    tpu_chips: int = 0
    tpu_type: str = ""
    tpu_topology: str = ""
    priority: str = ""

    @classmethod
    def resource_str_to_node_resource(cls, resource: str) -> "NodeResource":
        """Parse "cpu=4,memory=8192,tpu_chips=4" style strings."""
        kwargs: Dict[str, object] = {}
        for item in resource.split(","):
            if not item.strip():
                continue
            key, _, value = item.partition("=")
            key = key.strip().lower()
            value = value.strip()
            if key == "cpu":
                kwargs["cpu"] = float(value)
            elif key in ("memory", "mem"):
                kwargs["memory"] = int(value.lower().rstrip("mi"))
            elif key == "tpu_chips":
                kwargs["tpu_chips"] = int(value)
            elif key == "tpu_type":
                kwargs["tpu_type"] = value
            elif key == "tpu_topology":
                kwargs["tpu_topology"] = value
        return cls(**kwargs)  # type: ignore[arg-type]


@dataclass
class NodeGroupResource:
    """Replica-group resource spec (count x per-node resource)."""

    count: int = 0
    node_resource: NodeResource = field(default_factory=NodeResource)

    def update(self, count: int = 0, cpu: float = 0, memory: int = 0):
        if count > 0:
            self.count = count
        if cpu > 0:
            self.node_resource.cpu = cpu
        if memory > 0:
            self.node_resource.memory = memory


class Node:
    """A supervised node with status/rank/relaunch bookkeeping."""

    def __init__(
        self,
        node_type: str = NodeType.WORKER,
        node_id: int = 0,
        rank_index: Optional[int] = None,
        name: str = "",
        status: str = NodeStatus.INITIAL,
        config_resource: Optional[NodeResource] = None,
        max_relaunch_count: int = 3,
        relaunchable: bool = True,
        critical: bool = False,
    ):
        self.type = node_type
        self.id = node_id
        self.rank_index = rank_index if rank_index is not None else node_id
        self.name = name or f"{node_type}-{node_id}"
        self.status = status
        self.config_resource = config_resource or NodeResource()
        self.used_resource = NodeResource()
        self.max_relaunch_count = max_relaunch_count
        self.relaunch_count = 0
        self.relaunchable = relaunchable
        self.critical = critical
        self.exit_reason = ""
        self.create_time: Optional[float] = None
        self.start_time: Optional[float] = None
        self.finish_time: Optional[float] = None
        self.heartbeat_time: float = 0.0
        self.host_addr = ""
        self.host_port = 0
        self.restart_training = False
        self.paral_config = None
        self.start_hang_time: float = 0.0
        self.reported_status = NodeStatus.INITIAL
        self.is_released = False
        self.group: Optional[int] = None

    def update_status(self, status: str):
        if status != NodeStatus.UNKNOWN:
            self.status = status
        if status == NodeStatus.RUNNING and self.start_time is None:
            self.start_time = time.time()
        if status in NodeStatus.end_states():
            self.finish_time = time.time()

    def inc_relaunch_count(self):
        self.relaunch_count += 1

    def exceeded_max_relaunch(self) -> bool:
        return self.relaunch_count >= self.max_relaunch_count

    def update_node_check_result(self, succeeded: bool, elapsed: float):
        self.check_succeeded = succeeded
        self.check_elapsed = elapsed

    def set_exit_reason(self, reason: str):
        self.exit_reason = reason
        # only ever *clear* relaunchable; a node marked non-relaunchable
        # stays retired regardless of later exit reasons
        if reason == NodeExitReason.FATAL_ERROR:
            self.relaunchable = False

    def is_unrecoverable_failure(self) -> bool:
        if not self.relaunchable:
            return True
        if self.exceeded_max_relaunch():
            return True
        return self.exit_reason == NodeExitReason.FATAL_ERROR

    def timeout(self, timeout_secs: float) -> bool:
        now = time.time()
        if (
            self.heartbeat_time > 0
            and now - self.heartbeat_time > timeout_secs
            and self.status == NodeStatus.RUNNING
        ):
            return True
        return False

    def get_relaunch_node(self, new_id: int) -> "Node":
        """Build the replacement node after a relaunch decision."""
        new_node = copy.deepcopy(self)
        new_node.id = new_id
        new_node.name = f"{self.type}-{new_id}"
        new_node.status = NodeStatus.INITIAL
        new_node.start_time = None
        new_node.finish_time = None
        new_node.create_time = None
        new_node.is_released = False
        new_node.exit_reason = ""
        new_node.heartbeat_time = 0
        new_node.relaunch_count = self.relaunch_count
        return new_node

    def __repr__(self):  # pragma: no cover - debugging aid
        return (
            f"Node(type={self.type}, id={self.id}, rank={self.rank_index},"
            f" status={self.status})"
        )
