"""Legal node status-machine transitions.

Copy of ``dlrover_tpu/master/status_flow.py``.

Reference parity: ``dlrover/python/master/node/status_flow.py:27``
(``NODE_STATE_FLOWS``).
"""

from dataclasses import dataclass

from dlrover_tpu_torch.common.constants import NodeStatus


@dataclass(frozen=True)
class NodeStateFlow:
    from_status: str
    to_status: str
    should_relaunch: bool = False


ALLOWED_TRANSITIONS = {
    (NodeStatus.INITIAL, NodeStatus.PENDING),
    (NodeStatus.INITIAL, NodeStatus.RUNNING),
    (NodeStatus.INITIAL, NodeStatus.FAILED),
    (NodeStatus.INITIAL, NodeStatus.DELETED),
    (NodeStatus.PENDING, NodeStatus.RUNNING),
    (NodeStatus.PENDING, NodeStatus.SUCCEEDED),
    (NodeStatus.PENDING, NodeStatus.FAILED),
    (NodeStatus.PENDING, NodeStatus.DELETED),
    (NodeStatus.RUNNING, NodeStatus.SUCCEEDED),
    (NodeStatus.RUNNING, NodeStatus.FAILED),
    (NodeStatus.RUNNING, NodeStatus.DELETED),
    (NodeStatus.RUNNING, NodeStatus.BREAKDOWN),
    (NodeStatus.SUCCEEDED, NodeStatus.DELETED),
    (NodeStatus.FAILED, NodeStatus.DELETED),
    (NodeStatus.BREAKDOWN, NodeStatus.DELETED),
}

_RELAUNCH_TRIGGERS = {NodeStatus.FAILED, NodeStatus.DELETED,
                      NodeStatus.BREAKDOWN}


def get_node_state_flow(from_status: str, to_status: str):
    """Return the flow if legal else None; flags whether the transition
    is a relaunch trigger (failure-ish end state from a live state)."""
    if from_status == to_status:
        return None
    if (from_status, to_status) not in ALLOWED_TRANSITIONS:
        return None
    should_relaunch = (
        to_status in _RELAUNCH_TRIGGERS
        and from_status
        in (NodeStatus.INITIAL, NodeStatus.PENDING, NodeStatus.RUNNING)
    )
    return NodeStateFlow(from_status, to_status, should_relaunch)
