"""Ray platform variant: actor-based scheduler/watcher/scaler.

Copy of ``dlrover_tpu/scheduler/ray.py`` (imports rewritten to the
port): ``RayClient``, ``FakeRayClient``, ``ActorWatcher``,
``ActorScaler`` and the actor-name helpers.  Two changes: ``ray`` is
imported only inside ``RayClient`` (it is installed neither where the
tests run nor beside the cards), and an actor asks Ray for the node's
cards as ``num_gpus`` where the reference asks for a ``TPU`` resource.

Reference parity: ``dlrover/python/scheduler/ray.py`` (Ray job args +
actor client), ``master/watcher/ray_watcher.py:109`` (actor watcher)
and ``master/scaler/ray_scaler.py:39`` (``ActorScaler``).  The master
treats Ray exactly like k8s: nodes are named units some cluster
substrate runs, a watcher turns substrate state into ``NodeEvent``s
and a scaler executes ``ScalePlan``s — only this module knows the
substrate is Ray actors instead of pods.  Everything is injectable:
:class:`FakeRayClient` (an in-memory actor table) is what tests and
local dry runs use, mirroring ``FakeWatcher``.
"""

import threading
from typing import Callable, Dict, List, Optional

from dlrover_tpu_torch.common.constants import (
    NodeEventType,
    NodeStatus,
    NodeType,
)
from dlrover_tpu_torch.common.log import default_logger as logger
from dlrover_tpu_torch.common.messages import ScalePlan
from dlrover_tpu_torch.common.node import Node, NodeResource
from dlrover_tpu_torch.master.job_manager import NodeEvent
from dlrover_tpu_torch.master.scaler import Scaler
from dlrover_tpu_torch.master.watcher import NodeWatcher

# Ray actor states -> node lifecycle states
_ACTOR_STATE_TO_STATUS = {
    "DEPENDENCIES_UNREADY": NodeStatus.PENDING,
    "PENDING_CREATION": NodeStatus.PENDING,
    "ALIVE": NodeStatus.RUNNING,
    "RESTARTING": NodeStatus.PENDING,
    "DEAD": NodeStatus.FAILED,
}


def actor_state_to_status(state: str, exit_ok: bool = False) -> str:
    if state == "DEAD" and exit_ok:
        return NodeStatus.SUCCEEDED
    return _ACTOR_STATE_TO_STATUS.get(state, NodeStatus.UNKNOWN)


class RayClient:
    """Thin wrapper over the Ray actor APIs (list/create/kill); every
    consumer takes a client instance so tests inject fakes."""

    _instance = None
    _lock = threading.Lock()

    def __init__(self, namespace: str = "dlrover_tpu"):
        try:
            import ray
        except ImportError as e:
            raise RuntimeError(
                "the ray package is not installed; inject a "
                "FakeRayClient or run on the k8s/local platform"
            ) from e
        self._ray = ray
        self._namespace = namespace
        if not ray.is_initialized():  # pragma: no cover
            ray.init(namespace=namespace, ignore_reinit_error=True)

    @classmethod
    def singleton_instance(cls, namespace: str = "dlrover_tpu"):
        with cls._lock:
            if cls._instance is None:
                cls._instance = cls(namespace)
        return cls._instance

    def create_actor(
        self, name: str, actor_cls, resource: NodeResource, **kwargs
    ):  # pragma: no cover - requires a ray cluster
        options = {
            "name": name,
            "lifetime": "detached",
            "num_cpus": resource.cpu or 1,
        }
        if resource.tpu_chips:
            # the node's cards (NodeResource keeps the reference's field
            # name for the accelerator count)
            options["num_gpus"] = resource.tpu_chips
        return actor_cls.options(**options).remote(**kwargs)

    def remove_actor(self, name: str):  # pragma: no cover
        ray = self._ray
        try:
            ray.kill(ray.get_actor(name, namespace=self._namespace))
        except ValueError:
            pass

    def list_actors(self) -> List[Dict]:  # pragma: no cover
        from ray.util.state import list_actors

        out = []
        for a in list_actors(detail=True):
            if not a.name:
                continue
            # a DEAD actor's death cause distinguishes clean exits and
            # intentional kills (INTENDED_*) from crashes
            cause = str(getattr(a, "death_cause", "") or "")
            out.append(
                {
                    "name": a.name,
                    "state": a.state,
                    "exit_ok": "INTENDED" in cause.upper(),
                }
            )
        return out


class FakeRayClient:
    """In-memory actor table with the same surface the watcher/scaler
    consume; tests drive it by mutating ``actors`` / calling
    ``set_state``."""

    def __init__(self):
        self.actors: Dict[str, Dict] = {}
        self.created: List[str] = []
        self.removed: List[str] = []

    def create_actor(self, name: str, actor_cls=None,
                     resource: Optional[NodeResource] = None, **kwargs):
        # reusing a DEAD actor's name overwrites the stale entry,
        # matching Ray's named detached actor semantics
        self.actors[name] = {
            "name": name, "state": "PENDING_CREATION", "exit_ok": False,
        }
        self.created.append(name)

    def remove_actor(self, name: str):
        # real Ray keeps killed actors in the table as DEAD with an
        # INTENDED death cause until GC; model that, not deletion
        if name in self.actors:
            self.actors[name]["state"] = "DEAD"
            self.actors[name]["exit_ok"] = True
        self.removed.append(name)

    def gc_actor(self, name: str):
        """Simulate the actor-table GC finally dropping an entry."""
        self.actors.pop(name, None)

    def set_state(self, name: str, state: str, exit_ok: bool = False):
        if name in self.actors:
            self.actors[name]["state"] = state
            self.actors[name]["exit_ok"] = exit_ok

    def list_actors(self) -> List[Dict]:
        return list(self.actors.values())


def _actor_name(job_name: str, node_type: str, node_id: int) -> str:
    return f"{job_name}-{node_type}-{node_id}"


def _parse_actor_name(name: str):
    """job-type-id -> (node_type, node_id) or None for foreign actors."""
    parts = name.rsplit("-", 2)
    if len(parts) != 3:
        return None
    _, node_type, id_str = parts
    try:
        return node_type, int(id_str)
    except ValueError:
        return None


class ActorWatcher(NodeWatcher):
    """Poll the Ray actor table; emit a NodeEvent per state change
    (Ray has no k8s-style watch stream for actors — the reference's
    ray watcher polls too)."""

    def __init__(
        self,
        job_name: str,
        client,
        poll_interval: float = 2.0,
    ):
        self._job_name = job_name
        self._client = client
        self._interval = poll_interval
        self._stopped = threading.Event()
        self._last: Dict[str, str] = {}

    def _actor_to_node(self, info: Dict) -> Optional[Node]:
        name = info.get("name", "")
        if not name.startswith(self._job_name + "-"):
            return None
        parsed = _parse_actor_name(name)
        if parsed is None:
            return None
        node_type, node_id = parsed
        return Node(
            node_type=node_type,
            node_id=node_id,
            name=name,
            status=actor_state_to_status(
                info.get("state", ""),
                exit_ok=bool(info.get("exit_ok", False)),
            ),
        )

    def list(self) -> List[Node]:
        nodes = []
        for info in self._client.list_actors():
            node = self._actor_to_node(info)
            if node is not None:
                nodes.append(node)
        return nodes

    def watch(self, handler: Callable[[NodeEvent], None]):
        while not self._stopped.is_set():
            try:
                seen: Dict[str, str] = {}
                for info in self._client.list_actors():
                    node = self._actor_to_node(info)
                    if node is None:
                        continue
                    seen[node.name] = node.status
                    if self._last.get(node.name) != node.status:
                        handler(
                            NodeEvent(NodeEventType.MODIFIED, node)
                        )
                # an actor vanishing from the table is a deletion
                for name in set(self._last) - set(seen):
                    parsed = _parse_actor_name(name)
                    if parsed is None:
                        continue
                    node_type, node_id = parsed
                    handler(
                        NodeEvent(
                            NodeEventType.DELETED,
                            Node(
                                node_type=node_type,
                                node_id=node_id,
                                name=name,
                                status=NodeStatus.DELETED,
                            ),
                        )
                    )
                self._last = seen
            except Exception as e:  # noqa: BLE001
                logger.warning("actor watch error: %s", e)
            self._stopped.wait(self._interval)

    def stop(self):
        self._stopped.set()


class ActorScaler(Scaler):
    """Execute ScalePlans against the Ray actor table (reference
    ``ray_scaler.py:39``): group resources set target counts, explicit
    launch/remove lists override."""

    def __init__(self, job_name: str, client, actor_cls=None):
        super().__init__(job_name)
        self._client = client
        self._actor_cls = actor_cls

    def _existing(self, node_type: str) -> Dict[int, str]:
        """LIVE actors only: a DEAD entry lingers in Ray's actor table
        but holds no slot — counting it would leave a crashed worker
        permanently unreplaced."""
        out = {}
        for info in self._client.list_actors():
            name = info.get("name", "")
            if not name.startswith(self._job_name + "-"):
                continue
            if info.get("state") == "DEAD":
                continue
            parsed = _parse_actor_name(name)
            if parsed and parsed[0] == node_type:
                out[parsed[1]] = name
        return out

    @staticmethod
    def _group_resource(group: Dict) -> NodeResource:
        resource = group.get("resource", "")
        if isinstance(resource, str):
            return NodeResource.resource_str_to_node_resource(resource)
        return resource

    def scale(self, plan: ScalePlan):
        """Plan convention (shared with TpuPodScaler):
        ``node_group_resources`` = {type: {"count": N, ...}},
        ``remove_nodes`` = actor names, ``launch_nodes`` /
        ``migrate_nodes`` values = node-spec dicts."""
        for node_type, group in plan.node_group_resources.items():
            count = group.get("count", 0)
            resource = self._group_resource(group)
            existing = self._existing(node_type)
            # scale up: fill the smallest free ids (a DEAD actor's
            # name is reusable — Ray frees it on death)
            next_id = 0
            while len(existing) < count:
                while next_id in existing:
                    next_id += 1
                name = _actor_name(self._job_name, node_type, next_id)
                self._client.create_actor(
                    name, self._actor_cls, resource
                )
                existing[next_id] = name
                logger.info("ray scale-up: %s", name)
            # scale down: drop the highest ids first
            for node_id in sorted(existing, reverse=True):
                if len(existing) <= count:
                    break
                self._client.remove_actor(existing.pop(node_id))
        for name in plan.remove_nodes:
            self._client.remove_actor(name)
        for node_spec in plan.launch_nodes:
            node_type = node_spec.get("type", NodeType.WORKER)
            existing = self._existing(node_type)
            next_id = 0
            while next_id in existing:
                next_id += 1
            self._client.create_actor(
                _actor_name(self._job_name, node_type, next_id),
                self._actor_cls,
                self._group_resource(node_spec),
            )
        # migrate = launch a replacement, then kill the old actor
        for name, node_spec in plan.migrate_nodes.items():
            node_type = node_spec.get("type", NodeType.WORKER)
            existing = self._existing(node_type)
            next_id = 0
            while next_id in existing:
                next_id += 1
            self._client.create_actor(
                _actor_name(self._job_name, node_type, next_id),
                self._actor_cls,
                self._group_resource(node_spec),
            )
            self._client.remove_actor(name)
