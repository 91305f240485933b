"""Scalers: execute ScalePlans against the cluster substrate.

Reference parity: ``dlrover/python/master/scaler/`` — ``Scaler`` ABC
(``base_scaler.py``), ``PodScaler`` (``pod_scaler.py:77``: direct pod
create with a retry queue), ``ElasticJobScaler``
(``elasticjob_scaler.py``: writes a ScalePlan CRD for the operator).

Copy of ``dlrover_tpu/master/scaler.py`` (imports rewritten).  A
"node" is a worker pod.  ``GpuPodScaler`` (the reference's
``TpuPodScaler``, the same logic) drives the k8s API when the
``kubernetes`` package exists; the pod template decides the
accelerator.  ``InMemoryScaler`` is the test double (reference tests
mock k8sClient the same way, SURVEY.md §4).  ``Scaler.scale_to`` and
``relaunch`` are the port's: the reference's ``DistributedJobManager``
calls both and no scaler of the reference defines either, so its
distributed master with a scaler fails at ``start``.  Both are plans
through ``scale``.
"""

import threading
import time
from abc import ABCMeta, abstractmethod
from typing import Dict, List, Optional

from dlrover_tpu_torch.common.log import default_logger as logger
from dlrover_tpu_torch.common.messages import ScalePlan
from dlrover_tpu_torch.common.node import Node, NodeResource
from dlrover_tpu_torch.common.constants import NodeStatus, NodeType


class Scaler(metaclass=ABCMeta):
    def __init__(self, job_name: str = "job"):
        self._job_name = job_name

    @abstractmethod
    def scale(self, plan: ScalePlan):
        ...

    def scale_to(self, count: int, node_type: str = NodeType.WORKER):
        """Target ``count`` nodes of ``node_type``: what
        ``DistributedJobManager.start`` asks for."""
        plan = ScalePlan()
        plan.node_group_resources[node_type] = {"count": count}
        self.scale(plan)

    def relaunch(self, node: Node, new_node: Node):
        """Replace a dead node: its pod goes, and one for ``new_node``'s
        id comes (``DistributedJobManager._maybe_relaunch``)."""
        plan = ScalePlan()
        plan.remove_nodes.append(node.name)
        plan.launch_nodes.append({"type": new_node.type, "id": new_node.id})
        self.scale(plan)


class InMemoryScaler(Scaler):
    """Records plans and materializes fake nodes — the unit-test
    substrate (and the local single-host mode, where 'scaling' only
    bookkeeps)."""

    def __init__(self, job_name: str = "job"):
        super().__init__(job_name)
        self.plans: List[ScalePlan] = []
        self.alive: Dict[str, Node] = {}
        self._next_id = 0

    def scale(self, plan: ScalePlan):
        self.plans.append(plan)
        for node_type, group in plan.node_group_resources.items():
            count = group.get("count", 0)
            existing = [
                n for n in self.alive.values() if n.type == node_type
            ]
            for _ in range(max(0, count - len(existing))):
                node = Node(
                    node_type=node_type,
                    node_id=self._next_id,
                    status=NodeStatus.PENDING,
                )
                self.alive[node.name] = node
                self._next_id += 1
            # scale-down: drop the newest nodes beyond the target
            excess = len(existing) - count
            if excess > 0:
                for node in sorted(
                    existing, key=lambda n: n.id, reverse=True
                )[:excess]:
                    self.alive.pop(node.name, None)
                    node.update_status(NodeStatus.DELETED)
        for name in plan.remove_nodes:
            node = self.alive.pop(name, None)
            if node:
                node.update_status(NodeStatus.DELETED)
        for node_spec in plan.launch_nodes:
            self._launch(node_spec)
        # migrate = launch the replacement, then remove the old node
        # (the Brain's drain_replace plan; GpuPodScaler mirrors this)
        for name, node_spec in plan.migrate_nodes.items():
            self._launch(node_spec)
            node = self.alive.pop(name, None)
            if node:
                node.update_status(NodeStatus.DELETED)

    def _launch(self, node_spec: Dict):
        node = Node(
            node_type=node_spec.get("type", NodeType.WORKER),
            node_id=self._next_id,
            config_resource=NodeResource(
                cpu=node_spec.get("cpu", 0),
                memory=node_spec.get("memory", 0),
                tpu_chips=node_spec.get("tpu_chips", 0),
            ),
            status=NodeStatus.PENDING,
        )
        self.alive[node.name] = node
        self._next_id += 1


class GpuPodScaler(Scaler):
    """Creates/removes GPU worker pods through the k8s API with a retry
    queue (reference ``PodScaler`` ``pod_scaler.py:77,163,303``).

    The k8s client is injected so tests run without a cluster; when the
    ``kubernetes`` package is absent this scaler refuses to build
    (local mode uses ``InMemoryScaler``).
    """

    def __init__(
        self,
        job_name: str,
        namespace: str = "default",
        k8s_client=None,
        pod_template: Optional[Dict] = None,
        retry_interval: float = 5.0,
        max_retries: int = 3,
    ):
        super().__init__(job_name)
        if k8s_client is None:
            from dlrover_tpu_torch.scheduler.kubernetes import k8sClient

            k8s_client = k8sClient.singleton_instance(namespace)
        self._client = k8s_client
        self._namespace = namespace
        self._pod_template = pod_template or {}
        self._retry_interval = retry_interval
        self._max_retries = max_retries
        self._retry_queue: List = []
        self._lock = threading.Lock()
        self._retry_thread: Optional[threading.Thread] = None

    def _pod_manifest(self, node_type: str, node_id: int,
                      resource: Dict) -> Dict:
        """GPU worker pod: the template carries the container's
        ``resources.limits`` with its ``nvidia.com/gpu`` request (and
        any nodeSelector for the card's type); per-node env carries the
        rank contract."""
        import copy

        from dlrover_tpu_torch.common.constants import NodeEnv

        manifest = {
            "apiVersion": "v1",
            "kind": "Pod",
            "metadata": {
                "name": f"{self._job_name}-{node_type}-{node_id}",
                "labels": {
                    "app": "dlrover-tpu",
                    "job": self._job_name,
                    "node-type": node_type,
                    "node-id": str(node_id),
                },
            },
            # deep copy: env appended below must not mutate the shared
            # template across pods
            "spec": copy.deepcopy(self._pod_template),
        }
        containers = manifest["spec"].setdefault(
            "containers",
            [{"name": "trainer", "image": resource.get("image", "")}],
        )
        env = containers[0].setdefault("env", [])
        env.extend(
            [
                {"name": NodeEnv.NODE_RANK, "value": str(node_id)},
                {"name": NodeEnv.JOB_NAME, "value": self._job_name},
            ]
        )
        return manifest

    def _existing_ids(self, node_type: str):
        """Live pod ids + names from labels (id reuse after a
        mid-range death would 409 on AlreadyExists)."""
        pods = self._client.list_pods(
            f"job={self._job_name},node-type={node_type}"
        )
        ids = {}
        for pod in pods.items:
            labels = pod.metadata.labels or {}
            try:
                ids[int(labels.get("node-id", "-1"))] = pod.metadata.name
            except ValueError:
                continue
        ids.pop(-1, None)
        return ids

    def scale(self, plan: ScalePlan):
        for node_type, group in plan.node_group_resources.items():
            count = group.get("count", 0)
            existing = self._existing_ids(node_type)
            missing = count - len(existing)
            if missing > 0:
                next_id = max(existing, default=-1) + 1
                for i in range(missing):
                    self._create_pod(node_type, next_id + i, group)
            elif missing < 0:
                # scale-down: remove the highest-id pods
                for node_id in sorted(existing, reverse=True)[:-missing]:
                    self._remove_pod(existing[node_id])
        for name in plan.remove_nodes:
            self._remove_pod(name)
        # launch_nodes: replacement pods with fresh ids and per-node
        # resource overrides (OOM memory growth etc.)
        for node_spec in plan.launch_nodes:
            node_type = node_spec.get("type", NodeType.WORKER)
            existing = self._existing_ids(node_type)
            self._create_pod(
                node_type, max(existing, default=-1) + 1, node_spec
            )
        # migrate = launch replacement, then remove the old pod
        for name, node_spec in plan.migrate_nodes.items():
            node_type = node_spec.get("type", NodeType.WORKER)
            existing = self._existing_ids(node_type)
            self._create_pod(
                node_type, max(existing, default=-1) + 1, node_spec
            )
            self._remove_pod(name)

    def _create_pod(self, node_type: str, node_id: int, resource: Dict,
                    attempt: int = 0):
        manifest = self._pod_manifest(node_type, node_id, resource)
        try:
            self._client.create_pod(manifest)
        except Exception as e:  # noqa: BLE001
            if attempt < self._max_retries:
                logger.warning(
                    "pod create failed (%s); queueing retry", e
                )
                with self._lock:
                    self._retry_queue.append(
                        (node_type, node_id, resource, attempt + 1)
                    )
                self._ensure_retry_thread()
            else:
                logger.error("pod create permanently failed: %s", e)

    def _remove_pod(self, name: str):
        try:
            self._client.delete_pod(name)
        except Exception as e:  # noqa: BLE001
            logger.warning("pod delete failed for %s: %s", name, e)

    def _ensure_retry_thread(self):
        if self._retry_thread is not None:
            return

        def _loop():
            while True:
                time.sleep(self._retry_interval)
                with self._lock:
                    queue, self._retry_queue = self._retry_queue, []
                    if not queue:
                        # exit decision under the lock: a concurrent
                        # enqueue either lands before this (we drain
                        # it next loop) or sees _retry_thread=None and
                        # spawns a fresh thread
                        self._retry_thread = None
                        return
                for node_type, node_id, resource, attempt in queue:
                    self._create_pod(
                        node_type, node_id, resource, attempt
                    )

        self._retry_thread = threading.Thread(
            target=_loop, name="pod-scaler-retry", daemon=True
        )
        self._retry_thread.start()


class ElasticJobScaler(Scaler):
    """Writes a ScalePlan custom resource for an external operator to
    reconcile (reference ``elasticjob_scaler.py``)."""

    def __init__(self, job_name: str, namespace: str = "default",
                 k8s_client=None):
        super().__init__(job_name)
        if k8s_client is None:
            from dlrover_tpu_torch.scheduler.kubernetes import k8sClient

            k8s_client = k8sClient.singleton_instance(namespace)
        self._client = k8s_client
        self._namespace = namespace
        self._plan_index = 0

    def scale(self, plan: ScalePlan):
        body = {
            "apiVersion": "elastic.dlrover-tpu.io/v1alpha1",
            "kind": "ScalePlan",
            "metadata": {
                "name": f"{self._job_name}-scaleplan-{self._plan_index}",
                "labels": {"elasticjob-name": self._job_name},
            },
            "spec": {
                "ownerJob": self._job_name,
                "replicaResourceSpecs": plan.node_group_resources,
                "createPods": plan.launch_nodes,
                "removePods": plan.remove_nodes,
                "migratePods": plan.migrate_nodes,
            },
        }
        self._client.create_custom_resource(
            group="elastic.dlrover-tpu.io",
            version="v1alpha1",
            plural="scaleplans",
            body=body,
        )
        self._plan_index += 1
