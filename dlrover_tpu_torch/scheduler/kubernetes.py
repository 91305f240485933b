"""k8s client wrapper + job args (scheduler abstraction).

Copy of ``dlrover_tpu/scheduler/kubernetes.py``.  The ``kubernetes``
package is optional (installed neither where the tests run nor beside
the card): it is imported only when a ``k8sClient`` is built, which
raises a clear error without it; tests inject fakes, the reference's
own test strategy (``mock.patch`` of k8sClient, SURVEY.md §4).

Reference parity: ``dlrover/python/scheduler/kubernetes.py`` (the
``k8sClient`` singleton every watcher/scaler uses) and
``scheduler/job.py:70`` (``JobArgs``).
"""

import threading
from dataclasses import dataclass, field
from typing import Dict, Optional

from dlrover_tpu_torch.common.constants import DistributionStrategy
from dlrover_tpu_torch.common.log import default_logger as logger


@dataclass
class NodeGroupArgs:
    count: int = 0
    resource: str = ""  # "cpu=4,memory=8192,tpu_chips=4"
    restart_count: int = 3
    critical: bool = False


@dataclass
class JobArgs:
    """Per-job config assembled from the platform (CRD/env)."""

    platform: str = "local"
    namespace: str = "default"
    job_name: str = "job"
    distribution_strategy: str = DistributionStrategy.ALLREDUCE
    node_groups: Dict[str, NodeGroupArgs] = field(default_factory=dict)
    relaunch_on_worker_failure: int = 3
    remove_exited_node: bool = True
    tpu_type: str = ""
    tpu_topology: str = ""


class k8sClient:
    """Thin wrapper over the k8s CoreV1/CustomObjects APIs."""

    _instance: Optional["k8sClient"] = None
    _lock = threading.Lock()

    def __init__(self, namespace: str = "default"):
        try:
            from kubernetes import client as k8s_api
            from kubernetes import config as k8s_config
        except ImportError as e:
            raise RuntimeError(
                "the kubernetes package is not installed; inject a "
                "fake client or run platform=local"
            ) from e
        try:
            k8s_config.load_incluster_config()
        except Exception:  # noqa: BLE001
            k8s_config.load_kube_config()
        self.namespace = namespace
        self.core = k8s_api.CoreV1Api()
        self.custom = k8s_api.CustomObjectsApi()

    @classmethod
    def singleton_instance(cls, namespace: str = "default") -> "k8sClient":
        with cls._lock:
            if cls._instance is None:
                cls._instance = cls(namespace)
            return cls._instance

    # ------------------------------------------------------------- pods
    def create_pod(self, manifest: Dict):
        return self.core.create_namespaced_pod(self.namespace, manifest)

    def delete_pod(self, name: str):
        return self.core.delete_namespaced_pod(name, self.namespace)

    def list_pods(self, label_selector: str = ""):
        return self.core.list_namespaced_pod(
            self.namespace, label_selector=label_selector
        )

    def count_pods(self, job_name: str, node_type: str) -> int:
        pods = self.list_pods(
            f"job={job_name},node-type={node_type}"
        )
        return len(pods.items)

    def watch_pods(self, label_selector: str = ""):
        from kubernetes import watch as k8s_watch

        w = k8s_watch.Watch()
        return w.stream(
            self.core.list_namespaced_pod,
            self.namespace,
            label_selector=label_selector,
        )

    # ------------------------------------------------------ custom CRDs
    def create_custom_resource(self, group: str, version: str,
                               plural: str, body: Dict):
        return self.custom.create_namespaced_custom_object(
            group, version, self.namespace, plural, body
        )

    def get_custom_resource(self, group: str, version: str,
                            plural: str, name: str):
        return self.custom.get_namespaced_custom_object(
            group, version, self.namespace, plural, name
        )

    def list_custom_resource(self, group: str, version: str,
                             plural: str):
        return self.custom.list_namespaced_custom_object(
            group, version, self.namespace, plural
        )

    def update_custom_resource_status(self, group: str, version: str,
                                      plural: str, name: str,
                                      body: Dict):
        return self.custom.patch_namespaced_custom_object_status(
            group, version, self.namespace, plural, name, body
        )


def new_job_args(platform: str = "local", job_name: str = "job",
                 **kwargs) -> JobArgs:
    """Factory (reference ``scheduler/factory.py:33``)."""
    args = JobArgs(platform=platform, job_name=job_name, **kwargs)
    if platform == "local" and not args.node_groups:
        args.node_groups = {"worker": NodeGroupArgs(count=1)}
    logger.info("job args: %s", args)
    return args
