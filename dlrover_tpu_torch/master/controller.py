"""ElasticJob / ScalePlan controller — the operator's reconcile loops.

Copy of ``dlrover_tpu/master/controller.py`` (imports rewritten to the
port).  It differs from the reference in two places: the master pod
runs ``python -m dlrover_tpu_torch.master.main``, and a worker pod's
resource hints merge into the template's ``resources`` so that a
replacement keeps the template's ``nvidia.com/gpu`` limit.  The CRD
group (``elastic.dlrover-tpu.io``) and plurals are the reference's, so
one set of CRDs (``k8s/crds/``) serves both packages.

Reference parity: the Go kubebuilder operator
(``dlrover/go/operator/pkg/controllers/elasticjob_controller.go:85,182``
— reconcile ElasticJob by creating the job master pod;
``scaleplan_controller.go:79,95`` — apply a ScalePlan's replica specs /
create / remove / migrate pods).  Behavior parity in Python: a
poll-and-reconcile loop over the CRDs (same shapes as ``k8s/crds/``),
driving pods through the same ``k8sClient`` surface the scalers use —
so the whole control plane runs without any Go build.

The client is duck-typed (``scheduler.kubernetes.k8sClient`` in
production, a fake in tests), needing:
``list_pods/create_pod/delete_pod`` and
``list_custom_resource/update_custom_resource_status``.
"""

import threading
import time
from typing import Dict, List, Optional

from dlrover_tpu_torch.common.constants import NodeType
from dlrover_tpu_torch.common.log import default_logger as logger

GROUP = "elastic.dlrover-tpu.io"
VERSION = "v1alpha1"
ELASTICJOB_PLURAL = "elasticjobs"
SCALEPLAN_PLURAL = "scaleplans"

MASTER_SUFFIX = "-dlrover-master"


def update_condition(
    status: Dict,
    cond_type: str,
    cond_status: bool,
    reason: str = "",
    message: str = "",
) -> Dict:
    """Maintain a k8s-style conditions list on a CRD status
    (reference ``dlrover/go/operator/pkg/common/condition.go`` —
    ``setCondition``/``updateJobConditions``): one entry per type,
    ``lastTransitionTime`` touched only when the boolean status
    actually flips."""
    now = time.strftime("%Y-%m-%dT%H:%M:%SZ", time.gmtime())
    want = "True" if cond_status else "False"
    conditions = list(status.get("conditions") or [])
    for cond in conditions:
        if cond.get("type") == cond_type:
            if cond.get("status") != want:
                cond["lastTransitionTime"] = now
            cond.update(
                status=want, reason=reason, message=message
            )
            break
    else:
        conditions.append(
            {
                "type": cond_type,
                "status": want,
                "reason": reason,
                "message": message,
                "lastTransitionTime": now,
            }
        )
    status["conditions"] = conditions
    return status


def _pod_resource(node_spec: Dict) -> Optional[Dict]:
    """Resource hints out of an optimizer node spec ({"type", "memory"
    (MB), "cpu", ...}) — non-resource keys dropped."""
    if not isinstance(node_spec, dict):
        return None
    resource = {
        k: v for k, v in node_spec.items() if k in ("memory", "cpu")
    }
    return resource or None


def master_pod_manifest(job: Dict) -> Dict:
    """Master pod for an ElasticJob (ref ``pkg/controllers/master/
    master.go`` — image/env from the job spec, master command)."""
    name = job["metadata"]["name"]
    spec = job.get("spec", {})
    replica_specs = spec.get("replicaSpecs", {})
    worker = replica_specs.get(NodeType.WORKER, {})
    template = worker.get("template", {}) or {}
    image = "python:3.12"
    containers = (
        template.get("spec", {}).get("containers") or [{}]
    )
    if containers and containers[0].get("image"):
        image = containers[0]["image"]
    return {
        "apiVersion": "v1",
        "kind": "Pod",
        "metadata": {
            "name": f"{name}{MASTER_SUFFIX}",
            "labels": {
                "job": name,
                "node-type": "master",
                "app": "dlrover-tpu",
            },
            "ownerReferences": [
                {
                    "apiVersion": f"{GROUP}/{VERSION}",
                    "kind": "ElasticJob",
                    "name": name,
                    "uid": job["metadata"].get("uid", ""),
                }
            ],
        },
        "spec": {
            "restartPolicy": "Never",
            "containers": [
                {
                    "name": "master",
                    "image": image,
                    "command": [
                        "python", "-m", "dlrover_tpu_torch.master.main",
                        "--platform", "k8s",
                        "--job_name", name,
                    ],
                }
            ],
        },
    }


def worker_pod_manifest(
    job_name: str,
    node_id: int,
    resource: Optional[Dict] = None,
    template: Optional[Dict] = None,
) -> Dict:
    """Worker pod from the ElasticJob's worker template (image /
    command / env carried over, like ``GpuPodScaler._pod_manifest``),
    plus the rank contract env vars agents expect."""
    tmpl_spec = (template or {}).get("spec", {}) or {}
    containers = tmpl_spec.get("containers") or [{}]
    base = dict(containers[0]) if containers else {}
    container = {
        "name": base.get("name", "worker"),
        "image": base.get("image", "python:3.12"),
    }
    for key in ("command", "args", "env", "resources"):
        if base.get(key):
            container[key] = base[key]
    env = list(container.get("env", []))
    env += [
        {"name": "DLROVER_TPU_JOB_NAME", "value": job_name},
        {"name": "NODE_RANK", "value": str(node_id)},
    ]
    container["env"] = env
    if resource:
        # optimizer resource hints: numbers are MB of host memory.
        # Merge INTO the template's resources — replacing the block
        # would drop limits like nvidia.com/gpu and schedule a
        # replacement worker with no card
        resources = dict(container.get("resources", {}))
        requests = dict(resources.get("requests", {}))
        if "memory" in resource:
            requests["memory"] = f"{int(resource['memory'])}Mi"
        if "cpu" in resource:
            requests["cpu"] = str(resource["cpu"])
        resources["requests"] = requests
        container["resources"] = resources
    return {
        "apiVersion": "v1",
        "kind": "Pod",
        "metadata": {
            "name": f"{job_name}-worker-{node_id}",
            "labels": {
                "job": job_name,
                "node-type": NodeType.WORKER,
                "node-id": str(node_id),
                "app": "dlrover-tpu",
            },
        },
        "spec": {
            "restartPolicy": "Never",
            "containers": [container],
        },
    }


class ElasticJobController:
    """Poll-and-reconcile controller for both CRDs."""

    def __init__(self, client, resync_interval: float = 5.0):
        self._client = client
        self._interval = resync_interval
        self._stopped = threading.Event()
        self._thread: Optional[threading.Thread] = None
        # plans already applied (or attempted) by THIS controller,
        # keyed by (name, uid) -> [outcome phase, patched?]: a failed
        # status patch must retry only the patch (then stop — endless
        # re-patching would churn the CR with watch events every
        # resync), and a mid-apply failure must not re-execute creates
        # with fresh worker ids
        self._applied_plans: Dict[tuple, list] = {}

    # -- ElasticJob ------------------------------------------------------
    def reconcile_elasticjob(self, job: Dict):
        """Ensure the job's master pod exists (the master then owns
        worker lifecycle through its scaler — exactly the reference
        split: operator creates the master, master creates workers)."""
        name = job["metadata"]["name"]
        phase = (job.get("status") or {}).get("phase", "")
        if phase in ("Succeeded", "Failed"):
            return
        master_name = f"{name}{MASTER_SUFFIX}"
        pods = self._pods_by_name(f"job={name}")
        if master_name not in pods:
            logger.info("reconcile ElasticJob %s: creating master", name)
            self._client.create_pod(master_pod_manifest(job))
            status = dict(job.get("status") or {})
            status["phase"] = "Running"
            update_condition(
                status, "MasterCreated", True,
                reason="MasterPodCreated",
                message=f"master pod {master_name} created",
            )
            update_condition(
                status, "Running", True, reason="JobRunning",
                message="job master is supervising the job",
            )
            self._set_status(ELASTICJOB_PLURAL, name, status)

    # -- ScalePlan -------------------------------------------------------
    def reconcile_scaleplan(self, plan: Dict):
        """Apply a ScalePlan: replica targets, explicit creates,
        removals and migrations (ref ``scaleplan_controller.go:95``).

        Field dialect matches what the in-repo producers emit:
        ``ElasticJobScaler`` writes the optimizer's
        ``node_group_resources`` verbatim, so replica targets are
        accepted as ``replicas`` OR ``count``; ``launch_nodes`` entries
        carry ``{"type", "memory"(MB), ...}``; ``migratePods`` values
        are node specs (``{"type": ...}``), not k8s resources."""
        name = plan["metadata"]["name"]
        # key by (name, uid): a deleted-and-recreated plan with a
        # reused name is a NEW plan, not an applied one
        plan_key = (name, plan["metadata"].get("uid", ""))
        status = plan.get("status") or {}
        if status.get("phase") in ("Succeeded", "Failed"):
            return
        if plan_key in self._applied_plans:
            entry = self._applied_plans[plan_key]
            if not entry[1]:  # applied but the status patch failed
                entry[1] = self._set_status(
                    SCALEPLAN_PLURAL, name,
                    self._plan_status(entry[0], status),
                )
            return
        spec = plan.get("spec", {})
        owner = spec.get("ownerJob", "")
        # reads first: a transient list failure here must stay
        # retryable (nothing has been mutated yet)
        template = self._worker_template(owner)
        # at-most-once from HERE: mark before the first mutation — a
        # mid-apply failure must not re-execute creates with fresh
        # worker ids every resync (unbounded pod growth); a partially-
        # applied plan is surfaced as Failed instead of silently
        # retried
        self._applied_plans[plan_key] = ["Failed", False]

        # replica targets: diff current worker pods against the target
        replica_specs = spec.get("replicaResourceSpecs", {}) or {}
        worker_target = replica_specs.get(NodeType.WORKER, {})
        target = worker_target.get(
            "replicas", worker_target.get("count")
        )
        if target is not None:
            self._scale_workers(
                owner, int(target), worker_target.get("resource"),
                template,
            )

        for pod in spec.get("createPods", []) or []:
            if "id" in pod:
                node_id = int(pod["id"])
            else:
                node_id = self._next_worker_id(owner)
            self._client.create_pod(
                worker_pod_manifest(
                    owner, node_id, _pod_resource(pod), template
                )
            )
        for pod_name in spec.get("removePods", []) or []:
            self._delete_quietly(pod_name)
        for old_name, node_spec in (spec.get("migratePods") or {}).items():
            # create the replacement first, then drain the old pod
            self._client.create_pod(
                worker_pod_manifest(
                    owner,
                    self._next_worker_id(owner),
                    _pod_resource(node_spec),
                    template,
                )
            )
            self._delete_quietly(old_name)
        patched = self._set_status(
            SCALEPLAN_PLURAL, name,
            self._plan_status("Succeeded", status),
        )
        self._applied_plans[plan_key] = ["Succeeded", patched]

    @staticmethod
    def _plan_status(phase: str, existing: Optional[Dict] = None) -> Dict:
        """ScalePlan status with a condition trail (ref
        ``scaleplan_types.go:29-126`` phase + conditions).  Starts
        from the CR's EXISTING status so ``lastTransitionTime`` only
        moves when the condition actually flips."""
        status: Dict = dict(existing or {})
        status["phase"] = phase
        update_condition(
            status, "Applied", phase == "Succeeded",
            reason=(
                "PlanApplied"
                if phase == "Succeeded"
                else "PlanApplyFailed"
            ),
            message=(
                "all creates/removes/migrations executed"
                if phase == "Succeeded"
                else "plan application did not complete; pods may be "
                "partially scaled"
            ),
        )
        return status

    def _worker_template(self, job_name: str) -> Optional[Dict]:
        """The owner ElasticJob's worker pod template (workers must run
        the job's image/command, not a placeholder)."""
        if not job_name:
            return None
        for job in self._list(ELASTICJOB_PLURAL):
            if job["metadata"]["name"] == job_name:
                return (
                    job.get("spec", {})
                    .get("replicaSpecs", {})
                    .get(NodeType.WORKER, {})
                    .get("template")
                )
        return None

    def _scale_workers(self, job_name: str, target: int,
                       resource: Optional[Dict],
                       template: Optional[Dict] = None):
        workers = self._worker_pods(job_name)
        current = len(workers)
        if current < target:
            existing = {
                int(p["metadata"]["labels"].get("node-id", -1))
                for p in workers.values()
            }
            nid = 0
            for _ in range(target - current):
                while nid in existing:
                    nid += 1
                existing.add(nid)
                self._client.create_pod(
                    worker_pod_manifest(
                        job_name, nid, resource, template
                    )
                )
        elif current > target:
            # remove the highest node-ids first (stable rank prefix)
            doomed = sorted(
                workers.values(),
                key=lambda p: int(
                    p["metadata"]["labels"].get("node-id", 0)
                ),
                reverse=True,
            )[: current - target]
            for pod in doomed:
                self._delete_quietly(pod["metadata"]["name"])

    # -- loop ------------------------------------------------------------
    def reconcile_once(self):
        for job in self._list(ELASTICJOB_PLURAL):
            try:
                self.reconcile_elasticjob(job)
            except Exception as e:  # noqa: BLE001
                logger.warning("ElasticJob reconcile failed: %s", e)
        plans = self._list(SCALEPLAN_PLURAL)
        live = {
            (p["metadata"]["name"], p["metadata"].get("uid", ""))
            for p in plans
        }
        # prune bookkeeping for deleted plans (a recreated name+uid is
        # a fresh plan and must be applied)
        self._applied_plans = {
            k: v for k, v in self._applied_plans.items() if k in live
        }
        for plan in plans:
            try:
                self.reconcile_scaleplan(plan)
            except Exception as e:  # noqa: BLE001
                logger.warning("ScalePlan reconcile failed: %s", e)

    def start(self):
        if self._thread is not None:
            return
        self._thread = threading.Thread(
            target=self._loop, name="elasticjob-controller", daemon=True
        )
        self._thread.start()

    def stop(self):
        self._stopped.set()

    def _loop(self):
        while not self._stopped.wait(self._interval):
            try:
                self.reconcile_once()
            except Exception as e:  # noqa: BLE001
                logger.warning("reconcile cycle failed: %s", e)

    # -- client helpers --------------------------------------------------
    def _list(self, plural: str) -> List[Dict]:
        try:
            out = self._client.list_custom_resource(
                GROUP, VERSION, plural
            )
        except Exception:  # noqa: BLE001
            return []
        return list(out.get("items", []))

    def _set_status(
        self, plural: str, name: str, status: Dict
    ) -> bool:
        try:
            self._client.update_custom_resource_status(
                GROUP, VERSION, plural, name, {"status": status}
            )
            return True
        except Exception as e:  # noqa: BLE001
            logger.warning("status update failed for %s: %s", name, e)
            return False

    def _pods_by_name(self, selector: str) -> Dict[str, Dict]:
        pods = self._client.list_pods(selector)
        if isinstance(pods, dict):
            items = pods.get("items", [])
        else:  # kubernetes client object (V1PodList)
            items = pods.items
        out = {}
        for p in items:
            d = p if isinstance(p, dict) else p.to_dict()
            out[d["metadata"]["name"]] = d
        return out

    def _worker_pods(self, job_name: str) -> Dict[str, Dict]:
        return self._pods_by_name(
            f"job={job_name},node-type={NodeType.WORKER}"
        )

    def _next_worker_id(self, job_name: str) -> int:
        ids = [
            int(p["metadata"]["labels"].get("node-id", -1))
            for p in self._worker_pods(job_name).values()
        ]
        return (max(ids) + 1) if ids else 0

    def _delete_quietly(self, pod_name: str):
        try:
            self._client.delete_pod(pod_name)
        except Exception as e:  # noqa: BLE001
            logger.warning("delete %s failed: %s", pod_name, e)
