"""The port's ElasticJob/ScalePlan controller against the JAX package's.

Mirrors ``tests/test_controller.py`` case for case, with its
``FakeK8sClient``: every scenario runs on the port's
``master/controller.py`` (and ``master/net_topology.py``,
``master/rendezvous.py``) and on the JAX package's, and the pods, the
custom resources' statuses and the orders must be equal (a condition's
``lastTransitionTime`` aside), and what the reference's test expects.
The two packages' manifests are equal dicts for one job, apart from the
master's module; a replacement worker keeps the template's
``nvidia.com/gpu`` limit.
"""

import copy
import os

from dlrover_tpu.master import controller as jctl
from dlrover_tpu.master import net_topology as jtopo
from dlrover_tpu.master import rendezvous as jrdzv
from dlrover_tpu_torch.master import controller as tctl
from dlrover_tpu_torch.master import net_topology as ttopo
from dlrover_tpu_torch.master import rendezvous as trdzv

from test_controller import FakeK8sClient, make_job

PKGS = {"torch": tctl, "jax": jctl}


def _timeless(obj):
    """``obj`` without the conditions' transition times."""
    if isinstance(obj, dict):
        return {k: _timeless(v) for k, v in obj.items()
                if k != "lastTransitionTime"}
    if isinstance(obj, list):
        return [_timeless(v) for v in obj]
    return obj


def _module_free(obj):
    """``obj`` with the master's module name made one."""
    if isinstance(obj, dict):
        return {k: _module_free(v) for k, v in obj.items()}
    if isinstance(obj, list):
        return [_module_free(v) for v in obj]
    if obj in ("dlrover_tpu.master.main", "dlrover_tpu_torch.master.main"):
        return "<master module>"
    return obj


def both(scenario):
    """``scenario(controller_module) -> client``; the port's client after
    checking its pods and custom resources equal the reference's."""
    got = {k: scenario(mod) for k, mod in PKGS.items()}
    t, j = got["torch"], got["jax"]
    assert _module_free(_timeless(t.pods)) == _module_free(_timeless(j.pods))
    assert _timeless(t.crds) == _timeless(j.crds)
    return t


def _plan(name="plan1", **spec):
    return {"metadata": {"name": name}, "spec": dict(spec)}


class TestElasticJobReconcile:
    def test_creates_master_pod(self):
        def scenario(ctl):
            client = FakeK8sClient()
            client.add_crd(ctl.ELASTICJOB_PLURAL, make_job())
            c = ctl.ElasticJobController(client)
            c.reconcile_once()
            n = len(client.pods)
            c.reconcile_once()  # idempotent: nothing new
            assert len(client.pods) == n
            return client

        client = both(scenario)
        master = client.pods[f"job1{tctl.MASTER_SUFFIX}"]
        assert master["spec"]["containers"][0]["image"] == "img:1"
        command = master["spec"]["containers"][0]["command"]
        assert command[:3] == ["python", "-m",
                               "dlrover_tpu_torch.master.main"]
        assert command[3:5] == ["--platform", "k8s"]
        assert (client.crds[tctl.ELASTICJOB_PLURAL]["job1"]["status"]
                ["phase"] == "Running")

    def test_finished_job_not_reconciled(self):
        def scenario(ctl):
            client = FakeK8sClient()
            job = make_job()
            job["status"] = {"phase": "Succeeded"}
            client.add_crd(ctl.ELASTICJOB_PLURAL, job)
            ctl.ElasticJobController(client).reconcile_once()
            return client

        assert not both(scenario).pods


class TestScalePlanReconcile:
    def test_replica_target_scales_up_and_down(self):
        def scenario(ctl):
            client = FakeK8sClient()
            c = ctl.ElasticJobController(client)
            client.add_crd(ctl.SCALEPLAN_PLURAL, _plan(
                ownerJob="job1",
                replicaResourceSpecs={"worker": {"replicas": 3}}))
            c.reconcile_once()
            assert len(client.list_pods(
                "job=job1,node-type=worker")["items"]) == 3
            client.add_crd(ctl.SCALEPLAN_PLURAL, _plan(
                name="plan2", ownerJob="job1",
                replicaResourceSpecs={"worker": {"replicas": 1}}))
            c.reconcile_once()
            return client

        client = both(scenario)
        workers = client.list_pods("job=job1,node-type=worker")["items"]
        assert [w["metadata"]["labels"]["node-id"] for w in workers] == ["0"]
        assert (client.crds[tctl.SCALEPLAN_PLURAL]["plan1"]["status"]
                ["phase"] == "Succeeded")

    def test_scaler_dialect_count_and_template(self):
        def scenario(ctl):
            client = FakeK8sClient()
            client.add_crd(ctl.ELASTICJOB_PLURAL, make_job(name="jobx"))
            c = ctl.ElasticJobController(client)
            client.add_crd(ctl.SCALEPLAN_PLURAL, _plan(
                ownerJob="jobx", replicaResourceSpecs={"worker": {"count": 2}}))
            c.reconcile_once()
            return client

        workers = both(scenario).list_pods(
            "job=jobx,node-type=worker")["items"]
        assert len(workers) == 2
        c = workers[0]["spec"]["containers"][0]
        assert c["image"] == "img:1"  # from the ElasticJob template
        env = {e["name"]: e["value"] for e in c["env"]}
        assert env["DLROVER_TPU_JOB_NAME"] == "jobx"
        assert "NODE_RANK" in env

    def test_oom_launch_carries_memory(self):
        def scenario(ctl):
            client = FakeK8sClient()
            c = ctl.ElasticJobController(client)
            client.add_crd(ctl.SCALEPLAN_PLURAL, _plan(
                ownerJob="j2", createPods=[{"type": "worker",
                                            "memory": 24576}]))
            c.reconcile_once()
            return client

        workers = both(scenario).list_pods("job=j2,node-type=worker")["items"]
        reqs = workers[0]["spec"]["containers"][0]["resources"]["requests"]
        assert reqs["memory"] == "24576Mi"

    def test_plan_not_reapplied_after_status_patch_failure(self):
        def scenario(ctl):
            client = FakeK8sClient()
            fails = {"n": 0}
            orig = client.update_custom_resource_status

            def flaky(*args, **kwargs):
                if fails["n"] == 0:
                    fails["n"] += 1
                    raise RuntimeError("transient apiserver error")
                return orig(*args, **kwargs)

            client.update_custom_resource_status = flaky
            c = ctl.ElasticJobController(client)
            client.add_crd(ctl.SCALEPLAN_PLURAL, _plan(
                ownerJob="j3", createPods=[{"type": "worker"}]))
            c.reconcile_once()  # applies; the status patch fails
            n_pods = len(client.pods)
            c.reconcile_once()  # retries only the patch
            assert len(client.pods) == n_pods
            return client

        client = both(scenario)
        assert (client.crds[tctl.SCALEPLAN_PLURAL]["plan1"]["status"]
                ["phase"] == "Succeeded")

    def test_remove_and_migrate(self):
        def scenario(ctl):
            client = FakeK8sClient()
            c = ctl.ElasticJobController(client)
            client.add_crd(ctl.SCALEPLAN_PLURAL, _plan(
                ownerJob="j", replicaResourceSpecs={"worker": {"replicas": 2}}))
            c.reconcile_once()
            client.add_crd(ctl.SCALEPLAN_PLURAL, _plan(
                name="mig", ownerJob="j",
                migratePods={"j-worker-0": {"cpu": "4"}}))
            c.reconcile_once()
            return client

        client = both(scenario)
        assert "j-worker-0" not in client.pods  # the old pod drained
        assert sorted(client.pods) == ["j-worker-1", "j-worker-2"]


class TestTopologySort:
    def test_order_by_topology_groups_switches(self):
        levels = {0: ("pod1", "slice0"), 1: ("pod0", "slice1"),
                  2: ("pod0", "slice1"), 3: ("pod1", "slice0"), 4: ()}
        got = ttopo.order_by_topology([0, 1, 2, 3, 4], levels)
        assert got == jtopo.order_by_topology([0, 1, 2, 3, 4], levels)
        assert got == [1, 2, 0, 3, 4]

    def test_dp_sorter_renumbers(self):
        def scenario(topo):
            nodes = {0: topo.NodeTopologyMeta(node_rank=0, levels=("b", "x")),
                     1: topo.NodeTopologyMeta(node_rank=1, levels=("a", "y")),
                     2: topo.NodeTopologyMeta(node_rank=2, levels=("a", "y"))}
            out = topo.DpTopologySorter().sort(nodes)
            return list(out.keys()), [m.levels for m in out.values()]

        got = scenario(ttopo)
        assert got == scenario(jtopo)
        assert got == ([0, 1, 2], [("a", "y"), ("a", "y"), ("b", "x")])

    def test_static_querier(self):
        for topo in (ttopo, jtopo):
            q = topo.StaticTopologyQuerier({"n0": ("pod0", "slice1")})
            assert q.query("n0") == ("pod0", "slice1")
            assert q.query("nope") is None

    def test_rendezvous_orders_world_by_topology(self):
        def scenario(rdzv):
            mgr = rdzv.ElasticTrainingRendezvousManager()
            mgr.update_rdzv_params(4, 4, 0.1, 1)
            for r, pod in enumerate(("pod1", "pod0", "pod1", "pod0")):
                mgr.set_node_topology(r, (pod,))
            for r in range(4):
                mgr.join_rendezvous(r, 4)
            return list(mgr.get_comm_world(0)[2])

        got = scenario(trdzv)
        assert got == scenario(jrdzv)
        assert got == [1, 3, 0, 2]  # the pod0 pair first


# ------------------------------------------------------ the GPU manifests


def _gpu_job(name="llama"):
    job = make_job(name=name)
    job["spec"]["replicaSpecs"]["worker"]["template"]["spec"]["containers"] \
        = [{"name": "worker", "image": "img:gpu",
            "command": ["python", "-m", "dlrover_tpu_torch.run"],
            "resources": {"limits": {"nvidia.com/gpu": 8},
                          "requests": {"cpu": "32"}}}]
    return job


def test_manifests_equal_the_reference_apart_from_the_module():
    job = _gpu_job()
    master = {k: mod.master_pod_manifest(copy.deepcopy(job))
              for k, mod in PKGS.items()}
    assert master["torch"] != master["jax"]
    assert _module_free(master["torch"]) == _module_free(master["jax"])
    template = job["spec"]["replicaSpecs"]["worker"]["template"]
    for resource in (None, {"memory": 65536, "cpu": 16}):
        worker = {k: mod.worker_pod_manifest("llama", 3, resource,
                                             copy.deepcopy(template))
                  for k, mod in PKGS.items()}
        assert worker["torch"] == worker["jax"]


def test_a_replacement_worker_keeps_its_nvidia_gpu_limit():
    """A migrated worker (the Brain's drain with replace) with memory
    hints still asks for the template's cards."""
    client = FakeK8sClient()
    client.add_crd(tctl.ELASTICJOB_PLURAL, _gpu_job())
    c = tctl.ElasticJobController(client)
    client.add_crd(tctl.SCALEPLAN_PLURAL, _plan(
        ownerJob="llama", replicaResourceSpecs={"worker": {"count": 2}}))
    c.reconcile_once()
    client.add_crd(tctl.SCALEPLAN_PLURAL, _plan(
        name="mig", ownerJob="llama",
        migratePods={"llama-worker-1": {"type": "worker",
                                        "memory": 98304}}))
    c.reconcile_once()
    new = client.pods["llama-worker-2"]["spec"]["containers"][0]
    assert new["resources"]["limits"] == {"nvidia.com/gpu": 8}
    assert new["resources"]["requests"] == {"cpu": "32", "memory": "98304Mi"}
    assert new["command"] == ["python", "-m", "dlrover_tpu_torch.run"]
    assert "llama-worker-1" not in client.pods


def test_the_h100_example_manifest_runs_the_port_on_nvidia_gpus():
    """``k8s/examples/elasticjob-llama-h100.yaml``: the master runs the
    port's master on k8s, and a worker the controller makes from its
    template (a replacement with memory hints too) keeps the cards and
    runs the port's launcher."""
    import yaml

    job = yaml.safe_load(open(os.path.join(
        os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
        "k8s", "examples", "elasticjob-llama-h100.yaml")))
    spec = job["spec"]["replicaSpecs"]
    master = spec["master"]["template"]["spec"]["containers"][0]
    assert master["command"][:3] == ["python", "-m",
                                     "dlrover_tpu_torch.master.main"]
    assert "--platform=k8s" in master["command"]
    template = spec["worker"]["template"]
    for resource in (None, {"memory": 98304}):
        pod = tctl.worker_pod_manifest(job["metadata"]["name"], 5, resource,
                                       copy.deepcopy(template))
        c = pod["spec"]["containers"][0]
        assert c["resources"]["limits"] == {"nvidia.com/gpu": "8"}
        assert c["command"][:3] == ["python", "-m", "dlrover_tpu_torch.run"]
        assert "--node_rank=$(NODE_RANK)" in c["command"]
        env = {e["name"]: e["value"] for e in c["env"]}
        assert env["NODE_RANK"] == "5"
        assert env["DLROVER_TPU_MASTER_ADDR"].startswith(
            "llama-pretrain-h100-dlrover-master:")


# ---------------------------------------------------------- the watchers


def _pod(name, node_id, phase, reason=""):
    from types import SimpleNamespace as NS

    term = NS(reason=reason) if phase == "Failed" else None
    return NS(metadata=NS(name=name, labels={"node-id": str(node_id),
                                             "node-type": "worker"}),
              status=NS(phase=phase, container_statuses=[
                  NS(state=NS(terminated=term))]))


class _PodClient:
    def __init__(self, pods, stream):
        self._pods, self._stream = pods, stream

    def list_pods(self, selector):
        from types import SimpleNamespace as NS

        return NS(items=list(self._pods))

    def watch_pods(self, selector):
        return iter(self._stream)


def test_pod_watcher_lists_and_watches_as_jax():
    from dlrover_tpu.master import watcher as jw
    from dlrover_tpu_torch.master import watcher as tw

    pods = [_pod("j-worker-0", 0, "Running"), _pod("j-worker-1", 1, "Failed",
                                                   "OOMKilled"),
            _pod("j-worker-x", "x", "Pending")]
    stream = [{"type": t, "object": _pod(f"j-worker-{i}", i, phase)}
              for t, i, phase in (("ADDED", 2, "Pending"),
                                  ("MODIFIED", 2, "Running"),
                                  ("DELETED", 0, "Succeeded"),
                                  ("BOOKMARK", 1, "Unknown"))]

    def scenario(w):
        watcher = w.PodWatcher("j", k8s_client=_PodClient(pods, stream))
        listed = [(n.type, n.id, n.name, n.status, n.exit_reason)
                  for n in watcher.list()]
        events = []

        def handler(ev):
            events.append((ev.event_type, ev.node.id, ev.node.status))
            if len(events) == len(stream):
                watcher.stop()

        watcher.watch(handler)
        fake = w.FakeWatcher()
        fake.watch(lambda ev: events.append(("pushed", ev.node.id)))
        fake.push(w.NodeEvent("added", w.Node("worker", 7)))
        return listed, events, [w.pod_phase_to_status(p) for p in (
            "Pending", "Running", "Succeeded", "Failed", "Unknown", "?")]

    got = scenario(tw)
    assert got == scenario(jw)
    listed, events, phases = got
    assert [x[1] for x in listed] == [0, 1]
    assert listed[1][3:] == ("failed", "OOMKilled")
    assert events == [("added", 2, "pending"), ("modified", 2, "running"),
                      ("deleted", 0, "succeeded"), ("modified", 1, "unknown"),
                      ("pushed", 7)]
    assert phases == ["pending", "running", "succeeded", "failed",
                      "unknown", "unknown"]
