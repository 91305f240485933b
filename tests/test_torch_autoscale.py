"""The port's distributed master against the JAX package's.

Mirrors ``tests/test_autoscale_e2e.py`` (conditions, and the whole chain
speed samples -> ``LocalAllreduceOptimizer`` plan -> ``ElasticJobScaler``
ScalePlan custom resource -> ``ElasticJobController`` -> worker pods ->
the new node in the next rendezvous world), run on both packages, and
the ``DistributedJobMaster`` cases of ``tests/test_auto_scaler.py``
(``:542`` on: the Brain's switch and its wiring).  The same scripted
heartbeats and speeds give both packages' ``DistributedJobMaster`` the
same plans and the same exit reasons.  ``python -m
dlrover_tpu_torch.master.main --platform k8s`` builds a distributed
master whose Brain holds an ``ElasticJobScaler`` over a fake client, and
``--platform ray`` one without a scaler.
"""

import sys
import time
import types

import pytest

from dlrover_tpu.common import constants as jconst
from dlrover_tpu.master import auto_scaler as jas
from dlrover_tpu.master import controller as jctl
from dlrover_tpu.master import master as jmaster
from dlrover_tpu.master import rendezvous as jrdzv
from dlrover_tpu.master import resource_optimizer as jro
from dlrover_tpu.master import scaler as jscaler
from dlrover_tpu.master import speed_monitor as jspeed
from dlrover_tpu_torch.common import constants as tconst
from dlrover_tpu_torch.common.env import get_free_port
from dlrover_tpu_torch.master import auto_scaler as tas
from dlrover_tpu_torch.master import controller as tctl
from dlrover_tpu_torch.master import master as tmaster
from dlrover_tpu_torch.master import rendezvous as trdzv
from dlrover_tpu_torch.master import resource_optimizer as tro
from dlrover_tpu_torch.master import scaler as tscaler
from dlrover_tpu_torch.master import speed_monitor as tspeed

from test_autoscale_e2e import (
    FakeJobManager,
    FakeK8sClientWithCrdCreate,
    make_job,
)

PKGS = {
    "torch": types.SimpleNamespace(
        auto=tas, ctl=tctl, master=tmaster, rdzv=trdzv, ro=tro,
        scaler=tscaler, speed=tspeed, const=tconst),
    "jax": types.SimpleNamespace(
        auto=jas, ctl=jctl, master=jmaster, rdzv=jrdzv, ro=jro,
        scaler=jscaler, speed=jspeed, const=jconst),
}


def both(scenario):
    """``scenario(package namespace)`` on both packages; the port's
    result, after checking it equals the reference's."""
    got = {k: scenario(ns) for k, ns in PKGS.items()}
    assert got["torch"] == got["jax"]
    return got["torch"]


def _timeless(obj):
    if isinstance(obj, dict):
        return {k: _timeless(v) for k, v in obj.items()
                if k != "lastTransitionTime"}
    if isinstance(obj, list):
        return [_timeless(v) for v in obj]
    return obj


# ------------------------------------------------ tests/test_autoscale_e2e


class TestConditions:
    def test_update_condition_transitions(self):
        def scenario(ns):
            status = {}
            ns.ctl.update_condition(status, "Applied", False, reason="r1")
            t1 = status["conditions"][0]["lastTransitionTime"]
            ns.ctl.update_condition(status, "Applied", False, reason="r2")
            kept = status["conditions"][0]["lastTransitionTime"] == t1
            ns.ctl.update_condition(status, "Applied", True, reason="r3")
            return kept, _timeless(status)

        kept, status = both(scenario)
        assert kept  # the same boolean status keeps its transition time
        assert status["conditions"] == [
            {"type": "Applied", "status": "True", "reason": "r3",
             "message": ""}]

    def test_elasticjob_gets_conditions(self):
        def scenario(ns):
            client = FakeK8sClientWithCrdCreate()
            client.add_crd(ns.ctl.ELASTICJOB_PLURAL, make_job("job1"))
            ns.ctl.ElasticJobController(client).reconcile_once()
            status = client.crds[ns.ctl.ELASTICJOB_PLURAL]["job1"]["status"]
            return {c["type"]: c["status"] for c in status["conditions"]}

        assert both(scenario) == {"MasterCreated": "True", "Running": "True"}


class TestAutoscaleEndToEnd:
    def test_speed_to_new_world(self):
        """Sampled speed shows near-linear gain -> the optimizer grows
        the job -> a ScalePlan custom resource -> the controller creates
        the pod -> the new agent joins -> the next world holds it."""
        def scenario(ns):
            client = FakeK8sClientWithCrdCreate()
            client.add_crd(ns.ctl.ELASTICJOB_PLURAL, make_job("job1"))
            ctrl = ns.ctl.ElasticJobController(client)
            ctrl.reconcile_once()  # the master pod
            job_manager = FakeJobManager(2)
            rdzv = ns.rdzv.ElasticTrainingRendezvousManager()
            rdzv.update_rdzv_params(min_nodes=1, max_nodes=8,
                                    waiting_timeout=0.0, node_unit=1)
            for rank in range(2):
                client.create_pod({"metadata": {
                    "name": f"job1-worker-{rank}",
                    "labels": {"job": "job1", "node-type": "worker",
                               "node-id": str(rank)}}})
                rdzv.join_rendezvous(rank, 1)
            rnd0, _, world0 = rdzv.get_comm_world(0)
            optimizer = ns.ro.LocalAllreduceOptimizer(min_workers=1,
                                                      max_workers=4)
            optimizer.record_speed(1, 100.0)
            monitor = ns.speed.SpeedMonitor()
            monitor.add_running_worker("worker", 0)
            monitor.add_running_worker("worker", 1)
            t = 1_000_000.0
            monitor.collect_global_step(1000, t - 10)
            monitor.collect_global_step(2900, t)  # 190 steps/s at n=2
            scaler = ns.scaler.ElasticJobScaler("job1", k8s_client=client)
            auto = ns.auto.AllreduceAutoScaler(
                optimizer, scaler, speed_monitor=monitor,
                job_manager=job_manager, rendezvous_manager=None,
                interval=3600)
            auto._collect_speed()
            plan = optimizer.generate_plan(ns.ro.JobStage.RUNNING)
            scaler.scale(plan)
            ctrl.reconcile_once()
            plan_obj = next(iter(
                client.crds[ns.ctl.SCALEPLAN_PLURAL].values()))
            job_manager.grow(1)
            for rank in (2, 0, 1):
                rdzv.join_rendezvous(rank, 1)
            rnd1, _, world1 = rdzv.get_comm_world(0)
            return (plan.node_group_resources, _timeless(plan_obj),
                    sorted(client.pods), len(world0), len(world1),
                    rnd1 > rnd0)

        groups, plan_obj, pods, w0, w1, newer = both(scenario)
        assert groups["worker"]["count"] == 3
        assert plan_obj["status"]["phase"] == "Succeeded"
        assert {c["type"]: c["status"]
                for c in plan_obj["status"]["conditions"]} == {
                    "Applied": "True"}
        assert pods == ["job1-dlrover-master", "job1-worker-0",
                        "job1-worker-1", "job1-worker-2"]
        assert (w0, w1, newer) == (2, 3, True)

    def test_collect_speed_records_into_optimizer(self):
        def scenario(ns):
            optimizer = ns.ro.LocalAllreduceOptimizer(min_workers=1,
                                                      max_workers=4)
            monitor = ns.speed.SpeedMonitor()
            monitor.add_running_worker("worker", 0)
            t = 1_000_000.0
            monitor.collect_global_step(100, t - 10)
            monitor.collect_global_step(1100, t)
            auto = ns.auto.AllreduceAutoScaler(
                optimizer, scaler=None, speed_monitor=monitor,
                job_manager=FakeJobManager(1), interval=3600)
            auto._collect_speed()
            return dict(optimizer._samples)

        assert both(scenario) == {1: pytest.approx(100.0)}


# ------------------------------------- DistributedJobMaster (auto_scaler)


def _master(ns, monkeypatch, brain: str, **kwargs):
    monkeypatch.setenv("DLROVER_TPU_BRAIN", brain)
    return ns.master.DistributedJobMaster(
        get_free_port(), 2, scaler=ns.scaler.InMemoryScaler(), **kwargs)


class TestSeedPin:
    def test_kill_switch_restores_seed_wiring(self, monkeypatch):
        def scenario(ns):
            m = _master(ns, monkeypatch, "0", max_workers=4)
            opt = m.auto_scaler._optimizer
            return (m.brain is None,
                    type(m.auto_scaler).__name__, type(opt).__name__,
                    opt._min, opt._max)

        assert both(scenario) == (True, "AllreduceAutoScaler",
                                  "LocalAllreduceOptimizer", 2, 4)

    def test_brain_replaces_seed_loop(self, monkeypatch):
        def scenario(ns):
            m = _master(ns, monkeypatch, "1", max_workers=4)
            return (type(m.brain).__name__, m.auto_scaler,
                    m.brain.executor.can_launch)

        assert both(scenario) == ("BrainAutoScaler", None, True)

    def test_autoscale_off_drops_the_brain_too(self, monkeypatch):
        def scenario(ns):
            m = _master(ns, monkeypatch, "1", autoscale=False)
            return m.brain, m.auto_scaler

        assert both(scenario) == (None, None)

    def test_no_scaler_observes_only(self, monkeypatch):
        def scenario(ns):
            monkeypatch.setenv("DLROVER_TPU_BRAIN", "1")
            m = ns.master.DistributedJobMaster(get_free_port(), 2)
            return m.brain.executor.can_launch, m.auto_scaler

        assert both(scenario) == (False, None)


def _heartbeats(m, ids):
    for node_id in ids:
        m.job_manager.collect_node_heartbeat("worker", node_id, time.time())


def test_the_seed_loop_s_plans_match(monkeypatch):
    """Scripted heartbeats and speeds, one seed-loop cycle each: a grow
    while scaling is near linear, and back to two once the third node
    slowed the job down."""
    def scenario(ns):
        m = _master(ns, monkeypatch, "0", max_workers=4)
        _heartbeats(m, (0, 1))
        m.auto_scaler._optimizer.record_speed(1, 100.0)
        t = time.time()
        m.speed_monitor.collect_global_step(1000, t - 10)
        m.speed_monitor.collect_global_step(2900, t)  # 190/s at 2
        m.auto_scaler._cycle()
        _heartbeats(m, (2,))
        m.speed_monitor.collect_global_step(3000, t + 10)  # 10/s at 3
        m.auto_scaler._cycle()
        return [(p.node_group_resources, p.launch_nodes, p.remove_nodes,
                 p.migrate_nodes) for p in m.auto_scaler._scaler.plans]

    assert both(scenario) == [({"worker": {"count": 3}}, [], [], {}),
                              ({"worker": {"count": 2}}, [], [], {})]


@pytest.mark.parametrize("case", ["succeeded", "failed", "stop_reason",
                                  "stagnant", "tasks_done"])
def test_exit_reasons_match(monkeypatch, case):
    """The supervision loop's exit for the same scripted node states."""
    def scenario(ns):
        m = _master(ns, monkeypatch, "1")
        m.SUPERVISE_INTERVAL = 0.01
        jm = m.job_manager
        _heartbeats(m, (0, 1))
        status = ns.const.NodeStatus
        if case in ("succeeded", "failed"):
            end = status.SUCCEEDED if case == "succeeded" else status.FAILED
            for node in jm._nodes.values():
                node.update_status(end)
        elif case == "stop_reason":
            jm._stop_reason = "node 1: repeated user-code failure"
        elif case == "stagnant":
            m.speed_monitor.collect_global_step(5, time.time() - 7200)
        else:
            m.task_manager.finished = lambda: True
        code = m.run()
        return code, m._exit_reason

    want = {"succeeded": (0, "succeeded"), "failed": (1, "worker_error"),
            "stop_reason": (1, "worker_error"), "stagnant": (1, "hang_error"),
            "tasks_done": (0, "succeeded")}[case]
    assert both(scenario) == want


# --------------------------------------------------------------- main.py


class _Captured(Exception):
    pass


def _main_master(monkeypatch, argv):
    """The master ``main`` builds for ``argv``, caught at ``run``."""
    from dlrover_tpu_torch.master import main as tmain

    built = {}

    def fake_run(self):
        built["master"] = self
        raise _Captured()

    monkeypatch.setattr(tmaster.DistributedJobMaster, "run", fake_run)
    monkeypatch.setenv("DLROVER_TPU_BRAIN", "1")
    # main sets these in the process's environment: set first, so that
    # the undo removes what main leaves behind
    for name in ("DLROVER_TPU_JOB_NAME", "DLROVER_TPU_STATUS_PORT"):
        monkeypatch.setenv(name, "")
        monkeypatch.delenv(name)
    with pytest.raises(_Captured):
        tmain.main(argv)
    return built["master"]


def test_main_k8s_builds_the_distributed_master_on_a_fake_client(
        monkeypatch):
    from dlrover_tpu_torch.scheduler import kubernetes as tk8s

    client = FakeK8sClientWithCrdCreate()
    monkeypatch.setitem(sys.modules, "kubernetes",
                        types.ModuleType("kubernetes"))
    monkeypatch.setattr(tk8s.k8sClient, "_instance", client)
    m = _main_master(monkeypatch, ["--platform", "k8s", "--node_num", "2",
                                   "--job_name", "llama"])
    try:
        assert isinstance(m, tmaster.DistributedJobMaster)
        scaler = m.brain.executor._scaler
        assert isinstance(scaler, tscaler.ElasticJobScaler)
        assert scaler._client is client
        assert m.auto_scaler is None
        # the job manager's start asked for its two workers
        plan = client.crds[tctl.SCALEPLAN_PLURAL]["llama-scaleplan-0"]
        assert plan["spec"]["replicaResourceSpecs"] == {
            "worker": {"count": 2}}
        assert sorted(n.name for n in m.job_manager._nodes.values()) == [
            "llama-worker-0", "llama-worker-1"]
    finally:
        m.stop()


def test_main_k8s_without_kubernetes_raises_its_import_error(monkeypatch):
    import os

    from dlrover_tpu_torch.master import main as tmain

    monkeypatch.setitem(sys.modules, "kubernetes", None)
    before = dict(os.environ)
    with pytest.raises(ImportError):
        tmain.main(["--platform", "k8s"])
    assert dict(os.environ) == before  # raised before touching it


def test_main_ray_builds_an_observing_master(monkeypatch):
    m = _main_master(monkeypatch, ["--platform", "ray", "--node_num", "2"])
    try:
        assert isinstance(m, tmaster.DistributedJobMaster)
        assert m.job_manager._scaler is None
        assert not m.brain.executor.can_launch
        assert m.auto_scaler is None
    finally:
        m.stop()
