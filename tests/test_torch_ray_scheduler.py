"""The port's ray platform against the JAX package's, through
``FakeRayClient`` (``ray`` is installed on neither machine).

Mirrors ``tests/test_ray_scheduler.py`` case for case: every scenario
runs on the port's ``scheduler/ray.py`` and on ``dlrover_tpu/scheduler/
ray.py``, and the actor tables, the created and removed names, the
watcher's nodes and its events must be equal, and what the reference's
test expects.
"""

import threading
import time

import pytest

from dlrover_tpu.common import messages as jmsg
from dlrover_tpu.scheduler import ray as jray
from dlrover_tpu_torch.common import messages as tmsg
from dlrover_tpu_torch.common.constants import NodeEventType, NodeStatus
from dlrover_tpu_torch.scheduler import ray as tray

PKGS = {"torch": (tray, tmsg), "jax": (jray, jmsg)}


def both(scenario):
    """``scenario(ray_module, messages_module)`` on both packages; the
    port's result, after checking it equals the reference's."""
    got = {k: scenario(*mods) for k, mods in PKGS.items()}
    assert got["torch"] == got["jax"]
    return got["torch"]


def _table(client):
    return ({k: dict(v) for k, v in client.actors.items()},
            list(client.created), list(client.removed))


def test_actor_state_mapping():
    states = ["ALIVE", "PENDING_CREATION", "DEAD", "RESTARTING",
              "DEPENDENCIES_UNREADY", "???"]
    got = both(lambda ray, _m: [ray.actor_state_to_status(s)
                                for s in states]
               + [ray.actor_state_to_status("DEAD", exit_ok=True)])
    assert got == [NodeStatus.RUNNING, NodeStatus.PENDING, NodeStatus.FAILED,
                   NodeStatus.PENDING, NodeStatus.PENDING,
                   NodeStatus.UNKNOWN, NodeStatus.SUCCEEDED]


class TestActorScaler:
    def test_scale_up_down_and_explicit_nodes(self):
        def scenario(ray, m):
            client = ray.FakeRayClient()
            scaler = ray.ActorScaler("job", client)
            scaler.scale(m.ScalePlan(node_group_resources={
                "worker": {"count": 3, "resource": "cpu=2,tpu_chips=4"}}))
            steps = [_table(client)]
            scaler.scale(m.ScalePlan(node_group_resources={
                "worker": {"count": 1}}))
            steps.append(_table(client))
            scaler.scale(m.ScalePlan(launch_nodes=[
                {"type": "worker", "resource": "cpu=1"}]))
            steps.append(_table(client))
            scaler.scale(m.ScalePlan(remove_nodes=["job-worker-1"]))
            steps.append(_table(client))
            return steps

        steps = both(scenario)
        assert sorted(steps[0][1]) == ["job-worker-0", "job-worker-1",
                                       "job-worker-2"]
        live = {n for n, i in steps[1][0].items() if i["state"] != "DEAD"}
        assert live == {"job-worker-0"} and "job-worker-2" in steps[1][2]
        assert steps[2][0]["job-worker-1"]["state"] == "PENDING_CREATION"
        assert steps[3][0]["job-worker-1"]["state"] == "DEAD"

    def test_migrate_node(self):
        def scenario(ray, m):
            client = ray.FakeRayClient()
            scaler = ray.ActorScaler("job", client)
            scaler.scale(m.ScalePlan(node_group_resources={
                "worker": {"count": 2}}))
            scaler.scale(m.ScalePlan(migrate_nodes={
                "job-worker-0": {"type": "worker", "resource": "cpu=8"}}))
            return _table(client)

        actors, _, _ = both(scenario)
        assert actors["job-worker-2"]["state"] == "PENDING_CREATION"
        assert actors["job-worker-0"]["state"] == "DEAD"

    def test_dead_actor_is_replaced(self):
        def scenario(ray, m):
            client = ray.FakeRayClient()
            scaler = ray.ActorScaler("job", client)
            plan = m.ScalePlan(node_group_resources={"worker": {"count": 2}})
            scaler.scale(plan)
            client.set_state("job-worker-1", "DEAD")  # crash
            scaler.scale(plan)
            return _table(client)

        actors, created, _ = both(scenario)
        assert actors["job-worker-1"]["state"] == "PENDING_CREATION"
        assert created.count("job-worker-1") == 2

    def test_scale_up_fills_gaps(self):
        def scenario(ray, m):
            client = ray.FakeRayClient()
            scaler = ray.ActorScaler("job", client)
            client.create_actor("job-worker-1")  # id 0 is free
            scaler.scale(m.ScalePlan(node_group_resources={
                "worker": {"count": 3}}))
            return _table(client)

        actors, created, _ = both(scenario)
        assert set(actors) == {"job-worker-0", "job-worker-1",
                               "job-worker-2"}
        assert created == ["job-worker-1", "job-worker-0", "job-worker-2"]


def _nodes(nodes):
    return [(n.type, n.id, n.name, n.status) for n in nodes]


class TestActorWatcher:
    def test_list_filters_foreign_actors(self):
        def scenario(ray, _m):
            client = ray.FakeRayClient()
            client.create_actor("job-worker-0")
            client.create_actor("otherjob-worker-0")
            client.set_state("job-worker-0", "ALIVE")
            return _nodes(ray.ActorWatcher("job", client).list())

        assert both(scenario) == [
            ("worker", 0, "job-worker-0", NodeStatus.RUNNING)]

    def test_watch_emits_transitions_and_deletions(self):
        def scenario(ray, _m):
            client = ray.FakeRayClient()
            client.create_actor("job-worker-0")
            w = ray.ActorWatcher("job", client, poll_interval=0.01)
            events = []

            def handler(ev):
                events.append((ev.event_type, ev.node.name, ev.node.status))

            def settle(n):
                deadline = time.time() + 5.0
                while len(events) < n and time.time() < deadline:
                    time.sleep(0.005)

            t = threading.Thread(target=w.watch, args=(handler,),
                                 daemon=True)
            t.start()
            # PENDING -> ALIVE -> intentionally killed (DEAD) -> gc'd,
            # each change seen before the next
            settle(1)
            client.set_state("job-worker-0", "ALIVE")
            settle(2)
            client.remove_actor("job-worker-0")
            settle(3)
            client.gc_actor("job-worker-0")
            settle(4)
            w.stop()
            t.join(timeout=2.0)
            return events[:4]

        events = both(scenario)
        assert [(e[0], e[2]) for e in events] == [
            (NodeEventType.MODIFIED, NodeStatus.PENDING),
            (NodeEventType.MODIFIED, NodeStatus.RUNNING),
            # an INTENDED kill is a clean exit, NOT a failure
            (NodeEventType.MODIFIED, NodeStatus.SUCCEEDED),
            (NodeEventType.DELETED, NodeStatus.DELETED)]

    def test_crash_maps_to_failed_clean_exit_to_succeeded(self):
        def scenario(ray, _m):
            client = ray.FakeRayClient()
            client.create_actor("job-worker-0")
            client.create_actor("job-worker-1")
            client.set_state("job-worker-0", "DEAD")  # crash
            client.set_state("job-worker-1", "DEAD", exit_ok=True)
            return _nodes(ray.ActorWatcher("job", client).list())

        by_name = {n[2]: n[3] for n in both(scenario)}
        assert by_name == {"job-worker-0": NodeStatus.FAILED,
                           "job-worker-1": NodeStatus.SUCCEEDED}


def test_the_ray_client_needs_the_ray_package():
    """``ray`` is imported only when a client is built."""
    try:
        import ray  # noqa: F401
    except ImportError:
        with pytest.raises(RuntimeError, match="ray package"):
            tray.RayClient()
    assert "ray" not in vars(tray)
