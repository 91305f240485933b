"""The port's Brain against the JAX package's, on the CPU.

- The reference's rule table (``tests/test_auto_scaler.py``
  ``TestDecisionRules``, ``TestCooldownHysteresis`` and the journal
  round trip) through both packages' ``ObservatoryBrainOptimizer``:
  the same decisions and the same ``export_state()`` after every cycle,
  and over seeded random signals.
- ``BrainAutoScaler`` + ``BrainExecutor`` over the port's rendezvous
  manager: a drain posted, delivered once on the node's waiting-num
  poll and completed on the fence; the deadline's master-side fence;
  a decision journaled by one master resumed under the same id by the
  next, in process and through two ``LocalJobMaster`` incarnations on
  one Brain db; a stale one abandoned.
- ``LocalAllreduceOptimizer`` plans equal the JAX ones on seeded speed
  samples; the scalers make the same calls of a fake k8s client.
- ``LocalJobMaster`` builds the Brain by default, journaled under
  ``brain``, and not under ``DLROVER_TPU_BRAIN=0`` or with the
  observatory off.
- A two-node gloo launch of the example at a tiny size, node 1 slowed:
  the Brain drains it, its agent exits 43, node 0 finishes at world 1,
  and the master's timeline holds ``scale_decision`` and
  ``scale_execute`` (``scripts/torch_brain_nccl.py``'s run, Brain on).
"""

import dataclasses
import importlib.util
import os
import time
import types
from pathlib import Path

import numpy as np
import pytest

from dlrover_tpu.common import messages as jmsg
from dlrover_tpu.master import resource_optimizer as jro
from dlrover_tpu.master import scaler as jscaler
from dlrover_tpu_torch.common import messages as tmsg
from dlrover_tpu_torch.common.constants import RendezvousName
from dlrover_tpu_torch.common.env import get_free_port
from dlrover_tpu_torch.master import resource_optimizer as tro
from dlrover_tpu_torch.master import scaler as tscaler
from dlrover_tpu_torch.master.auto_scaler import BrainAutoScaler
from dlrover_tpu_torch.master.brain import BrainExecutor, NodeDirectives
from dlrover_tpu_torch.master.master import LocalJobMaster
from dlrover_tpu_torch.master.rendezvous import (
    ElasticTrainingRendezvousManager,
)
from dlrover_tpu_torch.scheduler import kubernetes as tk8s

REPO = Path(__file__).resolve().parents[1]
T0 = 1_000_000.0
PACKAGES = {"jax": jro, "torch": tro}


# ------------------------------------------------------------ rule table


def _opt(mod, **kw):
    kw.setdefault("cooldown_s", 10.0)
    kw.setdefault("sustain_cycles", 2)
    return mod.ObservatoryBrainOptimizer(**kw)


def _sig(mod, **kw):
    kw.setdefault("world", [0, 1, 2])
    kw.setdefault("min_nodes", 1)
    kw.setdefault("max_nodes", 4)
    kw.setdefault("now", T0)
    kw.setdefault("median_step_time_s", 0.2)
    return mod.ObservatorySignals(**kw)


class _Trace:
    """Feeds one optimizer signals and records every decision and the
    exported state after each cycle."""

    def __init__(self, mod, **kw):
        self.mod = mod
        self.opt = _opt(mod, **kw)
        self.rows = []

    def decide(self, **kw):
        d = self.opt.decide(_sig(self.mod, **kw))
        self.rows.append((d.to_dict() if d else None,
                          self.opt.export_state()))
        return d

    def drive(self, cycles, t0=T0, dt=1.0, **kw):
        for i in range(cycles):
            if self.decide(now=t0 + i * dt, **kw) is not None:
                return

    def complete(self, now):
        self.opt.complete("done", now=now)
        self.rows.append(("complete", self.opt.export_state()))


STALL3 = {0: {"host_fetch": 0.8}, 1: {"host_fetch": 0.8},
          2: {"host_fetch": 0.8}}


def _healthy(t):
    t.drive(5)


def _straggler_sustain(t):
    t.opt = _opt(t.mod, sustain_cycles=3)
    t.drive(3, stragglers=[(2, 3.5)])


def _straggler_recovers(t):
    t.decide(stragglers=[(2, 3.0)])
    t.decide(now=T0 + 1)
    t.decide(stragglers=[(2, 3.0)], now=T0 + 2)


def _drain_with_capacity(t):
    t.drive(3, stragglers=[(1, 4.0)], can_launch=True)


def _drain_at_min_nodes(t):
    t.drive(5, world=[0, 1], min_nodes=2, stragglers=[(1, 4.0)])


def _hang(t):
    t.drive(3, hangs=[(1, 120.0)], median_step_time_s=0.0)


def _fenced(t):
    t.drive(5, stragglers=[(2, 3.0)], fenced=[2])


def _chronic_stall(t):
    t.drive(3, stall_shares={0: {"host_fetch": 0.5},
                             1: {"host_fetch": 0.7}, 2: {"h2d": 0.1}})


def _one_stalled(t):
    t.drive(5, stall_shares={1: {"host_fetch": 0.9}})


def _shrink_at_min(t):
    t.drive(5, world=[0], stall_shares={0: {"host_fetch": 0.9}})


def _grow(t):
    t.drive(5, max_nodes=3, can_launch=True)
    t.drive(4, can_launch=True, t0=T0 + 100)


def _grow_sublinear(t):
    for i in range(3):
        t.decide(world=[0, 1], can_launch=False, now=T0 + i)
    t.drive(5, median_step_time_s=0.28, can_launch=True, t0=T0 + 10)


def _grow_no_samples(t):
    t.drive(5, can_launch=True, median_step_time_s=0.0)


def _in_flight_blocks(t):
    t.drive(4, stall_shares=STALL3)
    t.drive(5, stragglers=[(0, 9.0)], t0=T0 + 100)


def _cooldown(t):
    t.drive(4, stall_shares=STALL3)
    t.complete(T0 + 5)
    t.drive(3, world=[0, 1], stragglers=[(1, 4.0)], t0=T0 + 8, dt=0.1)
    t.drive(3, world=[0, 1], stragglers=[(1, 4.0)], t0=T0 + 16)


def _hysteresis(t):
    t.drive(4, stall_shares=STALL3)
    t.complete(T0 + 5)
    t.drive(3, world=[0, 1], can_launch=True, t0=T0 + 16)
    t.drive(2, world=[0, 1], can_launch=True, t0=T0 + 26)


def _journal_round_trip(t):
    t.drive(3, stragglers=[(2, 3.0)])
    clone = _opt(t.mod)
    clone.restore_state(t.opt.export_state())
    t.rows.append(("clone", clone.export_state()))
    t.opt = clone
    t.complete(T0 + 4)
    t.drive(3, stragglers=[(1, 3.0)], t0=T0 + 20)


def _restored_cooldown(t):
    t.drive(4, stall_shares=STALL3)
    t.complete(T0 + 5)
    reborn = _opt(t.mod)
    reborn.restore_state(t.opt.export_state())
    t.opt = reborn
    t.drive(4, world=[0, 1], can_launch=True, dt=0.5, t0=T0 + 7)
    t.drive(3, world=[0, 1], can_launch=True, t0=T0 + 40)


def _seeded(t):
    """Random signals over 60 cycles, completions at random times."""
    rng = np.random.default_rng(7)
    now = T0
    for _ in range(60):
        now += float(rng.uniform(0.5, 6.0))
        world = sorted(rng.choice(5, size=int(rng.integers(1, 5)),
                                  replace=False).tolist())
        kw = dict(world=world, max_nodes=5,
                  can_launch=bool(rng.integers(0, 2)),
                  median_step_time_s=float(rng.choice([0.0, 0.2, 0.3])),
                  goodput=float(rng.uniform()), now=now)
        if rng.uniform() < 0.4:
            kw["stragglers"] = [(int(rng.choice(world)),
                                 round(float(rng.uniform(1.5, 5)), 2))]
        if rng.uniform() < 0.2:
            kw["hangs"] = [(int(rng.choice(world)),
                            round(float(rng.uniform(60, 300)), 1))]
        if rng.uniform() < 0.4:
            kw["stall_shares"] = {
                n: {"host_fetch": round(float(rng.uniform()), 3)}
                for n in world}
        if rng.uniform() < 0.2:
            kw["fenced"] = [int(rng.choice(world))]
        t.decide(**kw)
        if t.opt.in_flight is not None and rng.uniform() < 0.5:
            t.complete(now + 1.0)


SCENARIOS = {f.__name__.lstrip("_"): f for f in (
    _healthy, _straggler_sustain, _straggler_recovers,
    _drain_with_capacity, _drain_at_min_nodes, _hang, _fenced,
    _chronic_stall, _one_stalled, _shrink_at_min, _grow, _grow_sublinear,
    _grow_no_samples, _in_flight_blocks, _cooldown, _hysteresis,
    _journal_round_trip, _restored_cooldown, _seeded)}


@pytest.mark.parametrize("name", sorted(SCENARIOS))
def test_rule_table_decides_and_exports_as_jax(name):
    traces = {}
    for pkg, mod in PACKAGES.items():
        t = _Trace(mod)
        SCENARIOS[name](t)
        traces[pkg] = t.rows
    assert traces["torch"] == traces["jax"]
    assert traces["torch"]
    if name in ("straggler_sustain", "hang", "chronic_stall", "grow",
                "seeded"):
        assert any(isinstance(d, dict) for d, _ in traces["torch"])


def test_empty_signals_and_vocabulary_equal_jax():
    assert _opt(tro).decide(tro.ObservatorySignals(now=T0)) is None
    for name in ("ACTION_GROW", "ACTION_SHRINK", "ACTION_DRAIN_REPLACE",
                 "OUTCOME_DONE", "OUTCOME_FENCED_FALLBACK",
                 "OUTCOME_ABANDONED"):
        assert getattr(tro, name) == getattr(jro, name)
    d = tro.BrainDecision.from_dict({"decision_id": 3, "junk": 1})
    assert d.decision_id == 3 and d.direction == "none"


# ---------------------------------------------------- executor and loop


def completed_world(ranks, max_nodes=4):
    manager = ElasticTrainingRendezvousManager()
    manager.update_rdzv_params(1, max_nodes, 0.0, 1)
    for r in ranks:
        manager.join_rendezvous(r, 1)
    _rnd, _g, world = manager.get_comm_world(ranks[0])
    assert set(world) == set(ranks)
    return manager


class FakeHealth:
    def __init__(self, stragglers=()):
        self.straggler_list = list(stragglers)

    def stragglers(self):
        return list(self.straggler_list)

    def hang_suspects(self):
        return []

    def stall_shares(self):
        return {}

    def median_step_time(self):
        return 0.2


def make_brain(manager, health=None, interval=3600.0, scaler=None,
               job_manager=None):
    executor = BrainExecutor(rdzv_manager=manager,
                             directives=NodeDirectives(),
                             job_manager=job_manager, scaler=scaler)
    return BrainAutoScaler(
        tro.ObservatoryBrainOptimizer(cooldown_s=10.0, sustain_cycles=2),
        executor, health_engine=health or FakeHealth(), interval=interval)


def test_drain_is_posted_delivered_once_and_done_on_the_fence():
    from dlrover_tpu_torch.master.servicer import MasterServicer

    manager = completed_world([0, 1, 2])
    brain = make_brain(manager, FakeHealth([(2, 4.0)]))
    journal = []
    brain.set_journal(lambda op, args: journal.append((op, args)))
    for i in range(3):
        brain.run_cycle(now=T0 + i)
    d = brain.optimizer.in_flight
    assert d.action == tro.ACTION_DRAIN_REPLACE and d.node == 2
    assert (d.from_world, d.to_world) == (3, 2)  # no launch capacity
    assert journal and journal[-1][0] == "state"
    assert brain.status()["pending_directives"] == [2]
    servicer = MasterServicer(
        rdzv_managers={RendezvousName.ELASTIC_TRAINING: manager},
        brain=brain)
    req = tmsg.WaitingNodeNumRequest()
    assert servicer._get_waiting_num(req, node_id=0).action == ""
    res = servicer._get_waiting_num(req, node_id=2)
    assert (res.action, res.action_id) == ("drain", 1)
    assert res.action_reason.startswith("straggler:")
    assert servicer._get_waiting_num(req, node_id=2).action == ""
    manager.fence_node(2, ttl_s=60.0)
    brain.run_cycle(now=T0 + 3)
    assert brain.optimizer.in_flight is None
    assert brain.status()["last_decision"]["decision_id"] == 1


def test_deadline_fences_master_side():
    manager = completed_world([0, 1, 2])
    brain = make_brain(manager, FakeHealth([(2, 4.0)]), interval=1.0)
    for i in range(3):
        brain.run_cycle(now=T0 + i)
    d = brain.optimizer.in_flight
    brain.run_cycle(now=d.made_at + 10_000.0)
    assert brain.optimizer.in_flight is None
    assert 2 in manager.fenced_ranks()
    assert brain.directives.peek(2) is None


def test_a_failover_resumes_the_decision_under_its_id():
    manager = completed_world([0, 1, 2])
    health = FakeHealth([(2, 4.0)])
    a = make_brain(manager, health)
    records = []
    a.set_journal(lambda op, args: records.append((op, args)))
    for i in range(3):
        a.run_cycle(now=T0 + i)
    in_flight = a.optimizer.in_flight
    b = make_brain(manager, health)
    for op, args in records:
        b.restore_state(args)
    assert b.directives.peek(2) is None  # the directive died with a
    b.run_cycle(now=T0 + 4)
    assert b.directives.peek(2)[2] == in_flight.decision_id
    manager.fence_node(2, ttl_s=60.0)
    b.run_cycle(now=T0 + 5)
    assert b.optimizer.in_flight is None


def test_a_stale_inherited_decision_is_fenced_not_acted_on():
    manager = completed_world([0, 1, 2])
    a = make_brain(manager)
    a.optimizer._in_flight = tro.BrainDecision(
        decision_id=7, action=tro.ACTION_DRAIN_REPLACE,
        reason="straggler:9.0x", node=1, from_world=3, to_world=2,
        made_at=T0)
    b = make_brain(manager)
    b.restore_state(a.export_state())
    b.run_cycle(now=T0 + 100_000.0)
    assert b.optimizer.last_decision.decision_id == 7
    assert 1 in manager.fenced_ranks()


class _NamedJobManager:
    def __init__(self):
        self.nodes = {}
        self.released = []

    def get_running_nodes(self):
        return [types.SimpleNamespace(rank_index=i, id=i,
                                      name=f"job-worker-{i}")
                for i in range(3)]

    def release_node(self, node_id):
        self.released.append(node_id)


def test_pod_leg_waits_for_the_drain_and_grow_reaches_the_scaler():
    manager = completed_world([0, 1, 2])
    scaler = tscaler.InMemoryScaler()
    brain = make_brain(manager, FakeHealth([(2, 4.0)]), scaler=scaler,
                       job_manager=_NamedJobManager())
    for i in range(3):
        brain.run_cycle(now=T0 + i)
    d = brain.optimizer.in_flight
    assert d.to_world == 3 and not scaler.plans  # a replace, not yet
    manager.fence_node(2, ttl_s=60.0)
    brain.run_cycle(now=T0 + 3)
    # fenced, but the survivors have not re-meshed: no replacement yet
    assert not scaler.plans and brain.optimizer.in_flight is d
    for r in (0, 1):
        manager.join_rendezvous(r, 1)
    assert list(manager.get_comm_world(0)[2]) == [0, 1]
    brain.run_cycle(now=T0 + 4)
    assert [list(p.migrate_nodes) for p in scaler.plans] == [
        ["job-worker-2"]]
    assert brain.optimizer.in_flight is None
    brain.executor.check(d)
    assert len(scaler.plans) == 1  # idempotent
    assert brain.executor._job_manager.released == [2]
    grow = make_brain(completed_world([0, 1], max_nodes=3))
    grow_scaler = tscaler.InMemoryScaler()
    grow.set_scaler(grow_scaler)
    for i in range(4):
        grow.run_cycle(now=T0 + i)
    assert grow.optimizer.in_flight.action == tro.ACTION_GROW
    assert grow_scaler.plans[-1].node_group_resources["worker"] == {
        "count": 3}


@pytest.mark.parametrize("crash", ["before_the_re_mesh",
                                   "after_the_pod_leg"])
def test_a_failover_between_the_fence_and_the_re_mesh_keeps_the_replacement(
        crash):
    """The replacing drain's pod-side leg waits for the survivors'
    re-mesh.  A master that fails over inside that window runs the leg
    once the world reflects the drain; one that fails over after the
    leg ran (its record journaled, the decision not yet closed) does not
    run it again."""
    manager = completed_world([0, 1, 2])
    health = FakeHealth([(2, 4.0)])
    scaler = tscaler.InMemoryScaler()
    a = make_brain(manager, health, scaler=scaler,
                   job_manager=_NamedJobManager())
    records = []
    a.set_journal(lambda op, args: records.append(args))
    for i in range(3):
        a.run_cycle(now=T0 + i)
    d = a.optimizer.in_flight
    decided = d.to_dict()
    manager.fence_node(2, ttl_s=60.0)
    a.run_cycle(now=T0 + 3)
    assert a.optimizer.in_flight is d and not scaler.plans
    if crash == "after_the_pod_leg":
        for r in (0, 1):
            manager.join_rendezvous(r, 1)
        manager.get_comm_world(0)
        a.run_cycle(now=T0 + 4)
        assert len(scaler.plans) == 1
        # the master dies before its record of the closed decision
        assert records[-1]["in_flight"] is None
        assert records[-2]["followed_up"] == [d.decision_id]
        records = records[:-1]
    b_scaler = tscaler.InMemoryScaler()
    b = make_brain(manager, health, scaler=b_scaler,
                   job_manager=_NamedJobManager())
    for args in records:
        b.restore_state(args)
    assert b.optimizer.in_flight.to_dict() == decided
    if crash == "before_the_re_mesh":
        b.run_cycle(now=T0 + 4)
        assert b.optimizer.in_flight is not None and not b_scaler.plans
        for r in (0, 1):
            manager.join_rendezvous(r, 1)
        manager.get_comm_world(0)
    b.run_cycle(now=T0 + 5)
    assert b.optimizer.in_flight is None
    want = [["job-worker-2"]] if crash == "before_the_re_mesh" else []
    assert [list(p.migrate_nodes) for p in b_scaler.plans] == want
    assert b.export_state()["followed_up"] == [d.decision_id]


def test_the_loop_thread_starts_and_stops():
    brain = make_brain(completed_world([0, 1]))
    brain._interval = 0.01
    brain.start()
    thread = brain._thread
    assert thread.is_alive()
    brain.stop()
    assert not thread.is_alive()


# ------------------------------------------- the seed optimizer and scalers


@pytest.mark.parametrize("seed", [0, 1, 2, 3])
def test_allreduce_optimizer_plans_equal_jax(seed):
    plans = {}
    for pkg, mod in PACKAGES.items():
        rng = np.random.default_rng(seed)
        opt = mod.LocalAllreduceOptimizer(min_workers=1, max_workers=8,
                                          datastore=_NoHistory())
        out = [dataclasses.asdict(mod.JobMeta())]
        out.append(_plan(opt.generate_plan(mod.JobStage.CREATE)))
        for _ in range(12):
            n = int(rng.integers(1, 9))
            opt.record_speed(n, float(n * rng.uniform(50, 100)
                                      / (1 + 0.1 * n)))
            if rng.uniform() < 0.3:
                opt.report_stragglers([f"w-{int(rng.integers(0, n))}"])
            if rng.uniform() < 0.2:
                opt.report_oom(f"w-{int(rng.integers(0, n))}",
                               int(rng.integers(1, 9)) * 1024)
            if rng.uniform() < 0.3:
                opt.set_current_workers(int(rng.integers(1, 9)))
            out.append(_plan(opt.generate_plan(mod.JobStage.RUNNING)))
        out.append(_plan(opt.oom_recovery_plan("w-0", 2048)))
        plans[pkg] = out
    assert plans["torch"] == plans["jax"]
    assert any(p is not None for p in plans["torch"][1:])


class _NoHistory:
    """A datastore with no speed history that keeps nothing."""

    def speed_history(self, job):
        return {}

    def record_speed(self, job, n, speed):
        pass


def _plan(plan):
    return None if plan is None else dataclasses.asdict(plan)


class FakeK8s:
    """Records every call; lists pods from what it created."""

    def __init__(self, fail_creates=0):
        self.calls = []
        self.pods = {}
        self._fail = fail_creates

    def list_pods(self, selector):
        self.calls.append(("list", selector))
        items = [types.SimpleNamespace(metadata=types.SimpleNamespace(
            name=name, labels=m["metadata"]["labels"]))
            for name, m in sorted(self.pods.items())]
        return types.SimpleNamespace(items=items)

    def create_pod(self, manifest):
        if self._fail > 0:
            self._fail -= 1
            raise RuntimeError("apiserver busy")
        self.calls.append(("create", manifest))
        self.pods[manifest["metadata"]["name"]] = manifest

    def delete_pod(self, name):
        self.calls.append(("delete", name))
        self.pods.pop(name, None)

    def create_custom_resource(self, **kw):
        self.calls.append(("crd", kw))


def _scale_all(scaler, msgmod):
    plans = []
    p = msgmod.ScalePlan()
    p.node_group_resources["worker"] = {"count": 3}
    plans.append(p)
    p = msgmod.ScalePlan()
    p.node_group_resources["worker"] = {"count": 2}
    plans.append(p)
    p = msgmod.ScalePlan()
    p.launch_nodes.append({"type": "worker", "memory": 4096})
    p.migrate_nodes["job-worker-0"] = {"type": "worker"}
    p.remove_nodes.append("job-worker-1")
    plans.append(p)
    for plan in plans:
        scaler.scale(plan)


@pytest.mark.parametrize("kind", ["pod", "elasticjob", "in_memory"])
def test_scalers_make_the_calls_jax_makes(kind):
    out = {}
    for pkg, mod, msgmod in (("jax", jscaler, jmsg),
                             ("torch", tscaler, tmsg)):
        client = FakeK8s()
        if kind == "pod":
            cls = mod.GpuPodScaler if pkg == "torch" else mod.TpuPodScaler
            s = cls("job", k8s_client=client,
                    pod_template={"containers": [{"name": "trainer",
                                                  "image": "img"}]})
        elif kind == "elasticjob":
            s = mod.ElasticJobScaler("job", k8s_client=client)
        else:
            s = mod.InMemoryScaler("job")
        _scale_all(s, msgmod)
        out[pkg] = (client.calls if kind != "in_memory" else sorted(
            (n, node.type) for n, node in s.alive.items()))
    assert out["torch"] == out["jax"] and out["torch"]


def test_pod_scaler_retries_a_failed_create():
    client = FakeK8s(fail_creates=1)
    s = tscaler.GpuPodScaler("job", k8s_client=client, retry_interval=0.01)
    p = tmsg.ScalePlan()
    p.node_group_resources["worker"] = {"count": 1}
    s.scale(p)
    deadline = time.time() + 5
    while not client.pods and time.time() < deadline:
        time.sleep(0.01)
    assert list(client.pods) == ["job-worker-0"]


def test_k8s_client_needs_the_kubernetes_package():
    try:
        import kubernetes  # noqa: F401
    except ImportError:
        with pytest.raises(RuntimeError, match="kubernetes package"):
            tk8s.k8sClient("default")
    args = tk8s.new_job_args("local", "job")
    assert args.node_groups["worker"].count == 1


# ------------------------------------------------------------- the master


@pytest.fixture
def fresh_datastore(monkeypatch):
    """No process datastore before the case, and none left after it."""
    from dlrover_tpu_torch.master import datastore

    monkeypatch.setattr(datastore, "_default_store", None)
    yield
    if datastore._default_store is not None:
        datastore._default_store.close()
    datastore._default_store = None


@pytest.mark.parametrize("switch,built", [
    (None, True), (("DLROVER_TPU_BRAIN", "0"), False),
    (("DLROVER_TPU_OBSERVATORY", "0"), False)])
def test_the_master_builds_the_brain_by_default(monkeypatch, switch, built):
    """``DLROVER_TPU_BRAIN=1`` raised until the Brain was ported; the
    master now builds it by default, as the reference's does."""
    for name in ("DLROVER_TPU_BRAIN", "DLROVER_TPU_OBSERVATORY",
                 "DLROVER_TPU_BRAIN_DB"):
        monkeypatch.delenv(name, raising=False)
    if switch:
        monkeypatch.setenv(*switch)
    m = LocalJobMaster(get_free_port())
    assert isinstance(m.brain, BrainAutoScaler) == built
    if built:
        assert m.brain.executor.current_world() == []
        assert not m.brain.executor.can_launch


def test_a_failed_over_master_resumes_the_brains_decision(
        monkeypatch, tmp_path, fresh_datastore):
    monkeypatch.setenv("DLROVER_TPU_BRAIN_DB", str(tmp_path / "brain.db"))
    monkeypatch.setenv("DLROVER_TPU_JOB_NAME", "brain-failover")
    monkeypatch.delenv("DLROVER_TPU_BRAIN", raising=False)
    from dlrover_tpu_torch.master import datastore
    from dlrover_tpu_torch.master.failover import BRAIN

    a = LocalJobMaster(get_free_port(), node_num=3)
    a.prepare()
    try:
        assert a.control_journal._brain is a.brain
        manager = a.rdzv_managers[RendezvousName.ELASTIC_TRAINING]
        manager.update_rdzv_params(1, 4, 0.0, 1)
        for r in (0, 1, 2):
            manager.join_rendezvous(r, 1)
        manager.get_comm_world(0)
        a.brain.stop()  # cycles driven here, not by the thread
        a.brain._health = FakeHealth([(2, 4.0)])
        for i in range(3):
            a.brain.run_cycle(now=T0 + i)
        decision = a.brain.optimizer.in_flight
        assert decision is not None
        rows = datastore._default_store.journal_entries("brain-failover")
        assert any(component == BRAIN for _, component, _, _ in rows)
    finally:
        a.stop()  # a bare stop: the next incarnation resumes
    b = LocalJobMaster(get_free_port(), node_num=3)
    b.prepare()
    try:
        b.brain.stop()
        assert b.incarnation == 2
        got = b.brain.optimizer.in_flight
        assert got.to_dict() == decision.to_dict()
        assert b.brain.directives.peek(2) is None
        b.brain._health = FakeHealth()
        b.brain.run_cycle(now=T0 + 4)
        assert b.brain.directives.peek(2)[2] == decision.decision_id
    finally:
        b.stop()


# ------------------------------------------------ two nodes, node 1 slowed


def _brain_script():
    spec = importlib.util.spec_from_file_location(
        "torch_brain_nccl", REPO / "scripts" / "torch_brain_nccl.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def test_two_gloo_nodes_the_brain_drains_the_slow_one(tmp_path):
    script = _brain_script()
    args = types.SimpleNamespace(device="cpu", steps=14, step_sleep=0.4,
                                 slow_from=6, slow_factor=10.0,
                                 timeout=300.0, slow_rank=1)
    logs = tmp_path / "logs"
    logs.mkdir()
    r = script.run_job(tmp_path / "runs", logs, "brain_on", True,
                       script.CPU_MODEL, args)
    names = [e["name"] for e in r["master_events"]]
    decisions = [e["labels"] for e in r["master_events"]
                 if e["name"] == "scale_decision"]
    assert len(decisions) == 1, names
    d = decisions[0]
    assert (d["action"], d["target_node"]) == ("drain_replace", 1)
    assert d["reason"].startswith("straggler:")
    assert (d["from_world"], d["to_world"]) == (2, 1)
    assert [e["labels"]["outcome"] for e in r["master_events"]
            if e["name"] == "scale_execute"] == ["done"]
    assert r["exits"][1][0] == 43 and r["exits"][0][0] == 0
    rep = r["reports"]
    n0 = [v for (rank, inc), v in rep.items() if rank == 0 and inc > 0]
    assert len(n0) == 1 and n0[0]["world"] == 1
    assert n0[0]["history"][-1]["step"] == 14


def test_two_gloo_nodes_the_brain_drains_node_0_the_survivor_commits(
        tmp_path):
    """Node 0, the committer, slowed: the Brain drains it, and node 1
    re-meshes as the index 0 of a world of 1.  Its worker's checkpoint
    engine and its agent's saver take that index, not the node rank 1,
    so the worker starts (process rank 0 of node 1 would be outside the
    node's shard range), finishes and commits its final step."""
    from dlrover_tpu_torch.agent.ckpt_saver import find_latest_checkpoint
    from dlrover_tpu_torch.common.constants import CheckpointConstant

    script = _brain_script()
    args = types.SimpleNamespace(device="cpu", steps=14, step_sleep=0.4,
                                 slow_from=6, slow_factor=10.0,
                                 timeout=300.0, slow_rank=0)
    logs = tmp_path / "logs"
    logs.mkdir()
    r = script.run_job(tmp_path / "runs", logs, "brain_on", True,
                       script.CPU_MODEL, args)
    names = [e["name"] for e in r["master_events"]]
    decisions = [e["labels"] for e in r["master_events"]
                 if e["name"] == "scale_decision"]
    assert len(decisions) == 1, names
    d = decisions[0]
    assert (d["action"], d["target_node"]) == ("drain_replace", 0)
    assert d["reason"].startswith("straggler:")
    assert (d["from_world"], d["to_world"]) == (2, 1)
    assert [e["labels"]["outcome"] for e in r["master_events"]
            if e["name"] == "scale_execute"] == ["done"]
    assert r["exits"][0][0] == 43 and r["exits"][1][0] == 0
    later = [v for (rank, inc), v in r["reports"].items() if inc > 0]
    assert len(later) == 1 and later[0]["world"] == 1
    assert later[0]["rank"] == 0
    assert later[0]["history"][-1]["step"] == 14
    latest = find_latest_checkpoint(str(r["dir"] / "ckpt"))
    assert latest is not None and os.path.basename(latest) == (
        f"{CheckpointConstant.CKPT_DIR_PREFIX}14")
    # C10: node 1 resumes from its own newest snapshot of the world of 2,
    # carried to its new rank (not from the last commit, step 0): its
    # first step at world 1 follows the newest step it snapshotted there
    first = r["reports"][(1, 0)]
    snapped = max(int(k) for k in first["snapshot_digests"])
    restored = later[0]["restored"]
    assert restored["step"] >= snapped >= args.slow_from
    assert later[0]["history"][0]["step"] == restored["step"] + 1
    assert later[0]["io_log"][0][:2] == ["restore_shm", restored["step"]]
    both = {int(k): v for k, v in first["snapshot_digests"].items()}
    if restored["step"] in both:
        assert restored["digest"] == both[restored["step"]]


def test_a_new_worlds_worker_updates_the_agents_saver(monkeypatch,
                                                      tmp_path):
    """After a drained peer left, the survivor's worker asks for a saver
    of one shard; the agent's saver built for two must take the new
    count, or its commits wait for the node that left (C8)."""
    import shutil
    import tempfile
    import uuid

    from dlrover_tpu_torch.agent.ckpt_saver import (
        FACTORY_QUEUE,
        AsyncCheckpointSaver,
        SaverConfig,
    )
    from dlrover_tpu_torch.common import multi_process
    from dlrover_tpu_torch.common.multi_process import SharedQueue

    sock = tempfile.mkdtemp(prefix="dtb", dir="/tmp")
    monkeypatch.setenv(multi_process.SOCKET_DIR_ENV, sock)
    factory = AsyncCheckpointSaver.start_async_saving_ckpt(
        install_signal_handlers=False)
    name = f"c8{uuid.uuid4().hex[:8]}"
    try:
        queue = SharedQueue(FACTORY_QUEUE, create=False)
        for world in (2, 1):
            queue.put(SaverConfig(checkpoint_dir=str(tmp_path),
                                  global_shard_num=world, name=name))
            deadline = time.time() + 10
            while time.time() < deadline:
                saver = AsyncCheckpointSaver.get_ckpt_saver()
                if saver is not None and (
                        saver.config.global_shard_num == world):
                    break
                time.sleep(0.05)
            assert saver.config.global_shard_num == world
        queue.close()
    finally:
        AsyncCheckpointSaver.reset(unlink=True)
        factory.close()
        shutil.rmtree(sock, ignore_errors=True)


def test_the_savers_rebuild_carries_the_snapshot_before_it_unlinks(
        monkeypatch, tmp_path):
    """C10: the node's index moved from 1 to 0.  The rebuilt saver
    serves the old rank's newest snapshot under rank 0, and the old
    saver is closed (its names unlinked) only after the segment moved."""
    import shutil
    import tempfile
    import uuid

    import torch

    from dlrover_tpu_torch.agent.ckpt_saver import (
        FACTORY_QUEUE,
        AsyncCheckpointSaver,
        SaverConfig,
    )
    from dlrover_tpu_torch.agent.ckpt_shm import (
        SharedMemoryHandler,
        segment_paths,
    )
    from dlrover_tpu_torch.common import multi_process
    from dlrover_tpu_torch.common.multi_process import SharedQueue

    sock = tempfile.mkdtemp(prefix="dtb", dir="/tmp")
    monkeypatch.setenv(multi_process.SOCKET_DIR_ENV, sock)
    name = f"c10{uuid.uuid4().hex[:8]}"
    seen = []
    close = AsyncCheckpointSaver.close

    def recording_close(self, unlink=False):
        seen.append((self.config.node_rank,
                     os.path.exists(segment_paths(1, name)[0]),
                     os.path.exists(segment_paths(0, name)[0])))
        return close(self, unlink=unlink)

    monkeypatch.setattr(AsyncCheckpointSaver, "close", recording_close)
    factory = AsyncCheckpointSaver.start_async_saving_ckpt(
        install_signal_handlers=False)

    def wait_for(node_rank):
        deadline = time.time() + 10
        while time.time() < deadline:
            saver = AsyncCheckpointSaver.get_ckpt_saver()
            if saver is not None and saver.config.node_rank == node_rank:
                return saver
            time.sleep(0.05)
        raise AssertionError(f"no saver of node rank {node_rank}")

    w = torch.arange(4096, dtype=torch.float32)
    try:
        queue = SharedQueue(FACTORY_QUEUE, create=False)
        queue.put(SaverConfig(checkpoint_dir=str(tmp_path), node_rank=1,
                              global_shard_num=2, name=name))
        wait_for(1)
        writer = SharedMemoryHandler(1, name=name)
        for step in (4, 5):
            writer.save_state(step, {"w": w + step})
        writer.close()
        queue.put(SaverConfig(checkpoint_dir=str(tmp_path), node_rank=0,
                              global_shard_num=1, name=name))
        saver = wait_for(0)
        assert seen == [(1, False, True)]
        assert saver.max_common_step() == 5
        reader = SharedMemoryHandler(0, name=name)
        assert sorted(reader.steps_available()) == [4, 5]
        step, leaves = reader.load_state(copy=True)
        assert step == 5 and len(leaves) == 1
        assert torch.equal(next(iter(leaves.values())), w + 5)
        reader.close()
        assert not os.path.exists(segment_paths(1, name)[0])
        queue.close()
    finally:
        AsyncCheckpointSaver.reset(unlink=True)
        factory.close()
        shutil.rmtree(sock, ignore_errors=True)
    assert not any(os.path.exists(p)
                   for r in (0, 1) for p in segment_paths(r, name))


def test_two_nodes_a_straggler_stands_out_where_the_reference_hides_it():
    """Of two nodes the reference's upper median is the slow node's own
    EWMA; the port's is the faster node's, and brands the slow one
    (ROADMAP §C)."""
    from dlrover_tpu.observability import health as jhealth
    from dlrover_tpu_torch.observability import health as thealth

    got = {}
    for name, mod in (("jax", jhealth), ("torch", thealth)):
        engine = mod.HealthEngine(job="two", straggler_ratio=2.0)
        for step in range(1, 6):
            for node, dur in ((0, 0.5), (1, 2.5)):
                engine.observe_events(node, [{
                    "name": "step", "ph": "X", "dur": dur,
                    "wall": 1000.0 + step * 3, "node": node,
                    "rank": node, "inc": 0, "pid": 10 + node,
                    "labels": {"step": step}}])
        got[name] = (engine.median_step_time(), engine.stragglers())
    assert got["jax"][1] == []
    assert got["torch"][1] == [(1, 5.0)]
    assert got["torch"][0] == 0.5 and got["jax"][0] == 2.5


def test_a_flush_in_a_world_of_one_commits_what_a_world_of_two_could_not(
        monkeypatch, tmp_path):
    """The survivor of a drain flushes its newest snapshot at each
    restart.  Counted over the world of 2 it waits for the drained
    node's done file of that step, which never comes (that node flushed
    an older step); once the world of 1's worker has asked for its saver
    (C8), the flush of the next restart commits it: the step a
    replacement then restores."""
    import shutil
    import tempfile
    import uuid

    import torch

    from dlrover_tpu_torch.agent.ckpt_saver import (
        FACTORY_QUEUE,
        AsyncCheckpointSaver,
        SaverConfig,
        find_latest_checkpoint,
    )
    from dlrover_tpu_torch.agent.ckpt_shm import SharedMemoryHandler
    from dlrover_tpu_torch.common import multi_process
    from dlrover_tpu_torch.common.multi_process import SharedQueue

    sock = tempfile.mkdtemp(prefix="dtb", dir="/tmp")
    monkeypatch.setenv(multi_process.SOCKET_DIR_ENV, sock)
    monkeypatch.setenv("DLROVER_TPU_EMERGENCY_COMMIT_TIMEOUT_S", "0.5")
    name = f"w1{uuid.uuid4().hex[:8]}"
    factory = AsyncCheckpointSaver.start_async_saving_ckpt(
        install_signal_handlers=False)
    try:
        queue = SharedQueue(FACTORY_QUEUE, create=False)
        queue.put(SaverConfig(checkpoint_dir=str(tmp_path), node_rank=0,
                              global_shard_num=2, name=name))
        deadline = time.time() + 10
        while AsyncCheckpointSaver.get_ckpt_saver() is None:
            assert time.time() < deadline
            time.sleep(0.05)
        saver = AsyncCheckpointSaver.get_ckpt_saver()
        writer = SharedMemoryHandler(0, name=name)
        writer.save_state(6, {"w": torch.zeros(64)})
        writer.close()
        # the restart into the world of 1: node 1 flushed step 5, not 6
        assert saver.save_shm_to_storage("membership change") is False
        assert find_latest_checkpoint(str(tmp_path)) is None
        # the world of 1's worker asks for its saver
        queue.put(SaverConfig(checkpoint_dir=str(tmp_path), node_rank=0,
                              global_shard_num=1, name=name))
        deadline = time.time() + 10
        while saver.config.global_shard_num != 1:
            assert time.time() < deadline
            time.sleep(0.05)
        assert AsyncCheckpointSaver.get_ckpt_saver() is saver
        assert saver.save_shm_to_storage("membership change") is True
        assert os.path.basename(find_latest_checkpoint(str(tmp_path))) == (
            "checkpoint-6")
        queue.close()
    finally:
        AsyncCheckpointSaver.reset(unlink=True)
        factory.close()
        shutil.rmtree(sock, ignore_errors=True)
