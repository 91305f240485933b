"""The port's durable master against the JAX package's, on the CPU.

- The Brain datastore: each package's ``BrainDatastore`` writes its own
  db; the schemas in ``sqlite_master`` are equal, and one call sequence
  (measurements, speed, node events, timeline events, profiles, journal,
  snapshots, incarnations and epochs) dumps to equal rows in every table
  but the wall-clock columns.
- The journal and its replay: one seeded stream of about 200 mutations
  goes into the KV store, both rendezvous managers, the task manager and
  the job manager of each package, each with its package's
  ``ControlPlaneJournal`` attached.  Recovery into fresh components gives
  equal ``export_state()`` across the packages and equal to the live
  state; the port also recovers a db that the JAX journal wrote.
- The reference's scenarios (``tests/test_master_failover.py``) against
  the port's ``LocalJobMaster``: the in-process restart (a parked KV
  wait re-parks on incarnation 2; a job-terminal stop retires the state;
  a bare stop keeps it), the torn journal tail (a SIGKILL between enqueue
  and flush, with the task manager's leases left unacked and requeued),
  the control meta, the servicer's fencing and the channel's adoption of
  a new epoch.
- A CPU elastic launch of the tiny example against a master process with
  a durable db and the ``master-kill-longpoll`` plan: one master kill,
  one restart on the same port and db, and the job ends with the losses
  of the uninterrupted launch.
"""

import json
import os
import shutil
import signal
import sqlite3
import subprocess
import sys
import tempfile
import threading
import time
from pathlib import Path

import numpy as np
import pytest

os.environ.setdefault("JAX_PLATFORMS", "cpu")

from dlrover_tpu.common import messages as jmsg  # noqa: E402
from dlrover_tpu.master import datastore as jds  # noqa: E402
from dlrover_tpu.master import failover as jfo  # noqa: E402
from dlrover_tpu.master import job_manager as jjm  # noqa: E402
from dlrover_tpu.master import kv_store as jkv  # noqa: E402
from dlrover_tpu.master import rendezvous as jrdzv  # noqa: E402
from dlrover_tpu.master.shard import task_manager as jtm  # noqa: E402
from dlrover_tpu_torch.agent.master_client import MasterClient  # noqa: E402
from dlrover_tpu_torch.common import messages as tmsg  # noqa: E402
from dlrover_tpu_torch.common.comm import MasterChannel  # noqa: E402
from dlrover_tpu_torch.common.constants import (  # noqa: E402
    NodeType,
    RendezvousName,
)
from dlrover_tpu_torch.common.env import get_free_port  # noqa: E402
from dlrover_tpu_torch.common.messages import serialize_message  # noqa: E402
from dlrover_tpu_torch.master import datastore as tds  # noqa: E402
from dlrover_tpu_torch.master import failover as tfo  # noqa: E402
from dlrover_tpu_torch.master import job_manager as tjm  # noqa: E402
from dlrover_tpu_torch.master import kv_store as tkv  # noqa: E402
from dlrover_tpu_torch.master import rendezvous as trdzv  # noqa: E402
from dlrover_tpu_torch.master.master import LocalJobMaster  # noqa: E402
from dlrover_tpu_torch.master.servicer import MasterServicer  # noqa: E402
from dlrover_tpu_torch.master.shard import task_manager as ttm  # noqa: E402

REPO = Path(__file__).resolve().parents[1]
SEED = 20261018
JAX = {"ds": jds, "fo": jfo, "jm": jjm, "kv": jkv, "rdzv": jrdzv,
       "tm": jtm, "msg": jmsg}
TORCH = {"ds": tds, "fo": tfo, "jm": tjm, "kv": tkv, "rdzv": trdzv,
         "tm": ttm, "msg": tmsg}
#: the columns a datastore fills from the wall clock at write time
WALL_COLUMNS = ("created_at", "updated_at")


@pytest.fixture
def pinned_time(monkeypatch):
    """``time.time`` at a fixed instant: both packages stamp the same
    heartbeats, windows and rows."""
    monkeypatch.setattr(time, "time", lambda: 1_790_000_000.0)


# ------------------------------------------------------ the datastore


def _schema(path):
    with sqlite3.connect(path) as conn:
        return conn.execute(
            "SELECT type, name, tbl_name, sql FROM sqlite_master "
            "ORDER BY type, name").fetchall()


def _dump(path):
    """Every table's rows without the wall-clock columns, in rowid
    order."""
    out = {}
    with sqlite3.connect(path) as conn:
        tables = [r[0] for r in conn.execute(
            "SELECT name FROM sqlite_master WHERE type = 'table' "
            "ORDER BY name")]
        for table in tables:
            cols = [r[1] for r in conn.execute(
                f"PRAGMA table_info({table})")
                if r[1] not in WALL_COLUMNS]
            out[table] = conn.execute(
                f"SELECT {', '.join(cols)} FROM {table} "
                "ORDER BY rowid").fetchall()
    return out


def test_datastore_schemas_are_equal(tmp_path):
    paths = {}
    for name, mods in (("jax", JAX), ("torch", TORCH)):
        paths[name] = str(tmp_path / f"{name}.db")
        mods["ds"].BrainDatastore(paths[name]).close()
    want = _schema(paths["jax"])
    assert len([r for r in want if r[0] == "table"]) == 8
    assert _schema(paths["torch"]) == want


def _datastore_calls(store, rng):
    """One seeded call sequence through every recorder of a store."""
    for i in range(12):
        store.record_measurement(
            f"wl{i % 3}", {"data": int(rng.integers(1, 9)), "fsdp": 1},
            float(rng.random()), job=f"job{i % 2}")
    for i in range(6):
        store.record_speed("job0", i % 3 + 1, float(rng.random() * 100))
    for i in range(5):
        store.record_node_event("job0", f"worker-{i}", "process_error",
                                f"exit {int(rng.integers(1, 255))}")
    store.record_timeline_events("job0", [
        {"name": "step", "ph": "X", "wall": 100.0 + i,
         "mono": float(i), "dur": float(rng.random()), "node": i % 2,
         "rank": i % 2, "inc": 0, "pid": 7, "labels": {"step": i}}
        for i in range(8)] + [
        {"name": "fault_injected", "ph": "i", "wall": 120.0, "node": 1,
         "labels": {"kind": "kill", "target": "master"}}])
    store.record_profile("job0", 1, kind="capture", reason="hang",
                         summary={"top": ["matmul"]}, artifact="a.json")
    epoch_inc = [store.bump_incarnation("job0"),
                 store.bump_incarnation("job0")]
    seqs = [store.journal_append("job0", "kv", "set",
                                 {"key": f"k{i}", "value": "dg=="})
            for i in range(5)]
    store.save_control_snapshot("job0", {"components": {"kv": {}}},
                                seqs[2])
    seqs.append(store.journal_append("job1", "tasks", "done",
                                     {"name": "ds", "step": 3}))
    epoch_inc.append(store.bump_job_epoch("job1"))
    epoch_inc.append(store.bump_incarnation("job1"))
    reads = (store.load_measurements("wl1"), store.speed_history("job0"),
             [{k: v for k, v in e.items() if k not in WALL_COLUMNS}
              for e in store.node_events("job0")],
             store.journal_entries("job0"),
             store.load_control_snapshot("job0"),
             store.get_control_meta("job0"), store.get_control_meta("job1"))
    return epoch_inc, seqs, reads


def test_one_call_sequence_writes_equal_rows(tmp_path):
    results, paths = {}, {}
    for name, mods in (("jax", JAX), ("torch", TORCH)):
        paths[name] = str(tmp_path / f"{name}.db")
        store = mods["ds"].BrainDatastore(paths[name])
        try:
            results[name] = _datastore_calls(
                store, np.random.default_rng(SEED))
        finally:
            store.close()
    assert results["torch"] == results["jax"]
    want = _dump(paths["jax"])
    assert sum(len(rows) for rows in want.values()) > 30
    assert _dump(paths["torch"]) == want


# ------------------------------------------------- journal and replay


def _components(mods, node_num=3):
    return {
        "kv": mods["kv"].KVStoreService(),
        "rdzv": {
            "elastic-training":
                mods["rdzv"].ElasticTrainingRendezvousManager(),
            "network-check": mods["rdzv"].NetworkCheckRendezvousManager(),
        },
        "tasks": mods["tm"].TaskManager(),
        "nodes": mods["jm"].LocalJobManager(node_num),
    }


def _journal(mods, store, c, job="job-r", **kw):
    return mods["fo"].ControlPlaneJournal(
        store, job, kv_store=c["kv"], rdzv_managers=c["rdzv"],
        task_manager=c["tasks"], job_manager=c["nodes"], **kw)


def _mutation_stream(n=200):
    """A seeded list of ``(target, op, args)`` mutations."""
    rng = np.random.default_rng(SEED)
    ops = [("rdzv", "params", ("elastic-training", 1, 3, 60.0, 1)),
           ("rdzv", "params", ("network-check", 1, 3, 60.0, 1)),
           ("tasks", "dataset", ("ds0", 64, 4)),
           ("tasks", "dataset", ("ds1", 40, 5))]
    for _ in range(n - len(ops)):
        kind = rng.choice(["kv", "rdzv", "tasks", "nodes"],
                          p=[0.35, 0.25, 0.25, 0.15])
        if kind == "kv":
            op = rng.choice(["set", "add", "delete"], p=[0.5, 0.35, 0.15])
            key = f"key{int(rng.integers(0, 12))}"
            if op == "set":
                ops.append(("kv", "set", (key, rng.bytes(6))))
            elif op == "add":
                ops.append(("kv", "add", (f"n{key}",
                                          int(rng.integers(-3, 9)))))
            else:
                ops.append(("kv", "delete", (key,)))
        elif kind == "rdzv":
            name = rng.choice(["elastic-training", "network-check"],
                              p=[0.7, 0.3])
            op = rng.choice(["join", "world", "remove", "ckpt"],
                            p=[0.45, 0.35, 0.1, 0.1])
            rank = int(rng.integers(0, 3))
            ops.append(("rdzv", op, (str(name), rank,
                                     int(rng.integers(1, 5)))))
        elif kind == "tasks":
            op = rng.choice(["get", "ok", "fail", "recover"],
                            p=[0.5, 0.3, 0.1, 0.1])
            ops.append(("tasks", op, (f"ds{int(rng.integers(0, 2))}",
                                      int(rng.integers(0, 3)))))
        else:
            op = rng.choice(["addr", "heartbeat"])
            ops.append(("nodes", op, (int(rng.integers(0, 3)),
                                      f"10.0.0.{int(rng.integers(1, 9))}")))
    return ops


def _apply(mods, c, stream):
    """Drive the components through ``stream``; the task manager's
    leases are tracked per dataset so acks name real task ids."""
    leases = {}
    for target, op, args in stream:
        if target == "kv":
            getattr(c["kv"], op)(*args)
        elif target == "rdzv":
            mgr = c["rdzv"][args[0]]
            if op == "params":
                mgr.update_rdzv_params(*args[1:])
            elif op == "join":
                mgr.join_rendezvous(args[1], args[2])
            elif op == "world":
                mgr.get_comm_world(args[1])
            elif op == "remove":
                mgr.remove_alive_node(args[1])
            else:
                mgr.sync_ckpt_nodes(args[1], args[2])
        elif target == "tasks":
            tm = c["tasks"]
            if op == "dataset":
                name, size, batch = args
                tm.new_dataset(mods["msg"].DatasetShardParams(
                    dataset_name=name, dataset_size=size,
                    batch_size=batch, num_epochs=2,
                    num_minibatches_per_shard=1))
            elif op == "get":
                task = tm.get_task(node_id=args[1], dataset_name=args[0])
                if not task.is_empty:
                    leases.setdefault(args[0], []).append(task.task_id)
            elif op in ("ok", "fail") and leases.get(args[0]):
                tm.report_task_status(args[0], leases[args[0]].pop(0),
                                      success=(op == "ok"))
            elif op == "recover":
                tm.recover_tasks(args[1])
        else:
            jm = c["nodes"]
            if op == "addr":
                jm.update_node_address(NodeType.WORKER, args[0], args[1])
            else:
                jm.collect_node_heartbeat(NodeType.WORKER, args[0],
                                          time.time())


def _state(c):
    """Every component's ``export_state()``."""
    return {
        "kv": c["kv"].export_state(),
        "rdzv": {n: m.export_state() for n, m in c["rdzv"].items()},
        "tasks": c["tasks"].export_state(),
        "nodes": c["nodes"].export_state(),
    }


def _as_replayed(state):
    """What a replay promises of ``state`` (the reference's journal
    semantics, ROADMAP C): the node table as a set of rows, each
    dataset's pending shards as a set (acked shards never come back,
    unacked leases are requeued, but in shard order rather than the live
    master's retry order), no task-id counter (a recovered manager may
    hand out higher ids: ``TestTaskManagerReplay.test_snapshot_roundtrip``)
    and no checkpoint-step barrier reports (``sync_ckpt_nodes`` journals
    nothing; the manager's next journaled mutation carries them)."""
    out = json.loads(json.dumps(state))
    out["nodes"]["nodes"] = sorted(out["nodes"]["nodes"],
                                   key=lambda row: row["id"])
    for entry in out["tasks"]["datasets"].values():
        ckpt = json.loads(entry["ckpt"])
        ckpt.pop("task_id", None)
        ckpt["todo"] = sorted(ckpt["todo"], key=lambda s: s[1])
        entry["ckpt"] = ckpt
    for rdzv in out["rdzv"].values():
        rdzv.pop("ckpt_steps")
    return out


def _live_and_recovered(mods, path, stream, snapshot_at=None):
    """Run ``stream`` with the journal attached (a compacted snapshot
    after ``snapshot_at`` mutations), then recover fresh components from
    the db; returns (live state, recovered state, recovery stats)."""
    store = mods["ds"].BrainDatastore(path)
    try:
        live = _components(mods)
        live["nodes"].start()
        journal = _journal(mods, store, live)
        journal.attach()
        if snapshot_at is None:
            _apply(mods, live, stream)
        else:
            _apply(mods, live, stream[:snapshot_at])
            journal.snapshot_now()
            _apply(mods, live, stream[snapshot_at:])
        fresh = _components(mods)
        stats = _journal(mods, store, fresh).recover()
        fresh["nodes"].start()
        return _state(live), _state(fresh), stats
    finally:
        store.close()


@pytest.mark.parametrize("snapshot_at", [None, 120])
def test_replay_gives_the_live_state_in_both_packages(
        tmp_path, pinned_time, snapshot_at):
    stream = _mutation_stream()
    assert len(stream) == 200
    out = {}
    for name, mods in (("jax", JAX), ("torch", TORCH)):
        out[name] = _live_and_recovered(
            mods, str(tmp_path / f"{name}.db"), stream, snapshot_at)
    (jlive, jfresh, jstats), (tlive, tfresh, tstats) = (
        out["jax"], out["torch"])
    assert tlive == jlive
    assert tfresh == jfresh
    assert tstats["replayed"] == jstats["replayed"] > 0
    assert tstats["snapshot_seq"] == jstats["snapshot_seq"]
    if snapshot_at is not None:
        assert tstats["snapshot_seq"] > 0
    # the rounds, worlds, leases and node table were really exercised
    rdzv = tlive["rdzv"]["elastic-training"]
    assert rdzv["round"] >= 2 and tlive["kv"]
    assert len(tlive["nodes"]["nodes"]) == 3
    assert _as_replayed(tfresh) == _as_replayed(tlive)


def test_the_ports_master_recovers_a_db_the_jax_journal_wrote(
        tmp_path, pinned_time):
    stream = _mutation_stream()
    path = str(tmp_path / "jax.db")
    jlive, _, _ = _live_and_recovered(JAX, path, stream, snapshot_at=80)
    store = tds.BrainDatastore(path)
    try:
        fresh = _components(TORCH)
        stats = _journal(TORCH, store, fresh).recover()
        fresh["nodes"].start()
    finally:
        store.close()
    assert stats["snapshot_seq"] > 0 and stats["replayed"] > 0
    assert _as_replayed(_state(fresh)) == _as_replayed(jlive)


# ------------------------------------ the reference's master scenarios


@pytest.fixture
def brain_env(tmp_path, monkeypatch):
    """A Brain db for the process datastore, closed after the case."""
    db = str(tmp_path / "brain.db")
    monkeypatch.setenv("DLROVER_TPU_BRAIN_DB", db)
    monkeypatch.setattr(tds, "_default_store", None)
    yield db
    if tds._default_store is not None:
        tds._default_store.close()
    tds._default_store = None


class TestInProcessMasterRestart:
    def test_kv_wait_survives_master_restart(self, brain_env):
        port = get_free_port()
        m1 = LocalJobMaster(port, node_num=1)
        m1.prepare()
        assert (m1.job_epoch, m1.incarnation) == (1, 1)
        client = MasterClient(f"127.0.0.1:{port}", node_id=0)
        try:
            client.kv_store_set("pre", b"persisted")
            got = []
            waiter = threading.Thread(
                target=lambda: got.append(
                    client.kv_store_wait("answer", timeout=30.0)),
                daemon=True)
            waiter.start()
            time.sleep(0.4)  # parked on incarnation 1
            m1.stop()

            m2 = LocalJobMaster(port, node_num=1)
            m2.prepare()
            try:
                assert (m2.job_epoch, m2.incarnation) == (1, 2)
                # journal replay restored the pre-crash set
                assert m2.kv_store.get("pre") == b"persisted"
                m2.kv_store.set("answer", b"42")
                waiter.join(timeout=30.0)
                assert got == [b"42"]
                # the re-issued wait refreshed the fencing pair
                assert client._channel.master_incarnation == 2
            finally:
                m2.stop()
        finally:
            client.close()

    def test_job_end_retires_state_next_run_starts_fresh(self, brain_env):
        port = get_free_port()
        m1 = LocalJobMaster(port, node_num=1)
        m1.prepare()
        m1.kv_store.set("stale", b"old-run")
        m1.task_manager.new_dataset(tmsg.DatasetShardParams(
            dataset_name="ds", dataset_size=10, batch_size=10,
            num_epochs=1, num_minibatches_per_shard=1))
        m1.request_stop(True, "Succeeded")  # job ENDED

        m2 = LocalJobMaster(port, node_num=1)
        m2.prepare()
        try:
            assert m2.job_epoch == 2 and m2.incarnation == 1
            assert m2.kv_store.get("stale") == b""
            assert not m2.task_manager.training_started()
        finally:
            m2.stop()

    def test_bare_stop_keeps_state_for_handover(self, brain_env):
        port = get_free_port()
        m1 = LocalJobMaster(port, node_num=1)
        m1.prepare()
        m1.kv_store.set("keep", b"live-job")
        m1.stop()
        m2 = LocalJobMaster(port, node_num=1)
        m2.prepare()
        try:
            assert (m2.job_epoch, m2.incarnation) == (1, 2)
            assert m2.kv_store.get("keep") == b"live-job"
        finally:
            m2.stop()


def test_the_master_records_into_the_brain_and_answers_its_query(
        brain_env, monkeypatch):
    """With a Brain db the master keeps what the reference keeps there:
    a worker failure's node event (the job manager's audit trail), the
    merged timeline (``TimelineAggregator``), the strategy service's
    measurements; the servicer's ``BrainQueryRequest`` answers from it as
    the JAX servicer does from the same db."""
    from dlrover_tpu.master import servicer as jservicer
    from dlrover_tpu_torch.accelerate import engine_service as tservice

    monkeypatch.setenv("DLROVER_TPU_JOB_NAME", "brain-job")
    monkeypatch.setattr(jds, "_default_store", None)
    m = LocalJobMaster(get_free_port(), node_num=1)
    m.prepare()
    chan = MasterChannel(m.addr, node_id=0)
    try:
        chan.report(tmsg.NodeFailure(error_data="exit -9 on worker",
                                     restart_count=0, level="process_error"))
        chan.report(tmsg.TimelineEventsReport(events=[
            {"name": "step", "ph": "X", "wall": 100.0 + i, "mono": 0.0,
             "dur": 0.5, "node": 0, "rank": 0, "inc": 0, "pid": 1,
             "labels": {"step": i + 1}} for i in range(3)]))
        svc = tservice.StrategyService()
        svc.record(tservice.StrategyMeasurement(
            num_params=1000, num_layers=2, strategy={"data": 2},
            step_time_s=0.25))
        workload = tds.workload_signature(tservice._workload_key(
            tservice.StrategyMeasurement(num_params=1000, num_layers=2)))
        queries = [
            tmsg.BrainQueryRequest(kind="node_events", job="brain-job"),
            tmsg.BrainQueryRequest(kind="workloads", job="brain-job"),
            tmsg.BrainQueryRequest(kind="measurements", workload=workload),
            tmsg.BrainQueryRequest(kind="speed", job="brain-job"),
        ]
        got = [chan.get(q) for q in queries]
        assert all(g.available for g in got)
        events = got[0].payload["events"]
        assert [(e["node"], e["event_type"]) for e in events] == [
            ("worker-0", "process_error")]
        assert got[1].payload["workloads"] == [workload]
        assert got[2].payload["measurements"] == [({"data": 2}, 0.25)]
        rows = tds.get_default_datastore().timeline_events("brain-job")
        assert [r["labels"]["step"] for r in rows
                if r["name"] == "step"] == [1, 2, 3]
        # the JAX servicer over the same db answers the same
        tds.get_default_datastore()._drain()
        jsvc = jservicer.MasterServicer()
        for q, g in zip(queries, got):
            want = jsvc._brain_query(jmsg.BrainQueryRequest(
                kind=q.kind, job=q.job, limit=q.limit,
                workload=q.workload))
            assert want.available
            assert json.loads(json.dumps(g.payload)) == json.loads(
                json.dumps(want.payload))
    finally:
        chan.close()
        m.stop()
        if jds._default_store is not None:
            jds._default_store.close()
            jds._default_store = None


class TestTornJournalTail:
    CHILD = """
import os, sys, time
sys.path.insert(0, {repo!r})
from dlrover_tpu_torch.common import messages as msg
from dlrover_tpu_torch.master.datastore import BrainDatastore
from dlrover_tpu_torch.master.failover import ControlPlaneJournal
from dlrover_tpu_torch.master.shard.task_manager import TaskManager

ds = BrainDatastore({db!r})
tm = TaskManager()
journal = ControlPlaneJournal(ds, "j", task_manager=tm)
journal.attach()
# batch 1 becomes durable (the fault plan skips the first flush): the
# dataset, then two leases of its four shards
tm.new_dataset(msg.DatasetShardParams(
    dataset_name="ds", dataset_size=40, batch_size=10, num_epochs=1,
    num_minibatches_per_shard=1))
a = tm.get_task(node_id=0, dataset_name="ds")
b = tm.get_task(node_id=0, dataset_name="ds")
# drains = the flush happened
print("DURABLE", *[e[2] for e in ds.journal_entries("j")], flush=True)
print("LEASES", a.shard.start, b.shard.start, flush=True)
# batch 2: both acks are enqueued; the NEXT flush SIGKILLs the process
# between dequeue and sqlite write
tm.report_task_status("ds", a.task_id, success=True)
tm.report_task_status("ds", b.task_id, success=True)
time.sleep(10)  # the flusher's kill lands first
"""

    def test_sigkill_between_enqueue_and_flush(self, tmp_path):
        db = str(tmp_path / "brain.db")
        child = tmp_path / "child.py"
        child.write_text(self.CHILD.format(repo=str(REPO), db=db))
        env = dict(
            os.environ, DLROVER_TPU_FAULT_ROLE="master",
            DLROVER_TPU_FAULT_PLAN=json.dumps({"faults": [{
                "kind": "kill", "target": "master",
                "phase": "mid_report_flush", "after": 1}]}))
        proc = subprocess.run([sys.executable, str(child)], env=env,
                              capture_output=True, text=True, timeout=60)
        assert proc.returncode == -9, proc.stdout + proc.stderr
        durable = proc.stdout.split("DURABLE")[1].split("LEASES")[0].split()
        leased = [int(x) for x in proc.stdout.split("LEASES")[1].split()]
        assert durable and set(durable) == {"dataset"}
        assert leased == [0, 10]

        ds = tds.BrainDatastore(db)
        try:
            entries = ds.journal_entries("j")
            # the durable prefix survives; the acks were the lost tail
            assert [e[2] for e in entries] == durable
            top = entries[-1][0]
            # a torn row, and a valid one behind it: replay stops at
            # the tear and never raises
            with ds._lock:
                ds._conn.execute(
                    "INSERT INTO control_journal VALUES (?,?,?,?,?,?)",
                    ("j", top + 1, "tasks", "done", '{"name": "d', 0.0))
                ds._conn.execute(
                    "INSERT INTO control_journal VALUES (?,?,?,?,?,?)",
                    ("j", top + 2, "kv", "set", '{"key": "x"}', 0.0))
                ds._conn.commit()
            assert [e[2] for e in ds.journal_entries("j")] == durable
            tm = ttm.TaskManager()
            stats = tfo.ControlPlaneJournal(
                ds, "j", task_manager=tm).recover()
            assert stats["replayed"] == len(durable)
            # neither ack landed: both leases are unacked and requeued,
            # in order, and the dataset is whole again (four shards)
            starts = []
            while True:
                task = tm.get_task(node_id=1, dataset_name="ds")
                if task.is_empty:
                    break
                starts.append(task.shard.start)
                tm.report_task_status("ds", task.task_id, success=True)
            assert starts == [0, 10, 20, 30]
            assert tm.finished()
            # new appends continue past the torn row's seq
            assert ds.journal_append("j", "kv", "set", {}) > top + 2
        finally:
            ds.close()


class TestControlMeta:
    @pytest.fixture
    def store(self, tmp_path):
        ds = tds.BrainDatastore(str(tmp_path / "brain.db"))
        yield ds
        ds.close()

    def test_incarnation_monotonic_same_epoch(self, store):
        assert store.bump_incarnation("j") == (1, 1)
        assert store.bump_incarnation("j") == (1, 2)
        assert store.get_control_meta("j") == (1, 2)

    def test_job_epoch_bump_drops_generation_state(self, store):
        store.bump_incarnation("j")
        store.journal_append("j", "kv", "set", {"key": "a"})
        assert store.bump_job_epoch("j") == 2
        assert store.journal_entries("j") == []
        assert store.load_control_snapshot("j") == (None, 0)
        assert store.bump_incarnation("j") == (2, 1)

    def test_unregistered_job_defaults(self, store):
        assert store.get_control_meta("never") == (1, 0)


def _servicer(job_epoch=3, incarnation=2):
    return MasterServicer(
        kv_store=tkv.KVStoreService(),
        rdzv_managers={RendezvousName.ELASTIC_TRAINING:
                       trdzv.ElasticTrainingRendezvousManager()},
        job_epoch=job_epoch, incarnation=incarnation)


def _envelope(message, job_epoch=-1):
    return tmsg.Envelope(node_id=0, node_type=NodeType.WORKER,
                         data=serialize_message(message),
                         job_epoch=job_epoch)


class TestServicerFencing:
    def test_stale_epoch_fenced_with_typed_answer(self):
        out = _servicer(job_epoch=3, incarnation=2).get(
            _envelope(tmsg.KeyValuePair(key="k"), job_epoch=1))
        assert isinstance(out, tmsg.StaleEpoch)
        assert (out.job_epoch, out.incarnation) == (3, 2)

    def test_report_fenced_too(self):
        out = _servicer(job_epoch=3).report(
            _envelope(tmsg.HeartBeat(timestamp=1.0), job_epoch=1))
        assert isinstance(out, tmsg.StaleEpoch)

    def test_matching_epoch_dispatched(self):
        out = _servicer(job_epoch=3).get(
            _envelope(tmsg.KeyValuePair(key="k"), job_epoch=3))
        assert not isinstance(out, tmsg.StaleEpoch)

    def test_legacy_client_never_fenced(self):
        out = _servicer(job_epoch=3).get(
            _envelope(tmsg.KeyValuePair(key="k")))
        assert not isinstance(out, tmsg.StaleEpoch)

    def test_epoch_request_answered_even_when_stale(self):
        out = _servicer(job_epoch=3, incarnation=7).get(
            _envelope(tmsg.ControlEpochRequest(), job_epoch=1))
        assert isinstance(out, tmsg.ControlEpoch)
        assert (out.job_epoch, out.incarnation) == (3, 7)

    def test_kill_switch_disables_fencing(self, monkeypatch):
        monkeypatch.setenv("DLROVER_TPU_MASTER_FAILOVER", "0")
        out = _servicer(job_epoch=3).get(
            _envelope(tmsg.KeyValuePair(key="k"), job_epoch=1))
        assert not isinstance(out, tmsg.StaleEpoch)


def test_a_fenced_client_adopts_the_new_epoch_and_sends_again():
    """The reference's ``TestChannelEpochHandling``: a client at the old
    incarnation adopts the restarted master's pair and re-issues."""
    chan = MasterChannel(f"127.0.0.1:{get_free_port()}", max_retry=1,
                         timeout=1.0)
    changes = []
    chan.on_epoch_change = lambda e, i: changes.append((e, i))
    answers = [
        serialize_message(tmsg.StaleEpoch(job_epoch=4, incarnation=9)),
        serialize_message(tmsg.KeyValuePair(key="k", value=b"v")),
    ]
    chan._get = lambda payload, timeout: answers.pop(0)
    out = chan._roundtrip("get", tmsg.KeyValuePair(key="k"), timeout=1.0)
    assert out.value == b"v"
    assert (chan.job_epoch, chan.master_incarnation) == (4, 9)
    assert changes == [(4, 9)]
    chan.close()


# ------------------------------ a CPU launch whose master is SIGKILLed


MODEL = ["--device", "cpu", "--dtype", "float32", "--dim", "64",
         "--layers", "2", "--heads", "4", "--seq", "16", "--batch", "2",
         "--steps", "6", "--save_memory_interval", "1",
         "--save_storage_interval", "100"]
#: the reference's ``scripts/chaos.py`` plan ``master-kill-longpoll``:
#: the master SIGKILLs itself at its first parked long-poll
KILL_LONGPOLL = json.dumps({"seed": 11, "faults": [{
    "kind": "kill", "target": "master", "phase": "mid_long_poll",
    "count": 1}]})


class MasterProcess:
    """``python -m dlrover_tpu_torch.master.main`` with a durable db,
    restarted on the same port and db (and without the fault plan) each
    time it dies, as a controller recreates a master pod."""

    def __init__(self, run_dir: Path, plan: str):
        self.port = get_free_port()
        self.addr = f"127.0.0.1:{self.port}"
        self.run_dir = run_dir
        self.plan = plan
        self.exits = []
        self._proc = None
        self._stop = threading.Event()
        self._thread = threading.Thread(target=self._supervise,
                                        daemon=True)

    def _spawn(self):
        n = len(self.exits) + 1
        env = dict(os.environ, PYTHONPATH=str(REPO),
                   DLROVER_TPU_FAULT_ROLE="master",
                   DLROVER_TPU_EVENTS_FILE=str(
                       self.run_dir / "master_events.jsonl"))
        if n == 1:
            env["DLROVER_TPU_FAULT_PLAN"] = self.plan
        else:
            env.pop("DLROVER_TPU_FAULT_PLAN", None)
        with open(self.run_dir / f"master{n}.log", "w") as log:
            self._proc = subprocess.Popen(
                [sys.executable, "-m", "dlrover_tpu_torch.master.main",
                 "--port", str(self.port), "--brain_db",
                 str(self.run_dir / "brain.db"), "--job_name", "chaos"],
                cwd=REPO, env=env, stdout=log, stderr=subprocess.STDOUT)

    def _supervise(self):
        while not self._stop.is_set():
            rc = self._proc.poll()
            if rc is not None and not self._stop.is_set():
                self.exits.append(rc)
                self._spawn()
            time.sleep(0.05)

    def start(self):
        self._spawn()
        self._thread.start()

    def stop(self):
        self._stop.set()
        self._thread.join(timeout=5)
        self._proc.terminate()
        self._proc.wait(timeout=10)

    def log(self, n: int) -> str:
        return (self.run_dir / f"master{n}.log").read_text()


def _launch(run_dir: Path, master_addr: str = ""):
    """The launcher over two gloo workers (``test_torch_elastic``'s
    ``_launch`` without a crash); returns the rank-0 losses."""
    rep = run_dir / "rep"
    rep.mkdir(parents=True)
    sockets = tempfile.mkdtemp(prefix="dtf", dir="/tmp")
    cmd = [sys.executable, "-m", "dlrover_tpu_torch.run", "--nnodes=1",
           "--nproc_per_node=2", "--max-restarts=1",
           "--monitor_interval=0.2",
           f"--events_file={run_dir / 'events.jsonl'}"]
    if master_addr:
        cmd.append(f"--master_addr={master_addr}")
    cmd += ["-m", "dlrover_tpu_torch.examples.llama_pretrain", *MODEL,
            "--ckpt_dir", str(run_dir / "ckpt"), "--report_dir", str(rep)]
    try:
        proc = subprocess.run(
            cmd, cwd=REPO, capture_output=True, text=True, timeout=240,
            env=dict(os.environ, PYTHONPATH=str(REPO), OMP_NUM_THREADS="1",
                     DLROVER_TPU_METADATA_BASE="http://127.0.0.1:9/",
                     DLROVER_TPU_TORCH_SOCKET_DIR=sockets))
    finally:
        shutil.rmtree(sockets, ignore_errors=True)
    assert proc.returncode == 0, proc.stderr[-4000:]
    report = json.loads((rep / "rank0_inc0.json").read_text())
    return [(h["step"], h["loss"]) for h in report["history"]]


def test_a_launch_whose_master_is_killed_ends_with_the_same_losses(
        tmp_path):
    base = _launch(tmp_path / "base")
    assert [s for s, _ in base] == [1, 2, 3, 4, 5, 6]
    run_dir = tmp_path / "killed"
    run_dir.mkdir()
    master = MasterProcess(run_dir, KILL_LONGPOLL)
    master.start()
    try:
        losses = _launch(run_dir, master.addr)
    finally:
        master.stop()
    # one plan-driven SIGKILL, one restart on the same port and db
    assert master.exits == [-signal.SIGKILL]
    assert "master incarnation 2 resumed job epoch 1" in master.log(2)
    store = tds.BrainDatastore(str(run_dir / "brain.db"))
    try:
        assert store.get_control_meta("chaos") == (1, 2)
    finally:
        store.close()
    kills = [e for e in map(json.loads, (
        run_dir / "master_events.jsonl").read_text().splitlines())
        if e["name"] == "fault_injected"]
    assert [k["labels"]["phase"] for k in kills] == ["mid_long_poll"]
    assert losses == base
