"""The agent's start-up services against the JAX package's, on the CPU.

- The preemption watcher: one injected fetcher sequence fires the same
  callbacks, returns the same events and marks the same outages as the
  JAX ``PreemptionWatcher``; the default fetcher sends nothing where no
  metadata server is expected, and asks a stand-in server on this
  machine (``DLROVER_TPU_METADATA_BASE``) on the watcher's own thread.
- The node check: the payload on the CPU over gloo at world 2;
  ``DLROVER_TPU_MOCK_NODE_ERROR`` fails it as it fails the JAX one; the
  master's verdicts for one set of reported times equal the JAX
  master's; the agent's check against a real master over gRPC.
- The monitors: the step file the ``ElasticTrainer`` writes becomes a
  ``GlobalStep``, as the JAX monitor makes it of the JAX trainer's; the
  ``ResourceMonitor`` and heartbeat messages equal the JAX ones.
- The replica service: the JAX ``push_replica``/``fetch_replica``
  against the port's ``ReplicaService`` and the reverse, byte for byte.
"""

import dataclasses
import http.server
import json
import os
import shutil
import subprocess
import sys
import tempfile
import threading
import time
from pathlib import Path

import pytest

os.environ.setdefault("JAX_PLATFORMS", "cpu")

from dlrover_tpu.agent import monitor as jmon  # noqa: E402
from dlrover_tpu.agent import node_check as jnc  # noqa: E402
from dlrover_tpu.agent import preemption as jpre  # noqa: E402
from dlrover_tpu.agent import replica as jrep  # noqa: E402
from dlrover_tpu.master import rendezvous as jrdzv  # noqa: E402
from dlrover_tpu.trainer.elastic import trainer as jet  # noqa: E402
from dlrover_tpu_torch.agent import monitor as tmon  # noqa: E402
from dlrover_tpu_torch.agent import node_check as tnc  # noqa: E402
from dlrover_tpu_torch.agent import preemption as tpre  # noqa: E402
from dlrover_tpu_torch.agent import replica as trep  # noqa: E402
from dlrover_tpu_torch.common import multi_process  # noqa: E402
from dlrover_tpu_torch.common.env import get_free_port  # noqa: E402
from dlrover_tpu_torch.master import rendezvous as trdzv  # noqa: E402
from dlrover_tpu_torch.trainer.elastic import trainer as tet  # noqa: E402

REPO = Path(__file__).resolve().parents[1]


@pytest.fixture(autouse=True)
def _sockets(monkeypatch):
    d = tempfile.mkdtemp(prefix="das", dir="/tmp")
    monkeypatch.setenv(multi_process.SOCKET_DIR_ENV, d)
    # no watcher here may ask a real metadata server
    monkeypatch.delenv(tpre.METADATA_BASE_ENV, raising=False)
    monkeypatch.setattr(tpre, "_DMI_PRODUCT", str(Path(d) / "no_dmi"))
    yield d
    shutil.rmtree(d, ignore_errors=True)


# ------------------------------------------------------------ preemption


_SEQUENCE = [None, "NONE", "MIGRATE_ON_HOST_MAINTENANCE",
             "MIGRATE_ON_HOST_MAINTENANCE", "NONE",
             "TERMINATE_ON_HOST_MAINTENANCE", "PREEMPTED", "FALSE", None,
             "", "PREEMPTED", "TRUE"]


def _watch(mod):
    values = iter(_SEQUENCE)
    fired = []
    w = mod.PreemptionWatcher(fetcher=lambda: next(values),
                              poll_interval=60)
    w.on_preemption(fired.append)
    w.on_preemption(lambda e: 1 / 0)  # a failing callback is contained
    returned, unavailable = [], []
    for _ in _SEQUENCE:
        returned.append(w.check_once())
        unavailable.append(w.unavailable)
    return fired, returned, unavailable


def test_watcher_fires_what_the_jax_watcher_fires():
    got, want = _watch(tpre), _watch(jpre)
    assert got == want
    assert got[0] == ["MIGRATE_ON_HOST_MAINTENANCE",
                      "TERMINATE_ON_HOST_MAINTENANCE", "PREEMPTED",
                      "PREEMPTED", "TRUE"]


def test_default_fetcher_sends_nothing_without_a_metadata_server(
        monkeypatch):
    def refuse(*a, **k):
        raise AssertionError("a request was built")

    import urllib.request

    monkeypatch.setattr(urllib.request, "build_opener", refuse)
    assert tpre._default_fetcher(timeout=0.1) is None
    w = tpre.PreemptionWatcher(poll_interval=60)
    assert w.check_once() is None and w.unavailable


class _StandIn:
    """A metadata server on this machine: answers ``answers[path]``
    after ``delay`` seconds; counts requests."""

    def __init__(self, answers, delay=0.0):
        owner = self
        self.requests = []

        class Handler(http.server.BaseHTTPRequestHandler):
            def do_GET(self):
                owner.requests.append(
                    (self.path, self.headers.get("Metadata-Flavor")))
                time.sleep(delay)
                body = answers[self.path.rsplit("/", 1)[-1]].encode()
                self.send_response(200)
                self.send_header("Content-Length", str(len(body)))
                self.end_headers()
                self.wfile.write(body)

            def log_message(self, *args):
                pass

        self.srv = http.server.ThreadingHTTPServer(("127.0.0.1", 0),
                                                   Handler)
        self.base = f"http://127.0.0.1:{self.srv.server_address[1]}/i/"
        threading.Thread(target=self.srv.serve_forever, daemon=True).start()

    def close(self):
        self.srv.shutdown()
        self.srv.server_close()


def test_watcher_polls_a_stand_in_on_its_own_thread(monkeypatch):
    answers = {"maintenance-event": "NONE", "preempted": "FALSE"}
    srv = _StandIn(answers, delay=0.3)
    monkeypatch.setenv(tpre.METADATA_BASE_ENV, srv.base)
    fired = []
    w = tpre.PreemptionWatcher(poll_interval=0.05)
    w.on_preemption(fired.append)
    try:
        t = time.perf_counter()
        w.start()
        assert time.perf_counter() - t < 0.1  # the caller never waits
        deadline = time.time() + 20
        while len(srv.requests) < 2 and time.time() < deadline:
            time.sleep(0.05)
        assert not fired and not w.unavailable
        answers["preempted"] = "TRUE"
        while not fired and time.time() < deadline:
            time.sleep(0.05)
    finally:
        w.stop()
        srv.close()
    assert fired == ["PREEMPTED"]
    assert srv.requests[0] == ("/i/maintenance-event", "Google")
    assert {p for p, _ in srv.requests} == {"/i/maintenance-event",
                                             "/i/preempted"}


# ------------------------------------------------------------ node check


def _payload(env):
    return subprocess.Popen(
        [sys.executable, "-m", "dlrover_tpu_torch.agent.node_check"],
        cwd=REPO, env=env)


def test_node_check_payload_over_gloo_at_world_2(tmp_path):
    addr = f"127.0.0.1:{get_free_port()}"
    procs = []
    for rank in range(2):
        procs.append(_payload(dict(
            os.environ, PYTHONPATH=str(REPO), OMP_NUM_THREADS="1",
            **{tnc.RANK_ENV: str(rank), tnc.WORLD_ENV: "2",
               tnc.ADDR_ENV: addr, tnc.DEVICE_ENV: "cpu",
               tnc.RESULT_FILE_ENV: str(tmp_path / f"r{rank}")})))
    assert [p.wait(timeout=120) for p in procs] == [0, 0]
    for rank in range(2):
        lines = (tmp_path / f"r{rank}").read_text().splitlines()
        got = json.loads(lines[1])
        assert float(lines[0]) == pytest.approx(got["elapsed"], abs=1e-6)
        assert got["world"] == 2 and got["device"] == "cpu"
        assert got["matmul_ms"] > 0 and got["allreduce_ms"] > 0


def test_mock_node_error_fails_both_payloads(monkeypatch, tmp_path):
    monkeypatch.setenv("DLROVER_TPU_MOCK_NODE_ERROR", "1")
    for mod in (tnc, jnc):
        out = tmp_path / mod.__name__
        monkeypatch.setenv("DLROVER_TPU_NODE_CHECK_RESULT_FILE", str(out))
        assert mod.mock_error()
        with pytest.raises(RuntimeError, match="injected"):
            mod.run_health_check()
        assert mod.main() == 1 and not out.exists()


def _verdicts(mod):
    """A two-round sweep of four nodes, node 2 failing round 1 and node
    3 slow; (groups, fault verdicts, straggler verdicts) per round."""
    m = mod.NetworkCheckRendezvousManager()
    m.update_rdzv_params(4, 4, 0.0, 1)
    out = []
    for rnd, reports in enumerate((
            {0: (True, 1.0), 1: (True, 1.1), 2: (False, -1.0),
             3: (True, 9.0)},
            {0: (True, 1.0), 1: (True, 1.2), 2: (True, 1.3),
             3: (True, 8.0)})):
        for n in range(4):
            m.join_rendezvous(n, 1)
        worlds = [m.get_comm_world(n) for n in range(4)]
        before = m.check_fault_node()
        for n, (ok, t) in reports.items():
            m.report_network_status(n, ok, t)
            if n == 1:
                out.append(("partial", m.check_fault_node()))
        out.append((rnd, worlds, before, m.check_fault_node(),
                    m.check_straggler()))
    return out


def test_master_verdicts_equal_the_jax_master_s():
    got, want = _verdicts(trdzv), _verdicts(jrdzv)
    assert got == want
    assert want[1][3] == ([2], "Node failure")
    assert want[1][4] == ([3], "")
    assert want[3][3] == ([], "")  # a success in round 2 clears node 2


@pytest.fixture
def client():
    from dlrover_tpu_torch.agent.master_client import MasterClient
    from dlrover_tpu_torch.master.master import LocalJobMaster

    m = LocalJobMaster(get_free_port(), node_num=1)
    m.prepare()
    MasterClient.reset()
    c = MasterClient.singleton_instance(m.addr, node_id=0)
    c.report_rdzv_params(1, 1, 30, 1)
    yield c
    MasterClient.reset()
    m.stop()


@pytest.mark.parametrize("fail", [False, True])
def test_the_agent_s_node_check_against_a_master(client, monkeypatch,
                                                 fail):
    from dlrover_tpu_torch.agent.training import (
        ElasticLaunchConfig,
        ElasticTrainingAgent,
    )

    monkeypatch.setenv(tnc.DEVICE_ENV, "cpu")
    monkeypatch.setenv("OMP_NUM_THREADS", "1")
    monkeypatch.setenv("PYTHONPATH", str(REPO))
    if fail:
        monkeypatch.setenv("DLROVER_TPU_MOCK_NODE_ERROR", "1")
    config = ElasticLaunchConfig(nproc_per_node=2, network_check=True,
                                 rdzv_timeout=30, node_rank=0)
    agent = ElasticTrainingAgent(config, [sys.executable, "-c", "0"],
                                 client=client, start_ckpt_saver=False)
    if fail:
        with pytest.raises(RuntimeError, match="health check"):
            agent._run_network_check()
        assert agent.node_check["fault_nodes"] == [0]
        return
    agent._run_network_check()
    nc = agent.node_check
    assert nc["world"] == 2 and nc["device"] == "cpu"
    assert nc["fault_nodes"] == [] and nc["reason"] == ""
    assert nc["spawn"] == "plain"
    assert client.check_fault_node() == ([], "")


def test_the_agent_s_node_check_forks_from_its_zygote(client, monkeypatch):
    """Under ``--prefork`` the payloads are forked from the agent's
    zygote, with torch already imported."""
    from dlrover_tpu_torch.agent.training import (
        ElasticLaunchConfig,
        ElasticTrainingAgent,
    )
    from dlrover_tpu_torch.agent.zygote import ZygotePool

    monkeypatch.setenv(tnc.DEVICE_ENV, "cpu")
    monkeypatch.setenv("OMP_NUM_THREADS", "1")
    monkeypatch.setenv("PYTHONPATH", str(REPO))
    config = ElasticLaunchConfig(nproc_per_node=2, network_check=True,
                                 rdzv_timeout=30, node_rank=0)
    agent = ElasticTrainingAgent(config, [sys.executable, "-c", "0"],
                                 client=client, start_ckpt_saver=False)
    pool = ZygotePool(name=f"z{os.getpid()}", preload=("torch",))
    assert pool.start(env=dict(os.environ), wait=True)
    agent._zygote = pool
    try:
        agent._run_network_check()
    finally:
        pool.close()
    nc = agent.node_check
    assert nc["spawn"] == "zygote"
    assert nc["world"] == 2 and nc["device"] == "cpu"
    assert nc["fault_nodes"] == []


# -------------------------------------------------------------- monitors


class _Buffer:
    def __init__(self):
        self.messages = []

    def add(self, message):
        self.messages.append(message)
        return True


def _fields(message):
    return type(message).__name__, dataclasses.asdict(message)


def test_step_file_becomes_a_global_step_as_in_jax(tmp_path, monkeypatch):
    monkeypatch.delenv("DLROVER_TPU_MASTER_ADDR", raising=False)
    out = {}
    for name, et, mon in (("jax", jet, jmon), ("torch", tet, tmon)):
        step_file = str(tmp_path / f"{name}.json")
        trainer = et.ElasticTrainer(8, 1, world_size=1, rank=0,
                                    step_file=step_file, report_interval=0)
        buf = _Buffer()
        m = mon.TrainingMonitor(step_file, client=object(), buffer=buf)
        m._tick()  # no file yet: nothing
        for _ in range(3):
            trainer.step_done()
        m._tick()
        m._tick()  # the same step is reported once
        trainer.step_done(2)
        m._tick()
        with open(step_file) as f:
            keys = sorted(json.load(f))
        out[name] = keys, [(type(x).__name__, x.step)
                           for x in buf.messages]
    assert out["torch"] == out["jax"]
    assert out["jax"] == (["step", "timestamp"],
                          [("GlobalStep", 3), ("GlobalStep", 5)])


def test_the_step_file_is_the_agent_s_or_none(tmp_path, monkeypatch):
    """Outside an agent (no ``DLROVER_TPU_STEP_FILE``) rank 0 writes no
    step file; under one it writes the agent's."""
    monkeypatch.delenv("DLROVER_TPU_MASTER_ADDR", raising=False)
    monkeypatch.delenv(tet.STEP_FILE_ENV, raising=False)
    monkeypatch.setattr(tempfile, "tempdir", str(tmp_path))
    trainer = tet.ElasticTrainer(1, 1, world_size=1, rank=0,
                                 report_interval=0)
    trainer.step_done()
    assert list(tmp_path.iterdir()) == []
    path = tmp_path / "agent" / "step.json"
    path.parent.mkdir()
    monkeypatch.setenv(tet.STEP_FILE_ENV, str(path))
    trainer = tet.ElasticTrainer(1, 1, world_size=1, rank=0,
                                 report_interval=0)
    trainer.step_done(2)
    assert json.loads(path.read_text())["step"] == 2


def test_a_rank_on_the_cpu_writes_no_card_stats(tmp_path, monkeypatch):
    monkeypatch.setenv(tet.CHIP_STATS_ENV, str(tmp_path / "cards"))
    trainer = tet.ElasticTrainer(1, 1, world_size=1, rank=0,
                                 step_file=str(tmp_path / "s.json"),
                                 report_interval=0, device="cpu")
    trainer.step_done()
    assert tet.card_stats("cpu") is None
    assert not (tmp_path / "cards").exists()
    assert json.loads((tmp_path / "s.json").read_text())["step"] == 1


def test_resource_and_heartbeat_messages_equal_the_jax_ones(tmp_path,
                                                            monkeypatch):
    cards = tmp_path / "cards"
    cards.mkdir()
    stats = [{"device": "cuda:0", "memory_allocated_mb": 100, "rank": 0},
             {"device": "cuda:1", "memory_allocated_mb": 200, "rank": 1}]
    for s in stats:
        (cards / f"rank{s['rank']}.json").write_text(json.dumps(s))
    (tmp_path / "one.json").write_text(json.dumps(stats))
    for mod in (jmon, tmon):
        monkeypatch.setattr(mod, "get_process_cpu_percent", lambda: 12.5)
        monkeypatch.setattr(mod, "get_used_memory_mb", lambda: 4096)
    monkeypatch.setattr(time, "time", lambda: 1234.5)
    out = {}
    for name, mod in (("jax", jmon), ("torch", tmon)):
        buf = _Buffer()
        mod.ResourceMonitor(client=object(), buffer=buf,
                            chip_stats_file=str(tmp_path / "one.json"))._tick()
        mod.ResourceMonitor(client=object(), buffer=buf,
                            chip_stats_file=str(tmp_path / "none"))._tick()
        mod.HeartbeatReporter(client=object(), buffer=buf)._tick()
        out[name] = [_fields(m) for m in buf.messages]
    assert out["torch"] == out["jax"]
    assert out["jax"][0][1] == {"cpu_percent": 12.5, "memory_mb": 4096,
                                "tpu_stats": stats}
    # the port also reads a directory of them, one a worker
    buf = _Buffer()
    tmon.ResourceMonitor(client=object(), buffer=buf,
                         chip_stats_file=str(cards))._tick()
    assert buf.messages[0].tpu_stats == stats


# --------------------------------------------------------------- replica


@pytest.mark.parametrize("server,client_mod", [(trep, jrep), (jrep, trep)])
def test_replica_protocol_crosses_the_packages(server, client_mod):
    svc = server.ReplicaService(host="127.0.0.1")
    svc.start()
    addr = f"127.0.0.1:{svc.port}"
    payload = os.urandom(3 << 20) + b"\n" + bytes(range(256))
    try:
        assert client_mod.fetch_replica(addr, 4) is None
        assert client_mod.push_replica(addr, 4, payload)
        assert svc.get_local(4) == payload
        assert client_mod.fetch_replica(addr, 4) == payload
        svc.put_local(5, b"x")
        assert client_mod.fetch_replica(addr, 5) == b"x"
    finally:
        svc.stop()


def test_replica_manager_backs_up_to_and_restores_from_a_jax_peer():
    services = {0: trep.ReplicaService(host="127.0.0.1"),
                1: jrep.ReplicaService(host="127.0.0.1")}
    for s in services.values():
        s.start()
    peers = {n: f"127.0.0.1:{s.port}" for n, s in services.items()}
    try:
        mine = trep.ReplicaManager(0, services[0], lambda: peers)
        assert mine.backup(b"shard-0" * 1000) == 1
        assert services[1].get_local(0) == b"shard-0" * 1000
        # a relaunched node 0, its own store empty, pulls from node 1
        fresh = trep.ReplicaService(host="127.0.0.1")
        again = trep.ReplicaManager(0, fresh, lambda: peers)
        assert again.restore() == b"shard-0" * 1000
        theirs = jrep.ReplicaManager(1, services[1], lambda: peers)
        assert theirs.backup(b"shard-1") == 1
        assert services[0].get_local(1) == b"shard-1"
    finally:
        for s in services.values():
            s.stop()
