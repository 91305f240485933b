"""The port's elastic launch (master, agent, launcher) on the CPU.

- The copied control plane against the JAX package: one join and leave
  sequence through both ``ElasticTrainingRendezvousManager``s gives the
  same rounds and worlds; one set of failure reports through both
  ``LocalJobManager``s gives the same relaunch decisions; one set of
  dataset parameters through both ``TaskManager``s gives the same shard
  sequence.
- The port's cases of ``tests/test_elastic_agent.py`` against a real
  ``LocalJobMaster`` over gRPC: the KV round trip, a single-node
  rendezvous, a successful run, a restart then giving up, a restart
  that recovers, a node excluded, ``parse_nnodes`` and the standalone
  launch.
- The slice end to end: ``python -m dlrover_tpu_torch.run
  --nproc_per_node=2 --max-restarts=1`` of the port's ``llama_pretrain``
  at a tiny size on two gloo workers, rank 1 SIGKILLed after step 3 on
  the first incarnation.  The restart restores step 3 from the agent's
  shared memory, and steps 4-6 and every final state leaf equal an
  uninterrupted two-process run bit for bit.  The uninterrupted run's
  losses equal the JAX package's ``Trainer`` on the same params and
  batches within ``tests/test_torch_train.py``'s 1e-5.
- The worker's side: after the drain signal the ``Trainer`` snapshots
  every step, blocking; a hung worker's ``HangDetector`` fires and its
  default action exits; ``leaf_digests`` sees one flipped byte.
- The same launch with the workers forked from the agent's zygote
  (``--prefork``), the node check before each rendezvous
  (``--network_check``) and the restart overlap on: every incarnation
  was forked with torch imported and CUDA untouched, the restarted
  workers restored through the prefetch, and the run ends bit for bit.
- What ROADMAP A3c still has to bring (the Brain, the deep capture,
  the distributed master) raises ``NotImplementedError`` naming it, and
  the port's defaults keep those switches off; the durable master and
  the observatory (A3c.3a/b) are built behind the reference's switches
  and defaults; the agent's switches take the reference's defaults.
"""

import functools
import json
import os
import random
import shutil
import subprocess
import sys
import tempfile
import textwrap
from pathlib import Path

import numpy as np
import pytest
import torch

os.environ.setdefault("JAX_PLATFORMS", "cpu")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from dlrover_tpu.common import messages as jmsg  # noqa: E402
from dlrover_tpu.master import job_manager as jjm  # noqa: E402
from dlrover_tpu.master import rendezvous as jrdzv  # noqa: E402
from dlrover_tpu.master.shard import task_manager as jtm  # noqa: E402
from dlrover_tpu_torch.agent.master_client import MasterClient  # noqa: E402
from dlrover_tpu_torch.agent.training import (  # noqa: E402
    ElasticLaunchConfig,
    ElasticTrainingAgent,
    MasterRendezvousHandler,
    NodeExcludedError,
)
from dlrover_tpu_torch.common import env  # noqa: E402
from dlrover_tpu_torch.common import messages as tmsg  # noqa: E402
from dlrover_tpu_torch.common import multi_process  # noqa: E402
from dlrover_tpu_torch.common.constants import (  # noqa: E402
    AgentExitCode,
    TrainingExceptionLevel,
)
from dlrover_tpu_torch.common.env import get_free_port  # noqa: E402
from dlrover_tpu_torch.master import job_manager as tjm  # noqa: E402
from dlrover_tpu_torch.master import rendezvous as trdzv  # noqa: E402
from dlrover_tpu_torch.master.master import LocalJobMaster  # noqa: E402
from dlrover_tpu_torch.master.shard import task_manager as ttm  # noqa: E402

REPO = Path(__file__).resolve().parents[1]
ATOL = 1e-5  # tests/test_torch_train.py: fp32, unit-scale values


def _short_tmp(prefix: str) -> str:
    """A directory short enough for AF_UNIX paths (107 bytes) whatever
    pytest's ``--basetemp``: the system temp dir when it is short."""
    base = tempfile.gettempdir()
    return tempfile.mkdtemp(prefix=prefix,
                            dir=base if len(base) <= 40 else "/tmp")


#: a metadata endpoint on this machine that refuses connections: the
#: agents' preemption watchers (on by default) never ask a real one
DEAD_METADATA = "http://127.0.0.1:9/computeMetadata/v1/instance/"


@pytest.fixture(autouse=True)
def _port_sockets(monkeypatch):
    d = _short_tmp("dte")
    monkeypatch.setenv(multi_process.SOCKET_DIR_ENV, d)
    monkeypatch.setenv("DLROVER_TPU_METADATA_BASE", DEAD_METADATA)
    yield d
    shutil.rmtree(d, ignore_errors=True)


# --------------------------------------------------- parity with the copies


def _rdzv_trace(mod):
    """Rounds and worlds of one join/leave sequence (two nodes of 2
    processes, one leaves before the second round completes)."""
    m = mod.ElasticTrainingRendezvousManager()
    m.update_rdzv_params(1, 2, 0.0, 1)
    out = [m.join_rendezvous(0, 2), m.join_rendezvous(1, 2)]
    out.append(m.get_comm_world(0))
    out.append(m.num_nodes_waiting())
    out.append(m.join_rendezvous(1, 2))
    out.append(m.num_nodes_waiting())
    m.remove_alive_node(1)
    out.append(m.num_nodes_waiting())
    out.append(m.join_rendezvous(0, 2))
    out.append(m.get_comm_world(0))
    out.append(m.get_rdzv_round())
    return out


def test_rendezvous_rounds_and_worlds_match_the_jax_package():
    got, want = _rdzv_trace(trdzv), _rdzv_trace(jrdzv)
    assert got == want
    assert want[2] == (1, 0, {0: 2, 1: 2}) and want[-1] == 2


def _job_trace(jm_mod, msg_mod):
    mgr = jm_mod.LocalJobManager(node_num=2)
    mgr.start()
    out = []
    for node_id, rc, data, level in (
        (0, 0, "{0: -9}", TrainingExceptionLevel.PROCESS_ERROR),
        (1, 0, "RESOURCE_EXHAUSTED: out of memory",
         TrainingExceptionLevel.PROCESS_ERROR),
        (0, 1, "node 0 excluded", TrainingExceptionLevel.NODE_EXCLUDED),
        (1, 1, "chip failed", TrainingExceptionLevel.NODE_ERROR),
    ):
        mgr.handle_training_failure("worker", node_id, rc, data, level)
        out.append((mgr.should_restart_node("worker", 0),
                    mgr.should_restart_node("worker", 1),
                    mgr.should_stop_job()))
    out.append(mgr.get_paral_config() == msg_mod.ParallelConfig())
    return out


def test_failure_reports_give_the_jax_package_s_relaunch_decisions():
    got, want = _job_trace(tjm, tmsg), _job_trace(jjm, jmsg)
    assert got == want
    assert want[-2][1]  # the node error earns node 1 a relaunch


@pytest.mark.parametrize("shuffle", [False, True])
def test_task_managers_hand_out_the_same_shards(shuffle):
    def trace(tm_mod, msg_mod):
        random.seed(7)
        tm = tm_mod.TaskManager()
        tm.new_dataset(msg_mod.DatasetShardParams(
            batch_size=4, num_epochs=2, dataset_size=37, shuffle=shuffle,
            num_minibatches_per_shard=2, dataset_name="ds"))
        out = []
        while True:
            task = tm.get_task(len(out) % 2, "ds")
            if task.is_empty:
                break
            out.append((task.task_id, task.task_type, task.shard.start,
                        task.shard.end))
            tm.report_task_status("ds", task.task_id, success=True)
        return out, tm.finished()

    got, want = trace(ttm, tmsg), trace(jtm, jmsg)
    assert got == want
    assert sum(e - s for _, _, s, e in want[0]) == 2 * 37 and want[1]


# ------------------------------------ the cases of test_elastic_agent.py


@pytest.fixture
def master():
    m = LocalJobMaster(get_free_port(), node_num=1)
    m.prepare()
    yield m
    m.stop()


@pytest.fixture
def client(master):
    MasterClient.reset()
    c = MasterClient.singleton_instance(master.addr, node_id=0)
    yield c
    MasterClient.reset()


def _write_script(tmp_path, body: str) -> str:
    path = tmp_path / "worker.py"
    path.write_text(textwrap.dedent(body))
    return str(path)


def _agent(client, script, nproc=2, max_restarts=1):
    config = ElasticLaunchConfig(
        min_nodes=1, max_nodes=1, nproc_per_node=nproc,
        monitor_interval=0.2, max_restarts=max_restarts, node_rank=0,
        rdzv_timeout=30)
    client.report_rdzv_params(1, 1, 30, 1)
    return ElasticTrainingAgent(config, [sys.executable, script],
                                client=client, start_ckpt_saver=False)


def test_kv_store_roundtrip(client):
    assert client.kv_store_set("k1", b"v1")
    assert client.kv_store_get("k1") == b"v1"
    assert client.kv_store_wait("k1") == b"v1"


def test_rendezvous_single_node(client):
    client.report_rdzv_params(1, 1, 60, 1)
    assert client.join_rendezvous(0, local_world_size=2) >= 0
    handler = MasterRendezvousHandler(client, 0, 2, timeout=10)
    _rnd, _group, world = handler.next_rendezvous()
    assert world == {0: 2}


def test_successful_run_publishes_the_torch_coordinator(client, tmp_path):
    script = _write_script(tmp_path, """
        import os, sys
        assert os.environ["DLROVER_TPU_PROCESS_COUNT"] == "2"
        assert os.environ["DLROVER_TPU_COORDINATOR_ADDR"]
        sys.exit(0)
        """)
    agent = _agent(client, script)
    assert agent.run() == 0
    addr = client.kv_store_get("torch_coordinator/1").decode()
    assert addr.rsplit(":", 1)[1].isdigit()


def test_failed_worker_restarts_then_gives_up(client, tmp_path):
    marker = tmp_path / "attempts"
    script = _write_script(tmp_path, f"""
        import sys
        with open({str(marker)!r}, "a") as f:
            f.write("x")
        sys.exit(3)
        """)
    assert _agent(client, script, nproc=1, max_restarts=1).run() == 1
    assert marker.read_text() == "xx"  # the first attempt + 1 restart


def test_restart_recovers(client, tmp_path):
    script = _write_script(tmp_path, """
        import os, sys
        sys.exit(0 if int(os.environ["DLROVER_TPU_RESTART_COUNT"]) > 0
                 else 5)
        """)
    assert _agent(client, script, nproc=1, max_restarts=2).run() == 0


def test_node_excluded_distinct_exit_code(client, tmp_path, monkeypatch):
    script = _write_script(tmp_path, "raise SystemExit(0)\n")
    agent = _agent(client, script, nproc=1)

    def excluded(self):
        raise NodeExcludedError("node 0 excluded from round 1")

    monkeypatch.setattr(MasterRendezvousHandler, "next_rendezvous",
                        excluded)
    reports = []
    real = client.report_failure

    def spy(error_data="", restart_count=0, level=""):
        reports.append((error_data, level))
        return real(error_data=error_data, restart_count=restart_count,
                    level=level)

    monkeypatch.setattr(client, "report_failure", spy)
    assert agent.run() == AgentExitCode.NODE_EXCLUDED
    assert reports[0][1] == TrainingExceptionLevel.NODE_EXCLUDED
    assert "excluded" in reports[0][0]


def test_parse_nnodes_and_the_launcher_flags():
    from dlrover_tpu_torch.trainer import elastic_run

    assert elastic_run.parse_nnodes("4") == (4, 4)
    assert elastic_run.parse_nnodes("1:8") == (1, 8)
    args = elastic_run.parse_args(
        ["--max-restarts=2", "-m", "pkg.mod", "--x", "1"])
    assert args.max_restarts == 2 and args.module
    assert elastic_run._build_entrypoint(args)[1:] == [
        "-m", "pkg.mod", "--x", "1"]


def test_standalone_launch(tmp_path):
    from dlrover_tpu_torch.trainer import elastic_run

    script = _write_script(tmp_path, """
        import os, sys
        sys.exit(0 if os.environ["DLROVER_TPU_PROCESS_COUNT"] == "2"
                 else 1)
        """)
    args = elastic_run.parse_args(
        ["--standalone", "--nproc_per_node=2", script])
    assert elastic_run.run(args) == 0


# ------------------------------------------------------ end to end


MODEL = ["--device", "cpu", "--dtype", "float32", "--dim", "64",
         "--layers", "2", "--heads", "4", "--seq", "16", "--batch", "2",
         "--steps", "6", "--save_memory_interval", "1",
         "--save_storage_interval", "100"]


def _launch(run_dir: Path, sockets: str, crash: bool, flags=(),
            with_output: bool = False):
    """The launcher over two gloo workers; returns {(rank, inc): report}
    (and the launcher's output and events with ``with_output``)."""
    rep = run_dir / "rep"
    rep.mkdir(parents=True)
    events = run_dir / "events.jsonl"
    cmd = [sys.executable, "-m", "dlrover_tpu_torch.run", "--nnodes=1",
           "--nproc_per_node=2", "--max-restarts=1", "--monitor_interval=0.2",
           f"--events_file={events}", *flags,
           "-m", "dlrover_tpu_torch.examples.llama_pretrain", *MODEL,
           "--ckpt_dir", str(run_dir / "ckpt"), "--report_dir", str(rep)]
    if crash:
        cmd += ["--crash_after_step", "3", "--crash_rank", "1"]
    # one thread a worker: the suite runs beside other tests' processes
    proc = subprocess.run(
        cmd, cwd=REPO, capture_output=True, text=True, timeout=240,
        env=dict(os.environ, PYTHONPATH=str(REPO), OMP_NUM_THREADS="1",
                 DLROVER_TPU_NODE_CHECK_DEVICE="cpu",
                 DLROVER_TPU_METADATA_BASE=DEAD_METADATA,
                 **{multi_process.SOCKET_DIR_ENV: sockets}))
    assert proc.returncode == 0, proc.stderr[-4000:]
    out = {}
    for p in rep.glob("rank*_inc*.json"):
        d = json.loads(p.read_text())
        out[(d["rank"], d["restart_count"])] = d
    if with_output:
        from dlrover_tpu_torch.observability.events import read_events

        return out, proc.stdout + proc.stderr, read_events(str(events))
    return out


@functools.lru_cache(maxsize=None)
def _jax_losses(steps: int):
    """The JAX package's ``Trainer`` on the port's initial params
    (converted) and the example's batches."""
    from dlrover_tpu.accelerate import auto_accelerate
    from dlrover_tpu.accelerate.strategy import load_strategy
    from dlrover_tpu.models import llama as jl
    from dlrover_tpu.optimizers.agd import agd
    from dlrover_tpu.trainer.callbacks import TrainerCallback
    from dlrover_tpu.trainer.trainer import Trainer, TrainingArgs
    from dlrover_tpu_torch.examples import llama_pretrain as ex
    from dlrover_tpu_torch.models import llama as tl

    args = ex.parse_args(MODEL)
    tcfg = ex.model_config(args)
    tp = tl.init_params(tcfg, torch.Generator().manual_seed(0), "cpu",
                        dtype=torch.float32)

    def to_jax(node):
        if isinstance(node, dict):
            return {k: to_jax(v) for k, v in node.items()}
        return jnp.asarray(node.detach().numpy())

    jparams = to_jax(tp)
    jcfg = jl.LlamaConfig(
        vocab_size=tcfg.vocab_size, dim=tcfg.dim, n_layers=tcfg.n_layers,
        n_heads=tcfg.n_heads, n_kv_heads=tcfg.n_kv_heads,
        mlp_dim=tcfg.mlp_dim, max_seq_len=tcfg.max_seq_len,
        dtype=jnp.float32, remat="none")
    result = auto_accelerate(
        loss_fn=lambda p, b: jl.loss_fn(p, b, jcfg),
        optimizer=agd(3e-4),
        init_params_fn=lambda rng: jparams,
        param_axes=jl.param_logical_axes(jcfg),
        devices=jax.devices()[:1],
        load_strategy=load_strategy({"data": 1, "remat": "none"}),
    )

    def data_iter():
        # the JAX example's stream (examples/llama_pretrain.py)
        rng = np.random.default_rng(0)
        for _ in range(steps):
            yield {"tokens": rng.integers(
                0, tcfg.vocab_size, size=(args.batch, args.seq + 1),
                dtype=np.int32)}

    losses = []

    class Record(TrainerCallback):
        def on_step_end(self, step, metrics):
            losses.append((step, metrics["loss"]))

    Trainer(result, TrainingArgs(max_steps=steps, log_interval=100),
            data_iter, callbacks=[Record()]).train()
    return losses


@pytest.fixture(scope="module")
def base_run(tmp_path_factory):
    """The uninterrupted two-process run both crash runs are held to."""
    sockets = _short_tmp("dtb")
    root = tmp_path_factory.mktemp("base")
    try:
        yield _launch(root, sockets, crash=False), root / "ckpt"
    finally:
        shutil.rmtree(sockets, ignore_errors=True)


def test_worker_killed_mid_run_resumes_bit_for_bit(tmp_path, _port_sockets,
                                                   base_run):
    base, base_ckpt = base_run
    crash = _launch(tmp_path / "crash", _port_sockets, crash=True)
    assert set(base) == {(0, 0), (1, 0)}
    assert set(crash) == {(1, 0), (0, 1), (1, 1)}  # rank 0 was stopped
    assert crash[(1, 0)]["crash_step"] == 3
    for rank in (0, 1):
        b, c = base[(rank, 0)], crash[(rank, 1)]
        assert c["io_log"][0][:2] == ["restore_shm", 3]
        assert [h["step"] for h in c["history"]] == [4, 5, 6]
        key = [(h["step"], h["loss"], h["grad_norm"]) for h in c["history"]]
        assert key == [(h["step"], h["loss"], h["grad_norm"])
                       for h in b["history"][3:]]
        assert c["digests"] == b["digests"]
        assert c["summary"]["final_step"] == 6
    # the ranks trained the same replica on the same batches
    assert base[(0, 0)]["digests"] == base[(1, 0)]["digests"]
    assert not [n for n in os.listdir("/dev/shm")
                if n.startswith("dlrover_tpu_torch_ckpt_")
                and n.split("_")[-2] in (
                    _engine_name(base_ckpt),
                    _engine_name(tmp_path / "crash" / "ckpt"))]
    want = _jax_losses(6)
    assert [s for s, _ in want] == list(range(1, 7))
    np.testing.assert_allclose([h["loss"] for h in base[(0, 0)]["history"]],
                               [v for _, v in want], atol=ATOL, rtol=0)


def test_prefork_restart_through_the_prefetch_resumes_bit_for_bit(
        tmp_path, _port_sockets, base_run):
    """``--prefork --network_check``, the overlap on: the crash run of
    the test above with every worker forked from the agent's zygote."""
    base, _ckpt = base_run
    crash, out, evs = _launch(
        tmp_path / "crash", _port_sockets, crash=True,
        flags=("--prefork", "--network_check"), with_output=True)
    assert set(crash) == {(1, 0), (0, 1), (1, 1)}
    for rep in crash.values():
        assert rep["entry"] == {
            "spawn": "zygote", "spawned_at": rep["entry"]["spawned_at"],
            "torch_preloaded": True, "cuda_initialized": False}
    assert "plain spawn" not in out
    # the node check ran before both rendezvous, and the master found
    # no fault
    assert out.count("master verdict: fault nodes [] (normal)") == 2
    for rank in (0, 1):
        b, c = base[(rank, 0)], crash[(rank, 1)]
        assert c["io_log"][0][:2] == ["restore_shm", 3]
        key = [(h["step"], h["loss"], h["grad_norm"]) for h in c["history"]]
        assert key == [(h["step"], h["loss"], h["grad_norm"])
                       for h in b["history"][3:]]
        assert c["digests"] == b["digests"]
        m = c["marks"]
        # the staging overlapped the state build
        assert m["prefetch_start"] < m["state_built"]
        assert m["state_build_start"] < m["prefetch_end"]
        pid = c["pid"]
        spans = {e["name"]: e for e in evs if e.get("pid") == pid
                 and e["name"] in ("restore_prefetch", "finish_restore")}
        assert spans["restore_prefetch"]["labels"]["bytes"] == c[
            "io_log"][0][2]
        assert spans["finish_restore"]["labels"]["step"] == 3
        # the restarted steps are the JAX Trainer's
        np.testing.assert_allclose(
            [h["loss"] for h in c["history"]],
            [v for _, v in _jax_losses(6)[3:]], atol=ATOL, rtol=0)


def _engine_name(ckpt_dir) -> str:
    import hashlib

    return "d" + hashlib.sha1(
        os.path.abspath(str(ckpt_dir)).encode()).hexdigest()[:8]


@pytest.mark.parametrize("repeat", [False, True])
def test_example_batches_are_the_jax_example_s_stream(repeat):
    from dlrover_tpu_torch.examples import llama_pretrain as ex

    args = ex.parse_args(MODEL + (["--repeat_batch"] if repeat else []))
    vocab = ex.model_config(args).vocab_size
    # examples/llama_pretrain.py: one default_rng(0), int32 draws
    rng = np.random.default_rng(0)
    jax_stream = [rng.integers(0, vocab, size=(args.batch, args.seq + 1),
                               dtype=np.int32) for _ in range(6)]
    if repeat:
        jax_stream = [jax_stream[0]] * 6
    for done in (0, 3):
        stream = ex.batches(done, args, vocab)
        got = [next(stream)["tokens"] for _ in range(6 - done)]
        for a, b in zip(got, jax_stream[done:]):
            assert a.dtype == np.int32 and np.array_equal(a, b)


def test_leaf_digests_see_one_flipped_byte():
    from dlrover_tpu_torch.accelerate import auto_accelerate
    from dlrover_tpu_torch.examples.llama_pretrain import leaf_digests
    from dlrover_tpu_torch.models import llama as tl
    from dlrover_tpu_torch.optimizers import AGD

    cfg = tl.LlamaConfig.tiny(dtype=torch.float32)
    result = auto_accelerate(
        loss_fn=lambda p, b: tl.loss_fn(p, b, cfg),
        optimizer=lambda ps: AGD(ps, lr=1e-3),
        init_params_fn=lambda gen, dev: tl.init_params(
            cfg, gen, dev, dtype=torch.float32),
        device="cpu")
    state = result.fns.init_state(0)
    before = leaf_digests(state)
    assert before == leaf_digests(result.fns.init_state(0))
    assert before["['step']"] == "0"
    with torch.no_grad():
        state["params"]["layers"]["wq"].view(-1).view(torch.uint8)[-1] ^= 0xFF
    after = leaf_digests(state)
    assert [k for k in before if before[k] != after[k]] == [
        "['params']['layers']['wq']"]


# ------------------------------- A3c: the reference's defaults, and raising


def test_a3c_switches_default_off(monkeypatch):
    """The port's defaults: the observatory, the self-telemetry and the
    Brain on, as the reference's are; the live profiler off (ROADMAP
    A7: the reference's default is on); with no Brain db the master is
    incarnation 0 and fences nothing."""
    from dlrover_tpu_torch.master.auto_scaler import BrainAutoScaler

    for name in (env.OBSERVATORY_ENV, env.PROFILE_ENV, env.BRAIN_ENV,
                 env.SELF_OBS_ENV, "DLROVER_TPU_BRAIN_DB",
                 "DLROVER_TPU_STATUS_PORT"):
        monkeypatch.delenv(name, raising=False)
    assert env.observatory_enabled() and env.self_obs_enabled()
    assert env.brain_enabled() and not env.profile_enabled()
    # the client's reconnect and epochs stay on
    assert env.master_failover_enabled()
    # the agent's switches take the reference's defaults: the watcher
    # and the restart overlap on, the zygote and the node check off
    config = ElasticLaunchConfig()
    assert not (config.prefork or config.network_check)
    assert config.watch_preemption and config.restart_overlap
    m = LocalJobMaster(get_free_port())
    assert m.health_engine is not None and m.master_telemetry is not None
    assert isinstance(m.brain, BrainAutoScaler)
    assert m.capture_coordinator is None
    assert m.job_epoch == 0 and m.incarnation == 0


@pytest.mark.parametrize("name,value", [
    ("DLROVER_TPU_PROFILE", "1"),
])
def test_a3c_master_subsystems_raise(monkeypatch, name, value):
    monkeypatch.setenv(name, value)
    with pytest.raises(NotImplementedError, match="ROADMAP A"):
        LocalJobMaster(get_free_port())


@pytest.fixture
def fresh_datastore(monkeypatch):
    """No process datastore before the case, and none left after it."""
    from dlrover_tpu_torch.master import datastore

    monkeypatch.setattr(datastore, "_default_store", None)
    yield
    if datastore._default_store is not None:
        datastore._default_store.close()
    datastore._default_store = None


@pytest.mark.parametrize("name", [
    "DLROVER_TPU_OBSERVATORY", "DLROVER_TPU_SELF_OBS",
    "DLROVER_TPU_BRAIN_DB", "DLROVER_TPU_STATUS_PORT",
])
def test_a3c3ab_switch_builds_its_subsystem(monkeypatch, tmp_path,
                                           fresh_datastore, name):
    """Each switch that raised before A3c.3a/b builds what the reference
    builds behind it."""
    from dlrover_tpu_torch.master.datastore import BrainDatastore
    from dlrover_tpu_torch.master.diagnosis import DiagnosisManager
    from dlrover_tpu_torch.master.failover import ControlPlaneJournal
    from dlrover_tpu_torch.observability.health import (
        HealthEngine,
        MasterHealth,
    )
    from dlrover_tpu_torch.observability.self_telemetry import (
        MasterSelfTelemetry,
    )
    from dlrover_tpu_torch.observability.status_server import StatusServer

    for other in ("DLROVER_TPU_BRAIN_DB", "DLROVER_TPU_STATUS_PORT"):
        monkeypatch.delenv(other, raising=False)
    value = {"DLROVER_TPU_BRAIN_DB": str(tmp_path / "brain.db"),
             "DLROVER_TPU_STATUS_PORT": "0"}.get(name, "1")
    monkeypatch.setenv(name, value)
    m = LocalJobMaster(get_free_port())
    m.prepare()
    try:
        if name == "DLROVER_TPU_OBSERVATORY":
            assert isinstance(m.health_engine, HealthEngine)
            assert m.timeline_aggregator._health is m.health_engine
            assert isinstance(m.diagnosis_manager, DiagnosisManager)
            assert m.diagnosis_manager._health is m.health_engine
        elif name == "DLROVER_TPU_SELF_OBS":
            assert isinstance(m.master_telemetry, MasterSelfTelemetry)
            assert isinstance(m.master_health, MasterHealth)
            assert m._servicer._telemetry is m.master_telemetry
        elif name == "DLROVER_TPU_BRAIN_DB":
            assert isinstance(m.control_journal, ControlPlaneJournal)
            assert isinstance(m.timeline_aggregator._datastore,
                              BrainDatastore)
            assert (m.job_epoch, m.incarnation) == (1, 1)
            assert (m._servicer.job_epoch, m._servicer.incarnation) == (1, 1)
        else:
            assert isinstance(m.status_server, StatusServer)
            assert m.status_server.port > 0
    finally:
        m.stop()


def test_a3c_agent_and_launcher_options_raise(client, tmp_path):
    """The zygote, the watcher and the node check run (their own tests);
    the deep capture (A7) still raises."""
    from dlrover_tpu_torch.master import main as master_main

    script = _write_script(tmp_path, "raise SystemExit(0)\n")
    agent = _agent(client, script, nproc=1)
    agent._config.watch_preemption = True
    assert agent.run() == 0
    with pytest.raises(NotImplementedError, match="ROADMAP A7"):
        agent._start_capture("hang", 1)
    # the k8s master is built now; without the kubernetes package it
    # raises that package's ImportError
    with pytest.raises(ImportError, match="kubernetes"):
        master_main.main(["--platform", "k8s"])


# ------------------------------------------- the worker's drain and hang


def test_drain_request_snapshots_every_step_blocking(tmp_path):
    """After the agent's SIGUSR1 the ``Trainer`` snapshots every step and
    waits for each to be in shm, whatever ``save_memory_interval``."""
    import signal

    from dlrover_tpu_torch.accelerate import auto_accelerate
    from dlrover_tpu_torch.models import llama as tl
    from dlrover_tpu_torch.optimizers import AGD
    from dlrover_tpu_torch.trainer import Trainer, TrainingArgs
    from dlrover_tpu_torch.trainer import drain

    cfg = tl.LlamaConfig.tiny(dtype=torch.float32)
    result = auto_accelerate(
        loss_fn=lambda p, b: tl.loss_fn(p, b, cfg),
        optimizer=lambda ps: AGD(ps, lr=1e-3),
        init_params_fn=lambda gen, dev: tl.init_params(
            cfg, gen, dev, dtype=torch.float32),
        device="cpu")
    batch = {"tokens": np.random.default_rng(0).integers(
        0, cfg.vocab_size, (2, 9)).astype(np.int32)}

    def data_iter():
        while True:
            yield batch

    ckpt = _short_tmp("dtc")
    trainer = Trainer(result, TrainingArgs(
        max_steps=3, checkpoint_dir=ckpt, save_memory_interval=100,
        save_storage_interval=100), data_iter)
    try:
        os.kill(os.getpid(), drain.DRAIN_SIGNAL)
        assert drain.drain_requested()
        trainer.train()
    finally:
        drain.reset_drain()
        signal.signal(drain.DRAIN_SIGNAL, signal.SIG_DFL)
        shutil.rmtree(ckpt, ignore_errors=True)
    # every step, each a blocking save
    assert [(s["step"], s["mode"], s["saved"]) for s in
            trainer.save_times] == [(1, "copy", True), (2, "copy", True),
                                    (3, "copy", True)]
    assert [r[:2] for r in trainer.checkpoint_engine.io_log[:3]] == [
        ("drain", 1), ("drain", 2), ("drain", 3)]
    assert trainer.progress.global_step == 3


def test_hang_detector_fires_and_the_default_action_exits():
    import threading

    from dlrover_tpu_torch.trainer import fault_tolerance as ft

    fired = threading.Event()
    det = ft.HangDetector(timeout=0.2, check_interval=0.05,
                          on_hang=fired.set)
    det.start()
    try:
        det.report_step(1)
        assert fired.wait(5) and det.hang_detected
    finally:
        det.stop()
    proc = subprocess.run(
        [sys.executable, "-c",
         "from dlrover_tpu_torch.trainer.fault_tolerance import "
         "default_hang_action; default_hang_action()"],
        cwd=REPO, capture_output=True, text=True, timeout=120,
        env=dict(os.environ, PYTHONPATH=str(REPO),
                 DLROVER_TPU_MASTER_ADDR=""))
    assert proc.returncode == ft.HANG_EXIT_CODE, proc.stderr[-2000:]
