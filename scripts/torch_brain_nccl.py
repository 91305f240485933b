"""The Brain on two cards: a node slowed mid-run is branded a straggler,
drained by one planned action, and the job finishes on the other card,
or, where the master has a scaler, grows back to two.

The grow run (first; ``--skip-grow`` leaves it out) holds its master in
this process: a ``DistributedJobMaster`` with an ``ElasticJobScaler``,
and an ``ElasticJobController``, over one ``FakeK8s`` client, so that
only the k8s API is faked.  The ElasticJob's worker template is one
launcher of the example on one card (``$(NODE_RANK)``, ``$(CARD)``), and
the client starts a worker pod once a card is free, as the device
plugin would; ``delete_pod`` sends the launcher SIGTERM.  The master's
start writes a ScalePlan of two workers, which the controller turns
into the two first pods; the Brain's ``drain_replace`` of the slowed
node (2 -> 2: with a scaler it replaces) writes a second, migrating the
drained pod, and the controller creates its replacement (node 2, whose
pod asks for ``nvidia.com/gpu``) on the freed card.  The run requires
exactly one decision, the two ScalePlans applied, the replacement
launched and at world 2 with node 0, the two replicas' digests equal at
every step both took after the grow (``--digest_every_incarnation``)
and their states at the end, and a two-card run resumed from a copy of
the checkpoint the grow restored bit for bit with them; it prints the
decision -> the replacement's launch -> its first step at world 2 and
the wall to the target step.  The replacement comes once node 0 has
re-meshed into the world of 1 the drain leaves (the Brain's pod-side
leg waits for that), so node 0's next restart commits a step of that
world, which both restore; the launchers wait 30 s in the rendezvous
(5 s on gloo), so the replacement waits out node 0's restart (~11 s on
the cards) instead of forming a world alone; its Brain cools down 120 s (the
default), so the world of 1 is not grown by a decision of its own.

``--slow-rank`` (1 by default) is the node slowed, and drained, in every
run; with 0 the survivor is node 1, whose index in the world moves to
0 (C10: it must resume from its own newest snapshot, at or past the
last step both nodes snapshotted).

One master (``python -m dlrover_tpu_torch.master.main --node_num 2``,
a Brain db, ``--status_port 0``) on timescales that are not the port's
defaults: the reference's chaos run (``scripts/chaos.py``
``run_slow_node``) decides every 0.5 s (default 30), cools down 5 s
(default 120), sustains a verdict over 2 cycles (the default) and
brands at a ratio of 2.0 (default 1.5), with a commit timeout of 3 s
(default 20); this script departs from that run too, with a fence of
120 s (chaos 8, default 30), which the cards' re-mesh outlasts, a drain
grace of 15 s (chaos 2, default 5) and an execution deadline of 60 s
(default 20), which an 8 GB flush outlasts.  No run of it used the
defaults.  Two launchers (``python -m dlrover_tpu_torch.run --nnodes=1:2
--nproc_per_node=1``, node ranks 0 and 1, node ``n`` on ``cuda:n``) of
the port's ``llama_pretrain`` at Llama-2-7B widths, 2 layers, a global
batch of 4 x 2048, ``--data 2``, a snapshot every step.  Every rank
sleeps ``--step-sleep`` seconds after each step (simulated work) and
node 1 sleeps ``--slow-factor`` times that from step ``--slow-from`` on
(the example's sleep fault).

Run 1 (the Brain on, its default, no scaler) requires, with the slow
node ``--slow-rank`` 1: node 1 branded a straggler
on the master's ``/status``; exactly one ``scale_decision``
(``drain_replace`` of node 1, reason ``straggler:...``, world 2 -> 1);
node 1's launcher exits with ``NODE_PREEMPTED`` (43); ``scale_execute``
closes with outcome ``done``; node 0 restarts into a world of 1,
restores a step at or past the step node 1 flushed, and finishes the
target steps. Then three readings of the states, by the example's
``--state_digests`` (``pytree_digest``; both nodes also digest every
snapshot of the first world from the slowdown on, outside the step
span): a one-card run restores a copy of node 1's drained flush (its
shard alone, so through ``reshard``, 2 -> 1) and must equal node 1's
state at that step; node 0's restored state must equal the world of 2's
digest of that step, which must exist, and the two nodes' digests must
agree at every step both took; and a one-card run resumed from a copy of
node 0's own flush of the step it restored must run the following steps
bit for bit with node 0. Run 2 (``DLROVER_TPU_BRAIN=0``; ``--skip-off``
leaves it out) requires no decision and both nodes slow to the end.
Prints both runs' wall times, node 0's step times before the slowdown,
during it and after the drain, the drain's timeline, and the card's
name and power limit.  The runs
live under ``build/brain_nccl/``, their logs go to
``chiprun_out/brain_nccl/``.

    python3 scripts/torch_brain_nccl.py                 # two cards
    python3 scripts/torch_brain_nccl.py --device cpu    # gloo, no card
    python3 scripts/torch_brain_nccl.py --slow-rank 0 --skip-grow
"""

import argparse
import copy
import json
import os
import re
import shutil
import signal
import statistics
import subprocess
import sys
import tempfile
import threading
import time
import urllib.request
from pathlib import Path

REPO = Path(__file__).resolve().parents[1]
JOB = "brain-smoke"
#: the reference's chaos timescales (scripts/chaos.py run_slow_node),
#: not the defaults, and for the fence not those either: chaos's 8 s
#: (the default is 30) ran out before node 0 had re-meshed on the cards
#: (an 8 GB flush, a worker wedged in NCCL until the drain grace), and
#: the Brain, seeing node 1 in the world again, drained it again
BRAIN_ENV = {"DLROVER_TPU_BRAIN_INTERVAL_S": "0.5",
             "DLROVER_TPU_BRAIN_COOLDOWN_S": "5",
             "DLROVER_TPU_BRAIN_SUSTAIN": "2",
             "DLROVER_TPU_STRAGGLER_RATIO": "2.0",
             "DLROVER_TPU_FENCE_TTL_S": "120",
             # the drained node's drain-mode snapshot (after the digest
             # of the step before it) and its 8 GB flush outlast the
             # default 20 s on two H100s, and the master fenced it instead
             "DLROVER_TPU_BRAIN_EXEC_DEADLINE_S": "60"}
#: the grow run's Brain: those timescales with the default cooldown
#: (120 s), so that the world of 1 the drain leaves, while the
#: replacement starts, is not grown a second time by a decision of its own
GROW_ENV = dict(BRAIN_ENV, DLROVER_TPU_BRAIN_COOLDOWN_S="120",
                # a replacing drain is done once node 0 has re-meshed,
                # 45-58 s after the decision on the cards (PRs 15-16)
                DLROVER_TPU_BRAIN_EXEC_DEADLINE_S="120")
GROW_JOB = "brain-grow"
NODE_PREEMPTED = 43
CARD_MODEL = ["--config", "llama2_7b", "--layers", "2", "--seq", "2048",
              "--batch", "4"]
CPU_MODEL = ["--dim", "64", "--layers", "2", "--heads", "4", "--seq", "32",
             "--batch", "4", "--dtype", "float32", "--device", "cpu"]


def require(ok, what):
    if not ok:
        raise SystemExit(f"FAIL: {what}")


def _stop(proc, grace=15.0):
    """End a process started in its own session, and its session."""
    if proc.poll() is None:
        try:
            os.killpg(proc.pid, signal.SIGTERM)
        except ProcessLookupError:
            pass
        try:
            proc.wait(timeout=grace)
        except subprocess.TimeoutExpired:
            pass
    try:
        os.killpg(proc.pid, signal.SIGKILL)
    except ProcessLookupError:
        pass
    proc.wait()


class Master:
    """The job's master, its ``/status`` polled every half second."""

    def __init__(self, run_dir: Path, env: dict, log_dir: Path):
        from dlrover_tpu_torch.common.env import get_free_port

        self.port = get_free_port()
        self.addr = f"127.0.0.1:{self.port}"
        self.events = run_dir / "master_events.jsonl"
        self.log = log_dir / f"{run_dir.name}_master.log"
        env = dict(env, DLROVER_TPU_EVENTS_FILE=str(self.events))
        with open(self.log, "w") as f:
            self.proc = subprocess.Popen(
                [sys.executable, "-m", "dlrover_tpu_torch.master.main",
                 "--port", str(self.port), "--node_num", "2",
                 "--brain_db", str(run_dir / "brain.db"),
                 "--status_port", "0", "--job_name", JOB],
                cwd=REPO, env=env, stdout=f, stderr=subprocess.STDOUT,
                start_new_session=True)
        self.poller = StatusPoller(self._base)
        self.status = self.poller.status

    def _base(self):
        m = re.search(r"DLROVER_TPU_STATUS_PORT=(\d+)", self.log.read_text())
        return None if m is None else f"http://127.0.0.1:{m.group(1)}"

    def stop(self):
        self.poller.stop()
        _stop(self.proc)


class StatusPoller:
    """A master's ``/status``, read every half second from the moment
    ``base_fn()`` names its address."""

    def __init__(self, base_fn):
        self._base_fn = base_fn
        #: every /status read, with the wall clock it was taken at
        self.status = []
        self._stop = threading.Event()
        self._thread = threading.Thread(target=self._poll, daemon=True)
        self._thread.start()

    def _poll(self):
        base = None
        while not self._stop.wait(0.5):
            if base is None:
                base = self._base_fn()
                if base is None:
                    continue
            try:
                status = json.loads(urllib.request.urlopen(
                    base + "/status", timeout=2).read().decode())
            except OSError:
                continue
            self.status.append((time.time(), status))

    def stop(self):
        self._stop.set()
        self._thread.join(timeout=5)


def launch_node(run_dir: Path, log_dir: Path, node: int, master: Master,
                model, args, extra_env, digests):
    """One launcher of one node; returns its Popen.  With ``digests`` the
    example reports its restored state's digest, and those of its
    drain-mode snapshots and of every snapshot of the first world from
    the slowdown on."""
    sock = tempfile.mkdtemp(prefix=f"dtb{node}", dir="/tmp")
    env = dict(os.environ, **extra_env,
               PYTHONPATH=str(REPO), DLROVER_TPU_TORCH_SOCKET_DIR=sock,
               # the preemption watcher asks a port on this machine that
               # refuses connections, never a real metadata server
               DLROVER_TPU_METADATA_BASE="http://127.0.0.1:9/",
               DLROVER_TPU_TIMELINE_REPORT_S="1.0",
               # the drained node's fresh snapshot lands within a step;
               # a survivor wedged in a collective waits it out whole
               # (chaos 2 s, default 5)
               DLROVER_TPU_PREEMPT_DRAIN_GRACE_S="15",
               DLROVER_TPU_EMERGENCY_COMMIT_TIMEOUT_S="3")
    device = ["--device", f"cuda:{node}"]
    if args.device == "cpu":
        env["OMP_NUM_THREADS"] = "1"
        device = []
    cmd = [sys.executable, "-m", "dlrover_tpu_torch.run", "--nnodes=1:2",
           "--nproc_per_node=1", f"--node_rank={node}",
           f"--master_addr={master.addr}", "--max-restarts=2",
           "--monitor_interval=0.5", "--rdzv_waiting_timeout=2",
           "--failure_stop_timeout=2",
           f"--events_file={run_dir / f'events_node{node}.jsonl'}",
           "-m", "dlrover_tpu_torch.examples.llama_pretrain", *model,
           *device, "--steps", str(args.steps), "--data", "2",
           "--save_memory_interval", "1", "--save_storage_interval", "1000",
           "--ckpt_dir", str(run_dir / "ckpt"),
           "--report_dir", str(run_dir / "rep"),
           "--step_sleep", str(args.step_sleep),
           "--slow_from_step", str(args.slow_from),
           "--slow_rank", str(args.slow_rank),
           "--slow_factor", str(args.slow_factor)]
    if digests:
        cmd += ["--state_digests", "--digest_from_step", str(args.slow_from)]
    log = open(log_dir / f"{run_dir.name}_node{node}.log", "w")
    proc = subprocess.Popen(cmd, cwd=REPO, env=env, stdout=log,
                            stderr=subprocess.STDOUT,
                            start_new_session=True)
    proc.sock, proc.logf = sock, log
    return proc


def reports(run_dir: Path):
    out = {}
    for p in (run_dir / "rep").glob("rank*_inc*.json"):
        d = json.loads(p.read_text())
        out[(d["rank"], d["restart_count"])] = d
    return out


def run_job(root: Path, log_dir: Path, name: str, brain: bool, model,
            args):
    """One job of two nodes; returns its readings."""
    from dlrover_tpu_torch.observability.events import read_events

    run_dir = root / name
    (run_dir / "rep").mkdir(parents=True)
    env = dict(os.environ, PYTHONPATH=str(REPO), **BRAIN_ENV,
               DLROVER_TPU_BRAIN="1" if brain else "0")
    master = Master(run_dir, env, log_dir)
    nodes, exits = [], {}
    t0 = time.time()
    try:
        for node in (0, 1):
            nodes.append(launch_node(run_dir, log_dir, node, master, model,
                                     args, {"DLROVER_TPU_BRAIN": env[
                                         "DLROVER_TPU_BRAIN"]}, brain))
        deadline = t0 + args.timeout
        while len(exits) < 2:
            require(time.time() < deadline, f"{name}: timed out")
            require(master.proc.poll() is None, f"{name}: the master died")
            for node, proc in enumerate(nodes):
                if node not in exits and proc.poll() is not None:
                    exits[node] = (proc.returncode, time.time())
            time.sleep(0.1)
    finally:
        for proc in nodes:
            _stop(proc)
            proc.logf.close()
            shutil.rmtree(proc.sock, ignore_errors=True)
        master.stop()
    evs = read_events(str(master.events))
    node_evs = {n: read_events(str(run_dir / f"events_node{n}.jsonl"))
                for n in (0, 1)}
    return {"t0": t0, "exits": exits, "reports": reports(run_dir),
            "master_events": evs, "node_events": node_evs,
            "status": master.status, "dir": run_dir}


def _named(evs, name):
    return [e for e in evs if e["name"] == name]


def stretches(hist, slow_from, slow_after=None):
    """Median step seconds (card clock) of node 0's history by stretch."""
    def med(xs):
        return round(statistics.median(xs), 6) if xs else None

    before = [h["step_time_s"] for h in hist if 1 < h["step"] < slow_from]
    during = [h["step_time_s"] for h in hist if h["step"] >= slow_from
              and (slow_after is None or h["step"] <= slow_after)]
    return med(before), med(during)


def one_card_run(root: Path, log_dir: Path, name: str, ckpt: Path, steps,
                 model, args):
    """The example on one card (no launcher), resumed from ``ckpt`` and
    trained to ``steps``; returns its report and its events."""
    from dlrover_tpu_torch.observability.events import read_events

    rep = root / f"{name}_rep"
    rep.mkdir(parents=True)
    events = root / f"{name}_events.jsonl"
    env = dict(os.environ, PYTHONPATH=str(REPO),
               DLROVER_TPU_EVENTS_FILE=str(events))
    device = ["--device", "cuda:0"]
    if args.device == "cpu":
        env["OMP_NUM_THREADS"] = "1"
        device = []
    cmd = [sys.executable, "-m", "dlrover_tpu_torch.examples.llama_pretrain",
           *model, *device, "--steps", str(steps), "--data", "2",
           "--save_memory_interval", "1000",
           "--save_storage_interval", "1000", "--ckpt_dir", str(ckpt),
           "--report_dir", str(rep), "--state_digests"]
    proc = subprocess.run(cmd, cwd=REPO, env=env, capture_output=True,
                          text=True, timeout=args.timeout)
    (log_dir / f"{name}.log").write_text(proc.stdout + proc.stderr)
    require(proc.returncode == 0, f"the one-card run {name} failed:\n"
            + (proc.stdout + proc.stderr)[-3000:])
    return (json.loads((rep / "rank0_inc0.json").read_text()),
            read_events(str(events)))


def flushed_shards(run_dir: Path, shard: int):
    """``{step: dir}`` of every flush that holds ``shard_<shard>``: the
    committed dirs and the stage dirs a commit never published."""
    from dlrover_tpu_torch.common.constants import CheckpointConstant as C

    ckpt = run_dir / "ckpt"
    out = {}
    for parent in (ckpt / C.STAGE_DIR, ckpt):
        for d in parent.glob(f"{C.CKPT_DIR_PREFIX}*"):
            if (d / f"shard_{shard}.drckpt").exists():
                out[int(d.name[len(C.CKPT_DIR_PREFIX):])] = d
    return out


def copy_shard(src: Path, shard: int, step: int, dest: Path):
    """A checkpoint dir of ``step`` holding only ``shard_<shard>`` of
    ``src``, committed (its tracker names it)."""
    from dlrover_tpu_torch.common.constants import CheckpointConstant as C

    (dest / f"{C.CKPT_DIR_PREFIX}{step}").mkdir(parents=True)
    shutil.copy(src / f"shard_{shard}.drckpt",
                dest / f"{C.CKPT_DIR_PREFIX}{step}")
    (dest / C.TRACKER_FILE).write_text(str(step))


class FakeK8s:
    """The k8s API of the grow run, inside this process: the one client
    that the master's ``ElasticJobScaler`` and the ``ElasticJobController``
    share.  Custom resources are dicts.  A worker pod is a launcher on one
    card: ``create_pod`` queues it, and it starts once a card is free (the
    device plugin's part: a card is free when the launcher that held it
    has exited), with its container's command and env, ``$(VAR)``
    expanded from the env as k8s does and ``CARD`` naming the card it got.
    ``delete_pod`` sends the pod's launcher SIGTERM.  The master's pod is
    this process: it is listed and never launched."""

    def __init__(self, cards, log_dir: Path, run: str, env: dict):
        self.pods = {}
        self.crds = {"elasticjobs": {}, "scaleplans": {}}
        self.procs = {}
        self.card = {}
        #: pod name -> wall time of its launch / deletion / exit seen
        self.launched, self.deleted, self.exited = {}, {}, {}
        self._free = list(cards)
        self._pending = []
        self._lock = threading.Lock()
        self._log_dir, self._run, self._env = log_dir, run, env
        self._stopped = threading.Event()
        self._thread = threading.Thread(target=self._schedule, daemon=True)
        self._thread.start()

    def create_pod(self, manifest):
        name = manifest["metadata"]["name"]
        with self._lock:
            self.pods[name] = copy.deepcopy(manifest)
            if manifest["metadata"]["labels"].get("node-type") == "worker":
                self._pending.append(name)

    def delete_pod(self, name):
        with self._lock:
            self.pods.pop(name, None)
            self.deleted[name] = time.time()
            proc = self.procs.get(name)
        if proc is not None and proc.poll() is None:
            proc.send_signal(signal.SIGTERM)

    def list_pods(self, label_selector=""):
        want = dict(kv.split("=") for kv in label_selector.split(",") if kv)
        with self._lock:
            return {"items": [
                copy.deepcopy(p) for p in self.pods.values()
                if all(p["metadata"]["labels"].get(k) == v
                       for k, v in want.items())]}

    def create_custom_resource(self, group, version, plural, body):
        with self._lock:
            body = copy.deepcopy(body)
            body["metadata"].setdefault(
                "uid", f"uid-{plural}-{len(self.crds[plural])}")
            self.crds[plural][body["metadata"]["name"]] = body

    def list_custom_resource(self, group, version, plural):
        with self._lock:
            return {"items": [copy.deepcopy(v)
                              for v in self.crds[plural].values()]}

    def update_custom_resource_status(self, group, version, plural, name,
                                      body):
        with self._lock:
            self.crds[plural][name].setdefault("status", {}).update(
                copy.deepcopy(body["status"]))

    def _schedule(self):
        while not self._stopped.wait(0.2):
            with self._lock:
                for name, proc in self.procs.items():
                    if proc.poll() is not None:
                        self.exited.setdefault(name, time.time())
                        if name in self.card:
                            self._free.append(self.card.pop(name))
                while self._pending and self._free:
                    name = self._pending.pop(0)
                    self.card[name] = self._free.pop(0)
                    self.procs[name] = self._launch(name, self.card[name])
                    self.launched[name] = time.time()

    def _launch(self, name, card):
        container = self.pods[name]["spec"]["containers"][0]
        sock = tempfile.mkdtemp(prefix=f"dtg{card}", dir="/tmp")
        env = dict(self._env, CARD=str(card),
                   DLROVER_TPU_TORCH_SOCKET_DIR=sock)
        env.update({e["name"]: e["value"] for e in container.get("env", [])})
        cmd = [re.sub(r"\$\((\w+)\)", lambda m: env[m.group(1)], a)
               for a in container["command"]]
        log = open(self._log_dir / f"{self._run}_{name}.log", "w")
        proc = subprocess.Popen(cmd, cwd=REPO, env=env, stdout=log,
                                stderr=subprocess.STDOUT,
                                start_new_session=True)
        proc.sock, proc.logf = sock, log
        return proc

    def exits(self):
        """``{pod: returncode}`` of the launchers that have exited."""
        with self._lock:
            return {n: p.returncode for n, p in self.procs.items()
                    if p.poll() is not None}

    def idle(self) -> bool:
        with self._lock:
            return not self._pending and all(
                p.poll() is not None for p in self.procs.values())

    def close(self):
        self._stopped.set()
        self._thread.join(timeout=5)
        for proc in self.procs.values():
            _stop(proc)
            proc.logf.close()
            shutil.rmtree(proc.sock, ignore_errors=True)


def elastic_job(run_dir: Path, master_addr: str, model, args) -> dict:
    """The grow run's ElasticJob: its worker template is one launcher of
    the example on one card, which asks for that card."""
    device = [] if args.device == "cpu" else ["--device", "cuda:$(CARD)"]
    command = [
        sys.executable, "-m", "dlrover_tpu_torch.run", "--nnodes=1:2",
        "--nproc_per_node=1", "--node_rank=$(NODE_RANK)",
        f"--master_addr={master_addr}", "--max-restarts=2",
        "--monitor_interval=0.5",
        # the replacement waits this long in the rendezvous for node 0,
        # whose restart (drain, flush, commit) takes ~11 s on the cards
        # and ~3 s on gloo: at 2 s it formed a world of its own from
        # step 0 meanwhile
        f"--rdzv_waiting_timeout={5 if args.device == 'cpu' else 30}",
        "--failure_stop_timeout=2",
        f"--events_file={run_dir}/events_node$(NODE_RANK).jsonl",
        "-m", "dlrover_tpu_torch.examples.llama_pretrain", *model, *device,
        "--steps", str(args.steps), "--data", "2",
        "--save_memory_interval", "1", "--save_storage_interval", "1000",
        "--ckpt_dir", str(run_dir / "ckpt"),
        "--report_dir", f"{run_dir}/rep/node$(NODE_RANK)",
        "--step_sleep", str(args.step_sleep),
        "--slow_from_step", str(args.slow_from),
        "--slow_rank", str(args.slow_rank),
        "--slow_factor", str(args.slow_factor),
        "--state_digests", "--digest_from_step", str(args.slow_from),
        "--digest_every_incarnation"]
    return {
        "apiVersion": "elastic.dlrover-tpu.io/v1alpha1",
        "kind": "ElasticJob",
        "metadata": {"name": GROW_JOB, "uid": "grow-1"},
        "spec": {"replicaSpecs": {"worker": {"replicas": 2, "template": {
            "spec": {"containers": [{
                "name": "worker", "image": "local",
                "command": command,
                "resources": {"limits": {"nvidia.com/gpu": 1}}}]}}}}}}


def run_grow(root: Path, log_dir: Path, model, args):
    """The grow run: the master of this process (``DistributedJobMaster``
    with an ``ElasticJobScaler``) and an ``ElasticJobController`` over one
    ``FakeK8s``; the master's start asks for the two workers, the
    controller makes their pods, and the drained node's replacement comes
    the same way.  Returns the readings."""
    from dlrover_tpu_torch.common.env import get_free_port
    from dlrover_tpu_torch.master.controller import (
        ELASTICJOB_PLURAL,
        GROUP,
        MASTER_SUFFIX,
        VERSION,
        ElasticJobController,
    )
    from dlrover_tpu_torch.master.master import DistributedJobMaster
    from dlrover_tpu_torch.master.scaler import ElasticJobScaler
    from dlrover_tpu_torch.observability.events import (
        read_events,
        set_default_event_logger,
    )

    run_dir = root / "brain_grow"
    for node in range(4):
        (run_dir / "rep" / f"node{node}").mkdir(parents=True)
    launcher_env = dict(
        os.environ, PYTHONPATH=str(REPO), DLROVER_TPU_BRAIN="1",
        # the preemption watcher asks a port on this machine that refuses
        # connections, never a real metadata server
        DLROVER_TPU_METADATA_BASE="http://127.0.0.1:9/",
        DLROVER_TPU_TIMELINE_REPORT_S="1.0",
        DLROVER_TPU_PREEMPT_DRAIN_GRACE_S="15",
        DLROVER_TPU_EMERGENCY_COMMIT_TIMEOUT_S="3")
    if args.device == "cpu":
        launcher_env["OMP_NUM_THREADS"] = "1"
    port = get_free_port()
    saved = dict(os.environ)
    # the master's environment: this process's
    os.environ.update(GROW_ENV, DLROVER_TPU_BRAIN="1",
                      DLROVER_TPU_JOB_NAME=GROW_JOB,
                      DLROVER_TPU_EVENTS_FILE=str(
                          run_dir / "master_events.jsonl"),
                      DLROVER_TPU_STATUS_PORT="0")
    # the master's timeline goes to its events file
    set_default_event_logger(None)
    client = FakeK8s((0, 1), log_dir, "brain_grow", launcher_env)
    client.create_custom_resource(
        GROUP, VERSION, ELASTICJOB_PLURAL,
        elastic_job(run_dir, f"127.0.0.1:{port}", model, args))
    # the master's pod is this process: the controller finds it
    client.pods[f"{GROW_JOB}{MASTER_SUFFIX}"] = {"metadata": {
        "name": f"{GROW_JOB}{MASTER_SUFFIX}",
        "labels": {"job": GROW_JOB, "node-type": "master"}}}
    master = DistributedJobMaster(
        port, 2, scaler=ElasticJobScaler(GROW_JOB, k8s_client=client))
    controller = ElasticJobController(client, resync_interval=0.5)
    poller = None
    t0 = time.time()
    try:
        master.prepare()
        controller.start()
        threading.Thread(target=master.run, daemon=True).start()
        poller = StatusPoller(
            lambda: f"http://127.0.0.1:{master.status_server.port}")
        deadline = t0 + args.timeout
        while not (client.launched and client.idle()):
            require(time.time() < deadline, "brain_grow: timed out")
            time.sleep(0.2)
        time.sleep(0.5)  # the scheduler's last exit times
        exits = client.exits()
    finally:
        controller.stop()
        if poller is not None:
            poller.stop()
        master.stop()
        client.close()
        os.environ.clear()
        os.environ.update(saved)
        set_default_event_logger(None)
    reports = {}
    for path in (run_dir / "rep").glob("node*/rank*_inc*.json"):
        d = json.loads(path.read_text())
        reports[(int(path.parent.name[4:]), d["restart_count"])] = d
    return {"t0": t0, "exits": exits, "reports": reports,
            "master_events": read_events(str(run_dir / "master_events.jsonl")),
            "node_events": {n: read_events(str(p)) for n, p in (
                (int(p.stem[len("events_node"):]), p)
                for p in run_dir.glob("events_node*.jsonl"))},
            "status": poller.status, "dir": run_dir, "client": client}


def two_card_run(root: Path, log_dir: Path, name: str, ckpt: Path, model,
                 args):
    """Two launchers of the example (Brain off, no slow node, no sleep),
    node n on card n, resumed from ``ckpt``; returns each node's report."""
    run_dir = root / name
    env = dict(os.environ, PYTHONPATH=str(REPO), DLROVER_TPU_BRAIN="0")
    master = Master(run_dir, env, log_dir)
    procs = []
    try:
        for node in (0, 1):
            rep = run_dir / f"rep{node}"
            rep.mkdir(parents=True)
            sock = tempfile.mkdtemp(prefix=f"dtr{node}", dir="/tmp")
            penv = dict(env, DLROVER_TPU_TORCH_SOCKET_DIR=sock,
                        DLROVER_TPU_METADATA_BASE="http://127.0.0.1:9/")
            device = ["--device", f"cuda:{node}"]
            if args.device == "cpu":
                penv["OMP_NUM_THREADS"] = "1"
                device = []
            cmd = [sys.executable, "-m", "dlrover_tpu_torch.run",
                   "--nnodes=2", "--nproc_per_node=1", f"--node_rank={node}",
                   f"--master_addr={master.addr}", "--max-restarts=0",
                   "--monitor_interval=0.5",
                   "-m", "dlrover_tpu_torch.examples.llama_pretrain", *model,
                   *device, "--steps", str(args.steps), "--data", "2",
                   "--save_memory_interval", "1000",
                   "--save_storage_interval", "1000",
                   "--ckpt_dir", str(ckpt), "--report_dir", str(rep),
                   "--state_digests"]
            log = open(log_dir / f"{name}_node{node}.log", "w")
            proc = subprocess.Popen(cmd, cwd=REPO, env=penv, stdout=log,
                                    stderr=subprocess.STDOUT,
                                    start_new_session=True)
            proc.sock, proc.logf = sock, log
            procs.append(proc)
        deadline = time.time() + args.timeout
        while any(p.poll() is None for p in procs):
            require(time.time() < deadline, f"{name}: timed out")
            time.sleep(0.2)
        require(all(p.returncode == 0 for p in procs),
                f"{name}: exits {[p.returncode for p in procs]}")
    finally:
        for proc in procs:
            _stop(proc)
            proc.logf.close()
            shutil.rmtree(proc.sock, ignore_errors=True)
        master.stop()
    return [json.loads(next((run_dir / f"rep{n}").glob(
        "rank*_inc0.json")).read_text()) for n in (0, 1)]


def check_grow(r, root, logs, model, args, card):
    """The grow run's readings: one decision, the replacement through
    ScalePlan -> controller -> pod, the world back at 2, the replicas
    equal, and bit for bit with two cards resumed from the checkpoint the
    grow restored."""
    from dlrover_tpu_torch.common.constants import CheckpointConstant as C
    from dlrover_tpu_torch.master.controller import SCALEPLAN_PLURAL

    slow = args.slow_rank
    client = r["client"]
    pod = lambda n: f"{GROW_JOB}-worker-{n}"  # noqa: E731
    evs = r["master_events"]
    decisions = _named(evs, "scale_decision")
    executes = _named(evs, "scale_execute")
    print(f"[grow] scale_decision {[e['labels'] for e in decisions]}; "
          f"scale_execute {[e['labels'] for e in executes]}", flush=True)
    require(len(decisions) == 1, f"{len(decisions)} decisions, not one")
    d = decisions[0]["labels"]
    require(d["action"] == "drain_replace" and d["target_node"] == slow
            and str(d["reason"]).startswith("straggler:")
            and (d["from_world"], d["to_world"]) == (2, 2),
            f"the decision is not a drain of node {slow} with its "
            f"replacement, 2 -> 2: {d}")
    require([e["labels"]["outcome"] for e in executes] == ["done"],
            f"scale_execute: {[e['labels'] for e in executes]}")
    # the chain: the job manager's start, then the drain's migrate plan,
    # each applied by the controller
    plans = [client.crds[SCALEPLAN_PLURAL][k]
             for k in sorted(client.crds[SCALEPLAN_PLURAL])]
    specs = [p["spec"] for p in plans]
    print(f"[grow] ScalePlans {[(p['metadata']['name'], p['spec'], p.get('status', {}).get('phase')) for p in plans]}",
          flush=True)
    require(len(plans) == 2 and all(p["status"]["phase"] == "Succeeded"
                                    for p in plans), "the ScalePlans")
    require(specs[0]["replicaResourceSpecs"] == {"worker": {"count": 2}},
            f"the first plan: {specs[0]}")
    require(list(specs[1]["migratePods"]) == [pod(slow)],
            f"the drain's plan: {specs[1]}")
    new = pod(2)
    require(sorted(client.launched) == [pod(0), pod(1), new],
            f"launched pods {sorted(client.launched)}")
    spec = client.pods[new]["spec"]["containers"][0]
    require(spec["resources"]["limits"] == {"nvidia.com/gpu": 1},
            f"the replacement's pod asks for {spec['resources']}")
    require(pod(slow) in client.deleted, "the drained pod was not deleted")
    exits = r["exits"]
    # the drained node exits with the preemption code, or, where the
    # controller's deletion of its pod finds its launcher still tearing
    # down (the interpreter's exit restores SIGTERM's default), by it
    require(exits.get(pod(slow)) in (NODE_PREEMPTED, -signal.SIGTERM)
            and exits.get(pod(1 - slow)) == 0 and exits.get(new) == 0,
            f"exits {exits}")
    rep = r["reports"]
    surv = 1 - slow
    mine = sorted(k for k in rep if k[0] == surv)
    # the survivor's rendezvous rounds, from its launcher's log
    worlds = [int(w) for w in re.findall(
        r"round \d+: world_size=(\d+)",
        (logs / f"brain_grow_{pod(surv)}.log").read_text())]
    print(f"[grow] node {surv}'s worlds by round {worlds}; its reports "
          f"{mine}; the replacement's (node 2) "
          f"{sorted(k for k in rep if k[0] == 2)}", flush=True)
    # the drain leaves node 0 a world of 1, and the replacement, launched
    # once it re-meshed, makes it 2 again
    require(worlds[:1] == [2] and 1 in worlds and worlds[-1] == 2
            and worlds.index(1) < len(worlds) - 1,
            f"node {surv}'s worlds {worlds}, not 2, ..., 1, ..., 2")
    last = rep[mine[-1]]
    repl = [rep[k] for k in rep if k[0] == 2]
    require(len(repl) == 1 and repl[0]["world"] == 2
            and repl[0]["node_rank"] == 2, "the replacement's report")
    repl = repl[0]
    key = lambda h: [(x["step"], x["loss"], x["grad_norm"]) for x in h]  # noqa: E731
    require(last["history"] and last["history"][-1]["step"] == args.steps,
            f"node {surv} did not finish the target steps")
    require(key(repl["history"]) == key(last["history"]),
            "the replicas' steps after the grow differ")
    require(repl["restored"] == last["restored"],
            f"the replicas restored {repl['restored']} and "
            f"{last['restored']}")
    R = last["restored"]["step"]
    # no step of the world of 2 is lost, and the grown world resumes
    # from a state the survivor held (digested) before the grow
    held = {}
    for x in mine[:-1]:
        held.update({int(k): v for k, v in
                     rep[x].get("snapshot_digests", {}).items()})
    newest2 = max(int(k) for k in rep[mine[0]].get("snapshot_digests", {}))
    require(R >= newest2, f"the grown world restored step {R}, before "
            f"node {surv}'s newest step in the world of 2, {newest2}")
    require(held.get(R) == last["restored"]["digest"],
            f"the grown world's restored state is not node {surv}'s state "
            f"at step {R} (digested steps {sorted(held)})")
    a = {int(k): v for k, v in last.get("snapshot_digests", {}).items()}
    b = {int(k): v for k, v in repl.get("snapshot_digests", {}).items()}
    common = sorted(set(a) & set(b))
    require(common and all(a[k] == b[k] for k in common),
            f"the replicas' digests differ or share no step: {common}")
    require(last["digests"] == repl["digests"], "the final states differ")
    print(f"[grow] node {surv} and the replacement restored step {R} "
          f"({last['io_log'][:1]} / {repl['io_log'][:1]}) and agree by "
          f"pytree_digest at steps {common} and at the end", flush=True)
    # the checkpoint the grow restored, copied, on two cards
    src = Path(r["dir"]) / "ckpt" / f"{C.CKPT_DIR_PREFIX}{R}"
    require(src.is_dir(), f"no committed checkpoint of step {R}")
    copy_dir = root / "grow_resume_ckpt"
    shutil.copytree(src, copy_dir / src.name)
    (copy_dir / C.TRACKER_FILE).write_text(str(R))
    two = two_card_run(root, logs, "grow_resume", copy_dir, model, args)
    for n, other in zip((0, 1), (last, repl)):
        require(two[n]["restored"] == last["restored"],
                f"the two-card run's node {n} restored {two[n]['restored']}")
        require(key(two[n]["history"]) == key(other["history"]),
                f"the two-card run's node {n} differs from the grown world")
        require(two[n]["digests"] == other["digests"],
                f"the two-card run's node {n} ends in another state")
    print(f"[grow] a two-card run resumed from a copy of checkpoint {R} "
          f"({sorted(p.name for p in src.iterdir())}) ran steps "
          f"{R + 1}-{args.steps} bit for bit with the grown world", flush=True)
    # the sleep fault keys on the launcher's own node rank: the
    # replacement (node 2) is not the slowed node 1, though it holds
    # node 1's place (index 1) in the world
    require(repl["node_rank"] == 2 != slow,
            f"the replacement runs as node {repl['node_rank']}")
    h0 = rep[(surv, 0)]["history"]
    before, during = stretches(h0, args.slow_from)
    after = statistics.median(h["step_time_s"] for h in repl["history"][1:])
    mine_after = statistics.median(
        h["step_time_s"] for h in last["history"][1:])
    # the legs, on the host clock
    t_dec = decisions[0]["wall"]
    t_launch = client.launched[new]
    t_first = repl["marks"].get("first_step_done", float("nan"))
    legs = {"scale_decision -> the drained node's pod deleted":
                client.deleted[pod(slow)] - t_dec,
            "scale_decision -> the replacement's launch": t_launch - t_dec,
            "the replacement's launch -> its first step at world 2":
                t_first - t_launch,
            "scale_decision -> the replacement's first step at world 2":
                t_first - t_dec}
    print(f"[grow] {card} | grow timeline (host clock): "
          + "; ".join(f"{k} {v:.3f} s" for k, v in legs.items()), flush=True)
    print(f"[grow] {card} | step time (median, card clock where there is a "
          f"card): node {surv} before the slowdown {before} s, during it "
          f"{during} s; after the grow (a digest every step) node {surv} "
          f"{mine_after} s, the replacement {after} s", flush=True)
    return {"decision": d, "restored_step": R, "worlds": worlds,
            "grow_legs": legs, "digested_steps": common,
            "replacement_step_s": after,
            "node_steps_s": {"before": before, "during": during},
            "wall_grow": client.exited[pod(surv)] - r["t0"]}


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default="",
                    help="cpu for a gloo run without a card")
    ap.add_argument("--steps", type=int, default=0)
    ap.add_argument("--slow-from", type=int, default=0)
    ap.add_argument("--slow-factor", type=float, default=5.0)
    ap.add_argument("--step-sleep", type=float, default=0.0)
    ap.add_argument("--slow-rank", type=int, default=1, choices=(0, 1),
                    help="the node slowed, and drained, in every run")
    ap.add_argument("--timeout", type=float, default=0.0)
    ap.add_argument("--skip-grow", action="store_true",
                    help="leave out the grow run")
    ap.add_argument("--skip-on", action="store_true",
                    help="leave out run 1 (the Brain on, no scaler)")
    ap.add_argument("--skip-off", action="store_true",
                    help="leave out run 2 (DLROVER_TPU_BRAIN=0)")
    args = ap.parse_args()
    cpu = args.device == "cpu"
    args.steps = args.steps or (16 if cpu else 20)
    # on the CPU the first steps share one core with the launch: a
    # later onset leaves clean steps to read the healthy pace from
    args.slow_from = args.slow_from or (6 if cpu else 4)
    args.step_sleep = args.step_sleep or (0.4 if cpu else 0.5)
    args.timeout = args.timeout or (300.0 if cpu else 900.0)
    sys.path.insert(0, str(REPO))
    card = "cpu (gloo)"
    if not cpu:
        import torch

        require(torch.cuda.device_count() >= 2, "needs two cards")
        card = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True,
            text=True).stdout.strip().splitlines()[0]
        print(card, flush=True)
        from dlrover_tpu_torch.ops import _build

        # the workers load these libraries and compile nothing
        print(f"kernels built in {_build.build():.1f} s", flush=True)
    model = CPU_MODEL if cpu else CARD_MODEL
    root = REPO / "build" / "brain_nccl"
    logs = REPO / "chiprun_out" / "brain_nccl"
    for d in (root, logs):
        shutil.rmtree(d, ignore_errors=True)
    logs.mkdir(parents=True)
    readings = {"slow_rank": args.slow_rank}
    walls = []
    try:
        # first: its master lives in this process
        if not args.skip_grow:
            grow = run_grow(root, logs, model, args)
            readings.update(check_grow(grow, root, logs, model, args, card))
            walls.append(f"Brain with a scaler (the world grows back) "
                         f"{readings['wall_grow']:.3f} s")
        if not args.skip_on:
            on = run_job(root, logs, "brain_on", True, model, args)
            readings.update(check_brain_on(on, root, logs, model, args,
                                           card))
            walls.append(f"Brain without a scaler {readings['wall_on']:.3f}"
                         " s")
        if not args.skip_off:
            off = run_job(root, logs, "brain_off", False, model, args)
            readings.update(check_brain_off(off, args, card))
            walls.append(f"Brain off {readings['wall_off']:.3f} s")
    finally:
        shutil.rmtree(root, ignore_errors=True)
    print(f"{card} | wall to step {args.steps} (node {args.slow_rank} "
          f"slowed): " + "; ".join(walls), flush=True)
    print(json.dumps({"brain_nccl": readings}, default=str), flush=True)
    print(json.dumps({"ok": True}))


def check_brain_on(r, root, logs, model, args, card):
    """Run 1's readings.  The slow node is ``args.slow_rank``; the
    survivor, the other one, is the index 0 of the world of 1 (where the
    slow node is node 0, its snapshots move to that index: C10)."""
    slow = args.slow_rank
    surv = 1 - slow
    evs = r["master_events"]
    decisions = _named(evs, "scale_decision")
    executes = _named(evs, "scale_execute")
    print(f"[on] scale_decision {[e['labels'] for e in decisions]}; "
          f"scale_execute {[e['labels'] for e in executes]}", flush=True)
    require(len(decisions) == 1, f"{len(decisions)} decisions, not one")
    d = decisions[0]["labels"]
    require(d["action"] == "drain_replace" and d["target_node"] == slow
            and str(d["reason"]).startswith("straggler:")
            and (d["from_world"], d["to_world"]) == (2, 1),
            f"the decision is not a drain of node {slow}, 2 -> 1: {d}")
    require(len(executes) == 1 and executes[0]["labels"]["outcome"]
            == "done", f"scale_execute: {[e['labels'] for e in executes]}")
    branded = [t for t, s in r["status"]
               if slow in (s.get("health") or {}).get("stragglers", [])]
    brain_blocks = [s["brain"] for _, s in r["status"] if "brain" in s]
    require(branded, f"node {slow} never stood among /status's stragglers")
    require(brain_blocks, "/status has no brain block")
    require(r["exits"][slow][0] == NODE_PREEMPTED,
            f"node {slow}'s launcher exited {r['exits'][slow][0]}, not 43")
    require(r["exits"][surv][0] == 0,
            f"node {surv} exited {r['exits'][surv][0]}")
    rep = r["reports"]
    require((0, 0) in rep and (1, 0) in rep, f"reports {sorted(rep)}")
    # the survivor's incarnations at world 1 are rank 0 of that world
    inc1 = [k for k in rep if k[0] == 0 and k[1] > 0]
    require(len(inc1) == 1, f"node {surv}'s restarts: {sorted(rep)}")
    n0 = rep[inc1[0]]
    require(n0["world"] == 1 and n0.get("node_rank", surv) == surv,
            f"node {surv} restarted into world {n0['world']}")
    require(n0["history"] and n0["history"][-1]["step"] == args.steps,
            f"node {surv} did not finish the target steps")
    restored = n0["restored"]
    R = restored["step"]
    # step -> {node: {digests}} of the world of 2's snapshots: drain mode,
    # and every snapshot of the first world from the slowdown on
    world2 = {}
    for key in ((0, 0), (1, 0)):
        for field in ("drain_digests", "snapshot_digests"):
            for step, dig in rep[key].get(field, {}).items():
                world2.setdefault(int(step), {}).setdefault(
                    key[0], set()).add(dig)
    d1 = {int(k): v
          for k, v in rep[(slow, 0)].get("drain_digests", {}).items()}
    # the drained node's flush: shard_<slow> of a step of the world of 2,
    # at most the survivor's restored step (a survivor that became index
    # 0 writes shard_0 of later steps)
    flushed = {k: v for k, v in flushed_shards(r["dir"], slow).items()
               if k <= R}
    require(flushed, f"node {slow} flushed no shard")
    D = max(flushed)
    # its state at step D: its own drain-mode digest, or, where its
    # worker was stopped before that digest was written, the world of
    # 2's (the replicas' digests agree, checked below)
    want = d1.get(D) or next(iter(set().union(
        *world2.get(D, {}).values())), None)
    print(f"[on] node {slow} flushed step {D} ("
          f"{flushed[D].relative_to(r['dir'])}); its drain-mode snapshots "
          f"{sorted(d1)}; node {surv} restored step {R} ({n0['io_log'][:1]})",
          flush=True)
    require(want is not None,
            f"no digest of step {D}, the step node {slow} flushed")
    require(R >= D, f"node {surv} restored step {R}, before the drained {D}")
    # C10: the survivor resumes from its own newest snapshot (in shared
    # memory, carried to its new index where that moved), at or past the
    # last step both nodes snapshotted in the world of 2
    snapped = sorted(st for st, v in world2.items() if len(v) == 2)
    require(n0["io_log"] and n0["io_log"][0][:2] == ["restore_shm", R],
            f"node {surv} did not restore step {R} from shared memory: "
            f"{n0['io_log'][:1]}")
    require(not snapped or R >= snapped[-1],
            f"node {surv} restored step {R}, before step {snapped[-1]} "
            "that both nodes snapshotted")
    require(n0["history"][0]["step"] == R + 1,
            f"node {surv}'s first step at world 1 is "
            f"{n0['history'][0]['step']}, not {R + 1}")
    # 1. the drained flush itself: a one-card restore of the slow node's
    # shard, resharded from the world of 2, is the state it had at step D
    copy = root / "drained_ckpt"
    copy_shard(flushed[D], slow, D, copy)
    a, a_evs = one_card_run(root, logs, "drained_restore", copy, D, model,
                            args)
    reshard = [e["labels"] for e in a_evs if e["name"] == "reshard"]
    require(a["restored"] == {"step": D, "digest": want},
            f"the drained flush restores to {a['restored']}, not node "
            f"{slow}'s state at step {D}")
    # shard_1 alone is a slice of another world for rank 0 of world 1:
    # it is read through reshard; shard_0 is rank 0's own (data parallel)
    require(slow == 0 or any((x["from_world"], x["to_world"]) == (2, 1)
                             for x in reshard),
            f"no reshard 2 -> 1: {reshard}")
    print(f"[on] a one-card restore of node {slow}'s drained flush went "
          f"through reshard {reshard} and equals node {slow}'s state at step "
          f"{D} by pytree_digest", flush=True)
    # 2. the two replicas agree wherever both digested a step, and node
    # 0's restored state is the world of 2's state at that step
    for step, by_node in sorted(world2.items()):
        digs = set().union(*by_node.values())
        require(len(digs) == 1, f"the world of 2's digests of step {step} "
                f"differ: {by_node}")
    require(R in world2, f"no node of the world of 2 digested step {R}, "
            f"the step node 0 restored (digested: {sorted(world2)})")
    require(set().union(*world2[R].values()) == {restored["digest"]},
            f"node {surv}'s restored state at step {R} is not the state the "
            f"world of 2 had at that step")
    print(f"[on] node {surv}'s restored state at step {R} equals the world "
          f"of 2's state at that step by pytree_digest (digested by node(s) "
          f"{sorted(world2[R])}); the replicas' digests agree at steps "
          f"{snapped}", flush=True)
    # 3. the survivor's steps after the restore, against one card resumed
    # from a copy of the checkpoint it restored (its own flush of step R)
    mine = flushed_shards(r["dir"], surv)
    require(R in mine,
            f"node {surv} flushed no shard of step {R}: {sorted(mine)}")
    copy = root / "resume_ckpt"
    copy_shard(mine[R], surv, R, copy)
    one, _ = one_card_run(root, logs, "resume", copy, args.steps, model,
                          args)
    key = lambda h: [(x["step"], x["loss"], x["grad_norm"]) for x in h]  # noqa: E731
    require(one["restored"] == restored,
            f"the one-card run restored {one['restored']}")
    require(key(one["history"]) == key(n0["history"]),
            f"node {surv}'s steps after the restore differ from the one-card "
            f"resume's: {key(n0['history'])[:3]} vs "
            f"{key(one['history'])[:3]}")
    require(one["digests"] == n0["digests"], "the final states differ")
    print(f"[on] a one-card run resumed from a copy of node {surv}'s flush "
          f"of step {R} restored the same state and ran steps "
          f"{R + 1}-{args.steps} bit for bit with node {surv}", flush=True)
    # the drain's timeline
    t_dec = decisions[0]["wall"]
    t_exec = executes[0]["wall"]
    t_exit = r["exits"][slow][1]
    n0_evs = r["node_events"][surv]
    begin = [e["wall"] for e in n0_evs if e["name"] == "rendezvous"
             and e["ph"] == "B" and e.get("inc", 0) >= 1]
    require(begin, f"node {surv}'s events hold no rendezvous of its restart")
    t_rdzv = min(e["wall"] for e in n0_evs if e["name"] == "rendezvous"
                 and e["ph"] == "E" and e["wall"] >= min(begin))
    t_first = n0["marks"].get("first_step_done", float("nan"))
    t_branded = branded[0]
    legs = {"straggler on /status -> scale_decision": t_dec - t_branded,
            f"scale_decision -> node {slow}'s launcher exit (43)":
                t_exit - t_dec,
            "scale_decision -> scale_execute (done)": t_exec - t_dec,
            f"scale_decision -> node {surv}'s rendezvous at world 1":
                t_rdzv - t_dec,
            f"scale_decision -> node {surv}'s first step at world 1":
                t_first - t_dec}
    print(f"[on] {card} | drain timeline (host clock): "
          + "; ".join(f"{k} {v:.3f} s" for k, v in legs.items()),
          flush=True)
    h0 = rep[(surv, 0)]["history"]
    last_w2 = h0[-1]["step"] if h0 else 0
    before, during = stretches(h0, args.slow_from)
    after = statistics.median(h["step_time_s"] for h in n0["history"][1:]) \
        if len(n0["history"]) > 1 else None
    print(f"[on] {card} | node {surv}'s step time (median, card clock where "
          f"there is a card): before the slowdown {before} s, during it "
          f"(steps {args.slow_from}-{last_w2}) {during} s, after the "
          f"drain (world 1, steps {R + 2}-{args.steps}) {after} s",
          flush=True)
    wall = r["exits"][surv][1] - r["t0"]
    return {"wall_on": wall, "slow_rank": slow, "decision": d,
            "restored_step": R, "drained_step": D,
            "both_snapshotted": snapped[-1] if snapped else None,
            "drain_legs": legs,
            "node0_steps_s": {"before": before, "during": during,
                              "after": after}}


def check_brain_off(r, args, card):
    evs = r["master_events"]
    decisions = _named(evs, "scale_decision")
    require(not decisions, f"Brain off made decisions: {decisions}")
    require(r["exits"] [0][0] == 0 and r["exits"][1][0] == 0,
            f"Brain off exits {r['exits']}")
    rep = r["reports"]
    slow = args.slow_rank
    h0, h1 = rep[(1 - slow, 0)]["history"], rep[(slow, 0)]["history"]
    require(h0[-1]["step"] == args.steps, "Brain off did not finish")
    before, during = stretches(h0, args.slow_from)
    before1, slow1 = stretches(h1, args.slow_from)
    # the slow node's added sleep is (F - 1) S a step: require half of it
    added = 0.5 * (args.slow_factor - 1) * args.step_sleep
    require(during - before >= added and slow1 - before1 >= added,
            f"Brain off: the steps did not slow down by {added} s: node 0 "
            f"{before} -> {during}, node 1 {before1} -> {slow1}")
    brain = [s.get("brain") for _, s in r["status"]]
    require(not any(brain), "Brain off: /status has a brain block")
    print(f"[off] {card} | no decision; node {1 - slow}'s step time "
          f"before the slowdown {before} s, during it {during} s (node "
          f"{slow} {slow1} s) to step {args.steps}", flush=True)
    return {"wall_off": r["exits"][1 - slow][1] - r["t0"],
            "off_node0_steps_s": {"before": before, "during": during}}


if __name__ == "__main__":
    main()
