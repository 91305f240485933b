"""The Brain on two cards: a node slowed mid-run is branded a straggler,
drained by one planned action, and the job finishes on the other card.

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

Run 1 (the Brain on, its default) requires: node 1 branded a straggler
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
"""

import argparse
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
        #: every /status read, with the wall clock it was taken at
        self.status = []
        self._stop = threading.Event()
        self._thread = threading.Thread(target=self._poll, daemon=True)
        self._thread.start()

    def _poll(self):
        base = None
        while not self._stop.wait(0.5):
            if base is None:
                m = re.search(r"DLROVER_TPU_STATUS_PORT=(\d+)",
                              self.log.read_text())
                if m is None:
                    continue
                base = f"http://127.0.0.1:{m.group(1)}"
            try:
                status = json.loads(urllib.request.urlopen(
                    base + "/status", timeout=2).read().decode())
            except OSError:
                continue
            self.status.append((time.time(), status))

    def stop(self):
        self._stop.set()
        self._thread.join(timeout=5)
        _stop(self.proc)


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


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default="",
                    help="cpu for a gloo run without a card")
    ap.add_argument("--steps", type=int, default=0)
    ap.add_argument("--slow-from", type=int, default=0)
    ap.add_argument("--slow-factor", type=float, default=5.0)
    ap.add_argument("--step-sleep", type=float, default=0.0)
    ap.add_argument("--timeout", type=float, default=0.0)
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
    args.slow_rank = 1  # the checks below read node 1 as the slow node
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
    try:
        on = run_job(root, logs, "brain_on", True, model, args)
        readings = check_brain_on(on, root, logs, model, args, card)
        if not args.skip_off:
            off = run_job(root, logs, "brain_off", False, model, args)
            readings.update(check_brain_off(off, args, card))
    finally:
        shutil.rmtree(root, ignore_errors=True)
    off_s = ("not run" if args.skip_off
             else f"{readings['wall_off']:.3f} s")
    print(f"{card} | wall to step {args.steps}: Brain on "
          f"{readings['wall_on']:.3f} s, Brain off {off_s}", flush=True)
    print(json.dumps({"brain_nccl": readings}), flush=True)
    print(json.dumps({"ok": True}))


def check_brain_on(r, root, logs, model, args, card):
    evs = r["master_events"]
    decisions = _named(evs, "scale_decision")
    executes = _named(evs, "scale_execute")
    print(f"[on] scale_decision {[e['labels'] for e in decisions]}; "
          f"scale_execute {[e['labels'] for e in executes]}", flush=True)
    require(len(decisions) == 1, f"{len(decisions)} decisions, not one")
    d = decisions[0]["labels"]
    require(d["action"] == "drain_replace" and d["target_node"] == 1
            and str(d["reason"]).startswith("straggler:")
            and (d["from_world"], d["to_world"]) == (2, 1),
            f"the decision is not a drain of node 1, 2 -> 1: {d}")
    require(len(executes) == 1 and executes[0]["labels"]["outcome"]
            == "done", f"scale_execute: {[e['labels'] for e in executes]}")
    branded = [t for t, s in r["status"]
               if 1 in (s.get("health") or {}).get("stragglers", [])]
    brain_blocks = [s["brain"] for _, s in r["status"] if "brain" in s]
    require(branded, "node 1 never stood among /status's stragglers")
    require(brain_blocks, "/status has no brain block")
    require(r["exits"][1][0] == NODE_PREEMPTED,
            f"node 1's launcher exited {r['exits'][1][0]}, not 43")
    require(r["exits"][0][0] == 0, f"node 0 exited {r['exits'][0][0]}")
    rep = r["reports"]
    require((0, 0) in rep and (1, 0) in rep, f"reports {sorted(rep)}")
    inc1 = [k for k in rep if k[0] == 0 and k[1] > 0]
    require(len(inc1) == 1, f"node 0's restarts: {sorted(rep)}")
    n0 = rep[inc1[0]]
    require(n0["world"] == 1, f"node 0 restarted into world {n0['world']}")
    require(n0["history"] and n0["history"][-1]["step"] == args.steps,
            "node 0 did not finish the target steps")
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
    d1 = {int(k): v for k, v in rep[(1, 0)].get("drain_digests", {}).items()}
    flushed = flushed_shards(r["dir"], 1)
    require(flushed, "node 1 flushed no shard")
    D = max(flushed)
    print(f"[on] node 1 flushed step {D} ({flushed[D].relative_to(r['dir'])}"
          f"); its drain-mode snapshots {sorted(d1)}; node 0 restored step "
          f"{R} ({n0['io_log'][:1]})", flush=True)
    require(D in d1, f"node 1 recorded no digest of the step it flushed")
    require(R >= D, f"node 0 restored step {R}, before the drained {D}")
    # 1. the drained flush itself: a one-card restore of node 1's shard,
    # resharded from the world of 2, is the state node 1 had at step D
    copy = root / "drained_ckpt"
    copy_shard(flushed[D], 1, D, copy)
    a, a_evs = one_card_run(root, logs, "drained_restore", copy, D, model,
                            args)
    reshard = [e["labels"] for e in a_evs if e["name"] == "reshard"]
    require(a["restored"] == {"step": D, "digest": d1[D]},
            f"the drained flush restores to {a['restored']}, not node 1's "
            f"state at step {D}")
    require(any((x["from_world"], x["to_world"]) == (2, 1)
                for x in reshard), f"no reshard 2 -> 1: {reshard}")
    print(f"[on] a one-card restore of node 1's drained flush went through "
          f"reshard {reshard} and equals node 1's state at step {D} by "
          "pytree_digest", flush=True)
    # 2. the two replicas agree wherever both digested a step, and node
    # 0's restored state is the world of 2's state at that step
    for step, by_node in sorted(world2.items()):
        digs = set().union(*by_node.values())
        require(len(digs) == 1, f"the world of 2's digests of step {step} "
                f"differ: {by_node}")
    require(R in world2, f"no node of the world of 2 digested step {R}, "
            f"the step node 0 restored (digested: {sorted(world2)})")
    require(set().union(*world2[R].values()) == {restored["digest"]},
            f"node 0's restored state at step {R} is not the state the "
            f"world of 2 had at that step")
    both = sorted(s for s, v in world2.items() if len(v) == 2)
    print(f"[on] node 0's restored state at step {R} equals the world of "
          f"2's state at that step by pytree_digest (digested by node(s) "
          f"{sorted(world2[R])}); the replicas' digests agree at steps "
          f"{both}", flush=True)
    # 3. node 0's steps after the restore, against one card resumed from a
    # copy of the checkpoint node 0 restored (its own flush of step R)
    mine = flushed_shards(r["dir"], 0)
    require(R in mine, f"node 0 flushed no shard of step {R}: {sorted(mine)}")
    copy = root / "resume_ckpt"
    copy_shard(mine[R], 0, R, copy)
    one, _ = one_card_run(root, logs, "resume", copy, args.steps, model,
                          args)
    key = lambda h: [(x["step"], x["loss"], x["grad_norm"]) for x in h]  # noqa: E731
    require(one["restored"] == restored,
            f"the one-card run restored {one['restored']}")
    require(key(one["history"]) == key(n0["history"]),
            "node 0's steps after the restore differ from the one-card "
            f"resume's: {key(n0['history'])[:3]} vs "
            f"{key(one['history'])[:3]}")
    require(one["digests"] == n0["digests"], "the final states differ")
    print(f"[on] a one-card run resumed from a copy of node 0's flush of "
          f"step {R} restored the same state and ran steps "
          f"{R + 1}-{args.steps} bit for bit with node 0", flush=True)
    # the drain's timeline
    t_dec = decisions[0]["wall"]
    t_exec = executes[0]["wall"]
    t_exit = r["exits"][1][1]
    n0_evs = r["node_events"][0]
    begin = [e["wall"] for e in n0_evs if e["name"] == "rendezvous"
             and e["ph"] == "B" and e.get("inc", 0) >= 1]
    require(begin, "node 0's events hold no rendezvous of its restart")
    t_rdzv = min(e["wall"] for e in n0_evs if e["name"] == "rendezvous"
                 and e["ph"] == "E" and e["wall"] >= min(begin))
    t_first = n0["marks"].get("first_step_done", float("nan"))
    t_branded = branded[0]
    legs = {"straggler on /status -> scale_decision": t_dec - t_branded,
            "scale_decision -> node 1's launcher exit (43)": t_exit - t_dec,
            "scale_decision -> scale_execute (done)": t_exec - t_dec,
            "scale_decision -> node 0's rendezvous at world 1":
                t_rdzv - t_dec,
            "scale_decision -> node 0's first step at world 1":
                t_first - t_dec}
    print(f"[on] {card} | drain timeline (host clock): "
          + "; ".join(f"{k} {v:.3f} s" for k, v in legs.items()),
          flush=True)
    h0 = rep[(0, 0)]["history"]
    last_w2 = h0[-1]["step"] if h0 else 0
    before, during = stretches(h0, args.slow_from)
    after = statistics.median(h["step_time_s"] for h in n0["history"][1:]) \
        if len(n0["history"]) > 1 else None
    print(f"[on] {card} | node 0's step time (median, card clock where "
          f"there is a card): before the slowdown {before} s, during it "
          f"(steps {args.slow_from}-{last_w2}) {during} s, after the "
          f"drain (world 1, steps {R + 2}-{args.steps}) {after} s",
          flush=True)
    wall = r["exits"][0][1] - r["t0"]
    return {"wall_on": wall, "decision": d, "restored_step": R,
            "drained_step": D,
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
    h0, h1 = rep[(0, 0)]["history"], rep[(1, 0)]["history"]
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
    print(f"[off] {card} | no decision; node 0's step time before the "
          f"slowdown {before} s, during it {during} s (node 1 {slow1} s) "
          f"to step {args.steps}", flush=True)
    return {"wall_off": r["exits"][0][1] - r["t0"],
            "off_node0_steps_s": {"before": before, "during": during}}


if __name__ == "__main__":
    main()
