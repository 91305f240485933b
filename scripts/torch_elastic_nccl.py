"""The elastic launch at world 2 on two cards: NCCL, its gloo host group,
and a worker killed mid-run.

Two runs of ``python -m dlrover_tpu_torch.run --nproc_per_node=2
--max-restarts=1`` of the port's ``llama_pretrain`` at a small size, one
card a worker (``cuda:<local rank>``): an uninterrupted one, and one
whose rank 1 SIGKILLs itself after step 3, so that the agent restarts
both workers and they restore the newest step both ranks hold in its
shared memory: step 3, or an earlier one where rank 0's snapshot of
step 3 was skipped behind a running drain (rank 1 snapshots step 3
blocking before it dies; rank 0 does not know it will be needed).
Checks that each worker joined an NCCL world with a gloo host group,
that both restarted ranks restored the same step from shm through the
restore prefetch (a ``restore_prefetch`` and a ``finish_restore`` span
of each in the launcher's events file), and that their steps after it
and every state leaf equal the uninterrupted run's bit for bit.  Prints
each rank's step times on the card's clock and the card's name and
power limit.  The runs live under
``build/elastic_nccl/``; the launchers' output goes to
``chiprun_out/elastic_nccl/``.

    python3 scripts/torch_elastic_nccl.py            # two cards
    python3 scripts/torch_elastic_nccl.py --device cpu   # gloo, no card
"""

import argparse
import json
import os
import shutil
import subprocess
import sys
import time
from pathlib import Path

REPO = Path(__file__).resolve().parents[1]
MODEL = ["--dim", "512", "--layers", "2", "--heads", "4", "--seq", "256",
         "--batch", "2", "--steps", "6", "--save_memory_interval", "1",
         "--save_storage_interval", "100"]


def launch(run_dir: Path, log_dir: Path, device: str, crash: bool):
    """One launcher run; returns ({(rank, inc): report}, its log, seconds,
    its events)."""
    from dlrover_tpu_torch.observability.events import read_events

    rep = run_dir / "rep"
    rep.mkdir(parents=True)
    events = run_dir / "events.jsonl"
    cmd = [sys.executable, "-m", "dlrover_tpu_torch.run", "--nnodes=1",
           "--nproc_per_node=2", "--max-restarts=1", "--monitor_interval=0.2",
           f"--events_file={events}", "-m",
           "dlrover_tpu_torch.examples.llama_pretrain", *MODEL,
           "--ckpt_dir", str(run_dir / "ckpt"), "--report_dir", str(rep)]
    if device:
        cmd += ["--device", device, "--dtype", "float32"]
    if crash:
        cmd += ["--crash_after_step", "3", "--crash_rank", "1"]
    t0 = time.time()
    # the agent's preemption watcher (on by default) asks a metadata
    # endpoint on this machine that refuses connections, never a real one
    env = dict(os.environ, PYTHONPATH=str(REPO),
               DLROVER_TPU_METADATA_BASE="http://127.0.0.1:9/")
    if device == "cpu":
        # one thread a worker: a CPU matmul whose thread count follows
        # the machine's load rounds differently from run to run
        env["OMP_NUM_THREADS"] = "1"
    proc = subprocess.run(
        cmd, cwd=REPO, capture_output=True, text=True, timeout=600,
        env=env)
    wall = time.time() - t0
    log = proc.stdout + proc.stderr
    (log_dir / f"{run_dir.name}.log").write_text(log)
    if proc.returncode != 0:
        raise SystemExit(f"{run_dir.name}: launcher exited "
                         f"{proc.returncode}:\n{log[-4000:]}")
    out = {}
    for p in rep.glob("rank*_inc*.json"):
        d = json.loads(p.read_text())
        out[(d["rank"], d["restart_count"])] = d
    return out, log, wall, read_events(str(events))


def require(ok, what):
    if not ok:
        raise SystemExit(f"FAIL: {what}")


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default="",
                    help="cpu for a gloo run without a card")
    args = ap.parse_args()
    sys.path.insert(0, str(REPO))
    if args.device != "cpu":
        import torch

        require(torch.cuda.device_count() >= 2, "needs two cards")
        print(subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True,
            text=True).stdout.strip(), flush=True)
        from dlrover_tpu_torch.ops import _build

        # the workers load these libraries and compile nothing
        print(f"kernels built in {_build.build():.1f} s", flush=True)
    root = REPO / "build" / "elastic_nccl"
    logs = REPO / "chiprun_out" / "elastic_nccl"
    for d in (root, logs):
        shutil.rmtree(d, ignore_errors=True)
    logs.mkdir(parents=True)
    try:
        base, log_b, wall_b, _ = launch(root / "base", logs, args.device,
                                        crash=False)
        crash, log_c, wall_c, evs = launch(root / "crash", logs,
                                           args.device, crash=True)
    finally:
        shutil.rmtree(root, ignore_errors=True)
    backend = "gloo" if args.device == "cpu" else "nccl, gloo host group"
    for name, log in (("base", log_b), ("crash", log_c)):
        joined = log.count(f"torch.distributed ({backend}) initialized")
        require(joined >= 2, f"{name}: {joined} workers joined a "
                f"({backend}) world, not 2 or more")
    require(set(base) == {(0, 0), (1, 0)}, f"base reports {sorted(base)}")
    require(set(crash) == {(1, 0), (0, 1), (1, 1)},
            f"crash reports {sorted(crash)}")
    require(crash[(1, 0)].get("crash_step") == 3, "rank 1 did not die at 3")
    restored = {crash[(r, 1)]["io_log"][0][1] for r in (0, 1)}
    require(all(crash[(r, 1)]["io_log"][0][0] == "restore_shm"
                for r in (0, 1)) and len(restored) == 1,
            f"the ranks restored {[crash[(r, 1)]['io_log'][:1] for r in (0, 1)]}"
            ", not one step from shm")
    step = restored.pop()
    require(1 <= step <= 3, f"restored step {step}")
    for rank in (0, 1):
        pid = crash[(rank, 1)]["pid"]
        spans = {e["name"] for e in evs if e.get("pid") == pid}
        require({"restore_prefetch", "finish_restore"} <= spans,
                f"rank {rank}'s restart did not restore through the "
                f"prefetch: {sorted(spans)}")
    for rank in (0, 1):
        b, c = base[(rank, 0)], crash[(rank, 1)]
        key = [(h["step"], h["loss"], h["grad_norm"]) for h in c["history"]]
        require(key == [(h["step"], h["loss"], h["grad_norm"])
                        for h in b["history"][step:]],
                f"rank {rank}: steps {step + 1}-6 differ: {key}")
        require(c["digests"] == b["digests"],
                f"rank {rank}: the state at step 6 differs")
        require(not c["compiled"], f"rank {rank} compiled {c['compiled']}")
        if args.device != "cpu":
            idle = [k for k in ("rms_norm", "rms_norm_bwd", "flash_fwd",
                                "flash_bwd_dkv", "flash_bwd_dq")
                    if not c["launches"].get(k)]
            require(not idle, f"rank {rank}'s restart launched none of {idle}")
        print(f"rank {rank} on {b['device']}: uninterrupted steps (ms) "
              f"{[round(h['step_time_s'] * 1e3, 3) for h in b['history']]}"
              f"; restarted steps {step + 1}-6 (ms) "
              f"{[round(h['step_time_s'] * 1e3, 3) for h in c['history']]}"
              f"; launches {c['launches']}", flush=True)
    require(base[(0, 0)]["digests"] == base[(1, 0)]["digests"],
            "the two ranks' replicas differ")
    print(f"launcher runs {wall_b:.1f} s (uninterrupted), {wall_c:.1f} s "
          f"(killed and restarted); both ranks restored step {step} from "
          f"shm through the prefetch; steps {step + 1}-6 and every leaf bit "
          f"for bit", flush=True)
    print(json.dumps({"ok": True}))


if __name__ == "__main__":
    main()
