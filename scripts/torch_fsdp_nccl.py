"""Data-parallel and FSDP training on two cards: NCCL gradients, the
per-layer gather, and a sharded checkpoint read back at world 1.

Runs of the port's ``llama_pretrain`` (AGD, the example's batch stream
of ``--batch`` rows a step, every rank drawing the global batch and
training on its rows), one card a worker:

(a) Llama-2-7B widths at 8 layers, global batch 4 x 2048, 6 steps: one
    card alone (``python -m dlrover_tpu_torch.examples.llama_pretrain``),
    then ``python -m dlrover_tpu_torch.run --nproc_per_node=2`` at
    ``--data 2`` and at ``--fsdp 2``.  Each two-card run's losses and
    grad norms must be within ``TOL`` of the one-card run's (bf16
    compute: the ranks' rows go through other GEMM shapes and the
    gradients are summed in another order); at ``{data 2}`` both ranks'
    state leaves must be equal bit for bit, and at ``{fsdp 2}`` both
    ranks' digests of the reassembled global state.
(b) Llama-2-7B at its published 32 layers, ``--fsdp 2``, 6 steps: 16 B
    of state a parameter (fp32 master, grad and two AGD moments) is
    108 GB, so each card holds ~54 GB of it.  Prints each card's peak
    reserved memory and the step window on the card's clock.
(c) The ``{fsdp 2}`` run of (a) persists its last step; after (b) this
    process restores it at world 1 (``DLROVER_TPU_PREV_WORLD=2``: the serial,
    layout-aware load reads each leaf from both shards), and every leaf
    must equal the two-card run's reassembled leaf bit for bit.

With ``--device cpu`` the same runs go through gloo at a small size
(fp32, ``TOL_CPU``).  Prints the card's name and power limit.  Runs live
under ``build/fsdp_nccl/``; the launchers' output goes to
``chiprun_out/fsdp_nccl/``.

    python3 scripts/torch_fsdp_nccl.py                # two cards
    python3 scripts/torch_fsdp_nccl.py --device cpu   # gloo, no card
    python3 scripts/torch_fsdp_nccl.py --skip-32      # (a) and (c) only
"""

import argparse
import gc
import json
import os
import shutil
import subprocess
import sys
import time
from pathlib import Path

REPO = Path(__file__).resolve().parents[1]
CARD_8 = ["--config", "llama2_7b", "--layers", "8", "--batch", "4",
          "--seq", "2048", "--steps", "6"]
CARD_32 = ["--config", "llama2_7b", "--layers", "32", "--batch", "4",
           "--seq", "2048", "--steps", "6"]
CPU = ["--device", "cpu", "--dtype", "float32", "--dim", "64", "--layers",
       "2", "--heads", "4", "--seq", "16", "--batch", "4", "--steps", "6"]
# |loss - one card's| and |grad_norm / one card's - 1| at every step:
# bf16 on the card (chip_smoke.py's STEP0_TOL for two attention paths),
# fp32 on the CPU (tests/test_torch_train.py)
TOL = {"loss": 1e-2, "grad_norm": 3e-2}
TOL_CPU = {"loss": 1e-5, "grad_norm": 1e-4}
# no snapshot to shared memory before the last step's persist
CKPT = ["--save_memory_interval", "100", "--save_storage_interval", "100"]


def require(ok, what):
    if not ok:
        raise SystemExit(f"FAIL: {what}")


def run(name: str, root: Path, logs: Path, model, nproc: int, flags=(),
        ckpt: str = ""):
    """One run; returns ({rank: report}, seconds)."""
    rep = root / name
    rep.mkdir(parents=True)
    args = [*model, *flags, "--report_dir", str(rep)]
    if ckpt:
        args += ["--ckpt_dir", ckpt, *CKPT]
    if nproc == 1:
        cmd = [sys.executable, "-m",
               "dlrover_tpu_torch.examples.llama_pretrain", *args]
    else:
        cmd = [sys.executable, "-m", "dlrover_tpu_torch.run", "--nnodes=1",
               f"--nproc_per_node={nproc}", "--max-restarts=0",
               "--monitor_interval=0.2", "-m",
               "dlrover_tpu_torch.examples.llama_pretrain", *args]
    # the agent's preemption watcher asks a metadata endpoint on this
    # machine that refuses connections, never a real one
    env = dict(os.environ, PYTHONPATH=str(REPO),
               DLROVER_TPU_METADATA_BASE="http://127.0.0.1:9/")
    if "cpu" in model:
        env["OMP_NUM_THREADS"] = "1"
    else:
        # 54 GB of state a card at 32 layers: cached blocks must not
        # fragment what is left (chip_smoke.py's int8 leg does the same)
        env.setdefault("PYTORCH_CUDA_ALLOC_CONF", "expandable_segments:True")
    t0 = time.time()
    proc = subprocess.run(cmd, cwd=REPO, capture_output=True, text=True,
                          timeout=900, env=env)
    wall = time.time() - t0
    log = proc.stdout + proc.stderr
    (logs / f"{name}.log").write_text(log)
    if proc.returncode != 0:
        raise SystemExit(f"{name}: exited {proc.returncode}:\n{log[-4000:]}")
    out = {}
    for p in rep.glob("rank*_inc0.json"):
        d = json.loads(p.read_text())
        out[d["rank"]] = d
    require(set(out) == set(range(nproc)), f"{name}: reports {sorted(out)}")
    return out, wall


def compare(name, got, want, tol):
    """Every step's loss and grad norm against the one-card run's."""
    dl = [abs(g["loss"] - w["loss"]) for g, w in zip(got, want)]
    dn = [abs(g["grad_norm"] / w["grad_norm"] - 1) for g, w in zip(got, want)]
    print(f"{name}: losses {[round(h['loss'], 6) for h in got]} grad_norms "
          f"{[round(h['grad_norm'], 6) for h in got]}; against one card: "
          f"max |d loss| {max(dl):.3g}, max rel d grad_norm {max(dn):.3g} "
          f"(tol {tol})", flush=True)
    require(len(got) == len(want) == 6, f"{name}: {len(got)} steps")
    require(max(dl) <= tol["loss"] and max(dn) <= tol["grad_norm"],
            f"{name} differs from the one-card run")


def reserved_gib(report):
    """The peak reserved card memory of a run's report (0 on the CPU)."""
    return round(report.get("cuda_memory", {}).get("max_reserved", 0)
                 / 2**30, 2)


def window_ms(hist):
    return 1e3 * sum(h["step_time_s"] for h in hist[1:]) / (len(hist) - 1)


def restore_world1(ckpt: str, model, device: str):
    """The persisted ``{fsdp 2}`` step read back in this process at world
    1; returns its leaf digests and the step."""
    os.environ["DLROVER_TPU_PREV_WORLD"] = "2"
    import torch

    from dlrover_tpu_torch.accelerate import Strategy, auto_accelerate
    from dlrover_tpu_torch.examples import llama_pretrain as ex
    from dlrover_tpu_torch.models.llama import (
        init_params,
        loss_fn,
        param_logical_axes,
    )
    from dlrover_tpu_torch.optimizers import AGD
    from dlrover_tpu_torch.trainer import Trainer, TrainingArgs

    args = ex.parse_args(list(model))
    cfg = ex.model_config(args)
    result = auto_accelerate(
        loss_fn=lambda p, b: loss_fn(p, b, cfg),
        optimizer=lambda ps: AGD(ps, lr=3e-4),
        init_params_fn=lambda gen, dev: init_params(
            cfg, gen, dev, dtype=torch.float32),
        param_axes=param_logical_axes(cfg),
        load_strategy=Strategy(data=1, fsdp=1), device=device or None)
    trainer = Trainer(result, TrainingArgs(
        max_steps=args.steps, checkpoint_dir=ckpt,
        snapshot_mode="staged"), lambda: iter(()))
    try:
        step = trainer.restore()
        io = [list(r[:2]) for r in trainer.checkpoint_engine.io_log]
        return ex.leaf_digests(trainer.state), step, io
    finally:
        trainer.checkpoint_engine.close()
        # this process's card memory goes back before anything else runs
        del trainer, result
        gc.collect()
        if torch.cuda.is_available():
            torch.cuda.empty_cache()


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default="",
                    help="cpu for a gloo run without a card")
    ap.add_argument("--skip-32", action="store_true",
                    help="leave out (b), the 32-layer run")
    args = ap.parse_args()
    sys.path.insert(0, str(REPO))
    cpu = args.device == "cpu"
    if not cpu:
        import torch

        require(torch.cuda.device_count() >= 2, "needs two cards")
        print(subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True,
            text=True).stdout.strip(), flush=True)
        from dlrover_tpu_torch.ops import _build

        # the workers load these libraries and compile nothing
        print(f"kernels built in {_build.build():.1f} s", flush=True)
    model8 = CPU if cpu else CARD_8
    tol = TOL_CPU if cpu else TOL
    root = REPO / "build" / "fsdp_nccl"
    logs = REPO / "chiprun_out" / "fsdp_nccl"
    for d in (root, logs):
        shutil.rmtree(d, ignore_errors=True)
    logs.mkdir(parents=True)
    ckpt = str(root / "ckpt")
    summary = {}
    try:
        one, w1 = run("one_card", root, logs, model8, 1)
        data2, wd = run("data2", root, logs, model8, 2, ["--data", "2"])
        fsdp2, wf = run("fsdp2", root, logs, model8, 2,
                        ["--data", "1", "--fsdp", "2"], ckpt=ckpt)
        want = one[0]["history"]
        for name, reps in (("{data 2}", data2), ("{fsdp 2}", fsdp2)):
            for r in (0, 1):
                compare(f"(a) {name} rank {r}", reps[r]["history"], want, tol)
            wins = [round(window_ms(reps[r]["history"]), 3) for r in (0, 1)]
            print(f"(a) {name} step_ms window(2-6) {wins} against one card "
                  f"{window_ms(want):.3f}; peak reserved GiB "
                  f"{[reserved_gib(reps[r]) for r in (0, 1)]} (one card "
                  f"{reserved_gib(one[0])})", flush=True)
        require(data2[0]["digests"] == data2[1]["digests"],
                "(a) {data 2}: the ranks' states differ")
        require("global_digests" not in data2[0],
                "(a) {data 2} sharded a param")
        g = [fsdp2[r].get("global_digests") for r in (0, 1)]
        require(g[0] and g[0] == g[1],
                "(a) {fsdp 2}: the ranks' reassembled states differ")
        require(fsdp2[0]["digests"] != fsdp2[1]["digests"],
                "(a) {fsdp 2}: the ranks hold the same slices")
        print("(a) {data 2}: both ranks' leaves equal bit for bit; "
              "{fsdp 2}: both ranks reassemble the same state", flush=True)
        summary["a"] = {"one_card_s": w1, "data2_s": wd, "fsdp2_s": wf}

        if not (cpu or args.skip_32):
            big, wb = run("fsdp2_32", root, logs, CARD_32, 2,
                          ["--data", "1", "--fsdp", "2"])
            for r in (0, 1):
                h = big[r]["history"]
                mem = big[r]["cuda_memory"]
                print(f"(b) Llama-2-7B 32 layers {{fsdp 2}} rank {r} on "
                      f"{big[r]['device']}: losses "
                      f"{[round(x['loss'], 6) for x in h]} step_ms (card "
                      f"clock) {[round(1e3 * x['step_time_s'], 3) for x in h]}"
                      f" window(2-6) {window_ms(h):.3f} max_reserved_GiB "
                      f"{mem['max_reserved'] / 2**30:.2f} max_allocated_GiB "
                      f"{mem['max_allocated'] / 2**30:.2f}", flush=True)
                require(len(h) == 6 and all(x["loss"] == x["loss"]
                                            for x in h), "(b) steps")
            summary["b"] = {"s": wb, "window_ms": [
                window_ms(big[r]["history"]) for r in (0, 1)],
                "max_reserved_gib": [
                    big[r]["cuda_memory"]["max_reserved"] / 2**30
                    for r in (0, 1)]}
        digests, step, io = restore_world1(ckpt, model8, args.device)
        diff = sorted(k for k in g[0] if digests.get(k) != g[0][k])
        print(f"(c) world 1 restored step {step} from the {{fsdp 2}} "
              f"checkpoint ({io}); leaves differing from the two cards' "
              f"reassembled state: {diff}", flush=True)
        require(step == 6 and not diff and set(digests) == set(g[0]),
                "(c) the world-1 restore differs from the reassembled shards")
        summary["c"] = {"step": step, "leaves": len(digests)}
    finally:
        shutil.rmtree(root, ignore_errors=True)
    print(json.dumps({"ok": True, **summary}))


if __name__ == "__main__":
    main()
