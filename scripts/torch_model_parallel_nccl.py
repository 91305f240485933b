"""Tensor, sequence and pipeline parallelism on the cards: each mesh's
losses against one card, 32 layers over four cards, and a tensor-parallel
checkpoint read back at world 1.

Runs of the port's ``llama_pretrain`` (AGD, the example's batch stream
of ``--batch`` rows a step, every rank drawing the global batch and
training on its rows), one card a worker, launched by
``python -m dlrover_tpu_torch.run``; a worker of this script builds the
``Strategy`` (the example has flags for data, fsdp and tensor only):

(a) Llama-2-7B widths at 8 layers, global batch 4 x 2048, 6 steps: one
    card alone, then on two cards ``{tensor 2}``, ``{seq 2}`` with
    Ulysses, ``{seq 2}`` with ring attention (``DLROVER_TPU_SP_KERNEL``)
    and ``{pipe 2}`` with 4 microbatches.  Each run's losses and grad
    norms must be within ``TOL`` of the one-card run's (bf16 compute:
    partial sums over the tensor ranks, other GEMM shapes, gradients
    summed in another order).  Prints each rank's step window on the
    card's clock, its peak reserved memory and its launches of B1 (and
    the RMSNorm backward) and B2-B4 over the 6 steps.
(b) Llama-2-7B at its published 32 layers over four cards at ``{pipe 2,
    tensor 2}``, 6 steps: 16 B of state a parameter is 108 GB, ~27 GB a
    card, with no per-step gather.  Prints each card's peak reserved
    memory and window.
(c) The ``{tensor 2}`` run of (a) persists its last step; after (b) this
    process restores it at world 1 (``DLROVER_TPU_PREV_WORLD=2``: the
    layout-aware load reads each leaf from both shards), and every leaf
    must equal the two-card run's reassembled leaf bit for bit.

With ``--device cpu`` the same runs go through gloo at a small size
(fp32, ``TOL_CPU``; (b) at 4 layers).  Prints the card's name and power
limit.  Runs live under ``build/mp_nccl/``; the launchers' output goes to
``chiprun_out/mp_nccl/``.

    python3 scripts/torch_model_parallel_nccl.py               # four cards
    python3 scripts/torch_model_parallel_nccl.py --device cpu  # gloo
    python3 scripts/torch_model_parallel_nccl.py --skip-32     # (a), (c)
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
CPU_4 = [*CPU[:7], "4", *CPU[8:]]
# |loss - one card's| and |grad_norm / one card's - 1| at every step:
# scripts/torch_fsdp_nccl.py's limits (bf16 on the card, fp32 on the CPU)
TOL = {"loss": 1e-2, "grad_norm": 3e-2}
TOL_CPU = {"loss": 1e-5, "grad_norm": 1e-4}
# no snapshot to shared memory before the last step's persist
CKPT = ["--save_memory_interval", "100", "--save_storage_interval", "100"]
KERNELS = ("rms_norm", "rms_norm_bwd", "flash_fwd", "flash_bwd_dkv",
           "flash_bwd_dq")
#: (name, strategy, SP kernel): the two-card meshes of (a)
MESHES = (("tensor2", "tensor=2", ""),
          ("seq2_ulysses", "seq=2", "ulysses"),
          ("seq2_ring", "seq=2", "ring"),
          ("pipe2", "pipe=2,pipe_microbatches=4", ""))


def require(ok, what):
    if not ok:
        raise SystemExit(f"FAIL: {what}")


def run(name: str, root: Path, logs: Path, model, nproc: int, strategy="",
        kernel="", ckpt: str = ""):
    """One run; returns ({rank: report}, seconds)."""
    rep = root / name
    rep.mkdir(parents=True)
    args = [*model, "--report_dir", str(rep)]
    if ckpt:
        args += ["--ckpt_dir", ckpt, *CKPT]
    worker = [str(Path(__file__).resolve()), "--worker", strategy or "-",
              "--", *args]
    if nproc == 1:
        cmd = [sys.executable, *worker]
    else:
        cmd = [sys.executable, "-m", "dlrover_tpu_torch.run", "--nnodes=1",
               f"--nproc_per_node={nproc}", "--max-restarts=0",
               "--monitor_interval=0.2", *worker]
    # the agent's preemption watcher asks a metadata endpoint on this
    # machine that refuses connections, never a real one
    env = dict(os.environ, PYTHONPATH=str(REPO),
               DLROVER_TPU_METADATA_BASE="http://127.0.0.1:9/",
               DLROVER_TPU_SP_KERNEL=kernel or "auto")
    if "cpu" in model:
        env["OMP_NUM_THREADS"] = "1"
    else:
        # scripts/torch_fsdp_nccl.py's allocator setting: without it cached
        # blocks fragment what the 32-layer state leaves
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
    print(f"{name}: losses {[h['loss'] for h in got]} grad_norms "
          f"{[h['grad_norm'] for h in got]}; against one card: max |d loss| "
          f"{max(dl):.3g}, max rel d grad_norm {max(dn):.3g} (tol {tol})",
          flush=True)
    require(len(got) == len(want) == 6, f"{name}: {len(got)} steps")
    require(max(dl) <= tol["loss"] and max(dn) <= tol["grad_norm"],
            f"{name} differs from the one-card run")


def reserved_gib(report):
    """The peak reserved card memory of a run's report (0 on the CPU)."""
    return report.get("cuda_memory", {}).get("max_reserved", 0) / 2**30


def window_ms(hist):
    return 1e3 * sum(h["step_time_s"] for h in hist[1:]) / (len(hist) - 1)


def describe(name, reps, one=None):
    for r in sorted(reps):
        rep = reps[r]
        launches = {k: rep["launches"].get(k, 0) for k in KERNELS}
        print(f"{name} rank {r} on {rep['device']}: step_ms (card clock) "
              f"{[1e3 * h['step_time_s'] for h in rep['history']]} "
              f"window(2-6) {window_ms(rep['history'])} peak reserved GiB "
              f"{reserved_gib(rep)} max allocated GiB "
              f"{rep.get('cuda_memory', {}).get('max_allocated', 0) / 2**30}"
              f" launches (6 steps) {launches}"
              + ("" if one is None else
                 f"; one card: window {window_ms(one['history'])} reserved"
                 f" {reserved_gib(one)}"), flush=True)


def restore_world1(ckpt: str, model, device: str):
    """The persisted ``{tensor 2}`` step read back in this process at
    world 1; returns its leaf digests, the step and the io log."""
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
        load_strategy=Strategy(data=1), device=device or None)
    trainer = Trainer(result, TrainingArgs(
        max_steps=args.steps, checkpoint_dir=ckpt,
        snapshot_mode="staged"), lambda: iter(()))
    try:
        step = trainer.restore()
        io = [list(r[:2]) for r in trainer.checkpoint_engine.io_log]
        return ex.leaf_digests(trainer.state), step, io
    finally:
        trainer.checkpoint_engine.close()
        del trainer, result
        gc.collect()
        if torch.cuda.is_available():
            torch.cuda.empty_cache()


def worker(spec: str, example_args):
    """One rank: the example with the strategy ``spec`` (``seq=2,...``;
    ``-``: the example's own flags), data parallel over what is left."""
    sys.path.insert(0, str(REPO))
    from dlrover_tpu_torch.accelerate import Strategy
    from dlrover_tpu_torch.trainer.elastic.context import process_count
    from dlrover_tpu_torch.examples import llama_pretrain

    strategy = None
    if spec != "-":
        sizes = {k: int(v) for k, v in (kv.split("=")
                                        for kv in spec.split(","))}
        used = 1
        for k in ("fsdp", "tensor", "seq", "pipe", "expert"):
            used *= sizes.get(k, 1)
        strategy = Strategy(data=process_count() // used, **sizes)
    llama_pretrain.main(example_args, strategy=strategy)


def main():
    if "--worker" in sys.argv:
        i = sys.argv.index("--worker")
        return worker(sys.argv[i + 1], sys.argv[sys.argv.index("--") + 1:])
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default="",
                    help="cpu for a gloo run without a card")
    ap.add_argument("--skip-32", action="store_true",
                    help="leave out (b), the 32-layer run on four cards")
    args = ap.parse_args()
    sys.path.insert(0, str(REPO))
    cpu = args.device == "cpu"
    if not cpu:
        import torch

        need = 2 if args.skip_32 else 4
        require(torch.cuda.device_count() >= need, f"needs {need} cards")
        print(subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True,
            text=True).stdout.strip(), flush=True)
        from dlrover_tpu_torch.ops import _build

        # the workers load these libraries and compile nothing
        print(f"kernels built in {_build.build():.1f} s", flush=True)
    model8 = CPU if cpu else CARD_8
    tol = TOL_CPU if cpu else TOL
    root = REPO / "build" / "mp_nccl"
    logs = REPO / "chiprun_out" / "mp_nccl"
    for d in (root, logs):
        shutil.rmtree(d, ignore_errors=True)
    logs.mkdir(parents=True)
    ckpt = str(root / "ckpt")
    summary = {}
    try:
        one, w1 = run("one_card", root, logs, model8, 1)
        want = one[0]["history"]
        describe("(a) one card", one)
        summary["a"] = {"one_card": {"s": w1,
                                     "window_ms": window_ms(want)}}
        tensor2 = None
        for name, strategy, kernel in MESHES:
            reps, wall = run(name, root, logs, model8, 2, strategy, kernel,
                             ckpt=ckpt if name == "tensor2" else "")
            for r in (0, 1):
                compare(f"(a) {name} rank {r}", reps[r]["history"], want,
                        tol)
            describe(f"(a) {name}", reps, one[0])
            if not cpu:
                for r in (0, 1):
                    require(all(reps[r]["launches"].get(k, 0)
                                for k in KERNELS),
                            f"(a) {name} rank {r}: a kernel did not launch")
            summary["a"][name] = {
                "s": wall,
                "window_ms": [window_ms(reps[r]["history"]) for r in (0, 1)],
                "max_reserved_gib": [reserved_gib(reps[r]) for r in (0, 1)]}
            if name == "tensor2":
                tensor2 = reps
        g = [tensor2[r].get("global_digests") for r in (0, 1)]
        require(g[0] and g[0] == g[1],
                "(a) {tensor 2}: the ranks' reassembled states differ")
        require(tensor2[0]["digests"] != tensor2[1]["digests"],
                "(a) {tensor 2}: the ranks hold the same slices")

        if not args.skip_32:
            big, wb = run("pipe2_tensor2_32", root, logs,
                          CPU_4 if cpu else CARD_32, 4,
                          "pipe=2,tensor=2,pipe_microbatches=4")
            describe("(b) 32 layers {pipe 2, tensor 2}" if not cpu else
                     "(b) 4 layers {pipe 2, tensor 2}", big)
            for r in range(4):
                h = big[r]["history"]
                require(len(h) == 6 and all(x["loss"] == x["loss"]
                                            for x in h), "(b) steps")
            losses = {tuple(x["loss"] for x in big[r]["history"])
                      for r in range(4)}
            require(len(losses) == 1, "(b) the ranks' losses differ")
            print(f"(b) losses {sorted(losses)[0]}", flush=True)
            summary["b"] = {"s": wb, "window_ms": [
                window_ms(big[r]["history"]) for r in range(4)],
                "max_reserved_gib": [reserved_gib(big[r])
                                     for r in range(4)]}
        digests, step, io = restore_world1(ckpt, model8, args.device)
        diff = sorted(k for k in g[0] if digests.get(k) != g[0][k])
        print(f"(c) world 1 restored step {step} from the {{tensor 2}} "
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
