"""The strategy search on two and four cards: the analytic ranking, the
race of timed dry runs agreed across the ranks, the winner's training,
and a pinned strategy re-solved for a smaller world.

Workers are this script (``--worker <phase>``), one card a worker,
launched by ``python -m dlrover_tpu_torch.run``; AGD, Llama-2-7B widths,
the example's batch stream (``llama_pretrain.batches``):

(t) ``{tensor 2}``'s first steps (8 layers, global 4 x 2048), where PR
    12's run measured a second step of ~940 ms against ~220 ms after it:
    the example as PR 12 ran it (with its checkpoint directory) and
    without a checkpoint directory, 6 steps each, every step's time on
    the card's clock; then in one process a ``{tensor 2}`` step loop
    with NCCL's ``INIT`` log on and each of the first three steps
    traced by ``torch.profiler`` (the device time by kernel, the NCCL
    kernels' share, the host's time in the step).
(a) Two cards, 8 layers, global 4 x 2048, without a dry run: the
    analytic ranking (``generate_candidates`` with each candidate's
    modelled cost) and ``candidates[0]``.
(b) The same with a dry run: ``successive_halving`` over the ranking,
    every round's agreed times, the winner; both ranks' winners must be
    equal, every raced candidate must have launched B1-B4, and the
    card's allocated memory after the race must be within 1 GiB of
    before (the card's used memory, with the communicators' buffers, is
    printed beside it).
(c) The winner trains 6 steps (``Trainer``); its window beside the
    one-axis windows of PR 12 (the same shape).
(d) A ``{data 2}`` strategy pinned at world 1 is re-solved
    (``solver.resolve_for_world``) and trains 6 steps.
(e) Four cards (unless ``--skip-32``), 32 layers, global 4 x 2048: the
    race of (b) where the memory model admits only sharded candidates; a
    candidate whose build runs out of memory is recorded as failed on
    every rank.

With ``--device cpu`` the same runs go through gloo at a small size
(fp32, 4 layers; (t) without the profiler).  Prints the card's name and
power limit.  Runs live under ``build/search_nccl/``; the launchers'
output goes to ``chiprun_out/search_nccl/``.

    python3 scripts/torch_strategy_search_nccl.py               # four cards
    python3 scripts/torch_strategy_search_nccl.py --device cpu  # gloo
    python3 scripts/torch_strategy_search_nccl.py --skip-32     # two cards
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
CARD_8 = ["--config", "llama2_7b", "--layers", "8", "--batch", "4",
          "--seq", "2048", "--steps", "6"]
CARD_32 = ["--config", "llama2_7b", "--layers", "32", "--batch", "4",
           "--seq", "2048", "--steps", "6"]
CPU = ["--device", "cpu", "--dtype", "float32", "--dim", "64", "--layers",
       "4", "--heads", "4", "--seq", "256", "--batch", "4", "--steps", "6"]
# PR 12's checkpoint flags: no snapshot to shared memory before the last
# step's persist
CKPT = ["--save_memory_interval", "100", "--save_storage_interval", "100"]
KERNELS = ("rms_norm", "rms_norm_bwd", "flash_fwd", "flash_bwd_dkv",
           "flash_bwd_dq")
#: PR 12 call 4 (two H100 80GB HBM3, 700 W): one-axis windows (steps 2-6,
#: ms) at 8 layers, global 4 x 2048
PR12_WINDOWS = {"one card": 339.763, "tp=2": "215.7-225.4 (steps 3-6)",
                "sp=2 (Ulysses)": 303.305, "sp=2 (ring)": 311.664,
                "pp=2": 375.966, "dp=2 (PR 11)": 288.224,
                "fsdp=2 (PR 11)": 282.055}
MEM_SLACK = 1 << 30
PROFILED_STEPS = 3


def require(ok, what):
    if not ok:
        raise SystemExit(f"FAIL: {what}")


def launch(name, root, logs, nproc, worker_args, env_extra=None,
           timeout=900):
    """One launcher run of this script's worker; returns the reports of
    its ranks (``<root>/<name>/rank<r>.json``) and the wall seconds."""
    rep = root / name
    rep.mkdir(parents=True)
    worker = [str(Path(__file__).resolve()), "--worker", *worker_args,
              "--report", str(rep)]
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
               **(env_extra or {}))
    if "cpu" in worker_args:
        env["OMP_NUM_THREADS"] = "1"
    else:
        env.setdefault("PYTORCH_CUDA_ALLOC_CONF", "expandable_segments:True")
    t0 = time.time()
    proc = subprocess.run(cmd, cwd=REPO, capture_output=True, text=True,
                          timeout=timeout, env=env)
    wall = time.time() - t0
    text = proc.stdout + proc.stderr
    (logs / f"{name}.log").write_text(text)
    if proc.returncode != 0:
        raise SystemExit(f"{name}: exited {proc.returncode}:\n{text[-6000:]}")
    out = {}
    for p in rep.glob("rank*.json"):
        d = json.loads(p.read_text())
        out[d["rank"]] = d
    require(set(out) == set(range(nproc)), f"{name}: reports {sorted(out)}")
    return out, wall


def window_ms(hist):
    return 1e3 * sum(h["step_time_s"] for h in hist[1:]) / (len(hist) - 1)


# ------------------------------------------------------------ the workers


def _model(example_args):
    import torch

    from dlrover_tpu_torch.examples import llama_pretrain as ex
    from dlrover_tpu_torch.models.llama import (
        check_mesh,
        init_params,
        loss_fn,
        param_logical_axes,
    )
    from dlrover_tpu_torch.optimizers import AGD

    args = ex.parse_args(example_args)
    cfg = ex.model_config(args)
    return args, cfg, dict(
        loss_fn=lambda p, b: loss_fn(p, b, cfg),
        optimizer=lambda ps: AGD(ps, lr=3e-4),
        init_params_fn=lambda gen, dev: init_params(
            cfg, gen, dev, dtype=torch.float32),
        param_axes=param_logical_axes(cfg),
        check_mesh=lambda m: check_mesh(cfg, m))


def _card_memory(dev):
    import torch

    if dev.type != "cuda":
        return {}
    torch.cuda.synchronize(dev)
    free, total = torch.cuda.mem_get_info(dev)
    return {"allocated": torch.cuda.memory_allocated(dev),
            "used": total - free}


def _train(result, args, cfg, ckpt_dir=""):
    """The ``Trainer`` over the example's stream for ``args.steps``."""
    from dlrover_tpu_torch.examples import llama_pretrain as ex
    from dlrover_tpu_torch.ops import _build
    from dlrover_tpu_torch.trainer import Trainer, TrainingArgs

    trainer = None

    def data_iter():
        return ex.batches(trainer.progress.global_step, args,
                          cfg.vocab_size)

    trainer = Trainer(result, TrainingArgs(
        max_steps=args.steps, log_interval=0, checkpoint_dir=ckpt_dir,
        save_memory_interval=100, save_storage_interval=100), data_iter)
    _build.reset_launches()
    trainer.train()
    if trainer.checkpoint_engine is not None:
        trainer.checkpoint_engine.close()
    return trainer.history, dict(_build.launches)


def _device_us(event) -> float:
    """An averaged profiler event's own time on the card (microseconds;
    the attribute's name moved between PyTorch versions)."""
    for name in ("self_device_time_total", "self_cuda_time_total"):
        if hasattr(event, name):
            return float(getattr(event, name))
    return 0.0


def worker_trace(example_args, report):
    """``{tensor 2}`` in one process: each of the first
    ``PROFILED_STEPS`` steps under its own profiler (on the card), then
    the rest; every step's time on the card's clock and the host's."""
    import torch

    from dlrover_tpu_torch.accelerate import Strategy, auto_accelerate
    from dlrover_tpu_torch.examples import llama_pretrain as ex

    args, cfg, kw = _model(example_args)
    result = auto_accelerate(load_strategy=Strategy(tensor=2),
                             device=args.device, **kw)
    fns, dev = result.fns, result.fns.device
    state = fns.init_state(0)
    stream = ex.batches(0, args, cfg.vocab_size)
    steps, traces = [], []
    for i in range(args.steps):
        b = {k: torch.from_numpy(v).to(dev) for k, v in
             fns.batch_sharding.local(next(stream)).items()}
        prof = None
        if dev.type == "cuda" and i < PROFILED_STEPS:
            from torch.profiler import ProfilerActivity, profile

            prof = profile(activities=[ProfilerActivity.CPU,
                                       ProfilerActivity.CUDA])
            prof.__enter__()
        print(f"[step] {i + 1} begins at {time.time():.6f}", flush=True)
        t0 = time.perf_counter()
        if dev.type == "cuda":
            start = torch.cuda.Event(enable_timing=True)
            start.record()
        state, m = fns.train_step(state, b)
        loss = float(m["loss"])
        if dev.type == "cuda":
            m["done"].synchronize()
            card_ms = start.elapsed_time(m["done"])
        else:
            card_ms = None
        host_ms = 1e3 * (time.perf_counter() - t0)
        print(f"[step] {i + 1} ends at {time.time():.6f}: card "
              f"{card_ms} ms, host {host_ms:.3f} ms, loss {loss}",
              flush=True)
        steps.append({"step": i + 1, "card_ms": card_ms,
                      "host_ms": host_ms, "loss": loss})
        if prof is not None:
            prof.__exit__(None, None, None)
            rows = [(e, _device_us(e)) for e in prof.key_averages()]
            rows = [(e, us) for e, us in rows if us > 0]
            total = sum(us for _, us in rows)
            nccl = sum(us for e, us in rows if "nccl" in e.key.lower())
            top = sorted(rows, key=lambda r: -r[1])[:12]
            traces.append({
                "step": i + 1, "device_ms": total / 1e3,
                "nccl_ms": nccl / 1e3,
                "top": [(e.key[:80], round(us / 1e3, 3), e.count)
                        for e, us in top]})
            print(f"[trace] step {i + 1}: device {total / 1e3:.3f} ms "
                  f"(NCCL kernels {nccl / 1e3:.3f}) top {traces[-1]['top']}",
                  flush=True)
    return {"steps": steps, "traces": traces,
            "strategy": result.strategy.describe()}


def worker_race(example_args, report):
    """(a)-(c) or (e): the analytic ranking, the race, the winner's
    training."""
    import torch

    from dlrover_tpu_torch.accelerate import (
        api,
        auto_accelerate,
        dry_runner,
    )
    from dlrover_tpu_torch.accelerate.strategy import (
        estimate_step_cost,
        generate_candidates,
    )
    from dlrover_tpu_torch.examples import llama_pretrain as ex
    from dlrover_tpu_torch.ops import _build
    from dlrover_tpu_torch.trainer.elastic.context import init_distributed

    args, cfg, kw = _model(example_args)
    ctx = init_distributed(args.device)
    dev = ctx.device
    world = ctx.world_size
    gb, seq = args.batch, args.seq
    profile = api.analyse_model(kw["init_params_fn"], kw["optimizer"])
    ranking = [(s.describe(), s.num_micro_steps,
                estimate_step_cost(s, profile, gb / world, seq))
               for s in generate_candidates(profile, world, global_batch=gb,
                                            seq_len=seq)]
    plain = auto_accelerate(global_batch=gb, seq_len=seq, device=dev, **kw)
    first = plain.strategy
    del plain
    builds = []
    run_steps, step_for = dry_runner._run_steps, api._step_for
    building = {}

    def tracked(strategy, *a, **k):
        building["s"] = strategy.describe()
        return step_for(strategy, *a, **k)

    def counted(live, warmup, steps):
        before = dict(_build.launches)
        out = run_steps(live, warmup, steps)
        builds.append({"strategy": building["s"],
                       "step_ms": [round(1e3 * t, 3) for t in out],
                       "launches": {k: _build.launches[k] - before[k]
                                    for k in KERNELS}})
        return out

    def sample(bs):
        b = next(ex.batches(0, args, cfg.vocab_size))
        return {k: torch.from_numpy(v).to(dev)
                for k, v in bs.local(b).items()}

    mem_before = _card_memory(dev)
    api._step_for, dry_runner._run_steps = tracked, counted
    t0 = time.time()
    try:
        result = auto_accelerate(dry_run=True, sample_batch_fn=sample,
                                 global_batch=gb, seq_len=seq, device=dev,
                                 **kw)
    finally:
        api._step_for, dry_runner._run_steps = step_for, run_steps
    race_s = time.time() - t0
    mem_after = _card_memory(dev)
    hist, launches = _train(result, args, cfg)
    return {"ranking": ranking, "first": first.describe(),
            "winner": result.strategy.describe(),
            "winner_strategy": str(result.strategy),
            "timings": result.timings, "builds": builds,
            "race_s": race_s, "memory": [mem_before, mem_after],
            "planner": [float(w) for w in result.planner.weights],
            "history": hist, "launches": launches}


def worker_resolve(example_args, report):
    """(d): ``{data 2}`` pinned at world 1."""
    from dlrover_tpu_torch.accelerate import Strategy, auto_accelerate

    args, cfg, kw = _model(example_args)
    result = auto_accelerate(load_strategy=Strategy(data=2),
                             global_batch=args.batch, seq_len=args.seq,
                             device=args.device, **kw)
    hist, launches = _train(result, args, cfg)
    return {"pinned": "dp=2", "strategy": result.strategy.describe(),
            "history": hist, "launches": launches}


WORKERS = {"trace": worker_trace, "race": worker_race,
           "resolve": worker_resolve}


def worker(phase, report, example_args):
    sys.path.insert(0, str(REPO))
    import logging

    from dlrover_tpu_torch.ops import _build
    from dlrover_tpu_torch.trainer.elastic.context import (
        init_distributed,
        shutdown_distributed,
    )

    logging.basicConfig(level=logging.INFO, format="%(message)s")
    if phase == "example":
        # PR 12's run: the example with the strategy of the next arg
        from dlrover_tpu_torch.accelerate import Strategy
        from dlrover_tpu_torch.examples import llama_pretrain

        sizes = {k: int(v) for k, v in (kv.split("=") for kv in
                                        example_args[0].split(","))}
        llama_pretrain.main([*example_args[1:], "--report_dir", report],
                            strategy=Strategy(**sizes))
        for p in Path(report).glob("rank*_inc0.json"):
            p.rename(p.with_name(p.name.replace("_inc0", "")))
        return
    ctx = init_distributed("cpu" if "cpu" in example_args else None)
    if ctx.device.type == "cuda":
        _build.build()
    out = WORKERS[phase](example_args, report)
    out.update(rank=ctx.rank, world=ctx.world_size, device=str(ctx.device))
    with open(os.path.join(report, f"rank{ctx.rank}.json"), "w") as f:
        json.dump(out, f)
    shutdown_distributed()


# ------------------------------------------------------------- the driver


def main():
    if "--worker" in sys.argv:
        i = sys.argv.index("--worker")
        report = sys.argv[sys.argv.index("--report") + 1]
        rest = sys.argv[i + 1:sys.argv.index("--report")]
        return worker(rest[0], report, rest[1:])
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default="",
                    help="cpu for a gloo run without a card")
    ap.add_argument("--skip-32", action="store_true",
                    help="leave out (e), the 32-layer race on four cards")
    ap.add_argument("--skip-trace", action="store_true",
                    help="leave out (t)")
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
    root = REPO / "build" / "search_nccl"
    logs = REPO / "chiprun_out" / "search_nccl"
    for d in (root, logs):
        shutil.rmtree(d, ignore_errors=True)
    logs.mkdir(parents=True)
    summary = {}
    try:
        if not args.skip_trace:
            summary["t"] = {}
            for name, ckpt in (("tensor2_ckpt", True), ("tensor2", False)):
                extra = []
                if ckpt:
                    extra = ["--ckpt_dir", str(root / "ckpt"), *CKPT]
                reps, wall = launch(name, root, logs, 2,
                                    ["example", "tensor=2", *model8, *extra])
                for r in (0, 1):
                    h = reps[r]["history"]
                    print(f"(t) {name} rank {r}: step ms (card clock) "
                          f"{[round(1e3 * x['step_time_s'], 3) for x in h]}"
                          f" window(2-6) {window_ms(h):.3f}", flush=True)
                summary["t"][name] = {
                    "s": wall, "step_ms": [[1e3 * x["step_time_s"]
                                            for x in reps[r]["history"]]
                                           for r in (0, 1)]}
            reps, wall = launch(
                "tensor2_traced", root, logs, 2, ["trace", *model8],
                env_extra={"NCCL_DEBUG": "INFO",
                           "NCCL_DEBUG_SUBSYS": "INIT"})
            for r in (0, 1):
                print(f"(t) traced {{tensor 2}} rank {r}: "
                      f"{reps[r]['steps']}", flush=True)
            summary["t"]["traced"] = {r: reps[r] for r in (0, 1)}

        reps, wall = launch("race2", root, logs, 2, ["race", *model8])
        for r in (0, 1):
            rep = reps[r]
            print(f"(a) rank {r}: ranking {rep['ranking']}; candidates[0] "
                  f"{rep['first']}", flush=True)
            print(f"(b) rank {r}: agreed timings {rep['timings']}; winner "
                  f"{rep['winner_strategy']}; race {rep['race_s']:.1f} s; "
                  f"memory before/after {rep['memory']}; planner "
                  f"{rep['planner']}", flush=True)
            for b in rep["builds"]:
                print(f"(b) rank {r} build {b}", flush=True)
            steps = [round(1e3 * h["step_time_s"], 3)
                     for h in rep["history"]]
            print(f"(c) rank {r}: winner {rep['winner']} step ms {steps} "
                  f"window(2-6) {window_ms(rep['history']):.3f} against "
                  f"PR 12 {PR12_WINDOWS}", flush=True)
        w = [reps[r]["winner_strategy"] for r in (0, 1)]
        require(w[0] == w[1], f"(b) the ranks' winners differ: {w}")
        require(json.dumps(reps[0]["timings"], sort_keys=True)
                == json.dumps(reps[1]["timings"], sort_keys=True),
                "(b) the ranks' agreed timings differ")
        for r in (0, 1):
            rep = reps[r]
            if not cpu:
                require(all(all(b["launches"].values())
                            for b in rep["builds"]),
                        "(b) a raced candidate did not launch B1-B4")
                a = [m["allocated"] for m in rep["memory"]]
                require(abs(a[1] - a[0]) <= MEM_SLACK,
                        f"(b) rank {r}: the race left {a} allocated")
        summary["a-c"] = {r: reps[r] for r in (0, 1)}

        reps, wall = launch("resolve1", root, logs, 1, ["resolve", *model8])
        rep = reps[0]
        print(f"(d) {rep['pinned']} pinned at world 1 -> "
              f"{rep['strategy']}: step ms "
              f"{[round(1e3 * h['step_time_s'], 3) for h in rep['history']]}"
              f" window(2-6) {window_ms(rep['history']):.3f}", flush=True)
        require(rep["strategy"] == "single-device" and len(
            rep["history"]) == 6, "(d) the re-solve")
        summary["d"] = rep

        if not args.skip_32:
            model32 = [*CPU[:7], "8", *CPU[8:]] if cpu else CARD_32
            reps, wall = launch("race4", root, logs, 4, ["race", *model32],
                                timeout=1500)
            for r in range(4):
                rep = reps[r]
                print(f"(e) rank {r}: ranking {rep['ranking']}; agreed "
                      f"timings {rep['timings']}; winner "
                      f"{rep['winner_strategy']}; race "
                      f"{rep['race_s']:.1f} s; memory {rep['memory']}; "
                      f"window(2-6) {window_ms(rep['history']):.3f}",
                      flush=True)
            for b in reps[0]["builds"]:
                print(f"(e) rank 0 build {b}", flush=True)
            require(len({reps[r]["winner_strategy"] for r in range(4)}) == 1,
                    "(e) the ranks' winners differ")
            summary["e"] = {r: reps[r] for r in range(4)}
    finally:
        (logs / "summary.json").write_text(json.dumps(summary))
        shutil.rmtree(root, ignore_errors=True)
    print(json.dumps({"ok": True}))


if __name__ == "__main__":
    main()
