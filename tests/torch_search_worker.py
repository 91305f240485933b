"""One rank of the strategy search on the CPU (gloo), driven by
``tests/test_torch_search.py``.

    python tests/torch_search_worker.py <out_dir>

with ``DLROVER_TPU_PROCESS_RANK``/``_COUNT``/``_COORDINATOR_ADDR`` set.
``auto_accelerate`` over ``LlamaConfig.tiny(n_kv_heads=4)`` (fp32, a
global batch of 4 rows of 16 + 1 tokens) six times, each rank writing
what it got to ``<out_dir>/<phase>_rank<r>.pt``:

- ``slow``: a dry run in which rank 1's timer reads 5 s more for the
  analytic ranking's first candidate (every step of it);
- ``build_fail``: a dry run in which every build of an fsdp candidate
  raises on rank 1 alone (after its mesh exists);
- ``plain``: no dry run (the analytic ranking's first);
- ``heads``: a dry run of ``LlamaConfig.tiny()`` (two kv heads), whose
  ``check_mesh`` fails the candidates with tensor 4 at their build;
- ``late``: a dry run in which rank 1 ends every warm-up ``LATE_S``
  late (the other ranks must not time the wait);
- ``step_fail``: a dry run in which rank 1's first timed step raises;
  rank 1 records what it raised and dies as a crashed worker does
  (``os._exit(3)``), the other ranks record how their collective ended.

Beside each result: the number of process groups this rank holds
before and after the call, and how many of them the returned mesh
holds.  Imports torch and the port only.
"""

import os
import sys
import time
import traceback

import numpy as np
import torch

SLOW_S = 5.0
LATE_S = 2.0


def _groups() -> int:
    import torch.distributed as dist

    return len(dist.distributed_c10d._world.pg_map)


def _mesh_groups(mesh_ctx) -> int:
    """The groups of its own a mesh holds (not the world's)."""
    import torch.distributed as dist

    if mesh_ctx.mesh is None:
        return 0
    world = dist.distributed_c10d._get_default_group()
    groups = [mesh_ctx.mesh.get_group(n)
              for n in mesh_ctx.mesh.mesh_dim_names]
    groups += list(mesh_ctx.groups.values())
    return len({id(g) for g in groups if g is not world})


def main(out_dir: str):
    torch.set_num_threads(1)
    sys.path.insert(0, os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))))
    import torch.distributed as dist

    from dlrover_tpu_torch.accelerate import api, dry_runner
    from dlrover_tpu_torch.models import llama as tl
    from dlrover_tpu_torch.optimizers import AGD
    from dlrover_tpu_torch.trainer.elastic.context import (
        init_distributed,
        shutdown_distributed,
    )

    ctx = init_distributed("cpu")
    rank = ctx.rank
    # as many kv heads as heads: every candidate of four ranks (tensor 4
    # too) holds whole heads a rank
    cfg = tl.LlamaConfig.tiny(n_kv_heads=4, dtype=torch.float32)
    tokens = np.random.default_rng(3).integers(
        0, cfg.vocab_size, (4, 17)).astype(np.int32)
    building = {}
    run_steps, step_for = dry_runner._run_steps, api._step_for

    def tracked_step_for(strategy, *a, **kw):
        building["strategy"] = strategy
        return step_for(strategy, *a, **kw)

    api._step_for = tracked_step_for

    def accelerate(dry_run=True, model=cfg):
        return api.auto_accelerate(
            loss_fn=lambda p, b: tl.loss_fn(p, b, model),
            optimizer=lambda ps: AGD(ps, lr=1e-3),
            init_params_fn=lambda gen, dev: tl.init_params(
                model, gen, dev, dtype=torch.float32),
            param_axes=tl.param_logical_axes(model),
            sample_batch_fn=lambda bs: {"tokens": torch.from_numpy(
                bs.local({"tokens": tokens})["tokens"])},
            dry_run=dry_run, global_batch=4, seq_len=16, device="cpu",
            check_mesh=lambda m: tl.check_mesh(model, m))

    def record(phase, model=cfg, **extra):
        before = _groups()
        result = accelerate(dry_run=phase != "plain", model=model)
        torch.save({"strategy": result.strategy, "timings": result.timings,
                    "groups": (before, _groups()),
                    "mesh_groups": _mesh_groups(result.mesh_ctx), **extra},
                   os.path.join(out_dir, f"{phase}_rank{rank}.pt"))
        dist.barrier()

    first = api.generate_candidates(
        api.analyse_model(lambda g, d: tl.init_params(
            cfg, g, d, dtype=torch.float32)), ctx.world_size,
        global_batch=4, seq_len=16)[0]

    def slow_steps(live, warmup, steps):
        out = run_steps(live, warmup, steps)
        if building["strategy"] == first:
            out = [t + SLOW_S for t in out]
        return out

    if rank == 1:
        dry_runner._run_steps = slow_steps
    record("slow", slowed=first.describe())
    dry_runner._run_steps = run_steps

    def failing_step_for(strategy, *a, **kw):
        if strategy.fsdp > 1:
            raise RuntimeError("planted build failure")
        return tracked_step_for(strategy, *a, **kw)

    if rank == 1:
        api._step_for = failing_step_for
    record("build_fail")
    api._step_for = tracked_step_for
    record("plain")
    # two kv heads: the model's check fails tensor 4 at its build
    record("heads", model=tl.LlamaConfig.tiny(dtype=torch.float32))

    def late_step_for(strategy, *a, **kw):
        fns, rules = tracked_step_for(strategy, *a, **kw)
        step, calls = fns.train_step, []

        def train_step(state, batch):
            out = step(state, batch)
            calls.append(1)
            if len(calls) == dry_runner.WARMUP_STEPS:
                time.sleep(LATE_S)  # this rank ends its warm-up late
            return out

        fns.train_step = train_step
        return fns, rules

    if rank == 1:
        api._step_for = late_step_for
    record("late")
    api._step_for = tracked_step_for

    def crashing_step_for(strategy, *a, **kw):
        fns, rules = tracked_step_for(strategy, *a, **kw)
        step, calls = fns.train_step, []

        def train_step(state, batch):
            calls.append(1)
            if len(calls) == 1 + dry_runner.WARMUP_STEPS:
                raise RuntimeError("planted step failure")
            return step(state, batch)

        fns.train_step = train_step
        return fns, rules

    if rank == 1:
        api._step_for = crashing_step_for
    path = os.path.join(out_dir, f"step_fail_rank{rank}.txt")
    try:
        accelerate()
        with open(path, "w") as f:
            f.write("returned")
    except Exception:  # noqa: BLE001 - what the search raised, recorded
        with open(path, "w") as f:
            f.write(traceback.format_exc())
        os._exit(3)
    shutdown_distributed()


if __name__ == "__main__":
    main(sys.argv[1])
