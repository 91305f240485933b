"""Llama pretraining on one GPU per process: auto_accelerate + Trainer +
AGD, with flash checkpoint and the elastic launch.

Port of ``examples/llama_pretrain.py`` (the same CLI, config recipe and
data stream) for one device a process.  It joins the world the agent
assembled (``init_distributed``, as the JAX example does at :47-49);
at world > 1 each rank trains the whole replica on the same batches,
since gradient sync across ranks is ROADMAP A4::

    python -m dlrover_tpu_torch.examples.llama_pretrain --steps 50
    python -m dlrover_tpu_torch.examples.llama_pretrain --device cpu \\
        --steps 4 --dim 64 --layers 2 --heads 4 --seq 32 --batch 2
    python -m dlrover_tpu_torch.run --nnodes=1 --nproc_per_node=2 \\
        --max-restarts=1 -m dlrover_tpu_torch.examples.llama_pretrain \\
        --device cpu --ckpt_dir /tmp/ck --steps 6 --dim 64 --layers 2 \\
        --heads 4 --seq 32 --batch 2

The batches are the JAX example's stream: one ``default_rng(0)``
drawing int32 tokens.  A worker that resumes after step ``s`` skips the
first ``s`` draws, so it trains on the batches the lost one would have
(``--repeat_batch``: every step trains on the stream's first batch).

``--report_dir`` makes each incarnation of each rank write what it saw
to ``<report_dir>/rank<r>_inc<n>.json``: how it was spawned and what it
found at its first line (``entry``: a zygote's fork or a plain process,
torch already imported, CUDA not initialised), host wall-clock marks of
its start-up (spawned by the agent, process start, ``import torch``,
the CUDA context, the kernels' libraries loaded, the port's modules
imported, ``auto_accelerate``, the ``Trainer`` (and its checkpoint
engine) built, and the ``Trainer``'s own marks: the state build, the
restore prefetch's staging, the restore, the first step), the sources
it compiled, the restore and the snapshots
(``io_log``), each step's loss, grad norm and time, and the kernels'
launch counts, zeroed after the restore and read after the last step.
A finished run adds a digest of every state leaf (``leaf_digests``).
``--crash_after_step N`` SIGKILLs rank ``--crash_rank`` of the first
incarnation (``DLROVER_TPU_RESTART_COUNT=0``) once step N's snapshot is
in shared memory: the fault the elastic launch recovers from.
"""

import time

T_START = time.time()  # before the heavy imports: the process's start

import argparse  # noqa: E402
import json  # noqa: E402
import logging  # noqa: E402
import os  # noqa: E402
import signal  # noqa: E402
import sys  # noqa: E402


def _entry() -> dict:
    """What this process found at its first line: how the agent spawned
    it (``DLROVER_TPU_SPAWN``: "zygote" or "plain") and when, whether
    torch was imported already (a zygote's child) and whether CUDA was
    initialised (it must not be: a context does not survive a fork)."""
    torch_mod = sys.modules.get("torch")
    spawned_at = os.environ.get("DLROVER_TPU_SPAWNED_AT", "")
    return {
        "spawn": os.environ.get("DLROVER_TPU_SPAWN", ""),
        "spawned_at": float(spawned_at) if spawned_at else None,
        "torch_preloaded": torch_mod is not None,
        "cuda_initialized": bool(
            torch_mod is not None and torch_mod.cuda.is_initialized()),
    }


ENTRY = _entry()

import numpy as np  # noqa: E402
import torch  # noqa: E402

T_TORCH = time.time()

#: words of a leaf digested at once (bounds the digest's temporaries)
_DIGEST_CHUNK = 1 << 24


def parse_args(argv=None):
    p = argparse.ArgumentParser()
    p.add_argument("--steps", type=int, default=50)
    p.add_argument("--batch", type=int, default=8)
    p.add_argument("--seq", type=int, default=128)
    p.add_argument("--dim", type=int, default=256)
    p.add_argument("--layers", type=int, default=4)
    p.add_argument("--heads", type=int, default=8)
    p.add_argument("--config", choices=("custom", "llama2_7b"),
                   default="custom",
                   help="llama2_7b: Llama-2-7B widths (dim 4096, vocab "
                   "32000) at --layers layers; --dim/--heads are ignored")
    p.add_argument("--dtype", choices=("bfloat16", "float32"),
                   default="bfloat16", help="compute dtype (masters fp32)")
    p.add_argument("--eval_interval", type=int, default=0,
                   help="evaluate on a held-out set every N steps (0 = off)")
    p.add_argument("--device", default=None,
                   help="cuda (default: cuda:<local rank>) or cpu")
    p.add_argument("--ckpt_dir", default="",
                   help="flash checkpoint directory (empty = none)")
    p.add_argument("--save_memory_interval", type=int, default=10)
    p.add_argument("--save_storage_interval", type=int, default=25)
    p.add_argument("--repeat_batch", action="store_true",
                   help="train every step on one batch")
    p.add_argument("--report_dir", default="")
    p.add_argument("--crash_after_step", type=int, default=0)
    p.add_argument("--crash_rank", type=int, default=0)
    return p.parse_args(argv)


def model_config(args):
    from dlrover_tpu_torch.models.llama import LlamaConfig

    dtype = getattr(torch, args.dtype)
    if args.config == "llama2_7b":
        return LlamaConfig.llama2_7b(n_layers=args.layers, dtype=dtype)
    return LlamaConfig(
        vocab_size=4096,
        dim=args.dim,
        n_layers=args.layers,
        n_heads=args.heads,
        n_kv_heads=max(args.heads // 2, 1),
        mlp_dim=args.dim * 3,
        max_seq_len=args.seq,
        dtype=dtype,
    )


def batches(done: int, args, vocab: int):
    """The host batches of steps ``done + 1``, ``done + 2``, ...: the JAX
    example's stream (``examples/llama_pretrain.py``), one
    ``default_rng(0)`` drawing int32 tokens, past its first ``done``
    batches."""
    rng = np.random.default_rng(0)
    size = (args.batch, args.seq + 1)

    def draw():
        return rng.integers(0, vocab, size=size, dtype=np.int32)

    if args.repeat_batch:
        first = draw()
        while True:
            yield {"tokens": first}
    for _ in range(done):
        draw()
    while True:
        yield {"tokens": draw()}


def leaf_digests(state) -> dict:
    """{JAX key path: digest} of a train state.  A tensor's digest is the
    plain and the position-weighted sum of its 32-bit words (bytes when
    its size is not a multiple of 4), each mod 2^64, computed where the
    tensor lies: a change of any one word changes the weighted sum
    (the weights are odd).  A Python number (a step count) is its
    value."""
    from dlrover_tpu_torch.models.convert import HostScalar, train_state_leaves

    out = {}
    for key, leaf in train_state_leaves(state):
        if isinstance(leaf, HostScalar):
            leaf = leaf.value()
        if not torch.is_tensor(leaf):
            out[key] = repr(np.asarray(leaf).tolist())
            continue
        flat = leaf.detach().contiguous().view(-1)
        if flat.numel() * flat.element_size() % 4 == 0:
            words = flat.view(torch.int32)
        else:
            words = flat.view(torch.uint8)
        plain = weighted = 0
        for lo in range(0, words.numel(), _DIGEST_CHUNK):
            w = words[lo:lo + _DIGEST_CHUNK].to(torch.int64)
            pos = torch.arange(lo, lo + w.numel(), device=w.device,
                               dtype=torch.int64)
            plain += int(w.sum())
            weighted += int((w * (2 * pos + 1)).sum())
        out[key] = f"{plain % 2**64:016x}{weighted % 2**64:016x}"
    return out


class _Report:
    """What one incarnation of one rank writes to ``--report_dir``."""

    def __init__(self, report_dir: str, ctx):
        self.path = os.path.join(
            report_dir, f"rank{ctx.rank}_inc{ctx.restart_count}.json")
        self.data = {"rank": ctx.rank, "world": ctx.world_size,
                     "restart_count": ctx.restart_count,
                     "pid": os.getpid(), "device": str(ctx.device),
                     "entry": ENTRY,
                     "marks": {"process_start": T_START,
                               "torch_imported": T_TORCH}}
        if ENTRY["spawned_at"] is not None:
            self.data["marks"]["spawned"] = ENTRY["spawned_at"]

    def write(self, trainer=None, **extra):
        from dlrover_tpu_torch.ops import _build

        d = self.data
        d["compiled"] = list(_build.compiled)
        d["launches"] = dict(_build.launches)
        if trainer is not None:
            d["marks"].update(trainer.marks)
            d["history"] = trainer.history
            d["save_times"] = trainer.save_times
            eng = trainer.checkpoint_engine
            d["io_log"] = [list(r) for r in eng.io_log] if eng else []
        d.update(extra)
        tmp = self.path + ".tmp"
        with open(tmp, "w") as f:
            json.dump(d, f)
        os.replace(tmp, self.path)


def main(argv=None):
    args = parse_args(argv)
    logging.basicConfig(level=logging.INFO, format="%(message)s")

    from dlrover_tpu_torch.ops import _build
    from dlrover_tpu_torch.trainer.elastic.context import (
        init_distributed,
        shutdown_distributed,
    )

    ctx = init_distributed(args.device)
    report = _Report(args.report_dir, ctx) if args.report_dir else None
    if ctx.device.type == "cuda":
        torch.cuda.init()
        torch.empty(1, device=ctx.device)  # the context exists now
        if report:
            report.data["marks"]["cuda_context"] = time.time()
        _build.build()  # the libraries an earlier build left, or nvcc
        if report:
            report.data["marks"]["kernels_loaded"] = time.time()

    from dlrover_tpu_torch.accelerate import auto_accelerate
    from dlrover_tpu_torch.models.llama import init_params, loss_fn
    from dlrover_tpu_torch.optimizers import AGD
    from dlrover_tpu_torch.trainer import Trainer, TrainingArgs

    if report:
        report.data["marks"]["modules_imported"] = time.time()
    cfg = model_config(args)
    result = auto_accelerate(
        loss_fn=lambda p, b: loss_fn(p, b, cfg),
        optimizer=lambda ps: AGD(ps, lr=3e-4),
        init_params_fn=lambda gen, dev: init_params(
            cfg, gen, dev, dtype=torch.float32),
        device=ctx.device,
    )
    if report:
        report.data["marks"]["accelerated"] = time.time()
    print(f"strategy: {result.strategy.describe()} | "
          f"params: {result.profile.num_params:,} | "
          f"device: {result.fns.device} | rank {ctx.rank}/{ctx.world_size}"
          f" | incarnation {ctx.restart_count}", flush=True)

    crash = (args.crash_after_step and ctx.restart_count == 0
             and ctx.rank == args.crash_rank)
    trainer = None

    def data_iter():
        step = trainer.progress.global_step
        stream = batches(step, args, cfg.vocab_size)
        while True:
            if crash and step == args.crash_after_step:
                # step N is done and N + 1 not queued: put step N in
                # shared memory (its "copy" snapshot may have been
                # skipped behind a running drain), then die as a killed
                # process does
                if trainer.checkpoint_engine is not None:
                    trainer.snapshot()
                if report:
                    report.write(trainer, crashed_at=time.time(),
                                 crash_step=step)
                os.kill(os.getpid(), signal.SIGKILL)
            step += 1
            yield next(stream)

    def eval_iter():
        # fixed held-out set (seeded separately from training data)
        eval_rng = np.random.default_rng(12345)
        for _ in range(4):
            yield {"tokens": eval_rng.integers(
                0, cfg.vocab_size, size=(args.batch, args.seq + 1),
                dtype=np.int32)}

    trainer = Trainer(
        result,
        TrainingArgs(max_steps=args.steps, log_interval=10,
                     eval_interval=args.eval_interval,
                     checkpoint_dir=args.ckpt_dir,
                     save_memory_interval=args.save_memory_interval,
                     save_storage_interval=args.save_storage_interval),
        data_iter,
        eval_iter_fn=eval_iter,
    )
    if report:
        report.data["marks"]["trainer_built"] = time.time()
    trainer.restore()
    _build.reset_launches()  # count this incarnation's steps only
    summary = trainer.train()
    if report:
        report.write(trainer, summary=summary,
                     digests=leaf_digests(trainer.state))
    if args.eval_interval and summary["final_step"] % args.eval_interval:
        print(f"final eval: {trainer.evaluate()}", flush=True)
    print(f"done: {summary}", flush=True)
    shutdown_distributed()
    return summary, trainer


if __name__ == "__main__":
    main()
