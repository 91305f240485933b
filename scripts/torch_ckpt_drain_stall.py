#!/usr/bin/env python3
"""What holds a training step back while a "copy" snapshot drains.

``Trainer``'s "copy" mode copies the train state on the card and drains
the copy into shared memory on a background thread (a copy stream, two
pinned bounce buffers, ``parallel_memcpy`` workers) while the next steps
run.  This script trains Llama-2-7B widths at ``--layers`` layers with
AGD (bf16 compute, remat "full", 4 x 2048 tokens a step, as
``chip_smoke.py``'s checkpoint leg) and times, on the card's clock, the
steps that follow each of these, every one started right after a step
was queued:

- ``none``: nothing (the reference);
- ``copy``: a clone of the state, then ``save_to_memory(blocking=False)``,
  twice: the first clone allocates fresh device memory, the second
  reuses the cached blocks;
- ``clone_hold``: the clone alone, kept for the steps, no drain;
- ``drain_static``: a drain of a clone made beforehand (no allocation);
- ``copy_workers1``: ``copy`` with one memcpy worker;
- ``host_memcpy``: the drain's host copies alone (the bounce-sized
  ``parallel_memcpy`` into the segment, as many bytes), no card work;
- ``d2h_only``: the drain's card-to-host copies alone (pinned bounce
  buffers on the copy stream), no host memcpy;
- ``gil_hog``: a Python thread spinning for as long as a drain lasts.

Each line gives the step times, the host time of each ``train_step``
call, and the caching allocator's retries, device mallocs and frees in
the window.  Then one step alone and one step beside a ``copy`` drain
run under ``torch.profiler`` (host and card): the card's busy share of
the step, the main thread's time inside and between torch ops, its
largest gaps, and the host ops that took the most time.

With ``--trainer`` it times ``Trainer`` itself instead (``trainer_runs``):
no checkpoint, then a "copy" snapshot every step with the snapshot
buffers ``Trainer`` allocates at the start, and with a clone made at
each snapshot, two of them traced the same way.

Run from the root of a checkout on one card::

    python3 scripts/torch_ckpt_drain_stall.py --layers 8
    python3 scripts/torch_ckpt_drain_stall.py --layers 8 --trainer --steps 5

Needs two slots of the state in ``/dev/shm`` (45 GB at 8 layers); the
segment is unlinked and the checkpoint dir removed before the script
exits.  Every line carries the card's name and power limit.
"""

import argparse
import gc
import os
import shutil
import subprocess
import sys
import tempfile
import threading
import time

import numpy as np
import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))

from dlrover_tpu_torch.agent import ckpt_shm  # noqa: E402
from dlrover_tpu_torch.common import multi_process, parallel_io  # noqa: E402

STATS = ("num_alloc_retries", "num_device_alloc", "num_device_free")


def smi() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], check=True, capture_output=True,
        text=True, timeout=60).stdout.strip()


def mem_stats():
    s = torch.cuda.memory_stats()
    return {k: s.get(k, 0) for k in STATS}


class Rig:
    """The model, its state and a checkpoint engine whose segment holds
    two slots of the state."""

    def __init__(self, layers: int, root: str):
        from dlrover_tpu_torch.accelerate import auto_accelerate
        from dlrover_tpu_torch.models import llama
        from dlrover_tpu_torch.optimizers import AGD
        from dlrover_tpu_torch.trainer.checkpoint.engine import (
            CheckpointEngine,
        )

        cfg = llama.LlamaConfig.llama2_7b(n_layers=layers)
        result = auto_accelerate(
            loss_fn=lambda p, b: llama.loss_fn(p, b, cfg),
            optimizer=lambda ps: AGD(ps, lr=3e-4),
            init_params_fn=lambda gen, dev: llama.init_params(
                cfg, gen, dev, dtype=torch.float32),
            device="cuda")
        self.fns = result.fns
        self.state = self.fns.init_state(0)
        tokens = np.random.default_rng(0).integers(
            0, cfg.vocab_size, (4, 2049)).astype(np.int32)
        self.batch = {"tokens": torch.from_numpy(tokens).cuda()}
        self.engine = CheckpointEngine(checkpoint_dir=root)
        t = time.perf_counter()
        self.nbytes = self.engine.preallocate_like(self.state)
        self.prealloc_s = time.perf_counter() - t
        self.snap_step = 0

    def pairs(self):
        return ckpt_shm._flatten_keyed(self.state)

    def clone(self):
        return [(k, v.detach().clone() if torch.is_tensor(v) else v)
                for k, v in self.pairs()]

    def drain(self, pairs):
        self.snap_step += 1
        assert self.engine.save_to_memory(self.snap_step, pairs,
                                          blocking=False)

    def step(self):
        _, m = self.fns.train_step(self.state, self.batch)
        return m["done"]

    def close(self):
        self.engine.close()


def measure(rig, card, name, action, steps):
    """One step, ``action()`` (returns a function that waits for what it
    started), then ``steps`` steps; prints their times."""
    torch.cuda.synchronize()
    s0 = mem_stats()
    start = rig.step()
    wait = action()
    done, host = [start], []
    for _ in range(steps):
        t = time.perf_counter()
        done.append(rig.step())
        host.append(1e3 * (time.perf_counter() - t))
    torch.cuda.synchronize()
    busy_s = wait() if wait else None
    ms = [done[i].elapsed_time(done[i + 1]) for i in range(steps)]
    d = {k: v - s0[k] for k, v in mem_stats().items()}
    extra = f" side work {busy_s:.3f} s" if busy_s is not None else ""
    print(f"[stall] {card} | {name}: step_ms {[round(x, 3) for x in ms]} "
          f"host_ms {[round(x, 1) for x in host]} allocator {d}{extra}",
          flush=True)
    return ms


def thread_waiter(fn):
    box = {}

    def run():
        t = time.perf_counter()
        fn()
        box["s"] = time.perf_counter() - t

    th = threading.Thread(target=run, daemon=True)
    th.start()

    def wait():
        th.join()
        return box["s"]
    return wait


def engine_waiter(rig):
    def wait():
        assert rig.engine.wait_for_snapshot(timeout=600)
        return rig.engine.io_log[-1][3]  # the drain's seconds
    return wait


def host_memcpy_work(rig):
    """The drain's host side alone: bounce-buffer-sized memcpys into the
    segment's first slot, as many bytes as the state."""
    src = np.ones(ckpt_shm.BOUNCE_BYTES, dtype=np.uint8)
    seg = np.ndarray((rig.engine._shm_handler._shm.size,), dtype=np.uint8,
                     buffer=rig.engine._shm_handler._shm.buf)

    def run():
        off = 0
        while off < rig.nbytes:
            n = min(src.nbytes, rig.nbytes - off)
            ckpt_shm._memcpy(seg[off:off + n], src[:n])
            off += n
    return run


def d2h_work(pairs):
    """The drain's card-to-host side alone: the pairs' bytes through the
    pinned bounce buffers on the copy stream, nothing landed."""
    def run():
        dev = [ckpt_shm._u8(v) for _, v in pairs if torch.is_tensor(v)]
        b = ckpt_shm._bounce(dev[0].device)
        fake = [(d, np.empty(0, dtype=np.uint8)) for d in dev]
        with b.lock:
            b.stream.wait_stream(torch.cuda.current_stream())
            evs = [None, None]
            i = 0
            for d, _ in fake:
                off = 0
                while off < d.numel():
                    j = i % 2
                    if evs[j] is not None:
                        evs[j].synchronize()
                    n = min(b.nbytes, d.numel() - off)
                    with torch.cuda.stream(b.stream):
                        b.bufs[j][:n].copy_(d[off:off + n],
                                            non_blocking=True)
                        evs[j] = torch.cuda.Event()
                        evs[j].record(b.stream)
                    off += n
                    i += 1
            b.stream.synchronize()
    return run


def gil_hog(seconds):
    def run():
        end = time.perf_counter() + seconds
        x = 0
        while time.perf_counter() < end:
            x += 1
    return run


def profile_step(rig, card, label, action):
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    rig.step()
    wait = action() if action else None
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        done = rig.step()
        done.synchronize()
    if wait:
        wait()
    analyze(prof, card, label)


def analyze(prof, card, label):
    """The card's busy share of the profiled window, the main thread's
    time inside and between its top-level ops, its largest gaps and its
    costliest host ops, and the same ops of the other threads."""
    from torch.autograd import DeviceType

    events = prof.events()
    cpu = [e for e in events if e.device_type == DeviceType.CPU]
    dev = [e for e in events if e.device_type == DeviceType.CUDA
           and not e.name.startswith("Optimizer.")]
    threads = {}
    for e in cpu:
        threads[e.thread] = threads.get(e.thread, 0) + 1
    main = max(threads, key=threads.get)
    top = sorted((e for e in cpu if e.thread == main and e.cpu_parent is None),
                 key=lambda e: e.time_range.start)
    t0 = top[0].time_range.start
    t1 = max(e.time_range.end for e in dev) if dev else top[-1].time_range.end
    inside = sum(e.time_range.end - e.time_range.start for e in top)
    gaps = []
    for a, b in zip(top, top[1:]):
        g = b.time_range.start - a.time_range.end
        if g > 0:
            gaps.append((g, a.name, b.name))
    ivs = sorted((e.time_range.start, e.time_range.end) for e in dev)
    busy, cur = 0.0, None
    for s, t in ivs:
        if cur is None or s > cur[1]:
            if cur is not None:
                busy += cur[1] - cur[0]
            cur = [s, t]
        else:
            cur[1] = max(cur[1], t)
    if cur is not None:
        busy += cur[1] - cur[0]
    host_span = top[-1].time_range.end - t0
    print(f"[stall-profile] {card} | {label}: window {(t1 - t0) / 1e3:.3f} "
          f"ms, card busy {busy / 1e3:.3f} ms (share "
          f"{busy / max(t1 - t0, 1):.3f}); main thread {len(top)} top-level "
          f"ops over {host_span / 1e3:.3f} ms, {inside / 1e3:.3f} ms inside "
          f"ops, {sum(g for g, _, _ in gaps) / 1e3:.3f} ms between; other "
          f"threads' host events {sum(v for k, v in threads.items() if k != main)}",
          flush=True)
    for g, a, b in sorted(gaps, reverse=True)[:6]:
        print(f"[stall-profile]   gap {g / 1e3:8.3f} ms after {a[:50]} "
              f"before {b[:50]}", flush=True)
    agg = {}
    for e in cpu:
        if e.thread != main:
            continue
        agg[e.name] = agg.get(e.name, 0) + e.self_cpu_time_total
    for name, us in sorted(agg.items(), key=lambda kv: -kv[1])[:8]:
        print(f"[stall-profile]   host self {us / 1e3:9.3f} ms  {name[:70]}",
              flush=True)
    other = {}
    for e in cpu:
        if e.thread != main:
            other[e.name] = other.get(e.name, 0) + e.self_cpu_time_total
    for name, us in sorted(other.items(), key=lambda kv: -kv[1])[:6]:
        print(f"[stall-profile]   other threads self {us / 1e3:9.3f} ms  "
              f"{name[:60]}", flush=True)


def _clone_snapshot(trainer):
    """A snapshot as ``Trainer``'s "copy" mode made it before its buffers
    were allocated at the start: a fresh clone of every tensor."""
    return [(k, v.detach().clone() if torch.is_tensor(v) else v)
            for k, v in ckpt_shm._flatten_keyed(trainer.state)]


class GcTimer:
    """Seconds spent in Python's cyclic garbage collector (all threads)."""

    def __init__(self):
        self.total, self.longest, self.count, self._t = 0.0, 0.0, 0, None
        gc.callbacks.append(self)

    def __call__(self, phase, info):
        if phase == "start":
            self._t = time.perf_counter()
        elif self._t is not None:
            d = time.perf_counter() - self._t
            self.total += d
            self.longest = max(self.longest, d)
            self.count += 1

    def close(self):
        gc.callbacks.remove(self)


def trainer_runs(layers, card, root, steps):
    """``Trainer`` itself, as ``chip_smoke.py``'s checkpoint leg drives
    it: 4 x 2048 tokens a step, no checkpoint, then a "copy" snapshot
    every step, with its snapshot buffers allocated at the start
    ("buffers", the saver in the engine and an agent's saver) and with a
    clone made at each snapshot ("clones").  The snapshot runs skip the
    final persist; two are profiled from the first step to the end."""
    import types

    from torch.profiler import ProfilerActivity, profile

    from dlrover_tpu_torch.accelerate import auto_accelerate
    from dlrover_tpu_torch.agent.ckpt_saver import AsyncCheckpointSaver
    from dlrover_tpu_torch.models import llama
    from dlrover_tpu_torch.optimizers import AGD
    from dlrover_tpu_torch.trainer import Trainer, TrainingArgs

    cfg = llama.LlamaConfig.llama2_7b(n_layers=layers)
    result = auto_accelerate(
        loss_fn=lambda p, b: llama.loss_fn(p, b, cfg),
        optimizer=lambda ps: AGD(ps, lr=3e-4),
        init_params_fn=lambda gen, dev: llama.init_params(
            cfg, gen, dev, dtype=torch.float32),
        device="cuda")
    batch = {"tokens": np.random.default_rng(0).integers(
        0, cfg.vocab_size, (4, 2049)).astype(np.int32)}

    def data():
        while True:
            yield batch

    runs = (("no checkpoint", None, False, False),
            ("clones", "clones", False, False),
            ("buffers", "buffers", False, True),
            ("buffers, agent's saver", "buffers", True, False),
            ("clones", "clones", False, True),
            ("no checkpoint", None, False, False))
    for label, snap, agent, traced in runs:
        factory = (AsyncCheckpointSaver.start_async_saving_ckpt(
            install_signal_handlers=False) if agent else None)
        ck = dict(checkpoint_dir=tempfile.mkdtemp(dir=root),
                  save_memory_interval=1, save_storage_interval=1000,
                  snapshot_mode="copy") if snap else {}
        tr = Trainer(result, TrainingArgs(max_steps=steps, log_interval=0,
                                          **ck), data)
        prof = profile(activities=[ProfilerActivity.CPU,
                                   ProfilerActivity.CUDA])
        fns = tr._fns

        def first_step(state, b, fns=fns, prof=prof):
            if not getattr(prof, "_on", False):
                prof._on = True
                prof.start()
            return fns.train_step(state, b)

        def wait_and_close(step, tr=tr, prof=prof, traced=traced):
            torch.cuda.synchronize()
            if traced:
                prof.stop()
            tr.checkpoint_engine.wait_for_snapshot(timeout=600)
            tr.checkpoint_engine.close()

        if snap:
            tr._final_checkpoint = wait_and_close
        if snap == "clones":
            tr._snapshot_buffers = lambda: None
            tr._copy_to_snapshot = lambda tr=tr: _clone_snapshot(tr)
        if traced:
            tr._fns = types.SimpleNamespace(
                train_step=first_step, init_state=fns.init_state,
                eval_step=fns.eval_step, device=fns.device)
        gct = GcTimer()
        t = time.perf_counter()
        try:
            tr.train()
        finally:
            gct.close()
            if agent:
                saver = AsyncCheckpointSaver.get_ckpt_saver()
                if saver is not None:
                    saver.close(unlink=True)
                AsyncCheckpointSaver._instance = None
                factory.close()
        wall = time.perf_counter() - t
        ms = [round(1e3 * r["step_time_s"], 3) for r in tr.history]
        saves = [(x["step"], x["saved"], round(1e3 * x["host_s"], 1))
                 for x in tr.save_times]
        eng = tr.checkpoint_engine
        drains = [round(d, 3) for k, _, _, d in (eng.io_log if eng else ())
                  if k == "drain"]
        print(f"[stall-trainer] {card} | {label}: step_ms {ms}; "
              f"_maybe_checkpoint (step, saved, host ms) {saves}; drains "
              f"{drains} s; gc {gct.count} runs, {1e3 * gct.total:.1f} ms, "
              f"longest {1e3 * gct.longest:.1f} ms; allocator "
              f"{mem_stats()}; wall {wall:.1f} s", flush=True)
        if traced:
            analyze(prof, card, label)
        del tr, prof
        gc.collect()
        torch.cuda.empty_cache()


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--layers", type=int, default=8)
    ap.add_argument("--steps", type=int, default=4)
    ap.add_argument("--no-profile", action="store_true")
    ap.add_argument("--trainer", action="store_true",
                    help="time Trainer itself instead of the variants")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("needs a CUDA card", file=sys.stderr)
        return 2
    card = smi()
    print(f"[stall] {card} | torch {torch.__version__}, {os.cpu_count()} "
          f"cores, switch interval {sys.getswitchinterval()} s, memcpy "
          f"workers {parallel_io.copy_workers()}", flush=True)
    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    root = tempfile.mkdtemp(prefix="stall_", dir=os.path.join(repo, "build")
                            if os.path.isdir(os.path.join(repo, "build"))
                            else None)
    sock = tempfile.mkdtemp(prefix="dts", dir="/tmp")
    os.environ[multi_process.SOCKET_DIR_ENV] = sock
    rig = None
    try:
        from dlrover_tpu_torch.ops import _build

        secs = _build.build(("rms_norm", "flash_attention",
                             "flash_attention_bwd"))
        print(f"[stall] build {secs:.1f} s", flush=True)
        if args.trainer:
            trainer_runs(args.layers, card, root, args.steps)
            return 0
        rig = Rig(args.layers, root)
        print(f"[stall] {card} | {args.layers} layers, state "
              f"{rig.nbytes / 1e9:.3f} GB, two slots preallocated in "
              f"{rig.prealloc_s:.1f} s", flush=True)
        for _ in range(2):
            rig.step()
        n = args.steps
        measure(rig, card, "none", lambda: None, n)
        measure(rig, card, "copy (first clone)",
                lambda: (rig.drain(rig.clone()), engine_waiter(rig))[1], n)
        measure(rig, card, "copy (again)",
                lambda: (rig.drain(rig.clone()), engine_waiter(rig))[1], n)
        measure(rig, card, "none", lambda: None, n)
        held = []
        measure(rig, card, "clone_hold",
                lambda: (held.append(rig.clone()), None)[1], n)
        static = held.pop()
        measure(rig, card, "drain_static",
                lambda: (rig.drain(static), engine_waiter(rig))[1], n)
        measure(rig, card, "d2h_only",
                lambda: thread_waiter(d2h_work(static)), n)
        del static
        measure(rig, card, "host_memcpy",
                lambda: thread_waiter(host_memcpy_work(rig)), n)
        os.environ[parallel_io.COPY_WORKERS_ENV] = "1"
        try:
            measure(rig, card, "copy_workers1",
                    lambda: (rig.drain(rig.clone()), engine_waiter(rig))[1],
                    n)
        finally:
            del os.environ[parallel_io.COPY_WORKERS_ENV]
        measure(rig, card, "gil_hog", lambda: thread_waiter(gil_hog(1.5)), n)
        measure(rig, card, "none", lambda: None, n)
        if not args.no_profile:
            profile_step(rig, card, "alone", None)
            profile_step(rig, card, "beside a copy drain",
                         lambda: (rig.drain(rig.clone()),
                                  engine_waiter(rig))[1])
            profile_step(rig, card, "beside a gil_hog",
                         lambda: thread_waiter(gil_hog(1.5)))
    finally:
        if rig is not None:
            rig.close()
        del rig
        gc.collect()
        shutil.rmtree(root, ignore_errors=True)
        shutil.rmtree(sock, ignore_errors=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
