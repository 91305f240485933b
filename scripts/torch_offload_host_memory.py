#!/usr/bin/env python3
"""Where the host's memory goes while the offloaded optimizer's state
comes and goes.

``optimizers.host_offload`` keeps the fp32 master and the moments in
blocks of CPU memory registered with ``cudaHostRegister``.  This script
reads ``/proc/meminfo`` (and a worker's own ``/proc/self/status``) at
each stage of four rounds, run in one worker process:

1. ``plain``: as many bytes of plain CPU memory as that state holds,
   written and freed, with no registration;
2. ``register``: the blocks of a ``--layers`` Llama-2-7B state with int8
   moments, registered and freed again, with no step;
3. ``train`` (twice): ``build_offloaded_train_step`` in ``auto`` mode at
   the same size, init, ``--steps`` steps of one 4 x 2048 batch, then
   the state dropped, the collector run and both caches emptied;

and again in the parent after the worker has exited.  Each reading is
printed as its change against the parent's first, in bytes; the whole
record goes to ``chiprun_out/offload_host_memory.json``.

Run from the root of a checkout::

    python3 scripts/torch_offload_host_memory.py --layers 32

Every line carries the card's name and power limit (``nvidia-smi``).
"""

import argparse
import gc
import json
import os
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

MEMINFO = ("MemTotal", "MemFree", "MemAvailable", "Buffers", "Cached",
           "Shmem", "AnonPages", "Mapped", "Mlocked", "Unevictable",
           "AnonHugePages", "KReclaimable", "SUnreclaim", "PageTables",
           "Committed_AS", "HugePages_Total")
STATUS = ("VmRSS", "RssAnon", "RssFile", "RssShmem", "VmPin", "VmLck")


def smi_line() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        check=True, capture_output=True, text=True, timeout=60,
    ).stdout.strip()


def _kb_fields(path, keys):
    out = {}
    with open(path) as f:
        for line in f:
            k, _, v = line.partition(":")
            if k in keys:
                parts = v.split()
                # HugePages_Total is a count, every other field kB
                out[k] = int(parts[0]) * (1024 if len(parts) > 1 else 1)
    return out


def reading(stage: str, own: bool = True) -> dict:
    out = {"stage": stage, "t": time.time(),
           "meminfo": _kb_fields("/proc/meminfo", MEMINFO)}
    if own:
        out["status"] = _kb_fields("/proc/self/status", STATUS)
        import torch

        from dlrover_tpu_torch.optimizers import host_offload as ho

        out["registered_bytes"] = ho._PinnedBlock.registered_bytes
        stats = getattr(torch.cuda, "host_memory_stats", None)
        if stats is not None and torch.cuda.is_initialized():
            s = stats()
            out["host_allocator"] = {k: v for k, v in s.items()
                                     if k.startswith(("allocated_bytes",
                                                      "reserved_bytes"))}
    return out


def _free():
    import torch

    gc.collect()
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    empty_host = getattr(torch._C, "_host_emptyCache", None)
    if empty_host is not None:
        empty_host()


def worker(args) -> list:
    import numpy as np
    import torch

    from dlrover_tpu_torch.models import llama
    from dlrover_tpu_torch.optimizers import host_offload as ho

    cfg = llama.LlamaConfig.llama2_7b(n_layers=args.layers)
    out = [reading("worker start")]

    def init_params(rng):
        gen = torch.Generator(device="cuda").manual_seed(rng)
        return llama.init_params(cfg, gen, "cuda", dtype=torch.float32)

    # 1, 2: the state's bytes as plain memory, then its blocks
    # registered, each freed
    opt = ho.HostOffloadAdamW(moments="int8")
    shapes = [tuple(t.shape) for t in ho.tree_leaves(
        llama.init_params(cfg, None, "meta", dtype=torch.float32))]
    specs = [(s, torch.float32) for s in shapes]
    for s in shapes:
        n = int(np.prod(s))
        for sl in opt._chunk_slices(n):
            padded = ho._q_padded(sl.stop - sl.start)
            specs += [((padded,), torch.int8),
                      ((padded // 1024,), torch.float32)] * 2
    nbytes = sum(int(np.prod(s)) * torch.empty((), dtype=d).element_size()
                 for s, d in specs)
    plain = torch.ones(nbytes, dtype=torch.uint8)
    out.append(reading("plain: allocated"))
    del plain
    _free()
    out.append(reading("plain: freed"))
    blocks = ho._host_tensors(specs, torch.device("cuda"))
    out.append(reading("register: blocks registered"))
    del blocks
    _free()
    out.append(reading("register: freed"))

    # 3, 4: the offloaded step at full size
    tokens = np.random.default_rng(0).integers(
        0, cfg.vocab_size, (4, 2049)).astype(np.int32)
    batch = {"tokens": torch.from_numpy(tokens).cuda()}
    for r in (1, 2):
        opt = ho.HostOffloadAdamW(learning_rate=3e-4, weight_decay=0.1,
                                  moments="int8")
        init, step = ho.build_offloaded_train_step(
            lambda p, b: llama.loss_fn(p, b, cfg), init_params, opt,
            mode="auto")
        state = init(r)
        torch.cuda.synchronize()
        out.append(reading(f"train {r}: init"))
        losses = []
        for _ in range(args.steps):
            holder = [state]
            del state
            state, m = step(holder.pop(), batch)
            losses.append(m["loss"])
        torch.cuda.synchronize()
        opt.synchronize()
        out.append(dict(reading(f"train {r}: {args.steps} steps"),
                        losses=[float(x) for x in losses]))
        del state, holder, m, opt, init, step, losses
        _free()
        out.append(reading(f"train {r}: freed"))
    return out


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--layers", type=int, default=32)
    p.add_argument("--steps", type=int, default=2)
    p.add_argument("--worker", metavar="PATH",
                   help="(internal) run the rounds, write JSON to PATH")
    args = p.parse_args(argv)
    if args.worker:
        with open(args.worker, "w") as f:
            json.dump(worker(args), f)
        return 0

    import torch

    if not torch.cuda.is_available():
        print("needs a CUDA card", file=sys.stderr)
        return 1
    card = smi_line()
    out_dir = os.path.join(ROOT, "chiprun_out")
    os.makedirs(out_dir, exist_ok=True)
    part = os.path.join(out_dir, f"offload_host_memory_{os.getpid()}.part")
    record = [reading("parent start", own=False)]
    rc = subprocess.run(
        [sys.executable, os.path.abspath(__file__), "--layers",
         str(args.layers), "--steps", str(args.steps), "--worker", part],
        timeout=1800).returncode
    record.append(reading("parent: worker exited", own=False))
    time.sleep(10)
    record.append(reading("parent: worker exited + 10 s", own=False))
    with open(part) as f:
        record[1:1] = json.load(f)
    os.unlink(part)
    base = record[0]["meminfo"]
    for r in record:
        delta = {k: r["meminfo"][k] - base[k] for k in base
                 if k != "MemTotal"}
        extra = {k: r[k] for k in ("status", "registered_bytes",
                                   "host_allocator", "losses") if k in r}
        print(f"[host-memory] {card} | {r['stage']}: change {delta} "
              f"{extra}", flush=True)
    print(f"[host-memory] {card} | MemTotal {base['MemTotal']}; "
          f"{args.layers} layers, int8 moments; worker rc {rc}")
    with open(os.path.join(out_dir, "offload_host_memory.json"), "w") as f:
        json.dump({"card": card, "layers": args.layers, "steps": args.steps,
                   "worker_rc": rc, "readings": record}, f, indent=1)
    return rc


if __name__ == "__main__":
    sys.exit(main())
