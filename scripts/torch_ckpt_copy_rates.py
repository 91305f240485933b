#!/usr/bin/env python3
"""Host <-> card copy rates for the port's flash checkpoint, on one card.

The snapshot moves the train state from the card into a POSIX shared
memory segment; a copy from the card straight into pageable memory is
synchronous and runs at the pageable rate.  Two ways around it:

1. two pinned bounce buffers on a copy stream, chunk k+1 crossing PCIe
   while chunk k is ``parallel_memcpy``'d into the segment (the port's
   ``agent/ckpt_shm.device_to_host`` / ``host_to_device``);
2. registering the segment itself with ``cudaHostRegister`` (through
   ``torch.cuda.cudart()``) and copying straight into it.

This script times, on ``--gib`` GiB of uint8 on the card (CUDA events for
the card's copies, the host clock where the host takes part):

- pinned buffer <-> card (the yardstick);
- pageable numpy memory <-> card;
- the bounce pipeline into a fresh segment and into a prefaulted one, and
  back to the card;
- ``cudaHostRegister`` of the segment (its cost), the card -> segment
  copy once registered, and ``cudaHostUnregister``;
- the prefault of a fresh segment: ``parallel_fill``,
  ``MADV_POPULATE_WRITE`` and ``MAP_POPULATE``;
- a restore from a fresh mapping of a faulted segment (what a restarted
  process sees), plain, after ``MADV_WILLNEED`` or ``MADV_POPULATE_*``,
  and mapped with ``MAP_POPULATE``, and a drain into a fresh mapping;
- a ``dd``-style write of the same bytes to ``--disk-dir`` (64 MiB
  chunks, then ``fsync``).

Run from the root of a checkout::

    python3 scripts/torch_ckpt_copy_rates.py --gib 4

Every line carries the card's name and power limit.  The segment is
unlinked and the disk file removed before the script exits.
"""

import argparse
import mmap
import os
import subprocess
import sys
import time
from multiprocessing import shared_memory

import numpy as np
import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))

from dlrover_tpu_torch.agent import ckpt_shm  # noqa: E402
from dlrover_tpu_torch.common import parallel_io  # noqa: E402

# Linux 5.14+ (<linux/mman.h>); Python 3.12's mmap does not name them
MADV_POPULATE_READ = 22
MADV_POPULATE_WRITE = 23


def smi() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], check=True, capture_output=True,
        text=True, timeout=60).stdout.strip()


def event_s(fn, reps: int = 3) -> float:
    """Median seconds of ``fn()`` on the card's clock."""
    out = []
    for _ in range(reps):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        torch.cuda.synchronize()
        a.record()
        fn()
        b.record()
        b.synchronize()
        out.append(a.elapsed_time(b) / 1e3)
    return sorted(out)[len(out) // 2]


def host_s(fn, reps: int = 3) -> float:
    out = []
    for _ in range(reps):
        torch.cuda.synchronize()
        t = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        out.append(time.perf_counter() - t)
    return sorted(out)[len(out) // 2]


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--gib", type=float, default=4.0)
    ap.add_argument("--disk-dir", default=os.path.join(
        os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
        "build"))
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("needs a CUDA card", file=sys.stderr)
        return 2
    card = smi()
    n = int(args.gib * 2**30)
    gb = n / 1e9

    def line(what, seconds, note=""):
        print(f"[copy] {card} | {what}: {seconds:.4f} s, "
              f"{gb / seconds:.3f} GB/s{note}", flush=True)

    dev = torch.randint(0, 255, (n,), dtype=torch.uint8, device="cuda")
    pinned = torch.empty(n, dtype=torch.uint8, pin_memory=True)
    line("pinned <- card", event_s(lambda: pinned.copy_(dev)))
    line("pinned -> card", event_s(lambda: dev.copy_(pinned)))
    del pinned
    pageable = np.empty(n, dtype=np.uint8)
    pageable.fill(0)
    pt = torch.from_numpy(pageable)
    line("pageable <- card", host_s(lambda: pt.copy_(dev)))
    line("pageable -> card", host_s(lambda: dev.copy_(pt)))
    del pt, pageable

    name = f"dlrover_tpu_torch_copyrates_{os.getpid()}"
    seg = shared_memory.SharedMemory(name=name, create=True, size=n)
    try:
        host = np.ndarray((n,), dtype=np.uint8, buffer=seg.buf)
        u8 = dev.view(torch.uint8)
        t = time.perf_counter()
        ckpt_shm.device_to_host([(u8, host)])
        line("bounce pipeline <- card, fresh segment",
             time.perf_counter() - t,
             f" (bounce {ckpt_shm.BOUNCE_BYTES >> 20} MiB x 2, "
             f"workers {parallel_io.copy_workers()})")
        line("bounce pipeline <- card, faulted segment",
             host_s(lambda: ckpt_shm.device_to_host([(u8, host)])))
        back = torch.empty_like(dev)
        line("bounce pipeline -> card",
             host_s(lambda: ckpt_shm.host_to_device(
                 [(back.view(torch.uint8), host)])))
        if not torch.equal(back, dev):
            raise SystemExit("bounce round trip differs")
        del back
        fresh = shared_memory.SharedMemory(name=name + "_f", create=True,
                                           size=n)
        try:
            view = np.ndarray((n,), dtype=np.uint8, buffer=fresh.buf)
            t = time.perf_counter()
            parallel_io.parallel_fill(view, 0)
            line("prefault (parallel_fill) of a fresh segment",
                 time.perf_counter() - t)
            del view
        finally:
            fresh.close()
            fresh.unlink()

        # a restarted process maps the agent's segment afresh: every page
        # of the new mapping is faulted on first touch unless the page
        # tables are populated up front
        fd = os.open(f"/dev/shm/{name}", os.O_RDWR)
        try:
            for how in ("plain", "MADV_WILLNEED", "MADV_POPULATE_READ",
                        "MADV_POPULATE_WRITE", "MAP_POPULATE"):
                flags = mmap.MAP_SHARED | (
                    mmap.MAP_POPULATE if how == "MAP_POPULATE" else 0)
                back = torch.empty_like(dev)
                torch.cuda.synchronize()
                t = time.perf_counter()
                m = mmap.mmap(fd, n, flags=flags)
                advice = {"MADV_WILLNEED": mmap.MADV_WILLNEED,
                          "MADV_POPULATE_READ": MADV_POPULATE_READ,
                          "MADV_POPULATE_WRITE": MADV_POPULATE_WRITE}
                note = ""
                if how in advice:
                    try:
                        m.madvise(advice[how])
                    except OSError as e:
                        note = f" (madvise failed: {e})"
                mapped = np.frombuffer(m, dtype=np.uint8)
                ckpt_shm.host_to_device([(back.view(torch.uint8), mapped)])
                line(f"fresh mapping of the segment ({how}) -> card",
                     time.perf_counter() - t, note)
                del mapped
                m.close()
                if not torch.equal(back, dev):
                    raise SystemExit(f"{how}: restore differs")
                del back
            m = mmap.mmap(fd, n)
            try:
                m.madvise(MADV_POPULATE_WRITE)
                note = " after MADV_POPULATE_WRITE"
            except OSError as e:
                note = f" (no MADV_POPULATE_WRITE: {e})"
            mapped = np.frombuffer(m, dtype=np.uint8)
            t = time.perf_counter()
            ckpt_shm.device_to_host([(u8, mapped)])
            line("bounce pipeline <- card, fresh mapping" + note,
                 time.perf_counter() - t)
            del mapped
            m.close()
        finally:
            os.close(fd)
        for how in ("MADV_POPULATE_WRITE", "MAP_POPULATE"):
            fresh = shared_memory.SharedMemory(name=name + "_p",
                                               create=True, size=n)
            fresh.close()
            fd = os.open(f"/dev/shm/{name}_p", os.O_RDWR)
            t = time.perf_counter()
            note = ""
            try:
                if how == "MAP_POPULATE":
                    m = mmap.mmap(fd, n, flags=mmap.MAP_SHARED
                                  | mmap.MAP_POPULATE)
                else:
                    m = mmap.mmap(fd, n)
                    try:
                        m.madvise(MADV_POPULATE_WRITE)
                    except OSError as e:
                        note = f" (madvise failed: {e})"
                line(f"prefault of a fresh segment by {how}",
                     time.perf_counter() - t, note)
                m.close()
            finally:
                os.close(fd)
                fresh.unlink()

        cudart = torch.cuda.cudart()
        ptr = host.ctypes.data
        t = time.perf_counter()
        err = cudart.cudaHostRegister(ptr, n, 0)
        reg_s = time.perf_counter() - t
        if int(err) != 0:
            print(f"[copy] {card} | cudaHostRegister of {gb:.3f} GB "
                  f"failed: {err}", flush=True)
        else:
            line("cudaHostRegister of the segment", reg_s)
            registered = torch.from_numpy(host)
            line("registered segment <- card",
                 event_s(lambda: registered.copy_(dev, non_blocking=True)))
            line("registered segment -> card",
                 event_s(lambda: dev.copy_(registered, non_blocking=True)))
            t = time.perf_counter()
            cudart.cudaHostUnregister(ptr)
            line("cudaHostUnregister", time.perf_counter() - t)
            del registered
        del host
    finally:
        seg.close()
        seg.unlink()

    os.makedirs(args.disk_dir, exist_ok=True)
    path = os.path.join(args.disk_dir, f"copyrates_{os.getpid()}.bin")
    chunk = np.random.default_rng(0).integers(
        0, 255, 64 << 20, dtype=np.uint8)
    try:
        t = time.perf_counter()
        with open(path, "wb") as f:
            left = n
            while left > 0:
                m = min(left, chunk.nbytes)
                f.write(memoryview(chunk)[:m])
                left -= m
            f.flush()
            os.fsync(f.fileno())
        line(f"dd-style write to {args.disk_dir}", time.perf_counter() - t)
    finally:
        if os.path.exists(path):
            os.remove(path)
    print(f"[copy] {card} done", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
