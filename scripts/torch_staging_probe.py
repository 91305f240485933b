#!/usr/bin/env python3
"""Run a tree's ``chip_smoke.py`` with each staging of ``device_prefetch``
timed in its parts.

``DevicePrefetch._put`` is replaced by a copy of itself that reads the
host clock between its steps (the rows cut, ``torch.as_tensor``,
``pin_memory``, the events made, ``torch.empty_like`` on the card, the
copy and its events recorded); every staging of 20 ms or more is printed
as ``[probe] put #N ...``, numbered across the process.  The smoke's
stall check then reads the same ``data_stall`` spans as without the
probe.  This is how the slow first staging of each new prefetcher was
traced to its first card allocation on a fresh copy stream.

Usage (one card; the tree is a checkout, e.g. a parent commit unpacked
under ``build/``)::

    python3 scripts/torch_staging_probe.py . --skip-search --skip-remat \\
        --skip-int8 --skip-ckpt --skip-elastic
"""

import os
import runpy
import sys
import time

#: stagings at least this long are printed
PRINT_S = 0.02


def main():
    tree = os.path.abspath(sys.argv[1])
    sys.path.insert(0, tree)
    os.chdir(tree)
    import torch

    from dlrover_tpu_torch.data import prefetch

    count = [0]

    def timed_put(self, batch):
        t = [time.monotonic()]
        t0_wall = prefetch.anchored_now(t[0])
        if self._sharding is not None:
            batch = self._sharding.local(batch)
        t.append(time.monotonic())
        host = prefetch._map(torch.as_tensor, batch)
        nbytes = sum(int(x.nbytes) for x in prefetch._leaves(host))
        t.append(time.monotonic())
        if self._stream is None:
            out = prefetch._InFlight(host, None, None, None, nbytes, 0.0)
        else:
            pinned = prefetch._map(lambda x: x.pin_memory(), host)
            t.append(time.monotonic())
            start = torch.cuda.Event(enable_timing=True)
            done = torch.cuda.Event(enable_timing=True)
            t.append(time.monotonic())
            with torch.cuda.stream(self._stream):
                start.record(self._stream)
                dev = prefetch._map(lambda x: torch.empty_like(
                    x, device=self._device), pinned)
                t.append(time.monotonic())
                for d, p in zip(prefetch._leaves(dev),
                                prefetch._leaves(pinned)):
                    d.copy_(p, non_blocking=True)
                done.record(self._stream)
            t.append(time.monotonic())
            out = prefetch._InFlight(dev, pinned, start, done, nbytes, 0.0)
        dur = time.monotonic() - t[0]
        out.host_s = dur
        count[0] += 1
        if dur >= PRINT_S:
            parts = ("local", "as_tensor", "pin_memory", "events",
                     "empty_like", "copy+record")
            print(f"[probe] put #{count[0]} {1e3 * dur:.1f} ms: " + ", ".join(
                f"{n} {1e3 * (b - a):.1f}" for n, a, b in zip(parts, t, t[1:])),
                flush=True)
        if self._events.enabled and dur >= self._threshold:
            self._events.complete("data_stall", t0_wall, dur, stage="h2d")
        return out

    prefetch.DevicePrefetch._put = timed_put
    sys.argv = ["chip_smoke.py"] + sys.argv[2:]
    runpy.run_path(os.path.join(tree, "chip_smoke.py"), run_name="__main__")


if __name__ == "__main__":
    main()
