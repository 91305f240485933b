#!/usr/bin/env python3
"""Host <-> card copy rates of the host-offloaded optimizer's chunk stream.

``optimizers.host_offload`` moves each chunk's state host -> card on one
copy stream and card -> host on another, so the two directions run at
once.  This script times, with CUDA events, ``--gib`` GiB of fp32 in
chunks of ``--chunk-mib`` MiB between the card and page-locked host
memory of both kinds the port could use (a block registered with
``cudaHostRegister``, as the optimizer's state is, and
``torch.empty(..., pin_memory=True)``):

- host -> card alone, and card -> host alone;
- both at once, each on its own stream (the chunk stream's case);
- both at once through ``HostOffloadAdamW``'s own streams and chunk
  buffers: one streamed update of a leaf of the same size with zero
  grads (``time_copies``: each chunk's copies on the card's clock), fp32
  and int8 moments, two and four chunk buffers;
- the same with bf16 GEMMs (8192 x 8192 x 8192) queued on another
  stream beforehand, as a backward's would run beside the stream.

Run from the root of a checkout::

    python3 scripts/torch_offload_copy_rates.py --gib 8

Every line carries the card's name and power limit (``nvidia-smi``).
"""

import argparse
import os
import subprocess
import sys

import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))

from dlrover_tpu_torch.optimizers import host_offload as ho  # noqa: E402


def smi_line() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        check=True, capture_output=True, text=True, timeout=60,
    ).stdout.strip()


def timed(fn, streams):
    """``fn()`` queues copies on ``streams``; the time from the first
    stream's start to the last stream's end, in seconds (card clock)."""
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    start.record()
    for s in streams:
        s.wait_event(start)
    fn()
    ends = []
    for s in streams:
        e = torch.cuda.Event(enable_timing=True)
        e.record(s)
        ends.append(e)
    torch.cuda.synchronize()
    return max(start.elapsed_time(e) for e in ends) / 1e3


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--gib", type=float, default=8.0)
    ap.add_argument("--chunk-mib", type=int, default=256)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("torch_offload_copy_rates: CUDA is not available",
              file=sys.stderr)
        return 2
    card = smi_line()
    n = int(args.gib * 2 ** 30) // 4
    chunk = args.chunk_mib * 2 ** 20 // 4
    n -= n % chunk
    gb = 4 * n / 1e9
    dev_in = torch.empty(n, device="cuda")
    dev_out = torch.ones(n, device="cuda")
    h2d, d2h = torch.cuda.Stream(), torch.cuda.Stream()
    kinds = {
        "registered": lambda: ho._host_tensors(
            [((n,), torch.float32)] * 2, torch.device("cuda")),
        "pin_memory": lambda: [torch.ones(n, pin_memory=True)
                               for _ in range(2)],
    }
    for kind, make in kinds.items():
        src, dst = make()
        assert src.is_pinned() and dst.is_pinned()

        def copy_in():
            with torch.cuda.stream(h2d):
                for lo in range(0, n, chunk):
                    dev_in[lo:lo + chunk].copy_(src[lo:lo + chunk],
                                                non_blocking=True)

        def copy_out():
            with torch.cuda.stream(d2h):
                for lo in range(0, n, chunk):
                    dst[lo:lo + chunk].copy_(dev_out[lo:lo + chunk],
                                             non_blocking=True)

        for _ in range(2):  # the second reading counts
            t_in = timed(copy_in, [h2d])
            t_out = timed(copy_out, [d2h])
            t_both = timed(lambda: (copy_in(), copy_out()), [h2d, d2h])
        print(f"[offload-copy] {card} | {kind}, {gb:.3f} GB each way in "
              f"{args.chunk_mib} MiB chunks: h2d alone {gb / t_in:.2f} "
              f"GB/s, d2h alone {gb / t_out:.2f} GB/s, both at once "
              f"{t_both:.3f} s = {gb / t_both:.2f} GB/s each way, "
              f"{2 * gb / t_both:.2f} GB/s together", flush=True)
        del src, dst

    a = torch.randn(8192, 8192, device="cuda", dtype=torch.bfloat16)
    load = torch.cuda.Stream()

    def queue_gemms(count):
        with torch.cuda.stream(load):
            for _ in range(count):
                torch.mm(a, a)

    for moments in ("fp32", "int8"):
        for window in (2, 4):
            for gemms in (0, 400):
                opt = ho.HostOffloadAdamW(chunk_elems=chunk, time_copies=True,
                                          max_in_flight=window,
                                          moments=moments)
                state = opt.init({"w": torch.zeros(n, device="cuda")})
                grads = {"w": torch.zeros(n, dtype=torch.bfloat16,
                                          device="cuda")}
                for _ in range(2):  # the second reading counts
                    torch.cuda.synchronize()
                    queue_gemms(gemms)
                    start = torch.cuda.Event(enable_timing=True)
                    start.record()
                    state = opt.apply_gradients(
                        state, grads, prefetched=opt.start_prefetch(state))
                    opt.synchronize()
                    total = start.elapsed_time(opt._stream_end) / 1e3
                    times = opt.copy_times()
                    torch.cuda.synchronize()
                each = opt.last_stream_bytes / 2 / 1e9
                h2d, d2h = sum(times["h2d"]), sum(times["d2h"])
                print(f"[offload-copy] {card} | HostOffloadAdamW {moments} "
                      f"stream of {n} elements ({each:.3f} GB each way, "
                      f"{window} chunk buffers, {gemms} GEMMs queued "
                      f"beside): {total:.3f} s = {each / total:.2f} GB/s "
                      f"each way; h2d busy {h2d:.1f} ms ({each / h2d * 1e3:.2f}"
                      f" GB/s), d2h busy {d2h:.1f} ms "
                      f"({each / d2h * 1e3:.2f} GB/s)", flush=True)
                del opt, state, grads
    return 0


if __name__ == "__main__":
    sys.exit(main())
