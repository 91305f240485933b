#!/usr/bin/env python3
"""A restarted worker's restore from shared memory, four ways, on one card.

The state is the elastic leg's: Llama-2-7B widths cut to ``--layers``
layers, fp32 parameters and AGD state on the card (``auto_accelerate``,
as ``dlrover_tpu_torch/examples/llama_pretrain.py`` builds it).  It is
snapshotted once into a shared-memory slot (an in-process saver), then
each run builds the state afresh (``init_state``) and restores the slot
into it:

- ``card``: a thread reads every leaf with ``preadv`` through the
  pinned bounce buffers into a second copy of the state on the card
  (``ckpt_shm.file_to_device``) while ``init_state`` runs, and the
  restore then copies card to card;
- ``host``: a thread reads every leaf with ``preadv`` into private host
  tensors (``FileLeaf.read``) while ``init_state`` runs, and the
  restore then copies them to the card through the bounce buffers;
- ``serial``: ``init_state``, then ``CheckpointEngine.load``, which
  reads the slot from the segment's file straight into the state's
  tensors;
- ``prefetch``: ``CheckpointEngine.start_prefetch`` (what is
  restorable, the slot opened), ``init_state``, then
  ``finish_restore``, which reads the slot as ``load`` does: the
  ``Trainer``'s restore.

The first two are the designs the port's prefetch does not take.  The
runs go in the order card, host, serial, prefetch, prefetch, serial,
host, card.  Each prints the host time of ``init_state``, the time
after it to the restored state on the card, and their total (for
``card`` and ``host`` also when the staging thread ended); each checks
every restored leaf against the snapshot (a sum of its 32-bit words, on
the card).

Run from the root of a checkout::

    python3 scripts/torch_restore_paths.py --layers 8

Every line carries the card's name and power limit.  The segment is
unlinked before the script exits.
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

import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))

from dlrover_tpu_torch.agent import ckpt_shm  # noqa: E402

ORDER = ("card", "host", "serial", "prefetch", "prefetch", "serial", "host",
         "card")


def smi() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], check=True, capture_output=True,
        text=True, timeout=60).stdout.strip()


def sums(state) -> dict:
    """{keypath: sum of the leaf's 32-bit words (bytes for an odd
    size), or its value}."""
    out = {}
    for key, leaf in ckpt_shm._flatten_keyed(state):
        if torch.is_tensor(leaf):
            raw = ckpt_shm._u8(leaf)
            if raw.numel() % 4 == 0:
                raw = raw.view(torch.int32)
            out[key] = int(raw.sum(dtype=torch.int64))
        else:
            out[key] = repr(leaf)
    return out


def staged_copy(engine, step, init, device, on_card: bool):
    """The ``card`` and ``host`` runs: the slot staged beside
    ``init_state`` into a second copy on the card or in host memory;
    returns (state, init seconds, staging end)."""
    fd, got, leaves = engine._shm_handler.open_slot(step)
    assert got == step
    staged, ended = {}, []

    def stage():
        with torch.cuda.device(device):
            for key, leaf in leaves.items():
                if not on_card or leaf.nbytes < (1 << 20):
                    staged[key] = leaf.read()
                    continue
                t = torch.empty(leaf.shape, dtype=leaf.dtype, device=device)
                ckpt_shm.file_to_device([(ckpt_shm._u8(t), leaf.range())])
                staged[key] = t
        ended.append(time.perf_counter())

    try:
        thread = threading.Thread(target=stage)
        t0 = time.perf_counter()
        thread.start()
        state = init()
        t_init = time.perf_counter() - t0
        thread.join()
        ckpt_shm.restore_to_target(state, staged)
        staged.clear()
    finally:
        os.close(fd)
    return state, t_init, ended[0] - t0


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--layers", type=int, default=8)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("no CUDA device", file=sys.stderr)
        return 1
    from dlrover_tpu_torch.accelerate import auto_accelerate
    from dlrover_tpu_torch.models.llama import (
        LlamaConfig,
        init_params,
        loss_fn,
    )
    from dlrover_tpu_torch.optimizers import AGD
    from dlrover_tpu_torch.trainer.checkpoint.engine import CheckpointEngine

    card = smi()
    device = torch.device("cuda", 0)
    cfg = LlamaConfig.llama2_7b(n_layers=args.layers)
    result = auto_accelerate(
        loss_fn=lambda p, b: loss_fn(p, b, cfg),
        optimizer=lambda ps: AGD(ps, lr=3e-4),
        init_params_fn=lambda gen, dev: init_params(
            cfg, gen, dev, dtype=torch.float32),
        device=device,
    )
    root = tempfile.mkdtemp(prefix="restore_paths_")
    engine = CheckpointEngine(root)
    try:
        state = result.fns.init_state(1)
        want = sums(state)
        nbytes = sum(int(v.nbytes) for _k, v in ckpt_shm._flatten_keyed(
            state) if torch.is_tensor(v))
        t = time.perf_counter()
        assert engine.save_to_memory(1, state, blocking=True)
        print(f"[restore] {card} | Llama-2-7B widths, {args.layers} layers, "
              f"AGD: {nbytes} bytes in the slot (snapshot "
              f"{time.perf_counter() - t:.3f} s)", flush=True)
        del state
        for name in ORDER:
            gc.collect()
            torch.cuda.empty_cache()
            torch.cuda.synchronize()
            extra = ""

            def init():
                return result.fns.init_state(0)

            t0 = time.perf_counter()
            if name in ("card", "host"):
                state, t_init, staged = staged_copy(
                    engine, 1, init, device, on_card=name == "card")
                extra = f"; staging ended at {staged:.3f} s"
            elif name == "serial":
                state = init()
                t_init = time.perf_counter() - t0
                step, _ = engine.load(target=state)
                assert step == 1
            else:
                pf = engine.start_prefetch()
                state = init()
                t_init = time.perf_counter() - t0
                step, _ = engine.finish_restore(pf, target=state)
                assert step == 1
                extra = (f"; prefetch window "
                        f"{pf.finished_at - pf.started_at:.4f} s")
            torch.cuda.synchronize()
            total = time.perf_counter() - t0
            ok = sums(state) == want
            print(f"[restore] {card} | {name}: init_state {t_init:.4f} s, "
                  f"restore after it {total - t_init:.4f} s, total "
                  f"{total:.4f} s ({nbytes / 1e9 / (total - t_init):.3f} "
                  f"GB/s after init_state){extra}; restored leaves equal "
                  f"the snapshot: {ok}", flush=True)
            if not ok:
                return 1
            del state
    finally:
        engine.close()
        shutil.rmtree(root, ignore_errors=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
