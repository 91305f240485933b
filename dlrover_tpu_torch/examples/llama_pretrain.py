"""Llama pretraining on one GPU: auto_accelerate + Trainer + AGD.

Port of ``examples/llama_pretrain.py`` (same CLI, same config recipe,
same data) for one device; the elastic launch, flash checkpoint and
multi-GPU strategies are later slices (ROADMAP A3, A4)::

    python -m dlrover_tpu_torch.examples.llama_pretrain --steps 50
    python -m dlrover_tpu_torch.examples.llama_pretrain --device cpu \\
        --steps 4 --dim 64 --layers 2 --heads 4 --seq 32 --batch 2
"""

import argparse
import logging

import numpy as np
import torch


def parse_args(argv=None):
    p = argparse.ArgumentParser()
    p.add_argument("--steps", type=int, default=50)
    p.add_argument("--batch", type=int, default=8)
    p.add_argument("--seq", type=int, default=128)
    p.add_argument("--dim", type=int, default=256)
    p.add_argument("--layers", type=int, default=4)
    p.add_argument("--heads", type=int, default=8)
    p.add_argument("--eval_interval", type=int, default=0,
                   help="evaluate on a held-out set every N steps (0 = off)")
    p.add_argument("--device", default=None,
                   help="cuda (default) or cpu")
    return p.parse_args(argv)


def main(argv=None):
    args = parse_args(argv)
    logging.basicConfig(level=logging.INFO, format="%(message)s")

    from dlrover_tpu_torch.accelerate import auto_accelerate
    from dlrover_tpu_torch.models.llama import (
        LlamaConfig,
        init_params,
        loss_fn,
    )
    from dlrover_tpu_torch.optimizers import AGD
    from dlrover_tpu_torch.trainer import Trainer, TrainingArgs

    cfg = LlamaConfig(
        vocab_size=4096,
        dim=args.dim,
        n_layers=args.layers,
        n_heads=args.heads,
        n_kv_heads=max(args.heads // 2, 1),
        mlp_dim=args.dim * 3,
        max_seq_len=args.seq,
    )
    result = auto_accelerate(
        loss_fn=lambda p, b: loss_fn(p, b, cfg),
        optimizer=lambda ps: AGD(ps, lr=3e-4),
        init_params_fn=lambda gen, dev: init_params(
            cfg, gen, dev, dtype=torch.float32),
        device=args.device,
    )
    print(f"strategy: {result.strategy.describe()} | "
          f"params: {result.profile.num_params:,} | "
          f"device: {result.fns.device}", flush=True)

    rng = np.random.default_rng(0)

    def data_iter():
        while True:
            yield {"tokens": rng.integers(
                0, cfg.vocab_size, size=(args.batch, args.seq + 1),
                dtype=np.int32)}

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
                     eval_interval=args.eval_interval),
        data_iter,
        eval_iter_fn=eval_iter,
    )
    summary = trainer.train()
    if args.eval_interval and summary["final_step"] % args.eval_interval:
        print(f"final eval: {trainer.evaluate()}", flush=True)
    print(f"done: {summary}", flush=True)
    return summary, trainer


if __name__ == "__main__":
    main()
