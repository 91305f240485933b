"""RLHF PPO starter: per-role engine (actor / critic), KV-cache rollout
generation, clipped-PPO updates.

Port of ``examples/rlhf_ppo.py`` (the same CLI, config, roles, reward
and prompt stream) on one device::

    python -m dlrover_tpu_torch.examples.rlhf_ppo --rounds 2
    python -m dlrover_tpu_torch.examples.rlhf_ppo --device cpu

The toy reward prefers responses ending in even tokens: watch
mean_reward climb while mean_kl stays bounded by the KL penalty against
the frozen reference policy.  ``--cross_process`` (generation in a
separate serving process) is the serving fleet's, ROADMAP A5.1, and
raises here.
"""

import argparse
import os
import sys

sys.path.insert(
    0, os.path.dirname(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))))
)


def parse_args(argv=None):
    p = argparse.ArgumentParser()
    p.add_argument("--rounds", type=int, default=2)
    p.add_argument("--batch", type=int, default=8)
    p.add_argument("--prompt_len", type=int, default=4)
    p.add_argument("--max_new", type=int, default=8)
    p.add_argument("--device", default=None,
                   help="cuda (the default) or cpu")
    # serve generation from a dedicated process (the reference's
    # vLLM-engine topology)
    p.add_argument("--cross_process", action="store_true")
    return p.parse_args(argv)


def main(argv=None):
    args = parse_args(argv)
    if args.cross_process:
        raise NotImplementedError(
            "--cross_process serves generation from a separate process "
            "(CrossProcessGenerationEngine): the serving fleet, ROADMAP "
            "A5.1, not ported yet")

    import numpy as np
    import torch

    from dlrover_tpu_torch.models.llama import (
        LlamaConfig,
        forward,
        init_params,
        param_logical_axes,
    )
    from dlrover_tpu_torch.rl.config import RLConfig
    from dlrover_tpu_torch.rl.engine import ModelEngine
    from dlrover_tpu_torch.rl.inference import KVCacheBackend
    from dlrover_tpu_torch.rl.trainer import (
        RLHFTrainer,
        actor_ppo_loss,
        critic_value_loss,
    )
    from dlrover_tpu_torch.trainer.elastic.context import init_distributed

    cfg = LlamaConfig.tiny(remat="none")
    ctx = init_distributed(args.device)
    dev = ctx.device
    n = ctx.world_size
    config = RLConfig.from_dict(
        {
            "roles": {
                "actor": {"strategy": {"data": n, "remat": "none"}},
                "critic": {"strategy": {"data": n, "remat": "none"}},
            },
            "ppo": {"rollout_batch": args.batch, "ppo_epochs": 1},
        }
    )

    def actor_forward(params, tokens):
        return forward(params, tokens, cfg)

    engine = ModelEngine(config)
    engine.build_role(
        "actor",
        loss_fn=lambda p, b: actor_ppo_loss(
            actor_forward(p, b["tokens"]), b
        ),
        optimizer=lambda ps: torch.optim.Adam(ps, lr=1e-4),
        init_params_fn=lambda g, d: init_params(cfg, g, d, torch.float32),
        param_axes=param_logical_axes(cfg),
        device=dev,
    )

    def critic_init(g, d):
        return {
            "emb": torch.randn((cfg.vocab_size, 16), generator=g, device=d)
            * 0.1,
            "w": torch.zeros((16,), device=d),
        }

    def critic_value(p, tokens):
        return torch.einsum("bse,e->bs", p["emb"][tokens.long()], p["w"])

    engine.build_role(
        "critic",
        loss_fn=lambda p, b: critic_value_loss(
            critic_value(p, b["tokens"]), b
        ),
        optimizer=lambda ps: torch.optim.Adam(ps, lr=1e-3),
        init_params_fn=critic_init,
        param_axes={"emb": (None, None), "w": (None,)},
        device=dev,
    )
    engine.init_role_state("actor", 0)
    engine.init_role_state("critic", 1)

    backend = KVCacheBackend(cfg, max_new_tokens=args.max_new, device=dev)
    trainer = RLHFTrainer(
        config,
        engine,
        backend,
        actor_forward=actor_forward,
        critic_value=critic_value,
        reward_fn=lambda tokens: np.asarray(
            (np.asarray(tokens)[:, -1] % 2 == 0), np.float32
        ),
        prompt_len=args.prompt_len,
    )
    rng = np.random.default_rng(0)
    prompts = [
        rng.integers(
            0, cfg.vocab_size, (args.batch, args.prompt_len)
        ).astype(np.int32)
        for _ in range(args.rounds)
    ]
    history = trainer.train(prompts, 2)
    for i, h in enumerate(history):
        print(
            f"round {i}: reward {h['mean_reward']:.3f} "
            f"kl {h['mean_kl']:.4f} actor_loss {h['actor_loss']:.4f}",
            flush=True,
        )
    return history


if __name__ == "__main__":
    main()
