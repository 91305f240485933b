"""RLHF PPO orchestration over the per-role engine.

Port of ``dlrover_tpu/rl/trainer.py`` (after ``atorch/atorch/rl/
main.py`` and the model engine / trainer split): four roles (actor /
critic / ref / reward), rollout generation on an inference backend whose
weights are the trainer's, experience with KL-shaped rewards and GAE,
then clipped-PPO updates of actor and critic through their own
accelerated train steps.

Model-agnostic: the caller supplies ``actor_forward(params, tokens) ->
logits`` and ``critic_value(params, tokens) -> values [B, S]``; roles
are built through :class:`dlrover_tpu_torch.rl.engine.ModelEngine`, so
each role gets its own parallelization strategy.

PyTorch updates params in place where JAX returns new ones, so the
frozen reference policy is a ``clone()`` of each actor leaf made at
construction, never the live tensors.  The mask, reward and GAE
bookkeeping stays numpy, as in the reference, so its rows line up; the
forwards run on each role's device under ``no_grad``.
"""

from typing import Callable, Dict, Optional

import numpy as np
import torch

from dlrover_tpu_torch.common.log import default_logger as logger
from dlrover_tpu_torch.rl.config import RLConfig
from dlrover_tpu_torch.rl.engine import ModelEngine
from dlrover_tpu_torch.rl.inference import InferenceBackend
from dlrover_tpu_torch.rl.ppo import ReplayBuffer, compute_gae
from dlrover_tpu_torch.rl.sampling import key_words, split


def token_logprobs(logits: torch.Tensor, tokens: torch.Tensor):
    """Next-token logprob per position: [B, S, V], [B, S] -> [B, S-1]."""
    logp = torch.log_softmax(logits[:, :-1].float(), dim=-1)
    return torch.gather(logp, -1, tokens[:, 1:, None].long())[..., 0]


def actor_ppo_loss(
    logits, batch, clip_ratio: float = 0.2, kl_coef: float = 0.1
):
    """Clipped surrogate + KL penalty (the policy half of
    ``ppo.ppo_loss``; the value half lives in the critic's loss)."""
    mask = batch["mask"]
    msum = torch.clamp(torch.sum(mask), min=1.0)
    logp = token_logprobs(logits, batch["tokens"])
    adv = batch["advantages"]
    amean = torch.sum(adv * mask) / msum
    astd = torch.sqrt(
        torch.sum(((adv - amean) ** 2) * mask) / msum + 1e-8
    )
    adv = (adv - amean) / astd
    ratio = torch.exp(logp - batch["old_logp"])
    unclipped = ratio * adv
    clipped = torch.clamp(ratio, 1 - clip_ratio, 1 + clip_ratio) * adv
    policy_loss = -torch.sum(torch.minimum(unclipped, clipped) * mask) / msum
    kl = torch.sum((logp - batch["ref_logp"]) * mask) / msum
    return policy_loss + kl_coef * kl


def critic_value_loss(values, batch, value_clip: float = 0.2):
    """Clipped value regression (the value half of ``ppo.ppo_loss``)."""
    mask = batch["mask"]
    msum = torch.clamp(torch.sum(mask), min=1.0)
    v = values[:, :-1]
    old_v = batch["old_values"]
    v_clip = old_v + torch.clamp(v - old_v, -value_clip, value_clip)
    returns = batch["returns"]
    return 0.5 * torch.sum(
        torch.maximum((v - returns) ** 2, (v_clip - returns) ** 2) * mask
    ) / msum


def _numpy(t) -> np.ndarray:
    if isinstance(t, torch.Tensor):
        return t.detach().cpu().numpy()
    return np.asarray(t)


class RLHFTrainer:
    """Rollout -> experience -> PPO epochs, over engine-built roles."""

    def __init__(
        self,
        config: RLConfig,
        engine: ModelEngine,
        backend: InferenceBackend,
        actor_forward: Callable,
        critic_value: Callable,
        reward_fn: Callable,  # (tokens [B, S] numpy) -> [B] reward
        prompt_len: int,
    ):
        self.config = config
        self.engine = engine
        self.backend = backend
        self._actor_forward = actor_forward
        self._critic_value = critic_value
        self._reward_fn = reward_fn
        self._prompt_len = prompt_len
        self.buffer = ReplayBuffer()
        # frozen reference policy = a copy of the actor params at
        # construction (the live ones are updated in place)
        self._ref_params = _clone(engine.states["actor"]["params"])

    @property
    def ref_params(self):
        return self._ref_params

    def _role_device(self, name: str) -> torch.device:
        return self.engine.roles[name].fns.device

    @torch.no_grad()
    def _logp_fn(self, params, tokens: np.ndarray) -> np.ndarray:
        t = torch.as_tensor(tokens, device=self._role_device("actor"))
        return _numpy(token_logprobs(self._actor_forward(params, t), t))

    @torch.no_grad()
    def _value_fn(self, params, tokens: np.ndarray) -> np.ndarray:
        t = torch.as_tensor(tokens, device=self._role_device("critic"))
        return _numpy(self._critic_value(params, t).float())

    def _fill(self, tokens, mask_t, old_logp, ref_logp, values,
              seq_reward) -> None:
        """KL-shaped per-token rewards (the sequence reward at the last
        response token), GAE, and one buffer row per sample."""
        ppo = self.config.ppo
        b, total = tokens.shape
        r = -ppo.kl_coef * (old_logp - ref_logp) * mask_t
        has_resp = mask_t.any(axis=1)
        last = np.where(
            has_resp,
            (mask_t * np.arange(total - 1)[None]).argmax(axis=1),
            total - 2,
        )
        r[np.arange(b), last] += seq_reward
        # batched GAE: one call for the whole rollout
        adv, ret = compute_gae(torch.from_numpy(r), torch.from_numpy(values),
                               gamma=ppo.gamma, lam=ppo.lam)
        adv, ret = adv.numpy(), ret.numpy()
        for i in range(b):
            self.buffer.add(
                {
                    "tokens": tokens[i],
                    "mask": mask_t[i],
                    "old_logp": old_logp[i],
                    "ref_logp": ref_logp[i],
                    "old_values": values[i, :-1],
                    "advantages": adv[i],
                    "returns": ret[i],
                }
            )

    # -- experience ------------------------------------------------------
    def make_experience(self, prompts, rng) -> Dict:
        """Generate responses, score them, compute advantages, fill the
        replay buffer; returns rollout stats."""
        actor_params = self.engine.states["actor"]["params"]
        self.backend.sync_weights(actor_params)
        tokens = _numpy(self.backend.generate(prompts, rng))

        mask = np.zeros(tokens.shape[:2], np.float32)
        mask[:, self._prompt_len :] = 1.0
        mask_t = mask[:, 1:]  # aligned with next-token logprobs

        old_logp = self._logp_fn(actor_params, tokens)
        ref_logp = self._logp_fn(self._ref_params, tokens)
        values = self._value_fn(self.engine.states["critic"]["params"],
                                tokens)
        seq_reward = np.asarray(self._reward_fn(tokens))
        self._fill(tokens, mask_t, old_logp, ref_logp, values, seq_reward)
        return {
            "mean_reward": float(seq_reward.mean()),
            "mean_kl": float(
                ((old_logp - ref_logp) * mask_t).sum()
                / max(mask_t.sum(), 1.0)
            ),
        }

    def experience_from_trajectories(self, trajectories) -> Dict:
        """PPO experience straight from streamed trajectories (anything
        with ``tokens``, ``prompt_len``, ``new_tokens`` and ``logprobs``,
        the reference's ``rl.flywheel.Trajectory``), using each
        trajectory's CAPTURED per-token logprobs as ``old_logp``: the
        actor forward of :meth:`make_experience` goes (the reference and
        value forwards remain).  Captured logprobs are ``log_softmax`` of
        the sampling policy's fp32 logits, what ``token_logprobs`` would
        recompute; NaN entries (positions a resume hop could not carry)
        fall back to ONE recompute pass for the whole batch."""
        if not trajectories:
            return {"mean_reward": 0.0, "mean_kl": 0.0, "samples": 0}
        b = len(trajectories)
        total = max(int(t.tokens.size) for t in trajectories)
        tokens = np.zeros((b, total), np.int32)
        mask_t = np.zeros((b, total - 1), np.float32)
        old_logp = np.zeros((b, total - 1), np.float32)
        for i, t in enumerate(trajectories):
            n = int(t.tokens.size)
            tokens[i, :n] = t.tokens
            lo = int(t.prompt_len)
            hi = lo + int(t.new_tokens)
            # the response token at position p pairs with next-token
            # logprob row p-1
            mask_t[i, lo - 1:hi - 1] = 1.0
            lp = np.asarray(t.logprobs, np.float32).reshape(-1)
            row = np.full((hi - lo,), np.nan, np.float32)
            row[: min(lp.size, hi - lo)] = lp[: hi - lo]
            old_logp[i, lo - 1:hi - 1] = row
        actor_params = self.engine.states["actor"]["params"]
        if np.isnan(old_logp[mask_t > 0]).any():
            recomputed = self._logp_fn(actor_params, tokens)
            old_logp = np.where(np.isnan(old_logp), recomputed, old_logp)
        else:
            old_logp = np.nan_to_num(old_logp)
        ref_logp = self._logp_fn(self._ref_params, tokens)
        values = self._value_fn(self.engine.states["critic"]["params"],
                                tokens)
        seq_reward = np.asarray(self._reward_fn(tokens))
        self._fill(tokens, mask_t, old_logp, ref_logp, values, seq_reward)
        return {
            "mean_reward": float(seq_reward.mean()),
            "mean_kl": float(
                ((old_logp - ref_logp) * mask_t).sum()
                / max(mask_t.sum(), 1.0)
            ),
            "samples": b,
        }

    # -- optimization ----------------------------------------------------
    def train_on_buffer(self, batch_size: int) -> Dict:
        """PPO epochs over the buffered experience through each role's
        accelerated train step."""
        stats = {"actor_loss": [], "critic_loss": []}
        for batch in self.buffer.sample_batches(
            batch_size, epochs=self.config.ppo.ppo_epochs
        ):
            for name, key in (("actor", "actor_loss"),
                              ("critic", "critic_loss")):
                fns = self.engine.roles[name].fns
                rows = fns.batch_sharding.local(batch)
                rows = {k: torch.as_tensor(v, device=fns.device)
                        for k, v in rows.items()}
                self.engine.states[name], m = fns.train_step(
                    self.engine.states[name], rows)
                stats[key].append(float(m["loss"]))
        self.buffer.clear()
        return {
            k: float(np.mean(v)) if v else 0.0
            for k, v in stats.items()
        }

    def train(
        self,
        prompt_batches,
        rng,
        minibatch_size: Optional[int] = None,
    ):
        """The outer PPO loop (reference ``rl/main.py``); ``rng`` is a
        key (``rl/sampling.py``)."""
        ppo = self.config.ppo
        minibatch_size = minibatch_size or ppo.rollout_batch
        history = []
        key = key_words(rng)
        for step, prompts in enumerate(prompt_batches):
            key, sub = split(key)
            roll = self.make_experience(prompts, sub)
            opt = self.train_on_buffer(minibatch_size)
            logger.info(
                "rlhf step %d: reward %.4f kl %.4f actor %.4f "
                "critic %.4f",
                step, roll["mean_reward"], roll["mean_kl"],
                opt["actor_loss"], opt["critic_loss"],
            )
            history.append({**roll, **opt})
        return history


def _clone(tree):
    if isinstance(tree, dict):
        return {k: _clone(v) for k, v in tree.items()}
    return tree.detach().clone()
