"""PPO math and the replay buffer.

Port of ``dlrover_tpu/rl/ppo.py`` (after ``atorch/atorch/rl``'s PPO
utilities and replay buffer): GAE advantages, the clipped surrogate
policy loss with value clipping and a KL penalty against the frozen
reference policy (the RLHF objective), and rollout storage with random
minibatches.

- ``compute_gae`` is the reference's reverse ``lax.scan`` as a reverse
  loop in fp32; it takes ``[..., T]`` rewards and ``[..., T + 1]``
  values, so one call covers a whole rollout (the trainer's ``vmap``).
- ``ReplayBuffer`` draws its minibatch order from numpy's
  ``default_rng(seed)``, as the reference does, so the two packages see
  the same rows in the same order.
"""

from typing import Dict, List, NamedTuple

import numpy as np
import torch


def compute_gae(
    rewards,  # [..., T]
    values,  # [..., T + 1] (bootstrap at the end)
    gamma: float = 1.0,
    lam: float = 0.95,
):
    """Generalized advantage estimation, a reverse loop over T in fp32:
    ``(advantages, returns)``, each ``[..., T]``."""
    rewards = torch.as_tensor(rewards, dtype=torch.float32)
    values = torch.as_tensor(values, dtype=torch.float32,
                             device=rewards.device)
    t_len = rewards.shape[-1]
    adv = torch.empty_like(rewards)
    gae = torch.zeros_like(rewards[..., 0])
    for t in range(t_len - 1, -1, -1):
        delta = rewards[..., t] + gamma * values[..., t + 1] - values[..., t]
        gae = delta + gamma * lam * gae
        adv[..., t] = gae
    return adv, adv + values[..., :-1]


class PPOOutputs(NamedTuple):
    loss: torch.Tensor
    policy_loss: torch.Tensor
    value_loss: torch.Tensor
    kl: torch.Tensor
    clip_frac: torch.Tensor


def ppo_loss(
    logprobs: torch.Tensor,  # new policy logprobs [B, T]
    old_logprobs: torch.Tensor,  # rollout-time logprobs
    ref_logprobs: torch.Tensor,  # frozen reference policy
    values: torch.Tensor,  # new value estimates [B, T]
    old_values: torch.Tensor,
    advantages: torch.Tensor,  # [B, T]
    returns: torch.Tensor,
    mask: torch.Tensor,  # [B, T] response-token mask
    clip_ratio: float = 0.2,
    value_clip: float = 0.2,
    vf_coef: float = 0.5,
    kl_coef: float = 0.1,
) -> PPOOutputs:
    msum = torch.clamp(torch.sum(mask), min=1.0)

    # normalized advantages over response tokens
    amean = torch.sum(advantages * mask) / msum
    astd = torch.sqrt(
        torch.sum(((advantages - amean) ** 2) * mask) / msum + 1e-8
    )
    adv = (advantages - amean) / astd

    ratio = torch.exp(logprobs - old_logprobs)
    unclipped = ratio * adv
    clipped = torch.clamp(ratio, 1 - clip_ratio, 1 + clip_ratio) * adv
    policy_loss = -torch.sum(
        torch.minimum(unclipped, clipped) * mask
    ) / msum
    clip_frac = torch.sum(
        (torch.abs(ratio - 1.0) > clip_ratio) * mask
    ) / msum

    v_clipped = old_values + torch.clamp(
        values - old_values, -value_clip, value_clip
    )
    value_loss = 0.5 * torch.sum(
        torch.maximum(
            (values - returns) ** 2, (v_clipped - returns) ** 2
        )
        * mask
    ) / msum

    kl = torch.sum((logprobs - ref_logprobs) * mask) / msum

    loss = policy_loss + vf_coef * value_loss + kl_coef * kl
    return PPOOutputs(loss, policy_loss, value_loss, kl, clip_frac)


class ReplayBuffer:
    """Rollout storage with random minibatch sampling."""

    def __init__(self, capacity: int = 4096, seed: int = 0):
        self._capacity = capacity
        self._items: List[Dict] = []
        self._rng = np.random.default_rng(seed)

    def add(self, sample: Dict):
        self._items.append(sample)
        if len(self._items) > self._capacity:
            self._items.pop(0)

    def __len__(self):
        return len(self._items)

    def clear(self):
        self._items.clear()

    def sample_batches(self, batch_size: int, epochs: int = 1):
        """Yield stacked-dict minibatches (numpy), ``epochs`` passes."""
        n = len(self._items)
        for _ in range(epochs):
            order = self._rng.permutation(n)
            for start in range(0, n - batch_size + 1, batch_size):
                idx = order[start : start + batch_size]
                batch = {}
                for key in self._items[0]:
                    batch[key] = np.stack(
                        [self._items[i][key] for i in idx]
                    )
                yield batch
