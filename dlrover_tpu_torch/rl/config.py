"""Config-driven RLHF setup.

Port of ``dlrover_tpu/rl/config.py`` (itself after
``atorch/atorch/rl/config.py``: a PPO config with per-role
model/optimizer/strategy sections for actor / critic / ref / reward),
the same dataclasses, defaults and ``from_dict``.
"""

from dataclasses import dataclass, field
from typing import Dict, Optional


@dataclass
class RoleConfig:
    """One model role (actor / critic / ref_model / reward_model)."""

    train: bool = True
    learning_rate: float = 1e-6
    strategy: Dict = field(default_factory=dict)  # Strategy kwargs
    checkpoint_dir: str = ""


@dataclass
class PPOParams:
    gamma: float = 1.0
    lam: float = 0.95
    clip_ratio: float = 0.2
    value_clip: float = 0.2
    vf_coef: float = 0.5
    entropy_coef: float = 0.0
    kl_coef: float = 0.1  # penalty vs the frozen reference policy
    ppo_epochs: int = 1
    rollout_batch: int = 64


@dataclass
class RLConfig:
    roles: Dict[str, RoleConfig] = field(default_factory=dict)
    ppo: PPOParams = field(default_factory=PPOParams)
    max_prompt_len: int = 512
    max_response_len: int = 512

    @classmethod
    def from_dict(cls, raw: Dict) -> "RLConfig":
        roles = {
            name: RoleConfig(**cfg)
            for name, cfg in raw.get("roles", {}).items()
        }
        ppo = PPOParams(**raw.get("ppo", {}))
        return cls(
            roles=roles,
            ppo=ppo,
            max_prompt_len=raw.get("max_prompt_len", 512),
            max_response_len=raw.get("max_response_len", 512),
        )

    def role(self, name: str) -> Optional[RoleConfig]:
        return self.roles.get(name)
