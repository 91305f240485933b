"""Per-role model engine for RLHF.

Port of ``dlrover_tpu/rl/engine.py`` (after
``atorch/atorch/rl/model_engine/model_engine.py``): each role (actor /
critic / ref_model / reward_model) is built with its own acceleration
strategy through the port's ``auto_accelerate``; the actor additionally
gets a generation path, a full-forward sampler on the actor params.

- ``optimizer`` is the port's ``OptimizerFn`` (``lambda ps:
  torch.optim.Adam(ps, lr=1e-4)``) where the reference takes
  ``optax.adam``; ``init_params_fn(generator, device)`` builds the
  params, as ``auto_accelerate`` takes it.
- ``init_role_state(name, seed)`` seeds the role's ``init_state``.
  ``set_role_params(name, tree)`` then writes another package's params
  into it (the JAX roles' numpy arrays, dtype kept) before the first
  step: the optimizer's state is still empty, so both packages' Adam
  start from zero moments on the same numbers.
- ``make_sampler`` is the reference's ``lax.scan`` sampler as a Python
  loop over ``max_new_tokens`` (PyTorch runs eagerly; nothing is
  compiled), drawing JAX's bits (``rl/sampling.py``).
"""

from typing import Callable, Dict, Optional

import torch

from dlrover_tpu_torch.accelerate import auto_accelerate, load_strategy
from dlrover_tpu_torch.common.device import DeviceLike
from dlrover_tpu_torch.common.log import default_logger as logger
from dlrover_tpu_torch.models.convert import params_from_jax
from dlrover_tpu_torch.rl.config import RLConfig
from dlrover_tpu_torch.rl.sampling import categorical, key_words, split


class ModelEngine:
    def __init__(self, config: RLConfig):
        self.config = config
        self.roles: Dict[str, object] = {}
        self.states: Dict[str, object] = {}

    def build_role(
        self,
        name: str,
        loss_fn: Callable,
        optimizer,
        init_params_fn: Callable,
        param_axes,
        devices=None,
        device: DeviceLike = None,
    ):
        """Accelerate one role with its configured strategy, on
        ``device`` (the card unless ``"cpu"``)."""
        role_cfg = self.config.role(name)
        strategy = None
        if role_cfg and role_cfg.strategy:
            strategy = load_strategy(role_cfg.strategy)
        result = auto_accelerate(
            loss_fn=loss_fn,
            optimizer=optimizer,
            init_params_fn=init_params_fn,
            param_axes=param_axes,
            devices=devices,
            load_strategy=strategy,
            device=device,
        )
        self.roles[name] = result
        logger.info(
            "role %s -> strategy %s", name, result.strategy.describe()
        )
        return result

    def init_role_state(self, name: str, seed: int = 0):
        state = self.roles[name].fns.init_state(seed)
        self.states[name] = state
        return state

    @torch.no_grad()
    def set_role_params(self, name: str, tree):
        """Copy ``tree`` (nested dict of arrays, e.g. the JAX role's
        params through ``numpy.asarray``) into the role's params in
        place, each leaf keeping its dtype; the optimizer keeps its
        (untouched) state.  Shapes must match leaf for leaf."""
        params = self.states[name]["params"]
        src = params_from_jax(tree, device=self.roles[name].fns.device,
                              dtype=None)

        def walk(dst, new, path):
            if isinstance(dst, dict):
                if set(dst) != set(new):
                    raise ValueError(f"{name}{path}: keys {sorted(new)} "
                                     f"are not {sorted(dst)}")
                for k in dst:
                    walk(dst[k], new[k], f"{path}/{k}")
                return
            if tuple(dst.shape) != tuple(new.shape):
                raise ValueError(f"{name}{path}: shape {tuple(new.shape)} "
                                 f"is not {tuple(dst.shape)}")
            dst.copy_(new)

        walk(params, src, "")
        return self.states[name]

    # --------------------------------------------------------- generation
    @staticmethod
    def make_sampler(
        forward_fn: Callable,  # (params, tokens) -> logits
        max_new_tokens: int,
        temperature: float = 1.0,
        eos_id: Optional[int] = None,
    ):
        """Autoregressive sampler on the actor with no KV cache (fine for
        short RLHF responses; the cached decoder swaps in without
        changing callers): ``sample(params, prompt, rng,
        prompt_len=None) -> tokens [B, P + max_new]``.

        ``prompt_len`` is the REAL prompt length when ``prompt`` is
        padded to a length bucket (``DLROVER_TPU_GEN_BUCKETS``): sampling
        starts there, and causal attention keeps the padded tail
        invisible to every sampled position."""

        @torch.no_grad()
        def sample(params, prompt, rng, prompt_len=None):
            b, padded_len = prompt.shape
            cur = padded_len if prompt_len is None else int(prompt_len)
            total = padded_len + max_new_tokens
            tokens = torch.zeros((b, total), dtype=prompt.dtype,
                                 device=prompt.device)
            tokens[:, :padded_len] = prompt
            key = key_words(rng)
            for _ in range(max_new_tokens):
                logits = forward_fn(params, tokens)
                # the last real position's logits
                last = logits[:, min(max(cur - 1, 0), total - 1)]
                key, sub = split(key)
                if temperature <= 0:
                    nxt = torch.argmax(last, dim=-1)
                else:
                    nxt = categorical(sub, last, temperature)
                tokens[:, cur] = nxt.to(tokens.dtype)
                cur += 1
            return tokens

        return sample
