"""Inference backends for RLHF generation.

Port of ``dlrover_tpu/rl/inference.py`` (after ``atorch/atorch/rl/
inference_backend/vllm_backend.py``: the actor's rollouts run on a
serving engine whose weights come from the trainer):

- :class:`JitSamplerBackend`: full-forward autoregressive sampling (no
  cache, O(T^2)), ``ModelEngine.make_sampler``;
- :class:`KVCacheBackend`: prefill, then cached decode through the
  model's ``decode_step``: a T-token generation costs one prefill and T
  one-position steps.  The prefill is one batched forward that fills the
  whole cache when the model has one (``models.llama.prefill``); a model
  without one feeds the prompt one token at a time through the decode
  step (``DLROVER_TPU_GEN_BATCHED_PREFILL=0`` forces that path).  Both
  prefills run the same kernels (B1), and the decode step's and the
  prefill's attention are plain torch, as the reference's are.

Both expose ``generate(prompts, rng, params=None)`` and take their
weights from the live train state: ``sync_weights`` holds a reference
to the actor's params and copies nothing.  PyTorch updates those params
in place, so the backend sees every round's weights by itself.  ``rng``
is a key (``rl/sampling.py``: an int seed, or the two uint32 words of a
JAX key), and every step splits it and draws ``categorical`` over the
whole ``[B, V]`` block as the reference does, so both packages sample
the same tokens.  Tokens come back int32, on the backend's device.

Shape bucketing (``DLROVER_TPU_GEN_BUCKETS``, e.g. ``"16,32,64"``):
prompts pad up to the smallest bucket >= their length and sampling
starts at the real length; causal masking makes the result identical
to the exact-shape one at any temperature (padding sits to the right of
every attended position, and the batch dim, which shapes the noise, is
never padded).  The reference buckets to bound its jit compiles and
counts them (``compile_count``); the port compiles nothing, so it has
no such count, and bucketing only changes the shapes it runs.
"""

from abc import ABCMeta, abstractmethod
from functools import partial
from typing import Callable, Optional, Tuple

import numpy as np
import torch

from dlrover_tpu_torch.common.device import DeviceLike, resolve_device
from dlrover_tpu_torch.common.env import (
    gen_batched_prefill_enabled,
    gen_buckets,
)
from dlrover_tpu_torch.rl.sampling import categorical, key_words, split


def bucket_len(plen: int, buckets: Tuple[int, ...]) -> int:
    """The padded length for a ``plen``-token prompt: the smallest
    bucket that fits, the exact length when none does (an oversized
    prompt must still run).  Only the length dim buckets: padding the
    batch dim would change what ``categorical`` draws per row."""
    for bk in buckets:
        if bk >= plen:
            return bk
    return plen


def _pad_prompts(prompts: torch.Tensor, padded_len: int) -> torch.Tensor:
    plen = prompts.shape[1]
    return torch.nn.functional.pad(prompts, (0, padded_len - plen))


def _as_tokens(prompts, device: torch.device) -> torch.Tensor:
    if isinstance(prompts, torch.Tensor):
        return prompts.to(device)
    return torch.as_tensor(np.asarray(prompts), device=device)


class InferenceBackend(metaclass=ABCMeta):
    """Generation engine fed from the trainer's weights."""

    def __init__(self, device: DeviceLike = None):
        self.device = resolve_device(device)
        self._params = None

    def sync_weights(self, params):
        """Point the backend at the trainer's current actor params (a
        reference: same device memory, no copy)."""
        self._params = params

    @abstractmethod
    def generate(self, prompts, rng, params=None):
        """prompts [B, P] -> tokens [B, P + max_new] (left part
        verbatim, right part sampled)."""


class JitSamplerBackend(InferenceBackend):
    """Full-forward sampler (no KV cache).  The name is the reference's;
    nothing is compiled here."""

    def __init__(self, forward_fn: Callable, max_new_tokens: int,
                 temperature: float = 1.0, device: DeviceLike = None):
        super().__init__(device)
        from dlrover_tpu_torch.rl.engine import ModelEngine

        self._max_new = int(max_new_tokens)
        self._sample = ModelEngine.make_sampler(
            forward_fn, max_new_tokens, temperature
        )

    def generate(self, prompts, rng, params=None):
        params = params if params is not None else self._params
        prompts = _as_tokens(prompts, self.device)
        plen = prompts.shape[1]
        buckets = gen_buckets()
        if not buckets:
            return self._sample(params, prompts, rng)
        out = self._sample(
            params, _pad_prompts(prompts, bucket_len(plen, buckets)), rng,
            plen,
        )
        return out[:, : plen + self._max_new]


class KVCacheBackend(InferenceBackend):
    """Prefill + cached decode on the model's ``decode_step``.

    ``cfg`` is the model's ``LlamaConfig`` (or any config accepted by
    the supplied ``decode_step_fn``/``init_cache_fn``).  ``prefill_fn``
    (``(params, tokens, cache) -> (logits [B, P, V], cache)``) enables
    the batched single-forward prefill; the default wires the llama one
    when the default decode fns are in use, and models without one take
    the one-token-at-a-time prefill.  ``init_cache_fn(batch, max_len)``
    must make the cache on the backend's device."""

    _AUTO = object()

    def __init__(
        self,
        cfg,
        max_new_tokens: int,
        temperature: float = 1.0,
        decode_step_fn: Optional[Callable] = None,
        init_cache_fn: Optional[Callable] = None,
        prefill_fn=_AUTO,
        device: DeviceLike = None,
    ):
        super().__init__(device)
        from dlrover_tpu_torch.models import llama

        self._cfg = cfg
        self._max_new = int(max_new_tokens)
        self._temp = temperature
        default_model = decode_step_fn is None and init_cache_fn is None
        self._decode = decode_step_fn or partial(llama.decode_step,
                                                 cfg=cfg)
        self._init_cache = init_cache_fn or partial(
            llama.init_kv_cache, cfg, device=self.device
        )
        if prefill_fn is KVCacheBackend._AUTO:
            prefill_fn = (
                partial(llama.prefill, cfg=cfg) if default_model else None
            )
        if not gen_batched_prefill_enabled():
            prefill_fn = None
        self._prefill = prefill_fn

    @torch.no_grad()
    def _generate(self, params, prompts: torch.Tensor, plen: int, rng):
        decode, temp, max_new = self._decode, self._temp, self._max_new
        b, padded_len = prompts.shape
        cache = self._init_cache(b, padded_len + max_new)

        if self._prefill is not None:
            # one forward fills every prompt position's K/V; the last
            # REAL position's logits seed the first sample
            all_logits, cache = self._prefill(params, prompts, cache)
            logits = all_logits[:, plen - 1]
        else:
            # one position at a time through the cached step, keeping
            # the logits of the last real position (padding runs past)
            for t in range(padded_len):
                step_logits, cache = decode(params, prompts[:, t], cache, t)
                if t == plen - 1:
                    logits = step_logits

        out = torch.cat(
            [prompts, prompts.new_zeros((b, max_new))], dim=1
        )
        key = key_words(rng)
        for i in range(max_new):
            pos = plen + i
            key, sub = split(key)
            if temp <= 0:
                nxt = torch.argmax(logits, dim=-1)
            else:
                nxt = categorical(sub, logits, temp)
            nxt = nxt.to(out.dtype)
            out[:, pos] = nxt
            if i + 1 < max_new:
                # the reference decodes once more after the last sample
                # and drops the logits; the tokens are the same
                logits, cache = decode(params, nxt, cache, pos)
        return out

    def generate(self, prompts, rng, params=None):
        params = params if params is not None else self._params
        prompts = _as_tokens(prompts, self.device)
        plen = prompts.shape[1]
        buckets = gen_buckets()
        if not buckets:
            return self._generate(params, prompts, plen, rng)
        out = self._generate(
            params, _pad_prompts(prompts, bucket_len(plen, buckets)), plen,
            rng,
        )
        return out[:, : plen + self._max_new]
