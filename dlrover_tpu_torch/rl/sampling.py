"""Token sampling for the scheduler, batched over lanes on the device.

Counterpart of ``_sample_rows`` / ``_sample_grid`` in
``dlrover_tpu/rl/scheduler.py:391-418``.  The contract is the
reference's: a token is a pure function of ``(seed, position)`` and the
logits, independent of which lane or iteration served it, so a request
gives the same tail alone, batched, or after preemption and resume.

- temperature <= 0: greedy ``argmax``.
- temperature > 0: ``jax.random.categorical(fold_in(PRNGKey(seed),
  position), logits / T)``, drawn as JAX draws it: the same threefry
  bits, so the two packages agree token by token.  The steps, in torch
  integer ops on int64 tensors holding 32-bit values (the same on the
  CPU and the card, vectorised over every leading dim and the vocab):

  - ``PRNGKey(seed)`` is ``(0, seed mod 2^32)``: JAX's default 32-bit
    mode cuts a Python int seed to its low 32 bits before
    ``threefry_seed`` (so 2^32 + 3 gives the key of 3);
  - ``fold_in(key, p)`` is ``threefry2x32(key, (0, p))``;
  - the 32-bit random bits of vocab id ``i`` (``jax_threefry_partitionable``,
    the default) are ``x0 ^ x1`` of ``threefry2x32(key, (hi(i), lo(i)))``;
  - uniform: the top 23 bits as the mantissa of a float in [1, 2), minus
    1, mapped to ``[tiny, 1)`` and clamped at ``tiny`` (``finfo(f32).tiny``);
  - Gumbel ``-log(-log(u))`` in fp32 (``mode="low"``, JAX's default);
  - ``argmax(g + logits * (1 / T))``: XLA compiles the reference's
    ``logits / T``, a division by a constant, as a multiply by the fp32
    reciprocal, and so does this.

The integer bits agree with JAX's bit for bit.  ``log`` is the
library's own on each side, so the noise may differ from JAX's in its
last bits, which moves an argmax only at a tie to within an ulp.
"""

import torch

_M32 = 0xFFFFFFFF
# threefry2x32's rotations (two alternating sets of four rounds) and the
# key-schedule parity constant
_ROTATIONS = ((13, 15, 26, 6), (17, 29, 16, 24))
_PARITY = 0x1BD11BDA
_F32_ONE = 0x3F800000
_F32_TINY = torch.finfo(torch.float32).tiny


def threefry2x32(k0, k1, x0, x1):
    """Threefry-2x32 with 20 rounds, as ``jax._src.prng`` computes it, on
    int64 tensors holding values in ``[0, 2^32)`` (they broadcast).
    Returns the two output words.  No product is taken, and a shift
    leaves at most 61 bits, so nothing leaves the int64 range."""
    ks = (k0, k1, k0 ^ k1 ^ _PARITY)
    x0 = (x0 + ks[0]) & _M32
    x1 = (x1 + ks[1]) & _M32
    for i in range(5):
        for r in _ROTATIONS[i % 2]:
            x0 = (x0 + x1) & _M32
            x1 = (((x1 << r) & _M32) | (x1 >> (32 - r))) ^ x0
        x0 = (x0 + ks[(i + 1) % 3]) & _M32
        x1 = (x1 + ks[(i + 2) % 3] + (i + 1)) & _M32
    return x0, x1


def seed_key(seeds: torch.Tensor):
    """``PRNGKey(seed)``'s two words for int64 ``seeds`` (any shape)."""
    seeds = seeds.long() & _M32
    return torch.zeros_like(seeds), seeds


def fold_in(k0, k1, data: torch.Tensor):
    """``jax.random.fold_in(key, data)`` for ``data`` taken as uint32."""
    data = data.long() & _M32
    return threefry2x32(k0, k1, torch.zeros_like(data), data)


def noise_bits(seeds, positions, vocab: int) -> torch.Tensor:
    """``jax.random.bits(fold_in(PRNGKey(seed), position), (vocab,),
    uint32)`` as int64 ``[..., vocab]``; ``seeds`` and ``positions``
    broadcast to the leading shape."""
    seeds, positions = torch.broadcast_tensors(seeds, positions)
    k0, k1 = fold_in(*seed_key(seeds), positions)
    idx = torch.arange(vocab, device=k0.device)
    b0, b1 = threefry2x32(k0[..., None], k1[..., None], idx >> 32,
                          idx & _M32)
    return b0 ^ b1


def uniform_from_bits(bits: torch.Tensor) -> torch.Tensor:
    """``jax.random.uniform(..., minval=tiny, maxval=1.)`` in fp32 from
    its 32-bit random bits: values in ``[tiny, 1)``."""
    f = ((bits >> 9) | _F32_ONE).to(torch.int32).view(torch.float32) - 1.0
    # f * (maxval - minval) + minval, where (1 - tiny) rounds to 1 in fp32
    return (f + _F32_TINY).clamp_min(_F32_TINY)


def gumbel_noise(seeds, positions, vocab: int) -> torch.Tensor:
    """``jax.random.gumbel(fold_in(PRNGKey(seed), position), (vocab,))``
    in fp32, ``[..., vocab]``."""
    u = uniform_from_bits(noise_bits(seeds, positions, vocab))
    return -torch.log(-torch.log(u))


def sample_tokens(
    logits: torch.Tensor,
    seeds: torch.Tensor,
    positions: torch.Tensor,
    temperature: float,
) -> torch.Tensor:
    """``logits [..., V]`` -> int32 tokens ``[...]``.  ``positions`` is
    the OUTPUT position each token will occupy."""
    if temperature <= 0:
        return torch.argmax(logits, dim=-1).to(torch.int32)
    one = torch.tensor(1.0, dtype=torch.float32)
    inv_t = float(one / torch.tensor(temperature, dtype=torch.float32))
    g = gumbel_noise(seeds, positions, logits.shape[-1])
    return torch.argmax(g + logits.float() * inv_t, dim=-1).to(torch.int32)
