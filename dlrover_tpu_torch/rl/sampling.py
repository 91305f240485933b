"""Token sampling for the scheduler, batched over lanes on the device.

Counterpart of ``_sample_rows`` / ``_sample_grid`` in
``dlrover_tpu/rl/scheduler.py:391-418``.  The contract is the
reference's: a token is a pure function of ``(seed, position)`` and the
logits, independent of which lane or iteration served it, so a request
gives the same tail alone, batched, or after preemption and resume.

- temperature <= 0: greedy ``argmax``.
- temperature > 0: Gumbel-max, ``argmax(logits / T + g)`` with
  ``g = -log(-log(u))``, which samples ``softmax(logits / T)``.  ``u`` is
  a counter-based integer hash of ``(seed, position, vocab id)`` written
  in torch integer ops, so the CPU and the card draw the same noise.
  These are not JAX's threefry bits: the two packages agree in
  distribution, not token by token, at temperature > 0.
"""

import torch

_M32 = 0xFFFFFFFF


def _hash32(x: torch.Tensor) -> torch.Tensor:
    """A 32-bit integer mixer on int64 tensors holding values in
    ``[0, 2^32)``.  Multipliers stay below 2^31, so no product leaves
    the int64 range."""
    x = x ^ (x >> 16)
    x = (x * 0x21F0AAAD) & _M32
    x = x ^ (x >> 15)
    x = (x * 0x735A2D97) & _M32
    return x ^ (x >> 15)


def uniform_noise(
    seeds: torch.Tensor, positions: torch.Tensor, vocab: int
) -> torch.Tensor:
    """``u [..., vocab]`` in (0, 1), fp32, a function of (seed,
    position, vocab id) only.  ``seeds`` and ``positions`` broadcast to
    the leading shape."""
    seeds, positions = torch.broadcast_tensors(
        seeds.long() & _M32, positions.long() & _M32
    )
    key = _hash32(_hash32(seeds) ^ positions)
    vid = _hash32(
        (torch.arange(vocab, device=key.device) + 0x9E3779B9) & _M32
    )
    bits = _hash32(key[..., None] ^ vid)
    return ((bits >> 8).float() + 0.5) * (1.0 / (1 << 24))


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
    u = uniform_noise(seeds, positions, logits.shape[-1])
    g = -torch.log(-torch.log(u))
    return torch.argmax(
        logits.float() / temperature + g, dim=-1
    ).to(torch.int32)
