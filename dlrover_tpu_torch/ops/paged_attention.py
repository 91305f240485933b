"""Paged (block-table) KV attention for continuous-batching serving.

Port of ``dlrover_tpu/ops/paged_attention.py:111-254``.  Layout: one
layer's pool is ``[num_blocks, block_size, KV, head_dim]``; a sequence
owns a list of block ids (its block table).  Block 0 is the null block:
schedulers point unallocated table entries and inactive lanes at it, and
its contents are never unmasked.

- ``paged_decode_attention`` and ``paged_verify_attention`` are the
  decode-hot ops: the wrappers of ``ops/paged_kernels.py`` under the
  reference's names.  They launch the CUDA kernels for CUDA tensors and
  take the plain versions for CPU tensors; the device decides, there is
  no backend switch.
- :func:`paged_prefill_attention` and :func:`write_block_kv` are plain
  PyTorch, as their counterparts are plain jnp in the reference.
"""

from typing import Tuple

import torch

from dlrover_tpu_torch.ops.paged_kernels import gather_pool
from dlrover_tpu_torch.ops.paged_kernels import (  # noqa: F401 (re-export)
    paged_decode_kernel as paged_decode_attention,
    paged_verify_kernel as paged_verify_attention,
)


def paged_prefill_attention(
    q: torch.Tensor,  # [C, H, D] chunk of query tokens, one sequence
    k_pool: torch.Tensor,  # [num_blocks, block_size, KV, D]
    v_pool: torch.Tensor,
    block_table: torch.Tensor,  # [max_blocks] int32
    start_pos,  # int or 0-d tensor: the chunk's first position
) -> torch.Tensor:
    """Chunked-prefill attention: query ``start_pos + i`` attends keys
    at positions ``<= start_pos + i``.  The chunk's K/V must already be
    in the pool.  Returns ``[C, H, D]``.  Numerics of the reference:
    fp32 logits and softmax, weights cast to ``v.dtype`` before an
    fp32-accumulated ``p @ v``; V rows no query may see are zeroed
    first so garbage past the chunk cannot enter the product."""
    c, nh, d = q.shape
    nkv = k_pool.shape[2]
    group = nh // nkv
    k = gather_pool(k_pool, block_table[None])[0]  # [T, KV, D]
    v = gather_pool(v_pool, block_table[None])[0]
    t = k.shape[0]
    q_pos = start_pos + torch.arange(c, device=q.device)
    visible = torch.arange(t, device=q.device)[None] <= q_pos[:, None]
    v = v.masked_fill(~visible[-1][:, None, None], 0)
    qg = q.float().reshape(c, nkv, group, d)
    logits = torch.einsum("ckgd,tkd->ckgt", qg, k.float()) * (d ** -0.5)
    logits = logits.masked_fill(~visible[:, None, None], -1e30)
    probs = torch.softmax(logits, dim=-1)
    out = torch.einsum(
        "ckgt,tkd->ckgd", probs.to(v.dtype).float(), v.float()
    ).to(v.dtype)
    return out.reshape(c, nh, d)


def write_block_kv(
    k_pool: torch.Tensor,
    v_pool: torch.Tensor,
    k_new: torch.Tensor,  # [N, KV, D] one token's K per write
    v_new: torch.Tensor,
    block_ids: torch.Tensor,  # [N] destination block per token
    offsets: torch.Tensor,  # [N] in-block slot per token
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Scatter N tokens' K/V into their (block, offset) cells IN PLACE
    (``index_put_``; the JAX version returns updated copies of a donated
    pool) and return the same two tensors.  Masked-out writes (inactive
    lanes, padded chunk tails) go to the null block, where concurrent
    writes may collide: its contents are never unmasked."""
    idx = (block_ids.long(), offsets.long())
    k_pool.index_put_(idx, k_new.to(k_pool.dtype))
    v_pool.index_put_(idx, v_new.to(v_pool.dtype))
    return k_pool, v_pool
