"""Llama family in PyTorch: the training forward and loss, and the
paged serving steps.

Port of ``dlrover_tpu/models/llama.py`` (``LlamaConfig`` :33-85,
``init_params`` :91-124, ``rms_norm``/RoPE :248-275, the training
forward and loss :278-447 and :957-996, the dense-cache serving steps
:453-590 and the paged steps :597-949): RMSNorm + RoPE (split-half) +
GQA + SwiGLU.

Training keeps fp32 master weights (``init_params(..., dtype=
torch.float32)``) and computes in ``cfg.dtype``: every projection casts
its weight, multiplies with fp32 accumulation and gives ``cfg.dtype``,
as JAX's ``preferred_element_type`` matmuls do.  Attention defaults to
``ops.flash_attention`` (the CUDA kernels on the card, the plain version
on the CPU).

Params are a plain dict with the JAX package's layout: ``embed [V, D]``,
``layers`` a dict of tensors stacked on dim 0 (``wq [L, D, H*hd]``,
projections ``[in, out]``), ``final_norm [D]``, ``lm_head [D, V]``.  The
JAX ``lax.scan`` over stacked layers is a Python loop here.  Under the
sharded train step each leaf is the rank's slice (``param_logical_axes``,
``parallel/sharding.py``), and the training forward reads the mesh from
the active ``ParamGather``:

- fsdp: the gather returns full weights where they are used, a layer's
  inside its (checkpointed) layer function, the embedding, final norm
  and head around their own use;
- tensor: ``wq``/``wk``/``wv``/``w_gate``/``w_up`` are column-parallel
  over the local heads and MLP columns, ``wo``/``w_down`` row-parallel,
  each followed by a sum over the tensor group (Megatron's conjugate
  pair, ``parallel.collectives.copy_to``/``reduce_from``); the embedding
  and the head are vocab-parallel (a masked lookup summed over tensor,
  and a cross entropy over the vocab shard);
- seq: ``loss_fn`` cuts the inputs and targets to the rank's chunk of
  the sequence, RoPE positions start at the chunk's, and the attention
  is Ulysses or ring (``accelerate.module_replace.select_attention``);
- pipe: the rank's layers are one stage of the GPipe executor
  (``module_replace.select_layer_executor``).

Serving weights are stored once in ``cfg.dtype``: JAX keeps fp32 master
weights and casts them at every matmul, which gives the same numbers.
Each projection is a ``cfg.dtype`` matmul (fp32 accumulation, output in
``cfg.dtype``); the lm-head logits are fp32: the product of the
``cfg.dtype`` hidden state and head with fp32 accumulation and fp32
output, as JAX gets from ``preferred_element_type=float32`` (on the
card ``torch.mm(..., out_dtype=float32)``; on the CPU, which has no such
mm, the same values cast to fp32 first).  A ``cfg.dtype`` matmul would
round the logits and flip greedy near-ties.

The pool (``{"k","v"}: [L, num_blocks, block_size, KV, hd]``) is
updated IN PLACE by the decode and prefill steps (JAX donates it and
returns a new one); each step still returns it, so callers read like
the reference.

The dense-cache steps (``init_kv_cache``, ``decode_step``, ``prefill``:
the whole-batch generators' path, ``rl/inference.py``) run on the
*training* params, fp32 master weights, as the reference's do: each
projection casts its weight to ``cfg.dtype`` (``_proj``), the logits are
fp32 (``_mm_f32``), and the norms are B1.  Their attention is plain
torch, as the reference's is: one query over the cached prefix in the
decode step (``jnp`` in the reference), the dense
``dot_product_attention`` in the prefill.  The cache
(``{"k","v"}: [L, B, max_len, KV, hd]`` in ``cfg.dtype``) is written in
place and returned.
"""

from dataclasses import dataclass
from typing import Callable, Dict, Optional, Tuple

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import (
    CheckpointPolicy,
    checkpoint,
    create_selective_checkpoint_contexts,
)

from dlrover_tpu_torch.common.device import DeviceLike, resolve_device
from dlrover_tpu_torch.parallel import sharding as sh
from dlrover_tpu_torch.parallel.collectives import copy_to, reduce_from
from dlrover_tpu_torch.parallel.mesh import AxisName
from dlrover_tpu_torch.ops.flash_attention import flash_attention
from dlrover_tpu_torch.ops.fused import (
    _mm_f32,
    add_rms_norm,
    fused_linear_cross_entropy,
    rms_norm,
    vocab_parallel_nll,
)
from dlrover_tpu_torch.ops.paged_attention import (
    paged_decode_attention,
    paged_prefill_attention,
    paged_verify_attention,
    write_block_kv,
)

Params = Dict


@dataclass(frozen=True)
class LlamaConfig:
    vocab_size: int = 32000
    dim: int = 4096
    n_layers: int = 32
    n_heads: int = 32
    n_kv_heads: int = 8
    mlp_dim: int = 11008
    max_seq_len: int = 4096
    rope_theta: float = 10000.0
    norm_eps: float = 1e-5
    dtype: torch.dtype = torch.bfloat16
    # training: activation recompute per layer, "none" | "full" | "dots"
    # (the projections' outputs saved, the rest of the layer recomputed)
    remat: str = "full"
    # fused-CE row chunk (peak logits memory = chunk x vocab fp32)
    ce_chunk_rows: int = 512
    # the source checkpoint tied lm_head to the embedding; the params
    # keep them separate, as the JAX package does, and only the HF
    # export (not ported yet) reads it
    tie_word_embeddings: bool = False

    def __post_init__(self):
        if self.tie_word_embeddings:
            raise NotImplementedError(
                "tie_word_embeddings=True is read only by the HF export, "
                "not ported yet: ROADMAP A7 (models/hf_convert.py)"
            )

    @property
    def head_dim(self) -> int:
        return self.dim // self.n_heads

    @staticmethod
    def tiny(**overrides) -> "LlamaConfig":
        """Test-sized config (the JAX package's ``tiny``)."""
        base = dict(
            vocab_size=256,
            dim=64,
            n_layers=2,
            n_heads=4,
            n_kv_heads=2,
            mlp_dim=128,
            max_seq_len=128,
        )
        base.update(overrides)
        return LlamaConfig(**base)

    @staticmethod
    def llama2_7b(**overrides) -> "LlamaConfig":
        base = dict(
            vocab_size=32000,
            dim=4096,
            n_layers=32,
            n_heads=32,
            n_kv_heads=32,
            mlp_dim=11008,
            max_seq_len=4096,
        )
        base.update(overrides)
        return LlamaConfig(**base)


def init_params(
    cfg: LlamaConfig,
    generator: Optional[torch.Generator] = None,
    device: DeviceLike = None,
    dtype: Optional[torch.dtype] = None,
) -> Params:
    """Random params in the JAX layout: dense weights ``N(0, 1/fan_in)``
    and unit norms, drawn from ``generator`` (a ``torch.Generator`` on
    ``device``; seed 0 when omitted) straight into ``dtype`` (default
    ``cfg.dtype``; training passes ``torch.float32`` for master weights)
    on the device.  ``device="meta"`` gives shapes only (no generator).
    Not JAX's numbers: tests that compare the two packages convert JAX
    params with ``models.convert``."""
    meta = device is not None and torch.device(device).type == "meta"
    dev = torch.device("meta") if meta else resolve_device(device)
    dt = dtype or cfg.dtype
    if generator is None and not meta:
        generator = torch.Generator(device=dev).manual_seed(0)
    d, hd = cfg.dim, cfg.head_dim
    nh, nkv, mlp, L = cfg.n_heads, cfg.n_kv_heads, cfg.mlp_dim, cfg.n_layers

    def dense(*shape, fan_in):
        w = torch.empty(shape, dtype=dt, device=dev)
        return w.normal_(0.0, fan_in ** -0.5, generator=generator)

    def norm(*shape):
        return torch.ones(shape, dtype=dt, device=dev)

    layers = {
        "attn_norm": norm(L, d),
        "wq": dense(L, d, nh * hd, fan_in=d),
        "wk": dense(L, d, nkv * hd, fan_in=d),
        "wv": dense(L, d, nkv * hd, fan_in=d),
        "wo": dense(L, nh * hd, d, fan_in=nh * hd),
        "mlp_norm": norm(L, d),
        "w_gate": dense(L, d, mlp, fan_in=d),
        "w_up": dense(L, d, mlp, fan_in=d),
        "w_down": dense(L, mlp, d, fan_in=mlp),
    }
    return {
        "embed": dense(cfg.vocab_size, d, fan_in=d),
        "layers": layers,
        "final_norm": norm(d),
        "lm_head": dense(d, cfg.vocab_size, fan_in=d),
    }


def param_logical_axes(cfg: LlamaConfig) -> Dict:
    """Same structure as ``init_params``, leaves = logical-axes tuples
    (None = replicated dim); a copy of the JAX version's."""
    return {
        "embed": (sh.VOCAB, sh.EMBED),
        "layers": {
            "attn_norm": (sh.LAYERS, None),
            "wq": (sh.LAYERS, sh.EMBED, sh.HEADS),
            "wk": (sh.LAYERS, sh.EMBED, sh.KV_HEADS),
            "wv": (sh.LAYERS, sh.EMBED, sh.KV_HEADS),
            "wo": (sh.LAYERS, sh.HEADS, sh.EMBED),
            "mlp_norm": (sh.LAYERS, None),
            "w_gate": (sh.LAYERS, sh.EMBED, sh.MLP),
            "w_up": (sh.LAYERS, sh.EMBED, sh.MLP),
            "w_down": (sh.LAYERS, sh.MLP, sh.EMBED),
        },
        "final_norm": (None,),
        "lm_head": (sh.EMBED, sh.VOCAB),
    }


def _full(gather, params: Params, name: str) -> torch.Tensor:
    """A top-level leaf, gathered around its use under fsdp."""
    t = params[name]
    return t if gather is None else gather.leaf(name, t)


def rope_frequencies(cfg: LlamaConfig, positions: torch.Tensor):
    """positions ``[...]`` -> cos/sin ``[..., head_dim/2]`` (fp32)."""
    half = cfg.head_dim // 2
    exponent = -torch.arange(0, half, dtype=torch.float32,
                             device=positions.device) / half
    # a fill, not a host-to-device copy: a decode step issues no copy or
    # sync of its own, so it can be captured in a CUDA graph
    freqs = torch.pow(
        torch.full((), cfg.rope_theta, dtype=torch.float32,
                   device=positions.device),
        exponent,
    )
    angles = positions.to(torch.float32)[..., None] * freqs
    return torch.cos(angles), torch.sin(angles)


def _rotate(x, cos, sin):
    half = x.shape[-1] // 2
    xf = x.float()
    x1, x2 = xf[..., :half], xf[..., half:]
    out1 = x1 * cos - x2 * sin
    out2 = x2 * cos + x1 * sin
    return torch.cat([out1, out2], dim=-1).to(x.dtype)


def apply_rope(x, cos, sin):
    """x ``[B, S, H, D]``, cos/sin ``[S, D/2]``: every batch row at the
    same positions (split-half convention)."""
    return _rotate(x, cos[None, :, None, :], sin[None, :, None, :])


def _apply_rope_rows(x, cos, sin):
    """x ``[B, 1, H, D]``, cos/sin ``[B, D/2]``: each row at its own
    position (continuous-batching decode)."""
    return _rotate(x, cos[:, None, None, :], sin[:, None, None, :])


def _apply_rope_grid(x, cos, sin):
    """x ``[B, C, H, D]``, cos/sin ``[B, C, D/2]``: every (lane, window
    offset) at its own position (multi-token verify)."""
    return _rotate(x, cos[:, :, None, :], sin[:, :, None, :])


def _layer(params: Params, i: int) -> Dict[str, torch.Tensor]:
    return {k: v[i] for k, v in params["layers"].items()}


def _norm(cfg: LlamaConfig, x, delta, w):
    """``(x + delta, its norm)``, or ``(x, its norm)`` with no pending
    ``delta``.  The serving steps carry each residual branch's output
    (``delta``) to the norm that follows it, so the add and the norm are
    one kernel on the card; the values are the unfused ones."""
    if delta is None:
        return x, rms_norm(x, w, cfg.norm_eps)
    return add_rms_norm(x, delta, w, cfg.norm_eps)


def _mlp(lp, h):
    """The SwiGLU branch on the normed ``h``: its residual delta."""
    gate = F.silu(torch.matmul(h, lp["w_gate"]))
    up = torch.matmul(h, lp["w_up"])
    return torch.matmul(gate * up, lp["w_down"])


def _attn_residual(cfg: LlamaConfig, lp, x, attn):
    """``x + attn @ wo`` and the MLP norm of it, then the MLP branch:
    ``(residual stream, the MLP's pending delta)``."""
    o = torch.matmul(attn.reshape(*x.shape[:-1], -1), lp["wo"])
    x, h = add_rms_norm(x, o, lp["mlp_norm"], cfg.norm_eps)
    return x, _mlp(lp, h)


def _logits(cfg: LlamaConfig, params: Params, x, delta):
    """The last layer's pending ``delta`` added, the final norm, and the
    fp32 lm-head logits (see the module docstring)."""
    _, x = _norm(cfg, x, delta, params["final_norm"])
    head = params["lm_head"]
    if head.is_cuda and head.dtype != torch.float32:
        # cuBLAS takes the bf16/fp16 operands and writes fp32: no fp32
        # copy of the [D, vocab] head on every step
        y = torch.mm(x.reshape(-1, x.shape[-1]), head,
                     out_dtype=torch.float32)
        return y.reshape(*x.shape[:-1], head.shape[1])
    return torch.matmul(x.float(), head.float())


def _write_targets(positions, block_tables, active, bs: int):
    """(block, offset) cells for tokens at ``positions`` ([B] or
    [B, C]) of lanes with tables ``[B, MB]``.  Inactive lanes and
    positions past the table go to the null block: a clamped lookup
    would alias the lane's last real block and overwrite real K/V."""
    mb = block_tables.shape[1]
    blk_idx = torch.div(positions, bs, rounding_mode="floor")
    idx = blk_idx.clamp(max=mb - 1).long()
    squeeze = idx.dim() == 1
    if squeeze:
        idx = idx[:, None]
    blk = torch.gather(block_tables, 1, idx)
    if squeeze:
        blk = blk[:, 0]
    act = active if positions.dim() == 1 else active[:, None]
    blk = torch.where(act & (blk_idx < mb), blk, torch.zeros_like(blk))
    off = torch.where(act, positions % bs, torch.zeros_like(positions))
    return blk, off


def paged_decode_step(
    params: Params,
    tokens: torch.Tensor,  # [B] current token per slot
    pool: Dict[str, torch.Tensor],  # [L, num_blocks, bs, KV, hd] each
    block_tables: torch.Tensor,  # [B, max_blocks] int32
    positions: torch.Tensor,  # [B] int32 position decoded per slot
    active: torch.Tensor,  # [B] bool
    cfg: LlamaConfig,
) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """One continuous-batching decode step: every active slot advances
    its own sequence by one token at its own position.  Inactive lanes
    write to the null block and attend to it (``seq_len`` 1, table row
    0); their logits are garbage the caller discards.  Returns
    ``(logits [B, vocab] fp32, pool)``; the pool is written in place."""
    b = tokens.shape[0]
    nh, nkv, hd = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    bs = pool["k"].shape[2]
    x = params["embed"][tokens.long()][:, None]  # [B, 1, D]
    cos, sin = rope_frequencies(cfg, positions)  # [B, hd/2]
    blk, off = _write_targets(positions, block_tables, active, bs)
    one = torch.ones_like(positions)
    seq_lens = torch.where(active, positions + 1, one).to(torch.int32)
    tables = block_tables.to(torch.int32).contiguous()
    delta = None
    for i in range(cfg.n_layers):
        lp = _layer(params, i)
        k_pool, v_pool = pool["k"][i], pool["v"][i]
        x, h = _norm(cfg, x, delta, lp["attn_norm"])
        q = _apply_rope_rows(
            torch.matmul(h, lp["wq"]).reshape(b, 1, nh, hd), cos, sin
        )
        k = _apply_rope_rows(
            torch.matmul(h, lp["wk"]).reshape(b, 1, nkv, hd), cos, sin
        )
        v = torch.matmul(h, lp["wv"]).reshape(b, 1, nkv, hd)
        write_block_kv(k_pool, v_pool, k[:, 0], v[:, 0], blk, off)
        attn = paged_decode_attention(
            q[:, 0].contiguous(), k_pool, v_pool, tables, seq_lens
        )
        x, delta = _attn_residual(cfg, lp, x, attn)
    return _logits(cfg, params, x, delta)[:, 0], pool


def paged_verify_step(
    params: Params,
    tokens: torch.Tensor,  # [B, C] window of C tokens per lane
    pool: Dict[str, torch.Tensor],
    block_tables: torch.Tensor,  # [B, max_blocks] int32
    positions: torch.Tensor,  # [B] int32 lane's first window position
    active: torch.Tensor,  # [B] bool
    cfg: LlamaConfig,
) -> torch.Tensor:
    """Score a C-token draft window for every lane in one forward.
    ``tokens[b, i]`` sits at ``positions[b] + i`` and its K/V must
    already be in the pool (the draft loop wrote it): this step only
    reads the pool.  Returns logits ``[B, C, vocab]`` (fp32); row ``i``
    predicts the token at ``positions[b] + i + 1``."""
    b, c = tokens.shape
    nh, hd = cfg.n_heads, cfg.head_dim
    pos_grid = positions[:, None] + torch.arange(
        c, device=positions.device, dtype=positions.dtype
    )[None]
    x = params["embed"][tokens.long()]  # [B, C, D]
    cos, sin = rope_frequencies(cfg, pos_grid)  # [B, C, hd/2]
    safe_pos = torch.where(
        active, positions, torch.zeros_like(positions)
    ).to(torch.int32)
    tables = block_tables.to(torch.int32).contiguous()
    delta = None
    for i in range(cfg.n_layers):
        lp = _layer(params, i)
        x, h = _norm(cfg, x, delta, lp["attn_norm"])
        q = _apply_rope_grid(
            torch.matmul(h, lp["wq"]).reshape(b, c, nh, hd), cos, sin
        )
        attn = paged_verify_attention(
            q.contiguous(), pool["k"][i], pool["v"][i], tables, safe_pos
        )
        x, delta = _attn_residual(cfg, lp, x, attn)
    return _logits(cfg, params, x, delta)


def paged_prefill_chunk(
    params: Params,
    tokens: torch.Tensor,  # [1, C] one sequence's prompt chunk
    pool: Dict[str, torch.Tensor],
    block_table: torch.Tensor,  # [max_blocks] int32
    start_pos,  # int: the chunk's first position
    cfg: LlamaConfig,
) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """Prefill C prompt positions of ONE sequence into its paged
    blocks.  Padded tail positions write ahead of the prompt into the
    sequence's own blocks (decode overwrites each before it becomes
    visible); positions past the table go to the null block.  Returns
    ``(logits [1, C, vocab] fp32, pool)``; the pool is written in
    place."""
    b, c = tokens.shape
    nh, nkv, hd = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    bs = pool["k"].shape[2]
    dev = tokens.device
    positions = start_pos + torch.arange(c, device=dev)  # [C]
    x = params["embed"][tokens.long()]  # [1, C, D]
    cos, sin = rope_frequencies(cfg, positions)
    blk, off = _write_targets(
        positions[None], block_table[None],
        torch.ones(1, dtype=torch.bool, device=dev), bs,
    )
    blk, off = blk[0], off[0]
    delta = None
    for i in range(cfg.n_layers):
        lp = _layer(params, i)
        k_pool, v_pool = pool["k"][i], pool["v"][i]
        x, h = _norm(cfg, x, delta, lp["attn_norm"])
        q = apply_rope(
            torch.matmul(h, lp["wq"]).reshape(b, c, nh, hd), cos, sin
        )
        k = apply_rope(
            torch.matmul(h, lp["wk"]).reshape(b, c, nkv, hd), cos, sin
        )
        v = torch.matmul(h, lp["wv"]).reshape(b, c, nkv, hd)
        write_block_kv(k_pool, v_pool, k[0], v[0], blk, off)
        attn = paged_prefill_attention(
            q[0], k_pool, v_pool, block_table, start_pos
        )
        x, delta = _attn_residual(cfg, lp, x, attn)
    return _logits(cfg, params, x, delta), pool


# ------------------------------------------------------ dense-cache decode


def init_kv_cache(cfg: LlamaConfig, batch: int, max_len: int,
                  device: DeviceLike = None) -> Dict[str, torch.Tensor]:
    """Per-layer K/V cache for autoregressive decode, stacked on the layer
    dim like the params: ``{"k","v"}: [L, batch, max_len, KV, hd]`` zeros
    in ``cfg.dtype`` on ``device`` (the card unless ``"cpu"``)."""
    dev = resolve_device(device)
    shape = (cfg.n_layers, batch, max_len, cfg.n_kv_heads, cfg.head_dim)
    return {"k": torch.zeros(shape, dtype=cfg.dtype, device=dev),
            "v": torch.zeros(shape, dtype=cfg.dtype, device=dev)}


def _cached_forward(cfg: LlamaConfig, params: Params, tokens, positions,
                    cache, write, attend):
    """The dense-cache layers over ``tokens [B, S]`` at ``positions
    [S]``: ``write(cache_leaf, t)`` stores a layer's new K or V,
    ``attend(q, k, v, k_cache, v_cache)`` gives its attention output
    ``[B, S, H, hd]``.  Returns the fp32 logits ``[B, S, vocab]``."""
    dt = cfg.dtype
    b, s = tokens.shape
    nh, nkv, hd = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    x = params["embed"][tokens.long()].to(dt)
    cos, sin = rope_frequencies(cfg, positions)
    delta = None
    for i in range(cfg.n_layers):
        lp = _layer(params, i)
        k_cache, v_cache = cache["k"][i], cache["v"][i]
        x, h = _norm(cfg, x, delta, lp["attn_norm"])
        q = apply_rope(_proj(h, lp["wq"], dt).reshape(b, s, nh, hd),
                       cos, sin)
        k = apply_rope(_proj(h, lp["wk"], dt).reshape(b, s, nkv, hd),
                       cos, sin)
        v = _proj(h, lp["wv"], dt).reshape(b, s, nkv, hd)
        write(k_cache, k)
        write(v_cache, v)
        attn = attend(q, k, v, k_cache, v_cache)
        o = _proj(attn.reshape(b, s, nh * hd), lp["wo"], dt)
        x, h = add_rms_norm(x, o, lp["mlp_norm"], cfg.norm_eps)
        gate = F.silu(_proj(h, lp["w_gate"], dt))
        delta = _proj(gate * _proj(h, lp["w_up"], dt), lp["w_down"], dt)
    _, x = _norm(cfg, x, delta, params["final_norm"])
    logits = _mm_f32(x.reshape(b * s, -1), params["lm_head"].to(dt))
    return logits.reshape(b, s, -1)


@torch.no_grad()
def decode_step(
    params: Params,
    tokens: torch.Tensor,  # [B] the token at ``pos`` of every row
    cache: Dict[str, torch.Tensor],
    pos: int,  # the position being decoded
    cfg: LlamaConfig,
) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """One cached decode step: logits ``[B, vocab]`` (fp32) for position
    ``pos`` and the cache with this position's K/V written (in place).
    Prior positions' K/V are read from the cache, so a T-token
    generation costs T one-position forwards."""
    dev = tokens.device
    dt = cfg.dtype
    hd = cfg.head_dim
    valid = torch.arange(cache["k"].shape[2], device=dev) <= pos

    def write(leaf, t):
        leaf[:, pos] = t[:, 0]

    def attend(q, k, v, k_cache, v_cache):
        # the single query over the cached prefix (causal: <= pos)
        b = q.shape[0]
        qg = q.reshape(b, k_cache.shape[2], -1, hd)
        logits = torch.einsum("bkgd,bskd->bkgs", qg.float(),
                              k_cache.float()) * (hd ** -0.5)
        logits = logits.masked_fill(~valid, -1e30)
        probs = torch.softmax(logits, dim=-1)
        attn = torch.einsum("bkgs,bskd->bkgd", probs.to(dt).float(),
                            v_cache.float()).to(dt)
        return attn.reshape(b, 1, -1, hd)

    positions = torch.full((1,), pos, dtype=torch.long, device=dev)
    logits = _cached_forward(cfg, params, tokens[:, None], positions,
                             cache, write, attend)
    return logits[:, 0], cache


@torch.no_grad()
def prefill(
    params: Params,
    tokens: torch.Tensor,  # [B, P] prompt tokens
    cache: Dict[str, torch.Tensor],
    cfg: LlamaConfig,
) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """Batched single-forward prefill: one causal pass over the whole
    prompt that writes every position's K/V into the cache (in place).
    Returns ``(logits [B, P, vocab] fp32, cache)``; callers gather the
    last *real* position's row to sample the first new token."""
    p = tokens.shape[1]

    def write(leaf, t):
        leaf[:, :p] = t

    def attend(q, k, v, k_cache, v_cache):
        return dot_product_attention(q, k, v, causal=True)

    positions = torch.arange(p, device=tokens.device)
    return _cached_forward(cfg, params, tokens, positions, cache, write,
                           attend), cache


# ------------------------------------------------------------- training

AttentionFn = Callable[..., torch.Tensor]

# fused CE kicks in for real vocabularies; tiny test configs keep the
# dense form, as in the JAX package
_FUSED_CE_MIN_VOCAB = 8192


def dot_product_attention(q, k, v, causal: bool = True):
    """Dense reference attention ``[B,S,H,D] x [B,S,KV,D]`` (GQA by
    ``H // KV``): fp32 logits, ``-1e30`` causal mask, fp32 softmax,
    probabilities cast to ``v.dtype`` before ``p v``, output in
    ``v.dtype``."""
    b, s, nh, d = q.shape
    nkv = k.shape[2]
    qg = q.reshape(b, s, nkv, nh // nkv, d)
    logits = torch.einsum("bqkgd,bskd->bkgqs", qg.float(), k.float())
    logits = logits * (d ** -0.5)
    if causal:
        mask = torch.ones(s, s, dtype=torch.bool, device=q.device).tril()
        logits = logits.masked_fill(~mask, -1e30)
    probs = torch.softmax(logits, dim=-1)
    out = torch.einsum(
        "bkgqs,bskd->bqkgd", probs.to(v.dtype).float(), v.float()
    ).to(v.dtype)
    return out.reshape(b, s, nh, d)


def _proj(a, w, dt):
    """``a @ w`` with the fp32 master weight cast to ``dt``, fp32
    accumulation, result in ``dt``."""
    return torch.matmul(a, w.to(dt))


def _layer_forward(cfg: LlamaConfig, attention_fn: AttentionFn, lp, x,
                   cos, sin, tp=None):
    """One layer on the rank's weights: under ``tp`` (the tensor group)
    the local heads and MLP columns, the row-parallel products summed
    over the group."""
    b, s, _ = x.shape
    hd = cfg.head_dim
    dt = cfg.dtype
    h = copy_to(rms_norm(x, lp["attn_norm"], cfg.norm_eps), tp)
    q = apply_rope(_proj(h, lp["wq"], dt).reshape(b, s, -1, hd), cos, sin)
    k = apply_rope(_proj(h, lp["wk"], dt).reshape(b, s, -1, hd), cos, sin)
    v = _proj(h, lp["wv"], dt).reshape(b, s, -1, hd)
    attn = attention_fn(q, k, v, causal=True)
    # the add before the MLP norm goes into its kernel; the one at the
    # layer's end crosses the per-layer checkpoint and stays an add
    o = reduce_from(_proj(attn.reshape(b, s, -1), lp["wo"], dt), tp)
    x, h = add_rms_norm(x, o, lp["mlp_norm"], cfg.norm_eps)
    h = copy_to(h, tp)
    gate = F.silu(_proj(h, lp["w_gate"], dt))
    up = _proj(h, lp["w_up"], dt)
    return x + reduce_from(_proj(gate * up, lp["w_down"], dt), tp)


def _dots_policy(ctx, op, *args, **kwargs):
    """JAX's ``checkpoint_dots_with_no_batch_dims``: save the products
    that have no batch dim, recompute everything else.  In a layer those
    are the seven projections, each a ``[tokens, in] x [in, out]``
    ``aten.mm`` (``torch.matmul`` folds the 3-D activation onto 2-D);
    the plain attention's products are batched (``aten.bmm``), and the
    norms, RoPE, ``silu``, the weight casts, the fsdp gathers, the
    tensor all-reduces and the flash kernels are recomputed."""
    if op is torch.ops.aten.mm.default:
        return CheckpointPolicy.MUST_SAVE
    return CheckpointPolicy.PREFER_RECOMPUTE


def _dots_contexts():
    """The selective checkpoint's forward and recompute contexts under
    ``_dots_policy`` (``checkpoint``'s ``context_fn``)."""
    return create_selective_checkpoint_contexts(_dots_policy)


def check_mesh(cfg: LlamaConfig, mesh_ctx) -> None:
    """ValueError where the model cannot run over ``mesh_ctx``: a tensor
    axis that does not split the heads and the kv heads into whole heads
    a rank (the column-parallel attention keeps a head on one rank).
    ``auto_accelerate(check_mesh=...)`` runs it when it builds a
    candidate's mesh, so that a dry run agrees such a candidate away on
    every rank; the forward runs it too."""
    if mesh_ctx is None:
        return
    n = mesh_ctx.axis_size(AxisName.TENSOR)
    if cfg.n_heads % n or cfg.n_kv_heads % n:
        raise ValueError(
            f"tensor {n} does not split {cfg.n_heads} heads and "
            f"{cfg.n_kv_heads} kv heads into whole heads a rank")


def _mesh(gather):
    """The step's mesh and rule table (None, None outside a sharded
    step)."""
    if gather is None:
        return None, None
    return gather.mesh_ctx, gather.rules


def _vocab_shard(gather, name: str, dim: int):
    """``(tensor group, first vocab id held)`` when the tensor axis cuts
    leaf ``name`` along ``dim``, else ``(None, 0)``."""
    mesh, _ = _mesh(gather)
    if mesh is None:
        return None, 0
    p = gather.placements[name]
    shard = p.shard(AxisName.TENSOR)
    if shard is None or shard.dim != dim:
        return None, 0
    return mesh.group(AxisName.TENSOR), p.starts[dim]


def _embed(gather, params: Params, tokens, dt):
    """The token embeddings; under a vocab-cut table each rank looks up
    the ids it holds and the rows are summed over the tensor group."""
    table = _full(gather, params, "embed").to(dt)
    group, v0 = _vocab_shard(gather, "embed", 0)
    if group is None:
        return table[tokens.long()]
    ids = tokens.long() - v0
    held = (ids >= 0) & (ids < table.shape[0])
    rows = table[ids.clamp(0, table.shape[0] - 1)]
    return reduce_from(torch.where(held[..., None], rows,
                                   torch.zeros_like(rows)), group)


def forward_hidden(
    params: Params,
    tokens: torch.Tensor,
    cfg: LlamaConfig,
    attention_fn: Optional[AttentionFn] = None,
) -> torch.Tensor:
    """tokens ``[B, S]`` -> final-norm hidden states ``[B, S, D]`` in
    ``cfg.dtype`` (the pre-lm-head activations, so the loss can fuse the
    vocab projection).  ``cfg.remat == "full"`` recomputes each layer's
    forward in the backward (non-reentrant ``checkpoint``), as
    ``jax.checkpoint`` does; ``"dots"`` recomputes it around the saved
    projection outputs (a selective checkpoint, ``_dots_policy``), as
    ``jax.checkpoint`` with ``checkpoint_dots_with_no_batch_dims`` does.
    Under seq parallelism ``tokens`` is the rank's chunk of the sequence
    (``loss_fn`` cuts it)."""
    from dlrover_tpu_torch.accelerate.module_replace import (
        select_attention,
        select_layer_executor,
    )

    if cfg.remat not in ("none", "full", "dots"):
        raise ValueError(f"unknown remat policy {cfg.remat!r}")
    # under fsdp (the sharded train step) each leaf is this rank's slice
    # and the full weights are gathered where they are used: a layer's
    # inside ``block``, so that the checkpoint's recompute gathers them
    # again and no more than one layer's full weights live at a time
    gather = sh.active_gather()
    mesh, rules = _mesh(gather)
    if attention_fn is None:
        attention_fn = select_attention(mesh, rules, flash_attention)
    # before the step's first collective: every rank stops here
    check_mesh(cfg, mesh)
    tp = mesh.group(AxisName.TENSOR) if mesh is not None else None
    dt = cfg.dtype
    s = tokens.shape[1]
    x = _embed(gather, params, tokens, dt)
    start = 0 if mesh is None else mesh.axis_index(AxisName.SEQUENCE) * s
    cos, sin = rope_frequencies(
        cfg, torch.arange(start, start + s, device=tokens.device)
    )
    # a tuple or list of stacked layer trees runs as sequential
    # segments, in order (the grouped offload step's split, whose
    # backward per group then makes only that group's grads); one
    # unbind per stacked leaf: its backward stacks the per-layer grads
    # once, where a slice per layer would add a full-size zero tensor
    # per layer
    stacks = params["layers"]
    if isinstance(stacks, dict):
        stacks = (stacks,)
    segments = [{k: v.unbind(0) for k, v in seg.items()} for seg in stacks]

    def block(lp, x, cos, sin):
        if gather is not None:
            lp = gather.layer(lp)
        return _layer_forward(cfg, attention_fn, lp, x, cos, sin, tp)

    def layer(lp, x, cos, sin):
        if cfg.remat == "full":
            return checkpoint(block, lp, x, cos, sin, use_reentrant=False)
        if cfg.remat == "dots":
            return checkpoint(block, lp, x, cos, sin, use_reentrant=False,
                              context_fn=_dots_contexts)
        return block(lp, x, cos, sin)

    execute = select_layer_executor(mesh)
    for layers in segments:
        x = execute(layer, layers, x, cos, sin)
    return rms_norm(x, _full(gather, params, "final_norm"), cfg.norm_eps)


def forward(
    params: Params,
    tokens: torch.Tensor,
    cfg: LlamaConfig,
    attention_fn: Optional[AttentionFn] = None,
) -> torch.Tensor:
    """tokens ``[B, S]`` -> logits ``[B, S, vocab]`` (fp32); under a
    vocab-cut head, the rank's columns of the vocab."""
    x = forward_hidden(params, tokens, cfg, attention_fn)
    b, s, d = x.shape
    gather = sh.active_gather()
    head = _full(gather, params, "lm_head")
    group, _ = _vocab_shard(gather, "lm_head", 1)
    x = copy_to(x, group)
    logits = _mm_f32(x.reshape(b * s, d), head.to(cfg.dtype))
    return logits.reshape(b, s, -1)


def _seq_chunk(gather, *ts):
    """Each of ``ts`` (``[B, S, ...]`` or None) cut to the seq rank's
    chunk of the sequence."""
    mesh, _ = _mesh(gather)
    n = 1 if mesh is None else mesh.axis_size(AxisName.SEQUENCE)
    if n == 1:
        return ts
    i = mesh.axis_index(AxisName.SEQUENCE)
    out = []
    for t in ts:
        if t is not None:
            if t.shape[1] % n:
                raise ValueError(f"a sequence of {t.shape[1]} tokens does "
                                 f"not split over seq {n}")
            size = t.shape[1] // n
            t = t[:, i * size:(i + 1) * size]
        out.append(t)
    return out


def loss_fn(
    params: Params,
    batch: Dict,
    cfg: LlamaConfig,
    attention_fn: Optional[AttentionFn] = None,
    fused_ce: Optional[bool] = None,
) -> torch.Tensor:
    """Next-token cross entropy (fp32 scalar); ``batch`` is
    ``{"tokens": [B, S+1]}`` or ``{"inputs", "targets"}``, with an
    optional ``"mask"``.  ``fused_ce`` (default: on when vocab >= 8192)
    routes the lm-head through ``ops.fused.fused_linear_cross_entropy``
    so fp32 logits never exist at ``[B, S, V]``.  Under seq parallelism
    the loss is the mean over the rank's chunk of the tokens (the train
    step averages the ranks')."""
    if "inputs" in batch:
        inputs, targets = batch["inputs"], batch["targets"]
    else:
        inputs, targets = batch["tokens"][:, :-1], batch["tokens"][:, 1:]
    gather = sh.active_gather()
    # under seq parallelism each rank's loss covers its chunk of tokens
    inputs, targets, mask = _seq_chunk(gather, inputs, targets,
                                       batch.get("mask"))
    group, v0 = _vocab_shard(gather, "lm_head", 1)
    if fused_ce is None:
        fused_ce = cfg.vocab_size >= _FUSED_CE_MIN_VOCAB
    if fused_ce:
        hidden = copy_to(forward_hidden(params, inputs, cfg, attention_fn),
                         group)
        return fused_linear_cross_entropy(
            hidden, _full(gather, params, "lm_head"), targets,
            mask,
            chunk_rows=cfg.ce_chunk_rows,
            group=group, vocab_start=v0,
        )
    logits = forward(params, inputs, cfg, attention_fn)
    if group is not None:
        nll = vocab_parallel_nll(logits, targets, group, v0)
    else:
        logp = torch.log_softmax(logits, dim=-1)
        nll = -logp.gather(-1, targets.long()[..., None])[..., 0]
    if mask is not None:
        mask = mask.to(nll.dtype)
        return torch.sum(nll * mask) / torch.clamp(mask.sum(), min=1.0)
    return nll.mean()


# ------------------------------------------------ grouped (offload) split


def loss_fn_ngrouped(
    parts,
    batch: Dict,
    cfg: LlamaConfig,
    attention_fn: Optional[AttentionFn] = None,
    fused_ce: Optional[bool] = None,
) -> torch.Tensor:
    """``loss_fn`` over an N-group param split: group 0 carries the
    embedding and the first layer segment, middle groups a contiguous
    layer segment each, the last group the tail segment, the final norm
    and the lm head.  A backward taken for one group's leaves only makes
    that group's grads, so the grouped offload step
    (``optimizers.host_offload.build_grouped_offload_step``) runs one
    backward per group and the largest grads tree resident at once is
    one group's."""
    parts = tuple(parts)
    if len(parts) == 1:
        return loss_fn(parts[0], batch, cfg, attention_fn, fused_ce)
    params = {
        "embed": parts[0]["embed"],
        "layers": tuple(p["layers"] for p in parts),
        "final_norm": parts[-1]["final_norm"],
        "lm_head": parts[-1]["lm_head"],
    }
    return loss_fn(params, batch, cfg, attention_fn, fused_ce)


def loss_fn_grouped(
    params_a: Dict,
    params_b: Dict,
    batch: Dict,
    cfg: LlamaConfig,
    attention_fn: Optional[AttentionFn] = None,
    fused_ce: Optional[bool] = None,
) -> torch.Tensor:
    """Two-group form of :func:`loss_fn_ngrouped` (the two-group calling
    convention of ``build_grouped_offload_step``)."""
    return loss_fn_ngrouped(
        (params_a, params_b), batch, cfg, attention_fn, fused_ce)


def init_ngrouped_params(cfg: LlamaConfig, boundaries,
                         generator: Optional[torch.Generator] = None,
                         device: DeviceLike = None,
                         dtype: Optional[torch.dtype] = torch.float32):
    """An N-group layer split built group by group, never the whole
    stacked tree at once: ``boundaries`` are the strictly increasing
    layer split points (``len(boundaries) + 1`` groups;
    ``offload_group_plan`` picks them from the per-layer footprint).
    Returns a list of thunks, so the caller can free each group's fp32
    source before the next one is made.  Each group draws from its own
    generator seeded from ``generator`` (seed 0 when omitted), as the
    JAX version splits its key per group."""
    import dataclasses

    bounds = [0] + list(boundaries) + [cfg.n_layers]
    for lo, hi in zip(bounds, bounds[1:]):
        if hi <= lo:
            raise ValueError(
                f"boundaries {tuple(boundaries)} must be strictly "
                f"increasing within (0, {cfg.n_layers})")
    n_groups = len(bounds) - 1
    dev = resolve_device(device)
    if generator is None:
        generator = torch.Generator(device=dev).manual_seed(0)
    seeds = torch.randint(0, 2 ** 62, (n_groups,), generator=generator,
                          device=dev).tolist()

    def make(i: int):
        seg_cfg = dataclasses.replace(
            cfg, n_layers=bounds[i + 1] - bounds[i])

        def init() -> Dict:
            gen = torch.Generator(device=dev).manual_seed(seeds[i])
            t = init_params(seg_cfg, gen, dev, dtype)
            part = {"layers": t["layers"]}
            if i == 0:
                part["embed"] = t["embed"]
            if i == n_groups - 1:
                part["final_norm"] = t["final_norm"]
                part["lm_head"] = t["lm_head"]
            return part

        return init

    return [make(i) for i in range(n_groups)]


def init_grouped_params(cfg: LlamaConfig, boundary: int,
                        generator: Optional[torch.Generator] = None,
                        device: DeviceLike = None,
                        dtype: Optional[torch.dtype] = torch.float32):
    """Two-group form of :func:`init_ngrouped_params`: ``(init_a,
    init_b)`` thunks splitting the stack at ``boundary``."""
    init_a, init_b = init_ngrouped_params(cfg, (boundary,), generator,
                                          device, dtype)
    return init_a, init_b


def layer_param_counts(cfg: LlamaConfig) -> Tuple[int, int, int]:
    """(params of one stacked layer, of the embedding, of the lm head),
    from the config (``init_params``' shapes)."""
    d, hd = cfg.dim, cfg.head_dim
    per_layer = (
        2 * d  # attn_norm, mlp_norm
        + d * cfg.n_heads * hd  # wq
        + 2 * d * cfg.n_kv_heads * hd  # wk, wv
        + cfg.n_heads * hd * d  # wo
        + 3 * d * cfg.mlp_dim  # w_gate, w_up, w_down
    )
    return per_layer, cfg.vocab_size * d, d * cfg.vocab_size


def offload_group_plan(cfg: LlamaConfig, batch: int, seq: int,
                       hbm_bytes: Optional[int] = None, **kwargs):
    """The grouped offload step's split for ``cfg`` at ``batch`` x
    ``seq``: ``accelerate.solver.solve_offload_groups`` over the
    per-layer footprint, the embedding charged to group 0 and the head
    to the last (``bench_mfu.py``'s wiring of the solver).  Returns its
    ``OffloadGroupPlan``; ``plan.boundaries`` feed
    :func:`init_ngrouped_params`."""
    from dlrover_tpu_torch.accelerate.analyser import ModelProfile
    from dlrover_tpu_torch.accelerate.solver import solve_offload_groups

    per_layer, embed, head = layer_param_counts(cfg)
    n_params = per_layer * cfg.n_layers + embed + head
    profile = ModelProfile(
        num_params=n_params,
        param_bytes=4 * n_params,
        largest_leaf=0,
        leaf_count=12,
        # the remat-none activation footprint per sample; the solver
        # applies the remat policy's retained share itself
        activation_bytes_per_sample=cfg.n_layers * seq * cfg.dim * 2 * 16,
        num_layers=cfg.n_layers,
    )
    return solve_offload_groups(
        profile,
        batch_per_replica=batch,
        remat=cfg.remat,
        hbm_bytes=hbm_bytes,
        layer_params=[per_layer] * cfg.n_layers,
        embed_params=embed,
        head_params=head,
        **kwargs,
    )
