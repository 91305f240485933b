"""Llama family in PyTorch: the training forward and loss, and the
paged serving steps.

Port of ``dlrover_tpu/models/llama.py`` (``LlamaConfig`` :33-85,
``init_params`` :91-124, ``rms_norm``/RoPE :248-275, the training
forward and loss :278-447 and :957-996, and the paged steps :597-949):
RMSNorm + RoPE (split-half) + GQA + SwiGLU.

Training keeps fp32 master weights (``init_params(..., dtype=
torch.float32)``) and computes in ``cfg.dtype``: every projection casts
its weight, multiplies with fp32 accumulation and gives ``cfg.dtype``,
as JAX's ``preferred_element_type`` matmuls do.  Attention defaults to
``ops.flash_attention`` (the CUDA kernels on the card, the plain version
on the CPU).

Params are a plain dict with the JAX package's layout: ``embed [V, D]``,
``layers`` a dict of tensors stacked on dim 0 (``wq [L, D, H*hd]``,
projections ``[in, out]``), ``final_norm [D]``, ``lm_head [D, V]``.  The
JAX ``lax.scan`` over stacked layers is a Python loop here.

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
"""

from dataclasses import dataclass
from typing import Callable, Dict, Optional, Tuple

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from dlrover_tpu_torch.common.device import DeviceLike, resolve_device
from dlrover_tpu_torch.ops.flash_attention import flash_attention
from dlrover_tpu_torch.ops.fused import (
    _mm_f32,
    add_rms_norm,
    fused_linear_cross_entropy,
    rms_norm,
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
    # training: activation recompute per layer ("none" | "full"; "dots"
    # is the JAX package's dots-saveable policy, not ported yet)
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
                   cos, sin):
    b, s, _ = x.shape
    nh, nkv, hd = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    dt = cfg.dtype
    h = rms_norm(x, lp["attn_norm"], cfg.norm_eps)
    q = apply_rope(_proj(h, lp["wq"], dt).reshape(b, s, nh, hd), cos, sin)
    k = apply_rope(_proj(h, lp["wk"], dt).reshape(b, s, nkv, hd), cos, sin)
    v = _proj(h, lp["wv"], dt).reshape(b, s, nkv, hd)
    attn = attention_fn(q, k, v, causal=True)
    # the add before the MLP norm goes into its kernel; the one at the
    # layer's end crosses the per-layer checkpoint and stays an add
    x, h = add_rms_norm(x, _proj(attn.reshape(b, s, nh * hd), lp["wo"], dt),
                        lp["mlp_norm"], cfg.norm_eps)
    gate = F.silu(_proj(h, lp["w_gate"], dt))
    up = _proj(h, lp["w_up"], dt)
    return x + _proj(gate * up, lp["w_down"], dt)


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
    ``jax.checkpoint`` does."""
    if cfg.remat not in ("none", "full"):
        if cfg.remat == "dots":
            raise NotImplementedError(
                'remat="dots" (save the matmul outputs, recompute the '
                "rest) is not ported yet: ROADMAP A2, left out"
            )
        raise ValueError(f"unknown remat policy {cfg.remat!r}")
    if attention_fn is None:
        attention_fn = flash_attention
    dt = cfg.dtype
    s = tokens.shape[1]
    x = params["embed"].to(dt)[tokens.long()]
    cos, sin = rope_frequencies(
        cfg, torch.arange(s, device=tokens.device)
    )
    # one unbind per stacked leaf: its backward stacks the per-layer
    # grads once, where a slice per layer would add a full-size zero
    # tensor per layer
    layers = {k: v.unbind(0) for k, v in params["layers"].items()}

    def block(lp, x):
        return _layer_forward(cfg, attention_fn, lp, x, cos, sin)

    for i in range(cfg.n_layers):
        lp = {k: v[i] for k, v in layers.items()}
        if cfg.remat == "full":
            x = checkpoint(block, lp, x, use_reentrant=False)
        else:
            x = block(lp, x)
    return rms_norm(x, params["final_norm"], cfg.norm_eps)


def forward(
    params: Params,
    tokens: torch.Tensor,
    cfg: LlamaConfig,
    attention_fn: Optional[AttentionFn] = None,
) -> torch.Tensor:
    """tokens ``[B, S]`` -> logits ``[B, S, vocab]`` (fp32)."""
    x = forward_hidden(params, tokens, cfg, attention_fn)
    b, s, d = x.shape
    logits = _mm_f32(x.reshape(b * s, d), params["lm_head"].to(cfg.dtype))
    return logits.reshape(b, s, -1)


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
    so fp32 logits never exist at ``[B, S, V]``."""
    if "inputs" in batch:
        inputs, targets = batch["inputs"], batch["targets"]
    else:
        inputs, targets = batch["tokens"][:, :-1], batch["tokens"][:, 1:]
    mask = batch.get("mask")
    if fused_ce is None:
        fused_ce = cfg.vocab_size >= _FUSED_CE_MIN_VOCAB
    if fused_ce:
        hidden = forward_hidden(params, inputs, cfg, attention_fn)
        return fused_linear_cross_entropy(
            hidden, params["lm_head"], targets, mask,
            chunk_rows=cfg.ce_chunk_rows,
        )
    logits = forward(params, inputs, cfg, attention_fn)
    logp = torch.log_softmax(logits, dim=-1)
    nll = -logp.gather(-1, targets.long()[..., None])[..., 0]
    if mask is not None:
        mask = mask.to(nll.dtype)
        return torch.sum(nll * mask) / torch.clamp(mask.sum(), min=1.0)
    return nll.mean()
