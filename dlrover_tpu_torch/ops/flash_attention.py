"""Flash attention forward and backward: the CUDA kernels
``ops/csrc/flash_attention.cu`` (forward) and
``ops/csrc/flash_attention_bwd.cu`` (dK/dV and dQ) and their plain
PyTorch versions, bound to one ``torch.autograd.Function``.

Port of ``dlrover_tpu/ops/flash_attention.py:42-634`` (B2
``_flash_fwd_kernel``, B3 ``_flash_bwd_dkv_kernel``, B4
``_flash_bwd_dq_kernel``, the ``custom_vjp`` pair and the public
``flash_attention`` / ``flash_attention_lse``).  The public layout is
the reference's: ``q [B, S, H, D]``, ``k, v [B, S, KV, D]`` with
``H % KV == 0``; the kernels read it in place.  ``lse`` is the natural
log of the softmax denominator of the *scaled* scores
(``s = q k^T * scale``, ``lse = m + log l``); the backward recomputes
``p = exp(s - lse)``.  The TPU tile knobs ``block_q``/``block_k`` are
not part of the signature: tiles are the CUDA kernels' own constants.

The plain versions are dense attention with an fp32 softmax and
``-1e30`` masking, with the kernels' roundings: in bf16, ``p`` is cast
to ``v``'s dtype before ``p v`` and ``p``/``ds`` to the input dtype
before ``p^T dO``, ``ds^T q`` and ``ds k``, as in the reference.
"""

import ctypes
from typing import Optional, Tuple

import torch

from dlrover_tpu_torch.ops import _build

NEG_INF = -1e30
#: The head dims the kernels take: bf16 runs on wgmma at 64 and 128 and
#: on the FMA kernels at 16 and 32; fp32 on the FMA kernels at all four.
HEAD_DIMS = (16, 32, 64, 128)


def _scores(q, k, causal, scale):
    """fp32 ``q k^T * scale`` as ``[B, KV, G, S, S]`` (query head
    ``kv * G + g``) and the keep mask (None when nothing masks)."""
    b, s, h, d = q.shape
    kv = k.shape[2]
    qg = q.float().reshape(b, s, kv, h // kv, d)
    sc = torch.einsum("bqkgd,bskd->bkgqs", qg, k.float()) * scale
    keep = None
    if causal:
        keep = torch.ones(s, s, dtype=torch.bool, device=q.device).tril()
    return sc, keep


def flash_fwd_plain(q, k, v, causal: bool, scale: float):
    """``(o [B, S, H, D] in q.dtype, lse [B, H, S] fp32)``."""
    b, s, h, d = q.shape
    sc, keep = _scores(q, k, causal, scale)
    if keep is not None:
        sc = sc.masked_fill(~keep, NEG_INF)
    m = sc.amax(dim=-1, keepdim=True)
    p = torch.exp(sc - m)
    denom = p.sum(dim=-1, keepdim=True).clamp_min(1e-30)
    o = torch.einsum("bkgqs,bskd->bqkgd", p.to(v.dtype).float(), v.float())
    o = o / denom.permute(0, 3, 1, 2, 4)
    lse = (m + torch.log(denom)).reshape(b, h, s)
    return o.to(q.dtype).reshape(b, s, h, d), lse


def _bwd_dense(q, k, v, dout, lse, delta, glse, causal, scale):
    """``p`` and ``ds`` as ``[B, KV, G, S, S]`` fp32 (``_bwd_block_math``
    over the whole matrix), each rounded to the input dtype."""
    b, s, h, d = q.shape
    kv = k.shape[2]
    sc, keep = _scores(q, k, causal, scale)
    rows = (b, kv, h // kv, s, 1)
    p = torch.exp(sc - lse.reshape(rows))
    dog = dout.float().reshape(b, s, kv, h // kv, d)
    dp = torch.einsum("bqkgd,bskd->bkgqs", dog, v.float())
    corr = -delta.reshape(rows)
    if glse is not None:
        corr = corr + glse.reshape(rows)
    ds = p * (dp + corr) * scale
    if keep is not None:
        p = p.masked_fill(~keep, 0.0)
        ds = ds.masked_fill(~keep, 0.0)
    dt = q.dtype
    return p.to(dt).float(), ds.to(dt).float()


def flash_bwd_dkv_plain(q, k, v, dout, lse, delta, glse, causal, scale):
    """``(dk, dv)`` ``[B, S, KV, D]`` in k's dtype, summed in fp32 over
    the query heads of each KV head."""
    b, s, h, d = q.shape
    kv = k.shape[2]
    p, ds = _bwd_dense(q, k, v, dout, lse, delta, glse, causal, scale)
    g = h // kv
    dog = dout.float().reshape(b, s, kv, g, d)
    qg = q.float().reshape(b, s, kv, g, d)
    dv = torch.einsum("bkgqs,bqkgd->bskd", p, dog)
    dk = torch.einsum("bkgqs,bqkgd->bskd", ds, qg)
    return dk.to(k.dtype), dv.to(v.dtype)


def flash_bwd_dq_plain(q, k, v, dout, lse, delta, glse, causal, scale):
    """``dq [B, S, H, D]`` in q's dtype."""
    b, s, h, d = q.shape
    _, ds = _bwd_dense(q, k, v, dout, lse, delta, glse, causal, scale)
    dq = torch.einsum("bkgqs,bskd->bqkgd", ds, k.float())
    return dq.to(q.dtype).reshape(b, s, h, d)


# ------------------------------------------------------------ kernels

#: ``dl_flash_fwd(q, k, v, o, lse, B, S, H, KV, D, scale, causal, dtype,
#: stream)``
FWD_ARGTYPES = [ctypes.c_void_p] * 5 + [ctypes.c_int] * 5 + [
    ctypes.c_float, ctypes.c_int, ctypes.c_int, ctypes.c_void_p,
]
#: ``dl_flash_bwd_dkv(q, k, v, dout, lse, delta, glse, dk, dv, B, S, H,
#: KV, D, scale, causal, dtype, stream)``
DKV_ARGTYPES = [ctypes.c_void_p] * 9 + [ctypes.c_int] * 5 + [
    ctypes.c_float, ctypes.c_int, ctypes.c_int, ctypes.c_void_p,
]
#: ``dl_flash_bwd_dq(q, k, v, dout, lse, delta, glse, dq, B, S, H, KV, D,
#: scale, causal, dtype, stream)``
DQ_ARGTYPES = [ctypes.c_void_p] * 8 + [ctypes.c_int] * 5 + [
    ctypes.c_float, ctypes.c_int, ctypes.c_int, ctypes.c_void_p,
]

#: ``dl_flash_bwd_smem(dkv, D)``
SMEM_ARGTYPES = [ctypes.c_int, ctypes.c_int]
#: ``dl_flash_fwd_smem(D)``
FWD_SMEM_ARGTYPES = [ctypes.c_int]


def _check(q, k, v, what, *rest):
    """Raise on what the kernels do not take; ``rest`` are
    ``(name, tensor, shape, dtype)`` of the backward's extra inputs."""
    if q.dtype not in _build.DTYPE_CODES:
        raise TypeError(f"{what} kernel takes fp32/bf16, got {q.dtype}")
    if k.dtype != q.dtype or v.dtype != q.dtype:
        raise TypeError(f"{what} kernel needs q, k, v in one dtype")
    if q.dim() != 4 or k.dim() != 4 or k.shape != v.shape:
        raise ValueError(f"{what} kernel needs [B, S, H, D] q, k, v")
    b, s, h, d = q.shape
    kv = k.shape[2]
    if k.shape[:2] != (b, s) or k.shape[3] != d or h % kv:
        raise ValueError(
            f"{what}: q {tuple(q.shape)} does not fit k {tuple(k.shape)}"
        )
    if d not in HEAD_DIMS:
        raise ValueError(
            f"{what} kernel takes head_dim 16, 32, 64 or 128, got {d}")
    if b > 65535 or h > 65535:
        raise ValueError(f"{what} kernel takes at most 65535 rows of heads")
    tensors = [("q", q), ("k", k), ("v", v)]
    for name, t, shape, dtype in rest:
        if t is None:
            continue
        if tuple(t.shape) != tuple(shape) or t.dtype != dtype:
            raise ValueError(
                f"{what}: {name} is {tuple(t.shape)} {t.dtype}, "
                f"needs {tuple(shape)} {dtype}"
            )
        tensors.append((name, t))
    for name, t in tensors:
        if not t.is_contiguous():
            raise ValueError(f"{what} kernel needs contiguous {name}")
        if t.data_ptr() % 16:
            raise ValueError(f"{what} kernel needs 16-byte aligned {name}")


def _call(source, name, fn_name, argtypes, *args):
    lib = _build.library(source)
    fn = getattr(lib, fn_name)
    fn.restype = ctypes.c_int
    fn.argtypes = argtypes
    _build.check(fn(*args), lib, name)
    _build.launches[name] += 1


def _dims(q, k, scale, causal):
    b, s, h, d = q.shape
    return (b, s, h, k.shape[2], d, float(scale), int(causal),
            _build.DTYPE_CODES[q.dtype], _build.stream_of(q))


def flash_fwd_kernel(q, k, v, causal: bool, scale: float):
    """B2 on the card: ``(o, lse [B, H, S] fp32)``."""
    _check(q, k, v, "flash_fwd")
    o = torch.empty_like(q)
    b, s, h, _ = q.shape
    lse = torch.empty(b, h, s, dtype=torch.float32, device=q.device)
    _call("flash_attention", "flash_fwd", "dl_flash_fwd", FWD_ARGTYPES,
          _build.ptr(q), _build.ptr(k), _build.ptr(v), _build.ptr(o),
          _build.ptr(lse), *_dims(q, k, scale, causal))
    return o, lse


def _bwd_rest(q, dout, lse, delta, glse):
    b, s, h, _ = q.shape
    return (("dout", dout, q.shape, q.dtype),
            ("lse", lse, (b, h, s), torch.float32),
            ("delta", delta, (b, h, s), torch.float32),
            ("glse", glse, (b, h, s), torch.float32))


def _opt_ptr(t):
    return ctypes.c_void_p(None) if t is None else _build.ptr(t)


def flash_bwd_dkv_kernel(q, k, v, dout, lse, delta, glse, causal, scale):
    """B3 on the card: ``(dk, dv)`` in k's dtype."""
    _check(q, k, v, "flash_bwd_dkv", *_bwd_rest(q, dout, lse, delta, glse))
    dk = torch.empty_like(k)
    dv = torch.empty_like(v)
    _call("flash_attention_bwd", "flash_bwd_dkv", "dl_flash_bwd_dkv",
          DKV_ARGTYPES, _build.ptr(q), _build.ptr(k), _build.ptr(v), _build.ptr(dout),
          _build.ptr(lse), _build.ptr(delta), _opt_ptr(glse),
          _build.ptr(dk), _build.ptr(dv), *_dims(q, k, scale, causal))
    return dk, dv


def flash_bwd_dq_kernel(q, k, v, dout, lse, delta, glse, causal, scale):
    """B4 on the card: ``dq`` in q's dtype."""
    _check(q, k, v, "flash_bwd_dq", *_bwd_rest(q, dout, lse, delta, glse))
    dq = torch.empty_like(q)
    _call("flash_attention_bwd", "flash_bwd_dq", "dl_flash_bwd_dq",
          DQ_ARGTYPES, _build.ptr(q), _build.ptr(k), _build.ptr(v), _build.ptr(dout),
          _build.ptr(lse), _build.ptr(delta), _opt_ptr(glse),
          _build.ptr(dq), *_dims(q, k, scale, causal))
    return dq


def smem_bytes(kind: str, d: int) -> int:
    """Dynamic shared memory of one bf16 block of a kernel (``kind``
    "fwd", "dkv" or "dq") at head dim ``d`` (the wgmma kernels at 64 and
    128, the FMA kernels at 16 and 32), as the launch asks for it
    (builds the library)."""
    if kind == "fwd":
        fn = _build.library("flash_attention").dl_flash_fwd_smem
        fn.restype = ctypes.c_int
        fn.argtypes = FWD_SMEM_ARGTYPES
        return fn(d)
    fn = _build.library("flash_attention_bwd").dl_flash_bwd_smem
    fn.restype = ctypes.c_int
    fn.argtypes = SMEM_ARGTYPES
    return fn(int(kind == "dkv"), d)


def flash_fwd(q, k, v, causal, scale):
    """The kernel for CUDA tensors, the plain version for CPU tensors."""
    if _build.on_cpu(q, k, v):
        return flash_fwd_plain(q, k, v, causal, scale)
    return flash_fwd_kernel(q, k, v, causal, scale)


def flash_bwd_dkv(q, k, v, dout, lse, delta, glse, causal, scale):
    if _build.on_cpu(q, k, v, dout):
        return flash_bwd_dkv_plain(q, k, v, dout, lse, delta, glse, causal,
                                   scale)
    return flash_bwd_dkv_kernel(q, k, v, dout, lse, delta, glse, causal,
                                scale)


def flash_bwd_dq(q, k, v, dout, lse, delta, glse, causal, scale):
    if _build.on_cpu(q, k, v, dout):
        return flash_bwd_dq_plain(q, k, v, dout, lse, delta, glse, causal,
                                  scale)
    return flash_bwd_dq_kernel(q, k, v, dout, lse, delta, glse, causal,
                               scale)


def attention_delta(o, dout):
    """``Δ = rowsum(dO ∘ O)`` in fp32 as ``[B, H, S]`` (jnp in the
    reference, ``flash_attention.py:412``)."""
    return (dout.float() * o.float()).sum(-1).transpose(1, 2).contiguous()


class _FlashAttention(torch.autograd.Function):
    @staticmethod
    def forward(ctx, q, k, v, causal, scale):
        ctx.set_materialize_grads(False)
        o, lse = flash_fwd(q, k, v, causal, scale)
        ctx.save_for_backward(q, k, v, o, lse)
        ctx.causal, ctx.scale = causal, scale
        return o, lse.transpose(1, 2)

    @staticmethod
    def backward(ctx, dout, dlse):
        q, k, v, o, lse = ctx.saved_tensors
        if dout is None:
            dout = torch.zeros_like(o)
        dout = dout.contiguous()
        delta = attention_delta(o, dout)
        # the lse cotangent folds into ds: p (dp - delta + glse) scale
        glse = None
        if dlse is not None:
            glse = dlse.float().transpose(1, 2).contiguous()
        args = (q, k, v, dout, lse, delta, glse, ctx.causal, ctx.scale)
        dk, dv = flash_bwd_dkv(*args)
        dq = flash_bwd_dq(*args)
        return dq, dk, dv, None, None


def _apply(q, k, v, causal, sm_scale):
    nh, nkv = q.shape[2], k.shape[2]
    if nh % nkv != 0:
        raise ValueError(f"heads {nh} not a multiple of kv {nkv}")
    if sm_scale is None:
        sm_scale = q.shape[-1] ** -0.5
    return _FlashAttention.apply(
        q.contiguous(), k.contiguous(), v.contiguous(), bool(causal),
        float(sm_scale),
    )


def flash_attention_lse(
    q: torch.Tensor,  # [B, S, H, D]
    k: torch.Tensor,  # [B, S, KV, D]
    v: torch.Tensor,
    causal: bool = True,
    sm_scale: Optional[float] = None,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """``(o [B, S, H, D], lse [B, S, H] fp32)``, differentiable in both
    outputs (the lse cotangent enters the backward kernels)."""
    return _apply(q, k, v, causal, sm_scale)


def flash_attention(
    q: torch.Tensor,  # [B, S, H, D]
    k: torch.Tensor,  # [B, S, KV, D]
    v: torch.Tensor,
    causal: bool = True,
    sm_scale: Optional[float] = None,
) -> torch.Tensor:
    """Drop-in for ``models.llama.dot_product_attention`` (same layout,
    GQA by ``H // KV``): the kernels on the card, the plain versions on
    the CPU."""
    return _apply(q, k, v, causal, sm_scale)[0]
