"""RMSNorm (the CUDA kernels ``ops/csrc/rms_norm.cu`` and their plain
PyTorch versions: the forward, the forward with the residual add before
it, and the backward) and the fused linear cross entropy.

Port of ``dlrover_tpu/ops/fused.py``:

- ``rms_norm`` (``:48-138``: ``_rms_fwd_kernel``, ``_rms_plain``, the
  ``custom_vjp`` with ``_rms_bwd``).  Both forward versions take the
  statistics in fp32, multiply by the weight in fp32 (whatever its
  dtype: training keeps fp32 master weights beside bf16 activations)
  and cast once to ``x.dtype``; both return ``rstd`` (``[..., 1]`` fp32)
  beside ``y``.  The backward reuses the saved ``rstd``; on the card it
  is a kernel (``dl_rms_norm_bwd``, the port's counterpart of the XLA
  fusion of ``_rms_bwd``), on the CPU the torch ops of ``_rms_bwd``.
- ``add_rms_norm``: ``h = x + delta`` in ``x.dtype`` and the norm of
  ``h``, one kernel on the card.  The reference writes the residual add
  and the norm as two ops (``dlrover_tpu/models/llama.py:332-334``); the
  values are the same, bit for bit on the CPU.
- ``fused_linear_cross_entropy`` (``:156-227``): mean next-token cross
  entropy of ``hidden @ w_vocab`` computed chunk by chunk, never holding
  more than one fp32 ``[chunk_rows, V]`` logits block, in the forward or
  the backward (which recomputes each chunk's logits and accumulates
  ``dW`` in fp32).  The reference is an XLA scan, not Pallas: the chunks'
  products go to ``torch.mm``.
"""

import ctypes
from typing import Optional, Tuple

import torch

from dlrover_tpu_torch.ops import _build


def rms_norm_plain(
    x: torch.Tensor, weight: torch.Tensor, eps: float = 1e-5
) -> Tuple[torch.Tensor, torch.Tensor]:
    """``(x * rsqrt(mean(x^2) + eps) * weight, rstd)`` over the last
    dim, statistics and weight multiply in fp32, one final cast."""
    xf = x.float()
    var = torch.mean(xf * xf, dim=-1, keepdim=True)
    rstd = 1.0 / torch.sqrt(var + eps)
    return (xf * rstd * weight.float()).to(x.dtype), rstd


def add_rms_norm_plain(
    x: torch.Tensor, delta: torch.Tensor, weight: torch.Tensor,
    eps: float = 1e-5,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """``(h, y, rstd)``: ``h = x + delta`` in ``x.dtype``, then
    ``rms_norm_plain(h)``, the unfused sequence of the reference."""
    h = x + delta
    y, rstd = rms_norm_plain(h, weight, eps)
    return h, y, rstd


#: ``dl_rms_norm_fwd(x, w, y, rstd, n, d, eps, dtype, w_dtype, stream)``
ARGTYPES = [ctypes.c_void_p] * 4 + [
    ctypes.c_int, ctypes.c_int, ctypes.c_float, ctypes.c_int, ctypes.c_int,
    ctypes.c_void_p,
]
#: ``dl_add_rms_norm_fwd(x, delta, w, h, y, rstd, n, d, eps, dtype,
#: w_dtype, stream)``
ADD_ARGTYPES = [ctypes.c_void_p] * 6 + [
    ctypes.c_int, ctypes.c_int, ctypes.c_float, ctypes.c_int, ctypes.c_int,
    ctypes.c_void_p,
]
#: ``dl_rms_norm_bwd(x, w, rstd, g, g_res, dx, part, dw, n, d, parts,
#: dtype, w_dtype, stream)``
BWD_ARGTYPES = [ctypes.c_void_p] * 8 + [ctypes.c_int] * 5 + [
    ctypes.c_void_p]

#: CTAs of the backward kernel per SM (its ``kBwdMinCtas`` fit at once).
#: Each keeps fp32 sums of ``g * xhat`` for its own rows (a ``[parts, D]``
#: fp32 workspace that a second kernel sums in a fixed order), so more
#: CTAs cost workspace bytes and fewer leave the SMs short of loads in
#: flight (``scripts/torch_rms_norm_variants.py`` times the choice).
BWD_CTAS_PER_SM = 2


def bwd_parts(n: int, device: torch.device) -> int:
    """CTAs of the backward kernel for ``n`` rows on ``device``: CTA
    ``c`` takes rows ``c, c + parts, c + 2 parts, ...``."""
    sms = torch.cuda.get_device_properties(device).multi_processor_count
    return max(1, min(n, BWD_CTAS_PER_SM * sms))


def _check_norm(x, weight, *like_x):
    if x.dtype not in _build.DTYPE_CODES:
        raise TypeError(f"rms_norm kernel takes fp32/bf16, got {x.dtype}")
    if weight.dtype not in _build.DTYPE_CODES:
        raise TypeError(
            f"rms_norm kernel takes an fp32/bf16 weight, got {weight.dtype}"
        )
    d = x.shape[-1]
    if weight.shape != (d,):
        raise ValueError(f"weight shape {tuple(weight.shape)} != ({d},)")
    for t in like_x:
        if t.shape != x.shape or t.dtype != x.dtype:
            raise ValueError(
                f"{tuple(t.shape)} {t.dtype} beside x {tuple(x.shape)} "
                f"{x.dtype}: the kernel takes them alike"
            )
    if not all(t.is_contiguous() for t in (x, weight, *like_x)):
        raise ValueError("rms_norm kernel needs contiguous inputs")


def _launch_fwd(x, delta, weight, eps):
    _check_norm(x, weight, *([] if delta is None else [delta]))
    d = x.shape[-1]
    y = torch.empty_like(x)
    h = None if delta is None else torch.empty_like(x)
    rstd = torch.empty(x.shape[:-1] + (1,), dtype=torch.float32,
                       device=x.device)
    n = x.numel() // d if d else 0
    if n == 0:
        return h, y, rstd
    lib = _build.library("rms_norm")
    codes = (_build.DTYPE_CODES[x.dtype], _build.DTYPE_CODES[weight.dtype],
             _build.stream_of(x))
    if delta is None:
        fn = lib.dl_rms_norm_fwd
        fn.argtypes = ARGTYPES
        ptrs = (x, weight, y, rstd)
    else:
        fn = lib.dl_add_rms_norm_fwd
        fn.argtypes = ADD_ARGTYPES
        ptrs = (x, delta, weight, h, y, rstd)
    fn.restype = ctypes.c_int
    code = fn(*map(_build.ptr, ptrs), n, d, float(eps), *codes)
    _build.check(code, lib, "rms_norm")
    # both entries count under one key: a norm is one launch either way
    _build.launches["rms_norm"] += 1
    return h, y, rstd


def _rms_norm_cuda(x, weight, eps):
    return _launch_fwd(x, None, weight, eps)[1:]


def rms_norm_fwd(
    x: torch.Tensor, weight: torch.Tensor, eps: float = 1e-5
) -> Tuple[torch.Tensor, torch.Tensor]:
    """``(y, rstd)``: the CUDA kernel for CUDA tensors, the plain
    version for CPU tensors."""
    if _build.on_cpu(x, weight):
        return rms_norm_plain(x, weight, eps)
    return _rms_norm_cuda(x, weight, eps)


def add_rms_norm_fwd(
    x: torch.Tensor, delta: torch.Tensor, weight: torch.Tensor,
    eps: float = 1e-5,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """``(h, y, rstd)`` of ``h = x + delta``: the CUDA kernel for CUDA
    tensors, the plain version for CPU tensors."""
    if delta.shape != x.shape:
        raise ValueError(
            f"delta {tuple(delta.shape)} beside x {tuple(x.shape)}")
    if _build.on_cpu(x, delta, weight):
        return add_rms_norm_plain(x, delta, weight, eps)
    return _launch_fwd(x, delta, weight, eps)


def rms_norm_bwd_plain(x, weight, rstd, g, g_res=None):
    """``_rms_bwd``: fp32 ``dx`` and ``dw`` from the saved ``rstd``,
    ``dw`` summed over every leading row; each cast to its input's
    dtype.  ``g_res``, the gradient that reaches ``x`` past the norm
    (the residual stream, where the add was fused), is added to ``dx``
    as autograd adds two gradients of ``x.dtype``."""
    d = x.shape[-1]
    xhat = x.float() * rstd
    gf = g.float()
    dxhat = gf * weight.float()
    dot = torch.sum(dxhat * xhat, dim=-1, keepdim=True) / d
    dx = (rstd * (dxhat - xhat * dot)).to(x.dtype)
    if g_res is not None:
        dx = dx + g_res
    dw = torch.sum((gf * xhat).reshape(-1, d), dim=0).to(weight.dtype)
    return dx, dw


def _rms_norm_bwd_cuda(x, weight, rstd, g, g_res):
    _check_norm(x, weight, g, *([] if g_res is None else [g_res]))
    d = x.shape[-1]
    n = x.numel() // d if d else 0
    if rstd.dtype != torch.float32 or rstd.numel() != n or (
            not rstd.is_contiguous()):
        raise ValueError("rstd must be contiguous fp32, one per row")
    dx = torch.empty_like(x)
    dw = torch.empty(d, dtype=weight.dtype, device=x.device)
    if n == 0:
        return dx, dw.zero_()
    parts = bwd_parts(n, x.device)
    part = torch.empty((parts, d), dtype=torch.float32, device=x.device)
    lib = _build.library("rms_norm")
    fn = lib.dl_rms_norm_bwd
    fn.restype = ctypes.c_int
    fn.argtypes = BWD_ARGTYPES
    code = fn(
        _build.ptr(x), _build.ptr(weight), _build.ptr(rstd), _build.ptr(g),
        None if g_res is None else _build.ptr(g_res), _build.ptr(dx),
        _build.ptr(part), _build.ptr(dw), n, d, parts,
        _build.DTYPE_CODES[x.dtype], _build.DTYPE_CODES[weight.dtype],
        _build.stream_of(x),
    )
    _build.check(code, lib, "rms_norm_bwd")
    _build.launches["rms_norm_bwd"] += 1
    return dx, dw


def rms_norm_bwd(x, weight, rstd, g, g_res=None):
    """``(dx, dw)`` of ``rms_norm_bwd_plain``: the CUDA kernel for CUDA
    tensors, the plain version for CPU tensors."""
    extra = () if g_res is None else (g_res,)
    if _build.on_cpu(x, weight, rstd, g, *extra):
        return rms_norm_bwd_plain(x, weight, rstd, g, g_res)
    return _rms_norm_bwd_cuda(x, weight, rstd, g, g_res)


class _RMSNorm(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, weight, eps):
        y, rstd = rms_norm_fwd(x, weight, eps)
        ctx.save_for_backward(x, weight, rstd)
        return y

    @staticmethod
    def backward(ctx, g):
        x, weight, rstd = ctx.saved_tensors
        dx, dw = rms_norm_bwd(x, weight, rstd, g.contiguous())
        return dx, dw, None


class _AddRMSNorm(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, delta, weight, eps):
        h, y, rstd = add_rms_norm_fwd(x, delta, weight, eps)
        ctx.save_for_backward(h, weight, rstd)
        ctx.set_materialize_grads(False)
        return h, y

    @staticmethod
    def backward(ctx, g_h, g_y):
        # x and delta both receive the gradient of h: what reaches h
        # directly (g_h) and through the norm
        if g_y is None:
            return g_h, g_h, None, None
        h, weight, rstd = ctx.saved_tensors
        dh, dw = rms_norm_bwd(h, weight, rstd, g_y.contiguous(),
                              None if g_h is None else g_h.contiguous())
        return dh, dh, dw, None


def rms_norm(
    x: torch.Tensor, weight: torch.Tensor, eps: float = 1e-5
) -> torch.Tensor:
    """``x * rsqrt(mean(x^2) + eps) * weight`` over the last dim, in
    ``x.dtype`` (any leading shape).  Differentiable in ``x`` and
    ``weight``; without a gradient to record it is the bare forward."""
    if torch.is_grad_enabled() and (x.requires_grad or weight.requires_grad):
        return _RMSNorm.apply(x.contiguous(), weight, eps)
    return rms_norm_fwd(x, weight, eps)[0]


def add_rms_norm(
    x: torch.Tensor, delta: torch.Tensor, weight: torch.Tensor,
    eps: float = 1e-5,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """``(h, rms_norm(h, weight))`` with ``h = x + delta`` in ``x.dtype``:
    the residual add and the norm after it in one kernel on the card.
    Differentiable in ``x``, ``delta`` and ``weight`` (the backward takes
    the gradients of both outputs); without a gradient to record it is
    the bare forward."""
    if torch.is_grad_enabled() and (
            x.requires_grad or delta.requires_grad or weight.requires_grad):
        return _AddRMSNorm.apply(x.contiguous(), delta.contiguous(), weight,
                                 eps)
    h, y, _ = add_rms_norm_fwd(x, delta, weight, eps)
    return h, y


# ---------------------------------------- fused linear cross entropy


class _MmF32(torch.autograd.Function):
    """``torch.mm(a, b, out_dtype=float32)``, which has no derivative of
    its own, with the backward that autograd gives the CPU's cast-then-mm:
    the grads in fp32, each rounded to its operand's dtype."""

    @staticmethod
    def forward(ctx, a, b):
        ctx.save_for_backward(a, b)
        return torch.mm(a, b, out_dtype=torch.float32)

    @staticmethod
    def backward(ctx, g):
        a, b = ctx.saved_tensors
        da = db = None
        if ctx.needs_input_grad[0]:
            da = torch.mm(g, b.float().t()).to(a.dtype)
        if ctx.needs_input_grad[1]:
            db = torch.mm(a.float().t(), g).to(b.dtype)
        return da, db


def _mm_f32(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """``a @ b`` with fp32 accumulation and an fp32 result (JAX's
    ``preferred_element_type=float32``): cuBLAS writes fp32 straight
    from bf16 operands (differentiable through ``_MmF32``); the CPU,
    which has no such mm, casts first."""
    if a.is_cuda and a.dtype != torch.float32:
        return _MmF32.apply(a, b)
    return torch.mm(a.float(), b.float())


class _FusedLinearCE(torch.autograd.Function):
    @staticmethod
    def forward(ctx, h, w, t, m, chunk):
        # h [N, D] in the compute dtype, w [D, V] (any float dtype),
        # t [N] int64, m [N] fp32 row weights
        w_dt = w.to(h.dtype)
        total = torch.zeros((), dtype=torch.float32, device=h.device)
        for i in range(0, h.shape[0], chunk):
            logits = _mm_f32(h[i:i + chunk], w_dt)
            lse = torch.logsumexp(logits, dim=-1)
            picked = logits.gather(1, t[i:i + chunk, None])[:, 0]
            total = total + torch.sum((lse - picked) * m[i:i + chunk])
            del logits
        count = torch.clamp(m.sum(), min=1.0)
        ctx.save_for_backward(h, w, t, m, count)
        ctx.chunk = chunk
        return total / count

    @staticmethod
    def backward(ctx, g):
        h, w, t, m, count = ctx.saved_tensors
        w_dt = w.to(h.dtype)
        scale = (g.float() / count) * m  # d loss / d nll per row
        dh = torch.empty_like(h) if ctx.needs_input_grad[0] else None
        dw = torch.zeros(w.shape, dtype=torch.float32, device=w.device)
        for i in range(0, h.shape[0], ctx.chunk):
            h_c = h[i:i + ctx.chunk]
            logits = _mm_f32(h_c, w_dt)
            dlogits = torch.softmax(logits, dim=-1)
            del logits
            rows = torch.arange(h_c.shape[0], device=h.device)
            dlogits[rows, t[i:i + ctx.chunk]] -= 1.0
            dlogits *= scale[i:i + ctx.chunk, None]
            d_dt = dlogits.to(h.dtype)
            del dlogits
            if dh is not None:
                dh[i:i + ctx.chunk] = _mm_f32(d_dt, w_dt.t()).to(h.dtype)
            dw += _mm_f32(h_c.t(), d_dt)
        return dh, dw.to(w.dtype), None, None, None


def fused_linear_cross_entropy(
    hidden: torch.Tensor,
    w_vocab: torch.Tensor,
    targets: torch.Tensor,
    mask: Optional[torch.Tensor] = None,
    chunk_rows: int = 512,
) -> torch.Tensor:
    """Mean next-token cross entropy of ``hidden @ w_vocab`` against
    ``targets`` without materializing the full logits tensor.

    ``hidden [..., D]`` (bf16/fp32), ``w_vocab [D, V]`` (cast to
    ``hidden.dtype`` for the products, fp32 logits), ``targets [...]``
    int, ``mask`` optional ``[...]`` row weights.  Rows go in chunks of
    ``chunk_rows``; the last chunk is short where the reference pads it
    with zero-weight rows, which is the same sum.  Returns
    ``sum(nll * mask) / max(sum(mask), 1)`` as an fp32 scalar."""
    d = hidden.shape[-1]
    h = hidden.reshape(-1, d)
    t = targets.reshape(-1).long()
    n = h.shape[0]
    if mask is None:
        m = torch.ones(n, dtype=torch.float32, device=h.device)
    else:
        m = mask.reshape(-1).to(torch.float32)
    chunk = max(1, min(chunk_rows, n))
    return _FusedLinearCE.apply(h, w_vocab, t, m, chunk)
