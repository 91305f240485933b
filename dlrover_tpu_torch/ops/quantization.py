"""Blockwise int8 quantization: quantize, dequantize and the fused int8
Adam update (the CUDA kernels ``ops/csrc/quantization.cu`` and their
plain PyTorch versions).

Port of ``dlrover_tpu/ops/quantization.py``: ``quantize_blockwise``
(``:251``, kernel ``_quant_kernel`` ``:35``), ``dequantize_blockwise``
(``:266``, ``_dequant_kernel`` ``:49``) and ``fused_int8_adam_update``
(``:206``, ``_fused_adam_kernel`` ``:118``), with the same arguments,
returns and padded layout (``_pad_to_blocks`` ``:238``):

- one fp32 scale per ``BLOCK`` = 1024 elements, ``scale = max(absmax /
  127, 1e-12)``, ``q = clip(round_half_even(x / scale), -127, 127)``;
- the payload is ``[P / 128, 128]`` int8 and the scales ``[n_blocks,
  1]`` fp32, where ``P = n_blocks * 1024`` covers the ``n`` elements in
  whole blocks and more than 8 blocks are rounded up to a multiple of 8
  (8 or fewer keep their count); ``n == 0`` gives ``(0, 128)`` and
  ``(0, 1)`` and launches nothing.  The same layout carries the JAX
  state across byte for byte.

The kernels and the plain versions round alike, so they agree bit for
bit on the card: ``x / scale``, ``mu / bc1`` and ``nu / bc2`` are true
IEEE divisions (the plain versions divide by a tensor, never by a
Python float, which PyTorch's CUDA ``div`` turns into a multiply by the
reciprocal), rounding is half to even, and B9's arithmetic keeps the
association of the JAX expression with every product and sum rounded
on its own.  ``absmax / 127`` is ``absmax * fp32(1/127)``: that is what
the reference computes as XLA compiles it (its algebraic simplifier
turns a division by a constant into a multiply by the reciprocal; a
true division differs in the last bit for about 4.5 % of absmax
values), and it keeps quantize bit for bit with the JAX package.

On the card the kernels read elements ``>= n`` as 0 instead of copying
the input into a padded buffer, so the pad region of the moments stays
0 exactly, as on the JAX path.  ``fused_int8_adam_update`` may write the
update into a given ``out`` (the optimizer hands it the grad it
consumes) and the moments in place (``inplace=True``): the port updates
in place where JAX returns new arrays, to keep a 7B model's state on one
card.  On ``meta`` tensors ``quantize_blockwise`` returns empty tensors
of the right shapes and launches nothing (``analyse_model`` sizes the
optimizer state there).
"""

import ctypes
from typing import Optional, Tuple

import numpy as np
import torch

from dlrover_tpu_torch.ops import _build

# one scale per BLOCK elements; the payload is [P / _LANES, _LANES]
BLOCK = 1024
_LANES = 128
_SUBLANES = BLOCK // _LANES
# large tensors round their block count up to a multiple of _GROUP (the
# reference's kernel group, kept so the layouts match)
_GROUP = 8

Meta = Tuple[Tuple[int, ...], int]


def padded_blocks(n: int) -> int:
    """The block count of ``_pad_to_blocks`` for ``n`` elements."""
    n_blocks = (n + BLOCK - 1) // BLOCK
    if n_blocks > _GROUP and n_blocks % _GROUP:
        n_blocks += _GROUP - n_blocks % _GROUP
    return n_blocks


#: fp32(1 / 127): the reference's ``absmax / 127.0`` as XLA computes it
RECIP_127 = float(np.float32(1.0) / np.float32(127.0))


def bias_corrections(b1: float, b2: float, step: int) -> Tuple[float, float]:
    """``(1 - b1**step, 1 - b2**step)`` computed in fp32, as the JAX
    update does from its fp32 step, returned as the Python floats of
    those fp32 values: kernel and plain version get the same two."""
    f = np.float32
    return (float(f(1.0) - f(b1) ** f(step)),
            float(f(1.0) - f(b2) ** f(step)))


# ---------------------------------------------------- plain versions


def _const(value: float, like: torch.Tensor) -> torch.Tensor:
    """A 0-dim fp32 tensor on ``like``'s device, to divide by: PyTorch's
    CUDA ``div`` by a Python scalar multiplies by its reciprocal."""
    return torch.full((), value, dtype=torch.float32, device=like.device)


def _pad_blocks(flat: torch.Tensor, n_blocks: int) -> torch.Tensor:
    """``flat`` fp32 zero-padded to ``n_blocks`` whole blocks, viewed
    ``[n_blocks, BLOCK]``."""
    pad = n_blocks * BLOCK - flat.numel()
    if pad:
        flat = torch.cat([flat, flat.new_zeros(pad)])
    return flat.view(n_blocks, BLOCK)


def quantize_plain(xb: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """``[n_blocks, 1024]`` fp32 -> (int8 ``[n_blocks, 1024]``, fp32
    scales ``[n_blocks, 1]``)."""
    absmax = xb.abs().amax(dim=1, keepdim=True)
    scale = torch.clamp_min(absmax * RECIP_127, 1e-12)
    t = xb / scale
    t.round_().clamp_(-127, 127)
    return t.to(torch.int8), scale


def dequantize_plain(qb: torch.Tensor, scales: torch.Tensor) -> torch.Tensor:
    """int8 ``[n_blocks, 1024]`` and scales ``[n_blocks, 1]`` -> fp32
    ``q * scale``."""
    return qb.to(torch.float32).mul_(scales)


def fused_adam_plain(gb, mu_q, mu_s, nu_q, nu_s, bc1, bc2, *, lr, b1, b2,
                     eps):
    """The fused update on ``[n_blocks, 1024]`` views (``gb`` fp32,
    zero-padded): dequantize mu and sqrt(nu), ``mu = b1 mu + (1 - b1) g``,
    ``nu = b2 r r + (1 - b2) g g``, ``upd = -lr (mu / bc1) / (sqrt(nu /
    bc2) + eps)``, requantize mu and sqrt(nu) with fresh scales.  Returns
    ``(upd, mu_q, mu_s, nu_q, nu_s)``; every product and sum is rounded
    on its own, in the JAX expression's order."""
    mu = dequantize_plain(mu_q, mu_s).mul_(b1)
    mu.add_(gb * (1.0 - b1))
    root = dequantize_plain(nu_q, nu_s)
    nu = (root * b2).mul_(root)
    del root
    nu.add_((gb * (1.0 - b2)).mul_(gb))
    den = (nu / _const(bc2, gb)).sqrt_().add_(eps)
    upd = (mu / _const(bc1, gb)).mul_(-lr).div_(den)
    del den
    mu_q2, mu_s2 = quantize_plain(mu)
    del mu
    nu_q2, nu_s2 = quantize_plain(nu.sqrt_())
    return upd, mu_q2, mu_s2, nu_q2, nu_s2


# ----------------------------------------------------------- kernels


#: ``dl_quantize(x, q, scales, n, n_blocks, stream)``
QUANT_ARGTYPES = [ctypes.c_void_p] * 3 + [ctypes.c_int64] * 2 + [
    ctypes.c_void_p]
#: ``dl_dequantize(q, scales, x, n, stream)``
DEQUANT_ARGTYPES = [ctypes.c_void_p] * 3 + [ctypes.c_int64, ctypes.c_void_p]
#: ``dl_int8_adam(g, upd, mu_q, mu_s, nu_q, nu_s, mu_q_out, mu_s_out,
#: nu_q_out, nu_s_out, n, n_blocks, bc1, bc2, neg_lr, b1, one_minus_b1,
#: b2, one_minus_b2, eps, stream)``
ADAM_ARGTYPES = [ctypes.c_void_p] * 10 + [ctypes.c_int64] * 2 + [
    ctypes.c_float] * 8 + [ctypes.c_void_p]


def _entry(name: str, argtypes):
    lib = _build.library("quantization")
    fn = getattr(lib, name)
    fn.restype = ctypes.c_int
    fn.argtypes = argtypes
    return lib, fn


def _check_payload(q, scales, n_blocks, what):
    """The kernels take the reference layout as given, contiguous: int8
    ``[n_blocks * 8, 128]`` and fp32 ``[n_blocks, 1]``."""
    if q.dtype != torch.int8 or tuple(q.shape) != (n_blocks * _SUBLANES,
                                                    _LANES):
        raise ValueError(f"{what}: payload {q.dtype} {tuple(q.shape)}, "
                         f"want int8 ({n_blocks * _SUBLANES}, {_LANES})")
    if scales.dtype != torch.float32 or tuple(scales.shape) != (n_blocks, 1):
        raise ValueError(f"{what}: scales {scales.dtype} "
                         f"{tuple(scales.shape)}, want float32 "
                         f"({n_blocks}, 1)")
    if not (q.is_contiguous() and scales.is_contiguous()):
        raise ValueError(f"{what}: payload and scales must be contiguous")
    if q.data_ptr() % 4:
        raise ValueError(f"{what}: payload must be 4-byte aligned")


def _flat_f32(x: torch.Tensor) -> torch.Tensor:
    return x.reshape(-1).to(torch.float32).contiguous()


def _quantize_cuda(flat, n_blocks):
    q = torch.empty((n_blocks * _SUBLANES, _LANES), dtype=torch.int8,
                    device=flat.device)
    scales = torch.empty((n_blocks, 1), dtype=torch.float32,
                         device=flat.device)
    lib, fn = _entry("dl_quantize", QUANT_ARGTYPES)
    code = fn(_build.ptr(flat), _build.ptr(q), _build.ptr(scales),
              flat.numel(), n_blocks, _build.stream_of(flat))
    _build.check(code, lib, "quantize")
    _build.launches["quantize"] += 1
    return q, scales


def _dequantize_cuda(q, scales, n):
    n_blocks = padded_blocks(n)
    _check_payload(q, scales, n_blocks, "dequantize")
    x = torch.empty(n, dtype=torch.float32, device=q.device)
    lib, fn = _entry("dl_dequantize", DEQUANT_ARGTYPES)
    code = fn(_build.ptr(q), _build.ptr(scales), _build.ptr(x), n,
              _build.stream_of(q))
    _build.check(code, lib, "dequantize")
    _build.launches["dequantize"] += 1
    return x


def _adam_cuda(flat, mu_q, mu_s, nu_q, nu_s, n_blocks, bc1, bc2, out,
               inplace, lr, b1, b2, eps):
    for t, what in ((mu_q, "mu"), (nu_q, "nu")):
        _check_payload(t, mu_s if t is mu_q else nu_s, n_blocks,
                       f"int8_adam {what}")
    n = flat.numel()
    if out is None:
        out = torch.empty(n, dtype=torch.float32, device=flat.device)
    elif (out.dtype != torch.float32 or out.numel() != n
          or not out.is_contiguous() or out.device != flat.device):
        raise ValueError("int8_adam: out must be contiguous fp32 with the "
                         "grad's element count, on its device")
    if inplace:
        outs = (mu_q, mu_s, nu_q, nu_s)
    else:
        outs = tuple(torch.empty_like(t) for t in (mu_q, mu_s, nu_q, nu_s))
    lib, fn = _entry("dl_int8_adam", ADAM_ARGTYPES)
    code = fn(
        _build.ptr(flat), _build.ptr(out), _build.ptr(mu_q),
        _build.ptr(mu_s), _build.ptr(nu_q), _build.ptr(nu_s),
        *(_build.ptr(t) for t in outs), n, n_blocks, bc1, bc2, -lr, b1,
        1.0 - b1, b2, 1.0 - b2, eps, _build.stream_of(flat),
    )
    _build.check(code, lib, "int8_adam")
    _build.launches["int8_adam"] += 1
    return (out,) + outs


# ------------------------------------------------------------ public


def quantize_blockwise(x: torch.Tensor):
    """Any-shape float tensor -> ``(int8 payload [P/128, 128], fp32
    scales [n_blocks, 1], (shape, n))``."""
    shape, n = tuple(x.shape), x.numel()
    if n == 0:  # zero-size leaf: nothing to quantize
        return (torch.zeros((0, _LANES), dtype=torch.int8, device=x.device),
                torch.zeros((0, 1), dtype=torch.float32, device=x.device),
                (shape, 0))
    n_blocks = padded_blocks(n)
    if x.device.type == "meta":
        return (torch.empty((n_blocks * _SUBLANES, _LANES), dtype=torch.int8,
                            device="meta"),
                torch.empty((n_blocks, 1), dtype=torch.float32,
                            device="meta"),
                (shape, n))
    flat = _flat_f32(x)
    if _build.on_cpu(flat):
        q, scales = quantize_plain(_pad_blocks(flat, n_blocks))
        return q.view(-1, _LANES), scales, (shape, n)
    q, scales = _quantize_cuda(flat, n_blocks)
    return q, scales, (shape, n)


def dequantize_blockwise(q: torch.Tensor, scales: torch.Tensor, meta: Meta,
                         dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """The payload and scales of :func:`quantize_blockwise` -> a tensor
    of the original shape in ``dtype``."""
    shape, n = meta
    if n == 0:
        return torch.zeros(shape, dtype=dtype, device=q.device)
    if q.device.type == "meta":
        return torch.empty(shape, dtype=dtype, device="meta")
    if _build.on_cpu(q, scales):
        x = dequantize_plain(q.reshape(-1, BLOCK), scales).view(-1)[:n]
    else:
        x = _dequantize_cuda(q, scales, n)
    return x.reshape(shape).to(dtype)


def fused_int8_adam_update(
    grad: torch.Tensor,
    mu_q: torch.Tensor,
    mu_scales: torch.Tensor,
    nu_q: torch.Tensor,
    nu_scales: torch.Tensor,
    meta: Meta,
    bc1: float,
    bc2: float,
    *,
    lr: float,
    b1: float,
    b2: float,
    eps: float,
    out: Optional[torch.Tensor] = None,
    inplace: bool = False,
):
    """Fused Adam step over int8 moments (nu stored as sqrt(nu)).

    ``meta`` is the ``(shape, n)`` pair of :func:`quantize_blockwise`;
    ``bc1``/``bc2`` are the fp32 bias corrections as Python floats
    (:func:`bias_corrections`).  Returns ``(update, new_mu_q,
    new_mu_scales, new_nu_q, new_nu_scales)`` with the update fp32 and
    shaped like ``grad``.  ``out`` (fp32, ``grad``'s element count, may be
    ``grad`` itself) receives the update; ``inplace=True`` writes the new
    moments over the given ones and returns those tensors."""
    shape, n = meta
    if n == 0:
        upd = torch.zeros(shape, dtype=torch.float32, device=grad.device)
        return upd, mu_q, mu_scales, nu_q, nu_scales
    if grad.numel() != n:
        raise ValueError(f"grad has {grad.numel()} elements, meta says {n}")
    n_blocks = padded_blocks(n)
    bc1, bc2 = float(np.float32(bc1)), float(np.float32(bc2))
    flat = _flat_f32(grad)
    if _build.on_cpu(flat, mu_q, mu_scales, nu_q, nu_scales):
        upd, *new = fused_adam_plain(
            _pad_blocks(flat, n_blocks), mu_q.reshape(-1, BLOCK), mu_scales,
            nu_q.reshape(-1, BLOCK), nu_scales, bc1, bc2, lr=lr, b1=b1, b2=b2,
            eps=eps)
        upd = upd.view(-1)[:n]
        if out is not None:
            upd = out.view(-1).copy_(upd)
        new[0], new[2] = new[0].view(-1, _LANES), new[2].view(-1, _LANES)
        if inplace:
            for dst, src in zip((mu_q, mu_scales, nu_q, nu_scales), new):
                dst.copy_(src)
            new = [mu_q, mu_scales, nu_q, nu_scales]
        return (upd.reshape(shape), *new)
    upd, *new = _adam_cuda(
        flat, mu_q, mu_scales, nu_q, nu_scales, n_blocks, bc1, bc2,
        None if out is None else out.view(-1), inplace, lr, b1, b2, eps)
    return (upd.view(shape), *new)
