"""RMSNorm forward: the CUDA kernel ``ops/csrc/rms_norm.cu`` and its
plain PyTorch version.

Port of ``dlrover_tpu/ops/fused.py:48-118`` (``_rms_fwd_kernel``,
``_rms_plain``, ``rms_norm``).  Forward only: serving needs no
backward.  Both versions take the statistics in fp32, multiply by the
weight in fp32 and cast once to ``x.dtype``, and both return ``rstd``
(``[..., 1]`` fp32) beside ``y``.
"""

import ctypes
from typing import Tuple

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


#: ``dl_rms_norm_fwd(x, w, y, rstd, n, d, eps, dtype, stream)``
ARGTYPES = [ctypes.c_void_p] * 4 + [
    ctypes.c_int, ctypes.c_int, ctypes.c_float, ctypes.c_int,
    ctypes.c_void_p,
]


def _rms_norm_cuda(x, weight, eps):
    if x.dtype not in _build.DTYPE_CODES:
        raise TypeError(f"rms_norm kernel takes fp32/bf16, got {x.dtype}")
    if weight.dtype != x.dtype:
        raise TypeError(
            f"rms_norm kernel needs weight in {x.dtype}, got {weight.dtype}"
        )
    d = x.shape[-1]
    if weight.shape != (d,):
        raise ValueError(f"weight shape {tuple(weight.shape)} != ({d},)")
    if not (x.is_contiguous() and weight.is_contiguous()):
        raise ValueError("rms_norm kernel needs contiguous x and weight")
    y = torch.empty_like(x)
    rstd = torch.empty(x.shape[:-1] + (1,), dtype=torch.float32,
                       device=x.device)
    n = x.numel() // d if d else 0
    if n == 0:
        return y, rstd
    lib = _build.library("rms_norm")
    fn = lib.dl_rms_norm_fwd
    fn.restype = ctypes.c_int
    fn.argtypes = ARGTYPES
    code = fn(
        _build.ptr(x), _build.ptr(weight), _build.ptr(y), _build.ptr(rstd),
        n, d, float(eps), _build.DTYPE_CODES[x.dtype], _build.stream_of(x),
    )
    _build.check(code, lib, "rms_norm")
    _build.launches["rms_norm"] += 1
    return y, rstd


def rms_norm_fwd(
    x: torch.Tensor, weight: torch.Tensor, eps: float = 1e-5
) -> Tuple[torch.Tensor, torch.Tensor]:
    """``(y, rstd)``: the CUDA kernel for CUDA tensors, the plain
    version for CPU tensors."""
    if _build.on_cpu(x, weight):
        return rms_norm_plain(x, weight, eps)
    return _rms_norm_cuda(x, weight, eps)


def rms_norm(
    x: torch.Tensor, weight: torch.Tensor, eps: float = 1e-5
) -> torch.Tensor:
    """``x * rsqrt(mean(x^2) + eps) * weight`` over the last dim, in
    ``x.dtype`` (any leading shape)."""
    return rms_norm_fwd(x, weight, eps)[0]
