#!/usr/bin/env python3
"""Time variants of the port's RMSNorm kernels (B1 and its backward).

Each variant is ``dlrover_tpu_torch/ops/csrc/rms_norm.cu`` with some of
its design constants set to other values:

- the forward: ``kFewVecs`` and ``kManyVecs``, the 16-byte vectors a
  thread holds (which set the thread count) below and from 8 rows per SM;
- the backward: ``kBwdThreads`` and ``kBwdVecs`` (threads per CTA and
  the vectors each holds) and ``kBwdMinCtas`` (a register cap); and,
  from Python, its CTAs per SM (``fused.BWD_CTAS_PER_SM``, 1-4).

Beside them, the card's own rate for the same bytes: ``Tensor.copy_`` of
a bf16 ``[8192, 4096]`` (the plain entry's x read and y written).

The variants are written under ``build/rms_variants/`` and compiled
there with the port's own ``nvcc`` flags, one process per variant, all at
once.  Every variant is held against the plain version
(``chip_smoke.py``'s limits) and timed (CUDA-graph replays) at the main
paths' shapes: bf16 ``[16, 4096]`` and ``[52, 4096]`` with a bf16 weight
(decode and verify rows of Llama-2-7B), ``[256, 4096]`` (a prefill
chunk), and ``[8192, 4096]`` with the fp32 master weight (a training
batch of 4 x 2048), each through the plain and the residual entry; the
backward at ``[8192, 4096]`` with the residual gradient.  Needs one
NVIDIA Hopper card::

    python3 scripts/torch_rms_norm_variants.py
"""

import ctypes
import re
import shutil
import subprocess
import sys
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

import chip_smoke as cs  # noqa: E402

# each variant: the constants it sets (the committed source's values
# elsewhere); {} is the committed source
VARIANTS = [
    {},
    {"kFewVecs": 2}, {"kFewVecs": 4},
    {"kManyVecs": 1}, {"kManyVecs": 4},
    {"kBwdThreads": 512, "kBwdVecs": 1}, {"kBwdMinCtas": 4},
    {"kBwdMinCtas": 1}, {"kBwdThreads": 1024, "kBwdVecs": 1,
                         "kBwdMinCtas": 1},
]
FEW = ((16, 4096), (52, 4096), (256, 4096))
MANY = (8192, 4096)


def label(v):
    return ", ".join(f"{k}={x}" for k, x in v.items()) or "committed"


def variant_source(text, consts):
    for name, value in consts.items():
        text, n = re.subn(rf"constexpr (int|bool) {name} = \w+;",
                          rf"constexpr \g<1> {name} = {value};", text)
        if n != 1:
            raise SystemExit(f"{name} matched {n} times")
    return text


def build_all(out):
    """Compile every variant at once; {variant: (library path, log)}."""
    from dlrover_tpu_torch.ops import _build

    text = (_build.CSRC / "rms_norm.cu").read_text()
    procs = {}
    for idx, v in enumerate(VARIANTS):
        d = out / f"v{idx}"
        shutil.rmtree(d, ignore_errors=True)
        shutil.copytree(_build.CSRC, d)
        (d / "rms_norm.cu").write_text(variant_source(text, v))
        cmd = [_build.find_nvcc(), *_build.NVCC_FLAGS, "-Xptxas", "-v",
               "-o", str(d / "lib.so"), str(d / "rms_norm.cu")]
        procs[idx] = (subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                       stderr=subprocess.STDOUT), d)
    built = []
    for idx, (proc, d) in procs.items():
        log = proc.communicate()[0].decode(errors="replace")
        if proc.returncode != 0:
            raise SystemExit(f"variant {VARIANTS[idx]} did not build:\n"
                             f"{log}")
        built.append((VARIANTS[idx], d / "lib.so", log))
    return built


def ptxas(log):
    """{kernel: [registers, spill store bytes]} of the bf16 kernels (the
    most over their instantiations)."""
    out, cur = {}, None
    for line in log.splitlines():
        m = re.search(r"(?:entry function '|Function properties for )"
                      r"(\w*rms_\w*)", line)
        if m:
            cur = re.search(r"(rms_[a-z_]+?_kernel)", m.group(1)).group(1)
            cur += "<bf16>" if "nv_bfloat16" in m.group(1) else ""
            continue
        m = re.search(r"Used (\d+) registers", line)
        if m and cur and cur.endswith("<bf16>"):
            out.setdefault(cur, [0, 0])[0] = max(out.get(cur, [0, 0])[0],
                                                int(m.group(1)))
        m = re.search(r"(\d+) bytes spill stores", line)
        if m and cur and cur.endswith("<bf16>"):
            out.setdefault(cur, [0, 0])[1] = max(out.get(cur, [0, 0])[1],
                                                int(m.group(1)))
    return out


def inputs(n, d, w_dtype, gen):
    x, delta = (torch.randn(n, d, device="cuda", generator=gen)
                .to(torch.bfloat16) for _ in range(2))
    w = (1 + 0.1 * torch.randn(d, device="cuda", generator=gen)).to(w_dtype)
    return x, delta, w


def time_forward(fused, tag, shapes, gen):
    """The plain and the residual entry at each shape: ms, bound/ms and
    the error against the plain version; False if one is out of limit."""
    ok = True
    for n, d in shapes:
        w_dtype = torch.float32 if n >= 8192 else torch.bfloat16
        x, delta, w = inputs(n, d, w_dtype, gen)
        y = fused.rms_norm_fwd(x, w, 1e-5)[0]
        h, ya, _ = fused.add_rms_norm_fwd(x, delta, w, 1e-5)
        h_ref, ya_ref, _ = fused.add_rms_norm_plain(x, delta, w, 1e-5)
        err = max(cs.max_err(y, fused.rms_norm_plain(x, w, 1e-5)[0]),
                  cs.max_err(ya, ya_ref))
        good = err <= cs.RMS_TOL[torch.bfloat16] and torch.equal(h, h_ref)
        ok &= good
        ms = cs.cuda_ms(lambda: fused.rms_norm_fwd(x, w, 1e-5))
        ms_add = cs.cuda_ms(lambda: fused.add_rms_norm_fwd(x, delta, w,
                                                           1e-5))
        bnd = cs.rms_bound_ms(x, w)[0]
        bnd_add = cs.rms_bound_ms(x, w, add=True)[0]
        cs.log(f"[variants] {tag}: [{n}, {d}] bf16 x, {str(w_dtype)[6:]} "
               f"weight: rms_norm ms={ms:.4f} bound/ms={bnd / ms:.3f}; "
               f"add_rms_norm ms={ms_add:.4f} bound/ms="
               f"{bnd_add / ms_add:.3f}; max_abs_err={err:.3g} "
               f"{'ok' if good else 'FAIL'}")
    return ok


def time_backward(fused, tag, gen):
    """The backward at the training shape with the residual gradient, by
    CTAs per SM; False if one is out of limit."""
    x, g, w = inputs(*MANY, torch.float32, gen)
    g_res = torch.randn(MANY, device="cuda", generator=gen).to(
        torch.bfloat16)
    rstd = fused.rms_norm_plain(x, w, 1e-5)[1]
    dx_ref, dw_ref = fused.rms_norm_bwd_plain(x, w, rstd, g, g_res)
    bnd = cs.rms_bwd_bound_ms(x, w, True)[0]
    ok = True
    committed = fused.BWD_CTAS_PER_SM
    for per_sm in (1, 2, 3, 4):
        fused.BWD_CTAS_PER_SM = per_sm
        dx, dw = fused.rms_norm_bwd(x, w, rstd, g, g_res)
        e_dx = cs.dx_err(dx, dx_ref)
        e_dw = cs.max_err(dw, dw_ref) / cs.dw_limit(dw_ref)
        good = e_dx <= 1 and e_dw <= 1
        ok &= good
        ms = cs.cuda_ms(lambda: fused.rms_norm_bwd(x, w, rstd, g, g_res))
        cs.log(f"[variants] {tag}: rms_norm_bwd [8192, 4096] bf16 x, fp32 "
               f"weight, g_res, {per_sm} CTAs per SM: ms={ms:.4f} bound_ms="
               f"{bnd:.4f} bound/ms={bnd / ms:.3f} err/limit dx={e_dx:.3g} "
               f"dw={e_dw:.3g} {'ok' if good else 'FAIL'}")
    fused.BWD_CTAS_PER_SM = committed
    return ok


def main() -> int:
    if not torch.cuda.is_available():
        print("needs a CUDA card", file=sys.stderr)
        return 2
    from dlrover_tpu_torch.ops import _build
    from dlrover_tpu_torch.ops import fused

    cs.log(f"[device] {cs.smi_line()}")
    built = build_all(ROOT / "build" / "rms_variants")
    gen = torch.Generator(device="cuda").manual_seed(cs.SEED)
    failed = 0
    for v, lib, log in built:
        _build._libs["rms_norm"] = ctypes.CDLL(str(lib))
        tag = label(v)
        cs.log(f"[variants] {tag}: ptxas [registers, spill bytes] "
               f"{ptxas(log)}")
        if not v or not all(k.startswith("kBwd") for k in v):
            failed += not time_forward(fused, tag, FEW + (MANY,), gen)
        if not v or any(k.startswith("kBwd") for k in v):
            failed += not time_backward(fused, tag, gen)
    x, g, w = inputs(*MANY, torch.float32, gen)
    y = torch.empty_like(x)
    copy_ms = cs.cuda_ms(lambda: y.copy_(x))
    copy_bound = cs.bound(2 * x.numel() * x.element_size(), 0, x.dtype)[0]
    cs.log(f"[variants] Tensor.copy_ [8192, 4096] bf16: ms={copy_ms:.4f} "
           f"bound/ms={copy_bound / copy_ms:.3f} (the plain entry's bytes "
           "but the weight's and rstd's)")
    g_res = torch.randn(MANY, device="cuda", generator=gen).to(
        torch.bfloat16)
    rstd = fused.rms_norm_plain(x, w, 1e-5)[1]
    plain_ms = cs.cuda_ms(
        lambda: fused.rms_norm_bwd_plain(x, w, rstd, g, g_res), reps=3)
    cs.log(f"[variants] rms_norm_bwd_plain (torch ops) [8192, 4096] bf16 x, "
           f"fp32 weight, g_res: ms={plain_ms:.4f}")
    return 1 if failed else 0


if __name__ == "__main__":
    sys.exit(main())
