#!/usr/bin/env python3
"""Time variants of the port's split-KV paged decode kernel (B5).

Each variant is ``dlrover_tpu_torch/ops/csrc/paged_attention.cu`` with
the decode kernel's design constants set to other values (warps per
block, stages of each warp's ring, keys per step of the block; and the
keys per split, ``paged_kernels.SPLIT_KEYS``), written
under ``build/decode_variants/`` and compiled there with the port's own
``nvcc`` flags, one process per variant, all at once.  Every variant is
held against the plain version (the ``chip_smoke.py`` limit, three runs
bit for bit) and timed on a decode input at the serving path's shape:
16 lanes at the lengths of the decode step ``chip_smoke.py`` captures
(180-1,004 keys), Llama-2-7B's 32 heads of 128, a 2,049-block bf16 pool
with the lanes' pages spread over it.  Needs one NVIDIA Hopper card::

    python3 scripts/torch_paged_decode_variants.py
"""

import ctypes
import re
import shutil
import subprocess
import sys
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

import chip_smoke as cs  # noqa: E402

LENS = [905, 716, 598, 396, 413, 203, 203, 180, 301, 859, 723, 947, 594,
        679, 1004, 785]
# (warps per block, stages of a warp's ring, keys per step of the block
# at rows under 1 KB (half that at 1 KB rows), keys per split): a warp's
# chunk is step / warps keys
VARIANTS = [(4, 3, 32, 128), (4, 2, 32, 128), (4, 4, 32, 128),
            (4, 3, 64, 128), (8, 3, 32, 128), (8, 2, 32, 128),
            (8, 4, 32, 128), (4, 3, 16, 128), (4, 2, 16, 128),
            (8, 2, 64, 128), (4, 4, 16, 128), (2, 2, 8, 128),
            (2, 3, 8, 128), (4, 2, 16, 64), (4, 3, 16, 64),
            (4, 2, 16, 256), (8, 2, 32, 64)]


def variant_source(text, warps, stages, step, split):
    """The source with the decode kernel's constants set."""
    subs = [
        (r"constexpr int kDecodeWarps = \d+;",
         f"constexpr int kDecodeWarps = {warps};"),
        (r"constexpr int kDecodeStages = \d+;",
         f"constexpr int kDecodeStages = {stages};"),
        (r"(struct DecodeCfg \{\n  static constexpr int kKeys = "
         r"D \* sizeof\(T\) >= 1024 \? )\d+ : \d+;",
         rf"\g<1>{step // 2} : {step};"),
    ]
    for pattern, repl in subs:
        text, n = re.subn(pattern, repl, text)
        if n != 1:
            raise SystemExit(f"{pattern!r} matched {n} times")
    return text


def decode_input(gen):
    """q [16, 32, 128], pools [2049, 16, 32, 128] bf16, tables of 128
    random pages per lane, the lanes' lengths."""
    rng = np.random.default_rng(cs.SEED)
    shape = (2049, 16, 32, 128)
    k_pool, v_pool = (torch.randn(shape, device="cuda", generator=gen)
                      .to(torch.bfloat16) for _ in range(2))
    pages = torch.from_numpy(1 + rng.permutation(2048)).int()
    tables = pages.reshape(16, 128).cuda()
    lens = torch.tensor(LENS, dtype=torch.int32, device="cuda")
    q = torch.randn(16, 32, 128, device="cuda", generator=gen).to(
        torch.bfloat16)
    return q, k_pool, v_pool, tables, lens


def build_all(out):
    """Compile every variant at once; {variant: (library path, log)}."""
    from dlrover_tpu_torch.ops import _build

    text = (_build.CSRC / "paged_attention.cu").read_text()
    procs = {}
    for v in VARIANTS:
        d = out / "v{}_{}_{}_{}".format(*v)
        shutil.rmtree(d, ignore_errors=True)
        shutil.copytree(_build.CSRC, d)
        (d / "paged_attention.cu").write_text(variant_source(text, *v))
        cmd = [_build.find_nvcc(), *_build.NVCC_FLAGS, "-Xptxas", "-v",
               "-o", str(d / "lib.so"), str(d / "paged_attention.cu")]
        procs[v] = (subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                     stderr=subprocess.STDOUT), d)
    built = {}
    for v, (proc, d) in procs.items():
        log = proc.communicate()[0].decode(errors="replace")
        if proc.returncode != 0:
            raise SystemExit(f"variant {v} did not build:\n{log}")
        built[v] = (d / "lib.so", log)
    return built


def main() -> int:
    if not torch.cuda.is_available():
        print("needs a CUDA card", file=sys.stderr)
        return 2
    from dlrover_tpu_torch.ops import _build
    from dlrover_tpu_torch.ops import paged_kernels as pk

    cs.log(f"[device] {cs.smi_line()}")
    built = build_all(ROOT / "build" / "decode_variants")
    a = decode_input(torch.Generator(device="cuda").manual_seed(cs.SEED))
    ref = pk.paged_decode_plain(*a)
    bound = cs.attn_bound_ms(a[0], a[1], a[4], None)[0]
    sdpa = cs.cuda_ms(cs.sdpa_decode_fn(*a, None))
    cs.log(f"[variants] B5 at q={tuple(a[0].shape)} lens={LENS}: bound_ms="
           f"{bound:.4f} (bytes) SDPA ms={sdpa:.4f}")
    failed = 0
    for (warps, stages, step, split), (lib, log) in built.items():
        pk.SPLIT_KEYS = split  # decode_plan's split size
        _build._libs["paged_attention"] = ctypes.CDLL(str(lib))
        _build.build_logs["paged_attention"] = log
        ptxas = cs.build_report({k: None for k in cs.BUILT})["paged_decode"]
        out = pk.paged_decode_kernel(*a)
        err = cs.max_err(out, ref)
        same = cs.bitwise_repeat(lambda: pk.paged_decode_kernel(*a))
        ms = cs.cuda_ms(lambda: pk.paged_decode_kernel(*a))
        ok = err <= cs.ATTN_TOL[torch.bfloat16] and same
        failed += not ok
        cs.log(f"[variants] {warps} warps, {stages}-stage rings, "
               f"{step // warps}-key chunks, {split}-key splits: ms="
               f"{ms:.4f} bound/ms="
               f"{bound / ms:.3f} max_abs_err={err:.3g} 3 runs equal: "
               f"{same} ptxas={ptxas} {'ok' if ok else 'FAIL'}")
    return 1 if failed else 0


if __name__ == "__main__":
    sys.exit(main())
